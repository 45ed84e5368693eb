// Batched SPD inverse by the sweep operator for Hopper (sm_90a).
//
// Replaces the TPU kernels brax_tracking_tpu/ops/cholesky.py::inverse_batched
// (M^-1) and ::inverse2_batched (M^-1 and (M + diag(damp))^-1 from one
// staged M), both _inverse_kernel -> sweep_invert_ref.
//
// Design. The TPU kernel puts 128 envs in the lanes of an (n, n, 128) VMEM
// tile and sweeps blocks of 8 pivots aligned to the sublanes. Here one
// block owns one matrix: grid (B, ninv), blockIdx.y = 0 inverts M and 1
// inverts M + diag(damp), so spd_inverse2 is one launch that reads M twice
// from L2/HBM and writes both inverses. The matrix lives in shared memory
// with an odd row stride (nv | 1) for the whole sweep; each of the nv
// pivots copies its row and column to two buffers, then every thread
// updates its entries (threadIdx.x along a row, threadIdx.y down the
// rows). At nv = 146 one matrix is 85.8 KB of shared memory (opt-in above
// 48 KB), so two blocks fit an SM.
//
// Bound. An SPD inverse needs ~nv^3 FP32 operations per matrix (the sweep
// keeps the matrix symmetric up to sign, so half the entries determine the
// rest; Cholesky inversion costs the same) and moves 8 nv^2 bytes (M read
// once, the inverse written once), ~nv/8 operations per byte: below the
// H100's ~20 FP32 operations per byte up to nv ~ 160, so one inverse is
// bound by bytes at rodent size and (in practice by launch latency) at
// nv = 7; the pair (12 nv^2 bytes, 2 nv^3 operations) turns bound by
// operations above nv ~ 120. This kernel sweeps the full matrix, 2 nv^3
// operations, which keeps one update rule for every entry: each is one
// fused multiply-add on shared memory, with the pivot row and column read
// from conflict-free buffers. The elimination order and update formulas
// are those of the plain version (ops/cholesky.py::sweep_inverse_reference).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
spd_inverse_kernel(const float* __restrict__ M, const float* __restrict__ damp,
                   float* __restrict__ out0, float* __restrict__ out1, int nv) {
  const int b = blockIdx.x;
  const bool damped = blockIdx.y == 1;
  const int ld = nv | 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = blockDim.x, ny = blockDim.y;
  const int tid = ty * nx + tx, nt = nx * ny;

  // dynamic shared memory: S (nv x ld), then the pivot row and column
  extern __shared__ float sm[];
  float* S = sm;
  float* rowb = S + nv * ld;
  float* colb = rowb + nv;

  const float* Mb = M + (size_t)b * nv * nv;
  for (int i = ty; i < nv; i += ny)
    for (int j = tx; j < nv; j += nx) {
      float v = Mb[i * nv + j];
      if (damped && i == j) v += damp[i];
      S[i * ld + j] = v;
    }
  __syncthreads();

  for (int k = 0; k < nv; ++k) {
    for (int i = tid; i < nv; i += nt) {
      rowb[i] = S[k * ld + i];
      colb[i] = S[i * ld + k];
    }
    __syncthreads();
    const float dinv = 1.f / rowb[k];
    for (int i = ty; i < nv; i += ny) {
      const float ci = colb[i];
      for (int j = tx; j < nv; j += nx) {
        float v;
        if (i == k && j == k) v = dinv;
        else if (i == k) v = rowb[j] * dinv;
        else if (j == k) v = -ci * dinv;
        else v = S[i * ld + j] - ci * (rowb[j] * dinv);
        S[i * ld + j] = v;
      }
    }
    __syncthreads();
  }

  float* ob = (damped ? out1 : out0) + (size_t)b * nv * nv;
  for (int i = ty; i < nv; i += ny)
    for (int j = tx; j < nv; j += nx) ob[i * nv + j] = S[i * ld + j];
}

}  // namespace

// Inverts B row-major (nv, nv) SPD matrices on `stream`: out0 = M^-1 and,
// when ninv == 2, out1 = (M + diag(damp))^-1. `smem` is the dynamic shared
// memory per block, 4 (nv (nv | 1) + 2 nv) bytes (ops/cholesky.py computes
// it). Returns the cudaGetLastError() code of the launch (0 on success).
extern "C" int spd_inverse_launch(const float* M, const float* damp, float* out0,
                                  float* out1, int B, int nv, int ninv, int smem,
                                  void* stream) {
  if (B == 0 || nv == 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spd_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nx = nv <= 8 ? 8 : (nv <= 16 ? 16 : 32);
  const int ny = nv < kMaxThreads / nx ? nv : kMaxThreads / nx;
  spd_inverse_kernel<<<dim3(B, ninv), dim3(nx, ny), smem, (cudaStream_t)stream>>>(
      M, damp, out0, out1, nv);
  return (int)cudaGetLastError();
}
