// Batched SPD solve M x = b (Cholesky factor and both substitutions) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel brax_tracking_tpu/ops/cholesky.py::
// factor_solve_batched (_factor_solve_kernel -> _factor_ref_blocked +
// _solve_ref): the upper factor U (M = U^T U) never leaves on-chip memory
// and only x is written.
//
// Design. The TPU kernel puts 128 envs in the lanes of an (n, n, 128) VMEM
// tile and factors in 8-row panels aligned to the sublanes. Here one block
// owns one env: M goes to shared memory (odd row stride nv | 1) and is
// factored in place, right-looking: at pivot k every thread scales its
// share of row k by rsqrt(pivot), then updates its share of the trailing
// upper triangle (threadIdx.x along a row, threadIdx.y down the rows).
// Both substitutions are right-looking too, one barrier per step: forward
// U^T y = b subtracts U[k, j] y_k from the later entries (row k of U),
// backward U x = y subtracts U[i, k] x_k from the earlier ones (column k,
// conflict-free through the odd stride). At nv = 146 the factor is 85.8 KB
// of shared memory (opt-in above 48 KB), so two blocks fit an SM.
//
// Bound. Per env the work is ~nv^3 / 3 FP32 operations against 4 nv^2
// bytes (M read once), ~nv/12 operations per byte: below the H100's ~20
// per byte up to nv ~ 240, so the kernel is bound by bytes at every size
// the engine has (and by launch latency at nv = 7). What the design does
// about the bytes: M is read exactly once, coalesced along its rows, and
// nothing but x is written; the factor stays in shared memory. The
// arithmetic order is that of the plain version (ops/cholesky.py::
// spd_solve_reference).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
spd_solve_kernel(const float* __restrict__ M, const float* __restrict__ rhs,
                 float* __restrict__ x, int nv) {
  const int b = blockIdx.x;
  const int ld = nv | 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = blockDim.x, ny = blockDim.y;
  const int tid = ty * nx + tx, nt = nx * ny;

  // dynamic shared memory: U (nv x ld), then y
  extern __shared__ float sm[];
  float* U = sm;
  float* y = U + nv * ld;

  const float* Mb = M + (size_t)b * nv * nv;
  for (int i = ty; i < nv; i += ny)
    for (int j = tx; j < nv; j += nx) U[i * ld + j] = Mb[i * nv + j];
  for (int i = tid; i < nv; i += nt) y[i] = rhs[(size_t)b * nv + i];
  __syncthreads();

  // ---- factor: rows of U overwrite the upper triangle
  for (int k = 0; k < nv; ++k) {
    const float c = rsqrtf(U[k * ld + k]);
    __syncthreads();  // every thread has read the pivot before row k changes
    for (int j = k + tid; j < nv; j += nt) U[k * ld + j] *= c;
    __syncthreads();
    for (int i = k + 1 + ty; i < nv; i += ny) {
      const float uki = U[k * ld + i];
      for (int j = i + tx; j < nv; j += nx) U[i * ld + j] -= uki * U[k * ld + j];
    }
    __syncthreads();
  }

  // ---- forward: U^T y = b (y[k] final once the earlier rows are done)
  for (int k = 0; k < nv; ++k) {
    const float yk = y[k] / U[k * ld + k];
    for (int j = k + 1 + tid; j < nv; j += nt) y[j] -= U[k * ld + j] * yk;
    __syncthreads();
    if (tid == 0) y[k] = yk;
  }
  __syncthreads();

  // ---- backward: U x = y
  for (int k = nv - 1; k >= 0; --k) {
    const float xk = y[k] / U[k * ld + k];
    for (int i = tid; i < k; i += nt) y[i] -= U[i * ld + k] * xk;
    if (tid == 0) x[(size_t)b * nv + k] = xk;
    __syncthreads();
  }
}

}  // namespace

// Solves B systems M x = b on `stream` (M row-major (nv, nv) SPD, b and x
// (nv,) per env). `smem` is the dynamic shared memory per block,
// 4 (nv (nv | 1) + nv) bytes (ops/cholesky.py computes it). Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int spd_solve_launch(const float* M, const float* rhs, float* x, int B,
                                int nv, int smem, void* stream) {
  if (B == 0 || nv == 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nx = nv <= 8 ? 8 : (nv <= 16 ? 16 : 32);
  const int ny = nv < kMaxThreads / nx ? nv : kMaxThreads / nx;
  spd_solve_kernel<<<B, dim3(nx, ny), smem, (cudaStream_t)stream>>>(M, rhs, x, nv);
  return (int)cudaGetLastError();
}
