// Batched Cholesky factor, and the solve from that factor, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels brax_tracking_tpu/ops/cholesky.py::factor_batched
// (_factor_kernel: (B, nv, nv) SPD -> upper U with M = U^T U, zero below the
// diagonal) and solve_batched (_solve_kernel: U^T U x = b, both
// substitutions). These are dynamics.factor_m and the qLD branch of
// dynamics.solve_m; spd_solve.cu fuses the two when the factor is not kept.
//
// Design. The TPU kernels put 128 envs in the lanes of an (n, n, 128) VMEM
// tile. Here one block owns one matrix, staged in shared memory with the odd
// row stride nv | 1, and runs the block-level pieces of cholesky.cuh (the
// same factor and substitutions as spd_solve). factor_kernel writes U out
// with zeros below the diagonal; solve_kernel stages U and b and writes x.
//
// Bound. The factor does ~nv^3 / 3 FP32 operations against 8 nv^2 bytes (M
// read, U written), ~nv/24 operations per byte; the solve 2 nv^2 operations
// against 4 nv^2 bytes. Both are bound by bytes at the engine's widths (and
// by launch latency at the ballmuscle's nv = 7). What the design does about
// the bytes: each matrix is read once and written once, coalesced along its
// rows; every intermediate stays in shared memory.

#include <cuda_runtime.h>

#include "cholesky.cuh"

namespace {

__global__ void __launch_bounds__(chol::kMaxThreads)
factor_kernel(const float* __restrict__ M, float* __restrict__ Uout, int nv) {
  const int b = blockIdx.x;
  const int ld = nv | 1;
  extern __shared__ float sm[];
  float* U = sm;  // nv x ld

  chol::load_matrix(U, ld, M + (size_t)b * nv * nv, nv);
  chol::factor_upper(U, ld, nv);
  float* Ub = Uout + (size_t)b * nv * nv;
  for (int i = threadIdx.y; i < nv; i += blockDim.y)
    for (int j = threadIdx.x; j < nv; j += blockDim.x) Ub[i * nv + j] = (j >= i) ? U[i * ld + j] : 0.f;
}

__global__ void __launch_bounds__(chol::kMaxThreads)
solve_kernel(const float* __restrict__ Uin, const float* __restrict__ rhs,
             float* __restrict__ x, int nv) {
  const int b = blockIdx.x;
  const int ld = nv | 1;
  extern __shared__ float sm[];
  float* U = sm;           // nv x ld
  float* y = U + nv * ld;  // nv

  chol::load_matrix(U, ld, Uin + (size_t)b * nv * nv, nv);
  for (int i = chol::tid(); i < nv; i += chol::nthreads()) y[i] = rhs[(size_t)b * nv + i];
  __syncthreads();
  chol::forward_subst(U, ld, y, nv);
  chol::backward_subst(U, ld, y, x + (size_t)b * nv, nv);
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Factors B row-major (nv, nv) SPD matrices on `stream` into upper factors U
// (zero below the diagonal). `smem` is 4 nv (nv | 1) bytes per block
// (ops/cholesky.py computes it). Returns the cudaGetLastError() code of the
// launch (0 on success).
extern "C" int cholesky_factor_launch(const float* M, float* U, int B, int nv, int smem,
                                      void* stream) {
  if (B == 0 || nv == 0) return 0;
  const int err = allow_smem(factor_kernel, smem);
  if (err) return err;
  factor_kernel<<<B, chol::chol_threads(nv), smem, (cudaStream_t)stream>>>(M, U, nv);
  return (int)cudaGetLastError();
}

// Solves U^T U x = b on `stream` for B upper factors U (nv, nv) and b (nv,).
// `smem` is 4 (nv (nv | 1) + nv) bytes per block. Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int cholesky_solve_launch(const float* U, const float* rhs, float* x, int B, int nv,
                                     int smem, void* stream) {
  if (B == 0 || nv == 0) return 0;
  const int err = allow_smem(solve_kernel, smem);
  if (err) return err;
  solve_kernel<<<B, chol::chol_threads(nv), smem, (cudaStream_t)stream>>>(U, rhs, x, nv);
  return (int)cudaGetLastError();
}
