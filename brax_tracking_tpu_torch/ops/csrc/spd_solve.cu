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
// factored in place and solved by the block-level pieces of cholesky.cuh
// (right-looking factor, both substitutions right-looking). At nv = 146 the
// factor is 85.8 KB of shared memory (opt-in above 48 KB), so two blocks fit
// an SM.
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

#include "cholesky.cuh"

namespace {

__global__ void __launch_bounds__(chol::kMaxThreads)
spd_solve_kernel(const float* __restrict__ M, const float* __restrict__ rhs,
                 float* __restrict__ x, int nv) {
  const int b = blockIdx.x;
  const int ld = nv | 1;

  // dynamic shared memory: U (nv x ld), then y
  extern __shared__ float sm[];
  float* U = sm;
  float* y = U + nv * ld;

  chol::load_matrix(U, ld, M + (size_t)b * nv * nv, nv);
  for (int i = chol::tid(); i < nv; i += chol::nthreads()) y[i] = rhs[(size_t)b * nv + i];
  chol::factor_upper(U, ld, nv);
  chol::forward_subst(U, ld, y, nv);
  chol::backward_subst(U, ld, y, x + (size_t)b * nv, nv);
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
  spd_solve_kernel<<<B, chol::chol_threads(nv), smem, (cudaStream_t)stream>>>(M, rhs, x, nv);
  return (int)cudaGetLastError();
}
