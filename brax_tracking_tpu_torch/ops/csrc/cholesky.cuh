// Block-level Cholesky pieces shared by the SPD solve (spd_solve.cu) and the
// separate factor and solve kernels (cholesky.cu), for Hopper (sm_90a).
//
// One block owns one matrix in shared memory with the odd row stride
// ld = nv | 1 (row and column walks free of bank conflicts). Threads tile the
// rows (threadIdx.y) and columns (threadIdx.x); chol_threads picks the tile.
// The factor is the upper U with M = U^T U, right-looking: at pivot k every
// thread scales its share of row k by rsqrt(pivot), then updates its share of
// the trailing upper triangle. Both substitutions are right-looking too, one
// barrier per step: forward U^T y = b subtracts U[k, j] y_k from the later
// entries (row k of U), backward U x = y subtracts U[i, k] x_k from the
// earlier ones (column k). The arithmetic order is that of the plain versions
// (ops/cholesky.py: cholesky_factor_reference, cholesky_solve_reference).

#pragma once

#include <cuda_runtime.h>

namespace chol {

constexpr int kMaxThreads = 256;

// threads per block for an nv x nv matrix: x along a row, y down the rows
inline dim3 chol_threads(int nv) {
  const int nx = nv <= 8 ? 8 : (nv <= 16 ? 16 : 32);
  const int ny = nv < kMaxThreads / nx ? nv : kMaxThreads / nx;
  return dim3(nx, ny);
}

__device__ __forceinline__ int tid() { return threadIdx.y * blockDim.x + threadIdx.x; }
__device__ __forceinline__ int nthreads() { return blockDim.x * blockDim.y; }

// the row-major nv x nv matrix Mb into U (stride ld); no barrier
__device__ __forceinline__ void load_matrix(float* U, int ld, const float* Mb, int nv) {
  for (int i = threadIdx.y; i < nv; i += blockDim.y)
    for (int j = threadIdx.x; j < nv; j += blockDim.x) U[i * ld + j] = Mb[i * nv + j];
}

// in-place right-looking factor: the upper triangle of U becomes the factor
// (the strict lower triangle keeps the input); starts and ends with a barrier
__device__ __forceinline__ void factor_upper(float* U, int ld, int nv) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = blockDim.x, ny = blockDim.y;
  const int t = ty * nx + tx, nt = nx * ny;
  __syncthreads();
  for (int k = 0; k < nv; ++k) {
    const float c = rsqrtf(U[k * ld + k]);
    __syncthreads();  // every thread has read the pivot before row k changes
    for (int j = k + t; j < nv; j += nt) U[k * ld + j] *= c;
    __syncthreads();
    for (int i = k + 1 + ty; i < nv; i += ny) {
      const float uki = U[k * ld + i];
      for (int j = i + tx; j < nv; j += nx) U[i * ld + j] -= uki * U[k * ld + j];
    }
    __syncthreads();
  }
}

// forward U^T y = b in place on y (y[k] is final once the earlier rows are
// done); starts with the caller's barrier, ends with one
__device__ __forceinline__ void forward_subst(const float* U, int ld, float* y, int nv) {
  const int t = tid(), nt = nthreads();
  for (int k = 0; k < nv; ++k) {
    const float yk = y[k] / U[k * ld + k];
    for (int j = k + 1 + t; j < nv; j += nt) y[j] -= U[k * ld + j] * yk;
    __syncthreads();
    if (t == 0) y[k] = yk;
  }
  __syncthreads();
}

// backward U x = y, consuming y; x[k] goes to xout[k]
__device__ __forceinline__ void backward_subst(const float* U, int ld, float* y, float* xout, int nv) {
  const int t = tid(), nt = nthreads();
  for (int k = nv - 1; k >= 0; --k) {
    const float xk = y[k] / U[k * ld + k];
    for (int i = t; i < k; i += nt) y[i] -= U[i * ld + k] * xk;
    if (t == 0) xout[k] = xk;
    __syncthreads();
  }
}

}  // namespace chol
