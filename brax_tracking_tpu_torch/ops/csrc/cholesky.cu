// Batched Cholesky factor, and the solve from that factor, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels brax_tracking_tpu/ops/cholesky.py::factor_batched
// (_factor_kernel: (B, nv, nv) SPD -> upper U with M = U^T U, zero below the
// diagonal) and solve_batched (_solve_kernel: U^T U x = b, both
// substitutions). These are dynamics.factor_m and the qLD branch of
// dynamics.solve_m; spd_solve.cu fuses the two when the factor is not kept.
//
// Bound. The factor does ~nv^3 / 3 FP32 operations against 8 nv^2 bytes (M
// read, U written), ~nv/24 operations per byte, so at the engine's widths
// it is bound by bytes (and by launch latency at the ballmuscle's nv = 7).
// Each element of the upper triangle still sees ~nv/3 dependent updates,
// and a factor with one barrier-separated step per pivot (cholesky.cuh::
// factor_upper, three barriers and a shared-memory read-modify-write chain
// per pivot) is bound by that latency instead: 18x above the bytes at
// nv = 146 and slower than torch.linalg.cholesky there.
//
// Design of the factor (factor_kernel). The TPU kernel puts 128 envs in the
// lanes of an (n, n, 128) VMEM tile. Here:
// - nv <= 32: one warp per matrix, several matrices per block, no shared
//   memory and no barrier. Lane c holds column c of the upper triangle in
//   registers (read along the rows, so each load is coalesced across the
//   warp); the pivot row is broadcast by shuffles. Right-looking, one pivot
//   at a time, as the plain version.
// - nv > 32: one block per matrix in shared memory (row stride and rows
//   padded to a multiple of 4, so tiles are 16-byte aligned), factored in
//   panels of kNb = 16 rows, right-looking and blocked, two barriers per
//   panel instead of three per pivot (20 against 438 at nv = 146):
//   1. every warp factors the panel's kNb x kNb diagonal block in registers
//      (lane c holds its column c, shuffles broadcast the pivot row; every
//      warp computes the same values, so none waits for another), and in the
//      same pivot loop each thread solves one column of the panel to the
//      right of the block (U12 = U11^-T A12), writing it once;
//   2. barrier; warp 0 writes the diagonal block; every thread takes 4 x 4
//      tiles of the trailing upper triangle (tile rows across a warp's lanes
//      for conflict-free 16-byte loads), accumulates the kNb rank-1 terms
//      U22 -= U12^T U12 in registers from two float4 loads of U12 per term
//      (0.125 loads per FMA), and writes each element once per panel;
//   3. barrier.
//   Only the upper triangle of M is read (half the input bytes); U's lower
//   triangle is written as zeros. A block's factor is a chain of dependent
//   steps (one block alone on an SM takes a third of the whole launch at
//   nv = 73, scripts/ab_solve_kernel.py's occupancy sweep), so the launch
//   leans on several matrices per SM, one loading while others factor: 8 at
//   nv <= 80 (registers capped at 64, where ptxas spills a few bytes: still
//   faster than 6 blocks of 80 registers), as many as shared memory holds
//   up to nv = 144 (one 128-thread instance), 2 at 146 (256 threads, 87.6 KB
//   each).
// Each element's updates are applied in pivot order, as in the plain
// version (ops/cholesky.py::cholesky_factor_reference), with fused
// multiply-adds and the hardware rsqrt.
//
// Design of the solve (solve_kernel, unchanged): one block per matrix,
// staged in shared memory with the odd row stride nv | 1, both
// substitutions from cholesky.cuh; each matrix is read once, coalesced.

#include <cuda_runtime.h>

#include "cholesky.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNb = 16;              // panel width of the blocked factor
constexpr int kWarpsPerBlockSmall = 4;  // matrices per block for nv <= 32

// (i, j) moved on by n elements of a row-major matrix with nv columns
__device__ __forceinline__ void advance(int& i, int& j, int n, int nv) {
  j += n;
  while (j >= nv) {
    j -= nv;
    ++i;
  }
}

// ---- nv <= kMax: one warp per matrix, column c of U in lane c's registers
template <int kMax>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlockSmall)
factor_kernel_warp(const float* __restrict__ M, float* __restrict__ Uout, int B, int nv) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int b = blockIdx.x * kWarpsPerBlockSmall + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps
  const float* Mb = M + (size_t)b * nv * nv;
  const bool mine = lane < nv;
  float col[kMax];
#pragma unroll
  for (int r = 0; r < kMax; ++r) col[r] = (mine && r < nv && r <= lane) ? Mb[r * nv + lane] : 0.f;
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    if (k < nv) {
      const float c = rsqrtf(__shfl_sync(kFull, col[k], k));
      col[k] *= c;  // row k of U (lanes >= k)
#pragma unroll
      for (int r = k + 1; r < kMax; ++r) {
        const float ukr = __shfl_sync(kFull, col[k], r);  // U[k, r]
        if (r < nv && r <= lane) col[r] -= ukr * col[k];
      }
    }
  }
  float* Ub = Uout + (size_t)b * nv * nv;
  if (mine) {
#pragma unroll
    for (int r = 0; r < kMax; ++r)
      if (r < nv) Ub[r * nv + lane] = (r <= lane) ? col[r] : 0.f;
  }
}

// 4 bytes from device to shared memory without passing through registers
// (cp.async): a thread issues all its copies before it waits for any
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// ---- nv > 32: blocked, one block of kThreads threads per matrix; the launch
// bounds keep kMinBlocks blocks resident per SM (registers permitting)
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
factor_kernel_blocked(const float* __restrict__ M, float* __restrict__ Uout, int nv) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = kThreads;
  const int lane = tid & (kWarp - 1), warp = tid >> 5;
  const int ld = (nv + 3) & ~3;
  extern __shared__ __align__(16) float U[];  // ld x ld, upper triangle used

  // the upper triangle of M, consecutive threads on consecutive elements,
  // every copy in flight at once
  const float* Mb = M + (size_t)b * nv * nv;
  for (int i = tid / nv, j = tid - (tid / nv) * nv; i < nv; advance(i, j, nt, nv))
    if (j >= i) copy_async(&U[i * ld + j], Mb + i * nv + j);
  copy_async_wait();
  __syncthreads();

  for (int k0 = 0; k0 < nv; k0 += kNb) {
    const int nb = min(kNb, nv - k0);
    // 1. the diagonal block (lane c < nb holds column k0 + c) and one panel
    // column j to its right per thread, in one pivot loop; a warp with no
    // panel column skips it (but warp 0, which writes the block)
    const int c = lane < nb ? lane : 0;
    const int j = k0 + kNb + tid;
    const bool has_col = j < nv;
    float col[kNb];
    if (warp == 0 || k0 + kNb + warp * kWarp < nv) {
      float x[kNb];
#pragma unroll
      for (int r = 0; r < kNb; ++r) {
        col[r] = (r < nb && r <= c) ? U[(k0 + r) * ld + k0 + c] : 0.f;
        x[r] = (r < nb && has_col) ? U[(k0 + r) * ld + j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kNb; ++i) {
        if (i < nb) {
          const float s = rsqrtf(__shfl_sync(kFull, col[i], i));
          col[i] *= s;
          x[i] *= s;
#pragma unroll
          for (int r = i + 1; r < kNb; ++r) {
            const float uir = __shfl_sync(kFull, col[i], r);  // U[k0 + i, k0 + r]
            if (r <= c) col[r] -= uir * col[i];
            x[r] -= uir * x[i];
          }
        }
      }
      if (has_col) {
#pragma unroll
        for (int r = 0; r < kNb; ++r)
          if (r < nb) U[(k0 + r) * ld + j] = x[r];
      }
    }
    __syncthreads();  // U12 complete; every warp has read the diagonal block

    // 2. warp 0 writes the diagonal block; the trailing update U22 -= U12^T U12
    if (warp == 0 && lane < nb) {
#pragma unroll
      for (int r = 0; r < kNb; ++r)
        if (r <= lane) U[(k0 + r) * ld + k0 + lane] = col[r];
    }
    const int t0 = k0 + kNb;
    const int T = (nv - t0 + 3) >> 2;  // tile rows (and columns) of the trailing block
    // tiles (I, J), I <= J, I-major: thread tid takes tiles tid, tid + nt, ...
    int I = 0, J = tid;
    while (I < T && J >= T) {
      J = J - T + I + 1;
      ++I;
    }
    while (I < T) {
      const int i0 = t0 + 4 * I, j0 = t0 + 4 * J;
      float a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(&U[(i0 + r) * ld + j0]);
        a[r][0] = v.x;
        a[r][1] = v.y;
        a[r][2] = v.z;
        a[r][3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        const float4 ui = *reinterpret_cast<const float4*>(&U[(k0 + k) * ld + i0]);
        const float4 uj = *reinterpret_cast<const float4*>(&U[(k0 + k) * ld + j0]);
        const float vi[4] = {ui.x, ui.y, ui.z, ui.w};
        const float vj[4] = {uj.x, uj.y, uj.z, uj.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[r][q] -= vi[r] * vj[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(&U[(i0 + r) * ld + j0]) =
            make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
      J += nt;
      while (I < T && J >= T) {
        J = J - T + I + 1;
        ++I;
      }
    }
    __syncthreads();
  }

  float* Ub = Uout + (size_t)b * nv * nv;
  for (int i = tid / nv, j = tid - (tid / nv) * nv; i < nv; advance(i, j, nt, nv))
    Ub[i * nv + j] = (j >= i) ? U[i * ld + j] : 0.f;
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
// (zero below the diagonal), reading only M's upper triangle. The launch
// geometry comes from ops/cholesky.py::factor_geometry: for nv <= 32
// `threads` is 128 (4 matrices per block, one per warp) and `smem` 0;
// above, one block of `threads` threads per matrix with `smem` =
// 4 ld^2 bytes, ld = nv rounded up to a multiple of 4, and each thread
// solves at most one panel column (threads >= nv - 16). Returns the
// cudaGetLastError() code of the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernels do not take.
extern "C" int cholesky_factor_launch(const float* M, float* U, int B, int nv, int threads,
                                      int smem, void* stream) {
  if (B == 0 || nv == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nv <= 32) {
    if (threads != kWarp * kWarpsPerBlockSmall || smem != 0) return (int)cudaErrorInvalidValue;
    const int grid = (B + kWarpsPerBlockSmall - 1) / kWarpsPerBlockSmall;
    if (nv <= 8)
      factor_kernel_warp<8><<<grid, threads, 0, s>>>(M, U, B, nv);
    else if (nv <= 16)
      factor_kernel_warp<16><<<grid, threads, 0, s>>>(M, U, B, nv);
    else
      factor_kernel_warp<32><<<grid, threads, 0, s>>>(M, U, B, nv);
    return (int)cudaGetLastError();
  }
  const int ld = (nv + 3) & ~3;
  if ((threads != 128 && threads != 256) || threads < nv - kNb || smem != 4 * ld * ld)
    return (int)cudaErrorInvalidValue;
  // 8 blocks per SM (64 registers per thread) where shared memory holds
  // them (nv <= 80), as many as it holds above
  auto kernel = threads == 256 ? factor_kernel_blocked<256, 2> : factor_kernel_blocked<128, 8>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, threads, smem, s>>>(M, U, nv);
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
