// Batched Cholesky factor, the solve from that factor, and the SPD solve
// that fuses the two, for Hopper (sm_90a).
//
// Replaces the TPU kernels of brax_tracking_tpu/ops/cholesky.py:
// - factor_batched (_factor_kernel: (B, nv, nv) SPD -> upper U with
//   M = U^T U, zero below the diagonal), dynamics.factor_m;
// - solve_batched (_solve_kernel: U^T U x = b, both substitutions), the qLD
//   branch of dynamics.solve_m;
// - factor_solve_batched (_factor_solve_kernel: M x = b, the factor kept
//   on chip and only x written), the Newton path's qacc_smooth, Hessian
//   step and damped Euler update (spd_solve).
// The pieces they share live in cholesky.cuh; all three read only the upper
// triangle of their matrix.
//
// Bound. The factor does ~nv^3 / 3 FP32 operations against 6 nv^2 bytes
// (M's upper triangle read, U written); the solve 2 nv^2 operations against
// 2 nv^2 bytes (U's upper triangle); the SPD solve ~nv^3 / 3 operations
// against 2 nv^2 bytes, past the H100's ~20 operations per byte from nv ~
// 120 on. So all three are bound by bytes from nv ~ 12 up (the SPD solve by
// its operations at 146) and by launch latency at the engine's nv = 7-10.
// What holds a kernel far above that is latency: each element of the factor
// sees ~nv / 3 dependent updates and each substitution is a chain of nv
// dependent steps, so a design with one barrier-separated step per pivot
// (three barriers per pivot in the factor, one per step in a substitution:
// 438 and 292 at nv = 146) is bound by its barriers, not by bytes.
//
// Design. The TPU kernels put 128 envs in the lanes of an (n, n, 128) VMEM
// tile. Here:
// - nv <= 32: one matrix per segment of lanes, in registers, no shared
//   memory and no barrier (cholesky.cuh: factor_warp, forward_warp,
//   backward_warp). factor_batched runs one matrix per warp (4 per block)
//   and writes U; spd_solve factors in the same registers, keeps column c
//   and row c of U in lane c (the rows come from the factor's broadcasts)
//   and runs both substitutions there; solve_batched loads U's columns and
//   rows (the upper triangle only; the rows hit the sectors the columns
//   brought in). The solves pack 4 matrices per warp up to nv = 8 and 2 up
//   to nv = 16 (segments of 8 and 16 lanes): a launch at the engine's
//   widths is a chain of dependent shuffles, and fewer warps carry it
//   (14-19% faster than one matrix per warp at nv 7 and 10, PERF.md).
// - nv > 32: one block per matrix in shared memory, panels of kNb = 16
//   rows, two barriers per panel in the factor and in each substitution (20
//   per pass at nv = 146). factor_blocked: every warp factors the panel's
//   diagonal block in registers while each thread solves one panel column
//   (U12 = U11^-T A12; these kernels' blocks have a thread for each, the
//   solve kernel's damped tail loops), then every thread takes 4 x 4
//   register tiles of the trailing update U22 -= U12^T U12 (0.125
//   shared-memory loads per FMA), on the padded square layout (rows and row
//   stride a multiple of 4).
//   forward_blocked / backward_blocked: warp 0 solves the panel's triangle in
//   registers, then every thread applies the panel as a 16-term update of
//   one later column (forward) or earlier row (backward).
//   - factor_batched stages M's upper triangle with cp.async (every copy in
//     flight at once), factors and writes U (zeros below the diagonal).
//   - spd_solve stages the same triangle a row per warp (fewer instructions
//     per copy), runs the same factor, then both substitutions on the
//     square layout, and writes only x (88.2 KB of shared memory at nv =
//     146).
//   - solve_batched stages only U's upper triangle, each panel's rows from
//     the panel's first column (47.8 KB at nv = 146 where the square takes
//     87.6 KB, so 4 blocks share an SM), with one cp.async group per panel,
//     so the forward pass starts on panel 0 while the rest is in flight.
//   A block is a chain of dependent steps (one matrix alone on an SM takes
//   a third of the whole launch at nv = 73), so the launches lean on
//   several blocks per SM, one loading while others compute: 8 at nv <= 80
//   (registers capped at 64, where ptxas spills a few bytes in the factor:
//   still faster than 6 blocks of 80 registers), as many as shared memory
//   holds above (128 threads up to nv = 144; 256 for the factor and the SPD
//   solve at 145 and up, 2 blocks per SM).
// scripts/ab_solve_kernel.py times each kernel, its occupancy sweep and
// ptxas's registers; PERF.md holds the readings and what was tried.

#include <cuda_runtime.h>

#include "cholesky.cuh"

namespace {

using chol::kNb;
using chol::kWarp;

constexpr int kWarpsPerBlockSmall = 4;  // warps per block for nv <= 32
// lanes per matrix in the register solves: nv <= 8, nv <= 16 (above, 32)
constexpr int kSeg8 = 8;
constexpr int kSeg16 = 16;

// ---- nv <= kMax: one warp per matrix, column c of U in lane c's registers
template <int kMax>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlockSmall)
factor_kernel_warp(const float* __restrict__ M, float* __restrict__ Uout, int B, int nv) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int b = blockIdx.x * kWarpsPerBlockSmall + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps
  const bool mine = lane < nv;
  float col[kMax];
  chol::load_columns(col, M + (size_t)b * nv * nv, lane, nv, mine);
  chol::factor_warp<kMax, kWarp, false>(col, col, lane, nv);
  float* Ub = Uout + (size_t)b * nv * nv;
  if (mine) {
#pragma unroll
    for (int r = 0; r < kMax; ++r)
      if (r < nv) Ub[r * nv + lane] = (r <= lane) ? col[r] : 0.f;
  }
}

// ---- nv <= kMax: one matrix per segment of kW lanes; M x = b with the
// factor in registers (kFactor: spd_solve), or U^T U x = b from U
// (solve_batched)
template <int kMax, int kW, bool kFactor>
__device__ __forceinline__ void solve_warp(const float* __restrict__ A,
                                           const float* __restrict__ rhs,
                                           float* __restrict__ x, int B, int nv) {
  const int lane = threadIdx.x & (kW - 1);
  const int b = (blockIdx.x * (kWarp * kWarpsPerBlockSmall) + threadIdx.x) / kW;
  // every lane runs the shuffles (full masks); a segment past B computes on
  // zeros and stores nothing
  const bool mine = b < B && lane < nv;
  const size_t bb = b < B ? b : 0;
  const float* Ab = A + bb * nv * nv;
  float col[kMax], row[kMax];
  chol::load_columns(col, Ab, lane, nv, mine);
  if (kFactor) {
#pragma unroll
    for (int r = 0; r < kMax; ++r) row[r] = 0.f;
  } else {
    chol::load_row(row, Ab, lane, nv, mine);
  }
  float y = mine ? rhs[bb * nv + lane] : 0.f;
  if (kFactor) chol::factor_warp<kMax, kW, true>(col, row, lane, nv);
  const float d = mine ? __frcp_rn(chol::at_lane(col, lane)) : 0.f;
  y = chol::forward_warp<kMax, kW>(col, y, d, lane, nv);
  y = chol::backward_warp<kMax, kW>(row, y, d, lane, nv);
  if (mine) x[bb * nv + lane] = y;
}

template <int kMax, int kW>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlockSmall)
spd_solve_kernel_warp(const float* __restrict__ M, const float* __restrict__ rhs,
                      float* __restrict__ x, int B, int nv) {
  solve_warp<kMax, kW, true>(M, rhs, x, B, nv);
}

template <int kMax, int kW>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlockSmall)
solve_kernel_warp(const float* __restrict__ U, const float* __restrict__ rhs,
                  float* __restrict__ x, int B, int nv) {
  solve_warp<kMax, kW, false>(U, rhs, x, B, nv);
}

// ---- nv > 32: blocked, one block of kThreads threads per matrix; the launch
// bounds keep kMinBlocks blocks resident per SM (registers permitting)
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
factor_kernel_blocked(const float* __restrict__ M, float* __restrict__ Uout, int nv) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = kThreads;
  const int ld = (nv + 3) & ~3;
  extern __shared__ __align__(16) float U[];  // ld x ld, upper triangle used
  chol::load_upper_async(U, ld, M + (size_t)b * nv * nv, nv, tid, nt);
  chol::copy_async_wait();
  __syncthreads();
  chol::factor_blocked<kThreads>(U, ld, nv);
  float* Ub = Uout + (size_t)b * nv * nv;
  for (int i = tid / nv, j = tid - (tid / nv) * nv; i < nv; chol::advance(i, j, nt, nv))
    Ub[i * nv + j] = (j >= i) ? U[i * ld + j] : 0.f;
}

template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spd_solve_kernel_blocked(const float* __restrict__ M, const float* __restrict__ rhs,
                         float* __restrict__ x, int nv) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int ld = (nv + 3) & ~3;
  extern __shared__ __align__(16) float U[];  // ld x ld, upper triangle used; then y
  float* y = U + ld * ld;
  chol::load_rows_async<kThreads>(U, chol::Square{ld}, M + (size_t)b * nv * nv, nv, 0, nv);
  for (int i = tid; i < nv; i += kThreads) y[i] = rhs[(size_t)b * nv + i];
  chol::copy_async_wait();
  __syncthreads();
  chol::factor_blocked<kThreads>(U, ld, nv);
  chol::forward_blocked<kThreads, false>(U, chol::Square{ld}, y, nv);
  chol::backward_blocked<kThreads>(U, chol::Square{ld}, y, nv);
  for (int i = tid; i < nv; i += kThreads) x[(size_t)b * nv + i] = y[i];
}

template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
solve_kernel_blocked(const float* __restrict__ Uin, const float* __restrict__ rhs,
                     float* __restrict__ x, int nv) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int np = (nv + kNb - 1) / kNb;
  extern __shared__ __align__(16) float P[];  // upper triangle by panels, then y
  float* y = P + chol::Panels{nv}(nv - 1, nv);
  const float* Ub = Uin + (size_t)b * nv * nv;
  for (int p = 0; p < np; ++p) {  // one cp.async group per panel of rows
    chol::load_rows_async<kThreads>(P, chol::Panels{nv}, Ub, nv, p * kNb,
                                    min(nv, (p + 1) * kNb));
    chol::copy_async_commit();
  }
  for (int i = tid; i < nv; i += kThreads) y[i] = rhs[(size_t)b * nv + i];
  chol::WaitPending<15>::run(np - 1);  // panel 0
  __syncthreads();
  chol::forward_blocked<kThreads, true>(P, chol::Panels{nv}, y, nv);
  chol::backward_blocked<kThreads>(P, chol::Panels{nv}, y, nv);
  for (int i = tid; i < nv; i += kThreads) x[(size_t)b * nv + i] = y[i];
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// matrices per 128-thread block of the register solves
constexpr int per_block(int kW) { return kWarp * kWarpsPerBlockSmall / kW; }

template <bool kFactor, int kMax, int kW>
int launch_warp(const float* A, const float* rhs, float* x, int B, int nv, cudaStream_t s) {
  const int grid = (B + per_block(kW) - 1) / per_block(kW), threads = kWarp * kWarpsPerBlockSmall;
  if (kFactor)
    spd_solve_kernel_warp<kMax, kW><<<grid, threads, 0, s>>>(A, rhs, x, B, nv);
  else
    solve_kernel_warp<kMax, kW><<<grid, threads, 0, s>>>(A, rhs, x, B, nv);
  return (int)cudaGetLastError();
}

// the register solves (nv <= 32) on `stream`
template <bool kFactor>
int launch_solve_warp(const float* A, const float* rhs, float* x, int B, int nv,
                      cudaStream_t s) {
  if (nv <= 8) return launch_warp<kFactor, 8, kSeg8>(A, rhs, x, B, nv, s);
  if (nv <= 16) return launch_warp<kFactor, 16, kSeg16>(A, rhs, x, B, nv, s);
  return launch_warp<kFactor, 32, kWarp>(A, rhs, x, B, nv, s);
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

// Solves B systems M x = b on `stream` (M row-major (nv, nv) SPD, read only
// above the diagonal; b and x (nv,) per matrix). The launch geometry comes
// from ops/cholesky.py::spd_solve_geometry: for nv <= 32 `threads` is 128
// and `smem` 0; above, factor_batched's threads and 4 (ld^2 + ld) bytes, ld
// = nv rounded up to a multiple of 4. Returns the cudaGetLastError() code
// of the launch (0 on success), or cudaErrorInvalidValue for a geometry the
// kernels do not take.
extern "C" int spd_solve_launch(const float* M, const float* rhs, float* x, int B, int nv,
                                int threads, int smem, void* stream) {
  if (B == 0 || nv == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nv <= 32) {
    if (threads != kWarp * kWarpsPerBlockSmall || smem != 0) return (int)cudaErrorInvalidValue;
    return launch_solve_warp<true>(M, rhs, x, B, nv, s);
  }
  const int ld = (nv + 3) & ~3;
  if ((threads != 128 && threads != 256) || threads < nv - kNb || smem != 4 * (ld * ld + ld))
    return (int)cudaErrorInvalidValue;
  auto kernel =
      threads == 256 ? spd_solve_kernel_blocked<256, 2> : spd_solve_kernel_blocked<128, 8>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, threads, smem, s>>>(M, rhs, x, nv);
  return (int)cudaGetLastError();
}

// Solves U^T U x = b on `stream` for B upper factors U (nv, nv), read only
// on and above the diagonal, and b (nv,). The launch geometry comes from
// ops/cholesky.py::solve_geometry: for nv <= 32 `threads` is 128 and `smem`
// 0; above, 128 threads and the bytes of U's upper triangle by panels and
// b. Returns the
// cudaGetLastError() code of the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernels do not take.
extern "C" int cholesky_solve_launch(const float* U, const float* rhs, float* x, int B, int nv,
                                     int threads, int smem, void* stream) {
  if (B == 0 || nv == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nv <= 32) {
    if (threads != kWarp * kWarpsPerBlockSmall || smem != 0) return (int)cudaErrorInvalidValue;
    return launch_solve_warp<false>(U, rhs, x, B, nv, s);
  }
  const int k0 = (nv - 1) & ~(kNb - 1);  // the last panel
  if (threads != 128 || smem != 4 * (k0 * nv - k0 * (k0 - kNb) / 2 + (nv - k0) * (nv - k0) + nv))
    return (int)cudaErrorInvalidValue;
  auto kernel = solve_kernel_blocked<128, 8>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, threads, smem, s>>>(U, rhs, x, nv);
  return (int)cudaGetLastError();
}
