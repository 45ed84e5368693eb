// Batched SPD inverse by the sweep operator for Hopper (sm_90a).
//
// Replaces the TPU kernels brax_tracking_tpu/ops/cholesky.py::inverse_batched
// (M^-1) and ::inverse2_batched (M^-1 and (M + diag(damp))^-1 from one
// staged M), both _inverse_kernel -> sweep_invert_ref (the blocked sweep).
//
// Bound (chip_smoke.py::spd_bound). Per inverse nv^3 + 2 nv^2 + nv FP32
// operations (the symmetric sweep: per pivot a reciprocal, the pivot row
// scaled, one multiply-add on each entry of a triangle; Cholesky inversion
// costs the same) against 8 nv^2 bytes (M read once, the inverse written
// once); the pair reads M once and writes two inverses, 12 nv^2 + 4 nv
// bytes against twice the operations. That is ~nv / 8 operations per byte
// for one inverse, below the H100's ~20 FP32 operations per byte up to nv ~
// 160: bound by bytes at the ballmuscle's nv = 7 (in practice by launch
// latency) and at the rodent's 73, and the pair by its operations at
// rodent_pair's 146. What holds a sweep far above that is its chain: nv
// dependent pivots, each of which changes every entry.
//
// Design. Every (matrix, which) pair is one unit of work: which = 1 inverts
// M + diag(damp), adding damp to the diagonal as it loads, so spd_inverse2
// is one launch and units 2b and 2b + 1 read the same M one after the other
// (the second from L2). Each unit writes its whole inverse (the callers
// multiply by it whole). The sweep itself is sweep.cuh's, shared with the
// solve kernel's wide instances:
// - nv <= 32: registers, no shared memory, no barrier. A unit lives in one
//   segment of kW lanes (8 up to nv = 8, 16 up to 16, else 32: 4 or 2
//   units per warp at the ballmuscle's 7 and the minirat's 10); lane j
//   holds column j (sweep::sweep_warp). Widths are templated on the
//   segment, so registers are indexed statically, and a full width class
//   runs every pivot without a test per step.
// - nv > 32: one block per unit, the matrix in shared memory (row stride
//   and rows padded to a multiple of 4 with zeros, for 16-byte tiles),
//   staged by cp.async with every copy in flight at once, and swept in
//   panels of kNb = 16 pivots with two barriers per panel (sweep::panels;
//   20 barriers at nv = 146, where one barrier pair per pivot took 292).
// The plain versions: ops/cholesky.py::sweep_inverse_reference (the scalar
// sweep, the wrappers' CPU path) and _sweep_inverse_panels_reference (the
// blocked path's grouping). The kernels contract to fused multiply-adds and
// group pivots in panels, so they agree with them to rounding, not bitwise.

#include <cuda_runtime.h>

#include "cholesky.cuh"  // chol::copy_async
#include "sweep.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kNb = 16;             // pivots per panel of the blocked sweep
constexpr int kSmallThreads = 128;  // threads per block of the register sweep

// ---- nv <= kMax: one unit per segment of kW lanes
template <int kMax, int kW, bool kFullWidth>
__global__ void __launch_bounds__(kSmallThreads)
spd_inverse_kernel_warp(const float* __restrict__ M, const float* __restrict__ damp,
                        float* __restrict__ out0, float* __restrict__ out1, int units, int nv,
                        int ninv) {
  const int lane = threadIdx.x & (kW - 1);
  const int u = (blockIdx.x * kSmallThreads + threadIdx.x) / kW;
  // every lane runs the shuffles (full masks); a segment past the last unit
  // inverts unit 0 again and stores nothing
  const bool live = u < units;
  const int uu = live ? u : 0;
  const int b = ninv == 2 ? uu >> 1 : uu;
  const bool damped = ninv == 2 && (uu & 1);
  const bool col = lane < nv;
  const float* Mb = M + (size_t)b * nv * nv + min(lane, nv - 1);
  float c[kMax];
  // loads from clamped places, then selects: no load waits behind a branch
#pragma unroll
  for (int r = 0; r < kMax; ++r) {
    const float v = Mb[(kFullWidth ? r : min(r, nv - 1)) * nv];
    c[r] = (col && (kFullWidth || r < nv)) ? v : 0.f;
  }
  if (damped) {
    const float d = col ? damp[lane] : 0.f;
#pragma unroll
    for (int r = 0; r < kMax; ++r)
      if (r == lane) c[r] += d;
  }
  sweep::sweep_warp<kMax, kW, kFullWidth>(c, lane, nv);
  if (live && col) {
    float* ob = (damped ? out1 : out0) + (size_t)b * nv * nv + lane;
#pragma unroll
    for (int r = 0; r < kMax; ++r)
      if (kFullWidth || r < nv) ob[r * nv] = c[r];
  }
}

// ---- nv > 32: one block per unit, the matrix S in shared memory (row
// stride ld), panels of kNb pivots

// One block of kThreads threads per unit; the launch bounds keep kMinBlocks
// blocks resident per SM (registers permitting)
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spd_inverse_kernel_blocked(const float* __restrict__ M, const float* __restrict__ damp,
                           float* __restrict__ out0, float* __restrict__ out1, int nv,
                           int ninv) {
  constexpr int kWarps = kThreads / kWarp;
  const int u = blockIdx.x;
  const int b = ninv == 2 ? u >> 1 : u;
  const bool damped = ninv == 2 && (u & 1);
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid >> 5;
  const int ld = (nv + 3) & ~3;
  // dynamic shared memory: S (ld x ld, zero past nv); Rk and Cn (kNb x ld
  // each); the pivot block's steps, colk and rowk (kNb x kNb each)
  extern __shared__ __align__(16) float sm[];
  float* S = sm;
  float* Rk = S + ld * ld;
  float* Cn = Rk + kNb * ld;
  float* colk = Cn + kNb * ld;
  float* rowk = colk + kNb * kNb;

  // M by cp.async, a row per warp, every copy in flight before the wait
  const float* Mb = M + (size_t)b * nv * nv;
  for (int i = warp; i < ld; i += kWarps)
    for (int j = lane; j < ld; j += kWarp) {
      if (i < nv && j < nv)
        chol::copy_async(&S[i * ld + j], Mb + i * nv + j);
      else
        S[i * ld + j] = 0.f;
    }
  chol::copy_async_wait();
  __syncthreads();
  if (damped) {
    for (int i = tid; i < nv; i += kThreads) S[i * ld + i] += damp[i];
    __syncthreads();
  }
  sweep::panels<kThreads, kNb>(S, ld, nv, Rk, Cn, colk, rowk);

  float* ob = (damped ? out1 : out0) + (size_t)b * nv * nv;
  for (int i = warp; i < nv; i += kWarps)
    for (int j = lane; j < nv; j += kWarp) ob[i * nv + j] = S[i * ld + j];
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int kMax, int kW>
int launch_warp(const float* M, const float* damp, float* out0, float* out1, int units, int nv,
                int ninv, cudaStream_t s) {
  const int per_block = kSmallThreads / kW;
  const int grid = (units + per_block - 1) / per_block;
  if (nv == kMax)
    spd_inverse_kernel_warp<kMax, kW, true>
        <<<grid, kSmallThreads, 0, s>>>(M, damp, out0, out1, units, nv, ninv);
  else
    spd_inverse_kernel_warp<kMax, kW, false>
        <<<grid, kSmallThreads, 0, s>>>(M, damp, out0, out1, units, nv, ninv);
  return (int)cudaGetLastError();
}

}  // namespace

// Inverts B row-major (nv, nv) SPD matrices on `stream`: out0 = M^-1 and,
// when ninv == 2, out1 = (M + diag(damp))^-1 (damp (nv,); with ninv == 1
// damp and out1 are not read and may be null). The launch geometry comes
// from ops/cholesky.py::inverse_geometry: for nv <= 32 `threads` is 128
// and `smem` 0; above, one block per (matrix, which) unit with 128 threads
// up to nv = 80 and 256 above, and `smem` = 4 (ld^2 + 2 * 16 ld + 2 * 16 * 16)
// bytes, ld = nv rounded up to a multiple of 4. Returns the
// cudaGetLastError() code of the launch (0 on success), or
// cudaErrorInvalidValue for a geometry or arguments the kernels do not take.
extern "C" int spd_inverse_launch(const float* M, const float* damp, float* out0, float* out1,
                                  int B, int nv, int ninv, int threads, int smem, void* stream) {
  if (B == 0 || nv == 0) return 0;
  if ((ninv != 1 && ninv != 2) || (ninv == 2 && (damp == nullptr || out1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int units = B * ninv;
  if (nv <= 32) {
    if (threads != kSmallThreads || smem != 0) return (int)cudaErrorInvalidValue;
    if (nv <= 8) return launch_warp<8, 8>(M, damp, out0, out1, units, nv, ninv, s);
    if (nv <= 16) return launch_warp<16, 16>(M, damp, out0, out1, units, nv, ninv, s);
    return launch_warp<32, kWarp>(M, damp, out0, out1, units, nv, ninv, s);
  }
  const int ld = (nv + 3) & ~3;
  if (threads != (nv <= 80 ? 128 : 256) || smem != 4 * (ld * ld + 2 * kNb * ld + 2 * kNb * kNb))
    return (int)cudaErrorInvalidValue;
  auto kernel = threads == 256 ? spd_inverse_kernel_blocked<256, 2>
                               : spd_inverse_kernel_blocked<128, 6>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<units, threads, smem, s>>>(M, damp, out0, out1, nv, ninv);
  return (int)cudaGetLastError();
}
