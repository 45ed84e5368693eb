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
// multiply by it whole).
// - nv <= 32: registers, no shared memory, no barrier. A unit lives in one
//   segment of kW lanes (8 up to nv = 8, 16 up to 16, else 32: 4 or 2
//   units per warp at the ballmuscle's 7 and the minirat's 10); lane j
//   holds column j. Per pivot k the segment takes S[k, k] and column k
//   from lane k by shuffles and applies one fused multiply-add per entry
//   (sweep_warp). Widths are templated on the segment, so registers are
//   indexed statically, and a full width class runs every pivot without a
//   test per step.
// - nv > 32: one block per unit, the matrix in shared memory (row stride
//   and rows padded to a multiple of 4 with zeros, for 16-byte tiles),
//   staged by cp.async with every copy in flight at once, and swept in
//   panels of kNb = 16 pivots with two barriers per panel (20 at nv = 146,
//   where one barrier pair per pivot took 292):
//   (1) warp 0 sweeps the 16 x 16 pivot block in registers (sweep_warp;
//       the last partial panel padded with the identity, so padded pivots
//       are exact no-ops), records each step's pivot column and scaled
//       pivot row (2 x 16 x 16 floats) and writes the swept block;
//   (2) one thread per column outside the panel replays the 16 steps on
//       its 16 entries of the panel's rows, and one thread per row outside
//       the panel on its 16 entries of the panel's columns, in registers,
//       each recording what the rest needs: the scaled pivot row of each
//       step (Rk, 16 x ld) and the pivot column, negated (Cn, 16 x ld);
//   (3) every thread applies the 16-deep update S += Cn^T Rk to the rest in
//       4 x 4 register tiles (0.125 shared-memory loads per FMA). Warp 0
//       updates the next panel's pivot block first and runs (1) of the next
//       panel on it while the other warps finish the rest, so the pivot
//       block's chain of 16 dependent steps overlaps the update.
//   So every entry receives its updates in the scalar sweep's pivot order
//   and with its formulas: the kernel is the scalar sweep regrouped, as
//   accurate as it. Shortcuts that read a row in place of a column lost
//   accuracy in float32 (the swept matrix is symmetric up to sign only to
//   rounding): the TPU kernel's form S -= C A^-1 R with C = s R^T (s = -1
//   on the pivots swept before the panel) left residuals ||M X - I|| 10-300x
//   the scalar sweep's at nv 33-146 on the card (PERF.md), and deriving the
//   panel's columns from its rows also failed chip_smoke.py's SPD_FACTOR
//   gate in a float32 rehearsal on the CPU.
//   The whole square is updated (nv^3 multiply-adds where the symmetric
//   half would do), which keeps every tile on one rule.
// The plain versions: ops/cholesky.py::sweep_inverse_reference (the scalar
// sweep, the wrappers' CPU path) and _sweep_inverse_panels_reference (the
// blocked path's grouping). The kernels contract to fused multiply-adds and
// group pivots in panels, so they agree with them to rounding, not bitwise.

#include <cuda_runtime.h>

#include "cholesky.cuh"  // chol::copy_async

namespace {

constexpr int kWarp = 32;
constexpr unsigned kMask = 0xffffffffu;
constexpr int kNb = 16;             // pivots per panel of the blocked sweep
constexpr int kSmallThreads = 128;  // threads per block of the register sweep

// In-place sweep of the matrix whose columns the segment's kW lanes hold
// (lane j: c[i] = S[i, j]), in the plain version's pivot order and update
// formulas. kFullWidth: every one of the kMax pivots is swept (nv == kMax,
// or an identity-padded block), with no test per step; otherwise the first
// nv. Lanes past nv hold zero columns and stay zero. With kRecord the
// segment's first kW lanes of the warp write, for each step k, the pivot
// column before the step (colk[k kMax + i] = S[i, k]) and the scaled pivot
// row (rowk[k kMax + j] = S[k, j] / S[k, k], 1 / S[k, k] at j = k).
template <int kMax, int kW, bool kFullWidth, bool kRecord = false>
__device__ __forceinline__ void sweep_warp(float (&c)[kMax], int lane, int nv,
                                           float* colk = nullptr, float* rowk = nullptr) {
  const int n = kFullWidth ? kMax : nv;
  const bool writer = kRecord && (threadIdx.x & (kWarp - 1)) < kW;
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    if (k < n) {
      const bool pivot = lane == k;
      const float dinv = __frcp_rn(__shfl_sync(kMask, c[k], k, kW));
      const float r = pivot ? dinv : c[k] * dinv;  // the new S[k, j]
      if (writer) {
        rowk[k * kMax + lane] = r;
        if (pivot) {
#pragma unroll
          for (int i = 0; i < kMax; ++i) colk[k * kMax + i] = c[i];
        }
      }
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        if (i != k && i < n) {
          const float ci = __shfl_sync(kMask, c[i], k, kW);  // S[i, k]
          // S[i, j] - S[i, k] S[k, j] / S[k, k]; in lane k, -S[i, k] / S[k, k]
          c[i] = fmaf(-ci, r, pivot ? 0.f : c[i]);
        }
      }
      c[k] = r;
    }
  }
}

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
  sweep_warp<kMax, kW, kFullWidth>(c, lane, nv);
  if (live && col) {
    float* ob = (damped ? out1 : out0) + (size_t)b * nv * nv + lane;
#pragma unroll
    for (int r = 0; r < kMax; ++r)
      if (kFullWidth || r < nv) ob[r * nv] = c[r];
  }
}

// ---- nv > 32: one block per unit, the matrix S in shared memory (row
// stride ld), panels of kNb pivots

// Warp 0 of a block: sweeps the pivot block of the panel at kb (nb real
// pivots, padded with the identity to kNb) in registers, records its steps
// in colk and rowk (sweep_warp) and writes the swept block back to S.
__device__ __forceinline__ void pivot_block(float* S, int ld, int kb, int nb, float* colk,
                                            float* rowk, int lane) {
  const int cl = lane & (kNb - 1);  // lanes 16-31 repeat lanes 0-15
  float* A = S + kb * ld + kb + min(cl, nb - 1);
  float c[kNb];
#pragma unroll
  for (int q = 0; q < kNb; ++q) {
    const float v = A[min(q, nb - 1) * ld];
    c[q] = (q < nb && cl < nb) ? v : (q == cl ? 1.f : 0.f);
  }
  sweep_warp<kNb, kNb, true, true>(c, cl, kNb, colk, rowk);
  if (lane < nb) {
#pragma unroll
    for (int q = 0; q < kNb; ++q)
      if (q < nb) A[q * ld] = c[q];
  }
}

// The 4 x 4 tile of S at (i0, j0) takes a panel's kNb updates:
// S[i, j] += sum_k Cn[k, i] Rk[k, j]
__device__ __forceinline__ void update_tile(float* S, const float* Cn, const float* Rk, int ld,
                                            int i0, int j0) {
  float a[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 v = *reinterpret_cast<const float4*>(&S[(i0 + r) * ld + j0]);
    a[r][0] = v.x;
    a[r][1] = v.y;
    a[r][2] = v.z;
    a[r][3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const float4 ci = *reinterpret_cast<const float4*>(&Cn[k * ld + i0]);
    const float4 rj = *reinterpret_cast<const float4*>(&Rk[k * ld + j0]);
    const float vi[4] = {ci.x, ci.y, ci.z, ci.w};
    const float vj[4] = {rj.x, rj.y, rj.z, rj.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[r][c] = fmaf(vi[r], vj[c], a[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(&S[(i0 + r) * ld + j0]) =
        make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
}

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
  const int T = ld >> 2;  // 4 x 4 tiles per row (and column)
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
  if (warp == 0) pivot_block(S, ld, 0, min(kNb, nv), colk, rowk, lane);
  __syncthreads();

  for (int kb = 0; kb < nv; kb += kNb) {
    const int nb = min(kNb, nv - kb);
    const int pend = min(kb + kNb, ld);  // the panel's columns: [kb, pend)
    const int nc = ld - (pend - kb);     // rows (and columns) outside the panel
    // (2) the panel's rows at the columns outside it (one thread per column
    // x), then its columns at the rows outside it (one thread per row x):
    // the pivot block's 16 steps replayed on 16 entries in registers
    for (int w = tid; w < 2 * nc; w += kThreads) {
      const bool is_col = w < nc;
      const int wc = is_col ? w : w - nc;
      const int x = wc < kb ? wc : wc + (pend - kb);
      // entry q: S[kb + q, x] (column) or S[x, kb + q] (row); zero past nb
      float* e = is_col ? S + kb * ld + x : S + x * ld + kb;
      const int es = is_col ? ld : 1;
      float v[kNb];
#pragma unroll
      for (int q = 0; q < kNb; ++q) {
        const float t = e[min(q, nb - 1) * es];
        v[q] = q < nb ? t : 0.f;
      }
      if (is_col) {
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          float m[kNb];  // the pivot column of step k
#pragma unroll
          for (int q4 = 0; q4 < kNb / 4; ++q4) {
            const float4 t = reinterpret_cast<const float4*>(colk + k * kNb)[q4];
            m[4 * q4] = t.x;
            m[4 * q4 + 1] = t.y;
            m[4 * q4 + 2] = t.z;
            m[4 * q4 + 3] = t.w;
          }
          const float r = v[k] * rowk[k * kNb + k];
#pragma unroll
          for (int q = 0; q < kNb; ++q)
            if (q != k) v[q] = fmaf(-m[q], r, v[q]);
          v[k] = r;
          Rk[k * ld + x] = r;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          float rr[kNb];  // the scaled pivot row of step k
#pragma unroll
          for (int q4 = 0; q4 < kNb / 4; ++q4) {
            const float4 t = reinterpret_cast<const float4*>(rowk + k * kNb)[q4];
            rr[4 * q4] = t.x;
            rr[4 * q4 + 1] = t.y;
            rr[4 * q4 + 2] = t.z;
            rr[4 * q4 + 3] = t.w;
          }
          const float ck = v[k];
#pragma unroll
          for (int q = 0; q < kNb; ++q)
            if (q != k) v[q] = fmaf(-ck, rr[q], v[q]);
          v[k] = -ck * rr[k];
          Cn[k * ld + x] = -ck;
        }
      }
#pragma unroll
      for (int q = 0; q < kNb; ++q)
        if (q < nb) e[q * es] = v[q];
    }
    __syncthreads();

    // (3) the update on the 4 x 4 tiles outside the panel's rows and
    // columns, in the numbering that skips the panel's tp tile rows (and
    // columns). Warp 0 first updates the next panel's pivot block (tiles
    // [tk, tk + tq) of that numbering), then sweeps it (step (1) of the next
    // panel) while the other warps update the rest.
    const int tp = (pend - kb) >> 2, tk = kb >> 2;
    const int Tn = T - tp;
    const int nk = kb + kNb;
    const bool next = nk < nv;
    const int tq = next ? (min(nk + kNb, ld) - nk) >> 2 : 0;
    if (next && warp == 0) {
      if (lane < tq * tq) update_tile(S, Cn, Rk, ld, nk + 4 * (lane / tq), nk + 4 * (lane % tq));
      __syncwarp();
      pivot_block(S, ld, nk, min(kNb, nv - nk), colk, rowk, lane);
    } else {
      const int t0 = next ? tid - kWarp : tid, nt = next ? kThreads - kWarp : kThreads;
      for (int t = t0; t < Tn * Tn; t += nt) {
        const int I = t / Tn, J = t - I * Tn;
        if (I >= tk && I < tk + tq && J >= tk && J < tk + tq) continue;  // warp 0's
        update_tile(S, Cn, Rk, ld, 4 * (I < tk ? I : I + tp), 4 * (J < tk ? J : J + tp));
      }
    }
    __syncthreads();
  }

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
