// The sweep operator's SPD inverse for Hopper (sm_90a), shared by
// spd_inverse.cu (spd_inverse, spd_inverse2) and cg_fused.cu (the solve
// kernel's M^-1: panels in its wide instances, several warps per env, and
// panels_warp in its one-warp instances past nv 16).
//
// Both run the plain version's scalar sweep (ops/cholesky.py::
// sweep_inverse_reference): pivots in order, per pivot k
//   S[k, k] <- 1 / S[k, k]; S[k, j] <- S[k, j] / S[k, k];
//   S[i, k] <- -S[i, k] / S[k, k]; S[i, j] <- S[i, j] - S[i, k] S[k, j] / S[k, k],
// regrouped so that every entry still takes its updates in that order and
// with those formulas:
// - sweep_warp: a matrix of up to kMax columns in the registers of a segment
//   of kW lanes (lane j holds column j); per pivot the segment takes S[k, k]
//   and column k from lane k by shuffles, one fused multiply-add per entry.
// - panels: a matrix in shared memory (row stride ld, a multiple of 4, and
//   zero past nv up to ld in both directions), in panels of kNb pivots with
//   two barriers per panel:
//   (1) warp 0 sweeps the kNb x kNb pivot block in registers (sweep_warp;
//       the last partial panel padded with the identity, so padded pivots
//       are exact no-ops), records each step's pivot column and scaled
//       pivot row (colk, rowk: kNb x kNb each) and writes the swept block;
//   (2) one thread per column outside the panel replays the kNb steps on
//       its kNb entries of the panel's rows, and one thread per row outside
//       the panel on its kNb entries of the panel's columns, in registers
//       (replay_item), each recording what the rest needs: the scaled pivot
//       row of each step (Rk, kNb x ld) and the pivot column, negated (Cn,
//       kNb x ld);
//   (3) every thread applies the kNb-deep update S += Cn^T Rk to the rest in
//       4 x 4 register tiles (0.125 shared-memory loads per FMA). Warp 0
//       updates the next panel's pivot block first and runs (1) of the next
//       panel on it while the other warps finish the rest, so the pivot
//       block's chain of dependent steps overlaps the update.
//   The whole square is updated (nv^3 multiply-adds where the symmetric half
//   would do), which keeps every tile on one rule. spd_inverse.cu sweeps in
//   panels of 16; the solve kernel in panels of 8, whose buffers (Rk and Cn,
//   2 x 8 x ld floats) fit beside its vectors up to layout 2's widest env.
// - panels_warp: the same three steps on one warp at any row stride (see
//   below), with no overlap of (1) and (3).
// Shortcuts that read a row in place of a column lost accuracy in float32
// (the swept matrix is symmetric up to sign only to rounding): the TPU
// kernel's block form S -= C A^-1 R with C = s R^T left residuals
// ||M X - I|| 10-300x the scalar sweep's at nv 33-146 on the card
// (PERF.md). The plain version of the grouping is ops/cholesky.py::
// _sweep_inverse_panels_reference. Each update is one fused multiply-add,
// c - a b with a the pivot column's entry and b the scaled pivot row's:
// the one-warp sweeps of cg_fused.cu form every entry by the same
// operation, so the solve kernel's wide M^-1 is bitwise its one-warp M^-1;
// against the plain version (a product, then a difference) the kernels
// agree to rounding, not bitwise.

#pragma once

#include <cuda_runtime.h>

namespace sweep {

constexpr int kWarp = 32;
constexpr unsigned kMask = 0xffffffffu;

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

// Warp 0 of a block: sweeps the pivot block of the panel at kb (nb real
// pivots, padded with the identity to kNb) in registers, records its steps
// in colk and rowk (sweep_warp) and writes the swept block back to S.
template <int kNb>
__device__ __forceinline__ void pivot_block(float* S, int ld, int kb, int nb, float* colk,
                                            float* rowk, int lane) {
  const int cl = lane & (kNb - 1);  // lanes past kNb repeat lanes 0..kNb-1
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

// Step (2) of a panel for one item outside its pivot block: the kNb steps
// recorded in colk and rowk replayed in registers on the item's kNb entries
// e[q es] (zero past nb), which are written back, with each step's record
// written to rec[k rs]. A column item (the panel's rows at one column)
// records the scaled pivot-row entry r = v[k] / S[k, k], a row item (the
// panel's columns at one row) the negated pivot-column entry. The column
// replay takes fmaf(-colk[k, q], r, v[q]), the row replay fmaf(-v[k],
// rowk[k, q], v[q]): the same rounding of the same product, so both are one
// loop.
template <int kNb>
__device__ __forceinline__ void replay_item(float* e, int es, int nb, bool is_col,
                                            const float* colk, const float* rowk, float* rec,
                                            int rs) {
  const float* tab = is_col ? colk : rowk;
  float v[kNb], out[kNb];
#pragma unroll
  for (int q = 0; q < kNb; ++q) {
    const float t = e[min(q, nb - 1) * es];
    v[q] = q < nb ? t : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    float m[kNb];  // step k's pivot column (column items) or scaled pivot row
#pragma unroll
    for (int q4 = 0; q4 < kNb / 4; ++q4) {
      const float4 t = reinterpret_cast<const float4*>(tab + k * kNb)[q4];
      m[4 * q4] = t.x;
      m[4 * q4 + 1] = t.y;
      m[4 * q4 + 2] = t.z;
      m[4 * q4 + 3] = t.w;
    }
    const float d = rowk[k * kNb + k];  // 1 / S[k, k]
    const float s = is_col ? v[k] * d : v[k];
#pragma unroll
    for (int q = 0; q < kNb; ++q)
      if (q != k) v[q] = fmaf(-m[q], s, v[q]);
    v[k] = is_col ? s : -s * d;
    out[k] = is_col ? s : -s;
  }
#pragma unroll
  for (int k = 0; k < kNb; ++k) rec[k * rs] = out[k];
#pragma unroll
  for (int q = 0; q < kNb; ++q)
    if (q < nb) e[q * es] = v[q];
}

// The 4 x 4 tile of S at (i0, j0) takes a panel's kNb updates:
// S[i, j] += sum_k Cn[k, i] Rk[k, j] (Cn holds the pivot column negated)
template <int kNb>
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

// S <- S^-1 in place for the nv x nv SPD matrix in shared memory (row
// stride ld, a multiple of 4, zero past nv up to ld in both directions; S,
// Rk, Cn, colk and rowk 16-byte aligned), by every thread of a block of
// kThreads; Rk and Cn hold kNb x ld floats each, colk and rowk kNb x kNb.
// Called by all threads after a barrier that follows the last write of S;
// returns after a barrier.
template <int kThreads, int kNb>
__device__ __forceinline__ void panels(float* S, int ld, int nv, float* Rk, float* Cn,
                                       float* colk, float* rowk) {
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int T = ld >> 2;  // 4 x 4 tiles per row (and column)
  if (warp == 0) pivot_block<kNb>(S, ld, 0, min(kNb, nv), colk, rowk, lane);
  __syncthreads();

  for (int kb = 0; kb < nv; kb += kNb) {
    const int nb = min(kNb, nv - kb);
    const int pend = min(kb + kNb, ld);  // the panel's columns: [kb, pend)
    const int nc = ld - (pend - kb);     // rows (and columns) outside the panel
    // (2) the panel's rows at the columns outside it (one thread per column
    // x), then its columns at the rows outside it (one thread per row x):
    // the pivot block's kNb steps replayed on kNb entries in registers
    for (int w = tid; w < 2 * nc; w += kThreads) {
      const bool is_col = w < nc;
      const int wc = is_col ? w : w - nc;
      const int x = wc < kb ? wc : wc + (pend - kb);
      replay_item<kNb>(is_col ? S + kb * ld + x : S + x * ld + kb, is_col ? ld : 1, nb, is_col,
                       colk, rowk, (is_col ? Rk : Cn) + x, ld);
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
      if (lane < tq * tq)
        update_tile<kNb>(S, Cn, Rk, ld, nk + 4 * (lane / tq), nk + 4 * (lane % tq));
      __syncwarp();
      pivot_block<kNb>(S, ld, nk, min(kNb, nv - nk), colk, rowk, lane);
    } else {
      const int t0 = next ? tid - kWarp : tid, nt = next ? kThreads - kWarp : kThreads;
      for (int t = t0; t < Tn * Tn; t += nt) {
        const int I = t / Tn, J = t - I * Tn;
        if (I >= tk && I < tk + tq && J >= tk && J < tk + tq) continue;  // warp 0's
        update_tile<kNb>(S, Cn, Rk, ld, 4 * (I < tk ? I : I + tp), 4 * (J < tk ? J : J + tp));
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// panels_warp: the panel sweep on one warp (the one-warp solve core past
// nv 16), in panels's grouping: per panel of kNb pivots at kb (nb real, the
// last partial one padded with the identity)
//   (1) the pivot block swept in registers (pivot_block: colk, rowk);
//   (2) the kNb steps replayed on the panel's rows and columns outside the
//       block, one lane per item and all its steps in registers, then the
//       scaled pivot rows (Rk) and negated pivot columns (Cn) written;
//   (3) the rank-kNb update of the rest in 4 x 4 register tiles,
// with three warp barriers per panel in place of the two per pivot of a
// row-at-a-time sweep. S keeps its own row stride ld (the solve core's is
// odd, so that its lane-per-row products read S free of bank conflicts):
// the tiles read and write S by scalar loads. Rk and Cn are indexed in the
// numbering of the rows outside the panel (row c below kb, c + nb past it),
// at the row stride warp_panel_ld, a multiple of 4, so their tiles' reads
// are float4s; only the nv rows and columns of S are read or written (no
// padding). Every entry takes the same fused multiply-adds in the same
// order as in panels, so the two give bitwise the same S^-1.

// The row stride of panels_warp's Rk and Cn: the most rows outside a panel
// (nv less the last panel's width), rounded up to a multiple of 4.
template <int kNb>
__device__ __host__ constexpr int warp_panel_ld(int nv) {
  return (nv - ((nv - 1) % kNb + 1) + 3) & ~3;
}

// Floats of panels_warp's buffers: Rk and Cn (kNb x warp_panel_ld each),
// colk and rowk (kNb x kNb each).
template <int kNb>
__device__ __host__ constexpr int warp_panel_floats(int nv) {
  return 2 * kNb * warp_panel_ld<kNb>(nv) + 2 * kNb * kNb;
}

// The 4 x 4 tile at (i0, j0) of the numbering of the nc rows (and columns)
// outside the panel of nb pivots at kb takes the panel's kNb updates:
// S[i, j] += sum_k Cn[k, i] Rk[k, j]. Entries past nc are loaded from a
// clamped index and never stored.
template <int kNb>
__device__ __forceinline__ void update_tile_skip(float* S, int ld, const float* Cn,
                                                 const float* Rk, int ldb, int i0, int j0,
                                                 int kb, int nb, int nc) {
  int ro[4], co[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = min(i0 + r, nc - 1), j = min(j0 + r, nc - 1);
    ro[r] = (i < kb ? i : i + nb) * ld;
    co[r] = j < kb ? j : j + nb;
  }
  float a[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[r][c] = S[ro[r] + co[c]];
  // 4 steps' loads in flight at a time: fully unrolled, their 64 registers
  // made the one-warp instances spill (12-16 B) at the 128-register cap
#pragma unroll 4
  for (int k = 0; k < kNb; ++k) {
    const float4 ci = *reinterpret_cast<const float4*>(&Cn[k * ldb + i0]);
    const float4 rj = *reinterpret_cast<const float4*>(&Rk[k * ldb + j0]);
    const float vi[4] = {ci.x, ci.y, ci.z, ci.w};
    const float vj[4] = {rj.x, rj.y, rj.z, rj.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[r][c] = fmaf(vi[r], vj[c], a[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (i0 + r < nc && j0 + c < nc) S[ro[r] + co[c]] = a[r][c];
}

// S <- S^-1 in place for the nv x nv SPD matrix in shared memory (row
// stride ld, any) by one warp; buf holds warp_panel_floats<kNb>(nv) floats,
// 16-byte aligned: Rk and Cn (kNb x warp_panel_ld<kNb>(nv) each), colk and
// rowk (kNb x kNb each). Called by the whole warp after a __syncwarp that
// follows the last write of S; returns after one.
template <int kNb>
__device__ __forceinline__ void panels_warp(float* S, int ld, int nv, float* buf) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int ldb = warp_panel_ld<kNb>(nv);
  float* const Rk = buf;
  float* const Cn = Rk + kNb * ldb;
  float* const colk = Cn + kNb * ldb;
  float* const rowk = colk + kNb * kNb;
  for (int kb = 0; kb < nv; kb += kNb) {
    const int nb = min(kNb, nv - kb);
    const int nc = nv - nb;  // rows (and columns) outside the panel
    pivot_block<kNb>(S, ld, kb, nb, colk, rowk, lane);
    __syncwarp();

    // (2) item w < nc: the panel's rows at column x, each step's scaled
    // pivot-row entry into Rk; item w >= nc: the panel's columns at row x,
    // each step's negated pivot-column entry into Cn
    for (int w = lane; w < 2 * nc; w += kWarp) {
      const bool is_col = w < nc;
      const int wc = is_col ? w : w - nc;
      const int x = wc < kb ? wc : wc + nb;
      replay_item<kNb>(is_col ? S + kb * ld + x : S + x * ld + kb, is_col ? ld : 1, nb, is_col,
                       colk, rowk, (is_col ? Rk : Cn) + wc, ldb);
    }
    __syncwarp();

    // (3) the rest: 4 x 4 tiles of the numbering outside the panel
    const int tn = (nc + 3) >> 2;
    for (int t = lane; t < tn * tn; t += kWarp) {
      const int I = t / tn;
      update_tile_skip<kNb>(S, ld, Cn, Rk, ldb, 4 * I, 4 * (t - I * tn), kb, nb, nc);
    }
    __syncwarp();
  }
}

}  // namespace sweep
