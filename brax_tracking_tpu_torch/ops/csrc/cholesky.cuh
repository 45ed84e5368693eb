// Cholesky pieces for Hopper (sm_90a), shared by the kernels of cholesky.cu:
// factor_batched (factor_kernel_warp, factor_kernel_blocked) writes the
// upper factor U (M = U^T U) out; spd_solve (spd_solve_kernel_warp,
// spd_solve_kernel_blocked) runs the same factor, keeps U on chip and
// solves; solve_batched (solve_kernel_warp, solve_kernel_blocked) solves
// from a U read from device memory. Every piece loads only the upper
// triangle of its matrix from device memory and uses nothing below the
// diagonal (a clamped shared-memory load there is selected away), so no
// value below it (NaN included) reaches an output.
//
// nv <= 32: one matrix per segment of kW lanes (kW = 32: one per warp), in
// registers, no shared memory and no barrier. Lane c holds column c of the
// upper triangle (col[r] = A[r, c], r <= c), read along the rows so that
// each load is coalesced across the lanes.
// - factor_warp: right-looking, one pivot at a time; the shuffles broadcast
//   row k of U at pivot k, so with kRows lane k keeps that row (row[j] =
//   U[k, j]) for free.
// - forward_warp (U^T y = b, right-looking): y_k from lane k by one
//   shuffle; the later lanes subtract col[k] y_k.
// - backward_warp (U x = y, right-looking): x_k from lane k by one
//   shuffle; the earlier lanes subtract row[k] x_k from the row they hold.
//   The other choice, a segment reduction of col[k] x_j over the lanes
//   j > k, puts log2(kW) dependent shuffles on every step where this puts
//   one; the rows come from the factor's broadcasts (spd_solve) or from a
//   second read of the same sectors of U (solve_batched).
//
// nv > 32: one block per matrix in shared memory, in panels of kNb = 16
// rows.
// - factor_blocked: right-looking and blocked, two barriers per panel
//   (cholesky.cu says more), on the padded square layout (row stride and
//   rows a multiple of 4, 16-byte tiles).
// - forward_blocked / backward_blocked: per panel, warp 0 solves the 16 x
//   16 diagonal triangle in registers (forward_warp / backward_warp), then
//   every thread applies the panel to the rest as a 16-term update, one
//   thread per later column (forward, y[j] -= sum_q U[k0 + q, j] y[k0 + q],
//   reading along the panel's rows) or per earlier row (backward, y[i] -=
//   sum_q U[i, k0 + q] x[k0 + q], 16 consecutive floats of row i), each
//   thread's 16 loads issued before its multiply-adds: two barriers per
//   panel, 2 ceil(nv / 16) per substitution where one pivot per step takes
//   nv. The triangle's loads are unconditional (from clamped places, then
//   selected), so no load waits behind a branch, and a whole panel's 16
//   steps are unrolled without a test each. Both run on either layout: the
//   factor's square one (spd_solve) or Panels, the upper triangle with each
//   panel's rows from the panel's first column (solve_batched).
//
// Each entry receives its updates in pivot order, as in the plain versions
// (ops/cholesky.py: cholesky_factor_reference, cholesky_solve_reference),
// but contracted to fused multiply-adds, with the hardware rsqrt in the
// factor and a multiply by the correctly rounded reciprocal of the pivot in
// the substitutions, so they agree with the plain versions to rounding.

#pragma once

#include <cuda_runtime.h>

namespace chol {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNb = 16;  // panel rows of the blocked pieces

// ---------------------------------------------------------------------------
// nv <= 32: registers
// ---------------------------------------------------------------------------

// col[r] = A[r, lane] for r <= lane < nv, zero elsewhere (and everywhere
// unless `mine`); A row-major (nv, nv)
template <int kMax>
__device__ __forceinline__ void load_columns(float (&col)[kMax], const float* __restrict__ A,
                                             int lane, int nv, bool mine) {
#pragma unroll
  for (int r = 0; r < kMax; ++r) col[r] = (mine && r < nv && r <= lane) ? A[r * nv + lane] : 0.f;
}

// row[j] = A[lane, j] for lane <= j < nv, zero elsewhere (and everywhere
// unless `mine`)
template <int kMax>
__device__ __forceinline__ void load_row(float (&row)[kMax], const float* __restrict__ A,
                                         int lane, int nv, bool mine) {
#pragma unroll
  for (int j = 0; j < kMax; ++j) row[j] = (mine && j < nv && j >= lane) ? A[lane * nv + j] : 0.f;
}

// v[lane] without a dynamic register index
template <int kMax>
__device__ __forceinline__ float at_lane(const float (&v)[kMax], int lane) {
  float d = 0.f;
#pragma unroll
  for (int r = 0; r < kMax; ++r)
    if (r == lane) d = v[r];
  return d;
}

// In-register factor of the nv x nv matrix whose upper triangle the
// segment's lanes hold as columns (load_columns): column c becomes column
// c of U. With kRows, lane k also receives row k of U (row[j] = U[k, j] for
// j >= k, zero before).
template <int kMax, int kW, bool kRows>
__device__ __forceinline__ void factor_warp(float (&col)[kMax], float (&row)[kMax], int lane,
                                            int nv) {
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    if (k < nv) {
      const float c = rsqrtf(__shfl_sync(kFull, col[k], k, kW));
      col[k] *= c;  // row k of U (lanes >= k)
      if (kRows && lane == k) row[k] = col[k];
#pragma unroll
      for (int r = k + 1; r < kMax; ++r) {
        const float ukr = __shfl_sync(kFull, col[k], r, kW);  // U[k, r]
        if (r < nv && r <= lane) col[r] -= ukr * col[k];
        if (kRows && lane == k) row[r] = ukr;
      }
    }
  }
}

// U^T y = b over the segment: lane c holds column c of U (zero below
// row c), y = b_c and d = 1 / U[c, c] (0 in lanes >= nv); returns y_c.
// Straight-line steps: a lane before k subtracts 0 y_k.
template <int kMax, int kW>
__device__ __forceinline__ float forward_warp(const float (&col)[kMax], float y, float d,
                                              int lane, int nv) {
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    if (k < nv) {
      const float yk = __shfl_sync(kFull, y * d, k, kW);
      y = lane == k ? yk : fmaf(-col[k], yk, y);
    }
  }
  return y;
}

// U x = y over the segment: lane c holds row c of U (zero before column
// c), y = y_c and d = 1 / U[c, c]; returns x_c
template <int kMax, int kW>
__device__ __forceinline__ float backward_warp(const float (&row)[kMax], float y, float d,
                                               int lane, int nv) {
#pragma unroll
  for (int k = kMax - 1; k >= 0; --k) {
    if (k < nv) {
      const float xk = __shfl_sync(kFull, y * d, k, kW);
      y = lane == k ? xk : fmaf(-row[k], xk, y);
    }
  }
  return y;
}

// ---------------------------------------------------------------------------
// nv > 32: shared memory, panels of kNb rows
// ---------------------------------------------------------------------------

// the padded square layout of factor_blocked: (i, j) at i ld + j. Both
// layouts hold a row's columns one after another and the rows of a panel
// (k0 a multiple of kNb) at the stride stride(k0).
struct Square {
  int ld;
  __device__ __forceinline__ int operator()(int i, int j) const { return i * ld + j; }
  __device__ __forceinline__ int stride(int) const { return ld; }
};

// the upper triangle by panels: panel p (rows k0 = p kNb ...) as a block of
// row stride nv - k0 from column k0, the panels one after another (half the
// square's floats plus the panels' diagonal blocks; affine within a panel)
struct Panels {
  int nv;
  __device__ __forceinline__ int operator()(int i, int j) const {
    const int k0 = i & ~(kNb - 1);
    return k0 * nv - ((k0 * (k0 - kNb)) >> 1) + (i - k0) * (nv - k0) + (j - k0);
  }
  __device__ __forceinline__ int stride(int k0) const { return nv - k0; }
};

// (i, j) moved on by n elements of a row-major matrix with nv columns
__device__ __forceinline__ void advance(int& i, int& j, int n, int nv) {
  j += n;
  while (j >= nv) {
    j -= nv;
    ++i;
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

// closes this thread's current group of copies
__device__ __forceinline__ void copy_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void copy_async_wait() {
  copy_async_commit();
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// waits until at most min(n, N) of this thread's groups are in flight
// (wait_group takes an immediate)
template <int N>
struct WaitPending {
  static __device__ __forceinline__ void run(int n) {
#ifdef __CUDA_ARCH__
    if (n >= N)
      asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
    else
      WaitPending<N - 1>::run(n);
#endif
  }
};
template <>
struct WaitPending<0> {
  static __device__ __forceinline__ void run(int) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
  }
};

// cp.async of the upper triangle of the row-major (nv, nv) A into the
// square layout U (row stride ld), consecutive threads on consecutive
// elements; no commit, no wait
__device__ __forceinline__ void load_upper_async(float* U, int ld, const float* __restrict__ A,
                                                 int nv, int tid, int nt) {
  for (int i = tid / nv, j = tid - (tid / nv) * nv; i < nv; advance(i, j, nt, nv))
    if (j >= i) copy_async(&U[i * ld + j], A + i * nv + j);
}

// cp.async of rows [r0, r1) of the upper triangle of the row-major (nv, nv)
// A into the layout `at` at S: warp w copies rows r0 + w, r0 + w + nwarps,
// ..., its lanes on consecutive columns; no commit, no wait
template <int kThreads, class Layout>
__device__ __forceinline__ void load_rows_async(float* S, Layout at, const float* __restrict__ A,
                                                int nv, int r0, int r1) {
  const int lane = threadIdx.x & (kWarp - 1);
  for (int i = r0 + (int)(threadIdx.x >> 5); i < r1; i += kThreads / kWarp) {
    float* d = S + at(i, 0);
    const float* s = A + i * nv;
    for (int j = i + lane; j < nv; j += kWarp) copy_async(d + j, s + j);
  }
}

// In-place blocked factor of the upper triangle of U (square layout, row
// stride ld, a multiple of 4, 16-byte aligned, ceil(nv / 4) * 4 rows): U's
// upper triangle becomes the factor; nothing below the diagonal or past nv
// reaches it. Every thread of the kThreads-thread block calls it; it starts
// after a barrier that made U visible and ends with one. Each thread solves
// at most one panel column to the right of the diagonal block (kThreads >=
// nv - kNb: the factor and SPD-solve kernels), or with kLoop the columns
// tid, tid + kThreads, ... (any nv: the solve kernel's damped tail), each
// column by the same operations.
template <int kThreads, bool kLoop = false>
__device__ __forceinline__ void factor_blocked(float* U, int ld, int nv) {
  const int tid = threadIdx.x, nt = kThreads;
  const int lane = tid & (kWarp - 1), warp = tid >> 5;
  for (int k0 = 0; k0 < nv; k0 += kNb) {
    const int nb = min(kNb, nv - k0);
    // 1. the diagonal block (lane c < nb holds column k0 + c) and a panel
    // column j to its right per thread, in one pivot loop (with kLoop once
    // per column, the block factored again each time); a warp with no panel
    // column skips it (but warp 0, which writes the block)
    const int c = lane < nb ? lane : 0;
    float col[kNb];
    auto columns = [&](int j) {
      const bool has_col = j < nv;
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
    };
    const int jw = k0 + kNb + warp * kWarp;  // the warp's first column
    if constexpr (kLoop) {
      for (int j = jw; j < nv || (warp == 0 && j == k0 + kNb); j += nt) columns(j + lane);
    } else if (warp == 0 || jw < nv) {
      columns(jw + lane);
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
}

// U^T y = b in place on the shared y[0, nv), U's upper triangle in shared
// memory at `at`. Every thread of the block calls it, after a barrier that
// made y and panel 0's rows visible; it ends with a barrier. With kStaged,
// the rows of panel p + 1 are this thread's (p + 1)-th cp.async group of
// ceil(nv / kNb), awaited before the barrier that ends panel p.
template <int kThreads, bool kStaged, class Layout>
__device__ __forceinline__ void forward_blocked(const float* U, Layout at, float* y, int nv) {
  const int tid = threadIdx.x, lane = tid & (kWarp - 1);
  const int np = (nv + kNb - 1) / kNb;
  for (int p = 0; p < np; ++p) {
    const int k0 = p * kNb, nb = min(kNb, nv - k0);
    if (tid < kWarp) {
      // every lane loads (from clamped places, then selects): no branch
      const bool mine = lane < nb;
      const float* Uc = U + at(k0, k0 + min(lane, nb - 1));  // column k0 + c
      const int rs = at.stride(k0);
      float col[kNb];
#pragma unroll
      for (int r = 0; r < kNb; ++r) {
        const float u = Uc[(r < nb ? r : nb - 1) * rs];
        col[r] = (mine && r <= lane) ? u : 0.f;
      }
      const float d = mine ? __frcp_rn(Uc[min(lane, nb - 1) * rs]) : 0.f;
      const float b = mine ? y[k0 + lane] : 0.f;
      // a whole panel without a test per step
      const float v = nb == kNb ? forward_warp<kNb, kWarp>(col, b, d, lane, kNb)
                                : forward_warp<kNb, kWarp>(col, b, d, lane, nb);
      if (mine) y[k0 + lane] = v;
    }
    __syncthreads();
    // the panel's rows on the later entries (none after a partial panel),
    // every load of a column issued before its multiply-adds
    if (k0 + kNb < nv) {
      float v[kNb];
#pragma unroll
      for (int q = 0; q < kNb; ++q) v[q] = y[k0 + q];
      const int rs = at.stride(k0);
      for (int j = k0 + kNb + tid; j < nv; j += kThreads) {
        const float* Uj = U + at(k0, j);
        float u[kNb];
#pragma unroll
        for (int q = 0; q < kNb; ++q) u[q] = Uj[q * rs];
        float s = y[j];
#pragma unroll
        for (int q = 0; q < kNb; ++q) s = fmaf(-u[q], v[q], s);
        y[j] = s;
      }
    }
    if (kStaged) WaitPending<15>::run(np - 2 - p);
    __syncthreads();
  }
}

// U x = y in place on the shared y[0, nv) (x replaces y), U as in
// forward_blocked, every row present. Every thread of the block calls it
// after a barrier; it ends with a barrier.
template <int kThreads, class Layout>
__device__ __forceinline__ void backward_blocked(const float* U, Layout at, float* y, int nv) {
  const int tid = threadIdx.x, lane = tid & (kWarp - 1);
  const int np = (nv + kNb - 1) / kNb;
  for (int p = np - 1; p >= 0; --p) {
    const int k0 = p * kNb, nb = min(kNb, nv - k0);
    if (tid < kWarp) {
      const bool mine = lane < nb;
      const float* Ur = U + at(k0 + min(lane, nb - 1), k0);  // row k0 + c
      float row[kNb];
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        const float u = Ur[j < nb ? j : nb - 1];
        row[j] = (mine && j >= lane && j < nb) ? u : 0.f;
      }
      const float d = mine ? __frcp_rn(Ur[min(lane, nb - 1)]) : 0.f;
      const float b = mine ? y[k0 + lane] : 0.f;
      const float v = nb == kNb ? backward_warp<kNb, kWarp>(row, b, d, lane, kNb)
                                : backward_warp<kNb, kWarp>(row, b, d, lane, nb);
      if (mine) y[k0 + lane] = v;
    }
    __syncthreads();
    // the panel's columns on the earlier entries, the last pivot first (a
    // partial panel's missing columns load its last one and add 0)
    if (k0 > 0) {
      float v[kNb];
#pragma unroll
      for (int q = 0; q < kNb; ++q) {
        const float t = y[k0 + (q < nb ? q : nb - 1)];
        v[q] = q < nb ? t : 0.f;
      }
      for (int i = tid; i < k0; i += kThreads) {
        const float* Ui = U + at(i, k0);
        float u[kNb];
#pragma unroll
        for (int q = 0; q < kNb; ++q) u[q] = Ui[q < nb ? q : nb - 1];
        float s = y[i];
#pragma unroll
        for (int q = kNb - 1; q >= 0; --q) s = fmaf(-u[q], v[q], s);
        y[i] = s;
      }
    }
    __syncthreads();
  }
}

}  // namespace chol
