// The constraint jacobian J by its static sparsity, for the solve kernel's
// wide core (cg_fused.cu::cg_core_wide): its row pass (J x, one thread per
// row) and its J^T force (16-column chunks, one warp each).
//
// A contact row is J[r] = md[slot(r)] * ((P A) cdof): zero wherever the
// static +-1/0 support mask md of the slot's two bodies is zero, so it has
// the slot's few support dofs as entries (8-15 of nv 73-146 on the rodent
// files); a scalar limit row has one entry, jsign at its dof. The pattern
// is fixed with the model (ops/cg.py::j_pattern) and its tables reach the
// device once:
// - rec (nefc int4 {base, stride, col0, n}): row r's k-th entry (k < n) is
//   J[r, cols[col0 + k]] = vals[base + k stride], its columns ascending. The
//   rows of one slot share its columns and are stored entry-major (stride =
//   the slot's row count), so consecutive rows read consecutive values; a
//   limit row is a group of its own. The values take nnz floats, shared
//   memory in layout 1 and a (B, nnz) device scratch in layout 2.
// - chw (nch x nefc int2, nch = ceil(nv / 16)): for chunk ch and row r, the
//   value index of the row's first entry in [16 ch, 16 ch + 16) (x), and the
//   bits of its columns there (low 16 bits of y) with the row's stride (high
//   16 bits), so a row of a chunk takes one load to be skipped or placed and
//   its k-th column there is a __popc of its mask away, with no dynamic
//   indexing of registers.
// A dense J (cg_solve_batched's; kDense) needs none of the tables: its
// values are J dof-major, row r's entry at column v vals[v nefc + r].
//
// Both passes form every sum by the dense forms' operations in their order
// (cg_fused.cu::dot_row over ascending columns; matvec_t's per-lane row
// order and warp_sum_scatter16's butterfly), each term one fmaf. A column
// outside the pattern is a structural zero, whose dense term fmaf(+-0, x, s)
// leaves s as it is (s starts at +0, and +0 + -0 is +0 in round to
// nearest), so on finite inputs both are bitwise the dense forms; a
// non-finite input that the dense forms multiply by a structural zero may
// give NaN there and not here. tests/test_torch_jsparse_host.py runs these
// functions on the CPU (tests/host_cuda) bitwise against the dense forms.

#pragma once

#include <cuda_runtime.h>

namespace jsp {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// A row's entries: vals[base + k stride] at column cols[col0 + k], k < n.
struct Row {
  int base, stride, col0, n;
};

__device__ __forceinline__ Row row(const int4* rec, int r) {
  const int4 q = __ldg(rec + r);
  return {q.x, q.y, q.z, q.w};
}

// J[r, :] . x in dot_row's order (ascending columns); kDense: row r of a
// dense J's nv columns (rec and cols unread)
template <bool kDense>
__device__ __forceinline__ float row_dot(const float* vals, const int4* rec, const int* cols,
                                         int r, int nv, int nefc, const float* x) {
  const Row q = kDense ? Row{r, nefc, 0, nv} : row(rec, r);
  const float* v = vals + q.base;
  const int* c = cols + q.col0;
  float s = 0.f;
  // 8 entries' loads in flight: in layout 2 each is an L2 round trip
#pragma unroll 8
  for (int k = 0; k < q.n; ++k) s = fmaf(v[k * q.stride], x[kDense ? k : __ldg(c + k)], s);
  return s;
}

// The warp sums of 16 per-lane values by a transposing butterfly: at each
// level a lane keeps half of its values and trades the other half with its
// partner (8 + 4 + 2 + 1 + 1 shuffles instead of 16 x 5). Returns the sum of
// v[lane >> 1]: lanes 2c and 2c + 1 hold column c, bitwise equal (their last
// step adds the same two values).
__device__ __forceinline__ float warp_sum_scatter16(const float (&v)[16], int lane) {
  float w8[8], w4[4], w2[2];
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4, h1 = lane & 2;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    w8[q] = (h4 ? v[q + 8] : v[q]) + __shfl_xor_sync(kFull, h4 ? v[q] : v[q + 8], 16);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w4[q] = (h3 ? w8[q + 4] : w8[q]) + __shfl_xor_sync(kFull, h3 ? w8[q] : w8[q + 4], 8);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    w2[q] = (h2 ? w4[q + 2] : w4[q]) + __shfl_xor_sync(kFull, h2 ? w4[q] : w4[q + 2], 4);
  float w1 = (h1 ? w2[1] : w2[0]) + __shfl_xor_sync(kFull, h1 ? w2[0] : w2[1], 2);
  return w1 + __shfl_xor_sync(kFull, w1, 1);
}

// The lane's share of chunk ch of J^T f: its rows r = lane, lane + 32, ...
// in order, each adding f[r] times its entries in the chunk's 16 columns to
// acc (kDense: every column below nv; chw unread). A row's loads are issued
// from clamped entries before any is used, then the columns outside its
// mask are dropped by a select: a load behind a branch would wait for the
// one before it (in layout 2 a device-memory latency each).
template <bool kDense>
__device__ __forceinline__ void jt_chunk(const float* vals, const int2* chw, const float* f,
                                         int nv, int nefc, int ch, int lane, float (&acc)[16]) {
  const int2* words = chw + (size_t)ch * nefc;
  const int left = nv - 16 * ch;  // a dense row's columns in the chunk
  const unsigned dense_mask = left >= 16 ? 0xffffu : (1u << left) - 1u;
#pragma unroll 2
  for (int r = lane; r < nefc; r += kWarp) {
    const int2 w = kDense ? make_int2(16 * ch * nefc + r, (int)dense_mask | (nefc << 16))
                          : __ldg(words + r);
    const unsigned mask = (unsigned)w.y & 0xffffu;
    if (mask == 0u) continue;
    const int stride = (unsigned)w.y >> 16;
    const float fr = f[r];
    const float* v = vals + w.x;
    const int last = __popc(mask) - 1;
    float jv[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int k = kDense ? min(c, last) : min(__popc(mask & ((1u << c) - 1u)), last);
      jv[c] = v[k * stride];
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float t = fmaf(jv[c], fr, acc[c]);
      acc[c] = ((mask >> c) & 1u) ? t : acc[c];
    }
  }
}

// y = J^T f by kW warps: warp w takes matvec_t's 16-column chunks w, w + kW,
// ... (the lane's rows in order, then the transposing butterfly; lane 2c
// writes column c); no barrier.
template <bool kDense, int kW>
__device__ __forceinline__ void jt_f(const float* vals, const int2* chw, const float* f, float* y,
                                     int nv, int nefc, int lane, int warp) {
  for (int ch = warp; 16 * ch < nv; ch += kW) {
    float acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = 0.f;
    jt_chunk<kDense>(vals, chw, f, nv, nefc, ch, lane, acc);
    const float sum = warp_sum_scatter16(acc, lane);
    const int c = 16 * ch + (lane >> 1);
    if (!(lane & 1) && c < nv) y[c] = sum;
  }
}

}  // namespace jsp
