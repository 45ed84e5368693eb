// brax_tracking_tpu_torch/ops/csrc/jsparse.cuh's row pass and J^T force on
// a CPU, through the host stand-ins of cuda_runtime.h beside this file,
// beside the dense forms they replace in the solve kernel's wide core
// (cg_fused.cu::dot_row over every column, and matvec_t: each lane's rows in
// order, then warp_sum_scatter16), each term one fmaf as nvcc contracts
// them. Built and called by tests/test_torch_jsparse_host.py:
//   g++ -std=c++20 -O2 -ffp-contract=off -fno-strict-aliasing -pthread
//       -shared -fPIC -I tests/host_cuda -I brax_tracking_tpu_torch/ops/csrc
//       tests/host_cuda/jsparse_host.cc -o libjsparse_host.so
#include <type_traits>

#include "jsparse.cuh"

extern "C" {

// y[r] = J[r, :] . x by jsp::row_dot: by the pattern's entries (rec: nefc x
// 4 ints, cols), or with `dense` over every column of the dense J whose
// values are dof-major (rec and cols unread)
void sparse_rows(const float* vals, const int* rec, const int* cols, const float* x, float* y,
                 int nv, int nefc, int dense) {
  const int4* rec4 = reinterpret_cast<const int4*>(rec);
  for (int r = 0; r < nefc; ++r)
    y[r] = dense ? jsp::row_dot<true>(vals, rec4, cols, r, nv, nefc, x)
                 : jsp::row_dot<false>(vals, rec4, cols, r, nv, nefc, x);
}

// y[r] = J[r, :] . x over every column of the dense J (row stride ld)
void dense_rows(const float* J, int ld, const float* x, float* y, int nefc, int nv) {
  for (int r = 0; r < nefc; ++r) {
    float s = 0.f;
    for (int j = 0; j < nv; ++j) s = fmaf(J[r * ld + j], x[j], s);
    y[r] = s;
  }
}

// y = J^T f by jsp::jt_f on a block of `warps` warps (8: layout 1, 16:
// layout 2), by the chunk words (chw: nch x nefc x 2 ints) or with `dense`
// on the dense J's dof-major values; returns -1 for a count the kernel does
// not build
int sparse_jt(const float* vals, const int* chw, const float* f, float* y, int nv, int nefc,
              int warps, int dense) {
  const int2* chw2 = reinterpret_cast<const int2*>(chw);
  auto run = [=](auto kw) {
    constexpr int kW = decltype(kw)::value;
    host_cuda::launch(kW * 32, [=] {
      const int tid = threadIdx.x;
      if (dense)
        jsp::jt_f<true, kW>(vals, chw2, f, y, nv, nefc, tid & 31, tid / 32);
      else
        jsp::jt_f<false, kW>(vals, chw2, f, y, nv, nefc, tid & 31, tid / 32);
    });
  };
  if (warps == 8)
    run(std::integral_constant<int, 8>{});
  else if (warps == 16)
    run(std::integral_constant<int, 16>{});
  else
    return -1;
  return 0;
}

// y = J^T f by matvec_t's form on one warp (the dense J, row stride ld)
void dense_jt(const float* J, int ld, const float* f, float* y, int nv, int nefc) {
  host_cuda::launch(32, [=] {
    const int lane = threadIdx.x;
    for (int v0 = 0; v0 < nv; v0 += 16) {
      float acc[16];
      for (int c = 0; c < 16; ++c) acc[c] = 0.f;
      for (int r = lane; r < nefc; r += 32) {
        const float fr = f[r];
        for (int c = 0; c < 16; ++c)
          if (v0 + c < nv) acc[c] = fmaf(J[r * ld + v0 + c], fr, acc[c]);
      }
      const float sum = jsp::warp_sum_scatter16(acc, lane);
      const int c = lane >> 1;
      if (!(lane & 1) && v0 + c < nv) y[v0 + c] = sum;
    }
  });
}

}  // extern "C"
