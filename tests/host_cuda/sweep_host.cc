// brax_tracking_tpu_torch/ops/csrc/sweep.cuh's panel sweeps on a CPU,
// through the host stand-ins of cuda_runtime.h beside this file, beside the
// scalar sweep they regroup. Built and called by
// tests/test_torch_sweep_host.py:
//   g++ -std=c++20 -O2 -ffp-contract=off -fno-strict-aliasing -pthread
//       -shared -fPIC -I tests/host_cuda -I brax_tracking_tpu_torch/ops/csrc
//       tests/host_cuda/sweep_host.cc -o libsweep_host.so
#include "sweep.cuh"

extern "C" {

// The scalar sweep in place on S (nv x nv, row stride ld): pivots in order,
// each update one fmaf as the kernels form it (sweep.cuh's header), the
// pivot's own column as fmaf(-S[i, k], 1 / S[k, k], 0).
void scalar_sweep(float* S, int ld, int nv) {
  std::vector<float> r(nv);
  for (int k = 0; k < nv; ++k) {
    const float d = 1.f / S[k * ld + k];
    for (int j = 0; j < nv; ++j) r[j] = j == k ? d : S[k * ld + j] * d;
    for (int i = 0; i < nv; ++i) {
      if (i == k) continue;
      const float ci = S[i * ld + k];
      for (int j = 0; j < nv; ++j) S[i * ld + j] = fmaf(-ci, r[j], j == k ? 0.f : S[i * ld + j]);
    }
    for (int j = 0; j < nv; ++j) S[k * ld + j] = r[j];
  }
}

// Floats of panels_warp<8>'s buffers at nv.
int warp_panel_floats8(int nv) { return sweep::warp_panel_floats<8>(nv); }

// panels_warp<8> on one warp (the one-warp solve core past nv 16): S at any
// row stride ld, buf of warp_panel_floats8(nv) floats, 16-byte aligned.
void run_panels_warp(float* S, int ld, int nv, float* buf) {
  host_cuda::launch(32, [=] { sweep::panels_warp<8>(S, ld, nv, buf); });
}

// panels<threads, nb> (the solve kernel's wide core: 256 or 512 threads, 8
// pivots; spd_inverse: 128 or 256 threads, 16 pivots): S zero past nv up to
// ld, a multiple of 4; buf holds Rk, Cn (nb x ld each), colk and rowk (nb x
// nb each), 16-byte aligned. Returns -1 for a pair that is not built.
int run_panels(float* S, int ld, int nv, float* buf, int threads, int nb) {
  float* Rk = buf;
  float* Cn = Rk + nb * ld;
  float* colk = Cn + nb * ld;
  float* rowk = colk + nb * nb;
  if (threads == 256 && nb == 8)
    host_cuda::launch(256, [=] { sweep::panels<256, 8>(S, ld, nv, Rk, Cn, colk, rowk); });
  else if (threads == 512 && nb == 8)
    host_cuda::launch(512, [=] { sweep::panels<512, 8>(S, ld, nv, Rk, Cn, colk, rowk); });
  else if (threads == 128 && nb == 16)
    host_cuda::launch(128, [=] { sweep::panels<128, 16>(S, ld, nv, Rk, Cn, colk, rowk); });
  else if (threads == 256 && nb == 16)
    host_cuda::launch(256, [=] { sweep::panels<256, 16>(S, ld, nv, Rk, Cn, colk, rowk); });
  else
    return -1;
  return 0;
}

}  // extern "C"
