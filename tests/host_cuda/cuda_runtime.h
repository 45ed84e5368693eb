// Host stand-ins for the CUDA names that brax_tracking_tpu_torch/ops/csrc/
// sweep.cuh uses, so that its block-level code runs on a CPU: one
// std::thread per CUDA thread, __syncthreads and __syncwarp as waits on a
// std::barrier of the block or of the warp, __shfl_sync through a per-warp
// exchange array between two waits. Float arithmetic is IEEE float32 with a
// correctly rounded fmaf and reciprocal, so code that fixes its operations
// (explicit fmaf, nothing left to contraction: build with -ffp-contract=off)
// gives bitwise the card's values. sweep_host.cc beside this file is the
// harness; tests/test_torch_sweep_host.py builds and drives it.
#pragma once

#include <math.h>

#include <algorithm>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline

using std::max;
using std::min;

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local HostDim3 threadIdx;

namespace host_cuda {

struct Warp {
  std::barrier<> bar{32};
  float slot[32];
};

struct Block {
  explicit Block(int threads) : bar(threads), warps(new Warp[threads / 32]) {}
  std::barrier<> bar;
  std::unique_ptr<Warp[]> warps;
};

inline thread_local Block* block = nullptr;

// Runs f() on `threads` threads (a multiple of 32) as one CUDA block.
template <class F>
void launch(int threads, F f) {
  Block b(threads);
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t)
    ts.emplace_back([&b, &f, t] {
      threadIdx.x = t;
      block = &b;
      f();
    });
  for (auto& t : ts) t.join();
}

}  // namespace host_cuda

inline void __syncthreads() { host_cuda::block->bar.arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) {
  host_cuda::block->warps[threadIdx.x / 32].bar.arrive_and_wait();
}

inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  host_cuda::Warp& w = host_cuda::block->warps[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  w.slot[lane] = v;
  w.bar.arrive_and_wait();
  const float r = w.slot[(lane & ~(width - 1)) + (src & (width - 1))];
  w.bar.arrive_and_wait();
  return r;
}

inline float __frcp_rn(float x) { return 1.f / x; }
