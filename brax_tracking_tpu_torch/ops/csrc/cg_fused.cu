// Batched constraint solve + Euler velocity update for Hopper (sm_90a).
//
// Replaces the TPU kernels brax_tracking_tpu/ops/cg.py::cg_solve_fused
// (_cg_fused_kernel -> _assemble_qM_J + _cg_core) and cg_solve_batched
// (_cg_kernel -> _cg_core): per env, assemble qM and J from their low-rank
// factors (cg_fused_kernel) or read them dense (cg_batched_kernel), invert M
// by the sweep operator, run MuJoCo CG with a bracketed Newton line search on
// one-sided quadratic rows plus one contiguous block of dim-3 elliptic
// contacts, optionally from the better of a warmstart and qacc_smooth and
// with the float32 stall exit, and form the Euler velocity update (when the
// model has damping, the Cholesky factor of M + h diag(B) and both
// substitutions by cholesky.cuh's blocked pieces on all of an env's threads:
// euler_damped). Both kernels run one device function, cg_core (or, for wide
// envs, cg_core_wide), once qM, J and the per-env vectors are in shared
// memory.
//
// Design. The TPU kernel tiles (rows, dofs, 128 envs) in VMEM; here one
// warp owns one env and one block holds one warp. qM, M^-1 and J stay in
// shared memory for the whole solve (row stride padded to an odd count so
// lane-per-row reads are free of bank conflicts), so the kernel reads its
// inputs once and writes its outputs once. All 2048 envs are resident at
// once (~16 warps per SM), so a launch lasts about as long as one env's
// chain of dependent steps; the bytes and FP32 operations are 30-60x below
// that. A warp leaves the iteration loop as soon as its env has converged:
// the frozen iterate is the result, and the done flag it writes is the one
// the TPU kernel's freeze leaves.
//
// What bounds it, and what the design does about it. clock64 stamps of PR
// 3's kernel (scripts/stamp_solve_kernel.py; minirat, one warp per env)
// split an env's 152K cycles into the assembly 17%, the sweep 16%, the 13
// bracket evaluations 21%, the step with its nv column sums 19%. Each phase
// is a chain of shared-memory round trips, warp barriers and 5-level
// shuffle reductions, and the 16 warps of an SM share its shared-memory and
// shuffle pipe, so the design cuts both the chain and the traffic:
// - the assembly: every input of an env (f, cdof, P A, the support masks
//   md, the tables, the per-env vectors) is staged in shared memory by one
//   batch of cp.async copies, so it waits on one memory latency instead of
//   one per J row and per md entry; qM one lane per row, J one lane per row
//   with the row's six P A entries in registers; the dense kernel loads qM
//   and J by the same copies;
// - the sweep inverse of an n <= 16 matrix runs in registers (lane j holds
//   column j, each pivot's column comes from lane k by shuffles: no barrier
//   and no shared-memory traffic until the columns are written), wider ones
//   by sweep.cuh's one-warp panel sweep (panels_warp: per panel of 8 pivots
//   the pivot block in registers, the panel's rows and columns replayed in
//   registers, the rest in 4 x 4 register tiles; three warp barriers per
//   panel), its buffers over what the sweep does not read;
// - reductions: xor butterflies with no broadcast from lane 0 (both
//   partners add the same two values, so every lane holds bitwise the same
//   sums and takes the same branches), and independent sums reduced
//   together: p.Mp, p.mxa, phi'(0) and phi''(0) in one butterfly of four
//   (phi'(0) and phi''(0) come out of the J p pass, each lane's own rows);
//   each line-search step's (phi', phi'') as a pair; the two cost terms,
//   |grad|^2 and Polak-Ribiere's numerator and denominator as five;
// - the bracket: phi' at all 13 candidates in one pass over the rows (13
//   partial sums per lane in registers), reduced by a transposing butterfly
//   (16 shuffles for 13 sums) and handed to every lane by one ballot; the
//   bracket and the line search read a lane's rows from registers (up to
//   96 rows, without the elliptic block);
// - J p and M p: p in registers (up to 16 dofs), one lane per output row;
// - the step (up to 16 dofs) in one pass over the rows: J alpha p into
//   J a - aref, each row's force and cost term, and its J^T force terms for
//   all columns in registers, whose 16 column sums share one transposing
//   butterfly (warp_sum_scatter16) instead of one reduction per column;
//   lane v then forms M^-1 grad for its dof and keeps it in a register.
//   The start without a warmstart takes the same pass (J a0 - aref). Wider
//   models run the same steps as separate passes (J^T f 16 columns at a
//   time);
// - the line search: a converged step leaves (alpha, lo, hi) as they are,
//   so every later step would repeat it, and the warp leaves the loop there
//   (a Newton chunk's data needs about 2 of its 16 steps, chip_smoke.py's
//   line_search_steps).
// 2048 envs fit one wave (16 one-warp blocks per SM: the launch bound caps
// the registers at 128, and the minirat's 11.2 KB of shared memory per env
// leaves room), so a launch lasts about one env's chain.
//
// An env that shares an SM with fewer than two others (ops/cg.py::
// kernel_layout: layout 2, and layout 1 above a width) runs the wide core: one block of
// several warps per env (see "The wide core" below). Layout 2, for envs
// whose J does not fit one block (rodent_pair: nv = 146, 590 rows, 642 KB
// in layout 1), keeps qM, M^-1 and the vectors in shared memory and J in
// device memory: the fused kernel assembles it into a per-env scratch that
// the wrapper allocates, the dense kernel copies its input there. One
// warp per env on its SM (the first layout 2) left a 1024-env pair launch at
// 55.5 ms, 78-83% of an env's cycles in the sweep inverse (PERF.md). The
// template switch kW (warps per env) compiles the two cores apart, so the
// one-warp instances' code, registers and occupancy stay as they were.

// The elliptic block. The TPU kernel permutes the block to [n*C][t1*C][t2*C]
// for its sublanes; here each lane takes whole contacts in their input order
// [n, t1, t2] (rows ell0 + 3c + {0, 1, 2}), so nothing is permuted. The
// per-contact zone logic (bottom: three quadratics; middle: the cone's
// quadratic in n - mu t; top: no force) adds into the same per-lane partial
// sums as the quadratic rows, so the cost and each phi' / phi'' evaluation
// share the quadratic rows' reductions; the bracket forms each contact's
// direction terms once for its 13 candidates. mu and the two tangent scales
// are a per-model (3, nell) array, staged with each env's contact
// activation in shared memory. The core is compiled twice (template kEll),
// so a model without the block runs loops with no trace of it: with the
// block's code in every phi' evaluation the minirat's solve took 94 us per
// launch instead of the 83 us it took before the block existed (H100, 2048
// envs).
//
// Warmstart (mj_warmstart): the cost at the warmstart (one extra qM (ws - a0)
// product) against the cost at qacc_smooth; the cheaper one starts CG. Only
// the chosen start's force and gradient are formed. The stall exit adds
// |phi'| < stall_tol |phi'(0)| to the line search's freeze and
// improvement < stall_tol |cost| to the done flag. Both are compiled in only
// where a launch asks for either (template kWarm; a Newton chunk asks for
// both), so a plain CG launch runs none of their tests in its loops.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cholesky.cuh"
#include "jsparse.cuh"
#include "sweep.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinval = 1e-15f;
// 16 one-warp blocks per SM hold 2048 envs in one wave on the H100's 132
// SMs; the launch bound keeps the kernels within the 128 registers per
// thread that allows. A wide block of kW warps is held to the same 128
// (16 / kW blocks' worth of the SM's registers), so that two layout-1
// blocks share an SM wherever their shared memory lets them (the rodent
// stand-in's 92,032 B). Without the bound ptxas gives the layout-1
// instances up to 168 registers, and above 128 one block per SM: so it
// left the main path's instance once the blocked damped tail was in it
// (the undamped one rat 1,309 us per launch instead of 753; H100 80GB
// HBM3, 700 W).
constexpr int kBlocksPerSm = 16;
template <int kW>
constexpr int kMinBlocks = kW == 1 ? kBlocksPerSm : 16 / kW;

__device__ inline int lead(int nv) { return nv | 1; }
// the row stride of the wide core's qM and M^-1 and of the damped tail's
// factor: nv rounded up to a multiple of 4
__device__ __host__ inline int lead4(int nv) { return (nv + 3) & ~3; }

// N independent warp sums by xor butterflies, issued together (5 levels for
// all N). Every lane ends with bitwise the same sums: at each level the two
// partners add the same two values, and IEEE addition commutes.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(kFull, v[k], o);
}

__device__ __forceinline__ float warp_sum(float v) {
  float w[1] = {v};
  warp_sums(w);
  return w[0];
}

using jsp::warp_sum_scatter16;

__device__ __forceinline__ float dot_row(const float* a, const float* x, int n) {
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += a[j] * x[j];
  return s;
}

// a . x over n <= 16 columns with x in registers, in dot_row's order
__device__ __forceinline__ float dot16(const float* a, const float (&x)[16], int n) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < n) s += a[j] * x[j];
  return s;
}

// y[i] = sum_j A[i, j] x[j], A row-major with stride ld; one lane per row
__device__ __forceinline__ void matvec(const float* A, int ld, const float* x,
                                       float* y, int nrow, int ncol, int lane) {
  for (int i = lane; i < nrow; i += kWarp) y[i] = dot_row(A + i * ld, x, ncol);
  __syncwarp();
}

// y[v] = sum_r J[r, v] f[r] for every column: each lane accumulates its
// rows' terms for 16 columns in registers, and the 16 column sums are
// reduced together (warp_sum_scatter16); lane 2c writes column c.
__device__ __forceinline__ void matvec_t(const float* J, int ld, const float* f,
                                         float* y, int nrow, int ncol, int lane) {
  for (int v0 = 0; v0 < ncol; v0 += 16) {
    float acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = 0.f;
    for (int r = lane; r < nrow; r += kWarp) {
      const float fr = f[r];
      const float* a = J + r * ld + v0;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        if (v0 + c < ncol) acc[c] += a[c] * fr;
    }
    const float sum = warp_sum_scatter16(acc, lane);
    const int c = lane >> 1;
    if (!(lane & 1) && v0 + c < ncol) y[v0 + c] = sum;
  }
  __syncwarp();
}

// S = A^-1 for SPD A (both n x n, stride ld) by the sweep operator, in the
// plain version's elimination order and update formulas. Up to kSweepReg
// wide in registers: lane j holds column j, and each pivot's column comes
// from lane k by shuffles, with no shared-memory traffic or barrier until
// the columns are written. Wider matrices by sweep.cuh's one-warp panel
// sweep (panels_warp, kWarpPanel pivots per panel) in place on a copy of A,
// its buffers in `panel`.
constexpr int kSweepReg = 16;
// 8 pivots per panel: 16 were no faster on the fly stand-ins, and their
// buffers do not fit the dead vectors of a dense one-warp block
constexpr int kWarpPanel = 8;
__device__ void sweep_inverse(const float* A, float* S, int ld, int n, float* panel, int lane) {
  if (n <= kSweepReg) {
    const int j = lane < n ? lane : 0;  // lanes past n shadow column 0
    float c[kSweepReg];
#pragma unroll
    for (int i = 0; i < kSweepReg; ++i) c[i] = (i < n) ? A[i * ld + j] : 0.f;
#pragma unroll
    for (int k = 0; k < kSweepReg; ++k) {
      if (k < n) {
        const float dinv = 1.f / __shfl_sync(kFull, c[k], k);
        const float rk = c[k] * dinv;  // S[k, j] / S[k, k]
#pragma unroll
        for (int i = 0; i < kSweepReg; ++i) {
          if (i < n && i != k) {
            const float ci = __shfl_sync(kFull, c[i], k);  // S[i, k]
            c[i] = (j == k) ? -ci * dinv : c[i] - ci * rk;
          }
        }
        c[k] = (j == k) ? dinv : rk;
      }
    }
    if (lane < n) {
#pragma unroll
      for (int i = 0; i < kSweepReg; ++i)
        if (i < n) S[i * ld + lane] = c[i];
    }
    __syncwarp();
    return;
  }
  // the copy in batches of 8 loads per lane before their stores
  const int len = n * ld;
  for (int e0 = lane; e0 < len; e0 += 8 * kWarp) {
    float t[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = A[min(e0 + q * kWarp, len - 1)];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (e0 + q * kWarp < len) S[e0 + q * kWarp] = t[q];
  }
  __syncwarp();
  sweep::panels_warp<kWarpPanel>(S, ld, n, panel);
}

// 4 bytes from device to shared memory without passing through registers
// (cp.async): a lane issues all its copies before it waits for any, so the
// staging of an env's inputs costs about one memory latency.
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
#else
  *static_cast<float*>(dst) = *static_cast<const float*>(src);
#endif
}

// waits for every copy_async of this lane, then for the warp's
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
  __syncwarp();
}

// n 4-byte words src -> dst (both contiguous), asynchronously
__device__ __forceinline__ void copy_vec(void* dst, const void* src, int n, int lane,
                                         int step = kWarp) {
  for (int i = lane; i < n; i += step)
    copy_async(static_cast<float*>(dst) + i, static_cast<const float*>(src) + i);
}

// The row-major (nrow, ncol) src into dst (row stride ld), asynchronously:
// consecutive threads on consecutive elements (step threads in all).
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, int nrow,
                                          int ncol, int lane, int step = kWarp) {
  int i = lane / ncol, j = lane - i * ncol;
  while (i < nrow) {
    copy_async(dst + i * ld + j, src + i * ncol + j);
    j += step;
    while (j >= ncol) {
      j -= ncol;
      ++i;
    }
  }
}

// n 0/1 bytes src -> dst as 1.f / 0.f, up to 8 loads in flight per lane
__device__ __forceinline__ void load_flags(float* dst, const uint8_t* src, int n, int lane,
                                           int step = kWarp) {
  for (int i0 = lane; i0 < n; i0 += 8 * step) {
    uint8_t v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = (i0 + q * step < n) ? __ldg(src + i0 + q * step) : 0;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (i0 + q * step < n) dst[i0 + q * step] = v[q] ? 1.f : 0.f;
  }
}

// Per-launch sizes, options and device pointers of the per-env vectors and
// the outputs (the same for both kernels).
struct Args {
  const float* D;
  const float* aref;
  const uint8_t* exists;      // (B, nefc): quadratic rows only
  const uint8_t* exists_con;  // (B, nell)
  const float* qfrc_smooth;
  const float* qvel;
  const float* damp;          // (nv,)
  const float* ell;           // (3, nell): mu, tangent scale 1, tangent scale 2
  const float* warmstart;     // (B, nv) when has_ws
  float* qacc;
  float* force;
  float* qfrc;
  float* a0;
  float* qvel_new;
  uint8_t* done;
  int nv, nefc, nell, ell0, iters, ls_iters, has_damping, has_ws;
  float tol, dt, stall_tol;
};

// The dynamic shared memory of one env's block, whose size the caller
// computes (ops/cg.py::kernel_smem_bytes): qM, Mi (M^-1, later the damped
// factor), J, three nefc-vectors, qfs and four nell-vectors (what the
// sweep leaves alone: the solve reads them later), then what the sweep does
// not read, which its panel buffers overlay: three nefc-vectors, twelve
// nv-vectors (the last one spare), and f and cdof (6 x nv each) staged for
// the assembly, with the fused kernel's P A and support masks past them.
struct Smem {
  float *qM, *Mi, *J;  // J: shared memory (layout 1) or device memory (layout 2)
  int ldj;             // J's row stride in shared memory
  float *Dv, *ar, *ex, *jar, *jarp, *force;
  float *x, *a0, *mxa, *grad, *mgrad, *gradn, *mgradn, *p, *mp, *qfs, *tmp, *rowb;
  float *econ, *mu, *sc1, *sc2;
  float *fs, *cs;
  float* panel;  // the one-warp sweep's buffers (16-byte aligned, over jar...)
};

__device__ __forceinline__ Smem carve(float* sm, int nv, int nefc, int nell) {
  const int ld = lead(nv);
  Smem s;
  s.qM = sm;
  s.Mi = s.qM + nv * ld;
  s.J = s.Mi + nv * ld;
  s.ldj = ld;
  s.Dv = s.J + nefc * ld;
  s.ar = s.Dv + nefc;
  s.ex = s.ar + nefc;
  s.qfs = s.ex + nefc;
  s.econ = s.qfs + nv;
  s.mu = s.econ + nell;
  s.sc1 = s.mu + nell;
  s.sc2 = s.sc1 + nell;
  s.jar = s.sc2 + nell;
  s.jarp = s.jar + nefc;
  s.force = s.jarp + nefc;
  s.x = s.force + nefc;
  s.a0 = s.x + nv;
  s.mxa = s.a0 + nv;
  s.grad = s.mxa + nv;
  s.mgrad = s.grad + nv;
  s.gradn = s.mgrad + nv;
  s.mgradn = s.gradn + nv;
  s.p = s.mgradn + nv;
  s.mp = s.p + nv;
  s.tmp = s.mp + nv;
  s.rowb = s.tmp + nv;
  s.fs = s.rowb + 2 * nv;
  s.cs = s.fs + 6 * nv;
  // sweep::warp_panel_floats past the alignment fits the 3 nefc + 24 nv
  // floats from jar on: at most 16 (nv + 2) + 131 (tests/test_torch_cg.py)
  s.panel = sm + ((s.jar - sm + 3) & ~3);
  return s;
}

// The per-env vectors into shared memory: the floats by async copies, the
// flags by batched loads issued while those copies are in flight; waits for
// this launch's earlier copy_async calls too (this thread's; its warp's
// after the __syncwarp: a block of several warps adds a __syncthreads).
__device__ __forceinline__ void load_env(const Args& a, const Smem& s, int b, int lane,
                                         int step = kWarp) {
  copy_vec(s.Dv, a.D + (size_t)b * a.nefc, a.nefc, lane, step);
  copy_vec(s.ar, a.aref + (size_t)b * a.nefc, a.nefc, lane, step);
  copy_vec(s.qfs, a.qfrc_smooth + (size_t)b * a.nv, a.nv, lane, step);
  copy_vec(s.mu, a.ell, a.nell, lane, step);
  copy_vec(s.sc1, a.ell + a.nell, a.nell, lane, step);
  copy_vec(s.sc2, a.ell + 2 * a.nell, a.nell, lane, step);
  load_flags(s.ex, a.exists + (size_t)b * a.nefc, a.nefc, lane, step);
  load_flags(s.econ, a.exists_con + (size_t)b * a.nell, a.nell, lane, step);
  copy_wait();
}

struct Phi {
  float d, dd;
};

// One lane's share of twice the elliptic block's cost at jar (contacts lane,
// lane + 32, ...); their forces go to `force` unless it is null.
__device__ __forceinline__ float ell_cost_force(const float* jar, const float* Dv, const float* econ,
                                             const float* mu_, const float* sc1_,
                                             const float* sc2_, float* force, int nell, int ell0,
                                             int lane) {
  float c = 0.f;
  for (int k = lane; k < nell; k += kWarp) {
    const int r = ell0 + 3 * k;
    const float n = jar[r], t1 = jar[r + 1], t2 = jar[r + 2];
    const float mu = mu_[k], sc1 = sc1_[k], sc2 = sc2_[k];
    const float u1 = t1 * sc1, u2 = t2 * sc2;
    const float t = sqrtf(fmaxf(u1 * u1 + u2 * u2, kMinval * kMinval));
    const bool on = econ[k] != 0.f;
    const bool bottom = on && (mu * n + t <= 0.f);
    const bool middle = on && !bottom && (n < mu * t);
    const float dn = Dv[r], d1 = Dv[r + 1], d2 = Dv[r + 2];
    float fn = 0.f, f1 = 0.f, f2 = 0.f;
    if (bottom) {
      c += dn * n * n + d1 * t1 * t1 + d2 * t2 * t2;
      fn = -dn * n;
      f1 = -d1 * t1;
      f2 = -d2 * t2;
    } else if (middle) {
      const float dm = dn / fmaxf(1.f + mu * mu, kMinval);
      const float nmt = n - mu * t;
      c += dm * nmt * nmt;
      fn = -dm * nmt;
      const float coef = dm * nmt * mu / t;
      f1 = coef * u1 * sc1;
      f2 = coef * u2 * sc2;
    }
    if (force) {
      force[r] = fn;
      force[r + 1] = f1;
      force[r + 2] = f2;
    }
  }
  return c;
}

// One lane's share of twice the constraint cost at jar (quadratic rows and,
// with kEll, the elliptic block); with kForce the per-row forces go to
// `force`. Ends with a __syncwarp.
template <bool kEll, bool kForce>
__device__ __forceinline__ float cost_part(const Args& a, const Smem& s, const float* jar,
                                           float* force, int lane) {
  float c = 0.f;
  const float* Dv = s.Dv;
  const float* ex = s.ex;
  const int nefc = a.nefc;
  for (int r = lane; r < nefc; r += kWarp) {
    const float act = (jar[r] < 0.f) ? ex[r] : 0.f;
    if (kForce) force[r] = -Dv[r] * jar[r] * act;
    c += act * Dv[r] * jar[r] * jar[r];
  }
  if (kEll) {
    __syncwarp();  // the quadratic loop wrote zeros on the elliptic rows
    c += ell_cost_force(jar, s.Dv, s.econ, s.mu, s.sc1, s.sc2, kForce ? force : nullptr,
                        a.nell, a.ell0, lane);
  }
  __syncwarp();
  return c;
}

// The constraint cost at jar, reduced over the warp.
template <bool kEll, bool kForce>
__device__ __forceinline__ float cost_force(const Args& a, const Smem& s, const float* jar,
                                            float* force, int lane) {
  return 0.5f * warp_sum(cost_part<kEll, kForce>(a, s, jar, force, lane));
}

// grad = mxa - J^T force into `grad`, M^-1 grad into `mgrad`
__device__ __forceinline__ void gradients(const Args& a, const Smem& s, const float* mxa,
                                          float* grad, float* mgrad, int lane) {
  const int ld = lead(a.nv);
  matvec_t(s.J, s.ldj, s.force, s.tmp, a.nefc, a.nv, lane);
  for (int v = lane; v < a.nv; v += kWarp) grad[v] = mxa[v] - s.tmp[v];
  __syncwarp();
  matvec(s.Mi, ld, grad, mgrad, a.nv, a.nv, lane);
}

// One pass over the rows for nv <= 16: each row's new jar = jar_of(r), its
// force and cost term, and its J^T force terms for every column in
// registers, so each row is visited once (the step, and the start without a
// warmstart); the column sums are reduced together (warp_sum_scatter16)
// into `jtf`, where lane 2c holds column c. Returns the lane's share of
// twice the constraint cost.
template <bool kEll, typename JarOf>
__device__ __forceinline__ float rows_pass16(const Args& a, const Smem& s, JarOf jar_of,
                                             float& jtf, int lane) {
  const int nv = a.nv, nefc = a.nefc;
  float acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0.f;
  auto add_row = [&](int r, float fr) {
    const float* Jr = s.J + r * s.ldj;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      if (c < nv) acc[c] += Jr[c] * fr;
  };
  float cost = 0.f;
  for (int r = lane; r < nefc; r += kWarp) {
    const float jr = jar_of(r);
    s.jar[r] = jr;
    const float act = (jr < 0.f) ? s.ex[r] : 0.f;
    const float fr = -s.Dv[r] * jr * act;
    s.force[r] = fr;
    cost += act * s.Dv[r] * jr * jr;
    add_row(r, fr);
  }
  if (kEll) {
    __syncwarp();  // the elliptic rows' jar and zero forces, written above
    cost += ell_cost_force(s.jar, s.Dv, s.econ, s.mu, s.sc1, s.sc2, s.force, a.nell, a.ell0,
                           lane);
    for (int k = lane; k < a.nell; k += kWarp) {
      const int r = a.ell0 + 3 * k;
      for (int q = 0; q < 3; ++q) add_row(r + q, s.force[r + q]);
    }
  }
  jtf = warp_sum_scatter16(acc, lane);
  __syncwarp();
  return cost;
}

// For nv <= 16, from J^T force in `jtf` (lane 2c holds column c): grad = mxa
// - J^T force into `grad`; returns M^-1 grad at lane v's dof (0 on lanes
// past nv).
__device__ __forceinline__ float grad16(const Args& a, const Smem& s, float jtf,
                                        float* grad, int lane) {
  const int nv = a.nv, c = lane >> 1;
  if (!(lane & 1) && c < nv) grad[c] = s.mxa[c] - jtf;
  __syncwarp();
  return lane < nv ? dot_row(s.Mi + lane * lead(nv), grad, nv) : 0.f;
}

// One lane's share of the elliptic block's (phi', phi'') at alpha.
__device__ __forceinline__ Phi ell_dphi(const float* jar, const float* jarp, const float* Dv,
                                     const float* econ, const float* mu_, const float* sc1_,
                                     const float* sc2_, float alpha, int nell, int ell0,
                                     int lane) {
  float d = 0.f, dd = 0.f;
  for (int k = lane; k < nell; k += kWarp) {
    const int r = ell0 + 3 * k;
    const float n = jar[r] + alpha * jarp[r];
    const float t1 = jar[r + 1] + alpha * jarp[r + 1];
    const float t2 = jar[r + 2] + alpha * jarp[r + 2];
    const float np = jarp[r], p1 = jarp[r + 1], p2 = jarp[r + 2];
    const float mu = mu_[k], sc1 = sc1_[k], sc2 = sc2_[k];
    const float u1 = t1 * sc1, u2 = t2 * sc2;
    const float t = sqrtf(fmaxf(u1 * u1 + u2 * u2, kMinval * kMinval));
    const bool on = econ[k] != 0.f;
    const bool bottom = on && (mu * n + t <= 0.f);
    const bool middle = on && !bottom && (n < mu * t);
    const float dn = Dv[r];
    if (bottom) {
      const float d1 = Dv[r + 1], d2 = Dv[r + 2];
      d += dn * n * np + d1 * t1 * p1 + d2 * t2 * p2;
      dd += dn * np * np + d1 * p1 * p1 + d2 * p2 * p2;
    } else if (middle) {
      const float up1 = p1 * sc1, up2 = p2 * sc2;
      const float dm = dn / fmaxf(1.f + mu * mu, kMinval);
      const float nmt = n - mu * t;
      const float tprime = (u1 * up1 + u2 * up2) / t;
      const float tdprime = fmaxf(up1 * up1 + up2 * up2 - tprime * tprime, 0.f) / t;
      const float g = np - mu * tprime;
      d += dm * nmt * g;
      dd += dm * (g * g - nmt * mu * tdprime);
    }
  }
  Phi out;
  out.d = d;
  out.dd = dd;
  return out;
}

// The lane's quadratic rows r = lane + 32 q, q < kRowCache, in registers
// for the bracket and the line search (jar, J p, D J p, exists), where the
// model has at most kRowCache * 32 rows; rows past nefc hold zeros, which
// add exact zeros. Wider models, and models with the elliptic block (whose
// rows are mostly elliptic, and whose bracket needs the registers), read the
// rows from shared memory.
constexpr int kRowCache = 3;
struct RowCache {
  float jr[kRowCache], jp[kRowCache], djp[kRowCache], e[kRowCache];
  bool on;
  template <bool kEll>
  __device__ __forceinline__ void fill(const Smem& s, int nefc, int lane) {
    on = !kEll && nefc <= kRowCache * kWarp;
    if (!on) return;
#pragma unroll
    for (int q = 0; q < kRowCache; ++q) {
      const int r = lane + q * kWarp;
      const bool in = r < nefc;
      jr[q] = in ? s.jar[r] : 0.f;
      jp[q] = in ? s.jarp[r] : 0.f;
      djp[q] = in ? s.Dv[r] * jp[q] : 0.f;
      e[q] = in ? s.ex[r] : 0.f;
    }
  }
};

// one quadratic row's share of (phi', phi'') at alpha
__device__ __forceinline__ void dphi_row(float jr, float jp, float djp, float e, float alpha,
                                         float& d, float& dd) {
  const float ja = jr + alpha * jp;
  const float act = (ja < 0.f) ? e : 0.f;
  d += act * djp * ja;
  dd += act * djp * jp;
}

// (phi'(alpha), phi''(alpha)) along the search direction
template <bool kEll>
__device__ __forceinline__ Phi dphi(const Args& a, const Smem& s, const RowCache& rc, float alpha,
                                    float gauss_p, float pmp, int lane) {
  const float* jar = s.jar;
  const float* jarp = s.jarp;
  const float* Dv = s.Dv;
  const float* ex = s.ex;
  const int nefc = a.nefc;
  float d = 0.f, dd = 0.f;
  if (rc.on) {
#pragma unroll
    for (int q = 0; q < kRowCache; ++q) dphi_row(rc.jr[q], rc.jp[q], rc.djp[q], rc.e[q], alpha, d, dd);
  } else {
    for (int r = lane; r < nefc; r += kWarp)
      dphi_row(jar[r], jarp[r], Dv[r] * jarp[r], ex[r], alpha, d, dd);
  }
  if (kEll) {
    const Phi e = ell_dphi(jar, jarp, s.Dv, s.econ, s.mu, s.sc1, s.sc2, alpha, a.nell, a.ell0,
                           lane);
    d += e.d;
    dd += e.dd;
  }
  float v[2] = {d, dd};
  warp_sums(v);  // the pair in one butterfly
  Phi out;
  out.d = gauss_p + alpha * pmp + v[0];
  out.dd = pmp + v[1];
  return out;
}

// The bracket's candidate k, guess * 2^k (k < 13), formed where it is used
// (a product with a power of two is exact, so every use is bitwise the same)
__device__ __forceinline__ float candidate(float guess, int k) { return guess * (float)(1 << k); }

// phi' at the 13 bracket candidates in one pass over the rows: each lane
// keeps 13 partial sums in registers, reduced together by the transposing
// butterfly; lane l tests candidate l >> 1 and a ballot hands every lane
// the same mask: bit 2k is set where phi'(guess * 2^k) >= 0.
template <bool kEll>
__device__ __forceinline__ unsigned bracket(const Args& a, const Smem& s, const RowCache& rc,
                                            float guess, float gauss_p, float pmp, int lane) {
  const float* jar = s.jar;
  const float* jarp = s.jarp;
  const float* Dv = s.Dv;
  const float* ex = s.ex;
  const int nefc = a.nefc;
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = 0.f;
  // one quadratic row's share of phi' at the 13 candidates
  auto row = [&](float jr, float jp, float djp, float e) {
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      const float ja = jr + candidate(guess, k) * jp;
      const float act = (ja < 0.f) ? e : 0.f;
      d[k] += act * djp * ja;
    }
  };
  if (rc.on) {
#pragma unroll
    for (int q = 0; q < kRowCache; ++q) row(rc.jr[q], rc.jp[q], rc.djp[q], rc.e[q]);
  } else {
    for (int r = lane; r < nefc; r += kWarp) row(jar[r], jarp[r], Dv[r] * jarp[r], ex[r]);
  }
  if (kEll) {
    // the elliptic block: each lane's contacts, their direction-only terms
    // formed once for all 13 candidates (ell_dphi's phi' per candidate)
    for (int c = lane; c < a.nell; c += kWarp) {
      if (s.econ[c] == 0.f) continue;
      const int r = a.ell0 + 3 * c;
      const float n0 = jar[r], t10 = jar[r + 1], t20 = jar[r + 2];
      const float np = jarp[r], p1 = jarp[r + 1], p2 = jarp[r + 2];
      const float mu = s.mu[c], sc1 = s.sc1[c], sc2 = s.sc2[c];
      const float dn = Dv[r], d1 = Dv[r + 1], d2 = Dv[r + 2];
      const float up1 = p1 * sc1, up2 = p2 * sc2;
      const float dm = dn / fmaxf(1.f + mu * mu, kMinval);
#pragma unroll
      for (int k = 0; k < 13; ++k) {
        const float ck = candidate(guess, k);
        const float n = n0 + ck * np, t1 = t10 + ck * p1, t2 = t20 + ck * p2;
        const float u1 = t1 * sc1, u2 = t2 * sc2;
        const float t = sqrtf(fmaxf(u1 * u1 + u2 * u2, kMinval * kMinval));
        const bool bottom = mu * n + t <= 0.f;
        if (bottom) {
          d[k] += dn * n * np + d1 * t1 * p1 + d2 * t2 * p2;
        } else if (n < mu * t) {  // middle
          const float nmt = n - mu * t;
          const float tprime = (u1 * up1 + u2 * up2) / t;
          d[k] += dm * nmt * (np - mu * tprime);
        }
      }
    }
  }
  const float sum = warp_sum_scatter16(d, lane);
  const int k = lane >> 1;
  const bool pos = k < 13 && gauss_p + candidate(guess, k) * pmp + sum >= 0.f;
  return __ballot_sync(kFull, pos);
}

// The damped Euler tail of both cores, on all kThreads threads of the
// block: qvel_new = qvel + dt z with (M + h diag(B)) z = qfrc_smooth +
// qfrc_constraint, for one env's nv-vectors. y = qfs + qfrc first (U may
// overlay qfs and qfrc), then the upper triangle of qM (row stride ldq) +
// damp into U (row stride ld, a multiple of 4, 16-byte aligned, ceil(nv /
// 4) * 4 rows), factored and solved in place on y by cholesky.cuh's
// blocked pieces. Starts after a barrier that made qfs and qfrc visible.
template <int kThreads>
__device__ __forceinline__ void euler_damped(int nv, const float* qM, int ldq,
                                             const float* __restrict__ damp, const float* qfs,
                                             const float* qfrc, float* U, int ld, float* y,
                                             const float* __restrict__ qvel,
                                             float* __restrict__ qvel_new, float dt) {
  const int tid = threadIdx.x, lane = tid & (kWarp - 1);
  for (int v = tid; v < nv; v += kThreads) y[v] = qfs[v] + qfrc[v];
  __syncthreads();
  for (int i = tid / kWarp; i < nv; i += kThreads / kWarp)
    for (int j = i + lane; j < nv; j += kWarp)
      U[i * ld + j] = qM[i * ldq + j] + ((i == j) ? __ldg(damp + i) : 0.f);
  __syncthreads();
  chol::factor_blocked<kThreads, true>(U, ld, nv);
  chol::forward_blocked<kThreads, false>(U, chol::Square{ld}, y, nv);
  chol::backward_blocked<kThreads>(U, chol::Square{ld}, y, nv);
  for (int v = tid; v < nv; v += kThreads) qvel_new[v] = __ldg(qvel + v) + dt * y[v];
}

// The solve of one warp once qM, J and the per-env vectors are in shared
// memory; writes every output of env b. kEll (nell > 0) compiles the
// elliptic block in: without it the quadratic rows' loops carry no trace of
// it. kWarm (a warmstart or stall_tol > 0) compiles in the warmstart select
// and the stall exit.
template <bool kEll, bool kWarm>
__device__ __forceinline__ void cg_core(const Args& a, const Smem& s, int b, int lane) {
  const int nv = a.nv, nefc = a.nefc;
  const int ld = lead(nv);

  // ---- M^-1 (stays in shared memory) and qacc_smooth
  sweep_inverse(s.qM, s.Mi, ld, nv, s.panel, lane);
  matvec(s.Mi, ld, s.qfs, s.a0, nv, nv, lane);

  // ---- start at x = a0 (mxa = 0, so the gauss term is 0)
  for (int v = lane; v < nv; v += kWarp) {
    s.x[v] = s.a0[v];
    s.mxa[v] = 0.f;
  }
  __syncwarp();
  const bool narrow = nv <= 16;
  float cost;
  if (!kWarm && narrow) {
    // x = a0 is the start: J x - aref, the forces, the cost and J^T force in
    // one row pass (a0 in registers), then the gradients
    float xr[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) xr[c] = c < nv ? s.a0[c] : 0.f;
    float jtf;
    cost = 0.5f * warp_sum(rows_pass16<kEll>(
                      a, s, [&](int r) { return dot16(s.J + r * s.ldj, xr, nv) - s.ar[r]; }, jtf,
                      lane));
    const float mg = grad16(a, s, jtf, s.grad, lane);
    if (lane < nv) {
      s.mgrad[lane] = mg;
      s.p[lane] = -mg;
    }
    __syncwarp();
  } else {
    matvec(s.J, s.ldj, s.x, s.jar, nefc, nv, lane);
    for (int r = lane; r < nefc; r += kWarp) s.jar[r] -= s.ar[r];
    __syncwarp();
    // without kWarm x = a0 is the start: its forces are formed here
    cost = cost_force<kEll, !kWarm>(a, s, s.jar, s.force, lane);
  }
  if (kWarm && a.has_ws) {
    // candidate ws: x in p, qM (ws - a0) in mp, J ws - aref in jarp
    for (int v = lane; v < nv; v += kWarp) {
      s.p[v] = __ldg(a.warmstart + (size_t)b * nv + v);
      s.tmp[v] = s.p[v] - s.a0[v];
    }
    __syncwarp();
    matvec(s.qM, ld, s.tmp, s.mp, nv, nv, lane);
    matvec(s.J, s.ldj, s.p, s.jarp, nefc, nv, lane);
    for (int r = lane; r < nefc; r += kWarp) s.jarp[r] -= s.ar[r];
    __syncwarp();
    float cw[2] = {cost_part<kEll, false>(a, s, s.jarp, nullptr, lane), 0.f};
    for (int v = lane; v < nv; v += kWarp) cw[1] += s.tmp[v] * s.mp[v];
    warp_sums(cw);
    const float cost_w = 0.5f * cw[0] + 0.5f * cw[1];
    if (cost_w < cost) {  // uniform: every lane holds the same costs
      for (int v = lane; v < nv; v += kWarp) {
        s.x[v] = s.p[v];
        s.mxa[v] = s.mp[v];
      }
      for (int r = lane; r < nefc; r += kWarp) s.jar[r] = s.jarp[r];
      __syncwarp();
      cost = cost_w;
    }
  }
  if (kWarm) cost_part<kEll, true>(a, s, s.jar, s.force, lane);  // the chosen start's forces
  if (kWarm || !narrow) {
    gradients(a, s, s.mxa, s.grad, s.mgrad, lane);
    for (int v = lane; v < nv; v += kWarp) s.p[v] = -s.mgrad[v];
    __syncwarp();
  }

  bool done = false;
  const int iters = a.iters, ls_iters = a.ls_iters;
  const float tol = a.tol, stall_tol = a.stall_tol;
  for (int it = 0; it < iters; ++it) {
    if (done) break;  // frozen: later iterations would not change the iterate
    // J p (one lane per row) with the lane's share of phi'(0) and phi''(0)
    // on its own rows, M p (one lane per dof) with its share of p.Mp and
    // p.mxa; the four sums reduced together
    // (p in registers up to 16 dofs)
    float pr[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) pr[c] = (narrow && c < nv) ? s.p[c] : 0.f;
    auto dotp = [&](const float* row) {
      return narrow ? dot16(row, pr, nv) : dot_row(row, s.p, nv);
    };
    float r4[4] = {0.f, 0.f, 0.f, 0.f};  // p.Mp, p.mxa, phi'(0), phi''(0)
    for (int r = lane; r < nefc; r += kWarp) {
      const float jp = dotp(s.J + r * s.ldj);
      s.jarp[r] = jp;
      const float jr = s.jar[r];
      const float act = (jr < 0.f) ? s.ex[r] : 0.f;
      const float djp = s.Dv[r] * jp;
      r4[2] += act * djp * jr;
      r4[3] += act * djp * jp;
    }
    for (int v = lane; v < nv; v += kWarp) {
      const float mp = dotp(s.qM + v * ld);
      s.mp[v] = mp;
      r4[0] += s.p[v] * mp;
      r4[1] += s.p[v] * s.mxa[v];
    }
    __syncwarp();
    if (kEll) {
      const Phi e = ell_dphi(s.jar, s.jarp, s.Dv, s.econ, s.mu, s.sc1, s.sc2, 0.f, a.nell,
                             a.ell0, lane);
      r4[2] += e.d;
      r4[3] += e.dd;
    }
    warp_sums(r4);
    const float pmp = r4[0], gauss_p = r4[1];
    const float d0 = gauss_p + r4[2], dd0 = pmp + r4[3];
    const float guess = fmaxf(-d0 / fmaxf(dd0, kMinval), kMinval);

    // bracket: phi' at guess * 2^k, k = 0..12, in one pass (every lane
    // holds the same mask)
    RowCache rc;
    rc.fill<kEll>(s, nefc, lane);
    const unsigned pos = bracket<kEll>(a, s, rc, guess, gauss_p, pmp, lane);
    float hi = candidate(guess, 12);
#pragma unroll
    for (int k = 0; k < 13; ++k)
      if ((pos >> (2 * k)) & 1u) hi = fminf(hi, candidate(guess, k));
    float lo = 0.f;
#pragma unroll
    for (int k = 0; k < 13; ++k)
      if (!((pos >> (2 * k)) & 1u) && candidate(guess, k) < hi) lo = fmaxf(lo, candidate(guess, k));
    float alpha = fminf(guess, hi);
    const float d0_scale = fabsf(d0) * stall_tol;
    for (int l = 0; l < ls_iters; ++l) {
      const Phi ph = dphi<kEll>(a, s, rc, alpha, gauss_p, pmp, lane);
      // a converged step leaves (alpha, lo, hi) as they are, so every later
      // step would evaluate the same alpha again: leave (uniform, as every
      // lane holds the same sums)
      if (fabsf(ph.d) < tol || (kWarm && stall_tol > 0.f && fabsf(ph.d) < d0_scale)) break;
      const float lo2 = (ph.d < 0.f) ? alpha : lo;
      const float hi2 = (ph.d >= 0.f) ? alpha : hi;
      const float newton = alpha - ph.d / fmaxf(ph.dd, kMinval);
      const bool inside = (newton > lo2) && (newton < hi2);
      alpha = inside ? newton : 0.5f * (lo2 + hi2);
      lo = lo2;
      hi = hi2;
    }

    // step, then the cost (constraint and gauss terms), forces and
    // gradients at the new iterate; the two cost terms, |grad|^2 and
    // Polak-Ribiere's numerator and denominator reduced together
    float t5[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int v = lane; v < nv; v += kWarp) {
      s.x[v] += alpha * s.p[v];
      s.mxa[v] += alpha * s.mp[v];
      t5[1] += (s.x[v] - s.a0[v]) * s.mxa[v];
    }
    float mgn = 0.f;  // narrow: M^-1 grad at the lane's dof
    if (narrow) {
      // one row pass; grad = mxa - J^T force and M^-1 grad on lane v's dof
      float jtf;
      t5[0] = rows_pass16<kEll>(
          a, s, [&](int r) { return s.jar[r] + alpha * s.jarp[r]; }, jtf, lane);
      mgn = grad16(a, s, jtf, s.gradn, lane);
      if (lane < nv) {
        const float gn = s.gradn[lane];
        t5[2] = gn * gn;
        t5[3] = gn * (mgn - s.mgrad[lane]);
        t5[4] = s.grad[lane] * s.mgrad[lane];
      }
    } else {
      for (int r = lane; r < nefc; r += kWarp) s.jar[r] += alpha * s.jarp[r];
      __syncwarp();
      t5[0] = cost_part<kEll, true>(a, s, s.jar, s.force, lane);
      gradients(a, s, s.mxa, s.gradn, s.mgradn, lane);
      for (int v = lane; v < nv; v += kWarp) {
        const float gn = s.gradn[v];
        t5[2] += gn * gn;
        t5[3] += gn * (s.mgradn[v] - s.mgrad[v]);
        t5[4] += s.grad[v] * s.mgrad[v];
      }
    }
    warp_sums(t5);
    const float cost_new = 0.5f * t5[0] + 0.5f * t5[1];
    const float improvement = cost - cost_new;
    const float gradnorm = sqrtf(t5[2]);
    const float beta = fmaxf(0.f, t5[3] / fmaxf(t5[4], kMinval));
    if (narrow) {
      if (lane < nv) {
        s.p[lane] = -mgn + beta * s.p[lane];
        s.grad[lane] = s.gradn[lane];
        s.mgrad[lane] = mgn;
      }
    } else {
      for (int v = lane; v < nv; v += kWarp) {
        s.p[v] = -s.mgradn[v] + beta * s.p[v];
        s.grad[v] = s.gradn[v];
        s.mgrad[v] = s.mgradn[v];
      }
    }
    __syncwarp();
    cost = cost_new;
    done = (improvement < tol) || (gradnorm < tol) ||
           (kWarm && stall_tol > 0.f && improvement < stall_tol * fabsf(cost_new));
  }

  // ---- outputs: qacc, efc_force, qfrc_constraint = J^T force, qacc_smooth
  matvec_t(s.J, s.ldj, s.force, s.tmp, nefc, nv, lane);
  for (int v = lane; v < nv; v += kWarp) {
    a.qacc[(size_t)b * nv + v] = s.x[v];
    a.qfrc[(size_t)b * nv + v] = s.tmp[v];
    a.a0[(size_t)b * nv + v] = s.a0[v];
  }
  for (int r = lane; r < nefc; r += kWarp) a.force[(size_t)b * nefc + r] = s.force[r];
  if (lane == 0) a.done[b] = done ? 1 : 0;

  // ---- Euler velocity update
  const float* qvel = a.qvel + (size_t)b * nv;
  float* qvel_new = a.qvel_new + (size_t)b * nv;
  if (a.has_damping) {
    // U on the 16-byte aligned square past qM, over M^-1, J and the vectors
    // up to rowb, free once the outputs are written (its ld (nv + nefc) + 6
    // nefc + 11 nv floats hold the lead4(nv)^2 of the square and the
    // alignment but at nv = 1 without rows, which the launch refuses); y in
    // rowb
    euler_damped<kWarp>(nv, s.qM, ld, a.damp, s.qfs, s.tmp, s.qM + ((nv * ld + 3) & ~3),
                        lead4(nv), s.rowb, qvel, qvel_new, a.dt);
  } else {
    for (int v = lane; v < nv; v += kWarp) qvel_new[v] = __ldg(qvel + v) + a.dt * s.x[v];
  }
}

// ---------------------------------------------------------------------------
// The wide core: one env per block of several warps, for envs that share
// an SM with fewer than two others (layout 2, and layout 1 above the width
// ops/cg.py::kernel_layout sets).
// One warp there left three of the SM's schedulers idle and ran the nv^3
// sweep as one warp's instruction stream (PERF.md: 78-83% of a pair
// env's 12.9-13.8M cycles). The wide core is the one-warp core (cg_core's
// path for nv > 16) with its heavy passes spread over the block:
// - M^-1 by sweep.cuh's panel sweep (the spd_inverse kernels' blocked path,
//   in panels of kPanel pivots), every entry taking the scalar sweep's
//   updates in its order, each by the same fused multiply-add;
// - the assembly, J p and M p (one thread per row of J and of qM), M^-1
//   qfrc_smooth and M^-1 grad (one thread per row of M^-1, float4 reads
//   along it), and J^T force (one warp per 16 columns, its lanes across
//   the rows, matvec_t's transposing butterfly);
// - every sum over rows or dofs, the bracket, the line search, the step
//   and the done flag on warp 0 with cg_core's own code and lane order
//   (the other warps wait at a barrier), which hands the flag to the block;
// - the damped Euler tail (euler_damped) on every thread: M + h diag(B)
//   over M^-1 (free after CG), cholesky.cuh's factor_blocked,
//   forward_blocked and backward_blocked, two barriers per 16-row panel (32
//   in all at nv 73). Its first version factored one pivot per step with
//   three block barriers each (219 at nv 73) and ran both substitutions on
//   warp 0 alone (146 dependent steps of a 5-level warp_sum): 196.8K of the
//   rodent stand-in's 340.1K cycles per env in clock64 stamps, 50.9K of
//   224.6K now, 1,518.0 -> 887.2 us per 2048-env launch (H100 80GB HBM3,
//   700 W; scripts/stamp_solve_kernel.py --rodent, ab_solve_kernel.py).
//   cg_core runs the same pieces on its 32 threads (the factor's panel
//   columns in several passes), and every entry takes its updates in pivot
//   order by the same operations whatever the thread count, so the two
//   cores stay bitwise equal, qvel_new included.
// Each value is formed by the same operations in the same order as in
// cg_core, so the wide core's outputs are bitwise the one-warp core's
// (chip_smoke.py holds that at nv > 16, where cg_core takes this path):
// float32 CG on stiff states stops early in a few envs per thousand (a
// line search leaves a direction that is not a descent direction, the
// next step is 0 and the env reports done), and which envs do changes with
// any regrouping of a sum, so a kernel whose sums are grouped otherwise
// stops in other envs than the one it is held against (a first version
// with block-wide reductions did, in 2 of 1024 pair envs; PERF.md).
// J is held by its static sparsity (jsparse.cuh): only its nnz entries are
// stored, built and multiplied, the rows of a slot entry-major, which keeps
// the dense forms' sums bitwise. A dense J (nefc x (nv | 1) in layout 1,
// (B, nefc, nv) in device memory in layout 2) is 5-10x J's nonzeros on the
// rodent files: the terrain's 107,164 B made its block 165,248 B, alone on
// its SM, and the pair's row passes and J^T force chunks each read its
// 344 KB J from device memory. Held sparse, the terrain's values take
// 19.3 KB of a 77.4 KB block, two of which share an SM, and the pair's
// (layout 2, a (B, nnz) device scratch) 35.4 KB per env, which the L2 keeps
// for the resident envs. Consecutive rows of a slot hold consecutive
// values, so a row pass (consecutive threads on consecutive rows) and a J^T
// force chunk (consecutive lanes on consecutive rows) read runs of them.
// The dense kernel keeps every entry of its J, dof-major, copied from its
// row-major input into shared memory (layout 1) or the device scratch
// (layout 2), and reads it without the tables (jsparse.cuh's kDense). P A,
// md and the pattern's tables are read through the read-only cache in both
// wide layouts, not staged.

// Warps per env of the wide core in layout 1 and layout 2 (ops/cg.py::
// WIDE_WARPS), from a sweep over 4, 8 and 16 on an H100 (PERF.md:
// the pair's layout 2 is fastest on 16, the one rat's layout 1 on 8).
#ifndef CG_WIDE_WARPS_L1
#define CG_WIDE_WARPS_L1 8
#endif
#ifndef CG_WIDE_WARPS_L2
#define CG_WIDE_WARPS_L2 16
#endif
constexpr int kWideWarps1 = CG_WIDE_WARPS_L1, kWideWarps2 = CG_WIDE_WARPS_L2;
static_assert((kWideWarps1 == 4 || kWideWarps1 == 8 || kWideWarps1 == 16) &&
                  (kWideWarps2 == 4 || kWideWarps2 == 8 || kWideWarps2 == 16),
              "4, 8 or 16 warps");
// pivots per panel of the wide sweep: 8 keeps its buffers beside the vectors
// up to layout 2's widest env (16, spd_inverse's, does not fit there)
constexpr int kPanel = 8;

// Floats of a wide block's dynamic shared memory (ops/cg.py::
// wide_smem_bytes / 4): qM (nv x ldm) and qfrc_smooth; in layout 1 J's jf
// stored values (jsparse.cuh); D, aref and exists; the elliptic block's four vectors;
// warp 0's done flag; then, 16-byte aligned, M^-1 (ldm x ldm, zero past
// nv) and the vectors the sweep does not read (jar, jarp, force; twelve
// nv-vectors), which the sweep's panel buffers overlay (and extend where
// they are larger). ldm = nv rounded up to a multiple of 4.
__device__ __host__ inline int wide_smem_floats(int nv, int nefc, int nell, bool l2, int jf) {
  const int ldm = lead4(nv), nefc4 = (nefc + 3) & ~3;
  const int head = nv * ldm + ldm + (l2 ? 0 : jf) + 3 * nefc + 4 * nell + 1;
  const int rest = 3 * nefc4 + 12 * ldm, panel = 2 * kPanel * ldm + 2 * kPanel * kPanel;
  return ((head + 3) & ~3) + ldm * ldm + (rest > panel ? rest : panel);
}

// A wide block's shared memory (wide_smem_floats): the one-warp layout's
// names (J: the jf stored values, in shared memory or device memory), the
// stride of qM and M^-1, warp 0's done flag and the sweep's panel buffers;
// and J's pattern (jsparse.cuh), in device memory.
struct SmemW : Smem {
  int ldm;                       // row stride of qM and M^-1, a multiple of 4
  float* done;                   // warp 0's done flag, read by the block
  float *Rk, *Cn, *colk, *rowk;  // the sweep's, over jar... (free during the sweep)
  const int4* jrec;              // per row {base, stride, col0, n}
  const int* jcols;              // the rows' columns
  const int2* jchw;              // per 16-column chunk and row: first entry, mask, stride
};

template <bool kL2>
__device__ __forceinline__ SmemW carve_wide(float* sm, int nv, int nefc, int nell, int jf) {
  const int ldm = lead4(nv), nefc4 = (nefc + 3) & ~3;
  SmemW s;
  s.ldm = ldm;
  float* q = sm;
  s.qM = q;
  q += nv * ldm;
  s.qfs = q;
  q += ldm;
  s.J = kL2 ? nullptr : q;  // layout 2: the kernel points it at device memory
  s.ldj = 0;                // J's entries are placed by its pattern
  q += kL2 ? 0 : jf;
  s.Dv = q;
  s.ar = s.Dv + nefc;
  s.ex = s.ar + nefc;
  s.econ = s.ex + nefc;
  s.mu = s.econ + nell;
  s.sc1 = s.mu + nell;
  s.sc2 = s.sc1 + nell;
  s.done = s.sc2 + nell;
  s.Mi = sm + ((s.done + 1 - sm + 3) & ~3);
  s.jar = s.Mi + ldm * ldm;
  s.jarp = s.jar + nefc4;
  s.force = s.jarp + nefc4;
  s.x = s.force + nefc4;  // twelve nv-vectors at stride ldm (16-byte aligned)
  s.a0 = s.x + ldm;
  s.mxa = s.a0 + ldm;
  s.grad = s.mxa + ldm;
  s.mgrad = s.grad + ldm;
  s.gradn = s.mgrad + ldm;
  s.mgradn = s.gradn + ldm;
  s.p = s.mgradn + ldm;
  s.mp = s.p + ldm;
  s.tmp = s.mp + ldm;
  s.rowb = s.tmp + ldm;
  s.Rk = s.jar;
  s.Cn = s.Rk + kPanel * ldm;
  s.colk = s.Cn + kPanel * ldm;
  s.rowk = s.colk + kPanel * kPanel;
  s.fs = s.Mi;  // the fused kernel's staging, over M^-1 (free before the sweep)
  s.cs = s.fs + 6 * nv;
  s.jrec = nullptr;  // the fused kernel points them at J's pattern
  s.jcols = nullptr;
  s.jchw = nullptr;
  return s;
}

// a . x over n columns, a and x 16-byte aligned, in dot_row's order (so
// bitwise dot_row's)
__device__ __forceinline__ float dot4(const float* a, const float* x, int n) {
  float s = 0.f;
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    const float4 u = *reinterpret_cast<const float4*>(a + j);
    const float4 w = *reinterpret_cast<const float4*>(x + j);
    s += u.x * w.x;
    s += u.y * w.y;
    s += u.z * w.z;
    s += u.w * w.w;
  }
  for (; j < n; ++j) s += a[j] * x[j];
  return s;
}

// J[r, :] . x by the row's entries (jsparse.cuh; kDenseJ: every column of
// the dense J), in dot_row's order
template <bool kDenseJ>
__device__ __forceinline__ float jdot(const SmemW& s, int r, const float* x, int nv, int nefc) {
  return jsp::row_dot<kDenseJ>(s.J, s.jrec, s.jcols, r, nv, nefc, x);
}

// y = J^T f by the block's kW warps (jsparse.cuh); no barrier
template <bool kDenseJ, int kW>
__device__ __forceinline__ void jt_f_wide(const SmemW& s, const float* f, float* y, int nv,
                                          int nefc, int lane, int warp) {
  jsp::jt_f<kDenseJ, kW>(s.J, s.jchw, f, y, nv, nefc, lane, warp);
}

// y[i] = A[i, :] . x for i < n (A: stride ld, 16-byte aligned rows), one
// thread of the kW warps per row; no barrier
template <int kW>
__device__ __forceinline__ void matvec_wide(const float* A, int ld, const float* x, float* y,
                                            int n, int tid) {
  for (int i = tid; i < n; i += kW * kWarp) y[i] = dot4(A + i * ld, x, n);
}

// gradients() by the block: J^T force into tmp (all warps), grad = mxa -
// tmp (warp 0, cg_core's lanes), M^-1 grad (all threads); starts with a
// barrier (every row's force) and ends with one (every entry of mgrad)
template <bool kDenseJ, int kW>
__device__ __forceinline__ void gradients_wide(const Args& a, const SmemW& s, const float* mxa,
                                               float* grad, float* mgrad, int tid, int lane,
                                               int warp) {
  __syncthreads();
  jt_f_wide<kDenseJ, kW>(s, s.force, s.tmp, a.nv, a.nefc, lane, warp);
  __syncthreads();
  if (warp == 0)
    for (int v = lane; v < a.nv; v += kWarp) grad[v] = mxa[v] - s.tmp[v];
  __syncthreads();
  matvec_wide<kW>(s.Mi, s.ldm, grad, mgrad, a.nv, tid);
  __syncthreads();
}

// cg_core's solve (its path for nv > 16) by a block of kW warps,
// once qM, J's values (layout 1: shared memory; layout 2: device memory;
// s.J points at them) and the per-env vectors are in place and a barrier
// has passed; writes every output of env b. kEll and kWarm as in cg_core;
// kDenseJ: J is dense (cg_solve_batched's, dof-major), else held by its
// pattern (s.jrec, s.jcols, s.jchw). Warp 0 holds the scalars (costs,
// alpha, beta, the done flag) and runs cg_core's sums and updates; every
// barrier is reached by every thread, and the loop's exit reads the flag
// warp 0 wrote.
template <bool kEll, bool kWarm, bool kDenseJ, int kW>
__device__ __forceinline__ void cg_core_wide(const Args& a, const SmemW& s, int b, int tid) {
  constexpr int kWide = kW * kWarp;  // threads per env
  const int lane = tid & (kWarp - 1), warp = tid / kWarp;
  const bool w0 = warp == 0;
  const int nv = a.nv, nefc = a.nefc, ldm = s.ldm;

  // ---- M^-1 by the panel sweep (over the block), then qacc_smooth
  for (int i = warp; i < ldm; i += kW)
    for (int j = lane; j < ldm; j += kWarp)
      s.Mi[i * ldm + j] = (i < nv && j < nv) ? s.qM[i * ldm + j] : 0.f;
  __syncthreads();
  sweep::panels<kWide, kPanel>(s.Mi, ldm, nv, s.Rk, s.Cn, s.colk, s.rowk);
  for (int v = tid; v < nv; v += kWide) {
    const float a0 = dot4(s.Mi + v * ldm, s.qfs, nv);
    s.a0[v] = a0;
    s.x[v] = a0;  // start at x = a0 (mxa = 0, so the gauss term is 0)
    s.mxa[v] = 0.f;
  }
  __syncthreads();
  for (int r = tid; r < nefc; r += kWide)
    s.jar[r] = jdot<kDenseJ>(s, r, s.x, nv, nefc) - s.ar[r];
  __syncthreads();
  float cost = 0.f;  // warp 0's
  // without kWarm x = a0 is the start: its forces are formed here
  if (w0) cost = cost_force<kEll, !kWarm>(a, s, s.jar, s.force, lane);
  if (kWarm && a.has_ws) {
    // candidate ws: x in p, qM (ws - a0) in mp, J ws - aref in jarp
    for (int v = tid; v < nv; v += kWide) {
      s.p[v] = __ldg(a.warmstart + (size_t)b * nv + v);
      s.tmp[v] = s.p[v] - s.a0[v];
    }
    __syncthreads();
    matvec_wide<kW>(s.qM, ldm, s.tmp, s.mp, nv, tid);
    for (int r = tid; r < nefc; r += kWide)
      s.jarp[r] = jdot<kDenseJ>(s, r, s.p, nv, nefc) - s.ar[r];
    __syncthreads();
    if (w0) {
      float cw[2] = {cost_part<kEll, false>(a, s, s.jarp, nullptr, lane), 0.f};
      for (int v = lane; v < nv; v += kWarp) cw[1] += s.tmp[v] * s.mp[v];
      warp_sums(cw);
      const float cost_w = 0.5f * cw[0] + 0.5f * cw[1];
      if (cost_w < cost) {  // uniform over warp 0
        for (int v = lane; v < nv; v += kWarp) {
          s.x[v] = s.p[v];
          s.mxa[v] = s.mp[v];
        }
        for (int r = lane; r < nefc; r += kWarp) s.jar[r] = s.jarp[r];
        __syncwarp();
        cost = cost_w;
      }
    }
  }
  if (kWarm && w0) cost_part<kEll, true>(a, s, s.jar, s.force, lane);  // the chosen start's forces
  gradients_wide<kDenseJ, kW>(a, s, s.mxa, s.grad, s.mgrad, tid, lane, warp);
  for (int v = tid; v < nv; v += kWide) s.p[v] = -s.mgrad[v];
  __syncthreads();

  bool done = false;
  const int iters = a.iters, ls_iters = a.ls_iters;
  const float tol = a.tol, stall_tol = a.stall_tol;
  for (int it = 0; it < iters; ++it) {
    if (done) break;  // frozen: later iterations would not change the iterate
    // J p (one thread per row) and M p (one thread per dof, counted from
    // the block's last thread, which has the fewest rows)
    for (int r = tid; r < nefc; r += kWide) s.jarp[r] = jdot<kDenseJ>(s, r, s.p, nv, nefc);
    for (int v = kWide - 1 - tid; v < nv; v += kWide) s.mp[v] = dot4(s.qM + v * ldm, s.p, nv);
    __syncthreads();
    float t5[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // warp 0's, across gradients_wide
    if (w0) {
      // cg_core's iteration up to the new iterate's forces, on warp 0: the
      // lane's share of phi'(0) and phi''(0) on its rows, of p.Mp and p.mxa
      // on its dofs, the four sums reduced together
      float r4[4] = {0.f, 0.f, 0.f, 0.f};  // p.Mp, p.mxa, phi'(0), phi''(0)
      for (int r = lane; r < nefc; r += kWarp) {
        const float jp = s.jarp[r];
        const float jr = s.jar[r];
        const float act = (jr < 0.f) ? s.ex[r] : 0.f;
        const float djp = s.Dv[r] * jp;
        r4[2] += act * djp * jr;
        r4[3] += act * djp * jp;
      }
      for (int v = lane; v < nv; v += kWarp) {
        const float mp = s.mp[v];
        r4[0] += s.p[v] * mp;
        r4[1] += s.p[v] * s.mxa[v];
      }
      if (kEll) {
        const Phi e = ell_dphi(s.jar, s.jarp, s.Dv, s.econ, s.mu, s.sc1, s.sc2, 0.f, a.nell,
                               a.ell0, lane);
        r4[2] += e.d;
        r4[3] += e.dd;
      }
      warp_sums(r4);
      const float pmp = r4[0], gauss_p = r4[1];
      const float d0 = gauss_p + r4[2], dd0 = pmp + r4[3];
      const float guess = fmaxf(-d0 / fmaxf(dd0, kMinval), kMinval);

      RowCache rc;
      rc.fill<kEll>(s, nefc, lane);
      const unsigned pos = bracket<kEll>(a, s, rc, guess, gauss_p, pmp, lane);
      float hi = candidate(guess, 12);
#pragma unroll
      for (int k = 0; k < 13; ++k)
        if ((pos >> (2 * k)) & 1u) hi = fminf(hi, candidate(guess, k));
      float lo = 0.f;
#pragma unroll
      for (int k = 0; k < 13; ++k)
        if (!((pos >> (2 * k)) & 1u) && candidate(guess, k) < hi)
          lo = fmaxf(lo, candidate(guess, k));
      float alpha = fminf(guess, hi);
      const float d0_scale = fabsf(d0) * stall_tol;
      for (int l = 0; l < ls_iters; ++l) {
        const Phi ph = dphi<kEll>(a, s, rc, alpha, gauss_p, pmp, lane);
        if (fabsf(ph.d) < tol || (kWarm && stall_tol > 0.f && fabsf(ph.d) < d0_scale)) break;
        const float lo2 = (ph.d < 0.f) ? alpha : lo;
        const float hi2 = (ph.d >= 0.f) ? alpha : hi;
        const float newton = alpha - ph.d / fmaxf(ph.dd, kMinval);
        const bool inside = (newton > lo2) && (newton < hi2);
        alpha = inside ? newton : 0.5f * (lo2 + hi2);
        lo = lo2;
        hi = hi2;
      }
      // step, then the constraint cost and forces at the new iterate
      for (int v = lane; v < nv; v += kWarp) {
        s.x[v] += alpha * s.p[v];
        s.mxa[v] += alpha * s.mp[v];
        t5[1] += (s.x[v] - s.a0[v]) * s.mxa[v];
      }
      for (int r = lane; r < nefc; r += kWarp) s.jar[r] += alpha * s.jarp[r];
      __syncwarp();
      t5[0] = cost_part<kEll, true>(a, s, s.jar, s.force, lane);
    }
    gradients_wide<kDenseJ, kW>(a, s, s.mxa, s.gradn, s.mgradn, tid, lane, warp);
    if (w0) {
      // |grad|^2 and Polak-Ribiere's numerator and denominator with the two
      // cost terms, reduced together; the direction and the done flag
      for (int v = lane; v < nv; v += kWarp) {
        const float gn = s.gradn[v];
        t5[2] += gn * gn;
        t5[3] += gn * (s.mgradn[v] - s.mgrad[v]);
        t5[4] += s.grad[v] * s.mgrad[v];
      }
      warp_sums(t5);
      const float cost_new = 0.5f * t5[0] + 0.5f * t5[1];
      const float improvement = cost - cost_new;
      const float gradnorm = sqrtf(t5[2]);
      const float beta = fmaxf(0.f, t5[3] / fmaxf(t5[4], kMinval));
      for (int v = lane; v < nv; v += kWarp) {
        s.p[v] = -s.mgradn[v] + beta * s.p[v];
        s.grad[v] = s.gradn[v];
        s.mgrad[v] = s.mgradn[v];
      }
      cost = cost_new;
      done = (improvement < tol) || (gradnorm < tol) ||
             (kWarm && stall_tol > 0.f && improvement < stall_tol * fabsf(cost_new));
      if (lane == 0) *s.done = done ? 1.f : 0.f;
    }
    __syncthreads();
    done = *s.done != 0.f;
  }

  // ---- outputs: qacc, efc_force, qfrc_constraint = J^T force, qacc_smooth
  jt_f_wide<kDenseJ, kW>(s, s.force, s.tmp, nv, nefc, lane, warp);
  __syncthreads();
  for (int v = tid; v < nv; v += kWide) {
    a.qacc[(size_t)b * nv + v] = s.x[v];
    a.qfrc[(size_t)b * nv + v] = s.tmp[v];
    a.a0[(size_t)b * nv + v] = s.a0[v];
  }
  for (int r = tid; r < nefc; r += kWide) a.force[(size_t)b * nefc + r] = s.force[r];
  if (tid == 0) a.done[b] = done ? 1 : 0;

  // ---- Euler velocity update
  const float* qvel = a.qvel + (size_t)b * nv;
  float* qvel_new = a.qvel_new + (size_t)b * nv;
  if (a.has_damping) {
    // U over M^-1 (ldm x ldm, 16-byte aligned), y in rowb
    euler_damped<kWide>(nv, s.qM, ldm, a.damp, s.qfs, s.tmp, s.Mi, ldm, s.rowb, qvel, qvel_new,
                        a.dt);
  } else {
    for (int v = tid; v < nv; v += kWide) qvel_new[v] = __ldg(qvel + v) + a.dt * s.x[v];
  }
}

// ---------------------------------------------------------------------------
// The kernels: one env per block, one warp (kW = 1, layout 1) or the wide
// core's kW warps (layout 1 or 2, kL2)

// cg_solve_fused's assembly by one warp: every input in shared memory at
// once (f, cdof, P A and md past the core's layout; the tables in buffers
// the core fills only later), qM one lane per row, J one lane per row.
template <bool kEll, bool kWarm>
__device__ __forceinline__ void fused_narrow(
    const Args& a, const float* __restrict__ f, const float* __restrict__ cdof,
    const float* __restrict__ Bm, const float* __restrict__ jsign, const float* __restrict__ md,
    const float* __restrict__ armature, const int* __restrict__ row_slot,
    const int* __restrict__ sz, const int* __restrict__ root_of_dof,
    const int* __restrict__ limit_dadr, int nlim, int nroots, int ncon, int arm_stride) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int nv = a.nv, nefc = a.nefc;
  const int ld = lead(nv);
  extern __shared__ __align__(16) float sm[];
  Smem s = carve(sm, nv, nefc, a.nell);

  const float* fb = f + (size_t)b * 6 * nv;
  const float* cb = cdof + (size_t)b * 6 * nv;
  const float* Bmb = Bm + (size_t)b * nroots * 6 * nefc;

  float* const bm_s = s.cs + 6 * nv;                    // (nroots * 6, nefc)
  float* const md_s = bm_s + nroots * 6 * nefc;         // (ncon, nv)
  int* const slot_s = reinterpret_cast<int*>(s.force);  // nefc
  int* const dadr_s = reinterpret_cast<int*>(s.jarp);   // nlim <= nefc
  float* const jsign_s = s.jar;                         // nlim
  int* const sz_s = reinterpret_cast<int*>(s.grad);     // nv
  int* const root_s = reinterpret_cast<int*>(s.mgrad);  // nv
  float* const arm_s = s.gradn;                         // nv
  copy_vec(s.fs, fb, 6 * nv, lane);
  copy_vec(s.cs, cb, 6 * nv, lane);
  copy_vec(bm_s, Bmb, nroots * 6 * nefc, lane);
  copy_vec(md_s, md, ncon * nv, lane);
  copy_vec(slot_s, row_slot, nefc, lane);
  copy_vec(dadr_s, limit_dadr, nlim, lane);
  copy_vec(jsign_s, jsign + (size_t)b * nlim, nlim, lane);
  copy_vec(sz_s, sz, nv, lane);
  copy_vec(root_s, root_of_dof, nv, lane);
  copy_vec(arm_s, armature + (size_t)b * arm_stride, nv, lane);
  load_env(a, s, b, lane);  // waits for all of them

  // ---- qM from (crb_f, cdof), one lane per row i: j ancestor-or-self of i
  // <=> i in [j, j + sz_j)
  for (int i = lane; i < nv; i += kWarp) {
    float fi[6], ci[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      fi[c] = s.fs[c * nv + i];
      ci[c] = s.cs[c * nv + i];
    }
    const int szi = sz_s[i];
    for (int j = 0; j < nv; ++j) {
      float v = 0.f;
      if (i >= j && i < j + sz_s[j]) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) acc += fi[c] * s.cs[c * nv + j];
        v += acc;
      }
      if (j > i && j < i + szi) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) acc += ci[c] * s.fs[c * nv + j];
        v += acc;
      }
      if (i == j) v += arm_s[i];
      s.qM[i * ld + j] = v;
    }
  }
  // ---- J, one lane per row: contact rows from Bm = P A and cdof, masked by
  // md (the row's six Bm entries of a root stay in registers); limit rows
  // are one-hot jsign at their dof
  for (int r = lane; r < nefc; r += kWarp) {
    const int slot = slot_s[r];
    float* Jr = s.J + r * s.ldj;
    if (slot < 0) {
      for (int v = 0; v < nv; ++v) Jr[v] = 0.f;
      continue;
    }
    const float* mdr = md_s + slot * nv;
    int root = -1;
    float bm[6];
    for (int v = 0; v < nv; ++v) {
      const int rv = root_s[v];
      if (rv != root) {
        root = rv;
#pragma unroll
        for (int c = 0; c < 6; ++c) bm[c] = bm_s[(rv * 6 + c) * nefc + r];
      }
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) acc += bm[c] * s.cs[c * nv + v];
      Jr[v] = acc * mdr[v];
    }
  }
  for (int i = lane; i < nlim; i += kWarp) s.J[i * s.ldj + dadr_s[i]] = jsign_s[i];
  __syncwarp();  // orders the J rows for the lanes that read them
  cg_core<kEll, kWarm>(a, s, b, lane);
}

// J's static pattern (jsparse.cuh): the wide core's tables, device
// pointers the wrapper uploads once per model, and its stored values' count
struct JPattern {
  const int4* rec;
  const int* cols;
  const int2* chw;
  int nnz;
};

// cg_solve_fused's assembly by a block of kW warps: f, cdof and the
// tables staged over M^-1 (free until the sweep), P A, md and J's pattern
// read through the read-only cache; qM one thread per row, J one thread per
// row at its pattern's entries (into shared memory, or into the device
// scratch: consecutive threads of a slot's rows write consecutive
// addresses).
template <bool kEll, bool kWarm, bool kL2, int kW>
__device__ __forceinline__ void fused_wide(
    const Args& a, const float* __restrict__ f, const float* __restrict__ cdof,
    const float* __restrict__ Bm, const float* __restrict__ jsign, const float* __restrict__ md,
    const float* __restrict__ armature, const int* __restrict__ row_slot,
    const int* __restrict__ sz, const int* __restrict__ root_of_dof, JPattern jp,
    float* jscratch, int nlim, int nroots, int arm_stride) {
  constexpr int kWide = kW * kWarp;  // threads per env
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nv = a.nv, nefc = a.nefc, ldm = lead4(nv);
  const int jnnz = jp.nnz;
  extern __shared__ __align__(16) float smw[];
  SmemW s = carve_wide<kL2>(smw, nv, nefc, a.nell, jnnz);
  if (kL2) s.J = jscratch + (size_t)b * jnnz;
  s.jrec = jp.rec;
  s.jcols = jp.cols;
  s.jchw = jp.chw;

  const float* fb = f + (size_t)b * 6 * nv;
  const float* cb = cdof + (size_t)b * 6 * nv;
  const float* Bmb = Bm + (size_t)b * nroots * 6 * nefc;
  // f and cdof (6 nv each), then the tables, over M^-1 and on into jar...
  // (wide_smem_floats leaves room: 15 nv + nefc + nlim <= ldm^2 + 3 nefc
  // + 12 ldm)
  int* const slot_s = reinterpret_cast<int*>(s.cs + 6 * nv);  // nefc
  float* const jsign_s = reinterpret_cast<float*>(slot_s + nefc);
  int* const sz_s = reinterpret_cast<int*>(jsign_s + nlim);    // nv
  int* const root_s = sz_s + nv;                               // nv
  float* const arm_s = reinterpret_cast<float*>(root_s + nv);  // nv
  copy_vec(s.fs, fb, 6 * nv, tid, kWide);
  copy_vec(s.cs, cb, 6 * nv, tid, kWide);
  copy_vec(slot_s, row_slot, nefc, tid, kWide);
  copy_vec(jsign_s, jsign + (size_t)b * nlim, nlim, tid, kWide);
  copy_vec(sz_s, sz, nv, tid, kWide);
  copy_vec(root_s, root_of_dof, nv, tid, kWide);
  copy_vec(arm_s, armature + (size_t)b * arm_stride, nv, tid, kWide);
  load_env(a, s, b, tid, kWide);  // waits for this thread's copies
  __syncthreads();

  // ---- qM, one thread per row (as fused_narrow)
  for (int i = tid; i < nv; i += kWide) {
    float fi[6], ci[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      fi[c] = s.fs[c * nv + i];
      ci[c] = s.cs[c * nv + i];
    }
    const int szi = sz_s[i];
    for (int j = 0; j < nv; ++j) {
      float v = 0.f;
      if (i >= j && i < j + sz_s[j]) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) acc += fi[c] * s.cs[c * nv + j];
        v += acc;
      }
      if (j > i && j < i + szi) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) acc += ci[c] * s.fs[c * nv + j];
        v += acc;
      }
      if (i == j) v += arm_s[i];
      s.qM[i * ldm + j] = v;
    }
  }
  // ---- J at its pattern's entries, one thread per row: a contact row's
  // from Bm = P A and cdof, masked by md (fused_narrow's values at the
  // slot's support dofs; the row's six Bm entries of a root stay in
  // registers); limit row r (< nlim) holds jsign_r at its dof
  for (int r = tid; r < nefc; r += kWide) {
    const jsp::Row q = jsp::row(jp.rec, r);
    float* jr = s.J + q.base;
    const int slot = slot_s[r];
    if (slot < 0) {
      if (q.n) jr[0] = jsign_s[r];
      continue;
    }
    const float* mdr = md + slot * nv;
    int root = -1;
    float bm[6];
    for (int k = 0; k < q.n; ++k) {
      const int v = __ldg(jp.cols + q.col0 + k);
      const int rv = root_s[v];
      if (rv != root) {
        root = rv;
#pragma unroll
        for (int c = 0; c < 6; ++c) bm[c] = __ldg(Bmb + (rv * 6 + c) * nefc + r);
      }
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) acc += bm[c] * s.cs[c * nv + v];
      jr[k * q.stride] = acc * __ldg(mdr + v);
    }
  }
  __syncthreads();  // orders qM and J (either memory) for every thread
  constexpr bool kDenseJ = false;
  cg_core_wide<kEll, kWarm, kDenseJ, kW>(a, s, b, tid);
}

template <bool kEll, bool kWarm, bool kL2, int kW>
__global__ void __launch_bounds__(kW * kWarp, kMinBlocks<kW>)
cg_fused_kernel(Args a, const float* __restrict__ f, const float* __restrict__ cdof,
                const float* __restrict__ Bm, const float* __restrict__ jsign,
                const float* __restrict__ md, const float* __restrict__ armature,
                const int* __restrict__ row_slot, const int* __restrict__ sz,
                const int* __restrict__ root_of_dof, const int* __restrict__ limit_dadr,
                JPattern jp, float* jscratch, int nlim, int nroots, int ncon, int arm_stride) {
  if constexpr (kW == 1) {
    static_assert(!kL2, "layout 2 runs wide");
    fused_narrow<kEll, kWarm>(a, f, cdof, Bm, jsign, md, armature, row_slot, sz, root_of_dof,
                              limit_dadr, nlim, nroots, ncon, arm_stride);
  } else {
    fused_wide<kEll, kWarm, kL2, kW>(a, f, cdof, Bm, jsign, md, armature, row_slot, sz,
                                     root_of_dof, jp, jscratch, nlim, nroots, arm_stride);
  }
}

// The row-major (nrow, ncol) src into dst column-major (dst[j nrow + i]),
// asynchronously: consecutive threads on consecutive source elements (step
// threads in all).
__device__ __forceinline__ void copy_cols(float* dst, const float* src, int nrow, int ncol,
                                          int tid, int step) {
  for (int e = tid; e < nrow * ncol; e += step) {
    const int i = e / ncol;
    copy_async(dst + (e - i * ncol) * nrow + i, src + e);
  }
}

template <bool kEll, bool kWarm, bool kL2, int kW>
__global__ void __launch_bounds__(kW * kWarp, kMinBlocks<kW>)
cg_batched_kernel(Args a, const float* __restrict__ qM, const float* __restrict__ J,
                  float* jscratch) {
  const int b = blockIdx.x;
  const int nv = a.nv, nefc = a.nefc;
  const float* qMb = qM + (size_t)b * nv * nv;
  const float* Jb = J + (size_t)b * nefc * nv;
  if constexpr (kW == 1) {
    static_assert(!kL2, "layout 2 runs wide");
    const int lane = threadIdx.x;
    extern __shared__ __align__(16) float sm[];
    Smem s = carve(sm, nv, nefc, a.nell);
    copy_rows(s.qM, lead(nv), qMb, nv, nv, lane);
    copy_rows(s.J, s.ldj, Jb, nefc, nv, lane);
    load_env(a, s, b, lane);  // waits for all of them
    cg_core<kEll, kWarm>(a, s, b, lane);
  } else {
    // every entry of J, dof-major (vals[v nefc + r]; jsparse.cuh's kDense)
    constexpr int kWide = kW * kWarp;  // threads per env
    const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
    const int jnnz = nefc * nv;
    extern __shared__ __align__(16) float smw[];
    SmemW s = carve_wide<kL2>(smw, nv, nefc, a.nell, jnnz);
    copy_rows(s.qM, s.ldm, qMb, nv, nv, tid, kWide);
    if (!kL2) copy_cols(s.J, Jb, nefc, nv, tid, kWide);
    load_env(a, s, b, tid, kWide);  // waits for this thread's copies
    if (kL2) {
      // the row-major input J into the dof-major scratch: warp w takes rows
      // 32 w + lane, ...; each lane walks its row (its cache lines stay in
      // L1 across the walk) and the warp's stores are consecutive
      s.J = jscratch + (size_t)b * jnnz;
      for (int r = warp * kWarp + lane; r < nefc; r += kWide) {
        const float* src = Jb + (size_t)r * nv;
#pragma unroll 8
        for (int v = 0; v < nv; ++v) s.J[(size_t)v * nefc + r] = __ldg(src + v);
      }
    }
    __syncthreads();
    constexpr bool kDenseJ = true;
    cg_core_wide<kEll, kWarm, kDenseJ, kW>(a, s, b, tid);
  }
}

Args make_args(const float* D, const float* aref, const uint8_t* exists,
               const uint8_t* exists_con, const float* qfrc_smooth, const float* qvel,
               const float* damp, const float* ell, const float* warmstart, float* qacc,
               float* force, float* qfrc, float* a0, float* qvel_new, uint8_t* done, int nv,
               int nefc, int nell, int ell0, int iters, int ls_iters, int has_damping,
               int has_ws, float tol, float dt, float stall_tol) {
  Args a;
  a.D = D;
  a.aref = aref;
  a.exists = exists;
  a.exists_con = exists_con;
  a.qfrc_smooth = qfrc_smooth;
  a.qvel = qvel;
  a.damp = damp;
  a.ell = ell;
  a.warmstart = warmstart;
  a.qacc = qacc;
  a.force = force;
  a.qfrc = qfrc;
  a.a0 = a0;
  a.qvel_new = qvel_new;
  a.done = done;
  a.nv = nv;
  a.nefc = nefc;
  a.nell = nell;
  a.ell0 = ell0;
  a.iters = iters;
  a.ls_iters = ls_iters;
  a.has_damping = has_damping;
  a.has_ws = has_ws;
  a.tol = tol;
  a.dt = dt;
  a.stall_tol = stall_tol;
  return a;
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The geometry a launch asks for, checked against what the kernels take:
// one warp in layout 1, or the wide core's warps of the layout (with the
// wide layout's own shared-memory size for J's jnnz stored values), the
// scratch where layout 2 needs it; a damped one-warp env has room for its
// factor (cg_core).
bool bad_geometry(int layout, int warps, int smem, int nv, int nefc, int nell, int jnnz,
                  const float* jscratch, int has_damping) {
  if (layout != 1 && layout != 2) return true;
  if (warps == 1 && has_damping && nv == 1 && nefc == 0) return true;
  if (warps != 1 && warps != (layout == 1 ? kWideWarps1 : kWideWarps2)) return true;
  if (layout == 2 && (warps == 1 || jscratch == nullptr)) return true;
  return warps > 1 && smem != 4 * wide_smem_floats(nv, nefc, nell, layout == 2, jnnz);
}

// cg_solve_fused's instance for a launch: one warp or the wide core's warps
// of the layout, with or without the elliptic block and the warmstart /
// stall exit (a launch's geometry is checked by bad_geometry first).
auto fused_kernel(int layout, int warps, bool ell, bool warm) {
  auto pick = [&](auto k11, auto k10, auto k01, auto k00) {
    return ell ? (warm ? k11 : k10) : (warm ? k01 : k00);
  };
  constexpr int W1 = kWideWarps1, W2 = kWideWarps2;
  return warps == 1
             ? pick(cg_fused_kernel<true, true, false, 1>, cg_fused_kernel<true, false, false, 1>,
                    cg_fused_kernel<false, true, false, 1>, cg_fused_kernel<false, false, false, 1>)
         : layout == 1
             ? pick(cg_fused_kernel<true, true, false, W1>, cg_fused_kernel<true, false, false, W1>,
                    cg_fused_kernel<false, true, false, W1>,
                    cg_fused_kernel<false, false, false, W1>)
             : pick(cg_fused_kernel<true, true, true, W2>, cg_fused_kernel<true, false, true, W2>,
                    cg_fused_kernel<false, true, true, W2>, cg_fused_kernel<false, false, true, W2>);
}

}  // namespace

// Each launch function starts one block per env on `stream`: `warps` warps
// (1, or the wide core's count for the layout) in `layout` 1 or 2 with `smem` bytes of
// dynamic shared memory (ops/cg.py::kernel_layout), and returns the
// cudaGetLastError() code of the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernels do not take. `warmstart`
// may be null when has_ws is 0. cg_solve_fused's wide core holds J by its
// pattern (jsparse.cuh: `jrec`, `jcols`, `jchw` and its `jnnz` stored
// values), which the one-warp core does not read; cg_solve_batched's holds
// the dense J dof-major (nefc nv values). `jscratch`, a (B, stored values)
// float32 scratch that layout 2 keeps J's values in, may be null in
// layout 1.
extern "C" int cg_fused_launch(
    const float* f, const float* cdof, const float* Bm, const float* jsign,
    const float* D, const float* aref, const uint8_t* exists, const uint8_t* exists_con,
    const float* qfrc_smooth, const float* qvel, const float* damp, const float* md,
    const float* armature, const float* ell, const float* warmstart, const int* row_slot,
    const int* sz, const int* root_of_dof, const int* limit_dadr, const int* jrec,
    const int* jcols, const int* jchw, float* qacc, float* force, float* qfrc, float* a0,
    float* qvel_new, uint8_t* done, float* jscratch, int B, int nv, int nefc, int nlim,
    int nroots, int ncon, int nell, int ell0, int jnnz, int smem, int layout, int warps,
    int iters, int ls_iters, int has_damping, int has_ws, float tol, float dt, float stall_tol,
    int arm_stride, void* stream) {
  if (B == 0) return 0;
  if (bad_geometry(layout, warps, smem, nv, nefc, nell, jnnz, jscratch, has_damping))
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_kernel(layout, warps, nell > 0, has_ws || stall_tol > 0.f);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const Args a = make_args(D, aref, exists, exists_con, qfrc_smooth, qvel, damp, ell, warmstart,
                           qacc, force, qfrc, a0, qvel_new, done, nv, nefc, nell, ell0, iters,
                           ls_iters, has_damping, has_ws, tol, dt, stall_tol);
  const JPattern jp{reinterpret_cast<const int4*>(jrec), jcols,
                    reinterpret_cast<const int2*>(jchw), jnnz};
  kernel<<<B, warps * kWarp, smem, (cudaStream_t)stream>>>(
      a, f, cdof, Bm, jsign, md, armature, row_slot, sz, root_of_dof, limit_dadr, jp, jscratch,
      nlim, nroots, ncon, arm_stride);
  return (int)cudaGetLastError();
}

// Blocks of cg_solve_fused's instance for (layout, warps, elliptic block,
// warmstart or stall exit) that one SM holds at `smem` bytes of dynamic
// shared memory per block (cudaOccupancyMaxActiveBlocksPerMultiprocessor:
// what the card's registers and shared memory allow), or -1 on an error.
extern "C" int cg_fused_blocks_per_sm(int layout, int warps, int ell, int warm, int smem) {
  if (layout != 1 && layout != 2) return -1;
  auto kernel = fused_kernel(layout, warps, ell != 0, warm != 0);
  if (allow_smem(kernel, smem)) return -1;
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, warps * kWarp, smem);
  return err == cudaSuccess ? n : -1;
}

extern "C" int cg_batched_launch(
    const float* qM, const float* J, const float* D, const float* aref, const uint8_t* exists,
    const uint8_t* exists_con, const float* qfrc_smooth, const float* qvel, const float* damp,
    const float* ell, const float* warmstart, float* qacc, float* force, float* qfrc, float* a0,
    float* qvel_new, uint8_t* done, float* jscratch, int B, int nv, int nefc, int nell, int ell0,
    int smem, int layout, int warps, int iters, int ls_iters, int has_damping, int has_ws,
    float tol, float dt, float stall_tol, void* stream) {
  if (B == 0) return 0;
  if (bad_geometry(layout, warps, smem, nv, nefc, nell, nefc * nv, jscratch, has_damping))
    return (int)cudaErrorInvalidValue;
  const bool warm = has_ws || stall_tol > 0.f;
  auto pick = [&](auto k11, auto k10, auto k01, auto k00) {
    return nell ? (warm ? k11 : k10) : (warm ? k01 : k00);
  };
  constexpr int W1 = kWideWarps1, W2 = kWideWarps2;
  auto kernel =
      warps == 1
          ? pick(cg_batched_kernel<true, true, false, 1>, cg_batched_kernel<true, false, false, 1>,
                 cg_batched_kernel<false, true, false, 1>,
                 cg_batched_kernel<false, false, false, 1>)
      : layout == 1
          ? pick(cg_batched_kernel<true, true, false, W1>,
                 cg_batched_kernel<true, false, false, W1>,
                 cg_batched_kernel<false, true, false, W1>,
                 cg_batched_kernel<false, false, false, W1>)
          : pick(cg_batched_kernel<true, true, true, W2>, cg_batched_kernel<true, false, true, W2>,
                 cg_batched_kernel<false, true, true, W2>,
                 cg_batched_kernel<false, false, true, W2>);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const Args a = make_args(D, aref, exists, exists_con, qfrc_smooth, qvel, damp, ell, warmstart,
                           qacc, force, qfrc, a0, qvel_new, done, nv, nefc, nell, ell0, iters,
                           ls_iters, has_damping, has_ws, tol, dt, stall_tol);
  kernel<<<B, warps * kWarp, smem, (cudaStream_t)stream>>>(a, qM, J, jscratch);
  return (int)cudaGetLastError();
}
