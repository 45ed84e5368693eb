// Batched constraint solve + Euler velocity update for Hopper (sm_90a).
//
// Replaces the TPU kernels brax_tracking_tpu/ops/cg.py::cg_solve_fused
// (_cg_fused_kernel -> _assemble_qM_J + _cg_core) and cg_solve_batched
// (_cg_kernel -> _cg_core): per env, assemble qM and J from their low-rank
// factors (cg_fused_kernel) or read them dense (cg_batched_kernel), invert M
// by the sweep operator, run MuJoCo CG with a bracketed Newton line search on
// one-sided quadratic rows plus one contiguous block of dim-3 elliptic
// contacts, optionally from the better of a warmstart and qacc_smooth and
// with the float32 stall exit, and form the Euler velocity update (Cholesky
// factor + solve of M + h diag(B) when the model has damping). Both kernels
// run one device function, cg_core, once qM, J and the per-env vectors are in
// shared memory.
//
// Design. The TPU kernel tiles (rows, dofs, 128 envs) in VMEM; here one
// warp owns one env and one block holds one warp. qM, M^-1 and J stay in
// shared memory for the whole solve (row stride padded to an odd count so
// lane-per-row reads are free of bank conflicts), so the kernel reads its
// inputs once and writes its outputs once. What bounds it is the chain of
// small dependent reductions (J p, M p, 14 + ls_iters line-search sums per
// CG iteration), each a few shuffle steps; envs run concurrently across
// warps (2048 envs = 2048 warps, ~16 per SM). A warp leaves the iteration
// loop as soon as its env has converged: the frozen iterate is the result,
// and the done flag it writes is the one the TPU kernel's freeze leaves.
//
// The elliptic block. The TPU kernel permutes the block to [n*C][t1*C][t2*C]
// for its sublanes; here each lane takes whole contacts in their input order
// [n, t1, t2] (rows ell0 + 3c + {0, 1, 2}), so nothing is permuted. The
// per-contact zone logic (bottom: three quadratics; middle: the cone's
// quadratic in n - mu t; top: no force) adds into the same per-lane partial
// sums as the quadratic rows, so the cost and each phi' / phi'' evaluation
// stay one warp reduction. mu and the two tangent scales are a per-model
// (3, nell) array, staged with each env's contact activation in shared
// memory. The core is compiled twice (template kEll), so a model without the
// block runs loops with no trace of it: with the block's code in every
// phi' evaluation the minirat's solve took 94 us per launch instead of the
// 83 us it took before the block existed (H100, 2048 envs).
//
// Warmstart (mj_warmstart): the cost at the warmstart (one extra qM (ws - a0)
// product) against the cost at qacc_smooth; the cheaper one starts CG. Only
// the chosen start's force and gradient are formed. The stall exit adds
// |phi'| < stall_tol |phi'(0)| to the line search's freeze and
// improvement < stall_tol |cost| to the done flag. Both are compiled in only
// where a launch asks for either (template kWarm; a Newton chunk asks for
// both), so a plain CG launch runs none of their tests in its loops.
//
// Products: J x and M x put one lane on each output row (serial dot over
// nv); J^T f reduces each column over the rows across the warp. Every
// reduction ends with a broadcast from lane 0, so all lanes hold bitwise the
// same scalars and take the same branches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinval = 1e-15f;

__device__ inline int lead(int nv) { return nv | 1; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}

// y[i] = sum_j A[i, j] x[j], A row-major with stride ld; one lane per row
__device__ __forceinline__ void matvec(const float* A, int ld, const float* x,
                                       float* y, int nrow, int ncol, int lane) {
  for (int i = lane; i < nrow; i += kWarp) {
    const float* a = A + i * ld;
    float s = 0.f;
    for (int j = 0; j < ncol; ++j) s += a[j] * x[j];
    y[i] = s;
  }
  __syncwarp();
}

// y[v] = sum_r J[r, v] f[r]; each column reduced across the warp
__device__ __forceinline__ void matvec_t(const float* J, int ld, const float* f,
                                         float* y, int nrow, int ncol, int lane) {
  for (int v = 0; v < ncol; ++v) {
    float s = 0.f;
    for (int r = lane; r < nrow; r += kWarp) s += J[r * ld + v] * f[r];
    s = warp_sum(s);
    if (lane == 0) y[v] = s;
  }
  __syncwarp();
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n, int lane) {
  float s = 0.f;
  for (int i = lane; i < n; i += kWarp) s += a[i] * b[i];
  return warp_sum(s);
}

// In-place SPD inverse by the sweep operator (same elimination order and
// update formulas as the plain version).
__device__ void sweep_inverse(float* S, int ld, int n, float* rowb, float* colb, int lane) {
  for (int k = 0; k < n; ++k) {
    for (int i = lane; i < n; i += kWarp) {
      rowb[i] = S[k * ld + i];
      colb[i] = S[i * ld + k];
    }
    __syncwarp();
    const float dinv = 1.f / rowb[k];
    for (int e = lane; e < n * n; e += kWarp) {
      const int i = e / n, j = e - i * n;
      float v;
      if (i == k && j == k) v = dinv;
      else if (i == k) v = rowb[j] * dinv;
      else if (j == k) v = -colb[i] * dinv;
      else v = S[i * ld + j] - colb[i] * (rowb[j] * dinv);
      S[i * ld + j] = v;
    }
    __syncwarp();
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
// factor), J, six nefc-vectors, thirteen nv-vectors, four nell-vectors.
struct Smem {
  float *qM, *Mi, *J;
  float *Dv, *ar, *ex, *jar, *jarp, *force;
  float *x, *a0, *mxa, *grad, *mgrad, *gradn, *mgradn, *p, *mp, *qfs, *tmp, *rowb, *colb;
  float *econ, *mu, *sc1, *sc2;
};

__device__ __forceinline__ Smem carve(float* sm, int nv, int nefc, int nell) {
  const int ld = lead(nv);
  Smem s;
  s.qM = sm;
  s.Mi = s.qM + nv * ld;
  s.J = s.Mi + nv * ld;
  s.Dv = s.J + nefc * ld;
  s.ar = s.Dv + nefc;
  s.ex = s.ar + nefc;
  s.jar = s.ex + nefc;
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
  s.qfs = s.mp + nv;
  s.tmp = s.qfs + nv;
  s.rowb = s.tmp + nv;
  s.colb = s.rowb + nv;
  s.econ = s.colb + nv;
  s.mu = s.econ + nell;
  s.sc1 = s.mu + nell;
  s.sc2 = s.sc1 + nell;
  return s;
}

// The per-env vectors into shared memory. Inputs are read through the
// read-only cache (__ldg): the Args struct's pointers carry no __restrict__,
// and plain loads through them cost the minirat's solve ~3% (H100).
__device__ __forceinline__ void load_env(const Args& a, const Smem& s, int b, int lane) {
  for (int r = lane; r < a.nefc; r += kWarp) {
    s.Dv[r] = __ldg(a.D + (size_t)b * a.nefc + r);
    s.ar[r] = __ldg(a.aref + (size_t)b * a.nefc + r);
    s.ex[r] = __ldg(a.exists + (size_t)b * a.nefc + r) ? 1.f : 0.f;
  }
  for (int v = lane; v < a.nv; v += kWarp) s.qfs[v] = __ldg(a.qfrc_smooth + (size_t)b * a.nv + v);
  for (int c = lane; c < a.nell; c += kWarp) {
    s.econ[c] = __ldg(a.exists_con + (size_t)b * a.nell + c) ? 1.f : 0.f;
    s.mu[c] = __ldg(a.ell + c);
    s.sc1[c] = __ldg(a.ell + a.nell + c);
    s.sc2[c] = __ldg(a.ell + 2 * a.nell + c);
  }
  __syncwarp();
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

// The constraint cost at jar (quadratic rows and, with kEll, the elliptic
// block); with kForce the per-row forces go to `force`.
template <bool kEll, bool kForce>
__device__ __forceinline__ float cost_force(const Args& a, const Smem& s, const float* jar,
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
  return 0.5f * warp_sum(c);
}

// grad = mxa - J^T force into `grad`, M^-1 grad into `mgrad`
__device__ __forceinline__ void gradients(const Args& a, const Smem& s, const float* mxa,
                                          float* grad, float* mgrad, int lane) {
  const int ld = lead(a.nv);
  matvec_t(s.J, ld, s.force, s.tmp, a.nefc, a.nv, lane);
  for (int v = lane; v < a.nv; v += kWarp) grad[v] = mxa[v] - s.tmp[v];
  __syncwarp();
  matvec(s.Mi, ld, grad, mgrad, a.nv, a.nv, lane);
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

// (phi'(alpha), phi''(alpha)) along the search direction
template <bool kEll>
__device__ __forceinline__ Phi dphi(const Args& a, const Smem& s, float alpha, float gauss_p,
                                    float pmp, int lane) {
  const float* jar = s.jar;
  const float* jarp = s.jarp;
  const float* Dv = s.Dv;
  const float* ex = s.ex;
  const int nefc = a.nefc;
  float d = 0.f, dd = 0.f;
  for (int r = lane; r < nefc; r += kWarp) {
    const float ja = jar[r] + alpha * jarp[r];
    const float act = (ja < 0.f) ? ex[r] : 0.f;
    const float djp = Dv[r] * jarp[r];
    d += act * djp * ja;
    dd += act * djp * jarp[r];
  }
  if (kEll) {
    const Phi e = ell_dphi(jar, jarp, s.Dv, s.econ, s.mu, s.sc1, s.sc2, alpha, a.nell, a.ell0,
                           lane);
    d += e.d;
    dd += e.dd;
  }
  Phi out;
  out.d = gauss_p + alpha * pmp + warp_sum(d);
  out.dd = pmp + warp_sum(dd);
  return out;
}

// The solve once qM (also copied into Mi), J and the per-env vectors are in
// shared memory; writes every output of env b. kEll (nell > 0) compiles the
// elliptic block in: without it the quadratic rows' loops carry no trace of
// it. kWarm (a warmstart or stall_tol > 0) compiles in the warmstart select
// and the stall exit.
template <bool kEll, bool kWarm>
__device__ __forceinline__ void cg_core(const Args& a, const Smem& s, int b, int lane) {
  const int nv = a.nv, nefc = a.nefc;
  const int ld = lead(nv);

  // ---- M^-1 (stays in shared memory) and qacc_smooth
  sweep_inverse(s.Mi, ld, nv, s.rowb, s.colb, lane);
  matvec(s.Mi, ld, s.qfs, s.a0, nv, nv, lane);

  // ---- start at x = a0 (mxa = 0, so the gauss term is 0)
  for (int v = lane; v < nv; v += kWarp) {
    s.x[v] = s.a0[v];
    s.mxa[v] = 0.f;
  }
  __syncwarp();
  matvec(s.J, ld, s.x, s.jar, nefc, nv, lane);
  for (int r = lane; r < nefc; r += kWarp) s.jar[r] -= s.ar[r];
  __syncwarp();
  // without kWarm x = a0 is the start: its forces are formed here
  float cost = cost_force<kEll, !kWarm>(a, s, s.jar, s.force, lane);
  if (kWarm && a.has_ws) {
    // candidate ws: x in p, qM (ws - a0) in mp, J ws - aref in jarp
    for (int v = lane; v < nv; v += kWarp) {
      s.p[v] = __ldg(a.warmstart + (size_t)b * nv + v);
      s.tmp[v] = s.p[v] - s.a0[v];
    }
    __syncwarp();
    matvec(s.qM, ld, s.tmp, s.mp, nv, nv, lane);
    matvec(s.J, ld, s.p, s.jarp, nefc, nv, lane);
    for (int r = lane; r < nefc; r += kWarp) s.jarp[r] -= s.ar[r];
    __syncwarp();
    const float cost_w =
        cost_force<kEll, false>(a, s, s.jarp, nullptr, lane) + 0.5f * dot(s.tmp, s.mp, nv, lane);
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
  if (kWarm) cost_force<kEll, true>(a, s, s.jar, s.force, lane);  // the chosen start
  gradients(a, s, s.mxa, s.grad, s.mgrad, lane);
  for (int v = lane; v < nv; v += kWarp) s.p[v] = -s.mgrad[v];
  __syncwarp();

  bool done = false;
  const int iters = a.iters, ls_iters = a.ls_iters;
  const float tol = a.tol, stall_tol = a.stall_tol;
  for (int it = 0; it < iters; ++it) {
    if (done) break;  // frozen: later iterations would not change the iterate
    matvec(s.J, ld, s.p, s.jarp, nefc, nv, lane);
    matvec(s.qM, ld, s.p, s.mp, nv, nv, lane);
    const float pmp = dot(s.p, s.mp, nv, lane);
    const float gauss_p = dot(s.p, s.mxa, nv, lane);

    const Phi ph0 = dphi<kEll>(a, s, 0.f, gauss_p, pmp, lane);
    const float guess = fmaxf(-ph0.d / fmaxf(ph0.dd, kMinval), kMinval);
    // bracket: phi' at guess * 2^k, k = 0..12 (kept in registers: every
    // lane holds the same reduced values)
    float cv[13];
    bool pv[13];
    float pw = 1.f;
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      cv[k] = guess * pw;
      pv[k] = dphi<kEll>(a, s, cv[k], gauss_p, pmp, lane).d >= 0.f;
      pw *= 2.f;
    }
    float hi = cv[12];
#pragma unroll
    for (int k = 0; k < 13; ++k)
      if (pv[k]) hi = fminf(hi, cv[k]);
    float lo = 0.f;
#pragma unroll
    for (int k = 0; k < 13; ++k)
      if (!pv[k] && cv[k] < hi) lo = fmaxf(lo, cv[k]);
    float alpha = fminf(guess, hi);
    const float d0_scale = fabsf(ph0.d) * stall_tol;
    for (int l = 0; l < ls_iters; ++l) {
      const Phi ph = dphi<kEll>(a, s, alpha, gauss_p, pmp, lane);
      const bool conv =
          fabsf(ph.d) < tol || (kWarm && stall_tol > 0.f && fabsf(ph.d) < d0_scale);
      const float lo2 = (ph.d < 0.f) ? alpha : lo;
      const float hi2 = (ph.d >= 0.f) ? alpha : hi;
      const float newton = alpha - ph.d / fmaxf(ph.dd, kMinval);
      const bool inside = (newton > lo2) && (newton < hi2);
      const float alpha2 = inside ? newton : 0.5f * (lo2 + hi2);
      if (!conv) {
        alpha = alpha2;
        lo = lo2;
        hi = hi2;
      }
    }

    // step, then the cost, forces and gradients at the new iterate
    for (int v = lane; v < nv; v += kWarp) {
      s.x[v] += alpha * s.p[v];
      s.mxa[v] += alpha * s.mp[v];
    }
    for (int r = lane; r < nefc; r += kWarp) s.jar[r] += alpha * s.jarp[r];
    __syncwarp();
    float cost_new = cost_force<kEll, true>(a, s, s.jar, s.force, lane);
    float g = 0.f;
    for (int v = lane; v < nv; v += kWarp) g += (s.x[v] - s.a0[v]) * s.mxa[v];
    cost_new += 0.5f * warp_sum(g);
    gradients(a, s, s.mxa, s.gradn, s.mgradn, lane);

    const float improvement = cost - cost_new;
    const float gradnorm = sqrtf(dot(s.gradn, s.gradn, nv, lane));
    float num = 0.f, den = 0.f;
    for (int v = lane; v < nv; v += kWarp) {
      num += s.gradn[v] * (s.mgradn[v] - s.mgrad[v]);
      den += s.grad[v] * s.mgrad[v];
    }
    const float beta = fmaxf(0.f, warp_sum(num) / fmaxf(warp_sum(den), kMinval));
    for (int v = lane; v < nv; v += kWarp) {
      s.p[v] = -s.mgradn[v] + beta * s.p[v];
      s.grad[v] = s.gradn[v];
      s.mgrad[v] = s.mgradn[v];
    }
    __syncwarp();
    cost = cost_new;
    done = (improvement < tol) || (gradnorm < tol) ||
           (kWarm && stall_tol > 0.f && improvement < stall_tol * fabsf(cost_new));
  }

  // ---- outputs: qacc, efc_force, qfrc_constraint = J^T force, qacc_smooth
  matvec_t(s.J, ld, s.force, s.tmp, nefc, nv, lane);
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
    // (M + h diag(B)) = U^T U, right-looking; rows of Mi become U
    float* U = s.Mi;
    for (int e = lane; e < nv * nv; e += kWarp) {
      const int i = e / nv, j = e - i * nv;
      U[i * ld + j] = s.qM[i * ld + j] + ((i == j) ? __ldg(a.damp + i) : 0.f);
    }
    __syncwarp();
    for (int k = 0; k < nv; ++k) {
      const float c = 1.f / sqrtf(U[k * ld + k]);
      __syncwarp();
      for (int j = k + lane; j < nv; j += kWarp) U[k * ld + j] *= c;
      __syncwarp();
      for (int e = lane; e < nv * nv; e += kWarp) {
        const int i = e / nv, j = e - i * nv;
        if (i > k && j >= i) U[i * ld + j] -= U[k * ld + i] * U[k * ld + j];
      }
      __syncwarp();
    }
    // rhs = qfrc_smooth + qfrc_constraint; forward U^T y = rhs into rowb
    for (int k = 0; k < nv; ++k) {
      float sum = 0.f;
      for (int i = lane; i < k; i += kWarp) sum += U[i * ld + k] * s.rowb[i];
      sum = warp_sum(sum);
      if (lane == 0) s.rowb[k] = (s.qfs[k] + s.tmp[k] - sum) / U[k * ld + k];
      __syncwarp();
    }
    // backward U z = y into colb
    for (int k = nv - 1; k >= 0; --k) {
      float sum = 0.f;
      for (int j = k + 1 + lane; j < nv; j += kWarp) sum += U[k * ld + j] * s.colb[j];
      sum = warp_sum(sum);
      if (lane == 0) s.colb[k] = (s.rowb[k] - sum) / U[k * ld + k];
      __syncwarp();
    }
    for (int v = lane; v < nv; v += kWarp) qvel_new[v] = __ldg(qvel + v) + a.dt * s.colb[v];
  } else {
    for (int v = lane; v < nv; v += kWarp) qvel_new[v] = __ldg(qvel + v) + a.dt * s.x[v];
  }
}

template <bool kEll, bool kWarm>
__global__ void __launch_bounds__(kWarp)
cg_fused_kernel(Args a, const float* __restrict__ f, const float* __restrict__ cdof,
                const float* __restrict__ Bm, const float* __restrict__ jsign,
                const float* __restrict__ md, const float* __restrict__ armature,
                const int* __restrict__ row_slot, const int* __restrict__ sz,
                const int* __restrict__ root_of_dof, const int* __restrict__ limit_dadr,
                int nlim, int nroots) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int nv = a.nv, nefc = a.nefc;
  const int ld = lead(nv);
  extern __shared__ float sm[];
  const Smem s = carve(sm, nv, nefc, a.nell);

  const float* fb = f + (size_t)b * 6 * nv;
  const float* cb = cdof + (size_t)b * 6 * nv;
  const float* Bmb = Bm + (size_t)b * nroots * 6 * nefc;

  // ---- qM from (crb_f, cdof): j ancestor-or-self of i <=> i in [j, j+sz_j)
  for (int e = lane; e < nv * nv; e += kWarp) {
    const int i = e / nv, j = e - i * nv;
    float v = 0.f;
    if (i >= j && i < j + sz[j]) {
      float acc = 0.f;
      for (int c = 0; c < 6; ++c) acc += fb[c * nv + i] * cb[c * nv + j];
      v += acc;
    }
    if (j > i && j < i + sz[i]) {
      float acc = 0.f;
      for (int c = 0; c < 6; ++c) acc += cb[c * nv + i] * fb[c * nv + j];
      v += acc;
    }
    if (i == j) v += armature[i];
    s.qM[i * ld + j] = v;
    s.Mi[i * ld + j] = v;
  }
  // ---- J: contact rows from Bm = P A and cdof, masked by md; limit rows
  // are one-hot jsign at their dof
  for (int e = lane; e < nefc * nv; e += kWarp) {
    const int r = e / nv, v = e - r * nv;
    const int slot = row_slot[r];
    float val = 0.f;
    if (slot >= 0) {
      const float* bm = Bmb + root_of_dof[v] * 6 * nefc + r;
      float acc = 0.f;
      for (int c = 0; c < 6; ++c) acc += bm[c * nefc] * cb[c * nv + v];
      val = acc * md[slot * nv + v];
    }
    s.J[r * ld + v] = val;
  }
  load_env(a, s, b, lane);
  for (int i = lane; i < nlim; i += kWarp) s.J[i * ld + limit_dadr[i]] = jsign[(size_t)b * nlim + i];
  __syncwarp();
  cg_core<kEll, kWarm>(a, s, b, lane);
}

template <bool kEll, bool kWarm>
__global__ void __launch_bounds__(kWarp)
cg_batched_kernel(Args a, const float* __restrict__ qM, const float* __restrict__ J) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int nv = a.nv, nefc = a.nefc;
  const int ld = lead(nv);
  extern __shared__ float sm[];
  const Smem s = carve(sm, nv, nefc, a.nell);

  const float* qMb = qM + (size_t)b * nv * nv;
  const float* Jb = J + (size_t)b * nefc * nv;
  for (int e = lane; e < nv * nv; e += kWarp) {
    const int i = e / nv, j = e - i * nv;
    s.qM[i * ld + j] = qMb[e];
    s.Mi[i * ld + j] = qMb[e];
  }
  for (int e = lane; e < nefc * nv; e += kWarp) {
    const int r = e / nv, v = e - r * nv;
    s.J[r * ld + v] = Jb[e];
  }
  load_env(a, s, b, lane);
  cg_core<kEll, kWarm>(a, s, b, lane);
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

}  // namespace

// Each launch function starts one warp per env on `stream` with `smem` bytes
// of dynamic shared memory per block and returns the cudaGetLastError() code
// of the launch (0 on success). `warmstart` may be null when has_ws is 0.
extern "C" int cg_fused_launch(
    const float* f, const float* cdof, const float* Bm, const float* jsign,
    const float* D, const float* aref, const uint8_t* exists, const uint8_t* exists_con,
    const float* qfrc_smooth, const float* qvel, const float* damp, const float* md,
    const float* armature, const float* ell, const float* warmstart, const int* row_slot,
    const int* sz, const int* root_of_dof, const int* limit_dadr, float* qacc, float* force,
    float* qfrc, float* a0, float* qvel_new, uint8_t* done, int B, int nv, int nefc,
    int nlim, int nroots, int nell, int ell0, int smem, int iters, int ls_iters,
    int has_damping, int has_ws, float tol, float dt, float stall_tol, void* stream) {
  if (B == 0) return 0;
  const bool warm = has_ws || stall_tol > 0.f;
  auto kernel = nell ? (warm ? cg_fused_kernel<true, true> : cg_fused_kernel<true, false>)
                     : (warm ? cg_fused_kernel<false, true> : cg_fused_kernel<false, false>);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const Args a = make_args(D, aref, exists, exists_con, qfrc_smooth, qvel, damp, ell, warmstart,
                           qacc, force, qfrc, a0, qvel_new, done, nv, nefc, nell, ell0, iters,
                           ls_iters, has_damping, has_ws, tol, dt, stall_tol);
  kernel<<<B, kWarp, smem, (cudaStream_t)stream>>>(
      a, f, cdof, Bm, jsign, md, armature, row_slot, sz, root_of_dof, limit_dadr, nlim, nroots);
  return (int)cudaGetLastError();
}

extern "C" int cg_batched_launch(
    const float* qM, const float* J, const float* D, const float* aref, const uint8_t* exists,
    const uint8_t* exists_con, const float* qfrc_smooth, const float* qvel, const float* damp,
    const float* ell, const float* warmstart, float* qacc, float* force, float* qfrc, float* a0,
    float* qvel_new, uint8_t* done, int B, int nv, int nefc, int nell, int ell0, int smem,
    int iters, int ls_iters, int has_damping, int has_ws, float tol, float dt, float stall_tol,
    void* stream) {
  if (B == 0) return 0;
  const bool warm = has_ws || stall_tol > 0.f;
  auto kernel = nell ? (warm ? cg_batched_kernel<true, true> : cg_batched_kernel<true, false>)
                     : (warm ? cg_batched_kernel<false, true> : cg_batched_kernel<false, false>);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const Args a = make_args(D, aref, exists, exists_con, qfrc_smooth, qvel, damp, ell, warmstart,
                           qacc, force, qfrc, a0, qvel_new, done, nv, nefc, nell, ell0, iters,
                           ls_iters, has_damping, has_ws, tol, dt, stall_tol);
  kernel<<<B, kWarp, smem, (cudaStream_t)stream>>>(a, qM, J);
  return (int)cudaGetLastError();
}
