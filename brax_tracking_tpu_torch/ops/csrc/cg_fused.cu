// Batched constraint solve + Euler velocity update for Hopper (sm_90a).
//
// Replaces the TPU kernel brax_tracking_tpu/ops/cg.py::cg_solve_fused
// (_cg_fused_kernel -> _assemble_qM_J + _cg_core): per env, assemble qM and
// J from their low-rank factors, invert M by the sweep operator, run MuJoCo
// CG with a bracketed Newton line search on one-sided quadratic rows, and
// form the Euler velocity update (Cholesky factor + solve of M + h diag(B)
// when the model has damping).
//
// Design. The TPU kernel tiles (rows, dofs, 128 envs) in VMEM; here one
// warp owns one env and one block holds one warp. qM, M^-1 and J stay in
// shared memory for the whole solve (row stride padded to an odd count so
// lane-per-row reads are free of bank conflicts), so the kernel reads its
// inputs once and writes its outputs once. What bounds it is the chain of
// small dependent reductions (J p, M p, 14 + ls_iters line-search sums per
// CG iteration), each a few shuffle steps; envs run concurrently across
// warps (2048 envs = 2048 warps, ~16 per SM). A warp leaves the iteration
// loop as soon as its env has converged: the frozen iterate is the result.
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

// The one-sided quadratic cost at jar: forces into `force`, returns the
// constraint cost.
__device__ __forceinline__ float cost_force(const float* jar, const float* Dv, const float* ex,
                                            float* force, int nefc, int lane) {
  float c = 0.f;
  for (int r = lane; r < nefc; r += kWarp) {
    const float a = (jar[r] < 0.f) ? ex[r] : 0.f;
    force[r] = -Dv[r] * jar[r] * a;
    c += a * Dv[r] * jar[r] * jar[r];
  }
  __syncwarp();
  return 0.5f * warp_sum(c);
}

struct Phi {
  float d, dd;
};

// (phi'(alpha), phi''(alpha)) along the search direction
__device__ __forceinline__ Phi dphi(float alpha, const float* jar, const float* jarp,
                                    const float* Dv, const float* ex, float gauss_p,
                                    float pmp, int nefc, int lane) {
  float d = 0.f, dd = 0.f;
  for (int r = lane; r < nefc; r += kWarp) {
    const float ja = jar[r] + alpha * jarp[r];
    const float a = (ja < 0.f) ? ex[r] : 0.f;
    const float djp = Dv[r] * jarp[r];
    d += a * djp * ja;
    dd += a * djp * jarp[r];
  }
  Phi out;
  out.d = gauss_p + alpha * pmp + warp_sum(d);
  out.dd = pmp + warp_sum(dd);
  return out;
}

__global__ void __launch_bounds__(kWarp)
cg_fused_kernel(const float* __restrict__ f, const float* __restrict__ cdof,
                const float* __restrict__ Bm, const float* __restrict__ jsign,
                const float* __restrict__ D, const float* __restrict__ aref,
                const uint8_t* __restrict__ exists, const float* __restrict__ qfrc_smooth,
                const float* __restrict__ qvel, const float* __restrict__ damp,
                const float* __restrict__ md, const float* __restrict__ armature,
                const int* __restrict__ row_slot, const int* __restrict__ sz,
                const int* __restrict__ root_of_dof, const int* __restrict__ limit_dadr,
                float* __restrict__ qacc_out, float* __restrict__ force_out,
                float* __restrict__ qfrc_out, float* __restrict__ a0_out,
                float* __restrict__ qvel_out, uint8_t* __restrict__ done_out,
                int nv, int nefc, int nlim, int nroots, int iters, int ls_iters,
                int has_damping, float tol, float dt) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int ld = lead(nv);

  // layout of the dynamic shared memory, whose size the caller computes
  // (ops/cg.py::kernel_smem_bytes)
  extern __shared__ float sm[];
  float* qM = sm;                 // nv x ld
  float* Mi = qM + nv * ld;       // nv x ld: M^-1, later the damped factor
  float* J = Mi + nv * ld;        // nefc x ld
  float* Dv = J + nefc * ld;      // nefc-vectors
  float* ar = Dv + nefc;
  float* ex = ar + nefc;
  float* jar = ex + nefc;
  float* jarp = jar + nefc;
  float* force = jarp + nefc;
  float* x = force + nefc;        // nv-vectors
  float* a0 = x + nv;
  float* mxa = a0 + nv;
  float* grad = mxa + nv;
  float* mgrad = grad + nv;
  float* gradn = mgrad + nv;
  float* mgradn = gradn + nv;
  float* p = mgradn + nv;
  float* mp = p + nv;
  float* qfs = mp + nv;
  float* tmp = qfs + nv;
  float* rowb = tmp + nv;
  float* colb = rowb + nv;

  const float* fb = f + (size_t)b * 6 * nv;
  const float* cb = cdof + (size_t)b * 6 * nv;
  const float* Bmb = Bm + (size_t)b * nroots * 6 * nefc;

  // ---- qM from (crb_f, cdof): j ancestor-or-self of i <=> i in [j, j+sz_j)
  for (int e = lane; e < nv * nv; e += kWarp) {
    const int i = e / nv, j = e - i * nv;
    float v = 0.f;
    if (i >= j && i < j + sz[j]) {
      float s = 0.f;
      for (int c = 0; c < 6; ++c) s += fb[c * nv + i] * cb[c * nv + j];
      v += s;
    }
    if (j > i && j < i + sz[i]) {
      float s = 0.f;
      for (int c = 0; c < 6; ++c) s += cb[c * nv + i] * fb[c * nv + j];
      v += s;
    }
    if (i == j) v += armature[i];
    qM[i * ld + j] = v;
    Mi[i * ld + j] = v;
  }
  // ---- J: contact rows from Bm = P A and cdof, masked by md; limit rows
  // are one-hot jsign at their dof
  for (int e = lane; e < nefc * nv; e += kWarp) {
    const int r = e / nv, v = e - r * nv;
    const int s = row_slot[r];
    float val = 0.f;
    if (s >= 0) {
      const float* bm = Bmb + root_of_dof[v] * 6 * nefc + r;
      float acc = 0.f;
      for (int c = 0; c < 6; ++c) acc += bm[c * nefc] * cb[c * nv + v];
      val = acc * md[s * nv + v];
    }
    J[r * ld + v] = val;
  }
  for (int r = lane; r < nefc; r += kWarp) {
    Dv[r] = D[(size_t)b * nefc + r];
    ar[r] = aref[(size_t)b * nefc + r];
    ex[r] = exists[(size_t)b * nefc + r] ? 1.f : 0.f;
  }
  for (int v = lane; v < nv; v += kWarp) qfs[v] = qfrc_smooth[(size_t)b * nv + v];
  __syncwarp();
  for (int i = lane; i < nlim; i += kWarp) J[i * ld + limit_dadr[i]] = jsign[(size_t)b * nlim + i];
  __syncwarp();

  // ---- M^-1 (stays in shared memory) and qacc_smooth
  sweep_inverse(Mi, ld, nv, rowb, colb, lane);
  matvec(Mi, ld, qfs, a0, nv, nv, lane);

  // ---- CG from x = a0
  for (int v = lane; v < nv; v += kWarp) {
    x[v] = a0[v];
    mxa[v] = 0.f;
  }
  __syncwarp();
  matvec(J, ld, x, jar, nefc, nv, lane);
  for (int r = lane; r < nefc; r += kWarp) jar[r] -= ar[r];
  __syncwarp();
  // eval_ctx at the start: gauss = 0 since mxa = 0
  float cost = cost_force(jar, Dv, ex, force, nefc, lane);
  matvec_t(J, ld, force, tmp, nefc, nv, lane);
  for (int v = lane; v < nv; v += kWarp) grad[v] = mxa[v] - tmp[v];
  __syncwarp();
  matvec(Mi, ld, grad, mgrad, nv, nv, lane);
  for (int v = lane; v < nv; v += kWarp) p[v] = -mgrad[v];
  __syncwarp();

  bool done = false;
  for (int it = 0; it < iters; ++it) {
    if (done) break;  // frozen: later iterations would not change the iterate
    matvec(J, ld, p, jarp, nefc, nv, lane);
    matvec(qM, ld, p, mp, nv, nv, lane);
    const float pmp = dot(p, mp, nv, lane);
    const float gauss_p = dot(p, mxa, nv, lane);

    const Phi ph0 = dphi(0.f, jar, jarp, Dv, ex, gauss_p, pmp, nefc, lane);
    const float guess = fmaxf(-ph0.d / fmaxf(ph0.dd, kMinval), kMinval);
    // bracket: phi' at guess * 2^k, k = 0..12 (kept in registers: every
    // lane holds the same reduced values)
    float cv[13];
    bool pv[13];
    float pw = 1.f;
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      cv[k] = guess * pw;
      pv[k] = dphi(cv[k], jar, jarp, Dv, ex, gauss_p, pmp, nefc, lane).d >= 0.f;
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
    for (int l = 0; l < ls_iters; ++l) {
      const Phi ph = dphi(alpha, jar, jarp, Dv, ex, gauss_p, pmp, nefc, lane);
      const bool conv = fabsf(ph.d) < tol;
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

    // step, then eval_ctx at the new iterate
    for (int v = lane; v < nv; v += kWarp) {
      x[v] += alpha * p[v];
      mxa[v] += alpha * mp[v];
    }
    for (int r = lane; r < nefc; r += kWarp) jar[r] += alpha * jarp[r];
    __syncwarp();
    float cost_new = cost_force(jar, Dv, ex, force, nefc, lane);
    float g = 0.f;
    for (int v = lane; v < nv; v += kWarp) g += (x[v] - a0[v]) * mxa[v];
    cost_new += 0.5f * warp_sum(g);
    matvec_t(J, ld, force, tmp, nefc, nv, lane);
    for (int v = lane; v < nv; v += kWarp) gradn[v] = mxa[v] - tmp[v];
    __syncwarp();
    matvec(Mi, ld, gradn, mgradn, nv, nv, lane);

    const float improvement = cost - cost_new;
    const float gradnorm = sqrtf(dot(gradn, gradn, nv, lane));
    float num = 0.f, den = 0.f;
    for (int v = lane; v < nv; v += kWarp) {
      num += gradn[v] * (mgradn[v] - mgrad[v]);
      den += grad[v] * mgrad[v];
    }
    const float beta = fmaxf(0.f, warp_sum(num) / fmaxf(warp_sum(den), kMinval));
    for (int v = lane; v < nv; v += kWarp) {
      p[v] = -mgradn[v] + beta * p[v];
      grad[v] = gradn[v];
      mgrad[v] = mgradn[v];
    }
    __syncwarp();
    cost = cost_new;
    done = (improvement < tol) || (gradnorm < tol);
  }

  // ---- outputs: qacc, efc_force, qfrc_constraint = J^T force, qacc_smooth
  matvec_t(J, ld, force, tmp, nefc, nv, lane);
  for (int v = lane; v < nv; v += kWarp) {
    qacc_out[(size_t)b * nv + v] = x[v];
    qfrc_out[(size_t)b * nv + v] = tmp[v];
    a0_out[(size_t)b * nv + v] = a0[v];
  }
  for (int r = lane; r < nefc; r += kWarp) force_out[(size_t)b * nefc + r] = force[r];
  if (lane == 0) done_out[b] = done ? 1 : 0;

  // ---- Euler velocity update
  if (has_damping) {
    // (M + h diag(B)) = U^T U, right-looking; rows of Mi become U
    for (int e = lane; e < nv * nv; e += kWarp) {
      const int i = e / nv, j = e - i * nv;
      Mi[i * ld + j] = qM[i * ld + j] + ((i == j) ? damp[i] : 0.f);
    }
    __syncwarp();
    for (int k = 0; k < nv; ++k) {
      const float c = 1.f / sqrtf(Mi[k * ld + k]);
      __syncwarp();
      for (int j = k + lane; j < nv; j += kWarp) Mi[k * ld + j] *= c;
      __syncwarp();
      for (int e = lane; e < nv * nv; e += kWarp) {
        const int i = e / nv, j = e - i * nv;
        if (i > k && j >= i) Mi[i * ld + j] -= Mi[k * ld + i] * Mi[k * ld + j];
      }
      __syncwarp();
    }
    // rhs = qfrc_smooth + qfrc_constraint; forward U^T y = rhs into rowb
    for (int k = 0; k < nv; ++k) {
      float s = 0.f;
      for (int i = lane; i < k; i += kWarp) s += Mi[i * ld + k] * rowb[i];
      s = warp_sum(s);
      if (lane == 0) rowb[k] = (qfs[k] + tmp[k] - s) / Mi[k * ld + k];
      __syncwarp();
    }
    // backward U z = y into colb
    for (int k = nv - 1; k >= 0; --k) {
      float s = 0.f;
      for (int j = k + 1 + lane; j < nv; j += kWarp) s += Mi[k * ld + j] * colb[j];
      s = warp_sum(s);
      if (lane == 0) colb[k] = (rowb[k] - s) / Mi[k * ld + k];
      __syncwarp();
    }
    for (int v = lane; v < nv; v += kWarp)
      qvel_out[(size_t)b * nv + v] = qvel[(size_t)b * nv + v] + dt * colb[v];
  } else {
    for (int v = lane; v < nv; v += kWarp)
      qvel_out[(size_t)b * nv + v] = qvel[(size_t)b * nv + v] + dt * x[v];
  }
}

}  // namespace

// Launches one warp per env on `stream` with `smem` bytes of dynamic shared
// memory per block; returns the cudaGetLastError() code of the launch (0 on
// success).
extern "C" int cg_fused_launch(
    const float* f, const float* cdof, const float* Bm, const float* jsign,
    const float* D, const float* aref, const uint8_t* exists, const float* qfrc_smooth,
    const float* qvel, const float* damp, const float* md, const float* armature,
    const int* row_slot, const int* sz, const int* root_of_dof, const int* limit_dadr,
    float* qacc, float* force, float* qfrc, float* a0, float* qvel_new, uint8_t* done,
    int B, int nv, int nefc, int nlim, int nroots, int smem, int iters, int ls_iters,
    int has_damping, float tol, float dt, void* stream) {
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cg_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cg_fused_kernel<<<B, kWarp, smem, (cudaStream_t)stream>>>(
      f, cdof, Bm, jsign, D, aref, exists, qfrc_smooth, qvel, damp, md, armature,
      row_slot, sz, root_of_dof, limit_dadr, qacc, force, qfrc, a0, qvel_new, done,
      nv, nefc, nlim, nroots, iters, ls_iters, has_damping, tol, dt);
  return (int)cudaGetLastError();
}
