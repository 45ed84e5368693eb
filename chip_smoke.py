"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It

1. checks for the card and prints its name and power limit;
2. builds every kernel (ops/csrc/*.cu, one library) and prints the seconds;
3. holds each kernel against its plain PyTorch version, both scored
   against a float64 plain run on the card: the solve kernel
   (cg_solve_fused) on the minirat's batched forward at B=2048 and B=2047,
   without and with joint damping and converged, on the elliptic minirat's
   (the elliptic block) likewise, and on a chunk of the Newton dispatch
   (warmstart, stall exit); the dense-input solve kernel (cg_solve_batched)
   on the dense qM and J of the minirat and the elliptic minirat; the SPD
   inverse, the paired inverse, the SPD solve, the Cholesky factor and the
   solve from it on seeded SPD matrices at nv = 7, 73 and 146 (B=2048 and
   B=2047) and on the ballmuscle's own mass matrices;
4. rolls out 2048 tracking envs (GenericSingleClip + EpisodeWrapper +
   AutoResetWrapperTracking, 10 substeps) for 20 control steps, on the
   minirat (the main path) and on the elliptic minirat, counts the kernel
   launches of each run and checks its first step on 8 envs against the
   same step run on the CPU in float64; then holds the elliptic minirat's
   constraint rows and one converged substep at seeded contact states
   against the CPU in float64;
5. steps 2048 ballmuscle envs (ball-joint limits, a fixed tendon, muscles)
   20 substeps under CG (the XLA-CG path: spd_inverse2 once per substep)
   and under Newton (spd_solve 2 + iterations per substep), counts the
   launches of each run and checks its first substep on 8 envs against the
   CPU in float64;
6. steps 2048 Newton minirat envs (Newton/100 on the kernel layout: chunks
   of the solve kernel) 20 substeps, holds the solve kernel's launches to
   the chunks the solver reports, and checks the first substep on 8 envs
   against the CPU in float64;
7. runs the smooth dynamics (dense qM, factor_m, solve_m) on 2048 minirat
   states: one launch each of the factor and the solve kernel;
8. times every kernel, its plain version and a PyTorch library call
   computing the same function with CUDA events (the SPD and Cholesky
   kernels' device time by torch.profiler), and the rollouts and substeps
   on the host clock.

It needs nothing beyond the checkout (the models are the frozen
``assets/*.npz``; weights and states come from seeds), exits non-zero if
any phase fails, and ends with one JSON line for the caller.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B_MAIN = 2048
# the minirat files: pyramidal CG 4/4 (the main path), elliptic CG 4/4,
# Newton/100 on the kernel layout
MODELS = ("minirat", "minirat_elliptic", "minirat_newton")
N_STEPS = 20
N_SUBSTEPS = 10
N_CPU_ENVS = 8

# Solve outputs the kernel is scored on, and its tolerances. A float64 plain
# run on the same inputs is the yardstick. The main path's solve (4 CG
# iterations, 4 line-search steps) is far from converged, and in float32 its
# result moves by ~5% (qacc) to ~25% (efc_force) of an env's scale against
# float64 at the median env, for the JAX package's own array path as much as
# for this port (input perturbations of 1e-7 move the float64 result by
# ~1e-6 only: the float32 error is rounding inside the iteration). So at the
# main path's settings the kernel is held to the float32 plain version's own
# error: max and median per-env relative error each within KERNEL_FACTOR of
# it (plus FLOOR_REL of the scale). A converged solve (CONVERGED_ITERS) on
# the same inputs then holds the kernel to an absolute bound: median per-env
# relative error within CONVERGED_MEDIAN (the float32 plain version's is
# ~2e-4 on qacc and ~2e-3 on the damped qvel_new). The median cannot see a
# kernel that is wrong on a few envs, so the converged run also holds the
# tail: the envs whose relative error is above TAIL_REL may be at most
# TAIL_FACTOR times as many as the float32 plain version's, plus TAIL_ENVS,
# and the kernel's 99th percentile is within TAIL_FACTOR of the plain
# version's (plus FLOOR_REL). Even converged, ~5% of envs are above TAIL_REL
# in float32, and a one-ulp change of the inputs moves which envs they are
# (two such float32 runs: 119 and 109 envs of 2048 above 1e-2 on qacc, 70
# of them in one run only), so the tail is held by its count, not per env.
SCORED = ("qacc", "efc_force", "qvel_new")
KERNEL_FACTOR = 4.0
FLOOR_REL = 1e-6
CONVERGED_ITERS = 64
CONVERGED_MEDIAN = 5e-3
TAIL_REL = 1e-2
TAIL_FACTOR = 1.5
TAIL_ENVS = 8
# The convergence flag tests a cost improvement against a tolerance at the
# edge of float32 rounding, so float32 runs flip it for envs that converge
# at rounding level. The kernel's flags may disagree with the float64 run's
# on at most KERNEL_FACTOR times as many envs as the float32 plain
# version's do, plus DONE_MISMATCH_MAX of the batch.
DONE_MISMATCH_MAX = 0.01
# first control step, card (float32) against CPU (float64): 10 substeps of
# the fall from the clip pose; obs and reward agree to this absolute
# tolerance. A CPU float32 rehearsal of that step (64 envs) is off float64 by
# 8.1e-6 (obs) and 2.9e-6 (reward) for both minirat files; the limit leaves
# ~37x the larger. The first step touches no floor, and the steps that do
# are far from float64 in float32 at 4/4 iterations (ROADMAP section C), so
# the elliptic rows meet float64 in a converged contact-state substep
# (ELL_ROW_RTOL below), and each rollout must have touched the floor
# (contact forces in at least ROLLOUT_MIN_CONTACT of the envs at its last
# step).
STEP_ATOL = {"minirat": 3e-4, "minirat_elliptic": 3e-4}
ROLLOUT_MIN_CONTACT = 0.5

# SPD kernels (spd_inverse, spd_inverse2, spd_solve). Seeded float32 SPD
# matrices Q diag(lam) Q^T with lam log-uniform in [1, SPD_COND] (condition
# number at most 1e3), at the widths of the ballmuscle (7), the rodent (73)
# and rodent_pair (146). Each kernel and the float32 plain version are
# scored by their float64 residuals, ||M X - I||_max for an inverse and
# ||M x - b|| / ||b|| for a solve (a CPU float32 rehearsal of the plain
# versions at B=33: max 1.1e-5 to 1.9e-5, median 1.3e-6 to 1.1e-5 at nv
# 7 and 73). Gate: the kernel's max and median residual within SPD_FACTOR
# of the plain version's own (plus SPD_FLOOR), and its max under SPD_ABS.
# The ballmuscle's own mass matrices (condition number up to 7.5e3 at the
# posed states) get the same factor gate and SPD_ABS_BM (the rehearsal's
# float32 plain residuals there: max 1.2e-6).
SPD_SIZES = (7, 73, 146)
SPD_COND = 1e3
SPD_FACTOR = 4.0
SPD_FLOOR = 1e-7
SPD_ABS = 1e-3
SPD_ABS_BM = 1e-4
SPD_KERNELS = ("spd_inverse", "spd_inverse2", "spd_solve")
CHOL_KERNELS = ("factor_batched", "solve_batched")
# factor_batched changes design at nv = 32 (one warp per matrix below, the
# blocked factor in panels of 16 rows above), its warp path at 8 and 16,
# its shared-memory row padding at multiples of 4 and its blocked path's
# 128 / 256 threads at 144: the Cholesky kernels are also held, by the same
# gates, on seeded SPD matrices at the widths on either side of each edge
CHOL_EDGE_SIZES = (16, 17, 31, 32, 33, 47, 48, 49, 84, 85, 144, 145)
# The dense solve kernel at a rodent-like size (rodent_like_case): nv = 73
# (the rodent's dofs), 296 rows of which 4 are scalar limits, ~140 KB of
# shared memory per env, seeded; its J^T f runs five 16-column chunks where
# the minirat's runs one. Scored like the minirat's cases.
RODENT_LIKE = {"nv": 73, "nefc": 296, "nlim": 4}
# ballmuscle slice: 20 substeps of 2048 envs per solver; its first substep
# of 8 envs on the card (float32) against the CPU (float64). A CPU float32
# rehearsal of that substep (64 envs, both solvers) is off float64 by
# 2.6e-7 (qpos), 2.6e-4 (qvel) and 3.8e-8 (act): qacc (~1e4) moves by
# ~0.35 in float32 through qM's condition number (up to 7.5e3), and one
# substep scales that by dt = 2e-3. BM_STEP_ATOL leaves ~30-40x room for
# the card's other summation order.
BM_SUBSTEPS = 20
BM_STEP_ATOL = {"qpos": 1e-5, "qvel": 1e-2, "act": 1e-6}

# Newton minirat (Newton/100 on the kernel layout, chunks of the solve
# kernel): NEWTON_SUBSTEPS substeps of 2048 envs from seeded contact states;
# its first substep of 8 envs on the card (float32) against the CPU
# (float64). A CPU float32 rehearsal of that substep (64 envs, 9 chunks) is
# off float64 by 6.9e-8 (qpos) and 2.4e-5 (qvel); the limits leave ~30-40x.
NEWTON_SUBSTEPS = 20
NEWTON_STEP_ATOL = {"qpos": 2e-6, "qvel": 1e-3}
# elliptic minirat at contact states (random_states with faster joints),
# card (float32) against the CPU (float64): the rollouts' first control step
# is a fall that touches no floor, so this is where the card's elliptic rows
# meet float64. One substep of B_MAIN envs on the card (one cg_solve_fused
# launch, no other kernel), with the solve converged (CONVERGED_ITERS CG
# iterations, ELL_LS_ITERS line-search steps: at the file's 4/4 a float32
# substep of these states is off float64 by up to 0.8 in qvel, rounding
# inside the iteration), against the same substep of the first ELL_ROW_ENVS
# envs on the CPU: make_constraint's rows (efc_D, efc_aref and efc_pos over
# the active rows, each relative to its largest value there; con_A) within
# ELL_ROW_RTOL, the quadratic rows' and the elliptic contacts' activations
# equal, and qpos and qvel of the first N_CPU_ENVS envs within ELL_STEP_ATOL.
# The float64 solution must leave active elliptic contacts in each zone of
# the cone (bottom, middle, top). A CPU float32 rehearsal (seeds 0-2, 256
# envs): rows at most 1.8e-6 relative (efc_pos), no activation flipped (every
# row lies at least 4.9e-3 from its threshold); the substep of 8 envs off by
# 4.4e-6 (qpos) and 2.2e-3 (qvel); the limits leave ~34x.
ELL_ROW_ENVS = 64
ELL_LS_ITERS = 50
ELL_ROW_RTOL = 6e-5
ELL_STEP_ATOL = {"qpos": 1.5e-4, "qvel": 7.5e-2}
# smooth dynamics: float64 residual ||qM x - f|| / ||f|| of solve_m from the
# factor on 2048 minirat states (a CPU float32 rehearsal: 2.8e-7)
SMOOTH_RESIDUAL = 1e-5

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def load(model, device, dtype=None):
    """One of the port's minirat files: pyramidal CG 4/4 (the main path),
    elliptic CG 4/4, or Newton/100 with 50 line-search steps."""
    from brax_tracking_tpu_torch.physics import spec

    if model == "minirat_newton":
        return spec.load_model(spec.MINIRAT_NEWTON_NPZ, device=device, dtype=dtype,
                               **spec.MINIRAT_NEWTON_OPTIONS)
    npz = spec.MINIRAT_ELLIPTIC_NPZ if model == "minirat_elliptic" else spec.MINIRAT_NPZ
    return spec.load_model(npz, device=device, dtype=dtype)


def random_states(m, B, seed, drop=0.01, vel=0.5):
    """Seeded minirat states with the root pushed into the floor (contacts),
    as the JAX package's fused-kernel tests build them."""
    from brax_tracking_tpu_torch.physics import step as pstep

    rng = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0.cpu().numpy().astype(np.float64)[None], (B, 1))
    qpos[:, 2] -= drop
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, m.nq - 7))
    t = lambda a: torch.as_tensor(a, dtype=m.dtype, device=m.device)
    d = pstep.make_data(m, B, device=m.device)
    return d.replace(
        qpos=t(qpos),
        qvel=t(rng.uniform(-vel, vel, (B, m.nv))),
        ctrl=t(rng.uniform(-0.3, 0.3, (B, m.nu))),
    )


def solve_case(device, model, B, seed, damped=False, iters=None):
    """The solve kernel's arguments as the solver passes them, at seeded
    float32 states of ``model``: the one cg_solve_fused call of a CG file
    (with an optional seeded damping, or ``iters`` CG iterations), or for
    ``minirat_newton`` one chunk of the Newton dispatch (K = 4, 16
    line-search steps, the stall exit) warmstarted from the qacc of a
    substep run just before on the card (its launches are set back).
    Elliptic states get faster joints (contacts in all three cone zones)."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load(model, device, torch.float32)
    d = random_states(m, B, seed, vel=1.0 if model == "minirat_elliptic" else 0.5)
    if model == "minirat_newton":
        launches = ops_cg.cg_solve_fused.launches
        d = pstep.step(m, d, device=device)
        ops_cg.cg_solve_fused.launches = launches
    d = pstep.forward_to_constraint(m, d)
    args, kw = S._kernel_args(m, d, Cn.efc_layout(m))
    args, kw = list(args), dict(kw)
    if model == "minirat_newton":
        kw.update(iters=4, ls_iters=min(kw["ls_iters"], 16), has_damping=False,
                  stall_tol=S.STALL_TOL_F32, warmstart=d.qacc_warmstart.contiguous())
    if damped:
        rng = np.random.RandomState(seed + 100)
        args[10] = torch.as_tensor(float(m.opt.timestep) * rng.uniform(0.005, 0.02, m.nv),
                                   dtype=m.dtype, device=m.device)
        kw["has_damping"] = True
    if iters is not None:
        kw["iters"] = iters
    return m, [a.contiguous() for a in args], kw


def dense_case(args, kw):
    """cg_solve_batched's arguments from cg_solve_fused's: qM and J
    assembled densely by the plain version."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    f, cdof, A, jsign, D, aref, exists, econ, qfs, qvel, damp, P, md, arm = args
    Bm = ops_cg._bm(P, A, len(kw["root_bounds"]), md.shape[0])
    qM, J = ops_cg.assemble_qM_J(f, cdof, Bm, jsign, md, arm, row_slot=kw["row_slot"],
                                 sz=kw["sz"], root_bounds=kw["root_bounds"],
                                 limit_dadr=kw["limit_dadr"])
    keep = ("iters", "ls_iters", "tol", "dt", "has_damping", "ell0", "ell_mu", "ell_scale",
            "warmstart", "stall_tol")
    return ([t.contiguous() for t in (qM, J, D, aref, exists, econ, qfs, qvel, damp)],
            {k: v for k, v in kw.items() if k in keep})


def rodent_like_case(device, B, seed, iters=None):
    """cg_solve_batched's arguments (float32) and keywords for a seeded
    dense problem at a rodent-like size (RODENT_LIKE): qM = Q diag(lam) Q^T
    with lam log-uniform in [1, SPD_COND]; the first nlim rows of J one-hot
    +-1 at distinct dofs (scalar limits), the others with half their dofs in
    the support, N(0, 2 / nv) there; D in [0.5, 2]; aref = J qacc_smooth
    plus noise of the same spread, so that about half of the rows start
    active; 5% of the rows absent. CG 4/4 as the minirat (or ``iters``),
    tolerance 1e-8 x mean diag(qM) x nv (MuJoCo's scaling), undamped."""
    nv, nefc, nlim = RODENT_LIKE["nv"], RODENT_LIKE["nefc"], RODENT_LIKE["nlim"]
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(generator=g, device=device, dtype=torch.float64)
    Q, _ = torch.linalg.qr(torch.randn(B, nv, nv, **f64))
    lam = SPD_COND ** torch.rand(B, nv, **f64)
    qM = (Q * lam[:, None, :]) @ Q.transpose(-1, -2)
    qM = 0.5 * (qM + qM.transpose(-1, -2))
    a0 = torch.randn(B, nv, **f64)
    J = torch.randn(B, nefc, nv, **f64) * (torch.rand(B, nefc, nv, **f64) < 0.5) * (2.0 / nv) ** 0.5
    dadr = torch.randperm(nv, generator=g, device=device)[:nlim]
    J[:, :nlim] = 0.0
    J[:, torch.arange(nlim, device=device), dadr] = 1.0 - 2.0 * (torch.rand(B, nlim, **f64) < 0.5).double()
    jar0 = (J @ a0[..., None])[..., 0]
    aref = jar0 + jar0.std(-1, keepdim=True) * torch.randn(B, nefc, **f64)
    D = 0.5 + 1.5 * torch.rand(B, nefc, **f64)
    exists = torch.rand(B, nefc, **f64) > 0.05
    qfs = (qM @ a0[..., None])[..., 0]
    qvel = torch.randn(B, nv, **f64)
    tol = 1e-8 * float(qM.diagonal(dim1=-2, dim2=-1).mean()) * nv
    f32 = lambda t: t.float().contiguous()
    args = [f32(qM), f32(J), f32(D), f32(aref), exists.contiguous(),
            torch.zeros(B, 0, dtype=torch.bool, device=device), f32(qfs), f32(qvel),
            torch.zeros(nv, device=device)]
    kw = {"iters": 4 if iters is None else iters, "ls_iters": 4, "tol": tol, "dt": 0.002,
          "has_damping": False, "ell0": 0, "ell_mu": (), "ell_scale": (), "stall_tol": 0.0}
    return args, kw


def cast(args, dtype):
    return [a.to(dtype) if a.is_floating_point() else a for a in args]


def cast_kw(kw, dtype):
    return {k: (v.to(dtype) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}


def outputs(out):
    return dict(zip(("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new", "done"), out))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _errors(out, ref):
    """Max abs error, and the median, 99th percentile and count above
    TAIL_REL of the per-env relative error (max abs error of the env over
    the env's max abs value)."""
    e = (out.double() - ref).abs().reshape(ref.shape[0], -1)
    scale = ref.abs().reshape(ref.shape[0], -1).amax(-1).clamp(min=1e-30)
    rel = e.amax(-1) / scale
    return {"max": float(e.max()), "median_rel": float(rel.median()),
            "p99_rel": float(torch.quantile(rel, 0.99)),
            "n_above_tail": int((rel > TAIL_REL).sum())}


def phase_kernel_vs_plain(device, B, damped, seed, iters=None, model="minirat",
                          batched=False):
    """Kernel and float32 plain version against a float64 plain run on the
    same inputs (the solve at state ``seed`` of ``model``, see solve_case;
    ``iters`` overrides the CG iteration count; ``batched`` runs
    cg_solve_batched on the dense qM and J of the same call; ``model`` =
    "rodent_like" runs cg_solve_batched on rodent_like_case). Returns the
    error report and (model, args, kw, kernel outputs)."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    kernel, plain_fn = ops_cg.cg_solve_fused, ops_cg.cg_solve_fused_reference
    if model == "rodent_like":
        m, (args, kw) = None, rodent_like_case(device, B, seed, iters)
    else:
        m, args, kw = solve_case(device, model, B, seed, damped, iters)
        if batched:
            args, kw = dense_case(args, kw)
    if batched or m is None:
        kernel, plain_fn = ops_cg.cg_solve_batched, ops_cg.cg_solve_batched_reference
    ref = outputs(plain_fn(*cast(args, torch.float64), **cast_kw(kw, torch.float64)))
    plain = outputs(plain_fn(*args, **kw))
    launches = kernel.launches
    kern = outputs(kernel(*args, device=device, **kw))
    kernel.launches = launches  # comparison launches do not count
    if device == "cuda":
        torch.cuda.synchronize()

    case = (f"{kernel.__name__}, {model}, B={B}, damped={damped}, iters={kw['iters']}, "
            f"warmstart={'warmstart' in kw}")
    report = {"kernel": kernel.__name__, "model": model, "B": B, "damped": damped,
              "iters": kw["iters"], "warmstart": "warmstart" in kw}
    for name in ("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new"):
        ek, ep = _errors(kern[name], ref[name]), _errors(plain[name], ref[name])
        report[name] = {"scale": float(ref[name].abs().max()),
                        **{f"kernel_{k}": v for k, v in ek.items()},
                        **{f"plain_{k}": v for k, v in ep.items()},
                        "finite": bool(torch.isfinite(kern[name]).all())}
    report["done_frac"] = {k: float(o["done"].float().mean()) for k, o in
                           (("kernel", kern), ("plain32", plain), ("plain64", ref))}
    report["done_mismatch"] = {
        "kernel_vs_plain32": int((kern["done"] != plain["done"]).sum()),
        "kernel_vs_plain64": int((kern["done"] != ref["done"]).sum()),
        "plain32_vs_plain64": int((plain["done"] != ref["done"]).sum()),
    }
    print("kernel_vs_plain " + json.dumps(report))

    for name in ("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new"):
        r = report[name]
        if not r["finite"]:
            fail(f"kernel {name} not finite ({case})")
        if name not in SCORED:
            continue
        ek, ep, mk, mp, scale = (r[k] for k in ("kernel_max", "plain_max",
                                                "kernel_median_rel", "plain_median_rel", "scale"))
        if ek > KERNEL_FACTOR * ep + FLOOR_REL * scale:
            fail(f"kernel {name} max error {ek:.3e} > {KERNEL_FACTOR} x plain "
                 f"{ep:.3e} + {FLOOR_REL} x {scale:.3e} ({case})")
        if mk > KERNEL_FACTOR * mp + FLOOR_REL:
            fail(f"kernel {name} median relative error {mk:.3e} > {KERNEL_FACTOR} x "
                 f"plain {mp:.3e} ({case})")
        if iters is None:
            continue
        if mk > CONVERGED_MEDIAN:
            fail(f"converged kernel {name} median relative error {mk:.3e} > "
                 f"{CONVERGED_MEDIAN} ({case})")
        n_kern, n_plain = r["kernel_n_above_tail"], r["plain_n_above_tail"]
        if n_kern > TAIL_FACTOR * n_plain + TAIL_ENVS:
            fail(f"converged kernel {name}: {n_kern} envs above {TAIL_REL} relative "
                 f"error, > {TAIL_FACTOR} x plain {n_plain} + {TAIL_ENVS} ({case})")
        if r["kernel_p99_rel"] > TAIL_FACTOR * r["plain_p99_rel"] + FLOOR_REL:
            fail(f"converged kernel {name} 99th percentile relative error "
                 f"{r['kernel_p99_rel']:.3e} > {TAIL_FACTOR} x plain "
                 f"{r['plain_p99_rel']:.3e} ({case})")
    dm = report["done_mismatch"]
    if dm["kernel_vs_plain64"] > KERNEL_FACTOR * dm["plain32_vs_plain64"] + DONE_MISMATCH_MAX * B:
        fail(f"done flags: {dm} ({case})")
    return report, (m, args, kw, kern)


def synth_clip_qpos(qpos0, T=128, walk=0.1):
    """bench.py's synthetic clip: qpos0, lifted 1 cm, walking along x."""
    qpos = np.tile(np.asarray(qpos0, np.float64), (T, 1))
    qpos[:, 2] += 0.01
    qpos[:, 0] += np.linspace(0.0, walk, T)
    return qpos


def make_env(device, dtype=None, model="minirat"):
    """The tracking env of a CG minirat file (``minirat`` or
    ``minirat_elliptic``) under the training wrappers."""
    from brax_tracking_tpu_torch.data import clips
    from brax_tracking_tpu_torch.envs import tracking, wrappers

    m = load(model, device, dtype)
    clip = clips.process_clip(m, torch.as_tensor(synth_clip_qpos(m.qpos0.cpu().numpy())))
    env = tracking.GenericSingleClip(
        reference_clip=clip,
        mjcf_path=f"builtin:{model}.xml",
        device=device,
        dtype=dtype,
        physics_steps_per_control_step=N_SUBSTEPS,
        center_of_mass="torso",
        end_eff_names=["leg_FL", "leg_FR", "leg_BL", "leg_BR"],
        body_names=["torso", "leg_FL", "leg_FR", "leg_BL", "leg_BR"],
        joint_names=["hip_FL", "hip_FR", "hip_BL", "hip_BR"],
        healthy_z_range=(0.02, 0.5),
        pos_reward_weight=1.0,
        strict_name_lookup=True,
    )
    return wrappers.wrap(env, episode_length=1000)


def phase_rollout(device, B, seed, model="minirat"):
    """Reset + N_STEPS control steps of B envs; returns the launch counts of
    the steps (every kernel, set to 0 just before), the first step's inputs
    and outputs, the final state and the share of envs with contact forces
    at the last step (which must reach ROLLOUT_MIN_CONTACT)."""
    from brax_tracking_tpu_torch.physics import constraint as Cn

    env = make_env(device, model=model)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = env.reset(gen, B)
    actions = [
        2.0 * torch.rand(B, env.action_size, generator=gen, device=device) - 1.0
        for _ in range(N_STEPS)
    ]
    first_in = state
    reset_counts()
    states = []
    for a in actions:
        state = env.step(state, a)
        states.append(state)
    launches = read_counts()
    for s in states:
        if not (torch.isfinite(s.obs).all() and torch.isfinite(s.reward).all()):
            fail(f"{model} rollout obs or reward not finite")
    contact_rows = torch.as_tensor(Cn.efc_layout(env.unwrapped.model).row_con >= 0,
                                   device=state.obs.device)
    touching = float((state.pipeline_state.efc_force[:, contact_rows] != 0).any(-1).float().mean())
    if touching < ROLLOUT_MIN_CONTACT:
        fail(f"{model} rollout: contact forces in {touching:.3f} of the envs at the last "
             f"step, expected >= {ROLLOUT_MIN_CONTACT}")
    return env, launches, first_in, actions[0], states[0], state, touching


def phase_first_step_on_cpu(first_in, action, first_out, n, model="minirat"):
    """The first control step of ``n`` envs run again by the port on the CPU
    in float64; returns the max obs and reward gaps."""
    env = make_env("cpu", model=model)
    d = first_in.pipeline_state
    cpu = lambda t: t[:n].detach().to("cpu", torch.float64)
    s = env.init_state(first_in.info["cur_frame"][:n].cpu(), cpu(d.qpos), cpu(d.qvel))
    s = env.step(s, cpu(action))
    gaps = {
        "obs": float((s.obs - cpu(first_out.obs)).abs().max()),
        "reward": float((s.reward - cpu(first_out.reward)).abs().max()),
        "done_mismatch": int((s.done != cpu(first_out.done)).sum()),
    }
    atol = STEP_ATOL[model]
    if gaps["obs"] > atol or gaps["reward"] > atol or gaps["done_mismatch"]:
        fail(f"{model}: first control step on the card differs from the CPU float64 "
             f"run: {gaps} (limit {atol})")
    return gaps


def converged(m):
    """The model with its solve run to convergence: CONVERGED_ITERS CG
    iterations, ELL_LS_ITERS line-search steps (a fresh cache: the solve
    statics hold the counts)."""
    import dataclasses

    opt = dataclasses.replace(m.opt, iterations=CONVERGED_ITERS, ls_iterations=ELL_LS_ITERS)
    return dataclasses.replace(m, opt=opt, cache={})


def ell_zones(m, d):
    """(bottom, middle, top) counts of the active elliptic contacts at the
    solution d.qacc of the substep whose forward fields ``d`` holds."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S

    args, kw = S._kernel_args(m, d, Cn.efc_layout(m))
    f, cdof, A, jsign, D, aref, exists, econ, qfs, qvel, damp, P, md, arm = args
    Bm = ops_cg._bm(P, A, len(kw["root_bounds"]), md.shape[0])
    _, J = ops_cg.assemble_qM_J(f, cdof, Bm, jsign, md, arm, row_slot=kw["row_slot"],
                                sz=kw["sz"], root_bounds=kw["root_bounds"],
                                limit_dadr=kw["limit_dadr"])
    jar = (J @ d.qacc[..., None])[..., 0] - aref
    nell, ell0 = len(kw["ell_mu"]), kw["ell0"]
    je = jar[:, ell0 : ell0 + 3 * nell].reshape(-1, nell, 3)
    mu = torch.as_tensor(kw["ell_mu"], dtype=jar.dtype)
    sc = torch.as_tensor(kw["ell_scale"], dtype=jar.dtype)
    n, t = je[..., 0], (je[..., 1:] * sc).norm(dim=-1)
    bottom = econ & (mu * n + t <= 0)
    middle = econ & ~bottom & (n < mu * t)
    return int(bottom.sum()), int(middle.sum()), int((econ & ~bottom & ~middle).sum())


def phase_elliptic_contacts(device, B, seed):
    """One converged substep of B elliptic-minirat envs at seeded contact
    states on ``device`` (float32) against the first ELL_ROW_ENVS of them on
    the CPU in float64 (see ELL_ROW_RTOL); on the card it must launch
    cg_solve_fused once and nothing else. Returns the gaps, the zone counts
    and the launch counts."""
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S
    from brax_tracking_tpu_torch.physics import step as pstep

    m = converged(load("minirat_elliptic", device, torch.float32))
    d = random_states(m, B, seed, vel=1.0)
    reset_counts()
    out = pstep.step(m, d, device=device)
    counts = read_counts()
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": 1}
    if device == "cuda" and counts != expected:
        fail(f"minirat_elliptic contact substep launches {counts}, expected {expected}")
    if not all(bool(torch.isfinite(getattr(out, k)).all()) for k in ("qpos", "qvel")):
        fail("minirat_elliptic contact substep: state not finite")

    m64 = converged(load("minirat_elliptic", "cpu"))
    n = ELL_ROW_ENVS
    cpu = lambda t: t[:n].detach().to("cpu", torch.float64 if t.is_floating_point() else t.dtype)
    d64 = pstep.make_data(m64, n, device="cpu").replace(
        **{k: cpu(getattr(d, k)) for k in ("qpos", "qvel", "ctrl")})
    ref = pstep.step(m64, d64, device="cpu")
    active = ref.efc_pos < ref.efc_margin
    gaps = {}
    for k in ("efc_D", "efc_aref", "efc_pos"):
        r = getattr(ref, k)[active]
        gaps[k] = float((cpu(getattr(out, k))[active] - r).abs().max() / r.abs().max())
    gaps["con_A"] = float((cpu(out.con_A) - ref.con_A).abs().max() / ref.con_A.abs().max())
    layout = Cn.efc_layout(m64)
    a32, _ = S._kernel_args(m, out, Cn.efc_layout(m))
    a64, _ = S._kernel_args(m64, ref, layout)
    gaps["exists_mismatch"] = int((cpu(a32[6]) != a64[6]).sum())
    gaps["exists_con_mismatch"] = int((cpu(a32[7]) != a64[7]).sum())
    for k in ELL_STEP_ATOL:
        gaps[k] = float((cpu(getattr(out, k))[:N_CPU_ENVS] - getattr(ref, k)[:N_CPU_ENVS])
                        .abs().max())
    zones = ell_zones(m64, ref)
    bad = [k for k in ("efc_D", "efc_aref", "efc_pos", "con_A") if gaps[k] > ELL_ROW_RTOL]
    bad += [k for k in ("exists_mismatch", "exists_con_mismatch") if gaps[k]]
    bad += [k for k in ELL_STEP_ATOL if gaps[k] > ELL_STEP_ATOL[k]]
    if bad:
        fail(f"minirat_elliptic contact substep on {device} differs from the CPU float64 run "
             f"in {bad}: {gaps} (limits {ELL_ROW_RTOL}, {ELL_STEP_ATOL})")
    if min(zones) == 0:
        fail(f"minirat_elliptic contact states: active elliptic contacts per zone (bottom, "
             f"middle, top) {zones}: every zone must be reached")
    return gaps, zones, counts


# ---------------------------------------------------------------------------
# SPD kernels and the ballmuscle slice
# ---------------------------------------------------------------------------


def counted():
    """Every kernel wrapper that counts its launches, by name."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    return {"cg_solve_fused": ops_cg.cg_solve_fused, "cg_solve_batched": ops_cg.cg_solve_batched,
            "spd_inverse": ops_chol.spd_inverse, "spd_inverse2": ops_chol.spd_inverse2,
            "spd_solve": ops_chol.spd_solve, "factor_batched": ops_chol.factor_batched,
            "solve_batched": ops_chol.solve_batched}


def reset_counts():
    for fn in counted().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counted().items()}


def spd_inputs(device, nv, B, seed):
    """Seeded float32 SPD matrices (condition number <= SPD_COND), a
    right-hand side and a damping vector."""
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(generator=g, device=device, dtype=torch.float64)
    Q, _ = torch.linalg.qr(torch.randn(B, nv, nv, **f64))
    lam = SPD_COND ** torch.rand(B, nv, **f64)
    M = (Q * lam[:, None, :]) @ Q.transpose(-1, -2)
    M = 0.5 * (M + M.transpose(-1, -2))
    b = torch.randn(B, nv, **f64)
    damp = 0.01 + 0.1 * torch.rand(nv, **f64)
    return M.float().contiguous(), b.float().contiguous(), damp.float().contiguous()


def chol_inputs(name, M, b, damp):
    """The inputs of ``name`` on the SPD matrices M: for solve_batched the
    first is the upper factor of M (float64 factor, stored in float32)."""
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    if name == "solve_batched":
        M = ops_chol.cholesky_factor_reference(M.double()).float().contiguous()
    return M, b, damp


def spd_run(name, M, b, damp, fn_kind):
    """One of the SPD functions on (M, b, damp) (M is the factor U for
    solve_batched): fn_kind "kernel" (the wrapper on M's device), "plain"
    or "plain64"; returns a tuple of outputs."""
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    if fn_kind == "plain64":
        M, b, damp = M.double(), b.double(), damp.double()
    if name in ("spd_solve", "solve_batched"):
        args = (M, b)
    elif name == "spd_inverse2":
        args = (M, damp)
    else:
        args = (M,)
    if fn_kind == "kernel":
        out = getattr(ops_chol, name)(*args, device=M.device)
    elif name == "spd_solve":
        out = ops_chol.spd_solve_reference(*args)
    elif name == "solve_batched":
        out = ops_chol.cholesky_solve_reference(*args)
    elif name == "factor_batched":
        out = ops_chol.cholesky_factor_reference(M)
    elif name == "spd_inverse2":
        out = (ops_chol.sweep_inverse_reference(M),
               ops_chol.sweep_inverse_reference(M + torch.diag(damp)))
    else:
        out = ops_chol.sweep_inverse_reference(M)
    return out if isinstance(out, tuple) else (out,)


def spd_residual(name, M, b, damp, outs):
    """Per-matrix float64 residual: ||M X - I||_max (for spd_inverse2 the
    larger of its two inverses'), ||M x - b|| / ||b|| (for solve_batched M
    = U^T U of its input factor U), ||U^T U - M||_max / ||M||_max for the
    factor."""
    Md, outs = M.double(), [o.double() for o in outs]
    if name == "factor_batched":
        U = outs[0]
        return (U.transpose(-1, -2) @ U - Md).abs().amax((-1, -2)) / Md.abs().amax((-1, -2))
    if name in ("spd_solve", "solve_batched"):
        if name == "solve_batched":
            Md = Md.transpose(-1, -2) @ Md
        bd = b.double()
        return ((Md @ outs[0][..., None])[..., 0] - bd).norm(dim=-1) / bd.norm(dim=-1)
    eye = torch.eye(M.shape[-1], dtype=torch.float64, device=M.device)
    mats = [Md, Md + torch.diag(damp.double())][: len(outs)]
    return torch.stack([(A @ X - eye).abs().amax((-1, -2)) for A, X in zip(mats, outs)]).amax(0)


def phase_spd_vs_plain(name, M, b, damp, case, abs_bound):
    """A SPD kernel and its float32 plain version against a float64 plain
    run on the same inputs; fails unless the kernel's residuals are within
    SPD_FACTOR of the plain version's and under ``abs_bound``. Launches
    made here do not count. Returns the report."""
    fn = counted()[name]
    launches = fn.launches
    kern = spd_run(name, M, b, damp, "kernel")
    fn.launches = launches
    plain = spd_run(name, M, b, damp, "plain")
    ref = spd_run(name, M, b, damp, "plain64")
    if M.is_cuda:
        torch.cuda.synchronize()
    rk, rp, rr = (spd_residual(name, M, b, damp, o) for o in (kern, plain, ref))
    report = {
        "kernel": name, "case": case, "B": M.shape[0], "nv": M.shape[-1],
        "kernel_max": float(rk.max()), "kernel_median": float(rk.median()),
        "plain_max": float(rp.max()), "plain_median": float(rp.median()),
        "plain64_max": float(rr.max()),
        "max_abs_err": max(float((k.double() - r).abs().max()) for k, r in zip(kern, ref)),
        "finite": all(bool(torch.isfinite(k).all()) for k in kern),
    }
    print("spd_vs_plain " + json.dumps(report))
    where = f"{name}, {case}, B={report['B']}, nv={report['nv']}"
    if not report["finite"]:
        fail(f"{where}: kernel output not finite")
    for stat in ("max", "median"):
        k, pl = report["kernel_" + stat], report["plain_" + stat]
        if k > SPD_FACTOR * pl + SPD_FLOOR:
            fail(f"{where}: kernel {stat} residual {k:.3e} > {SPD_FACTOR} x plain {pl:.3e}")
    if report["kernel_max"] > abs_bound:
        fail(f"{where}: kernel max residual {report['kernel_max']:.3e} > {abs_bound}")
    return report


def bm_model(device, solver, dtype=None):
    from brax_tracking_tpu_torch.physics import spec

    return spec.load_model(spec.BALLMUSCLE_NPZ[solver], device=device, dtype=dtype, solver=solver)


def _axis_quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def bm_posed(m, B, seed0=0):
    """The posed ballmuscle states of tests/test_physics_ball_muscle.py
    (shoulder rotated 0.58 rad, near its 0.6 rad ball limit; wrist 0.15
    rad), env i from RandomState(seed0 + i), built without mujoco."""
    from brax_tracking_tpu_torch.physics import step as pstep

    cols = {k: [] for k in ("qpos", "qvel", "ctrl", "act")}
    for i in range(B):
        rng = np.random.RandomState(seed0 + i)
        qpos = np.zeros(m.nq)
        qpos[0:4] = _axis_quat(rng.uniform(-1, 1, 3), 0.58)
        qpos[4] = rng.uniform(-1.3, 1.3)
        qpos[5:9] = _axis_quat(rng.uniform(-1, 1, 3), 0.15)
        cols["qpos"].append(qpos)
        cols["qvel"].append(rng.uniform(-0.5, 0.5, m.nv))
        cols["ctrl"].append(rng.uniform(-0.5, 1.0, m.nu))
        cols["act"].append(rng.uniform(0.1, 0.9, m.na))
    t = lambda a: torch.as_tensor(np.stack(a), dtype=m.dtype, device=m.device)
    return pstep.make_data(m, B, device=m.device).replace(**{k: t(v) for k, v in cols.items()})


def bm_ctrls(m, B, n, seed):
    """n seeded ctrl draws, uniform in [-0.5, 1] (the posed recipe's range)."""
    g = torch.Generator(device=m.device).manual_seed(seed)
    return [-0.5 + 1.5 * torch.rand(B, m.nu, generator=g, device=m.device, dtype=m.dtype)
            for _ in range(n)]


def phase_ballmuscle(device, solver, B, seed):
    """BM_SUBSTEPS substeps of B posed ballmuscle envs; the counts are set to
    0 just before and read just after. Fails on a non-finite state or a
    launch count other than the path's: CG one spd_inverse2 per substep,
    Newton 2 + (Newton iterations the batch ran) spd_solve per substep.
    Returns (counts, expected, per-substep Newton iterations, the first
    substep's input and output)."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = bm_model(device, solver)
    d = d0 = bm_posed(m, B)
    ctrls = bm_ctrls(m, B, BM_SUBSTEPS, seed)
    reset_counts()
    iters, outs = [], []
    for c in ctrls:
        d = pstep.step(m, d.replace(ctrl=c), device=device)
        iters.append(int(d.solver_niter.max()) if solver == "newton" else 0)
        outs.append(d)
    counts = read_counts()
    for k, o in enumerate(outs):
        for f in ("qpos", "qvel", "act"):
            if not bool(torch.isfinite(getattr(o, f)).all()):
                fail(f"ballmuscle {solver}: {f} not finite at substep {k}")
    expected = dict.fromkeys(counts, 0)
    if solver == "cg":
        expected["spd_inverse2"] = BM_SUBSTEPS
    else:
        expected["spd_solve"] = sum(2 + k for k in iters)
    if device == "cuda" and counts != expected:
        fail(f"ballmuscle {solver} launches {counts}, expected {expected}")
    return counts, expected, iters, d0.replace(ctrl=ctrls[0]), outs[0]


def phase_bm_first_substep_on_cpu(solver, first_in, first_out, n):
    """The first substep of ``n`` envs run again by the port on the CPU in
    float64; returns the max gaps of qpos, qvel and act."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = bm_model("cpu", solver)
    cpu = lambda t: t[:n].detach().to("cpu", torch.float64)
    d = pstep.make_data(m, n, device="cpu").replace(
        **{k: cpu(getattr(first_in, k)) for k in ("qpos", "qvel", "act", "ctrl")}
    )
    d = pstep.step(m, d, device="cpu")
    gaps = {k: float((getattr(d, k) - cpu(getattr(first_out, k))).abs().max()) for k in BM_STEP_ATOL}
    if any(gaps[k] > BM_STEP_ATOL[k] for k in gaps):
        fail(f"ballmuscle {solver}: first substep on the card differs from the CPU "
             f"float64 run: {gaps} (limits {BM_STEP_ATOL})")
    return gaps


# ---------------------------------------------------------------------------
# Newton on the kernel layout and the smooth dynamics
# ---------------------------------------------------------------------------


def newton_ctrls(m, B, n, seed):
    """n seeded ctrl draws, uniform in [-0.3, 0.3] (random_states' range)."""
    g = torch.Generator(device=m.device).manual_seed(seed)
    return [-0.3 + 0.6 * torch.rand(B, m.nu, generator=g, device=m.device, dtype=m.dtype)
            for _ in range(n)]


def phase_newton(device, B, seed, n=NEWTON_SUBSTEPS):
    """``n`` substeps of B Newton minirat envs (Newton/100 on the kernel
    layout: chunks of the solve kernel); the counts are set to 0 just before
    and read just after. Fails on a non-finite state, or unless the
    cg_solve_fused launches equal the chunks the solver reports and no other
    kernel ran. Returns (counts, chunks per substep, the first substep's
    input and output)."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("minirat_newton", device)
    d = d0 = random_states(m, B, seed)
    ctrls = newton_ctrls(m, B, n, seed)
    reset_counts()
    chunks, outs = [], []
    for c in ctrls:
        d = pstep.step(m, d.replace(ctrl=c), device=device)
        chunks.append(d.solver_nchunk)
        outs.append(d)
    counts = read_counts()
    for k, o in enumerate(outs):
        for f in ("qpos", "qvel"):
            if not bool(torch.isfinite(getattr(o, f)).all()):
                fail(f"minirat_newton: {f} not finite at substep {k}")
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": sum(chunks)}
    if device == "cuda" and counts != expected:
        fail(f"minirat_newton launches {counts}, expected {expected} (chunks {chunks})")
    return counts, chunks, d0.replace(ctrl=ctrls[0]), outs[0]


def phase_newton_first_substep_on_cpu(first_in, first_out, n):
    """The first Newton substep of ``n`` envs run again by the port on the
    CPU in float64; returns the max gaps of qpos and qvel."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("minirat_newton", "cpu")
    cpu = lambda t: t[:n].detach().to("cpu", torch.float64)
    d = pstep.make_data(m, n, device="cpu").replace(
        **{k: cpu(getattr(first_in, k)) for k in ("qpos", "qvel", "ctrl")}
    )
    d = pstep.step(m, d, device="cpu")
    gaps = {k: float((getattr(d, k) - cpu(getattr(first_out, k))).abs().max())
            for k in NEWTON_STEP_ATOL}
    if any(gaps[k] > NEWTON_STEP_ATOL[k] for k in gaps):
        fail(f"minirat_newton: first substep on the card differs from the CPU float64 "
             f"run: {gaps} (limits {NEWTON_STEP_ATOL})")
    return gaps


def phase_smooth(device, B, seed):
    """The smooth-dynamics entry points on B minirat states: crb with the
    dense qM, factor_m (factor_batched) and solve_m of qfrc_smooth from the
    factor (solve_batched); the counts are set to 0 just before the three
    calls and read just after. Fails unless each kernel launched exactly
    once and no other, or if the solve's float64 residual ||qM x - f|| /
    ||f|| exceeds SMOOTH_RESIDUAL. Returns (counts, residual, qM, qLD, rhs)."""
    from brax_tracking_tpu_torch.physics import dynamics as D
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("minirat", device)
    d = pstep.forward_to_constraint(m, random_states(m, B, seed))
    reset_counts()
    d = D.crb(m, d, dense=True)
    d = D.factor_m(m, d)
    x = D.solve_m(m, d, d.qfrc_smooth)
    counts = read_counts()
    expected = dict.fromkeys(counts, 0) | {"factor_batched": 1, "solve_batched": 1}
    if device == "cuda" and counts != expected:
        fail(f"smooth dynamics launches {counts}, expected {expected}")
    f = d.qfrc_smooth.double()
    res = float(((d.qM.double() @ x.double()[..., None])[..., 0] - f).norm(dim=-1).div(
        f.norm(dim=-1)).max())
    if not bool(torch.isfinite(x).all()) or res > SMOOTH_RESIDUAL:
        fail(f"smooth dynamics: solve_m residual {res:.3e} > {SMOOTH_RESIDUAL}")
    return counts, res, d.qM.contiguous(), d.qLD.contiguous(), d.qfrc_smooth.contiguous()


def spd_bound(name, B, nv):
    """Least time (ms) of one call on an H100 and what bounds it:
    max(bytes / HBM rate, FP32 operations / FP32 rate). Bytes: each input
    read once, each output written once. Operations, per matrix: nv^3 +
    2 nv^2 + nv per inverse (the symmetric sweep: per pivot a reciprocal,
    the pivot row scaled, one multiply-add on each entry of a triangle;
    Cholesky inversion, potrf + potri, also costs nv^3); the Cholesky
    nv^3 / 3 + nv^2 / 2 + nv (factor_batched), the two substitutions 2 nv^2
    (solve_batched), both for spd_solve."""
    mat = 4 * B * nv * nv
    if name == "spd_solve":
        nbytes = mat + 2 * 4 * B * nv
        flops = B * (nv**3 / 3 + 2.5 * nv * nv + nv)
    elif name == "factor_batched":
        nbytes = 2 * mat
        flops = B * (nv**3 / 3 + 0.5 * nv * nv + nv)
    elif name == "solve_batched":
        nbytes = mat + 2 * 4 * B * nv
        flops = B * 2 * nv * nv
    else:
        ninv = 2 if name == "spd_inverse2" else 1
        nbytes = mat * (1 + ninv) + (4 * nv if ninv == 2 else 0)
        flops = ninv * B * (nv**3 + 2 * nv * nv + nv)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def device_ms(fn, tag, reps=20):
    """Mean device time (ms) per call of ``fn`` of the CUDA kernels whose
    name holds ``tag``, from torch.profiler: at the ballmuscle's nv = 7 a
    launch takes less device time than the host needs to issue it, so CUDA
    events around a loop of launches time the host. The profiler may drop
    an event now and then (seen once in 20 launches), so a profile that
    does not see exactly ``reps`` launches is taken once more; a second
    miss fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ts = [e.device_time_total for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and tag in e.name]
        if len(ts) == reps:
            return sum(ts) / reps / 1e3
    fail(f"the profiler saw {len(ts)} launches of {tag} twice, expected {reps}")


def spd_times(name, M, b, damp):
    """(kernel device ms per launch, kernel host-clock ms per launch, plain
    ms, library ms) on the same inputs (M is the factor for solve_batched).
    The kernel is timed by its launch alone; the library call is the one
    PyTorch call computing the same function (torch.linalg.inv, twice for
    the pair, torch.linalg.solve, torch.linalg.cholesky or
    torch.cholesky_solve), which the port never calls."""
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    if name == "spd_solve":
        kern = lambda: ops_chol._launch_solve(M, b)
        lib = lambda: torch.linalg.solve(M, b[..., None])
    elif name == "factor_batched":
        kern = lambda: ops_chol._launch_factor(M)
        lib = lambda: torch.linalg.cholesky(M)
    elif name == "solve_batched":  # M is the factor U
        kern = lambda: ops_chol._launch_solve_factor(M, b)
        lib = lambda: torch.cholesky_solve(b[..., None], M, upper=True)
    elif name == "spd_inverse2":
        kern = lambda: ops_chol._launch_inverse(M, damp, 2)
        lib = lambda: (torch.linalg.inv(M), torch.linalg.inv(M + torch.diag(damp)))
    else:
        zero = torch.zeros_like(damp)
        kern = lambda: ops_chol._launch_inverse(M, zero, 1)
        lib = lambda: torch.linalg.inv(M)
    plain = lambda: spd_run(name, M, b, damp, "plain")
    reps = 50 if M.shape[-1] <= 73 else 10
    tag = {"spd_solve": "spd_solve_kernel", "factor_batched": "factor_kernel",
           "solve_batched": "solve_kernel"}.get(name, "spd_inverse_kernel")
    return (device_ms(kern, tag), time_cuda(kern, reps), time_cuda(plain, 3),
            time_cuda(lib, reps))


def bm_ms_per_substep(solver, B, n, seed):
    """Host-clock ms per substep of B ballmuscle envs, after one warm
    substep, ending in a synchronize."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = bm_model("cuda", solver)
    d = bm_posed(m, B)
    ctrls = bm_ctrls(m, B, n + 1, seed)
    d = pstep.step(m, d.replace(ctrl=ctrls[0]), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in ctrls[1:]:
        d = pstep.step(m, d.replace(ctrl=c), device="cuda")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def newton_ms_per_substep(B, n, seed):
    """Host-clock ms per substep of B Newton minirat envs, after one warm
    substep, ending in a synchronize."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("minirat_newton", "cuda")
    d = random_states(m, B, seed)
    ctrls = newton_ctrls(m, B, n + 1, seed)
    d = pstep.step(m, d.replace(ctrl=ctrls[0]), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in ctrls[1:]:
        d = pstep.step(m, d.replace(ctrl=c), device="cuda")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def time_cuda(fn, reps):
    """Mean ms per call over ``reps`` calls, after one warmup call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _launch_statics(kw):
    return dict(ell0=kw["ell0"], iters=kw["iters"], ls_iters=kw["ls_iters"], tol=kw["tol"],
                dt=kw["dt"], has_damping=kw["has_damping"], stall_tol=kw.get("stall_tol", 0.0))


def kernel_launch(args, kw, batched=False):
    """The kernel launch alone (no P A einsum, no argument checks) on these
    inputs: what ``ms`` times. Launches made here do not count."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    ell = ops_cg._ell_table(kw["ell_mu"], kw["ell_scale"], torch.float32, args[0].device)
    ws, st = kw.get("warmstart"), _launch_statics(kw)
    if batched:
        return lambda: ops_cg._launch_batched(*args, ell, ws, **st)
    f, cdof, A, jsign, D, aref, exists, econ, qfs, qvel, damp, P, md, arm = args
    Bm = ops_cg._bm(P, A, len(kw["root_bounds"]), md.shape[0]).contiguous()
    tables = ops_cg._int_tables(kw["row_slot"], kw["sz"], kw["root_bounds"],
                                kw["limit_dadr"], f.shape[-1], f.device)
    return lambda: ops_cg._launch(f, cdof, Bm, jsign, D, aref, exists, econ, qfs, qvel,
                                  damp, md, arm, ell, ws, tables, **st)


def iterations_run(args, kw, batched=False):
    """CG iterations each env runs (the kernel stops an env once it is
    done), from the float32 plain version's done flags after 1..iters-1
    iterations."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    plain = ops_cg.cg_solve_batched_reference if batched else ops_cg.cg_solve_fused_reference
    B = args[0].shape[0]
    its = torch.ones(B, device=args[0].device)
    for k in range(1, kw["iters"]):
        done_k = plain(*args, **dict(kw, iters=k))[5]
        its += (~done_k).float()
    return its


def line_search_steps(args, kw, batched=False):
    """Line-search steps per CG iteration each env needs (the kernel leaves
    the line search at its first converged step, whose later steps would
    change nothing): the least k for which the float32 plain version with
    ls_iters = k gives the same qacc as with the full count, so every
    iteration of the env converged within k steps (an upper count)."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    plain = ops_cg.cg_solve_batched_reference if batched else ops_cg.cg_solve_fused_reference
    full = plain(*args, **kw)[0]
    steps = torch.full((full.shape[0],), float(kw["ls_iters"]), device=full.device)
    same = torch.ones_like(steps, dtype=torch.bool)
    for k in range(kw["ls_iters"] - 1, 0, -1):
        same &= (plain(*args, **dict(kw, ls_iters=k))[0] == full).all(-1)
        steps[same] = float(k)
    return steps


def kernel_bound(args, kw, its, ls_steps, batched=False):
    """Least time of one call on an H100: max(bytes / HBM rate, FLOPs /
    FP32 rate), counting each input read once and each output written once,
    and the FLOPs of the CG iterations (``its``) and line-search steps per
    iteration (``ls_steps``) this data needs, per env. For cg_solve_fused qM
    is assembled only at its lower-triangle ancestor pairs (it is symmetric
    and zero elsewhere) and J only at its nonzeros (the md support of the
    contact rows, one entry per limit row); for cg_solve_batched the J
    products count the nonzeros of the J it is given. A phi' evaluation
    costs 6 FLOPs per quadratic row and 30 per elliptic contact; the
    warmstart adds its cost (qM (ws - a0), J ws) to the start."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    nell = len(kw["ell_mu"])
    ws = kw.get("warmstart")
    if batched:
        qM, J, D, aref, exists, econ, qfs, qvel, damp = args
        B, nefc, nv = J.shape
        j_nnz = float((J != 0).sum()) / B
        ins = list(args)
        build = 0
    else:
        f, cdof, A, jsign, D, aref, exists, econ, qfs, qvel, damp, P, md, arm = args
        B, _, nv = f.shape
        nefc, ncon = D.shape[1], md.shape[0]
        i = np.arange(nv)
        sz = np.asarray(kw["sz"])
        anc = int(((i[:, None] >= i[None, :]) & (i[:, None] < (i + sz)[None, :])).sum())
        rs = np.asarray(kw["row_slot"])
        j_con = int((md.cpu().numpy()[rs[rs >= 0]] != 0).sum())
        j_nnz = j_con + len(kw["limit_dadr"])
        Bm = ops_cg._bm(P, A, len(kw["root_bounds"]), ncon)
        ins = [f, cdof, Bm, jsign, D, aref, exists, econ, qfs, qvel, damp, md, arm]
        build = 12 * anc + nv + 12 * j_con  # qM (ancestor pairs, armature), contact rows of J
        # int tables
        ins.append(torch.empty(len(kw["row_slot"]) + 2 * nv + len(kw["limit_dadr"]),
                               dtype=torch.int32))
    if ws is not None:
        ins.append(ws)
    nbytes = sum(t.numel() * t.element_size() for t in ins) + 12 * nell  # ell table
    nbytes += B * (4 * (4 * nv + nefc) + 1)  # qacc qfrc a0 qvel_new, force, done
    nquad = nefc - 3 * nell
    cost = 6 * nquad + 30 * nell
    per_env = (
        build
        + nv**3 + 2 * nv * nv + nv + 2 * nv * nv  # SPD inverse (spd_bound), qacc_smooth
        + 4 * j_nnz + 2 * nv * nv + 2 * nefc + cost  # initial J x, J^T f, M^-1 grad, cost
        + (2 * nv * nv + 2 * j_nnz + cost + 4 * nv if ws is not None else 0)  # warmstart
        + 2 * j_nnz  # final J^T f
        + (nv**3 / 3 + 4 * nv * nv if kw["has_damping"] else 2 * nv)
    )
    per_iter = (
        4 * j_nnz + 4 * nv * nv + 20 * nv  # J p, J^T f, M p, M^-1 grad, dots
        + (6 * nquad + 30 * nell) * (1 + 13) + 4 * nefc + cost  # phi', step, cost
    )
    flops = float(B * per_env + its.sum().item() * per_iter
                  + (its * ls_steps).sum().item() * (6 * nquad + 30 * nell))  # line search
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def fused_times(args, kw, batched=False):
    """(kernel device ms per launch, plain ms, bound ms, bound by, bytes,
    FLOPs, mean CG iterations) of cg_solve_fused, or cg_solve_batched, on
    these inputs. The kernel by torch.profiler: the host's launch path takes
    about as long as a launch, so CUDA events around a loop of launches would
    time the host."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    plain = ops_cg.cg_solve_batched_reference if batched else ops_cg.cg_solve_fused_reference
    tag = "cg_batched_kernel" if batched else "cg_fused_kernel"
    k_ms = device_ms(kernel_launch(args, kw, batched), tag, 100)
    p_ms = time_cuda(lambda: plain(*args, **kw), 5)
    its = iterations_run(args, kw, batched)
    bound = kernel_bound(args, kw, its, line_search_steps(args, kw, batched), batched)
    return (k_ms, p_ms) + bound + (float(its.mean()),)


def entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
          library_ms):
    return {"name": name, "route": "cuda",
            "source": f"brax_tracking_tpu_torch/ops/csrc/{source}",
            "replaces": f"brax_tracking_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    t_start = time.perf_counter()
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.ops import library
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S
    from brax_tracking_tpu_torch.physics import step as pstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    secs = library.build()
    srcs = " ".join(os.path.basename(f) for f in library.SOURCES)
    print(f"build: {srcs} -> {secs:.1f} s")
    for model in MODELS:
        m = load(model, "cuda", torch.float32)
        layout = Cn.efc_layout(m)
        nell = int(S._cone_meta(m, layout).ell_con.size)
        nroots = len(S._fused_statics(m, layout)["root_bounds"])
        print(f"{model}: kernel shared memory per env "
              f"{ops_cg.kernel_smem_bytes(m.nv, layout.nefc, nell, nroots, m.ncon)} B (nv={m.nv}, "
              f"nefc={layout.nefc}, elliptic contacts {nell})")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    cases = {}
    for model, B, damped, iters in [
        ("minirat", B_MAIN, False, None), ("minirat", B_MAIN, True, None),
        ("minirat", B_MAIN - 1, False, None), ("minirat", B_MAIN - 1, True, None),
        ("minirat", B_MAIN, False, CONVERGED_ITERS), ("minirat", B_MAIN, True, CONVERGED_ITERS),
        ("minirat_elliptic", B_MAIN, False, None), ("minirat_elliptic", B_MAIN - 1, True, None),
        ("minirat_elliptic", B_MAIN, False, CONVERGED_ITERS),
        ("minirat_newton", B_MAIN, False, None), ("minirat_newton", B_MAIN - 1, False, None),
    ]:
        cases[model, B, damped, iters] = phase_kernel_vs_plain("cuda", B, damped, SEED, iters,
                                                               model)
    batched = {}
    for model, B in [("minirat", B_MAIN), ("minirat_elliptic", B_MAIN),
                     ("minirat_elliptic", B_MAIN - 1)]:
        batched[model, B] = phase_kernel_vs_plain("cuda", B, False, SEED, None, model,
                                                  batched=True)
    rodent = {}
    for B, iters in ((B_MAIN, None), (B_MAIN - 1, None), (B_MAIN, CONVERGED_ITERS)):
        rodent[B, iters] = phase_kernel_vs_plain("cuda", B, False, SEED, iters, "rodent_like")
    spd_cases = {}
    for nv in SPD_SIZES:
        for B in (B_MAIN, B_MAIN - 1):
            M, b, damp = spd_inputs("cuda", nv, B, SEED + nv)
            for name in SPD_KERNELS + CHOL_KERNELS:
                phase_spd_vs_plain(name, *chol_inputs(name, M, b, damp), "seeded", SPD_ABS)
            if B == B_MAIN:
                spd_cases[nv] = (M, b, damp)
    for nv in CHOL_EDGE_SIZES:
        for B in (B_MAIN, B_MAIN - 1):
            M, b, damp = spd_inputs("cuda", nv, B, SEED + nv)
            for name in CHOL_KERNELS:
                phase_spd_vs_plain(name, *chol_inputs(name, M, b, damp), "panel edge", SPD_ABS)
    bm = bm_model("cuda", "newton")
    dbm = pstep.forward_to_constraint(bm, bm_posed(bm, B_MAIN))
    bm_inputs = (dbm.qM.contiguous(), dbm.qfrc_smooth.contiguous(),
                 (bm.dof_damping * bm.opt.timestep).contiguous())
    bm_reports = {name: phase_spd_vs_plain(name, *chol_inputs(name, *bm_inputs),
                                           "ballmuscle qM", SPD_ABS_BM)
                  for name in SPD_KERNELS + CHOL_KERNELS}
    print(f"kernels against their plain versions: {time.perf_counter() - t0:.1f} s")

    # 4. the tracking rollouts: minirat (the main path) and elliptic minirat
    launches, envs = {}, {}
    for model in ("minirat", "minirat_elliptic"):
        t0 = time.perf_counter()
        env, counts, first_in, a0, first_out, last, touching = phase_rollout(
            "cuda", B_MAIN, SEED, model)
        torch.cuda.synchronize()
        envs[model] = env
        print(f"{model} rollout: {B_MAIN} envs x {N_STEPS} control steps x {N_SUBSTEPS} "
              f"substeps, first run {time.perf_counter() - t0:.1f} s, kernel launches {counts}")
        expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": N_STEPS * N_SUBSTEPS}
        if counts != expected:
            fail(f"kernel launches in the {model} rollout: {counts}, expected {expected}")
        if model == "minirat":
            launches["cg_solve_fused"] = counts["cg_solve_fused"]
            # cg_solve_batched lies on no step path (the JAX package has
            # no caller either): the main path's count of it is 0 (gated)
            launches["cg_solve_batched"] = counts["cg_solve_batched"]
        print(f"{model} rollout done fraction at the last step: {float(last.done.mean()):.4f}, "
              f"mean reward {float(last.reward.mean()):.4f}, envs with contact forces "
              f"{touching:.4f}")
        gaps = phase_first_step_on_cpu(first_in, a0, first_out, N_CPU_ENVS, model)
        print(f"{model}_first_step_vs_cpu_f64 " + json.dumps(gaps))
    gaps, zones, counts = phase_elliptic_contacts("cuda", B_MAIN, SEED)
    print(f"minirat_elliptic contact substep: {B_MAIN} envs, converged, kernel launches "
          f"{counts}; active elliptic contacts per zone (bottom, middle, top) in the "
          f"float64 solution of {ELL_ROW_ENVS} envs {zones}")
    print("minirat_elliptic_contact_substep_vs_cpu_f64 " + json.dumps(gaps))

    # 5. the ballmuscle slice, CG (i) and Newton (ii)
    for solver, kernel in (("cg", "spd_inverse2"), ("newton", "spd_solve")):
        t0 = time.perf_counter()
        counts, expected, iters, bm_in, bm_out = phase_ballmuscle("cuda", solver, B_MAIN, SEED)
        torch.cuda.synchronize()
        launches[kernel] = counts[kernel]
        if solver == "cg":
            # an undamped model would invert qM alone here; the ballmuscle
            # is damped, so the run's count of spd_inverse is 0 (gated above)
            launches["spd_inverse"] = counts["spd_inverse"]
        print(f"ballmuscle {solver}: {B_MAIN} envs x {BM_SUBSTEPS} substeps, first run "
              f"{time.perf_counter() - t0:.1f} s, kernel launches {counts} (expected "
              f"{expected}; Newton iterations per substep {iters})")
        gaps = phase_bm_first_substep_on_cpu(solver, bm_in, bm_out, N_CPU_ENVS)
        print(f"ballmuscle_{solver}_first_substep_vs_cpu_f64 " + json.dumps(gaps))

    # 6. Newton on the kernel layout
    t0 = time.perf_counter()
    counts, chunks, nt_in, nt_out = phase_newton("cuda", B_MAIN, SEED)
    torch.cuda.synchronize()
    print(f"minirat_newton: {B_MAIN} envs x {NEWTON_SUBSTEPS} substeps, first run "
          f"{time.perf_counter() - t0:.1f} s, kernel launches {counts} (chunks per substep "
          f"{chunks})")
    gaps = phase_newton_first_substep_on_cpu(nt_in, nt_out, N_CPU_ENVS)
    print("minirat_newton_first_substep_vs_cpu_f64 " + json.dumps(gaps))

    # 7. the smooth dynamics: crb (dense) -> factor_m -> solve_m
    counts, res, qM, qLD, rhs = phase_smooth("cuda", B_MAIN, SEED)
    launches.update(factor_batched=counts["factor_batched"], solve_batched=counts["solve_batched"])
    print(f"smooth dynamics: {B_MAIN} minirat envs, kernel launches {counts}, solve_m "
          f"residual {res:.3e}")
    mr_damp = torch.zeros(qM.shape[-1], device="cuda")
    chol_reports = {name: phase_spd_vs_plain(name, *chol_inputs(name, qM, rhs, mr_damp),
                                             "minirat qM", SPD_ABS_BM)
                    for name in CHOL_KERNELS}

    # 8. times
    entries = []
    for model, key in (("minirat", ("minirat", B_MAIN, False, None)),
                       ("minirat_elliptic", ("minirat_elliptic", B_MAIN, False, None)),
                       ("minirat_newton", ("minirat_newton", B_MAIN, False, None))):
        report, (_, args, kw, _) = cases[key]
        k_ms, p_ms, bound_ms, bound_by, nbytes, flops, its = fused_times(args, kw)
        print(f"cg_solve_fused on {model}: {k_ms * 1e3:.1f} us/launch at B={B_MAIN} (plain "
              f"{p_ms:.3f} ms; bound {bound_ms * 1e3:.2f} us by {bound_by}: {nbytes} B, "
              f"{flops:.3e} FLOP, mean CG iterations {its:.2f}) on {card}")
        if model == "minirat":
            w_ms = time_cuda(lambda: ops_cg.cg_solve_fused(*args, device="cuda", **kw), 100)
            print(f"cg_solve_fused wrapper with the P A einsum on minirat: {w_ms * 1e3:.1f} "
                  f"us/call on {card}")
            entries.append(entry(
                "cg_solve_fused", "cg_fused.cu", "cg.py:863", launches["cg_solve_fused"],
                max(report[n]["kernel_max"] for n in SCORED), k_ms, p_ms, bound_ms, bound_by,
                None))
    for model in ("minirat", "minirat_elliptic"):
        report, (_, args, kw, _) = batched[model, B_MAIN]
        k_ms, p_ms, bound_ms, bound_by, nbytes, flops, its = fused_times(args, kw, batched=True)
        print(f"cg_solve_batched on {model}: {k_ms * 1e3:.1f} us/launch at B={B_MAIN} (plain "
              f"{p_ms:.3f} ms; bound {bound_ms * 1e3:.2f} us by {bound_by}: {nbytes} B, "
              f"{flops:.3e} FLOP, mean CG iterations {its:.2f}) on {card}")
        if model == "minirat":
            entries.append(entry(
                "cg_solve_batched", "cg_fused.cu", "cg.py:552", launches["cg_solve_batched"],
                max(report[n]["kernel_max"] for n in SCORED), k_ms, p_ms, bound_ms, bound_by,
                None))
    _, (_, args, kw, _) = rodent[B_MAIN, None]
    k_ms = device_ms(kernel_launch(args, kw, batched=True), "cg_batched_kernel", 5)
    print(f"cg_solve_batched on the rodent-like case (nv={RODENT_LIKE['nv']}, "
          f"nefc={RODENT_LIKE['nefc']}): {k_ms * 1e3:.1f} us/launch on the device at "
          f"B={B_MAIN} on {card}")
    spd_meta = {
        "spd_inverse": ("spd_inverse.cu", 362),
        "spd_inverse2": ("spd_inverse.cu", 388),
        "spd_solve": ("spd_solve.cu", 489),
        "factor_batched": ("cholesky.cu", 180),
        "solve_batched": ("cholesky.cu", 206),
    }
    for name in SPD_KERNELS + CHOL_KERNELS:
        for nv in SPD_SIZES:
            t = spd_times(name, *chol_inputs(name, *spd_cases[nv]))
            bnd = spd_bound(name, B_MAIN, nv)
            print(f"{name} nv={nv} B={B_MAIN}: kernel {t[0] * 1e3:.2f} us/launch on the "
                  f"device ({t[1] * 1e3:.2f} us/launch on the host clock), plain "
                  f"{t[2]:.3f} ms, library {t[3] * 1e3:.2f} us, bound {bnd[0] * 1e3:.2f} us by "
                  f"{bnd[1]} ({bnd[2]} B, {bnd[3]:.3e} FLOP) on {card}")
        # the JSON line holds each kernel at its path's shape: the
        # ballmuscle's own mass matrices (nv=7) for the SPD kernels, the
        # minirat's (nv=10) for the factor and the solve; B=2048
        if name in CHOL_KERNELS:
            ins, where, nv, rep = (qM, rhs, mr_damp), "minirat", qM.shape[-1], chol_reports[name]
        else:
            ins, where, nv, rep = bm_inputs, "ballmuscle", bm.nv, bm_reports[name]
        t = spd_times(name, *chol_inputs(name, *ins))
        bnd = spd_bound(name, B_MAIN, nv)
        print(f"{name} on the {where}'s qM (nv={nv}, B={B_MAIN}): kernel "
              f"{t[0] * 1e3:.2f} us/launch on the device ({t[1] * 1e3:.2f} us on the host "
              f"clock), plain {t[2]:.3f} ms, library {t[3] * 1e3:.2f} us, bound "
              f"{bnd[0] * 1e3:.3f} us by {bnd[1]} on {card}")
        src, line = spd_meta[name]
        entries.append(entry(name, src, f"cholesky.py:{line}", launches[name],
                             rep["max_abs_err"], t[0], t[2], bnd[0], bnd[1], t[3]))

    for model, env in envs.items():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        state = env.reset(gen, B_MAIN)
        acts = [2.0 * torch.rand(B_MAIN, env.action_size, generator=gen, device="cuda") - 1.0
                for _ in range(N_STEPS)]
        state = env.step(state, acts[0])  # warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in acts:
            state = env.step(state, a)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"{model} rollout: {B_MAIN * N_STEPS / dt:.0f} env-steps/s ({dt / N_STEPS * 1e3:.2f} "
              f"ms per control step of {B_MAIN} envs) on {card}")
    for solver in ("cg", "newton"):
        ms = bm_ms_per_substep(solver, B_MAIN, 10, SEED + 2)
        print(f"ballmuscle {solver}: {ms:.2f} ms per substep of {B_MAIN} envs on {card}")
    ms = newton_ms_per_substep(B_MAIN, 10, SEED + 2)
    print(f"minirat_newton: {ms:.2f} ms per substep of {B_MAIN} envs on {card}")

    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
