"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It

1. checks for the card and prints its name and power limit;
2. builds every kernel (ops/csrc/*.cu, one library) and prints the seconds;
3. holds each kernel against its plain PyTorch version, both scored
   against a float64 plain run on the card: the solve kernel on the
   minirat's batched forward at B=2048 and B=2047, without and with joint
   damping; the SPD inverse, the paired inverse and the SPD solve on
   seeded SPD matrices at nv = 7, 73 and 146 (B=2048 and B=2047) and on
   the ballmuscle's own mass matrices;
4. rolls out 2048 minirat tracking envs (GenericSingleClip + EpisodeWrapper
   + AutoResetWrapperTracking, 10 substeps) for 20 control steps, counts
   the kernel launches of that run and checks its first step on 8 envs
   against the same step run on the CPU in float64;
5. steps 2048 ballmuscle envs (ball-joint limits, a fixed tendon, muscles)
   20 substeps under CG (the XLA-CG path: spd_inverse2 once per substep)
   and under Newton (spd_solve 2 + iterations per substep), counts the
   launches of each run and checks its first substep on 8 envs against the
   CPU in float64;
6. times every kernel, its plain version and a PyTorch library call
   computing the same function with CUDA events, and the rollout and the
   ballmuscle substeps on the host clock.

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
# contact dynamics; obs and reward agree to this absolute tolerance
STEP_ATOL = 1e-3

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
# ballmuscle slice: 20 substeps of 2048 envs per solver; its first substep
# of 8 envs on the card (float32) against the CPU (float64). A CPU float32
# rehearsal of that substep (64 envs, both solvers) is off float64 by
# 2.6e-7 (qpos), 2.6e-4 (qvel) and 3.8e-8 (act): qacc (~1e4) moves by
# ~0.35 in float32 through qM's condition number (up to 7.5e3), and one
# substep scales that by dt = 2e-3. BM_STEP_ATOL leaves ~30-40x room for
# the card's other summation order.
BM_SUBSTEPS = 20
BM_STEP_ATOL = {"qpos": 1e-5, "qvel": 1e-2, "act": 1e-6}

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


def random_states(m, B, seed, drop=0.01):
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
        qvel=t(rng.uniform(-0.5, 0.5, (B, m.nv))),
        ctrl=t(rng.uniform(-0.3, 0.3, (B, m.nu))),
    )


def solve_inputs(m, d, damp=None):
    """The solve kernel's arguments at the state ``d`` (as _solve_quad
    passes them), with an optional damping override."""
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S
    from brax_tracking_tpu_torch.physics import step as pstep

    d = pstep.forward_to_constraint(m, d)
    st = S._solve_statics(m, Cn.efc_layout(m))
    B = d.qpos.shape[0]
    kw = dict(st["kw"])
    args = [
        d.crb_f, d.cdof, d.con_A, d.efc_jsign, d.efc_D, d.efc_aref,
        d.efc_pos < d.efc_margin,
        torch.zeros(B, 0, dtype=torch.bool, device=m.device),
        d.qfrc_smooth, d.qvel, st["damp"], st["P"], st["md"], m.dof_armature,
    ]
    if damp is not None:
        args[10] = torch.as_tensor(damp, dtype=m.dtype, device=m.device)
        kw["has_damping"] = True
    return [a.contiguous() for a in args], kw


def cast(args, dtype):
    return [a.to(dtype) if a.is_floating_point() else a for a in args]


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


def phase_kernel_vs_plain(device, B, damped, seed, iters=None):
    """Kernel and float32 plain version against a float64 plain run on the
    same inputs (the main path's solve at state ``seed``; ``iters``
    overrides the CG iteration count). Returns the error report."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.physics import spec

    m = spec.load_model(device=device, dtype=torch.float32)
    damp = None
    if damped:
        rng = np.random.RandomState(seed + 100)
        damp = float(m.opt.timestep) * rng.uniform(0.005, 0.02, m.nv)
    args, kw = solve_inputs(m, random_states(m, B, seed), damp)
    if iters is not None:
        kw["iters"] = iters
    ref = outputs(ops_cg.cg_solve_fused_reference(*cast(args, torch.float64), **kw))
    plain = outputs(ops_cg.cg_solve_fused_reference(*args, **kw))
    launches = ops_cg.cg_solve_fused.launches
    kern = outputs(ops_cg.cg_solve_fused(*args, device=device, **kw))
    ops_cg.cg_solve_fused.launches = launches  # comparison launches do not count
    if device == "cuda":
        torch.cuda.synchronize()

    case = f"B={B}, damped={damped}, iters={kw['iters']}"
    report = {"B": B, "damped": damped, "iters": kw["iters"]}
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


def make_env(device, dtype=None):
    from brax_tracking_tpu_torch.data import clips
    from brax_tracking_tpu_torch.envs import tracking, wrappers
    from brax_tracking_tpu_torch.physics import spec

    m = spec.load_model(device=device, dtype=dtype)
    clip = clips.process_clip(m, torch.as_tensor(synth_clip_qpos(m.qpos0.cpu().numpy())))
    env = tracking.GenericSingleClip(
        reference_clip=clip,
        mjcf_path="builtin:minirat.xml",
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


def phase_rollout(device, B, seed):
    """Reset + N_STEPS control steps of B envs; returns the launch counts of
    the steps (every kernel, set to 0 just before), the first step's inputs
    and outputs, and the final state."""
    env = make_env(device)
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
            fail("rollout obs or reward not finite")
    return env, launches, first_in, actions[0], states[0], state


def phase_first_step_on_cpu(first_in, action, first_out, n):
    """The first control step of ``n`` envs run again by the port on the CPU
    in float64; returns the max obs and reward gaps."""
    env = make_env("cpu")
    d = first_in.pipeline_state
    cpu = lambda t: t[:n].detach().to("cpu", torch.float64)
    s = env.init_state(first_in.info["cur_frame"][:n].cpu(), cpu(d.qpos), cpu(d.qvel))
    s = env.step(s, cpu(action))
    gaps = {
        "obs": float((s.obs - cpu(first_out.obs)).abs().max()),
        "reward": float((s.reward - cpu(first_out.reward)).abs().max()),
        "done_mismatch": int((s.done != cpu(first_out.done)).sum()),
    }
    if gaps["obs"] > STEP_ATOL or gaps["reward"] > STEP_ATOL or gaps["done_mismatch"]:
        fail(f"first control step on the card differs from the CPU float64 run: {gaps}")
    return gaps


# ---------------------------------------------------------------------------
# SPD kernels and the ballmuscle slice
# ---------------------------------------------------------------------------


def counted():
    """Every kernel wrapper that counts its launches, by name."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    return {"cg_solve_fused": ops_cg.cg_solve_fused, "spd_inverse": ops_chol.spd_inverse,
            "spd_inverse2": ops_chol.spd_inverse2, "spd_solve": ops_chol.spd_solve}


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


def spd_run(name, M, b, damp, fn_kind):
    """One of the SPD functions on (M, b, damp): fn_kind "kernel" (the
    wrapper on M's device), "plain" or "plain64"; returns a tuple of
    outputs."""
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    if fn_kind == "plain64":
        M, b, damp = M.double(), b.double(), damp.double()
    if name == "spd_solve":
        args = (M, b)
    elif name == "spd_inverse2":
        args = (M, damp)
    else:
        args = (M,)
    if fn_kind == "kernel":
        out = getattr(ops_chol, name)(*args, device=M.device)
    elif name == "spd_solve":
        out = ops_chol.spd_solve_reference(*args)
    elif name == "spd_inverse2":
        out = (ops_chol.sweep_inverse_reference(M),
               ops_chol.sweep_inverse_reference(M + torch.diag(damp)))
    else:
        out = ops_chol.sweep_inverse_reference(M)
    return out if isinstance(out, tuple) else (out,)


def spd_residual(name, M, b, damp, outs):
    """Per-matrix float64 residual: ||M X - I||_max (for spd_inverse2 the
    larger of its two inverses') or ||M x - b|| / ||b||."""
    Md, outs = M.double(), [o.double() for o in outs]
    if name == "spd_solve":
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


def spd_bound(name, B, nv):
    """Least time (ms) of one call on an H100 and what bounds it:
    max(bytes / HBM rate, FP32 operations / FP32 rate). Bytes: each input
    read once, each output written once. Operations, per matrix: nv^3 +
    2 nv^2 + nv per inverse (the symmetric sweep: per pivot a reciprocal,
    the pivot row scaled, one multiply-add on each entry of a triangle;
    Cholesky inversion, potrf + potri, also costs nv^3); the Cholesky
    nv^3 / 3 + nv^2 / 2 and the two substitutions 2 nv^2 for the solve."""
    mat = 4 * B * nv * nv
    if name == "spd_solve":
        nbytes = mat + 2 * 4 * B * nv
        flops = B * (nv**3 / 3 + 2.5 * nv * nv + nv)
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
    events around a loop of launches time the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ts = [e.device_time_total for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and tag in e.name]
    if len(ts) != reps:
        fail(f"the profiler saw {len(ts)} launches of {tag}, expected {reps}")
    return sum(ts) / reps / 1e3


def spd_times(name, M, b, damp):
    """(kernel device ms per launch, kernel host-clock ms per launch, plain
    ms, library ms) on the same inputs. The kernel is timed by its launch
    alone; the library call is the one PyTorch call computing the same
    function (torch.linalg.inv, twice for the pair, or torch.linalg.solve),
    which the port never calls."""
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    if name == "spd_solve":
        kern = lambda: ops_chol._launch_solve(M, b)
        lib = lambda: torch.linalg.solve(M, b[..., None])
    elif name == "spd_inverse2":
        kern = lambda: ops_chol._launch_inverse(M, damp, 2)
        lib = lambda: (torch.linalg.inv(M), torch.linalg.inv(M + torch.diag(damp)))
    else:
        zero = torch.zeros_like(damp)
        kern = lambda: ops_chol._launch_inverse(M, zero, 1)
        lib = lambda: torch.linalg.inv(M)
    plain = lambda: spd_run(name, M, b, damp, "plain")
    reps = 50 if M.shape[-1] <= 73 else 10
    tag = "spd_solve_kernel" if name == "spd_solve" else "spd_inverse_kernel"
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


def kernel_launch(args, kw):
    """The kernel launch alone (no P A einsum, no argument checks), on the
    main path's inputs: what ``ms`` times. Launches made here do not
    count."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    f, cdof, A, jsign, D, aref, exists, _, qfs, qvel, damp, P, md, arm = args
    nroots = len(kw["root_bounds"])
    Bm = ops_cg._bm(P, A, nroots, md.shape[0]).contiguous()
    tables = ops_cg._int_tables(kw["row_slot"], kw["sz"], kw["root_bounds"],
                                kw["limit_dadr"], f.shape[-1], f.device)
    statics = {k: kw[k] for k in ("iters", "ls_iters", "tol", "dt", "has_damping")}
    return lambda: ops_cg._launch(f, cdof, Bm, jsign, D, aref, exists, qfs, qvel,
                                  damp, md, arm, tables, **statics)


def iterations_run(args, kw):
    """CG iterations each env runs (the kernel stops an env once it is
    done), from the float32 plain version's done flags after 1..iters-1
    iterations."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    B = args[0].shape[0]
    its = torch.ones(B, device=args[0].device)
    for k in range(1, kw["iters"]):
        done_k = ops_cg.cg_solve_fused_reference(*args, **dict(kw, iters=k))[5]
        its += (~done_k).float()
    return its


def kernel_bound(args, kw, its):
    """Least time of one call on an H100: max(bytes / HBM rate, FLOPs /
    FP32 rate), counting each input read once and each output written once,
    and the FLOPs of the iterations this data needs. qM is assembled only
    at its lower-triangle ancestor pairs (it is symmetric and zero
    elsewhere), and J only at its nonzeros (the md support of the contact
    rows, one entry per limit row); the J products count those nonzeros."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    f, cdof, A, jsign, D, aref, exists, _, qfs, qvel, damp, P, md, arm = args
    B, _, nv = f.shape
    nefc, ncon = D.shape[1], md.shape[0]
    i = np.arange(nv)
    sz = np.asarray(kw["sz"])
    anc = int(((i[:, None] >= i[None, :]) & (i[:, None] < (i + sz)[None, :])).sum())
    rs = np.asarray(kw["row_slot"])
    j_con = int((md.cpu().numpy()[rs[rs >= 0]] != 0).sum())
    j_nnz = j_con + len(kw["limit_dadr"])
    nroots = len(kw["root_bounds"])
    Bm = ops_cg._bm(P, A, nroots, ncon)
    ins = (f, cdof, Bm, jsign, D, aref, exists, qfs, qvel, damp, md, arm)
    nbytes = sum(t.numel() * t.element_size() for t in ins)
    nbytes += 4 * (len(kw["row_slot"]) + 2 * nv + len(kw["limit_dadr"]))  # int tables
    nbytes += B * (4 * (4 * nv + nefc) + 1)  # qacc qfrc a0 qvel_new, force, done
    ls = kw["ls_iters"]
    per_env = (
        12 * anc + nv + 12 * j_con  # qM (ancestor pairs, armature), contact rows of J
        + nv**3 + 2 * nv * nv + nv + 2 * nv * nv  # SPD inverse (spd_bound), qacc_smooth
        + 4 * j_nnz + 2 * nv * nv + 8 * nefc  # initial J x, J^T f, M^-1 grad
        + 2 * j_nnz  # final J^T f
        + (nv**3 / 3 + 4 * nv * nv if kw["has_damping"] else 2 * nv)
    )
    per_iter = (
        4 * j_nnz + 4 * nv * nv + 20 * nv  # J p, J^T f, M p, M^-1 grad, dots
        + 6 * nefc * (1 + 13 + ls) + 10 * nefc  # phi' evaluations, cost, step
    )
    flops = float(B * per_env + its.sum().item() * per_iter)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    t_start = time.perf_counter()
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.ops import library
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import spec
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
    m = spec.load_model(device="cuda", dtype=torch.float32)
    nefc = Cn.efc_layout(m).nefc
    print(f"kernel shared memory per env: {ops_cg.kernel_smem_bytes(m.nv, nefc)} B "
          f"(nv={m.nv}, nefc={nefc})")

    # 3. kernels against their plain versions
    for B, damped, iters in [(B_MAIN, False, None), (B_MAIN, True, None),
                             (B_MAIN - 1, False, None), (B_MAIN - 1, True, None),
                             (B_MAIN, False, CONVERGED_ITERS),
                             (B_MAIN, True, CONVERGED_ITERS)]:
        report, case = phase_kernel_vs_plain("cuda", B, damped, SEED, iters)
        if (B, damped, iters) == (B_MAIN, False, None):
            main_case, main_report = case, report
    spd_cases = {}
    for nv in SPD_SIZES:
        for B in (B_MAIN, B_MAIN - 1):
            M, b, damp = spd_inputs("cuda", nv, B, SEED + nv)
            for name in SPD_KERNELS:
                phase_spd_vs_plain(name, M, b, damp, "seeded", SPD_ABS)
            if B == B_MAIN:
                spd_cases[nv] = (M, b, damp)
    bm = bm_model("cuda", "newton")
    dbm = pstep.forward_to_constraint(bm, bm_posed(bm, B_MAIN))
    bm_inputs = (dbm.qM.contiguous(), dbm.qfrc_smooth.contiguous(),
                 (bm.dof_damping * bm.opt.timestep).contiguous())
    bm_reports = {name: phase_spd_vs_plain(name, *bm_inputs, "ballmuscle qM", SPD_ABS_BM)
                  for name in SPD_KERNELS}

    # 4. the minirat rollout
    t0 = time.perf_counter()
    env, counts, first_in, a0, first_out, last = phase_rollout("cuda", B_MAIN, SEED)
    torch.cuda.synchronize()
    launches = {"cg_solve_fused": counts["cg_solve_fused"]}
    print(f"rollout: {B_MAIN} envs x {N_STEPS} control steps x {N_SUBSTEPS} substeps, "
          f"first run {time.perf_counter() - t0:.1f} s, kernel launches {counts}")
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": N_STEPS * N_SUBSTEPS}
    if counts != expected:
        fail(f"kernel launches in the rollout: {counts}, expected {expected}")
    print(f"rollout done fraction at the last step: {float(last.done.mean()):.4f}, "
          f"mean reward {float(last.reward.mean()):.4f}")
    gaps = phase_first_step_on_cpu(first_in, a0, first_out, N_CPU_ENVS)
    print("first_step_vs_cpu_f64 " + json.dumps(gaps))

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

    # 6. times
    _, args, kw, _ = main_case
    k_ms = time_cuda(kernel_launch(args, kw), 100)
    w_ms = time_cuda(lambda: ops_cg.cg_solve_fused(*args, device="cuda", **kw), 100)
    p_ms = time_cuda(lambda: ops_cg.cg_solve_fused_reference(*args, **kw), 5)
    its = iterations_run(args, kw)
    bound_ms, bound_by, nbytes, flops = kernel_bound(args, kw, its)
    print(f"kernel: {k_ms * 1e3:.1f} us/launch at B={B_MAIN} (wrapper with the P A "
          f"einsum {w_ms * 1e3:.1f} us/call; plain {p_ms:.3f} ms; bound "
          f"{bound_ms * 1e3:.2f} us by {bound_by}: {nbytes} B, {flops:.3e} FLOP, "
          f"mean CG iterations {float(its.mean()):.2f}) on {card}")
    entries = [{
        "name": "cg_solve_fused",
        "route": "cuda",
        "source": "brax_tracking_tpu_torch/ops/csrc/cg_fused.cu",
        "replaces": "brax_tracking_tpu/ops/cg.py:863",
        "launches": launches["cg_solve_fused"],
        "max_abs_err": max(main_report[n]["kernel_max"] for n in SCORED),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    spd_meta = {
        "spd_inverse": ("spd_inverse.cu", 362),
        "spd_inverse2": ("spd_inverse.cu", 388),
        "spd_solve": ("spd_solve.cu", 489),
    }
    for name in SPD_KERNELS:
        for nv in SPD_SIZES:
            t = spd_times(name, *spd_cases[nv])
            bnd = spd_bound(name, B_MAIN, nv)
            print(f"{name} nv={nv} B={B_MAIN}: kernel {t[0] * 1e3:.2f} us/launch on the "
                  f"device ({t[1] * 1e3:.2f} us/launch on the host clock), plain "
                  f"{t[2]:.3f} ms, library {t[3] * 1e3:.2f} us, bound {bnd[0] * 1e3:.2f} us by "
                  f"{bnd[1]} ({bnd[2]} B, {bnd[3]:.3e} FLOP) on {card}")
        # the JSON line holds each kernel at the main path's shape: the
        # ballmuscle's own mass matrices (nv=7, B=2048)
        t = spd_times(name, *bm_inputs)
        bnd = spd_bound(name, B_MAIN, bm.nv)
        print(f"{name} on the ballmuscle's qM (nv={bm.nv}, B={B_MAIN}): kernel "
              f"{t[0] * 1e3:.2f} us/launch on the device ({t[1] * 1e3:.2f} us on the host "
              f"clock), plain {t[2]:.3f} ms, library {t[3] * 1e3:.2f} us on {card}")
        src, line = spd_meta[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"brax_tracking_tpu_torch/ops/csrc/{src}",
            "replaces": f"brax_tracking_tpu/ops/cholesky.py:{line}",
            "launches": launches[name],
            "max_abs_err": bm_reports[name]["max_abs_err"],
            "ms": t[0],
            "plain_ms": t[2],
            "bound_ms": bnd[0],
            "bound_by": bnd[1],
            "library_ms": t[3],
        })

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
    sps = B_MAIN * N_STEPS / dt
    print(f"rollout: {sps:.0f} env-steps/s ({dt / N_STEPS * 1e3:.2f} ms per control step "
          f"of {B_MAIN} envs) on {card}")
    for solver in ("cg", "newton"):
        ms = bm_ms_per_substep(solver, B_MAIN, 10, SEED + 2)
        print(f"ballmuscle {solver}: {ms:.2f} ms per substep of {B_MAIN} envs on {card}")

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
