"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It

1. checks for the card and prints its name and power limit;
2. builds the solve kernel (ops/csrc/cg_fused.cu) and prints the seconds;
3. holds the kernel against its plain PyTorch version on the minirat's
   batched forward at B=2048 and B=2047, without and with joint damping,
   both scored against a float64 plain run on the card;
4. rolls out 2048 minirat tracking envs (GenericSingleClip + EpisodeWrapper
   + AutoResetWrapperTracking, 10 substeps) for 20 control steps, counts
   the kernel launches of that run and checks its first step on 8 envs
   against the same step run on the CPU in float64;
5. times the kernel, its plain version and the rollout with CUDA events.

It needs nothing beyond the checkout (the model is the frozen
``assets/minirat.npz``; weights and states come from seeds), exits
non-zero if any phase fails, and ends with one JSON line for the caller.
"""

from __future__ import annotations

import json
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
    """Reset + N_STEPS control steps of B envs; returns the launch count of
    the steps, the first step's inputs and outputs, and the final state."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    env = make_env(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = env.reset(gen, B)
    actions = [
        2.0 * torch.rand(B, env.action_size, generator=gen, device=device) - 1.0
        for _ in range(N_STEPS)
    ]
    first_in = state
    ops_cg.cg_solve_fused.launches = 0
    states = []
    for a in actions:
        state = env.step(state, a)
        states.append(state)
    launches = ops_cg.cg_solve_fused.launches
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
        + 2 * nv**3 + 2 * nv * nv  # sweep inverse, qacc_smooth
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
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    secs = ops_cg.build()
    print(f"build: cg_fused.cu -> {secs:.1f} s")
    m = spec.load_model(device="cuda", dtype=torch.float32)
    nefc = Cn.efc_layout(m).nefc
    print(f"kernel shared memory per env: {ops_cg.kernel_smem_bytes(m.nv, nefc)} B "
          f"(nv={m.nv}, nefc={nefc})")

    # 3. kernel against plain version
    for B, damped, iters in [(B_MAIN, False, None), (B_MAIN, True, None),
                             (B_MAIN - 1, False, None), (B_MAIN - 1, True, None),
                             (B_MAIN, False, CONVERGED_ITERS),
                             (B_MAIN, True, CONVERGED_ITERS)]:
        report, case = phase_kernel_vs_plain("cuda", B, damped, SEED, iters)
        if (B, damped, iters) == (B_MAIN, False, None):
            main_case, main_report = case, report

    # 4. the slice
    t0 = time.perf_counter()
    env, launches, first_in, a0, first_out, last = phase_rollout("cuda", B_MAIN, SEED)
    torch.cuda.synchronize()
    print(f"rollout: {B_MAIN} envs x {N_STEPS} control steps x {N_SUBSTEPS} substeps, "
          f"first run {time.perf_counter() - t0:.1f} s, kernel launches {launches}")
    if launches != N_STEPS * N_SUBSTEPS:
        fail(f"kernel launches in the rollout: {launches}, expected {N_STEPS * N_SUBSTEPS}")
    print(f"rollout done fraction at the last step: {float(last.done.mean()):.4f}, "
          f"mean reward {float(last.reward.mean()):.4f}")
    gaps = phase_first_step_on_cpu(first_in, a0, first_out, N_CPU_ENVS)
    print("first_step_vs_cpu_f64 " + json.dumps(gaps))

    # 5. times
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

    ops_cg.cg_solve_fused.launches = launches
    print(json.dumps({"kernels": [{
        "name": "cg_solve_fused",
        "route": "cuda",
        "source": "brax_tracking_tpu_torch/ops/csrc/cg_fused.cu",
        "replaces": "brax_tracking_tpu/ops/cg.py:863",
        "launches": launches,
        "max_abs_err": max(main_report[n]["kernel_max"] for n in SCORED),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
