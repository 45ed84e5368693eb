"""Time the solve kernel's instances, the Cholesky kernels and the SPD
inverses, for comparing two trees on one card.

    python3 scripts/ab_solve_kernel.py [--root DIR] [--reps 3] [--seeded-only] [--no-ptxas]
    python3 scripts/ab_solve_kernel.py --warps 4,8,16

``--root`` is the root of the tree to measure (default: this checkout); an
older commit unpacked elsewhere works as long as its chip_smoke.py has
``solve_case``, ``dense_case``, ``kernel_launch``, ``time_cuda``,
``spd_inputs``, ``make_env`` and ``card_line``. Alternate
the trees in one call (parent, change, change, parent) and compare only
within it. Prints one JSON line:

- ``ptxas``: registers per thread, stack frame and spill bytes of every
  kernel instance (and of every device function left out of line) of the
  tree's ``ops/csrc/cg_fused.cu``, ``cholesky.cu``, ``spd_inverse.cu``
  and, where the tree has it, ``spd_solve.cu``, from ``nvcc -Xptxas -v``;
- ``seeded_us``: device us per launch of each solve-kernel instance alone
  (torch.profiler over 100 launches, ``--reps`` times: the host's launch
  path takes about as long as a launch now, so CUDA events around a loop
  of launches would time the host; 2048 envs at chip_smoke.py's seeded
  contact states): ``cg_solve_fused`` (a) on the minirat (CG 4/4),
  (b) on the elliptic minirat, (c) on a Newton chunk (warmstart, stall
  exit, 16 line-search steps), and ``cg_solve_batched`` on the dense qM and
  J of (a) and (b); the wide instances (several warps per env, where the
  tree has them): ``pair_a`` / ``pair_b`` / ``pair_c`` and
  ``pair_batched_a``, the same on the two-rat stand-in (1024 envs, layout
  2), ``rat_a`` on the one-rat file (2048 envs, where the tree has it) and
  ``rodent_like``, the seeded dense case (nv 73, 296 rows, 2048 envs);
  and the damped wide layout 1 (the Euler tail's factor and substitutions):
  ``rodent_standin_a`` (the rodent stand-in, nv 73, 135 rows, its own
  joint damping), ``terrain_a`` (on its terrain, 367 rows) and
  ``rodent_standin_arm_a`` (a per-env armature), 2048 envs each; the
  one-warp core past nv 16 (its panel sweep): (b) on the fly stand-in,
  free, tethered and ball-coxa (``fly_standin_b``,
  ``fly_standin_tethered_b``, ``fly_standin_ball_b``; nv 42 / 36 / 42),
  2048 envs each;
- ``digest``: per solve instance above, per output, and per width of
  ``factor_batched``, ``spd_solve`` and ``solve_batched`` below, the first
  16 hex digits of the SHA-256 of the output's bytes: equal digests of two
  trees in one call are bitwise equal outputs;
- ``factor_us`` / ``spd_solve_us`` / ``solve_us``: device us per launch
  (torch.profiler, ``--reps`` runs of 20 launches) of ``factor_batched``
  at nv 7, 10, 73, 144 (the widest on 128 threads) and 146, of
  ``spd_solve`` and of ``solve_batched`` (from the float64 factor, stored
  in float32) at 7, 10, 73 and 146 on seeded SPD matrices (2048);
  ``factor_library_us`` (CUDA events) and ``factor_library_device_us`` of
  ``torch.linalg.cholesky``, ``spd_solve_library_device_us`` of
  ``torch.linalg.solve`` and ``solve_library_device_us`` of
  ``torch.cholesky_solve`` on the same inputs (device time: every kernel
  and copy the call launches, torch.profiler);
- ``inverse_us`` / ``inverse2_us``: device us per launch of ``spd_inverse``
  and ``spd_inverse2`` (the kernels whose name holds ``spd_inverse``, so a
  tree's extra fill launch is not counted) at nv 7, 10, 73 and 146 on the
  same matrices, through the public wrappers so that an older tree is
  timed the same way; ``inverse_library_device_us`` of
  ``torch.linalg.inv`` on them (the pair's is twice that, on M and on M +
  diag(damp));
- ``occupancy_us``: device us per launch of (a) on the first 132 (one env
  per SM), 528 and 2048 of those envs, of ``pair_a`` on 132, 528 and 1024,
  of the fly's (b), free and tethered, on 132, one full wave (the blocks
  of its shared memory that fit an SM, times 132: 792 / 924) and 2048,
  and of ``factor_batched``,
  ``spd_solve``, ``solve_batched``, ``spd_inverse`` and ``spd_inverse2``
  at nv 73 and 146 on 132, 792 and 2048 matrices: a time that stays flat
  as the launch fills the card is one block's chain of dependent steps, a
  time that grows with it is a shared resource;
- ``rollout_inputs_us``: (a)'s device us on the inputs of the last substep of 22
  control steps of the 2048-env tracking rollout (captured at the wrapper);
- ``in_rollout_us``: device us per launch of (a) from torch.profiler over
  10 control steps of that rollout (after the 22 above).

``--seeded-only`` skips the rollout (the last two), ``--no-ptxas`` the
ptxas report (empty), for a second run of a tree in the same call.

``--warps 4,8,16`` instead builds the tree's ``cg_fused.cu`` once per warp
count of the wide core (both layouts' ``-DCG_WIDE_WARPS_L1`` / ``_L2``,
into ``runs/warps/``, all
builds at once) and prints one JSON line: ptxas's registers and spills
of the wide instances per count, device us per launch of ``pair_a``,
``pair_b``, ``pair_c``, ``pair_batched_a``, ``rat_a``, ``rodent_like`` and
the widest layout-1 env at 590 rows (``l1_last``) per count (``warps_us``),
and, with the tree's own count, the one-warp core against the wide one on
the dense case at 590 rows over nv, on ``rat_a`` and ``rodent_like``, and
on the fly stand-in's (b), free and tethered (``fly_standin_b``,
``fly_standin_tethered_b``, 2048 envs; where the tree has them)
(``edge_us``: where the one-warp / wide edge of ops/cg.py::kernel_layout
belongs).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import torch

SOLVE_CASES = (("a", "minirat", False), ("b", "minirat_elliptic", False),
               ("c", "minirat_newton", False), ("batched_a", "minirat", True),
               ("batched_b", "minirat_elliptic", True))
# the wide instances: (key, model, dense, envs); "rodent_like" is
# chip_smoke.py's seeded dense case
WIDE_CASES = (("pair_a", "ratpair", False, 1024), ("pair_b", "ratpair_elliptic", False, 1024),
              ("pair_c", "ratpair_newton", False, 1024), ("pair_batched_a", "ratpair", True, 1024),
              ("rat_a", "rat", False, 2048), ("rodent_like", "rodent_like", True, 2048))
# the damped wide layout 1 (its own joint damping: the Euler tail's factor
# and substitutions), timed and digested with the seeded instances; "+arm"
# gives every env its own armature (chip_smoke.py's armature_draw)
DAMPED_CASES = (("rodent_standin_a", "rodent_standin", False, 2048),
                ("terrain_a", "rodent_standin_terrain", False, 2048),
                ("rodent_standin_arm_a", "rodent_standin+arm", False, 2048))
PAIR_OCCUPANCY_ENVS = (132, 528, 1024)
# the fly stand-in's files (the one-warp elliptic instance by the rule),
# timed on both cores by --warps
FLY_CASES = ("fly_standin", "fly_standin_tethered")
# the one-warp core past nv 16 (its panel sweep), timed and digested with the
# seeded instances
FLY_SEEDED = (("fly_standin_b", "fly_standin", False, 2048),
              ("fly_standin_tethered_b", "fly_standin_tethered", False, 2048),
              ("fly_standin_ball_b", "fly_standin_ball", False, 2048))
# nv of the dense case at 590 rows for the one-warp / wide comparison
EDGE_NV = (8, 12, 15, 16, 20, 24, 32, 36, 48, 71)
FACTOR_SIZES = (7, 10, 73, 144, 146)
SOLVE_SIZES = (7, 10, 73, 146)  # spd_solve, solve_batched and the inverses
OCCUPANCY_ENVS = (132, 528, 2048)
OCCUPANCY_CHOL = {73: (132, 792, 2048), 146: (132, 792, 2048)}
PROFILE_MARGIN_S = 0.05


def ptxas(root: str, name: str) -> dict:
    """ptxas's resource lines per function of ops/csrc/<name>: registers,
    stack frame and spill bytes (a device function that appears here was
    not inlined)."""
    src = os.path.join(root, "brax_tracking_tpu_torch", "ops", "csrc", name)
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    out = subprocess.run(
        [nvcc, "-O3", "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas", "-v", "-c", src,
         "-o", os.devnull],
        capture_output=True, text=True, timeout=600,
    ).stderr
    info, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            fn = m.group(1)
            info.setdefault(fn, {})
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m and fn:
                info[fn][key] = int(m.group(1))
    return info


def profile_device(fn, reps: int):
    """(name, device us) of every CUDA kernel and copy that ``reps`` calls
    of ``fn`` launch (after one warm call), from torch.profiler with idle
    time at both ends of the window (chip_smoke.py's PROFILE_MARGIN_S says
    why). Its own copy (scripts/stamp_solve_kernel.py shares it), so that it
    times an older tree's kernels the same way."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def wide_case(cs, model: str, dense: bool, B: int):
    """(launch args, keywords, dense) of a wide case at B envs, or None
    where the tree lacks its model file (or, for "<model>+arm", a per-env
    armature)."""
    if model == "rodent_like":
        args, kw = cs.rodent_like_case("cuda", B, cs.SEED)
        return args, kw, True
    model, arm = model.removesuffix("+arm"), model.endswith("+arm")
    try:
        _, args, kw = cs.solve_case("cuda", model, B, cs.SEED)
        if arm:
            args[13] = cs.armature_draw(args[13], B, cs.SEED)
    except (KeyError, AttributeError, FileNotFoundError):
        return None
    if dense:
        args, kw = cs.dense_case(args, kw)
    return args, kw, dense


def warps_sweep(cs, root: str, counts, reps: int) -> dict:
    """``--warps``: the wide core per warp count and against the one-warp
    core (see the module docstring)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.ops import library

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.join(here, "runs", "warps")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(root, "brax_tracking_tpu_torch", "ops", "csrc", "cg_fused.cu")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    builds = {}
    for w in counts:
        so = os.path.join(out_dir, f"libcg_w{w}.so")
        builds[w] = (so, subprocess.Popen(
            [nvcc, "-O3", "-gencode=arch=compute_90a,code=sm_90a", f"-DCG_WIDE_WARPS_L1={w}",
             f"-DCG_WIDE_WARPS_L2={w}", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
             "-o", so, src],
            stderr=subprocess.PIPE, text=True))
    library.build()
    own, own_warps = library._LIB, ops_cg.WIDE_WARPS
    report = {"ptxas": {}, "warps_us": {}, "edge_us": {}}
    cases = {key: wide_case(cs, model, dense, B) for key, model, dense, B in WIDE_CASES}
    last1 = cs.l2_edges()[0]
    cases["l1_last"] = tuple(cs.rodent_like_case(
        "cuda", 1024, cs.SEED, None, {"nv": last1, "nefc": cs.PAIR_ROWS, "nlim": 4})) + (True,)
    for w, (so, proc) in builds.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc with {w} warps per env failed:\n{err[-4000:]}")
        info, fn = {}, None
        for line in err.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
            if m:
                fn = m.group(1)
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores")):
                m = re.search(pat, line)
                if m and fn and f"Li{w}EE" in fn:
                    info.setdefault(fn, {})[key] = int(m.group(1))
        report["ptxas"][w] = info
        lib = ctypes.CDLL(so)
        for name in ("cg_fused_launch", "cg_batched_launch"):
            getattr(lib, name).argtypes = library._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        library._LIB, ops_cg.WIDE_WARPS = lib, {1: w, 2: w}
        try:
            report["warps_us"][w] = {
                key: min(device_us(cs.kernel_launch(c[0], c[1], c[2]),
                                   "cg_batched_kernel" if c[2] else "cg_fused_kernel", 5)
                         for _ in range(reps))
                for key, c in cases.items() if c is not None}
        finally:
            library._LIB, ops_cg.WIDE_WARPS = own, own_warps
        print(json.dumps({"warps": w, "us": report["warps_us"][w]}), flush=True)
    edge = {f"dense_nv{nv}": tuple(cs.rodent_like_case(
        "cuda", 2048, cs.SEED, None, {"nv": nv, "nefc": cs.PAIR_ROWS, "nlim": 4})) + (True,)
        for nv in EDGE_NV}
    edge["rat_a"], edge["rodent_like"] = cases["rat_a"], cases["rodent_like"]
    # the fly's (b), free and tethered: one warp by the rule, wide forced
    for model in FLY_CASES:
        edge[f"{model}_b"] = wide_case(cs, model, False, 2048)
    wide_above = ops_cg.WIDE_ABOVE_SMEM
    for key, c in edge.items():
        if c is None:
            continue
        tag = "cg_batched_kernel" if c[2] else "cg_fused_kernel"
        row = {}
        for core, above in (("one_warp", 10 ** 9), ("wide", 0)):
            ops_cg.WIDE_ABOVE_SMEM = above
            try:
                row[core] = min(device_us(cs.kernel_launch(c[0], c[1], c[2]), tag, 10)
                                for _ in range(reps))
            finally:
                ops_cg.WIDE_ABOVE_SMEM = wide_above
        report["edge_us"][key] = row
        print(json.dumps({"edge": key, "us": row}), flush=True)
    return report


def fly_wave(ops_cg, kargs, kw) -> int:
    """Envs of one full wave of a one-warp fused case: the blocks of its
    shared memory (ops/cg.py::kernel_layout) that fit an SM, times 132."""
    _, smem, _ = ops_cg.kernel_layout(kargs[0].shape[-1], kargs[4].shape[1], kargs[7].shape[1],
                                      len(kw["root_bounds"]), kargs[12].shape[0])
    return 132 * (ops_cg.H100_SMEM_PER_SM // (smem + ops_cg._SMEM_RESERVED_PER_BLOCK))


def digest(outs) -> dict:
    """The first 16 hex digits of the SHA-256 of each output's bytes (a dict
    of tensors, or one tensor as "out"), so two trees' outputs compare
    bitwise across runs."""
    if isinstance(outs, torch.Tensor):
        outs = {"out": outs}
    return {k: hashlib.sha256(v.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
            for k, v in outs.items()}


def device_us(fn, tag: str, reps: int = 20) -> float:
    """Mean device us per call of ``fn`` of the CUDA kernels whose name
    holds ``tag`` (profile_device). A profile that does not see exactly
    ``reps`` launches is taken once more; a second miss raises."""
    for _ in range(2):
        ts = [t for name, t in profile_device(fn, reps) if tag in name]
        if len(ts) == reps:
            return sum(ts) / reps
    raise RuntimeError(f"the profiler saw {len(ts)} launches of {tag} twice, expected {reps}")


def all_device_us(fn, reps: int = 20) -> float:
    """Mean device us per call of ``fn``: every CUDA kernel and copy the
    calls launch (profile_device); for a library call that launches
    several."""
    return sum(t for _, t in profile_device(fn, reps)) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seeded-only", action="store_true")
    ap.add_argument("--no-ptxas", action="store_true",
                    help="skip the ptxas report (a second run of the same tree)")
    ap.add_argument("--warps", default=None,
                    help="comma-separated warp counts of the wide core to sweep")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol
    from brax_tracking_tpu_torch.ops import library

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.warps:
        counts = [int(w) for w in args.warps.split(",")]
        print(json.dumps({"root": root, "card": cs.card_line()}
                         | warps_sweep(cs, root, counts, args.reps)))
        return 0
    library.build()
    csrc = os.path.join(root, "brax_tracking_tpu_torch", "ops", "csrc")
    report = {"root": root, "card": cs.card_line(),
              "ptxas": {} if args.no_ptxas else {
                  f: ptxas(root, f)
                  for f in ("cg_fused.cu", "cholesky.cu", "spd_inverse.cu", "spd_solve.cu")
                  if os.path.exists(os.path.join(csrc, f))}}
    seeded, digests = {}, {}
    for key, model, batched in SOLVE_CASES:
        _, kargs, kw = cs.solve_case("cuda", model, cs.B_MAIN, cs.SEED)
        if batched:
            kargs, kw = cs.dense_case(kargs, kw)
        launch = cs.kernel_launch(kargs, kw, batched)
        tag = "cg_batched_kernel" if batched else "cg_fused_kernel"
        seeded[key] = [device_us(launch, tag, 100) for _ in range(args.reps)]
        digests[key] = digest(launch())
    for key, model, dense, B in WIDE_CASES + DAMPED_CASES + FLY_SEEDED:
        case = wide_case(cs, model, dense, B)
        if case is not None:
            tag = "cg_batched_kernel" if case[2] else "cg_fused_kernel"
            launch = cs.kernel_launch(*case)
            seeded[key] = [device_us(launch, tag, 10) for _ in range(args.reps)]
            digests[key] = digest(launch()) | {"damped": bool(case[1]["has_damping"])}
    report["seeded_us"] = seeded
    keys = ("factor_us", "factor_library_us", "factor_library_device_us", "spd_solve_us",
            "spd_solve_library_device_us", "solve_us", "solve_library_device_us", "inverse_us",
            "inverse2_us", "inverse_library_device_us")
    chol = {k: {} for k in keys}
    reps = range(args.reps)
    for nv in sorted(set(FACTOR_SIZES) | set(SOLVE_SIZES)):
        M, b, damp = cs.spd_inputs("cuda", nv, cs.B_MAIN, cs.SEED + nv)
        if nv in FACTOR_SIZES:
            kern = lambda: ops_chol._launch_factor(M)
            lib = lambda: torch.linalg.cholesky(M)
            digests[f"factor_{nv}"] = digest(kern())
            chol["factor_us"][nv] = [device_us(kern, "factor_kernel") for _ in reps]
            chol["factor_library_us"][nv] = [cs.time_cuda(lib, 20) * 1e3 for _ in reps]
            chol["factor_library_device_us"][nv] = [all_device_us(lib) for _ in reps]
        if nv in SOLVE_SIZES:
            U = ops_chol.cholesky_factor_reference(M.double()).float().contiguous()
            kern = lambda: ops_chol._launch_solve(M, b)
            chol["spd_solve_us"][nv] = [device_us(kern, "spd_solve_kernel") for _ in reps]
            digests[f"spd_solve_{nv}"] = digest(kern())
            chol["spd_solve_library_device_us"][nv] = [
                all_device_us(lambda: torch.linalg.solve(M, b[..., None])) for _ in reps]
            kern = lambda: ops_chol._launch_solve_factor(U, b)
            chol["solve_us"][nv] = [device_us(kern, "solve_kernel") for _ in reps]
            digests[f"solve_{nv}"] = digest(kern())
            chol["solve_library_device_us"][nv] = [
                all_device_us(lambda: torch.cholesky_solve(b[..., None], U, upper=True))
                for _ in reps]
            chol["inverse_us"][nv] = [
                device_us(lambda: ops_chol.spd_inverse(M, device="cuda"), "spd_inverse")
                for _ in reps]
            chol["inverse2_us"][nv] = [
                device_us(lambda: ops_chol.spd_inverse2(M, damp, device="cuda"), "spd_inverse")
                for _ in reps]
            chol["inverse_library_device_us"][nv] = [
                all_device_us(lambda: torch.linalg.inv(M)) for _ in reps]
    report.update(chol)
    report["digest"] = digests
    occ = {}
    _, kargs, kw = cs.solve_case("cuda", "minirat", cs.B_MAIN, cs.SEED)
    for B in OCCUPANCY_ENVS:
        part = [t[:B] if t.shape[0] == cs.B_MAIN else t for t in kargs]
        launch = cs.kernel_launch([t.contiguous() for t in part], kw)
        occ[f"a/{B}"] = min(device_us(launch, "cg_fused_kernel", 100) for _ in range(args.reps))
    _, kargs, kw = cs.solve_case("cuda", "ratpair", max(PAIR_OCCUPANCY_ENVS), cs.SEED)
    for B in PAIR_OCCUPANCY_ENVS:
        part = [t[:B].contiguous() if t.shape[0] == max(PAIR_OCCUPANCY_ENVS) else t for t in kargs]
        launch = cs.kernel_launch(part, kw)
        occ[f"pair_a/{B}"] = min(device_us(launch, "cg_fused_kernel", 10) for _ in range(args.reps))
    for model in FLY_CASES:
        _, kargs, kw = cs.solve_case("cuda", model, cs.B_MAIN, cs.SEED)
        for B in (132, fly_wave(ops_cg, kargs, kw), cs.B_MAIN):
            part = [t[:B].contiguous() if t.shape[0] == cs.B_MAIN else t for t in kargs]
            launch = cs.kernel_launch(part, kw)
            occ[f"{model}_b/{B}"] = min(device_us(launch, "cg_fused_kernel", 10)
                                        for _ in range(args.reps))
    for nv, counts in OCCUPANCY_CHOL.items():
        M, b, damp = cs.spd_inputs("cuda", nv, cs.B_MAIN, cs.SEED + nv)
        U = ops_chol.cholesky_factor_reference(M.double()).float().contiguous()
        for B in counts:
            Mb, Ub, bb = M[:B].contiguous(), U[:B].contiguous(), b[:B].contiguous()
            for key, launch, tag in (
                    ("factor", lambda: ops_chol._launch_factor(Mb), "factor_kernel"),
                    ("spd_solve", lambda: ops_chol._launch_solve(Mb, bb), "spd_solve_kernel"),
                    ("solve", lambda: ops_chol._launch_solve_factor(Ub, bb), "solve_kernel"),
                    ("inverse", lambda: ops_chol.spd_inverse(Mb, device="cuda"), "spd_inverse"),
                    ("inverse2", lambda: ops_chol.spd_inverse2(Mb, damp, device="cuda"),
                     "spd_inverse")):
                occ[f"{key}{nv}/{B}"] = min(device_us(launch, tag) for _ in reps)
    report["occupancy_us"] = occ
    if args.seeded_only:
        print(json.dumps(report))
        return 0

    # the rollout, capturing the wrapper's inputs
    seen = {}
    wrapped = ops_cg.cg_solve_fused

    def capture(*a, **k):
        seen["args"], seen["kw"] = [t.clone() if isinstance(t, torch.Tensor) else t for t in a], k
        return wrapped(*a, **k)

    capture.launches = 0
    ops_cg.cg_solve_fused = capture
    env = cs.make_env("cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    state = env.reset(gen, cs.B_MAIN)
    act = lambda: 2.0 * torch.rand(cs.B_MAIN, env.action_size, generator=gen, device="cuda") - 1.0
    for _ in range(22):
        state = env.step(state, act())
    torch.cuda.synchronize()
    ops_cg.cg_solve_fused = wrapped
    r_args, r_kw = seen["args"], {k: v for k, v in seen["kw"].items() if k != "device"}
    launch = cs.kernel_launch([t.contiguous() for t in r_args], r_kw)
    rollout_inputs = [device_us(launch, "cg_fused_kernel", 100) for _ in range(args.reps)]

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            state = env.step(state, act())
        torch.cuda.synchronize()
    ts = [e.device_time_total for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "cg_fused_kernel" in e.name]
    print(json.dumps(report | {
        "rollout_inputs_us": rollout_inputs,
        "in_rollout_us": sum(ts) / len(ts), "in_rollout_launches": len(ts),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
