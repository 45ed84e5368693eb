"""Time the solve kernel's instances and the Cholesky factor, for comparing
two trees on one card.

    python3 scripts/ab_solve_kernel.py [--root DIR] [--reps 3] [--seeded-only]

``--root`` is the root of the tree to measure (default: this checkout); an
older commit unpacked elsewhere works as long as its chip_smoke.py has
``solve_case``, ``dense_case``, ``kernel_launch``, ``time_cuda``,
``spd_inputs``, ``make_env`` and ``card_line``. Alternate
the trees in one call (parent, change, change, parent) and compare only
within it. Prints one JSON line:

- ``ptxas``: registers per thread, stack frame and spill bytes of every
  kernel instance (and of every device function left out of line) of the
  tree's ``ops/csrc/cg_fused.cu`` and ``cholesky.cu``, from
  ``nvcc -Xptxas -v``;
- ``seeded_us``: device us per launch of each solve-kernel instance alone
  (torch.profiler over 100 launches, ``--reps`` times: the host's launch
  path takes about as long as a launch now, so CUDA events around a loop
  of launches would time the host; 2048 envs at chip_smoke.py's seeded
  contact states): ``cg_solve_fused`` (a) on the minirat (CG 4/4),
  (b) on the elliptic minirat, (c) on a Newton chunk (warmstart, stall
  exit, 16 line-search steps), and ``cg_solve_batched`` on the dense qM and
  J of (a) and (b);
- ``factor_us`` / ``spd_solve_us``: device us per launch (torch.profiler,
  ``--reps`` runs of 20 launches) of ``factor_batched`` at nv 7, 10, 73,
  144 (the widest on 128 threads) and 146 and of ``spd_solve`` at 7, 73 and 146 on seeded SPD matrices (2048),
  and ``factor_library_us`` (CUDA events) of ``torch.linalg.cholesky`` on
  the same matrices;
- ``occupancy_us``: device us per launch of (a) on the first 132 (one env
  per SM), 528 and 2048 of those envs, and of ``factor_batched`` at nv 73
  and 146 on 132, 792 and 2048 matrices: a time that stays flat as
  the launch fills the card is one block's chain of dependent steps, a time
  that grows with it is a shared resource;
- ``rollout_inputs_us``: (a)'s device us on the inputs of the last substep of 22
  control steps of the 2048-env tracking rollout (captured at the wrapper);
- ``in_rollout_us``: device us per launch of (a) from torch.profiler over
  10 control steps of that rollout (after the 22 above).

``--seeded-only`` skips the rollout (the last two).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

SOLVE_CASES = (("a", "minirat", False), ("b", "minirat_elliptic", False),
               ("c", "minirat_newton", False), ("batched_a", "minirat", True),
               ("batched_b", "minirat_elliptic", True))
FACTOR_SIZES = (7, 10, 73, 144, 146)
SPD_SOLVE_SIZES = (7, 73, 146)
OCCUPANCY_ENVS = (132, 528, 2048)
OCCUPANCY_FACTOR = {73: (132, 792, 2048), 146: (132, 792, 2048)}


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


def device_us(fn, tag: str, reps: int = 20) -> float:
    """Mean device us per call of ``fn`` of the CUDA kernels whose name
    holds ``tag`` (torch.profiler). The profiler drops an event now and
    then, so a profile that does not see exactly ``reps`` launches is taken
    once more; a second miss raises. Its own copy
    (scripts/stamp_solve_kernel.py shares it), so that it times an older
    tree's kernels the same way."""
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
            return sum(ts) / reps
    raise RuntimeError(f"the profiler saw {len(ts)} launches of {tag} twice, expected {reps}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seeded-only", action="store_true")
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
    library.build()
    report = {"root": root, "card": cs.card_line(),
              "ptxas": {f: ptxas(root, f) for f in ("cg_fused.cu", "cholesky.cu")}}
    seeded = {}
    for key, model, batched in SOLVE_CASES:
        _, kargs, kw = cs.solve_case("cuda", model, cs.B_MAIN, cs.SEED)
        if batched:
            kargs, kw = cs.dense_case(kargs, kw)
        launch = cs.kernel_launch(kargs, kw, batched)
        tag = "cg_batched_kernel" if batched else "cg_fused_kernel"
        seeded[key] = [device_us(launch, tag, 100) for _ in range(args.reps)]
    report["seeded_us"] = seeded
    factor, lib, spd = {}, {}, {}
    for nv in sorted(set(FACTOR_SIZES) | set(SPD_SOLVE_SIZES)):
        M, b, _ = cs.spd_inputs("cuda", nv, cs.B_MAIN, cs.SEED + nv)
        if nv in FACTOR_SIZES:
            kern = lambda: ops_chol._launch_factor(M)
            factor[nv] = [device_us(kern, "factor_kernel") for _ in range(args.reps)]
            lib[nv] = [cs.time_cuda(lambda: torch.linalg.cholesky(M), 20) * 1e3
                       for _ in range(args.reps)]
        if nv in SPD_SOLVE_SIZES:
            kern = lambda: ops_chol._launch_solve(M, b)
            spd[nv] = [device_us(kern, "spd_solve_kernel") for _ in range(args.reps)]
    report.update(factor_us=factor, factor_library_us=lib, spd_solve_us=spd)
    occ = {}
    _, kargs, kw = cs.solve_case("cuda", "minirat", cs.B_MAIN, cs.SEED)
    for B in OCCUPANCY_ENVS:
        part = [t[:B] if t.shape[0] == cs.B_MAIN else t for t in kargs]
        launch = cs.kernel_launch([t.contiguous() for t in part], kw)
        occ[f"a/{B}"] = min(device_us(launch, "cg_fused_kernel", 100) for _ in range(args.reps))
    for nv, counts in OCCUPANCY_FACTOR.items():
        M, _, _ = cs.spd_inputs("cuda", nv, cs.B_MAIN, cs.SEED + nv)
        for B in counts:
            Mb = M[:B].contiguous()
            occ[f"factor{nv}/{B}"] = min(
                device_us(lambda: ops_chol._launch_factor(Mb), "factor_kernel")
                for _ in range(args.reps))
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
