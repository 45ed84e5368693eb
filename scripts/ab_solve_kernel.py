"""Time the main path's solve kernel (cg_solve_fused on the minirat) alone
and inside the tracking rollout, for comparing two trees on one card.

    python3 scripts/ab_solve_kernel.py [--root DIR] [--reps 3] [--seeded-only]

``--root`` is the root of the tree to measure (default: this checkout); an
older commit unpacked elsewhere works as long as its chip_smoke.py has
``phase_kernel_vs_plain``, ``kernel_launch``, ``time_cuda``, ``make_env``
and ``card_line``. Alternate the trees in one call (parent, change, change,
parent) and compare only within it. Prints one JSON line:

- ``ptxas``: registers per thread, stack frame and spill bytes of each
  solve-kernel instance and of every device function left out of line, from
  ``nvcc -Xptxas -v`` on the tree's ``ops/csrc/cg_fused.cu``;
- ``seeded_us``: us per launch of the kernel alone (CUDA events around 200
  launches, ``--reps`` times) on chip_smoke.py's seeded contact states
  (2048 envs, the minirat's CG 4/4);
- ``rollout_inputs_us``: the same on the inputs of the last substep of 22
  control steps of the 2048-env tracking rollout (captured at the wrapper);
- ``in_rollout_us``: device us per launch from torch.profiler over 10
  control steps of that rollout (after the 22 above).

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


def ptxas(root: str) -> dict:
    """ptxas's resource lines per function of cg_fused.cu: registers, stack
    frame and spill bytes (a device function that appears here was not
    inlined)."""
    src = os.path.join(root, "brax_tracking_tpu_torch", "ops", "csrc", "cg_fused.cu")
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    out = subprocess.run(
        [nvcc, "-O3", "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas", "-v", "-c", src,
         "-o", os.devnull],
        capture_output=True, text=True, timeout=600,
    ).stderr
    info, name = {}, None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            info.setdefault(name, {})
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m and name:
                info[name][key] = int(m.group(1))
    return info


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
    from brax_tracking_tpu_torch.ops import library

    torch.backends.cuda.matmul.allow_tf32 = False
    library.build()
    _, (_, kargs, kw, _) = cs.phase_kernel_vs_plain("cuda", cs.B_MAIN, False, cs.SEED)
    launch = cs.kernel_launch(kargs, kw)
    seeded = [cs.time_cuda(launch, 200) * 1e3 for _ in range(args.reps)]
    report = {"root": root, "card": cs.card_line(), "ptxas": ptxas(root), "seeded_us": seeded}
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
    rollout_inputs = [cs.time_cuda(launch, 200) * 1e3 for _ in range(args.reps)]

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
