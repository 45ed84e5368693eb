"""The readings that the limits of ``correct`` are set from, on the card at a
cell's own sizes (the benchmark's runs do not run this):

    python3 portbench/readings.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each seed the program's first training step is compared with
the float64 reference, as a run's check compares them (the sound
reading). For each control seed, the control: the reference put in the
program's place on the card in float32 with TF32 matrix products, the
step below the configuration's float32. For each fault seed, the program
with each fault planted that a training cell on one card can have:

- ``unchanged``: a step that leaves the parameters where they were (the
  program's learning rate 0);
- ``half``: every mean over the batch taken over half of it (the loss
  over each minibatch's rows, the normalizer over the unroll's);
- ``altered``: the env's observations and rewards altered by one part in
  a thousand where they are produced.

The lowest reading of the control (or of a fault) that is three (ten)
times the highest sound reading bounds a limit from above. Prints one JSON
object, and writes it to ``--out``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

FAULTS = ("unchanged", "half", "altered")
ALTER = 1e-3


def halve(loss_fn):
    """The loss over the first half of each minibatch's rows."""

    def loss(net, norm, data, eps, **kw):
        n = eps.shape[0] // 2
        return loss_fn(net, norm, data.map(lambda x: x[:n]), eps[:n], **kw)

    return loss


def alter(env):
    """The env with its observations and rewards scaled by 1 + ALTER."""
    from brax_tracking_tpu_torch.envs.base import Wrapper

    class Altered(Wrapper):
        def _after_reset(self, state):
            return state.replace(obs=state.obs * (1 + ALTER))

        def step(self, state, action):
            s = self.env.step(state, action)
            return s.replace(obs=s.obs * (1 + ALTER), reward=s.reward * (1 + ALTER))

    return Altered(env)


@contextlib.contextmanager
def planted(fault):
    """Inside the block, ``harness.Program`` builds the program with
    ``fault`` planted (None: as it is). ``half`` takes every mean over the
    batch over half of it: the loss's over each minibatch and the
    normalizer's over the unroll."""
    from brax_tracking_tpu_torch.training import running_statistics

    from portbench import harness

    real, update = harness.Program, running_statistics.update

    def program(config, traffic, seed, device, tmpdir):
        if fault == "unchanged":
            return real(dict(config, learning_rate=0.0), traffic, seed, device, tmpdir)
        return real(config, traffic, seed, device, tmpdir,
                    loss_wrap=halve if fault == "half" else None,
                    env_wrap=alter if fault == "altered" else None)

    harness.Program = program
    if fault == "half":
        running_statistics.update = lambda state, batch, *a, **k: update(
            state, batch[:batch.shape[0] // 2], *a, **k)
    try:
        yield
    finally:
        harness.Program, running_statistics.update = real, update


def reading(fault, config, traffic, seed, device, control=False):
    """The numbers of one seed: the program's (with ``fault``), and with
    ``control`` the control's too, each against the float64 reference."""
    import torch

    from portbench import check, harness, learner

    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        with planted(fault):
            cap = check.capture_first_steps(
                harness.Program(config, traffic, seed, device, tmpdir))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    ref = check.reference_outputs(cap, config, traffic, device=device)
    prog = check.program_outputs(cap)
    out = {"program": check.numbers(prog, ref)}
    if fault is None:
        # the look behind the change's comparison: each leaf's change gap,
        # and the share of its elements whose first reference gradient is
        # within 10x of Adam's eps, where the step is g / (|g| + eps)
        out["leaves"] = {
            "change_gaps": check.leaf_gaps(prog["change3"], ref["change3"]).tolist(),
            "moving": check.moving_leaves(ref).tolist(),
            "near_eps": [float((g.abs() < 10 * learner.ADAM_EPS).double().mean())
                         for g in ref["grad1"]],
            "shapes": [list(g.shape) for g in ref["grad1"]]}
    if control:
        ctl = check.reference_outputs(cap, config, traffic, device=device,
                                      dtype=torch.float32, tf32=True)
        out["control"] = check.numbers(ctl, ref)
    return out


def summary(out):
    """Per number: the highest sound reading, and the lowest of the
    control and of each fault."""
    sound = [r["program"] for r in out["sound"].values()]
    res = {}
    for k in sound[0]:
        row = {"lower": max(r[k] for r in sound)}
        ctl = [r["control"][k] for r in out["sound"].values() if "control" in r]
        if ctl:
            row["control_min"] = min(ctl)
        for f, rs in out["faults"].items():
            if rs:
                row[f"{f}_min"] = min(r["program"][k] for r in rs.values())
        res[k] = row
    return res


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", choices=FAULTS, default=list(FAULTS),
                    help="the faults to plant (unchanged reads 1 by its measure and needs no run)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise harness.SetupError("the readings need a CUDA card")
    from brax_tracking_tpu_torch.ops import library

    _, _, traffic, config = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    library.build()
    out = {"workload": args.workload, "card": harness.card_line(torch, device),
           "sound": {}, "faults": {f: {} for f in FAULTS}, "seconds": {}}
    t0 = time.perf_counter()
    for seed in args.seeds:
        t = time.perf_counter()
        out["sound"][seed] = reading(None, config, traffic, seed, device,
                                     control=seed in args.control_seeds)
        out["seconds"][f"sound {seed}"] = time.perf_counter() - t
        print(json.dumps({"seed": seed, **out["sound"][seed]}), file=sys.stderr, flush=True)
    for seed in args.fault_seeds:
        for f in args.faults:
            t = time.perf_counter()
            out["faults"][f][seed] = reading(f, config, traffic, seed, device)
            out["seconds"][f"{f} {seed}"] = time.perf_counter() - t
            print(json.dumps({"seed": seed, "fault": f, **out["faults"][f][seed]}),
                  file=sys.stderr, flush=True)
    out["summary"] = summary(out)
    out["seconds"]["all"] = time.perf_counter() - t0
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps(out["summary"]))
    return 0


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.dirname(here))
    sys.exit(main())
