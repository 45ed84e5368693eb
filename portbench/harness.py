"""One run of one benchmark cell: set-up, the measured window, the traced
steps, the comparison that decides ``correct``, and the result line.

Everything that belongs to one configuration, one cell or one per-layer
metric is data found by name: ``configs/<config>.json`` (the model file
and the PPO settings as run), ``workloads/<cell>.json`` (envs,
randomization, the check's sample and limits) and ``metrics/<name>.py``
(a reader of the traced steps). This module holds nothing specific to
any of them.

The program under test is the port's PPO training step, called as
``agents/ppo/train.py::train`` calls it in ``run_one_epoch``:
``rollout_draws`` -> ``rollout_step`` -> ``learn_draws`` -> ``learn_step``,
each half through ``training/debug_nans.call`` with the mode off. The
benchmark makes every input from ``--seed``: the initial env states, the
network weights, the action noise, the permutations, the entropy noise and
the per-env model draws.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "brax_tracking_tpu", "chip_smoke",
             "scripts")


class SetupError(RuntimeError):
    """The run cannot start: no card, too few cards, or a cell not found."""


def forbidden_modules(names) -> List[str]:
    """The module names whose top-level name (the part before the first
    dot), compared whole, is one of ``FORBIDDEN``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws, from any whole ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**128, stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# draw streams of one run
S_WEIGHTS, S_START, S_TRAIN, S_RANDOMIZE, S_SAMPLE = range(5)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str):
    """(BENCHMARK.json, its workload entry, the cell's traffic, its
    configuration), found by the cell's name."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SetupError(f"no workload {name!r} in BENCHMARK.json")
    traffic = load_json(HERE, "workloads", f"{entries[0]['name']}.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT, configs[entries[0]["config"]]["file"])
    return bench, entries[0], traffic, config


def model_file(config) -> str:
    return os.path.join(HERE, "configs", config["model_file"])


def episode_length(config) -> int:
    """``harness/driver.py``'s rule: (clip_length - 50 - ref_traj_length) control
    steps per mocap frame's worth of substeps."""
    with np.load(model_file(config)) as z:
        timestep = float(z["opt_timestep"])
    ds, n_frames = config["dataset"], config["env_args"]["physics_steps_per_control_step"]
    steps_per_frame = round(1.0 / (ds["mocap_hz"] * timestep)) // n_frames
    return (ds["clip_length"] - 50 - ds["ref_traj_length"]) * steps_per_frame


@dataclasses.dataclass
class Geometry:
    """The shapes of one training step."""

    envs: int
    n_unrolls: int
    unroll: int
    updates: int
    minibatches: int
    rows: int
    env_steps: int  # per training step
    substeps: int  # per control step


def geometry(config, traffic) -> Geometry:
    envs, mb = traffic["num_envs"], traffic["num_minibatches"]
    batch, T = config["batch_size"], config["unroll_length"]
    if (batch * mb) % envs:
        raise SetupError("batch_size * num_minibatches must divide by num_envs")
    n_unrolls = batch * mb // envs
    return Geometry(envs=envs, n_unrolls=n_unrolls, unroll=T,
                    updates=config["num_updates_per_batch"], minibatches=mb,
                    rows=n_unrolls * envs,
                    env_steps=mb * batch * T * config["action_repeat"],
                    substeps=config["env_args"]["physics_steps_per_control_step"])


# ---------------------------------------------------------------------------
# inputs made from the seed
# ---------------------------------------------------------------------------


def initial_weights(sizes, seed, device, torch):
    """LeCun-uniform weights (+-sqrt(3 / fan_in)), zero biases, of an MLP
    of ``sizes``, drawn on ``device``: [(W (out, in), b (out,)), ...]."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        bound = (3.0 / n_in) ** 0.5
        w = torch.rand((n_out, n_in), generator=g, device=device) * (2.0 * bound) - bound
        out.append((w, torch.zeros(n_out, device=device)))
    return out


def start_draws(config, envs, seed, device, torch):
    """Each env's start frame, qpos (qpos0 plus uniform noise) and qvel
    (uniform noise), float32, the tracking env's reset rule."""
    with np.load(model_file(config)) as z:
        qpos0 = torch.as_tensor(z["qpos0"], dtype=torch.float32, device=device)
        nv = int(z["nv"])
    lo, hi = config["reset"]["start_frame_range"]
    s = config["reset"]["noise_scale"]
    g = torch.Generator(device=device).manual_seed(seed)
    frame = torch.randint(lo, hi, (envs,), generator=g, device=device).to(torch.int32)
    qpos = qpos0 + (-s + 2 * s * torch.rand(envs, qpos0.shape[0], generator=g, device=device))
    qvel = -s + 2 * s * torch.rand(envs, nv, generator=g, device=device)
    return frame, qpos, qvel


def randomization_scales(spec, shapes, envs, seed, device, torch):
    """Per-env factors in 1 +- spread, one draw per env and leaf element
    shape ``(envs,) + (1,) * leaf.dim()``: the ``scaled`` randomization."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in spec["leaves"]:
        u = torch.rand((envs,) + (1,) * len(shapes[name]), generator=g, device=device)
        out[name] = 1.0 + spec["spread"] * (2.0 * u - 1.0)
    return out


def scaled_randomization(M, scales):
    """A ``randomization_fn`` for ``DomainRandomizationVmapWrapper`` (of
    the model module ``M``) that scales each leaf by its per-env factors."""

    def randomize(model):
        values = {n: model.leaf(n) * s.to(model.leaf(n).dtype) for n, s in scales.items()}
        return M.replace_leaves(model, values), values.keys()

    return randomize


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------


class Program:
    """The port's training step at a cell's sizes, built through its public
    API, with the state it carries from step to step."""

    def __init__(self, config, traffic, seed, device, tmpdir, loss_wrap=None,
                 env_wrap=None):
        import torch

        from brax_tracking_tpu_torch.agents.ppo import losses, networks
        from brax_tracking_tpu_torch.agents.ppo import train as ppo_train
        from brax_tracking_tpu_torch.envs import wrappers
        from brax_tracking_tpu_torch.harness.driver import build_env_from_cfg
        from brax_tracking_tpu_torch.physics import model as M
        from brax_tracking_tpu_torch.training import debug_nans, gradients, running_statistics

        self.torch, self.ppo, self.debug_nans = torch, ppo_train, debug_nans
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.geo = geo = geometry(config, traffic)
        cfg = {
            "dataset": dict(config["dataset"], stac_path="",
                            env_args=dict(config["env_args"], mjcf_path=model_file(config))),
            "train": {"env_name": config["env_name"]},
            "paths": {"data_dir": tmpdir},
        }
        base_env = build_env_from_cfg(cfg, device=device)
        self.dtype = base_env.model.dtype
        self.scales = None
        rand_fn = None
        if traffic.get("randomization"):
            shapes = {n: tuple(base_env.model.leaf(n).shape)
                      for n in traffic["randomization"]["leaves"]}
            self.scales = randomization_scales(traffic["randomization"], shapes, geo.envs,
                                               sub_seed(seed, S_RANDOMIZE), device, torch)
            rand_fn = scaled_randomization(M, self.scales)
        self.env = wrappers.wrap(base_env, episode_length=episode_length(config),
                                 action_repeat=config["action_repeat"],
                                 randomization_fn=rand_fn)
        if env_wrap is not None:
            self.env = env_wrap(self.env)
        frame, qpos, qvel = start_draws(config, geo.envs, sub_seed(seed, S_START), device, torch)
        self.start = (frame, qpos.to(self.dtype), qvel.to(self.dtype))
        self.env_state = self.env.init_state(*self.start)
        obs_size, self.action_size = self.env_state.obs.shape[-1], self.env.action_size

        preprocess = (networks.normalize_preprocessor if config["normalize_observations"]
                      else networks.identity_preprocessor)
        self.net = networks.make_ppo_networks(
            obs_size, self.action_size, preprocess_observations_fn=preprocess,
            policy_hidden_layer_sizes=tuple(config["policy_hidden_layer_sizes"]),
            value_hidden_layer_sizes=tuple(config["value_hidden_layer_sizes"]),
            generator=torch.Generator(device=device).manual_seed(0), device=device,
            dtype=self.dtype)
        self.weights = []
        for i, mlp in enumerate((self.net.policy, self.net.value)):
            sizes = [mlp.layers[0].in_features] + [layer.out_features for layer in mlp.layers]
            ws = initial_weights(sizes, sub_seed(seed, S_WEIGHTS) + i, device, torch)
            with torch.no_grad():
                for layer, (w, b) in zip(mlp.layers, ws):
                    layer.weight.copy_(w)
                    layer.bias.copy_(b)
            self.weights.append(ws)
        self.make_policy = networks.make_inference_fn(self.net)
        loss_fn = functools.partial(
            losses.compute_ppo_loss, entropy_cost=config["entropy_cost"],
            discounting=config["discounting"], reward_scaling=config["reward_scaling"],
            gae_lambda=config["gae_lambda"], clipping_epsilon=config["clipping_epsilon"],
            normalize_advantage=config["normalize_advantage"])
        self.loss_fn = loss_wrap(loss_fn) if loss_wrap else loss_fn
        self.ts = ppo_train.TrainingState(
            params=self.net,
            optimizer=gradients.make_optimizer(self.net.parameters(), config["learning_rate"]),
            normalizer_params=running_statistics.init_state(
                torch.zeros(obs_size, dtype=self.dtype, device=device)),
            env_steps=0)
        self.generator = torch.Generator(device=device).manual_seed(sub_seed(seed, S_TRAIN))

    def rollout(self, eps=None):
        """The acting half; returns (eps, data, normalizer)."""
        g = self.geo
        if eps is None:
            eps = self.ppo.rollout_draws(self.generator, g.n_unrolls, g.unroll, g.envs,
                                         self.action_size, self.dtype)
        self.env_state, data, norm = self.debug_nans.call(
            "rollout_step", self.ppo.rollout_step, self.env, self.make_policy, self.ts,
            self.env_state, eps, None)
        return eps, data, norm

    def learn(self, data, norm):
        """The learner half; returns (perms, entropy noise, loss metrics)."""
        g = self.geo
        perms, ent = self.ppo.learn_draws(self.generator, g.updates, g.minibatches, g.rows,
                                          g.unroll, self.action_size, self.dtype)
        self.ts, metrics = self.debug_nans.call(
            "learn_step", self.ppo.learn_step, self.ts, data, norm, perms, ent, self.loss_fn,
            g.env_steps, None)
        return perms, ent, metrics

    def step(self):
        """One training step; returns a device flag, true where every output
        (observations, rewards, loss metrics) is finite."""
        torch = self.torch
        _, data, norm = self.rollout()
        _, _, metrics = self.learn(data, norm)
        return torch.stack([torch.isfinite(data.observation).all(),
                            torch.isfinite(data.reward).all()]
                           + [torch.isfinite(v).all() for v in metrics.values()]).all()


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def card_line(torch, device) -> Dict:
    """The card's name, and its power limit as nvidia-smi reads it."""
    if device.type != "cuda":
        return {"kind": "cpu", "power_limit_w": None}
    kind = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", str(device.index)],
                             capture_output=True, text=True, timeout=30, check=True)
        power = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        power = None
    return {"kind": kind, "power_limit_w": power}


def cell_metrics(bench):
    """(end-to-end, per-layer) metrics of a cell: every one of each."""
    return bench["end_to_end"], bench["per_layer"]


def load_reader(name):
    """``metrics/<name>.py``'s ``read``."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window(program, seconds, sync):
    """Whole training steps until ``seconds`` have passed: one synchronize
    at the start and one after the last step; nothing in between reads the
    card. Returns (steps, failed steps, seconds)."""
    torch = program.torch
    flags = []
    sync()
    t0 = time.perf_counter()
    while True:
        flags.append(program.step())
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    dt = time.perf_counter() - t0
    failed = int((~torch.stack(flags)).sum().item())
    return len(flags), failed, dt


def traced_steps(program, traffic, config, sync):
    """Per-layer readings: ``span_steps`` training steps with the collect
    and learn halves timed on the host clock (each ending in a
    synchronize), then ``trace_steps`` whole training steps under
    torch.profiler with the benchmark's spans around its calls into the
    trainer. Returns (the run the metric readers take, steps, failed)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import devtrace

    torch = program.torch
    spans = {"collect": [], "learn": []}
    flags = []
    for _ in range(traffic["span_steps"]):
        sync()
        t0 = time.perf_counter()
        _, data, norm = program.rollout()
        sync()
        t1 = time.perf_counter()
        _, _, metrics = program.learn(data, norm)
        sync()
        spans["collect"].append(t1 - t0)
        spans["learn"].append(time.perf_counter() - t1)
        flags.append(_finite(torch, data, metrics))
    n = traffic["trace_steps"]
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function(devtrace.SPAN_PREFIX + "collect"):
                _, data, norm = program.rollout()
            with record_function(devtrace.SPAN_PREFIX + "learn"):
                _, _, metrics = program.learn(data, norm)
            flags.append(_finite(torch, data, metrics))
        sync()
        wall = time.perf_counter() - t0
    t_parse = time.perf_counter()
    geo = program.geo
    run = devtrace.Run(
        events=devtrace.collect(prof), wall_s=wall, training_steps=n,
        control_steps=n * geo.n_unrolls * geo.unroll,
        substeps=n * geo.n_unrolls * geo.unroll * geo.substeps,
        env_steps=n * geo.env_steps, geometry=geo, config=config, traffic=traffic,
        model_file=model_file(config), obs_size=program.env_state.obs.shape[-1],
        action_size=program.action_size, host_spans=spans,
        unprofiled_step_s=[c + le for c, le in zip(spans["collect"], spans["learn"])])
    run.parse_s = time.perf_counter() - t_parse
    return run, len(flags), sum(1 for f in flags if not f)


def _finite(torch, data, metrics) -> bool:
    return bool(torch.isfinite(data.observation).all()) and bool(
        torch.isfinite(data.reward).all()) and all(
        bool(torch.isfinite(v).all()) for v in metrics.values())


def run_cell(args, device, t_start, bench, entry, traffic, config) -> Dict:
    """One run of a cell on ``device`` (the card; the tests' CPU): set-up,
    the window or the traced steps, the check. Returns the result line."""
    import torch

    from portbench import check

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    if device.type == "cuda":
        from brax_tracking_tpu_torch.ops import library

        torch.cuda.set_device(device)
        library.build()
    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        program = Program(config, traffic, args.seed, device, tmpdir)
        capture = check.capture_first_steps(program)
        sync()
        setup_s = time.perf_counter() - t_start
        if args.trace:
            trace, attempted, failed = traced_steps(program, traffic, config, sync)
        else:
            attempted, failed, window_s = window(program, args.seconds, sync)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        card = card_line(torch, device)
        del program
        if device.type == "cuda":
            torch.cuda.empty_cache()
        values, contacts = check.compare(capture, config, traffic, device)
        judged = check.judge(values, traffic.get("limits", {}))
        print(f"portbench: the most contact rows carrying a force in the compared step in one "
              f"sampled env: {contacts}", file=sys.stderr)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    e2e, per_layer = cell_metrics(bench)
    metrics = {}
    if args.trace:
        for m in per_layer:
            value = load_reader(m["name"])(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        readings = {"train_sps": attempted * geometry(config, traffic).env_steps / window_s,
                    "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": readings[m["name"]], "unit": m["unit"]}
    device_line = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": card["kind"],
                   "count": entry["chips"], "memory_peak_bytes": int(peak),
                   "power_limit_w": card["power_limit_w"]}
    result = {"correct": all(ok for _, _, ok in judged.values()), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_line}
    if args.trace:
        device_line.update(busy_s=trace.busy_s, window_s=trace.wall_s)
        result["breakdown"] = trace.breakdown()
        print(f"portbench trace: unprofiled training steps {trace.unprofiled_step_s} s, "
              f"profiled {trace.wall_s / trace.training_steps} s each, trace read in "
              f"{trace.parse_s} s", file=sys.stderr)
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim, _) in judged.items()}
    return result


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(description="one run of one benchmark cell of the port")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start=None) -> int:
    """The command: one run of one cell on the card; the result as the
    last line of standard output, each compared number beside its limit as
    the last lines of standard error."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    bench, entry, traffic, config = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        raise SetupError("torch.cuda.is_available() is false: the benchmark needs CUDA cards")
    if torch.cuda.device_count() < entry["chips"]:
        raise SetupError(f"{torch.cuda.device_count()} CUDA cards; {args.workload} needs "
                         f"{entry['chips']}")
    result = run_cell(args, torch.device("cuda", 0), t_start, bench, entry, traffic, config)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: modules loaded that no run may hold: {bad}", file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
