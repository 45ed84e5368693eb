"""The comparison that decides ``correct``.

The set-up drives the program's training step from the seed through its
first training step, through the window's own calls, and keeps what it
produced (``capture_first_steps``); the window then runs on from the same
objects. Once the window has closed and the program's state is freed, the
plain reference works the same step out again from the same inputs, in
float64 on the run's device, and ``numbers`` sets the two side by side.
The reference is the benchmark's own for the policy, the normalizer and
the learner (``portbench/learner.py``, written from the published
algorithm), and a frozen copy of the port's plain engine for the env
(``portbench/ref``; ``tests/test_portbench_ref_jax.py`` holds it against
the JAX package's engine). Compared:

- the env control step (physics, the solve, the tracking observation and
  reward): the reset of a sample of envs from the benchmark's start draws
  and their first control step from there, with the program's action;
- the policy's actions: the pre-tanh action and its log-probability of a
  sample of (row, step) pairs of the first unroll, from the observation
  and the benchmark's action noise, with the initial weights;
- the observation normalizer the first unroll updates: its mean and std
  against the reference's from the same observations;
- the learner's update: the loss of each of the first three Adam steps,
  the first gradient as Adam holds it after one step (its first moment
  over 1 - b1) by the worst leaf, and the change after three steps by
  the median leaf, from the first unroll's transitions and the program's normalizer, the
  benchmark's permutation and entropy noise.

The learner follows the program step by step from the program's own
outputs (the first unroll's transitions and normalizer); the start of
those (the reset, the first control step, the actions, the normalizer)
is checked by itself. No constraint row carries a force in the compared
control step (the bodies start above the floor; the run prints the count).
A control step in contact is not compared: the capped CG solve (4
iterations, 4 line-search steps) amplifies a change in its inputs
10^3-10^5-fold in one control step, so float32 against float64 reads O(1)
there for the program and the control alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List

import numpy as np

from portbench import harness, learner

# a leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by rounding alone: it is left out of the change
STILL_LEAF = 1e-3


def _cpu(t):
    return t.detach().to("cpu")


@dataclasses.dataclass
class Capture:
    """What the program's first training step produced, on the host, with
    the benchmark's inputs that made it."""

    weights: list  # [policy, value]: [(W, b), ...]
    start: tuple  # (frame, qpos, qvel) of every env
    scales: dict  # per-env randomization factors, or None
    env_idx: object  # sampled envs
    obs_all: object  # the first unroll's observations (rows, T, obs)
    learn_rows: dict  # the first three minibatches' transitions
    entropy_eps: object  # (3, rows, T, A)
    normalizer: dict  # the program's observation statistics after the first unroll
    losses: object  # the program's first three losses
    grad1: list  # per leaf: Adam's first moment after one step / (1 - b1)
    params3: list  # per leaf: the parameters after three steps
    policy: dict  # sampled (row, t): obs, eps, raw_action, log_prob
    step: dict  # the sampled envs' reset and first control step: action, outputs


def capture_first_steps(program) -> Capture:
    """Runs the program's first training step, which warms every shape the
    window runs, and keeps what the reference needs."""
    torch, geo = program.torch, program.geo
    g = torch.Generator().manual_seed(harness.sub_seed(program.seed, harness.S_SAMPLE))
    n_env = min(program.traffic["check"]["env_sample"], geo.envs)
    env_idx = torch.randperm(geo.envs, generator=g)[:n_env].sort().values
    n_pol = program.traffic["check"]["policy_rows"]
    pol_rows = torch.randint(0, geo.rows, (n_pol,), generator=g).to(program.device)
    pol_t = torch.randint(0, geo.unroll, (n_pol,), generator=g).to(program.device)
    dev_idx = env_idx.to(program.device)

    params = [q for grp in program.ts.optimizer.param_groups for q in grp["params"]]
    snaps: Dict[str, list] = {"n": [0]}

    def hook(opt, args, kwargs):
        snaps["n"][0] += 1
        if snaps["n"][0] == 1:
            snaps["m1"] = [_cpu(opt.state[q]["exp_avg"]).clone() for q in params]
        if snaps["n"][0] == 3:
            snaps["p3"] = [_cpu(q).clone() for q in params]

    handle = program.ts.optimizer.register_step_post_hook(hook)
    try:
        eps1, data1, norm1 = program.rollout()
        perms, ent, metrics = program.learn(data1, norm1)
    finally:
        handle.remove()
    mb = geo.rows // geo.minibatches
    rows = perms[0, :3 * mb]
    learn_rows = {
        "observation": data1.observation[rows], "next_observation": data1.next_observation[rows],
        "reward": data1.reward[rows], "discount": data1.discount[rows],
        "truncation": data1.extras["state_extras"]["truncation"][rows],
        "raw_action": data1.extras["policy_extras"]["raw_action"][rows],
        "log_prob": data1.extras["policy_extras"]["log_prob"][rows],
    }
    # rows are unroll * envs + env: the first unroll's rows are the envs in order
    pe = data1.extras["policy_extras"]
    policy = {"obs": data1.observation[pol_rows, pol_t],
              "eps": eps1[pol_rows // geo.envs, pol_t, pol_rows % geo.envs],
              "raw_action": pe["raw_action"][pol_rows, pol_t],
              "log_prob": pe["log_prob"][pol_rows, pol_t]}
    step = {"reset_obs": data1.observation[dev_idx, 0],
            "raw_action": pe["raw_action"][dev_idx, 0],
            "obs": data1.observation[dev_idx, 1], "reward": data1.reward[dev_idx, 0],
            "discount": data1.discount[dev_idx, 0]}
    host = lambda d: {k: _cpu(v) for k, v in d.items()}
    return Capture(
        weights=[[(_cpu(w), _cpu(b)) for w, b in ws] for ws in program.weights],
        start=tuple(_cpu(t) for t in program.start),
        scales=None if program.scales is None else {k: _cpu(v)
                                                    for k, v in program.scales.items()},
        env_idx=env_idx,
        obs_all=_cpu(data1.observation),
        learn_rows=host(learn_rows),
        entropy_eps=_cpu(ent[0, :3]),
        normalizer={k: _cpu(getattr(norm1, k)) for k in ("mean", "std")},
        losses=_cpu(metrics["total_loss"][0, :3]),
        grad1=[m / (1.0 - learner.ADAM_B1) for m in snaps["m1"]],
        params3=snaps["p3"],
        policy=host(policy),
        step=host(step),
    )


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """TF32 matrix products on the card inside the block (the control)."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def synthetic_clip_qpos(qpos0: np.ndarray, clip_length: int) -> np.ndarray:
    """``harness/driver.py``'s synthetic demo clip of clip 0 of one: qpos0 lifted by
    0.01 and walked 0.2 along x over the clip."""
    qpos = np.tile(qpos0.astype(np.float64), (clip_length, 1))
    qpos[:, 2] += 0.01
    qpos[:, 0] += np.linspace(0.0, 0.2, clip_length)
    return qpos


def reference_env(config, traffic, env_idx, scales, device, dtype):
    """The frozen env at the config's settings for the sampled envs."""
    import torch

    from portbench.ref.data import clips
    from portbench.ref.envs import registry, wrappers
    from portbench.ref.physics import model as M
    from portbench.ref.physics import spec

    env_args = dict(config["env_args"], mjcf_path=harness.model_file(config))
    model = spec.load_model(env_args["mjcf_path"], device=device, dtype=dtype,
                            **{k: env_args[k] for k in spec.FROZEN_OPTIONS if k in env_args})
    ds = config["dataset"]
    clip = clips.process_clip(
        model, torch.as_tensor(synthetic_clip_qpos(model.qpos0.cpu().numpy(),
                                                   ds["clip_length"])),
        dt=1.0 / ds["mocap_hz"])
    env = registry.lookup(config["env_name"])(
        reference_clip=clip, mocap_hz=ds["mocap_hz"], ref_len=ds["ref_traj_length"],
        device=device, dtype=dtype, **env_args)
    rand = None
    if scales is not None:
        rand = harness.scaled_randomization(M, {k: v[env_idx].to(device)
                                                for k, v in scales.items()})
    return wrappers.wrap(env, episode_length=harness.episode_length(config),
                         action_repeat=config["action_repeat"], randomization_fn=rand)


def reference_outputs(cap: Capture, config, traffic, device="cpu", dtype=None,
                      tf32=False) -> Dict:
    """The reference's outputs for everything the program's capture holds,
    computed on ``device`` in ``dtype`` (float64 by default; the control
    runs it in float32 with TF32 products): the env by the frozen plain
    engine (``portbench/ref``), the policy, the normalizer and the learner
    by the benchmark's own (``portbench/learner.py``)."""
    import torch

    from portbench import learner

    dtype = torch.float64 if dtype is None else dtype
    f = lambda t: t.to(device, dtype) if t.is_floating_point() else t.to(device)
    out = {}
    with matmul_tf32(tf32), torch.no_grad():
        env = reference_env(config, traffic, cap.env_idx, cap.scales, device, dtype)
        frame, qpos, qvel = (t[cap.env_idx] for t in cap.start)
        start = env.init_state(frame.to(device), f(qpos), f(qvel))
        nxt = env.step(start, torch.tanh(f(cap.step["raw_action"])))
        out.update(reset_obs=start.obs, obs=nxt.obs, reward=nxt.reward,
                   discount=1 - nxt.done, contact_rows=_active_contacts(env, nxt))
        del env, start, nxt

    policy, value = ([(f(w), f(b)) for w, b in ws] for ws in cap.weights)
    normalize = config["normalize_observations"]
    with matmul_tf32(tf32):
        with torch.no_grad():
            # the first unroll acts with the statistics of no observations:
            # mean 0, std 1
            logits = learner.mlp(policy, f(cap.policy["obs"]))
            loc, scale = learner.gaussian(logits)
            out["raw_action"] = loc + scale * f(cap.policy["eps"])
            out["log_prob"] = learner.log_prob(logits, f(cap.policy["raw_action"]))
            out["norm_mean"], out["norm_std"] = learner.observation_stats(f(cap.obs_all))
        # the learner follows the program's statistics (checked above)
        stats = (f(cap.normalizer["mean"]), f(cap.normalizer["std"])) if normalize else None
        mb = cap.learn_rows["observation"].shape[0] // 3
        batches = [{n: f(t[k * mb:(k + 1) * mb]) for n, t in cap.learn_rows.items()}
                   for k in range(3)]
        out["losses"], out["grad1"], out["change3"] = learner.learn(
            policy, value, stats, batches, f(cap.entropy_eps), config)
    return _to_host(out)


def _active_contacts(env, state):
    """Per env, the contact rows that carry a force in the last substep of
    the compared step (by the reference): the rows the solve kernel's
    contact arithmetic works on."""
    from portbench.ref.physics import constraint

    force = state.pipeline_state.efc_force
    rows = np.nonzero(constraint.efc_layout(env.model).row_type != constraint.ROW_LIMIT)[0]
    return (force[:, rows.tolist()] > 0).sum(-1)


def _to_host(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_host(v) for v in x]
    return x


def program_outputs(cap: Capture) -> Dict:
    """The program's outputs in the reference's layout."""
    s = cap.step
    out = {"reset_obs": s["reset_obs"], "obs": s["obs"], "reward": s["reward"],
           "discount": s["discount"], "norm_mean": cap.normalizer["mean"],
           "norm_std": cap.normalizer["std"],
           "raw_action": cap.policy["raw_action"], "log_prob": cap.policy["log_prob"],
           "losses": list(cap.losses), "grad1": cap.grad1,
           "change3": [p3 - w for p3, w in zip(cap.params3, _initial_leaves(cap))]}
    return _to_host(out)


def _initial_leaves(cap: Capture) -> List:
    """The initial parameters in the optimizer's order: the policy's
    layers, then the value's, each weight then bias."""
    return [t for ws in cap.weights for w, b in ws for t in (w, b)]


# ---------------------------------------------------------------------------
# the numbers compared
# ---------------------------------------------------------------------------


def _widest(a, b):
    """The widest gap |a - b| / (1 + |b|)."""
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def leaf_gaps(prog, ref, keep=None):
    """Per leaf kept, the gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's."""
    pn = np.array([float(t.norm()) for t in prog])
    rn = np.array([float(t.norm()) for t in ref])
    keep = np.ones(len(rn), bool) if keep is None else keep
    med = float(np.median(rn[keep]))
    return np.abs(pn - rn)[keep] / np.maximum(rn[keep], med)


def moving_leaves(ref):
    """The leaves whose reference gradient is at least ``STILL_LEAF`` of
    the median leaf's."""
    g_ref = np.array([float(g.norm()) for g in ref["grad1"]])
    return g_ref >= STILL_LEAF * np.median(g_ref)


def _norm_gap(prog, ref):
    """The observation statistics' widest gap, each feature's mean and std
    against its scale |mean| + std: the program's one-pass float32
    variance loses digits to cancellation on features whose mean dwarfs
    their spread (the root quaternion's w), which this scale allows for."""
    scale = ref["norm_mean"].abs() + ref["norm_std"]
    return max(float(((prog["norm_mean"] - ref["norm_mean"]).abs() / scale).max()),
               float(((prog["norm_std"] - ref["norm_std"]).abs() / scale).max()))


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The gaps of the program's outputs (or the control's) against the
    reference's."""
    return {
        "reset_obs_gap": _widest(prog["reset_obs"], ref["reset_obs"]),
        # a done flag that differs counts 1
        "step_obs_gap": max(_widest(prog["obs"], ref["obs"]),
                            float((prog["discount"] - ref["discount"]).abs().max())),
        "step_reward_gap": _widest(prog["reward"], ref["reward"]),
        "norm_gap": _norm_gap(prog, ref),
        "action_gap": _widest(prog["raw_action"], ref["raw_action"]),
        "logp_gap": _widest(prog["log_prob"], ref["log_prob"]),
        "loss_gap": max(abs(float(a) - float(b)) / abs(float(b))
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": float(leaf_gaps(prog["grad1"], ref["grad1"]).max()),
        # the median leaf's: the worst leaf's change swings from seed to seed
        # (PERF.md, section 2)
        "change_gap": float(np.median(leaf_gaps(prog["change3"], ref["change3"],
                                                moving_leaves(ref)))),
    }


def compare(cap: Capture, config, traffic, device="cpu"):
    """The program's numbers against the float64 reference on ``device``,
    and the most contact rows that carried a force in the compared step in
    any sampled env."""
    ref = reference_outputs(cap, config, traffic, device=device)
    return numbers(program_outputs(cap), ref), int(ref["contact_rows"].max())


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """Each number with its limit and whether it holds (a number that is
    not finite, or has no limit, does not)."""
    out = {}
    for k, v in values.items():
        lim = limits.get(k)
        out[k] = (v, lim, lim is not None and math.isfinite(v) and v <= lim)
    return out
