"""Reproduce NaN per-term eval metrics of chip_smoke.py's multi-clip
driver run (ii) when it evaluates before training, and replay the states
that give them.

    python3 scripts/repro_eval_nan.py [--runs 2] [--out chiprun_out/eval_nan]
    python3 scripts/repro_eval_nan.py --replay chiprun_out/eval_nan

The first form (on a card) runs ``harness.driver.main`` on chip_smoke.py's
run (ii) (``DRIVER_ARGV + DRIVER_MULTI``: train_rodent's widths on the
minirat, 2048 training envs, 128 eval envs, four synthetic clips, float32)
with ``train.eval_every=32768``, so that it evaluates once before training
and once after, ``--runs`` times. Each eval step is watched: where an env
still in its episode gets a non-finite metric, the inputs of that control
step for the whole eval batch are kept (qpos, qvel, act, qacc_warmstart,
the action, frame, steps in the frame, clip) with the envs and the terms.
The first run's steps are then stepped again on the card, substep by
substep, from those inputs, for the whole batch and for each such env
alone: the substep at which its qpos or qvel first goes non-finite, and
its inputs there. Everything goes to ``--out``/states.npz and one JSON
line per run and per replayed step.

``--replay DIR`` (on the CPU, the JAX package beside the port) steps every
kept env (i) through the control step from its inputs, in the port's env in
float32 and float64 and in the JAX package's ``GenericMultiClip`` (jitted,
vmapped) in float32 and float64, and (ii) through the substep that went
non-finite on the card, from that substep's inputs, in the port's and the
JAX package's ``physics.step`` in both types. It prints which envs give a
non-finite term (i) or state (ii) in each, and the largest gaps between
the port and the JAX package over the values finite in both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

INFO_KEYS = ("cur_frame", "steps_taken_cur_frame", "clip_idx")
# the inputs of a physics step (the rest of Data is recomputed by forward)
INPUTS = ("qpos", "qvel", "act", "qacc_warmstart")


def run_argv(base: str, data_dir: str) -> list:
    import chip_smoke as cs

    return cs.DRIVER_ARGV + cs.DRIVER_MULTI + [
        "train.eval_every=32768", f"paths.base_dir={base}", f"paths.data_dir={data_dir}"]


def record_run(argv) -> list:
    """driver.main(argv) on the card with every eval step watched; returns
    one record per eval step with a non-finite metric in an active env:
    the step's inputs for the whole batch, the envs and their terms."""
    from brax_tracking_tpu_torch.harness import driver
    from brax_tracking_tpu_torch.training import acting

    records, where = [], {"eval": -1, "step": 0}
    step, unroll = acting.EvalWrapper.step, acting.Evaluator._unroll

    def watched_unroll(self, params, gen):
        where["eval"] += 1
        where["step"] = 0
        return unroll(self, params, gen)

    def watched_step(self, state, action):
        active = state.info["eval_metrics"].active_episodes.bool()
        nstate = step(self, state, action)
        bad = {k: ~torch.isfinite(v) & active for k, v in nstate.metrics.items()}
        any_bad = torch.stack(list(bad.values())).any(0)
        if bool(any_bad.any()):
            d = state.pipeline_state
            host = lambda t: t.detach().cpu().numpy()
            records.append({
                "eval": where["eval"], "step": where["step"],
                "envs": any_bad.nonzero()[:, 0].tolist(),
                "terms": sorted(k for k, v in bad.items() if bool(v.any())),
                "action": host(action),
                **{k: host(getattr(d, k)) for k in INPUTS if getattr(d, k) is not None},
                **{k: host(state.info[k]) for k in INFO_KEYS},
            })
        where["step"] += 1
        return nstate

    acting.EvalWrapper.step, acting.Evaluator._unroll = watched_step, watched_unroll
    try:
        driver.main(argv, device="cuda")
    finally:
        acting.EvalWrapper.step, acting.Evaluator._unroll = step, unroll
    return records


def first_nonfinite_substep(m, d, n_frames, envs):
    """Runs the control step's substeps from Data ``d`` (ctrl set); for
    each of ``envs`` (rows of d), the first substep after which its qpos or
    qvel is not finite (or -1) and the Data's inputs before it."""
    from brax_tracking_tpu_torch.physics import step as pstep

    found = {e: (-1, None) for e in envs}
    for k in range(n_frames):
        before = d
        d = pstep.step(m, d, device=m.device)
        ok = torch.isfinite(d.qpos).all(-1) & torch.isfinite(d.qvel).all(-1)
        for e in envs:
            if found[e][0] < 0 and not bool(ok[e]):
                found[e] = (k, {f: getattr(before, f)[e].detach().cpu().numpy()
                                for f in INPUTS + ("ctrl",) if getattr(before, f) is not None})
    return found


def substeps_on_card(cfg, rec, device="cuda"):
    """rec's control step again on the card (``device``) from its inputs,
    for the whole batch and for each of its envs alone."""
    from brax_tracking_tpu_torch.harness import driver
    from brax_tracking_tpu_torch.physics import step as pstep

    env = driver.build_env_from_cfg(cfg, device, torch.float32)
    m = env.model
    t = lambda a: torch.as_tensor(a, device=device)

    def data(rows):
        d = pstep.make_data(m, len(rows), device=device)
        return d.replace(ctrl=t(rec["action"][rows]).to(m.dtype),
                         **{k: t(rec[k][rows]) for k in INPUTS if k in rec})

    B = len(rec["action"])
    whole = first_nonfinite_substep(m, data(np.arange(B)), env._n_frames, rec["envs"])
    alone = {e: first_nonfinite_substep(m, data(np.array([e])), env._n_frames, [0])[0]
             for e in rec["envs"]}
    return whole, alone


def port_step(cfg, states, device, dtype):
    """One control step of the port's raw multi-clip env from the kept
    inputs; its metrics as float64 arrays."""
    from brax_tracking_tpu_torch.harness import driver

    env = driver.build_env_from_cfg(cfg, device, dtype)
    t = lambda k, dt=dtype: torch.as_tensor(states[k], device=device, dtype=dt)
    s = env.init_state(t("cur_frame", torch.int32), t("qpos"), t("qvel"),
                       t("clip_idx", torch.int32))
    s = s.replace(info=dict(s.info, steps_taken_cur_frame=t("steps_taken_cur_frame",
                                                            torch.int32)))
    out = env.step(s, t("action"))
    return {k: v.detach().cpu().double().numpy() for k, v in out.metrics.items()}


def jax_env(cfg, dtype):
    """The JAX package's multi-clip env of cfg in ``dtype`` (clips built as
    the JAX driver builds them)."""
    import jax.numpy as jnp

    from brax_tracking_tpu.data import clips as jclips
    from brax_tracking_tpu.envs import tracking as jtracking
    from brax_tracking_tpu.physics import spec as jspec

    ds = cfg["dataset"]
    env_args = dict(ds["env_args"])
    model = jspec.build_model(env_args["mjcf_path"], solver=env_args.get("solver", "cg"),
                              iterations=env_args.get("iterations", 4),
                              ls_iterations=env_args.get("ls_iterations", 4), dtype=dtype)
    n = int(ds["n_clips"])
    T, dt = ds["clip_length"], 1.0 / ds.get("mocap_hz", 50)
    clips = []
    for i in range(n):
        q = np.tile(np.asarray(model.qpos0, np.float64), (T, 1))
        q[:, 2] += 0.01
        ang = 2.0 * np.pi * i / n
        q[:, 0] += np.cos(ang) * np.linspace(0.0, 0.2, T)
        q[:, 1] += np.sin(ang) * np.linspace(0.0, 0.2, T)
        clips.append(jclips.process_clip(model, jnp.asarray(q, dtype), dt=dt))
    return jtracking.GenericMultiClip(reference_clip=jclips.stack_clips(clips), dtype=dtype,
                                      mocap_hz=ds.get("mocap_hz", 50),
                                      ref_len=ds.get("ref_traj_length", 5), **env_args)


def jax_step(cfg, states, dtype):
    """The same control step through the JAX package's env on the CPU."""
    import jax
    import jax.numpy as jnp

    from brax_tracking_tpu.envs.base import State

    env = jax_env(cfg, dtype)

    def one(qpos, qvel, frame, in_frame, clip, action):
        data = env.pipeline_init(qpos, qvel)
        zero = jnp.zeros((), dtype)
        info = {"cur_frame": frame, "steps_taken_cur_frame": in_frame,
                "summed_pos_distance": zero, "quat_distance": zero, "joint_distance": zero,
                "clip_idx": clip}
        obs = env._with_clip(env._select_clip(clip), lambda: env._get_obs(data, frame))
        s = State(pipeline_state=data, obs=obs, reward=zero, done=zero,
                  metrics=env._init_metrics(dtype), info=info)
        return env.step(s, action).metrics

    f = jax.jit(jax.vmap(one))
    a = lambda k, dt=dtype: jnp.asarray(states[k], dt)
    m = f(a("qpos"), a("qvel"), a("cur_frame", jnp.int32), a("steps_taken_cur_frame", jnp.int32),
          a("clip_idx", jnp.int32), a("action"))
    return {k: np.asarray(v, np.float64) for k, v in m.items()}


def port_substep(cfg, sub, dtype):
    """One physics substep of the port on the CPU from the kept substep
    inputs; qpos and qvel as float64 arrays."""
    from brax_tracking_tpu_torch.harness import driver
    from brax_tracking_tpu_torch.physics import step as pstep

    m = driver.build_env_from_cfg(cfg, "cpu", dtype).model
    t = lambda k: torch.as_tensor(sub[k], dtype=dtype)
    d = pstep.make_data(m, len(sub["qpos"]), device="cpu")
    d = d.replace(**{k: t(k) for k in INPUTS + ("ctrl",) if k in sub})
    d = pstep.step(m, d, device="cpu")
    return {"qpos": d.qpos.double().numpy(), "qvel": d.qvel.double().numpy()}


def jax_substep(cfg, sub, dtype):
    """The same substep through the JAX package's physics.step."""
    import jax
    import jax.numpy as jnp

    from brax_tracking_tpu.physics import step as jstep

    m = jax_env(cfg, dtype).model
    B = len(sub["qpos"])
    d = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstep.make_data(m))
    d = d.replace(**{k: jnp.asarray(sub[k], dtype) for k in INPUTS + ("ctrl",) if k in sub})
    out = jax.jit(jax.vmap(lambda dd: jstep.step(m, dd)))(d)
    return {"qpos": np.asarray(out.qpos, np.float64), "qvel": np.asarray(out.qvel, np.float64)}


def nonfinite(values) -> dict:
    """The envs with a non-finite value, per entry that has one."""
    bad = lambda v: ~np.isfinite(v).reshape(len(v), -1).all(-1)
    return {k: np.nonzero(bad(v))[0].tolist() for k, v in sorted(values.items())
            if bad(v).any()}


def gap(a, b) -> float:
    """The largest gap of two runs' values over those finite in both."""
    return max((float(np.abs(a[k] - b[k])[np.isfinite(a[k]) & np.isfinite(b[k])].max(initial=0))
                for k in a), default=0.0)


def replay(directory: str) -> dict:
    """The kept control steps and substeps on the CPU (module docstring)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from brax_tracking_tpu_torch.harness import config as hc

    with np.load(os.path.join(directory, "states.npz")) as z:
        states = {k[5:]: z[k] for k in z.files if k.startswith("step_")}
        sub = {k[4:]: z[k] for k in z.files if k.startswith("sub_")}
    out = {"envs": len(states["qpos"])}
    steps, subs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = hc.load_config(run_argv(os.path.join(tmp, "run"), os.path.join(tmp, "data")))
        for name, tdt, jdt in (("float32", torch.float32, jnp.float32),
                               ("float64", torch.float64, jnp.float64)):
            steps[f"port_{name}"] = port_step(cfg, states, "cpu", tdt)
            steps[f"jax_{name}"] = jax_step(cfg, states, jdt)
            if sub:
                subs[f"port_{name}"] = port_substep(cfg, sub, tdt)
                subs[f"jax_{name}"] = jax_substep(cfg, sub, jdt)
    out["control_step_nonfinite_terms"] = {k: nonfinite(v) for k, v in steps.items()}
    if sub:
        out["substep"] = sub["substep"].tolist()
        out["substep_nonfinite_state"] = {k: nonfinite(v) for k, v in subs.items()}
        out["substep_qvel_absmax"] = {k: np.abs(v["qvel"]).max(-1).tolist()
                                      for k, v in subs.items()}
    for name in ("float32", "float64"):
        out[f"control_step_gap_port_jax_{name}"] = gap(steps[f"port_{name}"],
                                                       steps[f"jax_{name}"])
        if sub:
            out[f"substep_gap_port_jax_{name}"] = gap(subs[f"port_{name}"], subs[f"jax_{name}"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "eval_nan"))
    ap.add_argument("--replay", default=None, help="a directory written by a card run")
    args = ap.parse_args()
    if args.replay:
        print(json.dumps(replay(args.replay)))
        return 0

    import chip_smoke as cs
    from brax_tracking_tpu_torch.harness import config as hc

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this mode needs a CUDA card")
    os.environ.setdefault("WANDB_MODE", "disabled")
    os.makedirs(args.out, exist_ok=True)
    print(cs.card_line(), flush=True)
    runs = []
    for run in range(args.runs):
        with tempfile.TemporaryDirectory() as tmp:
            argv = run_argv(os.path.join(tmp, "run"), os.path.join(tmp, "data"))
            t0 = time.perf_counter()
            recs = record_run(argv)
            seconds = time.perf_counter() - t0
            with open(os.path.join(tmp, "run", "logs", "metrics.jsonl")) as f:
                evals = [{k: v for k, v in json.loads(line).items()
                          if k.startswith("eval/episode_") and not k.endswith("_std")}
                         for line in f if "eval/episode_reward" in line]
            cfg = hc.load_config(argv)
        runs.append(recs)
        print(json.dumps({
            "run": run, "seconds": seconds,
            "nonfinite_eval_metrics": [[k for k, v in e.items() if not np.isfinite(v)]
                                       for e in evals],
            "records": [{k: r[k] for k in ("eval", "step", "envs", "terms")} for r in recs],
        }), flush=True)
    if not runs[0]:
        print(json.dumps({"reproduced": False}))
        return 0
    step_rows, sub_rows = [], []
    for rec in runs[0]:
        whole, alone = substeps_on_card(cfg, rec)
        print(json.dumps({"eval": rec["eval"], "step": rec["step"],
                          "first_nonfinite_substep_whole_batch": {e: v[0] for e, v in whole.items()},
                          "first_nonfinite_substep_alone": {e: v[0] for e, v in alone.items()}}),
              flush=True)
        for e in rec["envs"]:
            step_rows.append({k: rec[k][e] for k in ("action",) + INFO_KEYS + INPUTS if k in rec})
            k, inputs = whole[e]
            if k >= 0:
                sub_rows.append(dict(inputs, substep=np.asarray(k)))
    pack = lambda rows, p: {p + k: np.stack([r[k] for r in rows]) for k in rows[0]}
    np.savez(os.path.join(args.out, "states.npz"), **pack(step_rows, "step_"),
             **(pack(sub_rows, "sub_") if sub_rows else {}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
