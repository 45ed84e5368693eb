"""Experiment driver: config -> clip cache -> env -> PPO -> eval artifacts.

Counterpart of ``brax_tracking_tpu/harness/driver.py``:

    python -m brax_tracking_tpu_torch.harness.driver [group=choice] [a.b=v]

e.g. ``python -m brax_tracking_tpu_torch.harness.driver train=smoke
dataset=minirat``. It composes the config (``harness/config.py``, the
port's own copies of the configs), loads or builds the reference clips
(the cache ``<paths.data_dir>/clips/<i>.p``, the JAX package's pickle,
then ``<i>.npz``, the port's, else a build that writes ``<i>.npz``),
constructs the env through the registry and trains with
``agents/ppo/train.py::train`` on the card. After each eval the callback
snapshots the policy params, rolls out the deterministic policy from frame
0 of clip 0 and writes its per-frame stats, table and CSV, and for a
multi-clip env evaluates every clip, and with ``train.render_video`` renders
the rollout beside its reference clip into ``rollout_<step>.<ext>``
(harness/render.py; a failed render raises, where the JAX driver warns and
goes on). The run ends with the final params.

``main(argv, device="cuda")`` runs on the card and raises without one;
``device="cpu"`` runs the same on the CPU in float64. ``profile_dir`` /
``BTT_PROFILE_DIR`` traces the run with ``torch.profiler`` (the host, and
the card where the run is on one) and writes the trace there as
``<time>.pt.trace.json`` when the run returns or raises. ``debug_nans=true``
or ``BTT_DEBUG_NANS=1`` turns on ``training/debug_nans.py`` for the run: a
NaN in the outputs of a reset, a training step's rollout or learner half,
or an eval unroll raises ``FloatingPointError`` naming the op or kernel
that made it, as ``jax_debug_nans`` does in the JAX driver; with it on a
run is bitwise the run with it off. ``compilation_cache_dir`` names the
JAX package's compile cache, which has no counterpart here: it is read and
ignored, and so is ``train.epoch_mode``.

With ``dataset.stac_path=''`` a synthetic clip is built from the model's
home pose.

Several cards: start one process per card with torchrun (``torchrun
--nproc-per-node N -m brax_tracking_tpu_torch.harness.driver ...``, or
``harness/launch.py``). ``main`` builds the mesh from torchrun's
environment (``distributed/mesh.py``), each rank on its card; rank 0 builds
the clip cache and the others read it after a barrier, rank 0 alone writes
the run config, the metrics (wandb included), the eval callback's files and
videos and the final params, and every rank runs ``train()``.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import pickle
import sys
import time
from typing import Dict

import numpy as np
import torch

_logger = logging.getLogger(__name__)

# per-env start frames of the per-clip eval
_CLIP_EVAL_ENVS = 32


def _build_one_clip(cfg: Dict, model, clip_idx: int, write: bool = True):
    """Loads clip ``clip_idx`` from the cache, or builds it on the model's
    device and caches it as ``.npz``; with ``write`` false a missing cache
    raises."""
    from brax_tracking_tpu_torch.data import clips as C

    ds = cfg["dataset"]
    clip_dir = os.path.join(cfg["paths"]["data_dir"], "clips")
    for ext in (".p", ".npz"):
        cache = os.path.join(clip_dir, f"{clip_idx}{ext}")
        if os.path.exists(cache):
            _logger.info("clip %d from %s", clip_idx, cache)
            return C.load_clip(cache)
    if not write:
        raise FileNotFoundError(f"clip {clip_idx} is not cached in {clip_dir}")
    dt = 1.0 / ds.get("mocap_hz", 50)
    if ds.get("stac_path"):
        clip = C.process_clip_to_train(
            ds["stac_path"],
            model,
            start_step=clip_idx * ds["clip_length"],
            clip_length=ds["clip_length"],
            dt=dt,
            nan_policy=ds.get("nan_policy", "error"),
        )
    else:
        _logger.warning("dataset.stac_path empty -> synthetic demo clip %d", clip_idx)
        T = ds["clip_length"]
        qpos = np.tile(model.qpos0.cpu().numpy().astype(np.float64), (T, 1))
        qpos[:, 2] += 0.01
        # distinct synthetic clips walk in distinct directions
        ang = 2.0 * np.pi * clip_idx / max(int(ds.get("n_clips", 1)), 1)
        qpos[:, 0] += np.cos(ang) * np.linspace(0.0, 0.2, T)
        qpos[:, 1] += np.sin(ang) * np.linspace(0.0, 0.2, T)
        clip = C.process_clip(model, torch.as_tensor(qpos), dt=dt)
    os.makedirs(clip_dir, exist_ok=True)
    cache = os.path.join(clip_dir, f"{clip_idx}.npz")
    C.save_clip(cache, clip)
    _logger.info("clip %d built and cached at %s", clip_idx, cache)
    return clip


def _build_clip(cfg: Dict, model, write: bool = True):
    """Single clip, or a stacked multi-clip dataset when dataset.n_clips > 1."""
    from brax_tracking_tpu_torch.data import clips as C

    ds = cfg["dataset"]
    n_clips = int(ds.get("n_clips", 1))
    if n_clips <= 1:
        return _build_one_clip(cfg, model, int(ds["clip_idx"]), write)
    start = int(ds.get("clip_idx", 0))
    return C.stack_clips([_build_one_clip(cfg, model, start + i, write)
                          for i in range(n_clips)])


def build_env_from_cfg(cfg: Dict, device="cuda", dtype=None, mesh=None):
    """Loads the frozen model, loads or builds the reference clip and
    constructs the env on ``device``, in ``dtype`` (by default float64 on
    the CPU, float32 on the card). Under a ``mesh`` of several ranks rank 0
    loads or builds the clips and the others read its cache after a
    barrier."""
    from brax_tracking_tpu_torch.device import resolve_device
    from brax_tracking_tpu_torch.distributed import mesh as dmesh
    from brax_tracking_tpu_torch.envs import registry
    from brax_tracking_tpu_torch.physics import spec as bspec

    dev = resolve_device(device)
    ds, tr = cfg["dataset"], cfg["train"]
    env_args = dict(ds["env_args"])
    make_env = registry.lookup(tr["env_name"])

    # the clip builder's model: the env's frozen model, its options checked
    model = bspec.load_model(
        bspec.frozen_path(env_args["mjcf_path"], env_args.get("free_jnt", True)),
        device=dev,
        dtype=dtype,
        **{k: env_args[k] for k in bspec.FROZEN_OPTIONS if k in env_args},
    )
    lead = mesh is None or mesh.rank == 0
    if not lead:
        dmesh.synchronize_hosts(mesh)  # rank 0 has written the cache
    clip = _build_clip(cfg, model, write=lead)
    if lead and mesh is not None:
        dmesh.synchronize_hosts(mesh)
    return make_env(
        reference_clip=clip,
        mocap_hz=ds.get("mocap_hz", 50),
        ref_len=ds.get("ref_traj_length", 5),
        device=dev,
        dtype=dtype,
        **env_args,
    )


def _eval_callback(cfg: Dict, env, logger, model_path: str, fig_dir: str = ""):
    """The per-eval callback: params snapshot, the deterministic rollout
    (B = 1, frame 0 of clip 0) with its per-frame stats, table and
    artifacts, and for a multi-clip env the per-clip eval."""
    from brax_tracking_tpu_torch.envs.wrappers import RenderRolloutWrapperTracking
    from brax_tracking_tpu_torch.harness import eval_plots
    from brax_tracking_tpu_torch.training import checkpoint

    rollout_env = RenderRolloutWrapperTracking(env)
    n_steps = int(
        (cfg["dataset"]["clip_length"] - cfg["dataset"]["ref_traj_length"])
        * env._steps_for_cur_frame
    )
    dist_keys = ("summed_pos_distance", "quat_distance", "joint_distance")
    n_clips = int(getattr(env, "_n_clips", 1))
    thorax = env._thorax_idx
    ds = cfg["dataset"]
    scene = ds.get("rendering_mjcf") or ds["env_args"]["mjcf_path"]
    free_jnt = ds["env_args"].get("free_jnt", True)
    if cfg["train"].get("render_video"):
        from brax_tracking_tpu_torch.physics import spec

        spec.frozen_path(scene, free_jnt)  # a missing render scene raises before training

    @torch.no_grad()
    def deterministic_rollout(policy):
        """n_steps control steps of one env; per-step values stay on the
        device until the end, the qpos of the reset and of every step
        (n_steps + 1, nq) on the device for the video."""
        gen = torch.Generator(device=env.device).manual_seed(0)
        state = rollout_env.reset(gen, 1)
        metrics, dists, heights = [], [], [state.pipeline_state.xpos[:, thorax, 2]]
        qposes = [state.pipeline_state.qpos]
        for _ in range(n_steps):
            action, _ = policy(state.obs, None)
            state = rollout_env.step(state, action)
            metrics.append(state.metrics)
            dists.append({k: state.info[k] for k in dist_keys})
            heights.append(state.pipeline_state.xpos[:, thorax, 2])
            qposes.append(state.pipeline_state.qpos)
        table = {k: torch.cat([m[k] for m in metrics]).cpu().numpy() for k in metrics[0]}
        distances = {k: torch.cat([d[k] for d in dists]).cpu().numpy() for k in dist_keys}
        height = torch.cat(heights).cpu().numpy()
        return table, distances, height, torch.cat(qposes)

    @torch.no_grad()
    def clip_eval(policy):
        """Episode return of _CLIP_EVAL_ENVS envs per clip, pinned by
        reset_to_clip, in one batch; returns the mean per clip."""
        dev = env.device
        gen = torch.Generator(device=dev).manual_seed(0)
        idx = torch.arange(n_clips, device=dev).repeat_interleave(_CLIP_EVAL_ENVS)
        state = env.reset_to_clip(idx, gen)
        ret = torch.zeros_like(state.reward)
        alive = torch.ones_like(state.reward)
        for _ in range(n_steps):
            action, _ = policy(state.obs, None)
            state = env.step(state, action)
            ret = ret + state.reward * alive
            alive = alive * (1.0 - state.done)
        return ret.reshape(n_clips, _CLIP_EVAL_ENVS).mean(1).cpu().numpy()

    def policy_params_fn(num_steps, make_policy, params):
        os.makedirs(model_path, exist_ok=True)
        checkpoint.save_params(os.path.join(model_path, str(num_steps)), params)
        policy = make_policy(params, deterministic=True)
        if n_clips > 1:
            per_clip = clip_eval(policy)
            logger.log({f"eval/episode_reward_clip{j}": float(r) for j, r in enumerate(per_clip)},
                       step=num_steps)
        table, distances, thorax_z, qposes = deterministic_rollout(policy)
        stats = {}
        for k, v in table.items():
            stats[f"rollout/{k}_mean"] = float(np.nanmean(v))
            stats[f"rollout/{k}_min"] = float(np.nanmin(v))
        stats["rollout/summed_pos_distance_mean"] = float(
            np.nanmean(distances["summed_pos_distance"])
        )
        logger.log(stats, step=num_steps)
        with open(os.path.join(model_path, f"rollout_{num_steps}.p"), "wb") as f:
            pickle.dump(table, f)

        # the reference's thorax height, one entry per control step (clip 0
        # of a multi-clip env)
        bp = env._ref_traj.body_positions
        if bp.dim() == 4:
            bp = bp[0]
        bp = bp.cpu().numpy()
        frames = np.minimum(
            (np.arange(len(thorax_z)) / max(env._steps_for_cur_frame, 1)).astype(int),
            bp.shape[0] - 1,
        )
        paths = eval_plots.emit_eval_artifacts(
            fig_dir or model_path, num_steps, table, distances, thorax_z,
            bp[frames, thorax, 2],
        )
        logger.log({f"rollout/{k}": v for k, v in paths.items()}, step=num_steps)

        if cfg["train"].get("render_video"):
            from brax_tracking_tpu_torch.harness import render

            timings = {}
            video = render.render_rollout_vs_reference(
                scene,
                qposes,
                env._ref_traj,
                os.path.join(model_path, f"rollout_{num_steps}.mp4"),
                camera=ds.get("camera", 1),
                free_jnt=free_jnt,
                timings=timings,
            )
            logger.log({"rollout/video": video,
                        **{f"rollout/video_{k}": v for k, v in timings.items()}},
                       step=num_steps)

    return policy_params_fn


@contextlib.contextmanager
def _trace(profile_dir: str, dev: torch.device, suffix: str = ""):
    """torch.profiler over the block (the host, and the card for a card
    run); the trace is written into ``profile_dir`` however the block
    ends, named by the time and ``suffix``."""
    from torch.profiler import ProfilerActivity, profile

    out = os.path.expanduser(profile_dir)
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(out, time.strftime("%Y%m%d_%H%M%S") + suffix + ".pt.trace.json")
        prof.export_chrome_trace(path)
        _logger.info("profile trace written to %s", path)


def main(argv=None, device="cuda") -> Dict:
    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else argv

    from brax_tracking_tpu_torch.device import resolve_device
    from brax_tracking_tpu_torch.distributed import mesh as dmesh
    from brax_tracking_tpu_torch.harness.config import load_config, save_config
    from brax_tracking_tpu_torch.training import debug_nans

    resolve_device(device)
    cfg = load_config(argv)
    mesh = dmesh.make_train_mesh(device)
    paths = cfg["paths"]
    if mesh.rank == 0:
        for key in ("base_dir", "save_dir", "log_dir", "ckpt_dir", "fig_dir", "data_dir"):
            os.makedirs(paths[key], exist_ok=True)
        save_config(cfg, os.path.join(paths["save_dir"], "run_config.yaml"))
    profile_dir = cfg.get("profile_dir") or os.environ.get("BTT_PROFILE_DIR")
    suffix = f".rank{mesh.rank}" if mesh.world_size > 1 else ""
    # fail at the op that made the first NaN (training/debug_nans.py; the
    # JAX driver sets jax_debug_nans); default training relies on the envs'
    # NaN-to-done guards
    nan_mode = os.environ.get("BTT_DEBUG_NANS") == "1" or bool(cfg.get("debug_nans"))
    with debug_nans.debug_nans(nan_mode), \
            _trace(profile_dir, mesh.device, suffix) if profile_dir else contextlib.nullcontext():
        metrics = _run(cfg, mesh)
    mesh.close()
    return metrics


def _run(cfg: Dict, mesh) -> Dict:
    """main()'s run once the config is written: the env, train() with the
    eval callback, the final params (the callback, the logger and the
    params on rank 0)."""
    from brax_tracking_tpu_torch.agents.ppo import networks as ppo_networks
    from brax_tracking_tpu_torch.agents.ppo import train as ppo_train
    from brax_tracking_tpu_torch.harness.metrics import MetricsLogger
    from brax_tracking_tpu_torch.training import checkpoint

    paths = cfg["paths"]
    ds, tr = cfg["dataset"], cfg["train"]
    dev = mesh.device
    env = build_env_from_cfg(cfg, dev, mesh=mesh)
    # the episode length follows the clip unless force_episode_length
    if tr.get("force_episode_length"):
        episode_length = int(tr["episode_length"])
    else:
        episode_length = int(
            (ds["clip_length"] - 50 - ds["ref_traj_length"]) * env._steps_for_cur_frame
        )
    _logger.info("episode_length=%d", episode_length)

    run_name = f"{tr['env_name']}_{tr['task_name']}_{tr['version']}"
    model_path = os.path.join(paths["ckpt_dir"], run_name)
    lead = mesh.rank == 0
    if lead:
        logger = MetricsLogger(
            project=tr.get("wandb_project", "brax_tracking_tpu"),
            run_name=run_name,
            log_dir=paths["log_dir"],
            config=cfg,
        )
        policy_params_fn = _eval_callback(cfg, env, logger, model_path, fig_dir=paths["fig_dir"])

        def progress_fn(num_steps, metrics):
            logger.log(metrics, step=num_steps)
            _logger.info("steps=%s %s", num_steps, {
                k: round(float(v), 4)
                for k, v in metrics.items()
                if k in ("eval/episode_reward", "training/sps")
            })
    else:
        # train() calls neither on a rank other than 0
        progress_fn = policy_params_fn = None

    network_factory = functools.partial(
        ppo_networks.make_ppo_networks,
        policy_hidden_layer_sizes=tuple(tr["mlp_policy_layer_sizes"]),
        value_hidden_layer_sizes=tuple(
            tr.get("mlp_value_layer_sizes", tr["mlp_policy_layer_sizes"])
        ),
    )

    make_policy, params, metrics = ppo_train.train(
        environment=env,
        num_timesteps=int(tr["num_timesteps"]),
        episode_length=episode_length,
        action_repeat=tr.get("action_repeat", 1),
        num_envs=int(tr["num_envs"]),
        num_eval_envs=int(tr.get("num_eval_envs", 128)),
        learning_rate=float(tr["learning_rate"]),
        entropy_cost=float(tr.get("entropy_cost", 1e-3)),
        discounting=float(tr.get("discounting", 0.99)),
        seed=int(cfg.get("seed", 0)),
        unroll_length=int(tr.get("unroll_length", 16)),
        batch_size=int(tr["batch_size"]),
        num_minibatches=int(tr.get("num_minibatches", 32)),
        num_updates_per_batch=int(tr.get("num_updates_per_batch", 16)),
        num_evals=max(int(int(tr["num_timesteps"]) / int(tr["eval_every"])), 1),
        normalize_observations=bool(tr.get("normalize_observations", True)),
        reward_scaling=float(tr.get("reward_scaling", 1.0)),
        clipping_epsilon=float(tr.get("clipping_epsilon", 0.3)),
        deterministic_eval=bool(tr.get("deterministic_eval", False)),
        network_factory=network_factory,
        progress_fn=progress_fn,
        policy_params_fn=policy_params_fn,
        restore_checkpoint_path=cfg.get("checkpoint") or None,
        checkpoint_dir=paths["ckpt_dir"],
        device=dev,
        mesh=mesh,
    )

    if lead:
        final = os.path.join(model_path, "final")
        checkpoint.save_params(final, params)
        logger.log({"final_params": final, **metrics})
        logger.finish()
    return metrics


if __name__ == "__main__":
    main()
