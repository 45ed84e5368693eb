"""One rank of the port's data-parallel tests (not a pytest module).

The parent test starts one process per rank with torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and reads what each rank pickles; gloo on the CPU, float64.

    python tests/_torch_dist_worker.py ranks IN OUT PORT1
    python tests/_torch_dist_worker.py driver ARGV_JSON OUT

``ranks`` (tests/test_torch_distributed.py): the grouped normalizer update
on a seeded batch per rank; the replication check on a tensor that differs
across ranks; the port's ``train()`` on a point mass with
every tensor of its training state, the evals each rank ran, its first
reset and the files it wrote; one training step of the minirat tracking env
on this rank's envs and draws, once the parent has written ``IN``; and on
rank 0 after the ranks' group is gone, ``train()`` again through a group
of one rank (on ``PORT1``) and with no group. ``driver``
(tests/test_torch_launch.py): ``driver.main(argv, device="cpu")``, the
files the rank wrote and the params its ``train()`` returned.

Imports torch and the port only (no JAX): each rank starts in seconds. The
parent's helpers (``free_ports``, ``spawn_ranks``, ``wait_ranks``) are here
too.
"""

import dataclasses
import functools
import json
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from brax_tracking_tpu_torch.agents.ppo import losses as tlosses  # noqa: E402
from brax_tracking_tpu_torch.agents.ppo import networks as tnetworks  # noqa: E402
from brax_tracking_tpu_torch.agents.ppo import train as ttrain  # noqa: E402
from brax_tracking_tpu_torch.distributed import mesh as dmesh  # noqa: E402
from brax_tracking_tpu_torch.envs.base import Env, State  # noqa: E402
from brax_tracking_tpu_torch.training import gradients as tgradients  # noqa: E402
from brax_tracking_tpu_torch.training import running_statistics as trs  # noqa: E402

# the grouped normalizer update: each rank's batch, (T, B, obs)
STATS_SHAPE = (3, 5, 7)
# the point mass run: tests/test_torch_ppo_train.py's PM_ARGS, two training
# steps and an eval before and after them
PM_ARGS = dict(episode_length=32, num_envs=64, learning_rate=3e-4, entropy_cost=1e-3,
               discounting=0.95, unroll_length=8, batch_size=64, num_minibatches=4,
               num_updates_per_batch=4, num_eval_envs=64, normalize_observations=True, seed=0,
               device="cpu", num_timesteps=4096, num_evals=2)


@dataclasses.dataclass
class _Pos:
    pos: torch.Tensor

    def tensors(self):
        return {"pos": self.pos}

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


class PointMass(Env):
    """2-D point mass steering to the origin (tests/test_torch_ppo_train.py's);
    records the positions of each reset of ``batch_size`` envs."""

    def __init__(self):
        self.resets = []

    def reset(self, generator, batch_size):
        pos = 2.0 * torch.rand(batch_size, 2, generator=generator, dtype=torch.float64) - 1.0
        self.resets.append(pos.numpy().copy())
        return self._state(pos, {})

    def _state(self, pos, metrics):
        dist = torch.linalg.norm(pos, dim=-1)
        return State(pipeline_state=_Pos(pos), obs=pos, reward=-dist,
                     done=torch.zeros_like(dist), metrics={**metrics, "distance": dist}, info={})

    def step(self, state, action):
        s = self._state(state.pipeline_state.pos + 0.1 * torch.clamp(action, -1.0, 1.0),
                        state.metrics)
        return state.replace(pipeline_state=s.pipeline_state, obs=s.obs, reward=s.reward,
                             done=s.done, metrics=s.metrics)

    @property
    def observation_size(self):
        return 2

    @property
    def action_size(self):
        return 2


def record_writes(root):
    """Paths under ``root`` this process opens for writing or makes as a
    directory, from the interpreter's ``open`` and ``os.mkdir`` audit events
    (``torch.save`` opens its file in C++, unseen: the checkpoint shows by
    its directory)."""
    root = os.path.realpath(root)
    written = set()
    flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def hook(event, args):
        if event not in ("open", "os.mkdir") or not isinstance(args[0], (str, bytes, os.PathLike)):
            return
        if event == "os.mkdir":
            writing = True
        else:
            _, mode, oflags = args
            writing = (mode is not None and any(c in mode for c in "wax+")) or (
                mode is None and isinstance(oflags, int) and oflags & flags)
        path = args[0]
        path = os.path.realpath(os.fsdecode(path))
        if writing and path.startswith(root + os.sep):
            written.add(os.path.relpath(path, root))

    sys.addaudithook(hook)
    return written


# --- the parent's side ----------------------------------------------------------


def free_ports(n):
    """``n`` distinct free localhost ports."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def spawn_ranks(job, args_of_rank, world_size, port, logdir):
    """One worker process per rank, with torchrun's environment."""
    procs = []
    for rank in range(world_size):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        log = open(os.path.join(logdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job,
             *args_of_rank(rank)], stdout=log, stderr=subprocess.STDOUT, env=env), log))
    return procs


def wait_ranks(procs, logdir, timeout=300):
    """Waits for every rank; a rank that fails, or outlives the timeout,
    fails the test with its log (and the others are killed)."""
    try:
        for rank, (p, log) in enumerate(procs):
            p.wait(timeout=timeout)
            log.close()
            if p.returncode != 0:
                with open(os.path.join(logdir, f"rank{rank}.log")) as f:
                    raise AssertionError(
                        f"rank {rank} exited {p.returncode}:\n{f.read()[-4000:]}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


# --- a rank's side ------------------------------------------------------------


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def traced_train(env, **kwargs):
    """``train()`` with the networks and the optimizer it makes kept: returns
    (metrics, every tensor of the final training state, evals run)."""
    made, evals = {}, []

    def factory(*a, **kw):
        made["net"] = tnetworks.make_ppo_networks(*a, policy_hidden_layer_sizes=(32, 32),
                                                  value_hidden_layer_sizes=(32, 32), **kw)
        return made["net"]

    make_optimizer = ttrain.gradients.make_optimizer

    def keep_optimizer(*a, **kw):
        made["opt"] = make_optimizer(*a, **kw)
        return made["opt"]

    ttrain.gradients.make_optimizer = keep_optimizer
    try:
        _, (normalizer, _), metrics = ttrain.train(
            env, network_factory=factory, progress_fn=lambda step, m: evals.append(step),
            **kwargs)
    finally:
        ttrain.gradients.make_optimizer = make_optimizer
    state = ttrain.TrainingState(params=made["net"], optimizer=made["opt"],
                                 normalizer_params=normalizer, env_steps=0)
    return metrics, _numpy(dmesh.training_state_tensors(state)), evals


def tracking_step(mesh, inp):
    """One training step of the minirat tracking env on this rank's envs and
    draws (tests/test_torch_ppo_train.py's, under the ranks' group)."""
    from brax_tracking_tpu_torch.data import clips as tclips
    from brax_tracking_tpu_torch.envs import tracking as ttracking
    from brax_tracking_tpu_torch.envs import wrappers as twrappers
    from brax_tracking_tpu_torch.physics import spec as tspec

    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    mine = inp["ranks"][mesh.rank]
    tm = tspec.load_model(device="cpu")
    tenv = twrappers.wrap(
        ttracking.GenericSingleClip(reference_clip=tclips.process_clip(tm, t(inp["qclip"])),
                                    device="cpu", **inp["env_args"]),
        episode_length=inp["episode_length"])
    ts = tenv.init_state(t(mine["cur_frame"]), t(mine["qpos"]), t(mine["qvel"]))
    obs_size, action_size = ts.obs.shape[-1], tenv.action_size
    net = tnetworks.PPONetworks(
        tnetworks.params_from_numpy(inp["init_params"]["policy"], device="cpu"),
        tnetworks.params_from_numpy(inp["init_params"]["value"], device="cpu"),
        tnetworks.NormalTanhDistribution(action_size), tnetworks.normalize_preprocessor)
    state = ttrain.TrainingState(
        params=net, optimizer=tgradients.make_optimizer(net.parameters(), inp["lr"]),
        normalizer_params=trs.init_state(torch.zeros(obs_size, dtype=torch.float64)),
        env_steps=0)
    ts, data, normalizer = ttrain.rollout_step(
        tenv, tnetworks.make_inference_fn(net), state, ts, t(mine["action_eps"]), mesh.group)
    state, metrics = ttrain.learn_step(
        state, data, normalizer, t(mine["perms"]).long(), t(mine["entropy_eps"]),
        functools.partial(tlosses.compute_ppo_loss, **inp["loss_hparams"]),
        steps_per_train_step=0, group=mesh.group)
    metrics = ttrain.mean_across_ranks(metrics, mesh.group)
    return dict(tensors=_numpy(dmesh.training_state_tensors(state)), metrics=_numpy(metrics),
                observation=data.observation.numpy())


def ranks_job(inp_path, out_path, port1):
    torch.set_num_threads(1)
    mesh = dmesh.make_train_mesh("cpu")
    out = dict(rank=mesh.rank, world_size=mesh.world_size,
               backend=torch.distributed.get_backend(mesh.group))

    # the normalizer update on this rank's batch under the group
    batches = np.random.default_rng(7).normal(size=(mesh.world_size,) + STATS_SHAPE)
    st = trs.init_state(torch.zeros(STATS_SHAPE[-1], dtype=torch.float64))
    for _ in range(2):
        st = trs.update(st, torch.as_tensor(batches[mesh.rank]), mesh.group)
    out["stats"] = trs.state_to_numpy(st)

    # the replication check on tensors that differ on one rank
    tensors = {"a": torch.zeros(3), "b": torch.full((2,), float(mesh.rank)), "c": torch.ones(1)}
    try:
        dmesh.assert_is_replicated(tensors, mesh)
        out["mismatch"] = None
    except AssertionError as e:
        out["mismatch"] = str(e)
    dmesh.assert_is_replicated({k: torch.zeros(2) for k in "abc"}, mesh)

    # train() on the point mass across the ranks, a checkpoint each epoch
    ckpt = os.path.join(os.path.dirname(out_path), "ckpt")
    written = record_writes(os.path.dirname(out_path))
    env = PointMass()
    metrics, tensors, evals = traced_train(env, checkpoint_dir=ckpt, mesh=mesh, **PM_ARGS)
    out.update(pm_metrics=metrics, pm_tensors=tensors, pm_evals=evals,
               pm_first_reset=env.resets[0], pm_written=sorted(written))

    # one training step of the tracking env on this rank's envs and draws
    while not os.path.exists(inp_path):
        time.sleep(0.1)
    with open(inp_path, "rb") as f:
        out["step"] = tracking_step(mesh, pickle.load(f))
    dmesh.synchronize_hosts(mesh)
    mesh.close()

    if mesh.rank == 0:
        # a world of one rank through a process group, then no group
        os.environ.update(WORLD_SIZE="1", MASTER_PORT=str(port1))
        one = dmesh.make_train_mesh("cpu")
        out["one_world_size"] = one.world_size
        out["one"] = traced_train(PointMass(), mesh=one, **PM_ARGS)
        one.close()
        for k in dmesh.TORCHRUN_ENV:
            del os.environ[k]
        none = dmesh.make_train_mesh("cpu")
        assert none.group is None
        out["none"] = traced_train(PointMass(), **PM_ARGS)

    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def driver_job(argv_json, out_path):
    from brax_tracking_tpu_torch.harness import driver

    torch.set_num_threads(1)
    argv = json.loads(argv_json)
    base = os.path.dirname(out_path)
    written = record_writes(base)
    returned = []
    train = ttrain.train

    def keep(*a, **kw):
        result = train(*a, **kw)
        returned.append(result[1])
        return result

    ttrain.train = keep
    metrics = driver.main(argv, device="cpu")
    normalizer, policy = returned[0]
    out = dict(rank=int(os.environ["RANK"]), metrics=metrics, written=sorted(written),
               normalizer=trs.state_to_numpy(normalizer),
               policy=_numpy(dict(policy.state_dict())))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    job, *args = sys.argv[1:]
    {"ranks": ranks_job, "driver": driver_job}[job](*args)
