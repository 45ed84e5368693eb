"""The port's data parallelism (distributed/mesh.py and its users), float64
on the CPU over two gloo ranks, each a process of its own
(tests/_torch_dist_worker.py, started here with torchrun's environment).

- One data-parallel training step of the minirat tracking env against the
  JAX package's learner under ``shard_map`` over ``jax.devices()[:2]``:
  ``running_statistics.update(pmean_axis_name=...)``,
  ``gradients.gradient_update_fn(pmap_axis_name=...)`` and the ``pmean`` of
  the loss metrics, as ``brax_tracking_tpu/agents/ppo/train.py`` composes
  them. Each shard's rollout runs unsharded on its 4 envs from its own key
  (no sharded env step is compiled), every draw of each shard is
  recomputed from its key and handed to that rank, and each rank's rollout,
  the normalizer, the loss metrics, the params and both Adam moments agree
  with the JAX side at rtol 1e-7 / atol 1e-8 (tests/test_torch_ppo_train.py's
  geometry: 8 envs, 4 per rank; MLPs (32, 32); unroll 4; batch 8; 2
  minibatches; 2 updates).
- The port's ``train()`` on a point mass over the two ranks, with the
  checks of tests/test_multiprocess.py: the training state bitwise equal on
  both ranks, evals (and the checkpoint) on rank 0 only, rank-folded env
  draws that differ. The JAX test's "same global program on another process
  layout" has no counterpart here (each rank permutes and cuts its own rows,
  so two ranks draw other minibatches than one process does); in its place
  a world of one rank through a process group is bitwise the run with no
  group.
- The grouped normalizer update on two ranks against one process's update
  on the joined batch (1e-12), and a ``num_envs`` the ranks do not divide.
"""

import ast
import functools
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from brax_tracking_tpu.agents.ppo import losses as jlosses
from brax_tracking_tpu.agents.ppo import networks as jnetworks
from brax_tracking_tpu.data import clips as jclips
from brax_tracking_tpu.distributed.mesh import shard_map_compat
from brax_tracking_tpu.envs import tracking as jtracking
from brax_tracking_tpu.envs import wrappers as jwrappers
from brax_tracking_tpu.physics import spec as jspec
from brax_tracking_tpu.training import acting as jacting
from brax_tracking_tpu.training import gradients as jgradients
from brax_tracking_tpu.training import running_statistics as jrs
from brax_tracking_tpu_torch.agents.ppo import train as ttrain
from brax_tracking_tpu_torch.distributed import mesh as dmesh
from brax_tracking_tpu_torch.training import running_statistics as trs
from test_torch_ppo_train import ENV_ARGS, HIDDEN, LOSS_HPARAMS, LR, _synth_qpos

import _torch_dist_worker as worker
from _torch_dist_worker import free_ports, spawn_ranks, wait_ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
PORT = os.path.join(os.path.dirname(TESTS), "brax_tracking_tpu_torch")
RTOL, ATOL = 1e-7, 1e-8
RANKS, NUM_ENVS, UNROLL, BATCH, MINIBATCHES, UPDATES, EPISODE = 2, 8, 4, 8, 2, 2, 3
LOCAL_ENVS = NUM_ENVS // RANKS
N_UNROLLS = BATCH * MINIBATCHES // NUM_ENVS
LOCAL_ROWS = N_UNROLLS * LOCAL_ENVS
AXIS = "env"


# --- the JAX side: per-shard rollouts, the learner under shard_map -----------


def _jax_env():
    jm = jspec.build_model("builtin:minirat.xml", solver="cg", iterations=4, ls_iterations=4,
                           dtype=jnp.float64)
    qclip = _synth_qpos(jm.qpos0)
    jclip = jax.jit(lambda q: jclips.process_clip(jm, q))(jnp.asarray(qclip))
    jenv = jwrappers.wrap(jtracking.GenericSingleClip(reference_clip=jclip, dtype=jnp.float64,
                                                      **ENV_ARGS), episode_length=EPISODE)
    return jenv, qclip


def _jax_rollouts(jenv, jnet, params, normalizer, starts, shard_rngs, action_size):
    """Each shard's rollout, unsharded on its own envs (``starts``) from its
    own key as the JAX ``rollout_step`` runs it (train.py:247-289), and the
    action noise its policy drew; returns per shard (data, action eps)."""
    make_policy = jnetworks.make_inference_fn(jnet)
    unroll = jax.jit(lambda es, p, k: jacting.generate_unroll(
        jenv, es, make_policy(p), k, UNROLL, extra_fields=("truncation",), compact=True))
    out = []
    for js, rng in zip(starts, shard_rngs):
        _, unroll_rng, _ = jax.random.split(rng, 3)
        segments, boot_obs, action_eps = [], [], []
        u = unroll_rng
        for _ in range(N_UNROLLS):
            use_rng, u = jax.random.split(u)
            k, eps = use_rng, []
            for _ in range(UNROLL):
                cur, k = jax.random.split(k)
                eps.append(jax.random.normal(cur, (LOCAL_ENVS, action_size), jnp.float64))
            action_eps.append(jnp.stack(eps))
            js, segment = unroll(js, (normalizer, params.policy), use_rng)
            segments.append(segment)
            boot_obs.append(js.obs)

        def to_rows(x):
            x = jnp.swapaxes(x, 1, 2)
            return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])

        data = jax.tree_util.tree_map(lambda *xs: to_rows(jnp.stack(xs)), *segments)
        boot = jnp.stack(boot_obs)
        data = data.replace(next_observation=boot.reshape((-1,) + boot.shape[2:])[:, None, :])
        out.append((data, np.asarray(jnp.stack(action_eps))))
    return out


def _learn_draws(rng, action_size):
    """A shard's permutations and entropy noise recomputed from its key, as
    the JAX ``sgd_step`` / ``minibatch_step`` draw them (train.py:212-243)."""
    sgd_rng, _, _ = jax.random.split(rng, 3)
    perms, entropy_eps = [], []
    c = sgd_rng
    for _ in range(UPDATES):
        c, perm_rng, grad_rng = jax.random.split(c, 3)
        perms.append(np.asarray(jax.random.permutation(perm_rng, LOCAL_ROWS)))
        g, eps_pass = grad_rng, []
        for _ in range(MINIBATCHES):
            g, loss_rng = jax.random.split(g)
            eps_pass.append(np.swapaxes(np.asarray(jax.random.normal(
                loss_rng, (UNROLL, LOCAL_ROWS // MINIBATCHES, action_size), jnp.float64)), 0, 1))
        entropy_eps.append(np.stack(eps_pass))
    return sgd_rng, np.stack(perms), np.stack(entropy_eps)


def _jax_learner(jnet, optimizer):
    """The learner half of one training step under shard_map over two CPU
    devices: the normalizer update with ``pmean_axis_name``, the SGD passes
    with ``gradient_update_fn(pmap_axis_name=...)``, the metrics ``pmean``."""
    update = jgradients.gradient_update_fn(
        functools.partial(jlosses.compute_ppo_loss, ppo_network=jnet, **LOSS_HPARAMS),
        optimizer, pmap_axis_name=AXIS, has_aux=True)

    def learner(data, normalizer, params, opt_state, sgd_rng):
        normalizer = jrs.update(normalizer, data.observation, pmean_axis_name=AXIS)
        c, metrics = sgd_rng[0], []
        for _ in range(UPDATES):
            c, perm_rng, grad_rng = jax.random.split(c, 3)
            perm = jax.random.permutation(perm_rng, LOCAL_ROWS)
            g = grad_rng
            for rows in perm.reshape(MINIBATCHES, -1):
                g, loss_rng = jax.random.split(g)
                mb = jax.tree_util.tree_map(lambda x: x[rows], data)
                (_, m), params, opt_state = update(params, normalizer, mb, loss_rng,
                                                   optimizer_state=opt_state)
                metrics.append(m)
        stacked = {k: jnp.stack([m[k] for m in metrics]).reshape(UPDATES, MINIBATCHES)
                   for k in metrics[0]}
        return normalizer, params, opt_state, jax.lax.pmean(stacked, AXIS)

    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), (AXIS,))
    return jax.jit(shard_map_compat(learner, mesh=mesh,
                                    in_specs=(P(AXIS), P(), P(), P(), P(AXIS)),
                                    out_specs=(P(), P(), P(), P())))


def _port_names(tree, prefix):
    """The JAX params tree (policy, value: lists of kernel / bias) under the
    port's tensor names (``training_state_tensors``); Adam's moments by the
    optimizer's parameter index (policy's layers, then value's)."""
    out, i = {}, 0
    for part in ("policy", "value"):
        for j, layer in enumerate(getattr(tree, part)):
            for name, key in (("weight", "kernel"), ("bias", "bias")):
                a = np.asarray(layer[key])
                a = a.T if name == "weight" else a
                out[f"params.{part}.layers.{j}.{name}" if prefix == "params"
                    else f"adam.{i}.{prefix}"] = a
                i += 1
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results and the JAX side's, from one run of each."""
    tmp = tmp_path_factory.mktemp("ranks")
    port, port1 = free_ports(2)
    inp = str(tmp / "step_inputs.p")
    procs = spawn_ranks("ranks", lambda r: [inp, str(tmp / f"rank{r}.p"), str(port1)], RANKS,
                        port, str(tmp))
    try:
        jenv, qclip = _jax_env()
        keys = jax.random.split(jax.random.PRNGKey(0), NUM_ENVS).reshape(RANKS, LOCAL_ENVS, -1)
        starts = [jax.jit(jenv.reset)(k) for k in keys]
        obs_size, action_size = starts[0].obs.shape[-1], int(jenv.action_size)
        jnet = jnetworks.make_ppo_networks(obs_size, action_size,
                                           preprocess_observations_fn=jrs.normalize,
                                           policy_hidden_layer_sizes=HIDDEN,
                                           value_hidden_layer_sizes=HIDDEN)
        params = jlosses.PPONetworkParams(*(
            jnetworks.init_mlp(jax.random.PRNGKey(seed), HIDDEN + (out,), obs_size, jnp.float64)
            for seed, out in ((1, 2 * action_size), (2, 1))))
        normalizer = jrs.init_state(jnp.zeros((obs_size,), jnp.float64))
        optimizer = optax.adam(LR)
        opt_state = optimizer.init(params)
        shard_rngs = jax.random.split(jax.random.PRNGKey(3), RANKS)

        rollouts = _jax_rollouts(jenv, jnet, params, normalizer, starts, shard_rngs,
                                 action_size)
        per_rank, sgd_rngs = [], []
        for js, (_, eps), rng in zip(starts, rollouts, shard_rngs):
            sgd_rng, perms, entropy_eps = _learn_draws(rng, action_size)
            sgd_rngs.append(sgd_rng)
            per_rank.append(dict(cur_frame=np.asarray(js.info["cur_frame"]),
                                 qpos=np.asarray(js.pipeline_state.qpos),
                                 qvel=np.asarray(js.pipeline_state.qvel),
                                 action_eps=eps, perms=perms, entropy_eps=entropy_eps))
        step_inputs = dict(
            ranks=per_rank, qclip=qclip, env_args=ENV_ARGS, episode_length=EPISODE, lr=LR,
            loss_hparams=LOSS_HPARAMS,
            init_params={k: jax.tree_util.tree_map(np.asarray, getattr(params, k))
                         for k in ("policy", "value")})
        with open(inp + ".part", "wb") as f:
            pickle.dump(step_inputs, f)
        os.replace(inp + ".part", inp)

        data = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs),
                                      *[d for d, _ in rollouts])
        normalizer, params, opt_state, metrics = _jax_learner(jnet, optimizer)(
            data, normalizer, params, opt_state, jnp.stack(sgd_rngs))
        adam = opt_state[0]
        ref = dict(
            normalizer={k: np.asarray(getattr(normalizer, k))
                        for k in ("count", "mean", "summed_variance", "std")},
            metrics={k: np.asarray(v) for k, v in metrics.items()},
            params=_port_names(params, "params"), mu=_port_names(adam.mu, "exp_avg"),
            nu=_port_names(adam.nu, "exp_avg_sq"), count=int(adam.count),
            observation=[np.asarray(d.observation) for d, _ in rollouts])
        wait_ranks(procs, str(tmp))
    finally:
        wait_ranks(procs, str(tmp), timeout=1)
    out = []
    for r in range(RANKS):
        with open(tmp / f"rank{r}.p", "rb") as f:
            out.append(pickle.load(f))
    return out, ref, str(tmp)


# --- one training step against the JAX 2-shard composition -------------------


def test_ranks_are_two_gloo_processes(ranks):
    out, _, _ = ranks
    assert [(r["rank"], r["world_size"], r["backend"]) for r in out] == [
        (0, 2, "gloo"), (1, 2, "gloo")]
    assert out[0]["one_world_size"] == 1 and "one" not in out[1]


def test_step_rollout_matches_jax_shards(ranks):
    out, ref, _ = ranks
    for r in range(RANKS):
        np.testing.assert_allclose(out[r]["step"]["observation"], ref["observation"][r],
                                   rtol=RTOL, atol=ATOL)
    assert not np.allclose(ref["observation"][0], ref["observation"][1])


def test_step_normalizer_matches_jax(ranks):
    out, ref, _ = ranks
    for r in range(RANKS):
        for k, v in ref["normalizer"].items():
            np.testing.assert_allclose(out[r]["step"]["tensors"][f"normalizer.{k}"], v,
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(ref["normalizer"]["count"]) == RANKS * LOCAL_ROWS * UNROLL


def test_step_loss_metrics_match_jax(ranks):
    out, ref, _ = ranks
    for r in range(RANKS):
        m = out[r]["step"]["metrics"]
        assert m.keys() == ref["metrics"].keys()
        for k, v in ref["metrics"].items():
            assert m[k].shape == (UPDATES, MINIBATCHES)
            np.testing.assert_allclose(m[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("which", ["params", "mu", "nu"])
def test_step_params_and_adam_moments_match_jax(ranks, which):
    out, ref, _ = ranks
    assert ref["count"] == UPDATES * MINIBATCHES
    for r in range(RANKS):
        tensors = out[r]["step"]["tensors"]
        for name, v in ref[which].items():
            np.testing.assert_allclose(tensors[name], v, rtol=RTOL, atol=ATOL, err_msg=name)
        steps = {float(v) for k, v in tensors.items() if k.endswith(".step")}
        assert steps == {UPDATES * MINIBATCHES}


def test_step_state_bitwise_replicated(ranks):
    out, _, _ = ranks
    a, b = out[0]["step"]["tensors"], out[1]["step"]["tensors"]
    assert a.keys() == b.keys() and len(a) > 20
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- the port's train() over two ranks ----------------------------------------


def test_train_state_bitwise_equal_on_both_ranks(ranks):
    out, _, _ = ranks
    a, b = out[0]["pm_tensors"], out[1]["pm_tensors"]
    assert a.keys() == b.keys()
    assert {k.split(".")[0] for k in a} == {"params", "adam", "normalizer"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the normalizer counted both ranks' observations
    assert float(a["normalizer.count"]) == worker.PM_ARGS["num_timesteps"]
    for k in ("training/total_loss", "training/policy_loss", "training/v_loss",
              "training/entropy_loss"):
        assert out[0]["pm_metrics"][k] == out[1]["pm_metrics"][k], k


def test_train_evals_and_checkpoint_on_rank_zero_only(ranks):
    out, _, tmp = ranks
    steps = worker.PM_ARGS["num_timesteps"]
    assert out[0]["pm_evals"] == [0, steps] and out[1]["pm_evals"] == []
    assert "eval/episode_reward" in out[0]["pm_metrics"]
    assert not any(k.startswith("eval/") for k in out[1]["pm_metrics"])
    assert np.isfinite(out[1]["pm_metrics"]["training/sps"])
    assert out[0]["pm_written"] == ["ckpt", f"ckpt/{steps}"] and out[1]["pm_written"] == []
    saved = torch.load(os.path.join(tmp, "ckpt", str(steps), "training_state.pt"),
                       weights_only=True)
    for k, v in saved["params"].items():
        np.testing.assert_array_equal(v.numpy(), out[1]["pm_tensors"][f"params.{k}"])


def test_train_rank_folded_env_draws_differ(ranks):
    out, _, _ = ranks
    a, b = out[0]["pm_first_reset"], out[1]["pm_first_reset"]
    local = worker.PM_ARGS["num_envs"] // RANKS
    assert a.shape == b.shape == (local, 2) and not np.allclose(a, b)
    # rank 0 draws the undistributed run's stream
    gen = torch.Generator().manual_seed(worker.PM_ARGS["seed"])
    np.testing.assert_array_equal(
        a, (2.0 * torch.rand(local, 2, generator=gen, dtype=torch.float64) - 1.0).numpy())
    for rank in (0, 1, 2):
        g = dmesh.fold_process_key(5, rank, "cpu")
        assert (g.initial_seed() == 5) == (rank == 0)


def test_world_of_one_through_a_group_is_bitwise_no_group(ranks):
    """Stands in for tests/test_multiprocess.py's "the 2-process result
    matches the 1-process 8-device run": the port has no global program to
    lay out on other processes (each rank permutes and cuts its own rows), so
    the check is that the group's path adds nothing to a world of one."""
    out, _, _ = ranks
    (m1, t1, e1), (m0, t0, e0) = out[0]["one"], out[0]["none"]
    assert t1.keys() == t0.keys() and e1 == e0 == [0, worker.PM_ARGS["num_timesteps"]]
    for k in t0:
        np.testing.assert_array_equal(t1[k], t0[k], err_msg=k)
    timed = ("training/sps", "training/walltime", "eval/sps", "eval/walltime",
             "eval/epoch_eval_time")
    assert m1.keys() == m0.keys()
    assert {k: v for k, v in m1.items() if k not in timed} == {
        k: v for k, v in m0.items() if k not in timed}


# --- the normalizer, the errors, the imports ----------------------------------


def test_grouped_normalizer_update_matches_joined_batch(ranks):
    out, _, _ = ranks
    batches = np.random.default_rng(7).normal(size=(RANKS,) + worker.STATS_SHAPE)
    joined = torch.as_tensor(batches.reshape((-1, worker.STATS_SHAPE[-1])))
    st = trs.init_state(torch.zeros(worker.STATS_SHAPE[-1], dtype=torch.float64))
    for _ in range(2):
        st = trs.update(st, joined)
    for k, v in trs.state_to_numpy(st).items():
        np.testing.assert_array_equal(out[0]["stats"][k], out[1]["stats"][k], err_msg=k)
        np.testing.assert_allclose(out[0]["stats"][k], v, rtol=0, atol=1e-12, err_msg=k)


def test_replication_check_names_the_first_tensor_that_differs(ranks):
    out, _, _ = ranks
    for r in range(RANKS):
        msg = out[r]["mismatch"]
        assert msg is not None and msg.startswith("b is not replicated"), msg
    assert "on this rank" in out[1]["mismatch"] and "on another rank" in out[0]["mismatch"]


def test_num_envs_the_ranks_do_not_divide_raises():
    mesh = dmesh.TrainMesh(world_size=3, rank=0, local_rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        ttrain.train(worker.PointMass(), mesh=mesh, **worker.PM_ARGS)


def test_incomplete_torchrun_environment_raises(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    for k in dmesh.TORCHRUN_ENV[1:]:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="incomplete"):
        dmesh.make_train_mesh("cpu")


def test_distributed_code_imports_no_jax():
    files = glob.glob(os.path.join(PORT, "distributed", "*.py")) + [
        os.path.join(PORT, "harness", "launch.py"), os.path.join(TESTS, "_torch_dist_worker.py")]
    assert len(files) == 4
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "brax_tracking_tpu", "flax",
                                                 "optax", "orbax"), (path, mod)
