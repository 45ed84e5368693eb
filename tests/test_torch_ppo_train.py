"""One PPO training step of the port against the JAX package's pieces,
float64 on the CPU, on the minirat tracking env; and the port's trainer.

The reference is one training step composed from the JAX package's public
pieces in ``agents/ppo/train.py``'s order: ``acting.generate_unroll``
(compact) per unroll, the rows x time layout with the bootstrap
observation re-attached, ``running_statistics.update``, then per SGD pass a
``jax.random.permutation`` of the rows and ``losses.compute_ppo_loss`` under
``gradients.gradient_update_fn`` with ``optax.adam`` per minibatch. Every
draw the JAX side makes is recomputed here from its keys and handed to the
port's ``rollout_step`` / ``learn_step``; the params come across by
``params_from_numpy`` and the env state by ``init_state``.

Geometry: 8 envs, MLPs (32, 32), unroll_length 4, batch_size 8, 2
minibatches, 2 updates per batch, episode_length 3 (an auto-reset falls
inside each unroll), normalized observations.

Tolerance: rtol 1e-7, atol 1e-8 on the rollout, the normalizer, the loss
metrics, the params and both Adam moments (float64 on both sides; 80
physics substeps and 4 Adam steps apart only in summation order); ``done``
exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from brax_tracking_tpu.agents.ppo import losses as jlosses
from brax_tracking_tpu.agents.ppo import networks as jnetworks
from brax_tracking_tpu.data import clips as jclips
from brax_tracking_tpu.envs import tracking as jtracking
from brax_tracking_tpu.envs import wrappers as jwrappers
from brax_tracking_tpu.physics import spec as jspec
from brax_tracking_tpu.training import acting as jacting
from brax_tracking_tpu.training import checkpoint as jcheckpoint
from brax_tracking_tpu.training import gradients as jgradients
from brax_tracking_tpu.training import running_statistics as jrs
from brax_tracking_tpu_torch.agents.ppo import losses as tlosses
from brax_tracking_tpu_torch.agents.ppo import networks as tnetworks
from brax_tracking_tpu_torch.agents.ppo import train as ttrain
from brax_tracking_tpu_torch.data import clips as tclips
from brax_tracking_tpu_torch.envs import tracking as ttracking
from brax_tracking_tpu_torch.envs import wrappers as twrappers
from brax_tracking_tpu_torch.envs.base import Env, State
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.training import checkpoint as tcheckpoint
from brax_tracking_tpu_torch.training import gradients as tgradients
from brax_tracking_tpu_torch.training import running_statistics as trs

RTOL, ATOL = 1e-7, 1e-8
NUM_ENVS, HIDDEN, UNROLL, BATCH, MINIBATCHES, UPDATES, EPISODE = 8, (32, 32), 4, 8, 2, 2, 3
N_UNROLLS = BATCH * MINIBATCHES // NUM_ENVS
ROWS = BATCH * MINIBATCHES
LR = 3e-4
LOSS_HPARAMS = dict(entropy_cost=1e-3, discounting=0.99, reward_scaling=1.0, gae_lambda=0.95,
                    clipping_epsilon=0.3, normalize_advantage=True)

# configs/dataset/minirat.yaml env_args, as tests/test_torch_env.py builds the env
ENV_ARGS = dict(
    mjcf_path="builtin:minirat.xml", scale_factor=1.0, solver="cg", iterations=4,
    ls_iterations=4, torque_actuators=False, physics_steps_per_control_step=10,
    too_far_dist=0.1, bad_pose_dist=1000.0, bad_quat_dist=1000.0, ctrl_cost_weight=0.01,
    pos_reward_weight=1.0, quat_reward_weight=1.0, joint_reward_weight=10.0,
    angvel_reward_weight=1.0, bodypos_reward_weight=1.0, endeff_reward_weight=1.0,
    healthy_reward=0.25, healthy_z_range=(0.02, 0.5), terminate_when_unhealthy=True,
    free_jnt=True, center_of_mass="torso", strict_name_lookup=True,
    end_eff_names=["leg_FL", "leg_FR", "leg_BL", "leg_BR"],
    appendage_names=["leg_FL", "leg_FR", "leg_BL", "leg_BR"],
    body_names=["torso", "leg_FL", "leg_FR", "leg_BL", "leg_BR"],
    joint_names=["hip_FL", "hip_FR", "hip_BL", "hip_BR"],
)


def _synth_qpos(qpos0, T=64, walk=1.0):
    """bench.py's synthetic clip: qpos0, lifted 1 cm, walking along x."""
    qpos = np.tile(np.asarray(qpos0, np.float64), (T, 1))
    qpos[:, 2] += 0.01
    qpos[:, 0] += np.linspace(0.0, walk, T)
    return qpos


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(port, ref, **kw):
    kw = dict(dict(rtol=RTOL, atol=ATOL), **kw)
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **kw)


def _jax_step(jenv, js, obs_size, action_size):
    """One training step from the JAX package's pieces; returns everything
    it produced and every draw it made (as the port's tensors)."""
    jnet = jnetworks.make_ppo_networks(obs_size, action_size,
                                       preprocess_observations_fn=jrs.normalize,
                                       policy_hidden_layer_sizes=HIDDEN,
                                       value_hidden_layer_sizes=HIDDEN)
    init = lambda k, out: jnetworks.init_mlp(k, HIDDEN + (out,), obs_size, jnp.float64)
    params = jlosses.PPONetworkParams(policy=init(jax.random.PRNGKey(1), 2 * action_size),
                                      value=init(jax.random.PRNGKey(2), 1))
    init_params = jax.tree_util.tree_map(np.asarray, params)
    normalizer = jrs.init_state(jnp.zeros((obs_size,), jnp.float64))
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)
    make_policy = jnetworks.make_inference_fn(jnet)

    # rollout_step (train.py:247-289)
    sgd_rng, unroll_rng, _ = jax.random.split(jax.random.PRNGKey(3), 3)
    unroll = jax.jit(lambda es, p, k: jacting.generate_unroll(
        jenv, es, make_policy(p), k, UNROLL, extra_fields=("truncation",), compact=True))
    segments, boot_obs, action_eps = [], [], []
    r = unroll_rng
    for _ in range(N_UNROLLS):
        use_rng, r = jax.random.split(r)
        # generate_unroll's per-step keys and the policy's normal draws
        k, eps = use_rng, []
        for _ in range(UNROLL):
            cur, k = jax.random.split(k)
            eps.append(jax.random.normal(cur, (NUM_ENVS, action_size), jnp.float64))
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
    normalizer = jrs.update(normalizer, data.observation)

    # learn_step (train.py:212-243, 291-307)
    update = jax.jit(jgradients.gradient_update_fn(
        functools.partial(jlosses.compute_ppo_loss, ppo_network=jnet, **LOSS_HPARAMS),
        optimizer, pmap_axis_name=None, has_aux=True))
    perms, entropy_eps, metrics = [], [], []
    c = sgd_rng
    for _ in range(UPDATES):
        c, perm_rng, grad_rng = jax.random.split(c, 3)
        perm = jax.random.permutation(perm_rng, ROWS)
        perms.append(perm)
        g, eps_pass = grad_rng, []
        for rows in perm.reshape(MINIBATCHES, -1):
            g, loss_rng = jax.random.split(g)
            eps_pass.append(jnp.swapaxes(
                jax.random.normal(loss_rng, (UNROLL, BATCH, action_size), jnp.float64), 0, 1))
            mb = jax.tree_util.tree_map(lambda x: x[rows], data)
            (_, m), params, opt_state = update(params, normalizer, mb, loss_rng,
                                               optimizer_state=opt_state)
            metrics.append(m)
        entropy_eps.append(jnp.stack(eps_pass))
    return dict(
        init_params=init_params, data=data, normalizer=normalizer, params=params,
        adam=opt_state[0], metrics=metrics, action_eps=_t(jnp.stack(action_eps)),
        perms=_t(jnp.stack(perms)).long(), entropy_eps=_t(jnp.stack(entropy_eps)),
    )


@pytest.fixture(scope="module")
def step():
    jm = jspec.build_model("builtin:minirat.xml", solver="cg", iterations=4, ls_iterations=4,
                           dtype=jnp.float64)
    qclip = _synth_qpos(jm.qpos0)
    jclip = jax.jit(lambda q: jclips.process_clip(jm, q))(jnp.asarray(qclip))
    jenv = jwrappers.wrap(jtracking.GenericSingleClip(reference_clip=jclip, dtype=jnp.float64,
                                                      **ENV_ARGS), episode_length=EPISODE)
    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), NUM_ENVS))

    tm = tspec.load_model(device="cpu")
    tenv = twrappers.wrap(
        ttracking.GenericSingleClip(reference_clip=tclips.process_clip(tm, torch.as_tensor(qclip)),
                                    device="cpu", **ENV_ARGS),
        episode_length=EPISODE)
    ts = tenv.init_state(_t(js.info["cur_frame"]), _t(js.pipeline_state.qpos),
                         _t(js.pipeline_state.qvel))
    obs_size, action_size = ts.obs.shape[-1], tenv.action_size

    ref = _jax_step(jenv, js, obs_size, action_size)

    net = tnetworks.PPONetworks(
        tnetworks.params_from_numpy(ref["init_params"].policy, device="cpu"),
        tnetworks.params_from_numpy(ref["init_params"].value, device="cpu"),
        tnetworks.NormalTanhDistribution(action_size), tnetworks.normalize_preprocessor)
    state = ttrain.TrainingState(
        params=net, optimizer=tgradients.make_optimizer(net.parameters(), LR),
        normalizer_params=trs.init_state(torch.zeros(obs_size, dtype=torch.float64)),
        env_steps=0)
    ts, data, normalizer = ttrain.rollout_step(tenv, tnetworks.make_inference_fn(net), state, ts,
                                               ref["action_eps"])
    state, metrics = ttrain.learn_step(
        state, data, normalizer, ref["perms"], ref["entropy_eps"],
        functools.partial(tlosses.compute_ppo_loss, **LOSS_HPARAMS),
        steps_per_train_step=ROWS * UNROLL)
    return ref, data, state, metrics


@pytest.mark.parametrize("field", ["observation", "reward", "truncation", "next_observation",
                                   "log_prob", "raw_action"])
def test_rollout_matches_jax(step, field):
    ref, data, _, _ = step
    get = {"truncation": lambda d: d.extras["state_extras"]["truncation"],
           "log_prob": lambda d: d.extras["policy_extras"]["log_prob"],
           "raw_action": lambda d: d.extras["policy_extras"]["raw_action"]}.get(
        field, lambda d: getattr(d, field))
    assert get(data).shape == get(ref["data"]).shape
    _close(get(data), get(ref["data"]))


def test_rollout_done_exact_and_covers_resets(step):
    ref, data, _, _ = step
    done = 1 - data.discount
    np.testing.assert_array_equal(done.numpy(), 1 - np.asarray(ref["data"].discount))
    assert data.discount.shape == (ROWS, UNROLL)
    # episodes of at most 3 steps: every row's 4 steps hold a done
    assert done.any(dim=1).all()
    assert float(data.extras["state_extras"]["truncation"].sum()) > 0


def test_normalizer_matches_jax(step):
    ref, _, state, _ = step
    for k in ("count", "mean", "summed_variance", "std"):
        _close(getattr(state.normalizer_params, k), getattr(ref["normalizer"], k))


def test_loss_metrics_match_jax(step):
    ref, _, _, metrics = step
    assert metrics.keys() == ref["metrics"][0].keys()
    for k, v in metrics.items():
        assert v.shape == (UPDATES, MINIBATCHES)
        _close(v.reshape(-1), [m[k] for m in ref["metrics"]])


def test_params_and_adam_moments_match_jax(step):
    ref, _, state, _ = step
    assert state.env_steps == ROWS * UNROLL
    adam = ref["adam"]
    assert int(adam.count) == UPDATES * MINIBATCHES
    net, opt = state.params, state.optimizer
    for mlp, jp, mu, nu in ((net.policy, ref["params"].policy, adam.mu.policy, adam.nu.policy),
                            (net.value, ref["params"].value, adam.mu.value, adam.nu.value)):
        for layer, p, m, n in zip(mlp.layers, jp, mu, nu):
            for name, key in (("weight", "kernel"), ("bias", "bias")):
                tr = (lambda a: np.asarray(a).T) if name == "weight" else np.asarray
                param = getattr(layer, name)
                _close(param, tr(p[key]))
                _close(opt.state[param]["exp_avg"], tr(m[key]))
                _close(opt.state[param]["exp_avg_sq"], tr(n[key]))
                assert int(opt.state[param]["step"]) == UPDATES * MINIBATCHES


# --- the port's trainer (no JAX reference) ------------------------------------


@dataclasses.dataclass
class _Pos:
    pos: torch.Tensor

    def tensors(self):
        return {"pos": self.pos}

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


class PointMass(Env):
    """2-D point mass steering to the origin, batched (tests/test_ppo.py's)."""

    def reset(self, generator, batch_size):
        pos = 2.0 * torch.rand(batch_size, 2, generator=generator, dtype=torch.float64) - 1.0
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


PM_ARGS = dict(episode_length=32, num_envs=64, learning_rate=3e-4, entropy_cost=1e-3,
               discounting=0.95, unroll_length=8, batch_size=64, num_minibatches=4,
               num_updates_per_batch=4, num_eval_envs=64, normalize_observations=True, seed=0,
               device="cpu")


def test_train_learns_point_mass():
    """tests/test_ppo.py's run: a random policy scores ~ -32 * 0.6."""
    evals = []
    _, (normalizer, policy), metrics = ttrain.train(
        PointMass(), num_timesteps=2 ** 15, num_evals=3,
        progress_fn=lambda step, m: evals.append((step, m["eval/episode_reward"])), **PM_ARGS)
    assert [s for s, _ in evals] == [0, 2 ** 14, 2 ** 15]
    assert evals[-1][1] > evals[0][1] + 5.0, evals
    assert metrics["eval/episode_reward"] > -12.0, metrics
    assert metrics["eval/avg_episode_length"] == 32
    for k in ("eval/episode_reward_std", "eval/episode_distance", "eval/epoch_eval_time",
              "eval/sps", "eval/walltime", "training/sps", "training/total_loss",
              "training/policy_loss", "training/v_loss", "training/entropy_loss"):
        assert np.isfinite(metrics[k]), k
    assert float(normalizer.count) == 2 ** 15


class _Clock:
    """A host clock that advances ``tick`` seconds per reading."""

    def __init__(self, tick):
        self.t, self.tick = 0.0, tick

    def perf_counter(self):
        self.t += self.tick
        return self.t


def test_training_sps_counts_each_reset_once(monkeypatch):
    """With 2 resets per eval, each epoch call reports its own steps over its
    own time; the JAX package multiplies by the resets too (ROADMAP C)."""
    monkeypatch.setattr(ttrain, "time", _Clock(0.5))
    seen = []
    ttrain.train(PointMass(), num_timesteps=2 * 2048, num_evals=2, num_resets_per_eval=2,
                 progress_fn=lambda step, m: seen.append((step, m)), **PM_ARGS)
    step, m = seen[-1]
    assert step == 2 * 2048
    # one training step of 4 * 64 * 8 env steps per epoch call, 0.5 s apart
    assert m["training/sps"] == 2048 / 0.5


def _state_tensors(state):
    out = {f"params.{k}": v for k, v in state.params.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in s.items()})
    out.update({f"normalizer.{k}": v for k, v in
                dataclasses.asdict(state.normalizer_params).items()})
    return out


def test_checkpoint_round_trip_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _, (normalizer, policy), _ = ttrain.train(PointMass(), num_timesteps=4096, num_evals=2,
                                              checkpoint_dir=ckpt, **PM_ARGS)
    path = tcheckpoint.latest_checkpoint(ckpt)
    assert path.endswith("4096") and tcheckpoint.checkpoint_layout(path) == "full"
    assert tcheckpoint.latest_checkpoint(str(tmp_path / "missing")) is None

    def fresh(seed):
        gen = torch.Generator().manual_seed(seed)
        net = tnetworks.make_ppo_networks(2, 2, generator=gen, device="cpu")
        return ttrain.TrainingState(
            params=net, optimizer=tgradients.make_optimizer(net.parameters(), 3e-4),
            normalizer_params=trs.init_state(torch.zeros(2, dtype=torch.float64)), env_steps=0)

    restored = tcheckpoint.restore_checkpoint(path, fresh(1))
    assert restored.env_steps == 4096
    # the restored policy is the trained one, bitwise
    for a, b in zip(restored.params.policy.parameters(), policy.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(restored.normalizer_params.mean, normalizer.mean)
    # save what was restored, restore it into another fresh state: every
    # tensor bitwise, the Adam step included
    tcheckpoint.save_checkpoint(str(tmp_path / "again"), restored)
    again = tcheckpoint.restore_checkpoint(str(tmp_path / "again"), fresh(2))
    a, b = _state_tensors(restored), _state_tensors(again)
    assert a.keys() == b.keys() and any(k.endswith(".step") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert again.env_steps == 4096

    # resume: the run continues from the restored step count
    seen = []
    ttrain.train(PointMass(), num_timesteps=4096, num_evals=2, restore_checkpoint_path=path,
                 progress_fn=lambda step, m: seen.append(step), **PM_ARGS)
    assert seen == [4096, 8192]

    # pickled params (brax.io.model parity)
    tcheckpoint.save_params(str(tmp_path / "params.pkl"), (normalizer, policy))
    nrm, pol = tcheckpoint.load_params(str(tmp_path / "params.pkl"))
    np.testing.assert_array_equal(nrm["mean"], normalizer.mean.numpy())
    for p, layer in zip(pol, policy.layers):
        np.testing.assert_array_equal(p["kernel"], layer.weight.detach().numpy().T)


def test_train_zero_timesteps_returns_init():
    make_policy, (normalizer, policy), metrics = ttrain.train(PointMass(), num_timesteps=0,
                                                              **PM_ARGS)
    assert metrics == {} and float(normalizer.count) == 0
    act, extras = make_policy((normalizer, policy), deterministic=True)(
        torch.zeros(3, 2, dtype=torch.float64), None)
    assert act.shape == (3, 2) and extras == {}


def test_errors(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="divide by num_envs"):
        ttrain.train(PointMass(), num_timesteps=64, **dict(PM_ARGS, num_envs=48))
    # a bfloat16 compute dtype (ROADMAP A.15, ported): the params stay
    # float64, the outputs come back in the input's dtype
    bf16 = tnetworks.make_ppo_networks(2, 2, compute_dtype=torch.bfloat16,
                                       generator=torch.Generator(), device="cpu")
    assert bf16.compute_dtype == torch.bfloat16
    assert {p.dtype for p in bf16.parameters()} == {torch.float64}
    out = bf16.policy_logits(None, torch.ones(3, 2, dtype=torch.float64))
    assert out.dtype == torch.float64 and out.shape == (3, 4)
    # per-env models need a physics model (their tests:
    # test_torch_randomize.py)
    with pytest.raises(TypeError, match="physics model"):
        ttrain.train(PointMass(), num_timesteps=64,
                     randomization_fn=lambda m, num_envs, generator: (m, ()), **PM_ARGS)
    # an orbax checkpoint of the JAX package (ROADMAP A.13, ported) restores
    # where its tree is a training state; another tree raises naming why
    # (the restores themselves: tests/test_torch_orbax.py)
    orbax_dir = str(tmp_path / "orbax" / "100")
    jcheckpoint.save_checkpoint(orbax_dir, {"x": jnp.ones(3)})
    assert tcheckpoint.checkpoint_layout(orbax_dir) == "unknown"
    with pytest.raises(ValueError, match="neither"):
        ttrain.train(PointMass(), num_timesteps=2048, restore_checkpoint_path=orbax_dir,
                     **PM_ARGS)
    ref_dir = str(tmp_path / "orbax" / "reference")
    jnet = lambda k, out: jnetworks.init_mlp(k, (256, 256, out), 2, jnp.float64)
    jcheckpoint.save_checkpoint(ref_dir, (jrs.init_state(jnp.ones((2,), jnp.float64)),
                                          jlosses.PPONetworkParams(
                                              policy=jnet(jax.random.PRNGKey(0), 4),
                                              value=jnet(jax.random.PRNGKey(1), 1))))
    assert tcheckpoint.checkpoint_layout(ref_dir) == "reference"
    seen = []
    ttrain.train(PointMass(), num_timesteps=2048, num_evals=2, restore_checkpoint_path=ref_dir,
                 progress_fn=lambda step, m: seen.append(step), **PM_ARGS)
    assert seen == [0, 2048]
    # the default device is the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {k: v for k, v in PM_ARGS.items() if k != "device"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(PointMass(), num_timesteps=64, **args)
