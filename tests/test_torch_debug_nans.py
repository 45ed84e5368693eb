"""``debug_nans`` (training/debug_nans.py) against the JAX package's
``jax_debug_nans``, on the CPU in float64.

The JAX flag checks the outputs of each jitted call and, on a NaN, replays
the call op by op and raises ``FloatingPointError``; the port checks the
outputs of its counterparts (the env reset, ``rollout_step``,
``learn_step``, the evaluator's unroll) and replays under a dispatch mode
that names the aten op. Held here on the minirat env (8 envs, MLPs 32 x 32,
4 control steps, episode length 3 so an auto-reset falls inside the
unroll), the same env, states, params and action noise on both sides:

- a clean unroll raises in neither package, and the port's outputs with the
  mode on are bitwise its outputs with it off;
- a NaN in a policy bias raises ``FloatingPointError`` in both; the port's
  names an aten op and the line of ``agents/ppo/networks.py`` that ran it;
- one env's NaN qvel, masked by the tracking env's NaN guard and the
  auto-reset, reaches no output and raises in neither (established on the
  JAX side here, pinned on both);
- a NaN made by the learner half (a NaN value-head bias, which the rollout
  does not read) is found by replaying ``learn_step`` from its restored
  inputs (the modules and the optimizer it updates in place);
- the kernels' launch wrappers check their outputs only during a replay;
- ``train()`` with the mode on is bitwise ``train()`` with it off, and a
  NaN policy bias raises from ``train()``; with the mode off ``call``
  neither clones nor reads the outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tracking_tpu.agents.ppo import networks as jnetworks
from brax_tracking_tpu.data import clips as jclips
from brax_tracking_tpu.envs import tracking as jtracking
from brax_tracking_tpu.envs import wrappers as jwrappers
from brax_tracking_tpu.physics import spec as jspec
from brax_tracking_tpu.training import acting as jacting
from brax_tracking_tpu.training import running_statistics as jrs
from brax_tracking_tpu_torch.agents.ppo import networks as tnetworks
from brax_tracking_tpu_torch.agents.ppo import train as ttrain
from brax_tracking_tpu_torch.data import clips as tclips
from brax_tracking_tpu_torch.envs import tracking as ttracking
from brax_tracking_tpu_torch.envs import wrappers as twrappers
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.training import debug_nans
from brax_tracking_tpu_torch.training import gradients as tgradients
from brax_tracking_tpu_torch.training import running_statistics as trs
from test_torch_ppo_train import ENV_ARGS, PM_ARGS, PointMass, _synth_qpos

NUM_ENVS, HIDDEN, UNROLL, EPISODE = 8, (32, 32), 4, 3


@pytest.fixture(scope="module")
def envs():
    """The JAX env and its jitted unroll, the port's env, both first states,
    the JAX policy params and the unroll's action noise."""
    jm = jspec.build_model("builtin:minirat.xml", solver="cg", iterations=4, ls_iterations=4,
                           dtype=jnp.float64)
    qclip = _synth_qpos(jm.qpos0)
    jclip = jax.jit(lambda q: jclips.process_clip(jm, q))(jnp.asarray(qclip))
    jenv = jwrappers.wrap(jtracking.GenericSingleClip(reference_clip=jclip, dtype=jnp.float64,
                                                      **ENV_ARGS), episode_length=EPISODE)
    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), NUM_ENVS))
    obs_size, action_size = js.obs.shape[-1], jenv.action_size
    jnet = jnetworks.make_ppo_networks(obs_size, action_size,
                                       preprocess_observations_fn=jrs.normalize,
                                       policy_hidden_layer_sizes=HIDDEN,
                                       value_hidden_layer_sizes=HIDDEN)
    make_policy = jnetworks.make_inference_fn(jnet)
    unroll = lambda es, p, k: jacting.generate_unroll(
        jenv, es, make_policy(p), k, UNROLL, extra_fields=("truncation",), compact=True)
    policy = jnetworks.init_mlp(jax.random.PRNGKey(1), HIDDEN + (2 * action_size,), obs_size,
                                jnp.float64)
    value = jnetworks.init_mlp(jax.random.PRNGKey(2), HIDDEN + (1,), obs_size, jnp.float64)
    normalizer = jrs.init_state(jnp.zeros((obs_size,), jnp.float64))
    key = jax.random.PRNGKey(5)
    k, eps = key, []
    for _ in range(UNROLL):
        cur, k = jax.random.split(k)
        eps.append(jax.random.normal(cur, (NUM_ENVS, action_size), jnp.float64))

    tm = tspec.load_model(device="cpu")
    tenv = twrappers.wrap(
        ttracking.GenericSingleClip(reference_clip=tclips.process_clip(tm, torch.as_tensor(qclip)),
                                    device="cpu", **ENV_ARGS),
        episode_length=EPISODE)
    ts = tenv.init_state(torch.as_tensor(np.array(js.info["cur_frame"])),
                         torch.as_tensor(np.array(js.pipeline_state.qpos)),
                         torch.as_tensor(np.array(js.pipeline_state.qvel)))
    return dict(jenv=jenv, js=js, unroll=unroll, policy=policy, value=value,
                normalizer=normalizer, key=key, tenv=tenv, ts=ts,
                eps=torch.as_tensor(np.array(jnp.stack(eps)))[None])


def _jax_raises(envs, state, policy, jitted=None):
    """Whether the JAX unroll raises FloatingPointError under jax_debug_nans,
    called through a fresh jit (or through ``jitted``). A jit that has run
    once misses the NaN outputs of its later calls (see
    test_jax_checks_only_the_first_call_of_a_jit), so a raise is asked of a
    jit's first call, as the first NaN of a run would be checked."""
    jitted = jax.jit(lambda *a: envs["unroll"](*a)) if jitted is None else jitted
    jax.config.update("jax_debug_nans", True)
    try:
        out = jitted(state, (envs["normalizer"], policy), envs["key"])
        jax.block_until_ready(out)
        return False
    except FloatingPointError:
        return True
    finally:
        jax.config.update("jax_debug_nans", False)


def _jax_nan_outputs(envs, state, policy, jitted):
    """The paths of the JAX unroll's floating outputs that hold a NaN."""
    out = jitted(state, (envs["normalizer"], policy), envs["key"])
    return [jax.tree_util.keystr(p) for p, x in jax.tree_util.tree_leaves_with_path(out)
            if jnp.issubdtype(x.dtype, jnp.floating) and bool(jnp.isnan(x).any())]


@pytest.fixture(scope="module")
def checked_jit(envs):
    """A jit of the JAX unroll whose first call, clean, ran under
    jax_debug_nans: (the jit, whether that call raised)."""
    jitted = jax.jit(lambda *a: envs["unroll"](*a))
    return jitted, _jax_raises(envs, envs["js"], envs["policy"], jitted)


def _port_state(envs, policy_bias_nan=False, value_bias_nan=False):
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    policy = tnetworks.params_from_numpy(to_np(envs["policy"]), device="cpu")
    value = tnetworks.params_from_numpy(to_np(envs["value"]), device="cpu")
    with torch.no_grad():
        if policy_bias_nan:
            policy.layers[1].bias[3] = float("nan")
        if value_bias_nan:
            value.layers[0].bias[5] = float("nan")
    net = tnetworks.PPONetworks(policy, value,
                                tnetworks.NormalTanhDistribution(envs["tenv"].action_size),
                                tnetworks.normalize_preprocessor)
    obs_size = envs["ts"].obs.shape[-1]
    return ttrain.TrainingState(
        params=net, optimizer=tgradients.make_optimizer(net.parameters(), 3e-4),
        normalizer_params=trs.init_state(torch.zeros(obs_size, dtype=torch.float64)),
        env_steps=0)


def _rollout(envs, state, env_state):
    return debug_nans.call("rollout_step", ttrain.rollout_step, envs["tenv"],
                           tnetworks.make_inference_fn(state.params), state, env_state,
                           envs["eps"])


def _tensors(x, out=None):
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def _bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) and ta
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or (x.is_floating_point() and
                                     torch.equal(torch.isnan(x), torch.isnan(y))
                                     and torch.equal(x[~torch.isnan(x)], y[~torch.isnan(y)]))


def test_clean_unroll_raises_in_neither_and_the_mode_changes_nothing(envs, checked_jit):
    assert not checked_jit[1]
    state = _port_state(envs)
    off = _rollout(envs, state, envs["ts"])
    with debug_nans.debug_nans():
        on = _rollout(envs, state, envs["ts"])
    _bitwise(off, on)
    assert not debug_nans.has_nan(on)


def test_nan_policy_bias_raises_in_both(envs):
    policy = jax.tree_util.tree_map(lambda x: x, envs["policy"])
    policy[1]["bias"] = policy[1]["bias"].at[3].set(jnp.nan)
    assert _jax_raises(envs, envs["js"], policy)
    state = _port_state(envs, policy_bias_nan=True)
    with debug_nans.debug_nans(), pytest.raises(FloatingPointError) as e:
        _rollout(envs, state, envs["ts"])
    msg = str(e.value)
    assert "aten." in msg and "agents/ppo/networks.py" in msg and "rollout_step" in msg, msg
    # with the mode off the NaN goes on, unreported
    _rollout(envs, state, envs["ts"])


def test_jax_checks_only_the_first_call_of_a_jit(envs, checked_jit):
    """A finding in the JAX package (jax 0.9): jax_debug_nans checks a jitted
    unroll's outputs on its first call, but a later call of the same jit
    returns NaN outputs without a raise (its fast dispatch path skips the
    check). The port checks every call (ROADMAP C)."""
    policy = jax.tree_util.tree_map(lambda x: x, envs["policy"])
    policy[1]["bias"] = policy[1]["bias"].at[3].set(jnp.nan)
    jitted, _ = checked_jit
    assert not _jax_raises(envs, envs["js"], policy, jitted)
    assert "[1].extras['policy_extras']['log_prob']" in _jax_nan_outputs(
        envs, envs["js"], policy, jitted)


def test_masked_nan_qvel_raises_in_neither(envs, checked_jit):
    """One env's NaN qvel: the tracking env's NaN guard ends its episode and
    the auto-reset restores it inside the unroll, so no output holds a NaN
    (jax_debug_nans, which checks the outputs, has nothing to raise on) and
    neither package raises."""
    js = envs["js"]
    bad = js.replace(pipeline_state=js.pipeline_state.replace(
        qvel=js.pipeline_state.qvel.at[0, 3].set(jnp.nan)))
    assert _jax_nan_outputs(envs, bad, envs["policy"], checked_jit[0]) == []
    ts = envs["ts"]
    qvel = ts.pipeline_state.qvel.clone()
    qvel[0, 3] = float("nan")
    bad_ts = ts.replace(pipeline_state=ts.pipeline_state.replace(qvel=qvel))
    state = _port_state(envs)
    with debug_nans.debug_nans():
        env_state, data, _ = _rollout(envs, state, bad_ts)
    assert not debug_nans.has_nan((env_state, data))
    # the guard ended env 0's episode at its first step
    assert float(data.discount[0, 0]) == 0.0


def test_learner_nan_replays_learn_step(envs):
    import functools

    from brax_tracking_tpu_torch.agents.ppo import losses as tlosses

    state = _port_state(envs, value_bias_nan=True)
    with debug_nans.debug_nans():
        env_state, data, normalizer = _rollout(envs, state, envs["ts"])
        rows = data.observation.shape[0]
        perms = torch.arange(rows)[None]
        eps = torch.zeros(1, 1, rows, UNROLL, envs["tenv"].action_size, dtype=torch.float64)
        with pytest.raises(FloatingPointError) as e:
            debug_nans.call("learn_step", ttrain.learn_step, state, data, normalizer, perms, eps,
                            functools.partial(tlosses.compute_ppo_loss), 32)
    # the replay ran from the restored inputs: the first op to make a NaN is
    # the value head's, not an op on the NaN parameters the first run left
    msg = str(e.value)
    assert "learn_step" in msg and "aten." in msg and "agents/ppo/networks.py" in msg, msg


def test_kernel_outputs_checked_only_during_a_replay():
    out = torch.tensor([1.0, float("nan")])
    debug_nans.check_kernel("cg_solve_fused", [out])  # outside a replay: nothing
    with debug_nans.debug_nans():
        debug_nans.check_kernel("cg_solve_fused", [out])
    with pytest.raises(FloatingPointError, match="the kernel spd_inverse"):
        with debug_nans.checking("a unit case"):
            debug_nans.check_kernel("spd_inverse", [torch.ones(2), out])
    with debug_nans.checking("a unit case"):
        debug_nans.check_kernel("spd_inverse", [torch.ones(2), torch.tensor([float("inf")])])


def _pm_train(**kw):
    return ttrain.train(PointMass(), num_timesteps=2048, num_evals=2,
                        network_factory=lambda *a, **k: tnetworks.make_ppo_networks(
                            *a, policy_hidden_layer_sizes=(16, 16),
                            value_hidden_layer_sizes=(16, 16), **k),
                        **dict(PM_ARGS, **kw))


def test_train_with_the_mode_is_bitwise_and_raises_on_a_nan_bias(monkeypatch):
    _, (n_off, p_off), m_off = _pm_train()
    with debug_nans.debug_nans():
        _, (n_on, p_on), m_on = _pm_train()
    _bitwise((n_off, list(p_off.parameters())), (n_on, list(p_on.parameters())))
    assert m_off["eval/episode_reward"] == m_on["eval/episode_reward"]

    def nan_bias_networks(*a, **k):
        net = tnetworks.make_ppo_networks(*a, policy_hidden_layer_sizes=(16, 16),
                                          value_hidden_layer_sizes=(16, 16), **k)
        with torch.no_grad():
            net.policy.layers[0].bias[0] = float("nan")
        return net

    with debug_nans.debug_nans(), pytest.raises(FloatingPointError, match="aten."):
        ttrain.train(PointMass(), num_timesteps=2048, num_evals=2,
                     network_factory=nan_bias_networks, **PM_ARGS)

    # with the mode off: no clone, no read of the outputs
    def forbidden(*a, **k):
        raise AssertionError("debug_nans cloned or read with the mode off")

    monkeypatch.setattr(debug_nans, "_Snapshot", forbidden)
    monkeypatch.setattr(debug_nans, "has_nan", forbidden)
    _pm_train()
