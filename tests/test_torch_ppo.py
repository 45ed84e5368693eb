"""The port's PPO pieces against the JAX package's, float64 on the CPU.

Seeded numpy inputs go through the JAX function and its counterpart in
``brax_tracking_tpu_torch``: the action distribution (given the draw
``jax.random.normal`` makes from the JAX side's key), GAE, the running
statistics, the MLPs (params carried across by ``params_from_numpy``), the
PPO loss with its gradients, and Adam steps against ``optax.adam``.

Tolerance: rtol 1e-9, atol 1e-10 (both sides compute the same float64
expressions; they differ in summation order only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu.agents.ppo import losses as jlosses
from brax_tracking_tpu.agents.ppo import networks as jnetworks
from brax_tracking_tpu.training import distribution as jdistribution
from brax_tracking_tpu.training import gradients as jgradients
from brax_tracking_tpu.training import running_statistics as jrs
from brax_tracking_tpu.training.types import Transition as JTransition
from brax_tracking_tpu_torch.agents.ppo import losses as tlosses
from brax_tracking_tpu_torch.agents.ppo import networks as tnetworks
from brax_tracking_tpu_torch.training import distribution as tdistribution
from brax_tracking_tpu_torch.training import gradients as tgradients
from brax_tracking_tpu_torch.training import running_statistics as trs
from brax_tracking_tpu_torch.training.types import Transition as TTransition

RTOL, ATOL = 1e-9, 1e-10
OBS, ACT, B, T = 7, 3, 6, 5
HIDDEN = (16, 12)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port.detach()) if isinstance(port, torch.Tensor)
                               else np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


# --- distribution -----------------------------------------------------------


@pytest.mark.parametrize("fn", ["sample_no_postprocessing", "log_prob", "mode", "entropy"])
def test_normal_tanh_matches_jax(fn):
    rng = np.random.RandomState(0)
    # wide logits: the softplus far above and below zero, tanh near saturation
    logits = rng.normal(0.0, 4.0, (4, 5, 2 * ACT))
    key = jax.random.PRNGKey(3)
    jd = jdistribution.NormalTanhDistribution(event_size=ACT)
    td = tdistribution.NormalTanhDistribution(event_size=ACT)
    assert td.param_size == jd.param_size == 2 * ACT
    # the draw the JAX side makes from its key, handed to the port as eps
    eps = jax.random.normal(key, (4, 5, ACT), jnp.float64)
    if fn == "sample_no_postprocessing":
        ref, got = jd.sample_no_postprocessing(jnp.asarray(logits), key), td.sample_no_postprocessing(_t(logits), _t(eps))
    elif fn == "log_prob":
        pre = rng.normal(0.0, 2.0, (4, 5, ACT))
        ref, got = jd.log_prob(jnp.asarray(logits), jnp.asarray(pre)), td.log_prob(_t(logits), _t(pre))
    elif fn == "mode":
        ref, got = jd.mode(jnp.asarray(logits)), td.mode(_t(logits))
    else:
        ref, got = jd.entropy(jnp.asarray(logits), key), td.entropy(_t(logits), _t(eps))
    assert got.shape == ref.shape
    _close(got, ref)


# --- GAE and running statistics ---------------------------------------------


@pytest.mark.parametrize("lam,disc", [(0.95, 0.99), (1.0, 0.9)])
def test_compute_gae_matches_jax(lam, disc):
    rng = np.random.RandomState(1)
    truncation = (rng.rand(T, B) < 0.2).astype(np.float64)
    termination = (rng.rand(T, B) < 0.2).astype(np.float64) * (1 - truncation)
    assert truncation.any() and termination.any()
    rewards, values, bootstrap = rng.randn(T, B), rng.randn(T, B), rng.randn(B)
    jvs, jadv = jlosses.compute_gae(*map(jnp.asarray, (truncation, termination, rewards, values,
                                                      bootstrap)), lambda_=lam, discount=disc)
    values_t = _t(values).requires_grad_()
    tvs, tadv = tlosses.compute_gae(_t(truncation), _t(termination), _t(rewards), values_t,
                                    _t(bootstrap), lambda_=lam, discount=disc)
    _close(tvs, jvs)
    _close(tadv, jadv)
    assert not tvs.requires_grad and not tadv.requires_grad


def test_running_statistics_update_matches_jax():
    rng = np.random.RandomState(2)
    batches = [rng.normal(3.0, 2.0, (4, 3, OBS)), rng.normal(-1.0, 0.5, (9, OBS))]
    js = jrs.init_state(jnp.zeros((OBS,)))
    ts = trs.init_state(torch.zeros(OBS, dtype=torch.float64))
    for b in batches:
        js = jrs.update(js, jnp.asarray(b))
        ts = trs.update(ts, _t(b))
        for k in ("count", "mean", "summed_variance", "std"):
            _close(getattr(ts, k), getattr(js, k))
    x = rng.randn(5, OBS)
    _close(trs.normalize(_t(x), ts), jrs.normalize(jnp.asarray(x), js))
    _close(trs.denormalize(_t(x), ts), jrs.denormalize(jnp.asarray(x), js))
    back = trs.state_from_numpy(trs.state_to_numpy(ts), device="cpu")
    for k in ("count", "mean", "summed_variance", "std"):
        assert torch.equal(getattr(back, k), getattr(ts, k))


# --- networks ------------------------------------------------------------------


def _jax_mlp(key, sizes, obs=OBS):
    return jax.tree_util.tree_map(np.asarray, jnetworks.init_mlp(key, sizes, obs, jnp.float64))


@pytest.mark.parametrize("batch", [(B,), (B, T)])
def test_mlp_matches_apply_mlp(batch):
    params = _jax_mlp(jax.random.PRNGKey(4), (16, 12, 2 * ACT))
    x = np.random.RandomState(4).randn(*batch, OBS)
    ref = jnetworks.apply_mlp(params, jnp.asarray(x), jax.nn.swish)
    got = tnetworks.params_from_numpy(params, device="cpu")(_t(x))
    assert got.shape == batch + (2 * ACT,)
    _close(got, ref)


def test_params_round_trip():
    params = _jax_mlp(jax.random.PRNGKey(5), (16, 12, 1))
    back = tnetworks.params_to_numpy(tnetworks.params_from_numpy(params, device="cpu"))
    assert len(back) == len(params)
    for p, q in zip(params, back):
        assert p.keys() == q.keys()
        for k in p:
            assert q[k].dtype == p[k].dtype and np.array_equal(q[k], p[k])


def test_init_bounds_and_zero_biases():
    gen = torch.Generator().manual_seed(0)
    net = tnetworks.make_ppo_networks(OBS, ACT, policy_hidden_layer_sizes=(64, 32),
                                      value_hidden_layer_sizes=(48,), generator=gen, device="cpu")
    assert net.policy.layers[-1].out_features == 2 * ACT
    assert net.value_fn(None, torch.zeros(B, T, OBS, dtype=torch.float64)).shape == (B, T)
    for mlp in (net.policy, net.value):
        for layer in mlp.layers:
            bound = np.sqrt(3.0 / layer.in_features)
            w = layer.weight.detach()
            assert w.dtype == torch.float64
            assert float(w.abs().max()) <= bound
            # uniform over the range, not nn.Linear's narrower default
            assert float(w.abs().max()) > 0.9 * bound
            assert torch.count_nonzero(layer.bias) == 0


# --- loss and gradient step ------------------------------------------------------


def _minibatch(seed):
    """A seeded minibatch in the trainer's rows x time layout, the JAX
    networks' params and a normalizer fed from the observations."""
    rng = np.random.RandomState(seed)
    jnet = jnetworks.make_ppo_networks(OBS, ACT, preprocess_observations_fn=jrs.normalize,
                                       policy_hidden_layer_sizes=HIDDEN,
                                       value_hidden_layer_sizes=HIDDEN)
    params = jlosses.PPONetworkParams(policy=_jax_mlp(jax.random.PRNGKey(seed), HIDDEN + (2 * ACT,)),
                                      value=_jax_mlp(jax.random.PRNGKey(seed + 1), HIDDEN + (1,)))
    obs = rng.normal(0.5, 2.0, (B, T, OBS))
    norm = jrs.update(jrs.init_state(jnp.zeros((OBS,))), jnp.asarray(obs))
    raw = rng.normal(0.0, 1.0, (B, T, 2 * ACT))[..., :ACT]
    logits = jnetworks.apply_mlp(params.policy, jrs.normalize(jnp.asarray(obs), norm), jax.nn.swish)
    # behaviour log-probs near the target's: ratios inside and outside the clip
    log_prob = np.asarray(jnet.parametric_action_distribution.log_prob(logits, jnp.asarray(raw)))
    log_prob = log_prob + rng.normal(0.0, 0.4, (B, T))
    trunc = (rng.rand(B, T) < 0.15).astype(np.float64)
    done = np.maximum(trunc, (rng.rand(B, T) < 0.15).astype(np.float64))
    arrays = dict(
        observation=obs, reward=rng.randn(B, T), discount=1.0 - done,
        next_observation=rng.normal(0.5, 2.0, (B, 1, OBS)),
        log_prob=log_prob, raw_action=raw, truncation=trunc,
    )
    return jnet, params, norm, arrays


def _jax_data(a):
    return JTransition(
        observation=jnp.asarray(a["observation"]), action=jnp.zeros((B, T, 0)),
        reward=jnp.asarray(a["reward"]), discount=jnp.asarray(a["discount"]),
        next_observation=jnp.asarray(a["next_observation"]),
        extras={"policy_extras": {"log_prob": jnp.asarray(a["log_prob"]),
                                  "raw_action": jnp.asarray(a["raw_action"])},
                "state_extras": {"truncation": jnp.asarray(a["truncation"])}},
    )


def _port_data(a):
    return TTransition(
        observation=_t(a["observation"]), action=None, reward=_t(a["reward"]),
        discount=_t(a["discount"]), next_observation=_t(a["next_observation"]),
        extras={"policy_extras": {"log_prob": _t(a["log_prob"]), "raw_action": _t(a["raw_action"])},
                "state_extras": {"truncation": _t(a["truncation"])}},
    )


def _port_networks(params):
    return tnetworks.PPONetworks(
        tnetworks.params_from_numpy(params.policy, device="cpu"),
        tnetworks.params_from_numpy(params.value, device="cpu"),
        tdistribution.NormalTanhDistribution(ACT), tnetworks.normalize_preprocessor,
    )


def _port_norm(norm):
    return trs.state_from_numpy({k: np.asarray(getattr(norm, k)) for k in
                                 ("count", "mean", "summed_variance", "std")}, device="cpu")


LOSS_HPARAMS = dict(entropy_cost=3e-2, discounting=0.97, reward_scaling=0.5, gae_lambda=0.9,
                    clipping_epsilon=0.2)


def _entropy_eps(key):
    """The JAX loss's entropy draw (time-major) in the port's rows x time."""
    return _t(jax.random.normal(key, (T, B, ACT), jnp.float64)).transpose(0, 1)


def _assert_grads_match(net, jgrads):
    for mlp, jg in ((net.policy, jgrads.policy), (net.value, jgrads.value)):
        for layer, g in zip(mlp.layers, jg):
            _close(layer.weight.grad, np.asarray(g["kernel"]).T)
            _close(layer.bias.grad, g["bias"])


@pytest.mark.parametrize("normalize_advantage", [True, False])
def test_ppo_loss_and_gradients_match_jax(normalize_advantage):
    jnet, params, norm, arrays = _minibatch(6)
    key = jax.random.PRNGKey(7)
    hp = dict(LOSS_HPARAMS, normalize_advantage=normalize_advantage)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jlosses.compute_ppo_loss, ppo_network=jnet, **hp), has_aux=True
    ))(params, norm, _jax_data(arrays), key)

    net = _port_networks(params)
    loss, metrics = tlosses.compute_ppo_loss(net, _port_norm(norm), _port_data(arrays),
                                             _entropy_eps(key), **hp)
    loss.backward()
    _close(loss, jloss)
    assert metrics.keys() == jmetrics.keys()
    for k in metrics:
        _close(metrics[k], jmetrics[k])
    _assert_grads_match(net, jgrads)


def test_adam_steps_match_optax():
    """Two gradient_update_fn steps: params and both Adam moments."""
    jnet, params, norm, arrays = _minibatch(8)
    lr = 1e-2
    optimizer = optax.adam(lr)
    jupdate = jax.jit(jgradients.gradient_update_fn(
        functools.partial(jlosses.compute_ppo_loss, ppo_network=jnet, **LOSS_HPARAMS),
        optimizer, pmap_axis_name=None, has_aux=True))
    net = _port_networks(params)
    topt = tgradients.make_optimizer(net.parameters(), lr)
    tupdate = tgradients.gradient_update_fn(
        functools.partial(tlosses.compute_ppo_loss, **LOSS_HPARAMS), topt)
    opt_state = optimizer.init(params)
    jdata, tdata, tnorm = _jax_data(arrays), _port_data(arrays), _port_norm(norm)
    for k in range(2):
        key = jax.random.PRNGKey(20 + k)
        (jloss, _), params, opt_state = jupdate(params, norm, jdata, key,
                                                optimizer_state=opt_state)
        tloss, _ = tupdate(net, tnorm, tdata, _entropy_eps(key))
        _close(tloss, jloss)
    adam = opt_state[0]
    assert int(adam.count) == 2
    for mlp, jp, jmu, jnu in ((net.policy, params.policy, adam.mu.policy, adam.nu.policy),
                              (net.value, params.value, adam.mu.value, adam.nu.value)):
        for layer, p, mu, nu in zip(mlp.layers, jp, jmu, jnu):
            for name, kt in (("weight", "kernel"), ("bias", "bias")):
                param = getattr(layer, name)
                state = topt.state[param]
                tr = (lambda a: np.asarray(a).T) if name == "weight" else np.asarray
                assert int(state["step"]) == 2
                _close(param, tr(p[kt]))
                _close(state["exp_avg"], tr(mu[kt]))
                _close(state["exp_avg_sq"], tr(nu[kt]))
