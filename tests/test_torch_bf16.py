"""bfloat16 policy and value MLPs (``make_ppo_networks(compute_dtype=...)``,
ROADMAP A.15) against the JAX package's ``apply_mlp(compute_dtype=
jnp.bfloat16)``, on the CPU.

- The port's ``apply_mlp`` on the JAX package's params (the flagship's
  256 x 256 MLPs, a rodent-size observation of 757, seeded inputs) is within
  ``BF16_ATOL`` of the JAX bfloat16 apply, from float32 and from float64
  params and inputs. The limit is 3x the rehearsal's largest gap (1.17e-2
  at outputs up to 1.9, float64; 9.8e-3 in float32): the two round at other
  points (XLA on the CPU rounds each elementwise op of the swish to
  bfloat16 and leaves the last layer's bias add in float32), a bfloat16 ulp
  at the outputs' scale being 7.8e-3.
- The parameters stay in their dtype, and so do their gradients and both
  Adam moments; ``train()`` through ``network_factory=
  functools.partial(make_ppo_networks, compute_dtype=torch.bfloat16)`` (the
  JAX package's own reach: a Python caller) trains on the point mass to a
  finite state and finite metrics.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu.agents.ppo import networks as jnetworks
from brax_tracking_tpu_torch.agents.ppo import networks as tnetworks
from brax_tracking_tpu_torch.agents.ppo import train as ttrain
from test_torch_ppo_trainer import PM_ARGS, PointMass

BF16_ATOL = 3e-2


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("head", ["policy", "value"])
def test_bf16_apply_matches_jax(dtype, head):
    out = 76 if head == "policy" else 1
    params = jnetworks.init_mlp(jax.random.PRNGKey(3 if head == "policy" else 4),
                                (256, 256, out), 757, getattr(jnp, dtype))
    x = np.random.default_rng(0).standard_normal((512, 757)).astype(dtype)
    want = np.asarray(jnetworks.apply_mlp(params, jnp.asarray(x), jax.nn.swish,
                                          compute_dtype=jnp.bfloat16))
    mlp = tnetworks.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu",
                                      dtype=getattr(torch, dtype))
    with torch.no_grad():
        got = tnetworks.apply_mlp(mlp, torch.as_tensor(x), torch.bfloat16)
    assert got.dtype == getattr(torch, dtype)
    gap = np.abs(got.numpy() - want).max()
    print(f"{head} {dtype}: max |port - jax| = {gap:.3e} at outputs up to "
          f"{np.abs(want).max():.3f} (limit {BF16_ATOL})")
    assert gap <= BF16_ATOL
    # and bfloat16 is not float32: the gap to the plain apply is of its size
    with torch.no_grad():
        plain = tnetworks.apply_mlp(mlp, torch.as_tensor(x))
    assert 0 < (got - plain).abs().max() <= BF16_ATOL


def test_bf16_keeps_params_grads_and_moments_in_their_dtype():
    net = tnetworks.make_ppo_networks(12, 3, compute_dtype=torch.bfloat16,
                                      generator=torch.Generator().manual_seed(0), device="cpu",
                                      dtype=torch.float32)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    obs = torch.randn(16, 12, generator=torch.Generator().manual_seed(1))
    loss = net.policy_logits(None, obs).square().mean() + net.value_fn(None, obs).square().mean()
    loss.backward()
    opt.step()
    for p in net.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        assert opt.state[p]["exp_avg"].dtype == opt.state[p]["exp_avg_sq"].dtype == torch.float32
        assert torch.isfinite(p).all()


def test_train_with_bf16_networks():
    evals = []
    _, (normalizer, policy), metrics = ttrain.train(
        PointMass(), num_timesteps=2 ** 12, num_evals=2,
        network_factory=functools.partial(tnetworks.make_ppo_networks,
                                          policy_hidden_layer_sizes=(32, 32),
                                          value_hidden_layer_sizes=(32, 32),
                                          compute_dtype=torch.bfloat16),
        progress_fn=lambda step, m: evals.append(m["eval/episode_reward"]), **PM_ARGS)
    assert all(torch.isfinite(p).all() for p in policy.parameters())
    assert policy.layers[0].weight.dtype == torch.float64
    assert len(evals) == 2 and np.isfinite(evals).all()
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert torch.isfinite(normalizer.std).all()
