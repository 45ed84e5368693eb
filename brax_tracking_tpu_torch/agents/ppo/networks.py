"""PPO policy and value networks.

Counterpart of ``brax_tracking_tpu/agents/ppo/networks.py``: an MLP policy
head feeding a ``NormalTanhDistribution`` and an MLP value head, swish
between layers and nothing after the last, initialised as the JAX package
initialises them (weights uniform in +-sqrt(3 / fan_in), zero biases, not
``nn.Linear``'s default). The JAX package's params are a list of
``{"kernel": (in, out), "bias": (out,)}`` per layer; ``params_from_numpy``
and ``params_to_numpy`` carry them across (``nn.Linear.weight`` is the
kernel transposed).

The matrix products run in ``nn.Linear`` (cuBLAS on the card), as the JAX
package runs them outside any Pallas kernel (``x @ k + b``). With a
``compute_dtype`` (``make_ppo_networks(compute_dtype=torch.bfloat16)``, as
the JAX package's ``apply_mlp`` takes it) the inputs, weights and biases
are cast to it, each layer is ``x @ w.T + b`` in that dtype (a bfloat16
cuBLAS product on the card) and the output is cast back; the parameters,
their gradients and their Adam moments stay in their own dtype.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from brax_tracking_tpu_torch.device import default_dtype, resolve_device
from brax_tracking_tpu_torch.training import running_statistics
from brax_tracking_tpu_torch.training.distribution import NormalTanhDistribution

ActivationFn = Callable[[torch.Tensor], torch.Tensor]
PreprocessFn = Callable[[torch.Tensor, object], torch.Tensor]


def identity_preprocessor(obs, _):
    return obs


class MLP(nn.Module):
    """Dense layers of ``layer_sizes``; ``activation`` between them, none
    after the last."""

    def __init__(self, layer_sizes: Sequence[int], activation: ActivationFn = F.silu, *,
                 device, dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            # skip_init: no draw from torch's global generator; init_mlp_ sets them
            nn.utils.skip_init(nn.Linear, n_in, n_out, device=device, dtype=dtype)
            for n_in, n_out in zip(layer_sizes[:-1], layer_sizes[1:])
        )
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = self.activation(layer(x))
        return self.layers[-1](x)


def apply_mlp(mlp: MLP, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
    """``mlp(x)``; with ``compute_dtype``, computed in it as the JAX
    package's ``apply_mlp`` does: input, weights and biases cast, each layer
    a product then a bias add, the output cast back to ``x``'s dtype."""
    if compute_dtype is None:
        return mlp(x)
    in_dtype = x.dtype
    x = x.to(compute_dtype)
    n = len(mlp.layers)
    for i, layer in enumerate(mlp.layers):
        x = torch.matmul(x, layer.weight.to(compute_dtype).T) + layer.bias.to(compute_dtype)
        if i < n - 1:
            x = mlp.activation(x)
    return x.to(in_dtype)


@torch.no_grad()
def init_mlp_(mlp: MLP, generator: torch.Generator) -> MLP:
    """LeCun-uniform weights (+-sqrt(3 / fan_in)) and zero biases, in place,
    drawn from ``generator`` layer by layer."""
    for layer in mlp.layers:
        bound = math.sqrt(3.0 / layer.in_features)
        w = torch.rand(layer.weight.shape, generator=generator, dtype=layer.weight.dtype,
                       device=layer.weight.device)
        layer.weight.copy_(w * (2.0 * bound) - bound)
        layer.bias.zero_()
    return mlp


def params_from_numpy(jax_params: List[dict], device="cuda", dtype=None) -> MLP:
    """An MLP holding the JAX package's params: a list of
    ``{"kernel": (in, out), "bias": (out,)}`` numpy arrays, one per layer."""
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    sizes = [np.shape(jax_params[0]["kernel"])[0]] + [np.shape(p["bias"])[0] for p in jax_params]
    mlp = MLP(sizes, device=dev, dtype=dtype)
    with torch.no_grad():
        for layer, p in zip(mlp.layers, jax_params):
            layer.weight.copy_(torch.as_tensor(np.array(p["kernel"]).T))
            layer.bias.copy_(torch.as_tensor(np.array(p["bias"])))
    return mlp


def params_to_numpy(mlp: MLP) -> List[dict]:
    """Inverse of ``params_from_numpy``: the JAX package's layout."""
    return [
        {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
         "bias": layer.bias.detach().cpu().numpy().copy()}
        for layer in mlp.layers
    ]


class PPONetworks(nn.Module):
    """Policy and value MLPs (the trained parameters, in this order) and the
    action distribution; observations go through ``preprocess`` with the
    normalizer state first. Both MLPs compute in ``compute_dtype`` where one
    is given (``apply_mlp``)."""

    def __init__(self, policy: MLP, value: MLP, distribution: NormalTanhDistribution,
                 preprocess: PreprocessFn = identity_preprocessor,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.policy = policy
        self.value = value
        self.parametric_action_distribution = distribution
        self.preprocess = preprocess
        self.compute_dtype = compute_dtype

    def policy_logits(self, normalizer_params, obs: torch.Tensor,
                      policy: Optional[MLP] = None) -> torch.Tensor:
        return apply_mlp(self.policy if policy is None else policy,
                         self.preprocess(obs, normalizer_params), self.compute_dtype)

    def value_fn(self, normalizer_params, obs: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self.value, self.preprocess(obs, normalizer_params),
                         self.compute_dtype).squeeze(-1)


def make_ppo_networks(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn: PreprocessFn = identity_preprocessor,
    policy_hidden_layer_sizes: Sequence[int] = (256, 256),
    value_hidden_layer_sizes: Sequence[int] = (256, 256),
    activation: ActivationFn = F.silu,
    compute_dtype=None,
    *,
    generator: torch.Generator,
    device="cuda",
    dtype=None,
) -> PPONetworks:
    """Policy (``2 * action_size`` outputs) and value (one output, squeezed)
    MLPs, initialised from ``generator``, the policy first, computing in
    ``compute_dtype`` where one is given (their parameters in ``dtype``)."""
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    dist = NormalTanhDistribution(event_size=action_size)
    policy = MLP([observation_size, *policy_hidden_layer_sizes, dist.param_size], activation,
                 device=dev, dtype=dtype)
    value = MLP([observation_size, *value_hidden_layer_sizes, 1], activation, device=dev,
                dtype=dtype)
    init_mlp_(policy, generator)
    init_mlp_(value, generator)
    return PPONetworks(policy, value, dist, preprocess_observations_fn, compute_dtype)


def make_inference_fn(ppo_networks: PPONetworks):
    """Policy factory: ``make_policy((normalizer, policy_mlp), deterministic)``
    returns ``policy(obs, eps) -> (action, extras)``. Deterministic mode
    acts ``tanh(loc)`` and ignores ``eps``."""

    def make_policy(params: Tuple, deterministic: bool = False):
        normalizer_params, policy_mlp = params
        dist = ppo_networks.parametric_action_distribution

        def policy(observations: torch.Tensor, eps: Optional[torch.Tensor]):
            logits = ppo_networks.policy_logits(normalizer_params, observations, policy_mlp)
            if deterministic:
                return dist.mode(logits), {}
            raw = dist.sample_no_postprocessing(logits, eps)
            log_prob = dist.log_prob(logits, raw)
            return dist.postprocess(raw), {"log_prob": log_prob, "raw_action": raw}

        return policy

    return make_policy


def normalize_preprocessor(obs, normalizer_state):
    """Observation preprocessor used when normalize_observations=True."""
    return running_statistics.normalize(obs, normalizer_state)
