"""FLOPs of the PPO networks' dense layers (two per multiply-add)."""

from __future__ import annotations

from typing import Sequence


def forward(sizes: Sequence[int]) -> int:
    """One sample's forward pass through dense layers of ``sizes``."""
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def backward(sizes: Sequence[int]) -> int:
    """One sample's backward pass: each layer's weight gradient, and the
    input gradient of every layer but the first (the observations need
    none)."""
    return forward(sizes) + forward(sizes) - 2 * sizes[0] * sizes[1]


def training_step(obs: int, action: int, config, geometry) -> int:
    """The dense layers' FLOPs of one training step: the policy's forward
    per env and control step of the unrolls; per SGD pass and minibatch
    the loss's policy and value forward and backward per row and time step
    and the value's forward of each row's bootstrap observation."""
    pol = [obs, *config["policy_hidden_layer_sizes"], 2 * action]
    val = [obs, *config["value_hidden_layer_sizes"], 1]
    g = geometry
    collect = g.n_unrolls * g.unroll * g.envs * forward(pol)
    per_row = g.unroll * (forward(pol) + backward(pol) + forward(val) + backward(val)) \
        + forward(val)
    learn = g.updates * g.rows * per_row
    return collect + learn
