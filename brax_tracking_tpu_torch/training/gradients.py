"""Gradient update: loss, backward, one optimizer step.

Counterpart of ``brax_tracking_tpu/training/gradients.py``. The JAX
package's ``optax.adam(lr)`` over the joint policy and value pytree is
``torch.optim.Adam`` over both modules' parameters together: b1 0.9, b2
0.999, eps 1e-8 outside the square root, bias correction, no clipping. One
card has no gradient all-reduce (several GPUs are ROADMAP A.14).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def make_optimizer(parameters: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate) (eps_root 0) as a torch optimizer."""
    return torch.optim.Adam(parameters, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def gradient_update_fn(loss_fn: Callable, optimizer: torch.optim.Optimizer):
    """Returns ``f(*args) -> (loss, aux)``: ``loss_fn(*args)`` returns
    ``(loss, aux)``; ``f`` back-propagates the loss and takes one optimizer
    step on the parameters it holds."""

    def f(*args, **kwargs):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(*args, **kwargs)
        loss.backward()
        optimizer.step()
        return loss.detach(), aux

    return f
