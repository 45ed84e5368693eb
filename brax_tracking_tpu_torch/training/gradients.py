"""Gradient update: loss, backward, one optimizer step.

Counterpart of ``brax_tracking_tpu/training/gradients.py``. The JAX
package's ``optax.adam(lr)`` over the joint policy and value pytree is
``torch.optim.Adam`` over both modules' parameters together: b1 0.9, b2
0.999, eps 1e-8 outside the square root, bias correction, no clipping.
Under a process group the gradients are averaged across the ranks before
the step, as the JAX ``loss_and_pgrad``'s ``lax.pmean`` averages them over
the mesh axis: one all-reduce per minibatch.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from brax_tracking_tpu_torch.distributed.mesh import all_reduce_mean


def make_optimizer(parameters: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate) (eps_root 0) as a torch optimizer."""
    return torch.optim.Adam(parameters, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def gradient_update_fn(loss_fn: Callable, optimizer: torch.optim.Optimizer, group=None):
    """Returns ``f(*args) -> (loss, aux)``: ``loss_fn(*args)`` returns
    ``(loss, aux)``; ``f`` back-propagates the loss, replaces each gradient
    by its mean across the ranks of ``group`` (all of them in one buffer,
    one all-reduce) where one is given, and takes one optimizer step on the
    parameters it holds."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def f(*args, **kwargs):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(*args, **kwargs)
        loss.backward()
        if group is not None:
            for p, g in zip(params, all_reduce_mean([p.grad for p in params], group)):
                p.grad.copy_(g)
        optimizer.step()
        return loss.detach(), aux

    return f
