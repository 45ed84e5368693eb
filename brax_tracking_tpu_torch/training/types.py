"""Shared training types.

Counterpart of ``brax_tracking_tpu/training/types.py``: the ``Transition``
record the actor collects and the PPO loss consumes. Its fields are
batch-first tensors; ``generate_unroll`` stacks them time-major ``[T, B,
...]`` and the trainer lays them out as rows x time ``[R, T, ...]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Metrics = Dict[str, Any]
# policy(observation, eps) -> (action, extras); eps is the standard-normal
# draw (B, action_size), or None for a deterministic policy
Policy = Callable[[torch.Tensor, Optional[torch.Tensor]], Tuple[torch.Tensor, Dict]]


@dataclasses.dataclass
class Transition:
    """One env transition, or a stack of them.

    ``extras`` carries ``{"policy_extras": {"log_prob", "raw_action"},
    "state_extras": {"truncation"}}``. ``action`` and ``next_observation``
    are None where the unroll was compact (the loss reads neither per step).
    """

    observation: torch.Tensor
    action: Optional[torch.Tensor]
    reward: torch.Tensor
    discount: torch.Tensor
    next_observation: Optional[torch.Tensor]
    extras: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)

    def replace(self, **kwargs) -> "Transition":
        return dataclasses.replace(self, **kwargs)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Transition":
        """``fn`` applied to every tensor, extras included (None stays None)."""
        f = lambda x: None if x is None else fn(x)
        return Transition(
            observation=f(self.observation),
            action=f(self.action),
            reward=f(self.reward),
            discount=f(self.discount),
            next_observation=f(self.next_observation),
            extras={k: {n: f(v) for n, v in d.items()} for k, d in self.extras.items()},
        )

    @staticmethod
    def stack(items, dim: int = 0) -> "Transition":
        """Stacks transitions along a new axis ``dim``."""
        first = items[0]
        st = lambda get: None if get(first) is None else torch.stack([get(t) for t in items], dim)
        return Transition(
            observation=st(lambda t: t.observation),
            action=st(lambda t: t.action),
            reward=st(lambda t: t.reward),
            discount=st(lambda t: t.discount),
            next_observation=st(lambda t: t.next_observation),
            extras={
                k: {n: st(lambda t, k=k, n=n: t.extras[k][n]) for n in d}
                for k, d in first.extras.items()
            },
        )
