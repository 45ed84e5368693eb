"""Parametric action distribution: tanh(Normal(loc, scale)).

Counterpart of ``brax_tracking_tpu/training/distribution.py``, with the
same numerics:
- scale = softplus(raw_scale) * var_scale + min_std (min_std = 1e-3);
- tanh log|det J| per dim = 2 (log 2 - x - softplus(-2x)), the stable form
  of log(1 - tanh(x)^2);
- entropy is the single-sample estimator: the Gaussian entropy plus the
  log-det at one sampled pre-activation point.

The sampling functions take the standard-normal draw ``eps`` (the shape of
``loc``) as a tensor instead of a key: the caller draws it from its
generator.
"""

from __future__ import annotations

import math

import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) exactly, as jnp.logaddexp(x, 0) (F.softplus returns x
    # itself above its threshold)
    return torch.logaddexp(x, torch.zeros_like(x))


class NormalTanhDistribution:
    """The network emits ``2 * event_size`` logits: [loc, raw_scale]."""

    def __init__(self, event_size: int, min_std: float = 1e-3, var_scale: float = 1.0):
        self.event_size = event_size
        self._min_std = min_std
        self._var_scale = var_scale

    @property
    def param_size(self) -> int:
        return 2 * self.event_size

    def _loc_scale(self, logits: torch.Tensor):
        loc, raw = torch.chunk(logits, 2, dim=-1)
        return loc, _softplus(raw) * self._var_scale + self._min_std

    def sample_no_postprocessing(self, logits: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """The pre-tanh sample loc + scale * eps."""
        loc, scale = self._loc_scale(logits)
        return loc + scale * eps

    def postprocess(self, pre_tanh: torch.Tensor) -> torch.Tensor:
        return torch.tanh(pre_tanh)

    def sample(self, logits: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return self.postprocess(self.sample_no_postprocessing(logits, eps))

    def mode(self, logits: torch.Tensor) -> torch.Tensor:
        loc, _ = self._loc_scale(logits)
        return torch.tanh(loc)

    @staticmethod
    def _tanh_log_det(x: torch.Tensor) -> torch.Tensor:
        return 2.0 * (math.log(2.0) - x - _softplus(-2.0 * x))

    def log_prob(self, logits: torch.Tensor, pre_tanh: torch.Tensor) -> torch.Tensor:
        """Log density of tanh(pre_tanh), from the pre-tanh sample (the
        ``raw_action`` the actor stores), so no atanh is needed."""
        loc, scale = self._loc_scale(logits)
        z = (pre_tanh - loc) / scale
        normal = -0.5 * z * z - 0.5 * math.log(2.0 * math.pi) - torch.log(scale)
        return torch.sum(normal - self._tanh_log_det(pre_tanh), dim=-1)

    def entropy(self, logits: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Single-sample entropy estimate of the squashed distribution."""
        loc, scale = self._loc_scale(logits)
        x = loc + scale * eps
        ent = 0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(scale)
        return torch.sum(ent + self._tanh_log_det(x), dim=-1)
