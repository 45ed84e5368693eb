"""Welford running mean and std of observations.

Counterpart of ``brax_tracking_tpu/training/running_statistics.py`` for a
tensor observation (the tracking envs' is one; the JAX package's pytree
case serves dict observations, which no env of the port has). Under a
process group the update is the JAX ``pmean_axis_name`` form: the count
grows by the global batch (the local one times the world size), and the
mean and variance updates, each summed over the local batch and divided by
the global count, are summed across the ranks (all-reduces), so every rank
holds the statistics of the joined batch.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from brax_tracking_tpu_torch.device import default_dtype, resolve_device

_FIELDS = ("count", "mean", "summed_variance", "std")


@dataclasses.dataclass
class RunningStatisticsState:
    count: torch.Tensor  # scalar, in the observation's dtype
    mean: torch.Tensor
    summed_variance: torch.Tensor
    std: torch.Tensor


def init_state(specimen: torch.Tensor) -> RunningStatisticsState:
    """Zero statistics (std one) for observations shaped like ``specimen``
    (one step's shape, its dtype and device)."""
    zeros = torch.zeros_like(specimen)
    return RunningStatisticsState(
        count=torch.zeros((), dtype=specimen.dtype, device=specimen.device),
        mean=zeros,
        summed_variance=zeros.clone(),
        std=torch.ones_like(specimen),
    )


def update(
    state: RunningStatisticsState,
    batch: torch.Tensor,
    group=None,
    std_min_value: float = 1e-6,
    std_max_value: float = 1e6,
) -> RunningStatisticsState:
    """Folds a batch (any number of leading batch dims) into the statistics;
    with ``group``, this rank's batch into the statistics of every rank's
    (each rank's batch of the same size)."""
    n_batch_dims = batch.dim() - state.mean.dim()
    batch_axes = tuple(range(n_batch_dims))
    world_size = 1 if group is None else dist.get_world_size(group)
    count = state.count + int(np.prod(batch.shape[:n_batch_dims])) * world_size
    diff_to_old = batch - state.mean
    mean_update = torch.sum(diff_to_old, dim=batch_axes) / count
    if group is not None:
        dist.all_reduce(mean_update, group=group)
    mean = state.mean + mean_update
    diff_to_new = batch - mean
    var_update = torch.sum(diff_to_old * diff_to_new, dim=batch_axes)
    if group is not None:
        dist.all_reduce(var_update, group=group)
    summed_variance = state.summed_variance + var_update
    std = torch.clamp(torch.sqrt(summed_variance / count), std_min_value, std_max_value)
    return RunningStatisticsState(count=count, mean=mean, summed_variance=summed_variance, std=std)


def normalize(batch: torch.Tensor, state: RunningStatisticsState) -> torch.Tensor:
    return (batch - state.mean) / state.std


def denormalize(batch: torch.Tensor, state: RunningStatisticsState) -> torch.Tensor:
    return batch * state.std + state.mean


def state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda", dtype=None) -> RunningStatisticsState:
    """The state from numpy arrays named as its fields (the JAX package's
    ``RunningStatisticsState`` read field by field)."""
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    return RunningStatisticsState(
        **{k: torch.as_tensor(np.array(arrays[k]), dtype=dtype, device=dev) for k in _FIELDS}
    )


def state_to_numpy(state: RunningStatisticsState) -> dict:
    """Inverse of ``state_from_numpy``."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in _FIELDS}
