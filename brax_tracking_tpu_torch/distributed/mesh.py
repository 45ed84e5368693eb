"""Ranks, replication checks, the barrier and the rank-folded generator.

Counterpart of ``brax_tracking_tpu/distributed/mesh.py``. The JAX package
builds a 1-D ``env`` mesh over every device and runs its epoch under
``shard_map``: the env state sharded on the mesh axis, the learner
replicated, the gradient and normalizer reductions ``lax.pmean`` /
``psum`` over the axis. Here one process drives one card, as ``torchrun``
lays it out: each rank holds ``num_envs / world_size`` envs and a whole
copy of the learner, and the reductions are ``torch.distributed``
all-reduces over the process group (NCCL between cards, gloo on the CPU).
``shard_map_compat`` has no counterpart: there is no global program to
shard, each rank runs its own.

Without torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) ``make_train_mesh`` returns one rank
with no process group, and every helper here is then the identity or a
no-op. With it, even at world size 1, the reductions go through the group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from brax_tracking_tpu_torch.device import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass
class TrainMesh:
    """This process's place among the ranks: its card (``device``) and the
    process group, ``None`` for a run of one process without a group."""

    world_size: int
    rank: int
    local_rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    # whether make_train_mesh initialised the group (close() destroys it)
    owns_group: bool = False

    @property
    def num_shards(self) -> int:
        return self.world_size

    def close(self) -> None:
        """Destroys the process group if this mesh initialised it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.group, self.owns_group = None, False


def make_train_mesh(device="cuda", backend: Optional[str] = None) -> TrainMesh:
    """The mesh of this process. Under torchrun (its five variables set) the
    rank's device is ``cuda:LOCAL_RANK`` (made the current device) for a
    ``cuda`` device, and the default process group is initialised from the
    environment with ``backend`` (NCCL on the card, gloo on the CPU unless
    given), or taken as it is if the caller initialised it. Without them,
    one rank and no group on ``resolve_device(device)``."""
    present = [k for k in TORCHRUN_ENV if k in os.environ]
    if not present:
        return TrainMesh(world_size=1, rank=0, local_rank=0, device=resolve_device(device))
    if len(present) != len(TORCHRUN_ENV):
        missing = sorted(set(TORCHRUN_ENV) - set(present))
        raise RuntimeError(f"torchrun's environment is incomplete: {missing} unset")
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        want = torch.device(device)
        if want.index is not None and want.index != local_rank:
            raise ValueError(f"device {want} is not this rank's card cuda:{local_rank}")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    owns = not dist.is_initialized()
    if owns:
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size, **kwargs)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
        raise RuntimeError(
            f"the process group has rank {dist.get_rank()} of {dist.get_world_size()}, "
            f"torchrun's environment rank {rank} of {world_size}")
    return TrainMesh(world_size=world_size, rank=rank, local_rank=local_rank, device=dev,
                     group=dist.group.WORLD, owns_group=owns)


def fold_process_key(seed: int, rank: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, rank)``: rank 0's is
    the one an undistributed run seeds with ``seed``, every other rank's is
    seeded by numpy's ``SeedSequence([seed, rank])``, so env draws
    decorrelate across ranks (the JAX ``fold_in(key, process_index)``)."""
    if rank != 0:
        seed = int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> list:
    """The mean across ranks of each tensor (all on one device, of one
    dtype), by one all-reduce (a sum: gloo has no average) of their
    flattened concatenation divided by the world size. Returns views of that
    buffer shaped as the inputs."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def broadcast_parameters(module: torch.nn.Module, mesh: TrainMesh) -> None:
    """Overwrites ``module``'s parameters with rank 0's (one broadcast)."""
    if mesh.group is None:
        return
    params = list(module.parameters())
    flat = torch.nn.utils.parameters_to_vector(params).detach()
    dist.broadcast(flat, src=0, group=mesh.group)
    with torch.no_grad():
        torch.nn.utils.vector_to_parameters(flat, params)


def training_state_tensors(training_state) -> dict:
    """Every tensor of a training state by name: the networks' parameters,
    the optimizer's state (Adam's moments and step) and the normalizer."""
    out = {f"params.{k}": v for k, v in training_state.params.state_dict().items()}
    for i, st in training_state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    out.update({f"normalizer.{f.name}": getattr(training_state.normalizer_params, f.name)
                for f in dataclasses.fields(training_state.normalizer_params)})
    return out


def assert_is_replicated(tensors: Mapping[str, torch.Tensor], mesh: TrainMesh) -> None:
    """Raises on every rank unless each tensor is bitwise rank 0's: the bytes
    of all of them in one buffer, broadcast from rank 0 and compared, and
    the index of the first tensor that differs on any rank agreed by an
    all-reduce. The error names that tensor."""
    if mesh.group is None:
        return
    # NCCL moves device memory only; gloo's check runs on the host
    dev = mesh.device if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu")
    names = list(tensors)
    chunks = [tensors[k].detach().to(dev).contiguous().reshape(-1).view(torch.uint8)
              for k in names]
    mine = torch.cat(chunks)
    ref = mine.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    first = len(names)
    if not torch.equal(mine, ref):
        sizes = [c.numel() for c in chunks]
        for i, (a, b) in enumerate(zip(mine.split(sizes), ref.split(sizes))):
            if not torch.equal(a, b):
                first = i
                break
    flag = torch.tensor([first], dtype=torch.int64, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    if int(flag) < len(names):
        raise AssertionError(
            f"{names[int(flag)]} is not replicated: it differs from rank 0's "
            f"({'on this rank' if int(flag) == first else 'on another rank'}, rank "
            f"{mesh.rank} of {mesh.world_size})")


def synchronize_hosts(mesh: TrainMesh) -> None:
    """A barrier across the ranks (no-op without a group)."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
