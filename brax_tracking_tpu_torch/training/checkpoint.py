"""Checkpoint and resume of the full training state, and pickled params.

Counterpart of ``brax_tracking_tpu/training/checkpoint.py``. A checkpoint
is a directory holding one ``torch.save`` file with the whole training
state: the policy and value parameters, the Adam moments and step, the
normalizer and ``env_steps``. The JAX package writes orbax directories,
and restores the reference's bare ``(normalizer, params)`` layout too;
neither is read here (no orbax on the card): restoring one raises
(ROADMAP A.13).

``save_params`` / ``load_params`` pickle numpy arrays, as the JAX
package's do (brax.io.model parity): a ``(normalizer, policy)`` pair goes
out as the normalizer's fields and the policy's ``{"kernel", "bias"}``
list. ``load_params`` also reads the JAX package's snapshots (its
``RunningStatisticsState`` is read as the same dict of fields), and
``load_policy`` turns either into the port's ``(normalizer state, MLP)``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Optional

import torch
import torch.distributed as dist

from brax_tracking_tpu_torch.data import pickles
from brax_tracking_tpu_torch.physics import model as M
from brax_tracking_tpu_torch.training import running_statistics

STATE_FILE = "training_state.pt"
_KEYS = {"params", "optimizer_state", "normalizer_params", "env_steps"}


def save_checkpoint(path: str, training_state: Any, group=None) -> None:
    """Writes ``training_state`` (``params``: a module, ``optimizer``,
    ``normalizer_params``, ``env_steps``) into the directory ``path``. Under
    a process group (whose ranks hold one replicated state and share the
    directory) rank 0 writes and the ranks meet at a barrier after it, so
    none reads the checkpoint before it is whole; the JAX package leans on
    orbax's multi-process save for this."""
    if group is not None and dist.get_rank(group) != 0:
        dist.barrier(group=group)
        return
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(
        {
            "params": training_state.params.state_dict(),
            "optimizer_state": training_state.optimizer.state_dict(),
            "normalizer_params": dataclasses.asdict(training_state.normalizer_params),
            "env_steps": int(training_state.env_steps),
        },
        os.path.join(path, STATE_FILE),
    )
    if group is not None:
        dist.barrier(group=group)


def restore_checkpoint(path: str, target: Any) -> Any:
    """Restores the checkpoint at ``path`` into ``target``, a training state
    of the same networks: its module and optimizer are loaded in place,
    and the state is returned with the restored normalizer and
    ``env_steps``."""
    path = os.path.abspath(path)
    if checkpoint_layout(path) != "full":
        M.unported(
            f"restoring {path}, which holds no {STATE_FILE} (orbax checkpoints of "
            "the JAX package and the reference's (normalizer, params) layout)",
            "§A.13",
        )
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    target.params.load_state_dict(saved["params"])
    target.optimizer.load_state_dict(saved["optimizer_state"])
    norm = target.normalizer_params
    normalizer = running_statistics.RunningStatisticsState(**{
        k: v.to(device=getattr(norm, k).device, dtype=getattr(norm, k).dtype)
        for k, v in saved["normalizer_params"].items()
    })
    return dataclasses.replace(target, normalizer_params=normalizer, env_steps=saved["env_steps"])


def checkpoint_layout(path: str) -> str:
    """``"full"`` for a directory holding this package's training state,
    ``"unknown"`` for anything else (an orbax directory of the JAX
    package, a partial write), so callers fail loudly on it."""
    f = os.path.join(os.path.abspath(path), STATE_FILE)
    if not os.path.isfile(f):
        return "unknown"
    try:
        saved = torch.load(f, map_location="cpu", weights_only=True)
    except (RuntimeError, pickle.UnpicklingError, EOFError):
        return "unknown"
    return "full" if isinstance(saved, dict) and _KEYS <= saved.keys() else "unknown"


def latest_checkpoint(root: str) -> Optional[str]:
    """Newest step-named subdirectory under ``root`` (restart-from-latest)."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=int))


def _to_numpy(obj: Any) -> Any:
    from brax_tracking_tpu_torch.agents.ppo import networks

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, networks.MLP):
        return networks.params_to_numpy(obj)
    if isinstance(obj, running_statistics.RunningStatisticsState):
        return running_statistics.state_to_numpy(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_numpy(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    return obj


def save_params(path: str, params: Any) -> None:
    """Pickles ``params`` as numpy (tensors, MLPs and normalizer states
    converted, tuples, lists and dicts walked)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_numpy(params), f)


class _NumpyFields:
    """Stand-in for a pickled dataclass of numpy arrays: unpickling sets its
    fields as attributes."""


# the JAX package's normalizer state, as its pickles name it
_JAX_NORMALIZER = ("brax_tracking_tpu.training.running_statistics", "RunningStatisticsState")


def _plain(obj: Any) -> Any:
    if isinstance(obj, _NumpyFields):
        return dict(vars(obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_plain(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def load_params(path: str) -> Any:
    """Reads back what ``save_params`` (this package's or the JAX
    package's) wrote: numpy arrays, a normalizer state as a dict of its
    fields. Only numpy globals and the JAX normalizer class are read."""
    return _plain(pickles.load(path, {_JAX_NORMALIZER: _NumpyFields}))


def load_policy(path: str, device="cuda", dtype=None):
    """A ``(normalizer, policy)`` snapshot as the port's
    ``(RunningStatisticsState, MLP)`` on ``device``: the params
    ``make_policy`` takes."""
    from brax_tracking_tpu_torch.agents.ppo import networks

    normalizer, policy = load_params(path)
    return (running_statistics.state_from_numpy(normalizer, device=device, dtype=dtype),
            networks.params_from_numpy(policy, device=device, dtype=dtype))
