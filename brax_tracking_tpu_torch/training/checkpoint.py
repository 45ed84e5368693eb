"""Checkpoint and resume of the full training state, and pickled params.

Counterpart of ``brax_tracking_tpu/training/checkpoint.py``. A checkpoint
is a directory holding one ``torch.save`` file with the whole training
state: the policy and value parameters, the Adam moments and step, the
normalizer and ``env_steps``.

``restore_checkpoint`` also reads the JAX package's orbax directories
without orbax (``training/_orbax.py`` over ``ocdbt.py`` and ``zstd.py``):
its full ``TrainingState`` (``checkpoint_layout`` "full") and the
reference's bare ``(normalizer, params)`` tuple ("reference"). The JAX
params go in through the ``params_from_numpy`` layout (each kernel
transposed into ``nn.Linear.weight``); optax's Adam state becomes the
torch one: ``count`` each parameter's ``step``, ``mu`` its ``exp_avg``,
``nu`` its ``exp_avg_sq`` (both add eps outside the square root, so the
next update is the one optax would make).

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
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from brax_tracking_tpu_torch.data import pickles
from brax_tracking_tpu_torch.training import _orbax, running_statistics

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
    ``env_steps``. A "reference" layout restores the normalizer and the
    params only; the optimizer and ``env_steps`` stay as ``target`` has
    them. A key or shape that does not match raises and names it."""
    path = os.path.abspath(path)
    layout = checkpoint_layout(path)
    if layout == "unknown":
        raise ValueError(f"{path} holds neither a {STATE_FILE} nor an orbax training state "
                         "or (normalizer, params) tuple")
    if not os.path.isfile(os.path.join(path, STATE_FILE)):
        return _restore_orbax(path, target, layout)
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
    """``"full"`` for a directory holding this package's training state or
    an orbax tree whose top level is a dict with ``optimizer_state`` (the
    JAX package's ``TrainingState``), ``"reference"`` for an orbax tree
    that is a bare 2-tuple ``(normalizer, params)``, ``"unknown"`` for
    anything else (a partial write), so callers fail loudly on it."""
    path = os.path.abspath(path)
    f = os.path.join(path, STATE_FILE)
    if os.path.isfile(f):
        try:
            saved = torch.load(f, map_location="cpu", weights_only=True)
        except (RuntimeError, pickle.UnpicklingError, EOFError):
            return "unknown"
        return "full" if isinstance(saved, dict) and _KEYS <= saved.keys() else "unknown"
    try:
        kind, keys = _orbax.tree_layout(path)
    except (OSError, ValueError, KeyError, TypeError):
        return "unknown"
    if kind == "dict" and "optimizer_state" in keys:
        return "full"
    if kind == "sequence" and keys == 2:
        return "reference"
    return "unknown"


def _node(tree: Any, keys: Tuple[str, ...]) -> Any:
    """The subtree at ``keys`` of a JAX checkpoint's tree, or a KeyError
    naming the dotted key."""
    node = tree
    for k in keys:
        try:
            node = node[int(k)] if isinstance(node, list) else node[k]
        except (KeyError, IndexError, ValueError, TypeError):
            raise KeyError(f"{'.'.join(keys)} is not in the checkpoint") from None
    return node


def _array(tree: Any, keys: Tuple[str, ...]) -> np.ndarray:
    node = _node(tree, keys)
    if not isinstance(node, np.ndarray):
        raise KeyError(f"{'.'.join(keys)} is not an array in the checkpoint")
    return node


def _tensor(like: torch.Tensor, a: np.ndarray, name: str, transpose: bool = False):
    """``a`` (transposed for a kernel) as a tensor of ``like``'s shape,
    dtype and device; a shape mismatch raises naming ``name``."""
    b = a.T if transpose else a
    if tuple(b.shape) != tuple(like.shape):
        want = like.shape[::-1] if transpose else like.shape
        raise ValueError(f"{name}: shape {tuple(a.shape)} in the checkpoint, the target's is "
                         f"{tuple(want)}")
    return torch.as_tensor(np.array(b, order="C")).to(device=like.device, dtype=like.dtype)


def _network_tensors(net, tree: Any, root: Tuple[str, ...]):
    """(parameter, its value from ``tree``) for every parameter of the
    policy then the value MLP, read in the JAX layout under ``root``:
    ``<root>.<policy|value>.<layer>.<kernel|bias>``."""
    out = []
    for name in ("policy", "value"):
        mlp, key = getattr(net, name), root + (name,)
        layers = _node(tree, key)
        if not isinstance(layers, list) or len(layers) != len(mlp.layers):
            n = len(layers) if isinstance(layers, list) else "no"
            raise ValueError(f"{'.'.join(key)}: {n} layers in the checkpoint, the target's "
                             f"{name} has {len(mlp.layers)}")
        for i, layer in enumerate(mlp.layers):
            for attr, leaf in (("weight", "kernel"), ("bias", "bias")):
                k = key + (str(i), leaf)
                param = getattr(layer, attr)
                out.append((param, _tensor(param, _array(tree, k), ".".join(k),
                                           attr == "weight")))
    return out


def _restore_orbax(path: str, target: Any, layout: str) -> Any:
    """A JAX orbax checkpoint into ``target`` (see ``restore_checkpoint``).
    Every leaf is read and checked before anything is written."""
    tree = _orbax.read_tree(path)
    full = layout == "full"
    params_root, norm_root = (("params",), ("normalizer_params",)) if full else (("1",), ("0",))
    params = _network_tensors(target.params, tree, params_root)
    norm = target.normalizer_params
    normalizer = running_statistics.RunningStatisticsState(**{
        f.name: _tensor(getattr(norm, f.name), _array(tree, norm_root + (f.name,)),
                        ".".join(norm_root + (f.name,)))
        for f in dataclasses.fields(norm)
    })
    if full:
        adam = ("optimizer_state", "0")
        count = int(_array(tree, adam + ("count",)))
        mu = _network_tensors(target.params, tree, adam + ("mu",))
        nu = _network_tensors(target.params, tree, adam + ("nu",))
        env_steps = int(_array(tree, ("env_steps",)))
        opt = target.optimizer
        held = {id(p) for g in opt.param_groups for p in g["params"]}
        if held != {id(p) for p, _ in params}:
            raise ValueError("the target's optimizer does not hold the networks' parameters")
    with torch.no_grad():
        for p, v in params:
            p.copy_(v)
    if not full:
        return dataclasses.replace(target, normalizer_params=normalizer)
    # torch.optim.Adam keeps its step as a host scalar of the default float dtype
    step_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    for (p, _), (_, m), (_, v) in zip(params, mu, nu):
        opt.state[p] = {"step": torch.tensor(float(count), dtype=step_dtype),
                        "exp_avg": m, "exp_avg_sq": v}
    return dataclasses.replace(target, normalizer_params=normalizer, env_steps=env_steps)


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
