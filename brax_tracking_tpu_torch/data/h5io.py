"""Recursive dict <-> HDF5 IO and ReferenceClip h5 storage.

Counterpart of ``brax_tracking_tpu/data/h5io.py``: nested dicts, lists and
arrays to and from HDF5 groups (the stac export layout), and clips stored
one group per clip name. ``h5py`` is needed only when a function is
called. Clips come back as the port's ``ReferenceClip`` of CPU tensors.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Union

import numpy as np
import torch


def _require_h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is required for HDF5 IO") from e
    return h5py


def save(filename: str, data: Dict[str, Any]) -> None:
    """Recursively saves a (possibly nested) dict of arrays/scalars."""
    h5py = _require_h5py()
    with h5py.File(filename, "w") as hf:
        _save_group(hf, data)


def _save_group(group, data: Dict[str, Any]) -> None:
    for key, value in data.items():
        key = str(key)
        if isinstance(value, dict):
            _save_group(group.create_group(key), value)
        elif isinstance(value, (list, tuple)):
            sub = group.create_group(key)
            sub.attrs["__list__"] = True
            _save_group(sub, {str(i): v for i, v in enumerate(value)})
        elif value is None:
            group.attrs[key] = "__none__"
        else:
            group.create_dataset(key, data=_numpy(value))


def load(filename: str) -> Dict[str, Any]:
    """Recursively loads an HDF5 tree back into dicts/lists/arrays."""
    h5py = _require_h5py()
    with h5py.File(filename, "r") as hf:
        return _load_group(hf, h5py)


def _load_group(group, h5py):
    if group.attrs.get("__list__", False):
        items = sorted(group.items(), key=lambda kv: int(kv[0]))
        return [_load_item(v, h5py) for _, v in items]
    out = {key: _load_item(value, h5py) for key, value in group.items()}
    for key, value in group.attrs.items():
        if isinstance(value, str) and value == "__none__":
            out[key] = None
    return out


def _load_item(value, h5py):
    if isinstance(value, h5py.Group):
        return _load_group(value, h5py)
    return value[()]


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_reference_clip(filename: str, clip_names: Union[List[str], str], clip) -> None:
    """ReferenceClip -> h5: one group per clip name; a list of names stores
    a stacked clip's leading axis one clip per group."""
    h5py = _require_h5py()
    names = [clip_names] if isinstance(clip_names, str) else list(clip_names)
    single = isinstance(clip_names, str)
    with h5py.File(filename, "w") as hf:
        for i, name in enumerate(names):
            for attr, value in vars(clip).items():
                if value is None:
                    continue
                data = _numpy(value) if single else _numpy(value[i])
                hf.create_dataset(f"{name}/{attr}", data=data)


def load_reference_clip(filename: str, clip_names: Union[List[str], str]):
    """h5 -> ReferenceClip of CPU tensors; a list of names stacks a leading
    clip axis."""
    h5py = _require_h5py()
    from brax_tracking_tpu_torch.data.clips import ReferenceClip

    names = [clip_names] if isinstance(clip_names, str) else list(clip_names)
    single = isinstance(clip_names, str)
    aggregated = defaultdict(list)
    with h5py.File(filename, "r") as hf:
        for name in names:
            for attr in ReferenceClip.__dataclass_fields__:
                key = f"{name}/{attr}"
                if key in hf:
                    aggregated[attr].append(torch.as_tensor(hf[key][:]))
    return ReferenceClip(**{
        k: v[0] if single else torch.stack(v) for k, v in aggregated.items()
    })
