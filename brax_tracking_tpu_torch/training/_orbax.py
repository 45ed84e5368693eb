"""Reads the pytree of an orbax ``PyTreeCheckpointer`` directory as numpy.

The JAX package's ``save_checkpoint`` writes its training state with orbax:
``_METADATA`` (JSON) lists every leaf by its key path, and each array leaf
is a zarr v2 array in the directory's OCDBT store (``training/ocdbt.py``)
under the key path joined by ``.``: ``<name>/.zarray`` (shape, chunk
shape, dtype, order, fill value, compressor) and one chunk per grid cell,
``<name>/0.0`` and so on, each compressed by zstd (``training/zstd.py``).

``read_tree`` returns the nested tree: dicts for the dict and dataclass
levels, lists for the sequence levels (tuples, lists, named tuples), numpy
arrays for array leaves (0-d for scalars) and ``None`` for a leaf orbax
skipped (optax's ``EmptyState``). ``tree_layout`` reads only
``_METADATA``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from brax_tracking_tpu_torch.training import ocdbt, zstd

METADATA = "_METADATA"
_SEQUENCE, _DICT = 1, 2


def read_metadata(path: str) -> Dict[str, Any]:
    """The parsed ``_METADATA`` of the checkpoint directory ``path``."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if not isinstance(meta, dict) or "tree_metadata" not in meta:
        raise ValueError(f"{os.path.join(path, METADATA)} holds no orbax tree metadata")
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: only orbax's default layout is read (OCDBT, zarr v2)")
    return meta


def _leaves(meta: Dict[str, Any]) -> List[Tuple[Tuple[Tuple[str, int], ...], dict]]:
    """Each leaf as ((key, key type) per level, value metadata)."""
    out = []
    for entry in meta["tree_metadata"].values():
        path = tuple((k["key"], k["key_type"]) for k in entry["key_metadata"])
        out.append((path, entry["value_metadata"]))
    return out


def tree_layout(path: str):
    """The top level of the checkpoint's tree: ``("dict", keys)`` or
    ``("sequence", length)``."""
    leaves = _leaves(read_metadata(path))
    kinds = {p[0][1] for p, _ in leaves}
    if kinds == {_DICT}:
        return "dict", sorted({p[0][0] for p, _ in leaves})
    if kinds == {_SEQUENCE}:
        return "sequence", 1 + max(int(p[0][0]) for p, _ in leaves)
    raise ValueError(f"{path}: unknown tree structure")


def _decode_chunk(raw: bytes, name: str) -> bytes:
    try:
        return zstd.decompress(raw)
    except zstd.ZstdError as e:
        raise ValueError(f"{name}: {e}") from None


def read_array(store: ocdbt.OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if (meta.get("zarr_format") != 2 or meta.get("filters")
            or (meta.get("compressor") or {}).get("id") != "zstd"):
        raise ValueError(f"{name}: only zstd-compressed zarr v2 arrays without filters are read")
    dtype = np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise ValueError(f"{name}: chunk shape {chunks} does not match shape {shape}")
    order, sep = meta.get("order", "C"), meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = np.empty(shape, dtype)
    n_chunk = int(np.prod(chunks, dtype=np.int64))
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        if key not in store:
            if fill is None:
                raise ValueError(f"{key}: chunk absent and the array has no fill value")
            out[region] = fill
            continue
        raw = _decode_chunk(store.read(key), key)
        if len(raw) != n_chunk * dtype.itemsize:
            raise ValueError(f"{key}: chunk of {len(raw)} bytes, expected "
                             f"{n_chunk * dtype.itemsize}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def _nest(items: List[Tuple[Tuple[Tuple[str, int], ...], Any]]) -> Any:
    """The nested tree of (key path, leaf) pairs."""
    if len(items) == 1 and not items[0][0]:
        return items[0][1]
    kinds = {p[0][1] for p, _ in items}
    if len(kinds) != 1 or any(not p for p, _ in items):
        raise ValueError("inconsistent tree metadata")
    groups: Dict[str, list] = {}
    for p, leaf in items:
        groups.setdefault(p[0][0], []).append((p[1:], leaf))
    if kinds == {_SEQUENCE}:
        n = 1 + max(int(k) for k in groups)
        if sorted(int(k) for k in groups) != list(range(n)):
            raise ValueError("a sequence in the tree metadata misses an element")
        return [_nest(groups[str(i)]) for i in range(n)]
    return {k: _nest(v) for k, v in groups.items()}


def read_tree(path: str) -> Any:
    """The checkpoint's tree, every array leaf as numpy."""
    path = os.path.abspath(path)
    meta = read_metadata(path)
    store = ocdbt.OcdbtStore(path)
    items = []
    for keys, value in _leaves(meta):
        if value.get("skip_deserialize") or value.get("value_type") == "None":
            leaf = None
        else:
            leaf = read_array(store, ".".join(k for k, _ in keys))
        items.append((keys, leaf))
    return _nest(items)
