"""Reading pickles of numpy data, those the JAX package writes included.

The JAX package pickles dataclasses of numpy arrays (the clip caches
``data/*/clips/<i>.p``, the policy snapshots of ``save_params``). Their
pickles name the JAX package's classes. ``load`` reads them without
importing that package: each class named in ``classes`` (by the module and
name strings the pickle holds) is replaced by the given stand-in, numpy's
array reconstructors are allowed, and every other global is refused, so
unpickling cannot run code outside numpy.
"""

from __future__ import annotations

import importlib
import pickle
from typing import Any, Dict, Optional, Tuple

# numpy's array, dtype and scalar reconstructors, under numpy 2's module
# names and numpy 1's
_NUMPY = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"), ("numpy.core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"), ("numpy.core.numeric", "_frombuffer"),
}


def _numpy_global(module: str, name: str) -> Any:
    for mod in (module, module.replace("numpy._core", "numpy.core"),
                module.replace("numpy.core", "numpy._core")):
        try:
            return getattr(importlib.import_module(mod), name)
        except (ImportError, AttributeError):
            continue
    raise pickle.UnpicklingError(f"numpy has no {module}.{name}")


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, classes: Dict[Tuple[str, str], type]):
        super().__init__(f)
        self._classes = classes

    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in self._classes:
            return self._classes[module, name]
        if (module, name) in _NUMPY:
            return _numpy_global(module, name)
        raise pickle.UnpicklingError(
            f"refusing to load global {module}.{name}: only numpy arrays and "
            f"{sorted('.'.join(k) for k in self._classes)} are read")


def load(path: str, classes: Optional[Dict[Tuple[str, str], type]] = None) -> Any:
    """The object pickled at ``path``, with ``classes`` mapping a pickled
    class's ``(module, name)`` to the class built in its place."""
    with open(path, "rb") as f:
        return _Unpickler(f, classes or {}).load()
