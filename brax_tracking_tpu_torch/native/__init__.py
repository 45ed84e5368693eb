"""Host C++ pieces of the port, built at first use.

Counterpart of ``brax_tracking_tpu/native/__init__.py``: the renderer's
scan converter, ``csrc/rasterizer.cc`` (a byte copy of the JAX package's
``native/rasterizer.cc``), is compiled with the system's ``g++`` into
``brax_tracking_tpu_torch/_build/`` the first time it is loaded, and called
through ``ctypes``. It runs on the host, as in the JAX package; it is not
a kernel of the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

_lock = threading.Lock()
_libs = {}


def _build(name: str) -> str:
    """Compiles csrc/<name>.cc into _build/lib<name>.so unless it is newer
    than its source; a failed compile raises with the compiler's errors."""
    src = os.path.join(_CSRC, f"{name}.cc")
    out = os.path.join(_BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", src, "-o", out]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {src} failed ({' '.join(cmd)}):\n{res.stderr}")
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cc, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_build(name))
        return _libs[name]
