"""The port's CUDA kernels, built into one shared library at first use.

Every source under ``csrc/`` (``*.cu``, and the ``*.cuh`` they share) has a
plain C interface and includes no torch headers, so ``nvcc`` takes seconds;
``torch.utils.cpp_extension.load`` compiles the sources in parallel (one
ninja job each) into
``brax_tracking_tpu_torch/_build/`` and the library is called through
``ctypes``. Each launch function returns the ``cudaGetLastError()`` of its
launch, which ``check`` turns into an exception.

``load`` guards its build with ``_build/lock``, a ``FileBaton``: a file
created at the start and removed at the end, which a later build waits on
for as long as it exists. A build killed in between leaves it, and every
later one then waits forever. So ``build`` first takes ``build_lock``, an
``fcntl.flock`` on ``_build/build.flock``, which the kernel drops when its
holder exits however it exits: processes that build at once (the ranks of
a run) go one at a time, and the one that holds it knows that a
``_build/lock`` left over has no live writer, so it logs and removes it
(the counterpart of the JAX package's ``cache_guard.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import logging
import os
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = tuple(
    os.path.join(_CSRC, f)
    for f in ("cg_fused.cu", "spd_inverse.cu", "cholesky.cu")
)
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
_LIB = None
_logger = logging.getLogger(__name__)
# shared memory a block may use on Hopper (227 KB, opt-in above 48 KB)
H100_SMEM_PER_BLOCK = 232448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each launch function (see its source)
_SIGNATURES = {
    "cg_fused_launch": [_P] * 29 + [_I] * 16 + [_F] * 3 + [_I, _P],
    "cg_batched_launch": [_P] * 18 + [_I] * 12 + [_F] * 3 + [_P],
    "cg_fused_blocks_per_sm": [_I] * 5,
    "spd_inverse_launch": [_P] * 4 + [_I] * 5 + [_P],
    "spd_solve_launch": [_P] * 3 + [_I] * 4 + [_P],
    "cholesky_factor_launch": [_P] * 2 + [_I] * 4 + [_P],
    "cholesky_solve_launch": [_P] * 3 + [_I] * 4 + [_P],
}


@contextlib.contextmanager
def build_lock(build_dir: str):
    """Holds an exclusive ``flock`` on ``build_dir/build.flock`` over the
    block, waiting while another process holds it; once held, a
    ``build_dir/lock`` (``load``'s baton) is a dead build's and is removed
    with a log line."""
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "build.flock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            baton = os.path.join(build_dir, "lock")
            if os.path.exists(baton):
                _logger.warning("removing %s, left by a build that did not finish", baton)
                os.remove(baton)
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> float:
    """Builds the library from the repo's sources (first use only), under
    ``build_lock``; returns the seconds it took, the wait for the lock
    included. A failure raises."""
    global _LIB
    if _LIB is not None:
        return 0.0
    from torch.utils.cpp_extension import load

    t0 = time.perf_counter()
    with build_lock(_BUILD_DIR):
        path = load(
            name="btt_kernels",
            sources=list(SOURCES),
            build_directory=_BUILD_DIR,
            extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
            is_python_module=False,
            verbose=False,
        )
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    _LIB = lib
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    build()
    return _LIB


def check(name: str, err: int) -> None:
    """Raises if a launch function reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
