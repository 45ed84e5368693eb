"""The port's CUDA kernels, built into one shared library at first use.

Every source under ``csrc/`` (``*.cu``, and the ``*.cuh`` they share) has a
plain C interface and includes no torch headers, so ``nvcc`` takes seconds;
``torch.utils.cpp_extension.load`` compiles the sources in parallel (one
ninja job each) into
``brax_tracking_tpu_torch/_build/`` and the library is called through
``ctypes``. Each launch function returns the ``cudaGetLastError()`` of its
launch, which ``check`` turns into an exception.
"""

from __future__ import annotations

import ctypes
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
# shared memory a block may use on Hopper (227 KB, opt-in above 48 KB)
H100_SMEM_PER_BLOCK = 232448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each launch function (see its source)
_SIGNATURES = {
    "cg_fused_launch": [_P] * 26 + [_I] * 15 + [_F] * 3 + [_I, _P],
    "cg_batched_launch": [_P] * 18 + [_I] * 12 + [_F] * 3 + [_P],
    "spd_inverse_launch": [_P] * 4 + [_I] * 5 + [_P],
    "spd_solve_launch": [_P] * 3 + [_I] * 4 + [_P],
    "cholesky_factor_launch": [_P] * 2 + [_I] * 4 + [_P],
    "cholesky_solve_launch": [_P] * 3 + [_I] * 4 + [_P],
}


def build() -> float:
    """Builds the library from the repo's sources (first use only);
    returns the seconds it took. A failure raises."""
    global _LIB
    if _LIB is not None:
        return 0.0
    from torch.utils.cpp_extension import load

    t0 = time.perf_counter()
    os.makedirs(_BUILD_DIR, exist_ok=True)
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
