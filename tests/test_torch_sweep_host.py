"""The solve kernel's panel sweeps (ops/csrc/sweep.cuh) run on the CPU.

tests/host_cuda/sweep_host.cc includes sweep.cuh itself and runs its
block-level code through the host stand-ins of tests/host_cuda/
cuda_runtime.h (one thread per CUDA thread, barriers for the warp and block
syncs, an exchange array for the shuffles), built with g++ and no float
contraction. That reaches the CUDA indexing the plain versions do not: the
one-warp ``panels_warp``'s numbering of the rows outside a panel, its
buffers' stride and the clamped edge tiles at every width of the last
panel, and the wide ``panels``' two-barrier overlap. Every form must give
bitwise the scalar sweep's values (each update one fmaf in pivot order),
which is what lets the card hold the wide core bitwise against the one-warp
core (chip_smoke.py ``phase_wide_vs_one_warp``); the scalar sweep itself is
held against the port's plain version in float64.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "brax_tracking_tpu_torch", "ops", "csrc")
# a canary in what a sweep must leave alone: S's columns past nv, the buffers' end
CANARY = np.float32(-1234.5)
P = ctypes.POINTER(ctypes.c_float)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sweep_host") / "libsweep_host.so")
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fno-strict-aliasing",
                    "-pthread", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-I", os.path.join(HERE, "host_cuda"), "-I", CSRC,
                    os.path.join(HERE, "host_cuda", "sweep_host.cc"), "-o", out], check=True)
    so = ctypes.CDLL(out)
    so.scalar_sweep.argtypes = [P, ctypes.c_int, ctypes.c_int]
    so.warp_panel_floats8.argtypes = [ctypes.c_int]
    so.warp_panel_floats8.restype = ctypes.c_int
    so.run_panels_warp.argtypes = [P, ctypes.c_int, ctypes.c_int, P]
    so.run_panels.argtypes = [P, ctypes.c_int, ctypes.c_int, P, ctypes.c_int, ctypes.c_int]
    so.run_panels.restype = ctypes.c_int
    return so


def _ptr(a):
    return a.ctypes.data_as(P)


def _aligned(n):
    """n float32 canaries, 16-byte aligned (the kernels' float4 tables)."""
    raw = np.empty(n + 4, np.float32)
    k = (-raw.ctypes.data % 16) // 4
    out = raw[k:k + n]
    out[:] = CANARY
    assert out.ctypes.data % 16 == 0
    return out


def _spd(nv, seed, blocks=False):
    """A seeded float32 SPD matrix of condition number 1e3; ``blocks``: block
    diagonal (blocks of 1-9), so whole stretches of the sweep stay zero."""
    rng = np.random.RandomState(seed)
    if not blocks:
        q, _ = np.linalg.qr(rng.randn(nv, nv))
        return ((q * 1e3 ** rng.rand(nv)) @ q.T).astype(np.float32)
    m = np.zeros((nv, nv))
    i = 0
    while i < nv:
        w = min(nv - i, rng.randint(1, 10))
        q, _ = np.linalg.qr(rng.randn(w, w))
        m[i:i + w, i:i + w] = (q * 1e3 ** rng.rand(w)) @ q.T
        i += w
    return m.astype(np.float32)


def _scalar(lib, a):
    s = np.array(a, np.float32, order="C")  # a copy
    lib.scalar_sweep(_ptr(s), a.shape[0], a.shape[0])
    return s


CASES = [(nv, blocks) for nv in range(1, 91) for blocks in (False, True)]


@pytest.mark.parametrize("stride", ["odd", "even"])
def test_panels_warp_bitwise_scalar_sweep(lib, stride):
    """panels_warp<8> on one warp at nv 1-90 (every width of the last panel
    and of the edge tiles), at the one-warp core's odd row stride nv | 1
    (dense and block-diagonal matrices) and at an even one (dense): bitwise
    the scalar sweep, the columns past nv and the end of its buffers
    untouched."""
    for nv, blocks in CASES if stride == "odd" else CASES[::2]:
        a = _spd(nv, nv, blocks)
        ref = _scalar(lib, a)
        ld = nv | 1 if stride == "odd" else nv + 2 - nv % 2
        s = np.full((nv, ld), CANARY, np.float32)
        s[:, :nv] = a
        need = lib.warp_panel_floats8(nv)
        buf = _aligned(need + 16)
        lib.run_panels_warp(_ptr(s), ld, nv, _ptr(buf))
        assert np.array_equal(s[:, :nv], ref), (nv, blocks, float(np.abs(s[:, :nv] - ref).max()))
        assert (s[:, nv:] == CANARY).all() and (buf[need:] == CANARY).all(), (nv, blocks)


# the wide panels' cases: every kind of last panel and edge tile at each
# block size its kernels use (spd_inverse takes 256 threads past nv 80)
WIDE_CASES = {(256, 8): CASES[::5], (512, 8): CASES[1::9], (128, 16): CASES[:160:7],
              (256, 16): CASES[120::5]}


@pytest.mark.parametrize("threads,nb", list(WIDE_CASES))
def test_panels_bitwise_scalar_sweep(lib, threads, nb):
    """The wide panels<threads, nb> (the solve kernel's wide layouts 1 and 2
    in 8-pivot panels, spd_inverse's in 16) on seeded widths of 1-90, S
    zero-padded to a multiple of 4: bitwise the scalar sweep, the padding
    left zero and the end of the buffers untouched."""
    for nv, blocks in WIDE_CASES[threads, nb]:
        a = _spd(nv, nv, blocks)
        ref = _scalar(lib, a)
        ld = (nv + 3) & ~3
        s = _aligned(ld * ld).reshape(ld, ld)
        s[:] = 0
        s[:nv, :nv] = a
        need = 2 * nb * ld + 2 * nb * nb
        buf = _aligned(need + 16)
        assert lib.run_panels(_ptr(s), ld, nv, _ptr(buf), threads, nb) == 0
        assert np.array_equal(s[:nv, :nv], ref), (nv, blocks, float(np.abs(s[:nv, :nv] - ref).max()))
        assert not s[nv:].any() and not s[:, nv:].any() and (buf[need:] == CANARY).all(), (nv, blocks)


@pytest.mark.parametrize("nv", [17, 36, 42, 73])
def test_scalar_sweep_is_the_plain_version(lib, nv):
    """The harness's scalar sweep is ops/cholesky.py::sweep_inverse_reference
    to float32 rounding: both against the float64 plain version of the same
    float32 inputs, the scalar sweep no further off than the plain version
    run in float32 (x 2 and a floor of float32's epsilon)."""
    from brax_tracking_tpu_torch.ops import cholesky as tchol

    a = _spd(nv, nv)
    ref = tchol.sweep_inverse_reference(torch.as_tensor(a, dtype=torch.float64)[None])[0].numpy()
    plain32 = tchol.sweep_inverse_reference(torch.as_tensor(a)[None])[0].numpy()
    scale = np.abs(ref).max()
    err = np.abs(_scalar(lib, a) - ref).max() / scale
    err_plain = np.abs(plain32 - ref).max() / scale
    assert err <= 2 * err_plain + float(np.finfo(np.float32).eps), (err, err_plain)
