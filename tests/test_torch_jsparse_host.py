"""The solve kernel's sparse J passes (ops/csrc/jsparse.cuh) run on the CPU.

tests/host_cuda/jsparse_host.cc includes jsparse.cuh itself and runs its
row pass (``row_dot``) and its J^T force (``jt_f`` on the wide core's 8
and 16 warps: chunk per warp, the lanes' rows, the transposing butterfly)
through the host stand-ins of tests/host_cuda/cuda_runtime.h, built with
g++ and no float contraction, beside the dense forms they replace in the
wide core (``dot_row`` over every column, ``matvec_t``), each term one fmaf
as nvcc contracts them. On the real patterns of the terrain, the pair and
the rodent stand-in (ops/cg.py::j_pattern), and in their dense mode
(``kDense``: cg_solve_batched's J, dof-major) on a dense J, with seeded
values and structural zeros of either sign, both passes are bitwise the
dense forms, and nothing past any buffer is read or written (canaries). That equality is what lets the card
hold the sparse wide core bitwise against the dense one-warp core
(chip_smoke.py ``phase_wide_vs_one_warp``).
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import chip_smoke as cs
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import solver as tS

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "brax_tracking_tpu_torch", "ops", "csrc")
CANARY = np.float32(-1234.5)
PAD = 64  # canaries past each buffer
F = ctypes.POINTER(ctypes.c_float)
I = ctypes.POINTER(ctypes.c_int)
MODELS = ("rodent_standin_terrain", "ratpair", "rodent_standin")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jsparse_host") / "libjsparse_host.so")
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fno-strict-aliasing",
                    "-pthread", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-I", os.path.join(HERE, "host_cuda"), "-I", CSRC,
                    os.path.join(HERE, "host_cuda", "jsparse_host.cc"), "-o", out], check=True)
    so = ctypes.CDLL(out)
    so.sparse_rows.argtypes = [F, I, I, F, F, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    so.dense_rows.argtypes = [F, ctypes.c_int, F, F, ctypes.c_int, ctypes.c_int]
    so.sparse_jt.argtypes = [F, I, F, F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    so.sparse_jt.restype = ctypes.c_int
    so.dense_jt.argtypes = [F, ctypes.c_int, F, F, ctypes.c_int, ctypes.c_int]
    return so


def _padded(a, dtype=np.float32, fill=CANARY):
    """a's values, then PAD canaries; returns (buffer, view of a's part)."""
    a = np.ascontiguousarray(a, dtype).ravel()
    buf = np.full(a.size + PAD, fill, dtype)
    buf[:a.size] = a
    return buf, buf[:a.size]


def _p(a, t=F):
    return a.ctypes.data_as(t)


def _dense_pattern(nefc, nv):
    """A dense J as the kDense mode holds it: values dof-major, one row's
    entry at column v at v nefc + r (only ``rec`` and ``nnz``, to place the
    seeded values; the kernel reads no table)."""
    rec = np.stack([np.arange(nefc), np.full(nefc, nefc), np.zeros(nefc), np.full(nefc, nv)], -1)
    return dict(rec=rec.astype(np.int32), cols=np.arange(nv, dtype=np.int32),
                chw=np.zeros((1, 1, 2), np.int32), nnz=nefc * nv)


def _patterns():
    """(name, pattern, nefc, nv, dense): the three models' J patterns and a
    dense J (the pair's size)."""
    out = []
    for model in MODELS:
        m = cs.load(model, "cpu", torch.float64)
        layout = tCn.efc_layout(m)
        out.append((model, tS._fused_statics(m, layout)["j_pattern"], layout.nefc, m.nv, 0))
    out.append(("dense", _dense_pattern(590, 146), 590, 146, 1))
    return out


@pytest.fixture(scope="module")
def patterns():
    return _patterns()


def _case(pat, nefc, nv, seed):
    """Seeded float32 values at the pattern's entries, the dense J that
    holds them (its structural zeros +0 or -0 at random, as acc * md gives
    them), the values in the kernel's order, x and f."""
    rng = np.random.RandomState(seed)
    J = np.where(rng.rand(nefc, nv) < 0.5, np.float32(0.0), np.float32(-0.0)).astype(np.float32)
    rec, cols = pat["rec"], pat["cols"]
    vals = np.zeros(pat["nnz"], np.float32)
    for r, (base, stride, col0, n) in enumerate(rec):
        v = rng.uniform(-2, 2, n).astype(np.float32)
        J[r, cols[col0:col0 + n]] = v
        vals[base + stride * np.arange(n)] = v
    x = rng.uniform(-3, 3, nv).astype(np.float32)
    f = (rng.uniform(-5, 5, nefc) * (rng.rand(nefc) < 0.7)).astype(np.float32)
    return J, vals, x, f


@pytest.mark.parametrize("seed", [0, 1])
def test_row_pass_bitwise_dense(lib, patterns, seed):
    for name, pat, nefc, nv, dense in patterns:
        J, vals, x, _ = _case(pat, nefc, nv, seed)
        vbuf, _ = _padded(vals)
        xbuf, _ = _padded(x)
        rec, _ = _padded(pat["rec"], np.int32, 0)
        cols, _ = _padded(pat["cols"], np.int32, 0)
        ys, y_s = _padded(np.zeros(nefc))
        yd, y_d = _padded(np.zeros(nefc))
        lib.sparse_rows(_p(vbuf), _p(rec, I), _p(cols, I), _p(xbuf), _p(ys), nv, nefc, dense)
        lib.dense_rows(_p(J), nv, _p(xbuf), _p(yd), nefc, nv)
        assert np.array_equal(y_s.view(np.uint32), y_d.view(np.uint32)), name
        assert (ys[nefc:] == CANARY).all() and np.isfinite(y_s).all(), name


@pytest.mark.parametrize("warps", [8, 16])
def test_jt_force_bitwise_dense(lib, patterns, warps):
    for seed, (name, pat, nefc, nv, dense) in enumerate(patterns):
        J, vals, _, f = _case(pat, nefc, nv, seed + 10)
        vbuf, _ = _padded(vals)
        fbuf, _ = _padded(f)
        chw, _ = _padded(pat["chw"], np.int32, 0)
        ys, y_s = _padded(np.zeros(nv))
        yd, y_d = _padded(np.zeros(nv))
        assert lib.sparse_jt(_p(vbuf), _p(chw, I), _p(fbuf), _p(ys), nv, nefc, warps,
                             dense) == 0
        lib.dense_jt(_p(J), nv, _p(fbuf), _p(yd), nv, nefc)
        assert np.array_equal(y_s.view(np.uint32), y_d.view(np.uint32)), name
        assert (ys[nv:] == CANARY).all() and np.isfinite(y_s).all(), name
        # the plain product, to float32 rounding
        ref = J.astype(np.float64).T @ f.astype(np.float64)
        np.testing.assert_allclose(y_s, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
