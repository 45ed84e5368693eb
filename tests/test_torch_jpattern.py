"""J's static sparsity (ops/cg.py::j_pattern), as the solve kernel's wide
core holds J (csrc/jsparse.cuh).

On every committed file of the kernel path, the J that the plain version
assembles (``assemble_qM_J``, as the kernel assembles it) from seeded
random factors is exactly zero outside the pattern and nonzero on it, the
pattern's tables place every entry once, and its count is what
chip_smoke.py's bound charges J (``fused_j_nnz``).
"""

import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import chip_smoke as cs
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import solver as tS

# chip_smoke.py's names of the files the kernel path runs
FILES = ("minirat", "minirat_elliptic", "minirat_newton", "minirat_planar", "rodent_standin",
         "rodent_standin_terrain", "ratpair", "ratpair_elliptic", "ratpair_newton", "rat",
         "props", "fly_standin", "fly_standin_tethered")


def entries(pat, nv):
    """(row, column) of each stored value, from the tables alone; checks
    that every value index is taken once, the columns ascend per row and
    each chunk word (first entry's index, mask | stride << 16) agrees with
    them."""
    rec, cols, chw = pat["rec"], pat["cols"], pat["chw"]
    nnz = pat["nnz"]
    where = np.full((nnz, 2), -1, np.int64)
    for r, (base, stride, col0, n) in enumerate(rec):
        c = cols[col0:col0 + n]
        assert (np.diff(c) > 0).all() and ((c >= 0) & (c < nv)).all(), r
        idx = base + stride * np.arange(n)
        assert (where[idx] == -1).all(), r
        where[idx] = np.stack([np.full(n, r), c], -1)
        for ch in range(chw.shape[0]):
            inch = c[(c >= 16 * ch) & (c < 16 * ch + 16)] - 16 * ch
            index, word = (int(w) for w in chw[ch, r])
            assert word & 0xFFFF == int(np.sum(1 << inch)), (r, ch)
            if inch.size:
                assert word >> 16 == stride, (r, ch)
                assert index == base + stride * int(np.sum(c < 16 * ch)), (r, ch)
    assert (where >= 0).all()
    return where


@pytest.mark.parametrize("model", FILES)
def test_assembled_J_is_zero_outside_the_pattern(model):
    m = cs.load(model, "cpu", torch.float64)
    layout = tCn.efc_layout(m)
    fstat = tS._fused_statics(m, layout)
    st = tS._solve_statics(m, layout)
    kw = st["kw"]
    pat = fstat["j_pattern"]
    nv, nefc, nlim = m.nv, layout.nefc, len(kw["limit_dadr"])
    where = entries(pat, nv)
    assert pat["nnz"] == cs.fused_j_nnz(st["md"], kw)[1]

    B, nroots = 3, len(kw["root_bounds"])
    rng = np.random.RandomState(0)
    T = lambda *s: torch.as_tensor(rng.uniform(-1, 1, s))
    Bm = T(B, nroots * 6, nefc)
    _, J = tcg.assemble_qM_J(T(B, 6, nv), T(B, 6, nv), Bm, T(B, nlim), st["md"],
                             m.dof_armature, row_slot=kw["row_slot"], sz=kw["sz"],
                             root_bounds=kw["root_bounds"], limit_dadr=kw["limit_dadr"])
    on = np.zeros((nefc, nv), bool)
    on[where[:, 0], where[:, 1]] = True
    J = J.numpy()
    assert (J[:, ~on] == 0).all()
    assert (J[:, on] != 0).all()
    # the values the kernel stores, in its order, put back: J itself
    vals = J[:, where[:, 0], where[:, 1]]
    back = np.zeros_like(J)
    back[:, where[:, 0], where[:, 1]] = vals
    assert np.array_equal(back, J)
