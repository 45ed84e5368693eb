"""The frozen solve count (``counts/solve.py``) against a hand count on a
tiny model file, and the two cells' sizes against the port's own
statics."""

import numpy as np
import pytest

from portbench import harness
from portbench.counts import H100_FP32_FLOPS, H100_HBM_BYTES_PER_S, mlp, solve


def tiny_model(path):
    """World, a free root (6 dofs), and a hinge child with a limit; two
    geoms (floor on the world, a sphere on the child) in one pair of condim
    3 and one point, a pyramidal cone, joint damping."""
    np.savez(path, nv=np.int64(7),
             dof_parentid=np.array([-1, 0, 1, 2, 3, 4, 5]),
             dof_bodyid=np.array([1, 1, 1, 1, 1, 1, 2]),
             dof_damping=np.array([0, 0, 0, 0, 0, 0, 0.1]),
             jnt_limited=np.array([False, True]), jnt_type=np.array([0, 3]),
             pairs_condim=np.array([3]), pairs_npoint=np.array([1]),
             pairs_geom1=np.array([0]), pairs_geom2=np.array([1]),
             geom_bodyid=np.array([0, 2]), body_parentid=np.array([0, 0, 1]),
             body_rootid=np.array([0, 1, 1]), opt_cone=np.int64(0))


def test_tiny_hand_count(tmp_path):
    tiny_model(tmp_path / "m.npz")
    s = solve.sizes(str(tmp_path / "m.npz"))
    # rows: 1 limit + 4 pyramid rows; the sphere's body moves with all 7
    # dofs; qM's ancestor pairs: the 7-dof chain, 7 * 8 / 2
    assert (s.nv, s.nefc, s.nlim, s.ncon, s.nroots, s.nell) == (7, 5, 1, 1, 1, 0)
    assert (s.anc, s.j_con, s.damped) == (28, 4 * 7, True)
    B = 10
    nbytes, flops, least, bound = solve.launch(s, B, its=4, ls=4)
    ins = 4 * (2 * B * 6 * 7 + B * 6 * 5 + B * 1 + 2 * B * 5 + 2 * B * 7) + B * 5 \
        + 4 * (7 + 7 + 7) + 4 * (5 + 14 + 1)
    assert nbytes == ins + B * (4 * (4 * 7 + 5) + 1)
    j_nnz, cost = 28 + 1, 6 * 5
    per_env = (12 * 28 + 7 + 12 * 28 + 343 + 4 * 49 + 7 + 4 * j_nnz + 2 * 49 + 2 * 5 + cost
               + 2 * j_nnz + 343 / 3 + 4 * 49)
    per_iter = 4 * j_nnz + 4 * 49 + 20 * 7 + 14 * cost + 4 * 5 + cost + 4 * cost
    assert flops == pytest.approx(B * (per_env + 4 * per_iter), rel=1e-12)
    assert least == max(nbytes / H100_HBM_BYTES_PER_S, flops / H100_FP32_FLOPS)


@pytest.mark.parametrize("cell", ["rodent.flat", "pair.flat"])
def test_cell_sizes_match_the_port(cell):
    """The counts from the model file alone agree with the sizes and J
    pattern the port's solver builds from the same file."""
    import torch

    from brax_tracking_tpu_torch.physics import constraint, solver, spec

    _, _, _, config = harness.load_cell(cell)
    s = solve.sizes(harness.model_file(config))
    m = spec.load_model(harness.model_file(config), device="cpu", dtype=torch.float64)
    layout = constraint.efc_layout(m)
    st = solver._fused_statics(m, layout)
    assert (s.nv, s.nefc, s.ncon, s.nroots) == (m.nv, layout.nefc, m.ncon,
                                                 len(st["root_bounds"]))
    assert s.nlim == len(st["limit_dadr"])
    assert s.j_con + s.nlim == int(st["j_pattern"]["nnz"])
    assert s.damped == bool(m.has_damping)


def test_mlp_counts():
    assert mlp.forward([3, 4, 2]) == 2 * (12 + 8)
    assert mlp.backward([3, 4, 2]) == 2 * (12 + 8) + 2 * 8
