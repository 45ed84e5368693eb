"""The dense-input solve kernel's plain version (``cg_solve_batched``)
against the JAX package's ``ops/cg.cg_solve_batched(interpret=True)``,
float64 on the CPU, on the seeded problems of tests/test_ops_cg.py: random
SPD qM, dense J with scalar limit rows first, a contiguous block of dim-3
elliptic contacts after them, quadratic contact rows last.

Cases: quadratic rows only, undamped; the same damped; mixed (4 limits,
2 elliptic contacts, 3 quadratic rows, damped); pure elliptic at B = 130
(past the TPU kernel's 128-env lane padding); and the mixed case with a
warmstart and the stall exit. Tolerance rtol 1e-9 / atol 1e-11, the JAX
package's own for its kernel against its array path in float64: the same
algorithm in another summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu.ops import cg as jcg
from brax_tracking_tpu_torch.ops import cg as tcg

RTOL, ATOL = 1e-9, 1e-11
NAMES = ("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new")
CASES = {
    # B, nv, nlim, nell, quadratic contact rows, damped, warmstart + stall
    "quad": (8, 9, 0, 0, 5, False, False),
    "quad_damped": (4, 7, 3, 0, 6, True, False),
    "mixed": (6, 10, 4, 2, 3, True, False),
    "pure_elliptic": (130, 12, 0, 4, 0, True, False),
    "mixed_ws_stall": (6, 10, 4, 2, 3, True, True),
}


def _problem(B, nv, nlim, nell, nquad, damped, ws_stall, seed=1):
    rng = np.random.RandomState(seed)
    A = rng.randn(B, nv, nv)
    qM = A @ A.transpose(0, 2, 1) + nv * np.eye(nv)
    nefc = nlim + 3 * nell + nquad
    dadr = rng.permutation(nv)[:nlim]
    J = np.concatenate([
        np.where(rng.rand(B, nlim, 1) > 0.5, 1.0, -1.0) * np.eye(nv)[dadr][None],
        rng.randn(B, nefc - nlim, nv),
    ], axis=1)
    quad = np.ones(nefc, bool)
    quad[nlim : nlim + 3 * nell] = False
    kw = dict(
        iters=4, ls_iters=4, tol=1e-8, dt=0.002, has_damping=damped, ell0=nlim,
        ell_mu=tuple((0.4 + 0.3 * rng.rand(nell)).tolist()),
        ell_scale=tuple(map(tuple, (0.8 + 0.4 * rng.rand(nell, 2)).tolist())),
        stall_tol=4e-6 if ws_stall else 0.0,
    )
    arrays = dict(
        qM=qM, J=J, D=0.5 + rng.rand(B, nefc), aref=rng.randn(B, nefc),
        exists=(rng.rand(B, nefc) > 0.3) & quad, exists_con=rng.rand(B, nell) > 0.3,
        qfrc_smooth=rng.randn(B, nv), qvel=rng.randn(B, nv), damp=0.1 * rng.rand(nv),
    )
    ws = None
    if ws_stall:
        ws = rng.randn(B, nv)
        ws[::2] = 0.0
    return arrays, ws, kw


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_jax_kernel_interpret(name):
    arrays, ws, kw = _problem(*CASES[name])
    kout = jcg.cg_solve_batched(
        *(jnp.asarray(v) for v in arrays.values()), **kw,
        warmstart=None if ws is None else jnp.asarray(ws),
        unroll_iters=False, unroll_ls=False, interpret=True,  # rolled: compiles faster
    )
    tout = tcg.cg_solve_batched(
        *(torch.as_tensor(v) for v in arrays.values()), **kw,
        warmstart=None if ws is None else torch.as_tensor(ws), device="cpu",
    )
    for nm, k, t in zip(NAMES, kout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(k), rtol=RTOL, atol=ATOL, err_msg=nm)
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(kout[5]))
    assert tout[0].shape == (arrays["qM"].shape[0], arrays["qM"].shape[1])


def test_fused_plain_version_is_the_batched_one_on_assembled_inputs():
    """``cg_solve_fused_reference`` is the dense assembly followed by
    ``cg_solve_batched_reference`` (one CG core for both kernels)."""
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S
    from brax_tracking_tpu_torch.physics import spec
    from brax_tracking_tpu_torch.physics import step as pstep

    m = spec.load_model(spec.MINIRAT_ELLIPTIC_NPZ, device="cpu")
    rng = np.random.RandomState(0)
    qpos = np.tile(m.qpos0.numpy()[None], (3, 1))
    qpos[:, 2] -= 0.01
    d = pstep.make_data(m, 3, device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(rng.uniform(-1, 1, (3, m.nv))),
    )
    d = pstep.forward_to_constraint(m, d)
    args, kw = S._kernel_args(m, d, Cn.efc_layout(m))
    f, cdof, A, jsign, D, aref, exists, econ, qfs, qvel, damp, P, md, arm = args
    Bm = tcg._bm(P, A, len(kw["root_bounds"]), m.ncon)
    qM, J = tcg.assemble_qM_J(f, cdof, Bm, jsign, md, arm, row_slot=kw["row_slot"], sz=kw["sz"],
                              root_bounds=kw["root_bounds"], limit_dadr=kw["limit_dadr"])
    statics = {k: kw[k] for k in ("iters", "ls_iters", "tol", "dt", "has_damping", "ell0",
                                  "ell_mu", "ell_scale")}
    a = tcg.cg_solve_batched(qM, J, D, aref, exists, econ, qfs, qvel, damp, device="cpu", **statics)
    b = tcg.cg_solve_fused(*args, device="cpu", **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_wrapper_dispatch_and_checks(monkeypatch):
    arrays, ws, kw = _problem(*CASES["mixed_ws_stall"])
    t = {k: torch.as_tensor(v) for k, v in arrays.items()}
    launches = tcg.cg_solve_batched.launches
    out = tcg.cg_solve_batched(*t.values(), **kw, warmstart=torch.as_tensor(ws), device="cpu")
    ref = tcg.cg_solve_batched_reference(*t.values(), **kw, warmstart=torch.as_tensor(ws))
    assert tcg.cg_solve_batched.launches == launches  # the plain version launches nothing
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    bad = dict(t, exists_con=t["exists_con"][:, :1])
    with pytest.raises(ValueError, match="exists_con"):
        tcg.cg_solve_batched(*bad.values(), **kw, device="cpu")
    with pytest.raises(ValueError, match="warmstart"):
        tcg.cg_solve_batched(*t.values(), **kw, warmstart=torch.as_tensor(ws)[:, :3], device="cpu")
    with pytest.raises(ValueError, match="D has shape"):
        tcg.cg_solve_batched(*dict(t, D=t["D"][:, :3]).values(), **kw, device="cpu")
    # the kernel takes contiguous float32 only (checked before any launch)
    ell = tcg._ell_table(kw["ell_mu"], kw["ell_scale"], torch.float32, "cpu")
    f32 = {k: (v.float() if v.is_floating_point() else v) for k, v in t.items()}
    statics = {k: kw[k] for k in ("iters", "ls_iters", "tol", "dt", "has_damping", "stall_tol")}
    with pytest.raises(TypeError, match="float32"):
        tcg._launch_batched(*t.values(), ell, None, ell0=kw["ell0"], **statics)
    with pytest.raises(ValueError, match="contiguous"):
        tcg._launch_batched(*dict(f32, qM=f32["qM"].transpose(1, 2)).values(), ell, None,
                            ell0=kw["ell0"], **statics)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcg.cg_solve_batched(*t.values(), **kw)


def test_rodent_like_case():
    """chip_smoke.py's dense solve case at a rodent-like size
    (``rodent_like_case``: nv = 73, 296 rows, the first 4 scalar limits), at
    B = 6 on the CPU: qM symmetric positive definite with condition number
    within SPD_COND, the limit rows one-hot +-1 at distinct dofs, one env's
    shared memory under the H100's block; the float64 plain solve converged
    at CONVERGED_ITERS with active and inactive rows in every env; and the
    plain version at the case's 4/4 iterations against the JAX kernel in
    interpret mode on the same float64 inputs (the float32 inputs widened),
    at this file's tolerance."""
    import chip_smoke as cs

    B, nv, nefc, nlim = 6, cs.RODENT_LIKE["nv"], cs.RODENT_LIKE["nefc"], cs.RODENT_LIKE["nlim"]
    args, kw = cs.rodent_like_case("cpu", B, 0)
    qM, J, D, aref, exists, econ, qfs, qvel, damp = cs.cast(args, torch.float64)
    assert tuple(J.shape) == (B, nefc, nv) and econ.shape == (B, 0)
    assert tcg.kernel_smem_bytes(nv, nefc) <= tcg.H100_SMEM_PER_BLOCK
    torch.testing.assert_close(qM, qM.transpose(1, 2), rtol=0, atol=0)
    lam = torch.linalg.eigvalsh(qM)
    assert lam.min() > 0 and (lam[:, -1] / lam[:, 0]).max() <= 1.01 * cs.SPD_COND
    lim = J[:, :nlim]
    assert torch.all((lim != 0).sum(-1) == 1) and torch.all(lim.abs().sum(-1) == 1)
    assert torch.all(lim.abs().sum(1) <= 1)  # distinct dofs
    assert torch.all(D > 0) and exists.any(-1).all()

    conv = tcg.cg_solve_batched_reference(
        qM, J, D, aref, exists, econ, qfs, qvel, damp, **dict(kw, iters=cs.CONVERGED_ITERS))
    assert conv[5].all()
    active = ((J @ conv[0][..., None])[..., 0] - aref < 0) & exists
    assert torch.all(active.any(-1)) and torch.all((~active).any(-1))

    tout = tcg.cg_solve_batched(qM, J, D, aref, exists, econ, qfs, qvel, damp, device="cpu", **kw)
    kout = jcg.cg_solve_batched(
        *(jnp.asarray(t.numpy()) for t in (qM, J, D, aref, exists, econ, qfs, qvel, damp)), **kw,
        unroll_iters=False, unroll_ls=False, interpret=True,
    )
    for nm, k, t in zip(NAMES, kout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(k), rtol=RTOL, atol=ATOL, err_msg=nm)
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(kout[5]))


def test_pair_like_case():
    """chip_smoke.py's dense solve case at the pair's size (``PAIR_LIKE``:
    nv 146, 590 rows of which 134 are scalar limits, layout 2), at B = 2 on
    the CPU: the limit rows one-hot at distinct dofs, the env past layout 1;
    the plain version at the case's 4/4 iterations against the JAX kernel
    in interpret mode on the same float64 inputs, at this file's
    tolerance; and layout 2's design edges at the pair's rows."""
    import chip_smoke as cs

    nv, nefc, nlim = cs.PAIR_LIKE["nv"], cs.PAIR_LIKE["nefc"], cs.PAIR_LIKE["nlim"]
    args, kw = cs.rodent_like_case("cpu", 2, 0, None, cs.PAIR_LIKE)
    qM, J, D, aref, exists, econ, qfs, qvel, damp = cs.cast(args, torch.float64)
    assert tuple(J.shape) == (2, nefc, nv)
    assert tcg.kernel_layout(nv, nefc)[0] == 2
    lim = J[:, :nlim]
    assert torch.all(lim.abs().sum(-1) == 1) and torch.all(lim.abs().sum(1) <= 1)
    tout = tcg.cg_solve_batched(qM, J, D, aref, exists, econ, qfs, qvel, damp, device="cpu", **kw)
    kout = jcg.cg_solve_batched(
        *(jnp.asarray(t.numpy()) for t in (qM, J, D, aref, exists, econ, qfs, qvel, damp)), **kw,
        unroll_iters=False, unroll_ls=False, interpret=True,
    )
    for nm, k, t in zip(NAMES, kout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(k), rtol=RTOL, atol=ATOL, err_msg=nm)
    last1, first2, last2 = cs.l2_edges(nefc)
    assert (last1, first2, last2) == (72, 73, 160)
    assert [tcg.kernel_layout(n, nefc)[0] for n in (last1, first2, last2)] == [1, 2, 2]
