"""The Cholesky factor and solve kernels' plain versions
(``ops/cholesky.py::factor_batched``, ``solve_batched``) and the smooth
dynamics entry points on them (``dynamics.factor_m``, ``solve_m``'s qLD
branch), against the JAX package, float64 on the CPU.

- ``factor_batched`` / ``solve_batched`` against the JAX Pallas kernels of
  the same names with ``interpret=True`` at (B, nv) = (8, 5) and (130, 73)
  (130 crosses the TPU kernels' 128-env lane padding, 73 is the rodent's
  width and pads to 80). Tolerance 1e-10 relative to the largest entry, as
  tests/test_torch_cholesky.py holds the SPD kernels: float64 eliminations
  of well-conditioned matrices (A A^T + nv I), so anything above rounding
  is a fault.
- ``factor_m`` and ``solve_m`` (its qLD branch, through the solve kernel)
  against the JAX package's ``factor_m`` /
  ``solve_m`` under vmap, on the minirat's and the ballmuscle's mass
  matrices at seeded states, at the same 1e-10; the factor has a zero
  sub-diagonal as the JAX entry returns it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.dynamics as jD
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu.ops import cholesky as jchol
from brax_tracking_tpu_torch.ops import cholesky as tchol
from brax_tracking_tpu_torch.physics import dynamics as tD
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep
from test_physics_ball_muscle import posed

RTOL = 1e-10


def _close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= RTOL * np.abs(ref).max()


def _case(B, nv, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(B, nv, nv)
    return A @ A.transpose(0, 2, 1) + nv * np.eye(nv), rng.randn(B, nv)


@pytest.mark.parametrize("B,nv", [(8, 5), (130, 73)])
def test_factor_and_solve_match_jax_kernels(B, nv):
    M, b = _case(B, nv)
    U = tchol.factor_batched(torch.as_tensor(M), device="cpu")
    jU = jchol.factor_batched(jnp.asarray(M), interpret=True)
    _close(U.numpy(), jU)
    assert np.all(np.tril(U.numpy(), -1) == 0)
    x = tchol.solve_batched(U, torch.as_tensor(b), device="cpu")
    _close(x.numpy(), jchol.solve_batched(jU, jnp.asarray(b), interpret=True))
    # and the pair solves M x = b
    assert np.abs(np.einsum("bij,bj->bi", M, x.numpy()) - b).max() <= 1e-10 * np.abs(b).max()


def test_wrappers_dispatch_and_check(monkeypatch):
    M, b = (torch.as_tensor(a) for a in _case(4, 7, seed=1))
    counts = (tchol.factor_batched.launches, tchol.solve_batched.launches)
    U = tchol.factor_batched(M, device="cpu")
    torch.testing.assert_close(U, tchol.cholesky_factor_reference(M), rtol=0, atol=0)
    torch.testing.assert_close(tchol.solve_batched(U, b, device="cpu"),
                               tchol.cholesky_solve_reference(U, b), rtol=0, atol=0)
    # the fused SPD solve is the factor followed by the solve
    torch.testing.assert_close(tchol.spd_solve(M, b, device="cpu"),
                               tchol.cholesky_solve_reference(U, b), rtol=0, atol=0)
    assert counts == (tchol.factor_batched.launches, tchol.solve_batched.launches)
    with pytest.raises(ValueError, match="shape"):
        tchol.solve_batched(U, b[:, :5], device="cpu")
    with pytest.raises(ValueError, match=r"\(B, nv, nv\)"):
        tchol.factor_batched(M[:, :, :5], device="cpu")
    with pytest.raises(TypeError, match="float32"):
        tchol._launch_factor(M)
    with pytest.raises(ValueError, match="contiguous"):
        tchol._launch_solve_factor(U.float().transpose(1, 2), b.float())
    assert tchol.factor_smem_bytes(146) == 4 * 146 * 147 <= tchol.H100_SMEM_PER_BLOCK
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tchol.factor_batched(M), lambda: tchol.solve_batched(U, b)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _minirat_qM(B=6):
    jm = jspec.build_model("builtin:minirat.xml", solver="cg", iterations=4, ls_iterations=4,
                           dtype=jnp.float64)
    rng = np.random.RandomState(2)
    qpos = np.tile(np.asarray(jm.qpos0)[None], (B, 1))
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (B, jm.nq - 7))
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstep.make_data(jm))
    dB = dB.replace(qpos=jnp.asarray(qpos))
    return jm, jax.jit(jax.vmap(lambda d: jD.crb(jm, jstep.fwd_position_smooth(jm, d))))(dB)


def _ballmuscle_qM(B=6):
    jm, mj = jspec.build_model("builtin:ballmuscle.xml", solver="newton", dtype=jnp.float64,
                               return_mj=True, **tspec.BALLMUSCLE_OPTIONS)
    qpos = np.stack([posed(mj, s).qpos for s in range(B)])
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstep.make_data(jm))
    dB = dB.replace(qpos=jnp.asarray(qpos))
    return jm, jax.jit(jax.vmap(lambda d: jD.crb(jm, jstep.fwd_position_smooth(jm, d))))(dB)


@pytest.mark.parametrize("model", ["minirat", "ballmuscle"])
def test_factor_m_and_solve_m_match_jax(model):
    jm, jd = {"minirat": _minirat_qM, "ballmuscle": _ballmuscle_qM}[model]()
    B, nv = jd.qM.shape[:2]
    jd = jax.vmap(lambda d: jD.factor_m(jm, d))(jd)
    tm = tspec.model_from_numpy(tspec.model_to_numpy(jm), device="cpu")
    td = tstep.make_data(tm, B, device="cpu").replace(qM=torch.as_tensor(np.array(jd.qM)))
    td = tD.factor_m(tm, td)
    _close(td.qLD.numpy(), jd.qLD)
    rng = np.random.RandomState(4)
    rhs = rng.randn(B, nv)
    solve = jax.vmap(lambda d, r: jD.solve_m(jm, d, r))
    _close(tD.solve_m(tm, td, torch.as_tensor(rhs)).numpy(), solve(jd, jnp.asarray(rhs)))
    assert td.qMinv is None  # the qLD branch, not the inverse
