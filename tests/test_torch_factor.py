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

from _torch_threads import torch_one_thread  # noqa: F401
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
    assert tchol.factor_smem_bytes(146) == 4 * 148 * 148 <= tchol.H100_SMEM_PER_BLOCK
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tchol.factor_batched(M), lambda: tchol.solve_batched(U, b)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("B", [1, 2047, 2048])
def test_factor_geometry(B):
    """factor_batched's launch (csrc/cholesky.cu) at every width up to 160:
    up to FACTOR_WARP_MAX one warp per matrix, 4 per 128-thread block, and
    no shared memory; above, one block per matrix holding the matrix with
    rows and row stride padded to a multiple of 4 (16-byte tiles) within
    the H100's block, with a thread for every panel column (nv - 16) and
    at most 256 threads."""
    for nv in range(1, 161):
        blocks, threads, smem = tchol.factor_geometry(B, nv)
        assert smem == tchol.factor_smem_bytes(nv) <= tchol.H100_SMEM_PER_BLOCK
        if nv <= tchol.FACTOR_WARP_MAX:
            assert (blocks, threads, smem) == (-(-B // 4), 128, 0)
        else:
            ld = -(-nv // 4) * 4
            assert ld % 4 == 0 and nv <= ld < nv + 4 and smem == 4 * ld * ld
            assert blocks == B and threads % 32 == 0
            assert nv - tchol.FACTOR_NB <= threads <= 256


def test_factor_launch_refuses_oversize():
    """The widest matrix whose padded copy fits one block is nv = 240; a
    wider one raises before any launch."""
    assert tchol.factor_smem_bytes(240) <= tchol.H100_SMEM_PER_BLOCK
    assert tchol.factor_smem_bytes(241) > tchol.H100_SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        tchol._launch_factor(torch.zeros(1, 241, 241))


@pytest.mark.parametrize("B", [1, 2047, 2048])
def test_solve_geometry(B):
    """spd_solve's and solve_batched's launches (csrc/cholesky.cu) at every
    width up to 160: up to FACTOR_WARP_MAX 128-thread blocks of 8, 16 or 32
    lanes per system (4 warps of 4, 2 or 1 systems) and no shared memory;
    above, one block per system, spd_solve with factor_batched's threads and
    its padded matrix plus the right-hand side, solve_batched with 128
    threads and U's upper triangle by panels of 16 rows (each panel's rows
    from its first column) plus the right-hand side."""
    for nv in range(1, 161):
        spd, chol = tchol.spd_solve_geometry(B, nv), tchol.solve_geometry(B, nv)
        assert spd[2] == tchol.spd_solve_smem_bytes(nv) <= tchol.H100_SMEM_PER_BLOCK
        assert chol[2] == tchol.solve_smem_bytes(nv) <= tchol.H100_SMEM_PER_BLOCK
        if nv <= tchol.FACTOR_WARP_MAX:
            lanes = 8 if nv <= 8 else (16 if nv <= 16 else 32)
            assert tchol.solve_segment(nv) == lanes
            assert spd == chol == (-(-B // (128 // lanes)), 128, 0)
        else:
            ld = -(-nv // 4) * 4
            _, threads, _ = tchol.factor_geometry(B, nv)
            assert spd == (B, threads, 4 * (ld * ld + ld))
            k0 = (nv - 1) // 16 * 16
            panels = sum(min(16, nv - p) * (nv - p) for p in range(0, nv, 16))
            assert panels == k0 * nv - k0 * (k0 - 16) // 2 + (nv - k0) ** 2
            assert chol == (B, 128, 4 * (panels + nv))


def test_solve_launches_refuse_oversize():
    """The widest system whose padded factor fits one block is nv = 240
    for spd_solve; solve_batched's triangle by panels fits up to nv = 332.
    A wider one raises before any launch."""
    assert tchol.spd_solve_smem_bytes(240) <= tchol.H100_SMEM_PER_BLOCK
    assert tchol.spd_solve_smem_bytes(241) > tchol.H100_SMEM_PER_BLOCK
    assert tchol.solve_smem_bytes(332) <= tchol.H100_SMEM_PER_BLOCK
    assert tchol.solve_smem_bytes(333) > tchol.H100_SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        tchol._launch_solve(torch.zeros(1, 241, 241), torch.zeros(1, 241))
    with pytest.raises(ValueError, match="shared memory"):
        tchol._launch_solve_factor(torch.zeros(1, 333, 333), torch.zeros(1, 333))


@pytest.mark.parametrize("nv", [7, 33])
def test_plain_versions_read_only_the_upper_triangle(nv):
    """The factor, the solve from U and the SPD solve give bitwise the same
    result with NaN in the strict lower triangle of their matrix: they are
    functions of its upper triangle (the CUDA kernels are held to the same
    on the card by chip_smoke.py)."""
    M, b = (torch.as_tensor(a) for a in _case(5, nv, seed=3))
    lower = torch.ones(nv, nv, dtype=torch.bool).tril(-1)
    U = tchol.cholesky_factor_reference(M)
    for fn, args in ((tchol.cholesky_factor_reference, (M,)),
                     (tchol.cholesky_solve_reference, (U, b)),
                     (tchol.spd_solve_reference, (M, b))):
        clean = fn(*args)
        dirty = fn(args[0].masked_fill(lower, float("nan")), *args[1:])
        assert torch.isfinite(dirty).all()
        torch.testing.assert_close(dirty, clean, rtol=0, atol=0)


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
