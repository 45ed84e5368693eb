"""The port's SPD inverse and solve kernels (ops/cholesky.py): their plain
versions against the JAX package's Pallas kernels, float64 on the CPU.

The JAX kernels run with ``interpret=True`` as tests/test_ops_cholesky.py
runs them; under ``jax_enable_x64`` they compute in float64, within ~1e-16
of numpy. Seeded SPD matrices at nv in {7 (ballmuscle), 13} and B in
{5, 130} (130 crosses the TPU kernels' 128-env lane padding); the SPD
solve also at (nv, B) = (33, 8) and (73, 130), past the CUDA kernel's
register path (nv <= 32) into its blocked one. Tolerance
1e-10 relative to the largest entry: both sides are float64 eliminations of
well-conditioned matrices (condition number < ~10), so anything above
rounding (~1e-15) is a fault; 1e-10 leaves room for the two elimination
orders (blocked on the TPU side, one pivot at a time here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu.ops import cholesky as jchol
from brax_tracking_tpu_torch.ops import cholesky as tchol

RTOL = 1e-10
SHAPES = [(7, 5), (7, 130), (13, 5), (13, 130)]
SOLVE_SHAPES = SHAPES + [(33, 8), (73, 130)]
# the inverses also across the CUDA kernel's design edges: the register
# sweep's widest class (16), the blocked sweep's first width (33), a full
# and a partial last panel of 16 pivots (48, 17 / 73)
INVERSE_SHAPES = SHAPES + [(16, 8), (17, 8), (33, 8), (48, 8), (73, 130)]
PANEL_WIDTHS = (7, 15, 16, 17, 33, 48, 73)


def _case(nv, B, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(B, nv, nv)
    M = A @ A.transpose(0, 2, 1) + nv * np.eye(nv)
    return M, rng.randn(B, nv), rng.uniform(0.01, 0.1, nv)


def _close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("nv,B", INVERSE_SHAPES)
def test_inverse_matches_jax_kernel(nv, B):
    M, _, _ = _case(nv, B)
    ref = jchol.inverse_batched(jnp.asarray(M), interpret=True)
    _close(tchol.spd_inverse(torch.as_tensor(M), device="cpu").numpy(), ref)


@pytest.mark.parametrize("nv,B", INVERSE_SHAPES)
def test_inverse2_matches_jax_kernel(nv, B):
    M, _, damp = _case(nv, B)
    ref = jchol.inverse2_batched(jnp.asarray(M), jnp.asarray(damp), interpret=True)
    out = tchol.spd_inverse2(torch.as_tensor(M), torch.as_tensor(damp), device="cpu")
    for o, r in zip(out, ref):
        _close(o.numpy(), r)


@pytest.mark.parametrize("nv", PANEL_WIDTHS)
def test_inverse_panels_match_jax_kernel(nv):
    """The blocked CUDA sweep's grouping (panels of 16 pivots, the last one
    padded with the identity, each panel's steps replayed on its rows and
    columns and the rest updated by one 16-deep product) against the JAX
    kernel, which sweeps blocks of 8 through the block's explicit
    inverse."""
    M, _, _ = _case(nv, 8, seed=3)
    ref = jchol.inverse_batched(jnp.asarray(M), interpret=True)
    _close(tchol._sweep_inverse_panels_reference(torch.as_tensor(M)).numpy(), ref)


@pytest.mark.parametrize("nv,B", SOLVE_SHAPES)
def test_solve_matches_jax_kernel(nv, B):
    M, b, _ = _case(nv, B)
    ref = jchol.factor_solve_batched(jnp.asarray(M), jnp.asarray(b), interpret=True)
    _close(tchol.spd_solve(torch.as_tensor(M), torch.as_tensor(b), device="cpu").numpy(), ref)


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors each wrapper returns exactly its plain version and
    launches nothing."""
    M, b, damp = (torch.as_tensor(a) for a in _case(7, 4, seed=1))
    counts = [f.launches for f in (tchol.spd_inverse, tchol.spd_inverse2, tchol.spd_solve)]
    torch.testing.assert_close(
        tchol.spd_inverse(M, device="cpu"), tchol.sweep_inverse_reference(M), rtol=0, atol=0
    )
    inv, invd = tchol.spd_inverse2(M, damp, device="cpu")
    torch.testing.assert_close(inv, tchol.sweep_inverse_reference(M), rtol=0, atol=0)
    torch.testing.assert_close(
        invd, tchol.sweep_inverse_reference(M + torch.diag(damp)), rtol=0, atol=0
    )
    torch.testing.assert_close(
        tchol.spd_solve(M, b, device="cpu"), tchol.spd_solve_reference(M, b), rtol=0, atol=0
    )
    assert counts == [f.launches for f in (tchol.spd_inverse, tchol.spd_inverse2, tchol.spd_solve)]


def test_wrappers_check_their_arguments(monkeypatch):
    M, b, damp = (torch.as_tensor(a) for a in _case(7, 4, seed=2))
    with pytest.raises(ValueError, match="shape"):
        tchol.spd_solve(M, b[:, :5], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tchol.spd_inverse2(M, damp[:3], device="cpu")
    with pytest.raises(ValueError, match=r"\(B, nv, nv\)"):
        tchol.spd_inverse(M[:, :, :5], device="cpu")
    # the kernels take contiguous float32 only (checked before any launch)
    with pytest.raises(TypeError, match="float32"):
        tchol._launch_solve(M, b)
    with pytest.raises(ValueError, match="contiguous"):
        tchol._launch_inverse(M.float().transpose(1, 2), damp.float(), 2)
    # entry points default to the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tchol.spd_inverse(M), lambda: tchol.spd_inverse2(M, damp),
                 lambda: tchol.spd_solve(M, b)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_shared_memory_rule():
    """One block holds one matrix: the blocked sweep (nv > 32) holds the
    matrix with rows and row stride padded to a multiple of 4, a panel's
    scaled pivot rows and pivot columns outside it (16 x ld each) and the
    16 x 16 pivot block's steps (two 16 x 16 tables): 108.6 KB at
    rodent_pair's nv = 146, so 2 blocks share an SM;
    nv = 240 does not fit a block of the H100. The SPD solve holds the
    factor's padded matrix and the right-hand side (88.2 KB at 146); the
    solve from U only U's upper triangle by panels of 16 rows (each panel's
    rows from its first column: 146 x 147 / 2 floats plus 9 panels' lower
    16 x 16 triangles and the last one's, 2 x 2) and the right-hand side
    (47.8 KB), so that 4 of its blocks share an SM's 228 KB (1 KB of it
    reserved per block). Up to nv = 32 the inverses and the Cholesky
    solves use no shared memory."""
    assert tchol.inverse_smem_bytes(146) == 4 * (148 * 148 + 2 * 16 * 148 + 2 * 256)
    assert 2 * (tchol.inverse_smem_bytes(146) + 1024) <= 228 * 1024
    assert tchol.inverse_smem_bytes(240) > tchol.H100_SMEM_PER_BLOCK
    assert tchol.inverse_smem_bytes(32) == 0
    assert tchol.spd_solve_smem_bytes(146) == 4 * (148 * 148 + 148) <= tchol.H100_SMEM_PER_BLOCK
    assert tchol.solve_smem_bytes(146) == 4 * (146 * 147 // 2 + 9 * 120 + 1 + 146)
    assert 4 * (tchol.solve_smem_bytes(146) + 1024) <= 228 * 1024
    assert tchol.spd_solve_smem_bytes(32) == tchol.solve_smem_bytes(32) == 0


@pytest.mark.parametrize("B", [2048, 2047])
@pytest.mark.parametrize("ninv", [1, 2])
def test_inverse_geometry(B, ninv):
    """One unit of work per (matrix, inverse). Up to nv = 32 a unit takes a
    segment of 8, 16 or 32 lanes of a 128-thread block (16, 8 or 4 units
    per block); above, a block of its own: 128 threads up to nv = 80, 256
    above, with the padded layout's shared memory."""
    units = B * ninv
    for nv, per_block in ((7, 16), (8, 16), (9, 8), (16, 8), (17, 4), (32, 4)):
        assert tchol.inverse_geometry(B, nv, ninv) == (-(-units // per_block), 128, 0)
    for nv, threads in ((33, 128), (80, 128), (81, 256), (146, 256)):
        ld = -(-nv // 4) * 4
        smem = 4 * (ld * ld + 32 * ld + 512)
        assert tchol.inverse_geometry(B, nv, ninv) == (units, threads, smem)
    # the launch refuses a block past the H100's shared memory (before any
    # launch, so on the CPU too)
    M = torch.eye(240).repeat(2, 1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        tchol._launch_inverse(M, torch.zeros(240) if ninv == 2 else None, ninv)
