"""Batched SPD inverses, the SPD solve and the Cholesky factor and solve:
CUDA kernels and their plain versions.

Replaces the TPU kernels of ``brax_tracking_tpu/ops/cholesky.py``:

- ``spd_inverse``: ``inverse_batched`` (M^-1 by the sweep operator);
- ``spd_inverse2``: ``inverse2_batched`` (M^-1 and (M + diag(damp))^-1
  from one staged M), the XLA-CG path's ``dynamics.invert_m`` on a damped
  model, once per substep;
- ``spd_solve``: ``factor_solve_batched`` (Cholesky factor and both
  substitutions, the factor kept on chip), the Newton path's qacc_smooth,
  Hessian step and damped Euler update;
- ``factor_batched`` / ``solve_batched``: the TPU kernels of the same
  names, the upper factor U (M = U^T U) written out and the solve from it:
  ``dynamics.factor_m`` and the qLD branch of ``dynamics.solve_m``.

Hopper design (``csrc/spd_inverse.cu``, ``csrc/cholesky.cu`` on the
pieces of ``csrc/cholesky.cuh``). Up to nv = 32 a matrix lives in the
registers of a segment of 8, 16 or 32 lanes (several matrices per warp at
the engine's widths), lane c holding column c, with no shared memory and no
barrier, and each step takes what it needs from another lane by shuffles.
The sweep inverts one (matrix, inverse) unit per segment, the pair's two
units in one launch, pivot k's column coming from lane k. The Cholesky
kernels share one factor and read only the upper triangle of their matrix:
the factor and both substitutions are right-looking with one shuffle per
step, and the solves keep row c of U beside column c so that the backward
pass needs one shuffle per step too. Above that one block per matrix (per
unit for the sweep) in shared memory, in panels of 16 pivots: one warp
works the panel's 16 x 16 diagonal block in registers, and the rest of the
panel's work is a 16-deep update by every thread in 4 x 4 register tiles,
two barriers per panel. The sweep replays the block's 16 steps on the
panel's rows and columns, so every entry gets the scalar sweep's updates in
its order. ``factor_batched`` writes U; ``spd_solve`` factors on the same
code and keeps U on chip; ``solve_batched`` stages only U's upper triangle,
by panels, one panel of rows at a time. ``inverse_geometry``,
``factor_geometry``, ``spd_solve_geometry`` and ``solve_geometry`` give the
launches. All are bound by their bytes from nv ~ 12 up (the pair of
inverses and the SPD solve by their operations at nv = 146) and by launch
latency at the ballmuscle's nv = 7 and the minirat's 10. Each source says
more.

``sweep_inverse_reference``, ``cholesky_factor_reference``,
``cholesky_solve_reference`` and ``spd_solve_reference`` are the plain
PyTorch versions: the functions each kernel computes, and its yardstick.
They eliminate one pivot at a time. The kernels apply each entry's updates
in the same pivot order, but contract them to fused multiply-adds, use the
hardware reciprocal square root, multiply by reciprocals where the plain
versions divide and, in the blocked paths, group the pivots in panels, so
they agree with the plain versions to rounding, not bitwise. A wrapper runs
the plain versions only for tensors on the CPU; CUDA tensors go to the
kernel (float32, contiguous) or the call raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from brax_tracking_tpu_torch.device import check_device, resolve_device
from brax_tracking_tpu_torch.ops import library
from brax_tracking_tpu_torch.training import debug_nans

H100_SMEM_PER_BLOCK = library.H100_SMEM_PER_BLOCK
# spd_inverse: widths up to INVERSE_WARP_MAX are swept in registers, wider
# ones in shared memory in panels of INVERSE_NB pivots (csrc/spd_inverse.cu)
INVERSE_WARP_MAX = 32
INVERSE_NB = 16


def inverse_smem_bytes(nv: int) -> int:
    """Shared memory of one spd_inverse block: none up to INVERSE_WARP_MAX,
    else the matrix with rows and row stride padded to a multiple of 4
    (16-byte tiles), each panel step's scaled pivot row and negated pivot
    column outside the panel (INVERSE_NB x ld each) and the pivot block's
    steps (2 x INVERSE_NB x INVERSE_NB), float32."""
    if nv <= INVERSE_WARP_MAX:
        return 0
    ld = -(-nv // 4) * 4
    return 4 * (ld * ld + 2 * INVERSE_NB * ld + 2 * INVERSE_NB * INVERSE_NB)


def inverse_geometry(B: int, nv: int, ninv: int) -> Tuple[int, int, int]:
    """(blocks, threads per block, shared memory bytes per block) of a
    spd_inverse launch on B matrices of width nv, ninv inverses each (1:
    M^-1; 2: also (M + diag(damp))^-1), one unit of work per (matrix,
    inverse): up to INVERSE_WARP_MAX, 128-thread blocks of
    solve_segment(nv) lanes per unit (as the register solves); above, one
    block per unit, 128 threads up to nv = 80 and 256 above."""
    units = B * ninv
    if nv <= INVERSE_WARP_MAX:
        return _solve_warp_geometry(units, nv)
    return units, (128 if nv <= 80 else 256), inverse_smem_bytes(nv)


# factor_batched: widths up to FACTOR_WARP_MAX take one warp per matrix and
# no shared memory; wider ones the blocked factor in panels of FACTOR_NB rows
# (csrc/cholesky.cu), where each thread solves at most one panel column
FACTOR_WARP_MAX = 32
FACTOR_NB = 16
_FACTOR_WARPS_PER_BLOCK = 4


def factor_smem_bytes(nv: int) -> int:
    """Shared memory of one factor_batched block: none up to
    FACTOR_WARP_MAX, else the matrix with rows and row stride padded to a
    multiple of 4 (16-byte tiles), float32."""
    if nv <= FACTOR_WARP_MAX:
        return 0
    ld = -(-nv // 4) * 4
    return 4 * ld * ld


def factor_geometry(B: int, nv: int) -> Tuple[int, int, int]:
    """(blocks, threads per block, shared memory bytes per block) of a
    factor_batched launch on B matrices of width nv: up to
    FACTOR_WARP_MAX, 4 matrices per 128-thread block; above, one block per
    matrix with enough threads for one panel column each (128 up to
    nv = 144, else 256)."""
    if nv <= FACTOR_WARP_MAX:
        w = _FACTOR_WARPS_PER_BLOCK
        return -(-B // w), 32 * w, 0
    return B, (128 if nv - FACTOR_NB <= 128 else 256), factor_smem_bytes(nv)


def spd_solve_smem_bytes(nv: int) -> int:
    """Shared memory of one spd_solve block: none up to FACTOR_WARP_MAX,
    else the factor's padded matrix (factor_smem_bytes) and the
    right-hand side (ld floats), float32."""
    if nv <= FACTOR_WARP_MAX:
        return 0
    ld = -(-nv // 4) * 4
    return factor_smem_bytes(nv) + 4 * ld


def solve_smem_bytes(nv: int) -> int:
    """Shared memory of one solve_batched block: none up to
    FACTOR_WARP_MAX, else U's upper triangle by panels of FACTOR_NB rows
    (panel p, from row k0 = FACTOR_NB p, as rows of nv - k0 floats from
    column k0) and the right-hand side, float32."""
    if nv <= FACTOR_WARP_MAX:
        return 0
    k0 = (nv - 1) // FACTOR_NB * FACTOR_NB  # the last panel
    return 4 * (k0 * nv - k0 * (k0 - FACTOR_NB) // 2 + (nv - k0) ** 2 + nv)


def solve_segment(nv: int) -> int:
    """Lanes per matrix of the register solves (nv <= FACTOR_WARP_MAX): 8
    up to nv = 8, 16 up to 16, else a whole warp."""
    return 8 if nv <= 8 else (16 if nv <= 16 else 32)


def _solve_warp_geometry(B: int, nv: int) -> Tuple[int, int, int]:
    per_block = _FACTOR_WARPS_PER_BLOCK * 32 // solve_segment(nv)
    return -(-B // per_block), 32 * _FACTOR_WARPS_PER_BLOCK, 0


def spd_solve_geometry(B: int, nv: int) -> Tuple[int, int, int]:
    """(blocks, threads per block, shared memory bytes per block) of an
    spd_solve launch on B systems of width nv: up to FACTOR_WARP_MAX,
    128-thread blocks of solve_segment(nv) lanes per system; above, one
    block per system with factor_batched's threads."""
    if nv <= FACTOR_WARP_MAX:
        return _solve_warp_geometry(B, nv)
    return B, factor_geometry(B, nv)[1], spd_solve_smem_bytes(nv)


def solve_geometry(B: int, nv: int) -> Tuple[int, int, int]:
    """(blocks, threads per block, shared memory bytes per block) of a
    solve_batched launch on B systems of width nv: up to FACTOR_WARP_MAX
    as spd_solve; above, one 128-thread block per system."""
    if nv <= FACTOR_WARP_MAX:
        return _solve_warp_geometry(B, nv)
    return B, 128, solve_smem_bytes(nv)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def sweep_inverse_reference(a: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse (B, n, n) by the sweep operator: the formulas of
    the TPU kernel's ``sweep_invert_ref`` one pivot at a time, in the CUDA
    kernel's order."""
    s = a.clone()
    for k in range(a.shape[-1]):
        row = s[:, k, :].clone()
        col = s[:, :, k].clone()
        dinv = 1.0 / s[:, k, k]
        row_d = row * dinv[:, None]
        s = s - col[:, :, None] * row_d[:, None, :]
        s[:, k, :] = row_d
        s[:, :, k] = -col * dinv[:, None]
        s[:, k, k] = dinv
    return s


def _sweep_inverse_panels_reference(a: torch.Tensor, nb: int = INVERSE_NB) -> torch.Tensor:
    """Batched SPD inverse (B, n, n) by the sweep in panels of nb pivots,
    grouped as the CUDA kernel groups it above INVERSE_WARP_MAX (no wrapper
    calls it): per panel the pivot block (the last partial one padded with
    the identity) is swept one pivot at a time, the same steps are replayed
    on the panel's rows and on its columns outside the block, recording each
    step's scaled pivot row Rk and pivot column Ck outside the panel, and
    the rest takes the panel's nb updates at once, S -= Ck^T Rk. Every entry
    receives the scalar sweep's updates in its pivot order, so this is
    ``sweep_inverse_reference`` regrouped; the TPU kernel's
    ``sweep_invert_ref`` computes the same function through the block's
    explicit inverse."""
    s = a.clone()
    B, n, _ = a.shape
    for kb in range(0, n, nb):
        b = min(nb, n - kb)
        p = slice(kb, kb + b)
        rest = torch.cat([torch.arange(kb), torch.arange(kb + b, n)]).to(a.device)
        A = torch.eye(nb, dtype=a.dtype, device=a.device).repeat(B, 1, 1)
        A[:, :b, :b] = s[:, p, p]
        rows = a.new_zeros(B, nb, n - b)  # the panel's rows outside the block
        rows[:, :b] = s[:, p][:, :, rest]
        cols = a.new_zeros(B, n - b, nb)  # the panel's columns outside the block
        cols[:, :, :b] = s[:, rest][:, :, p]
        Rk = a.new_empty(B, nb, n - b)
        Ck = a.new_empty(B, nb, n - b)
        for k in range(nb):
            dinv = 1.0 / A[:, k, k]
            acol, arow_d = A[:, :, k].clone(), A[:, k, :] * dinv[:, None]
            Rk[:, k] = rows[:, k] * dinv[:, None]
            rows = rows - acol[:, :, None] * Rk[:, k, None, :]
            rows[:, k] = Rk[:, k]
            Ck[:, k] = cols[:, :, k]
            cols = cols - Ck[:, k, :, None] * arow_d[:, None, :]
            cols[:, :, k] = -Ck[:, k] * dinv[:, None]
            A = A - acol[:, :, None] * arow_d[:, None, :]
            A[:, k, :] = arow_d
            A[:, :, k] = -acol * dinv[:, None]
            A[:, k, k] = dinv
        s[:, rest[:, None], rest[None, :]] -= Ck.transpose(1, 2) @ Rk
        s[:, p, rest] = rows[:, :b]
        s[:, rest, p] = cols[:, :, :b]
        s[:, p, p] = A[:, :b, :b]
    return s


def cholesky_factor_reference(a: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor U (a = U^T U, zero below the diagonal) of SPD a
    (B, n, n), from a's upper triangle: right-looking, one pivot at a time
    (the function of the TPU kernels' ``_factor_kernel`` /
    ``_factor_ref_blocked``). The CUDA kernels compute the same function
    and apply each entry's updates in the same pivot order, but not
    bitwise (module docstring)."""
    U = a.clone()
    for k in range(a.shape[-1]):
        U[:, k, k:] = U[:, k, k:] * torch.rsqrt(U[:, k, k])[:, None]
        u = U[:, k, k + 1:]
        U[:, k + 1:, k + 1:] -= u[:, :, None] * u[:, None, :]
    return torch.triu(U)


def cholesky_solve_reference(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves U^T U x = b for upper U (B, n, n), b (B, n), from U's upper
    triangle: both substitutions right-looking, one pivot at a time (the
    function of the TPU kernel's ``_solve_kernel``). The CUDA kernel
    computes the same function, not bitwise (module docstring)."""
    y = b.clone()
    n = U.shape[-1]
    for k in range(n):
        yk = y[:, k] / U[:, k, k]
        y[:, k + 1:] -= U[:, k, k + 1:] * yk[:, None]
        y[:, k] = yk
    for k in reversed(range(n)):
        xk = y[:, k] / U[:, k, k]
        y[:, :k] -= U[:, :k, k] * xk[:, None]
        y[:, k] = xk
    return y


def spd_solve_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves a x = b for SPD a (B, n, n), b (B, n), from a's upper
    triangle: the factor and both substitutions (the function of the TPU
    kernel's ``_factor_solve_kernel``)."""
    return cholesky_solve_reference(cholesky_factor_reference(a), b)


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _check_kernel_args(name, smem, **tensors):
    for k, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel: {k} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {k} must be contiguous")
    if smem > H100_SMEM_PER_BLOCK:
        raise ValueError(
            f"{name} kernel: needs {smem} B of shared memory per block "
            f"(limit {H100_SMEM_PER_BLOCK})"
        )


def _launch_inverse(qM: torch.Tensor, damp, ninv: int):
    """The sweep kernel on (B, nv, nv): (M^-1,) (ninv 1, damp None) or
    (M^-1, (M + diag(damp))^-1) (ninv 2)."""
    B, nv, _ = qM.shape
    _, threads, smem = inverse_geometry(B, nv, ninv)
    tensors = {"qM": qM} if damp is None else {"qM": qM, "damp": damp}
    _check_kernel_args("spd_inverse", smem, **tensors)
    outs = tuple(torch.empty_like(qM) for _ in range(ninv))
    stream = torch.cuda.current_stream(qM.device).cuda_stream
    err = library.lib().spd_inverse_launch(
        library.ptr(qM), None if damp is None else library.ptr(damp), library.ptr(outs[0]),
        library.ptr(outs[-1]), B, nv, ninv, threads, smem, stream,
    )
    library.check("spd_inverse", err)
    debug_nans.check_kernel("spd_inverse", outs)
    return outs


def _launch_solve(qM: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    B, nv, _ = qM.shape
    _, threads, smem = spd_solve_geometry(B, nv)
    _check_kernel_args("spd_solve", smem, qM=qM, b=b)
    x = torch.empty_like(b)
    stream = torch.cuda.current_stream(qM.device).cuda_stream
    err = library.lib().spd_solve_launch(
        library.ptr(qM), library.ptr(b), library.ptr(x), B, nv, threads, smem, stream
    )
    library.check("spd_solve", err)
    debug_nans.check_kernel("spd_solve", (x,))
    return x


def _launch_factor(qM: torch.Tensor) -> torch.Tensor:
    B, nv, _ = qM.shape
    _, threads, smem = factor_geometry(B, nv)
    _check_kernel_args("factor_batched", smem, qM=qM)
    U = torch.empty_like(qM)
    stream = torch.cuda.current_stream(qM.device).cuda_stream
    err = library.lib().cholesky_factor_launch(
        library.ptr(qM), library.ptr(U), B, nv, threads, smem, stream
    )
    library.check("factor_batched", err)
    debug_nans.check_kernel("factor_batched", (U,))
    return U


def _launch_solve_factor(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    B, nv, _ = U.shape
    _, threads, smem = solve_geometry(B, nv)
    _check_kernel_args("solve_batched", smem, U=U, b=b)
    x = torch.empty_like(b)
    stream = torch.cuda.current_stream(U.device).cuda_stream
    err = library.lib().cholesky_solve_launch(
        library.ptr(U), library.ptr(b), library.ptr(x), B, nv, threads, smem, stream
    )
    library.check("solve_batched", err)
    debug_nans.check_kernel("solve_batched", (x,))
    return x


def _check_shapes(name, qM, **vectors):
    if qM.dim() != 3 or qM.shape[1] != qM.shape[2]:
        raise ValueError(f"{name}: qM must be (B, nv, nv), got {tuple(qM.shape)}")
    for k, (t, shape) in vectors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, expected {shape}")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def spd_inverse(qM: torch.Tensor, device="cuda") -> torch.Tensor:
    """M^-1 for SPD qM (B, nv, nv). CPU tensors run the plain version; CUDA
    tensors launch the kernel (float32) or raise."""
    dev = resolve_device(device)
    _check_shapes("spd_inverse", qM)
    check_device(dev, qM=qM)
    if dev.type == "cpu":
        return sweep_inverse_reference(qM)
    (out,) = _launch_inverse(qM, None, 1)
    spd_inverse.launches += 1
    return out


def spd_inverse2(
    qM: torch.Tensor, damp: torch.Tensor, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M^-1, (M + diag(damp))^-1) for SPD qM (B, nv, nv) and damp (nv,),
    one launch on the card. CPU tensors run the plain version."""
    dev = resolve_device(device)
    nv = qM.shape[-1]
    _check_shapes("spd_inverse2", qM, damp=(damp, (nv,)))
    check_device(dev, qM=qM, damp=damp)
    if dev.type == "cpu":
        return sweep_inverse_reference(qM), sweep_inverse_reference(qM + torch.diag(damp))
    out = _launch_inverse(qM, damp, 2)
    spd_inverse2.launches += 1
    return out


def spd_solve(qM: torch.Tensor, b: torch.Tensor, device="cuda") -> torch.Tensor:
    """x with qM x = b for SPD qM (B, nv, nv), b (B, nv). CPU tensors run
    the plain version; CUDA tensors launch the kernel (float32) or raise."""
    dev = resolve_device(device)
    _check_shapes("spd_solve", qM, b=(b, qM.shape[:2]))
    check_device(dev, qM=qM, b=b)
    if dev.type == "cpu":
        return spd_solve_reference(qM, b)
    x = _launch_solve(qM, b)
    spd_solve.launches += 1
    return x


def factor_batched(qM: torch.Tensor, device="cuda") -> torch.Tensor:
    """Upper Cholesky factor U (qM = U^T U, zero below the diagonal) of SPD
    qM (B, nv, nv). CPU tensors run the plain version; CUDA tensors launch
    the kernel (float32) or raise."""
    dev = resolve_device(device)
    _check_shapes("factor_batched", qM)
    check_device(dev, qM=qM)
    if dev.type == "cpu":
        return cholesky_factor_reference(qM)
    U = _launch_factor(qM)
    factor_batched.launches += 1
    return U


def solve_batched(U: torch.Tensor, b: torch.Tensor, device="cuda") -> torch.Tensor:
    """x with U^T U x = b for upper factors U (B, nv, nv) and b (B, nv).
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (float32) or raise."""
    dev = resolve_device(device)
    _check_shapes("solve_batched", U, b=(b, U.shape[:2]))
    check_device(dev, U=U, b=b)
    if dev.type == "cpu":
        return cholesky_solve_reference(U, b)
    x = _launch_solve_factor(U, b)
    solve_batched.launches += 1
    return x


# kernel launches since each count was last set to 0
spd_inverse.launches = 0
spd_inverse2.launches = 0
spd_solve.launches = 0
factor_batched.launches = 0
solve_batched.launches = 0
