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

Hopper design (``csrc/spd_inverse.cu``, ``csrc/spd_solve.cu``,
``csrc/cholesky.cu``): one block per matrix, the matrix in shared memory
for the whole factor or sweep, each input read once and each output written
once. ``spd_solve`` and ``solve_batched`` run the block-level pieces of
``csrc/cholesky.cuh`` (one pivot per step). ``factor_batched`` has a
factor of its own: one warp per matrix in registers up to nv = 32, above
that a blocked factor in panels of 16 rows with the trailing update in
register tiles (``factor_geometry`` gives its launch). The sweep is bound
by its FP32 operations at rodent size, the Cholesky kernels by their
bytes; at the ballmuscle's nv = 7 all are bound by launch latency. Each
source says more.

``sweep_inverse_reference``, ``cholesky_factor_reference``,
``cholesky_solve_reference`` and ``spd_solve_reference`` are the plain
PyTorch versions: the functions each kernel computes, and its yardstick.
They eliminate one pivot at a time; the kernels apply each entry's updates
in the same pivot order but contract them to fused multiply-adds, use the
hardware reciprocal square root and, in the blocked factor, group the
pivots in panels, so they agree with the plain versions to rounding, not
bitwise. A wrapper runs the plain versions only for tensors on the CPU;
CUDA tensors go to the kernel (float32, contiguous) or the call raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from brax_tracking_tpu_torch.device import check_device, resolve_device
from brax_tracking_tpu_torch.ops import library

H100_SMEM_PER_BLOCK = library.H100_SMEM_PER_BLOCK


def inverse_smem_bytes(nv: int) -> int:
    """Shared memory of one spd_inverse block: the matrix (row stride
    nv | 1) and the pivot row and column, float32."""
    return 4 * (nv * (nv | 1) + 2 * nv)


def solve_smem_bytes(nv: int) -> int:
    """Shared memory of one spd_solve or solve_batched block: the factor
    (row stride nv | 1) and the right-hand side, float32."""
    return 4 * (nv * (nv | 1) + nv)


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
    """Solves U^T U x = b for upper U (B, n, n), b (B, n): both
    substitutions right-looking, in the CUDA kernels' order."""
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
    """Solves a x = b for SPD a (B, n, n), b (B, n): the factor and both
    substitutions, as the fused kernel computes them."""
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


def _launch_inverse(qM: torch.Tensor, damp: torch.Tensor, ninv: int):
    """The sweep kernel on (B, nv, nv): (M^-1,) or (M^-1, (M + diag(damp))^-1)."""
    B, nv, _ = qM.shape
    smem = inverse_smem_bytes(nv)
    _check_kernel_args("spd_inverse", smem, qM=qM, damp=damp)
    outs = tuple(torch.empty_like(qM) for _ in range(ninv))
    stream = torch.cuda.current_stream(qM.device).cuda_stream
    err = library.lib().spd_inverse_launch(
        library.ptr(qM), library.ptr(damp), library.ptr(outs[0]),
        library.ptr(outs[-1]), B, nv, ninv, smem, stream,
    )
    library.check("spd_inverse", err)
    return outs


def _launch_solve(qM: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    B, nv, _ = qM.shape
    smem = solve_smem_bytes(nv)
    _check_kernel_args("spd_solve", smem, qM=qM, b=b)
    x = torch.empty_like(b)
    stream = torch.cuda.current_stream(qM.device).cuda_stream
    err = library.lib().spd_solve_launch(
        library.ptr(qM), library.ptr(b), library.ptr(x), B, nv, smem, stream
    )
    library.check("spd_solve", err)
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
    return U


def _launch_solve_factor(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    B, nv, _ = U.shape
    smem = solve_smem_bytes(nv)
    _check_kernel_args("solve_batched", smem, U=U, b=b)
    x = torch.empty_like(b)
    stream = torch.cuda.current_stream(U.device).cuda_stream
    err = library.lib().cholesky_solve_launch(
        library.ptr(U), library.ptr(b), library.ptr(x), B, nv, smem, stream
    )
    library.check("solve_batched", err)
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
    (out,) = _launch_inverse(qM, qM.new_zeros(qM.shape[-1]), 1)
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
