"""The batched SPD inverse by the sweep operator, in plain PyTorch: what
the frozen solve (``ops/cg.py``) takes M^-1 with.
"""

from __future__ import annotations

import torch


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
