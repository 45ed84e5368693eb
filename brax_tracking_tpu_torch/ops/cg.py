"""Batched constraint solve + Euler velocity update: CUDA kernels.

Replaces the TPU kernels ``brax_tracking_tpu/ops/cg.py::cg_solve_fused``
(``_cg_fused_kernel`` -> ``_assemble_qM_J`` + ``_cg_core``) and
``cg_solve_batched`` (``_cg_kernel`` -> ``_cg_core``). Per env it

  1. assembles qM from the low-rank factor (crb_f, cdof) with the
     DFS-contiguous subtree masks plus armature, and J = ((P A) cdof) * md
     plus the one-hot limit rows (``cg_solve_fused``), or reads the dense
     qM and J (``cg_solve_batched``);
  2. inverts M by the sweep operator and forms qacc_smooth = M^-1 qfrc_smooth;
  3. runs MuJoCo CG (Polak-Ribiere, M^-1-preconditioned, bracketed Newton
     line search, per-env convergence freeze) on one-sided quadratic rows
     plus one contiguous block of dim-3 elliptic contacts [n, t1, t2],
     optionally started from the better of a warmstart and qacc_smooth and
     with the float32 stall exit;
  4. returns qvel + h (M + h diag(damping))^-1 (qfrc_smooth + qfrc_constraint)
     by Cholesky factor and substitution when the model has damping, else
     qvel + h qacc.

Hopper design (``csrc/cg_fused.cu``): one env per block. In layout 1 qM,
M^-1 and J live in shared memory for the whole solve, so between the input
reads and the result writes nothing touches device memory: the kernel
reads its inputs once (~3.6 KB per env at the minirat). An env whose J
does not fit (rodent_pair) runs in layout 2, with J in device memory. An
env small enough to share its SM with others (the minirat: 16 per SM)
runs on one warp; one that shares it with fewer than two others runs on a
block of ``WIDE_WARPS`` warps, which sweeps M^-1 in panels over the whole
block and spreads J p, M p and J^T f over it (``kernel_layout`` decides
both, in one place). On the roofline a call is bound by its bytes or its
FP32 operations; what the kernel actually waits on is one env's chain of
dependent steps: the assembly's loads, the sweep, and per iteration the
products, the bracket, the line search and the step. The core keeps that
chain short: independent sums share one butterfly, the 13 bracket
candidates are evaluated in one pass, J^T f reduces several columns at a
time, the one-warp sweep of a matrix up to 16 wide runs in registers, and
a wider one in panels of 8 pivots with register tiles.
Envs that converge leave the iteration loop early. The two entry points
share one device-side core per block shape and differ only in how qM and J
reach it.

``cg_solve_fused_reference`` and ``cg_solve_batched_reference`` are the
plain PyTorch versions of the same functions (dense assembly + ``_cg_arrays``,
the port of the TPU kernel's ``_cg_core``). The wrappers run them only for
tensors on the CPU; CUDA tensors go to the kernels or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from brax_tracking_tpu_torch.device import check_device, resolve_device
from brax_tracking_tpu_torch.ops import library
from brax_tracking_tpu_torch.ops.cholesky import sweep_inverse_reference
from brax_tracking_tpu_torch.physics import model as M
from brax_tracking_tpu_torch.training import debug_nans

MINVAL = M.MINVAL
# floats of nv-length scratch vectors the kernel keeps per env (see the
# layout in csrc/cg_fused.cu::carve: qfs, then x a0 mxa grad mgrad gradn
# mgradn p mp tmp y and one spare, then f and cdof, 6 each, staged for the
# assembly)
_NVEC = 13 + 12
H100_SMEM_PER_BLOCK = library.H100_SMEM_PER_BLOCK
# an H100 SM's shared memory, and what each resident block reserves of it
H100_SMEM_PER_SM = 233472
_SMEM_RESERVED_PER_BLOCK = 1024
# warps per env of the wide core by layout (csrc/cg_fused.cu,
# CG_WIDE_WARPS_L1 / _L2), from the sweep over 4, 8 and 16 on the card
# (PERF.md: the pair's layout 2 is fastest on 16, the one rat's layout 1
# on 8)
WIDE_WARPS = {1: 8, 2: 16}
# the one-warp layout-1 block above which an env runs wide: the largest of
# which three fit an SM (PERF.md: at 590 rows the one-warp core still
# matches the wide one at three blocks per SM, nv 20, and loses at two, nv
# 24)
WIDE_ABOVE_SMEM = H100_SMEM_PER_SM // 3 - _SMEM_RESERVED_PER_BLOCK
# the wide sweep's pivots per panel
_WIDE_PANEL = 8


def kernel_smem_bytes(nv: int, nefc: int, nell: int = 0, nroots: int = 0,
                      ncon: int = 0) -> int:
    """Shared memory one env's block needs in layout 1: qM, M^-1 and J (row
    stride padded to odd), six nefc-vectors, the nv-vectors (with f and cdof
    staged for the assembly) and four per-contact vectors of the elliptic
    block (activation, mu and the two tangent scales), then for
    cg_solve_fused the rest of the assembly's inputs (P A, nroots x 6
    nefc-vectors, and the (ncon, nv) support masks), all float32. The launch
    passes this size to the kernel, which carves it up with what the sweep
    inverse reads or keeps first and the rest, which its panel buffers
    overlay past nv 16, last (csrc/cg_fused.cu::carve)."""
    ld = nv | 1
    return 4 * (2 * nv * ld + nefc * ld + 6 * nefc + _NVEC * nv + 4 * nell
                + 6 * nroots * nefc + ncon * nv)


def wide_smem_bytes(nv: int, nefc: int, nell: int = 0, l2: bool = False,
                    j_floats: int = None) -> int:
    """Shared memory of one env's block in the wide core (any warp count):
    qM (nv x ldm, ldm = nv rounded up to a multiple of 4) and
    qfrc_smooth; in layout 1 J's ``j_floats`` stored values (the fused
    kernel's pattern's nnz, ``j_pattern``; the dense kernel's nefc x nv),
    by default a dense J at row stride nv | 1, the size ``kernel_layout``
    decides on; D, aref, exists and the elliptic block's four vectors; the
    done flag; then, 16-byte aligned, M^-1 (ldm x ldm) and the vectors the
    sweep does not read (jar, jarp, force at a multiple of 4 each; twelve
    nv-vectors at stride ldm), which the sweep's panel buffers (2 x 8 x
    ldm + 2 x 8 x 8) overlay and extend where they are larger. P A, md and
    J's pattern are read from device memory, and the fused kernel stages
    f, cdof and its tables over M^-1 before the sweep.
    The kernel carves it in this order (csrc/cg_fused.cu::carve_wide,
    wide_smem_floats)."""
    ldm, nefc4 = (nv + 3) & ~3, (nefc + 3) & ~3
    jf = nefc * (nv | 1) if j_floats is None else j_floats
    head = nv * ldm + ldm + (0 if l2 else jf) + 3 * nefc + 4 * nell + 1
    rest = max(3 * nefc4 + 12 * ldm, 2 * _WIDE_PANEL * ldm + 2 * _WIDE_PANEL ** 2)
    return 4 * (((head + 3) & ~3) + ldm * ldm + rest)


def kernel_layout(nv: int, nefc: int, nell: int = 0, nroots: int = 0,
                  ncon: int = 0) -> Tuple[int, int, int]:
    """The solve kernel's layout for one env, its shared memory per block
    and its warps per env: the one rule the wrappers and the solver's
    dispatch share.

    - Layout 1 on one warp where the whole env fits a block of which at
      least three share an SM (``kernel_smem_bytes`` <= ``WIDE_ABOVE_SMEM``,
      76,800 B): the minirat (11,224 B, 16 envs per SM), the ballmuscle.
    - Otherwise the wide core, ``WIDE_WARPS[layout]`` warps per env (8 in
      layout 1, 16 in layout 2; ``wide_smem_bytes``): layout 1 where the
      env fits a block (a rodent-size env: nv 73, one root, 70 slots; the
      one-rat stand-in ``assets/rat.xml``; at 590 rows nv 24 to 72), else
      layout 2 where qM, M^-1 and the vectors fit but J does not, which
      stays in device memory. Layout 2 reaches nv = 160 at the pair's 590
      rows (up to 804 rows) and nv = 164 up to 364 rows, past every env the
      one-warp layout 2 held (nv 159 at 590 rows, nv 163 up to 149).
      The rule decides on J held dense; the fused kernel's wide core holds
      it by its static sparsity (``j_pattern``), so its launch asks for
      ``wide_smem_bytes`` at the pattern's stored values: in layout 1 the
      terrain's block is 77,360 B in place of 165,248, and in layout 2 J's
      values take a (B, nnz) float32 scratch (36.2 MB at rodent_pair's 590
      rows and 1024 envs, where a dense J takes 352.8 MB; 705.7 MB at
      2048, as the dense kernel's still does).
    - Above that it raises ``NotImplementedError`` (ROADMAP.md §A.10: a
      layout over a thread-block cluster).
    """
    one = kernel_smem_bytes(nv, nefc, nell, nroots, ncon)
    if one <= min(H100_SMEM_PER_BLOCK, WIDE_ABOVE_SMEM):
        return 1, one, 1
    wide1 = wide_smem_bytes(nv, nefc, nell)
    if wide1 <= H100_SMEM_PER_BLOCK:
        return 1, wide1, WIDE_WARPS[1]
    wide2 = wide_smem_bytes(nv, nefc, nell, l2=True)
    if wide2 <= H100_SMEM_PER_BLOCK:
        return 2, wide2, WIDE_WARPS[2]
    M.unported(
        f"the solve kernel for an env of nv={nv}, nefc={nefc}: {wide2} B of shared memory "
        f"per block without J (one block holds {H100_SMEM_PER_BLOCK} B), a cluster layout",
        "§A.10",
    )


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


def _bm(P: torch.Tensor, A: torch.Tensor, nroots: int, ncon: int) -> torch.Tensor:
    """Low-rank J factor: Bm[b, root*6 + c, r] = sum_k P[r, k] A[b, root, k, c]."""
    B = A.shape[0]
    Ar = A.reshape(B, nroots, ncon * 3, 6)
    return torch.einsum("rk,bnkc->bncr", P, Ar).reshape(B, nroots * 6, P.shape[0])


def _int_tables(row_slot, sz, root_bounds, limit_dadr, nv, device):
    """Static int tables as device tensors, uploaded once per (tables,
    device)."""
    key = (row_slot, sz, root_bounds, limit_dadr, str(device))
    t = _TABLES.get(key)
    if t is None:
        root_of_dof = np.zeros(nv, np.int32)
        for n, (lo, hi) in enumerate(root_bounds):
            root_of_dof[lo:hi] = n
        as_i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32).reshape(-1), device=device)
        t = (as_i32(row_slot), as_i32(sz), as_i32(root_of_dof), as_i32(limit_dadr))
        _TABLES[key] = t
    return t


def _ell_table(ell_mu, ell_scale, dtype, device) -> torch.Tensor:
    """The elliptic block's per-model friction as one (3, nell) tensor
    [mu; tangent scale 1; tangent scale 2], built once per (statics, dtype,
    device)."""
    key = ("ell", tuple(ell_mu), tuple(map(tuple, ell_scale)), dtype, str(device))
    t = _TABLES.get(key)
    if t is None:
        sc = np.asarray(ell_scale, np.float64).reshape(len(ell_mu), 2)
        t = torch.as_tensor(
            np.stack([np.asarray(ell_mu, np.float64).reshape(-1), sc[:, 0], sc[:, 1]]),
            dtype=dtype, device=device,
        )
        _TABLES[key] = t
    return t


_TABLES: dict = {}


def j_pattern(md, row_slot, limit_dadr, nv: int) -> dict:
    """J's static sparsity, as the wide core holds J (csrc/jsparse.cuh): a
    contact row of slot s is nonzero only at the support dofs of the slot's
    two bodies, md[s] != 0, and scalar limit row r (r < nlim) only at its
    dof limit_dadr[r]. Fixed with the model (``solver._fused_statics``):
    nnz is 4,819 of the terrain's 367 x 73 entries and 8,846 of the pair's
    590 x 146.

    Consecutive rows that share their columns (a slot's; a limit row alone)
    form a group whose values are entry-major: entry k of its row i at
    base + k nr + i. Returns per row {base + i, nr, col0, n} (``rec``), the
    groups' ascending columns (``cols``), per 16-column chunk and row the
    value index of the row's first entry in the chunk and its column mask
    there with its stride (``chw``, (nch, nefc, 2): index, mask | stride <<
    16), and the stored values' count (``nnz``)."""
    md = np.asarray(md)
    rs = np.asarray(row_slot, np.int64).reshape(-1)
    groups, r = [], 0
    while r < rs.size:
        e = r + 1
        if rs[r] < 0:
            groups.append((r, 1, [int(limit_dadr[r])] if r < len(limit_dadr) else []))
        else:
            while e < rs.size and rs[e] == rs[r]:
                e += 1
            groups.append((r, e - r, np.nonzero(md[rs[r]])[0]))
        r = e
    nch = (nv + 15) // 16
    rec = np.zeros((rs.size, 4), np.int32)
    chw = np.zeros((nch, rs.size, 2), np.int64)
    cols, base, col0 = [], 0, 0
    for r0, nr, gc in groups:
        gc = np.asarray(gc, np.int64)
        rec[r0 : r0 + nr] = [(base + i, nr, col0, gc.size) for i in range(nr)]
        for ch in range(nch):
            inch = gc[(gc >= 16 * ch) & (gc < 16 * ch + 16)] - 16 * ch
            if inch.size:
                chw[ch, r0 : r0 + nr, 0] = base + np.sum(gc < 16 * ch) * nr + np.arange(nr)
                chw[ch, r0 : r0 + nr, 1] = np.sum(1 << inch) | (nr << 16)
        cols.append(gc)
        base += nr * gc.size
        col0 += gc.size
    cols = np.concatenate(cols).astype(np.int32) if cols else np.zeros(0, np.int32)
    return dict(rec=rec, cols=cols, chw=chw.astype(np.int32), nnz=base)


def _j_tables(md, row_slot, limit_dadr, pattern=None):
    """``j_pattern``'s tables on md's device, uploaded once per support-mask
    tensor: keyed by md's storage and version (the entry holds md, so its
    address is not reused while the entry lives). ``pattern`` is md's
    pattern where the caller has it (the solver's statics); else md is read
    once."""
    key = ("j", md.data_ptr(), md._version, tuple(md.shape), str(md.device), row_slot,
           limit_dadr)
    hit = _TABLES.get(key)
    if hit is None:
        if pattern is None:
            pattern = j_pattern(md.detach().cpu().numpy(), row_slot, limit_dadr, md.shape[1])
        tables = [torch.as_tensor(pattern[k], device=md.device) for k in ("rec", "cols", "chw")]
        hit = (md, (*tables, pattern["nnz"]))
        _TABLES[key] = hit
    return hit[1]


def _check_kernel_tensors(name, float_tensors, bool_tensors):
    for k, t in float_tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel: {k} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {k} must be contiguous")
    for k, t in bool_tensors.items():
        if t.dtype != torch.bool or not t.is_contiguous():
            raise TypeError(f"{name} kernel: {k} must be a contiguous bool tensor")


def _outputs(B, nv, nefc, like):
    e = lambda *s: torch.empty(*s, dtype=like.dtype, device=like.device)
    return dict(qacc=e(B, nv), force=e(B, nefc), qfrc=e(B, nv), a0=e(B, nv),
                qvel_new=e(B, nv),
                done=torch.empty(B, dtype=torch.bool, device=like.device))


def _launch(f, cdof, Bm, jsign, D, aref, exists, exists_con, qfrc_smooth, qvel,
            damp, md, armature, ell, warmstart, tables, jtables, *, ell0, iters,
            ls_iters, tol, dt, has_damping, stall_tol):
    """``cg_solve_fused``'s kernel on prepared arguments (Bm = P A, the int
    tables, J's pattern (``_j_tables``), the (3, nell) friction table, the
    warmstart or None). A wide block asks for the shared memory of J's
    stored values; in layout 2 it allocates the (B, nnz) float32 scratch for
    them: 36.2 MB at rodent_pair's 590 rows and 1024 envs."""
    B, _, nv = f.shape
    nefc = D.shape[1]
    nlim = jsign.shape[1]
    nroots = Bm.shape[1] // 6
    ncon = md.shape[0]
    nell = exists_con.shape[1]
    fl = dict(f=f, cdof=cdof, Bm=Bm, jsign=jsign, D=D, aref=aref,
              qfrc_smooth=qfrc_smooth, qvel=qvel, damp=damp, md=md,
              armature=armature, ell=ell)
    if warmstart is not None:
        fl["warmstart"] = warmstart
    _check_kernel_tensors("cg_solve_fused", fl, dict(exists=exists, exists_con=exists_con))
    layout, smem, warps = kernel_layout(nv, nefc, nell, nroots, ncon)
    *jt, jnnz = jtables
    if warps > 1:
        smem = wide_smem_bytes(nv, nefc, nell, l2=layout == 2, j_floats=jnnz)
    row_slot, sz, root_of_dof, limit_dadr = tables
    outs = _outputs(B, nv, nefc, f)
    ptr = library.ptr
    ws = ptr(warmstart) if warmstart is not None else ctypes.c_void_p(None)
    # layout 2: each env's J values in device memory, held here until the
    # launch is queued
    jbuf = torch.empty(B, jnnz, dtype=f.dtype, device=f.device) if layout == 2 else None
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = library.lib().cg_fused_launch(
        *(ptr(t) for t in (f, cdof, Bm, jsign, D, aref, exists, exists_con,
                           qfrc_smooth, qvel, damp, md, armature, ell)),
        ws,
        *(ptr(t) for t in (row_slot, sz, root_of_dof, limit_dadr, *jt)),
        *(ptr(t) for t in outs.values()),
        ptr(jbuf) if jbuf is not None else ctypes.c_void_p(None),
        B, nv, nefc, nlim, nroots, ncon, nell, ell0, jnnz, smem, layout, warps, iters, ls_iters,
        int(has_damping), int(warmstart is not None),
        ctypes.c_float(tol), ctypes.c_float(dt), ctypes.c_float(stall_tol),
        nv if armature.dim() == 2 else 0,  # the armature's per-env stride
        ctypes.c_void_p(stream),
    )
    library.check("cg_solve_fused", err)
    debug_nans.check_kernel("cg_solve_fused", outs.values())
    return outs


def _launch_batched(qM, J, D, aref, exists, exists_con, qfrc_smooth, qvel,
                    damp, ell, warmstart, *, ell0, iters, ls_iters, tol, dt,
                    has_damping, stall_tol):
    """``cg_solve_batched``'s kernel on prepared arguments. The wide core
    holds the dense J dof-major, in shared memory in layout 1 and in a (B,
    nefc, nv) float32 scratch in layout 2, into which the kernel copies
    it."""
    B, nefc, nv = J.shape
    nell = exists_con.shape[1]
    fl = dict(qM=qM, J=J, D=D, aref=aref, qfrc_smooth=qfrc_smooth, qvel=qvel,
              damp=damp, ell=ell)
    if warmstart is not None:
        fl["warmstart"] = warmstart
    _check_kernel_tensors("cg_solve_batched", fl, dict(exists=exists, exists_con=exists_con))
    layout, smem, warps = kernel_layout(nv, nefc, nell)
    if warps > 1:  # J dof-major, nefc x nv
        smem = wide_smem_bytes(nv, nefc, nell, l2=layout == 2, j_floats=nefc * nv)
    outs = _outputs(B, nv, nefc, qM)
    ptr = library.ptr
    ws = ptr(warmstart) if warmstart is not None else ctypes.c_void_p(None)
    jbuf = torch.empty(B, nefc, nv, dtype=qM.dtype, device=qM.device) if layout == 2 else None
    stream = torch.cuda.current_stream(qM.device).cuda_stream
    err = library.lib().cg_batched_launch(
        *(ptr(t) for t in (qM, J, D, aref, exists, exists_con, qfrc_smooth,
                           qvel, damp, ell)),
        ws,
        *(ptr(t) for t in outs.values()),
        ptr(jbuf) if jbuf is not None else ctypes.c_void_p(None),
        B, nv, nefc, nell, ell0, smem, layout, warps, iters, ls_iters, int(has_damping),
        int(warmstart is not None),
        ctypes.c_float(tol), ctypes.c_float(dt), ctypes.c_float(stall_tol),
        ctypes.c_void_p(stream),
    )
    library.check("cg_solve_batched", err)
    debug_nans.check_kernel("cg_solve_batched", outs.values())
    return outs


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def assemble_qM_J(f, cdof, Bm, jsign, md, armature, *, row_slot, sz,
                  root_bounds, limit_dadr):
    """Dense qM (B, nv, nv) and J (B, nefc, nv) from the low-rank factors,
    exactly as the kernel assembles them (JAX ``_assemble_qM_J``).

    qM[i, j] = sum_c f[c, i] cdof[c, j] where j is an ancestor-or-self of i
    (i in [j, j + sz_j)), its transpose above the diagonal, plus armature
    ((nv,), or per env (B, nv)).
    Contact row r: J[r] = md[slot(r)] * sum_c Bm[root(v)*6 + c, r] cdof[c, v];
    scalar limit row i: jsign_i at its dof.
    """
    B, _, nv = f.shape
    nefc = Bm.shape[-1]
    i = np.arange(nv)[:, None]
    j = np.arange(nv)[None, :]
    sz = np.asarray(sz)
    m1 = torch.as_tensor((i >= j) & (i < j + sz[None, :]), device=f.device)
    m2 = torch.as_tensor((j > i) & (j < i + sz[:, None]), device=f.device)
    acc = torch.einsum("bci,bcj->bij", f, cdof)
    accT = torch.einsum("bci,bcj->bij", cdof, f)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    qM = torch.where(m1, acc, zero) + torch.where(m2, accT, zero) + torch.diag_embed(armature)

    nroots = len(root_bounds)
    G = cdof.new_zeros(B, nroots, 6, nv)
    for n, (lo, hi) in enumerate(root_bounds):
        G[:, n, :, lo:hi] = cdof[:, :, lo:hi]
    J = torch.einsum("bkr,bkv->brv", Bm, G.reshape(B, nroots * 6, nv))
    rs = np.asarray(row_slot)
    mdrow = md[torch.as_tensor(np.maximum(rs, 0), device=md.device)]
    mdrow = mdrow * torch.as_tensor(rs >= 0, dtype=md.dtype, device=md.device)[:, None]
    J = J * mdrow
    nlim = len(limit_dadr)
    if nlim:
        J[:, torch.arange(nlim), torch.as_tensor(np.asarray(limit_dadr, np.int64))] = jsign
    return qM, J


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def _cg_arrays(qM, J, D, aref, exists, qfrc_smooth, qvel, *, iters, ls_iters,
               tol, dt, damp, has_damping, exists_con=None, ell0=0, ell=None,
               warmstart=None, stall_tol=0.0):
    """Batched CG on plain tensors: the port of the TPU kernel's ``_cg_core``
    (the math of ``solver.py::_cg_arrays`` plus the warmstart select and the
    stall exit), with the qacc_smooth / Euler products and the per-env
    convergence flag.

    ``exists`` covers the quadratic rows only (False on the elliptic rows);
    the elliptic block is rows [ell0, ell0 + 3 nell) in [n, t1, t2] order per
    contact, ``ell`` its (3, nell) friction [mu; scale1; scale2] and
    ``exists_con`` (B, nell) its activation. ``warmstart`` (B, nv) starts
    each env from whichever of it and qacc_smooth has the lower cost;
    ``stall_tol`` > 0 adds the float32 stall exit to the line search's
    freeze and to the done flag.
    """
    B = qM.shape[0]
    nell = 0 if exists_con is None else exists_con.shape[1]
    qMinv = sweep_inverse_reference(qM)
    a0 = _mv(qMinv, qfrc_smooth)
    Jt = J.transpose(-1, -2)
    zero = torch.zeros((), dtype=qM.dtype, device=qM.device)
    if nell:
        mu, sc = ell[0], ell[1:].T  # (nell,), (nell, 2)
        parts = lambda v: v[..., ell0 : ell0 + 3 * nell].reshape(v.shape[:-1] + (nell, 3))
        d_e = parts(D)  # (B, nell, 3)
        dm = d_e[..., 0] / torch.clamp(1 + mu * mu, min=MINVAL)

    def cost_force(jar):
        active = (jar < 0) & exists
        f = torch.where(active, -D * jar, zero)
        cost = 0.5 * torch.sum(torch.where(active, D * jar**2, zero), -1)
        if nell:
            je = parts(jar)
            n = je[..., 0]
            u = je[..., 1:] * sc
            t = torch.sqrt(torch.clamp(torch.sum(u * u, -1), min=MINVAL * MINVAL))
            bottom = exists_con & (mu * n + t <= 0)
            middle = exists_con & ~bottom & (n < mu * t)
            nmt = n - mu * t
            cost = cost + torch.sum(torch.where(bottom, 0.5 * torch.sum(d_e * je**2, -1), zero), -1)
            cost = cost + torch.sum(torch.where(middle, 0.5 * dm * nmt * nmt, zero), -1)
            f_mid = torch.cat(
                [(-dm * nmt)[..., None], (dm * nmt * mu)[..., None] * (u / t[..., None]) * sc], -1
            )
            f_e = torch.where(bottom[..., None], -d_e * je, torch.where(middle[..., None], f_mid, zero))
            f = torch.cat([f[:, :ell0], f_e.reshape(B, 3 * nell), f[:, ell0 + 3 * nell :]], -1)
        return cost, f

    def eval_ctx(x, jar, mxa):
        cost, force = cost_force(jar)
        gauss = 0.5 * torch.sum((x - a0) * mxa, -1)
        grad = mxa - _mv(Jt, force)
        return force, cost + gauss, grad, _mv(qMinv, grad)

    x = a0
    jar = _mv(J, x) - aref
    mxa = torch.zeros_like(x)
    force, cost, grad, mgrad = eval_ctx(x, jar, mxa)
    if warmstart is not None:
        # mj_warmstart: start from whichever of {warmstart, qacc_smooth} has
        # the lower cost
        jar_w = _mv(J, warmstart) - aref
        mxa_w = _mv(qM, warmstart - a0)
        force_w, cost_w, grad_w, mgrad_w = eval_ctx(warmstart, jar_w, mxa_w)
        better = cost_w < cost
        pick = lambda w, o: torch.where(better.reshape((B,) + (1,) * (o.dim() - 1)), w, o)
        x, jar, mxa, force = pick(warmstart, x), pick(jar_w, jar), pick(mxa_w, mxa), pick(force_w, force)
        cost, grad, mgrad = pick(cost_w, cost), pick(grad_w, grad), pick(mgrad_w, mgrad)
    p = -mgrad
    done = torch.zeros(B, dtype=torch.bool, device=qM.device)
    pow2 = torch.as_tensor(2.0 ** np.arange(13), dtype=qM.dtype, device=qM.device)

    for _ in range(iters):
        jar_p = _mv(J, p)
        mp = _mv(qM, p)
        pmp = torch.sum(p * mp, -1)
        gauss_p = torch.sum(p * mxa, -1)
        if nell:
            jpe = parts(jar_p)[:, None]  # (B, 1, nell, 3)
            np_ = jpe[..., 0]
            up = jpe[..., 1:] * sc
            tpsqr = torch.sum(up * up, -1)
            d_eb, dmb, econ = d_e[:, None], dm[:, None], exists_con[:, None]

        def dphi(alpha):
            """alpha (B, A) -> (phi', phi'') each (B, A)."""
            jar_a = jar[:, None, :] + alpha[..., None] * jar_p[:, None, :]
            active = (jar_a < 0) & exists[:, None, :]
            dval = gauss_p[:, None] + alpha * pmp[:, None] + torch.sum(
                torch.where(active, (D * jar_p)[:, None, :] * jar_a, zero), -1
            )
            ddval = pmp[:, None] + torch.sum(
                torch.where(active, (D * jar_p**2)[:, None, :], zero), -1
            )
            if nell:
                jae = parts(jar_a)  # (B, A, nell, 3)
                n = jae[..., 0]
                u = jae[..., 1:] * sc
                t = torch.sqrt(torch.clamp(torch.sum(u * u, -1), min=MINVAL * MINVAL))
                bottom = econ & (mu * n + t <= 0)
                middle = econ & ~bottom & (n < mu * t)
                nmt = n - mu * t
                tprime = torch.sum(u * up, -1) / t
                tdprime = torch.clamp(tpsqr - tprime * tprime, min=0.0) / t
                g = np_ - mu * tprime
                dval = dval + torch.sum(torch.where(middle, dmb * nmt * g, zero), -1)
                ddval = ddval + torch.sum(
                    torch.where(middle, dmb * (g * g - nmt * mu * tdprime), zero), -1
                )
                dval = dval + torch.sum(torch.where(bottom, torch.sum(d_eb * jae * jpe, -1), zero), -1)
                ddval = ddval + torch.sum(torch.where(bottom, torch.sum(d_eb * jpe**2, -1), zero), -1)
            return dval, ddval

        d0, dd0 = dphi(torch.zeros(B, 1, dtype=qM.dtype, device=qM.device))
        guess = torch.clamp(-d0[:, 0] / torch.clamp(dd0[:, 0], min=MINVAL), min=MINVAL)
        cand = guess[:, None] * pow2
        dcand, _ = dphi(cand)
        pos = dcand >= 0
        hi = torch.min(torch.where(pos, cand, cand[:, -1:]), -1).values
        lo = torch.max(torch.where(~pos & (cand < hi[:, None]), cand, zero), -1).values
        alpha = torch.minimum(guess, hi)
        if stall_tol:
            # float32 stall floor: |phi'| at rounding noise of its start value
            d0_scale = torch.abs(d0[:, 0]) * stall_tol

        for _ in range(ls_iters):
            dv, ddv = dphi(alpha[:, None])
            dv, ddv = dv[:, 0], ddv[:, 0]
            # freeze once converged: at dv ~ 0 the Newton step underflows
            # and the safeguard would bisect away from the optimum
            conv = torch.abs(dv) < tol
            if stall_tol:
                conv = conv | (torch.abs(dv) < d0_scale)
            lo2 = torch.where(dv < 0, alpha, lo)
            hi2 = torch.where(dv >= 0, alpha, hi)
            newton = alpha - dv / torch.clamp(ddv, min=MINVAL)
            inside = (newton > lo2) & (newton < hi2)
            alpha2 = torch.where(inside, newton, 0.5 * (lo2 + hi2))
            alpha = torch.where(conv, alpha, alpha2)
            lo = torch.where(conv, lo, lo2)
            hi = torch.where(conv, hi, hi2)

        x_new = x + alpha[:, None] * p
        jar_new = jar + alpha[:, None] * jar_p
        mxa_new = mxa + alpha[:, None] * mp
        force_new, cost_new, grad_new, mgrad_new = eval_ctx(x_new, jar_new, mxa_new)
        improvement = cost - cost_new
        gradient = torch.linalg.norm(grad_new, dim=-1)
        beta = torch.sum(grad_new * (mgrad_new - mgrad), -1) / torch.clamp(
            torch.sum(grad * mgrad, -1), min=MINVAL
        )
        beta = torch.clamp(beta, min=0.0)
        p_new = -mgrad_new + beta[:, None] * p
        step_done = (improvement < tol) | (gradient < tol)
        if stall_tol:
            # float32 stall: the cost improvement is rounding noise
            step_done = step_done | (improvement < stall_tol * torch.abs(cost_new))
        # envs that converged before this iteration keep their state
        keep = lambda old, new: torch.where(
            done.reshape((B,) + (1,) * (old.dim() - 1)), old, new
        )
        x, jar, mxa, force = keep(x, x_new), keep(jar, jar_new), keep(mxa, mxa_new), keep(force, force_new)
        cost, grad, mgrad, p = keep(cost, cost_new), keep(grad, grad_new), keep(mgrad, mgrad_new), keep(p, p_new)
        done = done | step_done

    qfrc_constraint = _mv(Jt, force)
    qfrc_total = qfrc_smooth + qfrc_constraint
    if has_damping:
        mhinv = sweep_inverse_reference(qM + torch.diag(damp))
        qvel_next = qvel + dt * _mv(mhinv, qfrc_total)
    else:
        qvel_next = qvel + dt * x
    return x, force, qfrc_constraint, a0, qvel_next, done


def cg_solve_fused_reference(
    f, cdof, A, jsign, D, aref, exists, exists_con, qfrc_smooth, qvel, damp,
    P, md, armature, *, iters, ls_iters, tol, dt, has_damping, row_slot, sz,
    root_bounds, limit_dadr, ell0=0, ell_mu=(), ell_scale=(), warmstart=None,
    stall_tol=0.0,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the fused kernel, on any device: dense
    assembly of qM and J, then ``_cg_arrays``. Same arguments and outputs
    as ``cg_solve_fused``."""
    ncon = md.shape[0]
    Bm = _bm(P, A, len(root_bounds), ncon)
    qM, J = assemble_qM_J(
        f, cdof, Bm, jsign, md, armature, row_slot=row_slot, sz=sz,
        root_bounds=root_bounds, limit_dadr=limit_dadr,
    )
    return cg_solve_batched_reference(
        qM, J, D, aref, exists, exists_con, qfrc_smooth, qvel, damp,
        iters=iters, ls_iters=ls_iters, tol=tol, dt=dt, has_damping=has_damping,
        ell0=ell0, ell_mu=ell_mu, ell_scale=ell_scale, warmstart=warmstart,
        stall_tol=stall_tol,
    )


def cg_solve_batched_reference(
    qM, J, D, aref, exists, exists_con, qfrc_smooth, qvel, damp, *, iters,
    ls_iters, tol, dt, has_damping, ell0=0, ell_mu=(), ell_scale=(),
    warmstart=None, stall_tol=0.0,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the dense-input kernel, on any device. Same
    arguments and outputs as ``cg_solve_batched``."""
    ell = _ell_table(ell_mu, ell_scale, qM.dtype, qM.device) if len(ell_mu) else None
    return _cg_arrays(
        qM, J, D, aref, exists, qfrc_smooth, qvel, iters=iters,
        ls_iters=ls_iters, tol=tol, dt=dt, damp=damp, has_damping=has_damping,
        exists_con=exists_con if len(ell_mu) else None, ell0=ell0, ell=ell,
        warmstart=warmstart, stall_tol=stall_tol,
    )


def _check_statics(name, B, nv, nefc, exists_con, ell0, ell_mu, ell_scale,
                   warmstart, stall_tol):
    """The elliptic block, warmstart and stall arguments the core takes."""
    nell = len(ell_mu)
    if tuple(exists_con.shape) != (B, nell):
        raise ValueError(
            f"{name}: exists_con has shape {tuple(exists_con.shape)}, expected "
            f"{(B, nell)} (one column per elliptic contact of ell_mu)"
        )
    if nell:
        if np.asarray(ell_scale, np.float64).shape != (nell, 2):
            raise ValueError(f"{name}: ell_scale must hold (scale1, scale2) per elliptic contact")
        if not 0 <= ell0 <= nefc - 3 * nell:
            raise ValueError(f"{name}: the elliptic block [{ell0}, {ell0} + 3 x {nell}) "
                             f"does not fit {nefc} rows")
    if warmstart is not None and tuple(warmstart.shape) != (B, nv):
        raise ValueError(f"{name}: warmstart has shape {tuple(warmstart.shape)}, expected {(B, nv)}")
    if not 0.0 <= stall_tol < 1.0:
        raise ValueError(f"{name}: stall_tol must lie in [0, 1), got {stall_tol}")


def cg_solve_fused(
    f: torch.Tensor,  # (B, 6, nv) composite-inertia factor (crb_f)
    cdof: torch.Tensor,  # (B, 6, nv)
    A: torch.Tensor,  # (B, nroots, ncon, 3, 6) contact point operators
    jsign: torch.Tensor,  # (B, nlim) scalar limit signs
    D: torch.Tensor,  # (B, nefc)
    aref: torch.Tensor,  # (B, nefc)
    exists: torch.Tensor,  # (B, nefc) bool: quadratic row instantiated
    exists_con: torch.Tensor,  # (B, nell) bool: elliptic contact active
    qfrc_smooth: torch.Tensor,  # (B, nv)
    qvel: torch.Tensor,  # (B, nv)
    damp: torch.Tensor,  # (nv,) h * dof_damping
    P: torch.Tensor,  # (nefc, ncon*3) static row-combination coefficients
    md: torch.Tensor,  # (ncon, nv) static +-1/0 contact support masks
    armature: torch.Tensor,  # (nv,), or per env (B, nv)
    *,
    iters: int,
    ls_iters: int,
    tol: float,
    dt: float,
    has_damping: bool,
    row_slot: tuple,  # (nefc,) contact slot per row, -1 for limit rows
    sz: tuple,  # (nv,) dof subtree sizes (DFS-contiguous)
    root_bounds: tuple,  # ((lo, hi), ...) contiguous dof range per root
    limit_dadr: tuple,  # (nlim,) dof address of each scalar limit row
    ell0: int = 0,  # first row of the elliptic block
    ell_mu: tuple = (),  # (nell,) friction coefficient per elliptic contact
    ell_scale: tuple = (),  # (nell, 2) tangent scales friction[0:2] / mu
    warmstart: torch.Tensor = None,  # (B, nv) qacc warmstart, or None
    stall_tol: float = 0.0,  # float32 stall exit (0 disables)
    device="cuda",
):
    """The solve kernel with in-kernel qM/J assembly (see the module
    docstring). Returns (qacc, efc_force, qfrc_constraint, qacc_smooth,
    qvel_new, done).

    ``exists`` is False on the elliptic rows, whose activation is
    ``exists_con``; the elliptic block is rows [ell0, ell0 + 3 nell) in
    [n, t1, t2] order per contact. Tensors on the CPU run the plain
    version; tensors on the card launch the CUDA kernel (float32 only) or
    raise.
    """
    dev = resolve_device(device)
    B, _, nv = f.shape
    nefc = D.shape[1]
    ncon = md.shape[0]
    nroots = len(root_bounds)
    shapes = dict(
        f=(f, (B, 6, nv)), cdof=(cdof, (B, 6, nv)), A=(A, (B, nroots, ncon, 3, 6)),
        jsign=(jsign, (B, len(limit_dadr))), D=(D, (B, nefc)), aref=(aref, (B, nefc)),
        exists=(exists, (B, nefc)), qfrc_smooth=(qfrc_smooth, (B, nv)),
        qvel=(qvel, (B, nv)), damp=(damp, (nv,)), P=(P, (nefc, ncon * 3)),
        md=(md, (ncon, nv)),
        armature=(armature, (B, nv) if armature.dim() == 2 else (nv,)),
    )
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"cg_solve_fused: {name} has shape {tuple(t.shape)}, expected {shape}")
    _check_statics("cg_solve_fused", B, nv, nefc, exists_con, ell0, ell_mu, ell_scale,
                   warmstart, stall_tol)
    extra = dict(exists_con=exists_con) | ({} if warmstart is None else dict(warmstart=warmstart))
    check_device(dev, **{k: t for k, (t, _) in shapes.items()}, **extra)
    statics = dict(iters=iters, ls_iters=ls_iters, tol=tol, dt=dt,
                   has_damping=has_damping, stall_tol=stall_tol)
    if dev.type == "cpu":
        return cg_solve_fused_reference(
            f, cdof, A, jsign, D, aref, exists, exists_con, qfrc_smooth, qvel,
            damp, P, md, armature, row_slot=row_slot, sz=sz,
            root_bounds=root_bounds, limit_dadr=limit_dadr, ell0=ell0,
            ell_mu=ell_mu, ell_scale=ell_scale, warmstart=warmstart, **statics,
        )
    tables = _int_tables(row_slot, sz, root_bounds, limit_dadr, nv, dev)
    outs = _launch(
        f, cdof, _bm(P, A, nroots, ncon).contiguous(), jsign, D, aref, exists,
        exists_con, qfrc_smooth, qvel, damp, md, armature,
        _ell_table(ell_mu, ell_scale, f.dtype, dev), warmstart, tables,
        _j_tables(md, row_slot, limit_dadr), ell0=ell0, **statics,
    )
    cg_solve_fused.launches += 1
    return tuple(outs.values())


def cg_solve_batched(
    qM: torch.Tensor,  # (B, nv, nv)
    J: torch.Tensor,  # (B, nefc, nv) dense constraint jacobian
    D: torch.Tensor,  # (B, nefc)
    aref: torch.Tensor,  # (B, nefc)
    exists: torch.Tensor,  # (B, nefc) bool: quadratic row instantiated
    exists_con: torch.Tensor,  # (B, nell) bool: elliptic contact active
    qfrc_smooth: torch.Tensor,  # (B, nv)
    qvel: torch.Tensor,  # (B, nv)
    damp: torch.Tensor,  # (nv,) h * dof_damping
    *,
    iters: int,
    ls_iters: int,
    tol: float,
    dt: float,
    has_damping: bool,
    ell0: int = 0,
    ell_mu: tuple = (),
    ell_scale: tuple = (),
    warmstart: torch.Tensor = None,
    stall_tol: float = 0.0,
    device="cuda",
):
    """The solve kernel on a dense qM and J (the TPU kernel
    ``cg_solve_batched``): ``cg_solve_fused``'s core and outputs, with the
    elliptic block, warmstart and stall exit as there."""
    dev = resolve_device(device)
    B, nefc, nv = J.shape
    shapes = dict(
        qM=(qM, (B, nv, nv)), J=(J, (B, nefc, nv)), D=(D, (B, nefc)),
        aref=(aref, (B, nefc)), exists=(exists, (B, nefc)),
        qfrc_smooth=(qfrc_smooth, (B, nv)), qvel=(qvel, (B, nv)), damp=(damp, (nv,)),
    )
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"cg_solve_batched: {name} has shape {tuple(t.shape)}, expected {shape}")
    _check_statics("cg_solve_batched", B, nv, nefc, exists_con, ell0, ell_mu, ell_scale,
                   warmstart, stall_tol)
    extra = dict(exists_con=exists_con) | ({} if warmstart is None else dict(warmstart=warmstart))
    check_device(dev, **{k: t for k, (t, _) in shapes.items()}, **extra)
    statics = dict(iters=iters, ls_iters=ls_iters, tol=tol, dt=dt,
                   has_damping=has_damping, stall_tol=stall_tol)
    if dev.type == "cpu":
        return cg_solve_batched_reference(
            qM, J, D, aref, exists, exists_con, qfrc_smooth, qvel, damp,
            ell0=ell0, ell_mu=ell_mu, ell_scale=ell_scale, warmstart=warmstart,
            **statics,
        )
    outs = _launch_batched(
        qM, J, D, aref, exists, exists_con, qfrc_smooth, qvel, damp,
        _ell_table(ell_mu, ell_scale, qM.dtype, dev), warmstart, ell0=ell0, **statics,
    )
    cg_solve_batched.launches += 1
    return tuple(outs.values())


# kernel launches since each count was last set to 0
cg_solve_fused.launches = 0
cg_solve_batched.launches = 0
