"""Constraint solve: MuJoCo CG on the primal (acceleration) problem, on
the solve kernel's layout (one-sided quadratic rows built from limits and
contacts: the rodent's and the pair's), through ``_solve_quad``, which
calls ``ops/cg.py``'s ``cg_solve_fused`` (here its plain version) once.
The frozen copy keeps only this path: Newton, PGS and CG off that layout
raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.ref.ops import cg as ops_cg
from portbench.ref.physics import constraint as Cn
from portbench.ref.physics import model as M


def solve(m: M.Model, d: M.Data) -> M.Data:
    """Constraint solve for qacc; writes qacc, qfrc_constraint and
    efc_force, and on the kernel path qacc_smooth and the Euler velocity
    update qvel_next, on the Newton path the iteration counts."""
    layout = Cn.efc_layout(m)
    if layout.nefc == 0 or m.nv == 0:
        B = d.qpos.shape[0]
        return d.replace(
            qacc=d.qacc_smooth, qfrc_constraint=torch.zeros_like(d.qvel),
            efc_force=d.qpos.new_zeros(B, 0),
        )
    if m.opt.solver != M.SOLVER_CG or not quad_kernel_eligible(m):
        raise NotImplementedError("the frozen copy solves CG on the kernel layout only")
    return _solve_quad(m, d, layout)


class _ConeMeta(NamedTuple):
    """Static row metadata for evaluating the constraint cost."""

    quad_rows: np.ndarray  # rows with a one-sided quadratic cost
    ell_con: np.ndarray  # elliptic contact slot ids
    ell_rows: np.ndarray  # (nell, maxdim) row indices (normal first), -1 pad
    ell_dim: np.ndarray  # (nell,)


def _cone_meta(m: M.Model, layout: Cn.EfcLayout) -> _ConeMeta:
    """Which rows are one-sided quadratics and which form elliptic cones
    (the JAX package's ``_cone_meta``), built once per model."""
    meta = m.cache.get("cone_meta")
    if meta is not None:
        return meta
    elliptic = m.opt.cone == M.CONE_ELLIPTIC
    quad_rows = []
    ell_con, ell_rows, ell_dim = [], [], []
    for r in range(layout.nefc):
        t = layout.row_type[r]
        if t in (Cn.ROW_LIMIT, Cn.ROW_CON_PYRAMID) or (
            t == Cn.ROW_CON_NORMAL and (not elliptic or layout.con_dim[layout.row_con[r]] == 1)
        ):
            quad_rows.append(r)
    if elliptic:
        for slot in range(m.ncon):
            dim = int(layout.con_dim[slot])
            if dim > 1:
                ell_con.append(slot)
                ell_rows.append([int(layout.con_rows[slot]) + k for k in range(dim)])
                ell_dim.append(dim)
    maxdim = max(ell_dim, default=1)
    ell_rows = np.array(
        [r + [-1] * (maxdim - len(r)) for r in ell_rows], np.int32
    ).reshape(len(ell_con), maxdim)
    meta = _ConeMeta(
        np.array(quad_rows, np.int32),
        np.array(ell_con, np.int32),
        ell_rows,
        np.array(ell_dim, np.int32),
    )
    m.cache["cone_meta"] = meta
    return meta


def static_leaves(m: M.Model) -> dict:
    """The parameter leaves the model's solve path reads as per-model
    constants (Python floats or numpy tables built once), each with what
    reads it: a per-env value of one raises (``model.env_model``). They are
    the leaves for which the JAX package's ``DomainRandomizationVmapWrapper``
    raises on the same path (its kernel path reads them into numpy, and its
    ball-limit rows read ``jnt_range`` so), found by batching each leaf in
    turn on the minirat, the rodent stand-in, the ballmuscle and the
    ball-coxa fly stand-in (on the damped XLA-CG path the JAX wrapper does
    not raise for damping and timestep but steps every env with env 0's
    damped inverse)."""
    if quad_kernel_eligible(m):
        return {
            "opt.timestep": "the solve kernel's Euler tail (dt)",
            "opt.tolerance": "the solve kernel's stopping tolerance",
            "opt.meaninertia": "the solve kernel's stopping tolerance",
            "dof_damping": "the solve kernel's damped Euler tail",
            "pairs.friction": "the solve kernel's row combinations P and elliptic table",
        }
    static = {}
    if Cn.efc_layout(m).limit_ball_jnt.size:
        static["jnt_range"] = "the ball-limit rows' largest angle"
    if m.opt.solver == M.SOLVER_CG and m.has_damping:
        # the JAX package's batched spd_inverse2 takes env 0's damping for
        # every env (its ops/cholesky.py::_spd_inverse2_vmap)
        damped = "the damped inverse (M + h diag(damping))^-1 of the array CG path"
        static.update({"opt.timestep": damped, "dof_damping": damped})
    return static


def quad_kernel_eligible(m: M.Model) -> bool:
    """The JAX package's rule for its solve-kernel path (CG or Newton): one-
    sided quadratic rows plus at most one contiguous block of dim-3
    elliptic contacts, no ball-joint limits, condim <= 3, at most 128
    iterations, DFS-contiguous dof subtrees, and the TPU kernel's VMEM
    budget. Models that fail it take the array paths; models that pass it
    skip the dense qM. Whether the env also fits the H100 kernel's shared
    memory is checked where the kernel is called (``_solve_quad``)."""
    if "kernel_path" not in m.cache:
        m.cache["kernel_path"] = _quad_kernel_eligible(m)
    return m.cache["kernel_path"]


def _quad_kernel_eligible(m: M.Model) -> bool:
    if m.nv == 0 or m.opt.solver not in (M.SOLVER_CG, M.SOLVER_NEWTON):
        return False
    layout = Cn.efc_layout(m)
    if layout.nefc == 0 or max(int(m.opt.iterations), 1) > 128:
        return False
    meta = _cone_meta(m, layout)
    if meta.ell_con.size:
        # one contiguous block of uniform dim-3 elliptic contacts
        er = meta.ell_rows
        if set(meta.ell_dim.tolist()) != {3}:
            return False
        if not np.array_equal(np.sort(er.ravel()), np.arange(er.min(), er.max() + 1)):
            return False
        if not np.array_equal(er[:, 0], er.min() + 3 * np.arange(er.shape[0])):
            return False
    elif meta.quad_rows.size != layout.nefc:
        return False
    if layout.limit_ball_jnt.size:
        return False
    if m.ncon and int(np.max(layout.con_dim)) > 3:
        return False
    if _fused_statics(m, layout) is None:
        return False
    rp = (layout.nefc + 7) // 8 * 8
    vp = (m.nv + 7) // 8 * 8
    return (rp * vp + 3 * vp * vp) * 128 * 4 + int(12e6) < int(100e6)


def _fused_statics(m: M.Model, layout: Cn.EfcLayout):
    """Static tables for in-kernel qM/J assembly, or None when the model
    breaks the layout the kernel relies on (DFS-contiguous dof subtrees and
    root dof ranges; MuJoCo's compiler always produces them)."""
    if "fused_statics" in m.cache:
        return m.cache["fused_statics"]
    mask = np.asarray(m.dof_ancestor_mask)  # [i, j] = j anc-or-self of i
    nv = m.nv
    sz = mask.sum(axis=0).astype(int)  # subtree size per dof j
    out = None
    ok = True
    for j in range(nv):
        expect = np.zeros(nv, bool)
        expect[j : j + sz[j]] = True
        ok = ok and np.array_equal(mask[:, j], expect)
    dof_root = np.asarray(m.body_rootid)[np.asarray(m.dof_bodyid)]
    bounds = []
    for r in np.unique(dof_root):
        idx = np.nonzero(dof_root == r)[0]
        if not np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
            ok = False
        bounds.append((int(idx[0]), int(idx[-1] + 1)))
    if ok:
        # static row-combination coefficients: J_con = (P @ A) @ cdof * md
        ncon = m.ncon
        P = np.zeros((layout.nefc, ncon * 3))
        friction = m.pairs.friction.cpu().numpy().astype(np.float64)
        for r in range(layout.nefc):
            slot = int(layout.row_con[r])
            if slot < 0:
                continue
            k = int(layout.row_fdim[r])
            pf = friction[int(layout.con_pair[slot])]
            if int(layout.row_type[r]) == Cn.ROW_CON_PYRAMID:
                i_pyr = k // 2
                P[r, slot * 3] = 1.0
                P[r, slot * 3 + i_pyr + 1] = (1.0 - 2.0 * (k % 2)) * pf[i_pyr]
            else:  # frictionless normal row: direct selection
                P[r, slot * 3 + k] = 1.0
        b1 = np.asarray(m.geom_bodyid)[layout.con_geom1]
        b2 = np.asarray(m.geom_bodyid)[layout.con_geom2]
        bdm = np.asarray(m.body_dof_mask, np.float64)
        md = bdm[b2] - bdm[b1] if ncon else np.zeros((0, nv))
        row_slot = tuple(int(s) for s in layout.row_con)
        limit_dadr = tuple(int(a) for a in Cn.limit_dofs(m))
        out = dict(
            P=P,
            md=md,
            row_slot=row_slot,
            sz=tuple(int(s) for s in sz),
            root_bounds=tuple(bounds),
            limit_dadr=limit_dadr,
        )
    m.cache["fused_statics"] = out
    return out


def _solve_statics(m: M.Model, layout: Cn.EfcLayout) -> dict:
    """Per-model solve constants (device tensors and python scalars), built
    once: the hot path then reads nothing back from the device. The
    elliptic block's statics come from the pairs' friction: mu = friction[0]
    and the tangent scales friction[0:2] / mu per elliptic slot."""
    st = m.cache.get("solve_statics")
    if st is None:
        fstat = _fused_statics(m, layout)
        meta = _cone_meta(m, layout)
        dt = float(m.opt.timestep)
        nell = int(meta.ell_con.size)
        if nell:
            cp = layout.con_pair[meta.ell_con]
            fr = m.pairs.friction.cpu().numpy().astype(np.float64)[cp, 0:2]
            ell = dict(
                ell0=int(meta.ell_rows.min()),
                ell_mu=tuple(fr[:, 0].tolist()),
                ell_scale=tuple(map(tuple, (fr / fr[:, :1]).tolist())),
            )
            quad_mask = np.zeros(layout.nefc, bool)
            quad_mask[meta.quad_rows] = True
        else:
            ell = dict(ell0=layout.nefc, ell_mu=(), ell_scale=())
        st = dict(
            P=m.const(fstat["P"]),
            md=m.const(fstat["md"]),
            damp=m.const(m.dof_damping.cpu().numpy().astype(np.float64) * dt),
            # rows the kernel's quadratic cost covers (None: all of them)
            quad_mask=m.const(quad_mask, torch.bool) if nell else None,
            ell_con=m.idx(meta.ell_con),
            ell_margin=m.pairs.margin[m.idx(layout.con_pair[meta.ell_con])],
            kw=dict(
                iters=max(int(m.opt.iterations), 1),
                ls_iters=max(int(m.opt.ls_iterations), 1),
                tol=float(m.opt.tolerance) * float(m.opt.meaninertia) * max(1, m.nv),
                dt=dt,
                has_damping=bool(m.has_damping),
                row_slot=fstat["row_slot"],
                sz=fstat["sz"],
                root_bounds=fstat["root_bounds"],
                limit_dadr=fstat["limit_dadr"],
                **ell,
            ),
        )
        m.cache["solve_statics"] = st
    return st


def _kernel_args(m: M.Model, d: M.Data, layout: Cn.EfcLayout):
    """The solve kernel's positional arguments at the state ``d`` and its
    static keywords."""
    st = _solve_statics(m, layout)
    nell = len(st["kw"]["ell_mu"])
    B = d.qpos.shape[0]
    exists = d.efc_pos < d.efc_margin
    if st["quad_mask"] is not None:
        exists = exists & st["quad_mask"]  # elliptic rows: exists_con
    if nell:
        exists_con = d.contact_dist[:, st["ell_con"]] < st["ell_margin"]
    else:
        exists_con = torch.zeros(B, 0, dtype=torch.bool, device=m.device)
    con_A = d.con_A
    if con_A is None:  # no contact slots
        nroots = len(st["kw"]["root_bounds"])
        con_A = d.qpos.new_zeros(B, nroots, 0, 3, 6)
    args = (
        d.crb_f, d.cdof, con_A, d.efc_jsign, d.efc_D, d.efc_aref, exists,
        exists_con, d.qfrc_smooth, d.qvel, st["damp"], st["P"], st["md"],
        m.dof_armature,
    )
    return args, st["kw"]


def _solve_quad(m: M.Model, d: M.Data, layout: Cn.EfcLayout) -> M.Data:
    """CG on the kernel layout: one solve-kernel launch, which also produces
    qacc_smooth and the Euler velocity update (qvel_next)."""
    args, kw = _kernel_args(m, d, layout)
    x, force, qfrc, a0, qvel_next, _ = ops_cg.cg_solve_fused(*args, device=m.device, **kw)
    return d.replace(
        qacc=x, qfrc_constraint=qfrc, efc_force=force, qacc_smooth=a0,
        qvel_next=qvel_next,
    )


# float32 stall floor of the chunked Newton dispatch: a relative cost
# improvement below ~32 eps_f32 is rounding noise (the JAX package's
# _STALL_TOL_F32)
STALL_TOL_F32 = 4e-6


# ---------------------------------------------------------------------------
# The array paths (models off the kernel layout)
# ---------------------------------------------------------------------------


