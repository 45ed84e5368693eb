"""Constraint solve: MuJoCo CG on the primal (acceleration) problem.

Counterpart of ``brax_tracking_tpu/physics/solver.py`` for the path the
minirat (and the rodent) takes: CG models whose rows are all one-sided
quadratics go through ``_solve_quad``, which calls the solve kernel
(ops/cg.py ``cg_solve_fused``). On a CUDA model that is the hand-written
kernel; on a CPU model the wrapper runs its plain version. There is no
other switch. Newton, PGS, elliptic cones and models outside the kernel's
layout raise.
"""

from __future__ import annotations

import numpy as np
import torch

from brax_tracking_tpu_torch.ops import cg as ops_cg
from brax_tracking_tpu_torch.physics import constraint as Cn
from brax_tracking_tpu_torch.physics import model as M


def solve(m: M.Model, d: M.Data) -> M.Data:
    """Constraint solve for qacc; writes qacc, qfrc_constraint, efc_force,
    qacc_smooth and the Euler velocity update qvel_next."""
    if m.opt.solver == M.SOLVER_NEWTON:
        M.unported("the Newton solver", "§A.6")
    if m.opt.solver != M.SOLVER_CG:
        raise NotImplementedError(
            f"solver {m.opt.solver} (PGS?) is not implemented; use cg"
        )
    if not quad_kernel_eligible(m):
        M.unported("CG for models outside the solve kernel's layout", "§A.5")
    return _solve_quad(m, d, Cn.efc_layout(m))


def quad_kernel_eligible(m: M.Model) -> bool:
    """True when the model fits the solve kernel: CG or Newton, one-sided
    quadratic rows only (scalar limits, pyramidal or frictionless
    contacts), at most 128 iterations, DFS-contiguous dof subtrees and, the
    Hopper rule, one env's qM, M^-1 and J in one block's shared memory
    (``ops_cg.kernel_smem_bytes`` <= 227 KB)."""
    if m.nv == 0 or m.opt.solver not in (M.SOLVER_CG, M.SOLVER_NEWTON):
        return False
    layout = Cn.efc_layout(m)
    if layout.nefc == 0 or max(int(m.opt.iterations), 1) > 128:
        return False
    if m.opt.cone == M.CONE_ELLIPTIC and m.ncon and np.any(layout.con_dim > 1):
        return False
    if layout.limit_ball_jnt.size:
        return False
    if m.ncon and int(np.max(layout.con_dim)) > 3:
        return False
    if _fused_statics(m, layout) is None:
        return False
    return ops_cg.kernel_smem_bytes(m.nv, layout.nefc) <= ops_cg.H100_SMEM_PER_BLOCK


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
        out = dict(
            P=P,
            md=bdm[b2] - bdm[b1] if ncon else np.zeros((0, nv)),
            row_slot=tuple(int(s) for s in layout.row_con),
            sz=tuple(int(s) for s in sz),
            root_bounds=tuple(bounds),
            limit_dadr=tuple(int(a) for a in Cn.limit_dofs(m)),
        )
    m.cache["fused_statics"] = out
    return out


def _solve_statics(m: M.Model, layout: Cn.EfcLayout) -> dict:
    """Per-model solve constants (device tensors and python scalars), built
    once: the hot path then reads nothing back from the device."""
    st = m.cache.get("solve_statics")
    if st is None:
        fstat = _fused_statics(m, layout)
        dt = float(m.opt.timestep)
        st = dict(
            P=m.const(fstat["P"]),
            md=m.const(fstat["md"]),
            damp=m.const(m.dof_damping.cpu().numpy().astype(np.float64) * dt),
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
            ),
        )
        m.cache["solve_statics"] = st
    return st


def _solve_quad(m: M.Model, d: M.Data, layout: Cn.EfcLayout) -> M.Data:
    """Purely one-sided-quadratic costs: the solve kernel also produces
    qacc_smooth and the Euler velocity update (qvel_next)."""
    st = _solve_statics(m, layout)
    B = d.qpos.shape[0]
    exists = d.efc_pos < d.efc_margin
    con_A = d.con_A
    if con_A is None:  # no contact slots
        nroots = len(st["kw"]["root_bounds"])
        con_A = d.qpos.new_zeros(B, nroots, 0, 3, 6)
    x, force, qfrc, a0, qvel_next, _ = ops_cg.cg_solve_fused(
        d.crb_f, d.cdof, con_A, d.efc_jsign, d.efc_D, d.efc_aref, exists,
        torch.zeros(B, 0, dtype=torch.bool, device=m.device),
        d.qfrc_smooth, d.qvel, st["damp"], st["P"], st["md"], m.dof_armature,
        device=m.device, **st["kw"],
    )
    return d.replace(
        qacc=x, qfrc_constraint=qfrc, efc_force=force, qacc_smooth=a0,
        qvel_next=qvel_next,
    )
