"""Composite rigid body factor (CRB), mass-matrix inverses and bias forces
(RNE), batch-first.

Counterpart of ``brax_tracking_tpu/physics/dynamics.py`` (mj_crb / mj_rne
semantics). ``crb`` produces the low-rank mass-matrix factor ``crb_f``:
qM[i, j] = cdof_j . f_i on the dof-ancestor pattern, symmetrized, plus
diag(armature). On the kernel path the dense qM is never materialized:
the solve kernel assembles it from (crb_f, cdof), as the JAX kernel does
(ops/cg.py ``assemble_qM_J`` is the plain version of that assembly). The
solve paths off that layout (XLA-CG and Newton) read the dense qM, and
XLA-CG its inverses (``invert_m``, ``solve_m``). ``factor_m`` keeps the
Cholesky factor (kernel ``factor_batched``), from which ``solve_m`` solves
when there is no inverse (kernel ``solve_batched``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref.math.spatial import inert_mul_cm, motion_cross_force_cm
from portbench.ref.ops import cholesky as ops_chol
from portbench.ref.physics import kinematics as K
from portbench.ref.physics import model as M


def crb(m: M.Model, d: M.Data, dense: bool = False) -> M.Data:
    """Composite inertias (subtree sums) applied to cdof: crb_f (B, 6, nv),
    and with ``dense`` the dense qM (B, nv, nv) the solve paths off the
    kernel layout read."""
    SUB = m.const(m.plan.body_subtree_mask)
    ci = d.cinert_s @ SUB.T  # (B, 6, nbody) composite packed inertia
    ch = d.cinert_h @ SUB.T  # (B, 3, nbody)
    cm = K.subtree_mass(m, d.qpos.shape[0])
    dofb = m.idx(m.dof_bodyid)
    f = inert_mul_cm(ci[:, :, dofb], ch[:, :, dofb], cm[:, dofb], d.cdof)
    if not dense:
        return d.replace(crb_f=f)
    # qM[i, j] = cdof_j . f_i on the dof-ancestor pattern, symmetrized
    full = torch.einsum("bci,bcj->bij", f, d.cdof)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    lower = torch.where(m.const(m.dof_ancestor_mask, torch.bool), full, zero)
    qM = lower + lower.transpose(-1, -2) - torch.diag_embed(torch.diagonal(lower, dim1=-2, dim2=-1))
    return d.replace(crb_f=f, qM=qM + torch.diag_embed(m.dof_armature))


def rne(m: M.Model, d: M.Data) -> M.Data:
    """Recursive Newton-Euler: qfrc_bias = C(qpos, qvel), gravity included."""
    dtype = d.qpos.dtype
    gravity = m.opt.gravity  # (3,), per env (B, 3)
    cacc0 = torch.cat([torch.zeros_like(gravity), -gravity], -1)

    dofb = np.asarray(m.dof_bodyid)
    D2B = m.const(np.eye(m.nbody)[dofb])  # (nv, nbody)
    dof_acc = (d.cdof_dot * d.qvel[:, None, :]) @ D2B  # (B, 6, nbody)
    # prefix (root-to-body) and subtree (body-to-root) sums as mask products
    SUB = m.const(m.plan.body_subtree_mask)
    cacc = cacc0[..., None] + dof_acc @ SUB

    mass = m.body_mass
    fv = inert_mul_cm(d.cinert_s, d.cinert_h, mass, d.cvel)
    cfrc = inert_mul_cm(d.cinert_s, d.cinert_h, mass, cacc)
    cfrc = cfrc + motion_cross_force_cm(d.cvel, fv)
    cfrc = torch.cat([torch.zeros_like(cfrc[:, :, :1]), cfrc[:, :, 1:]], dim=-1)
    cfrc = cfrc @ SUB.T  # subtree (body-to-root) sum

    qfrc_bias = torch.sum(d.cdof * cfrc[:, :, m.idx(dofb)], dim=1)
    return d.replace(qfrc_bias=qfrc_bias)
