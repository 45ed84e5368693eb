"""Constraint solve: MuJoCo CG and Newton on the primal (acceleration)
problem.

Counterpart of ``brax_tracking_tpu/physics/solver.py``. Dispatch follows
``solve`` there, by the same eligibility rule (``quad_kernel_eligible``):

- CG on the kernel layout (one-sided quadratic rows built from limits and
  contacts, plus at most one contiguous block of dim-3 elliptic contacts;
  the minirat, the elliptic minirat, the rodent, the fly, rodent_pair)
  goes through ``_solve_quad``, which calls the solve kernel (ops/cg.py
  ``cg_solve_fused``) once, in the layout and block shape
  ``ops_cg.kernel_layout`` picks: the whole env in one block's shared
  memory or J in device memory for the pair, on one warp for an env that
  shares its SM with others or several for one that holds it alone. A
  model the rule sends there but too large for both layouts
  raises: the XLA-CG path warmstarts where the kernel's CG call does not,
  so it would compute something else.
- Newton on the kernel layout goes through ``_solve_newton_fused``: the
  JAX package's batched branch for such models, which is CG with warmstart
  and the float32 stall exit in chunks of the same kernel, not
  exact-Hessian Newton (a documented performance dispatch there; the two
  converge to the same optimum of the same strictly convex cost).
- CG off that layout (ball-joint limits, > 128 iterations) runs
  ``_solve_xla``: M^-1-preconditioned Polak-Ribiere CG on the dense qM and
  its inverse (``dynamics.invert_m``, kernel ``spd_inverse2``).
- Newton off that layout runs ``_solve_newton``: exact-Hessian Newton, one
  ``spd_solve`` launch per iteration.

Both array paths cost pyramidal, limit and elliptic (dim-3) rows as the
JAX package does, on the dense block efc_Jc (ball-limit rows, then contact
rows), warmstart from the previous step's qacc (mj_warmstart), freeze each
env once it has converged, and stop when every env has (a host read of the
done flags per iteration), as the JAX package's loops do under vmap; the
chunked Newton path reads the flags once per chunk. PGS and condim > 3
raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from brax_tracking_tpu_torch.ops import cg as ops_cg
from brax_tracking_tpu_torch.ops import cholesky as ops_chol
from brax_tracking_tpu_torch.physics import constraint as Cn
from brax_tracking_tpu_torch.physics import dynamics as D
from brax_tracking_tpu_torch.physics import model as M


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
    if m.opt.solver == M.SOLVER_NEWTON:
        if quad_kernel_eligible(m):
            return _solve_newton_fused(m, d, layout)
        return _solve_newton(m, d)
    if m.opt.solver != M.SOLVER_CG:
        raise NotImplementedError(
            f"solver {m.opt.solver} (PGS?) is not implemented; use cg or newton"
        )
    if quad_kernel_eligible(m):
        return _solve_quad(m, d, layout)
    return _solve_xla(m, d)


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
    static keywords. The kernel's layout rule (``ops_cg.kernel_layout``)
    decides here too, so a model too large for both layouts raises before
    anything is computed."""
    st = _solve_statics(m, layout)
    nell = len(st["kw"]["ell_mu"])
    ops_cg.kernel_layout(m.nv, layout.nefc, nell, len(st["kw"]["root_bounds"]), m.ncon)
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


def _solve_newton_fused(m: M.Model, d: M.Data, layout: Cn.EfcLayout) -> M.Data:
    """Newton models on the kernel layout: the JAX package's batched branch
    of ``_solve_newton_fused``. That branch is CG with warmstart and the
    float32 stall exit, not exact-Hessian Newton: the solve kernel runs in
    chunks of K = min(iterations, 4) CG iterations with at most 16
    line-search steps, each chunk warmstarted from the previous chunk's
    qacc (the first from qacc_warmstart, or zeros, which the kernel's
    better-of select discards for qacc_smooth), until every env's done flag
    is set or ceil(iterations / K) chunks have run: one host read of the
    flags per chunk. The kernel's own Euler tail is off; a damped model's
    update is one ``spd_solve`` of (M + h diag(damping)) after the loop.
    ``solver_nchunk`` records the chunks the batch ran."""
    args, kw = _kernel_args(m, d, layout)
    iters = kw["iters"]
    K = min(iters, 4)
    n_chunks = -(-iters // K)
    kw = dict(kw, iters=K, ls_iters=min(kw["ls_iters"], 16), has_damping=False,
              stall_tol=STALL_TOL_F32)
    ws = d.qacc_warmstart if d.qacc_warmstart is not None else torch.zeros_like(d.qfrc_smooth)
    out = ops_cg.cg_solve_fused(*args, warmstart=ws, device=m.device, **kw)
    chunks = 1
    while chunks < n_chunks and not bool(out[5].all()):
        out = ops_cg.cg_solve_fused(*args, warmstart=out[0], device=m.device, **kw)
        chunks += 1
    x, force, qfrc, a0, qvel_next, _ = out
    if m.has_damping:
        mh = d.qM + torch.diag(_solve_statics(m, layout)["damp"])
        qvel_next = d.qvel + m.opt.timestep * ops_chol.spd_solve(
            mh, d.qfrc_smooth + qfrc, device=m.device
        )
    return d.replace(
        qacc=x, qfrc_constraint=qfrc, efc_force=force, qacc_smooth=a0,
        qvel_next=qvel_next, solver_nchunk=chunks,
    )


# ---------------------------------------------------------------------------
# The array paths (models off the kernel layout)
# ---------------------------------------------------------------------------


class _Ctx(NamedTuple):
    x: torch.Tensor  # qacc (B, nv)
    jar: torch.Tensor  # J x - aref (B, nefc)
    mxa: torch.Tensor  # qM (x - qacc_smooth), tracked incrementally
    force: torch.Tensor  # efc forces (B, nefc)
    cost: torch.Tensor  # (B,)
    grad: torch.Tensor
    mgrad: torch.Tensor  # M^-1 grad (CG's preconditioned gradient)


class _Rows(NamedTuple):
    """The array paths' view of the rows: the one-sided quadratic rows
    gated by existence, and the elliptic cones (every tensor per env)."""

    exists: torch.Tensor  # (B, nefc) bool: an instantiated quadratic row
    efc_D: torch.Tensor  # (B, nefc)
    aref: torch.Tensor  # (B, nefc)
    ell_rows: np.ndarray  # (nell, 3) rows [n, t1, t2] of each elliptic cone
    mu: torch.Tensor  # (B, nell) the cone's friction (slide1)
    fr: torch.Tensor  # (B, nell, 2) the tangent rows' friction
    g: torch.Tensor  # (B, nell) bool: the contact slot is active


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def _select(mask: torch.Tensor, a, b):
    """Per env: ``a`` where mask, else ``b`` (tensors or _Ctx of them)."""
    if isinstance(a, _Ctx):
        return _Ctx(*(_select(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _tol(m: M.Model) -> torch.Tensor:
    """The solve's tolerance, 0-d or per env (B,)."""
    return m.opt_b("tolerance", 1) * m.opt_b("meaninertia", 1) * max(1, m.nv)


def _cone_terms(rows: _Rows, jar: torch.Tensor):
    """Per elliptic cone at jar (..., nefc): the normal n, the scaled
    tangents u, t = |u|, and the bottom and middle zones (the JAX package's
    ``_eval_cost_force``; the top zone has no cost)."""
    er = rows.ell_rows
    mu = rows.mu
    n = jar[..., er[:, 0]]
    u = jar[..., er[:, 1:]] * rows.fr / mu[..., None]
    t = torch.sqrt(torch.clamp(torch.sum(u * u, -1), min=M.MINVAL * M.MINVAL))
    bottom = rows.g & (mu * n + t <= 0)
    middle = rows.g & ~bottom & (n < mu * t)
    return n, u, t, bottom, middle


def _eval_cost_force(rows: _Rows, jar: torch.Tensor):
    """Cost and per-row force at jar: the one-sided quadratic rows, then the
    elliptic cones' bottom zone (independent quadratics on the cone's rows)
    and middle zone (the cone-distance cost)."""
    zero = torch.zeros((), dtype=jar.dtype, device=jar.device)
    efc_D = rows.efc_D
    active = (jar < 0) & rows.exists
    force = torch.where(active, -efc_D * jar, zero)
    cost = 0.5 * torch.sum(torch.where(active, efc_D * jar**2, zero), -1)
    if rows.ell_rows.size:
        er = rows.ell_rows
        mu, fr = rows.mu, rows.fr
        n, u_t, t, bottom, middle = _cone_terms(rows, jar)
        dm = efc_D[:, er[:, 0]] / torch.clamp(1 + mu * mu, min=M.MINVAL)
        nmt = n - mu * t
        d_all, jar_all = efc_D[:, er], jar[:, er]
        cost = cost + torch.sum(
            torch.where(bottom, 0.5 * torch.sum(d_all * jar_all**2, -1), zero), -1)
        cost = cost + torch.sum(torch.where(middle, 0.5 * dm * nmt * nmt, zero), -1)
        ft_mid = (dm * nmt * mu)[..., None] * (u_t / t[..., None]) * fr / mu[..., None]
        f_mid = torch.cat([(-dm * nmt)[..., None], ft_mid], -1)
        f = torch.where(bottom[..., None], -d_all * jar_all,
                        torch.where(middle[..., None], f_mid, zero))
        force = force.clone()
        force[:, er.reshape(-1)] = f.reshape(f.shape[0], -1)
    return cost, force


def _linesearch(m: M.Model, rows: _Rows, ctx: _Ctx, p, jar_p, mp) -> torch.Tensor:
    """Exact line search along p per env: bracket the sign change of phi'
    over guess * 2^k, then safeguarded Newton steps, each env frozen once
    |phi'| < tol. It always runs ls_iterations steps: a frozen env is a
    fixed point, and nearly every call needs them all (a host read of the
    flags per step cost more than the steps it saved)."""
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    efc_D, exists = rows.efc_D, rows.exists
    pmp = torch.sum(p * mp, -1)
    # gauss part: phi_g' = p'M(x - a0) + alpha p'Mp
    gauss_p = torch.sum(p * ctx.mxa, -1)
    er = rows.ell_rows
    if er.size:
        # per env, ready for the (B, A, nell) alpha batch
        mu = rows.mu[:, None]
        scale = (rows.fr / rows.mu[..., None])[:, None]
        np_ = jar_p[:, None, er[:, 0]]
        u_tp = jar_p[:, None, er[:, 1:]] * scale
        tpsqr = torch.sum(u_tp * u_tp, -1)
        g = rows.g[:, None]
        dn = efc_D[:, None, er[:, 0]]
        dm = dn / torch.clamp(1 + mu * mu, min=M.MINVAL)
        d_all = efc_D[:, None, er]
        jp_all = jar_p[:, None, er]

    def dphi(alpha):
        """alpha (B, A) -> (phi'(alpha), phi''(alpha)), each (B, A)."""
        jar = ctx.jar[:, None, :] + alpha[..., None] * jar_p[:, None, :]
        active = (jar < 0) & exists[:, None, :]
        dval = gauss_p[:, None] + alpha * pmp[:, None] + torch.sum(
            torch.where(active, efc_D[:, None, :] * jar * jar_p[:, None, :], zero), -1
        )
        ddval = pmp[:, None] + torch.sum(
            torch.where(active, (efc_D * jar_p**2)[:, None, :], zero), -1
        )
        if er.size:
            n = jar[..., er[:, 0]]
            u_t = jar[..., er[:, 1:]] * scale
            t = torch.sqrt(torch.clamp(torch.sum(u_t * u_t, -1), min=M.MINVAL * M.MINVAL))
            tp_dot = torch.sum(u_t * u_tp, -1)
            bottom = g & (mu * n + t <= 0)
            middle = g & ~bottom & (n < mu * t)
            nmt = n - mu * t
            tprime = tp_dot / t
            tdprime = torch.clamp(tpsqr - tprime * tprime, min=0.0) / t
            dval = dval + torch.sum(torch.where(middle, dm * nmt * (np_ - mu * tprime), zero), -1)
            ddval = ddval + torch.sum(torch.where(
                middle, dm * ((np_ - mu * tprime) ** 2 - nmt * mu * tdprime), zero), -1)
            jar_all = jar[..., er]
            dval = dval + torch.sum(torch.where(
                bottom, torch.sum(d_all * jar_all * jp_all, -1), zero), -1)
            ddval = ddval + torch.sum(torch.where(
                bottom, torch.sum(d_all * jp_all**2, -1), zero), -1)
        return dval, ddval

    B = p.shape[0]
    d0, dd0 = dphi(p.new_zeros(B, 1))
    guess = torch.clamp(-d0[:, 0] / torch.clamp(dd0[:, 0], min=M.MINVAL), min=M.MINVAL)
    cand = guess[:, None] * m.const(2.0 ** np.arange(13))
    dcand, _ = dphi(cand)
    pos = dcand >= 0
    hi = torch.min(torch.where(pos, cand, cand[:, -1:]), -1).values
    lo = torch.max(torch.where(~pos & (cand < hi[:, None]), cand, zero), -1).values
    alpha = torch.minimum(guess, hi)

    tol = _tol(m)
    for _ in range(max(int(m.opt.ls_iterations), 1)):
        dv, ddv = dphi(alpha[:, None])
        dv, ddv = dv[:, 0], ddv[:, 0]
        # freeze once converged: at dv ~ 0 the Newton step underflows and
        # the safeguard would bisect away from the optimum
        conv = torch.abs(dv) < tol
        lo2 = torch.where(dv < 0, alpha, lo)
        hi2 = torch.where(dv >= 0, alpha, hi)
        newton = alpha - dv / torch.clamp(ddv, min=M.MINVAL)
        inside = (newton > lo2) & (newton < hi2)
        alpha2 = torch.where(inside, newton, 0.5 * (lo2 + hi2))
        alpha = torch.where(conv, alpha, alpha2)
        lo = torch.where(conv, lo, lo2)
        hi = torch.where(conv, hi, hi2)
    return alpha


def _array_inputs(m: M.Model, d: M.Data) -> _Rows:
    """The rows as the array paths read them: a row exists where efc_pos <
    efc_margin and is quadratic unless it belongs to an elliptic cone,
    whose slot is active where contact_dist < margin (the JAX package's
    ``_solve_xla`` / ``_solve_newton``); friction per slot, per env."""
    layout = Cn.efc_layout(m)
    meta = _cone_meta(m, layout)
    B = d.qpos.shape[0]
    exists = d.efc_pos < d.efc_margin
    if meta.ell_con.size:
        if int(meta.ell_dim.max()) > 3:
            M.unported("torsional and rolling friction (condim > 3)", "§A.12")
        quad = np.zeros(layout.nefc, bool)
        quad[meta.quad_rows] = True
        exists = exists & m.const(quad, torch.bool)
        cp = m.idx(layout.con_pair[meta.ell_con])
        fr = m.pairs.friction[..., cp, 0:2].expand(B, -1, -1)
        g = d.contact_dist[:, m.idx(meta.ell_con)] < m.pairs.margin[..., cp]
        return _Rows(exists, d.efc_D, d.efc_aref, meta.ell_rows, fr[..., 0], fr, g)
    empty = d.qpos.new_zeros(B, 0)
    return _Rows(exists, d.efc_D, d.efc_aref, np.zeros((0, 3), np.int64), empty,
                 d.qpos.new_zeros(B, 0, 2), empty.bool())


def _warmstart(m, d, eval_ctx, ctx: _Ctx, a0, aref) -> _Ctx:
    """mj_warmstart: start from whichever of {qacc_warmstart, qacc_smooth}
    has the lower primal cost."""
    if d.qacc_warmstart is None:
        return ctx
    ws = d.qacc_warmstart
    ctx_w = eval_ctx(ws, Cn.jac_mul(m, d, ws) - aref, _mv(d.qM, ws - a0))
    return _select(ctx_w.cost < ctx.cost, ctx_w, ctx)


def _solve_xla(m: M.Model, d: M.Data) -> M.Data:
    """M^-1-preconditioned Polak-Ribiere CG with exact line search, on the
    dense qM and qMinv, pyramidal and elliptic rows (port of the JAX
    package's ``_solve_xla``)."""
    rows = _array_inputs(m, d)
    aref = rows.aref
    a0 = d.qacc_smooth
    tol = _tol(m)

    def eval_ctx(x, jar, mxa):
        cost, force = _eval_cost_force(rows, jar)
        gauss = 0.5 * torch.sum((x - a0) * mxa, -1)
        grad = mxa - Cn.jac_t_mul(m, d, force)
        return _Ctx(x, jar, mxa, force, cost + gauss, grad, D.solve_m(m, d, grad))

    ctx = eval_ctx(a0, Cn.jac_mul(m, d, a0) - aref, torch.zeros_like(a0))
    ctx = _warmstart(m, d, eval_ctx, ctx, a0, aref)
    p = -ctx.mgrad
    done = torch.zeros(a0.shape[0], dtype=torch.bool, device=a0.device)
    for _ in range(max(int(m.opt.iterations), 1)):
        jar_p = Cn.jac_mul(m, d, p)
        mp = _mv(d.qM, p)
        alpha = _linesearch(m, rows, ctx, p, jar_p, mp)
        new = eval_ctx(
            ctx.x + alpha[:, None] * p, ctx.jar + alpha[:, None] * jar_p,
            ctx.mxa + alpha[:, None] * mp,
        )
        improvement = ctx.cost - new.cost
        gradient = torch.linalg.norm(new.grad, dim=-1)
        beta = torch.sum(new.grad * (new.mgrad - ctx.mgrad), -1) / torch.clamp(
            torch.sum(ctx.grad * ctx.mgrad, -1), min=M.MINVAL
        )
        p_new = -new.mgrad + torch.clamp(beta, min=0.0)[:, None] * p
        step_done = (improvement < tol) | (gradient < tol)
        # envs that converged before this iteration keep their state
        ctx = _select(done, ctx, new)
        p = _select(done, p, p_new)
        done = done | step_done
        if bool(done.all()):
            break
    return d.replace(
        qacc=ctx.x, qfrc_constraint=Cn.jac_t_mul(m, d, ctx.force), efc_force=ctx.force
    )


def _solve_newton(m: M.Model, d: M.Data) -> M.Data:
    """Exact-Hessian Newton (mjSOL_NEWTON; port of the JAX package's
    ``_solve_newton`` / ``_newton_iterate``): direction -H^-1 grad with
    H = M + J' W J, W the row weights of the active quadratic rows and of
    the elliptic cones' bottom zone plus a dense 3 x 3 cone Hessian per
    middle-zone cone, one ``spd_solve`` launch per iteration for the whole
    batch."""
    rows = _array_inputs(m, d)
    aref = rows.aref
    a0 = d.qacc_smooth
    qM = d.qM
    tol = _tol(m)
    nlim = d.efc_jsign.shape[1]
    dadr_lim = m.idx(Cn.limit_dofs(m))
    Jc = d.efc_Jc
    er = rows.ell_rows
    if er.size:
        Jb = Jc[:, m.idx(er - nlim)]  # (B, nell, 3, nv)
        sc = rows.fr / rows.mu[..., None]  # (B, nell, 2)
        s2 = torch.cat([torch.zeros_like(rows.mu)[..., None], sc * sc], -1)
        eye = torch.eye(3, dtype=a0.dtype, device=a0.device)

    def hess(jar):
        zero = torch.zeros((), dtype=jar.dtype, device=jar.device)
        efc_D = rows.efc_D
        w = torch.where((jar < 0) & rows.exists, efc_D, zero)
        H_ell = None
        if er.size:
            mu = rows.mu
            n, u, t, bottom, middle = _cone_terms(rows, jar)
            # bottom zone: independent quadratics on the cone's rows
            w = w.clone()
            w[:, er.reshape(-1)] += torch.where(
                bottom[..., None], efc_D[:, er], zero).reshape(w.shape[0], -1)
            # middle zone: the dense 3 x 3 cone Hessian
            # dm h h' + c (diag(0, s^2) - ghat ghat'), h = [1, -mu g],
            # ghat = [0, g], g_i = s_i u_i / t, c = -dm (n - mu t) mu / t
            dm = efc_D[:, er[:, 0]] / torch.clamp(1 + mu * mu, min=M.MINVAL)
            nmt = n - mu * t
            gv = sc * u / t[..., None]
            h = torch.cat([torch.ones_like(mu)[..., None], -mu[..., None] * gv], -1)
            ghat = torch.cat([torch.zeros_like(mu)[..., None], gv], -1)
            c = -dm * nmt * mu / t
            Bm = (dm[..., None, None] * h[..., :, None] * h[..., None, :]
                  + c[..., None, None] * (eye * s2[..., None, :]
                                          - ghat[..., :, None] * ghat[..., None, :]))
            Bm = torch.where(middle[..., None, None], Bm, zero)
            H_ell = torch.einsum("bcin,bcij,bcjm->bnm", Jb, Bm, Jb)
        H = qM
        if Jc is not None and Jc.shape[1]:
            H = H + (Jc * w[:, nlim:, None]).transpose(-1, -2) @ Jc
        if H_ell is not None:
            H = H + H_ell
        if nlim:
            # scalar limit rows are +-1 one-hot: a diagonal scatter-add
            diag_w = torch.zeros_like(a0).index_add_(1, dadr_lim, w[:, :nlim])
            H = H + torch.diag_embed(diag_w)
        return H

    def eval_ctx(x, jar, mxa):
        cost, force = _eval_cost_force(rows, jar)
        gauss = 0.5 * torch.sum((x - a0) * mxa, -1)
        grad = mxa - Cn.jac_t_mul(m, d, force)
        return _Ctx(x, jar, mxa, force, cost + gauss, grad, grad)

    ctx = eval_ctx(a0, Cn.jac_mul(m, d, a0) - aref, torch.zeros_like(a0))
    ctx = _warmstart(m, d, eval_ctx, ctx, a0, aref)
    done = torch.linalg.norm(ctx.grad, dim=-1) < tol
    niter = torch.zeros(a0.shape[0], dtype=torch.int32, device=a0.device)
    for _ in range(max(int(m.opt.iterations), 1)):
        if bool(done.all()):
            break
        p = -ops_chol.spd_solve(hess(ctx.jar), ctx.grad, device=m.device)
        jar_p = Cn.jac_mul(m, d, p)
        mp = _mv(qM, p)
        alpha = _linesearch(m, rows, ctx, p, jar_p, mp)
        new = eval_ctx(
            ctx.x + alpha[:, None] * p, ctx.jar + alpha[:, None] * jar_p,
            ctx.mxa + alpha[:, None] * mp,
        )
        improvement = ctx.cost - new.cost
        gradient = torch.linalg.norm(new.grad, dim=-1)
        step_done = (improvement < tol) | (gradient < tol)
        ctx = _select(done, ctx, new)
        niter = niter + (~done).to(torch.int32)
        done = done | step_done
    return d.replace(
        qacc=ctx.x, qfrc_constraint=Cn.jac_t_mul(m, d, ctx.force),
        efc_force=ctx.force, solver_niter=niter,
    )
