"""Batched constraint solve + Euler velocity update, in plain PyTorch: the
solve kernel's plain version (``cg_solve_fused``), frozen.

Per env it
  1. assembles qM from the low-rank factor (crb_f, cdof) with the
     DFS-contiguous subtree masks plus armature, and J = ((P A) cdof) * md
     plus the one-hot limit rows;
  2. inverts M by the sweep operator and forms qacc_smooth = M^-1 qfrc_smooth;
  3. runs MuJoCo CG (Polak-Ribiere, M^-1-preconditioned, bracketed Newton
     line search, per-env convergence freeze) on one-sided quadratic rows
     plus one contiguous block of dim-3 elliptic contacts [n, t1, t2],
     optionally started from the better of a warmstart and qacc_smooth and
     with the float32 stall exit;
  4. returns qvel + h (M + h diag(damping))^-1 (qfrc_smooth + qfrc_constraint)
     by Cholesky factor and substitution when the model has damping, else
     qvel + h qacc.

``cg_solve_fused`` checks its arguments and runs ``cg_solve_fused_reference``
(dense assembly + ``_cg_arrays``) on any device; it launches no kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from portbench.ref.device import check_device, resolve_device
from portbench.ref.ops.cholesky import sweep_inverse_reference
from portbench.ref.physics import model as M

MINVAL = M.MINVAL


def _bm(P: torch.Tensor, A: torch.Tensor, nroots: int, ncon: int) -> torch.Tensor:
    """Low-rank J factor: Bm[b, root*6 + c, r] = sum_k P[r, k] A[b, root, k, c]."""
    B = A.shape[0]
    Ar = A.reshape(B, nroots, ncon * 3, 6)
    return torch.einsum("rk,bnkc->bncr", P, Ar).reshape(B, nroots * 6, P.shape[0])


_TABLES: dict = {}


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
    return cg_solve_fused_reference(
        f, cdof, A, jsign, D, aref, exists, exists_con, qfrc_smooth, qvel,
        damp, P, md, armature, row_slot=row_slot, sz=sz,
        root_bounds=root_bounds, limit_dadr=limit_dadr, ell0=ell0,
        ell_mu=ell_mu, ell_scale=ell_scale, warmstart=warmstart, **statics,
    )

