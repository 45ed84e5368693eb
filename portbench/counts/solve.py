"""The least time of one solve-kernel launch (``cg_solve_fused``) on an
H100, from the static arrays of the cell's frozen model file alone: the
row layout, the dof tree and the contact supports are worked out here with
numpy, so no change to the program moves this count.

Bytes: each input read once and each output written once (float32 tensors,
bool masks, the int tables). Operations per env: qM assembled at its
lower-triangle ancestor pairs and J at its nonzeros (the dof support of
each contact row, one entry per limit row), the SPD inverse and
qacc_smooth, the CG start, ``its`` iterations of J p, J^T f, M p, M^-1
grad and the dots, the line search's ``ls`` cost evaluations per
iteration, the final J^T f and the (damped) Euler tail. The bound is the
larger of bytes over the HBM rate and operations over the FP32 rate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.counts import H100_FP32_FLOPS, H100_HBM_BYTES_PER_S

JNT_SLIDE, JNT_HINGE = 2, 3
CONE_ELLIPTIC = 1


@dataclasses.dataclass
class Sizes:
    nv: int
    nefc: int  # rows
    nlim: int  # scalar limit rows
    ncon: int  # contact slots
    nroots: int
    nell: int  # elliptic contacts
    anc: int  # lower-triangle ancestor pairs of qM
    j_con: int  # J's nonzeros on the contact rows
    damped: bool


def sizes(npz_path: str) -> Sizes:
    """The solve's sizes from a frozen model file."""
    with np.load(npz_path) as z:
        nv = int(z["nv"])
        parent = z["dof_parentid"].astype(int)
        limited = z["jnt_limited"].astype(bool)
        jtype = z["jnt_type"].astype(int)
        condim = z["pairs_condim"].astype(int)
        npoint = z["pairs_npoint"].astype(int)
        g1, g2 = z["pairs_geom1"].astype(int), z["pairs_geom2"].astype(int)
        geom_body = z["geom_bodyid"].astype(int)
        body_parent = z["body_parentid"].astype(int)
        body_root = z["body_rootid"].astype(int)
        dof_body = z["dof_bodyid"].astype(int)
        elliptic = int(z["opt_cone"]) == CONE_ELLIPTIC
        damped = bool((z["dof_damping"] > 0).any())
    # dof ancestor-or-self mask: anc[i, j] = j is i or an ancestor of i
    anc = np.eye(nv, dtype=bool)
    for i in range(nv):
        j = parent[i]
        while j >= 0:
            anc[i, j] = True
            j = parent[j]
    # dofs that move each body: those of its ancestors-or-self
    nbody = len(body_parent)
    body_anc = np.eye(nbody, dtype=bool)
    for b in range(nbody):
        a = b
        while a != 0:  # the world (body 0) holds no dof
            body_anc[b, a] = True
            a = body_parent[a]
    moves = body_anc[:, dof_body]  # (nbody, nv)
    nlim = int(np.sum(limited & np.isin(jtype, (JNT_SLIDE, JNT_HINGE))))
    rows, j_con, nell = nlim, 0, 0
    for p in range(len(condim)):
        support = int(np.count_nonzero(moves[geom_body[g2[p]]].astype(int)
                                       - moves[geom_body[g1[p]]].astype(int)))
        for _ in range(npoint[p]):
            if condim[p] == 1:
                k = 1
            elif elliptic:
                k, nell = condim[p], nell + 1
            else:
                k = 2 * (condim[p] - 1)
            rows += k
            j_con += k * support
    nroots = len(np.unique(body_root[dof_body]))
    return Sizes(nv=nv, nefc=int(rows), nlim=nlim, ncon=int(npoint.sum()), nroots=nroots,
                 nell=nell, anc=int(anc.sum()), j_con=int(j_con), damped=damped)


def launch(s: Sizes, envs: int, its: int, ls: int, per_env_armature: bool = False):
    """(bytes, FLOPs, least seconds, bound) of one launch over ``envs`` envs,
    each running ``its`` CG iterations of ``ls`` line-search steps."""
    nv, nefc, B = s.nv, s.nefc, envs
    f4 = 4
    ins = (2 * B * 6 * nv  # crb_f, cdof
           + B * s.nroots * 6 * nefc  # the low-rank J factor
           + B * s.nlim + 2 * B * nefc + 2 * B * nv) * f4  # jsign, D, aref, qfrc_smooth, qvel
    ins += B * nefc + B * s.nell  # the row and elliptic masks (bool)
    ins += (nv + s.ncon * nv + (B * nv if per_env_armature else nv)) * f4  # damp, md, armature
    ins += (nefc + 2 * nv + s.nlim) * 4 + 12 * s.nell  # int tables, elliptic table
    outs = B * (f4 * (4 * nv + nefc) + 1)  # qacc, qfrc, a0, qvel_new, force, done
    nbytes = ins + outs
    j_nnz = s.j_con + s.nlim
    nquad = nefc - 3 * s.nell
    cost = 6 * nquad + 30 * s.nell
    per_env = (12 * s.anc + nv + 12 * s.j_con
               + nv ** 3 + 4 * nv * nv + nv  # SPD inverse, qacc_smooth
               + 4 * j_nnz + 2 * nv * nv + 2 * nefc + cost  # start
               + 2 * j_nnz  # final J^T f
               + (nv ** 3 / 3 + 4 * nv * nv if s.damped else 2 * nv))
    per_iter = (4 * j_nnz + 4 * nv * nv + 20 * nv + cost * 14 + 4 * nefc + cost
                + ls * cost)
    flops = float(B * (per_env + its * per_iter))
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_PER_S, flops / H100_FP32_FLOPS
    return nbytes, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
