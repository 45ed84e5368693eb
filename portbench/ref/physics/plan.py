"""Static execution plans derived from model structure at build time.

Counterpart of ``brax_tracking_tpu/physics/plan.py``, reduced to what the
port's engine reads: the tree depth, the joint-type partition and the
tree-accumulation masks its batched tensor ops use. All arrays here are
plain numpy, fixed per model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Plan:
    depth: int  # levels below the world body (the deepest body's depth)
    # joint-type partitions over all joints (for cdof etc.)
    jnt_by_type: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
    # tree-accumulation mask: SUB[p, b] = 1 iff p is ancestor-or-self of b.
    # Subtree sums are SUB @ x; root-to-body prefix sums are SUB.T @ x.
    body_subtree_mask: np.ndarray  # (nbody, nbody) float
    # com_vel helpers
    dof_suffix_mask: np.ndarray  # (nv, nv) float: same-body, >= group start
    free_trans_dof: np.ndarray  # (nv,) bool: translational dofs of free joints


def make_plan(m) -> Plan:
    """Builds the static execution plan from any object exposing MuJoCo's
    structural arrays."""
    nbody, njnt, nv = int(m.nbody), int(m.njnt), int(m.nv)
    depth = np.zeros(nbody, np.int32)
    for b in range(1, nbody):
        depth[b] = depth[int(m.body_parentid[b])] + 1

    jnt_by_type = tuple(
        np.nonzero(np.asarray(m.jnt_type) == t)[0].astype(np.int32)
        for t in range(4)
    )

    # dof suffix mask for cdof_dot: S[d, d'] = 1 if same body and
    # d' >= start of d's joint sub-group (trio for ball/free-rot, self for 1-dof)
    S = np.zeros((nv, nv), np.float64)
    free_trans = np.zeros(nv, bool)
    for j in range(njnt):
        t = int(m.jnt_type[j])
        dadr = int(m.jnt_dofadr[j])
        b = int(m.jnt_bodyid[j])
        body_dofs = np.arange(
            int(m.body_dofadr[b]), int(m.body_dofadr[b]) + int(m.body_dofnum[b])
        )
        if t == 0:  # free
            free_trans[dadr : dadr + 3] = True
            for i in range(3):  # rotation trio
                d = dadr + 3 + i
                S[d, body_dofs[body_dofs >= dadr + 3]] = 1.0
            # translation trio: cdof_dot forced to zero, mask irrelevant
        elif t == 1:  # ball trio
            for i in range(3):
                d = dadr + i
                S[d, body_dofs[body_dofs >= dadr]] = 1.0
        else:
            d = dadr
            S[d, body_dofs[body_dofs >= dadr]] = 1.0

    # ancestor-or-self closure over the parent chain
    SUB = np.eye(nbody, dtype=np.float64)
    for b in range(1, nbody):
        SUB[:, b] += SUB[:, int(m.body_parentid[b])]
    np.clip(SUB, 0.0, 1.0, out=SUB)

    return Plan(
        depth=int(depth.max()) if nbody > 1 else 0,
        jnt_by_type=jnt_by_type,
        body_subtree_mask=SUB,
        dof_suffix_mask=S,
        free_trans_dof=free_trans,
    )
