"""Contact forces decoded from the solved constraint rows, batch-first.

Counterpart of ``brax_tracking_tpu/physics/support.py`` (MuJoCo's
``mj_contactForce``): ``contact_force`` reads each contact slot's wrench
out of ``efc_force`` by the engine's cone convention. The pyramidal
decode (MuJoCo's ``mju_decodePyramid``) is the one the touch sensor reads
(physics/sensor.py).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref.physics import constraint as Cn
from portbench.ref.physics import model as M


def _slot_groups(m: M.Model):
    """Contact slots grouped by how their rows decode: (dim, pyramidal,
    slot ids, first rows, pair ids), built once per model."""
    groups = m.cache.get("support_slot_groups")
    if groups is None:
        layout = Cn.efc_layout(m)
        elliptic = m.opt.cone == M.CONE_ELLIPTIC
        groups = []
        for dim in sorted(set(layout.con_dim.tolist())):
            slots = np.nonzero((layout.con_dim == dim) & (layout.con_rows >= 0))[0]
            groups.append((dim, not elliptic and dim > 1, slots, layout.con_rows[slots],
                           layout.con_pair[slots]))
        m.cache["support_slot_groups"] = groups
    return groups


def contact_force(m: M.Model, d: M.Data, world_frame: bool = False) -> torch.Tensor:
    """Per-slot wrench (B, ncon, 6): [normal, t1, t2, torsion, roll, roll].

    Elliptic rows (and frictionless ones) hold the components directly.
    Pyramidal rows are the edge forces of the ``mu_i Jn +- Jt_i`` pyramid,
    so ``normal = sum_i mu_i (f_2i + f_2i+1)`` and ``t_i = f_2i - f_2i+1``.
    An inactive slot decodes to zero, the solver having left its rows at
    zero. ``world_frame`` rotates the translational part out of the contact
    frame (whose rows are [n, t1, t2])."""
    B = d.qpos.shape[0]
    out = d.qpos.new_zeros(B, m.ncon, 6)
    if m.ncon == 0 or d.efc_force.shape[-1] == 0:
        return out
    f = d.efc_force
    for dim, pyramid, slots, row0, pair in _slot_groups(m):
        si = m.idx(slots)
        if not pyramid:
            out[:, si, :dim] = f[:, m.idx(row0[:, None] + np.arange(dim))]
            continue
        k = np.arange(dim - 1)
        f_pos = f[:, m.idx(row0[:, None] + 2 * k)]  # (B, n, dim - 1)
        f_neg = f[:, m.idx(row0[:, None] + 2 * k + 1)]
        mu = m.pairs.friction[..., m.idx(pair), : dim - 1]
        out[:, si, 0] = torch.sum(mu * (f_pos + f_neg), -1)
        out[:, si, 1:dim] = f_pos - f_neg
    if world_frame:
        lin = torch.einsum("bcji,bcj->bci", d.contact_frame, out[..., :3])
        out = torch.cat([lin, out[..., 3:]], dim=-1)
    return out


