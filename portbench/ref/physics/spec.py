"""Frozen model files (.npz) -> Model on a device.

``load_model`` builds the ``Model`` from a frozen model file, the
benchmark's own copy of each configuration's body; ``model_from_numpy``
takes the same flat field dict from any source.
"""

from __future__ import annotations

import os
import types
from typing import Dict

import numpy as np
import torch

from portbench.ref.device import default_dtype, resolve_device
from portbench.ref.physics import model as M
from portbench.ref.physics.plan import make_plan

# the env options a frozen file was compiled with (load_model checks them)
FROZEN_OPTIONS = (
    "scale_factor", "rescale_root", "free_jnt", "torque_actuators", "solver",
    "iterations", "ls_iterations",
)

# contact slots a pair of geom types owns: the JAX package's table, every
# pair type physics/collision.py collides
_PAIR_POINTS = {
    (M.GEOM_PLANE, M.GEOM_SPHERE): 1,
    (M.GEOM_PLANE, M.GEOM_CAPSULE): 2,
    (M.GEOM_PLANE, M.GEOM_ELLIPSOID): 1,
    (M.GEOM_PLANE, M.GEOM_BOX): 4,
    (M.GEOM_PLANE, M.GEOM_CYLINDER): 4,
    (M.GEOM_SPHERE, M.GEOM_SPHERE): 1,
    (M.GEOM_SPHERE, M.GEOM_CAPSULE): 1,
    (M.GEOM_SPHERE, M.GEOM_ELLIPSOID): 1,
    (M.GEOM_SPHERE, M.GEOM_BOX): 1,
    (M.GEOM_CAPSULE, M.GEOM_CAPSULE): 2,
    (M.GEOM_CAPSULE, M.GEOM_ELLIPSOID): 1,
    (M.GEOM_CAPSULE, M.GEOM_BOX): 2,
    (M.GEOM_ELLIPSOID, M.GEOM_ELLIPSOID): 1,
    (M.GEOM_SPHERE, M.GEOM_CYLINDER): 1,
    (M.GEOM_CAPSULE, M.GEOM_CYLINDER): 3,
    (M.GEOM_BOX, M.GEOM_BOX): 8,
    # the support-function ascent: one contact, as mjc_Convex
    (M.GEOM_ELLIPSOID, M.GEOM_CYLINDER): 1,
    (M.GEOM_ELLIPSOID, M.GEOM_BOX): 1,
    (M.GEOM_CYLINDER, M.GEOM_CYLINDER): 1,
    (M.GEOM_CYLINDER, M.GEOM_BOX): 1,
    # convex meshes: the four deepest hull vertices on a plane, else the
    # support-function ascent
    (M.GEOM_PLANE, M.GEOM_MESH): 4,
    # height fields: the deepest triangle under each probe (a sphere is one
    # probe, a capsule three along its axis)
    (M.GEOM_HFIELD, M.GEOM_SPHERE): 1,
    (M.GEOM_HFIELD, M.GEOM_CAPSULE): 3,
    (M.GEOM_SPHERE, M.GEOM_MESH): 1,
    (M.GEOM_CAPSULE, M.GEOM_MESH): 1,
    (M.GEOM_ELLIPSOID, M.GEOM_MESH): 1,
    (M.GEOM_CYLINDER, M.GEOM_MESH): 1,
    (M.GEOM_BOX, M.GEOM_MESH): 1,
    (M.GEOM_MESH, M.GEOM_MESH): 1,
}


# ---------------------------------------------------------------------------
# Static-structure derivations (numpy; take any object with the fields)
# ---------------------------------------------------------------------------


def _dof_ancestor_mask(m) -> np.ndarray:
    nv = int(m.nv)
    mask = np.zeros((nv, nv), bool)
    for i in range(nv):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = int(m.dof_parentid[j])
    return mask


def _body_dof_mask(m) -> np.ndarray:
    """mask[b, j] = True iff dof j is in the kinematic chain above body b."""
    mask = np.zeros((int(m.nbody), int(m.nv)), bool)
    for b in range(1, int(m.nbody)):
        body = b
        while body > 0:
            adr, num = int(m.body_dofadr[body]), int(m.body_dofnum[body])
            mask[b, adr : adr + num] = True
            body = int(m.body_parentid[body])
    return mask


def name2id(model: M.Model, objtype: str, name: str) -> int:
    """mj_name2id semantics: -1 when absent."""
    try:
        return model.names[objtype].index(name)
    except ValueError:
        return -1


# ---------------------------------------------------------------------------
# Freeze (offline) and load
# ---------------------------------------------------------------------------


def frozen_path(mjcf_path: str, free_jnt: bool = True) -> str:
    """The frozen model file of an env's ``mjcf_path``: the benchmark
    passes its own ``.npz``, which is itself."""
    if mjcf_path.endswith(".npz"):
        return mjcf_path
    raise FileNotFoundError(f"no frozen model for {mjcf_path!r}: pass the .npz")


def load_model(npz: str, device="cuda", dtype=None, **options) -> M.Model:
    """Builds the port's Model on ``device`` from a frozen model file.

    ``options`` (any of FROZEN_OPTIONS) must match what the file was frozen
    with: the port cannot recompile the MJCF, so a different request
    raises rather than silently running the frozen configuration.
    """
    with np.load(npz) as z:
        fields = {k: z[k] for k in z.files}
    for k, want in options.items():
        if k not in FROZEN_OPTIONS:
            raise TypeError(f"unknown model option {k!r}")
        have = fields["frozen_" + k].item()
        if k == "solver":
            want = want.lower()
        if want != have:
            raise ValueError(
                f"{os.path.basename(npz)} was frozen with {k}={have!r}; "
                f"{k}={want!r} needs a new spec.freeze_mjcf run"
            )
    return model_from_numpy(fields, device=device, dtype=dtype)


def model_from_numpy(
    fields: Dict[str, np.ndarray], device="cuda", dtype=None
) -> M.Model:
    """The port's Model from flat numpy fields (``model.field_keys()``).

    Derived static structure (dof ancestor / body-dof masks, the plan,
    has_damping, has_fluid) is computed here from the static fields.
    """
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    t = lambda x: torch.as_tensor(np.array(x, np.float64), dtype=dtype, device=dev)
    sizes = {k: int(fields[k]) for k in M.SIZE_FIELDS}
    static = {
        k: np.asarray(fields[k], bool if k in M.BOOL_FIELDS else np.int32)
        for k in M.STATIC_FIELDS
    }
    opt = M.Option(
        **{k: t(fields["opt_" + k]) for k in M.OPT_PARAM_FIELDS},
        **{k: int(fields["opt_" + k]) for k in M.OPT_STATIC_FIELDS},
    )
    pairs = M.ContactPairs(
        **{k: np.asarray(fields["pairs_" + k], np.int32) for k in M.PAIR_STATIC_FIELDS},
        **{k: t(fields["pairs_" + k]) for k in M.PAIR_PARAM_FIELDS},
    )
    meshes = {k: np.asarray(fields[k], np.int32) for k in M.MESH_STATIC_FIELDS[:-1]}
    ns = types.SimpleNamespace(**sizes, **static)
    damping = np.asarray(fields["dof_damping"])
    return M.Model(
        opt=opt,
        device=dev,
        dtype=dtype,
        **sizes,
        **static,
        has_damping=bool(np.any(damping != 0)),
        has_fluid=bool(
            float(fields["opt_density"]) > 0 or float(fields["opt_viscosity"]) > 0
        ),
        dof_ancestor_mask=_dof_ancestor_mask(ns),
        body_dof_mask=_body_dof_mask(ns),
        plan=make_plan(ns),
        names={k: [str(s) for s in fields["names_" + k]] for k in M.NAME_KINDS},
        **{k: t(fields[k]) for k in M.PARAM_FIELDS},
        **meshes,
        hfield_patch=int(fields["hfield_patch"]),
        **{k: t(fields[k]) for k in M.MESH_PARAM_FIELDS},
        pairs=pairs,
    )
