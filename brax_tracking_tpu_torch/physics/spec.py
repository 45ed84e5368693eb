"""Frozen model files: MJCF -> .npz (offline) -> Model on a device.

Counterpart of ``brax_tracking_tpu/physics/spec.py``. The JAX package
compiles MJCF through the ``mujoco`` bindings every time it builds a
model; the machine that runs the port on the card has no ``mujoco``, so
the port splits that in two:

- ``freeze_mjcf`` (offline, imports ``mujoco`` lazily) compiles an MJCF
  with the env's solver options and writes every field the port reads,
  plus the static contact-pair table, into an ``.npz``;
- ``load_model`` builds the port's ``Model`` on a device from that file,
  with no ``mujoco`` at all.

``model_from_numpy`` takes the same flat field dict from any source, e.g.
the JAX package's Model converted to numpy, so both packages can compute
on identical parameters.
"""

from __future__ import annotations

import os
import types
from typing import Dict

import numpy as np
import torch

from brax_tracking_tpu_torch.device import default_dtype, resolve_device
from brax_tracking_tpu_torch.physics import model as M
from brax_tracking_tpu_torch.physics.plan import make_plan

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
MINIRAT_NPZ = os.path.join(ASSETS, "minirat.npz")
MINIRAT_XML = os.path.join(ASSETS, "minirat.xml")
# the minirat with elliptic friction cones (its <option> line adds
# cone="elliptic"): 22 dim-3 elliptic contacts on the solve kernel's layout
MINIRAT_ELLIPTIC_XML = os.path.join(ASSETS, "minirat_elliptic.xml")
MINIRAT_ELLIPTIC_NPZ = os.path.join(ASSETS, "minirat_elliptic.npz")
# the minirat frozen for Newton at MuJoCo's default budget (rodent_pair's
# Newton/100), on the solve kernel's layout
MINIRAT_NEWTON_NPZ = os.path.join(ASSETS, "minirat_newton.npz")
MINIRAT_NEWTON_OPTIONS = dict(solver="newton", iterations=100, ls_iterations=50)
# the minirat on the x-z plane (slides rootx, rootz and the hinge rooty in
# place of its free joint, dm_control's planar walkers' root): the slide
# joints' fixture, CG 4/4 on the solve kernel's layout
MINIRAT_PLANAR_XML = os.path.join(ASSETS, "minirat_planar.xml")
MINIRAT_PLANAR_NPZ = os.path.join(ASSETS, "minirat_planar.npz")
# the minirat with a targetbody, a targetbodycom and a track camera: the
# render fixture of the cameras that aim at a body
MINIRAT_CAMERAS_XML = os.path.join(ASSETS, "minirat_cameras.xml")
MINIRAT_CAMERAS_NPZ = os.path.join(ASSETS, "minirat_cameras.npz")
# the two-rat stand-in at rodent_pair's sizes (assets/make_ratpair.py writes
# the MJCF): frozen with the dataset config's CG 4/4, with elliptic cones,
# and for Newton at the pair XML's own default budget (Newton/100)
RATPAIR_XML = os.path.join(ASSETS, "ratpair.xml")
RATPAIR_NPZ = os.path.join(ASSETS, "ratpair.npz")
RATPAIR_ELLIPTIC_XML = os.path.join(ASSETS, "ratpair_elliptic.xml")
RATPAIR_ELLIPTIC_NPZ = os.path.join(ASSETS, "ratpair_elliptic.npz")
RATPAIR_NEWTON_NPZ = os.path.join(ASSETS, "ratpair_newton.npz")
# one rat of the stand-in alone (nv 73, the rodent's width): the solve
# kernel's wide layout 1
RAT_XML = os.path.join(ASSETS, "rat.xml")
RAT_NPZ = os.path.join(ASSETS, "rat.npz")
# ballmuscle: ball joints with limits, a fixed tendon, muscles and a
# filterexact actuator, frozen once per solver of the engine slice
BALLMUSCLE_XML = os.path.join(ASSETS, "ballmuscle.xml")
BALLMUSCLE_NPZ = {
    solver: os.path.join(ASSETS, f"ballmuscle_{solver}.npz")
    for solver in ("cg", "newton")
}
# the options each ballmuscle file is frozen with: its own <option> line,
# with the solver switched for the Newton file
BALLMUSCLE_OPTIONS = dict(iterations=50, ls_iterations=25)

# the rodent stand-in at the sizes and with the features of the flagship
# rodent (configs/dataset/rodent.yaml, whose MJCF is not in this repository;
# assets/make_ratpair.py writes it), frozen with that config's env_args:
# CG 4/4 and the subtree under the torso rescaled by 0.9
RODENT_STANDIN_XML = os.path.join(ASSETS, "rodent_standin.xml")
RODENT_STANDIN_NPZ = os.path.join(ASSETS, "rodent_standin.npz")
RODENT_OPTIONS = dict(scale_factor=0.9, rescale_root="torso")
# the rodent configs' render scene on the stand-in: two rodent stand-ins,
# the reference clip's first, frozen unscaled as the JAX render compiles
# its rendering_mjcf
RODENT_STANDIN_PAIR_XML = os.path.join(ASSETS, "rodent_standin_pair.xml")
RODENT_STANDIN_PAIR_NPZ = os.path.join(ASSETS, "rodent_standin_pair.npz")
# the rodent stand-in dressed in visual meshes on a terrain (a height field,
# a box step, a cylinder and two convex mesh rocks; assets/make_ratpair.py),
# frozen as RODENT_STANDIN_NPZ, and its render scene
RODENT_STANDIN_TERRAIN_XML = os.path.join(ASSETS, "rodent_standin_terrain.xml")
RODENT_STANDIN_TERRAIN_NPZ = os.path.join(ASSETS, "rodent_standin_terrain.npz")
RODENT_STANDIN_TERRAIN_PAIR_XML = os.path.join(ASSETS, "rodent_standin_terrain_pair.xml")
RODENT_STANDIN_TERRAIN_PAIR_NPZ = os.path.join(ASSETS, "rodent_standin_terrain_pair.npz")
# free props (boxes, cylinders, convex meshes, a sphere and a capsule)
# dropped on a plane, a height field and each other (assets/make_props.py),
# frozen with CG 4/4
PROPS_XML = os.path.join(ASSETS, "props.xml")
PROPS_NPZ = os.path.join(ASSETS, "props.npz")

# the fly stand-in at the sizes of the fly's _fast model (configs/dataset/
# fly.yaml and fly_freejnt.yaml, whose MJCF is not in this repository;
# assets/make_fly_standin.py writes it), frozen with those configs' CG 4/4:
# with its free root for fly_freejnt.yaml, and tethered (the free joint
# stripped) for fly.yaml; its stac exports are one MuJoCo C rollout of the
# free stand-in, full width and without the root columns
FLY_STANDIN_XML = os.path.join(ASSETS, "fly_standin.xml")
FLY_STANDIN_NPZ = os.path.join(ASSETS, "fly_standin.npz")
FLY_STANDIN_TETHERED_NPZ = os.path.join(ASSETS, "fly_standin_tethered.npz")
FLY_STANDIN_STAC = os.path.join(ASSETS, "fly_standin_stac.p")
FLY_STANDIN_TETHERED_STAC = os.path.join(ASSETS, "fly_standin_tethered_stac.p")
# the fly stand-in's ball-coxa variant (the shape of the fly's _ball model:
# limited ball joints beside elliptic contacts, off the solve kernel's
# layout), frozen as fly_freejnt.yaml loads it and as a Newton copy, and
# its stac export
FLY_STANDIN_BALL_XML = os.path.join(ASSETS, "fly_standin_ball.xml")
FLY_STANDIN_BALL_NPZ = os.path.join(ASSETS, "fly_standin_ball.npz")
FLY_STANDIN_BALL_NEWTON_NPZ = os.path.join(ASSETS, "fly_standin_ball_newton.npz")
FLY_STANDIN_BALL_STAC = os.path.join(ASSETS, "fly_standin_ball_stac.p")
FLY_BALL_NEWTON_OPTIONS = dict(solver="newton", iterations=10, ls_iterations=10)
# the fly configs' render scene on the stand-in: two fly stand-ins, frozen
# with both free roots and with both stripped (render_scene)
FLY_STANDIN_PAIR_XML = os.path.join(ASSETS, "fly_standin_pair.xml")
FLY_STANDIN_PAIR_NPZ = os.path.join(ASSETS, "fly_standin_pair.npz")
FLY_STANDIN_PAIR_TETHERED_NPZ = os.path.join(ASSETS, "fly_standin_pair_tethered.npz")

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

# MuJoCo's sensor types (mjtSensor names) as the port's SENS_*, the JAX
# package's _SENSOR_MAP; any other type raises at freeze
_SENSOR_MAP = {
    "mjSENS_TOUCH": M.SENS_TOUCH,
    "mjSENS_ACCELEROMETER": M.SENS_ACCELEROMETER,
    "mjSENS_VELOCIMETER": M.SENS_VELOCIMETER,
    "mjSENS_GYRO": M.SENS_GYRO,
    "mjSENS_SUBTREELINVEL": M.SENS_SUBTREELINVEL,
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
# Meshes and height fields (offline, on a compiled mujoco.MjModel)
# ---------------------------------------------------------------------------


def _build_meshes(m):
    """The colliding meshes' hull data (the JAX package's _build_meshes):
    (geom_meshidx, mesh_vertnum, mesh_vert), each mesh geom's index into a
    padded (nmeshused, maxvert, 3) array of its mesh's vertices in the geom
    frame (MuJoCo bakes the mesh-to-geom transform into the compiled
    vertices). A support maximum over every vertex is the hull's; padding
    repeats vertex 0, which never changes a maximum, and the valid count
    keeps it out of plane-mesh's four deepest."""
    geom_meshidx = np.full(m.ngeom, -1, np.int32)
    mesh_ids = sorted(
        {
            int(m.geom_dataid[g])
            for g in range(m.ngeom)
            if m.geom_type[g] == M.GEOM_MESH
            and (m.geom_contype[g] or m.geom_conaffinity[g])
        }
    )
    if not mesh_ids:
        return geom_meshidx, np.zeros(0, np.int32), np.zeros((0, 0, 3))
    verts = []
    for did in mesh_ids:
        adr, num = int(m.mesh_vertadr[did]), int(m.mesh_vertnum[did])
        verts.append(np.asarray(m.mesh_vert[adr : adr + num], np.float64))
    maxv = max(len(v) for v in verts)
    packed = np.stack(
        [np.concatenate([v, np.tile(v[:1], (maxv - len(v), 1))]) for v in verts]
    )
    for g in range(m.ngeom):
        if m.geom_type[g] == M.GEOM_MESH and int(m.geom_dataid[g]) in mesh_ids:
            geom_meshidx[g] = mesh_ids.index(int(m.geom_dataid[g]))
    return geom_meshidx, np.array([len(v) for v in verts], np.int32), packed


def _build_hfields(m):
    """The colliding height fields (the JAX package's _build_hfields):
    (geom_hfieldidx, nrowcol, patch_k, elev, size), each hfield geom's index
    into a padded (nhfused, maxrow, maxcol) array of elevations in metres
    (MuJoCo's hfield_data in [0, 1] times size[2]), and the static side K of
    the (K, K) grid patch each probe tests: it covers the widest probe of
    any sphere or capsule of the model, colliding or not (2 x reach over the
    finest grid spacing, + 3), clamped to the grid."""
    geom_hfieldidx = np.full(m.ngeom, -1, np.int32)
    hf_geoms = [
        g
        for g in range(m.ngeom)
        if m.geom_type[g] == M.GEOM_HFIELD
        and (m.geom_contype[g] or m.geom_conaffinity[g])
    ]
    if not hf_geoms:
        return geom_hfieldidx, np.zeros((0, 2), np.int32), 0, np.zeros((0, 0, 0)), np.zeros((0, 4))
    hids = sorted({int(m.geom_dataid[g]) for g in hf_geoms})
    nrowcol = np.array(
        [[int(m.hfield_nrow[h]), int(m.hfield_ncol[h])] for h in hids], np.int32
    )
    size = np.array([m.hfield_size[h] for h in hids], np.float64)
    maxr, maxc = int(nrowcol[:, 0].max()), int(nrowcol[:, 1].max())
    elev = np.zeros((len(hids), maxr, maxc))
    for k, h in enumerate(hids):
        nr, nc = nrowcol[k]
        adr = int(m.hfield_adr[h])
        data = np.asarray(m.hfield_data[adr : adr + nr * nc]).reshape(nr, nc)
        elev[k, :nr, :nc] = data * float(m.hfield_size[h][2])
    for g in hf_geoms:
        geom_hfieldidx[g] = hids.index(int(m.geom_dataid[g]))

    # a probe's reach: a sphere's radius; a capsule is probed as three
    # spheres along its axis, so its radius and half the probe spacing
    reach = 0.0
    for g in range(m.ngeom):
        t = int(m.geom_type[g])
        if t == M.GEOM_SPHERE:
            r = float(m.geom_size[g, 0])
        elif t == M.GEOM_CAPSULE:
            r = float(m.geom_size[g, 0] + 0.5 * m.geom_size[g, 1])
        else:
            continue
        reach = max(reach, r)
    spacing = np.inf
    for k in range(len(hids)):
        nr, nc = nrowcol[k]
        if nc > 1:
            spacing = min(spacing, 2.0 * size[k, 0] / (nc - 1))
        if nr > 1:
            spacing = min(spacing, 2.0 * size[k, 1] / (nr - 1))
    if not np.isfinite(spacing):
        spacing = 1.0
    patch_k = int(np.ceil(2.0 * reach / spacing)) + 3
    patch_k = min(patch_k, int(nrowcol[:, 0].min()), int(nrowcol[:, 1].min()))
    patch_k = max(patch_k, 2)
    return geom_hfieldidx, nrowcol, patch_k, elev, size


def _mesh_fields(m) -> Dict[str, np.ndarray]:
    """M.MESH_STATIC_FIELDS and M.MESH_PARAM_FIELDS of a compiled model."""
    geom_meshidx, mesh_vertnum, mesh_vert = _build_meshes(m)
    geom_hfieldidx, nrowcol, patch_k, elev, size = _build_hfields(m)
    return dict(
        geom_meshidx=geom_meshidx, mesh_vertnum=mesh_vertnum,
        geom_hfieldidx=geom_hfieldidx, hfield_nrowcol=nrowcol,
        hfield_patch=np.asarray(patch_k, np.int64), mesh_vert=np.asarray(mesh_vert, np.float64),
        hfield_elev=np.asarray(elev, np.float64), hfield_size=np.asarray(size, np.float64),
    )


# ---------------------------------------------------------------------------
# Contact pairs (offline, on a compiled mujoco.MjModel)
# ---------------------------------------------------------------------------


def _candidate_pairs(m):
    """Geom pairs that can ever collide, per MuJoCo's filters: same-weld
    exclusion, parent-child filter (world excepted), contype/conaffinity
    compatibility and <exclude> signatures. Lower geom type first."""
    excludes = set()
    for s in m.exclude_signature:
        excludes.add((int(s) >> 16, int(s) & 0xFFFF))
    pairs = []
    for g1 in range(m.ngeom):
        for g2 in range(g1 + 1, m.ngeom):
            b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
            w1, w2 = int(m.body_weldid[b1]), int(m.body_weldid[b2])
            if w1 == w2:
                continue
            wp1 = int(m.body_weldid[m.body_parentid[w1]])
            wp2 = int(m.body_weldid[m.body_parentid[w2]])
            if (wp1 == w2 and w2 != 0) or (wp2 == w1 and w1 != 0):
                continue
            if (b1, b2) in excludes or (b2, b1) in excludes:
                continue
            t1 = int(m.geom_contype[g1]) & int(m.geom_conaffinity[g2])
            t2 = int(m.geom_contype[g2]) & int(m.geom_conaffinity[g1])
            if not (t1 or t2):
                continue
            if m.geom_type[g1] <= m.geom_type[g2]:
                pairs.append((g1, g2))
            else:
                pairs.append((g2, g1))
    return pairs


def _mix_pair_params(m, g1: int, g2: int):
    """MuJoCo's contact parameter mixing (priority / solmix rules)."""
    p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
    f1, f2 = m.geom_friction[g1], m.geom_friction[g2]
    if p1 != p2:
        hi = g1 if p1 > p2 else g2
        condim = int(m.geom_condim[hi])
        friction3 = m.geom_friction[hi].copy()
        solref = m.geom_solref[hi].copy()
        solimp = m.geom_solimp[hi].copy()
    else:
        condim = int(max(m.geom_condim[g1], m.geom_condim[g2]))
        friction3 = np.maximum(f1, f2)
        s1, s2 = float(m.geom_solmix[g1]), float(m.geom_solmix[g2])
        if s1 >= M.MINVAL and s2 >= M.MINVAL:
            mix = s1 / (s1 + s2)
        elif s1 < M.MINVAL and s2 < M.MINVAL:
            mix = 0.5
        else:
            mix = 1.0 if s1 >= M.MINVAL else 0.0
        r1, r2 = m.geom_solref[g1], m.geom_solref[g2]
        if r1[0] > 0 and r2[0] > 0:
            solref = mix * r1 + (1 - mix) * r2
        else:
            solref = np.minimum(r1, r2)
        solimp = mix * m.geom_solimp[g1] + (1 - mix) * m.geom_solimp[g2]
    friction5 = np.array(
        [friction3[0], friction3[0], friction3[1], friction3[2], friction3[2]]
    )
    margin = float(max(m.geom_margin[g1], m.geom_margin[g2]))
    gap = float(max(m.geom_gap[g1], m.geom_gap[g2]))
    return condim, friction5, solref, solimp, margin, gap


def _build_pairs(m) -> Dict[str, np.ndarray]:
    """The static pair table as flat ``pairs_*`` arrays."""
    cols = {k: [] for k in M.PAIR_STATIC_FIELDS + M.PAIR_PARAM_FIELDS}
    for g1, g2 in _candidate_pairs(m):
        key = (int(m.geom_type[g1]), int(m.geom_type[g2]))
        if key not in _PAIR_POINTS:
            M.unported(f"collision pair of geom types {key}", "§A.12")
        condim, fr, sr, si, margin, gap = _mix_pair_params(m, g1, g2)
        for k, v in zip(
            M.PAIR_STATIC_FIELDS + M.PAIR_PARAM_FIELDS,
            (g1, g2, _PAIR_POINTS[key], condim, fr, sr, si, margin, gap),
        ):
            cols[k].append(v)
    shapes = dict(friction=(0, 5), solref=(0, 2), solimp=(0, 5))
    out = {}
    for k, v in cols.items():
        if k in M.PAIR_STATIC_FIELDS:
            out["pairs_" + k] = np.asarray(v, np.int32)
        elif v:
            out["pairs_" + k] = np.asarray(np.stack(v) if k in shapes else v, np.float64)
        else:
            out["pairs_" + k] = np.zeros(shapes.get(k, (0,)))
    return out


# ---------------------------------------------------------------------------
# Freeze (offline) and load
# ---------------------------------------------------------------------------


def rescale_subtree(spec, body_name: str, length_factor: float):
    """Scales every length in the subtree under ``body_name`` of a
    ``mujoco.MjSpec``: child body, geom, site and joint positions, geom and
    site sizes and geom ``fromto``; the compiler then refits masses and
    inertias from the scaled geometry. The named body's own position stays
    (the JAX package's ``spec.rescale_subtree``, dm_control's
    ``rescale.rescale_subtree``)."""

    def recurse(body):
        for child in body.bodies:
            child.pos = np.asarray(child.pos) * length_factor
            recurse(child)
        for geom in body.geoms:
            geom.size = np.asarray(geom.size) * length_factor
            geom.pos = np.asarray(geom.pos) * length_factor
            if hasattr(geom, "fromto") and np.all(np.isfinite(geom.fromto)):
                geom.fromto = np.asarray(geom.fromto) * length_factor
        for site in body.sites:
            site.pos = np.asarray(site.pos) * length_factor
            site.size = np.asarray(site.size) * length_factor
        for joint in body.joints:
            joint.pos = np.asarray(joint.pos) * length_factor

    recurse(spec.body(body_name))
    return spec


def strip_free_joint(spec, body_name: str = "thorax"):
    """Deletes the leading joint of ``body_name`` when it is the free joint
    named ``free``: the tethered fly (the JAX package's
    ``spec.strip_free_joint``)."""
    joints = spec.body(body_name).joints
    if joints and joints[0].name == "free":
        spec.delete(joints[0])
    return spec


def torque_actuator_rewrite(spec):
    """Makes every actuator a direct torque motor: a fixed gain equal to its
    upper force limit and no bias (the JAX package's
    ``spec.torque_actuator_rewrite``)."""
    import mujoco

    for act in spec.actuators:
        force_hi = act.forcerange[1]
        act.gainprm[:] = 0.0
        act.gainprm[0] = force_hi
        act.gaintype = mujoco.mjtGain.mjGAIN_FIXED
        act.biastype = mujoco.mjtBias.mjBIAS_NONE
        act.biasprm[:] = 0.0
    return spec


def _sensor_types(m) -> np.ndarray:
    """The port's SENS_* of each sensor of a compiled model; another type
    raises."""
    import mujoco

    out = []
    for s, t in enumerate(np.asarray(m.sensor_type)):
        name = mujoco.mjtSensor(int(t)).name
        if name not in _SENSOR_MAP:
            M.unported(f"sensor {s} of type {name}", "§A.12")
        out.append(_SENSOR_MAP[name])
    return np.asarray(out, np.int32)


def strip_every_free_joint(spec):
    """Deletes every free joint: a tethered render scene of two bodies (the
    JAX package's ``harness/render.py``)."""
    import mujoco

    for joint in list(spec.joints):
        if joint.type == mujoco.mjtJoint.mjJNT_FREE:
            spec.delete(joint)
    return spec


def _render_fields(m, mujoco) -> Dict[str, np.ndarray]:
    """The ``render_*`` fields of a compiled model (M.RENDER_FIELDS, every
    mesh's triangles M.RENDER_MESH_FIELDS, and the camera names). An SDF
    geom raises: the JAX package collides none."""
    if np.any(np.asarray(m.geom_type) == M.GEOM_SDF):
        M.unported("SDF geoms", "§A.12")
    out = {}
    for k in M.RENDER_FIELDS:
        v = getattr(m.stat, k[5:]) if k.startswith("stat_") else getattr(m, k)
        out["render_" + k] = np.asarray(v, np.int32 if k in M.RENDER_INT_FIELDS else np.float64)
    for k in M.RENDER_MESH_FIELDS:
        out["render_" + k] = np.asarray(
            getattr(m, k), np.float64 if k in M.RENDER_MESH_FLOAT_FIELDS else np.int32)
    out["render_names_camera"] = np.asarray(
        [mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_CAMERA, i) or "" for i in range(m.ncam)],
        dtype=str)
    return out


def freeze_mjcf(
    xml_path: str,
    out_npz: str,
    scale_factor: float = 1.0,
    rescale_root: str = "torso",
    free_jnt: bool = True,
    torque_actuators: bool = False,
    solver: str = "cg",
    iterations: int = 4,
    ls_iterations: int = 4,
    render_scene: bool = False,
) -> Dict[str, np.ndarray]:
    """Compiles ``xml_path`` with the env options and writes every field the
    port reads into ``out_npz``; returns the written arrays.

    The defaults are the minirat dataset's env_args
    (configs/dataset/minirat.yaml). The spec transforms run before the
    compile in the JAX package's ``build_model`` order: ``free_jnt`` False
    strips the thorax's free joint (strip_free_joint), or with
    ``render_scene`` every free joint (strip_every_free_joint: a pair scene
    for the renderer, compiled as the JAX render compiles it),
    ``torque_actuators`` rewrites the actuators as torque motors
    (torque_actuator_rewrite), and ``scale_factor`` != 1 rescales the
    subtree under ``rescale_root`` (rescale_subtree). Besides the physics
    fields it writes the renderer's (``render_*``, ``render_fields``):
    meshes freeze with their triangles, height fields are skipped as the
    JAX renderer skips them, and SDF geoms raise. Needs the ``mujoco`` bindings,
    which only this offline step imports.
    """
    import mujoco

    spec = mujoco.MjSpec.from_file(xml_path)
    if not free_jnt:
        (strip_every_free_joint if render_scene else strip_free_joint)(spec)
    if torque_actuators:
        torque_actuator_rewrite(spec)
    if scale_factor != 1.0:
        rescale_subtree(spec, rescale_root, scale_factor)
    m = spec.compile()
    render = _render_fields(m, mujoco)
    if any(int(w) != int(mujoco.mjtWrap.mjWRAP_JOINT) for w in m.wrap_type):
        M.unported("spatial tendons (site and geom wraps)", "§A.12")
    if np.any(np.asarray(m.geom_fluid)[:, 0] > 0):
        # MuJoCo then replaces the body's inertia box by its geoms' ellipsoids
        M.unported("the ellipsoid fluid model (geom fluidshape; the JAX package lacks it too)",
                   "§A.12")
    # the env-level solver overrides (JAX spec.set_solver_options)
    m.opt.solver = {
        "cg": mujoco.mjtSolver.mjSOL_CG,
        "newton": mujoco.mjtSolver.mjSOL_NEWTON,
    }[solver.lower()]
    m.opt.iterations = iterations
    m.opt.ls_iterations = ls_iterations

    fields: Dict[str, np.ndarray] = {}
    for k in M.SIZE_FIELDS:
        fields[k] = np.asarray(int(getattr(m, k)), np.int64)
    for k in M.STATIC_FIELDS:
        dt = bool if k in M.BOOL_FIELDS else np.int32
        fields[k] = np.asarray(getattr(m, k), dt)
    fields["sensor_type"] = _sensor_types(m)
    fields.update(_mesh_fields(m))
    for k in M.PARAM_FIELDS:
        fields[k] = np.asarray(getattr(m, k), np.float64)
    for k in M.OPT_PARAM_FIELDS:
        src = m.stat if k == "meaninertia" else m.opt
        fields["opt_" + k] = np.asarray(getattr(src, k), np.float64)
    for k in M.OPT_STATIC_FIELDS:
        fields["opt_" + k] = np.asarray(int(getattr(m.opt, k)), np.int64)
    fields.update(_build_pairs(m))
    objs = dict(
        body=(mujoco.mjtObj.mjOBJ_BODY, m.nbody),
        joint=(mujoco.mjtObj.mjOBJ_JOINT, m.njnt),
        geom=(mujoco.mjtObj.mjOBJ_GEOM, m.ngeom),
        site=(mujoco.mjtObj.mjOBJ_SITE, m.nsite),
        actuator=(mujoco.mjtObj.mjOBJ_ACTUATOR, m.nu),
        sensor=(mujoco.mjtObj.mjOBJ_SENSOR, m.nsensor),
    )
    for kind, (objtype, count) in objs.items():
        names = [mujoco.mj_id2name(m, objtype, i) or "" for i in range(count)]
        fields["names_" + kind] = np.asarray(names, dtype=str)
    frozen = dict(
        scale_factor=scale_factor, rescale_root=rescale_root, free_jnt=free_jnt,
        torque_actuators=torque_actuators, solver=solver.lower(),
        iterations=iterations, ls_iterations=ls_iterations,
    )
    for k, v in frozen.items():
        fields["frozen_" + k] = np.asarray(v)
    fields.update(render)
    np.savez(out_npz, **fields)
    return fields


def frozen_path(mjcf_path: str, free_jnt: bool = True) -> str:
    """The frozen model file for an MJCF path as the dataset configs name
    it, with the env's model options: ``builtin:<name>.xml`` is the port's
    ``assets/<name>.npz``, or with ``free_jnt`` False (the free joint
    stripped) ``assets/<name>_tethered.npz``; an ``.npz`` path is itself.
    ``load_model`` checks the file's options against the env's."""
    if mjcf_path.endswith(".npz"):
        return mjcf_path
    if mjcf_path.startswith("builtin:"):
        name = os.path.splitext(mjcf_path[len("builtin:"):])[0]
        path = os.path.join(ASSETS, name + ("" if free_jnt else "_tethered") + ".npz")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"no frozen model for {mjcf_path!r}: run spec.freeze_mjcf on the MJCF "
        "and pass the .npz"
    )


def load_model(npz: str = MINIRAT_NPZ, device="cuda", dtype=None, **options) -> M.Model:
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


def render_fields(npz: str) -> types.SimpleNamespace:
    """The renderer's fields of a frozen model file (M.RENDER_FIELDS and
    M.RENDER_MESH_FIELDS, as numpy, with ``ngeom``, ``ncam``, ``geom_type``,
    ``geom_size`` and the camera names ``names_camera``)."""
    with np.load(npz) as z:
        out = {k: z["render_" + k] for k in M.RENDER_FIELDS + M.RENDER_MESH_FIELDS}
        out.update(geom_type=z["geom_type"], geom_size=z["geom_size"], ngeom=int(z["ngeom"]),
                   names_camera=[str(s) for s in z["render_names_camera"]])
    out["ncam"] = len(out["names_camera"])
    out["stat_extent"] = float(out["stat_extent"])
    return types.SimpleNamespace(**out)


def model_to_numpy(model) -> Dict[str, np.ndarray]:
    """Flat numpy fields (``model.field_keys()``) of a model: the port's, or
    any object with the same MuJoCo-named fields, ``opt``, ``pairs`` and
    ``names`` (the JAX package's Model included)."""

    def get(k):
        if k.startswith("opt_"):
            return getattr(model.opt, k[4:])
        if k.startswith("pairs_"):
            return getattr(model.pairs, k[6:])
        if k.startswith("names_"):
            return np.asarray(model.names[k[6:]], dtype=str)
        return getattr(model, k)

    out = {}
    for k in M.field_keys():
        v = get(k)
        out[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


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
