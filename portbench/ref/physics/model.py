"""Model / Data containers for the PyTorch engine.

Counterpart of ``brax_tracking_tpu/physics/model.py``. Field names follow
MuJoCo's vocabulary, as there. Everything that fixes control flow, shapes
or indexing (tree topology, joint types, contact pair table, actuator
wiring) is static numpy; everything physical is a torch tensor on the
model's device. Data tensors are batch-first: ``qpos`` is ``(B, nq)``,
``cdof`` is ``(B, 6, nv)`` (component-major per env, as the JAX package
keeps it). A per-env model (``env_model``) carries a leading env axis on
the parameter leaves it names; the engine reads every leaf past that axis
(``leaf[..., idx]``), so a shared leaf and a per-env one line up with the
batch alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

# MuJoCo enums mirrored as plain ints (values match mujoco.mjtJoint etc.)
JNT_FREE, JNT_BALL, JNT_SLIDE, JNT_HINGE = 0, 1, 2, 3
GEOM_PLANE, GEOM_HFIELD, GEOM_SPHERE, GEOM_CAPSULE = 0, 1, 2, 3
GEOM_ELLIPSOID, GEOM_CYLINDER, GEOM_BOX, GEOM_MESH = 4, 5, 6, 7
GEOM_SDF = 8
CAM_FIXED, CAM_TRACK, CAM_TRACKCOM, CAM_TARGETBODY, CAM_TARGETBODYCOM = 0, 1, 2, 3, 4
TRN_JOINT, TRN_JOINTINPARENT, TRN_SLIDERCRANK, TRN_TENDON, TRN_SITE = 0, 1, 2, 3, 4
DYN_NONE, DYN_INTEGRATOR, DYN_FILTER, DYN_FILTEREXACT, DYN_MUSCLE = 0, 1, 2, 3, 4
GAIN_FIXED, GAIN_AFFINE, GAIN_MUSCLE = 0, 1, 2
BIAS_NONE, BIAS_AFFINE, BIAS_MUSCLE = 0, 1, 2
CONE_PYRAMIDAL, CONE_ELLIPTIC = 0, 1
SOLVER_PGS, SOLVER_CG, SOLVER_NEWTON = 0, 1, 2
INT_EULER, INT_RK4, INT_IMPLICIT, INT_IMPLICITFAST = 0, 1, 2, 3
# the sensor types of the JAX package (its physics/model.py), not MuJoCo's
# mjtSensor values: spec.freeze_mjcf maps them
SENS_TOUCH, SENS_ACCELEROMETER, SENS_VELOCIMETER, SENS_GYRO = 0, 1, 2, 3
SENS_SUBTREELINVEL = 4

# mjMINVAL equivalent for guarded divisions.
MINVAL = 1e-15


# ---------------------------------------------------------------------------
# Frozen field inventory: every field the port reads, as stored in a frozen
# model file (spec.freeze_mjcf) and as model_from_numpy takes it. Keys are
# flat; "opt_x" / "pairs_x" / "names_x" live on Option / ContactPairs /
# Model.names.
# ---------------------------------------------------------------------------

SIZE_FIELDS = (
    "nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite", "ntendon",
    "nsensor", "nsensordata",
)
STATIC_FIELDS = (
    "body_parentid", "body_rootid", "body_weldid", "body_jntadr",
    "body_jntnum", "body_dofadr", "body_dofnum", "jnt_type", "jnt_qposadr",
    "jnt_dofadr", "jnt_bodyid", "jnt_limited", "dof_bodyid", "dof_jntid",
    "dof_parentid", "geom_type", "geom_bodyid", "site_bodyid",
    "actuator_trntype", "actuator_dyntype", "actuator_gaintype",
    "actuator_biastype", "actuator_trnid", "actuator_actadr",
    "actuator_actnum", "actuator_ctrllimited", "actuator_forcelimited",
    "actuator_actlimited", "tendon_adr", "tendon_num", "wrap_objid",
    "sensor_type", "sensor_objid", "sensor_adr", "sensor_dim",
)
BOOL_FIELDS = (
    "jnt_limited", "actuator_ctrllimited", "actuator_forcelimited",
    "actuator_actlimited",
)
PARAM_FIELDS = (
    "qpos0", "qpos_spring", "body_pos", "body_quat", "body_ipos",
    "body_iquat", "body_mass", "body_inertia", "body_invweight0", "jnt_axis",
    "jnt_pos", "jnt_range", "jnt_stiffness", "jnt_solref", "jnt_solimp",
    "jnt_margin", "dof_armature", "dof_damping", "dof_invweight0",
    "geom_pos", "geom_quat", "geom_size", "site_pos", "site_quat",
    "actuator_dynprm", "actuator_gainprm", "actuator_biasprm",
    "actuator_ctrlrange", "actuator_forcerange", "actuator_actrange",
    "actuator_gear", "actuator_lengthrange", "actuator_acc0",
    "tendon_stiffness", "tendon_damping", "tendon_lengthspring", "wrap_prm",
)
OPT_PARAM_FIELDS = (
    "timestep", "gravity", "wind", "density", "viscosity", "impratio",
    "tolerance", "ls_tolerance", "meaninertia",
)
OPT_STATIC_FIELDS = (
    "integrator", "cone", "solver", "iterations", "ls_iterations",
    "disableflags",
)
PAIR_STATIC_FIELDS = ("geom1", "geom2", "npoint", "condim")
PAIR_PARAM_FIELDS = ("friction", "solref", "solimp", "margin", "gap")
NAME_KINDS = ("body", "joint", "geom", "site", "actuator", "sensor")
# what the renderer and MuJoCo's cameras read (harness/render.py,
# native/softraster.py), stored apart from the physics fields as
# "render_x" keys ("render_names_camera" the camera names), so
# model_from_numpy never reads them
RENDER_FIELDS = (
    "geom_rgba", "geom_dataid", "stat_center", "stat_extent", "cam_mode", "cam_bodyid",
    "cam_pos", "cam_quat", "cam_fovy", "cam_pos0", "cam_poscom0", "cam_mat0",
    "cam_targetbodyid",
)
RENDER_INT_FIELDS = ("geom_dataid", "cam_mode", "cam_bodyid", "cam_targetbodyid")
# the renderer's triangle meshes (every mesh of the model, colliding or not),
# stored as "render_x" keys beside RENDER_FIELDS
RENDER_MESH_FIELDS = (
    "mesh_vertadr", "mesh_vertnum", "mesh_faceadr", "mesh_facenum", "mesh_vert", "mesh_face",
)
RENDER_MESH_FLOAT_FIELDS = ("mesh_vert",)
# the colliding meshes' hull vertices and the colliding height fields
# (spec._build_meshes / _build_hfields), the JAX package's fields of the
# same names: static index tables and the patch side K, then the tensors
MESH_STATIC_FIELDS = (
    "geom_meshidx", "mesh_vertnum", "geom_hfieldidx", "hfield_nrowcol", "hfield_patch",
)
MESH_PARAM_FIELDS = ("mesh_vert", "hfield_elev", "hfield_size")


@dataclasses.dataclass
class Option:
    """Simulation options (mjOption subset the slice reads)."""

    timestep: torch.Tensor
    gravity: torch.Tensor  # (3,)
    wind: torch.Tensor  # (3,)
    density: torch.Tensor
    viscosity: torch.Tensor
    impratio: torch.Tensor
    tolerance: torch.Tensor
    ls_tolerance: torch.Tensor
    meaninertia: torch.Tensor
    integrator: int = INT_EULER
    cone: int = CONE_PYRAMIDAL
    solver: int = SOLVER_NEWTON
    iterations: int = 100
    ls_iterations: int = 50
    disableflags: int = 0

    def replace(self, **kwargs) -> "Option":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class ContactPairs:
    """Static candidate contact-pair table; each pair owns ``npoint`` fixed
    contact slots, switched on and off at run time by dist < margin."""

    geom1: np.ndarray
    geom2: np.ndarray
    npoint: np.ndarray
    condim: np.ndarray
    friction: torch.Tensor  # (npair, 5)
    solref: torch.Tensor  # (npair, 2)
    solimp: torch.Tensor  # (npair, 5)
    margin: torch.Tensor  # (npair,)
    gap: torch.Tensor  # (npair,)

    @property
    def count(self) -> int:
        return int(np.sum(self.npoint))

    def replace(self, **kwargs) -> "ContactPairs":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class Model:
    """Compiled model on one device. Built by ``spec.model_from_numpy``."""

    opt: Option
    device: torch.device
    dtype: torch.dtype
    # sizes
    nq: int = 0
    nv: int = 0
    nu: int = 0
    na: int = 0
    nbody: int = 0
    njnt: int = 0
    ngeom: int = 0
    nsite: int = 0
    ntendon: int = 0
    nsensor: int = 0
    nsensordata: int = 0
    # static structure (numpy)
    body_parentid: Any = None
    body_rootid: Any = None
    body_weldid: Any = None
    body_jntadr: Any = None
    body_jntnum: Any = None
    body_dofadr: Any = None
    body_dofnum: Any = None
    jnt_type: Any = None
    jnt_qposadr: Any = None
    jnt_dofadr: Any = None
    jnt_bodyid: Any = None
    jnt_limited: Any = None
    dof_bodyid: Any = None
    dof_jntid: Any = None
    dof_parentid: Any = None
    geom_type: Any = None
    geom_bodyid: Any = None
    site_bodyid: Any = None
    actuator_trntype: Any = None
    actuator_dyntype: Any = None
    actuator_gaintype: Any = None
    actuator_biastype: Any = None
    actuator_trnid: Any = None
    actuator_actadr: Any = None
    actuator_actnum: Any = None
    actuator_ctrllimited: Any = None
    actuator_forcelimited: Any = None
    actuator_actlimited: Any = None
    tendon_adr: Any = None  # (ntendon,) first wrap of each fixed tendon
    tendon_num: Any = None  # (ntendon,) wraps per tendon
    wrap_objid: Any = None  # (nwrap,) joint id of each fixed-tendon wrap
    sensor_type: Any = None  # (nsensor,) SENS_* (not mjtSensor)
    sensor_objid: Any = None  # (nsensor,) site or body id
    sensor_adr: Any = None  # (nsensor,) first column in sensordata
    sensor_dim: Any = None  # (nsensor,)
    # derived static structure
    has_damping: bool = False
    has_fluid: bool = False
    dof_ancestor_mask: Any = None  # (nv, nv) bool, [i, j] = j anc-or-self of i
    body_dof_mask: Any = None  # (nbody, nv) bool, [b, j] = dof j moves body b
    plan: Any = None  # physics.plan.Plan
    names: Dict[str, list] = None
    # colliding meshes and height fields (spec._build_meshes / _build_hfields)
    geom_meshidx: Any = None  # (ngeom,) into mesh_vert, -1 = not a colliding mesh
    mesh_vertnum: Any = None  # (nmeshused,) valid hull vertices of each
    geom_hfieldidx: Any = None  # (ngeom,) into hfield_*, -1 = not a colliding hfield
    hfield_nrowcol: Any = None  # (nhfused, 2) (nrow, ncol)
    hfield_patch: int = 0  # K: the (K, K) elevation patch under each probe
    # physical parameters (tensors on ``device``)
    qpos0: torch.Tensor = None
    qpos_spring: torch.Tensor = None
    body_pos: torch.Tensor = None
    body_quat: torch.Tensor = None
    body_ipos: torch.Tensor = None
    body_iquat: torch.Tensor = None
    body_mass: torch.Tensor = None
    body_inertia: torch.Tensor = None
    body_invweight0: torch.Tensor = None
    jnt_axis: torch.Tensor = None
    jnt_pos: torch.Tensor = None
    jnt_range: torch.Tensor = None
    jnt_stiffness: torch.Tensor = None
    jnt_solref: torch.Tensor = None
    jnt_solimp: torch.Tensor = None
    jnt_margin: torch.Tensor = None
    dof_armature: torch.Tensor = None
    dof_damping: torch.Tensor = None
    dof_invweight0: torch.Tensor = None
    geom_pos: torch.Tensor = None
    geom_quat: torch.Tensor = None
    geom_size: torch.Tensor = None
    site_pos: torch.Tensor = None
    site_quat: torch.Tensor = None
    actuator_dynprm: torch.Tensor = None
    actuator_gainprm: torch.Tensor = None
    actuator_biasprm: torch.Tensor = None
    actuator_ctrlrange: torch.Tensor = None
    actuator_forcerange: torch.Tensor = None
    actuator_actrange: torch.Tensor = None
    actuator_gear: torch.Tensor = None
    actuator_lengthrange: torch.Tensor = None  # (nu, 2) muscle operating range
    actuator_acc0: torch.Tensor = None  # (nu,) norm of unit-force qacc (muscle)
    tendon_stiffness: torch.Tensor = None
    tendon_damping: torch.Tensor = None
    tendon_lengthspring: torch.Tensor = None  # (ntendon, 2) deadband
    wrap_prm: torch.Tensor = None  # (nwrap,) fixed-tendon joint coefficients
    mesh_vert: torch.Tensor = None  # (nmeshused, maxvert, 3) geom frame, padded by vertex 0
    hfield_elev: torch.Tensor = None  # (nhfused, maxrow, maxcol) elevations in metres
    hfield_size: torch.Tensor = None  # (nhfused, 4) rx, ry, z top, z bottom
    pairs: ContactPairs = None
    # per-env parameters (envs/wrappers.py DomainRandomizationVmapWrapper):
    # the leaves ("body_mass", "opt.gravity", "pairs.solref") that carry a
    # leading axis of ``nenv`` envs; every other leaf is shared
    env_leaves: frozenset = frozenset()
    nenv: int = 0
    # per-model statics built once on first use (solver kernel tables)
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    def replace(self, **kwargs) -> "Model":
        """A copy with the given fields replaced and an empty cache: the
        cache holds tensors derived from the parameters."""
        return dataclasses.replace(self, cache={}, **kwargs)

    def leaf(self, name: str) -> torch.Tensor:
        """A parameter leaf by its name ("body_mass", "opt.gravity")."""
        obj = self
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    def opt_b(self, name: str, ndim: int) -> torch.Tensor:
        """An option scalar ready to broadcast against a batch tensor of
        ``ndim`` dims: shared, the 0-d tensor; per env, (B, 1, ...)."""
        x = getattr(self.opt, name)
        if "opt." + name in self.env_leaves:
            return x.reshape(x.shape[:1] + (1,) * (ndim - 1))
        return x

    @property
    def ncon(self) -> int:
        """Fixed contact slot count."""
        return self.pairs.count if self.pairs is not None else 0

    def const(self, value, dtype=None) -> torch.Tensor:
        """A static numpy constant (index array, mask, table) as a tensor on
        the model's device, uploaded once and reused: the hot path then
        issues no host-to-device copies. ``dtype`` defaults to the model's
        float dtype; pass ``torch.long`` for index arrays."""
        a = np.ascontiguousarray(value)
        dtype = dtype or self.dtype
        key = (dtype, a.dtype.str, a.shape, a.tobytes())
        t = self.cache.get(key)
        if t is None:
            t = torch.as_tensor(a, device=self.device).to(dtype)
            self.cache[key] = t
        return t

    def idx(self, value) -> torch.Tensor:
        """A static index array as a long tensor on the model's device."""
        return self.const(np.asarray(value, np.int64), torch.long)


def param_leaves() -> tuple:
    """Every parameter leaf's name, as ``Model.leaf`` reads it."""
    return (
        PARAM_FIELDS + MESH_PARAM_FIELDS
        + tuple("opt." + k for k in OPT_PARAM_FIELDS)
        + tuple("pairs." + k for k in PAIR_PARAM_FIELDS)
    )


def replace_leaves(model: Model, values: Dict[str, torch.Tensor]) -> Model:
    """A copy of ``model`` (empty cache) with the parameter leaves named in
    ``values`` ("body_mass", "opt.gravity", "pairs.solref") replaced: how a
    ``randomization_fn`` builds its per-env model."""
    top, opt, pairs = {}, {}, {}
    for name, v in values.items():
        group, _, leaf = name.rpartition(".")
        {"": top, "opt": opt, "pairs": pairs}[group][leaf] = v
    if opt:
        top["opt"] = model.opt.replace(**opt)
    if pairs:
        top["pairs"] = model.pairs.replace(**pairs)
    return model.replace(**top)


def env_model(base: Model, batched: Model, leaves, static: Dict[str, str]) -> Model:
    """``batched`` checked and marked as a per-env model of ``base``: the
    leaves named in ``leaves`` carry a leading axis of one value per env
    (the same count for all), every other leaf is ``base``'s shape. A leaf
    in ``static`` (name -> what reads it as a per-model constant on the
    model's solve path: ``solver.static_leaves``) raises by name; the JAX
    package reads it as a constant there too, so it cannot randomize it
    either. The result has an empty cache."""
    leaves = frozenset(leaves)
    known = param_leaves()
    for name in sorted(leaves):
        if name not in known:
            raise ValueError(f"{name!r} is not a parameter leaf of the model ({known})")
        if name in static:
            raise NotImplementedError(
                f"a per-env {name}: {static[name]} reads it as one value per model; "
                "the JAX package reads it the same way, so it cannot randomize it either "
                "(ROADMAP.md §A.12, not to port)"
            )
    counts = {batched.leaf(n).shape[0] for n in leaves if batched.leaf(n).dim()}
    if len(counts) != 1:
        raise ValueError(f"the per-env leaves must share one env count, got {sorted(counts)}")
    nenv = counts.pop()
    for name in known:
        want = base.leaf(name).shape
        if name in leaves:
            want = (nenv,) + tuple(want)
        got = batched.leaf(name).shape
        if tuple(got) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(got)}, expected {tuple(want)}")
    return batched.replace(env_leaves=leaves, nenv=nenv)


@dataclasses.dataclass
class Data:
    """Per-step simulation state of a batch of envs, batch-first."""

    qpos: torch.Tensor  # (B, nq)
    qvel: torch.Tensor  # (B, nv)
    act: torch.Tensor  # (B, na)
    time: torch.Tensor  # (B,)
    ctrl: torch.Tensor  # (B, nu)
    # position stage
    xpos: Optional[torch.Tensor] = None  # (B, nbody, 3)
    xquat: Optional[torch.Tensor] = None  # (B, nbody, 4)
    xipos: Optional[torch.Tensor] = None  # (B, nbody, 3)
    xanchor: Optional[torch.Tensor] = None  # (B, njnt, 3)
    xaxis: Optional[torch.Tensor] = None  # (B, njnt, 3)
    geom_xpos: Optional[torch.Tensor] = None  # (B, ngeom, 3)
    geom_xquat: Optional[torch.Tensor] = None  # (B, ngeom, 4)
    site_xpos: Optional[torch.Tensor] = None  # (B, nsite, 3)
    site_xquat: Optional[torch.Tensor] = None  # (B, nsite, 4)
    subtree_com: Optional[torch.Tensor] = None  # (B, nbody, 3)
    cinert_s: Optional[torch.Tensor] = None  # (B, 6, nbody) [xx,yy,zz,xy,xz,yz]
    cinert_h: Optional[torch.Tensor] = None  # (B, 3, nbody)
    cdof: Optional[torch.Tensor] = None  # (B, 6, nv)
    ten_length: Optional[torch.Tensor] = None  # (B, ntendon)
    ten_J: Optional[torch.Tensor] = None  # (B, ntendon, nv)
    # velocity stage
    cvel: Optional[torch.Tensor] = None  # (B, 6, nbody)
    cdof_dot: Optional[torch.Tensor] = None  # (B, 6, nv)
    # dynamics: crb_f is the low-rank qM factor (qM = masksym(f^T cdof) +
    # diag(armature)); the solve kernel assembles qM from it
    crb_f: Optional[torch.Tensor] = None  # (B, 6, nv)
    # dense mass matrix and inverses: only on the solve paths outside the
    # kernel layout (dynamics.crb / invert_m)
    qM: Optional[torch.Tensor] = None  # (B, nv, nv)
    qMinv: Optional[torch.Tensor] = None  # (B, nv, nv) M^-1 (CG path)
    qMhinv: Optional[torch.Tensor] = None  # (B, nv, nv) (M + h diag(damping))^-1
    qLD: Optional[torch.Tensor] = None  # (B, nv, nv) upper Cholesky factor, qM = U^T U
    qfrc_bias: Optional[torch.Tensor] = None  # (B, nv)
    qfrc_passive: Optional[torch.Tensor] = None  # (B, nv)
    qfrc_actuator: Optional[torch.Tensor] = None  # (B, nv)
    actuator_force: Optional[torch.Tensor] = None  # (B, nu)
    act_dot: Optional[torch.Tensor] = None  # (B, na)
    qfrc_smooth: Optional[torch.Tensor] = None  # (B, nv)
    qacc_smooth: Optional[torch.Tensor] = None  # (B, nv)
    # contacts (fixed slot count)
    contact_dist: Optional[torch.Tensor] = None  # (B, ncon)
    contact_pos: Optional[torch.Tensor] = None  # (B, ncon, 3)
    contact_frame: Optional[torch.Tensor] = None  # (B, ncon, 3, 3)
    con_A: Optional[torch.Tensor] = None  # (B, nroots, ncon, 3, 6)
    # constraint rows (static layout; scalar limits, ball limits, then
    # contacts). On the kernel path the dense jacobian is never
    # materialized: the solve kernel assembles it from con_A, cdof and the
    # static row tables (ops/cg.py). Off it, the rows after the scalar
    # limits are the dense block efc_Jc.
    efc_Jc: Optional[torch.Tensor] = None  # (B, nefc - nlim, nv)
    efc_jsign: Optional[torch.Tensor] = None  # (B, nlim)
    efc_D: Optional[torch.Tensor] = None  # (B, nefc)
    efc_aref: Optional[torch.Tensor] = None  # (B, nefc)
    efc_pos: Optional[torch.Tensor] = None  # (B, nefc)
    efc_margin: Optional[torch.Tensor] = None  # (B, nefc)
    # solve products
    efc_force: Optional[torch.Tensor] = None  # (B, nefc)
    qfrc_constraint: Optional[torch.Tensor] = None  # (B, nv)
    qacc: Optional[torch.Tensor] = None  # (B, nv)
    qvel_next: Optional[torch.Tensor] = None  # (B, nv) Euler velocity update
    # Newton iterations each env ran (the batch loop runs max of them)
    solver_niter: Optional[torch.Tensor] = None  # (B,) int
    # solve-kernel chunks the batch ran (Newton on the kernel layout), a
    # count the dispatch holds on the host
    solver_nchunk: Optional[int] = None
    # the next solve's warm start (mj_forward copies qacc here); None after
    # make_data, so the first solve starts cold
    qacc_warmstart: Optional[torch.Tensor] = None  # (B, nv)
    # sensors, after the solve (physics/sensor.py)
    sensordata: Optional[torch.Tensor] = None  # (B, nsensordata)

    def replace(self, **kwargs) -> "Data":
        return dataclasses.replace(self, **kwargs)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The tensor fields that are set, by name."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
