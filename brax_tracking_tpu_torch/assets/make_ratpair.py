"""Writes ``ratpair.xml`` and ``ratpair_elliptic.xml``, a two-rat stand-in
at the sizes of the rodent_pair scene (configs/dataset/rodent_pair.yaml),
``rat.xml``, one of its rats alone on the floor, and
``rodent_standin.xml``, a stand-in for the flagship rodent.

    python -m brax_tracking_tpu_torch.assets.make_ratpair [--freeze]

``--freeze`` then freezes them as the port loads them (``freeze``; needs
the ``mujoco`` bindings). The pair's own MJCF is not in this repository, so the pair path is built
and held on this fixture. It matches the pair's sizes: two free roots,
nq = 148, nv = 146 (134 hinges), nbody = 133, ngeom = 201, nu = 60, and
114 contact slots that give nefc = 590 under pyramidal condim-3 contacts
(4 rows per slot plus one row per limited hinge). It uses only what the
port covers: capsules, a plane, limited hinges, motors, condim-3 contacts;
no damping, sensors or other pair types.

Each rat is a tree of 66 bodies (a torso with the free joint, a lumbar
chain to the pelvis, a tail of 24 segments, a neck, a skull with a jaw and
two ears, four legs with three digits each) carrying 67 hinges and 100
capsules. The collision filter makes 57 candidate geom pairs, two contact
slots each:
- 12 geoms of each rat touch the floor (``conaffinity`` bit 1 against the
  floor's ``contype`` 1): both feet, their six toes, both hands, the belly
  and the pelvis;
- 3 geoms of rat 0 (skull and hands, ``contype`` bit 2) against 12 geoms of
  rat 1 (torso, pelvis, skull, jaw and the upper limbs, ``conaffinity``
  bit 2), less the three pairs that two ``<exclude>`` body pairs remove
  (rat 0's skull against rat 1's skull, two geoms, and jaw): 33 cross-body
  pairs between the two roots.

``rat.xml`` is rat 0 alone (nq 74, nv 73 = 6 + 67 hinges: the rodent's
width, whose MJCF is not in the repository either), its 12 floor geoms
against the floor (24 contact slots, 163 rows under pyramidal CG 4/4) and
its 30 motors: a stand-in at the flagship rodent's width for the solve
kernel's wide layout 1.

``rodent_standin.xml`` stands in for the flagship rodent
(configs/dataset/rodent.yaml; its MJCF is not in this repository either):
its sizes (nq 74, nv 73 = 6 + 67 hinges, nbody 67, njnt 68, ngeom 101,
nsite 21, nu = na = 38), every body and joint name the config looks up, and
its kinds of features: per-class joint damping and armature, four
unlimited fixed tendons, 38 ``<general>`` actuators with filter dynamics and
an affine bias (position servos, four of them on the tendons), touch
sensors on the feet and hands, an accelerometer, a velocimeter and a gyro
on a torso site and the torso's subtree linear velocity, and floor contacts
through plane-capsule, plane-sphere and plane-ellipsoid pairs (13 floor
geoms, 17 contact slots, 135 rows under pyramidal CG 4/4 with the 67
limited hinges). The config rescales the subtree under the torso by 0.9;
after that the feet and hands hover 4-7 mm above the floor at qpos0.

``rodent_standin_pair.xml`` is the render scene of the rodent configs'
``rendering_mjcf`` (the reference's ``rodent_pair.xml`` is not in this
repository either): two rodent stand-ins, unscaled, every name suffixed
``-0`` and ``-1``, the reference clip's body first (nq 2 x 74, so a
rollout of the 74-wide env takes the render's pair branch), each in its
own colour, with no actuators, tendons or sensors. Camera 0 is fixed in
the world; camera 1 tracks the rollout body's subtree CoM (``trackcom`` on
``torso-1``), the one the configs' ``camera: 1`` selects.
"""

from __future__ import annotations

import math
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
FLOOR_BIT, CROSS_BIT = 1, 2
TAIL_SEGMENTS = 24
# rat 1's geoms that rat 0's skull and hands can touch
CROSS_TARGETS = ("torso_g1", "torso_g2", "torso_g3", "pelvis_g1", "pelvis_g2", "skull_g1",
                 "skull_g2", "jaw_g", "upper_arm_L_g", "upper_arm_R_g", "upper_leg_L_g",
                 "upper_leg_R_g")
CROSS_SOURCES = ("skull_g1", "hand_L_g", "hand_R_g")
FLOOR_GEOMS = ("foot_L_g", "foot_R_g", "hand_L_g", "hand_R_g", "torso_g2", "pelvis_g1") + tuple(
    f"toe_{side}{k}_g" for side in "LR" for k in range(3))
# body pairs whose contacts <exclude> removes
EXCLUDES = (("skull-0", "skull-1"), ("skull-0", "jaw-1"))
# 30 motors per rat, on these hinges (nu = 60 as the rodent pair)
MOTORS = (
    "vertebra_1_extend", "vertebra_1_bend", "vertebra_3_extend", "atlas", "cervical_2_extend",
    "hip_L_supinate", "hip_L_abduct", "hip_L_extend", "knee_L", "ankle_L",
    "hip_R_supinate", "hip_R_abduct", "hip_R_extend", "knee_R", "ankle_R",
    "scapula_L_extend", "shoulder_L", "elbow_L", "wrist_L",
    "scapula_R_extend", "shoulder_R", "elbow_R", "wrist_R",
    "caudal_0", "caudal_1", "caudal_2", "pelvis_tilt", "vertebra_4_bend", "toe_L0", "toe_R0",
)


class _Bodies:
    """Nested ``<body>`` XML as it is written, indented inside worldbody."""

    def __init__(self):
        self.lines = []
        self.depth = 2

    def _emit(self, text: str):
        self.lines.append("  " * self.depth + text)

    def close(self, n: int = 1):
        for _ in range(n):
            self.depth -= 1
            self._emit("</body>")


class _Rat(_Bodies):
    """One rat's bodies as nested XML, with the suffix and the collision
    bits of rat ``idx``."""

    def __init__(self, idx: int):
        super().__init__()
        self.idx = idx
        self.suffix = f"-{idx}"

    def _bits(self, geom: str):
        contype, conaff = 0, 0
        if geom in FLOOR_GEOMS:
            conaff |= FLOOR_BIT
        if self.idx == 0 and geom in CROSS_SOURCES:
            contype |= CROSS_BIT
        if self.idx == 1 and geom in CROSS_TARGETS:
            conaff |= CROSS_BIT
        return contype, conaff

    def open(self, name: str, pos, joints=()):
        self._emit(f'<body name="{name}{self.suffix}" pos="{_v(pos)}">')
        self.depth += 1
        for jname, axis, lo, hi in joints:
            self._emit(f'<joint name="{jname}{self.suffix}" axis="{_v(axis)}" '
                       f'range="{lo} {hi}"/>')

    def geom(self, name: str, a, b, r):
        contype, conaff = self._bits(name)
        self._emit(f'<geom name="{name}{self.suffix}" fromto="{_v(a)} {_v(b)}" size="{r}" '
                   f'contype="{contype}" conaffinity="{conaff}"/>')

    def build(self, y0: float):
        # at qpos0 the feet and hands hover 5 mm above the floor, as the
        # minirat's legs do: a reset at the clip's first pose falls before
        # it touches
        self._emit(f'<body name="torso{self.suffix}" pos="0 {y0} 0.072">')
        self.depth += 1
        self._emit(f'<freejoint name="root{self.suffix}"/>')
        self.geom("torso_g1", (-0.03, 0, 0), (0.03, 0, 0), 0.025)
        self.geom("torso_g2", (-0.02, 0, -0.01), (0.02, 0, -0.01), 0.02)
        self.geom("torso_g3", (0.03, 0, 0), (0.045, 0, 0), 0.018)
        self._spine()
        self._neck()
        for side, s in (("L", 1), ("R", -1)):
            self._foreleg(side, s)
        self.close()
        return self.lines

    def _spine(self):
        # lumbar chain behind the torso, then the pelvis with legs and tail
        joints = [("vertebra_1_extend", (0, 1, 0), -30, 30), ("vertebra_1_bend", (0, 0, 1), -30, 30)]
        self.open("vertebra_1", (-0.035, 0, 0), joints)
        self.geom("vertebra_1_g", (0, 0, 0), (-0.012, 0, 0), 0.018)
        for k in range(2, 7):
            axis, kind = ((0, 1, 0), "extend") if k % 2 else ((0, 0, 1), "bend")
            self.open(f"vertebra_{k}", (-0.012, 0, 0), [(f"vertebra_{k}_{kind}", axis, -20, 20)])
            self.geom(f"vertebra_{k}_g", (0, 0, 0), (-0.012, 0, 0), 0.018)
        self.open("pelvis", (-0.012, 0, 0), [("pelvis_tilt", (1, 0, 0), -20, 20)])
        self.geom("pelvis_g1", (0, 0, 0), (-0.03, 0, 0), 0.022)
        self.geom("pelvis_g2", (-0.015, -0.02, 0), (-0.015, 0.02, 0), 0.012)
        for side, s in (("L", 1), ("R", -1)):
            self._hindleg(side, s)
        self._tail()
        for _ in range(7):  # pelvis and the six vertebrae
            self.close()

    def _hindleg(self, side: str, s: int):
        self.open(f"upper_leg_{side}", (-0.015, s * 0.022, 0), [
            (f"hip_{side}_supinate", (1, 0, 0), -30, 30),
            (f"hip_{side}_abduct", (0, 0, 1), -30, 30),
            (f"hip_{side}_extend", (0, 1, 0), -60, 60)])
        self.geom(f"upper_leg_{side}_g", (0, 0, 0), (0.01, 0, -0.03), 0.008)
        self.geom(f"upper_leg_{side}_g2", (0, 0, 0), (0.008, 0, -0.02), 0.007)
        self.open(f"lower_leg_{side}", (0.01, 0, -0.03), [(f"knee_{side}", (0, 1, 0), -90, 10)])
        self.geom(f"lower_leg_{side}_g", (0, 0, 0), (-0.012, 0, -0.03), 0.006)
        self.geom(f"lower_leg_{side}_g2", (0, 0, 0), (-0.008, 0, -0.02), 0.005)
        self.open(f"foot_{side}", (-0.012, 0, -0.03), [(f"ankle_{side}", (0, 1, 0), -45, 45)])
        self.geom(f"foot_{side}_g", (0, 0, 0), (0.018, 0, -0.003), 0.004)
        for k in range(3):
            dy = (k - 1) * 0.004
            self.open(f"toe_{side}{k}", (0.018, dy, -0.003), [(f"toe_{side}{k}", (0, 1, 0), -30, 30)])
            self.geom(f"toe_{side}{k}_g", (0, 0, 0), (0.007, 0, 0), 0.0025)
            self.close()
        for _ in range(3):
            self.close()

    def _tail(self):
        for k in range(TAIL_SEGMENTS):
            axis = (0, 1, 0) if k % 2 == 0 else (0, 0, 1)
            pos = (-0.03, 0, 0) if k == 0 else (-0.01, 0, 0)
            r = 0.005 - 0.003 * k / (TAIL_SEGMENTS - 1)
            self.open(f"caudal_{k}", pos, [(f"caudal_{k}", axis, -25, 25)])
            self.geom(f"caudal_{k}_g", (0, 0, 0), (-0.01, 0, 0), round(r, 5))
            self.geom(f"caudal_{k}_g2", (-0.003, 0, 0), (-0.007, 0, 0), round(0.8 * r, 5))
        for _ in range(TAIL_SEGMENTS):
            self.close()

    def _neck(self):
        self.open("cervical_1", (0.045, 0, 0.005), [("cervical_1_extend", (0, 1, 0), -30, 30)])
        self.geom("cervical_1_g", (0, 0, 0), (0.01, 0, 0.003), 0.012)
        for k in range(2, 5):
            axis, kind = ((0, 1, 0), "extend") if k % 2 == 0 else ((0, 0, 1), "bend")
            self.open(f"cervical_{k}", (0.01, 0, 0.003), [(f"cervical_{k}_{kind}", axis, -30, 30)])
            self.geom(f"cervical_{k}_g", (0, 0, 0), (0.01, 0, 0.003), 0.011)
        self.open("skull", (0.01, 0, 0.003), [("atlas", (0, 1, 0), -45, 45)])
        self.geom("skull_g1", (0, 0, 0), (0.03, 0, -0.005), 0.013)
        self.geom("skull_g2", (0.03, 0, -0.005), (0.045, 0, -0.01), 0.007)
        self.open("jaw", (0.01, 0, -0.01))  # welded to the skull
        self.geom("jaw_g", (0, 0, 0), (0.03, 0, -0.004), 0.005)
        self.close()
        for side, s in (("L", 1), ("R", -1)):
            self.open(f"ear_{side}", (0.008, s * 0.01, 0.01))  # welded to the skull
            self.geom(f"ear_{side}_g", (0, 0, 0), (-0.004, s * 0.004, 0.008), 0.003)
            self.close()
        for _ in range(5):  # skull and four cervical vertebrae
            self.close()

    def _foreleg(self, side: str, s: int):
        self.open(f"scapula_{side}", (0.025, s * 0.018, -0.005),
                  [(f"scapula_{side}_extend", (0, 1, 0), -30, 30)])
        self.geom(f"scapula_{side}_g", (0, 0, 0), (0, s * 0.003, -0.015), 0.007)
        self.open(f"upper_arm_{side}", (0, s * 0.003, -0.015), [(f"shoulder_{side}", (0, 1, 0), -60, 60)])
        self.geom(f"upper_arm_{side}_g", (0, 0, 0), (-0.005, 0, -0.02), 0.006)
        self.geom(f"upper_arm_{side}_g2", (0, 0, 0), (-0.003, 0, -0.012), 0.005)
        self.open(f"lower_arm_{side}", (-0.005, 0, -0.02), [(f"elbow_{side}", (0, 1, 0), -10, 90)])
        self.geom(f"lower_arm_{side}_g", (0, 0, 0), (0.004, 0, -0.02), 0.005)
        self.open(f"hand_{side}", (0.004, 0, -0.02), [(f"wrist_{side}", (0, 1, 0), -45, 45)])
        self.geom(f"hand_{side}_g", (0, 0, 0), (0.01, 0, -0.003), 0.004)
        for k in range(3):
            dy = (k - 1) * 0.003
            self.open(f"finger_{side}{k}", (0.01, dy, -0.003),
                      [(f"finger_{side}{k}", (0, 1, 0), -30, 30)])
            self.geom(f"finger_{side}{k}_g", (0, 0, 0), (0.006, 0, 0), 0.0025)
            self.close()
        for _ in range(4):
            self.close()


def _v(xs) -> str:
    return " ".join(f"{x:g}" for x in xs)


def ratpair_xml(cone: str = "pyramidal", rats: int = 2) -> str:
    """The stand-in's MJCF text; ``cone`` "elliptic" gives the same model
    with elliptic friction cones, ``rats`` 1 rat 0 alone (``rat.xml``)."""
    cone_attr = ' cone="elliptic"' if cone == "elliptic" else ""
    what = ("Two-rat stand-in for the rodent_pair scene at its sizes" if rats == 2
            else "One rat of the two-rat stand-in, alone on the floor")
    lines = [
        f"<!-- {what}; written by",
        "     brax_tracking_tpu_torch/assets/make_ratpair.py (edit that, not this). -->",
        f'<mujoco model="{"ratpair" if rats == 2 else "rat"}">',
        f'  <option timestep="0.002" iterations="4" ls_iterations="4" solver="CG"{cone_attr}/>',
        "  <default>",
        '    <joint armature="5e-5"/>',
        '    <geom type="capsule"/>',
        '    <motor gear="0.02" ctrlrange="-1 1"/>',
        "  </default>",
        "  <worldbody>",
        f'    <geom name="floor" type="plane" size="2 2 .1" contype="{FLOOR_BIT}" '
        f'conaffinity="0"/>',
    ]
    for idx, y0 in ((0, 0.06), (1, -0.06))[:rats]:
        lines += _Rat(idx).build(y0)
    lines.append("  </worldbody>")
    if rats == 2:
        lines.append("  <contact>")
        lines += [f'    <exclude body1="{a}" body2="{b}"/>' for a, b in EXCLUDES]
        lines.append("  </contact>")
    lines.append("  <actuator>")
    lines += [f'    <motor name="{j}-{i}" joint="{j}-{i}"/>' for i in range(rats) for j in MOTORS]
    lines.append("  </actuator>")
    lines.append("</mujoco>")
    return "\n".join(lines) + "\n"


# the files write() makes: name, cone, rats
FILES = (("ratpair.xml", "pyramidal", 2), ("ratpair_elliptic.xml", "elliptic", 2),
         ("rat.xml", "pyramidal", 1))
STANDIN = "rodent_standin.xml"


# ---------------------------------------------------------------------------
# the rodent stand-in
# ---------------------------------------------------------------------------

# the torso's height at qpos0; the rescale leaves it and lifts the limbs
STANDIN_TORSO_Z = 0.065
# joint classes: damping, armature, servo gain (N m per rad, also the force
# limit)
STANDIN_CLASSES = {
    "spine": (0.02, 2e-4, 0.05),
    "tail": (0.002, 2e-5, 0.005),
    "limb": (0.01, 1e-4, 0.03),
    "head": (0.005, 5e-5, 0.01),
    "digit": (0.001, 1e-5, 0.002),
}
# the 38 actuators: four on the fixed tendons, 34 on hinges (name = target)
STANDIN_TENDON_ACTUATORS = ("spine_extend", "spine_bend", "tail_extend", "tail_bend")
STANDIN_JOINT_ACTUATORS = (
    "vertebra_3_twist", "vertebra_cervical_3_twist", "vertebra_axis_twist",
    "vertebra_atlant_extend", "atlas", "mandible",
) + tuple(j for s in "LR" for j in (
    f"hip_{s}_supinate", f"hip_{s}_abduct", f"hip_{s}_extend", f"knee_{s}", f"ankle_{s}",
    f"toe_{s}", f"scapula_{s}_supinate", f"scapula_{s}_abduct", f"scapula_{s}_extend",
    f"shoulder_{s}", f"shoulder_sup_{s}", f"elbow_{s}", f"wrist_{s}", f"finger_{s}"))
# the tail: 24 vertebrae, each with one hinge (the config's 18 and six more)
STANDIN_TAIL = (
    "C1_extend", "C2_bend", "C3_extend", "C4_extend", "C5_bend", "C6_extend", "C7_extend",
    "C8_bend", "C9_bend", "C10_extend", "C11_extend", "C12_bend", "C13_bend", "C14_extend",
    "C15_extend", "C16_bend", "C17_bend", "C18_extend", "C19_extend", "C21_bend",
    "C23_extend", "C25_bend", "C27_extend", "C29_bend")
_AXES = {"extend": (0, 1, 0), "bend": (0, 0, 1), "twist": (1, 0, 0), "supinate": (1, 0, 0),
         "abduct": (0, 0, 1)}


# ---------------------------------------------------------------------------
# the rodent stand-in on a terrain
# ---------------------------------------------------------------------------

TERRAIN = "rodent_standin_terrain.xml"
PAIR_TERRAIN = "rodent_standin_terrain_pair.xml"
# the terrain's contype bits: the box, the cylinder and the rocks, and the
# height field; the limbs' spheres and capsules carry both in conaffinity,
# the hand ellipsoids only the first (the JAX table has no hfield-ellipsoid)
TERRAIN_BIT, HFIELD_BIT = 4, 8
# the terrain's tops: 2.5-3.5 mm above the limbs' lowest points at the
# rescaled qpos0, so every limb over a piece touches it from the first
# substep
TERRAIN_TOP = 0.009


def _hull(rx, ry, rz, rings=3, around=8):
    """Vertices of a coarse ellipsoid (rings of ``around`` points and both
    poles): a convex mesh MuJoCo meshes from its hull."""
    pts = [(0.0, 0.0, rz), (0.0, 0.0, -rz)]
    for i in range(1, rings + 1):
        th = math.pi * i / (rings + 1)
        for j in range(around):
            ph = 2.0 * math.pi * (j + 0.5 * (i % 2)) / around
            pts.append((rx * math.sin(th) * math.cos(ph), ry * math.sin(th) * math.sin(ph),
                        rz * math.cos(th)))
    return pts


# the visual meshes (skin and bone, as the real rodent's): vertices
VISUAL_MESH_VERTS = {
    "skin": _hull(0.04, 0.026, 0.024),
    "hip": _hull(0.028, 0.022, 0.02),
    "head": _hull(0.026, 0.015, 0.014),
    "bone": _hull(0.003, 0.003, 0.014, rings=2, around=6),
}
# body -> (mesh, position in the body), on the terrain scene only; never
# colliding and massless (class "visual")
VISUAL_MESHES = {
    "torso": ("skin", (0, 0, 0)),
    "pelvis": ("hip", (-0.015, 0, 0)),
    "skull": ("head", (0.02, 0, -0.003)),
    "upper_leg_L": ("bone", (0.005, 0, -0.015)),
    "upper_leg_R": ("bone", (0.005, 0, -0.015)),
    "upper_arm_L": ("bone", (-0.0025, 0, -0.01)),
    "upper_arm_R": ("bone", (-0.0025, 0, -0.01)),
}
# a convex rock: a top (one corner lower) over a wider base, a bulge on a side
ROCK_VERTS = (
    (0.0161, 0.0165, TERRAIN_TOP), (0.0161, -0.0165, TERRAIN_TOP),
    (-0.0161, 0.0165, TERRAIN_TOP), (-0.0161, -0.0165, TERRAIN_TOP - 0.0015),
    (0.0175, 0.018, -0.004), (0.0175, -0.018, -0.004), (-0.0175, 0.018, -0.004),
    (-0.0175, -0.018, -0.004), (0.0, 0.0195, 0.003),
)
# the height field under the left heel: 5 rows (y) x 7 columns (x), 1 cm
# apart, its top (1.0 x TERRAIN_TOP) under the heel and the foot's back end
HFIELD_ELEVATION = (
    (0.0, 0.3, 0.6, 0.8, 0.8, 0.7, 0.5),
    (0.2, 0.5, 0.8, 1.0, 1.0, 1.0, 0.8),
    (0.3, 0.6, 0.9, 1.0, 1.0, 1.0, 0.9),
    (0.2, 0.5, 0.8, 1.0, 1.0, 1.0, 0.8),
    (0.1, 0.3, 0.6, 0.8, 0.9, 0.7, 0.4),
)
# the terrain under the rescaled stand-in at qpos0 (the limbs at x -0.103 to
# -0.078 behind and 0.020 to 0.036 in front, y +-0.019): on the left a box
# step from the foot's middle to past the finger and the height field under
# the heel; on the right a cylinder (a log along x) from the foot's middle to
# the hand's middle, a rock behind it under the heel and one in front under
# the finger. So each foot capsule and the right hand straddle two pieces.
TERRAIN_GEOMS = (
    '<geom name="step" type="box" class="terrain" pos="-0.02385 0.02 0.0045" '
    'size="0.06885 0.016 0.0045"/>',
    '<geom name="log" type="cylinder" class="terrain" pos="-0.03335 -0.0195 -0.003" '
    'size="0.012 0.05935" euler="0 90 0"/>',
    '<geom name="rock_back" type="mesh" mesh="rock" class="terrain" pos="-0.10885 -0.0195 0"/>',
    '<geom name="rock_front" type="mesh" mesh="rock" class="terrain" pos="0.0421 -0.0195 0"/>',
    '<geom name="bumps" type="hfield" hfield="bumps" class="terrain_hfield" '
    'pos="-0.115 0.0195 0"/>',
)


def _terrain_assets():
    """The terrain scenes' <asset> block: the visual meshes, the rock and the
    height field, inline."""
    lines = ["  <asset>"]
    for name, verts in VISUAL_MESH_VERTS.items():
        lines.append(f'    <mesh name="{name}" vertex="{" ".join(_v(p) for p in verts)}"/>')
    lines.append(f'    <mesh name="rock" vertex="{" ".join(_v(p) for p in ROCK_VERTS)}"/>')
    lines.append(f'    <hfield name="bumps" nrow="{len(HFIELD_ELEVATION)}" '
                 f'ncol="{len(HFIELD_ELEVATION[0])}" size="0.03 0.02 {TERRAIN_TOP:g} 0.004" '
                 f'elevation="{" ".join(_v(r) for r in HFIELD_ELEVATION)}"/>')
    return lines + ["  </asset>"]


def _terrain_defaults(lines):
    """The rodent stand-in's <default> block with the terrain's classes."""
    probe = FLOOR_BIT | TERRAIN_BIT | HFIELD_BIT
    return lines[:-1] + [
        f'    <default class="foot_hold"><geom conaffinity="{probe}"/></default>',
        f'    <default class="hand_hold"><geom conaffinity="{FLOOR_BIT | TERRAIN_BIT}"/></default>',
        f'    <default class="terrain"><geom contype="{TERRAIN_BIT}" conaffinity="0" '
        'rgba="0.55 0.5 0.45 1"/></default>',
        f'    <default class="terrain_hfield"><geom contype="{HFIELD_BIT}" conaffinity="0" '
        'rgba="0.45 0.55 0.4 1"/></default>',
        '    <default class="visual"><geom type="mesh" contype="0" conaffinity="0" density="0" '
        'rgba="0.8 0.7 0.6 1"/></default>',
    ] + lines[-1:]


class _Rodent(_Bodies):
    """The stand-in's bodies as nested XML; ``joint_class`` maps each hinge
    to its default class. With ``terrain`` the limbs' floor geoms also touch
    the terrain (TERRAIN_CLASSES) and VISUAL_MESHES dress the bodies."""

    def __init__(self, terrain: bool = False):
        super().__init__()
        self.joint_class = {}
        self.terrain = terrain

    def open(self, name: str, pos, joints=(), cls="limb"):
        """A body with hinges (name, axis, lo, hi) of joint class ``cls``."""
        self._emit(f'<body name="{name}" pos="{_v(pos)}">')
        self.depth += 1
        for jname, axis, lo, hi in joints:
            self.joint_class[jname] = cls
            self._emit(f'<joint name="{jname}" class="{cls}" axis="{_v(axis)}" '
                       f'range="{lo} {hi}"/>')
        self._skin(name)

    def _skin(self, body: str):
        """The body's visual mesh on the terrain scene."""
        if self.terrain and body in VISUAL_MESHES:
            mesh, at = VISUAL_MESHES[body]
            self._emit(f'<geom name="{body}_skin" class="visual" mesh="{mesh}" pos="{_v(at)}"/>')

    def _cls(self, floor, kind):
        """The class attribute of a floor geom: a limb's on the terrain
        scene touches the terrain too."""
        if not floor:
            return "/>"
        if self.terrain and floor == "limb":
            return f' class="{"hand_hold" if kind == "ellipsoid" else "foot_hold"}"/>'
        return ' class="floor"/>'

    def capsule(self, name, a, b, r, floor=False):
        self._emit(f'<geom name="{name}" fromto="{_v(a)} {_v(b)}" size="{r}"'
                   + self._cls(floor, "capsule"))

    def sphere(self, name, pos, r, floor=False):
        self._emit(f'<geom name="{name}" type="sphere" pos="{_v(pos)}" size="{r}"'
                   + self._cls(floor, "sphere"))

    def ellipsoid(self, name, pos, size, floor=False):
        self._emit(f'<geom name="{name}" type="ellipsoid" pos="{_v(pos)}" size="{_v(size)}"'
                   + self._cls(floor, "ellipsoid"))

    def site(self, name, pos, size=None):
        box = f' type="box" size="{_v(size)}"' if size is not None else ""
        self._emit(f'<site name="{name}" pos="{_v(pos)}"{box}/>')

    def build(self, y0: float = 0.0):
        self._emit(f'<body name="torso" pos="0 {y0:g} {STANDIN_TORSO_Z}">')
        self.depth += 1
        self._emit('<freejoint name="free"/>')
        self._skin("torso")
        self.ellipsoid("torso_belly", (0, 0, -0.005), (0.035, 0.022, 0.02), floor=True)
        self.capsule("torso_back", (-0.025, 0, 0.005), (0.025, 0, 0.005), 0.018)
        self.capsule("torso_neck", (0.025, 0, 0.005), (0.04, 0, 0.006), 0.014)
        self.site("torso_imu", (0, 0, 0.01))
        self.site("marker_torso", (0, 0, 0.025))
        self.open("sternum", (0.03, 0, -0.01))  # welded to the torso
        self.sphere("sternum_g", (0, 0, 0), 0.012)
        self.close()
        self._lumbar()
        self._neck()
        for side, s in (("L", 1), ("R", -1)):
            self._foreleg(side, s)
        self.close()
        return self.lines

    def _lumbar(self):
        x = (-0.035, 0, 0)
        for k, kind in enumerate(("extend", "bend", "twist") * 2, start=1):
            self.open(f"vertebra_{k}", x, [(f"vertebra_{k}_{kind}", _AXES[kind], -20, 20)],
                      "spine")
            self.capsule(f"vertebra_{k}_g", (0, 0, 0), (-0.01, 0, 0), 0.016)
            if k == 3:
                self.site("marker_vertebra_3", (-0.005, 0, 0.016))
            x = (-0.01, 0, 0)
        self.open("pelvis", (-0.01, 0, 0))  # welded to vertebra_6
        self.ellipsoid("pelvis_g", (-0.015, 0, -0.003), (0.025, 0.02, 0.017), floor=True)
        self.capsule("pelvis_g2", (-0.015, -0.02, 0), (-0.015, 0.02, 0), 0.01)
        self.site("marker_pelvis", (-0.015, 0, 0.017))
        for side, s in (("L", 1), ("R", -1)):
            self._hindleg(side, s)
        self._tail()
        self.close(7)  # pelvis and the six lumbar vertebrae

    def _hindleg(self, side: str, s: int):
        self.open(f"upper_leg_{side}", (-0.015, s * 0.022, 0), [
            (f"hip_{side}_supinate", _AXES["supinate"], -30, 30),
            (f"hip_{side}_abduct", _AXES["abduct"], -30, 30),
            (f"hip_{side}_extend", _AXES["extend"], -60, 60)])
        self.capsule(f"upper_leg_{side}_g", (0, 0, 0), (0.01, 0, -0.03), 0.008)
        self.capsule(f"upper_leg_{side}_g2", (0, 0, 0), (0.008, 0, -0.02), 0.007)
        self.site(f"marker_upper_leg_{side}", (0.005, s * 0.008, -0.015))
        self.open(f"lower_leg_{side}", (0.01, 0, -0.03), [(f"knee_{side}", _AXES["extend"], -90, 10)])
        self.capsule(f"lower_leg_{side}_g", (0, 0, 0), (-0.012, 0, -0.03), 0.006)
        self.capsule(f"lower_leg_{side}_g2", (0, 0, 0), (-0.008, 0, -0.02), 0.005)
        self.site(f"marker_lower_leg_{side}", (-0.006, s * 0.006, -0.015))
        self.open(f"foot_{side}", (-0.012, 0, -0.03), [(f"ankle_{side}", _AXES["extend"], -45, 45)])
        self.capsule(f"foot_{side}_g", (0, 0, 0), (0.018, 0, -0.003), 0.004, floor="limb")
        self.site(f"sole_{side}", (0.009, 0, -0.003), (0.013, 0.005, 0.004))
        self.open(f"heel_{side}", (-0.002, 0, -0.001))  # welded to the foot
        self.sphere(f"heel_{side}_g", (0, 0, 0), 0.004, floor="limb")
        self.close()
        self.open(f"toe_{side}", (0.018, 0, -0.003), [(f"toe_{side}", _AXES["extend"], -30, 30)],
                  "digit")
        self.sphere(f"toe_{side}_g", (0.004, 0, 0), 0.003, floor="limb")
        self.close(4)  # toe, foot, lower and upper leg

    def _tail(self):
        for k, joint in enumerate(STANDIN_TAIL):
            name = "vertebra_" + joint.split("_")[0]
            kind = joint.split("_")[1]
            r = round(0.005 - 0.003 * k / (len(STANDIN_TAIL) - 1), 5)
            self.open(name, (-0.03, 0, 0) if k == 0 else (-0.01, 0, 0),
                      [("vertebra_" + joint, _AXES[kind], -25, 25)], "tail")
            self.capsule(f"{name}_g", (0, 0, 0), (-0.01, 0, 0), r)
            self.sphere(f"{name}_g2", (-0.005, 0, 0), round(1.1 * r, 5))
            if joint == "C11_extend":
                self.site("marker_tail_mid", (-0.005, 0, r))
        self.open("tail_tip", (-0.01, 0, 0))  # welded to the last vertebra
        self.sphere("tail_tip_g", (0, 0, 0), 0.002)
        self.site("marker_tail_tip", (-0.002, 0, 0))
        self.close(len(STANDIN_TAIL) + 1)

    def _neck(self):
        chain = (("vertebra_cervical_5", "extend"), ("vertebra_cervical_4", "bend"),
                 ("vertebra_cervical_3", "twist"), ("vertebra_cervical_2", "extend"),
                 ("vertebra_cervical_1", "bend"), ("vertebra_axis", "twist"),
                 ("vertebra_atlant", "extend"))
        for k, (name, kind) in enumerate(chain):
            self.open(name, (0.045, 0, 0.005) if k == 0 else (0.008, 0, 0.003),
                      [(f"{name}_{kind}", _AXES[kind], -30, 30)], "spine" if k < 5 else "head")
            self.capsule(f"{name}_g", (0, 0, 0), (0.008, 0, 0.003), 0.011)
            if name == "vertebra_cervical_3":
                self.site("marker_neck", (0.004, 0, 0.012))
        self.open("skull", (0.008, 0, 0.003), [("atlas", _AXES["extend"], -45, 45)], "head")
        self.ellipsoid("skull_g", (0.02, 0, -0.003), (0.022, 0.013, 0.012))
        self.capsule("skull_g2", (0.03, 0, -0.005), (0.045, 0, -0.01), 0.007)
        self.site("marker_skull", (0.02, 0, 0.01))
        self.open("jaw", (0.01, 0, -0.01), [("mandible", _AXES["extend"], -5, 30)], "head")
        self.capsule("jaw_g", (0, 0, 0), (0.03, 0, -0.004), 0.005, floor=True)
        self.site("marker_jaw", (0.02, 0, -0.006))
        self.close()
        for side, s in (("L", 1), ("R", -1)):
            self.open(f"ear_{side}", (0.008, s * 0.01, 0.01))  # welded to the skull
            self.ellipsoid(f"ear_{side}_g", (0, s * 0.001, 0.004), (0.004, 0.001, 0.006))
            self.close()
        self.open("nose", (0.048, 0, -0.01))  # welded to the skull
        self.sphere("nose_g", (0, 0, 0), 0.003, floor=True)
        self.close()
        self.close(len(chain) + 1)  # the skull and the neck

    def _foreleg(self, side: str, s: int):
        self.open(f"scapula_{side}", (0.025, s * 0.018, -0.005), [
            (f"scapula_{side}_supinate", _AXES["supinate"], -20, 20),
            (f"scapula_{side}_abduct", _AXES["abduct"], -20, 20),
            (f"scapula_{side}_extend", _AXES["extend"], -30, 30)])
        self.capsule(f"scapula_{side}_g", (0, 0, 0), (0, s * 0.003, -0.015), 0.007)
        self.open(f"upper_arm_{side}", (0, s * 0.003, -0.015), [
            (f"shoulder_{side}", _AXES["extend"], -60, 60),
            (f"shoulder_sup_{side}", _AXES["supinate"], -30, 30)])
        self.capsule(f"upper_arm_{side}_g", (0, 0, 0), (-0.005, 0, -0.02), 0.006)
        self.capsule(f"upper_arm_{side}_g2", (0, 0, 0), (-0.003, 0, -0.012), 0.005)
        self.site(f"marker_upper_arm_{side}", (-0.003, s * 0.006, -0.01))
        self.open(f"lower_arm_{side}", (-0.005, 0, -0.02), [(f"elbow_{side}", _AXES["extend"], -10, 90)])
        self.capsule(f"lower_arm_{side}_g", (0, 0, 0), (0.004, 0, -0.02), 0.005)
        self.site(f"marker_lower_arm_{side}", (0.002, s * 0.005, -0.01))
        self.open(f"hand_{side}", (0.004, 0, -0.02), [(f"wrist_{side}", _AXES["extend"], -45, 45)])
        self.ellipsoid(f"hand_{side}_g", (0.005, 0, -0.002), (0.007, 0.004, 0.003), floor="limb")
        self.site(f"palm_{side}", (0.005, 0, -0.002), (0.008, 0.005, 0.004))
        self.open(f"finger_{side}", (0.01, 0, -0.003), [(f"finger_{side}", _AXES["extend"], -30, 30)],
                  "digit")
        self.sphere(f"finger_{side}_g", (0.003, 0, 0), 0.0025, floor="limb")
        self.close(5)  # finger, hand, lower and upper arm, scapula


def _tendon_joints():
    """Each fixed tendon's (joint, coefficient)s."""
    tail = ["vertebra_" + j for j in STANDIN_TAIL]
    ext = [j for j in tail if j.endswith("extend")]
    bend = [j for j in tail if j.endswith("bend")]
    return {
        "spine_extend": [("vertebra_1_extend", 1.0), ("vertebra_4_extend", 1.0)],
        "spine_bend": [("vertebra_2_bend", 1.0), ("vertebra_5_bend", 1.0)],
        "tail_extend": [(j, round(1.0 / len(ext), 4)) for j in ext],
        "tail_bend": [(j, round(1.0 / len(bend), 4)) for j in bend],
    }


def _standin_defaults():
    """The rodent stand-in's <default> block."""
    lines = [
        "  <default>",
        '    <geom type="capsule" contype="0" conaffinity="0"/>',
        '    <site type="sphere" size="0.002"/>',
        '    <general dyntype="filter" dynprm="0.01" gaintype="fixed" biastype="affine" '
        'ctrlrange="-1 1" ctrllimited="true" forcelimited="true"/>',
        f'    <default class="floor"><geom conaffinity="{FLOOR_BIT}"/></default>',
    ]
    for name, (damping, armature, kp) in STANDIN_CLASSES.items():
        lines += [
            f'    <default class="{name}">',
            f'      <joint damping="{damping:g}" armature="{armature:g}"/>',
            f'      <general gainprm="{kp:g}" biasprm="0 {-kp:g} 0" forcerange="{-kp:g} {kp:g}"/>',
            "    </default>",
        ]
    return lines + ["  </default>"]


def rodent_standin_xml(terrain: bool = False) -> str:
    """The rodent stand-in's MJCF text (``rodent_standin.xml``), or with
    ``terrain`` the same rodent dressed in visual meshes on the terrain
    (``rodent_standin_terrain.xml``)."""
    what = ("Stand-in for the flagship rodent at its sizes and with its kinds of features"
            + (", on a terrain" if terrain else ""))
    lines = [
        f"<!-- {what};",
        "     written by brax_tracking_tpu_torch/assets/make_ratpair.py (edit that, not this). -->",
        f'<mujoco model="rodent_standin{"_terrain" if terrain else ""}">',
        '  <option timestep="0.002" iterations="4" ls_iterations="4" solver="CG"/>',
        *(_terrain_defaults(_standin_defaults()) if terrain else _standin_defaults()),
        *(_terrain_assets() if terrain else []),
        "  <worldbody>",
        f'    <geom name="floor" type="plane" size="2 2 .1" contype="{FLOOR_BIT}" '
        'conaffinity="0"/>',
        *("    " + g for g in (TERRAIN_GEOMS if terrain else ())),
    ]
    body = _Rodent(terrain)
    lines += body.build()
    lines += ["  </worldbody>", "  <tendon>"]
    for name, joints in _tendon_joints().items():
        lines.append(f'    <fixed name="{name}">')
        lines += [f'      <joint joint="{j}" coef="{c:g}"/>' for j, c in joints]
        lines.append("    </fixed>")
    lines += ["  </tendon>", "  <actuator>"]
    lines += [f'    <general name="{t}" tendon="{t}" class="{t.split("_")[0]}"/>'
              for t in STANDIN_TENDON_ACTUATORS]
    lines += [f'    <general name="{j}" joint="{j}" class="{body.joint_class[j]}"/>'
              for j in STANDIN_JOINT_ACTUATORS]
    lines += [
        "  </actuator>",
        "  <sensor>",
        '    <accelerometer name="accelerometer" site="torso_imu"/>',
        '    <velocimeter name="velocimeter" site="torso_imu"/>',
        '    <gyro name="gyro" site="torso_imu"/>',
    ]
    lines += [f'    <touch name="touch_{site}" site="{site}"/>'
              for site in ("sole_L", "sole_R", "palm_L", "palm_R")]
    lines += [
        '    <subtreelinvel name="torso_subtreelinvel" body="torso"/>',
        "  </sensor>",
        "</mujoco>",
    ]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# render scenes: two bodies, the reference clip's first
# ---------------------------------------------------------------------------

PAIR_STANDIN = "rodent_standin_pair.xml"
# each body's colour: the reference clip's (-0), the rollout's (-1)
PAIR_RGBA = ("0.35 0.55 0.85 1", "0.9 0.55 0.3 1")


def pair_body(lines, idx: int, camera: str = ""):
    """Body ``idx`` of a render pair from one body's XML lines: every name
    suffixed ``-idx``, every geom in PAIR_RGBA[idx], and ``camera`` (a
    <camera> element) on the root body, after its joint."""
    out = []
    for k, line in enumerate(lines):
        line = re.sub(r' name="([^"]+)"', rf' name="\1-{idx}"', line)
        out.append(line.replace("<geom ", f'<geom rgba="{PAIR_RGBA[idx]}" '))
        if camera and k == 1:
            out.append(line[: len(line) - len(line.lstrip())] + camera)
    return out


def rodent_standin_pair_xml(terrain: bool = False) -> str:
    """The rodent stand-ins' render scene (``rodent_standin_pair.xml``), or
    with ``terrain`` that of the terrain scene
    (``rodent_standin_terrain_pair.xml``: the visual meshes and the
    terrain)."""
    name = "rodent_standin" + ("_terrain" if terrain else "") + "_pair"
    lines = [
        "<!-- Render scene of two rodent stand-ins" + (" on the terrain" if terrain else "")
        + ", the reference clip's body first; written by",
        "     brax_tracking_tpu_torch/assets/make_ratpair.py (edit that, not this). -->",
        f'<mujoco model="{name}">',
        '  <option timestep="0.002" iterations="4" ls_iterations="4" solver="CG"/>',
        *(_terrain_defaults(_standin_defaults()) if terrain else _standin_defaults()),
        *(_terrain_assets() if terrain else []),
        "  <worldbody>",
        f'    <geom name="floor" type="plane" size="2 2 .1" contype="{FLOOR_BIT}" '
        'conaffinity="0"/>',
        *("    " + g for g in (TERRAIN_GEOMS if terrain else ())),
        '    <camera name="side" pos="0.6 0 0.25" xyaxes="0 1 0 -0.4 0 1"/>',
    ]
    track = '<camera name="track" mode="trackcom" pos="0 -0.5 0.2" xyaxes="1 0 0 0 0.4 1"/>'
    for idx, y0 in ((0, 0.08), (1, -0.08)):
        lines += pair_body(_Rodent(terrain).build(y0), idx, track if idx == 1 else "")
    lines += ["  </worldbody>", "</mujoco>"]
    return "\n".join(lines) + "\n"


def write(directory: str = HERE):
    """Writes the three files of the pair, the rodent stand-in and its
    render scene into ``directory``; returns their paths."""
    out = []
    texts = [(name, ratpair_xml(cone, rats)) for name, cone, rats in FILES]
    texts += [(STANDIN, rodent_standin_xml()), (PAIR_STANDIN, rodent_standin_pair_xml()),
              (TERRAIN, rodent_standin_xml(terrain=True)),
              (PAIR_TERRAIN, rodent_standin_pair_xml(terrain=True))]
    for name, text in texts:
        path = os.path.join(directory, name)
        with open(path, "w") as f:
            f.write(text)
        out.append(path)
    return out


def freeze():
    """Freezes the written files into their ``.npz`` files: the pair with
    configs/dataset/rodent_pair.yaml's CG 4/4, elliptic and for Newton/100,
    the one rat with CG 4/4, the rodent stand-in as
    configs/dataset/rodent.yaml freezes it (CG 4/4, rescaled by 0.9 under
    the torso) and its render scene as the JAX render compiles it
    (unscaled, the free roots kept); returns their paths."""
    from brax_tracking_tpu_torch.physics import spec

    jobs = ((spec.RATPAIR_XML, spec.RATPAIR_NPZ, {}),
            (spec.RATPAIR_ELLIPTIC_XML, spec.RATPAIR_ELLIPTIC_NPZ, {}),
            (spec.RATPAIR_XML, spec.RATPAIR_NEWTON_NPZ, spec.MINIRAT_NEWTON_OPTIONS),
            (spec.RAT_XML, spec.RAT_NPZ, {}),
            (spec.RODENT_STANDIN_XML, spec.RODENT_STANDIN_NPZ, spec.RODENT_OPTIONS),
            (spec.RODENT_STANDIN_PAIR_XML, spec.RODENT_STANDIN_PAIR_NPZ, {}),
            (spec.RODENT_STANDIN_TERRAIN_XML, spec.RODENT_STANDIN_TERRAIN_NPZ,
             spec.RODENT_OPTIONS),
            (spec.RODENT_STANDIN_TERRAIN_PAIR_XML, spec.RODENT_STANDIN_TERRAIN_PAIR_NPZ, {}))
    for xml, npz, options in jobs:
        spec.freeze_mjcf(xml, npz, **options)
    return [npz for _, npz, _ in jobs]


if __name__ == "__main__":
    import sys

    for p in write() + (freeze() if "--freeze" in sys.argv[1:] else []):
        print(p)
