"""Writes ``ratpair.xml`` and ``ratpair_elliptic.xml``, a two-rat stand-in
at the sizes of the rodent_pair scene (configs/dataset/rodent_pair.yaml),
and ``rat.xml``, one of its rats alone on the floor.

    python -m brax_tracking_tpu_torch.assets.make_ratpair

The pair's own MJCF is not in this repository, so the pair path is built
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
"""

from __future__ import annotations

import os

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


class _Rat:
    """One rat's bodies as nested XML, with the suffix and the collision
    bits of rat ``idx``."""

    def __init__(self, idx: int):
        self.idx = idx
        self.suffix = f"-{idx}"
        self.lines = []
        self.depth = 2

    def _bits(self, geom: str):
        contype, conaff = 0, 0
        if geom in FLOOR_GEOMS:
            conaff |= FLOOR_BIT
        if self.idx == 0 and geom in CROSS_SOURCES:
            contype |= CROSS_BIT
        if self.idx == 1 and geom in CROSS_TARGETS:
            conaff |= CROSS_BIT
        return contype, conaff

    def _emit(self, text: str):
        self.lines.append("  " * self.depth + text)

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

    def close(self):
        self.depth -= 1
        self._emit("</body>")

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


def write(directory: str = HERE):
    """Writes the three files into ``directory``; returns their paths."""
    out = []
    for name, cone, rats in FILES:
        path = os.path.join(directory, name)
        with open(path, "w") as f:
            f.write(ratpair_xml(cone, rats))
        out.append(path)
    return out


if __name__ == "__main__":
    for p in write():
        print(p)
