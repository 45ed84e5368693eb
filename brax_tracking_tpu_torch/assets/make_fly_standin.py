"""Writes ``fly_standin.xml``, a stand-in for the fruit fly at the sizes of
the fly's ``_fast`` model (configs/dataset/fly.yaml and fly_freejnt.yaml;
its MJCF is not in this repository).

    python -m brax_tracking_tpu_torch.assets.make_fly_standin [--freeze]

``--freeze`` then freezes it as the two fly configs load it (``freeze``:
``fly_standin.npz`` with the free root, ``fly_standin_tethered.npz`` with
it stripped, both at CG 4/4) and writes its stac exports (``export_stac``;
needs the ``mujoco`` bindings).

The stand-in has the fly's sizes: nq 43 and nv 42 (the free joint named
``free`` on the thorax and 36 limited leg hinges), nu 36 direct motors,
one on each hinge, nbody 68 (the world and the 67 ``body_names`` of the
configs: six legs of coxa, femur, tibia, tarsus, tarsus2-4 and claw, the
head with its mouth parts and antennae, the wings, halteres and a
seven-segment abdomen) and ngeom 160, most of them visual (``contype`` =
``conaffinity`` = 0). Only the leg hinges move: the head, wings, halteres
and abdomen are welded to the thorax. The hinges carry the correctly spelt
joint names, so the configs' misspelt ones (``oxa_twist_T1_right``,
``emur_T1_right``, ``tarsus_T2_righ``, ...) miss under
``strict_name_lookup: false`` as they do on the real fly.

Its option line is the fly's: timestep 0.002, elliptic cones, a medium of
density 0.00128 and viscosity 0.000185 (the inertia-box fluid model) and
three noslip iterations; its units are the fly's, cm and g, with gravity
-981 and a total mass near 1 mg. Its collision filter is the fly's in
kind: the thorax, coxae, femurs and tibiae collide with each other, and
33 ``<exclude>`` body pairs remove every one of those pairs (with the free
joint stripped the thorax is welded to the world, so the parent-child
filter no longer removes thorax-coxa pairs; only the excludes do). What
remains is the six claws (capsules) against the floor: 12 contact slots,
36 elliptic rows in one contiguous dim-3 block. At qpos0 the thorax lies
inside the configs' ``healthy_z_range`` and the claws touch the floor.

The stac exports are one MuJoCo C rollout of the free stand-in under slow,
seeded, time-varying actuation, 250 frames at 50 Hz, in the reference's
``.p`` layout (a dict holding ``qpos``): ``fly_standin_stac.p`` with the
full-width qpos (fly_freejnt.yaml), ``fly_standin_tethered_stac.p`` with
the root columns dropped (fly.yaml: the JAX package's tethered fly reads a
qpos as wide as its model, as scripts/make_demo_stac.py writes one).

``fly_standin_ball.xml`` is the stand-in at the shape of the fly's
``_ball`` variant (nq 49, nv 42, njnt 25; SURVEY.md row 16): each leg's
coxa hinges and the femur's twist become one limited ball joint on the
coxa (range 40 degrees), driven by three motors with one gear axis each,
so nu stays 36. Its limited ball joints take it off the solve kernel's
layout: under CG it runs the array CG path (``spd_inverse`` once per
substep), and ``fly_standin_ball_newton.npz`` is a Newton copy for the
array Newton path. Its stac export (``fly_standin_ball_stac.p``, full
width) is a MuJoCo C rollout as the fly's.

``fly_standin_pair.xml`` is the render scene of the fly configs'
``rendering_mjcf`` (the reference's ``fruitfly_force_pair.xml`` is not in
this repository either): two fly stand-ins side by side, every name
suffixed ``-0`` and ``-1``, the reference clip's body first, each in its
own colour, with no actuators. It is frozen with both free roots (nq 2 x
43) and with both stripped (nq 2 x 36), as the JAX render strips every
free joint for a tethered config. Camera 0 is fixed in the world; camera 1
tracks the rollout body's subtree CoM (``trackcom`` on ``thorax-1``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from brax_tracking_tpu_torch.assets.make_ratpair import FLOOR_BIT, _Bodies, _v, pair_body

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = "fly_standin.xml"
BALL_NAME = "fly_standin_ball.xml"
PAIR_NAME = "fly_standin_pair.xml"
# the render pair's thoraxes lie this far either side of y = 0 (cm)
PAIR_Y = 0.15
# collision bits: the claws against the floor (FLOOR_BIT); the thorax
# against the coxae, femurs and tibiae, and coxa against coxa, all of
# which the excludes remove
THORAX_BIT, COXA_BIT = 2, 4
LEGS = tuple((f"T{i}", side) for i in (1, 2, 3) for side in ("left", "right"))
# each leg's attachment under the thorax (x) and its hinges: body -> (name
# prefix, axis, range in degrees)
LEG_X = {"T1": 0.045, "T2": 0.0, "T3": -0.045}
LEG_JOINTS = {
    "coxa": (("coxa_flexion", (0, 1, 0), -40, 40), ("coxa_twist", (0, 0, 1), -30, 30)),
    "femur": (("femur", (1, 0, 0), -45, 45), ("femur_twist", (0, 1, 0), -30, 30)),
    "tibia": (("tibia", (1, 0, 0), -60, 60),),
    "tarsus": (("tarsus", (1, 0, 0), -30, 30),),
}
# leg segments: body, offset of the next body (lateral, vertical; cm),
# capsule radius
LEG_SEGMENTS = (
    ("coxa", (0.012, -0.018), 0.008),
    ("femur", (0.035, 0.004), 0.006),
    ("tibia", (0.012, -0.035), 0.004),
    ("tarsus", (0.004, -0.012), 0.003),
    ("tarsus2", (0.002, -0.004), 0.0025),
    ("tarsus3", (0.002, -0.004), 0.0022),
    ("tarsus4", (0.002, -0.004), 0.002),
)
CLAW_RADIUS = 0.0015
# the coxae's height under the thorax, and how deep the claws dip into the
# floor at qpos0 (cm): the thorax's height follows
LEG_Z, CLAW_DIP = -0.02, 2e-4
# the contacts' time constant (s): twice the timestep, MuJoCo's stiffest;
# under -981 cm/s^2 the claws then settle ~0.01 cm into the floor (the
# default 0.02 s would let them sink past the legs' length)
CONTACT_TIMECONST = 0.004
THORAX_Z = round(-LEG_Z - sum(v for _, (_, v), _ in LEG_SEGMENTS) + CLAW_RADIUS - CLAW_DIP, 6)
# motor gear and force limit per hinge kind (dyn cm per unit control); the
# hinges' springs hold the fly's weight (about 1 dyn) at qpos0
MOTOR = {"coxa_flexion": (0.2, 0.4), "coxa_twist": (0.1, 0.2), "femur": (0.2, 0.4),
         "femur_twist": (0.1, 0.2), "tibia": (0.1, 0.2), "tarsus": (0.05, 0.1)}
JOINT_STIFFNESS, JOINT_ARMATURE = 1.0, 1e-5
# the ball variant's coxa joint: its range (degrees), and its three motors'
# gear axes, gears and force limits
BALL_RANGE = 40
BALL_MOTORS = (("x", (1, 0, 0), 0.2, 0.4), ("y", (0, 1, 0), 0.2, 0.4), ("z", (0, 0, 1), 0.1, 0.2))
# the stac exports: frames, rate, actuation seed and amplitude
STAC_FRAMES, STAC_HZ, STAC_SEED, STAC_AMP = 250, 50, 17, 0.4
STAC_FREE = "fly_standin_stac.p"
STAC_BALL = "fly_standin_ball_stac.p"
STAC_TETHERED = "fly_standin_tethered_stac.p"


class _Fly(_Bodies):
    """The stand-in's bodies as nested XML; ``collide`` lists the leg
    bodies whose geoms collide (the coxae, and the femurs and tibiae),
    ``hinges`` the leg hinges in order; with ``ball`` each coxa holds one
    ball joint in place of its hinges and the femur's twist, listed in
    ``balls``."""

    def __init__(self, ball: bool = False):
        super().__init__()
        self.collide = {"coxa": [], "leg": []}
        self.hinges = []
        self.ball = ball
        self.balls = []

    def open(self, name: str, pos, joints=()):
        self._emit(f'<body name="{name}" pos="{_v(pos)}">')
        self.depth += 1
        if self.ball and name.startswith("coxa_"):
            self.balls.append(name)
            self._emit(f'<joint name="{name}" type="ball" range="0 {BALL_RANGE}"/>')
            return
        for jname, axis, lo, hi in joints:
            if self.ball and jname.startswith("femur_twist"):
                continue
            self.hinges.append(jname)
            self._emit(f'<joint name="{jname}" axis="{_v(axis)}" range="{lo} {hi}"/>')

    def geom(self, kind: str, name: str, **attrs):
        body = " ".join(f'{k}="{_v(v) if isinstance(v, tuple) else v}"'
                        for k, v in attrs.items())
        self._emit(f'<geom name="{name}" type="{kind}" {body}/>')

    def visual(self, name: str, kind: str, pos, size):
        self.geom(kind, name, pos=pos, size=size, **{"class": "visual"})

    def build(self, y0: float = 0.0):
        self._emit(f'<body name="thorax" pos="0 {y0:g} {THORAX_Z}">')
        self.depth += 1
        self._emit('<freejoint name="free"/>')
        self.geom("capsule", "thorax", fromto=(-0.04, 0, 0, 0.04, 0, 0), size=0.03,
                  contype=THORAX_BIT, conaffinity=0)
        self.visual("thorax_scutum", "ellipsoid", (0, 0, 0.02), (0.04, 0.025, 0.012))
        self.visual("thorax_notum", "sphere", (-0.03, 0, 0.018), (0.012,))
        self._head()
        for side, s in (("left", 1), ("right", -1)):
            self.open(f"wing_{side}", (0.0, s * 0.02, 0.028))
            self.visual(f"wing_{side}_blade", "ellipsoid", (-0.05, s * 0.04, 0),
                        (0.08, 0.03, 0.001))
            self.visual(f"wing_{side}_vein", "capsule", (-0.02, s * 0.02, 0), (0.001, 0.03))
            self.close()
            self.open(f"haltere_{side}", (-0.03, s * 0.022, 0.01))
            self.visual(f"haltere_{side}_stalk", "capsule", (-0.005, s * 0.003, 0),
                        (0.001, 0.005))
            self.visual(f"haltere_{side}_knob", "sphere", (-0.01, s * 0.006, 0), (0.003,))
            self.close()
        self._abdomen()
        for seg, side in LEGS:
            self._leg(seg, side)
        self.close()
        return self.lines

    def _head(self):
        self.open("head", (0.05, 0, 0.01))
        self.visual("head_capsule", "ellipsoid", (0.012, 0, 0), (0.015, 0.028, 0.02))
        self.visual("head_eyes", "capsule", (0.012, 0, 0.005), (0.012, 0.02))
        self.open("rostrum", (0.015, 0, -0.02))
        self.visual("rostrum_g", "capsule", (0, 0, -0.005), (0.004, 0.005))
        self.visual("rostrum_tip", "sphere", (0, 0, -0.01), (0.004,))
        self.open("haustellum", (0.002, 0, -0.012))
        self.visual("haustellum_g", "capsule", (0, 0, -0.004), (0.003, 0.004))
        self.visual("haustellum_tip", "sphere", (0, 0, -0.008), (0.003,))
        for side, s in (("left", 1), ("right", -1)):
            self.open(f"labrum_{side}", (0.002, s * 0.002, -0.01))
            self.visual(f"labrum_{side}_g", "ellipsoid", (0.002, s * 0.001, 0),
                        (0.003, 0.0015, 0.002))
            self.visual(f"labrum_{side}_tip", "sphere", (0.004, s * 0.001, -0.001), (0.0012,))
            self.close()
        self.close(2)  # haustellum, rostrum
        for side, s in (("left", 1), ("right", -1)):
            self.open(f"antenna_{side}", (0.025, s * 0.008, 0.008))
            self.visual(f"antenna_{side}_g", "capsule", (0.003, s * 0.002, 0.003), (0.0015, 0.004))
            self.visual(f"antenna_{side}_arista", "sphere", (0.006, s * 0.004, 0.006), (0.0015,))
            self.close()
        self.close()  # head

    def _abdomen(self):
        for k in range(1, 8):
            name = "abdomen" if k == 1 else f"abdomen_{k}"
            r = round(0.028 - 0.003 * k, 4)
            self.open(name, (-0.045, 0, -0.005) if k == 1 else (-0.016, 0, -0.001))
            self.visual(f"{name}_g", "ellipsoid", (-0.008, 0, 0), (0.009, r, round(0.8 * r, 5)))
            self.visual(f"{name}_tergite", "sphere", (-0.008, 0, round(0.6 * r, 5)),
                        (round(0.5 * r, 5),))
        self.close(7)

    def _leg(self, seg: str, side: str):
        s = 1 if side == "left" else -1
        pos = (LEG_X[seg], s * 0.02, LEG_Z)
        for body, (lat, vert), r in LEG_SEGMENTS:
            name = f"{body}_{seg}_{side}"
            joints = [(f"{j}_{seg}_{side}", axis, lo, hi)
                      for j, axis, lo, hi in LEG_JOINTS.get(body, ())]
            self.open(name, pos, joints)
            end = (0, s * lat, vert)
            if body in ("coxa", "femur", "tibia"):
                bits = (dict(contype=COXA_BIT, conaffinity=THORAX_BIT | COXA_BIT)
                        if body == "coxa" else dict(contype=0, conaffinity=THORAX_BIT))
                self.geom("capsule", name, fromto=(0, 0, 0) + end, size=r, **bits)
                self.collide["coxa" if body == "coxa" else "leg"].append(name)
            else:
                self.geom("capsule", name, fromto=(0, 0, 0) + end, size=r,
                          **{"class": "visual"})
            self.visual(f"{name}_joint", "sphere", (0, 0, 0), (round(1.1 * r, 5),))
            if body in LEG_JOINTS:
                self.visual(f"{name}_hair", "capsule", tuple(0.5 * x for x in end),
                            (round(0.3 * r, 5), round(0.2 * abs(vert) + 0.001, 5)))
            pos = end
        # the claw: welded to tarsus4, the leg's only floor geom
        name = f"claw_{seg}_{side}"
        self.open(name, pos)
        self.geom("capsule", name, fromto=(-0.0015, 0, 0, 0.0015, 0, 0), size=CLAW_RADIUS,
                  contype=0, conaffinity=FLOOR_BIT)
        self.visual(f"{name}_pulvillus", "sphere", (0.001, 0, 0.0005), (0.001,))
        self.close(len(LEG_SEGMENTS) + 1)


def _excludes(fly: _Fly):
    """The 33 body pairs whose contacts <exclude> removes: the thorax with
    each coxa, femur and tibia (18), and every pair of coxae (15)."""
    coxae = fly.collide["coxa"]
    pairs = [("thorax", b) for b in coxae + fly.collide["leg"]]
    pairs += [(a, b) for i, a in enumerate(coxae) for b in coxae[i + 1:]]
    return pairs


def _header(model: str):
    """The stand-in's compiler, option and default lines."""
    return [
        f'<mujoco model="{model}">',
        '  <compiler angle="degree"/>',
        '  <option timestep="0.002" gravity="0 0 -981" density="0.00128" viscosity="0.000185" '
        'cone="elliptic" noslip_iterations="3" iterations="4" ls_iterations="4" solver="CG"/>',
        "  <default>",
        f'    <joint stiffness="{JOINT_STIFFNESS:g}" armature="{JOINT_ARMATURE:g}" '
        'limited="true"/>',
        f'    <geom density="1.5" friction="1 0.005 0.0001" solref="{CONTACT_TIMECONST:g} 1"/>',
        '    <default class="visual"><geom contype="0" conaffinity="0"/></default>',
        "  </default>",
        "  <worldbody>",
        f'    <geom name="floor" type="plane" size="2 2 .1" contype="{FLOOR_BIT}" '
        'conaffinity="0"/>',
    ]


def fly_standin_xml(ball: bool = False) -> str:
    """The fly stand-in's MJCF text (``fly_standin.xml``), or with ``ball``
    its ball-coxa variant's (``fly_standin_ball.xml``)."""
    fly = _Fly(ball)
    bodies = fly.build()
    what = "its _ball variant's shape" if ball else "the sizes of its _fast model"
    lines = [
        f"<!-- Stand-in for the fruit fly at {what}; written by",
        "     brax_tracking_tpu_torch/assets/make_fly_standin.py (edit that, not this). -->",
        *_header("fly_standin_ball" if ball else "fly_standin"),
    ]
    lines += bodies
    lines += ["  </worldbody>", "  <contact>"]
    lines += [f'    <exclude body1="{a}" body2="{b}"/>' for a, b in _excludes(fly)]
    lines += ["  </contact>", "  <actuator>"]
    for j in fly.balls:
        for ax, axis, gear, force in BALL_MOTORS:
            g = " ".join(f"{gear * a:g}" for a in axis)
            lines.append(f'    <motor name="{j}_{ax}" joint="{j}" gear="{g}" ctrlrange="-1 1" '
                         f'forcerange="{-force:g} {force:g}"/>')
    for j in fly.hinges:
        gear, force = MOTOR[j.rsplit("_", 2)[0]]
        lines.append(f'    <motor name="{j}" joint="{j}" gear="{gear:g}" ctrlrange="-1 1" '
                     f'forcerange="{-force:g} {force:g}"/>')
    lines += ["  </actuator>", "</mujoco>"]
    return "\n".join(lines) + "\n"


def fly_standin_pair_xml() -> str:
    """The fly stand-ins' render scene (``fly_standin_pair.xml``)."""
    lines = [
        "<!-- Render scene of two fly stand-ins, the reference clip's body first; written by",
        "     brax_tracking_tpu_torch/assets/make_fly_standin.py (edit that, not this). -->",
        *_header("fly_standin_pair"),
        '    <camera name="side" pos="1 0 0.4" xyaxes="0 1 0 -0.37 0 1"/>',
    ]
    track = '<camera name="track" mode="trackcom" pos="0 -0.6 0.25" xyaxes="1 0 0 0 0.4 1"/>'
    excludes = []
    for idx, y0 in ((0, PAIR_Y), (1, -PAIR_Y)):
        fly = _Fly()
        lines += pair_body(fly.build(y0), idx, track if idx == 1 else "")
        excludes += [f'    <exclude body1="{a}-{idx}" body2="{b}-{idx}"/>'
                     for a, b in _excludes(fly)]
    lines += ["  </worldbody>", "  <contact>", *excludes, "  </contact>", "</mujoco>"]
    return "\n".join(lines) + "\n"


def write(directory: str = HERE):
    """Writes the stand-in and its render scene; returns their paths."""
    out = []
    for name, text in ((NAME, fly_standin_xml()), (BALL_NAME, fly_standin_xml(ball=True)),
                       (PAIR_NAME, fly_standin_pair_xml())):
        path = os.path.join(directory, name)
        with open(path, "w") as f:
            f.write(text)
        out.append(path)
    return out


def freeze():
    """Freezes the stand-in as configs/dataset/fly_freejnt.yaml and fly.yaml
    load it (CG 4/4; the free root kept, then stripped), and its render
    scene with both free roots and with both stripped; returns the
    paths."""
    from brax_tracking_tpu_torch.physics import spec

    spec.freeze_mjcf(spec.FLY_STANDIN_XML, spec.FLY_STANDIN_NPZ, free_jnt=True)
    spec.freeze_mjcf(spec.FLY_STANDIN_XML, spec.FLY_STANDIN_TETHERED_NPZ, free_jnt=False)
    spec.freeze_mjcf(spec.FLY_STANDIN_PAIR_XML, spec.FLY_STANDIN_PAIR_NPZ, free_jnt=True)
    spec.freeze_mjcf(spec.FLY_STANDIN_PAIR_XML, spec.FLY_STANDIN_PAIR_TETHERED_NPZ,
                     free_jnt=False, render_scene=True)
    spec.freeze_mjcf(spec.FLY_STANDIN_BALL_XML, spec.FLY_STANDIN_BALL_NPZ, free_jnt=True)
    spec.freeze_mjcf(spec.FLY_STANDIN_BALL_XML, spec.FLY_STANDIN_BALL_NEWTON_NPZ, free_jnt=True,
                     **spec.FLY_BALL_NEWTON_OPTIONS)
    return [spec.FLY_STANDIN_NPZ, spec.FLY_STANDIN_TETHERED_NPZ, spec.FLY_STANDIN_PAIR_NPZ,
            spec.FLY_STANDIN_PAIR_TETHERED_NPZ, spec.FLY_STANDIN_BALL_NPZ,
            spec.FLY_STANDIN_BALL_NEWTON_NPZ]


def stac_qpos(xml_path: str = os.path.join(HERE, NAME), n_frames: int = STAC_FRAMES):
    """A MuJoCo C rollout of the free stand-in from qpos0 under seeded,
    slow sinusoidal controls (scripts/make_demo_stac.py's recipe): the qpos
    of ``n_frames`` frames at STAC_HZ. The motion stands in for motion
    capture, so MuJoCo solves it to convergence (Newton, 100 iterations);
    at the configs' CG 4/4 the stand-in does not stand for long."""
    import mujoco

    m = mujoco.MjModel.from_xml_path(xml_path)
    m.opt.solver, m.opt.iterations, m.opt.ls_iterations = mujoco.mjtSolver.mjSOL_NEWTON, 100, 50
    d = mujoco.MjData(m)
    rng = np.random.RandomState(STAC_SEED)
    phase = rng.uniform(0, 2 * np.pi, m.nu)
    freq = rng.uniform(0.5, 2.5, m.nu)
    amp = rng.uniform(0.5, 1.0, m.nu) * STAC_AMP
    substeps = int(round(1.0 / (STAC_HZ * m.opt.timestep)))
    qpos = np.zeros((n_frames, m.nq))
    for i in range(n_frames):
        qpos[i] = d.qpos
        for _ in range(substeps):
            d.ctrl[:] = amp * np.sin(2 * np.pi * freq * d.time + phase)
            mujoco.mj_step(m, d)
    if not np.isfinite(qpos).all():
        raise RuntimeError("the stand-in's rollout diverged")
    return qpos


def export_stac(directory: str = HERE):
    """Writes the two stac exports of one rollout and the ball variant's
    of its own; returns their paths."""
    qpos = stac_qpos()
    out = []
    for name, q in ((STAC_FREE, qpos), (STAC_TETHERED, qpos[:, 7:]),
                    (STAC_BALL, stac_qpos(os.path.join(directory, BALL_NAME)))):
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            pickle.dump({"qpos": np.ascontiguousarray(q)}, f, protocol=4)
        out.append(path)
    return out


if __name__ == "__main__":
    import sys

    out = write()
    if "--freeze" in sys.argv[1:]:
        out += freeze() + export_stac()
    for p in out:
        print(p)
