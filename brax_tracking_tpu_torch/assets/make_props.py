"""Writes ``props.xml``: free props dropped on a plane, a height field and
each other, for the narrowphase pairs that need two moving bodies.

    python -m brax_tracking_tpu_torch.assets.make_props [--freeze]

``--freeze`` then freezes it into ``props.npz`` with CG 4/4 (``freeze``;
needs the ``mujoco`` bindings).

Two boxes, two cylinders and two convex mesh rocks stand in a cluster on
the floor and lean on or hover over each other: plane-box, plane-cylinder,
plane-mesh, box-box, cylinder-cylinder, cylinder-box, box-mesh,
cylinder-mesh and mesh-mesh. A pebble sphere and a pebble capsule lie on a
height field beside them (hfield-sphere and hfield-capsule; the JAX
package's pair table has no height-field pair with a box, a cylinder or a
mesh, so the height field's contype bit is carried by the pebbles alone).
Every prop collides with every other: 8 free bodies (nq 56, nv 48).
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = "props.xml"
PROP_BIT, HFIELD_BIT = 1, 2
# a convex rock (the rodent terrain's, larger): a top over a wider base
ROCK_VERTS = (
    (0.035, 0.03, 0.03), (0.035, -0.03, 0.025), (-0.035, 0.03, 0.028), (-0.03, -0.03, 0.03),
    (0.04, 0.035, -0.03), (0.04, -0.035, -0.03), (-0.04, 0.035, -0.03), (-0.04, -0.035, -0.03),
    (0.0, 0.04, 0.0), (0.045, 0.0, 0.005),
)
# a flatter second rock: an irregular octahedron (tests/test_mesh_collision.py's)
SLAB_VERTS = ((0.09, 0, 0), (-0.08, 0, 0), (0, 0.07, 0), (0, -0.06, 0), (0, 0, 0.05),
              (0, 0, -0.055))
# the height field beside the cluster: 7 x 7, 5 cm apart, bumps to 3 cm
HFIELD_ELEVATION = (
    (0.0, 0.2, 0.4, 0.5, 0.4, 0.2, 0.1),
    (0.2, 0.5, 0.7, 0.8, 0.7, 0.4, 0.2),
    (0.3, 0.6, 0.9, 1.0, 0.9, 0.6, 0.3),
    (0.3, 0.7, 1.0, 0.9, 0.8, 0.6, 0.3),
    (0.2, 0.5, 0.8, 0.8, 0.6, 0.4, 0.2),
    (0.1, 0.3, 0.5, 0.5, 0.4, 0.3, 0.1),
    (0.0, 0.1, 0.2, 0.3, 0.2, 0.1, 0.0),
)
# name, geom attributes, position, euler (degrees): the drop poses
PROPS = (
    ("box_a", 'type="box" size="0.05 0.04 0.03"', (0.0, 0.0, 0.029), (0, 0, 0)),
    ("box_b", 'type="box" size="0.04 0.03 0.025"', (0.01, 0.005, 0.085), (0, 0, 30)),
    ("cyl_a", 'type="cylinder" size="0.035 0.04"', (0.095, 0.0, 0.039), (0, 0, 0)),
    ("cyl_b", 'type="cylinder" size="0.025 0.05"', (0.08, 0.02, 0.105), (90, 0, 0)),
    ("rock_a", 'type="mesh" mesh="rock"', (-0.095, 0.0, 0.029), (0, 0, 0)),
    ("rock_b", 'type="mesh" mesh="slab"', (-0.1, 0.0, 0.115), (0, 20, 0)),
    ("pebble", 'type="sphere" size="0.03"', (0.45, 0.0, 0.08), (0, 0, 0)),
    ("stick", 'type="capsule" size="0.02 0.04"', (0.5, 0.08, 0.07), (0, 90, 0)),
)
PEBBLES = ("pebble", "stick")


def _v(xs) -> str:
    return " ".join(f"{x:g}" for x in xs)


def props_xml() -> str:
    """The props scene's MJCF text (``props.xml``)."""
    lines = [
        "<!-- Free props dropped on a plane, a height field and each other; written by",
        "     brax_tracking_tpu_torch/assets/make_props.py (edit that, not this). -->",
        '<mujoco model="props">',
        '  <option timestep="0.002" iterations="4" ls_iterations="4" solver="CG"/>',
        "  <default>",
        f'    <geom contype="{PROP_BIT}" conaffinity="{PROP_BIT}" density="500"/>',
        f'    <default class="pebble"><geom conaffinity="{PROP_BIT | HFIELD_BIT}"/></default>',
        "  </default>",
        "  <asset>",
        f'    <mesh name="rock" vertex="{" ".join(_v(p) for p in ROCK_VERTS)}"/>',
        f'    <mesh name="slab" vertex="{" ".join(_v(p) for p in SLAB_VERTS)}"/>',
        f'    <hfield name="bumps" nrow="{len(HFIELD_ELEVATION)}" '
        f'ncol="{len(HFIELD_ELEVATION[0])}" size="0.15 0.15 0.03 0.01" '
        f'elevation="{" ".join(_v(r) for r in HFIELD_ELEVATION)}"/>',
        "  </asset>",
        "  <worldbody>",
        '    <geom name="floor" type="plane" size="2 2 .1"/>',
        f'    <geom name="bumps" type="hfield" hfield="bumps" pos="0.48 0.04 0" '
        f'contype="{HFIELD_BIT}" conaffinity="0"/>',
    ]
    for name, geom, pos, euler in PROPS:
        cls = ' class="pebble"' if name in PEBBLES else ""
        lines += [
            f'    <body name="{name}" pos="{_v(pos)}" euler="{_v(euler)}">',
            "      <freejoint/>",
            f'      <geom name="{name}_g"{cls} {geom}/>',
            "    </body>",
        ]
    lines += ["  </worldbody>", "</mujoco>"]
    return "\n".join(lines) + "\n"


def seeded_qpos(qpos0: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """n qposes of the props, each in a random orientation: the six
    boxes, cylinders and rocks anywhere in a 16 cm x 16 cm x 8 cm cluster
    over the floor, and the pebbles within 3 cm of their drop poses over
    the height field, so that in each pose some neighbours overlap and
    others part."""
    rng = np.random.RandomState(seed)
    out = np.tile(np.asarray(qpos0, np.float64), (n, 1))
    for k, (name, _, pos, _) in enumerate(PROPS):
        a = 7 * k
        if name in PEBBLES:
            lo = np.array([pos[0] - 0.03, pos[1] - 0.03, 0.01])
            hi = np.array([pos[0] + 0.03, pos[1] + 0.03, 0.06])
        else:
            lo, hi = np.array([-0.08, -0.08, 0.02]), np.array([0.08, 0.08, 0.1])
        out[:, a:a + 3] = rng.uniform(lo, hi, (n, 3))
        q = rng.randn(n, 4)
        out[:, a + 3:a + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return out


def write(directory: str = HERE) -> str:
    path = os.path.join(directory, NAME)
    with open(path, "w") as f:
        f.write(props_xml())
    return path


def freeze() -> str:
    """Freezes props.xml into props.npz with CG 4/4; returns its path."""
    from brax_tracking_tpu_torch.physics import spec

    spec.freeze_mjcf(spec.PROPS_XML, spec.PROPS_NPZ)
    return spec.PROPS_NPZ


if __name__ == "__main__":
    import sys

    print(write())
    if "--freeze" in sys.argv[1:]:
        print(freeze())
