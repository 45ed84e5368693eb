"""The narrowphase's 20 box, cylinder, mesh and height-field pair types
(ROADMAP A.12), the port against the JAX package's ``collision``, float64
on the CPU.

Each pair type runs on the JAX package's own fixtures
(tests/test_collision_extended.py, tests/test_mesh_collision.py,
tests/test_hfield_collision.py: a free body against a world geom or a
plane, the height field with that file's seeded terrain) and the props
scene ``assets/props.xml`` (free boxes, cylinders and convex meshes
dropped on a plane, a height field and each other) on seeded poses. All
poses of a fixture go through the port as one batch and through one
``vmap``-ed JAX call; dist, pos and frame are compared per slot, in slot
order, at 1e-9 (and 1e-12 of the value: a switched-off face-manifold
candidate of box-box sits ~5e8 m away), widened only by the JAX package's
own spread where its answer is ill-conditioned: the JAX call is run again
on the qposes scaled by 1 +- 1e-15, and a slot whose output moves by more
than that between the JAX runs is held at twice its movement on top of
1e-9 (one cylinder-cylinder pose, whose ascent ends where both cylinders'
support witnesses jump from rim to rim: the JAX package's own normal moves
by ~1e-7 there under a 4e-16 relative change of the pose). The poses
overlap and separate, and a box or mesh face resting flat on the plane
(for the box, four exact ties in the four-deepest selection) is among
them.

Also: the props scene's fresh freeze and ``model_from_numpy`` round trip
against the JAX package's model of the same MJCF, its pair types, and the
pair table equal to the JAX package's 29 entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.collision as jC
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu_torch.physics import collision as tC
from brax_tracking_tpu_torch.physics import kinematics as tK
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep
from engine_harness import build_cached

mujoco = pytest.importorskip("mujoco")

ATOL, RTOL = 1e-9, 1e-12
N_POSES = 24

# tests/test_mesh_collision.py's meshes
CUBE = (
    "-.07 -.06 -.05  .07 -.06 -.05  -.07 .06 -.05  .07 .06 -.05 "
    "-.07 -.06 .05   .07 -.06 .05   -.07 .06 .05   .07 .06 .05"
)
OCTA = ".09 0 0  -.08 0 0  0 .07 0  0 -.06 0  0 0 .05  0 0 -.055"


def _vs(world, free, pos="0.2 0 0", assets=""):
    """A world geom and a free body's geom (test_collision_extended.py's
    form)."""
    return (f"<mujoco><asset>{assets}</asset><worldbody><geom {world} contype=\"1\" "
            f"conaffinity=\"1\"/><body pos=\"{pos}\"><freejoint/><geom {free}/></body>"
            "</worldbody></mujoco>")


def _on_plane(free, assets=""):
    return (f"<mujoco><asset>{assets}</asset><worldbody><geom type=\"plane\" size=\"2 2 .1\"/>"
            f"<body pos=\"0 0 0.3\"><freejoint/><geom {free}/></body></worldbody></mujoco>")


CUBE_MESH = f'<mesh name="cube" vertex="{CUBE}"/>'
BOTH_MESHES = CUBE_MESH + f'<mesh name="octa" vertex="{OCTA}"/>'
# test_hfield_collision.py's height field
NROW = NCOL = 17
HFIELD_XML = """<mujoco>
<asset><hfield name="terrain" nrow="17" ncol="17" size="0.5 0.5 0.08 0.02"/></asset>
<worldbody><geom type="hfield" hfield="terrain"/>
<body pos="0 0 0.3"><freejoint/><geom {}/></body></worldbody></mujoco>"""

# pair type -> (xml, pose recipe, recipe arguments, seed)
FIXTURES = {
    "plane-box": (_on_plane('type="box" size="0.08 0.06 0.05"'), "above", (0.02, 0.09, 0.045), 11),
    "plane-cylinder": (_on_plane('type="cylinder" size="0.1 0.15"'), "above", (0.05, 0.2, 0.15), 12),
    "plane-mesh": (_on_plane('type="mesh" mesh="cube"', CUBE_MESH), "above", (0.03, 0.09, 0.045),
                   13),
    "hfield-sphere": (HFIELD_XML.format('type="sphere" size="0.06"'), "hfield", (0.05, 0.16), 41),
    "hfield-capsule": (HFIELD_XML.format('type="capsule" size="0.04 0.07"'), "hfield",
                       (0.05, 0.18), 42),
    "sphere-box": (_vs('type="box" size="0.1 0.12 0.08"', 'type="sphere" size="0.07"',
                       "0.15 0 0"), "around", (0.1, 0.22), 1),
    "capsule-box": (_vs('type="box" size="0.1 0.12 0.08"', 'type="capsule" size="0.05 0.12"'),
                    "around", (0.15, 0.28), 2),
    "sphere-cylinder": (_vs('type="cylinder" size="0.08 0.1"', 'type="sphere" size="0.05"',
                            "0.15 0 0"), "around", (0.08, 0.2), 14),
    "capsule-cylinder": (_vs('type="cylinder" size="0.07 0.09"', 'type="capsule" size="0.04 0.08"',
                             "0.15 0 0"), "around", (0.08, 0.22), 15),
    "box-box": (_vs('type="box" size="0.1 0.12 0.08"', 'type="box" size="0.07 0.05 0.06"'),
                "around", (0.1, 0.25), 16),
    "ellipsoid-cylinder": (_vs('type="ellipsoid" size="0.08 0.06 0.05"',
                               'type="cylinder" size="0.06 0.08"'), "around", (0.1, 0.22), 21),
    "ellipsoid-box": (_vs('type="ellipsoid" size="0.08 0.06 0.05"',
                          'type="box" size="0.07 0.05 0.06"'), "around", (0.1, 0.22), 22),
    "cylinder-cylinder": (_vs('type="cylinder" size="0.06 0.08"', 'type="cylinder" size="0.05 0.07"'),
                          "around", (0.1, 0.22), 23),
    "cylinder-box": (_vs('type="cylinder" size="0.06 0.08"', 'type="box" size="0.07 0.05 0.06"'),
                     "around", (0.1, 0.22), 24),
    "sphere-mesh": (_vs('type="sphere" size="0.07"', 'type="mesh" mesh="cube"', "0.15 0 0",
                        CUBE_MESH), "around", (0.11, 0.22), 31),
    "capsule-mesh": (_vs('type="capsule" size="0.05 0.08"', 'type="mesh" mesh="cube"', "0.15 0 0",
                         CUBE_MESH), "around", (0.11, 0.22), 32),
    "ellipsoid-mesh": (_vs('type="ellipsoid" size="0.08 0.06 0.05"', 'type="mesh" mesh="cube"',
                           "0.15 0 0", CUBE_MESH), "around", (0.11, 0.22), 33),
    "cylinder-mesh": (_vs('type="cylinder" size="0.06 0.08"', 'type="mesh" mesh="cube"',
                          "0.15 0 0", CUBE_MESH), "around", (0.11, 0.22), 34),
    "box-mesh": (_vs('type="box" size="0.07 0.05 0.06"', 'type="mesh" mesh="cube"', "0.15 0 0",
                     CUBE_MESH), "around", (0.11, 0.22), 35),
    "mesh-mesh": (_vs('type="mesh" mesh="octa"', 'type="mesh" mesh="cube"', "0.15 0 0",
                      BOTH_MESHES), "around", (0.11, 0.22), 36),
}
TYPES = {"plane": TM.GEOM_PLANE, "hfield": TM.GEOM_HFIELD, "sphere": TM.GEOM_SPHERE,
         "capsule": TM.GEOM_CAPSULE, "ellipsoid": TM.GEOM_ELLIPSOID,
         "cylinder": TM.GEOM_CYLINDER, "box": TM.GEOM_BOX, "mesh": TM.GEOM_MESH}


def _terrain(seed=0):
    """test_hfield_collision.py::_terrain: a smooth random elevation in [0, 1]."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(0.0, 1.0, (NROW, NCOL))
    for _ in range(2):
        z = (z + np.roll(z, 1, 0) + np.roll(z, -1, 0) + np.roll(z, 1, 1)
             + np.roll(z, -1, 1)) / 5.0
    z -= z.min()
    return z / max(z.max(), 1e-9)


def _quat(rng):
    q = rng.randn(4)
    return q / np.linalg.norm(q)


def _poses(recipe, args, seed, n=N_POSES):
    """n free-body qposes: ``around`` a world geom at distances from args[0]
    to args[1] (test_collision_extended.py's recipe), ``above`` a plane
    with the centre at heights args[0]..args[1] (the first pose flat at
    args[2]), or over the ``hfield`` at heights args[0]..args[1]
    (test_hfield_collision.py's recipe)."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        if recipe == "around":
            p = rng.uniform(-1, 1, 3)
            p = p / np.linalg.norm(p) * rng.uniform(*args)
            out.append(np.concatenate([p, _quat(rng)]))
        elif recipe == "above":
            if k == 0:
                out.append(np.array([0.0, 0.0, args[2], 1.0, 0.0, 0.0, 0.0]))
                continue
            p = np.array([rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02),
                          rng.uniform(args[0], args[1])])
            out.append(np.concatenate([p, _quat(rng)]))
        else:
            p = np.concatenate([rng.uniform(-0.35, 0.35, 2), [rng.uniform(*args)]])
            out.append(np.concatenate([p, _quat(rng)]))
    return np.stack(out)


def jax_model(xml):
    """The JAX package's model of a fixture (test_hfield_collision.py's
    terrain written into a height field), built once per fixture."""
    if "hfield" not in xml:
        return build_cached(xml)[1]
    mj = mujoco.MjModel.from_xml_string(xml)
    mj.hfield_data[:] = _terrain().ravel()
    return jspec.model_from_mj(mj, dtype=jnp.float64)


def _carry(jm):
    return tspec.model_from_numpy(tspec.model_to_numpy(jm), device="cpu")


FIELDS = ("contact_dist", "contact_pos", "contact_frame")
# the JAX package's rounding sensitivity: its call again on the qposes
# scaled by these
SPREAD_SCALES = (1.0 + 1e-15, 1.0 - 1e-15)


def both_collide(jm, tm, qpos):
    """The narrowphase on a batch of qposes with zero velocities: the JAX
    package's fields, their spread (jax_spread) and the port's Data. The
    JAX call takes the qposes and their two scaled copies as one batch."""
    n = qpos.shape[0]
    batch = np.concatenate([qpos] + [qpos * s for s in SPREAD_SCALES])
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (len(batch),) + x.shape), jstep.make_data(jm))
    jd = jd.replace(qpos=jnp.asarray(batch))
    js = jax.jit(jax.vmap(lambda d: jC.collision(jm, jstep.fwd_position_smooth(jm, d))))(jd)
    want = {k: np.asarray(getattr(js, k))[:n] for k in FIELDS}
    td = tstep.make_data(tm, n, device="cpu").replace(qpos=torch.as_tensor(qpos))
    return want, jax_spread(js, n), tC.collision(tm, tK.kinematics(tm, td))


def jax_spread(js, n):
    """Per slot and field, how far the JAX package's own output moves when
    the qposes are scaled by SPREAD_SCALES (slots that are off in both
    runs, dist 1e10, move by nothing)."""
    out = {}
    for k in FIELDS:
        a = np.asarray(getattr(js, k)).reshape((1 + len(SPREAD_SCALES), n) + getattr(js, k).shape[1:])
        gap = np.abs(a[1:] - a[0]).max(0)
        out[k] = np.where(np.abs(a[0]) < 1e9, gap, 0.0)
    return out


def assert_slots_match(want, spread, ts, err=""):
    for name in FIELDS:
        got = getattr(ts, name).numpy()
        bound = ATOL + RTOL * np.abs(want[name]) + 2.0 * spread[name]
        bad = np.abs(got - want[name]) > bound
        assert not bad.any(), (f"{err} {name}: {int(bad.sum())} elements, max gap "
                               f"{np.abs(got - want[name])[bad].max():.3e}")


@pytest.mark.parametrize("pair", sorted(FIXTURES))
def test_pair_matches_jax(pair):
    xml, recipe, args, seed = FIXTURES[pair]
    jm = jax_model(xml)
    tm = _carry(jm)
    ta, tb = (TYPES[t] for t in pair.split("-"))
    assert [(int(tm.geom_type[a]), int(tm.geom_type[b]))
            for a, b in zip(tm.pairs.geom1, tm.pairs.geom2)] == [(ta, tb)]
    want, spread, ts = both_collide(jm, tm, _poses(recipe, args, seed))
    dist = want["contact_dist"]
    assert (dist < 0).any() and ((dist > 0) & (dist < 1e9)).any(), pair  # overlapping and clear
    if pair == "plane-box":
        # the flat pose's four deepest are four exact ties, taken in index
        # order by both packages' stable sorts
        np.testing.assert_array_equal(dist[0], np.full(4, dist[0, 0]))
    assert_slots_match(want, spread, ts, pair)


def test_pair_table_is_the_jaxs():
    assert tspec._PAIR_POINTS == {tuple(int(x) for x in k): v
                                  for k, v in jspec._PAIR_POINTS.items()}
    assert len(tspec._PAIR_POINTS) == 29


# ---------------------------------------------------------------------------
# the props scene
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def props():
    """The JAX package's model of props.xml (CG 4/4) and the port's frozen
    file."""
    jm = jspec.build_model(tspec.PROPS_XML, dtype=jnp.float64, solver="cg", iterations=4,
                           ls_iterations=4)
    tm = tspec.load_model(tspec.PROPS_NPZ, device="cpu", solver="cg", iterations=4,
                          ls_iterations=4)
    return jm, tm


def test_props_xml_is_the_generators():
    from brax_tracking_tpu_torch.assets import make_props

    with open(tspec.PROPS_XML) as f:
        assert f.read() == make_props.props_xml()


def test_props_freeze_round_trip(props, tmp_path):
    """A fresh freeze equals the committed file; both and the JAX model
    carried across by model_to_numpy give the same fields."""
    jm, tm = props
    fresh = tspec.freeze_mjcf(tspec.PROPS_XML, str(tmp_path / "p.npz"))
    with np.load(tspec.PROPS_NPZ) as z:
        assert sorted(fresh) == sorted(z.files)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    a, b = tspec.model_to_numpy(_carry(jm)), tspec.model_to_numpy(tm)
    for k in TM.field_keys():
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tm.hfield_patch == jm.hfield_patch > 0 and tm.mesh_vert.shape[0] == 2


def test_props_pair_types(props):
    """The props give the nine pair types that need two moving bodies or a
    plane under a prop."""
    _, tm = props
    t = np.asarray(tm.geom_type)
    got = {(int(t[a]), int(t[b])) for a, b in zip(tm.pairs.geom1, tm.pairs.geom2)}
    want = {(TM.GEOM_PLANE, TM.GEOM_BOX), (TM.GEOM_PLANE, TM.GEOM_CYLINDER),
            (TM.GEOM_PLANE, TM.GEOM_MESH), (TM.GEOM_BOX, TM.GEOM_BOX),
            (TM.GEOM_CYLINDER, TM.GEOM_CYLINDER), (TM.GEOM_CYLINDER, TM.GEOM_BOX),
            (TM.GEOM_BOX, TM.GEOM_MESH), (TM.GEOM_CYLINDER, TM.GEOM_MESH),
            (TM.GEOM_MESH, TM.GEOM_MESH)}
    assert want <= got, want - got


def test_props_collision_matches_jax(props):
    """Seeded poses of the props scene (each prop jittered about its drop
    pose and lowered onto its neighbours): every slot against the JAX
    package."""
    from brax_tracking_tpu_torch.assets import make_props

    jm, tm = props
    qpos = make_props.seeded_qpos(np.asarray(tm.qpos0.numpy()), N_POSES, seed=7)
    want, spread, ts = both_collide(jm, tm, qpos)
    dist = want["contact_dist"]
    assert (dist < 0).any() and ((dist > 0) & (dist < 1e9)).any()
    assert_slots_match(want, spread, ts, "props")
