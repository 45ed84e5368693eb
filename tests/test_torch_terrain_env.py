"""The rodent stand-in's env on a terrain (ROADMAP A.12's meshes and height
fields) against the JAX env, float64 on the CPU (the scene's pieces:
tests/test_torch_terrain.py, whose fixture and helpers this file shares):

- ``RodentSingleClip`` on the scene against the JAX env from the same
  reset (the terrain's contacts active): one control step, and ten
  physics substeps each started from the JAX state, at
  tests/test_torch_rodent_env.py's tolerances plus twice the JAX package's
  own spread (its runs from the qposes scaled by 1 +- 1e-15 and 1 +-
  3e-15: the convex pairs' contact points jump with the normal, so one
  control step of the JAX env moves by ~1e-3 under such a change).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu_torch.physics import collision as tC
from brax_tracking_tpu_torch.physics import kinematics as tK
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep
from test_torch_terrain import ATOL, N, RTOL, SUBSTEPS, T, active_by_type, terrain  # noqa: F401

# the JAX package's rounding sensitivity: its runs again from the reset
# qposes scaled by these
SPREAD_SCALES = (1.0 + 1e-15, 1.0 - 1e-15, 1.0 + 3e-15, 1.0 - 3e-15)


def _spread(runs, key):
    """How far the JAX runs from the scaled qposes land from the first."""
    a = [np.asarray(key(r)) for r in runs]
    return np.max([np.abs(x - a[0]) for x in a[1:]], axis=0)


def _close(want, got, spread=0.0, err=""):
    """|got - want| within ATOL + RTOL |want| + twice the JAX spread."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    gap = np.abs(got - want)
    bad = gap > ATOL + RTOL * np.abs(want) + 2.0 * np.asarray(spread)
    assert not bad.any(), f"{err}: {int(bad.sum())} elements, max gap {gap[bad].max():.3e}"


@pytest.fixture(scope="module")
def envs(terrain):
    """The JAX RodentSingleClip on the scene (with the driver's synthetic
    clip), the port's, and N JAX reset states: the terrain's contacts are
    active there."""
    from brax_tracking_tpu.data import clips as jclips
    from brax_tracking_tpu.envs import rodent as jrodent
    from brax_tracking_tpu_torch.data import clips as tclips
    from brax_tracking_tpu_torch.envs import registry
    from brax_tracking_tpu_torch.harness import config as hc

    jm, tm = terrain
    env_args = dict(hc.load_config(["dataset=rodent"])["dataset"]["env_args"],
                    mjcf_path="builtin:rodent_standin_terrain.xml")
    q = np.tile(np.asarray(jm.qpos0, np.float64), (T, 1))
    q[:, 2] += 0.01
    q[:, 0] += np.linspace(0.0, 0.2, T)
    jc = jax.jit(lambda x: jclips.process_clip(jm, x))(jnp.asarray(q))
    tc = tclips.process_clip(tm, torch.as_tensor(q))
    jenv = jrodent.RodentSingleClip(reference_clip=jc, **dict(
        env_args, mjcf_path=tspec.RODENT_STANDIN_TERRAIN_XML, dtype=jnp.float64))
    tenv = registry.get_environment("rodent_single_clip", reference_clip=tc, device="cpu",
                                    **env_args)
    js = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), N))
    return jenv, tenv, js


def _port_state(tenv, js):
    ps = js.pipeline_state
    return tenv.init_state(torch.as_tensor(np.array(js.info["cur_frame"])),
                           torch.as_tensor(np.array(ps.qpos)), torch.as_tensor(np.array(ps.qvel)))


def _scaled(js, scale):
    return js.replace(pipeline_state=js.pipeline_state.replace(qpos=js.pipeline_state.qpos * scale))


def test_reset_stands_on_the_terrain(envs):
    _, tenv, js = envs
    ts = _port_state(tenv, js)
    m = tenv.model
    d = tC.collision(m, tK.kinematics(m, ts.pipeline_state))
    counts = active_by_type(m, d.contact_dist.numpy())
    assert all(counts.values()), counts
    _close(js.obs, ts.obs, err="obs")


def test_control_step_matches_jax(envs):
    """One control step (5 substeps) from the reset with seeded actions:
    obs, reward, every metric, the frame clocks, qpos, qvel and the
    sensors. The convex pairs' contact point is the midpoint of the two
    support witnesses, a hull vertex or a box corner, which jumps as the
    contact normal crosses a face's normal: over 5 substeps of a rodent
    standing on flat faces the JAX package's own run moves by ~1e-3 when
    its reset qposes move by 1e-15 of themselves, so each field is held at
    tests/test_torch_rodent_env.py's tolerances plus twice that spread."""
    jenv, tenv, js = envs
    a = np.random.RandomState(1).uniform(-1.0, 1.0, (N, tenv.action_size))
    step = jax.jit(jax.vmap(jenv.step))
    runs = [step(s, jnp.asarray(a)) for s in [js] + [_scaled(js, x) for x in SPREAD_SCALES]]
    ts = tenv.step(_port_state(tenv, js), torch.as_tensor(a))
    want = runs[0]
    assert ts.obs.shape == want.obs.shape == (N, tenv.observation_size)
    fields = {"obs": lambda s: s.obs, "reward": lambda s: s.reward,
              **{f"metrics/{k}": (lambda s, k=k: s.metrics[k]) for k in want.metrics},
              **{k: (lambda s, k=k: getattr(s.pipeline_state, k))
                 for k in ("qpos", "qvel", "sensordata")}}
    for name, key in fields.items():
        _close(key(want), key(ts).numpy(), _spread(runs, key), name)
    for key in ("cur_frame", "steps_taken_cur_frame"):
        np.testing.assert_array_equal(ts.info[key].numpy(), np.asarray(want.info[key]))
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(want.done))


def test_substeps_match_jax(envs, terrain):
    """SUBSTEPS physics substeps from the reset with seeded controls, each
    started on both sides from the JAX package's state: qpos, qvel, act and
    the contacts at the rodent env tests' tolerances plus twice the JAX
    package's own spread over the same substep."""
    from brax_tracking_tpu.physics import step as jstep

    jm, tm = terrain
    _, _, js = envs
    step = jax.jit(jax.vmap(lambda d: jstep.step(jm, d)))
    d = js.pipeline_state
    rng = np.random.RandomState(2)
    t = lambda x: torch.as_tensor(np.array(x))
    for k in range(SUBSTEPS):
        d = d.replace(ctrl=jnp.asarray(rng.uniform(-1.0, 1.0, (N, jm.nu))))
        runs = [step(d.replace(qpos=d.qpos * x)) for x in (1.0,) + SPREAD_SCALES]
        td = tstep.make_data(tm, N, device="cpu").replace(
            qpos=t(d.qpos), qvel=t(d.qvel), act=t(d.act), ctrl=t(d.ctrl),
            qacc_warmstart=t(d.qacc_warmstart))
        got = tstep.step(tm, td, device="cpu")
        for name in ("qpos", "qvel", "act", "contact_dist", "contact_pos", "sensordata"):
            key = lambda s, name=name: getattr(s, name)
            _close(key(runs[0]), key(got).numpy(), _spread(runs, key), f"substep {k} {name}")
        d = runs[0]
