"""The port's minirat tracking env against the JAX package's, f64 on the CPU.

Same synthetic clip, same reset states and the same actions (numpy, from a
seed) go through the JAX ``GenericSingleClip`` under ``wrap`` (vmapped) and
the port's ``GenericSingleClip`` (frozen model file) under its ``wrap``;
obs, reward and done must agree over 5 control steps (50 physics
substeps), including auto-resets (episode truncation at step 3 and
too-far terminations).

Tolerance: atol 1e-10 + rtol 1e-9 on obs and reward; done and the
episode/frame clocks exactly. Both sides run the same algorithms in
float64; they differ in summation order only, which after 50 substeps
leaves gaps of ~5e-14 on this seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tracking_tpu.data import clips as jclips
from brax_tracking_tpu.envs import tracking as jtracking
from brax_tracking_tpu.envs import wrappers as jwrappers
from brax_tracking_tpu.physics import spec as jspec
from brax_tracking_tpu_torch.data import clips as tclips
from brax_tracking_tpu_torch.envs import tracking as ttracking
from brax_tracking_tpu_torch.envs import wrappers as twrappers
from brax_tracking_tpu_torch.physics import spec as tspec

ATOL, RTOL = 1e-10, 1e-9
B, STEPS, EPISODE = 8, 5, 3

# configs/dataset/minirat.yaml env_args
ENV_ARGS = dict(
    mjcf_path="builtin:minirat.xml",
    scale_factor=1.0,
    solver="cg",
    iterations=4,
    ls_iterations=4,
    torque_actuators=False,
    physics_steps_per_control_step=10,
    too_far_dist=0.1,
    bad_pose_dist=1000.0,
    bad_quat_dist=1000.0,
    ctrl_cost_weight=0.01,
    pos_reward_weight=1.0,
    quat_reward_weight=1.0,
    joint_reward_weight=10.0,
    angvel_reward_weight=1.0,
    bodypos_reward_weight=1.0,
    endeff_reward_weight=1.0,
    healthy_reward=0.25,
    healthy_z_range=(0.02, 0.5),
    terminate_when_unhealthy=True,
    free_jnt=True,
    center_of_mass="torso",
    strict_name_lookup=True,
    end_eff_names=["leg_FL", "leg_FR", "leg_BL", "leg_BR"],
    appendage_names=["leg_FL", "leg_FR", "leg_BL", "leg_BR"],
    body_names=["torso", "leg_FL", "leg_FR", "leg_BL", "leg_BR"],
    joint_names=["hip_FL", "hip_FR", "hip_BL", "hip_BR"],
)


def _synth_qpos(qpos0, T=64, walk=1.0):
    """bench.py's synthetic clip: qpos0, lifted 1 cm, walking along x."""
    qpos = np.tile(np.asarray(qpos0, np.float64), (T, 1))
    qpos[:, 2] += 0.01
    qpos[:, 0] += np.linspace(0.0, walk, T)
    return qpos


@pytest.fixture(scope="module")
def rollouts():
    jm = jspec.build_model(
        "builtin:minirat.xml", solver="cg", iterations=4, ls_iterations=4,
        dtype=jnp.float64,
    )
    qclip = _synth_qpos(jm.qpos0)
    # jitted: one compile instead of the eager vmap's many small ones
    jclip = jax.jit(lambda q: jclips.process_clip(jm, q))(jnp.asarray(qclip))
    jenv = jtracking.GenericSingleClip(
        reference_clip=jclip,
        dtype=jnp.float64, **ENV_ARGS,
    )
    jenv = jwrappers.wrap(jenv, episode_length=EPISODE)
    tm = tspec.load_model(device="cpu")
    tenv = ttracking.GenericSingleClip(
        reference_clip=tclips.process_clip(tm, torch.as_tensor(qclip)),
        device="cpu", **ENV_ARGS,
    )
    tenv = twrappers.wrap(tenv, episode_length=EPISODE)

    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    ts = tenv.init_state(
        torch.as_tensor(np.array(js.info["cur_frame"])),
        torch.as_tensor(np.array(js.pipeline_state.qpos)),
        torch.as_tensor(np.array(js.pipeline_state.qvel)),
    )
    out = [(js, ts)]
    rng = np.random.RandomState(1)
    jstep = jax.jit(jenv.step)
    for _ in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (B, tenv.action_size))
        js = jstep(js, jnp.asarray(a))
        ts = tenv.step(ts, torch.as_tensor(a))
        out.append((js, ts))
    return out


def _close(j, t, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **kw)


def test_reset_obs_matches(rollouts):
    js, ts = rollouts[0]
    assert ts.obs.shape == js.obs.shape
    _close(js.obs, ts.obs, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", range(1, STEPS + 1))
def test_step_matches(rollouts, k):
    js, ts = rollouts[k]
    _close(js.obs, ts.obs, atol=ATOL, rtol=RTOL)
    _close(js.reward, ts.reward, atol=ATOL, rtol=RTOL)
    _close(js.done, ts.done, atol=0, rtol=0)
    for key in ("cur_frame", "steps_taken_cur_frame", "steps", "truncation"):
        _close(js.info[key], ts.info[key], atol=0, rtol=0)


def test_rollout_covers_auto_reset(rollouts):
    """The 5 steps must include rollbacks, or the parity above would not
    exercise AutoResetWrapperTracking."""
    dones = np.stack([np.asarray(js.done) for js, _ in rollouts[1:]])
    assert dones[EPISODE - 1].all()  # truncation
    assert dones[: EPISODE - 1].any()  # an early too-far termination
    assert not dones.all()
