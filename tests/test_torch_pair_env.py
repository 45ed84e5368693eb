"""One control step of the rodent_pair tracking env on the two-rat stand-in,
the port against the JAX package, float64 on the CPU.

configs/dataset/rodent_pair.yaml's env args with the stand-in
(``builtin:ratpair.xml``; the JAX env builds the same MJCF from its path),
the driver's synthetic clip, both envs under the training wrappers, reset
from the same JAX state and stepped with the same actions: obs (424 wide)
and reward at atol 1e-10 + rtol 1e-9, done and the frame clocks exactly.
Both sides read root 0's qpos for the root terms and track qpos[7:], rat
1's free joint included, as the JAX env does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.spec as jspec
from brax_tracking_tpu_torch.physics import spec as tspec


@pytest.fixture(scope="module")
def pair_envs():
    """The JAX env and the port's on the stand-in with rodent_pair's env
    args, the driver's synthetic clip (qpos0, lifted 1 cm, root 0 walking
    0.2 m along x), reset from the same JAX state, and one control step of
    the same actions."""
    from brax_tracking_tpu.data import clips as jclips
    from brax_tracking_tpu.envs import tracking as jtracking
    from brax_tracking_tpu.envs import wrappers as jwrappers
    from brax_tracking_tpu_torch.data import clips as tclips
    from brax_tracking_tpu_torch.envs import tracking as ttracking
    from brax_tracking_tpu_torch.envs import wrappers as twrappers
    from brax_tracking_tpu_torch.harness import config as hc

    cfg = hc.load_config(["train=train_pair", "dataset=rodent_pair",
                          "dataset.env_args.mjcf_path=builtin:ratpair.xml"])
    env_args = dict(cfg["dataset"]["env_args"])
    jm = jspec.build_model(tspec.RATPAIR_XML, solver="cg", iterations=4, ls_iterations=4,
                           dtype=jnp.float64)
    T = 32
    qclip = np.tile(np.asarray(jm.qpos0, np.float64), (T, 1))
    qclip[:, 2] += 0.01
    qclip[:, 0] += np.linspace(0.0, 0.2, T)
    jclip = jax.jit(lambda q: jclips.process_clip(jm, q))(jnp.asarray(qclip))
    jenv = jwrappers.wrap(jtracking.GenericSingleClip(
        reference_clip=jclip, dtype=jnp.float64, **dict(env_args, mjcf_path=tspec.RATPAIR_XML)),
        episode_length=1000)
    tm = tspec.load_model(tspec.RATPAIR_NPZ, device="cpu")
    tenv = twrappers.wrap(ttracking.GenericSingleClip(
        reference_clip=tclips.process_clip(tm, torch.as_tensor(qclip)), device="cpu", **env_args),
        episode_length=1000)
    n = 4
    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), n))
    ts = tenv.init_state(torch.as_tensor(np.array(js.info["cur_frame"])),
                         torch.as_tensor(np.array(js.pipeline_state.qpos)),
                         torch.as_tensor(np.array(js.pipeline_state.qvel)))
    a = np.random.RandomState(1).uniform(-1.0, 1.0, (n, tenv.action_size))
    return (js, ts), (jax.jit(jenv.step)(js, jnp.asarray(a)), tenv.step(ts, torch.as_tensor(a)))


def test_pair_env_control_step(pair_envs):
    for js, ts in pair_envs:
        assert ts.obs.shape == js.obs.shape == (4, 424)
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), atol=1e-10, rtol=1e-9)
    js, ts = pair_envs[1]
    np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), atol=1e-10, rtol=1e-9)
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    for key in ("cur_frame", "steps_taken_cur_frame"):
        np.testing.assert_array_equal(ts.info[key].numpy(), np.asarray(js.info[key]))
    # the root terms read root 0 (qpos[:7]); rat 1's root is qpos[74:81],
    # part of the joint vector the JAX env tracks as qpos[7:]
    for key in ("pos_reward", "quat_reward", "joint_reward"):
        np.testing.assert_allclose(ts.metrics[key].numpy(), np.asarray(js.metrics[key]),
                                   atol=1e-10, rtol=1e-9, err_msg=key)
