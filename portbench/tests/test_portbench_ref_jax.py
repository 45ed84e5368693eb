"""The frozen plain engine of the check (``portbench/ref``) against the JAX
package's engine, float64 on the CPU, at both configurations' models.

Each configuration's env as the check builds it (its frozen model file,
its env args, the synthetic clip, the training wrappers), and the JAX
package's env built from the stand-in's MJCF with the same args and clip,
reset from the same JAX state and stepped STEPS control steps (5 substeps
each) with the same seeded actions: observations, rewards and done flags
at every step at atol 1e-8 + rtol 1e-7. The bodies reach the floor by the
third step, so the last steps cover the solve's contact rows; the test
checks that they carry a force. This test imports JAX; a benchmark run
never does.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from portbench import check, harness  # noqa: E402

STEPS, N = 5, 4
ATOL, RTOL = 1e-8, 1e-7


def _jax_env(config, xml):
    """The JAX package's env of ``config`` on the MJCF ``xml``, with the
    check's synthetic clip, under the training wrappers."""
    import brax_tracking_tpu.physics.spec as jspec
    from brax_tracking_tpu.data import clips as jclips
    from brax_tracking_tpu.envs import registry as jregistry
    from brax_tracking_tpu.envs import wrappers as jwrappers

    args = config["env_args"]
    jm = jspec.build_model(xml, solver=args["solver"], iterations=args["iterations"],
                           ls_iterations=args["ls_iterations"],
                           scale_factor=args.get("scale_factor", 1.0), dtype=jnp.float64)
    ds = config["dataset"]
    qclip = check.synthetic_clip_qpos(np.asarray(jm.qpos0), ds["clip_length"])
    clip = jax.jit(lambda q: jclips.process_clip(jm, q, dt=1.0 / ds["mocap_hz"]))(
        jnp.asarray(qclip))
    env = jregistry.get_environment(config["env_name"], reference_clip=clip, mocap_hz=ds["mocap_hz"],
                                    ref_len=ds["ref_traj_length"], dtype=jnp.float64,
                                    **dict(args, mjcf_path=xml))
    return jwrappers.wrap(env, episode_length=harness.episode_length(config),
                          action_repeat=config["action_repeat"])


@pytest.fixture(scope="module", params=["rodent.flat", "pair.flat"])
def trajectories(request):
    from brax_tracking_tpu_torch.physics import spec as tspec

    from portbench.ref.physics import constraint

    _, _, traffic, config = harness.load_cell(request.param)
    xml = {"rodent": tspec.RODENT_STANDIN_XML, "pair": tspec.RATPAIR_XML}[config["name"]]
    jenv = _jax_env(config, xml)
    renv = check.reference_env(config, traffic, torch.arange(N), None, "cpu", torch.float64)
    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(3), N))
    rs = renv.init_state(torch.as_tensor(np.array(js.info["cur_frame"])),
                         torch.as_tensor(np.array(js.pipeline_state.qpos)),
                         torch.as_tensor(np.array(js.pipeline_state.qvel)))
    out = [(js, rs, 0)]
    rng = np.random.RandomState(11)
    step = jax.jit(jenv.step)
    contact = np.nonzero(constraint.efc_layout(renv.model).row_type != constraint.ROW_LIMIT)[0]
    for _ in range(STEPS):
        a = np.tanh(0.5 * rng.standard_normal((N, renv.action_size)))
        js, rs = step(js, jnp.asarray(a)), renv.step(rs, torch.as_tensor(a))
        out.append((js, rs, int((rs.pipeline_state.efc_force[:, contact.tolist()] > 0).sum())))
    return request.param, out


@pytest.mark.parametrize("k", range(STEPS + 1))
def test_frozen_engine_matches_jax(trajectories, k):
    _, out = trajectories
    js, rs, _ = out[k]
    np.testing.assert_allclose(rs.obs.numpy(), np.asarray(js.obs), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rs.reward.numpy(), np.asarray(js.reward), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(rs.done.numpy(), np.asarray(js.done))


def test_contact_rows_carry_force(trajectories):
    _, out = trajectories
    assert out[-1][2] > 0
