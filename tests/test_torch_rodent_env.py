"""The rodent tracking envs on the rodent stand-in, the port against the JAX
package, float64 on the CPU.

configs/dataset/rodent.yaml's env args with the stand-in
(``builtin:rodent_standin.xml``: the port loads its frozen file, the JAX
env builds and rescales the same MJCF from its path), the driver's
synthetic clips (qpos0 lifted 1 cm, walking away), both envs reset from
the same JAX state (the JAX env vmapped) and stepped STEPS control
steps (5 substeps each) with the same seeded actions: obs, reward, every metric and the distances at
atol 1e-10 + rtol 1e-9, done and the frame clocks exactly, and the
sensors of the last substep at the same tolerances. ``RodentMultiClip``
likewise over three clips, its JAX reset pinned to each env's clip (as
tests/test_torch_multiclip.py does, ROADMAP C). Both through
``registry.get_environment``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import brax_tracking_tpu.physics.spec as jspec
from brax_tracking_tpu_torch.physics import spec as tspec

ATOL, RTOL = 1e-10, 1e-9
N, STEPS, T = 2, 3, 32
CLIP_IDX = np.array([2, 1], np.int32)
N_CLIPS = 3


def _walk(qpos0, ang, dist=0.2):
    q = np.tile(np.asarray(qpos0, np.float64), (T, 1))
    q[:, 2] += 0.01
    q[:, 0] += np.cos(ang) * np.linspace(0.0, dist, T)
    q[:, 1] += np.sin(ang) * np.linspace(0.0, dist, T)
    return q


def _rollout(multi):
    """The JAX env and the port's, reset from the same JAX state, then STEPS
    control steps: [(JAX state, port state)] from the reset on."""
    from brax_tracking_tpu.data import clips as jclips
    from brax_tracking_tpu.envs import rodent as jrodent
    from brax_tracking_tpu_torch.data import clips as tclips
    from brax_tracking_tpu_torch.envs import registry
    from brax_tracking_tpu_torch.harness import config as hc

    env_args = dict(hc.load_config(["dataset=rodent"])["dataset"]["env_args"],
                    mjcf_path="builtin:rodent_standin.xml")
    jm = jspec.build_model(tspec.RODENT_STANDIN_XML, solver="cg", iterations=4,
                           ls_iterations=4, scale_factor=0.9, dtype=jnp.float64)
    tm = tspec.load_model(tspec.RODENT_STANDIN_NPZ, device="cpu")
    qs = [_walk(jm.qpos0, 2 * np.pi * i / N_CLIPS) for i in range(N_CLIPS if multi else 1)]
    proc = jax.jit(lambda q: jclips.process_clip(jm, q))
    jc = [proc(jnp.asarray(q)) for q in qs]
    tc = [tclips.process_clip(tm, torch.as_tensor(q)) for q in qs]
    jargs = dict(env_args, mjcf_path=tspec.RODENT_STANDIN_XML, dtype=jnp.float64)
    if multi:
        from brax_tracking_tpu.envs import tracking as jtracking

        class Pinned(jrodent.RodentMultiClip):
            """``reset((clip_idx, key))`` is ``reset_to_clip``, its reset
            observation read from the env's own clip."""

            def reset(self, rng):
                clip_idx, key = rng
                return self.reset_to_clip(clip_idx, key)

            def reset_to_frame(self, start_frame, rng1, rng2):
                return jtracking.TrackingEnv.reset_to_frame(self, start_frame, rng1, rng2)

        jenv = Pinned(reference_clip=jclips.stack_clips(jc), **jargs)
        tenv = registry.get_environment("rodent_multi_clip", reference_clip=tclips.stack_clips(tc),
                                        device="cpu", **env_args)
        js = jax.jit(jax.vmap(jenv.reset))((jnp.asarray(CLIP_IDX),
                                            jax.random.split(jax.random.PRNGKey(0), N)))
        extra = (torch.as_tensor(np.array(js.info["clip_idx"])),)
    else:
        jenv = jrodent.RodentSingleClip(reference_clip=jc[0], **jargs)
        tenv = registry.get_environment("rodent_single_clip", reference_clip=tc[0],
                                        device="cpu", **env_args)
        js = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), N))
        extra = ()
    ts = tenv.init_state(torch.as_tensor(np.array(js.info["cur_frame"])),
                         torch.as_tensor(np.array(js.pipeline_state.qpos)),
                         torch.as_tensor(np.array(js.pipeline_state.qvel)), *extra)
    out = [(js, ts)]
    rng = np.random.RandomState(1)
    step = jax.jit(jax.vmap(jenv.step))
    for _ in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (N, tenv.action_size))
        js, ts = step(js, jnp.asarray(a)), tenv.step(ts, torch.as_tensor(a))
        out.append((js, ts))
    return tenv, out


@pytest.fixture(scope="module", params=["single", "multi"])
def rollout(request):
    return request.param, *_rollout(request.param == "multi")


def _close(j, t, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **kw)


def test_env_is_the_rodents(rollout):
    from brax_tracking_tpu_torch.envs import rodent

    kind, tenv, _ = rollout
    assert type(tenv) is {"single": rodent.RodentSingleClip, "multi": rodent.RodentMultiClip}[kind]
    m = tenv.model
    assert (m.nq, m.nv, m.nu, m.nsensor) == (74, 73, 38, 8)
    assert tenv._n_frames == 5 and tenv._include_root_obs and not tenv._joint_full_qpos


@pytest.mark.parametrize("k", range(STEPS + 1))
def test_control_steps_match_jax(rollout, k):
    kind, tenv, out = rollout
    js, ts = out[k]
    assert ts.obs.shape == js.obs.shape == (N, tenv.observation_size)
    _close(js.obs, ts.obs, atol=ATOL, rtol=RTOL)
    _close(js.reward, ts.reward, atol=ATOL, rtol=RTOL)
    _close(js.done, ts.done, atol=0, rtol=0)
    assert js.metrics.keys() == ts.metrics.keys()
    for key in js.metrics:
        _close(js.metrics[key], ts.metrics[key], atol=ATOL, rtol=RTOL, err_msg=key)
    for key in ("summed_pos_distance", "quat_distance", "joint_distance"):
        _close(js.info[key], ts.info[key], atol=ATOL, rtol=RTOL, err_msg=key)
    for key in ("cur_frame", "steps_taken_cur_frame") + (("clip_idx",) if kind == "multi" else ()):
        _close(js.info[key], ts.info[key], atol=0, rtol=0, err_msg=key)
    if k:
        _close(js.pipeline_state.sensordata, ts.pipeline_state.sensordata, atol=ATOL, rtol=RTOL)
        assert torch.isfinite(ts.pipeline_state.sensordata).all()
