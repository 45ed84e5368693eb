"""The fly tracking envs on the fly stand-in, the port against the JAX
package, float64 on the CPU.

configs/dataset/fly.yaml's and fly_freejnt.yaml's env args with the stand-in
(``builtin:fly_standin.xml``: the port loads its frozen file for the env's
``free_jnt``, the JAX env builds the same MJCF from its path and strips
the free joint itself), the clip of the stand-in's stac export for the
env's width (the first T frames through ``process_clip_to_train`` on each
side), both envs reset from the same JAX state (the JAX env vmapped) and
stepped STEPS control steps (5 substeps each) with the same seeded
actions: obs, reward, every metric and the distances at atol 1e-10 + rtol
1e-9, done and the frame clocks exactly. Both through
``registry.get_environment``. The tethered fly is the first env of the
port whose root has no free joint: its joint observations span the full
qpos, it has no root terms, and its contacts move leg dofs only.

The envs run the configs' 4 CG iterations with LS_ITERS line-search steps
(the stand-in frozen so into a temporary file; the JAX env built so): at
the configs' 4 steps, once a line search has converged to the last ulp,
the sign of phi''s float64 rounding noise (~1e-10, above the absolute
freeze tolerance 3.6e-12) picks between a collapsed bracket and a
bisection back into it, in both packages alike, and the two drift apart
(ROADMAP C; tests/test_torch_fly.py pins it). With LS_ITERS steps the
bisection re-converges on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.spec as jspec
from brax_tracking_tpu_torch.physics import spec as tspec

ATOL, RTOL = 1e-10, 1e-9
N, STEPS, T = 2, 3, 64
LS_ITERS = 50
# env name -> (dataset config, stac export)
FLIES = {
    "fly_single_clip": ("fly", tspec.FLY_STANDIN_TETHERED_STAC),
    "fly_single_clip_freejnt": ("fly_freejnt", tspec.FLY_STANDIN_STAC),
}


def _rollout(name, tmp):
    """The JAX env and the port's, reset from the same JAX state, then STEPS
    control steps: [(JAX state, port state)] from the reset on."""
    from brax_tracking_tpu.data import clips as jclips
    from brax_tracking_tpu.envs import fly as jfly
    from brax_tracking_tpu_torch.data import clips as tclips
    from brax_tracking_tpu_torch.envs import registry
    from brax_tracking_tpu_torch.harness import config as hc

    dataset, stac = FLIES[name]
    env_args = hc.load_config([f"dataset={dataset}"])["dataset"]["env_args"]
    free = env_args["free_jnt"]
    assert (env_args["iterations"], env_args["ls_iterations"]) == (4, 4)
    npz = str(tmp / f"{name}.npz")
    tspec.freeze_mjcf(tspec.FLY_STANDIN_XML, npz, free_jnt=free, ls_iterations=LS_ITERS)
    env_args = dict(env_args, mjcf_path=npz, ls_iterations=LS_ITERS)
    jm = jspec.build_model(tspec.FLY_STANDIN_XML, free_jnt=free, solver="cg", iterations=4,
                           ls_iterations=LS_ITERS, dtype=jnp.float64)
    tm = tspec.load_model(npz, device="cpu", free_jnt=free)
    # the JAX clip with its process_clip jitted (eagerly it takes ~15 s)
    eager = jclips.process_clip
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jclips, "process_clip",
                   lambda m, q, **k: jax.jit(lambda x: eager(m, x, **k))(q))
        jc = jclips.process_clip_to_train(stac, jm, clip_length=T)
    tc = tclips.process_clip_to_train(stac, tm, clip_length=T)
    jargs = dict(env_args, mjcf_path=tspec.FLY_STANDIN_XML, dtype=jnp.float64)
    jenv = (jfly.FlyFreeJoint if free else jfly.FlyTethered)(reference_clip=jc, **jargs)
    tenv = registry.get_environment(name, reference_clip=tc, device="cpu", **env_args)
    js = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), N))
    ts = tenv.init_state(torch.as_tensor(np.array(js.info["cur_frame"])),
                         torch.as_tensor(np.array(js.pipeline_state.qpos)),
                         torch.as_tensor(np.array(js.pipeline_state.qvel)))
    out = [(js, ts)]
    rng = np.random.RandomState(1)
    step = jax.jit(jax.vmap(jenv.step))
    for _ in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (N, tenv.action_size))
        js, ts = step(js, jnp.asarray(a)), tenv.step(ts, torch.as_tensor(a))
        out.append((js, ts))
    return tenv, out


@pytest.fixture(scope="module", params=sorted(FLIES))
def rollout(request, tmp_path_factory):
    return request.param, *_rollout(request.param, tmp_path_factory.mktemp("fly"))


def _close(j, t, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **kw)


def test_env_is_the_flys(rollout):
    """The registry's class, the stand-in's widths, fly.yaml's 5 substeps,
    the tethered fly's observation over the full qpos without root terms,
    the free fly's root terms, the configs' misspelt joint names missing."""
    from brax_tracking_tpu_torch.envs import fly

    name, tenv, _ = rollout
    free = name.endswith("freejnt")
    assert type(tenv) is (fly.FlyFreeJoint if free else fly.FlyTethered)
    m = tenv.model
    assert (m.nq, m.nv, m.nu) == ((43, 42, 36) if free else (36, 36, 36))
    assert tenv._n_frames == 5 and m.has_fluid and not m.has_damping
    assert tenv._include_root_obs == free and tenv._joint_full_qpos == (not free)
    assert int((tenv._joint_idxs < 0).sum()) == 11  # the config's eleven misspelt names
    L = tenv._ref_len
    assert tenv.observation_size == (m.nq + m.nv + (7 * L if free else 0) + 36 * L
                                     + 3 * 67 * L)


@pytest.mark.parametrize("k", range(STEPS + 1))
def test_control_steps_match_jax(rollout, k):
    name, tenv, out = rollout
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
    for key in ("cur_frame", "steps_taken_cur_frame"):
        _close(js.info[key], ts.info[key], atol=0, rtol=0, err_msg=key)
    if k:
        _close(js.pipeline_state.qpos, ts.pipeline_state.qpos, atol=ATOL, rtol=RTOL)
        # the claws on the floor: contact rows active
        assert bool((ts.pipeline_state.efc_force[:, 36:] != 0).any())
