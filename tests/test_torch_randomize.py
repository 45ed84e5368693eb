"""Per-env randomized models (envs/wrappers.py DomainRandomizationVmapWrapper),
the port against the JAX package, float64 on the CPU.

- Every parameter leaf the JAX package's wrapper can batch on the solve
  kernel's path (all but the ones ``solver.static_leaves`` lists, and the
  empty ones) gets one value per env at once: the leaf times 0.97, 0.99,
  1.01 and 1.03 over 4 envs. The JAX env under its
  ``DomainRandomizationVmapWrapper`` and the port's under its own, the
  minirat tracking env and the rodent stand-in's ``RodentSingleClip``: the
  JAX reset, then 3 control steps with the same seeded actions; obs,
  reward, qpos and qvel at atol 1e-10 + rtol 1e-9 (the env tests'
  tolerance), done exactly.
- A batch whose every per-env value equals the shared model's steps bit
  for bit as the unrandomized port (both envs, every leaf batched).
- Each leaf a solve path reads as a per-model constant raises by name in
  the port; ``dof_damping`` on the minirat raises in the JAX wrapper too.

The array paths, the narrowphase and the trainer with per-env models:
test_torch_randomize_paths.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu.data import clips as jclips
from brax_tracking_tpu.envs import rodent as jrodent
from brax_tracking_tpu.envs import tracking as jtracking
from brax_tracking_tpu.envs import wrappers as jwrappers
from brax_tracking_tpu.physics import spec as jspec
from brax_tracking_tpu_torch.data import clips as tclips
from brax_tracking_tpu_torch.envs import registry
from brax_tracking_tpu_torch.envs import tracking as ttracking
from brax_tracking_tpu_torch.envs import wrappers as twrappers
from brax_tracking_tpu_torch.harness import config as hc
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import solver as TS
from brax_tracking_tpu_torch.physics import spec as tspec

ATOL, RTOL = 1e-10, 1e-9
N, STEPS, EPISODE = 4, 3, 1000
SCALES = np.array([0.97, 0.99, 1.01, 1.03])
MINIRAT_ARGS = dict(
    hc.load_config(["dataset=minirat"])["dataset"]["env_args"], strict_name_lookup=True)


def _synth(qpos0, T=32, walk=0.2):
    q = np.tile(np.asarray(qpos0, np.float64), (T, 1))
    q[:, 2] += 0.01
    q[:, 0] += np.linspace(0.0, walk, T)
    return q


def _envs(kind):
    """(JAX env, port env), unwrapped, on the same clip."""
    if kind == "minirat":
        jm = jspec.build_model("builtin:minirat.xml", solver="cg", iterations=4,
                               ls_iterations=4, dtype=jnp.float64)
        tm = tspec.load_model(device="cpu")
        q = _synth(jm.qpos0)
        jc = jax.jit(lambda x: jclips.process_clip(jm, x))(jnp.asarray(q))
        jenv = jtracking.GenericSingleClip(reference_clip=jc, dtype=jnp.float64, **MINIRAT_ARGS)
        tenv = ttracking.GenericSingleClip(
            reference_clip=tclips.process_clip(tm, torch.as_tensor(q)), device="cpu",
            **MINIRAT_ARGS)
        return jenv, tenv
    args = dict(hc.load_config(["dataset=rodent"])["dataset"]["env_args"],
                mjcf_path="builtin:rodent_standin.xml")
    jm = jspec.build_model(tspec.RODENT_STANDIN_XML, solver="cg", iterations=4,
                           ls_iterations=4, scale_factor=0.9, dtype=jnp.float64)
    tm = tspec.load_model(tspec.RODENT_STANDIN_NPZ, device="cpu")
    q = _synth(jm.qpos0)
    jc = jax.jit(lambda x: jclips.process_clip(jm, x))(jnp.asarray(q))
    jenv = jrodent.RodentSingleClip(
        reference_clip=jc, **dict(args, mjcf_path=tspec.RODENT_STANDIN_XML, dtype=jnp.float64))
    tenv = registry.get_environment(
        "rodent_single_clip", reference_clip=tclips.process_clip(tm, torch.as_tensor(q)),
        device="cpu", **args)
    return jenv, tenv


def _accepted(tm):
    """The leaves randomized at once: every parameter leaf of the port's
    model the kernel path does not read as a constant, and not empty."""
    static = TS.static_leaves(tm)
    return [n for n in TM.param_leaves() if n not in static and tm.leaf(n).numel()]


def _jax_leaf(jm, name):
    group, _, leaf = name.rpartition(".")
    return getattr(getattr(jm, group) if group else jm, leaf)


def _jax_randomization(names, values):
    """The JAX contract: randomization_fn(model) -> (batched model, in_axes)."""

    def fn(jm):
        axes = jax.tree.map(lambda _: None, jm)
        top, top_ax = {}, {}
        groups = {"opt": ({}, {}), "pairs": ({}, {})}
        for n in names:
            group, _, leaf = n.rpartition(".")
            vals, ax = groups[group] if group else (top, top_ax)
            vals[leaf], ax[leaf] = jnp.asarray(values[n]), 0
        for g, (vals, ax) in groups.items():
            if vals:
                top[g] = getattr(jm, g).replace(**vals)
                top_ax[g] = getattr(axes, g).replace(**ax)
        return jm.replace(**top), axes.replace(**top_ax)

    return fn


def _port_randomization(values):
    def fn(tm):
        v = {n: torch.as_tensor(x) for n, x in values.items()}
        return TM.replace_leaves(tm, v), v.keys()

    return fn


def _scaled(tm, names):
    return {n: tm.leaf(n).numpy()[None] * SCALES.reshape((N,) + (1,) * tm.leaf(n).dim())
            for n in names}


@pytest.fixture(scope="module", params=["minirat", "rodent"])
def rollout(request):
    jenv, tenv = _envs(request.param)
    tm = tenv.unwrapped.model
    names = _accepted(tm)
    for n in names:
        assert _jax_leaf(jenv.unwrapped.model, n).shape == tuple(tm.leaf(n).shape), n
    values = _scaled(tm, names)
    jw = jwrappers.wrap(jenv, episode_length=EPISODE,
                        randomization_fn=_jax_randomization(names, values))
    tw = twrappers.wrap(tenv, episode_length=EPISODE, randomization_fn=_port_randomization(values))
    js = jax.jit(jw.reset)(jax.random.split(jax.random.PRNGKey(0), N))
    ts = tw.init_state(torch.as_tensor(np.array(js.info["cur_frame"])),
                       torch.as_tensor(np.array(js.pipeline_state.qpos)),
                       torch.as_tensor(np.array(js.pipeline_state.qvel)))
    out = [(js, ts)]
    rng = np.random.RandomState(1)
    step = jax.jit(jw.step)
    for _ in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (N, tw.action_size))
        js, ts = step(js, jnp.asarray(a)), tw.step(ts, torch.as_tensor(a))
        out.append((js, ts))
    return request.param, names, tenv, out


def _close(j, t, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **kw)


def test_every_accepted_leaf_is_randomized(rollout):
    kind, names, tenv, _ = rollout
    assert len(names) >= 40 and "dof_armature" in names and "opt.gravity" in names
    # the unwrapped env holds its shared model again after every call
    assert tenv.unwrapped.model.nenv == 0 and not tenv.unwrapped.model.env_leaves


@pytest.mark.parametrize("k", range(STEPS + 1))
def test_randomized_steps_match_jax(rollout, k):
    _, _, _, out = rollout
    js, ts = out[k]
    _close(js.obs, ts.obs, atol=ATOL, rtol=RTOL)
    _close(js.reward, ts.reward, atol=ATOL, rtol=RTOL)
    _close(js.done, ts.done, atol=0, rtol=0)
    for f in ("qpos", "qvel"):
        _close(getattr(js.pipeline_state, f), getattr(ts.pipeline_state, f), atol=ATOL,
               rtol=RTOL, err_msg=f)
    if k:
        # the envs really differ: the scaled leaves move the states apart
        q = ts.pipeline_state.qvel
        assert float((q[0] - q[-1]).abs().max()) > 1e-6


@pytest.mark.parametrize("kind", ["minirat", "rodent"])
def test_equal_values_batch_is_bitwise_the_shared_model(kind):
    """Every accepted leaf batched with each env's value the shared one's:
    reset and 2 control steps bit for bit as without the wrapper's model."""
    if kind == "minirat":
        tm = tspec.load_model(device="cpu")
        q = _synth(tm.qpos0.numpy())
        mk = lambda: ttracking.GenericSingleClip(
            reference_clip=tclips.process_clip(tm, torch.as_tensor(q)), device="cpu",
            **MINIRAT_ARGS)
    else:
        args = dict(hc.load_config(["dataset=rodent"])["dataset"]["env_args"],
                    mjcf_path="builtin:rodent_standin.xml")
        tm = tspec.load_model(tspec.RODENT_STANDIN_NPZ, device="cpu")
        q = _synth(tm.qpos0.numpy())
        mk = lambda: registry.get_environment(
            "rodent_single_clip", reference_clip=tclips.process_clip(tm, torch.as_tensor(q)),
            device="cpu", **args)
    names = _accepted(tm)
    equal = {n: tm.leaf(n).numpy()[None].repeat(N, 0) for n in names}
    runs = []
    for rfn in (None, _port_randomization(equal)):
        env = twrappers.wrap(mk(), episode_length=EPISODE, randomization_fn=rfn)
        g = torch.Generator().manual_seed(3)
        s = env.reset(g, N)
        states = [s]
        for i in range(2):
            a = torch.as_tensor(np.random.RandomState(i).uniform(-1, 1, (N, env.action_size)))
            s = env.step(s, a)
            states.append(s)
        runs.append(states)
    for s0, s1 in zip(*runs):
        for a, b in ((s0.obs, s1.obs), (s0.reward, s1.reward)):
            assert torch.equal(a, b)
        t0, t1 = s0.pipeline_state.tensors(), s1.pipeline_state.tensors()
        assert t0.keys() == t1.keys()
        for key in t0:
            assert torch.equal(t0[key], t1[key]), key


@pytest.mark.parametrize("leaf", ["opt.timestep", "opt.tolerance", "opt.meaninertia",
                                  "dof_damping", "pairs.friction", "jnt_range"])
def test_static_leaves_raise_by_name(leaf):
    """On the kernel path (the minirat) and, for jnt_range, the array path
    of a model with ball-joint limits (the ball-coxa fly stand-in)."""
    npz = tspec.FLY_STANDIN_BALL_NPZ if leaf == "jnt_range" else tspec.MINIRAT_NPZ
    tm = tspec.load_model(npz, device="cpu")
    assert leaf in TS.static_leaves(tm)
    v = tm.leaf(leaf)[None].repeat((N,) + (1,) * tm.leaf(leaf).dim())
    base_env = type("E", (), {"model": tm, "unwrapped": property(lambda self: self)})()
    with pytest.raises(NotImplementedError, match=leaf.replace(".", r"\.")):
        twrappers.DomainRandomizationVmapWrapper(
            base_env, lambda m: (TM.replace_leaves(m, {leaf: v}), [leaf]))
    # the array paths read the kernel path's constants per env (the JAX
    # package's do too): an undamped model off the kernel layout takes them
    # (a damped one under CG raises for damping and timestep:
    # test_torch_randomize_paths.py)
    if leaf != "jnt_range":
        fly = tspec.load_model(tspec.FLY_STANDIN_BALL_NPZ, device="cpu")
        assert leaf not in TS.static_leaves(fly)


def test_a_static_leaf_raises_in_the_jax_wrapper_too():
    jenv, _ = _envs("minirat")

    def fn(m):
        axes = jax.tree.map(lambda _: None, m)
        return (m.replace(dof_damping=m.dof_damping[None] * jnp.ones((2, 1))),
                axes.replace(dof_damping=0))

    env = jwrappers.DomainRandomizationVmapWrapper(jwrappers.EpisodeWrapper(jenv, 10, 1), fn)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax.jit(env.reset)(jax.random.split(jax.random.PRNGKey(0), 2))


def test_bad_randomizations_raise():
    tm = tspec.load_model(device="cpu")
    env = type("E", (), {"model": tm, "unwrapped": property(lambda self: self)})()
    mass = tm.body_mass[None].repeat(N, 1)
    cases = [
        (lambda m: (TM.replace_leaves(m, {"body_mass": mass}), ["no_such_leaf"]), "not a parameter"),
        (lambda m: (TM.replace_leaves(m, {"body_mass": mass[:, :2]}), ["body_mass"]), "shape"),
        (lambda m: (TM.replace_leaves(m, {"body_mass": mass, "geom_size": tm.geom_size[None]}),
                    ["body_mass", "geom_size"]), "one env count"),
        (lambda m: m, "must return"),
    ]
    for fn, match in cases:
        with pytest.raises((ValueError, TypeError), match=match):
            twrappers.DomainRandomizationVmapWrapper(env, fn)
    w = twrappers.DomainRandomizationVmapWrapper(
        env, lambda m: (TM.replace_leaves(m, {"body_mass": mass}), ["body_mass"]))
    with pytest.raises(ValueError, match="holds 4 envs"):
        w.reset(torch.Generator(), N + 1)
