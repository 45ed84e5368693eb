"""Per-env randomized models off the kernel layout, in the narrowphase and
in the trainer, float64 on the CPU (the wrapper against the JAX package:
test_torch_randomize.py).

- The array solve paths take per env the leaves the kernel path reads as
  constants (timestep, tolerance, meaninertia, damping, friction): the
  ballmuscle under CG and Newton and the ball-coxa fly's Newton copy, 3
  substeps against the JAX step on each env's own model. The damped XLA-CG
  path (the ballmuscle under CG) raises for damping and timestep instead:
  the JAX wrapper steps every env there with env 0's damped inverse.
- Every collision pair type reads its geometry per env (the props and the
  terrain stand-in), against the JAX ``collision`` vmapped over the same
  per-env leaves.
- The solve kernel's plain version takes a per-env armature.
- ``train(randomization_fn=...)`` trains a few steps on the minirat.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu.physics import spec as jspec
from brax_tracking_tpu_torch.data import clips as tclips
from brax_tracking_tpu_torch.envs import tracking as ttracking
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import solver as TS
from brax_tracking_tpu_torch.physics import spec as tspec
from test_torch_randomize import (MINIRAT_ARGS, N, SCALES, _jax_randomization,
                                  _port_randomization, _synth)


ARRAY_CASES = {
    # model, the leaves the kernel path reads as constants plus a few more
    "ballmuscle_cg": (tspec.BALLMUSCLE_XML, tspec.BALLMUSCLE_NPZ["cg"],
                      dict(solver="cg", **tspec.BALLMUSCLE_OPTIONS)),
    "ballmuscle_newton": (tspec.BALLMUSCLE_XML, tspec.BALLMUSCLE_NPZ["newton"],
                          dict(solver="newton", **tspec.BALLMUSCLE_OPTIONS)),
    "fly_ball": (tspec.FLY_STANDIN_BALL_XML, tspec.FLY_STANDIN_BALL_NEWTON_NPZ,
                 dict(free_jnt=True, **tspec.FLY_BALL_NEWTON_OPTIONS)),
}
ARRAY_LEAVES = ("opt.timestep", "opt.tolerance", "opt.meaninertia", "dof_damping",
                "pairs.friction", "body_mass", "opt.gravity", "dof_armature")


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_array_paths_take_the_kernel_constants_per_env(case):
    """Off the kernel layout the JAX package reads timestep, tolerance,
    meaninertia, damping and friction as arrays; the port takes them per
    env: 3 substeps of 2 envs (the leaves times 0.97 and 1.03) against the
    JAX step run on each env's own model, atol 1e-9 of the scale. Under
    the JAX wrapper's vmap the XLA-CG path's damped inverse takes env 0's
    damping for every env (``ops/cholesky.py::_spd_inverse2_vmap``, ROADMAP
    C); the ballmuscle's CG case shows that gap, and there the port raises
    by name for damping and timestep (``solver.static_leaves``). The JAX
    wrapper's vmap over the leaves the port takes matches the per-env
    steps at the same tolerance."""
    import brax_tracking_tpu.physics.step as jstep
    from brax_tracking_tpu_torch.physics import step as tstep

    xml, npz, options = ARRAY_CASES[case]
    jm = jspec.build_model(xml, dtype=jnp.float64, **options)
    tm = tspec.load_model(npz, device="cpu")
    assert not TS.quad_kernel_eligible(tm)
    static = TS.static_leaves(tm)
    assert ({"dof_damping", "opt.timestep"} <= static.keys()) == (case == "ballmuscle_cg")
    every = [n for n in ARRAY_LEAVES if tm.leaf(n).numel() and not (
        n == "dof_damping" and not tm.has_damping)]
    names = [n for n in every if n not in static]
    scales = np.array([0.97, 1.03])
    values = {n: tm.leaf(n).numpy()[None] * scales.reshape((2,) + (1,) * tm.leaf(n).dim())
              for n in every}
    for n in every:
        if n in static:
            with pytest.raises(NotImplementedError, match=n):
                TM.env_model(tm, _port_randomization({n: values[n]})(tm)[0], [n], static)
    own = {n: values[n] for n in names}
    tmv = TM.env_model(tm, _port_randomization(own)(tm)[0], names, static)
    rng = np.random.RandomState(0)
    qpos = np.asarray(jm.qpos0)[None].repeat(2, 0)
    if case == "fly_ball":
        qpos[:, 2] -= 0.01
        qpos[:, 7:] += rng.uniform(-0.3, 0.3, (2, jm.nq - 7))
    qvel = rng.uniform(-1, 1, (2, jm.nv))
    ctrl = rng.uniform(0, 0.5, (2, jm.nu))
    td = tstep.make_data(tmv, 2, device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel), ctrl=torch.as_tensor(ctrl))
    for _ in range(3):
        td = tstep.step(tmv, td, device="cpu")
    refs = []
    for b in range(2):
        jmb = _jax_randomization(names, {n: v[b] for n, v in own.items()})(jm)[0]
        jd = jstep.make_data(jmb).replace(qpos=jnp.asarray(qpos[b]), qvel=jnp.asarray(qvel[b]),
                                          ctrl=jnp.asarray(ctrl[b]))
        step = jax.jit(lambda d: jstep.step(jmb, d))
        for _ in range(3):
            jd = step(jd)
        refs.append(jd)
    for f in ("qpos", "qvel", "time"):
        ref = np.stack([np.asarray(getattr(r, f)) for r in refs])
        np.testing.assert_allclose(getattr(td, f).numpy(), ref,
                                   atol=1e-9 * max(1.0, np.abs(ref).max()), rtol=0, err_msg=f)
    assert float((td.qvel[0] - td.qvel[1]).abs().max()) > 1e-6
    # the JAX wrapper's vmap over the leaves the port takes gives each env's
    # own step: the JAX package randomizes them too
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), jstep.make_data(jm))
    jd = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
    jmv, axes = _jax_randomization(names, own)(jm)
    vstep = jax.jit(lambda d: jax.vmap(jstep.step, in_axes=(axes, 0))(jmv, d))
    jv = jd
    for _ in range(3):
        jv = vstep(jv)
    for f in ("qpos", "qvel"):
        ref = np.stack([np.asarray(getattr(r, f)) for r in refs])
        np.testing.assert_allclose(np.asarray(getattr(jv, f)), ref,
                                   atol=1e-9 * max(1.0, np.abs(ref).max()), rtol=0, err_msg=f)
    if case == "ballmuscle_cg":
        jmv, axes = _jax_randomization(every, values)(jm)
        vmapped = jax.jit(lambda d: jax.vmap(jstep.step, in_axes=(axes, 0))(jmv, d))(jd)
        one = jax.jit(lambda d: jstep.step(
            _jax_randomization(every, {n: v[1] for n, v in values.items()})(jm)[0], d))(
            jstep.make_data(jm).replace(qpos=jnp.asarray(qpos[1]), qvel=jnp.asarray(qvel[1]),
                                        ctrl=jnp.asarray(ctrl[1])))
        assert np.abs(np.asarray(vmapped.qvel[1]) - np.asarray(one.qvel)).max() > 1e-3


SCENES = {
    "props": (tspec.PROPS_XML, tspec.PROPS_NPZ, {}),
    "terrain": (tspec.RODENT_STANDIN_TERRAIN_XML, tspec.RODENT_STANDIN_TERRAIN_NPZ,
                dict(scale_factor=0.9)),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_collision_takes_per_env_geometry(scene):
    """Every collision pair type reads its sizes, mesh vertices and height
    fields per env: equal per-env values give the shared model's contacts,
    and per-env values (geom_size, geom_pos, mesh_vert, hfield_elev and
    hfield_size times 0.97 ... 1.03, geom_quat batched at its values) give
    the JAX package's ``collision`` vmapped over the same leaves, per slot
    at 1e-9."""
    import brax_tracking_tpu.physics.collision as jC
    import brax_tracking_tpu.physics.step as jstep
    from brax_tracking_tpu_torch.physics import collision as tC
    from brax_tracking_tpu_torch.physics import step as tstep

    xml, npz, build = SCENES[scene]
    tm = tspec.load_model(npz, device="cpu")
    names = [n for n in ("geom_size", "geom_pos", "geom_quat", "mesh_vert", "hfield_elev",
                         "hfield_size") if tm.leaf(n).numel()]
    assert "mesh_vert" in names and "hfield_elev" in names
    rng = np.random.RandomState(1)
    d0 = tstep.make_data(tm, N, device="cpu")
    d0 = d0.replace(qpos=d0.qpos + torch.as_tensor(rng.uniform(-0.02, 0.02, d0.qpos.shape)))
    collide = lambda m: tC.collision(m, tstep.fwd_position_smooth(m, d0))
    shared = collide(tm)
    equal = {n: tm.leaf(n)[None].repeat((N,) + (1,) * tm.leaf(n).dim()) for n in names}
    per_env = collide(TM.env_model(tm, TM.replace_leaves(tm, equal), names, {}))
    for k in ("contact_dist", "contact_pos", "contact_frame"):
        np.testing.assert_allclose(getattr(per_env, k).numpy(), getattr(shared, k).numpy(),
                                   atol=1e-12, rtol=0, err_msg=k)
    values = {n: (v if n == "geom_quat" else v * torch.as_tensor(SCALES).reshape(
        (N,) + (1,) * (v.dim() - 1))).numpy() for n, v in equal.items()}
    moved = collide(TM.env_model(tm, _port_randomization(values)(tm)[0], names, {}))
    live = shared.contact_dist < 1e9
    assert float((moved.contact_dist - shared.contact_dist)[live].abs().max()) > 1e-5
    jm = jspec.build_model(xml, dtype=jnp.float64, solver="cg", iterations=4,
                           ls_iterations=4, **build)
    jmv, axes = _jax_randomization(names, values)(jm)
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), jstep.make_data(jm))
    jd = jd.replace(qpos=jnp.asarray(d0.qpos.numpy()))
    want = jax.jit(jax.vmap(lambda m, x: jC.collision(m, jstep.fwd_position_smooth(m, x)),
                            in_axes=(axes, 0)))(jmv, jd)
    for k in ("contact_dist", "contact_pos", "contact_frame"):
        ref = np.asarray(getattr(want, k))
        gap = np.abs(getattr(moved, k).numpy() - ref)
        bad = gap > 1e-9 + 1e-12 * np.abs(ref)
        assert not bad.any(), (k, int(bad.sum()), gap[bad].max(), np.argwhere(bad)[:8])


def test_solve_kernel_plain_version_takes_per_env_armature():
    """cg_solve_fused's plain version with a (B, nv) armature equals one
    call per env with that env's (nv,) armature; a (B, nv) batch of the
    shared values is bitwise the (nv,) call."""
    from brax_tracking_tpu_torch.ops import cg as tcg
    from brax_tracking_tpu_torch.physics import constraint as tCn
    from brax_tracking_tpu_torch.physics import step as tstep

    tm = tspec.load_model(device="cpu")
    rng = np.random.RandomState(0)
    d = tstep.make_data(tm, N, device="cpu")
    d = d.replace(qpos=d.qpos + torch.as_tensor(rng.uniform(-0.05, 0.05, d.qpos.shape)),
                  qvel=torch.as_tensor(rng.uniform(-1, 1, d.qvel.shape)))
    d = tstep.forward_to_constraint(tm, d)
    args, kw = TS._kernel_args(tm, d, tCn.efc_layout(tm))
    arm = tm.dof_armature + 0.01 * torch.as_tensor(SCALES)[:, None]
    out = tcg.cg_solve_fused(*args[:-1], arm, device="cpu", **kw)
    for b in range(N):
        one = tcg.cg_solve_fused(*(a[b:b + 1] if a.dim() and a.shape[0] == N else a
                                   for a in args[:11]), *args[11:13], arm[b], device="cpu", **kw)
        for x, y in zip(out, one):
            np.testing.assert_allclose(x[b:b + 1].numpy(), y.numpy(), atol=1e-12, rtol=0)
    same = tcg.cg_solve_fused(*args[:-1], tm.dof_armature.expand(N, -1).contiguous(),
                              device="cpu", **kw)
    for x, y in zip(same, tcg.cg_solve_fused(*args, device="cpu", **kw)):
        assert torch.equal(x, y)


def test_train_with_randomization_fn():
    """A few training steps on 16 minirat envs, masses and gravity drawn
    per env from the randomization generator; the eval envs get their own
    draws."""
    from brax_tracking_tpu_torch.agents.ppo import networks as tnetworks
    from brax_tracking_tpu_torch.agents.ppo import train as ttrain

    tm = tspec.load_model(device="cpu")
    q = _synth(tm.qpos0.numpy(), T=64)
    env = ttracking.GenericSingleClip(
        reference_clip=tclips.process_clip(tm, torch.as_tensor(q)), device="cpu", **MINIRAT_ARGS)
    seen = []

    def randomize(m, num_envs, generator):
        s = 0.8 + 0.4 * torch.rand(num_envs, 1, generator=generator, dtype=m.dtype)
        v = {"body_mass": m.body_mass * s, "opt.gravity": m.opt.gravity * s}
        seen.append(num_envs)
        return TM.replace_leaves(m, v), v.keys()

    _, _, metrics = ttrain.train(
        env, num_timesteps=256, episode_length=8, num_envs=16, batch_size=16,
        num_minibatches=2, unroll_length=4, num_updates_per_batch=1, num_evals=2,
        num_eval_envs=8, randomization_fn=randomize, seed=0, device="cpu",
        network_factory=lambda *a, **k: __import__(
            "brax_tracking_tpu_torch.agents.ppo.networks", fromlist=["x"]).make_ppo_networks(
                *a, policy_hidden_layer_sizes=(16,), value_hidden_layer_sizes=(16,), **k))
    assert seen == [16, 8]
    assert np.isfinite(metrics["eval/episode_reward"])
    assert metrics["training/sps"] > 0
