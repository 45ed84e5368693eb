"""The elliptic minirat (``assets/minirat_elliptic.xml``: the minirat with
``cone="elliptic"``, 22 dim-3 elliptic contacts, nefc = 70) in the port
against the JAX package, float64 on the CPU.

- the committed ``minirat_elliptic.npz`` equals a fresh freeze;
- ``make_constraint``'s elliptic rows (efc_D, efc_aref, efc_pos,
  efc_margin, con_A and the assembled J) at seeded states whose solve has
  contacts in all three zones of the cone (bottom, middle, top), at rtol
  1e-10 (same formulas, rounding only);
- the solve kernel's plain version with the elliptic block, without and
  with warmstart + stall exit, against the JAX kernel
  ``cg_solve_fused(..., interpret=True)`` (rolled loops) and, without
  warmstart, against the JAX array path ``solver._cg_arrays`` under vmap,
  at rtol 1e-9 / atol 1e-11 as tests/test_torch_cg.py holds the quadratic
  case: both sides run the same float64 algorithm in another summation
  order;
- three control steps of the elliptic-minirat tracking env (8 envs, 10
  substeps each, auto-resets) at atol 1e-10 / rtol 1e-9 on obs and
  reward, as tests/test_torch_env.py holds the pyramidal minirat.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import brax_tracking_tpu.physics.constraint as jCn
import brax_tracking_tpu.physics.solver as jS
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu.data import clips as jclips
from brax_tracking_tpu.envs import tracking as jtracking
from brax_tracking_tpu.envs import wrappers as jwrappers
from brax_tracking_tpu.ops import cg as jcg
from brax_tracking_tpu_torch.data import clips as tclips
from brax_tracking_tpu_torch.envs import tracking as ttracking
from brax_tracking_tpu_torch.envs import wrappers as twrappers
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep

RTOL, ATOL = 1e-9, 1e-11
ROW_RTOL = 1e-10
B = 4
NAMES = ("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new")
T = lambda x: torch.as_tensor(np.array(x, np.float64))


def _states(nq, nv, nu, qpos0, seed=0, drop=0.01, vel=1.0):
    """Root 1 cm into the floor, seeded joints and velocities: at seed 0 the
    4-iteration solve leaves contacts in all three cone zones."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(qpos0, np.float64)[None], (B, 1))
    qpos[:, 2] -= drop
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, nq - 7))
    return dict(qpos=qpos, qvel=rng.uniform(-vel, vel, (B, nv)),
                ctrl=rng.uniform(-0.3, 0.3, (B, nu)))


@pytest.fixture(scope="module")
def case():
    jm = jspec.build_model(
        tspec.MINIRAT_ELLIPTIC_XML, solver="cg", iterations=4, ls_iterations=4,
        dtype=jnp.float64,
    )
    st = _states(jm.nq, jm.nv, jm.nu, jm.qpos0)
    d0 = jstep.make_data(jm)
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
    dB = dB.replace(**{k: jnp.asarray(v) for k, v in st.items()})
    dF = jax.jit(jax.vmap(lambda dd: jstep.forward(jm, dd)))(dB)
    tm = tspec.model_from_numpy(tspec.model_to_numpy(jm), device="cpu")
    td = tstep.make_data(tm, B, device="cpu").replace(**{k: T(v) for k, v in st.items()})
    td = tstep.forward_to_constraint(tm, td)

    layout = jCn.efc_layout(jm)
    meta = jS._cone_meta(jm, layout)
    fstat = jS._fused_statics(jm, layout)
    cp = layout.con_pair[meta.ell_con]
    fr = np.asarray(jm.pairs.friction, np.float64)[cp]
    quad_mask = np.zeros(layout.nefc, bool)
    quad_mask[meta.quad_rows] = True
    exists = np.asarray(dF.efc_pos < dF.efc_margin)
    e_con = np.asarray(dF.contact_dist)[:, meta.ell_con] < np.asarray(jm.pairs.margin)[cp]
    kw = dict(
        iters=4, ls_iters=4,
        tol=float(jm.opt.tolerance) * float(jm.opt.meaninertia) * jm.nv,
        dt=float(jm.opt.timestep), row_slot=fstat["row_slot"], sz=fstat["sz"],
        root_bounds=fstat["root_bounds"], limit_dadr=fstat["limit_dadr"],
        ell0=int(meta.ell_rows.min()), ell_mu=tuple(fr[:, 0].tolist()),
        ell_scale=tuple(map(tuple, (fr[:, 0:2] / fr[:, :1]).tolist())),
    )
    return jm, dF, tm, td, layout, meta, fstat, kw, exists & quad_mask, e_con


def test_committed_npz_matches_fresh_freeze(tmp_path):
    try:
        importlib.import_module("mujoco")
    except ImportError:
        pytest.skip("the mujoco bindings are needed to freeze an MJCF")
    fresh = tspec.freeze_mjcf(tspec.MINIRAT_ELLIPTIC_XML, str(tmp_path / "e.npz"))
    with np.load(tspec.MINIRAT_ELLIPTIC_NPZ) as z:
        assert sorted(fresh) == sorted(z.files)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_model_and_statics(case):
    """The frozen file is the JAX package's model of the same MJCF; the
    port's cone metadata, kernel eligibility and elliptic statics equal the
    JAX package's."""
    jm, dF, tm, td, layout, meta, fstat, kw, exists_q, e_con = case
    loaded = tspec.load_model(tspec.MINIRAT_ELLIPTIC_NPZ, device="cpu")
    a, b = tspec.model_to_numpy(tm), tspec.model_to_numpy(loaded)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert layout.nefc == 70 and meta.ell_con.size == 22 and jm.nv == 10
    assert jS.quad_kernel_eligible(jm) and tS.quad_kernel_eligible(tm)
    tl = tCn.efc_layout(tm)
    tmeta = tS._cone_meta(tm, tl)
    for name in tmeta._fields:
        np.testing.assert_array_equal(getattr(tmeta, name), getattr(meta, name), err_msg=name)
    st = tS._solve_statics(tm, tl)
    for k in ("ell0", "ell_mu", "row_slot", "sz", "root_bounds", "limit_dadr"):
        assert st["kw"][k] == kw[k], k
    np.testing.assert_allclose(np.asarray(st["kw"]["ell_scale"]), np.asarray(kw["ell_scale"]), rtol=0, atol=0)
    np.testing.assert_array_equal(st["P"].numpy(), fstat["P"])


def test_make_constraint_elliptic_rows(case):
    jm, dF, tm, td, layout, meta, fstat, kw, exists_q, e_con = case
    for name in ("efc_D", "efc_aref", "efc_pos", "efc_margin", "con_A", "contact_dist"):
        np.testing.assert_allclose(
            getattr(td, name).numpy(), np.asarray(getattr(dF, name)),
            rtol=ROW_RTOL, atol=1e-12, err_msg=name,
        )
    Bm = tcg._bm(T(fstat["P"]), td.con_A, len(fstat["root_bounds"]), tm.ncon)
    _, J = tcg.assemble_qM_J(
        td.crb_f, td.cdof, Bm, td.efc_jsign, T(fstat["md"]), tm.dof_armature,
        row_slot=fstat["row_slot"], sz=fstat["sz"], root_bounds=fstat["root_bounds"],
        limit_dadr=fstat["limit_dadr"],
    )
    dense = np.asarray(jax.jit(jax.vmap(lambda d: jCn.dense_J(jm, d)))(dF))
    np.testing.assert_allclose(J.numpy(), dense, rtol=ROW_RTOL, atol=1e-12)
    # friction rows carry no position term: their aref is -b * velocity only
    ell_rows = meta.ell_rows[:, 1:].ravel()
    assert np.abs(np.asarray(dF.efc_aref)[:, ell_rows]).max() > 0


def _zones(jm, dF, fstat, kw, e_con, x):
    """Per-zone counts of active elliptic contacts at qacc = x."""
    J = np.asarray(jax.vmap(lambda d: jCn.dense_J(jm, d))(dF))
    jar = np.einsum("brv,bv->br", J, x) - np.asarray(dF.efc_aref)
    nell = len(kw["ell_mu"])
    je = jar[:, kw["ell0"] : kw["ell0"] + 3 * nell].reshape(B, nell, 3)
    mu, sc = np.asarray(kw["ell_mu"]), np.asarray(kw["ell_scale"])
    n, t = je[..., 0], np.linalg.norm(je[..., 1:] * sc, axis=-1)
    bottom = e_con & (mu * n + t <= 0)
    middle = e_con & ~bottom & (n < mu * t)
    return int(bottom.sum()), int(middle.sum()), int((e_con & ~bottom & ~middle).sum())


def _port(case, warmstart=None, stall_tol=0.0, damp=None, iters=4):
    jm, dF, tm, td, layout, meta, fstat, kw, exists_q, e_con = case
    return tcg.cg_solve_fused_reference(
        T(dF.crb_f), T(dF.cdof), T(dF.con_A), T(dF.efc_jsign), T(dF.efc_D),
        T(dF.efc_aref), torch.as_tensor(exists_q), torch.as_tensor(e_con),
        T(dF.qfrc_smooth), T(dF.qvel), T(np.zeros(jm.nv) if damp is None else damp),
        T(fstat["P"]), T(fstat["md"]), T(jm.dof_armature),
        **dict(kw, iters=iters), has_damping=damp is not None,
        warmstart=None if warmstart is None else T(warmstart), stall_tol=stall_tol,
    )


def _jax(case, warmstart=None, stall_tol=0.0, damp=None, iters=4):
    jm, dF, tm, td, layout, meta, fstat, kw, exists_q, e_con = case
    return jcg.cg_solve_fused(
        dF.crb_f, dF.cdof, dF.con_A, dF.efc_jsign, dF.efc_D, dF.efc_aref,
        jnp.asarray(exists_q), jnp.asarray(e_con), dF.qfrc_smooth, dF.qvel,
        jnp.asarray(np.zeros(jm.nv) if damp is None else damp),
        jnp.asarray(fstat["P"]), jnp.asarray(fstat["md"]), jm.dof_armature,
        **dict(kw, iters=iters), has_damping=damp is not None,
        warmstart=None if warmstart is None else jnp.asarray(warmstart),
        stall_tol=stall_tol,
        unroll_iters=False, unroll_ls=False, interpret=True,  # rolled: compiles faster
    )


def _warmstart(case):
    """Per env: near the solution, far from it, zeros, near qacc_smooth, so
    the better-of select goes both ways."""
    jm, dF = case[:2]
    rng = np.random.RandomState(3)
    sol, a0 = np.asarray(dF.qacc), np.asarray(dF.qacc_smooth)
    ws = np.stack([sol[0] * (1 + 1e-3 * rng.randn(jm.nv)), sol[1] + 50.0 * rng.randn(jm.nv),
                   np.zeros(jm.nv), a0[3] * (1 + 1e-3 * rng.randn(jm.nv))])
    return ws


@pytest.mark.parametrize("variant", ["elliptic", "elliptic_ws_stall"])
def test_reference_matches_jax_kernel_interpret(case, variant):
    jm, dF, tm, td, layout, meta, fstat, kw, exists_q, e_con = case
    extra = {}
    if variant == "elliptic_ws_stall":
        extra = dict(warmstart=_warmstart(case), stall_tol=4e-6,
                     damp=float(jm.opt.timestep) * np.random.RandomState(7).uniform(0.005, 0.02, jm.nv))
    kout = _jax(case, **extra)
    tout = _port(case, **extra)
    for name, k, t in zip(NAMES, kout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(k), rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(kout[5]))
    if variant == "elliptic":
        # the solution leaves active contacts in every zone of the cone
        assert min(_zones(jm, dF, fstat, kw, e_con, tout[0].numpy())) > 0
    else:
        # the start the select picks: the warmstart in some envs, qacc_smooth
        # in others (zeros included)
        x0 = _port(case, iters=0, **extra)[0].numpy()
        took_ws = np.all(x0 == extra["warmstart"], -1)
        took_a0 = np.all(x0 == tout[3].numpy(), -1)
        assert took_ws.any() and took_a0.any() and np.all(took_ws ^ took_a0)
        assert took_a0[2]  # zeros lose to qacc_smooth


def test_reference_matches_jax_arrays(case):
    jm, dF, tm, td, layout, meta, fstat, kw, exists_q, e_con = case
    quad_mask = np.zeros(layout.nefc)
    quad_mask[meta.quad_rows] = 1.0
    statics = dict(
        L1=np.eye(jm.nv)[jCn.limit_dofs(jm)], iters=4, ls_iters=4, tol=kw["tol"],
        dt=kw["dt"], damp=np.zeros(jm.nv), has_damping=False, quad_mask=quad_mask,
        ell0=kw["ell0"], ell_mu=np.asarray(kw["ell_mu"]), ell_scale=np.asarray(kw["ell_scale"]),
    )
    bout = jax.vmap(
        lambda qM, Jc, js, D, ar, ex, ec, qfs, qv: jS._cg_arrays(
            qM, Jc, js, D, ar, ex, ec, qfs, qv, **statics
        )
    )(dF.qM, dF.efc_Jc, dF.efc_jsign, dF.efc_D, dF.efc_aref,
      jnp.asarray(np.asarray(dF.efc_pos < dF.efc_margin)), jnp.asarray(e_con),
      dF.qfrc_smooth, dF.qvel)
    tout = _port(case)
    for name, b, t in zip(NAMES, bout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)
    # and the JAX package's own forward (the same array path) and the
    # port's step-level solve agree
    ts = tS.solve(tm, td)
    np.testing.assert_allclose(ts.qacc.numpy(), np.asarray(dF.qacc), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the tracking env
# ---------------------------------------------------------------------------

STEPS, NENV, EPISODE = 3, 8, 3
ENV_ARGS = dict(
    scale_factor=1.0, solver="cg", iterations=4, ls_iterations=4,
    torque_actuators=False, physics_steps_per_control_step=10, too_far_dist=0.1,
    bad_pose_dist=1000.0, bad_quat_dist=1000.0, ctrl_cost_weight=0.01,
    pos_reward_weight=1.0, quat_reward_weight=1.0, joint_reward_weight=10.0,
    angvel_reward_weight=1.0, bodypos_reward_weight=1.0, endeff_reward_weight=1.0,
    healthy_reward=0.25, healthy_z_range=(0.02, 0.5), terminate_when_unhealthy=True,
    free_jnt=True, center_of_mass="torso", strict_name_lookup=True,
    end_eff_names=["leg_FL", "leg_FR", "leg_BL", "leg_BR"],
    appendage_names=["leg_FL", "leg_FR", "leg_BL", "leg_BR"],
    body_names=["torso", "leg_FL", "leg_FR", "leg_BL", "leg_BR"],
    joint_names=["hip_FL", "hip_FR", "hip_BL", "hip_BR"],
)


@pytest.fixture(scope="module")
def rollouts():
    jm = jspec.build_model(
        tspec.MINIRAT_ELLIPTIC_XML, solver="cg", iterations=4, ls_iterations=4,
        dtype=jnp.float64,
    )
    qclip = np.tile(np.asarray(jm.qpos0, np.float64), (64, 1))
    qclip[:, 2] += 0.01
    qclip[:, 0] += np.linspace(0.0, 1.0, 64)
    jclip = jax.jit(lambda q: jclips.process_clip(jm, q))(jnp.asarray(qclip))
    jenv = jtracking.GenericSingleClip(
        reference_clip=jclip, mjcf_path=tspec.MINIRAT_ELLIPTIC_XML, dtype=jnp.float64,
        **ENV_ARGS,
    )
    jenv = jwrappers.wrap(jenv, episode_length=EPISODE)
    tm = tspec.load_model(tspec.MINIRAT_ELLIPTIC_NPZ, device="cpu")
    tenv = ttracking.GenericSingleClip(
        reference_clip=tclips.process_clip(tm, torch.as_tensor(qclip)),
        mjcf_path="builtin:minirat_elliptic.xml", device="cpu", **ENV_ARGS,
    )
    tenv = twrappers.wrap(tenv, episode_length=EPISODE)
    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), NENV))
    ts = tenv.init_state(
        torch.as_tensor(np.array(js.info["cur_frame"])),
        torch.as_tensor(np.array(js.pipeline_state.qpos)),
        torch.as_tensor(np.array(js.pipeline_state.qvel)),
    )
    out = []
    rng = np.random.RandomState(1)
    step = jax.jit(jenv.step)
    for _ in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (NENV, tenv.action_size))
        js = step(js, jnp.asarray(a))
        ts = tenv.step(ts, torch.as_tensor(a))
        out.append((js, ts))
    return out


@pytest.mark.parametrize("k", range(STEPS))
def test_env_step_matches(rollouts, k):
    js, ts = rollouts[k]
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), atol=1e-10, rtol=1e-9)
    np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), atol=1e-10, rtol=1e-9)
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    for key in ("cur_frame", "steps_taken_cur_frame", "steps", "truncation"):
        np.testing.assert_array_equal(ts.info[key].numpy(), np.asarray(js.info[key]))


def test_env_rollout_has_contacts_and_resets(rollouts):
    """The steps must touch the floor through the elliptic rows and include
    auto-resets, or the parity above would not exercise them."""
    dones = np.stack([np.asarray(js.done) for js, _ in rollouts])
    assert dones[EPISODE - 1].all() and not dones.all()
    force = np.stack([np.asarray(js.pipeline_state.efc_force) for js, _ in rollouts])
    assert np.abs(force[..., 4:]).max() > 0
