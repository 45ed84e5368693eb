"""The two-rat stand-in at rodent_pair's sizes, on the CPU in float64.

``assets/ratpair.xml`` (written by ``assets/make_ratpair.py``) stands in for
the pair scene, whose MJCF is not in the repository; ``assets/rat.xml``,
one of its rats alone (nv 73, the rodent's width), for the solve kernel's
wide layout 1. Here:

- the committed XML is what the generator writes, and each frozen file
  equals a fresh ``freeze_mjcf`` of it, at the pair's sizes (nv 146, two
  free roots, 114 contact slots, 590 rows pyramidal, 476 elliptic) and the
  one rat's (nv 73, 24 slots, 163 rows);
- ``spec._candidate_pairs`` against MuJoCo's own filters: with every
  capsule inflated to overlap every geom, MuJoCo's collision reports
  exactly the candidate pairs;
- the port's forward against MuJoCo C at seeded contact states: qfrc_bias
  and qM at atol 1e-12 (same formulas, rounding only), and the active rows
  (dist < margin) equal MuJoCo's nefc;
- the port's stages, qM and J, and one substep against the JAX package on
  the same XML (``build_model`` of the port's asset path), B = 2, through
  the JAX path its own CPU tests take: the vmapped step, whose CG solve runs
  the array path (``_cg_arrays``) on the CPU, not the Pallas kernel; the one
  rat's substep likewise. Stage
  tolerances as tests/test_torch_physics.py: atol 1e-12 on the position and
  velocity stages and contacts, 1e-10 on forces, rows and the solve; the
  substep's qpos and qvel at 1e-12; the elliptic file's substep likewise;
  the Newton file's substep (the port's chunked dispatch) against the JAX
  package's batched branch with its Pallas kernel in interpret mode, at
  1e-10 of each field's scale;
- the pair env's control step: tests/test_torch_pair_env.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import brax_tracking_tpu.physics.constraint as jCn
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu_torch.assets import make_ratpair
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep

mujoco = pytest.importorskip("mujoco")

B = 2
FILES = {
    "ratpair": (tspec.RATPAIR_XML, tspec.RATPAIR_NPZ, {}),
    "ratpair_elliptic": (tspec.RATPAIR_ELLIPTIC_XML, tspec.RATPAIR_ELLIPTIC_NPZ, {}),
    "ratpair_newton": (tspec.RATPAIR_XML, tspec.RATPAIR_NEWTON_NPZ, tspec.MINIRAT_NEWTON_OPTIONS),
    "rat": (tspec.RAT_XML, tspec.RAT_NPZ, {}),
}
NEFC = {"ratpair": 590, "ratpair_elliptic": 476, "ratpair_newton": 590, "rat": 163}
# (nq, nv, nbody, ngeom, nu), root dof ranges, contact slots, limit rows and
# slots between the two roots of each file
SIZES = {
    "ratpair": ((148, 146, 133, 201, 60), ((0, 73), (73, 146)), 114, 134, 66),
    "rat": ((74, 73, 67, 101, 30), ((0, 73),), 24, 67, 0),
}
STAGES = {
    1e-12: (
        "xpos", "xquat", "xipos", "xanchor", "xaxis", "geom_xpos", "geom_xquat",
        "subtree_com", "cinert_s", "cinert_h", "cdof", "cvel", "cdof_dot",
        "contact_dist", "contact_pos", "contact_frame", "con_A", "efc_jsign",
        "efc_pos", "efc_margin",
    ),
    1e-10: (
        "crb_f", "qfrc_bias", "qfrc_passive", "qfrc_actuator", "qfrc_smooth",
        "efc_D", "efc_aref", "qacc_smooth", "efc_force", "qfrc_constraint", "qacc",
        "qvel_next",
    ),
}
# Newton against the JAX package's batched branch: the same float64
# algorithm on both sides (measured gaps ~3e-15 of the scale)
NEWTON_REL = 1e-10


def _states(m, seed=0, drop=0.01):
    """B seeded states: both roots 1 cm into the floor, hinges perturbed
    (chip_smoke.py::random_states' recipe), ctrl in [-0.3, 0.3]."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.qpos0, np.float64)[None], (B, 1))
    jt, qadr = np.asarray(m.jnt_type), np.asarray(m.jnt_qposadr)
    free = qadr[jt == 0]
    hinge = np.setdiff1d(np.arange(m.nq), (free[:, None] + np.arange(7)).ravel())
    qpos[:, free + 2] -= drop
    qpos[:, hinge] += rng.uniform(-0.05, 0.05, (B, hinge.size))
    return qpos, rng.uniform(-0.5, 0.5, (B, m.nv)), rng.uniform(-0.3, 0.3, (B, m.nu))


# ---------------------------------------------------------------------------
# the fixture and its frozen files
# ---------------------------------------------------------------------------


def test_xml_is_the_generators():
    for name, cone, rats in make_ratpair.FILES:
        with open(os.path.join(os.path.dirname(tspec.RATPAIR_XML), name)) as f:
            assert f.read() == make_ratpair.ratpair_xml(cone, rats), name


@pytest.mark.parametrize("name", sorted(FILES))
def test_committed_npz_matches_fresh_freeze(tmp_path, name):
    xml, npz, options = FILES[name]
    fresh = tspec.freeze_mjcf(xml, str(tmp_path / f"{name}.npz"), **options)
    with np.load(npz) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(fresh) == sorted(committed)
    for k, v in fresh.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    m = tspec.load_model(npz, device="cpu", **options)
    layout = tCn.efc_layout(m)
    roots = tS._fused_statics(m, layout)["root_bounds"]
    dims, bounds, ncon, nlim, cross = SIZES["rat" if name == "rat" else "ratpair"]
    assert (m.nq, m.nv, m.nbody, m.ngeom, m.nu) == dims
    assert roots == bounds
    assert (m.ncon, layout.nefc, layout.limit_jnt.size) == (ncon, NEFC[name], nlim)
    assert tS.quad_kernel_eligible(m)
    # cross-body slots: rat 0 against rat 1
    b1 = np.asarray(m.body_rootid)[np.asarray(m.geom_bodyid)[layout.con_geom1]]
    b2 = np.asarray(m.body_rootid)[np.asarray(m.geom_bodyid)[layout.con_geom2]]
    assert int(((b1 != b2) & (b1 != 0)).sum()) == cross
    names = (("body", "torso-0"), ("body", "hand_R-0"), ("joint", "hip_L_supinate-0"))
    if name != "rat":
        names += (("body", "foot_L-1"), ("joint", "vertebra_1_extend-1"))
    for kind, name_ in names:
        assert tspec.name2id(m, kind, name_) >= 0, name_


def _candidate_pairs_against_mujoco(xml):
    """With every capsule's radius raised to 0.5 m every geom overlaps every
    other, so MuJoCo's collision (broadphase, contype/conaffinity, parent,
    weld and <exclude> filters) reports a contact for each pair it lets
    through: that set must equal _candidate_pairs'. Returns its size."""
    spec_ = mujoco.MjSpec.from_file(xml)
    for g in spec_.geoms:
        if g.type == mujoco.mjtGeom.mjGEOM_CAPSULE:
            g.size[0] = 0.5
    mjm = spec_.compile()
    mjd = mujoco.MjData(mjm)
    mujoco.mj_forward(mjm, mjd)
    seen = {tuple(sorted(map(int, g))) for g in zip(mjd.contact.geom1, mjd.contact.geom2)}
    ours = {tuple(sorted(p)) for p in tspec._candidate_pairs(mjm)}
    assert seen == ours
    return len(ours)


def test_candidate_pairs_against_mujoco():
    assert _candidate_pairs_against_mujoco(tspec.RATPAIR_XML) == 57


def test_candidate_pairs_against_mujoco_one_rat():
    """The one rat: its 12 floor geoms against the floor, nothing else (its
    cross-body bits meet no geom)."""
    assert _candidate_pairs_against_mujoco(tspec.RAT_XML) == 12


@pytest.mark.parametrize("name", ["ratpair", "ratpair_elliptic", "rat"])
def test_forward_against_mujoco(name):
    xml, npz, _ = FILES[name]
    m = tspec.load_model(npz, device="cpu")
    mjm = mujoco.MjModel.from_xml_path(xml)
    mjd = mujoco.MjData(mjm)
    qpos, qvel, _ = _states(mjm, seed=1)
    qpos[:, 7:74] += np.random.RandomState(2).uniform(-0.4, 0.4, (B, 67))  # limits reached
    d = tstep.forward_to_constraint(m, tstep.make_data(m, B, device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel)))
    st = tS._solve_statics(m, tCn.efc_layout(m))
    kw = st["kw"]
    Bm = tcg._bm(st["P"], d.con_A, len(kw["root_bounds"]), m.ncon)
    qM, _ = tcg.assemble_qM_J(d.crb_f, d.cdof, Bm, d.efc_jsign, st["md"], m.dof_armature,
                              row_slot=kw["row_slot"], sz=kw["sz"],
                              root_bounds=kw["root_bounds"], limit_dadr=kw["limit_dadr"])
    for b in range(B):
        mjd.qpos[:], mjd.qvel[:] = qpos[b], qvel[b]
        mujoco.mj_forward(mjm, mjd)
        full = np.zeros((mjm.nv, mjm.nv))
        mujoco.mj_fullM(mjm, mjd, full)
        np.testing.assert_allclose(d.qfrc_bias[b].numpy(), mjd.qfrc_bias, atol=1e-12, rtol=0)
        np.testing.assert_allclose(qM[b].numpy(), full, atol=1e-12, rtol=0)
        active = d.efc_pos[b] < d.efc_margin[b]
        assert int(active.sum()) == mjd.nefc
        nlim = int(active[: len(kw["limit_dadr"])].sum())
        assert 0 < nlim < mjd.nefc  # limits and contacts both active


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax_model(name):
    xml, _, options = FILES[name]
    opts = dict(solver="cg", iterations=4, ls_iterations=4) | options
    return jspec.build_model(xml, dtype=jnp.float64, **opts)


@pytest.fixture(scope="module")
def cg_pair():
    """The JAX model, the port's carried across, seeded states and the JAX
    package's vmapped step (compiled once: it returns forward's fields of
    the state it started from, so one compile serves stages and step)."""
    jm = _jax_model("ratpair")
    tm = tspec.model_from_numpy(tspec.model_to_numpy(jm), device="cpu")
    qpos, qvel, ctrl = _states(jm)
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstep.make_data(jm))
    jd = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
    td = tstep.make_data(tm, B, device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel), ctrl=torch.as_tensor(ctrl))
    js = jax.jit(jax.vmap(lambda dd: jstep.step(jm, dd)))(jd)
    return jm, tm, jd, td, js


def test_model_from_jax_equals_frozen(cg_pair):
    jm, tm, *_ = cg_pair
    loaded = tspec.model_to_numpy(tspec.load_model(tspec.RATPAIR_NPZ, device="cpu"))
    for k, v in tspec.model_to_numpy(tm).items():
        np.testing.assert_array_equal(v, loaded[k], err_msg=k)
    assert tm.plan.depth == len(jm.plan.levels)


@pytest.mark.parametrize("atol", sorted(STAGES))
def test_forward_stages(cg_pair, atol):
    jm, tm, jd, td, js = cg_pair
    tf = tstep.forward(tm, td)
    assert bool(np.asarray(js.efc_pos < js.efc_margin)[:, 134:].any())  # contacts active
    for name in STAGES[atol]:
        j, t = np.asarray(getattr(js, name)), getattr(tf, name).numpy()
        assert j.shape == t.shape, name
        np.testing.assert_allclose(t, j, atol=atol, rtol=0, err_msg=name)


def test_mass_matrix_and_jacobian(cg_pair):
    """qM and J, which the port leaves to the solve kernel, assembled from
    the port's factors by the kernel's plain version (two roots, cross-body
    slots included) against the JAX package's dense ones."""
    jm, tm, jd, td, js = cg_pair
    tf = tstep.forward_to_constraint(tm, td)
    st = tS._solve_statics(tm, tCn.efc_layout(tm))
    kw = st["kw"]
    Bm = tcg._bm(st["P"], tf.con_A, len(kw["root_bounds"]), tm.ncon)
    qM, J = tcg.assemble_qM_J(tf.crb_f, tf.cdof, Bm, tf.efc_jsign, st["md"], tm.dof_armature,
                              row_slot=kw["row_slot"], sz=kw["sz"],
                              root_bounds=kw["root_bounds"], limit_dadr=kw["limit_dadr"])
    np.testing.assert_allclose(qM.numpy(), np.asarray(js.qM), atol=1e-12, rtol=0)
    dense = np.asarray(jax.jit(jax.vmap(lambda d: jCn.dense_J(jm, d)))(js))
    np.testing.assert_allclose(J.numpy(), dense, atol=1e-12, rtol=0)
    cross = [r for r in range(134, 590) if (J[0, r, :73] != 0).any() and (J[0, r, 73:] != 0).any()]
    assert len(cross) == 33 * 2 * 4  # rows that move both rats


def test_one_substep(cg_pair):
    jm, tm, jd, td, js = cg_pair
    ts = tstep.step(tm, td, device="cpu")
    # qacc is a solve output (up to ~1e3 here), held at the solve's 1e-10
    for name, atol in (("qpos", 1e-12), ("qvel", 1e-12), ("time", 1e-12), ("qacc", 1e-10)):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=atol, rtol=0, err_msg=name)


def _substeps(name, seed=3, **options):
    """One substep of B seeded states of ``name`` (``options`` override its
    solver options) in both packages: (JAX state, port state)."""
    jm = _jax_model(name) if not options else jspec.build_model(
        FILES[name][0], dtype=jnp.float64, **options)
    tm = tspec.model_from_numpy(tspec.model_to_numpy(jm), device="cpu")
    qpos, qvel, ctrl = _states(jm, seed=seed)
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstep.make_data(jm))
    jd = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
    js = jax.jit(jax.vmap(lambda dd: jstep.step(jm, dd)))(jd)
    ts = tstep.step(tm, tstep.make_data(tm, B, device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel), ctrl=torch.as_tensor(ctrl)),
        device="cpu")
    return js, ts


def test_one_substep_one_rat():
    """The one rat (the solve kernel's wide layout 1 on the card): one
    substep against the JAX package, at the pair's substep tolerances."""
    js, ts = _substeps("rat")
    assert bool(np.asarray(js.efc_pos < js.efc_margin)[:, 67:].any())  # contacts active
    for k, atol in (("qpos", 1e-12), ("qvel", 1e-12), ("qacc", 1e-10)):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                   atol=atol, rtol=0, err_msg=k)


def test_one_substep_elliptic():
    """The elliptic file (the solve kernel's elliptic block; the JAX array
    path), at the pyramidal substep's tolerances."""
    js, ts = _substeps("ratpair_elliptic")
    for k, atol in (("qpos", 1e-12), ("qvel", 1e-12), ("qacc", 1e-10)):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                   atol=atol, rtol=0, err_msg=k)


def test_one_substep_newton(monkeypatch):
    """Newton on the kernel layout: the port's chunked dispatch (warmstarted
    CG with the stall exit) against the JAX package's batched branch, which
    the JAX package takes on its accelerator, forced on the CPU with its
    Pallas kernel in interpret mode (rolled loops), as
    tests/test_torch_newton_kernel.py runs it for the minirat. The budget is
    cut to 8 iterations (two chunks of 4) to keep the interpreted kernel's
    time; both packages run the same float64 algorithm, so every field is
    held at NEWTON_REL of its scale."""
    from brax_tracking_tpu.ops import cg as jcg
    from brax_tracking_tpu.ops import cholesky as jchol

    kernel = jcg.cg_solve_fused
    monkeypatch.setattr(jchol, "_use_pallas", lambda x: True)
    monkeypatch.setattr(jcg, "cg_solve_fused", lambda *a, **k: kernel(
        *a, **{**k, "unroll_iters": False, "unroll_ls": False, "interpret": True}))
    js, ts = _substeps("ratpair_newton", solver="newton", iterations=8, ls_iterations=50)
    assert ts.solver_nchunk == 2
    for k in ("qpos", "qvel", "qacc", "efc_force"):
        ref = np.asarray(getattr(js, k))
        err = np.abs(getattr(ts, k).numpy() - ref).max()
        assert err <= NEWTON_REL * np.abs(ref).max(), (k, err)

