"""The port's solve-kernel plain version against the JAX package, float64.

``cg_solve_fused_reference`` (the CPU path and the CUDA kernel's yardstick)
on minirat batched states, against the JAX kernel
``ops/cg.cg_solve_fused(..., interpret=True)`` and against the JAX array
path ``solver._cg_arrays``, at rtol 1e-9 / atol 1e-11 as
tests/test_ops_cg_fused.py holds the JAX kernel to its array path. Both
damping branches: the minirat has no joint damping, so the damped branch
uses a seeded positive ``damp`` (the Cholesky tail of the JAX kernel, the
sweep-inverse tail of the array paths).
"""

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
from brax_tracking_tpu.ops import cg as jcg
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep

RTOL, ATOL = 1e-9, 1e-11
NAMES = ("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new")


def batched_forward(model, B, seed, drop=0.01):
    """Seeded minirat states, root pushed into the floor (contacts), as in
    tests/test_ops_cg_fused.py."""
    rng = np.random.RandomState(seed)
    d0 = jstep.make_data(model)
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
    qpos = np.tile(np.asarray(model.qpos0)[None], (B, 1))
    qpos[:, 2] -= drop
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, model.nq - 7))
    dB = dB.replace(
        qpos=jnp.asarray(qpos),
        qvel=jnp.asarray(rng.uniform(-0.5, 0.5, (B, model.nv))),
        ctrl=jnp.asarray(rng.uniform(-0.3, 0.3, (B, model.nu))),
    )
    return jax.jit(jax.vmap(lambda dd: jstep.forward(model, dd)))(dB)


@pytest.fixture(scope="module")
def case():
    model = jspec.build_model(
        "builtin:minirat.xml", solver="cg", iterations=4, ls_iterations=4,
        dtype=jnp.float64,
    )
    dF = batched_forward(model, 4, 0)
    layout = jCn.efc_layout(model)
    fstat = jS._fused_statics(model, layout)
    nv = model.nv
    tol = float(model.opt.tolerance) * float(model.opt.meaninertia) * nv
    exists = np.asarray(dF.efc_pos < dF.efc_margin)
    assert exists.any()
    return model, dF, layout, fstat, tol, exists


def _damp(model, damped):
    if not damped:
        return np.zeros(model.nv)
    return float(model.opt.timestep) * np.random.RandomState(7).uniform(0.005, 0.02, model.nv)


def _port(case, damped, iters):
    model, dF, layout, fstat, tol, exists = case
    T = lambda x: torch.as_tensor(np.array(x, np.float64))
    B = exists.shape[0]
    return tcg.cg_solve_fused_reference(
        T(dF.crb_f), T(dF.cdof), T(dF.con_A), T(dF.efc_jsign), T(dF.efc_D),
        T(dF.efc_aref), torch.as_tensor(np.array(exists)), torch.zeros(B, 0, dtype=torch.bool),
        T(dF.qfrc_smooth), T(dF.qvel), T(_damp(model, damped)), T(fstat["P"]),
        T(fstat["md"]), T(model.dof_armature),
        iters=iters, ls_iters=4, tol=tol, dt=float(model.opt.timestep),
        has_damping=damped, row_slot=fstat["row_slot"], sz=fstat["sz"],
        root_bounds=fstat["root_bounds"], limit_dadr=fstat["limit_dadr"],
    )


@pytest.mark.parametrize("damped", [False, True])
def test_reference_matches_jax_kernel_interpret(case, damped):
    model, dF, layout, fstat, tol, exists = case
    kout = jcg.cg_solve_fused(
        dF.crb_f, dF.cdof, dF.con_A, dF.efc_jsign, dF.efc_D, dF.efc_aref,
        jnp.asarray(exists), jnp.zeros((exists.shape[0], 0), bool),
        dF.qfrc_smooth, dF.qvel, jnp.asarray(_damp(model, damped)),
        jnp.asarray(fstat["P"]), jnp.asarray(fstat["md"]), model.dof_armature,
        iters=4, ls_iters=4, tol=tol, dt=float(model.opt.timestep),
        has_damping=damped, row_slot=fstat["row_slot"], sz=fstat["sz"],
        root_bounds=fstat["root_bounds"], limit_dadr=fstat["limit_dadr"],
        unroll_iters=False, unroll_ls=False, interpret=True,  # rolled: compiles faster
    )
    tout = _port(case, damped, 4)
    for name, k, t in zip(NAMES, kout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(k), rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(kout[5]))


@pytest.mark.parametrize("damped,iters", [(False, 4), (True, 4), (False, 12)])
def test_reference_matches_jax_arrays(case, damped, iters):
    model, dF, layout, fstat, tol, exists = case
    statics = dict(
        L1=np.eye(model.nv)[jCn.limit_dofs(model)], iters=iters, ls_iters=4,
        tol=tol, dt=float(model.opt.timestep), damp=_damp(model, damped),
        has_damping=damped, quad_mask=np.ones(layout.nefc), ell0=layout.nefc,
        ell_mu=np.zeros(0), ell_scale=np.zeros((0, 2)),
    )
    bout = jax.vmap(
        lambda qM, Jc, js, D, ar, ex, qfs, qv: jS._cg_arrays(
            qM, Jc, js, D, ar, ex, jnp.zeros((0,), bool), qfs, qv, **statics
        )
    )(dF.qM, dF.efc_Jc, dF.efc_jsign, dF.efc_D, dF.efc_aref, jnp.asarray(exists),
      dF.qfrc_smooth, dF.qvel)
    tout = _port(case, damped, iters)
    for name, b, t in zip(NAMES, bout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)


def test_assembly_matches_dense_qM_J(case):
    """The plain version's qM/J assembly from the low-rank factors against
    the JAX package's dense qM and constraint jacobian."""
    model, dF, layout, fstat, tol, exists = case
    T = lambda x: torch.as_tensor(np.array(x, np.float64))
    Bm = tcg._bm(T(fstat["P"]), T(dF.con_A), len(fstat["root_bounds"]), model.ncon)
    qM, J = tcg.assemble_qM_J(
        T(dF.crb_f), T(dF.cdof), Bm, T(dF.efc_jsign), T(fstat["md"]),
        T(model.dof_armature), row_slot=fstat["row_slot"], sz=fstat["sz"],
        root_bounds=fstat["root_bounds"], limit_dadr=fstat["limit_dadr"],
    )
    np.testing.assert_allclose(qM.numpy(), np.asarray(dF.qM), rtol=1e-12, atol=1e-15)
    dense = np.asarray(jax.jit(jax.vmap(lambda d: jCn.dense_J(model, d)))(dF))
    np.testing.assert_allclose(J.numpy(), dense, rtol=1e-12, atol=1e-14)


def test_jax_J_is_zero_outside_the_port_pattern(case):
    """The JAX package's own dense constraint jacobian on the minirat's
    seeded states is zero outside the static pattern by which the port's
    wide core holds J (ops/cg.py::j_pattern, from the port's statics), and
    the pattern counts the JAX statics' support (md) entries plus one per
    limit row."""
    model, dF, layout, fstat, tol, exists = case
    tm = tspec.load_model(device="cpu")
    pat = tS._fused_statics(tm, tCn.efc_layout(tm))["j_pattern"]
    dense = np.asarray(jax.jit(jax.vmap(lambda d: jCn.dense_J(model, d)))(dF))
    on = np.zeros(dense.shape[1:], bool)
    for r, (_, _, col0, n) in enumerate(pat["rec"]):
        on[r, pat["cols"][col0:col0 + n]] = True
    assert (dense[:, ~on] == 0).all()
    # the pattern is not padding: 85% of its entries are nonzero in some env
    # (the rest are zeros of the values, e.g. a free joint's components
    # along a plane contact's normal)
    assert dense[:, on].any(0).mean() > 0.75
    rs = np.asarray(fstat["row_slot"])
    md = np.asarray(fstat["md"])
    assert pat["nnz"] == on.sum() == int((md[rs[rs >= 0]] != 0).sum()) + len(fstat["limit_dadr"])


def test_port_statics_and_wrapper_dispatch(case):
    """The port's own static tables equal the JAX package's, and on CPU
    tensors the wrapper runs exactly the plain version."""
    model, dF, layout, fstat, tol, exists = case
    tm = tspec.load_model(device="cpu")
    tf = tS._fused_statics(tm, tCn.efc_layout(tm))
    for k in ("row_slot", "sz", "root_bounds", "limit_dadr"):
        assert tf[k] == fstat[k], k
    np.testing.assert_array_equal(tf["P"], fstat["P"])
    np.testing.assert_array_equal(tf["md"], fstat["md"])
    assert tS.quad_kernel_eligible(tm)

    ref = _port(case, False, 4)
    T = lambda x: torch.as_tensor(np.array(x, np.float64))
    B = exists.shape[0]
    launches = tcg.cg_solve_fused.launches
    out = tcg.cg_solve_fused(
        T(dF.crb_f), T(dF.cdof), T(dF.con_A), T(dF.efc_jsign), T(dF.efc_D),
        T(dF.efc_aref), torch.as_tensor(np.array(exists)), torch.zeros(B, 0, dtype=torch.bool),
        T(dF.qfrc_smooth), T(dF.qvel), T(np.zeros(model.nv)), T(fstat["P"]),
        T(fstat["md"]), T(model.dof_armature),
        iters=4, ls_iters=4, tol=tol, dt=float(model.opt.timestep),
        has_damping=False, row_slot=fstat["row_slot"], sz=fstat["sz"],
        root_bounds=fstat["root_bounds"], limit_dadr=fstat["limit_dadr"],
        device="cpu",
    )
    assert tcg.cg_solve_fused.launches == launches  # the plain version launches nothing
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_smem_rule():
    """The Hopper eligibility rule: one env's qM, M^-1 and J fit a block's
    shared memory. The minirat needs ~8 KB; a rodent-size model
    (nv=73, ~300 rows) ~144 KB; a model with 1000 rows does not fit."""
    assert tcg.kernel_smem_bytes(10, 92) == 8136
    assert tcg.kernel_smem_bytes(73, 300) <= tcg.H100_SMEM_PER_BLOCK
    assert tcg.kernel_smem_bytes(73, 1000) > tcg.H100_SMEM_PER_BLOCK


def test_kernel_smem_fused_staging():
    """cg_solve_fused stages the rest of the assembly's inputs (P A: 6
    nefc-vectors per root; md: ncon x nv) past the core's layout. The
    minirat (one root, 22 contact slots) then needs 11,224 B, and the
    solver's eligibility check counts them; at most 13,312 B (the H100's
    228 KB per SM over 16 blocks, less the 1 KB reserved per block)
    leaves the 16 one-warp blocks per SM that hold 2048 envs in one wave."""
    assert tcg.kernel_smem_bytes(10, 92, 0, 1, 22) == 8136 + 4 * (6 * 92 + 22 * 10) == 11224
    assert tcg.kernel_smem_bytes(10, 92, 0, 1, 22) <= 228 * 1024 // 16 - 1024
    m = tspec.load_model(device="cpu")
    layout = tCn.efc_layout(m)
    st = tS._solve_statics(m, layout)
    assert (len(st["kw"]["root_bounds"]), m.ncon, m.nv, layout.nefc) == (1, 22, 10, 92)
    for nv in (10, 73):
        assert tcg.kernel_smem_bytes(nv, 300, 0, 1, 70) <= tcg.H100_SMEM_PER_BLOCK


def test_float32_error_is_rounding_not_conditioning(capsys):
    """At the main path's 4 CG / 4 line-search iterations on stiff contact
    states, the float32 solve is far from float64 (PERF.md section 6): in
    the port's plain version and in the JAX array path alike, while a 1e-7
    relative perturbation of the inputs moves the float64 result ~100x less.
    Prints the median per-env relative qacc errors."""
    from brax_tracking_tpu_torch.physics import step as tstep

    B = 64
    tm = tspec.load_model(device="cpu")
    rng = np.random.RandomState(0)
    qpos = np.tile(tm.qpos0.numpy()[None], (B, 1))
    qpos[:, 2] -= 0.01
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, tm.nq - 7))
    d = tstep.make_data(tm, B, device="cpu").replace(
        qpos=torch.as_tensor(qpos),
        qvel=torch.as_tensor(rng.uniform(-0.5, 0.5, (B, tm.nv))),
        ctrl=torch.as_tensor(rng.uniform(-0.3, 0.3, (B, tm.nu))),
    )
    d = tstep.forward_to_constraint(tm, d)
    st = tS._solve_statics(tm, tCn.efc_layout(tm))
    kw = st["kw"]
    Bm = tcg._bm(st["P"], d.con_A, len(kw["root_bounds"]), tm.ncon)
    qM, J = tcg.assemble_qM_J(
        d.crb_f, d.cdof, Bm, d.efc_jsign, st["md"], tm.dof_armature,
        row_slot=kw["row_slot"], sz=kw["sz"], root_bounds=kw["root_bounds"],
        limit_dadr=kw["limit_dadr"],
    )
    ins = (qM, J, d.efc_D, d.efc_aref)
    exists = d.efc_pos < d.efc_margin
    solve = dict(iters=kw["iters"], ls_iters=kw["ls_iters"], tol=kw["tol"],
                 dt=kw["dt"], damp=st["damp"], has_damping=False)

    def port(qM, J, D, aref):
        return tcg._cg_arrays(qM, J, D, aref, exists, d.qfrc_smooth.to(qM.dtype),
                              d.qvel.to(qM.dtype), **dict(solve, damp=st["damp"].to(qM.dtype)))[0]

    nlim = len(kw["limit_dadr"])
    jstatics = dict(
        L1=np.eye(tm.nv)[list(kw["limit_dadr"])], iters=kw["iters"],
        ls_iters=kw["ls_iters"], tol=kw["tol"], dt=kw["dt"], damp=np.zeros(tm.nv),
        has_damping=False, quad_mask=np.ones(J.shape[1]), ell0=J.shape[1],
        ell_mu=np.zeros(0), ell_scale=np.zeros((0, 2)),
    )

    # jitted: one compile per dtype instead of the eager vmap's many
    solve_jax = jax.jit(jax.vmap(
        lambda qM, Jc, js, D, ar, ex, qfs, qv: jS._cg_arrays(
            qM, Jc, js, D, ar, ex, jnp.zeros((0,), bool), qfs, qv, **jstatics
        )[0]
    ))

    def jax_arrays(dtype):
        c = lambda t: jnp.asarray(t.numpy(), dtype)
        return np.asarray(solve_jax(
            c(qM), c(J[:, nlim:]), c(d.efc_jsign), c(d.efc_D), c(d.efc_aref),
            jnp.asarray(exists.numpy()), c(d.qfrc_smooth), c(d.qvel),
        ), np.float64)

    def median_rel(x, ref):
        x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
        return float(np.median(np.abs(x - ref).max(-1) / np.abs(ref).max(-1)))

    ref = port(*ins).numpy()
    g = torch.Generator().manual_seed(1)
    perturbed = [t * (1 + 1e-7 * torch.randn(t.shape, generator=g, dtype=t.dtype)) for t in ins]
    e_perturbed = median_rel(port(*perturbed), ref)
    e_port32 = median_rel(port(*(t.float() for t in ins)), ref)
    e_jax32 = median_rel(jax_arrays(jnp.float32), ref)
    np.testing.assert_allclose(jax_arrays(jnp.float64), ref, rtol=RTOL, atol=ATOL)
    with capsys.disabled():
        print(f"\nmedian per-env relative qacc error vs float64 (B={B}): port float32 "
              f"{e_port32:.3e}, JAX array path float32 {e_jax32:.3e}, float64 with "
              f"1e-7 input noise {e_perturbed:.3e}")
    assert e_port32 > 100 * e_perturbed and e_jax32 > 100 * e_perturbed
    assert 0.2 < e_port32 / e_jax32 < 5.0


def _file_point(npz, **options):
    """kernel_layout's arguments for a frozen file: (nv, nefc, nell,
    nroots, ncon), as solver._kernel_args passes them."""
    m = tspec.load_model(npz, device="cpu", **options)
    layout = tCn.efc_layout(m)
    st = tS._solve_statics(m, layout)
    return (m.nv, layout.nefc, len(st["kw"]["ell_mu"]), len(st["kw"]["root_bounds"]), m.ncon)


# kernel_layout's points: the files the port runs, a rodent-size env, the
# one-warp / wide edge and layout 2's design edges at the pair's 590 rows
# (chip_smoke.py's wide_edges and l2_edges), and layout 2's widest env.
# Expected (layout, shared memory per block, warps per env): the one-warp
# block's kernel_smem_bytes where at least three share an SM (<= 76,800 B),
# else the wide block's wide_smem_bytes on 8 warps in layout 1, 16 in
# layout 2.
LAYOUT_POINTS = {
    "minirat": (lambda: (10, 92, 0, 1, 22), (1, 11224, 1)),
    "minirat_elliptic": (lambda: _file_point(tspec.MINIRAT_ELLIPTIC_NPZ), (1, 9552, 1)),
    "minirat_newton": (lambda: _file_point(tspec.MINIRAT_NEWTON_NPZ,
                                           **tspec.MINIRAT_NEWTON_OPTIONS), (1, 11224, 1)),
    "ballmuscle": (lambda: _file_point(tspec.BALLMUSCLE_NPZ["cg"], solver="cg"), (1, 1320, 1)),
    # the one-warp core past nv 16 (its panel sweep's buffers overlay the
    # block, which stays this size: 6 / 7 blocks per SM)
    "fly_standin": (lambda: _file_point(tspec.FLY_STANDIN_NPZ), (1, 36696, 1)),
    "fly_standin_tethered": (lambda: _file_point(tspec.FLY_STANDIN_TETHERED_NPZ), (1, 30288, 1)),
    "rodent_size": (lambda: (73, 300, 0, 1, 70), (1, 144064, 8)),
    "rat": (lambda: _file_point(tspec.RAT_NPZ), (1, 100784, 8)),
    "ratpair": (lambda: _file_point(tspec.RATPAIR_NPZ), (2, 195936, 16)),
    "ratpair_elliptic": (lambda: _file_point(tspec.RATPAIR_ELLIPTIC_NPZ), (2, 195008, 16)),
    "ratpair_newton": (lambda: _file_point(tspec.RATPAIR_NEWTON_NPZ,
                                           **tspec.MINIRAT_NEWTON_OPTIONS), (2, 195936, 16)),
    "narrow_last": (lambda: (23, 590), (1, 74972, 1)),
    "wide_first": (lambda: (24, 590), (1, 79056, 8)),
    "l1_last": (lambda: (72, 590), (1, 231696, 8)),
    "l2_first": (lambda: (73, 590), (2, 63440, 16)),
    "l2_last": (lambda: (160, 590), (2, 227312, 16)),
    "l2_widest": (lambda: (164, 364), (2, 232448, 16)),
}


@pytest.mark.parametrize("point", sorted(LAYOUT_POINTS))
def test_kernel_layout_rule(point):
    """ops/cg.py::kernel_layout, the one rule the wrappers and the solver's
    dispatch share: (layout, shared memory per block, warps per env) at
    each of LAYOUT_POINTS. One warp in layout 1 for the minirat's three
    files and the ballmuscle (16 and more envs per SM); the wide core
    (WIDE_WARPS[layout] warps) in layout 1 for a rodent-size env and the one-rat
    file, in layout 2 (J in device memory) for the two-rat stand-in's three
    files; the edges at 590 rows."""
    args, expected = LAYOUT_POINTS[point]
    args = args()
    assert tcg.kernel_layout(*args) == expected
    layout, smem, warps = expected
    if warps == 1:
        assert smem == tcg.kernel_smem_bytes(*args) <= tcg.WIDE_ABOVE_SMEM
    else:
        assert tcg.kernel_smem_bytes(*args) > tcg.WIDE_ABOVE_SMEM
        assert smem == tcg.wide_smem_bytes(*args[:3], l2=layout == 2) <= tcg.H100_SMEM_PER_BLOCK


def test_kernel_layout_edges():
    """chip_smoke.py's edges at the pair's 590 rows follow the rule: the
    widest one-warp env and the first wide one (nv 23 / 24), the widest in
    layout 1 and the first and widest in layout 2 (nv 72 / 73 / 160)."""
    import chip_smoke as cs

    assert cs.wide_edges() == (23, 24)
    assert cs.l2_edges() == (72, 73, 160)
    sizes = cs.seeded_dense()
    for name, nv in (("narrow_last", 23), ("wide_first", 24), ("l1_last", 72),
                     ("l2_first", 73), ("l2_last", 160)):
        assert (sizes[name]["nv"], sizes[name]["nefc"]) == (nv, 590)
        assert tcg.kernel_layout(nv, 590) == LAYOUT_POINTS[name][1]


def test_kernel_layout_keeps_every_one_warp_env():
    """No env the one-warp layouts ran raises now: wherever their rule took
    an env (layout 1, 4 (2 nv ld + nefc ld + 6 nefc + 25 nv + 4 nell) <=
    232,448 B with ld = nv | 1; or layout 2, 4 (2 nv ld + 6 nefc + 25 nv + 4
    nell) <= 232,448 B), kernel_layout gives a layout within one block."""
    limit = tcg.H100_SMEM_PER_BLOCK
    for nv in range(1, 170):
        ld = nv | 1
        for nefc in list(range(0, 800, 13)) + [149, 150, 590]:
            for nell in {0, nefc // 3}:
                old = 4 * (2 * nv * ld + 6 * nefc + 25 * nv + 4 * nell)
                if min(old + 4 * nefc * ld, old) > limit:
                    continue
                layout, smem, warps = tcg.kernel_layout(nv, nefc, nell)
                assert warps in (1, tcg.WIDE_WARPS[layout]) and smem <= limit, (
                    nv, nefc, nell)


def test_kernel_layout_raises_past_layout_2(monkeypatch):
    """NotImplementedError naming §A.10 past the wide layout 2's bound (nv
    161 at 590 rows, nv 164 past 364 rows, nv 165 at no rows), and the
    solver's dispatch asks the same rule."""
    for nv, nefc in ((161, 590), (164, 365), (165, 0)):
        with pytest.raises(NotImplementedError, match=r"A\.10"):
            tcg.kernel_layout(nv, nefc)
    m = tspec.load_model(tspec.RATPAIR_NPZ, device="cpu")
    d = tstep.forward_to_constraint(m, tstep.make_data(m, 2, device="cpu"))
    tS._kernel_args(m, d, tCn.efc_layout(m))
    monkeypatch.setattr(tcg, "H100_SMEM_PER_BLOCK", 150_000)
    with pytest.raises(NotImplementedError, match=r"A\.10"):
        tS._kernel_args(m, d, tCn.efc_layout(m))


@pytest.mark.parametrize("nv", [5, 8, 9, 16, 36, 42, 73, 146])
def test_wide_sweep_panels(nv):
    """The wide core's M^-1 (sweep.cuh's panels in 8-pivot panels) and the
    one-warp core's past nv 16 (panels_warp, the same grouping; nv 36 and
    42 are the fly stand-in's) regroup the scalar sweep: their plain
    version, _sweep_inverse_panels_reference at nb = 8, agrees with
    sweep_inverse_reference in float64 on seeded SPD matrices (condition
    number 1e3), at this file's tolerance."""
    from brax_tracking_tpu_torch.ops import cholesky as tchol

    rng = np.random.RandomState(nv)
    q, _ = np.linalg.qr(rng.randn(3, nv, nv))
    M = torch.as_tensor((q * 1e3 ** rng.rand(3, 1, nv)) @ q.transpose(0, 2, 1))
    ref = tchol.sweep_inverse_reference(M)
    out = tchol._sweep_inverse_panels_reference(M, nb=8)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL * float(ref.abs().max()))


def _warp_panel_floats(nv: int, nb: int) -> int:
    """csrc/sweep.cuh::warp_panel_floats: Rk and Cn (nb x ld each, ld the
    most rows outside a panel rounded up to a multiple of 4), colk and
    rowk (nb x nb each)."""
    ld = (nv - ((nv - 1) % nb + 1) + 3) & ~3
    return 2 * nb * ld + 2 * nb * nb


def test_one_warp_panel_buffers_fit():
    """The one-warp core's panel sweep (nv > 16) keeps its buffers, 16-byte
    aligned, in what the sweep does not read (csrc/cg_fused.cu::carve: from
    jar on, 3 nefc + 24 nv floats in cg_solve_batched's block, more in
    cg_solve_fused's): they fit every env the one-warp rule takes, nefc 0
    included, at the kernel's panel width, so kernel_smem_bytes need not
    grow."""
    nb = 8  # csrc/cg_fused.cu::kWarpPanel
    taken = 0
    for nv in range(17, 170):
        nefc = 0
        while tcg.kernel_smem_bytes(nv, nefc) <= tcg.WIDE_ABOVE_SMEM:
            assert tcg.kernel_layout(nv, nefc)[2] == 1
            assert _warp_panel_floats(nv, nb) + 3 <= 3 * nefc + 24 * nv, (nv, nefc)
            taken += 1
            nefc += 1
    assert taken > 1000
