"""Newton on the solve kernel's layout: the minirat under Newton in the port
against the JAX package's batched branch, float64 on the CPU.

The JAX package sends a kernel-eligible Newton model, batched on its
accelerator, to ``solver._solve_newton_fused``'s batched branch: the CG
kernel with warmstart and the float32 stall exit, in chunks of
K = min(iterations, 4), until every env is done or the budget is spent,
then a damped model's Euler update by one SPD solve. The port always takes
that branch (ROADMAP A.2's dispatch rule). Here the JAX branch runs on the
CPU with ``ops_chol._use_pallas`` forced on and its kernels in interpret
mode (rolled loops), as tests/test_ops_cg_fused.py:231 runs it.

- the committed ``minirat_newton.npz`` (Newton/100, line search 50) equals a
  fresh freeze;
- the kernel's plain version with warmstart + stall exit (K = 4 CG
  iterations, 16 line-search steps, stall 4e-6, as the dispatch calls it)
  against the JAX kernel at rtol 1e-9 / atol 1e-11, with the better-of
  select going both ways;
- two substeps of 4 minirat envs at iterations = 8 (two chunks), undamped
  and with a seeded joint damping (the spd_solve tail), against the JAX
  step under vmap at 1e-10 of each field's scale: both sides run the same
  float64 algorithm (measured gaps ~1e-15);
- the chunk count the port records against the JAX kernel run chunk by
  chunk on the same inputs.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu.ops import cg as jcg
from brax_tracking_tpu.ops import cholesky as jchol
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep

B, ITERS = 4, 8
REL = 1e-10
FIELDS = ("qpos", "qvel", "qacc", "qacc_smooth", "qfrc_constraint", "efc_force")
T = lambda x: torch.as_tensor(np.array(x, np.float64))
J = lambda x: jnp.asarray(x.numpy())


def _rolled_interpret(fn):
    @functools.wraps(fn)
    def call(*args, **kw):
        return fn(*args, **{**kw, "unroll_iters": False, "unroll_ls": False, "interpret": True})
    return call


@pytest.fixture(scope="module")
def jax_kernel_branch():
    """The JAX package's batched Pallas branch, on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jchol, "_use_pallas", lambda x: True)
    mp.setattr(jcg, "cg_solve_fused", _rolled_interpret(jcg.cg_solve_fused))
    mp.setattr(jchol, "factor_solve_batched",
               functools.partial(jchol.factor_solve_batched, interpret=True))
    yield
    mp.undo()


def _states(jm, seed=0):
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(jm.qpos0, np.float64)[None], (B, 1))
    qpos[:, 2] -= 0.01
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, jm.nq - 7))
    return dict(qpos=qpos, qvel=rng.uniform(-0.5, 0.5, (B, jm.nv)),
                ctrl=rng.uniform(-0.3, 0.3, (B, jm.nu)))


def _models(damped):
    jm = jspec.build_model(
        "builtin:minirat.xml", solver="newton", iterations=ITERS, ls_iterations=50,
        dtype=jnp.float64,
    )
    if damped:
        damp = np.random.RandomState(11).uniform(0.005, 0.02, jm.nv)
        jm = jm.replace(dof_damping=jnp.asarray(damp), has_damping=True)
    return jm, tspec.model_from_numpy(tspec.model_to_numpy(jm), device="cpu")


@pytest.fixture(scope="module", params=["undamped", "damped"])
def substeps(request, jax_kernel_branch):
    """Two substeps from the same seeded states (the second warmstarted from
    the first's qacc) in both packages."""
    jm, tm = _models(request.param == "damped")
    st = _states(jm)
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstep.make_data(jm))
    dB = dB.replace(**{k: jnp.asarray(v) for k, v in st.items()})
    step = jax.jit(jax.vmap(lambda dd: jstep.step(jm, dd)))
    td = tstep.make_data(tm, B, device="cpu").replace(**{k: T(v) for k, v in st.items()})
    out = []
    for _ in range(2):
        dB = step(dB)
        t_in = td
        td = tstep.step(tm, td, device="cpu")
        out.append((dB, td, t_in))
    return jm, tm, out


def test_committed_npz_matches_fresh_freeze(tmp_path):
    try:
        importlib.import_module("mujoco")
    except ImportError:
        pytest.skip("the mujoco bindings are needed to freeze an MJCF")
    fresh = tspec.freeze_mjcf(tspec.MINIRAT_XML, str(tmp_path / "n.npz"),
                              **tspec.MINIRAT_NEWTON_OPTIONS)
    with np.load(tspec.MINIRAT_NEWTON_NPZ) as z:
        assert sorted(fresh) == sorted(z.files)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_frozen_newton_minirat_takes_the_kernel():
    tm = tspec.load_model(tspec.MINIRAT_NEWTON_NPZ, device="cpu", **tspec.MINIRAT_NEWTON_OPTIONS)
    assert tm.opt.solver == 2 and tm.opt.iterations == 100 and tm.opt.ls_iterations == 50
    assert tS.quad_kernel_eligible(tm) and not tm.has_damping
    d = tstep.step(tm, tstep.make_data(tm, 2, device="cpu"), device="cpu")
    assert d.qM is None  # undamped: no dense qM
    assert isinstance(d.solver_nchunk, int) and 1 <= d.solver_nchunk <= 25


@pytest.mark.parametrize("k", [0, 1])
def test_substep_matches_jax(substeps, k):
    jm, tm, out = substeps
    jd, td, _ = out[k]
    for name in FIELDS:
        ref = np.asarray(getattr(jd, name))
        err = np.abs(getattr(td, name).numpy() - ref).max()
        assert err <= REL * np.abs(ref).max(), (name, err)
    # two chunks of 4 ran (the budget of 8): the first did not finish every env
    assert td.solver_nchunk == 2
    assert (td.qM is not None) == bool(tm.has_damping)


def _jax_chunks(tm, t_in):
    """The JAX kernel run chunk by chunk on the port's inputs, with the
    dispatch's stopping rule; returns (chunks, qacc)."""
    d = tstep.forward_to_constraint(tm, t_in)
    args, kw = tS._kernel_args(tm, d, tCn.efc_layout(tm))
    kw = dict(kw, iters=4, ls_iters=16, has_damping=False, stall_tol=tS.STALL_TOL_F32)
    ws = d.qacc_warmstart if d.qacc_warmstart is not None else torch.zeros_like(d.qfrc_smooth)
    jargs = [J(a) for a in args]
    run = lambda x0: jcg.cg_solve_fused(*jargs, **kw, warmstart=x0, unroll_iters=False,
                                        unroll_ls=False, interpret=True)
    out, n = run(J(ws)), 1
    while n < -(-ITERS // 4) and not bool(np.all(np.asarray(out[5]))):
        out, n = run(out[0]), n + 1
    return n, np.asarray(out[0])


def test_chunk_count_matches_jax_kernel(substeps):
    jm, tm, out = substeps
    for jd, td, t_in in out:
        n, qacc = _jax_chunks(tm, t_in)
        assert td.solver_nchunk == n
        np.testing.assert_allclose(td.qacc.numpy(), qacc, rtol=1e-9, atol=1e-11)


def test_ws_stall_reference_matches_jax_kernel():
    """The kernel's plain version with warmstart and the stall exit, as the
    dispatch calls it, against the JAX kernel on the same inputs. The
    warmstart is near the solution in two envs (it wins the better-of
    select), zeros in one and far off in one (it loses to qacc_smooth);
    with 0 iterations both packages return the same starts."""
    jm, tm = _models(False)
    st = _states(jm, seed=1)
    d = tstep.make_data(tm, B, device="cpu").replace(**{k: T(v) for k, v in st.items()})
    d = tstep.forward_to_constraint(tm, d)
    args, kw = tS._kernel_args(tm, d, tCn.efc_layout(tm))
    kw = dict(kw, iters=4, ls_iters=16, has_damping=False, stall_tol=tS.STALL_TOL_F32)
    sol = tcg.cg_solve_fused_reference(*args, **dict(kw, iters=32, stall_tol=0.0))[0]
    far = sol[3:] + 100.0 * torch.as_tensor(np.random.RandomState(5).randn(1, jm.nv))
    ws = torch.cat([sol[:2] * (1 + 1e-4), torch.zeros(1, jm.nv), far])
    tout = tcg.cg_solve_fused(*args, **kw, warmstart=ws, device="cpu")
    kout = jcg.cg_solve_fused(*[J(a) for a in args], **kw, warmstart=J(ws),
                              unroll_iters=False, unroll_ls=False, interpret=True)
    for name, k, t in zip(("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new"),
                          kout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(k), rtol=1e-9, atol=1e-11, err_msg=name)
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(kout[5]))
    start = tcg.cg_solve_fused(*args, **dict(kw, iters=0), warmstart=ws, device="cpu")[0]
    kstart = jcg.cg_solve_fused(*[J(a) for a in args], **dict(kw, iters=0), warmstart=J(ws),
                                unroll_iters=False, unroll_ls=False, interpret=True)[0]
    np.testing.assert_allclose(start.numpy(), np.asarray(kstart), rtol=1e-9, atol=1e-11)
    assert torch.equal(start[:2], ws[:2])  # the near-solution warmstart wins
    assert torch.equal(start[3], tout[3][3])  # the far one loses to qacc_smooth
