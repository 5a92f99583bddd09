"""Mixed-precision iterative refinement reaches the 1e-10 parity target."""

import jax.numpy as jnp
import numpy as np
import pytest

from dgtpu.ops.smoothers import element_colors
from dgtpu.ops.stencil import StencilOperator
from dgtpu.solvers.multigrid import MultigridSolver
from dgtpu.solvers.refinement import make_refined_solver


def test_refined_solve_reaches_1e10():
    import __graft_entry__
    dg = __graft_entry__._flagship(n=8, p_grid=2, p_sol=2)
    colors = [element_colors(l.Ni, l.Nj) for l in dg.levels]
    ops32 = [StencilOperator(l.op.blocks.astype(jnp.float32), l.op.nbr, l.op.mask)
             for l in dg.levels]

    class _T:
        pass

    tr32 = []
    for t in dg.transfers:
        t2 = _T()
        t2.__class__ = t.__class__
        t2.__dict__ = dict(t.__dict__)
        t2.R = t.R.astype(jnp.float32)
        t2.P = t.P.astype(jnp.float32)
        tr32.append(t2)
    mg32 = MultigridSolver(ops32, tr32, dg.transfer_types, dg.settings,
                           colors=colors)
    n_lev = len(ops32)
    solve = make_refined_solver(dg.levels[-1].op,
                                lambda r, u: mg32.v_cycle(n_lev, r, u),
                                n_inner=6, tol=1e-10)
    rhs = dg.levels[-1].rhs
    u, res, n, hist = solve(rhs, jnp.zeros_like(rhs))
    assert float(res) < 1e-10
    assert int(n) <= 6
    # the refined solution matches the f64 direct solve to ~1e-10
    from dgtpu.solvers.direct import solve_direct
    ud = np.asarray(solve_direct(dg.levels[-1].op, rhs))
    assert np.abs(np.asarray(u) - ud).max() < 1e-8


def test_gmres_inner_converges_where_stationary_diverges():
    """inner='gmres': Krylov-wrapped refinement must converge when the
    stand-alone cycle iteration has spectral radius > 1.

    An over-relaxed exact solve (u + omega*A^-1 r, omega=2.5) is the
    textbook case: the stationary iteration multiplies the error by
    |1-omega| = 1.5 per application (diverges), while GMRES with the SAME
    map as preconditioner solves in one iteration — the mechanism that
    rescues deep Stokes hierarchies whose cycle contraction degrades
    past 1."""
    import jax

    import __graft_entry__
    dg = __graft_entry__._flagship(n=4, p_grid=1, p_sol=1)
    op64 = dg.levels[-1].op
    rhs = dg.levels[-1].rhs
    ndof = rhs.shape[0]

    op32 = StencilOperator(op64.blocks.astype(jnp.float32), op64.nbr,
                           op64.mask)
    A32 = jax.vmap(op32.matvec, in_axes=1, out_axes=1)(
        jnp.eye(ndof, dtype=jnp.float32))
    omega = jnp.float32(2.5)

    def bad_cycle(r32, u32):
        return u32 + omega * jnp.linalg.solve(
            A32, (r32 - op32.matvec(u32))[:, None])[:, 0]

    plain = make_refined_solver(op64, bad_cycle, n_inner=4, tol=1e-10,
                                max_outer=8)
    _, res_plain, _, _ = plain(rhs, jnp.zeros_like(rhs))
    assert not (float(res_plain) < 1e-10), \
        "stationary iteration should diverge at omega=2.5"

    wrapped = make_refined_solver(op64, bad_cycle, n_inner=4, tol=1e-10,
                                  max_outer=8, inner="gmres",
                                  matvec32=op32.matvec)
    _, res, n, _ = wrapped(rhs, jnp.zeros_like(rhs))
    assert float(res) < 1e-10
    assert int(n) <= 6


def test_gmres_inner_requires_matvec():
    import pytest

    with pytest.raises(ValueError, match="matvec32"):
        make_refined_solver(None, lambda r, u: u, inner="gmres")


def test_precision_mixed_api_poisson():
    """performance.precision: mixed routes the multigrid solve through f32
    rolled V-cycles + f64 defect refinement, matching the full-f64 path."""
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params

    def run(precision):
        params = load_params()
        params["grid"]["filename"] = "Rectangle_8X8_nPoly2.xyz"
        params["grid"]["polynomial degree"] = 2
        params["solution"]["u"]["polynomial degree"] = 2
        params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
        params["performance"]["precision"] = precision
        params["visualization"]["export"] = False
        params["visualization"]["automatically open paraview"] = False
        params["logging"]["loglevel"] = "ERROR"
        s = Settings(params)
        s.solver.method = "multigrid"
        s.update_setting("solver.discretization", "dg")
        dg = DGFEM(settings=s, solve_multigrid=True)
        dg.solve()
        return dg

    mixed = run("mixed")
    assert mixed.residuals[-1] < 1e-6
    full = run("full")
    assert np.isclose(mixed.L2_error_u, full.L2_error_u, rtol=1e-6)


def test_precision_mixed_fvm_falls_back_to_full():
    """precision: mixed + an FVM coarse level (transfer kinds the f32
    cycles do not implement) must degrade to the full-precision path and
    still converge — not crash at the first refined() call (r3 review)."""
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params

    params = load_params()
    params["grid"]["filename"] = "Rectangle_8X8_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    mgp = params["solver"]["multigrid"]
    mgp["polynomial coarsening"]["levels"]["u"] = "1,2"
    mgp["geometric coarsening"]["enabled"] = True
    mgp["geometric coarsening"]["use FVM"] = True
    params["performance"]["precision"] = "mixed"
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    dg = DGFEM(settings=s, solve_multigrid=True)
    dg.solve()
    assert dg.residuals[-1] < 1e-6


def test_precision_mixed_fmg_seeds_refinement():
    """full multigrid + precision mixed: the FMG f32 guess seeds the
    refinement (api._solve_multigrid_mixed), so the first recorded residual
    starts far below 1 and the outer loop needs no more rounds than the
    zero-guess run, with the same solution (VERDICT r3 item 5)."""
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params

    def run(fmg):
        params = load_params()
        params["grid"]["filename"] = "Rectangle_8X8_nPoly2.xyz"
        params["grid"]["polynomial degree"] = 2
        params["solution"]["u"]["polynomial degree"] = 2
        params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
        params["solver"]["multigrid"]["full multigrid"] = fmg
        params["performance"]["precision"] = "mixed"
        params["visualization"]["export"] = False
        params["visualization"]["automatically open paraview"] = False
        params["logging"]["loglevel"] = "ERROR"
        params["caching"]["enabled"] = False
        s = Settings(params)
        s.solver.method = "multigrid"
        s.update_setting("solver.discretization", "dg")
        dg = DGFEM(settings=s, solve_multigrid=True)
        dg.solve()
        return dg

    plain = run(False)
    fmg = run(True)
    assert fmg.residuals[-1] < 1e-10
    # the FMG guess starts the outer loop orders below the zero guess
    assert fmg.residuals[0] < 5e-2
    assert len(fmg.residuals) <= len(plain.residuals)
    assert np.isclose(fmg.L2_error_u, plain.L2_error_u, rtol=1e-8)


def test_fused_stokes_fmg_guess():
    """SoAStokesVCycle.build_fmg: the nested-iteration guess lands well
    below the zero iterate on the saddle system."""
    import jax.numpy as jnp

    from dgtpu.api import DGFEM
    from dgtpu.ops.pallas_stokes import SoAStokesVCycle
    from dgtpu.settings import Settings, load_params

    params = load_params()
    params["problem"]["type"] = "Stokes"
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solution"]["p"]["polynomial degree"] = 1
    params["solution"]["ordering"] = "global"
    mgp = params["solver"]["multigrid"]
    mgp["penalty parameter coarsening"]["enabled"] = False
    mgp["polynomial coarsening"]["enabled"] = True
    mgp["polynomial coarsening"]["levels"]["u"] = "1,2"
    mgp["geometric coarsening"]["enabled"] = False
    for w in ("pre smoother", "post smoother"):
        mgp["polynomial coarsening"][w]["smoother"] = "distributive_gauss_seidel"
    mgp["coarse grid solver"] = "direct"
    params["performance"]["dgs_splitting"] = "lsq"
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    params["caching"]["enabled"] = False
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    dg = DGFEM(settings=s, solve_multigrid=True)
    sv = SoAStokesVCycle(dg.levels, dg.transfers, dg.transfer_types, s,
                         dtype=jnp.float32)
    fmg = sv.build_fmg()
    rhs = dg.levels[-1].rhs
    u0 = fmg(rhs.astype(jnp.float32)).astype(rhs.dtype)
    op = dg.levels[-1].op
    r = float(jnp.linalg.norm(rhs - op.matvec(u0)) / jnp.linalg.norm(rhs))
    assert r < 0.1, f"Stokes FMG guess too weak: {r}"



def test_rolled_fmg_matches_generic_fmg():
    """PallasVCycle.build_fmg() (the Poisson mixed route's FMG guess) lands
    as close to the solution as MultigridSolver.fmg_guess; on a
    single-level hierarchy the pass is just the coarse solve, i.e. one
    cycle from zero."""
    import jax.numpy as jnp

    import __graft_entry__
    from dgtpu.ops.pallas_vcycle import PallasVCycle
    from dgtpu.ops.smoothers import element_colors
    from dgtpu.solvers.multigrid import MultigridSolver

    dg = __graft_entry__._flagship(n=8, p_grid=2, p_sol=2)
    dims = [(lvl.Nj, lvl.Ni) for lvl in dg.levels]
    ops = [lvl.op for lvl in dg.levels]
    colors = [element_colors(lvl.Ni, lvl.Nj) for lvl in dg.levels]
    rhs = dg.levels[-1].rhs
    args = (dg.transfers, dg.transfer_types, dg.settings)

    def rel_res(u):
        return float(jnp.linalg.norm(rhs - ops[-1].matvec(jnp.asarray(u)))
                     / jnp.linalg.norm(rhs))

    a = PallasVCycle(ops, *args, dims, dtype=jnp.float64).build_fmg()(rhs)
    b = MultigridSolver(ops, *args, colors=colors).fmg_guess(rhs)
    assert rel_res(a) < 0.1
    assert rel_res(a) == pytest.approx(rel_res(b), rel=0.5)

    one = PallasVCycle(ops[-1:], [], [], dg.settings, dims[-1:],
                       dtype=jnp.float64)
    a = np.asarray(one.build_fmg()(rhs))
    b = np.asarray(one.build_xla()(rhs, jnp.zeros_like(rhs)))
    assert np.abs(a - b).max() < 1e-12 * np.abs(b).max()


@pytest.mark.slow
def test_precision_mixed_stokes_past_budget_on_cpu(monkeypatch):
    """Mixed precision on Stokes runs f32 SoA cycles + defect refinement
    at any hierarchy size instead of silently rerouting to full-precision
    f64."""
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params

    params = load_params()
    params["problem"]["type"] = "Stokes"
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solution"]["p"]["polynomial degree"] = 1
    params["solution"]["ordering"] = "global"
    mgp = params["solver"]["multigrid"]
    mgp["penalty parameter coarsening"]["enabled"] = False
    mgp["polynomial coarsening"]["enabled"] = True
    mgp["polynomial coarsening"]["levels"]["u"] = "1,2"
    mgp["geometric coarsening"]["enabled"] = False
    for w in ("pre smoother", "post smoother"):
        mgp["polynomial coarsening"][w]["smoother"] = "distributive_gauss_seidel"
    mgp["coarse grid solver"] = "direct"
    params["performance"]["precision"] = "mixed"
    params["performance"]["dgs_splitting"] = "lsq"
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    params["caching"]["enabled"] = False
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    dg = DGFEM(settings=s, solve_multigrid=True)
    dg.solve()
    # the mixed route ran (refinement residual, not the f64 fallback's 1e-6)
    assert dg.residuals[-1] < 1e-10


@pytest.mark.slow
def test_precision_mixed_api_stokes():
    """Mixed precision on the Stokes saddle system (SoA DGS inner cycle)."""
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params

    params = load_params()
    params["problem"]["type"] = "Stokes"
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solution"]["p"]["polynomial degree"] = 1
    params["solution"]["ordering"] = "global"
    mgp = params["solver"]["multigrid"]
    mgp["penalty parameter coarsening"]["enabled"] = False
    mgp["polynomial coarsening"]["enabled"] = True
    mgp["polynomial coarsening"]["levels"]["u"] = "1,2"
    mgp["geometric coarsening"]["enabled"] = False
    for w in ("pre smoother", "post smoother"):
        mgp["polynomial coarsening"][w]["smoother"] = "distributive_gauss_seidel"
    mgp["coarse grid solver"] = "direct"
    params["performance"]["precision"] = "mixed"
    params["performance"]["dgs_splitting"] = "lsq"
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    dg = DGFEM(settings=s, solve_multigrid=True)
    dg.solve()
    assert dg.residuals[-1] < 1e-6
    assert dg.L2_error_u < 0.05
