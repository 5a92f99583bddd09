"""Multigrid V-cycle: convergence, oracle parity, all coarsening flavors."""

import os

import numpy as np
import pytest

from dgtpu.__main__ import main
from tests.conftest import INPUT_DIR, REPO
from tests.numpy_reference import numpy_block_gs_sweep


def run_cli(args):
    return main(args + ["--silent"])


def test_p_multigrid_converges_flagship():
    """8x8 p=5 Poisson, p(5,3,1) + geometric — the BASELINE north-star config."""
    dg = run_cli(["-m", "-f", "Rectangle_8X8_nPoly5.xyz"])
    assert dg.residuals[-1] < 1e-6
    assert len(dg.residuals) - 1 <= 15, f"too many cycles: {len(dg.residuals)-1}"
    assert dg.L2_error_u < 1e-4


def test_multigrid_matches_direct_solution():
    dg_mg = run_cli(["-m", "-f", "Rectangle_4X4_nPoly2.xyz", "--p-grid", "2"])
    dg_d = run_cli(["-d", "-f", "Rectangle_4X4_nPoly2.xyz", "--p-grid", "2"])
    assert np.isclose(dg_mg.L2_error_u, dg_d.L2_error_u, rtol=1e-2)


def test_multigrid_numpy_oracle_vcycle(base_settings):
    """One V-cycle of the 2-level p-multigrid reproduced in pure numpy."""
    import jax.numpy as jnp
    from dgtpu.geometry import Geometry
    from dgtpu.level import GridLevel
    from dgtpu.mms import ManufacturedSolution
    from dgtpu.models.poisson import assemble_poisson
    from dgtpu.ops.transfer import make_transfer
    from dgtpu.solvers.multigrid import MultigridSolver

    s = base_settings
    s.update_setting("grid.polynomial_degree", 1)
    s.update_setting("problem.multiply_inverse_mass_matrix", True)
    s.update_setting("solver.multigrid.geometric_coarsening.enabled", False)
    s.update_setting("solver.multigrid.polynomial_coarsening.enabled", True)
    s.update_setting("solver.multigrid.coarse_grid_solver", "direct")
    geom = Geometry(os.path.join(INPUT_DIR, "Rectangle_4X4_nPoly1.xyz"), s)
    mms = ManufacturedSolution({"u": "sin(pi*x)*sin(pi*y)"}, "Poisson", 1.0)
    fine = GridLevel(geom, s, ["u"], {"u": 3}, sigma=16.0)
    coarse = GridLevel(geom, s, ["u"], {"u": 1}, sigma=4.0)
    fine.op, rhs, _ = assemble_poisson(fine, mms)
    coarse.op, _, _ = assemble_poisson(coarse)
    t = make_transfer("polynomial", p_fine=3, p_coarse=1)
    mg = MultigridSolver([coarse.op, fine.op], [t], ["polynomial"], s)

    u, res, n, hist = mg.solve(rhs, max_cycles=60)
    assert float(res) < 1e-6

    # --- same V-cycle in numpy ---
    A_f = np.asarray(fine.op.to_dense())
    A_c = np.asarray(coarse.op.to_dense())
    b = np.asarray(rhs)
    B_f, B_c = 16, 4
    R = np.asarray(t.R)
    pre_cfg = s.solver.multigrid.polynomial_coarsening.pre_smoother
    post_cfg = s.solver.multigrid.polynomial_coarsening.post_smoother

    def np_smooth(A, b, x, cfg):
        for _ in range(int(cfg.iterations)):
            if cfg.direction in ("forward", "symmetric"):
                x = numpy_block_gs_sweep(A, b, x, B_f if A is A_f else B_c)
            if cfg.direction in ("backward", "symmetric"):
                x = numpy_block_gs_sweep(A, b, x, B_f if A is A_f else B_c,
                                         backward=True)
        return x

    u_np = np.zeros_like(b)
    for _ in range(int(n)):
        u_np = np_smooth(A_f, b, u_np, pre_cfg)
        r = b - A_f @ u_np
        r_c = (R @ r.reshape(-1, B_f).T).T.reshape(-1)
        e_c = np.linalg.solve(A_c, r_c)
        u_np = u_np + (R.T @ e_c.reshape(-1, B_c).T).T.reshape(-1)
        u_np = np_smooth(A_f, b, u_np, post_cfg)

    assert np.abs(np.asarray(u) - u_np).max() < 1e-9, \
        "device V-cycle differs from numpy oracle"


def test_penalty_coarsening_path(base_settings, monkeypatch):
    """Penalty-parameter coarsening multigrid runs and converges (Poisson)."""
    from dgtpu.settings import Settings, load_params
    params = load_params()
    params["solver"]["multigrid"]["penalty parameter coarsening"]["enabled"] = True
    params["solver"]["multigrid"]["penalty parameter coarsening"]["multipliers"] = "20,2"
    params["solver"]["multigrid"]["penalty parameter coarsening"]["pre smoother"]["smoother"] = "block_gauss_seidel"
    params["solver"]["multigrid"]["penalty parameter coarsening"]["post smoother"]["smoother"] = "block_gauss_seidel"
    params["solver"]["multigrid"]["polynomial coarsening"]["enabled"] = False
    params["solver"]["multigrid"]["geometric coarsening"]["enabled"] = False
    params["problem"]["SIP penalty parameter multiplier"] = 20
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    from dgtpu.api import DGFEM
    dg = DGFEM(settings=s)
    dg.solve()
    assert dg.residuals[-1] < 1e-6


def test_geometric_only_path(base_settings):
    import copy
    from dgtpu.settings import Settings, load_params
    params = load_params()
    params["solver"]["multigrid"]["polynomial coarsening"]["enabled"] = False
    params["solver"]["multigrid"]["geometric coarsening"]["enabled"] = True
    params["solver"]["multigrid"]["geometric coarsening"]["coarsening factors"] = "2,4"
    params["grid"]["filename"] = "Rectangle_8X8_nPoly1.xyz"
    params["grid"]["polynomial degree"] = 1
    params["solution"]["u"]["polynomial degree"] = 1
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    import os as _os
    from dgtpu.geometry import generate_rectangle_grid, write_plot3d
    path = _os.path.join(INPUT_DIR, "Rectangle_8X8_nPoly1.xyz")
    if not _os.path.exists(path):
        write_plot3d(path, *generate_rectangle_grid(8, 8, 1))
    from dgtpu.api import DGFEM
    dg = DGFEM(settings=s)
    dg.solve()
    assert dg.residuals[-1] < 1e-6
    assert len(dg.levels) == 3  # cf4, cf2, fine


def test_residual_history_saved():
    dg = run_cli(["-m", "-f", "Rectangle_4X4_nPoly2.xyz", "--p-grid", "2"])
    path = os.path.join(REPO, "postprocessing", "multigrid")
    files = [f for f in os.listdir(path) if f.endswith(".npy")]
    assert files
    hist = np.load(os.path.join(path, sorted(files)[0]))
    assert hist[0] == pytest.approx(1.0)
    assert hist[-1] < 1e-6


def test_w_cycle_converges_in_fewer_cycles():
    """W-cycles (dgtpu extension; reference is V-only) converge at least as
    fast per cycle as V on the flagship hierarchy."""
    import copy
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params

    def run(cycle):
        params = load_params()
        params["grid"]["filename"] = "Rectangle_8X8_nPoly5.xyz"
        params["solver"]["multigrid"]["cycle type"] = cycle
        params["visualization"]["export"] = False
        params["visualization"]["automatically open paraview"] = False
        params["logging"]["loglevel"] = "ERROR"
        params["caching"]["enabled"] = False
        s = Settings(params)
        s.solver.method = "multigrid"
        s.update_setting("solver.discretization", "dg")
        dg = DGFEM(settings=s, solve_multigrid=True)
        dg.solve()
        assert dg.residuals[-1] < 1e-6
        return len(dg.residuals) - 1

    n_v = run("V")
    n_w = run("W")
    assert n_w <= n_v, (n_w, n_v)


def _run_flagship_mg(cycle="V", fmg=False):
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params

    params = load_params()
    params["grid"]["filename"] = "Rectangle_8X8_nPoly5.xyz"
    params["solver"]["multigrid"]["cycle type"] = cycle
    params["solver"]["multigrid"]["full multigrid"] = fmg
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    params["caching"]["enabled"] = False
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    dg = DGFEM(settings=s, solve_multigrid=True)
    dg.solve()
    assert dg.residuals[-1] < 1e-6
    return dg


def test_f_cycle_converges_between_v_and_w():
    """F-cycles (dgtpu extension): converge, cycle count between W and V."""
    n_v = len(_run_flagship_mg("V").residuals) - 1
    n_f = len(_run_flagship_mg("F").residuals) - 1
    n_w = len(_run_flagship_mg("W").residuals) - 1
    assert n_w <= n_f <= n_v, (n_w, n_f, n_v)


def test_full_multigrid_initial_guess():
    """FMG nested iteration (dgtpu extension): the guess starts orders
    below a zero guess, the outer loop saves cycles, and the solution
    matches the non-FMG solve."""
    dg_v = _run_flagship_mg("V", fmg=False)
    dg_f = _run_flagship_mg("V", fmg=True)
    # history[0] is the normalized residual of the initial iterate:
    # 1.0 for the zero guess, far below for the FMG guess
    assert dg_v.residuals[0] == pytest.approx(1.0)
    assert dg_f.residuals[0] < 1e-1
    assert len(dg_f.residuals) < len(dg_v.residuals)
    assert np.isclose(dg_f.L2_error_u, dg_v.L2_error_u, rtol=1e-6)


def test_f_cycle_streamed_rejects_fused_and_sharded_accept():
    """cycle_type F: the rolled and sharded builders accept it and
    converge (parallel/halo.py, ops/pallas_vcycle.py)."""
    import jax.numpy as jnp

    from dgtpu.api import DGFEM
    from dgtpu.parallel.halo import ShardedMultigrid, make_mesh
    from dgtpu.settings import Settings, load_params

    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solver"]["multigrid"]["cycle type"] = "F"
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    params["caching"]["enabled"] = False
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    dg = DGFEM(settings=s, solve_multigrid=True)

    # the rolled builder accepts F and its cycle contracts
    from dgtpu.ops.pallas_vcycle import PallasVCycle
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    pv = PallasVCycle([l.op for l in dg.levels], dg.transfers,
                      dg.transfer_types, s, dims)
    one = pv.build_xla()
    rhs = dg.levels[-1].rhs.astype(jnp.float32)
    u = jnp.zeros_like(rhs)
    for _ in range(3):
        u = one(rhs, u)
    op = dg.levels[-1].op
    r3 = float(jnp.linalg.norm(rhs.astype(jnp.float64) - op.matvec(
        u.astype(jnp.float64))) / jnp.linalg.norm(rhs))
    assert r3 < 1e-2, f"rolled F-cycle not contracting: {r3}"

    # sharded builder accepts F and its cycle contracts
    sm = ShardedMultigrid([l for l in dg.levels], dg.transfers, s,
                          mesh=make_mesh(2))
    u_s, res_s, _ = sm.solve(dg.levels[-1].rhs)
    assert float(res_s) < 1e-6


@pytest.mark.slow
def test_stokes_fmg_f_cycle():
    """F-cycles + FMG on the Stokes saddle path (distributive-GS smoothing):
    measured 43 V-cycles -> 13 F+FMG cycles on the 8x8 p=2 hierarchy; this
    compact 4x4 version pins convergence, the FMG head start, and solution
    agreement with the plain-V solve."""
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params

    def run(cycle, fmg):
        params = load_params()
        params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
        params["grid"]["polynomial degree"] = 2
        params["problem"]["type"] = "Stokes"
        params["solution"]["ordering"] = "global"
        for ck in ("polynomial coarsening", "geometric coarsening"):
            for side in ("pre smoother", "post smoother"):
                params["solver"]["multigrid"][ck][side]["smoother"] = \
                    "distributive_gauss_seidel"
        params["solver"]["multigrid"]["cycle type"] = cycle
        params["solver"]["multigrid"]["full multigrid"] = fmg
        params["visualization"]["export"] = False
        params["visualization"]["automatically open paraview"] = False
        params["logging"]["loglevel"] = "ERROR"
        params["caching"]["enabled"] = False
        s = Settings(params)
        s.solver.method = "multigrid"
        s.update_setting("solver.discretization", "dg")
        dg = DGFEM(settings=s, solve_multigrid=True)
        dg.solve()
        assert dg.residuals[-1] < 1e-6
        return dg

    dg_v = run("V", False)
    dg_f = run("F", True)
    assert dg_f.residuals[0] < 0.5            # FMG head start
    assert len(dg_f.residuals) <= len(dg_v.residuals)
    # both iterates satisfy the 1e-6 residual criterion but differ at the
    # residual-induced level (~5e-4 relative on this hierarchy)
    assert np.isclose(dg_f.L2_error_u, dg_v.L2_error_u, rtol=1e-2)
