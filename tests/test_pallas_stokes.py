"""SoA Stokes DGS V-cycle vs the generic multigrid path.

The SoA cycle must match MultigridSolver with the stencil-form
distributive-GS smoother (``performance.dgs_splitting = lsq``) —
same algorithm, different memory layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dgtpu.api import DGFEM
from dgtpu.ops.pallas_stokes import SoAStokesVCycle
from dgtpu.ops.smoothers import element_colors
from dgtpu.settings import Settings, load_params
from dgtpu.solvers.multigrid import MultigridSolver


@pytest.fixture(scope="module")
def stokes_mg():
    params = load_params()
    params["problem"]["type"] = "Stokes"
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solution"]["p"]["polynomial degree"] = 1
    params["solution"]["ordering"] = "global"
    params["solver"]["multigrid"]["penalty parameter coarsening"]["enabled"] = False
    params["solver"]["multigrid"]["polynomial coarsening"]["enabled"] = True
    params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
    params["solver"]["multigrid"]["geometric coarsening"]["enabled"] = True
    params["solver"]["multigrid"]["geometric coarsening"]["coarsening factors"] = 2
    for c in ("polynomial coarsening", "geometric coarsening"):
        for w in ("pre smoother", "post smoother"):
            params["solver"]["multigrid"][c][w]["smoother"] = \
                "distributive_gauss_seidel"
    params["solver"]["multigrid"]["coarse grid solver"] = "direct"
    params["performance"]["dgs_splitting"] = "lsq"
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    return DGFEM(settings=s, solve_multigrid=True)


@pytest.fixture(scope="module")
def soa(stokes_mg):
    return SoAStokesVCycle(stokes_mg.levels, stokes_mg.transfers,
                           stokes_mg.transfer_types, stokes_mg.settings,
                           dtype=jnp.float64)


@pytest.mark.slow
def test_soa_stokes_matches_generic_vcycle(stokes_mg, soa):
    dg = stokes_mg
    assert [(l.Ni, l.Nj) for l in dg.levels] == [(2, 2), (4, 4), (4, 4)]
    colors = [element_colors(l.Ni, l.Nj) for l in dg.levels]
    mg = MultigridSolver([l.op for l in dg.levels], dg.transfers,
                         dg.transfer_types, dg.settings, colors=colors,
                         levels=dg.levels)
    soa_xla = soa.build_xla()
    rhs = dg.levels[-1].rhs
    n_lev = len(dg.levels)
    ug = us = jnp.zeros_like(rhs)
    for _ in range(2):
        ug = mg.v_cycle(n_lev, rhs, ug)
        us = soa_xla(rhs, us)
    scale = float(jnp.abs(ug).max())
    assert float(jnp.abs(us - ug).max()) / scale < 1e-11
    op = dg.levels[-1].op
    r = float(jnp.linalg.norm(rhs - op.matvec(us)) / jnp.linalg.norm(rhs))
    assert r < 1e-2


def test_soa_stokes_solves_to_tolerance(stokes_mg, soa):
    """Repeated SoA cycles reach the paramfile tolerance."""
    dg = stokes_mg
    cyc = soa.build_xla()
    rhs = dg.levels[-1].rhs
    op = dg.levels[-1].op
    u = jnp.zeros_like(rhs)
    r0 = float(jnp.linalg.norm(rhs))
    for n in range(25):
        u = cyc(rhs, u)
        r = float(jnp.linalg.norm(rhs - op.matvec(u))) / r0
        if r < 1e-6:
            break
    assert r < 1e-6
    assert n + 1 <= 20


def test_soa_stokes_build_matvec(stokes_mg, soa):
    """build_matvec on the SoA builder equals op.matvec (the operator
    handed to Krylov-wrapped refinement)."""
    import numpy as np
    dg = stokes_mg
    mv = soa.build_matvec()
    op = dg.levels[-1].op
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(dg.levels[-1].rhs.shape[0]))
    y_ref = np.asarray(op.matvec(x))
    y = np.asarray(mv(x))
    rel = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
    assert rel < 1e-12, rel


def test_soa_stokes_rejects_non_dgs_config(stokes_mg):
    dg = stokes_mg
    import copy
    s2 = dg.settings
    old = s2.solver.multigrid.polynomial_coarsening.pre_smoother.smoother
    s2.solver.multigrid.polynomial_coarsening.pre_smoother.smoother = "jacobi"
    try:
        with pytest.raises(ValueError, match="distributive"):
            SoAStokesVCycle(dg.levels, dg.transfers, dg.transfer_types,
                            s2, dtype=jnp.float64)
    finally:
        s2.solver.multigrid.polynomial_coarsening.pre_smoother.smoother = old
