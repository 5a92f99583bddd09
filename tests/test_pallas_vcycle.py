"""Rolled-layout V-cycle vs the generic XLA multigrid path.

The rolled cycle is the f32 inner cycle of the Poisson mixed-precision
route; it must contract like ``MultigridSolver`` for every cycle type it
implements, on Cartesian and O-grid (periodic i-neighbor) topologies, in
both of its layouts (color-split for even Ni, masked otherwise).
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest

from dgtpu.ops.pallas_vcycle import PallasVCycle
from dgtpu.ops.smoothers import element_colors
from dgtpu.solvers.multigrid import MultigridSolver


INPUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "input")


@pytest.fixture(scope="module")
def flagship():
    import __graft_entry__
    return __graft_entry__._flagship(n=8, p_grid=2, p_sol=2)


@pytest.fixture(scope="module")
def ogrid():
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params
    params = load_params()
    params["grid"]["filename"] = "CircleInCircle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["grid"]["O grid"] = True
    params["grid"]["circular"] = True
    params["solution"]["u"]["polynomial degree"] = 2
    params["problem"]["SIP penalty parameter multiplier"] = 2
    params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    return DGFEM(settings=s, solve_multigrid=True)


def _rolled(dg, settings=None):
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    return PallasVCycle([l.op for l in dg.levels], dg.transfers,
                        dg.transfer_types, settings or dg.settings, dims,
                        dtype=jnp.float64)


def _generic(dg, settings=None):
    colors = [element_colors(l.Ni, l.Nj) for l in dg.levels]
    return MultigridSolver([l.op for l in dg.levels], dg.transfers,
                           dg.transfer_types, settings or dg.settings,
                           colors=colors)


def _residual(dg, u):
    rhs = dg.levels[-1].rhs
    return float(jnp.linalg.norm(rhs - dg.levels[-1].op.matvec(u))
                 / jnp.linalg.norm(rhs))


def _run(dg, cycle, n):
    rhs = dg.levels[-1].rhs
    u = jnp.zeros_like(rhs)
    for _ in range(n):
        u = cycle(rhs, u)
    return u


@pytest.mark.parametrize("grid", ["flagship", "ogrid"])
def test_rolled_cycle_matches_generic(grid, request):
    """Three rolled V-cycles contract at least as well as three generic
    ones, also where the i-neighbors wrap around an O-grid."""
    dg = request.getfixturevalue(grid)
    mg = _generic(dg)
    n_lev = len(dg.levels)
    rr = _residual(dg, _run(dg, _rolled(dg).build_xla(), 3))
    rg = _residual(dg, _run(dg, lambda r, u: mg.v_cycle(n_lev, r, u), 3))
    assert rr < 5e-2
    assert rr <= 1.3 * rg


def test_rolled_w_cycle_matches_generic(flagship):
    """cycle_type: W visits the coarse sub-hierarchies twice, as
    MultigridSolver does, and contracts at least as fast as V."""
    dg = flagship
    s = copy.deepcopy(dg.settings)
    s.solver.multigrid.cycle_type = "W"
    pv = _rolled(dg, s)
    assert pv.cycle_type == "W"
    mg = _generic(dg, s)
    n_lev = len(dg.levels)
    rw = _residual(dg, _run(dg, pv.build_xla(), 2))
    rg = _residual(dg, _run(dg, lambda r, u: mg.v_cycle(n_lev, r, u), 2))
    assert rw == pytest.approx(rg, rel=0.3)
    rv = _residual(dg, _run(dg, _rolled(dg).build_xla(), 2))
    assert rw <= rv * 1.05


def test_rolled_f_cycle_between_v_and_w(flagship):
    """cycle_type: F recurses as F on the first coarse visit and as a plain
    V on the revisit: its contraction lies between V's and W's."""
    dg = flagship

    def run(cycle):
        s = copy.deepcopy(dg.settings)
        s.solver.multigrid.cycle_type = cycle
        return _residual(dg, _run(dg, _rolled(dg, s).build_xla(), 2))

    rv, rf, rw = run("V"), run("F"), run("W")
    assert rw <= rf * 1.05 and rf <= rv * 1.05


def test_rolled_masked_layout_matches_split(flagship):
    """The masked layout (used when some level has an odd Ni) computes the
    color-split layout's iterate."""
    dg = flagship
    pv = _rolled(dg)
    assert pv.use_split
    u_split = _run(dg, pv.build_xla(), 3)
    pv.use_split = False
    u_masked = _run(dg, pv.build_xla(), 3)
    scale = float(jnp.abs(u_split).max())
    assert float(jnp.abs(u_masked - u_split).max()) < 1e-11 * scale


@pytest.mark.slow
def test_pallas_vcycle_converges_like_xla(flagship):
    dg = flagship
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    pv = PallasVCycle([l.op for l in dg.levels], dg.transfers,
                      dg.transfer_types, dg.settings, dims,
                      dtype=jnp.float64)
    cycle = pv.build_xla()
    colors = [element_colors(l.Ni, l.Nj) for l in dg.levels]
    mg = MultigridSolver([l.op for l in dg.levels], dg.transfers,
                         dg.transfer_types, dg.settings, colors=colors)
    rhs = dg.levels[-1].rhs
    A = dg.levels[-1].op
    r0 = float(jnp.linalg.norm(rhs))

    up = jnp.zeros_like(rhs)
    ux = jnp.zeros_like(rhs)
    for _ in range(8):
        up = cycle(rhs, up)
        ux = mg.v_cycle(len(dg.levels), rhs, ux)
    rp = float(jnp.linalg.norm(rhs - A.matvec(up))) / r0
    rx = float(jnp.linalg.norm(rhs - A.matvec(ux))) / r0
    assert rp < 1e-6
    assert rp == pytest.approx(rx, rel=0.2)
    assert np.abs(np.asarray(up - ux)).max() < 1e-6


def test_rolled_ops_match_gather(flagship):
    from dgtpu.ops import rolled
    dg = flagship
    lvl = dg.levels[-1]
    op = lvl.op
    Ni, Nj, B = lvl.Ni, lvl.Nj, lvl.N_DOF_sol_tot
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(op.shape[1]))
    blocks_r = rolled.to_rolled(op, Ni, Nj)
    mv_roll = rolled.matvec(blocks_r, x.reshape(Nj, Ni, B)).reshape(-1)
    mv_gather = op.matvec(x)
    scale = float(jnp.abs(mv_gather).max())
    assert float(jnp.abs(mv_roll - mv_gather).max()) < 1e-13 * scale


def test_color_split_ops_match_masked(flagship):
    """The gather-free color-split layout reproduces the masked rolled ops
    (same math, half the traffic per color pass)."""
    import jax.numpy as jnp
    from dgtpu.ops import rolled

    dg = flagship
    lvl = dg.levels[-1]
    Ni, Nj, B = lvl.Ni, lvl.Nj, lvl.N_DOF_sol_tot
    blocks = rolled.to_rolled(lvl.op, Ni, Nj)
    from dgtpu.ops.linalg import host_inv
    Dinv = host_inv(blocks[:, :, 0])
    masks = rolled.color_masks(Nj, Ni, blocks.dtype)
    even = rolled.parity_mask(Nj, blocks.dtype)
    bc, dc = rolled.pack_operator_colors(blocks, Dinv)

    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.standard_normal((Nj, Ni, B)))
    rhs = jnp.asarray(rng.standard_normal((Nj, Ni, B)))

    # pack/unpack round trip
    u0, u1 = rolled.pack_colors(u, even)
    assert np.allclose(np.asarray(rolled.unpack_colors(u0, u1, even)),
                       np.asarray(u))

    # matvec parity
    r_ref = rolled.matvec(blocks, u)
    r0, r1 = rolled.matvec_split(bc, (u0, u1), even)
    r_split = rolled.unpack_colors(r0, r1, even)
    scale = np.abs(np.asarray(r_ref)).max()
    assert np.abs(np.asarray(r_split - r_ref)).max() < 1e-13 * scale

    # sweep parity (4 color passes)
    u_m = rolled.rb_gs_sweeps_masked(blocks, Dinv, rhs, u, masks, 4)
    rc = rolled.pack_colors(rhs, even)
    s0, s1 = rolled.rb_gs_sweeps_split(bc, dc, rc, (u0, u1), even, 4)
    u_s = rolled.unpack_colors(s0, s1, even)
    scale = np.abs(np.asarray(u_m)).max()
    assert np.abs(np.asarray(u_s - u_m)).max() < 1e-13 * scale
