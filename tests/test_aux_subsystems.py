"""Caching, diagnostics, visualization, VTK export, logging/timer."""

import os

import numpy as np
import pytest

from dgtpu.api import DGFEM
from dgtpu.settings import Settings, load_params
from tests.conftest import REPO


def make_settings(**over):
    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly1.xyz"
    params["grid"]["polynomial degree"] = 1
    params["solution"]["u"]["polynomial degree"] = 2
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    for k, v in over.items():
        node = params
        *path, leaf = k.split(".")
        for kk in path:
            node = node[kk]
        node[leaf] = v
    s = Settings(params)
    s.solver.method = "direct"
    s.update_setting("solver.discretization", "dg")
    return s


def test_operator_cache_roundtrip(tmp_path):
    s = make_settings(**{"caching.enabled": True})
    dg1 = DGFEM(settings=s, solve_direct=True)
    u1 = dg1.solve()
    # second construction loads from cache and gives identical results
    s2 = make_settings(**{"caching.enabled": True})
    dg2 = DGFEM(settings=s2, solve_direct=True)
    u2 = dg2.solve()
    assert np.allclose(np.asarray(u1), np.asarray(u2))
    from dgtpu.utils.caching import cache_dir
    assert any(f.endswith(".npz") for f in os.listdir(cache_dir()))


def test_cache_invalidated_on_settings_change():
    from dgtpu.utils.caching import load_operator
    s = make_settings(**{"caching.enabled": True})
    dg = DGFEM(settings=s, solve_direct=True)
    lvl = dg.levels[-1]
    assert load_operator(lvl, "Poisson") is not None
    lvl.settings.update_setting("problem.kinematic_viscosity", 3.14)
    assert load_operator(lvl, "Poisson") is None


def test_diagnostics_flags():
    s = make_settings(**{"problem.check eigenvalues": True,
                         "problem.check condition number": True,
                         "problem.check characteristics": True,
                         "problem.check iteration matrix": True,
                         "problem.multiply inverse mass matrix": False})
    dg = DGFEM(settings=s, solve_direct=True)
    d = dg.diagnostics
    assert d["spd"] is True
    assert d["cond"] > 1
    assert 0 < d["rho_gs"] < 1  # GS converges on the SPD SIP operator
    assert np.real(d["min_eig"]) > 0


def test_vtk_export(tmp_path):
    from dgtpu.io.vtk import write_vts
    x, y = np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 2, 7), indexing="ij")
    path = write_vts(os.path.join(tmp_path, "t.vts"), x, y,
                     {"phi": x + y})
    raw = open(path, "rb").read()
    assert raw.startswith(b"<?xml")
    assert b"StructuredGrid" in raw and b"AppendedData" in raw
    # full pipeline export
    s = make_settings(**{"visualization.export": True})
    dg = DGFEM(settings=s, solve_direct=True)
    dg.solve()
    assert os.path.exists(dg.solution_visualization_filepath + ".vts")
    assert os.path.exists(os.path.join(dg.results_dir, "grid.vts"))


def test_summary_txt_schema():
    s = make_settings()
    dg = DGFEM(settings=s, solve_direct=True)
    dg.solve()
    text = open(dg.solution_summary_filepath).read()
    for token in ("SIMULATION SUMMARY", "### grid=", "### P sol=",
                  "Residual=", "L1 error=", "L2 error="):
        assert token in text, token


def test_visualization_plots(tmp_path):
    from dgtpu import visualization as viz
    if not viz.HAVE_MPL:
        pytest.skip("matplotlib unavailable")
    s = make_settings()
    dg = DGFEM(settings=s, solve_direct=True)
    p1 = viz.plot_sparsity_pattern(dg.levels[-1].op, outdir=str(tmp_path))
    p2 = viz.plot_grid_convergence({1: [(2, 0.1), (4, 0.025)],
                                    2: [(2, 0.01), (4, 0.00125)]},
                                   outdir=str(tmp_path))
    p3 = viz.plot_residual_history([np.geomspace(1, 1e-7, 10)],
                                   outdir=str(tmp_path))
    p4 = viz.plot_standard_element(3, outdir=str(tmp_path))
    p5 = viz.plot_basis_1d(4, outdir=str(tmp_path))
    for p in (p1, p2, p3, p4, p5):
        assert p and os.path.getsize(p) > 1000


def test_timer_and_logger():
    import time
    from dgtpu.utils.logger import Logger
    from dgtpu.utils.timer import Timer
    s = make_settings()
    logger = Logger("test_mod", s).logger
    t = Timer(logger)
    with t:
        time.sleep(0.01)
    assert 0.005 < t.elapsed() < 1.0

    @t.timeit
    def f(x):
        return x + 1
    assert f(1) == 2


def test_cache_covers_all_multigrid_levels(monkeypatch):
    """Every DG level of the hierarchy is cached (reference caches each
    Grid/DiscreteSystem it builds, grid.py:96-148, discrete_system.py:29-50);
    a second construction must not assemble anything."""
    import dgtpu.models.poisson as poisson_mod
    from dgtpu.utils.caching import cache_key

    over = {"caching.enabled": True,
            "solver.multigrid.geometric coarsening.enabled": False}
    s = make_settings(**over)
    s.solver.method = "multigrid"
    s.update_setting("solver.multigrid.polynomial_coarsening.levels.u", "1,2")
    dg1 = DGFEM(settings=s, solve_multigrid=True)
    from dgtpu.utils.caching import cache_dir
    files = set(os.listdir(cache_dir()))
    for lvl in dg1.levels:
        assert cache_key(lvl, "Poisson") + ".npz" in files

    real = poisson_mod.assemble_poisson

    def boom(*a, **k):
        raise AssertionError("assembly ran despite a warm cache")

    monkeypatch.setattr(poisson_mod, "assemble_poisson", boom)
    s2 = make_settings(**over)
    s2.solver.method = "multigrid"
    s2.update_setting("solver.multigrid.polynomial_coarsening.levels.u", "1,2")
    dg2 = DGFEM(settings=s2, solve_multigrid=True)
    monkeypatch.setattr(poisson_mod, "assemble_poisson", real)
    u1, u2 = dg1.solve(), dg2.solve()
    assert np.allclose(np.asarray(u1), np.asarray(u2))


def test_cache_key_depends_on_sigma():
    """Changing the penalty-coarsening multipliers changes sigma, which must
    change the cache identity (advisor finding: a stale operator assembled
    with the old sigma must never load)."""
    from dgtpu.geometry import Geometry
    from dgtpu.level import GridLevel
    from dgtpu.utils.caching import _fingerprint, cache_key
    from tests.conftest import INPUT_DIR

    s = make_settings(**{"caching.enabled": True})
    geom = Geometry(os.path.join(INPUT_DIR, "Rectangle_4X4_nPoly1.xyz"), s)
    lvl_a = GridLevel(geom, s, ["u"], {"u": 2}, sigma=9.0)
    lvl_b = GridLevel(geom, s, ["u"], {"u": 2}, sigma=18.0)
    assert cache_key(lvl_a, "Poisson") != cache_key(lvl_b, "Poisson")
    assert _fingerprint(lvl_a) != _fingerprint(lvl_b)


def test_stokes_cache_roundtrip(monkeypatch):
    """Stokes assembly caches A/D/G blocks + rhs + Epsilon; the second
    assembly must come from the cache and produce the identical system."""
    import dgtpu.models.stokes as stokes_mod
    from dgtpu.geometry import Geometry
    from dgtpu.level import GridLevel
    from dgtpu.mms import ManufacturedSolution
    from tests.conftest import INPUT_DIR

    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly1.xyz"
    params["grid"]["polynomial degree"] = 1
    params["problem"]["type"] = "Stokes"
    params["solution"]["ordering"] = "global"
    params["caching"]["enabled"] = True
    params["logging"]["loglevel"] = "ERROR"
    s = Settings(params)
    mms = ManufacturedSolution(
        {"u": "sin(pi*x)*sin(pi*y)", "v": "cos(pi*x)*cos(pi*y)", "p": "x+y"},
        "Stokes", s.problem.kinematic_viscosity)
    geom = Geometry(os.path.join(INPUT_DIR, "Rectangle_4X4_nPoly1.xyz"), s)

    lvl1 = GridLevel(geom, s, ["u", "p"], {"u": 2, "p": 1})
    stokes_mod.assemble_stokes(lvl1, mms)

    real = stokes_mod._element_blocks

    def boom(*a, **k):
        raise AssertionError("Stokes assembly ran despite a warm cache")

    monkeypatch.setattr(stokes_mod, "_element_blocks", boom)
    lvl2 = GridLevel(geom, s, ["u", "p"], {"u": 2, "p": 1})
    stokes_mod.assemble_stokes(lvl2, mms)
    monkeypatch.setattr(stokes_mod, "_element_blocks", real)

    assert np.allclose(np.asarray(lvl1.block_A.blocks),
                       np.asarray(lvl2.block_A.blocks))
    assert np.allclose(np.asarray(lvl1.rhs), np.asarray(lvl2.rhs))
    assert lvl1.Epsilon == pytest.approx(lvl2.Epsilon)


def test_grid_init_cache_roundtrip():
    """Initialized-grid caching (reference grid.py:96-148): the per-element
    coordinate extraction is cached content-addressed by the node lattice,
    so a second build loads identical coords; editing the lattice misses."""
    from dgtpu.geometry import Geometry
    from dgtpu.level import GridLevel
    from dgtpu.utils.caching import (_grid_cache_dir, load_element_coords,
                                     save_element_coords)

    s = make_settings(**{"caching.enabled": True})
    grid_path = os.path.join(REPO, "input", "Rectangle_4X4_nPoly1.xyz")
    geom = Geometry(grid_path, s)
    lvl1 = GridLevel(geom, s, ["u"], {"u": 2})
    cached = load_element_coords(s, geom.x, geom.y, geom.Ni, geom.Nj,
                                 geom.P_grid)
    assert cached is not None
    lvl2 = GridLevel(geom, s, ["u"], {"u": 2})
    assert np.array_equal(np.asarray(lvl1.X), np.asarray(lvl2.X))
    assert np.array_equal(np.asarray(lvl1.Y), np.asarray(lvl2.Y))
    # a different node lattice is a different content address -> miss
    assert load_element_coords(s, geom.x + 1e-3, geom.y, geom.Ni, geom.Nj,
                               geom.P_grid) is None
    # caching disabled -> no reads, no writes
    s_off = make_settings()
    assert load_element_coords(s_off, geom.x, geom.y, geom.Ni, geom.Nj,
                               geom.P_grid) is None
    assert save_element_coords(s_off, geom.x, geom.y, geom.Ni, geom.Nj,
                               geom.P_grid, lvl1.X, lvl1.Y) is None


def test_cache_writes_are_atomic_and_corruption_tolerant():
    """npz caches are written via temp + os.replace (no reader can observe
    a truncated archive) and a corrupt/legacy cache file loads as a miss
    instead of raising mid-solve."""
    from dgtpu.geometry import Geometry
    from dgtpu.utils import caching
    from dgtpu.utils.caching import (_grid_cache_dir, _grid_key,
                                     load_element_coords,
                                     save_element_coords)

    s = make_settings(**{"caching.enabled": True})
    geom = Geometry(os.path.join(REPO, "input", "Rectangle_4X4_nPoly1.xyz"),
                    s)
    X = np.ones((4, 4)); Y = np.zeros((4, 4))
    path = save_element_coords(s, geom.x, geom.y, geom.Ni, geom.Nj,
                               geom.P_grid, X, Y, tag="atomic_probe")
    assert path.endswith(".npz") and os.path.exists(path)
    # no stray temp files left behind
    leftovers = [f for f in os.listdir(_grid_cache_dir()) if ".tmp" in f]
    assert leftovers == []
    # corrupt the file in place: load must report a miss, not raise
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 not a real zip")
    assert load_element_coords(s, geom.x, geom.y, geom.Ni, geom.Nj,
                               geom.P_grid, tag="atomic_probe") is None
    os.remove(path)
    # an interrupted writer (np.savez raising mid-write) leaves no temp
    real_savez = np.savez

    def boom(file, **kw):
        real_savez(file, **kw)
        raise RuntimeError("simulated crash after write, before replace")

    key = _grid_key(geom.x, geom.y, geom.Ni, geom.Nj, geom.P_grid,
                    "atomic_probe")
    target = os.path.join(_grid_cache_dir(), key + ".npz")
    try:
        caching.np.savez = boom
        with pytest.raises(RuntimeError):
            caching._atomic_savez(target, X=X, Y=Y)
    finally:
        caching.np.savez = real_savez
    assert not os.path.exists(target)
    assert [f for f in os.listdir(_grid_cache_dir()) if ".tmp" in f] == []


def test_geometric_coarsening_factor_chain_validated():
    """Non-contiguous geometric coarsening chains (e.g. factors='4') are
    rejected at hierarchy build with a clear error — the 2x2 agglomeration
    transfers couple consecutive levels only (the reference silently
    builds shape-inconsistent operators for such chains, dgfem.py:363)."""
    params = load_params()
    params["grid"]["filename"] = "Rectangle_8X8_nPoly1.xyz"
    params["grid"]["polynomial degree"] = 1
    params["solution"]["u"]["polynomial degree"] = 2
    mgp = params["solver"]["multigrid"]
    mgp["penalty parameter coarsening"]["enabled"] = False
    mgp["polynomial coarsening"]["enabled"] = False
    mgp["geometric coarsening"]["enabled"] = True
    mgp["geometric coarsening"]["coarsening factors"] = 4
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    params["caching"]["enabled"] = False
    s = Settings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    with pytest.raises(ValueError, match="contiguous 2x chain"):
        DGFEM(settings=s, solve_multigrid=True)
    # a contiguous chain still builds
    mgp["geometric coarsening"]["coarsening factors"] = "2,4"
    s2 = Settings(params)
    s2.solver.method = "multigrid"
    s2.update_setting("solver.discretization", "dg")
    dg = DGFEM(settings=s2, solve_multigrid=True)
    assert len(dg.levels) >= 3


def test_modal_to_vtk(tmp_path):
    """modal_to_vtk (reference visualization.py:119-128): a modal vector
    interpolates to the node lattice and exports; the lattice agrees with
    the exact solution sampled at the grid nodes to the solver accuracy."""
    from dgtpu.io.vtk import modal_to_vtk, nodal_lattice

    dg = DGFEM(settings=make_settings(), solve_direct=True)
    u_modal = dg.solve()
    lvl = dg.levels[-1]
    path = modal_to_vtk(os.path.join(tmp_path, "modal"), lvl, u_modal,
                        dg.geometry.x, dg.geometry.y)
    raw = open(path, "rb").read()
    assert raw.startswith(b"<?xml") and b"StructuredGrid" in raw
    # the helper's modal->nodal->lattice agrees with the orchestrator's
    # own postprocessing (api._postprocess computed dg.u_nodal)
    lat_api = nodal_lattice(lvl, dg.u_nodal)
    Vg = np.asarray(lvl.quad.V_sol_grid["u"])
    nodal = np.asarray(u_modal).reshape(lvl.N, -1) @ Vg.T
    lat = nodal_lattice(lvl, nodal)
    assert lat.shape == (lvl.Ni * lvl.P_grid + 1, lvl.Nj * lvl.P_grid + 1)
    np.testing.assert_allclose(lat, lat_api, atol=1e-12)
