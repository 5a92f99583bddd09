"""DGFEM orchestrator — end-to-end driver (reference: ``dgfem/dgfem.py``).

Builds settings + manufactured solution, reads the grid, constructs the
(multigrid) level hierarchy with transfer operators, assembles each level,
dispatches the solver, and post-processes: residual norms, Stokes pressure
mean shift, modal->nodal interpolation, L1/L2 MMS errors, VTK export and
``summary.txt`` in the reference's schema.
"""

import os

import jax.numpy as jnp
import numpy as np

from dgtpu.geometry import Geometry
from dgtpu.io.vtk import elements_to_vtk, grid_to_vtk
from dgtpu.level import CoarseGridLevel, GridLevel
from dgtpu.mms import ManufacturedSolution
from dgtpu.ops.smoothers import element_colors
from dgtpu.ops.transfer import make_transfer
from dgtpu.settings import Settings, load_params
from dgtpu.utils.logger import Logger
from dgtpu.utils.norms import lp_norm
from dgtpu.utils.timer import Timer, synchronize


class DGFEM:
    def __init__(self, **kwargs):
        if kwargs.get("settings"):
            self.settings = kwargs["settings"]
        else:
            self.settings = Settings(load_params(kwargs.get("paramfile")))
        self.settings.update_settings(kwargs)

        self.logger = Logger(__name__, self.settings).logger
        self.timer = Timer(self.logger)

        for key, arg in kwargs.items():
            if "solve_" in key and arg:
                self.settings.solver.method = key.removeprefix("solve_")
        if not hasattr(self.settings.solver, "method"):
            self.settings.solver.method = "direct"

        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        folder = self.settings.grid.folder
        grid_filepath = (folder if os.path.isabs(folder)
                         else os.path.join(repo_root, folder))
        grid_filepath = os.path.join(grid_filepath, self.settings.grid.filename)
        self.geometry = Geometry(grid_filepath, self.settings)

        problem = self.settings.problem.type
        if problem == "Poisson":
            self.vars = ["u"]
            self.P_sol = {"u": self.settings.solution.u.polynomial_degree}
        elif problem in ("Stokes", "Navier-Stokes"):
            self.vars = ["u", "p"]
            self.P_sol = {v: getattr(getattr(self.settings.solution, v),
                                     "polynomial_degree") for v in self.vars}
        else:
            raise NotImplementedError(
                f"There exists no implementation for the {problem} equation(s), "
                f"possible equation(s) are: Poisson|Stokes|Navier-Stokes")

        exact = {k: getattr(self.settings.problem.exact_solution, k, None)
                 for k in ("u", "v", "p")}
        lam = getattr(self.settings.problem.exact_solution, "lam", None)
        self.mms = ManufacturedSolution(
            exact, "Stokes" if problem != "Poisson" else "Poisson",
            self.settings.problem.kinematic_viscosity, lam_expr=lam,
            logger=self.logger)
        if problem == "Stokes":
            if self.settings.solution.manufactured_solution:
                self.mms.check_divergence_free()
            self.exact_p_mean = self.mms.compute_pressure_mean(
                self.geometry, self.settings.grid.circular)

        self.settings._validate_settings(self.settings)

        # results folder structure (dgfem.py:64-101)
        grid_filename = os.path.splitext(self.settings.grid.filename)[0]
        results_folder = f"exact_sol_{self.settings.problem.exact_solution.tag}"
        mul = self.settings.problem.SIP_penalty_parameter_multiplier
        results_folder += f"_sigmamul{mul}".replace(".", "_")
        if problem == "Stokes":
            results_folder += (f"_gamma{self.settings.problem.velocity_penalty_parameter}"
                               .replace(".", "_"))
        self.results_dir = os.path.join(repo_root, "results",
                                        problem.replace("-", "_"),
                                        f"grid_{grid_filename}", results_folder)
        os.makedirs(self.results_dir, exist_ok=True)
        self.solution_visualization_filepath = os.path.join(
            self.results_dir,
            "solution_" + "_".join(f"P{v}{self.P_sol[v]}" for v in self.vars))
        self.solution_summary_filepath = os.path.join(self.results_dir, "summary.txt")

        self.residuals = []
        # setup always runs on the host CPU (see dgtpu.utils.device)
        from dgtpu.utils.device import setup_scope
        with setup_scope():
            self.initialize()

        if self.settings.visualization.export:
            grid_to_vtk(os.path.join(self.results_dir, "grid"),
                        self.geometry.x, self.geometry.y)
        self._write_summary_header(grid_filename)

    # ------------------------------------------------------------------ setup

    def initialize(self):
        s = self.settings
        self.sigma = (s.problem.SIP_penalty_parameter if s.problem.SIP_penalty_parameter
                      else (self.P_sol["u"] + 1) ** 2
                      * s.problem.SIP_penalty_parameter_multiplier)
        self.levels = []
        self.transfers = []
        self.transfer_types = []
        wants_mg_precond = (
            s.solver.method == "krylov"
            and str(getattr(getattr(s.solver, "krylov", None),
                            "preconditioner", "")) == "multigrid")
        if s.solver.method == "multigrid" or wants_mg_precond:
            # krylov + preconditioner: multigrid assembles the same coarse
            # hierarchy the multigrid method would; one V-cycle per Krylov
            # iteration is then the preconditioner application
            self._build_multigrid_hierarchy()
        else:
            disc = getattr(s.solver, "discretization", "dg")
            self.levels.append(GridLevel(self.geometry, s, self.vars,
                                         self.P_sol, self.sigma,
                                         discretization=disc))

        for idx, lvl in enumerate(self.levels):
            self.logger.debug(
                f"grid number {idx+1}: P_grid={lvl.P_grid}, P_sol={lvl.P_sol}, "
                f"sigma={lvl.sigma}, Ni={lvl.Ni}, Nj={lvl.Nj}")

        self._assemble_all()

    def _build_multigrid_hierarchy(self):
        """Mirror of dgfem.assemble_multigrid_operators (dgfem.py:269-376).

        Levels are ordered coarsest -> finest; transfers[k] sits between
        levels[k] and levels[k+1].
        """
        s = self.settings
        mg = s.solver.multigrid

        if mg.penalty_parameter_coarsening.enabled:
            sigma_min = (self.P_sol["u"] + 1) ** 2
            multipliers = sorted(map(int, str(
                mg.penalty_parameter_coarsening.multipliers).split(",")))
            sigmas = [sigma_min * m for m in multipliers]
            for m in multipliers:
                if m < 2:
                    self.logger.warning(
                        "You are trying to use a penalty parameter multiplier lower "
                        "than 2, expect unstable results on curved grids")
            new = [GridLevel(self.geometry, s, self.vars, self.P_sol, sig)
                   for sig in sigmas]
            self.levels[0:0] = new
            self.transfers[0:0] = [make_transfer("penalty", p_fine=self.P_sol["u"])
                                   for _ in range(len(sigmas) - 1)]
            self.transfer_types[0:0] = ["penalty_parameter"] * (len(sigmas) - 1)

        if mg.polynomial_coarsening.enabled:
            p_levels = {}
            for v in self.vars:
                node = mg.polynomial_coarsening.levels
                if hasattr(node, v) and getattr(node, v) is not None:
                    p_levels[v] = sorted(map(int, str(getattr(node, v)).split(",")))
                elif v == "p":
                    # derive pressure levels from the velocity ones
                    # (Taylor-Hood pairing) — the reference leaves Stokes
                    # p-levels unimplemented (paramfile.yml:41 note)
                    p_levels["p"] = [max(pu - 1, 0) for pu in p_levels["u"]]
                else:
                    raise ValueError(f"polynomial coarsening levels missing for {v}")
            if mg.penalty_parameter_coarsening.enabled:
                p_levels_grids = {v: lv[:-1] for v, lv in p_levels.items()}
                s.problem.SIP_penalty_parameter_multiplier = multipliers[0]
            else:
                p_levels_grids = p_levels
            sigma_min = [(p + 1) ** 2 * s.problem.SIP_penalty_parameter_multiplier
                         for p in p_levels_grids["u"]]
            new = [GridLevel(self.geometry, s, self.vars,
                             dict(zip(p_levels_grids.keys(), ps)), sig)
                   for ps, sig in zip(zip(*p_levels_grids.values()), sigma_min)]
            self.levels[0:0] = new
            if self.vars == ["u", "p"]:
                from dgtpu.models.stokes import StokesPolynomialTransfer
                p_transfers = [StokesPolynomialTransfer(
                    self.geometry.N,
                    pu_fine=p_levels["u"][i + 1], pu_coarse=p_levels["u"][i],
                    pp_fine=p_levels["p"][i + 1], pp_coarse=p_levels["p"][i])
                    for i in range(len(p_levels["u"]) - 1)]
            else:
                p_transfers = [make_transfer("polynomial",
                                             p_fine=p_levels["u"][i + 1],
                                             p_coarse=p_levels["u"][i])
                               for i in range(len(p_levels["u"]) - 1)]
            self.transfers[0:0] = p_transfers
            self.transfer_types[0:0] = ["polynomial"] * len(p_transfers)

        if mg.geometric_coarsening.enabled:
            if not self.levels:
                self.levels.append(GridLevel(self.geometry, s, self.vars,
                                             self.P_sol, self.sigma))
            if mg.geometric_coarsening.use_FVM:
                fvm_level = GridLevel(self.geometry, s, self.vars, self.P_sol,
                                      self.sigma, discretization="fvm")
                dg_above = self.levels[0]
                import numpy as np
                scale = (np.asarray(dg_above.gt["A"]) / 4.0
                         if s.problem.multiply_inverse_mass_matrix else None)
                self.levels[0:0] = [fvm_level]
                self.transfers[0:0] = [make_transfer(
                    "dg_to_fvm", p_fine=self.levels[1].P_sol["u"],
                    row_scale=scale)]
                self.transfer_types[0:0] = ["geometric"]

            cfs = mg.geometric_coarsening.coarsening_factors
            cfs = (sorted(map(int, str(cfs).split(",")), reverse=True)
                   if not isinstance(cfs, int) else [cfs])
            # every geometric transfer below is a 2x2 agglomeration between
            # CONSECUTIVE levels (the reference hard-codes the same 4x16
            # stencils for every level, dgfem.py:363-372, and silently
            # produces shape garbage for e.g. factors='4'); validate the
            # chain instead of crashing later with an opaque reshape error
            chain = cfs + [1]
            if any(a != 2 * b for a, b in zip(chain, chain[1:])):
                raise ValueError(
                    "geometric coarsening factors must form a contiguous "
                    f"2x chain down to the fine grid (e.g. '8,4,2'); got "
                    f"{cfs}")
            base = self.levels[0]
            use_fvm = mg.geometric_coarsening.use_FVM
            coarse = [CoarseGridLevel(self.geometry, base, s, self.vars, cf,
                                      discretization="fvm" if use_fvm else "dg")
                      for cf in cfs]
            self.levels[0:0] = coarse
            # transfers between successive geometric levels (each a 2x fine-up)
            geo_transfers = []
            for k in range(len(coarse)):
                if use_fvm:
                    geo_transfers.append(make_transfer(
                        "geometric_fvm", Ni_c=self.levels[k].Ni,
                        Nj_c=self.levels[k].Nj))
                elif self.vars == ["u", "p"]:
                    from dgtpu.models.stokes import StokesGeometricTransfer
                    geo_transfers.append(StokesGeometricTransfer(
                        self.levels[k].Ni, self.levels[k].Nj,
                        pu=self.levels[k].P_sol["u"],
                        pp=self.levels[k].P_sol["p"], cf=2))
                else:
                    geo_transfers.append(make_transfer(
                        "geometric", p_fine=self.levels[k].P_sol["u"],
                        Ni_c=self.levels[k].Ni, Nj_c=self.levels[k].Nj, cf=2))
            self.transfers[0:0] = geo_transfers
            self.transfer_types[0:0] = ["geometric"] * len(geo_transfers)

        if not self.levels:
            raise ValueError("multigrid requires at least one coarsening type enabled")

    def _assemble_all(self):
        from dgtpu.models.poisson import assemble_poisson
        from dgtpu.utils.caching import load_operator, save_operator
        problem = self.settings.problem.type
        finest = self.levels[-1]
        for lvl in self.levels:
            need_rhs = lvl is finest
            if problem == "Poisson":
                if lvl.discretization == "fvm":
                    from dgtpu.models.fvm import assemble_poisson_fvm
                    lvl.op, lvl.rhs = assemble_poisson_fvm(lvl, self.mms)
                else:
                    cached = load_operator(lvl, problem)
                    # a cache hit must carry an rhs whenever this level needs
                    # one (the finest), else reassemble and overwrite it
                    if cached is not None and (cached[1] is not None
                                               or not need_rhs):
                        lvl.op, lvl.rhs, lvl.inv_mass = cached
                        self.logger.debug("loaded assembled system from cache")
                    else:
                        lvl.op, lvl.rhs, lvl.inv_mass = assemble_poisson(
                            lvl, self.mms if need_rhs else None)
                        save_operator(lvl, problem, lvl.op, lvl.rhs,
                                      lvl.inv_mass)
            elif problem == "Stokes":
                from dgtpu.models.stokes import assemble_stokes
                assemble_stokes(lvl, self.mms if need_rhs else None,
                                direct=(self.settings.solver.method == "direct"))
            else:
                raise NotImplementedError(problem)
        self._run_diagnostics(finest)

    def _run_diagnostics(self, level):
        """Opt-in diagnostic flags (reference discrete_system.py:130-186,
        :753-810; dgfem.py:129-149)."""
        from dgtpu.diagnostics import run_diagnostics
        run_diagnostics(self, level)

    # ------------------------------------------------------------------ solve

    def solve(self):
        s = self.settings
        method = s.solver.method
        finest = self.levels[-1]
        self.logger.debug(f"Solving with {method} method ...")
        n_shards = int(getattr(getattr(s, "performance", None), "n_shards", 1)
                       or 1)
        if method != "multigrid" and n_shards > 1:
            self.logger.warning(
                "performance.n_shards only applies to the multigrid solver; "
                f"running {method} single-device")

        # commit the operator pytrees to the compute device (setup stayed
        # on the host CPU); jit then follows the committed inputs.  The
        # sharded solvers place their own shards over the mesh.
        from dgtpu.utils.device import (default_compute_device, put_transfer,
                                        put_tree)
        target = default_compute_device(s)
        if method != "multigrid" or n_shards == 1:
            for lvl in self.levels:
                lvl.op = put_tree(lvl.op, target)
                lvl.rhs = put_tree(lvl.rhs, target)
            self.transfers = [put_transfer(t, target) for t in self.transfers]

        with Timer() as t:
            if method == "direct":
                from dgtpu.solvers.direct import solve_direct
                u_modal = synchronize(solve_direct(finest.op, finest.rhs))
            elif method == "multigrid":
                precision = str(getattr(getattr(s, "performance", None),
                                        "precision", "full"))
                if n_shards > 1:
                    u_modal, res, n = self._solve_multigrid_sharded(
                        n_shards, precision=precision)
                    u_modal = synchronize(u_modal)
                    self.residuals = self.mg.history
                else:
                    if precision == "mixed":
                        try:
                            u_modal, res, n = \
                                self._solve_multigrid_mixed(finest)
                            u_modal = synchronize(u_modal)
                        except NotImplementedError as e:
                            self.logger.warning(str(e))
                            precision = "full"
                    if precision != "mixed":
                        from dgtpu.solvers.multigrid import MultigridSolver
                        colors = [element_colors(l.Ni, l.Nj)
                                  for l in self.levels]
                        self.mg = MultigridSolver(
                            [l.op for l in self.levels], self.transfers,
                            self.transfer_types, s, colors=colors,
                            levels=self.levels)
                        u_modal, res, n, hist = self.mg.solve(finest.rhs)
                        u_modal = synchronize(u_modal)
                        self.residuals = [float(r) for r in np.asarray(hist)
                                          if np.isfinite(r)]
                self.iterations = int(n)
                self.logger.info(f"multigrid: {int(n)} V-cycles, final normalized "
                                 f"residual {float(res):.6e}")
                self._save_residual_history("multigrid")
            elif method == "smoother":
                u_modal = synchronize(self._solve_smoother(finest))
            elif method == "smoother_amplification":
                from dgtpu.solvers.amplification import calculate_amplification
                return calculate_amplification(finest, self.results_dir)
            elif method == "krylov":
                from dgtpu.solvers.krylov import solve_krylov
                u_modal = synchronize(solve_krylov(
                    finest, s, mg_cycle=self._krylov_mg_cycle()))
            elif method == "pyamg":
                from dgtpu.solvers.amg import solve_amg
                variant = str(getattr(getattr(s.solver, "amg", None),
                                      "variant", "sa"))
                u_modal, info = solve_amg(finest.op, finest.rhs,
                                          variant=variant)
                u_modal = synchronize(u_modal)
            elif method == "finite_volume_method":
                from dgtpu.solvers.direct import solve_direct
                u_modal = synchronize(solve_direct(finest.op, finest.rhs))
            else:
                raise NotImplementedError(method)
        self.solve_seconds = t.elapsed()
        self.logger.info(f"Solving with {method} method took "
                         f"{self.solve_seconds:.4g} seconds")

        return self._postprocess(u_modal)

    def _krylov_mg_cycle(self):
        """One jitted V/W/F-cycle as a Krylov preconditioner application.

        Returns None unless ``solver.krylov.preconditioner: multigrid``.
        The hierarchy was already assembled in ``initialize()`` (the same
        coarsening config the multigrid method reads); a cycle from a zero
        initial guess is a fixed linear operator, which is exactly what
        ``jax.scipy.sparse.linalg`` expects of M.  dgtpu extension — the
        reference's Krylov path (solver.py:79-112) has no multigrid
        preconditioner.
        """
        s = self.settings
        if str(getattr(getattr(s.solver, "krylov", None), "preconditioner",
                       "")) != "multigrid":
            return None
        if len(self.levels) < 2:
            raise ValueError(
                "solver.krylov.preconditioner: multigrid needs a coarse "
                "hierarchy — enable at least one solver.multigrid coarsening")
        from dgtpu.solvers.multigrid import MultigridSolver
        colors = [element_colors(l.Ni, l.Nj) for l in self.levels]
        self.mg = MultigridSolver([l.op for l in self.levels], self.transfers,
                                  self.transfer_types, s, colors=colors,
                                  levels=self.levels)
        k = len(self.mg.ops)
        import jax

        @jax.jit
        def cycle(r):
            return self.mg.v_cycle(k, r, jnp.zeros_like(r))

        return cycle

    def _solve_multigrid_mixed(self, finest):
        """Mixed-precision multigrid: f32 V-cycles + f64 defect refinement
        (``performance.precision: mixed``).

        The inner cycle is the rolled-layout XLA cycle for Poisson
        (``ops/pallas_vcycle.py``) and the structure-of-arrays
        distributive-GS cycle for Stokes
        (``ops/pallas_stokes.py``).  Defect correction reaches the f64
        solver tolerance while most of the work runs in f32 — no reference
        equivalent (the reference is f64-only NumPy).
        """
        import jax.numpy as jnp
        from dgtpu.solvers.refinement import make_refined_solver
        from dgtpu.utils.device import setup_scope

        fmg_on = bool(getattr(self.settings.solver.multigrid,
                              "full_multigrid", False))

        s = self.settings
        # precision: mixed exists to deliver f64-parity accuracy at f32
        # speed, so it targets at least the 1e-10 BASELINE parity residual
        # (tighter if the configured tolerance is tighter) — the same
        # stopping rule as the sharded refinement path in _solve_sharded
        tol = min(float(s.solver.multigrid.tolerance), 1e-10)
        dims = [(l.Nj, l.Ni) for l in self.levels]
        stokes = self.levels[-1].block_A is not None
        # none of the f32 cycles (nor the rolled fallback) implement the
        # FVM coarse-level transfers; detect before any builder runs so the
        # caller's NotImplementedError handler routes to the
        # full-precision path instead of crashing at call time
        unsupported = ({t.kind for t in self.transfers}
                       - {"penalty", "polynomial", "geometric"})
        if unsupported:
            raise NotImplementedError(
                "mixed precision: the f32 cycles do not support "
                f"transfer kind(s) {sorted(unsupported)} (FVM coarse "
                "level); running full precision")
        with setup_scope():
            if stokes:
                from dgtpu.ops.pallas_stokes import SoAStokesVCycle
                try:
                    builder = SoAStokesVCycle(self.levels, self.transfers,
                                              self.transfer_types, s,
                                              dtype=jnp.float32)
                    cyc = builder.build_xla()
                except ValueError as e:
                    # the rolled cycle would smooth with block-GS on the
                    # saddle operator — a different smoother than the
                    # configured distributive GS, which can stall the
                    # refinement; signal solve() to run the full-precision
                    # generic path instead
                    raise NotImplementedError(
                        "mixed precision: the SoA Stokes cycle is "
                        f"unavailable ({e}); running full precision")
                kind = "SoA"
            else:
                from dgtpu.ops.pallas_vcycle import PallasVCycle
                builder = PallasVCycle([l.op for l in self.levels],
                                       self.transfers, self.transfer_types,
                                       s, dims, dtype=jnp.float32)
                cyc = builder.build_xla()
                kind = "rolled"
        rhs = finest.rhs
        u0 = jnp.zeros_like(rhs)
        if fmg_on:
            # FMG nested-iteration guess in f32 through the same
            # hierarchy; the refinement tolerance then normalizes by
            # ||rhs|| so it keeps its relative-to-zero-iterate meaning
            with setup_scope():
                fmg = builder.build_fmg()
            u0 = fmg(rhs.astype(jnp.float32)).astype(rhs.dtype)
            kind += " + FMG guess"
        refined = make_refined_solver(finest.op, cyc, n_inner=6, tol=tol,
                                      normalize="rhs" if fmg_on else "u0")
        u, res, n, hist = refined(rhs, u0)
        self.residuals = [float(r) for r in np.asarray(hist)
                          if np.isfinite(r)]
        self.logger.info(
            f"mixed-precision multigrid ({kind} inner cycle): {int(n)} outer "
            f"refinement rounds x 6 f32 cycles, residual {float(res):.3e}")
        if float(res) >= tol and hasattr(builder, "build_matvec"):
            # deep hierarchies can push the stand-alone cycle's asymptotic
            # contraction past 1 (measured: identical rho>1 trace on the
            # generic f64 path at 32x32 Stokes — a property of the cycle
            # config, not the f32 kernels).  GMRES preconditioned by the
            # same cycle converges on isolated divergent modes, so retry
            # the refinement with the Krylov-wrapped inner solve.
            self.logger.warning(
                f"mixed-precision refinement stalled at {float(res):.3e}; "
                "retrying with f32 GMRES-wrapped inner cycles")
            # m=16: restarting at 8 loses the stubborn subspace each outer
            # round (32x32 Stokes took 18 outer rounds at m=8, 7 at m=16)
            refined = make_refined_solver(
                finest.op, cyc, n_inner=16, tol=tol,
                normalize="rhs" if fmg_on else "u0", inner="gmres",
                matvec32=builder.build_matvec())
            u, res, n, hist = refined(rhs, u0)
            self.residuals += [float(r) for r in np.asarray(hist)
                               if np.isfinite(r)]
            self.logger.info(
                f"GMRES-wrapped refinement: {int(n)} outer rounds, "
                f"residual {float(res):.3e}")
        if float(res) >= tol:
            self.logger.warning(
                f"mixed-precision refinement stopped at {float(res):.3e} "
                f"(tolerance {tol:g})")
        return u, res, n

    def _solve_multigrid_sharded(self, n_shards, precision="full"):
        """Multigrid over an n_shards device mesh (element-row decomposition).

        New capability with no reference equivalent (SURVEY §2: the reference
        is strictly single-process).  Poisson uses red-black smoothing with
        ppermute halo exchange; Stokes uses the distributive-GS smoother in
        stencil/halo form.  Transfers must be p-/penalty- (element-local) or
        geometric (shard-local agglomeration).  ``precision='mixed'`` runs
        sharded f32 inner cycles inside an f64 halo defect-correction loop
        (``solve_refined``) to the 1e-10 parity target.
        """
        import jax as _jax
        from dgtpu.parallel.halo import make_mesh
        avail = len(_jax.devices())
        if avail < n_shards:
            raise ValueError(
                f"performance.n_shards={n_shards} but only {avail} device(s) "
                "are visible (set XLA_FLAGS=--xla_force_host_platform_device_"
                "count=N for a virtual CPU mesh)")
        mesh = make_mesh(n_shards)
        finest = self.levels[-1]
        if (precision == "mixed"
                and bool(getattr(self.settings.solver.multigrid,
                                 "full_multigrid", False))):
            # halo/stokes_halo build_refined seed their outer loop with the
            # shard-local f32 FMG guess on the initial defect (single-chip
            # parity: fmg_guess + make_refined_solver in _solve_multigrid)
            self.logger.info(
                "sharded mixed-precision refinement seeded with the "
                "shard-local FMG (nested-iteration) guess")
        # smoother kind/direction/iterations/relaxation factor and the
        # coarse-grid solver all come from the per-coarsening paramfile
        # nodes inside the sharded solvers, same as the single-chip path
        if self.vars == ["u", "p"]:
            # the Stokes saddle smoother is structurally distributive GS in
            # sharded mode (cell-Vanka diverges on SIP-DG, see
            # parallel/stokes_halo.py) — warn if the config names another
            from dgtpu.ops.smoothers import normalize_smoother_name
            mgs = self.settings.solver.multigrid
            for t in set(self.transfer_types):
                node = getattr(mgs, f"{t}_coarsening")
                for side in (node.pre_smoother, node.post_smoother):
                    name = normalize_smoother_name(side.smoother)
                    if name != "distributive_gauss_seidel":
                        self.logger.warning(
                            f"sharded Stokes multigrid smooths with "
                            f"distributive GS, not the configured "
                            f"{side.smoother!r}")
            from dgtpu.parallel.stokes_halo import ShardedStokesMultigrid
            self.mg = ShardedStokesMultigrid(self.levels, self.settings,
                                             mesh=mesh,
                                             transfers=self.transfers,
                                             transfer_types=self.transfer_types)
        else:
            from dgtpu.parallel.halo import ShardedMultigrid
            self.mg = ShardedMultigrid(self.levels, self.transfers,
                                       self.settings, mesh=mesh)
        self.logger.info(f"sharded multigrid over {n_shards} devices "
                         f"({mesh.devices.ravel()[0].platform})")
        if precision == "mixed":
            tol = float(self.settings.solver.multigrid.tolerance)
            self.logger.info("sharded mixed-precision refinement "
                             "(f32 inner cycles, f64 halo defect loop)")
            out = self.mg.solve_refined(finest.rhs, tol=min(tol, 1e-10))
            if (self.vars == ["u", "p"]
                    and float(out[1]) >= min(tol, 1e-10)):
                # same rescue as the single-chip mixed route: deep
                # hierarchies can push the stand-alone cycle contraction
                # past 1; GMRES(16) preconditioned by the sharded cycle
                # converges on the isolated divergent modes
                self.logger.warning(
                    f"sharded mixed refinement stalled at "
                    f"{float(out[1]):.3e}; retrying with f32 GMRES-wrapped "
                    "inner cycles")
                out = self.mg.solve_refined(finest.rhs,
                                            tol=min(tol, 1e-10),
                                            n_inner=16, inner="gmres")
            return out
        return self.mg.solve(finest.rhs)

    def _solve_smoother(self, finest):
        s = self.settings
        name = s.solver.smoother if hasattr(s.solver, "smoother") else "block_gauss_seidel"
        if str(name).lower() == "distributive_gauss_seidel":
            from dgtpu.models.stokes import distributive_gauss_seidel_solve
            u, hist, n, status = distributive_gauss_seidel_solve(
                finest, finest.rhs, max_iterations=1_000_000, splitting="lsq")
        else:
            from dgtpu.solvers.relaxation_driver import residual_tracked_smoother
            u, hist, n, status = residual_tracked_smoother(
                finest.op, finest.rhs, name=name, direction="symmetric",
                max_iterations=1000,   # reference default
                                       # (relaxation.py:198 max_iterations=1e3)
                strategy=getattr(getattr(s, "performance", None),
                                 "smoother_parallelization", "sequential"),
                colors=element_colors(finest.Ni, finest.Nj))
        self.residuals = [float(r) for r in np.asarray(hist) if np.isfinite(r)]
        self._save_residual_history("relaxation")
        if int(status) == 0:
            self.logger.info(f"Residual reduced by 6 orders in {int(n)} sweeps")
        elif int(status) == 2:
            self.logger.error(f"smoother diverged after {int(n)} sweeps "
                              f"(normalized residual > 1e10 or non-finite)")
        else:
            self.logger.warning(f"smoother hit the iteration cap after "
                                f"{int(n)} sweeps without converging")
        return u

    def _save_residual_history(self, kind):
        """Residual histories as .npy (reference pickles them, solver.py:128-138)."""
        lvl = self.levels[-1]
        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.path.join(repo_root, "postprocessing", kind)
        os.makedirs(path, exist_ok=True)
        name = (f"residuals_{self.settings.problem.type}_{lvl.Ni}X{lvl.Nj}"
                f"_nPoly{lvl.P_grid}")
        if kind == "multigrid":
            name += "_" + "_".join(sorted(set(self.transfer_types)))
        name += "_circle" if self.settings.grid.circular else "_rectangle"
        np.save(os.path.join(path, name + ".npy"), np.asarray(self.residuals))

    # ---------------------------------------------------------------- post

    def _postprocess(self, u_modal):
        s = self.settings
        finest = self.levels[-1]
        problem = s.problem.type

        residual_0 = lp_norm(finest.rhs, 2)
        self.residual = float(lp_norm(finest.rhs - finest.op.matvec(u_modal), 2))
        self.logger.info(f"L2 norm of the residual (modal): {self.residual:.6e} "
                         f"(not normalized)")
        self.logger.info(f"L2 norm of the residual (modal): "
                         f"{self.residual/float(residual_0):.6e} (normalized)")

        if s.solver.method == "finite_volume_method" or finest.discretization == "fvm":
            u_nodal = np.asarray(u_modal)
            self.L1_error_u = float(lp_norm(u_nodal - self._fvm_exact(finest), 1))
            self.L2_error_u = float(lp_norm(u_nodal - self._fvm_exact(finest), 2))
            self.logger.info(f"The norms of the error (nodal) are: "
                             f"L1={self.L1_error_u:.6e}, L2={self.L2_error_u:.6e}")
            self._write_summary_results(problem)
            return u_modal

        if s.solution.ordering == "global":
            from dgtpu.models.stokes import reorder_global_to_local
            u_modal = reorder_global_to_local(finest, u_modal)
        u_el = u_modal.reshape(finest.N, finest.N_DOF_sol_tot)

        if problem == "Stokes" and s.solver.method != "smoother":
            from dgtpu.models.stokes import pressure_mean_shift
            u_el = pressure_mean_shift(finest, u_el)

        # modal -> nodal (dgfem.py:201-209), batched; per-element nodal tables
        # when the physical-element orthonormal basis is active (element.py:43)
        nu_dof = finest.N_DOF_sol["u"]
        eb = getattr(finest, "element_basis", None) or {}

        def to_nodal(modal, var):
            """Modal block -> nodal values, per-element basis aware."""
            eb_v = eb.get(var)
            if eb_v is not None:
                Vg_e = eb_v.apply(finest.quad.V_sol_grid[var])  # (N, G, B)
                return jnp.einsum("ngb,nb->ng", Vg_e, modal)
            return modal @ jnp.asarray(finest.quad.V_sol_grid[var]).T

        u_nodal = to_nodal(u_el[:, :nu_dof], "u")
        X, Y = jnp.asarray(finest.X), jnp.asarray(finest.Y)
        u_exact = self.mms.u(X, Y)
        self.L1_error_u = float(lp_norm(u_nodal - u_exact, 1))
        self.L2_error_u = float(lp_norm(u_nodal - u_exact, 2))

        point_data = {}
        if problem == "Stokes":
            np_dof = finest.N_DOF_sol["p"]
            v_nodal = to_nodal(u_el[:, nu_dof:2 * nu_dof], "u")
            p_nodal = to_nodal(u_el[:, -np_dof:], "p")
            v_exact = self.mms.v(X, Y)
            p_exact = self.mms.p(X, Y)
            self.L1_error_v = float(lp_norm(v_nodal - v_exact, 1))
            self.L2_error_v = float(lp_norm(v_nodal - v_exact, 2))
            self.L1_error_p = float(lp_norm(p_nodal - p_exact, 1))
            self.L2_error_p = float(lp_norm(p_nodal - p_exact, 2))
            self.logger.info(f"The norms of the error in u-velocity (nodal) are: "
                             f"L1={self.L1_error_u:.6e}, L2={self.L2_error_u:.6e}")
            self.logger.info(f"The norms of the error in v-velocity (nodal) are: "
                             f"L1={self.L1_error_v:.6e}, L2={self.L2_error_v:.6e}")
            self.logger.info(f"The norms of the error in pressure (nodal) are: "
                             f"L1={self.L1_error_p:.6e}, L2={self.L2_error_p:.6e}")
        else:
            self.logger.info(f"The norms of the error (nodal) are: "
                             f"L1={self.L1_error_u:.6e}, L2={self.L2_error_u:.6e}")

        if s.visualization.export:
            nodal_lattices = self._nodal_lattices(finest, u_nodal, u_exact)
            if problem == "Stokes":
                nodal_lattices.update(self._nodal_lattices(finest, v_nodal, v_exact, "v"))
                nodal_lattices.update(self._nodal_lattices(finest, p_nodal, p_exact, "pressure"))
            elements_to_vtk(self.solution_visualization_filepath,
                            self.geometry.x, self.geometry.y, nodal_lattices)
        self._write_summary_results(problem)

        if s.visualization.automatically_open_paraview:
            executable = s.visualization.paraview_executable_path
            if not executable:
                raise ValueError("ParaView executable path must be set in paramfile.yml")
            import subprocess
            subprocess.Popen([rf"{executable}",
                              self.solution_visualization_filepath + ".vts"])
        self.u_nodal = np.asarray(u_nodal)
        return u_modal

    def _fvm_exact(self, level):
        from dgtpu.models.fvm import fvm_cell_centers
        xc, yc = fvm_cell_centers(level)
        return np.asarray(self.mms.u(xc, yc))

    def _nodal_lattices(self, level, num, exact, name="phi"):
        """Per-element nodal fields -> global (il, jl) lattices for VTK."""
        from dgtpu.io.vtk import nodal_lattice

        def to_lattice(arr):
            return nodal_lattice(level, arr)

        nn, ne = to_lattice(num), to_lattice(exact)
        return {f"{name}": nn, f"{name}_exact": ne, f"abs_error_{name}": np.abs(nn - ne)}

    def _write_summary_header(self, grid_filename):
        s = self.settings
        with open(self.solution_summary_filepath, "w") as f:
            f.write("############################################\n")
            f.write("###          SIMULATION SUMMARY          ###\n")
            f.write("############################################\n\n")
            f.write(f"### grid={grid_filename}\n")
            exact = {k: getattr(s.problem.exact_solution, k, None)
                     for k in (("u",) if s.problem.type == "Poisson" else ("u", "v", "p"))}
            f.write(f"### exact solution={exact}\n")
            f.write(f"### Ni={self.geometry.Ni}, Nj={self.geometry.Nj}\n")
            f.write(f"### P grid={s.grid.polynomial_degree}\n")
            f.write(f"### P sol={self.P_sol}\n")
            f.write(f"### epsilon multiplier={s.problem.SIP_penalty_parameter_multiplier}\n")
            if s.problem.type == "Stokes":
                f.write(f"### gamma={s.problem.velocity_penalty_parameter}\n")
            f.write("###\n")
            f.write(f"### solver={'multigrid' if s.solver.method == 'multigrid' else 'direct'}\n\n")
            f.write("############################################\n\n")

    def _write_summary_results(self, problem):
        with open(self.solution_summary_filepath, "a") as f:
            f.write(f"Residual={self.residual}\n")
            if problem == "Stokes":
                f.write(f"L1 error={self.L1_error_u} (u-velocity)\n")
                f.write(f"L2 error={self.L2_error_u} (u-velocity)\n")
                f.write(f"L1 error={self.L1_error_v} (v-velocity)\n")
                f.write(f"L2 error={self.L2_error_v} (v-velocity)\n")
                f.write(f"L1 error={self.L1_error_p} (pressure)\n")
                f.write(f"L2 error={self.L2_error_p} (pressure)\n")
            else:
                f.write(f"L1 error={self.L1_error_u}\n")
                f.write(f"L2 error={self.L2_error_u}\n")
