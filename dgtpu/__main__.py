"""CLI entry point — same flag surface as the reference (``dgfem/__main__.py``).

    python -m dgtpu -d|-s|-amg|-k|-m|-fvm|-amp [options]
"""

import argparse
import sys
import traceback


class MutuallyInclusiveArgumentError(Exception):
    pass


class MutuallyExclusiveArgumentError(Exception):
    pass


def build_parser():
    parser = argparse.ArgumentParser(
        prog="DG solver (dgtpu)",
        description="DG solver for the Poisson and Stokes problems")
    parser.add_argument("--grid-folder", type=str)
    parser.add_argument("-f", "--grid-file", type=str)
    parser.add_argument("--p-grid", type=int)
    parser.add_argument("--p-solution", type=int)

    solver = parser.add_mutually_exclusive_group(required=True)
    solver.add_argument("-d", "--solve-direct", action="store_true")
    solver.add_argument("-s", "--solve-smoother",
                        help="mutually inclusive with --smoother", action="store_true")
    parser.add_argument("--smoother", type=str)

    solver.add_argument("-amg", "--solve-pyamg", action="store_true")
    solver.add_argument("-k", "--solve-krylov", action="store_true")
    solver.add_argument("-m", "--solve-multigrid", action="store_true")
    solver.add_argument("-fvm", "--solve-finite-volume-method", action="store_true")

    solver.add_argument("-amp", "--solve-smoother-amplification",
                        help="mutually inclusive with --fvm-discretization or "
                             "--dg-discretization", action="store_true")
    parser.add_argument("--dg-discretization", action="store_true")
    parser.add_argument("--fvm-discretization", action="store_true")

    parser.add_argument("--check-eigenvalues", action="store_true")
    parser.add_argument("--check-condition-number", action="store_true")
    parser.add_argument("--plot-sparsity-pattern", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--silent", action="store_true")
    # dgtpu extensions
    parser.add_argument("--shards", type=int, default=None,
                        help="shard the MULTIGRID solve over N devices "
                             "(element-row domain decomposition; ignored "
                             "with a warning for other solvers; new "
                             "capability, no reference equivalent)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="capture a jax.profiler trace of the solve into "
                             "DIR (inspect with TensorBoard/xprof)")
    parser.add_argument("--paramfile", type=str, help="alternate paramfile.yml")
    parser.add_argument("--backend", type=str, default=None,
                        help="force a JAX backend (cpu|gpu)")
    parser.add_argument("--precision", type=str, default=None,
                        choices=("full", "mixed"),
                        help="multigrid precision: full (f64 cycles, "
                             "reference parity) or mixed (f32 "
                             "V-cycles + f64 defect refinement — f64 "
                             "accuracy at f32 speed; dgtpu extension)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.solve_smoother and not args.smoother:
        raise MutuallyInclusiveArgumentError(
            "--solve-smoother option must be used with --smoother")

    discretization = None
    if args.solve_smoother_amplification:
        if not (args.dg_discretization or args.fvm_discretization):
            raise MutuallyInclusiveArgumentError(
                "--solve-smoother-amplification option must be used with either "
                "--dg-discretization or --fvm-discretization")
        if args.dg_discretization and args.fvm_discretization:
            raise MutuallyExclusiveArgumentError(
                "--dg-discretization cannot be used together with --fvm-discretization")
        discretization = "dg" if args.dg_discretization else "fvm"

    if args.backend:
        import jax
        jax.config.update("jax_platforms", args.backend)

    from dgtpu.settings import Settings, load_params
    settings = Settings(load_params(args.paramfile))
    if args.verbose:
        settings.update_setting("logging.loglevel", "DEBUG")
    if args.silent:
        settings.update_setting("logging.loglevel", "ERROR")

    from dgtpu.api import DGFEM
    from dgtpu.utils.logger import Logger
    logger = Logger(__name__, settings).logger
    logger.info("starting DG-FEM (dgtpu)")

    try:
        dgfem = DGFEM(settings=settings, grid_folder=args.grid_folder,
                      grid_file=args.grid_file, p_grid=args.p_grid,
                      p_solution=args.p_solution,
                      solve_direct=args.solve_direct,
                      solve_smoother=args.solve_smoother,
                      solve_smoother_amplification=args.solve_smoother_amplification,
                      solve_pyamg=args.solve_pyamg,
                      solve_krylov=args.solve_krylov,
                      solve_multigrid=args.solve_multigrid,
                      solve_finite_volume_method=args.solve_finite_volume_method,
                      smoother=args.smoother, shards=args.shards,
                      precision=args.precision,
                      discretization=discretization,
                      check_eigenvalues=args.check_eigenvalues,
                      check_condition_number=args.check_condition_number,
                      plot_sparsity_pattern=args.plot_sparsity_pattern)
        if args.profile:
            # jax.profiler trace around the solve (SURVEY §5 tracing: the
            # reference only has wall-clock Timer logs, utils/timer.py:3-40)
            import jax
            with jax.profiler.trace(args.profile):
                dgfem.solve()
            logger.info(f"profiler trace written to {args.profile}")
        else:
            dgfem.solve()
        return dgfem
    except Exception:
        logger.critical(traceback.format_exc())
        sys.exit(1)


if __name__ == "__main__":
    from dgtpu.utils.device import enable_compile_cache
    enable_compile_cache()
    main()
