"""Smoke run of dgtpu's main path on an NVIDIA GPU, checked against the CPU.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # the sharded phase on four cards

Phases (one card): ``device`` (a GPU is the default device), ``cli``
(``python -m dgtpu -m`` on the paramfile flagship, checked against the same
solve on the host CPU), ``configs`` (the five BASELINE configurations, GPU
against CPU) and ``mixed_64`` (64x64 p=5 Poisson to a 1e-10 residual, mixed
against full precision, plus the f32 cycle's iterate on the GPU against the
CPU's, a check that TF32 products would fail).
``--four-cards`` runs only the sharded multigrid phase and the
one-card solves it is compared with.

Every phase prints its own line; every time is printed beside the card's
name and power limit.  A failed check raises, so the script exits non-zero
and does not print the last line, which is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

CARD = "unknown card"


def card_line():
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else \
        f"nvidia-smi failed (rc {out.returncode})"


def say(phase, msg):
    print(f"[{CARD}] {phase}: {msg}", flush=True)


def last_line(devices):
    """The run's result line: platform, kind and count of the devices."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def require_gpu(devices):
    """Exit non-zero unless JAX's default device is a GPU."""
    if devices[0].platform != "gpu":
        print(f"chip_smoke: the default JAX device is "
              f"{devices[0].platform!r}, not a GPU", file=sys.stderr)
        raise SystemExit(2)
    return devices[0]


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# -------------------------------------------------------------- phase 2: cli

def phase_cli(paramfile=None, rtol=1e-10):
    """``python -m dgtpu -m`` on the default device, against the same solve
    on the host CPU.  Returns the default-device DGFEM."""
    from dgtpu.__main__ import main as cli_main
    from dgtpu.api import DGFEM
    from dgtpu.settings import Settings, load_params

    argv = ["-m", "--silent"] + (["--paramfile", paramfile] if paramfile
                                 else [])
    dg, total = _timed(lambda: cli_main(argv))
    cold = dg.solve_seconds
    dg.solve()
    warm = dg.solve_seconds
    res = dg.residuals[-1]
    check(res <= 1e-6, f"cli: final normalized residual {res:.3e} > 1e-6")

    s = Settings(load_params(paramfile))
    s.update_setting("logging.loglevel", "ERROR")
    s.update_setting("visualization.export", False)
    s.update_setting("performance.device", "cpu")
    ref = DGFEM(settings=s, solve_multigrid=True)
    ref.solve()
    err = rel(dg.L2_error_u, ref.L2_error_u)
    check(err <= rtol, f"cli: L2_error_u {dg.L2_error_u!r} vs CPU "
                       f"{ref.L2_error_u!r} (rel {err:.2e} > {rtol:g})")
    say("cli", f"python -m dgtpu {' '.join(argv)}: {dg.iterations} cycles, "
               f"residual {res:.3e}, L2_error_u {dg.L2_error_u:.6e} "
               f"(CPU {ref.L2_error_u:.6e}, rel {err:.1e}); DGFEM.solve "
               f"cold {cold:.3f} s, warm {warm:.3f} s (set-up + cold solve "
               f"{total:.3f} s; CPU solve {ref.solve_seconds:.3f} s)")
    return dg


# ---------------------------------------------------------- phase 3: configs

def phase_configs(rtol=1e-10, names=None):
    """The five BASELINE configs (as ``bench.py`` builds them) on the
    default device and on the host CPU."""
    import bench
    from dgtpu.api import DGFEM

    for name, make, kw in bench.baseline_configs():
        if names is not None and name not in names:
            continue
        dg = DGFEM(settings=make(), **kw)
        dg.solve()
        cold = dg.solve_seconds
        dg.solve()
        warm = dg.solve_seconds
        s_cpu = make()
        s_cpu.update_setting("performance.device", "cpu")
        ref = DGFEM(settings=s_cpu, **kw)
        ref.solve()
        res = bench.normalized_residual(dg)
        check(res < 1e-6, f"configs: {name} residual {res:.3e} >= 1e-6")
        errs = []
        for k in ("L2_error_u", "L2_error_v", "L2_error_p"):
            if hasattr(dg, k):
                e = rel(getattr(dg, k), getattr(ref, k))
                check(e <= rtol, f"configs: {name} {k} {getattr(dg, k)!r} "
                                 f"vs CPU {getattr(ref, k)!r} "
                                 f"(rel {e:.2e} > {rtol:g})")
                errs.append(f"{k} rel {e:.1e}")
        say("configs", f"{name}: residual {res:.3e}, {', '.join(errs)}; "
                       f"solve cold {cold:.3f} s, warm {warm:.3f} s "
                       f"(CPU {ref.solve_seconds:.3f} s)")


# --------------------------------------------------------- phase 4: mixed_64

def phase_mixed(n=64, p=5, rtol=1e-8, check_n=8, check_p=5,
                tf32_must_fail=True):
    """n x n p Poisson to a 1e-10 residual, mixed precision + FMG against
    full precision; the f32 cycle's time per cycle, and its iterate on the
    default device against the CPU's (``precision_gap``).

    The two solutions must agree to ``rtol`` (max-norm, relative).  Their
    MMS L2 errors are reported, not compared: at 64x64 p=5 the
    discretization error (~5e-12) is below what a 1e-10 residual
    resolves, so the two L2 errors differ at O(1) relative while both sit
    at the discretization floor."""
    import numpy as np
    from __graft_entry__ import _flagship

    dg, setup = _timed(lambda: _flagship(
        n=n, p_grid=p, p_sol=p, **{"performance.precision": "mixed",
                                   "solver.multigrid.full_multigrid": True,
                                   "solver.multigrid.tolerance": 1e-10}))
    dg.solve()
    cold = dg.solve_seconds
    u_mixed = np.asarray(dg.solve())
    warm, rounds, res = dg.solve_seconds, dg.iterations, dg.residuals[-1]
    l2_mixed = dg.L2_error_u
    check(res <= 1e-10, f"mixed_64: mixed residual {res:.3e} > 1e-10")
    say("mixed_64", f"{n}x{n} p={p} ({dg.levels[-1].rhs.shape[0]} DOF) "
                    f"set-up {setup:.3f} s; mixed+FMG to {res:.2e}: "
                    f"{rounds} outer rounds; DGFEM.solve to 1e-10 (f32 "
                    f"cycle set-up included) {warm:.4f} s warm, {cold:.3f} s "
                    f"cold (compile ~{cold - warm:.3f} s)")

    dg.settings.update_setting("performance.precision", "full")
    dg.settings.update_setting("solver.multigrid.full_multigrid", False)
    dg.solve()
    cold_f = dg.solve_seconds
    u_full = np.asarray(dg.solve())
    warm_f, res_f = dg.solve_seconds, dg.residuals[-1]
    e = np.abs(u_mixed - u_full).max() / np.abs(u_full).max()
    check(res_f <= 1e-10, f"mixed_64: full residual {res_f:.3e} > 1e-10")
    check(e <= rtol, f"mixed_64: mixed vs full solution max rel diff "
                     f"{e:.2e} > {rtol:g}")
    say("mixed_64", f"full f64: {dg.iterations} cycles to {res_f:.2e} in "
                    f"{warm_f:.4f} s warm, {cold_f:.3f} s cold; solutions "
                    f"agree to {e:.1e} (max rel); L2_error_u mixed "
                    f"{l2_mixed:.6e}, full {dg.L2_error_u:.6e}")

    cycle_time(dg, "mixed_64")
    if check_n == n and check_p == p:
        small = dg
    else:
        small = _flagship(n=check_n, p_grid=check_p, p_sol=check_p)
        cycle_time(small, "mixed_64")
    precision_gap(small, tf32_must_fail=tf32_must_fail)
    return dg


def _route_builder(dg):
    """The f32 inner cycle of the Poisson mixed route (rolled layout)."""
    import jax.numpy as jnp
    from dgtpu.ops.pallas_vcycle import PallasVCycle
    from dgtpu.utils.device import setup_scope
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    with setup_scope():
        return PallasVCycle([l.op for l in dg.levels], dg.transfers,
                            dg.transfer_types, dg.settings, dims,
                            dtype=jnp.float32)


def cycle_time(dg, phase, reps=20):
    """Set-up time and bytes of the f32 route cycle, and its time per cycle
    on the default device (``reps`` calls, one wait at the end)."""
    import jax
    import jax.numpy as jnp

    pv, setup = _timed(lambda: _route_builder(dg))
    target = jax.devices()[0]
    pv.to_device(target)
    nbytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(
        (pv._host_consts(), pv.R, pv.P, pv.coarse_inv_col))
        if hasattr(x, "nbytes"))
    cyc = pv.build_xla()

    def many(u):
        for _ in range(reps):
            u = cyc(rhs, u)
        return jax.block_until_ready(u)

    rhs = jax.device_put(dg.levels[-1].rhs.astype(jnp.float32), target)
    u0 = jnp.zeros_like(rhs)
    _, first = _timed(lambda: jax.block_until_ready(cyc(rhs, u0)))
    many(u0)
    _, t = _timed(lambda: many(u0))
    lvl = dg.levels[-1]
    say(phase, f"rolled f32 cycle {lvl.Ni}x{lvl.Nj} p={lvl.P_sol['u']}: "
               f"{t / reps * 1e3:.4f} ms/cycle ({reps} calls, one wait; "
               f"first call {first:.3f} s); builder set-up {setup:.3f} s, "
               f"{nbytes / 1e6:.1f} MB of cycle operands")
    return t / reps


def precision_ok(gap, limit, what):
    """Raise unless the f32 cycle's iterate is within ``limit`` of the
    CPU's (max-norm, relative)."""
    check(gap <= limit, f"precision: {what} iterate differs from the CPU's "
                        f"by {gap:.2e} (max rel) > {limit:g}: products in "
                        f"reduced precision (TF32?)")


def precision_gap(dg, cycles=2, limit=1.6e-5, rho_tol=0.10,
                  tf32_must_fail=True):
    """The f32 route cycle's iterate after ``cycles`` cycles from zero on
    the default device against the host CPU's (max-norm, relative): at the
    "highest" matmul precision it must be within ``limit``, and the same
    cycle with TF32 products must fail that check (``tf32_must_fail``), so
    the check is shown to catch TF32.  The contraction per cycle must
    agree with the CPU's within ``rho_tol``.

    Two cycles, because a TF32 product's error scales with the correction
    it computes: later cycles compute ever smaller corrections, and from
    the third cycle on the iterate sits at the f32 cycle's own rounding
    floor, where TF32 no longer shows.  At 8x8 p=5 on an H100 the gap was
    5.2e-6 at "highest" and 5.3e-5 with TF32; ``limit`` lies between."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dgtpu.utils.device import cpu_device

    pv = _route_builder(dg)
    op = jax.device_put(dg.levels[-1].op, cpu_device())
    rhs64 = np.asarray(dg.levels[-1].rhs)

    def iterate(device, precision="highest"):
        pv.to_device(device)
        rhs = jax.device_put(jnp.asarray(rhs64, jnp.float32), device)
        with jax.default_matmul_precision(precision):
            cyc = pv.build_xla()
            u = jnp.zeros_like(rhs)
            for _ in range(cycles):
                u = cyc(rhs, u)
        return np.asarray(u, np.float64)

    def rho(u):
        u = jax.device_put(u, cpu_device())
        r = np.linalg.norm(rhs64 - np.asarray(op.matvec(u)))
        return (r / np.linalg.norm(rhs64)) ** (1.0 / cycles)

    target = jax.devices()[0]
    u_cpu = iterate(cpu_device())
    u_dev, u_tf32 = iterate(target), iterate(target, "tensorfloat32")
    scale = np.abs(u_cpu).max()
    gap = float(np.abs(u_dev - u_cpu).max() / scale)
    gap_tf32 = float(np.abs(u_tf32 - u_cpu).max() / scale)
    r_dev, r_cpu, r_tf32 = rho(u_dev), rho(u_cpu), rho(u_tf32)
    lvl = dg.levels[-1]
    say("mixed_64", f"f32 rolled cycle at {lvl.Ni}x{lvl.Nj} "
                    f"p={lvl.P_sol['u']}, iterate after {cycles} cycles vs "
                    f"CPU (max rel): {target.platform} {gap:.2e}, with TF32 "
                    f"products {gap_tf32:.2e} (limit {limit:g}); contraction "
                    f"per cycle {target.platform} {r_dev:.4f}, CPU "
                    f"{r_cpu:.4f}, TF32 {r_tf32:.4f}")
    precision_ok(gap, limit, target.platform)
    e = rel(r_dev, r_cpu)
    check(e <= rho_tol, f"precision: contraction {target.platform} "
                        f"{r_dev:.4f} vs CPU {r_cpu:.4f} per cycle (rel "
                        f"{e:.2f} > {rho_tol:g})")
    try:
        precision_ok(gap_tf32, limit, f"{target.platform} TF32")
        caught = False
    except AssertionError:
        caught = True
    check(caught or not tf32_must_fail,
          f"precision: TF32 products moved the iterate by only "
          f"{gap_tf32:.2e} <= {limit:g}; the check cannot catch TF32")
    return gap, gap_tf32


# ------------------------------------------------------- phase 6: four cards

def phase_four_cards(n_cards=4, n=64, p=5, stokes_n=16):
    """Sharded multigrid over ``n_cards`` devices against the same sharded
    solver on one card: full f64 solutions must agree to 1e-10, mixed
    (f32 cycles + FMG, to a 1e-10 residual) solutions to 1e-8.  The mixed
    runs' MMS L2 errors are reported, not compared, for the reason given
    in ``phase_mixed``."""
    import jax
    import numpy as np
    from __graft_entry__ import _flagship

    devices = jax.devices()
    check(len(devices) >= n_cards,
          f"four_cards: {len(devices)} device(s), need {n_cards}")

    def pair(dg, what, precision, rtol, res_tol):
        (u4, res4, n4), t4 = _timed(
            lambda: dg._solve_multigrid_sharded(n_cards, precision))
        (u1, res1, n1), t1 = _timed(
            lambda: dg._solve_multigrid_sharded(1, precision))
        u4, u1 = np.asarray(u4), np.asarray(u1)
        e = np.abs(u4 - u1).max() / np.abs(u1).max()
        check(float(res4) <= res_tol,
              f"four_cards: {what} {precision} residual {float(res4):.3e}")
        check(e <= rtol, f"four_cards: {what} {precision} solution over "
                         f"{n_cards} cards vs one card: rel {e:.2e} > "
                         f"{rtol:g}")
        l2 = ""
        if precision == "mixed":
            dg._postprocess(u4)
            l2_4 = dg.L2_error_u
            dg._postprocess(u1)
            l2 = (f"; L2_error_u {l2_4:.6e} over {n_cards} cards, "
                  f"{dg.L2_error_u:.6e} on one")
        say("four_cards", f"{what} {precision}: {int(n4)} rounds/cycles to "
                          f"{float(res4):.2e} over {n_cards} cards in "
                          f"{t4:.3f} s (first call), one card {int(n1)} in "
                          f"{t1:.3f} s; solutions agree to {e:.1e}{l2}")

    cfs = _cfs_for_rows(n, n_cards)
    dg = _flagship(n=n, p_grid=p, p_sol=p, **{
        "solver.multigrid.geometric_coarsening.coarsening_factors": cfs})
    what = f"Poisson {n}x{n} p={p} (factors {cfs})"
    pair(dg, what, "full", 1e-10, 1e-6)
    dg.settings.update_setting("solver.multigrid.full_multigrid", True)
    dg.settings.update_setting("solver.multigrid.tolerance", 1e-10)
    pair(dg, what, "mixed", 1e-8, 1e-10)

    import bench
    st = bench.stokes_dgfem(stokes_n, cfs=_cfs_for_rows(stokes_n, n_cards))
    pair(st, f"Stokes {stokes_n}x{stokes_n} p_u=2 p_p=1", "full", 1e-10,
         1e-6)


def _cfs_for_rows(n, n_cards):
    """Geometric factors 2, 4, ... down to the coarsest level that keeps
    one element row per card (the shard-local agglomeration needs it)."""
    cfs, cf = [], 2
    while n // cf >= n_cards and n // cf >= 2:
        cfs.append(cf)
        cf *= 2
    return ",".join(map(str, cfs))


# --------------------------------------------------------------------- main

def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded multigrid phase over four "
                         "cards and the one-card solves it is compared with")
    args = ap.parse_args(argv)

    import jax
    import dgtpu  # noqa: F401  (x64, matmul precision)
    from dgtpu.utils.device import enable_compile_cache

    devices = jax.devices()
    dev = require_gpu(devices)
    CARD = card_line()
    enable_compile_cache()
    print(f"card: {CARD}", flush=True)
    say("device", f"{dev.platform} {dev.device_kind}, {len(devices)} "
                  f"device(s); jax {jax.__version__}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_cli()
        phase_configs()
        phase_mixed()
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(last_line(devices), flush=True)


if __name__ == "__main__":
    main()
