"""Mixed-precision iterative refinement: f64 accuracy at f32 multigrid speed.

The BASELINE parity target is a 1e-10 residual, which f32 multigrid alone
cannot reach.  Classic defect correction bridges the gap:

    loop:  r = b - A u            (high precision, ONE matvec per outer step)
           e ~ A^-1 r             (k float32 V-cycles — the fast path)
           u = u + e              (high-precision accumulation)

The f32 inner solve only needs to reduce the defect by ~1e-6 per outer
iteration, so the outer loop reaches 1e-10..1e-14 in a handful of rounds
while >95% of the work runs in native-speed float32.

The defect runs in float64, exactly the reference's arithmetic
(``solver.py:114-123`` runs native f64 NumPy).
"""

import jax
import jax.numpy as jnp

from dgtpu.utils.jitting import const_jit
from dgtpu.utils.norms import lp_norm


def make_refined_solver(op64, cycle32, n_inner=8, tol=1e-10, max_outer=20,
                        normalize="u0", inner="cycles",
                        matvec32=None):
    """Build a jitted mixed-precision solver.

    ``op64``: the float64 operator (matvec).  ``cycle32(rhs32, u32)``: one
    float32 V-cycle.
    ``normalize``: 'u0' divides residuals by ||b - A u0|| (the classic
    relative criterion for a zero guess); 'rhs' divides by ||b|| — use this
    when u0 is an FMG guess, so the tolerance keeps its
    relative-to-zero-iterate meaning instead of demanding ``tol`` *beyond*
    the already-good start (same rule as MultigridSolver._build_solve).

    ``inner``: how the f32 correction equation is solved each outer step.
    'cycles' (default) applies ``n_inner`` multigrid cycles; 'gmres' runs
    ``n_inner`` iterations of f32 GMRES *preconditioned* by one cycle
    (requires ``matvec32``, the f32 operator).  Krylov-wrapped cycles
    converge even when the stand-alone cycle iteration has spectral radius
    >= 1 (e.g. deep Stokes hierarchies where the coarse-grid correction
    quality degrades with level count) — GMRES minimizes the residual over
    the Krylov space, so isolated divergent cycle modes cost a few extra
    iterations instead of blowing up the outer loop.
    Returns solve(rhs64, u0) -> (u, res, n_outer, history).
    """
    if normalize not in ("u0", "rhs"):
        raise ValueError(normalize)
    if inner not in ("cycles", "gmres"):
        raise ValueError(inner)
    if inner == "gmres":
        if matvec32 is None:
            raise ValueError("inner='gmres' requires matvec32 (the f32 "
                             "operator matvec)")
        inner_solve = _make_gmres_inner(matvec32, cycle32, n_inner)
    else:
        def inner_solve(r32):
            return _inner(cycle32, n_inner, r32)
    return _make_f64_solver(op64, inner_solve, tol, max_outer,
                            normalize)


def _inner(cycle32, n_inner, r32):
    # a loop, not n_inner unrolled copies of the cycle: the compiled graph
    # holds one cycle, which keeps the GPU compile of large cycles short
    return jax.lax.fori_loop(0, n_inner, lambda _, e: cycle32(r32, e),
                             jnp.zeros_like(r32))


def gmres_correction(AM, M, r, m, dot=None, norm=None):
    """e = M z, where z approximately minimizes ``||r - A M z||`` over the
    m-step Krylov space: the correction step of RIGHT-preconditioned
    GMRES(m) with a zero initial guess.

    ``AM(x)`` applies the preconditioned operator A∘M; ``M(x)`` applies
    the preconditioner alone (one multigrid cycle from zero).  ``dot`` /
    ``norm`` default to the single-device ``jnp.vdot`` /
    ``jnp.linalg.norm``; shard_map callers pass psum-reductions so the
    Arnoldi runs on shard-local vectors with global inner products.

    Hand-rolled rather than ``jax.scipy.sparse.linalg.gmres`` because that
    one is built on ``lax.custom_linear_solve``, which transposes the
    operator at trace time, and a cycle need not define a transpose rule.  A static ``m``-step Arnoldi with a
    dense (m+1) x m least-squares finish is also exactly the fixed,
    jit-friendly work profile the outer defect loop wants, and right
    preconditioning keeps the minimized residual that of the TRUE system
    (left preconditioning minimizes ``M r``)."""
    if dot is None:
        dot = jnp.vdot
    if norm is None:
        norm = jnp.linalg.norm
    dt = r.dtype
    tiny = jnp.asarray(1e-35 if dt == jnp.float32 else 1e-300, dt)

    beta = norm(r)
    V = [r / jnp.maximum(beta, tiny)]
    H = jnp.zeros((m + 1, m), dt)
    for j in range(m):                      # static unroll, m is small
        w = AM(V[j])
        for i in range(j + 1):              # modified Gram-Schmidt
            hij = dot(V[i], w).astype(dt)
            H = H.at[i, j].set(hij)
            w = w - hij * V[i]
        hj1 = norm(w).astype(dt)
        H = H.at[j + 1, j].set(hj1)
        # happy breakdown -> zero vector; the QR finish handles the rank
        # drop
        V.append(jnp.where(hj1 > tiny, 1.0, 0.0).astype(dt)
                 * w / jnp.maximum(hj1, tiny))
    # min ||beta e1 - H y|| via explicit Givens QR + back-substitution:
    # H is (m+1) x m upper Hessenberg with tiny m, so the unrolled
    # scalar form is cheap — and it avoids SVD/QR primitives inside
    # this while_loop (lowering jnp.linalg.lstsq here crashed one XLA
    # backend's TransposeFolding pass)
    g = jnp.zeros((m + 1,), dt).at[0].set(beta)
    R = H
    for j in range(m):
        a, b = R[j, j], R[j + 1, j]
        rad = jnp.sqrt(a * a + b * b)
        safe = jnp.maximum(rad, tiny)
        c, s = a / safe, b / safe
        row_j = c * R[j] + s * R[j + 1]
        row_j1 = -s * R[j] + c * R[j + 1]
        R = R.at[j].set(row_j).at[j + 1].set(row_j1)
        gj = c * g[j] + s * g[j + 1]
        gj1 = -s * g[j] + c * g[j + 1]
        g = g.at[j].set(gj).at[j + 1].set(gj1)
    y = [jnp.zeros((), dt)] * m
    for i in reversed(range(m)):
        acc = g[i]
        for k in range(i + 1, m):
            acc = acc - R[i, k] * y[k]
        # breakdown (zero pivot) -> that direction contributes nothing
        y[i] = jnp.where(jnp.abs(R[i, i]) > tiny,
                         acc / jnp.where(jnp.abs(R[i, i]) > tiny,
                                         R[i, i], 1.0),
                         0.0).astype(dt)
    z = sum(y[j] * V[j] for j in range(m))
    return M(z)


def _make_gmres_inner(matvec32, cycle32, n_inner):
    """inner_solve(r32) -> e32 via ``gmres_correction`` over the f32 cycle
    (see there for the why)."""

    # unwrap const_jit callables: re-entering jit mid-trace is unnecessary
    # here, and the ENCLOSING refined solver is const_jit'd anyway, so the
    # operator arrays still get hoisted to runtime arguments
    matvec32 = getattr(matvec32, "__wrapped__", matvec32)
    cycle32 = getattr(cycle32, "__wrapped__", cycle32)

    def inner_solve(r32):
        dt = r32.dtype

        def M(x):
            # an f64 inner cycle (used in tests) must not widen the f32
            # defect
            return cycle32(x, jnp.zeros_like(x)).astype(dt)

        def AM(x):
            return matvec32(M(x)).astype(dt)

        return gmres_correction(AM, M, r32, n_inner)

    return inner_solve


def _make_f64_solver(op64, inner_solve, tol, max_outer,
                     normalize="u0"):
    # op64 is passed as a jit ARGUMENT (it is a registered pytree), not
    # captured by closure: closure-captured arrays become HLO literals, and
    # the emulated-f64 operator blocks are by far the largest array in the
    # program (212 MB at 64x64 — large enough to exceed compile-request
    # limits on remote-compile setups)
    @const_jit
    def solve_with_op(op64, rhs, u0):
        r0 = rhs - op64.matvec(u0)
        res0 = lp_norm(rhs, 2) if normalize == "rhs" else lp_norm(r0, 2)
        hist0 = jnp.full((max_outer + 1,), jnp.nan, dtype=rhs.dtype)

        def cond(state):
            n, u, r, res, hist = state
            return (n < max_outer) & (res >= tol) & jnp.isfinite(res)

        def body(state):
            n, u, r, res, hist = state
            hist = hist.at[n].set(res)
            e32 = inner_solve(r.astype(jnp.float32))
            u = u + e32.astype(rhs.dtype)
            r = rhs - op64.matvec(u)
            res = lp_norm(r, 2) / res0
            return n + 1, u, r, res, hist

        state = (jnp.asarray(0, dtype=jnp.int32), u0, r0,
                 lp_norm(r0, 2) / res0, hist0)
        n, u, r, res, hist = jax.lax.while_loop(cond, body, state)
        hist = hist.at[n].set(res)
        return u, res, n, hist

    def solve(rhs, u0):
        return solve_with_op(op64, rhs, u0)

    return solve
