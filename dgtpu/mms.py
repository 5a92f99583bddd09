"""Manufactured solutions via JAX autodiff (replacement for sympy).

The reference builds MMS sources by symbolic differentiation with sympy
(``dgfem/dgfem.py:404-484``).  Here the exact-solution strings from the
paramfile are parsed into JAX-traceable scalar functions and the momentum /
continuity sources are produced by automatic differentiation:

    f_mom_x = -nu * laplace(u) (+ dp/dx for Stokes)
    f_cont  = du/dx + dv/dy    (must vanish: divergence-free check)

This keeps the whole assembly pipeline jittable end-to-end (the reference's
lambdify boundary disappears) and is exact to machine precision, which the
MMS parity tests rely on.  The exact pressure mean (reference:
dgfem.py:378-402, symbolic integration) is computed with high-order
Gauss-Legendre quadrature instead.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from dgtpu.basis import gauss_legendre

_SAFE_FUNCS = {
    "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
    "sinh": jnp.sinh, "cosh": jnp.cosh, "tanh": jnp.tanh,
    "exp": jnp.exp, "log": jnp.log, "sqrt": jnp.sqrt,
    "atan": jnp.arctan, "asin": jnp.arcsin, "acos": jnp.arccos,
    "abs": jnp.abs, "Abs": jnp.abs,
    "pi": math.pi,
}


def parse_expression(expr, constants=None):
    """Compile an exact-solution string (sympy-style) to a scalar jax fn f(x, y).

    Only whitelisted math names are visible; ``constants`` adds numeric
    symbols (e.g. lam, nu for the Kovasznay solution).
    """
    if expr is None:
        return None
    if isinstance(expr, (int, float)):
        const = float(expr)
        return lambda x, y: const + 0.0 * x
    ns = dict(_SAFE_FUNCS)
    if constants:
        ns.update(constants)
    code = compile(str(expr), "<mms>", "eval")
    for name in code.co_names:
        if name not in ns and name not in ("x", "y"):
            raise ValueError(f"Unknown symbol {name!r} in exact solution {expr!r}")

    def f(x, y):
        local = dict(ns)
        local["x"], local["y"] = x, y
        return eval(code, {"__builtins__": {}}, local) + 0.0 * x

    return f


def _vectorize(f):
    """Elementwise application of a scalar fn over arrays of any shape.

    Runs on the host CPU with the rest of set-up: MMS evaluation is
    set-up and oracle work (sources, Dirichlet data, divergence checks,
    nodal errors), so the exact solution a run is scored against is the
    same whichever device ran the solve."""
    def g(x, y):
        from dgtpu.utils.device import setup_scope
        with setup_scope():
            x = jnp.asarray(x, dtype=jnp.result_type(float))
            y = jnp.asarray(y, dtype=x.dtype)
            flat = jax.vmap(f)(x.ravel(), y.ravel())
            return flat.reshape(x.shape)
    return g


def _dx(f):
    return jax.grad(f, argnums=0)


def _dy(f):
    return jax.grad(f, argnums=1)


class ManufacturedSolution:
    """Exact solution + autodiff sources for one problem configuration.

    Parameters mirror the reference orchestrator's MMS machinery:
    ``exact`` is a dict of expression strings per variable, ``nu`` the
    kinematic viscosity; optional ``lam`` is substituted as in the Kovasznay
    configuration (dgfem.py:53-56).
    """

    def __init__(self, exact, problem, nu, lam_expr=None, logger=None):
        constants = {"nu": nu}
        if lam_expr is not None:
            lam_code = compile(str(lam_expr), "<lam>", "eval")
            constants["lam"] = float(eval(lam_code, {"__builtins__": {}},
                                          dict(_SAFE_FUNCS, nu=nu)))
        self.problem = problem
        self.nu = nu
        self.p_mean = 0.0
        self._u = parse_expression(exact.get("u"), constants)
        self._v = parse_expression(exact.get("v"), constants) if problem == "Stokes" else None
        self._p = parse_expression(exact.get("p"), constants) if problem == "Stokes" else None
        self.logger = logger

        # scalar-core derivative functions
        u, v, p = self._u, self._v, self._p
        if problem == "Poisson":
            lap_u = lambda x, y: _dx(_dx(u))(x, y) + _dy(_dy(u))(x, y)
            self._f_mom = (lambda x, y: -nu * lap_u(x, y),)
            self._f_cont = None
        elif problem == "Stokes":
            lap_u = lambda x, y: _dx(_dx(u))(x, y) + _dy(_dy(u))(x, y)
            lap_v = lambda x, y: _dx(_dx(v))(x, y) + _dy(_dy(v))(x, y)
            self._f_mom = (
                lambda x, y: -nu * lap_u(x, y) + _dx(p)(x, y),
                lambda x, y: -nu * lap_v(x, y) + _dy(p)(x, y),
            )
            self._f_cont = lambda x, y: _dx(u)(x, y) + _dy(v)(x, y)
        else:
            raise NotImplementedError(problem)

        # vectorized public callables
        self.u = _vectorize(self._u)
        self.v = _vectorize(self._v) if self._v else None
        self.p_raw = _vectorize(self._p) if self._p else None
        self.f_momentum = tuple(_vectorize(f) for f in self._f_mom)
        self.f_continuity = _vectorize(self._f_cont) if self._f_cont else None

    def check_divergence_free(self, n_sample=64, tol=1e-10):
        """Numeric analog of the reference's symbolic divergence check (dgfem.py:425-429)."""
        if self._f_cont is None:
            return True
        rng = np.random.default_rng(0)
        xs = rng.uniform(-0.9, 0.9, n_sample)
        ys = rng.uniform(-0.9, 0.9, n_sample)
        div = np.asarray(self.f_continuity(xs, ys))
        if np.max(np.abs(div)) > tol:
            raise ValueError(f"Manufactured solution is not divergence-free, "
                             f"max|div u| = {np.max(np.abs(div)):.3e}")
        return True

    def p(self, x, y):
        """Mean-shifted exact pressure (reference subtracts exact_p_mean, dgfem.py:443)."""
        return self.p_raw(x, y) - self.p_mean

    def compute_pressure_mean(self, geometry, circular, n_quad=64):
        """Domain-average of the exact pressure by high-order GL quadrature.

        Reference computes this symbolically (dgfem.py:378-402); we integrate
        numerically to ~1e-14 on the rectangle bounding box or on the annulus
        (r dtheta dr weight).
        """
        if self._p is None:
            self.p_mean = 0.0
            return 0.0
        r, w = gauss_legendre(n_quad)
        if circular:
            r_min = float(np.min(np.sqrt(geometry.x ** 2 + geometry.y ** 2)))
            r_max = float(np.max(np.sqrt(geometry.x ** 2 + geometry.y ** 2)))
            rr = r_min + (r + 1) / 2 * (r_max - r_min)
            tt = (r + 1) / 2 * (2 * np.pi)
            R, T = np.meshgrid(rr, tt, indexing="ij")
            W = np.outer(w, w) * (r_max - r_min) / 2 * np.pi * R
            vals = np.asarray(self.p_raw(R * np.cos(T), R * np.sin(T)))
            A = np.pi * (r_max ** 2 - r_min ** 2)
            self.p_mean = float(np.sum(vals * W) / A)
        else:
            x_min, x_max = float(np.min(geometry.x)), float(np.max(geometry.x))
            y_min, y_max = float(np.min(geometry.y)), float(np.max(geometry.y))
            xx = x_min + (r + 1) / 2 * (x_max - x_min)
            yy = y_min + (r + 1) / 2 * (y_max - y_min)
            X, Y = np.meshgrid(xx, yy, indexing="ij")
            W = np.outer(w, w) * (x_max - x_min) * (y_max - y_min) / 4
            vals = np.asarray(self.p_raw(X, Y))
            A = (x_max - x_min) * (y_max - y_min)
            self.p_mean = float(np.sum(vals * W) / A)
        return self.p_mean

    # ---- reference-compatible multi-variable evaluation ------------------

    def solution(self, var):
        """Return the vectorized exact-field callable for 'u'|'v'|'p'."""
        return {"u": self.u, "v": self.v, "p": self.p}[var]
