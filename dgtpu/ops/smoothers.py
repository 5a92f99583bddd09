"""Element-block relaxation smoothers.

The reference's smoother menu (``dgfem/relaxation.py:103-218``) — jacobi,
jacobi_pyamg, block_jacobi, gauss_seidel, gauss_seidel_pyamg,
block_gauss_seidel, block_gauss_seidel_pyamg — all reduce mathematically to
two kernels over the element-block partition:

* **block Jacobi**:       x <- w * Dinv (b - (A - D) x) + (1 - w) x
* **block Gauss-Seidel**: for block rows i in sweep order,
                          x_i <- Dinv_i (b_i - sum_{j!=i} A_ij x_j)

(The reference's scalar-named variants operate on the BSR blocks too:
pyamg's ``bsr_gauss_seidel`` solves the diagonal block per block row, and
its plain ``gauss_seidel``/``jacobi`` splitting solves use the block
diagonal from ``split_block_EDF``.)

Two execution strategies:

* ``sequential`` — a ``lax.scan`` over element rows, bit-faithful to the
  reference/pyamg lexicographic sweep (forward/backward/symmetric).  This is
  the parity mode used to reproduce residual histories.
* ``redblack`` — checkerboard-colored sweeps: each color updates as one
  batched solve, 2 fused steps per sweep, no sequential dependence — the
  parallel fast path.  (A permitted numerical deviation: the iteration matrix differs
  from lexicographic GS; offered under the same config strings via
  ``performance.smoother_parallelization``.)

All functions are jit-safe with static ``iterations``/``direction``.
"""

from functools import partial

import jax
import jax.numpy as jnp


def block_diag_inv(op):
    # setup-time inversion on host LAPACK (see ops.linalg)
    from dgtpu.ops.linalg import host_inv
    return host_inv(op.diag_blocks())


def block_jacobi(op, rhs, u, omega=1.0, iterations=1, Dinv=None):
    """Damped block Jacobi (relaxation.py:103-150 semantics)."""
    n, _, br, bc = op.blocks.shape
    if Dinv is None:
        Dinv = block_diag_inv(op)
    rhs2 = rhs.reshape(n, br)

    def body(_, u):
        off = op.offdiag_matvec(u).reshape(n, br)
        unew = jnp.einsum("nij,nj->ni", Dinv, rhs2 - off)
        return (omega * unew + (1 - omega) * u.reshape(n, bc)).reshape(-1)

    return jax.lax.fori_loop(0, iterations, body, u.reshape(-1))


def _gs_sweep_sequential(op, rhs, u, Dinv, omega, backward):
    """One lexicographic block-GS sweep as a lax.scan over element rows."""
    n, _, br, bc = op.blocks.shape
    rhs2 = rhs.reshape(n, br)
    u = u.reshape(n, bc)
    order = jnp.arange(n - 1, -1, -1) if backward else jnp.arange(n)
    # zero the diagonal slot so a full gather-contract gives the off-diag part
    off_blocks = op.blocks.at[:, 0].set(0.0)

    def step(u, e):
        ublk = u[op.nbr[e]]                            # (5, Bc)
        contrib = jnp.einsum("sij,sj->i", off_blocks[e], ublk)
        unew = Dinv[e] @ (rhs2[e] - contrib)
        unew = omega * unew + (1 - omega) * u[e]
        return u.at[e].set(unew), None

    u, _ = jax.lax.scan(step, u, order)
    return u.reshape(-1)


def _gs_sweep_colored(op, rhs, u, Dinv, omega, colors):
    """Red-black block-GS sweep: one batched update per color."""
    n, _, br, bc = op.blocks.shape
    rhs2 = rhs.reshape(n, br)
    u = u.reshape(n, bc)
    for c in (0, 1):
        sel = (colors == c)[:, None]
        off = op.offdiag_matvec(u.reshape(-1)).reshape(n, br)
        unew = jnp.einsum("nij,nj->ni", Dinv, rhs2 - off)
        unew = omega * unew + (1 - omega) * u
        u = jnp.where(sel, unew, u)
    return u.reshape(-1)


class ColorPack:
    """Per-color packed off-diagonal blocks for red-black sweeps.

    ``_gs_sweep_colored`` reads the full (N, 5) stencil and where-selects
    half the rows away — per sweep that is 2 full passes over the operator.
    Packing each color's rows once at setup (idx_c, 4 off-diag slots) cuts
    the block traffic per color pass to ~1/2.5 of the full stencil, with
    bit-identical update math (neighbors are gathered from the same
    pre-update vector either way).
    """

    def __init__(self, op, colors):
        import numpy as np
        blocks = np.asarray(op.blocks)
        mask = np.asarray(op.mask)
        nbr = np.asarray(op.nbr)
        cols = np.asarray(colors)
        self.idx, self.off_blocks, self.off_nbr = [], [], []
        for c in (0, 1):
            idx = np.nonzero(cols == c)[0]
            self.idx.append(jnp.asarray(idx, dtype=jnp.int32))
            ob = np.where(mask[idx][:, 1:, None, None], blocks[idx][:, 1:], 0.0)
            self.off_blocks.append(jnp.asarray(ob, dtype=blocks.dtype))
            self.off_nbr.append(jnp.asarray(nbr[idx][:, 1:], dtype=jnp.int32))

    def to_device(self, device):
        self.idx = [jax.device_put(x, device) for x in self.idx]
        self.off_blocks = [jax.device_put(x, device) for x in self.off_blocks]
        self.off_nbr = [jax.device_put(x, device) for x in self.off_nbr]
        return self

    def astype(self, dtype):
        self.off_blocks = [b.astype(dtype) for b in self.off_blocks]
        return self


def _gs_sweep_packed(op, rhs, u, Dinv, omega, pack):
    """Red-black sweep over color-packed blocks (same math, less traffic)."""
    n, _, br, bc = op.blocks.shape
    rhs2 = rhs.reshape(n, br)
    u = u.reshape(n, bc)
    for c in (0, 1):
        idx = pack.idx[c]
        u_nbr = u[pack.off_nbr[c]]                      # (nc, 4, bc)
        off = jnp.einsum("nsij,nsj->ni", pack.off_blocks[c], u_nbr)
        unew = jnp.einsum("nij,nj->ni", Dinv[idx], rhs2[idx] - off)
        unew = omega * unew + (1 - omega) * u[idx]
        u = u.at[idx].set(unew)
    return u.reshape(-1)


def estimate_rho_dinv_a(op, Dinv=None, iterations=30, seed=7):
    """Spectral-radius estimate of D^-1 A by power iteration (setup-time).

    Used to set the Chebyshev smoothing interval.  Runs eagerly in the
    operator's dtype; ~30 iterations give rho to a few percent, and the
    1.1 safety factor applied by the caller absorbs the slack.
    """
    if Dinv is None:
        Dinv = block_diag_inv(op)
    n, _, br, _ = op.blocks.shape
    key = jax.random.PRNGKey(seed)
    v = jax.random.normal(key, (n * br,), dtype=op.blocks.dtype)
    v = v / jnp.linalg.norm(v)
    rho = jnp.asarray(1.0, dtype=v.dtype)
    for _ in range(int(iterations)):
        w = jnp.einsum("nij,nj->ni", Dinv,
                       op.matvec(v).reshape(n, br)).reshape(-1)
        rho = jnp.linalg.norm(w)
        v = w / rho
    return float(rho)


def chebyshev(op, rhs, u, degree=3, eig_max=None, eig_ratio=0.3, Dinv=None):
    """Chebyshev polynomial smoother on the block-Jacobi-preconditioned
    operator — the parallel-first smoother: ``degree`` stencil matvecs and
    batched block solves, no sequential sweep, no coloring, no
    data-dependent control flow (hypre/AMGcl-style; no reference
    equivalent, relaxation.py has only Jacobi/GS variants).

    Damps the interval [eig_ratio*lmax, lmax] of D^-1 A; ``eig_max``
    should be a power-iteration estimate (``estimate_rho_dinv_a``) times
    a ~1.1 safety factor, supplied by the caller at setup.
    """
    if Dinv is None:
        Dinv = block_diag_inv(op)
    if eig_max is None:
        eig_max = 1.1 * estimate_rho_dinv_a(op, Dinv)
    n, _, br, bc = op.blocks.shape
    lmax = jnp.asarray(eig_max, dtype=rhs.dtype)
    lmin = eig_ratio * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def prec_residual(x):
        r = (rhs - op.matvec(x)).reshape(n, br)
        return jnp.einsum("nij,nj->ni", Dinv, r).reshape(-1)

    x = u.reshape(-1)
    d = prec_residual(x) / theta
    x = x + d
    rho = 1.0 / sigma
    # static degree: the three-term recurrence coefficients are python
    # floats folded into the HLO; degree-k = k matvecs
    for _ in range(int(degree) - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        z = prec_residual(x)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x


def element_colors(Ni, Nj):
    """Checkerboard coloring of the element grid (m = j*Ni + i)."""
    m = jnp.arange(Ni * Nj)
    i, j = m % Ni, m // Ni
    return ((i + j) % 2).astype(jnp.int32)


def block_gauss_seidel(op, rhs, u, direction="symmetric", omega=1.0, iterations=1,
                       Dinv=None, strategy="sequential", colors=None, pack=None):
    """Block Gauss-Seidel with pyamg sweep semantics.

    ``direction``: 'forward' | 'backward' | 'symmetric' (forward then backward
    per iteration, pyamg_relaxation.py:240-250).
    """
    if Dinv is None:
        Dinv = block_diag_inv(op)

    if strategy == "redblack":
        if colors is None and pack is None:
            raise ValueError("redblack strategy needs element colors")
        # direction is immaterial for colored sweeps; symmetric does 2 passes
        n_pass = 2 if direction == "symmetric" else 1

        def body(_, u):
            for _ in range(n_pass):
                if pack is not None:
                    u = _gs_sweep_packed(op, rhs, u, Dinv, omega, pack)
                else:
                    u = _gs_sweep_colored(op, rhs, u, Dinv, omega, colors)
            return u
        return jax.lax.fori_loop(0, iterations, body, u.reshape(-1))

    def body(_, u):
        if direction in ("forward", "symmetric"):
            u = _gs_sweep_sequential(op, rhs, u, Dinv, omega, backward=False)
        if direction in ("backward", "symmetric"):
            u = _gs_sweep_sequential(op, rhs, u, Dinv, omega, backward=True)
        return u

    return jax.lax.fori_loop(0, iterations, body, u.reshape(-1))


SMOOTHER_ALIASES = {
    # every reference smoother string -> (kernel, kwargs)
    "jacobi": "jacobi",
    "jacobi_pyamg": "jacobi",
    "block_jacobi": "jacobi",
    "gauss_seidel": "gs",
    "gauss_seidel_pyamg": "gs",
    "block_gauss_seidel": "gs",
    "block_gauss_seidel_pyamg": "gs",
    "block_gauss_seidel_rb": "gs_rb",
    "distributive_gauss_seidel": "dgs",
    "chebyshev": "cheby",
}


def normalize_smoother_name(name):
    """Case-insensitive smoother lookup.

    (The reference paramfile spells ``distributive_Gauss_Seidel`` while the
    method is ``distributive_gauss_seidel`` — a latent AttributeError there;
    normalized here.)
    """
    key = str(name).lower()
    if key not in SMOOTHER_ALIASES:
        raise ValueError(f"Unknown smoother {name!r}; options: {sorted(SMOOTHER_ALIASES)}")
    return key


def apply_smoother(name, op, rhs, u, direction="symmetric", omega=1.0,
                   iterations=1, Dinv=None, strategy="sequential", colors=None,
                   pack=None, eig_max=None, eig_ratio=None):
    """Dispatch a reference smoother string onto the batched smoothers.

    For ``chebyshev``, ``iterations`` is the polynomial degree.  The
    smoothing-interval lower end comes from ``eig_ratio`` (fraction of
    lmax); when it is None, a ``relaxation factor`` inside (0, 1) is
    reinterpreted as eig_ratio **with a warning** — an omega carried over
    from a damped-Jacobi config would otherwise silently narrow the
    interval and weaken the smoother (advisor r3, smoothers.py:289).  The
    conventional omega=1.0 maps to the standard 0.3.
    """
    kind = SMOOTHER_ALIASES[normalize_smoother_name(name)]
    iterations = int(iterations)
    if kind == "cheby":
        if eig_ratio is None:
            if 0.0 < omega < 1.0:
                import logging
                logging.getLogger("dgtpu").warning(
                    "chebyshev: relaxation factor omega=%g is being "
                    "reinterpreted as eig_ratio (smoothing interval "
                    "[%g*lmax, lmax]); set an explicit 'eig ratio' on the "
                    "smoother node to silence this", omega, omega)
                eig_ratio = omega
            else:
                eig_ratio = 0.3
        return chebyshev(op, rhs, u, degree=iterations, eig_max=eig_max,
                         eig_ratio=eig_ratio, Dinv=Dinv)
    if kind == "jacobi":
        return block_jacobi(op, rhs, u, omega=omega, iterations=iterations, Dinv=Dinv)
    if kind == "gs":
        return block_gauss_seidel(op, rhs, u, direction=direction, omega=omega,
                                  iterations=iterations, Dinv=Dinv,
                                  strategy=strategy, colors=colors, pack=pack)
    if kind == "gs_rb":
        return block_gauss_seidel(op, rhs, u, direction=direction, omega=omega,
                                  iterations=iterations, Dinv=Dinv,
                                  strategy="redblack", colors=colors, pack=pack)
    raise ValueError(f"Smoother {name!r} requires the Stokes distributive driver")
