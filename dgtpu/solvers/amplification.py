"""Smoother amplification analysis (local Fourier analysis), ``-amp`` flag.

Reference: ``dgfem/relaxation.py:21-101``.  For each Fourier mode
(theta_x, theta_y) the initial guess ``exp(i(theta_x k + theta_y l))`` is
projected to modal space, one symmetric block-GS sweep is applied to the
homogeneous system, and the amplitude is sampled at the four center elements.

Batched translation: the reference loops over the 101x101 theta grid in
Python (10201 sequential smoother calls); here the *whole theta grid is one
vmapped batch* of complex sweeps on device.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from dgtpu.ops.smoothers import _gs_sweep_sequential


def calculate_amplification(level, results_dir, n_theta=101, export=True):
    """Returns dict with A1..A4 amplitude arrays over the theta grid."""
    theta = np.linspace(-np.pi, np.pi, n_theta)
    op = level.op
    is_fvm = level.discretization == "fvm"

    if not is_fvm:
        # Fourier modes are sampled at the *solution* LGL nodes, where the
        # modal Vandermonde is square for any P_sol — the reference pins
        # degree 6 in its -amp config but the projection itself is general
        # (relaxation.py:71-90); the round-1 P_sol == P_grid restriction is
        # lifted by interpolating node coordinates from the grid lattice.
        from dgtpu.basis import lagrange_basis, vandermonde_2d
        ns = level.N_sol["u"]
        if ns < 2:
            raise ValueError("smoother amplification needs P_sol >= 1")
        q = level.quad
        V = np.asarray(vandermonde_2d(ns, q.r_sol["u"], q.r_sol["u"]))
        Vinv = np.linalg.inv(V)
        if ns == level.N_grid:
            Xs, Ys = np.asarray(level.X), np.asarray(level.Y)
        else:
            L1 = lagrange_basis(q.r_sol["u"], q.r_grid)    # (ns, n_grid)
            L2 = np.kron(L1, L1)                           # Fortran n=i+j*G
            Xs = np.asarray(level.X) @ L2.T
            Ys = np.asarray(level.Y) @ L2.T
        x0, y0 = float(Xs.min()), float(Ys.min())
        Lx, Ly = float(Xs.max()) - x0, float(Ys.max()) - y0
        Ni_tot = level.Ni * (ns - 1)
        Nj_tot = level.Nj * (ns - 1)
        k = (Xs - x0) * Ni_tot / Lx                        # (N, ns^2)
        l = (Ys - y0) * Nj_tot / Ly
        k_dev, l_dev = jnp.asarray(k), jnp.asarray(l)
        Vinv_dev = jnp.asarray(Vinv)
        V_dev = jnp.asarray(V)
    else:
        i_idx = jnp.arange(level.N) % level.Ni
        j_idx = jnp.arange(level.N) // level.Ni

    blocks_c = op.blocks.astype(jnp.complex128)
    from dgtpu.ops.stencil import StencilOperator
    op_c = StencilOperator(blocks_c, op.nbr, op.mask)
    Dinv_c = jnp.asarray(np.linalg.inv(np.asarray(op.diag_blocks())),
                         dtype=jnp.complex128)

    def one_mode(tx, ty):
        if not is_fvm:
            f_nodal = jnp.exp(1j * (tx * k_dev + ty * l_dev))      # (N, G)
            u0 = (f_nodal @ Vinv_dev.T).reshape(-1)                # modal
        else:
            u0 = jnp.exp(1j * (tx * i_idx + ty * j_idx))
        rhs = jnp.zeros_like(u0)
        u = _gs_sweep_sequential(op_c, rhs, u0, Dinv_c, 1.0, backward=False)
        u = _gs_sweep_sequential(op_c, rhs, u, Dinv_c, 1.0, backward=True)
        if not is_fvm:
            u_nodal = u.reshape(level.N, -1) @ V_dev.T
        else:
            u_nodal = u.reshape(level.N, 1)
        m = lambda i, j: j * level.Ni + i
        ic, jc = level.Ni // 2, level.Nj // 2
        if not is_fvm:
            ns = level.N_sol["u"]
            return jnp.stack([
                jnp.abs(u_nodal[m(ic - 1, jc - 1), -1]),
                jnp.abs(u_nodal[m(ic, jc - 1), -1 - ns]),
                jnp.abs(u_nodal[m(ic - 1, jc), ns]),
                jnp.abs(u_nodal[m(ic, jc), 0]),
            ])
        return jnp.stack([jnp.abs(u_nodal[m(ic - 1, jc - 1), 0]),
                          jnp.abs(u_nodal[m(ic, jc - 1), 0]),
                          jnp.abs(u_nodal[m(ic - 1, jc), 0]),
                          jnp.abs(u_nodal[m(ic, jc), 0])])

    TX, TY = np.meshgrid(theta, theta, indexing="ij")
    amps = jax.jit(jax.vmap(one_mode))(jnp.asarray(TX.ravel()),
                                       jnp.asarray(TY.ravel()))
    amps = np.asarray(amps).reshape(n_theta, n_theta, 4)
    out = {"theta": theta}
    for q in range(4):
        A = amps[:, :, q]
        out[f"A{q+1}"] = A
        print(f"np.min(A{q+1})={A.min()}")
        print(f"np.max(A{q+1})={A.max()}")
    if export:
        os.makedirs(results_dir, exist_ok=True)
        np.savez(os.path.join(results_dir, "amplification.npz"), **out)
        try:
            from dgtpu.visualization import (plot_amplification_factor,
                                             plot_amplification_quadrants)
            for q in range(4):
                plot_amplification_factor(out[f"A{q+1}"], theta, theta,
                                          results_dir, suffix=str(q))
            # the reference's four-quadrant deliverable layout
            # (relaxation.py:55-68): all four center-element factors in one
            # figure
            plot_amplification_quadrants(out, theta, results_dir)
        except Exception:
            pass
    return out
