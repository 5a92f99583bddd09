"""Stokes pressure-robust SIP-DG assembly and solvers.

Reference: ``dgfem/discrete_system.py:405-1029`` (local + global order
assembly), ``dgfem/relaxation.py:220-441`` (distributive Gauss-Seidel),
``utils/helpers.py:41-80`` (DOF reorderings), ``dgfem/dgfem.py:170-186``
(pressure mean shift), ``dgfem/grid.py:227-269`` (MMS Epsilon).

Local ordering packs one (2*Nu + Np) block per element: [u-modes, v-modes,
p-modes].  Global ordering keeps component stencils (A as 2x2 of Nu-blocks,
D as Np x Nu, G as Nu x Np) composed into a saddle operator [[A, G], [D, 0]];
derived operators needed by the distributive smoother (D@G, Schur) are
materialized dense — at the reference's scales dense matmuls are the fast
layout.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from dgtpu.utils.jitting import const_jit
import numpy as np

from dgtpu.models.faces import (FaceData, continuity_dirichlet_rhs,
                                continuity_surface, pressure_dirichlet_rhs,
                                pressure_surface, sip_dirichlet_rhs, sip_terms,
                                velocity_penalty_dirichlet_rhs,
                                velocity_penalty_surface)
from dgtpu.models.poisson import (_vol_table, mass_matrices,
                                  source_volume_rhs, volume_laplace)
from dgtpu.ops.linalg import host_inv
from dgtpu.ops.stencil import StencilOperator, stencil_from_contributions
from dgtpu.utils.norms import lp_norm


# --------------------------------------------------------------------------
# volume kernels (element.py:151-231)
# --------------------------------------------------------------------------

def _grad_basis(level, var_basis, var_quad, gt):
    """G_x, G_y of a basis at a quadrature: (N, nq2, B) each.  Per-element
    tables when the physical-element orthonormal basis is active."""
    q = level.quad
    g = gt[var_quad]["e"]
    Vr = _vol_table(level, q.Vr_sol_int[var_basis][var_quad], var_basis)
    Vs = _vol_table(level, q.Vs_sol_int[var_basis][var_quad], var_basis)
    Gx = Vr * g["rx"][:, :, None] + Vs * g["sx"][:, :, None]
    Gy = Vr * g["ry"][:, :, None] + Vs * g["sy"][:, :, None]
    return Gx, Gy


def continuity_volume(level, gt):
    """-int q div(u): (N, Np, 2Nu) (element.py:169-179)."""
    q = level.quad
    Gx, Gy = _grad_basis(level, "u", "p", gt)
    Vp = _vol_table(level, q.V_sol_int["p"]["p"], "p")
    wJ = gt["p"]["e"]["J"] * jnp.asarray(q.w_int_2d["p"])[None, :]
    res_u = -jnp.einsum("nqi,nq,nqk->nki", Gx, wJ, Vp)
    res_v = -jnp.einsum("nqi,nq,nqk->nki", Gy, wJ, Vp)
    return jnp.concatenate([res_u, res_v], axis=2)


def pressure_volume(level, gt):
    """-int p div(psi): (N, 2Nu, Np) (element.py:201-211)."""
    q = level.quad
    Gx, Gy = _grad_basis(level, "u", "u", gt)
    Vp = _vol_table(level, q.V_sol_int["p"]["u"], "p")
    wJ = gt["u"]["e"]["J"] * jnp.asarray(q.w_int_2d["u"])[None, :]
    res_x = -jnp.einsum("nqi,nq,nqk->nki", Vp, wJ, Gx)
    res_y = -jnp.einsum("nqi,nq,nqk->nki", Vp, wJ, Gy)
    return jnp.concatenate([res_x, res_y], axis=1)


def velocity_penalty_volume(level, gt):
    """gamma int div(u) div(psi): (N, 2Nu, 2Nu) (element.py:213-231)."""
    q = level.quad
    Gx, Gy = _grad_basis(level, "u", "u", gt)
    wJ = gt["u"]["e"]["J"] * jnp.asarray(q.w_int_2d["u"])[None, :]
    gamma = level.gamma

    def blk(Ga, Gb):
        return gamma * jnp.einsum("nqi,nq,nqk->nki", Ga, wJ, Gb)

    top = jnp.concatenate([blk(Gx, Gx), blk(Gy, Gx)], axis=2)
    bot = jnp.concatenate([blk(Gx, Gy), blk(Gy, Gy)], axis=2)
    return jnp.concatenate([top, bot], axis=1)


def _expand_2x2_diag(blocks):
    """Scalar (F, B, B) -> velocity-block-diagonal (F, 2B, 2B) (face.py:174-178)."""
    F, B, _ = blocks.shape
    z = jnp.zeros_like(blocks)
    top = jnp.concatenate([blocks, z], axis=2)
    bot = jnp.concatenate([z, blocks], axis=2)
    return jnp.concatenate([top, bot], axis=1)


# --------------------------------------------------------------------------
# assembly
# --------------------------------------------------------------------------

def _element_blocks(level, gt):
    """All Stokes per-element/per-face blocks gathered into stencil slots.

    Returns dict of (N, 5, rows, cols) arrays for the A (2Nux2Nu),
    D (Npx2Nu) and G (2Nux Np) parts.
    """
    s = level.settings
    nu = s.problem.kinematic_viscosity
    # physical-element orthonormal bases for BOTH u and p when enabled
    # (beyond the reference, whose transform is u-only and whose Stokes
    # path is explicitly unimplemented: element.py:32 "not yet transformed
    # to multiple variables u,v,p")
    from dgtpu.ops.orthonormal import element_bases
    eb = element_bases(level, gt=gt, vars=("u", "p"))
    fd_i_u = FaceData(level, level.faces_i, "u", gt=gt, element_basis=eb)
    fd_j_u = FaceData(level, level.faces_j, "u", gt=gt, element_basis=eb)
    fd_i_p = FaceData(level, level.faces_i, "p", gt=gt, element_basis=eb)
    fd_j_p = FaceData(level, level.faces_j, "p", gt=gt, element_basis=eb)

    def per_direction(fd_u, fd_p):
        sip = [_expand_2x2_diag(b) for b in sip_terms(fd_u, nu, level.sigma)]
        vp = velocity_penalty_surface(fd_u, level.gamma)
        A4 = [a + b for a, b in zip(sip, vp)]
        D4 = continuity_surface(fd_p, level.N_DOF_sol["u"])
        G4 = pressure_surface(fd_u, level.N_DOF_sol["u"])
        return A4, D4, G4

    Ai, Di, Gi = per_direction(fd_i_u, fd_i_p)
    Aj, Dj, Gj = per_direction(fd_j_u, fd_j_p)

    fi_min, fi_max = level.faces_i.f_min, level.faces_i.f_max
    fj_min, fj_max = level.faces_j.f_min, level.faces_j.f_max

    def slots(vol, four_i, four_j):
        LL_i, LR_i, RL_i, RR_i = four_i
        LL_j, LR_j, RL_j, RR_j = four_j
        diag = vol + RR_i[fi_min] + LL_i[fi_max] + RR_j[fj_min] + LL_j[fj_max]
        return jnp.stack([diag, RL_i[fi_min], LR_i[fi_max],
                          RL_j[fj_min], LR_j[fj_max]], axis=1)

    vol_A = (_expand_2x2_diag(volume_laplace(level, gt=gt))
             + velocity_penalty_volume(level, gt))
    out = {
        "A": slots(vol_A, Ai, Aj),
        "D": slots(continuity_volume(level, gt), Di, Dj),
        "G": slots(pressure_volume(level, gt), Gi, Gj),
        "fd": (fd_i_u, fd_j_u, fd_i_p, fd_j_p),
    }
    return out


def _mask_blocks(blocks, mask):
    return jnp.where(mask[:, :, None, None], blocks, 0.0)


@jax.tree_util.register_pytree_node_class
@dataclass
class StokesGlobalOperator:
    """Saddle operator [[A, G], [D, 0]] on globally ordered vectors [u; v; p].

    Component stencils keep the 5-point structure; ``pin`` adds the single
    pressure-DOF pin used for direct solves (discrete_system.py:742).
    """

    A: StencilOperator       # (N, 5, 2Nu, 2Nu)
    D: StencilOperator       # (N, 5, Np, 2Nu)
    G: StencilOperator       # (N, 5, 2Nu, Np)
    pin: bool

    def tree_flatten(self):
        return (self.A, self.D, self.G), (self.pin,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, pin=aux[0])

    @property
    def sizes(self):
        n = self.A.n_elem
        nu2 = self.A.block_shape[0]
        npp = self.D.block_shape[0]
        return n, nu2 // 2, npp

    @property
    def shape(self):
        n, nu, npp = self.sizes
        tot = n * (2 * nu + npp)
        return (tot, tot)

    def split(self, x):
        n, nu, npp = self.sizes
        return x[:2 * n * nu], x[2 * n * nu:]

    def matvec(self, x):
        n, nu, npp = self.sizes
        uv_g, p = self.split(x)
        # global [all u; all v] -> per-element interleaved (N, 2Nu) for stencils
        uv = _global_uv_to_elem(uv_g, n, nu)
        mom = self.A.matvec(uv) + self.G.matvec(p)
        cont = self.D.matvec(uv)
        if self.pin:
            cont = cont.at[0].add(p[0])
        return jnp.concatenate([_elem_uv_to_global(mom, n, nu), cont])

    def to_dense(self):
        n, nu, npp = self.sizes
        A = self.A.to_dense()
        D = self.D.to_dense()
        G = self.G.to_dense()
        P = _uv_permutation(n, nu)          # elem-interleaved -> global
        A_g = P @ A @ P.T
        D_g = D @ P.T
        G_g = P @ G
        Z = jnp.zeros((n * npp, n * npp), dtype=A.dtype)
        if self.pin:
            Z = Z.at[0, 0].set(1.0)
        top = jnp.concatenate([A_g, G_g], axis=1)
        bot = jnp.concatenate([D_g, Z], axis=1)
        return jnp.concatenate([top, bot], axis=0)


def _uv_permutation(n, nu):
    """Permutation matrix mapping element-interleaved (u_e, v_e) to global [u; v]."""
    idx = np.zeros(2 * n * nu, dtype=np.int64)
    for e in range(n):
        idx[e * nu:(e + 1) * nu] = np.arange(e * 2 * nu, e * 2 * nu + nu)
        idx[n * nu + e * nu:n * nu + (e + 1) * nu] = \
            np.arange(e * 2 * nu + nu, (e + 1) * 2 * nu)
    P = np.zeros((2 * n * nu, 2 * n * nu))
    P[np.arange(2 * n * nu), idx] = 1.0
    return jnp.asarray(P)


def _global_uv_to_elem(uv_g, n, nu):
    u = uv_g[:n * nu].reshape(n, nu)
    v = uv_g[n * nu:].reshape(n, nu)
    return jnp.concatenate([u, v], axis=1).reshape(-1)


def _elem_uv_to_global(uv_e, n, nu):
    uv = uv_e.reshape(n, 2 * nu)
    return jnp.concatenate([uv[:, :nu].reshape(-1), uv[:, nu:].reshape(-1)])


def assemble_stokes(level, mms=None, direct=False):
    """Assemble the Stokes system on a level (both orderings).

    Local order: ``level.op`` is one StencilOperator of block size 2Nu+Np
    (discrete_system.py:812-965).  Global order: ``level.op`` is a
    StokesGlobalOperator and the component stencils are stored on the level
    (block_A/D/G) for the distributive smoother (discrete_system.py:416-745).
    ``level.rhs`` is stored in the operator's own ordering.
    """
    from dgtpu.utils.caching import load_stokes_parts, save_stokes_parts
    from dgtpu.ops.orthonormal import element_bases
    s = level.settings
    # construct (or clear) the per-element basis transforms up front so a
    # parts-cache hit still leaves them available to error evaluation,
    # mean shift, and VTK export
    element_bases(level, vars=("u", "p"))
    mask = jnp.asarray(level.nbr_mask)
    nbr = jnp.asarray(level.nbr, dtype=jnp.int32)
    rhs_local = None
    cached = load_stokes_parts(level)
    # the cache holds the ordering-independent pieces; require a cached rhs
    # whenever this call needs one (mms given) so we never skip RHS assembly
    if cached is not None and (mms is None or cached[3] is not None):
        A_blocks, D_blocks, G_blocks, rhs_local, eps = cached
        level.Epsilon = eps if eps is not None else 0.0
        parts = None
    else:
        gt = level.gt
        parts = _element_blocks(level, gt)
        A_blocks = _mask_blocks(parts["A"], mask)
        D_blocks = _mask_blocks(parts["D"], mask)
        G_blocks = _mask_blocks(parts["G"], mask)
    nu_dof = level.N_DOF_sol["u"]
    np_dof = level.N_DOF_sol["p"]

    ordering = s.solution.ordering
    if ordering == "global":
        level.block_A = StencilOperator(A_blocks, nbr, mask)
        level.block_D = StencilOperator(D_blocks, nbr, mask)
        level.block_G = StencilOperator(G_blocks, nbr, mask)
        level.op = StokesGlobalOperator(level.block_A, level.block_D,
                                        level.block_G, pin=direct)
    else:
        B = 2 * nu_dof + np_dof
        blocks = jnp.zeros((level.N, 5, B, B))
        blocks = blocks.at[:, :, :2 * nu_dof, :2 * nu_dof].set(A_blocks)
        blocks = blocks.at[:, :, 2 * nu_dof:, :2 * nu_dof].set(D_blocks)
        blocks = blocks.at[:, :, :2 * nu_dof, 2 * nu_dof:].set(G_blocks)
        if direct:
            # pin one pressure DOF (discrete_system.py:946)
            blocks = blocks.at[0, 0, 2 * nu_dof, 2 * nu_dof].set(1.0)
        level.op = StencilOperator(blocks, nbr, mask)

    if parts is not None:
        compute_mms_epsilon(level, mms)
        if mms is not None:
            rhs_local = assemble_rhs_stokes(level, mms, parts["fd"])
        save_stokes_parts(level, A_blocks, D_blocks, G_blocks, rhs_local,
                          level.Epsilon)
    if rhs_local is not None:
        level.rhs = (reorder_local_to_global(level, rhs_local)
                     if ordering == "global" else rhs_local)
    return level.op


def assemble_rhs_stokes(level, mms, fds):
    """MMS right-hand side in local ordering (discrete_system.py:967-1029)."""
    s = level.settings
    nu = s.problem.kinematic_viscosity
    gt = level.gt
    nu_dof = level.N_DOF_sol["u"]
    np_dof = level.N_DOF_sol["p"]
    fd_i_u, fd_j_u, fd_i_p, fd_j_p = fds

    gu = gt["u"]["e"]
    gp = gt["p"]["e"]
    fx = mms.f_momentum[0](gu["x"], gu["y"])
    fy = mms.f_momentum[1](gu["x"], gu["y"])
    rhs_u = source_volume_rhs(level, fx, gt=gt)
    rhs_v = source_volume_rhs(level, fy, gt=gt)
    # continuity source: -int q f_cont at p-quad (element.py:158-159)
    Vp = _vol_table(level, level.quad.V_sol_int["p"]["p"], "p")
    wJp = gp["J"] * jnp.asarray(level.quad.w_int_2d["p"])[None, :]
    f_cont = mms.f_continuity(gp["x"], gp["y"])
    rhs_p = -jnp.einsum("nqi,nq,nq->ni", Vp, wJp, f_cont)

    include_p_bc = s.problem.include_pressure_BC
    for fd_u, fd_p, topo in ((fd_i_u, fd_i_p, level.faces_i),
                             (fd_j_u, fd_j_p, level.faces_j)):
        if topo.periodic:
            continue
        # boundary data at u-quad traces
        gmin_u = (mms.u(fd_u.x_R, fd_u.y_R), mms.v(fd_u.x_R, fd_u.y_R))
        gmax_u = (mms.u(fd_u.x_L, fd_u.y_L), mms.v(fd_u.x_L, fd_u.y_L))
        # ... and at p-quad traces
        gmin_p = (mms.u(fd_p.x_R, fd_p.y_R), mms.v(fd_p.x_R, fd_p.y_R))
        gmax_p = (mms.u(fd_p.x_L, fd_p.y_L), mms.v(fd_p.x_L, fd_p.y_L))

        bmin = jnp.asarray(~topo.has_L, dtype=rhs_u.dtype)[:, None]
        bmax = jnp.asarray(~topo.has_R, dtype=rhs_u.dtype)[:, None]

        c_min, c_max = continuity_dirichlet_rhs(fd_p, gmin_p, gmax_p)
        rhs_p = rhs_p.at[topo.eR].add(c_min * bmin)
        rhs_p = rhs_p.at[topo.eL].add(c_max * bmax)

        pu_min, pu_max = sip_dirichlet_rhs(fd_u, nu, level.sigma,
                                           gmin_u[0], gmax_u[0])
        pv_min, pv_max = sip_dirichlet_rhs(fd_u, nu, level.sigma,
                                           gmin_u[1], gmax_u[1])
        rhs_u = rhs_u.at[topo.eR].add(pu_min * bmin)
        rhs_u = rhs_u.at[topo.eL].add(pu_max * bmax)
        rhs_v = rhs_v.at[topo.eR].add(pv_min * bmin)
        rhs_v = rhs_v.at[topo.eL].add(pv_max * bmax)

        vp_min, vp_max = velocity_penalty_dirichlet_rhs(fd_u, level.gamma,
                                                        gmin_u, gmax_u)
        rhs_u = rhs_u.at[topo.eR].add(vp_min[:, :nu_dof] * bmin)
        rhs_v = rhs_v.at[topo.eR].add(vp_min[:, nu_dof:] * bmin)
        rhs_u = rhs_u.at[topo.eL].add(vp_max[:, :nu_dof] * bmax)
        rhs_v = rhs_v.at[topo.eL].add(vp_max[:, nu_dof:] * bmax)

        if include_p_bc:
            gp_min = mms.p(fd_u.x_R, fd_u.y_R)
            gp_max = mms.p(fd_u.x_L, fd_u.y_L)
            pb_min, pb_max = pressure_dirichlet_rhs(fd_u, gp_min, gp_max)
            rhs_u = rhs_u.at[topo.eR].add(pb_min[:, :nu_dof] * bmin)
            rhs_v = rhs_v.at[topo.eR].add(pb_min[:, nu_dof:] * bmin)
            rhs_u = rhs_u.at[topo.eL].add(pb_max[:, :nu_dof] * bmax)
            rhs_v = rhs_v.at[topo.eL].add(pb_max[:, nu_dof:] * bmax)

    return jnp.concatenate([rhs_u, rhs_v, rhs_p], axis=1).reshape(-1)


class StokesPolynomialTransfer:
    """p-coarsening transfer on globally ordered Stokes vectors [u; v; p].

    The reference's paramfile notes this 'should be extended with p-levels
    for Stokes multigrid' (input/paramfile.yml:41) but never implements it;
    here each component gets its zero-padded-identity modal restriction
    applied per element.
    """

    kind = "polynomial"

    def __init__(self, N, pu_fine, pu_coarse, pp_fine, pp_coarse):
        import jax.numpy as jnp
        from dgtpu.ops.transfer import p_restriction
        self.N = N
        self.Ru = jnp.asarray(p_restriction(pu_fine, pu_coarse))
        self.Rp = jnp.asarray(p_restriction(pp_fine, pp_coarse))
        self.nu_f, self.nu_c = (pu_fine + 1) ** 2, (pu_coarse + 1) ** 2
        self.np_f, self.np_c = (pp_fine + 1) ** 2, (pp_coarse + 1) ** 2
        # dtype-castable attributes for the bench fast path
        self.R = self.Ru
        self.P = self.Ru.T

    def _split(self, vec, nu, npd):
        n = self.N
        return (vec[:n * nu].reshape(n, nu),
                vec[n * nu:2 * n * nu].reshape(n, nu),
                vec[2 * n * nu:].reshape(n, npd))

    def restrict(self, vec):
        import jax.numpy as jnp
        u, v, p = self._split(vec, self.nu_f, self.np_f)
        return jnp.concatenate([
            (u @ self.Ru.T).reshape(-1), (v @ self.Ru.T).reshape(-1),
            (p @ self.Rp.T).reshape(-1)])

    def prolong(self, vec):
        import jax.numpy as jnp
        u, v, p = self._split(vec, self.nu_c, self.np_c)
        return jnp.concatenate([
            (u @ self.Ru).reshape(-1), (v @ self.Ru).reshape(-1),
            (p @ self.Rp).reshape(-1)])


class StokesGeometricTransfer:
    """Geometric (h) coarsening transfer on globally ordered Stokes vectors.

    New capability beyond the reference (its CoarseElement sampling is
    Poisson-only, element.py:314): each component restricts/prolongs with
    the scalar L2-projection agglomeration operator of its own degree,
    applied through the same tile machinery as the Poisson path.  This is
    what keeps the coarsest Stokes level *small* at large element counts —
    the p-hierarchy bottoms out at p_u=1 on the fine element grid, where a
    dense coarse solve stops scaling and a 10-sweep coarse smoother is too
    weak (divergence observed at 32x32 in round 2).
    """

    kind = "geometric"

    def __init__(self, Ni_c, Nj_c, pu, pp, cf=2):
        from dgtpu.ops.transfer import make_transfer
        self.tu = make_transfer("geometric", p_fine=pu, Ni_c=Ni_c, Nj_c=Nj_c,
                                cf=cf)
        self.tp = make_transfer("geometric", p_fine=pp, Ni_c=Ni_c, Nj_c=Nj_c,
                                cf=cf)
        self.N_f = Ni_c * Nj_c * cf * cf
        self.N_c = Ni_c * Nj_c
        self.cf = cf
        self.nu = (pu + 1) ** 2
        self.npd = (pp + 1) ** 2
        # dtype-castable attributes for the bench fast path
        self.R, self.P = self.tu.R, self.tu.P

    def _split(self, vec, n):
        nu, npd = self.nu, self.npd
        return (vec[:n * nu], vec[n * nu:2 * n * nu], vec[2 * n * nu:])

    def restrict(self, vec):
        import jax.numpy as jnp
        u, v, p = self._split(vec, self.N_f)
        return jnp.concatenate([self.tu.restrict(u), self.tu.restrict(v),
                                self.tp.restrict(p)])

    def prolong(self, vec):
        import jax.numpy as jnp
        u, v, p = self._split(vec, self.N_c)
        return jnp.concatenate([self.tu.prolong(u), self.tu.prolong(v),
                                self.tp.prolong(p)])


# --------------------------------------------------------------------------
# reorderings, pressure postprocessing, Epsilon
# --------------------------------------------------------------------------

def reorder_local_to_global(level, vec):
    """[per-element u,v,p] -> [all u; all v; all p] (helpers.py:60-80)."""
    n = level.N
    nu, npd = level.N_DOF_sol["u"], level.N_DOF_sol["p"]
    m = vec.reshape(n, 2 * nu + npd)
    return jnp.concatenate([m[:, :nu].reshape(-1), m[:, nu:2 * nu].reshape(-1),
                            m[:, 2 * nu:].reshape(-1)])


def reorder_global_to_local(level, vec):
    """[all u; all v; all p] -> [per-element u,v,p] (helpers.py:41-58)."""
    n = level.N
    nu, npd = level.N_DOF_sol["u"], level.N_DOF_sol["p"]
    u = vec[:n * nu].reshape(n, nu)
    v = vec[n * nu:2 * n * nu].reshape(n, nu)
    p = vec[2 * n * nu:].reshape(n, npd)
    return jnp.concatenate([u, v, p], axis=1).reshape(-1)


def pressure_integral(level, p_modal):
    """int p dA per element batch (element.py:151-153); p_modal (N, Np)."""
    gt = level.gt
    Vp = _vol_table(level, level.quad.V_sol_int["p"]["p"], "p")
    wJ = gt["p"]["e"]["J"] * jnp.asarray(level.quad.w_int_2d["p"])[None, :]
    p_int = jnp.einsum("nqi,ni->nq", Vp, p_modal)
    return jnp.sum(p_int * wJ, axis=1)


def pressure_mean_shift(level, u_el):
    """Subtract the numerical pressure mean (dgfem.py:170-186).

    The mode-(0,0) coefficient shift is 2*mean since phi_00 = 1/2; under
    the physical-element orthonormal p basis the constant mode is
    norms_e0 * 1/2 per element, so the shift divides by norms_e0.
    """
    npd = level.N_DOF_sol["p"]
    p_modal = u_el[:, -npd:]
    mean = jnp.sum(pressure_integral(level, p_modal)) / jnp.sum(level.gt["A"])
    shift = -2.0 * mean
    eb_p = (getattr(level, "element_basis", None) or {}).get("p")
    if eb_p is not None:
        shift = shift / eb_p.norms[:, 0]
    return u_el.at[:, -npd].add(shift)


def compute_mms_epsilon(level, mms):
    """Global mass-defect constant Epsilon (grid.py:227-269)."""
    if mms is None or mms.f_continuity is None:
        level.Epsilon = 0.0
        return 0.0
    if not level.settings.solution.manufactured_solution:
        level.Epsilon = 0.0
        return 0.0
    gt = level.gt
    gp = gt["p"]["e"]
    wJ = gp["J"] * jnp.asarray(level.quad.w_int_2d["p"])[None, :]
    f_int = jnp.sum(mms.f_continuity(gp["x"], gp["y"]) * wJ)
    # boundary integral of u.n (outward; the L-boundary uses -n_R as in
    # face.py:69-77)
    u_dot_n = 0.0
    for topo in (level.faces_i, level.faces_j):
        if topo.periodic:
            continue
        fd = FaceData(level, topo, "p")
        gu_min = (mms.u(fd.x_R, fd.y_R), mms.v(fd.x_R, fd.y_R))
        gu_max = (mms.u(fd.x_L, fd.y_L), mms.v(fd.x_L, fd.y_L))
        gn_min = gu_min[0] * fd.mt_R["nx"] + gu_min[1] * fd.mt_R["ny"]
        gn_max = gu_max[0] * fd.mt_L["nx"] + gu_max[1] * fd.mt_L["ny"]
        bmin = jnp.asarray(~topo.has_L, dtype=gn_min.dtype)
        bmax = jnp.asarray(~topo.has_R, dtype=gn_min.dtype)
        u_dot_n += jnp.sum(-bmin[:, None] * gn_min * fd.wJ)
        u_dot_n += jnp.sum(bmax[:, None] * gn_max * fd.wJ)
    A = jnp.sum(gt["A"])
    level.Epsilon = float((f_int - u_dot_n) / A)
    return level.Epsilon


# --------------------------------------------------------------------------
# distributive Gauss-Seidel (relaxation.py:220-441)
# --------------------------------------------------------------------------

def _dense_sym_bgs(A, Dinv, b, x, blocksize):
    from dgtpu.ops.stencil import dense_block_gs_sweep
    x = dense_block_gs_sweep(A, b, x, blocksize, backward=False, Dinv=Dinv)
    x = dense_block_gs_sweep(A, b, x, blocksize, backward=True, Dinv=Dinv)
    return x


class DistributiveGS:
    """Distributive GS smoother state for a global-order Stokes level.

    Materializes the dense A, D, G, D@G (and Schur pieces for the classical
    splittings) once; each ``sweep`` is a fixed sequence of dense matmuls and
    block-GS sweeps — one jittable graph.
    """

    def __init__(self, level, splitting="lsq"):
        if level.block_A is None:
            raise ValueError("Distributive GS needs a global-order Stokes assembly")
        self.level = level
        self.splitting = splitting
        n, nu = level.N, level.N_DOF_sol["u"]
        npd = level.N_DOF_sol["p"]
        self.n, self.nu, self.npd = n, nu, npd
        P = _uv_permutation(n, nu)
        self.A = np.asarray(P @ level.block_A.to_dense() @ P.T)
        self.D = np.asarray(level.block_D.to_dense() @ P.T)
        self.G = np.asarray(P @ level.block_G.to_dense())
        self.A_Dinv = self._block_diag_inv(self.A, nu)
        if splitting == "lsq":
            self.DG = self.D @ self.G
            self.DG_Dinv = self._block_diag_inv(self.DG, npd)
        elif splitting in ("classical", "classical_exact"):
            if splitting == "classical":
                A_D = self._block_diag(self.A, nu)
                Ainv = np.linalg.inv(A_D)
                self.A_D = A_D
                self.A_D_Dinv = self._block_diag_inv(A_D, nu)
            else:
                Ainv = np.linalg.inv(self.A)
            self.Schur = -self.D @ Ainv @ self.G
            self.Schur_Dinv = self._block_diag_inv(self.Schur, npd)
        self._to_dev()

    @staticmethod
    def _block_diag(A, B):
        out = np.zeros_like(A)
        for e in range(A.shape[0] // B):
            sl = slice(e * B, (e + 1) * B)
            out[sl, sl] = A[sl, sl]
        return out

    @staticmethod
    def _block_diag_inv(A, B):
        n = A.shape[0] // B
        blocks = np.stack([np.linalg.inv(A[e * B:(e + 1) * B, e * B:(e + 1) * B])
                           for e in range(n)])
        return blocks

    def _to_dev(self):
        for k in ("A", "D", "G", "A_Dinv"):
            setattr(self, k, jnp.asarray(getattr(self, k)))
        for k in ("DG", "DG_Dinv", "Schur", "Schur_Dinv", "A_D", "A_D_Dinv"):
            if hasattr(self, k):
                setattr(self, k, jnp.asarray(getattr(self, k)))

    def sweep(self, rhs, x):
        """One distributive GS iteration on the global vector [u; v; p]."""
        n, nu, npd = self.n, self.nu, self.npd
        idx_u = 2 * n * nu
        u_k, p_k = x[:idx_u], x[idx_u:]
        f_mom, f_cont = rhs[:idx_u], rhs[idx_u:]
        rhs_mom = f_mom - self.A @ u_k - self.G @ p_k
        if self.splitting == "lsq":
            du_s = _dense_sym_bgs(self.A, self.A_Dinv, rhs_mom,
                                  jnp.zeros_like(u_k), nu)
            rhs_cont = f_cont - self.D @ (u_k + du_s)
            dp_s = _dense_sym_bgs(self.DG, self.DG_Dinv, rhs_cont,
                                  jnp.zeros_like(p_k), npd)
            du = du_s + self.G @ dp_s
            rhs_dg = -self.D @ (self.A @ (self.G @ dp_s))
            dp = _dense_sym_bgs(self.DG, self.DG_Dinv, rhs_dg,
                                jnp.zeros_like(p_k), npd)
        elif self.splitting == "classical":
            # reference note (relaxation.py:286): this splitting diverges when
            # the Schur complement uses the block-diagonal A inverse; kept for
            # behavioral parity, use 'classical_exact' or 'lsq' to converge.
            du_s = _dense_sym_bgs(self.A_D, self.A_D_Dinv, rhs_mom,
                                  jnp.zeros_like(u_k), nu)
            rhs_cont = f_cont - self.D @ (u_k + du_s)
            dp_s = _dense_sym_bgs(self.Schur, self.Schur_Dinv, rhs_cont,
                                  jnp.zeros_like(p_k), npd)
            rhs_a = self.A @ du_s - self.G @ dp_s
            du = _dense_sym_bgs(self.A, self.A_Dinv, rhs_a,
                                jnp.zeros_like(u_k), nu)
            dp = dp_s
        elif self.splitting == "classical_exact":
            # relaxation.py:400-438 with the exact Schur complement
            du_s = _dense_sym_bgs(self.A, self.A_Dinv, rhs_mom,
                                  jnp.zeros_like(u_k), nu)
            rhs_cont = f_cont - self.D @ (u_k + du_s)
            dp_s = _dense_sym_bgs(self.Schur, self.Schur_Dinv, rhs_cont,
                                  jnp.zeros_like(p_k), npd)
            rhs_a = self.A @ du_s - self.G @ dp_s
            du = _dense_sym_bgs(self.A, self.A_Dinv, rhs_a,
                                jnp.zeros_like(u_k), nu)
            dp = dp_s
        else:
            raise ValueError(self.splitting)
        return jnp.concatenate([u_k + du, p_k + dp])


class StencilDGS:
    """lsq-splitting distributive GS in 5-point stencil (rolled) form.

    Single-chip counterpart of ``parallel/stokes_halo._dgs_sweep``: the same
    algorithm with the j-halo ppermute exchanges replaced by rolled-layout
    shifts.  Nothing dense is ever materialized — round-1's DistributiveGS
    built dense A and D@G at O((N*B)^2), which caps the reachable problem
    size; here DG applies as two composed stencil matvecs and only the
    per-element diagonal blocks are inverted (host LAPACK at setup).

    Component solves are red-black colored block-GS passes — the documented
    parallel deviation from the reference's lexicographic dense sweeps
    (relaxation.py:220-441); the dense sequential form remains available as
    ``splitting='lsq_dense'``.
    """

    def __init__(self, level, n_pass=2):
        from dgtpu.ops import rolled
        from dgtpu.ops.linalg import host_inv
        from dgtpu.parallel.stokes_halo import _dg_diag_blocks
        if level.block_A is None:
            raise ValueError("Distributive GS needs a global-order Stokes assembly")
        self.n, self.nu = level.N, level.N_DOF_sol["u"]
        self.npd = level.N_DOF_sol["p"]
        self.Ni, self.Nj = level.Ni, level.Nj
        self.n_pass = n_pass
        Ni, Nj = self.Ni, self.Nj
        self.A = rolled.to_rolled(level.block_A, Ni, Nj)
        self.D = rolled.to_rolled(level.block_D, Ni, Nj)
        self.G = rolled.to_rolled(level.block_G, Ni, Nj)
        self.A_Dinv = host_inv(self.A[:, :, 0])
        dg_diag = _dg_diag_blocks(level.block_D, level.block_G)
        self.DG_diag = jnp.asarray(dg_diag).reshape(Nj, Ni, self.npd, self.npd)
        self.DG_Dinv = host_inv(self.DG_diag)
        self.colors = rolled.checkerboard(Nj, Ni)

    def _bgs(self, blocks, Dinv, rhs, x):
        from dgtpu.ops import rolled
        for _ in range(self.n_pass):
            for c in (0, 1):
                off = rolled.offdiag_matvec(blocks, x)
                xn = rolled.bmv(Dinv, rhs - off)
                x = jnp.where((self.colors == c)[:, :, None], xn, x)
        return x

    def _bgs_dg(self, rhs, p):
        from dgtpu.ops import rolled
        for _ in range(self.n_pass):
            for c in (0, 1):
                off = (rolled.matvec(self.D, rolled.matvec(self.G, p))
                       - rolled.bmv(self.DG_diag, p))
                pn = rolled.bmv(self.DG_Dinv, rhs - off)
                p = jnp.where((self.colors == c)[:, :, None], pn, p)
        return p

    def sweep(self, rhs, x):
        """One distributive GS iteration on the global vector [u; v; p]."""
        from dgtpu.ops import rolled
        n, nu, npd = self.n, self.nu, self.npd
        Nj, Ni = self.Nj, self.Ni
        idx_u = 2 * n * nu
        uv = _global_uv_to_elem(x[:idx_u], n, nu).reshape(Nj, Ni, 2 * nu)
        p = x[idx_u:].reshape(Nj, Ni, npd)
        f_mom = _global_uv_to_elem(rhs[:idx_u], n, nu).reshape(Nj, Ni, 2 * nu)
        f_cont = rhs[idx_u:].reshape(Nj, Ni, npd)

        rhs_mom = f_mom - rolled.matvec(self.A, uv) - rolled.matvec(self.G, p)
        du_s = self._bgs(self.A, self.A_Dinv, rhs_mom, jnp.zeros_like(uv))
        rhs_cont = f_cont - rolled.matvec(self.D, uv + du_s)
        dp_s = self._bgs_dg(rhs_cont, jnp.zeros_like(p))
        G_dp = rolled.matvec(self.G, dp_s)
        du = du_s + G_dp
        rhs_dg = -rolled.matvec(self.D, rolled.matvec(self.A, G_dp))
        dp = self._bgs_dg(rhs_dg, jnp.zeros_like(p))

        uv_g = _elem_uv_to_global((uv + du).reshape(-1), n, nu)
        return jnp.concatenate([uv_g, (p + dp).reshape(-1)])


def make_dgs(level, splitting="lsq"):
    """Distributive-GS smoother factory.

    ``lsq`` (the reference default) runs in stencil/rolled form with no
    dense operators; ``lsq_dense`` keeps round-1's dense sequential-sweep
    variant (parity/testing); the ``classical*`` Schur splittings are
    structurally dense (they need (an approximation of) A^-1).
    """
    if splitting == "lsq":
        return StencilDGS(level)
    if splitting == "lsq_dense":
        return DistributiveGS(level, splitting="lsq")
    return DistributiveGS(level, splitting=splitting)


def distributive_gauss_seidel_solve(level, rhs, u0=None, splitting="lsq",
                                    max_iterations=1000, tol=1e-6, div_tol=1e10):
    """Residual-tracked distributive GS solve (relaxation.py:236-283).

    Returns (u, residual_history, n, status) with status 0/1/2 as in the
    relaxation driver.
    """
    dgs = make_dgs(level, splitting)
    op = level.op
    if u0 is None:
        u0 = jnp.zeros_like(rhs)
    max_iterations = int(min(max_iterations, 100000))
    hist_len = min(max_iterations, 20000)

    @const_jit
    def run(rhs, u0):
        res0 = lp_norm(rhs - op.matvec(u0), 2)
        hist0 = jnp.full((hist_len,), jnp.nan, dtype=rhs.dtype)

        def cond(state):
            n, u, res, hist = state
            return (n < max_iterations) & (res >= tol) & (res <= div_tol) & jnp.isfinite(res)

        def body(state):
            n, u, res, hist = state
            u = dgs.sweep(rhs, u)
            res = lp_norm(rhs - op.matvec(u), 2) / res0
            hist = jnp.where(n < hist_len, hist.at[jnp.minimum(n, hist_len - 1)].set(res), hist)
            return n + 1, u, res, hist

        n0 = jnp.asarray(0, dtype=jnp.int64 if rhs.dtype == jnp.float64 else jnp.int32)
        res_init = lp_norm(rhs - op.matvec(u0), 2) / res0
        n, u, res, hist = jax.lax.while_loop(cond, body, (n0, u0, res_init, hist0))
        # NaN residual must map to diverged (2), not max-iterations (1)
        status = jnp.where(res < tol, 0,
                           jnp.where((res > div_tol) | ~jnp.isfinite(res), 2, 1))
        return u, hist, n, status

    return run(rhs, u0)
