"""Sharded Stokes multigrid: distributive GS smoothing over a device mesh.

The reference has no parallel code at all (SURVEY §2); its Stokes multigrid
path configures a *dense* distributive Gauss-Seidel smoother
(``dgfem/relaxation.py:220-441``) which we re-derived in
``dgtpu.models.stokes.DistributiveGS``.  This module is the multi-chip
re-design: the same ``lsq``-splitting algorithm expressed purely in terms of
5-point *stencil* applications so every step shards over an element-domain
decomposition (j-banded, like ``dgtpu.parallel.halo``):

    momentum   A  : (N, 5, 2Nu, 2Nu)  velocity -> velocity
    gradient   G  : (N, 5, 2Nu, Np)   pressure -> momentum rows
    divergence D  : (N, 5, Np, 2Nu)   velocity -> continuity rows
    DG = D @ G    : 13-point operator, applied as two stencil matvecs
                    (two halo exchanges) — never materialized.

One DGS sweep is a fixed sequence of stencil matvecs + red-black colored
block-GS passes; the only communication is one-row ``lax.ppermute`` halo
exchanges riding the ICI (one per stencil application).  The p-/penalty-
multigrid transfers are element-local (communication-free); the coarsest
level is solved with a replicated dense pinned LU inverse (one
``all_gather`` per visit), exactly like the Poisson path.

Red-black sweeps are the documented parallel deviation from the reference's
lexicographic dense sweeps (same deviation as the sharded Poisson path); for
the 13-point DG operator the checkerboard coloring is a hybrid Jacobi/GS
pass (diagonal and distance-2 couplings stay same-color), which is fine for
a *smoother* — convergence is validated against the single-chip solver in
``tests/test_parallel.py``.

Design note: the obvious cheaper alternative — cell-wise Vanka, i.e. plain
red-black block-GS on the local-ordering saddle stencil (one (2Nu+Np)^2
block per element) — was prototyped and diverges hard on this SIP-DG
discretization even with damping down to omega=0.3 (growth factor ~2 per
cycle), so the distributive transform is structural, not optional.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dgtpu.parallel.halo import (AXIS, ShardColorPack, _local_offdiag,
                                 _matvec_with_halo as _matvec,
                                 _rb_gs_sweep_packed, make_mesh, reshape_level)
from dgtpu.ops.transfer import p_restriction

# stencil slot order [self, iL, iR, jL, jR]; mirror(s) = slot of e as seen
# from its s-neighbor
_MIRROR = np.array([0, 2, 1, 4, 3])


def _dg_diag_blocks(D_op, G_op):
    """Diagonal (Np x Np) blocks of DG = D @ G, from the component stencils.

    (DG)[e,e] = sum_s D[e,s] @ G[nbr(e,s), mirror(s)] — the column block of G
    coupling the s-neighbor's momentum rows back to e's pressure.
    """
    Db = np.where(np.asarray(D_op.mask)[:, :, None, None],
                  np.asarray(D_op.blocks), 0.0)
    Gb = np.where(np.asarray(G_op.mask)[:, :, None, None],
                  np.asarray(G_op.blocks), 0.0)
    nbr = np.asarray(D_op.nbr)
    n = Db.shape[0]
    out = np.zeros((n, Db.shape[2], Db.shape[2]))
    for s in range(5):
        G_back = Gb[nbr[:, s], _MIRROR[s]]          # (N, 2Nu, Np)
        out += np.einsum("npu,nuq->npq", Db[:, s], G_back)
    return out


class _LevelData:
    """Per-level device arrays in the j-sharded (Nj, Ni, ...) layout."""

    def __init__(self, level):
        from dgtpu.ops.linalg import host_inv
        if level.block_A is None:
            raise ValueError("sharded Stokes needs a global-order assembly "
                             "(level.block_A/D/G)")
        self.Ni, self.Nj = level.Ni, level.Nj
        self.nu = level.N_DOF_sol["u"]
        self.npd = level.N_DOF_sol["p"]
        Ni, Nj = self.Ni, self.Nj
        # block_A/D/G arrive masked from assemble_stokes (_mask_blocks)
        self.A = reshape_level(level.block_A, Ni, Nj)
        self.D = reshape_level(level.block_D, Ni, Nj)
        self.G = reshape_level(level.block_G, Ni, Nj)
        self.A_Dinv = host_inv(self.A[:, :, 0])
        dg_diag = _dg_diag_blocks(level.block_D, level.block_G)
        self.DG_diag = jnp.asarray(dg_diag).reshape(Nj, Ni, self.npd, self.npd)
        self.DG_Dinv = host_inv(self.DG_diag)
        i = jnp.arange(Ni)[None, :]
        j = jnp.arange(Nj)[:, None]
        self.colors = ((i + j) % 2).astype(jnp.int32)

    def tree(self):
        return (self.A, self.D, self.G, self.A_Dinv, self.DG_diag,
                self.DG_Dinv, self.colors)


# -- inside-shard_map smoother kernels ---------------------------------------


def _rb_bgs_A(A, A_Dinv, colors, rhs, x, n_pass):
    """Red-black block-GS passes on the velocity operator A."""
    for _ in range(n_pass):
        for c in (0, 1):
            off = _local_offdiag(A, x)
            xn = jnp.einsum("jiab,jib->jia", A_Dinv, rhs - off)
            x = jnp.where((colors == c)[:, :, None], xn, x)
    return x


def _rb_bgs_DG(D, G, DG_diag, DG_Dinv, colors, rhs, p, n_pass):
    """Colored block-GS passes on DG = D@G applied as composed matvecs."""
    for _ in range(n_pass):
        for c in (0, 1):
            off = _matvec(D, _matvec(G, p)) - jnp.einsum(
                "jiab,jib->jia", DG_diag, p)
            pn = jnp.einsum("jiab,jib->jia", DG_Dinv, rhs - off)
            p = jnp.where((colors == c)[:, :, None], pn, p)
    return p


def _dgs_sweep(data, f_mom, f_cont, uv, p, n_pass=2, apack=None, cheb=None):
    """One distributive-GS (lsq splitting) sweep — stencil/halo form of
    ``DistributiveGS.sweep`` (models/stokes.py; relaxation.py:220-441).

    The velocity-block GS passes use the color-packed form (halo.py
    ShardColorPack, ~2.5x less A-block traffic) when ``apack`` is given.
    ``cheb=(degree, eig_max)`` replaces the velocity-block color passes
    with a Chebyshev polynomial on the SPD momentum operator A — no color
    masks, no per-color passes; the only communication left in the whole
    sweep is the halo matvecs' own ppermutes (the Poisson Chebyshev story
    applied inside DGS; config key performance.dgs_velocity_solver).
    """
    A, D, G, A_Dinv, DG_diag, DG_Dinv, colors = data

    def bgs_A(rhs, x):
        if cheb is not None:
            from dgtpu.parallel.halo import _chebyshev_sweep
            return _chebyshev_sweep(A, A_Dinv, rhs, x, degree=cheb[0],
                                    eig_max=cheb[1])
        if apack is not None:
            return _rb_gs_sweep_packed(apack, rhs, x, n_pass=n_pass)
        return _rb_bgs_A(A, A_Dinv, colors, rhs, x, n_pass)

    rhs_mom = f_mom - _matvec(A, uv) - _matvec(G, p)
    du_s = bgs_A(rhs_mom, jnp.zeros_like(uv))
    rhs_cont = f_cont - _matvec(D, uv + du_s)
    dp_s = _rb_bgs_DG(D, G, DG_diag, DG_Dinv, colors, rhs_cont,
                      jnp.zeros_like(p), n_pass)
    G_dp = _matvec(G, dp_s)
    du = du_s + G_dp
    rhs_dg = -_matvec(D, _matvec(A, G_dp))
    dp = _rb_bgs_DG(D, G, DG_diag, DG_Dinv, colors, rhs_dg,
                    jnp.zeros_like(p), n_pass)
    return uv + du, p + dp


def _saddle_residual(data, f_mom, f_cont, uv, p):
    A, D, G = data[0], data[1], data[2]
    return f_mom - _matvec(A, uv) - _matvec(G, p), f_cont - _matvec(D, uv)


def _pnorm_pair(r_mom, r_cont):
    s = jax.lax.psum(jnp.sum(r_mom * r_mom) + jnp.sum(r_cont * r_cont), AXIS)
    n = jax.lax.psum(jnp.asarray(r_mom.size + r_cont.size, r_mom.dtype), AXIS)
    return jnp.sqrt(s / n)


from dgtpu.ops.pallas_stokes import _blockdiag2  # noqa: E402 — single
# definition of the [u; v] interleaved block-diagonal convention


class ShardedStokesMultigrid:
    """Sharded Stokes V-cycle with distributive-GS smoothing.

    Levels are coarsest-first, each assembled in global ordering
    (``assemble_stokes`` with ``solution.ordering == 'global'``).  Transfer
    kinds come from ``transfers``/``transfer_types`` when given (supporting
    geometric (h) coarsening as shard-local 2x2 agglomeration per
    component, like the Poisson path — each device owns whole coarse
    element rows so the transfer needs no communication); otherwise they
    are inferred from the level polynomial degrees: equal degrees =>
    penalty (identity), otherwise component-wise modal truncation.
    """

    def __init__(self, levels, settings, mesh=None, pre_iters=None,
                 post_iters=None, smoother_passes=2, transfers=None,
                 transfer_types=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.devices.size
        self.levels = levels
        self.Ni, self.Nj = levels[-1].Ni, levels[-1].Nj
        for l in levels:
            if l.Nj % n_dev:
                from dgtpu.parallel.halo import shardable_device_counts
                raise ValueError(
                    f"level with Nj={l.Nj} element rows does not divide over "
                    f"{n_dev} devices; usable device counts for this "
                    f"hierarchy are {shardable_device_counts(levels)}")
        if transfers is None:
            for l in levels:
                if (l.Ni, l.Nj) != (self.Ni, self.Nj):
                    raise ValueError(
                        "levels with unequal element counts need explicit "
                        "geometric transfers (pass transfers=)")
        self.data = [_LevelData(l) for l in levels]
        # transfer kinds + component matrices per inter-level transfer
        kinds = []
        self.Ruv, self.Puv, self.Rp, self.Pp = [], [], [], []
        self.cfs = []
        if transfers is not None:
            from dgtpu.models.stokes import (StokesGeometricTransfer,
                                             StokesPolynomialTransfer)
            for k, t in enumerate(transfers):
                kind = (transfer_types[k] if transfer_types is not None
                        else getattr(t, "kind", "penalty"))
                kind = {"penalty_parameter": "penalty"}.get(kind, kind)
                kinds.append(kind)
                if isinstance(t, StokesGeometricTransfer):
                    # per-child scalar transfer matrices -> component-wise
                    # agglomeration operators (uv 2x2-blockdiag per child);
                    # the 4-child slicing below assumes 2x2 agglomeration
                    cf = int(getattr(t, "cf", 2))
                    if cf != 2:
                        raise NotImplementedError(
                            "sharded Stokes geometric coarsening supports "
                            f"cf=2 (2x2 agglomeration) only, got cf={cf}")
                    R4u = np.asarray(t.tu.R)
                    Bu = R4u.shape[1] // 4
                    Ruv = np.hstack([_blockdiag2(R4u[:, c * Bu:(c + 1) * Bu])
                                     for c in range(4)])
                    P4u = np.asarray(t.tu.P)
                    Puv = np.vstack([_blockdiag2(P4u[c * Bu:(c + 1) * Bu, :])
                                     for c in range(4)])
                    self.Ruv.append(jnp.asarray(Ruv))
                    self.Puv.append(jnp.asarray(Puv))
                    self.Rp.append(jnp.asarray(np.asarray(t.tp.R)))
                    self.Pp.append(jnp.asarray(np.asarray(t.tp.P)))
                    self.cfs.append(2)
                elif isinstance(t, StokesPolynomialTransfer):
                    Ru2 = _blockdiag2(np.asarray(t.Ru))
                    self.Ruv.append(jnp.asarray(Ru2))
                    self.Puv.append(jnp.asarray(Ru2.T))
                    self.Rp.append(jnp.asarray(np.asarray(t.Rp)))
                    self.Pp.append(jnp.asarray(np.asarray(t.Rp).T))
                    self.cfs.append(1)
                else:                      # penalty / identity transfer
                    hi = levels[k + 1]
                    nu_f = hi.N_DOF_sol["u"]
                    np_f = hi.N_DOF_sol["p"]
                    self.Ruv.append(jnp.eye(2 * nu_f))
                    self.Puv.append(jnp.eye(2 * nu_f))
                    self.Rp.append(jnp.eye(np_f))
                    self.Pp.append(jnp.eye(np_f))
                    self.cfs.append(1)
        else:
            for lo, hi in zip(levels[:-1], levels[1:]):
                pu_c, pu_f = lo.P_sol["u"], hi.P_sol["u"]
                pp_c, pp_f = lo.P_sol["p"], hi.P_sol["p"]
                if (pu_c, pp_c) == (pu_f, pp_f):
                    nu_f, np_f = (pu_f + 1) ** 2, (pp_f + 1) ** 2
                    Ru2 = np.eye(2 * nu_f)
                    Rp = np.eye(np_f)
                    kinds.append("penalty")
                else:
                    Ru = p_restriction(pu_f, pu_c)
                    Ru2 = np.block([[Ru, np.zeros_like(Ru)],
                                    [np.zeros_like(Ru), Ru]])
                    Rp = p_restriction(pp_f, pp_c)
                    kinds.append("polynomial")
                self.Ruv.append(jnp.asarray(Ru2))
                self.Puv.append(jnp.asarray(Ru2.T))
                self.Rp.append(jnp.asarray(Rp))
                self.Pp.append(jnp.asarray(Rp.T))
                self.cfs.append(1)
        # pre/post sweep counts per level from the paramfile (the smoother
        # *kind* is structurally DGS here — cell-Vanka diverges, see module
        # docstring — so other configured kinds are warned about in the api)
        from dgtpu.parallel.halo import _level_smoother_cfgs
        self.cfgs = _level_smoother_cfgs(kinds, settings, pre_iters, post_iters)
        self.n_pass = smoother_passes
        # per-level color packing of the velocity stencil (any local band)
        self.a_packs = [ShardColorPack(d.A, d.A_Dinv, d.Nj // n_dev, d.Ni)
                        for d in self.data]
        # velocity-block solver inside DGS: 'gs' (colored block-GS, the
        # default) or 'chebyshev' (polynomial on the SPD momentum block —
        # collective-free except the halo matvecs).  eig bounds are
        # per-level power iterations on the momentum stencil at setup.
        perf = getattr(settings, "performance", None)
        self.vel_solver = str(getattr(perf, "dgs_velocity_solver",
                                      "gs")).lower()
        self.cheb = [None] * len(levels)
        if self.vel_solver == "chebyshev":
            from dgtpu.ops.smoothers import estimate_rho_dinv_a
            degree = int(getattr(perf, "dgs_velocity_chebyshev_degree", 3))
            self.cheb = [(degree, 1.1 * estimate_rho_dinv_a(l.block_A))
                         for l in levels]
        elif self.vel_solver != "gs":
            raise ValueError(
                f"performance.dgs_velocity_solver must be 'gs' or "
                f"'chebyshev', got {self.vel_solver!r}")

        # replicated pinned coarse inverse in [uv-interleaved; p] ordering
        from dgtpu.ops.linalg import host_lu_inverse
        c = levels[0]
        A_d = c.block_A.to_dense()
        D_d = c.block_D.to_dense()
        G_d = c.block_G.to_dense()
        n_p = c.N * c.N_DOF_sol["p"]
        Z = jnp.zeros((n_p, n_p), dtype=A_d.dtype).at[0, 0].set(1.0)
        dense = jnp.concatenate([
            jnp.concatenate([A_d, G_d], axis=1),
            jnp.concatenate([D_d, Z], axis=1)], axis=0)
        self.coarse_inv = host_lu_inverse(dense)

        self.tol = settings.solver.multigrid.tolerance
        self.max_cycles = int(settings.solver.multigrid.max_cycles)
        self.cycle_type = str(getattr(settings.solver.multigrid,
                                      "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise NotImplementedError(
                f"the sharded Stokes multigrid implements V, W and F, not "
                f"{self.cycle_type!r}")
        self.full_multigrid = bool(getattr(settings.solver.multigrid,
                                           "full_multigrid", False))
        self._built = None

    # -- V-cycle (statically unrolled over levels) ---------------------------

    def _coarse_solve(self, coarse_inv, f_mom, f_cont):
        r_uv = jax.lax.all_gather(f_mom, AXIS, axis=0, tiled=True)
        r_p = jax.lax.all_gather(f_cont, AXIS, axis=0, tiled=True)
        full = jnp.concatenate([r_uv.reshape(-1), r_p.reshape(-1)])
        e = coarse_inv @ full
        n_uv = r_uv.size
        e_uv = e[:n_uv].reshape(r_uv.shape)
        e_p = e[n_uv:].reshape(r_p.shape)
        idx = jax.lax.axis_index(AXIS)
        nj_loc = f_mom.shape[0]
        return (jax.lax.dynamic_slice_in_dim(e_uv, idx * nj_loc, nj_loc, 0),
                jax.lax.dynamic_slice_in_dim(e_p, idx * nj_loc, nj_loc, 0))

    def _restrict_field(self, k, R, r):
        """Level k residual component -> level k-1 rhs (shard-local);
        geometric transfers agglomerate 2x2 element tiles first (the same
        shard-local reshape as the Poisson path, halo.ShardedMultigrid)."""
        cf = self.cfs[k - 1]
        if cf > 1:
            nj_loc, ni, B = r.shape
            rows = r.reshape(nj_loc // cf, cf, ni // cf, cf, B)
            rows = rows.transpose(0, 2, 1, 3, 4).reshape(
                nj_loc // cf, ni // cf, cf * cf * B)
            return jnp.einsum("ab,jib->jia", R, rows)
        return jnp.einsum("ab,jib->jia", R, r)

    def _prolong_field(self, k, Pm, e_c):
        cf = self.cfs[k - 1]
        v = jnp.einsum("ab,jib->jia", Pm, e_c)
        if cf > 1:
            njc_loc, nic, _ = e_c.shape
            B = v.shape[2] // (cf * cf)
            v = v.reshape(njc_loc, nic, cf, cf, B).transpose(0, 2, 1, 3, 4)
            return v.reshape(njc_loc * cf, nic * cf, B)
        return v

    def _v_cycle(self, k, datas, coarse_inv, Rs, Ps, apacks, f_mom, f_cont,
                 uv, p, mode=None):
        mode = mode or self.cycle_type
        if k == 0:
            return self._coarse_solve(coarse_inv, f_mom, f_cont)
        data = datas[k]
        apack = apacks[k]
        pre, post = self.cfgs[k]
        for _ in range(pre.iterations):
            uv, p = _dgs_sweep(data, f_mom, f_cont, uv, p, self.n_pass,
                               apack=apack, cheb=self.cheb[k])
        r_mom, r_cont = _saddle_residual(data, f_mom, f_cont, uv, p)
        Ruv, Rp = Rs[k - 1]
        fc_mom = self._restrict_field(k, Ruv, r_mom)
        fc_cont = self._restrict_field(k, Rp, r_cont)
        e_uv, e_p = self._v_cycle(k - 1, datas, coarse_inv, Rs, Ps, apacks,
                                  fc_mom, fc_cont,
                                  jnp.zeros_like(fc_mom),
                                  jnp.zeros_like(fc_cont), mode=mode)
        if mode in ("W", "F") and k - 1 > 0:
            # F revisits with a plain V (MultigridSolver.v_cycle semantics)
            e_uv, e_p = self._v_cycle(k - 1, datas, coarse_inv, Rs, Ps,
                                      apacks, fc_mom, fc_cont, e_uv, e_p,
                                      mode="W" if mode == "W" else "V")
        Puv, Pp = Ps[k - 1]
        uv = uv + self._prolong_field(k, Puv, e_uv)
        p = p + self._prolong_field(k, Pp, e_p)
        for _ in range(post.iterations):
            uv, p = _dgs_sweep(data, f_mom, f_cont, uv, p, self.n_pass,
                               apack=apack, cheb=self.cheb[k])
        return uv, p

    def _fmg(self, datas, coarse_inv, Rs, Ps, apacks, f_mom, f_cont):
        """Full-multigrid (nested-iteration) guess, shard-local: restrict
        the saddle rhs to the coarsest level, solve, prolong upward with
        one configured cycle per level (MultigridSolver.fmg_guess analog)."""
        n_lev = len(self.levels)
        rhss = [(f_mom, f_cont)]
        for k in range(n_lev - 1, 0, -1):
            Ruv, Rp = Rs[k - 1]
            fm, fc = rhss[-1]
            rhss.append((self._restrict_field(k, Ruv, fm),
                         self._restrict_field(k, Rp, fc)))
        rhss = rhss[::-1]                   # coarsest first
        uv, p = self._coarse_solve(coarse_inv, rhss[0][0], rhss[0][1])
        for k in range(1, n_lev):
            Puv, Pp = Ps[k - 1]
            uv = self._prolong_field(k, Puv, uv)
            p = self._prolong_field(k, Pp, p)
            uv, p = self._v_cycle(k, datas, coarse_inv, Rs, Ps, apacks,
                                  rhss[k][0], rhss[k][1], uv, p)
        return uv, p

    def build(self):
        shard_map = jax.shard_map
        mesh = self.mesh
        n_lev = len(self.levels)
        spec = P(AXIS)
        tol, max_cycles = self.tol, self.max_cycles
        datas = [d.tree() for d in self.data]
        data_specs = tuple(tuple(P(AXIS) for _ in d) for d in datas)
        Rs_specs = tuple((P(), P()) for _ in self.Ruv)
        apack_specs = tuple(pk.specs() for pk in self.a_packs)

        def solve_local(datas, coarse_inv, Rs, Ps, apacks, f_mom, f_cont,
                        uv0, p0):
            if self.full_multigrid:
                # FMG guess on the defect; normalization stays ||rhs|| so
                # "res <= tol" keeps its relative-to-zero-iterate meaning
                r0m, r0c = _saddle_residual(datas[-1], f_mom, f_cont,
                                            uv0, p0)
                e_uv, e_p = self._fmg(datas, coarse_inv, Rs, Ps, apacks,
                                      r0m, r0c)
                uv0, p0 = uv0 + e_uv, p0 + e_p
                res0 = _pnorm_pair(f_mom, f_cont)
            else:
                r0m, r0c = _saddle_residual(datas[-1], f_mom, f_cont,
                                            uv0, p0)
                res0 = _pnorm_pair(r0m, r0c)
            hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=f_mom.dtype)

            def cond(state):
                n, uv, p, res, hist = state
                return (n < max_cycles) & (res >= tol) & jnp.isfinite(res)

            def body(state):
                n, uv, p, res, hist = state
                hist = hist.at[n].set(res)
                uv, p = self._v_cycle(n_lev - 1, datas, coarse_inv, Rs, Ps,
                                      apacks, f_mom, f_cont, uv, p)
                rm, rc = _saddle_residual(datas[-1], f_mom, f_cont, uv, p)
                return n + 1, uv, p, _pnorm_pair(rm, rc) / res0, hist

            n0 = jnp.asarray(0, dtype=jnp.int32)
            rm_i, rc_i = _saddle_residual(datas[-1], f_mom, f_cont, uv0, p0)
            res_init = _pnorm_pair(rm_i, rc_i) / res0
            n, uv, p, res, hist = jax.lax.while_loop(
                cond, body, (n0, uv0, p0, res_init, hist0))
            hist = hist.at[n].set(res)
            return uv, p, res, n, hist

        fn = shard_map(solve_local, mesh=mesh,
                       in_specs=(data_specs, P(), Rs_specs, Rs_specs,
                                 apack_specs, spec, spec, spec, spec),
                       out_specs=(spec, spec, P(), P(), P()),
                       check_vma=False)
        self._built = jax.jit(fn)
        return self._built

    # -- host-facing API ------------------------------------------------------

    def _split_fields(self, rhs_global):
        """Global-order [all u; all v; p] vector -> ((Nj,Ni,2Nu),(Nj,Ni,Np))."""
        from dgtpu.models.stokes import _global_uv_to_elem
        lvl = self.levels[-1]
        n, nu, npd = lvl.N, lvl.N_DOF_sol["u"], lvl.N_DOF_sol["p"]
        uv = _global_uv_to_elem(rhs_global[:2 * n * nu], n, nu)
        f_mom = uv.reshape(self.Nj, self.Ni, 2 * nu)
        f_cont = rhs_global[2 * n * nu:].reshape(self.Nj, self.Ni, npd)
        return f_mom, f_cont

    def _join_fields(self, uv, p):
        from dgtpu.models.stokes import _elem_uv_to_global
        lvl = self.levels[-1]
        n, nu = lvl.N, lvl.N_DOF_sol["u"]
        uv_g = _elem_uv_to_global(uv.reshape(-1), n, nu)
        return jnp.concatenate([uv_g, p.reshape(-1)])

    def solve(self, rhs_global, u0_global=None):
        f_mom, f_cont = self._split_fields(rhs_global)
        if u0_global is None:
            uv0, p0 = jnp.zeros_like(f_mom), jnp.zeros_like(f_cont)
        else:
            uv0, p0 = self._split_fields(u0_global)
        if self._built is None:
            self.build()
        with self.mesh:
            sh = NamedSharding(self.mesh, P(AXIS))
            args = [jax.device_put(x, sh) for x in (f_mom, f_cont, uv0, p0)]
            datas = tuple(tuple(jax.device_put(a, sh) for a in d.tree())
                          for d in self.data)
            Rs = tuple((r, rp) for r, rp in zip(self.Ruv, self.Rp))
            Ps = tuple((pu, pp) for pu, pp in zip(self.Puv, self.Pp))
            apacks = tuple(pk.tree() for pk in self.a_packs)
            uv, p, res, n, hist = self._built(datas, self.coarse_inv, Rs, Ps,
                                              apacks, *args)
        hist = np.asarray(hist)
        self.history = [float(r) for r in hist[np.isfinite(hist)]]
        return self._join_fields(uv, p), float(res), int(n)

    # -- mixed-precision refinement over the mesh ----------------------------

    def _data32(self):
        """Float32 casts of the cycle data (built once, cached)."""
        if getattr(self, "_data32_cache", None) is None:
            f32 = jnp.float32

            def cast(x):
                return x.astype(f32) if jnp.issubdtype(x.dtype,
                                                       jnp.floating) else x

            datas32 = tuple(tuple(cast(a) for a in d.tree())
                            for d in self.data)
            packs32 = tuple(
                (tuple(b.astype(f32) for b in pk.off_blocks),
                 tuple(dv.astype(f32) for dv in pk.Dinv),
                 tuple(pk.idx), tuple(pk.off_nbr))
                for pk in self.a_packs)
            Rs32 = tuple((r.astype(f32), rp.astype(f32))
                         for r, rp in zip(self.Ruv, self.Rp))
            Ps32 = tuple((pu.astype(f32), pp.astype(f32))
                         for pu, pp in zip(self.Puv, self.Pp))
            self._data32_cache = (datas32, self.coarse_inv.astype(f32),
                                  Rs32, Ps32, packs32)
        return self._data32_cache

    def build_refined(self, tol=1e-10, n_inner=6, max_outer=20,
                      inner="cycles"):
        """Sharded Stokes mixed-precision defect correction: one saddle
        defect residual per outer round (halo-exchange component matvecs),
        the inner correction as n_inner f32 sharded DGS V-cycles — the
        Stokes analog of ``halo.ShardedMultigrid.build_refined``.

        The component matvecs of the defect run in float64.

        ``inner='gmres'`` replaces the n_inner stationary cycles with
        GMRES(n_inner) right-preconditioned by one sharded cycle (the
        shard_map analog of ``make_refined_solver(inner='gmres')``): the
        Arnoldi runs on shard-local flattened [mom; cont] vectors with
        psum inner products, the operator is the halo saddle matvec.  Use
        it when the stand-alone cycle contraction degrades toward/past 1
        on deep hierarchies (measured single-chip: rho 0.99 at 16x16,
        1.34 at 32x32)."""
        if inner not in ("cycles", "gmres"):
            raise ValueError(inner)
        shard_map = jax.shard_map
        mesh = self.mesh
        n_lev = len(self.levels)
        spec = P(AXIS)
        data_specs = tuple(tuple(P(AXIS) for _ in d.tree())
                           for d in self.data)
        Rs_specs = tuple((P(), P()) for _ in self.Ruv)
        apack_specs = tuple(pk.specs() for pk in self.a_packs)
        inner_mode = inner
        # full_multigrid seeds the outer loop with the shard-local f32 FMG
        # guess on the initial defect (single-chip api.py parity); the
        # criterion stays normalized by the PRE-seed residual
        fmg_seed = self.full_multigrid

        def inner_cycles(datas, coarse_inv, Rs, Ps, apacks, rm32, rc32):
            # fori_loop, not Python unrolling: one V-cycle in the HLO
            # instead of n_inner copies (see halo.py inner; the Stokes
            # saddle cycle is the larger module, compile went 7 min -> s)
            def one(_, ep):
                return self._v_cycle(n_lev - 1, datas, coarse_inv, Rs,
                                     Ps, apacks, rm32, rc32, *ep)

            return jax.lax.fori_loop(
                0, n_inner, one,
                (jnp.zeros_like(rm32), jnp.zeros_like(rc32)))

        def inner_gmres(datas, coarse_inv, Rs, Ps, apacks, rm32, rc32):
            from dgtpu.solvers.refinement import gmres_correction
            top = datas[-1]
            nm, shp_m, shp_c = rm32.size, rm32.shape, rc32.shape

            def flat(am, ac):
                return jnp.concatenate([am.ravel(), ac.ravel()])

            def unflat(x):
                return x[:nm].reshape(shp_m), x[nm:].reshape(shp_c)

            def M(x):
                em, ec = unflat(x)
                duv, dp = self._v_cycle(
                    n_lev - 1, datas, coarse_inv, Rs, Ps, apacks, em, ec,
                    jnp.zeros_like(em), jnp.zeros_like(ec))
                return flat(duv, dp)

            def AM(x):
                uv, p = unflat(M(x))
                # _saddle_residual(f_mom, f_cont, u, p) = f - A u; f = 0
                am, ac = _saddle_residual(top, jnp.zeros_like(uv),
                                          jnp.zeros_like(p), uv, p)
                return -flat(am, ac)

            def dot(a, b):
                return jax.lax.psum(jnp.vdot(a, b), AXIS)

            def norm(a):
                return jnp.sqrt(jax.lax.psum(jnp.sum(a * a), AXIS))

            e = gmres_correction(AM, M, flat(rm32, rc32), n_inner,
                                 dot=dot, norm=norm)
            return unflat(e)

        inner = inner_gmres if inner_mode == "gmres" else inner_cycles

        def solve_local_f64(top64, datas, coarse_inv, Rs, Ps, apacks,
                            f_mom, f_cont, uv0, p0):
            r0m, r0c = _saddle_residual(top64, f_mom, f_cont, uv0, p0)
            res0 = _pnorm_pair(r0m, r0c)
            if fmg_seed:
                duv, dp = self._fmg(datas, coarse_inv, Rs, Ps, apacks,
                                    r0m.astype(jnp.float32),
                                    r0c.astype(jnp.float32))
                uv0 = uv0 + duv.astype(f_mom.dtype)
                p0 = p0 + dp.astype(f_mom.dtype)
                r0m, r0c = _saddle_residual(top64, f_mom, f_cont, uv0, p0)
            hist0 = jnp.full((max_outer + 1,), jnp.nan, dtype=f_mom.dtype)

            def cond(state):
                n, uv, p, rm, rc, res, hist = state
                return (n < max_outer) & (res >= tol) & jnp.isfinite(res)

            def body(state):
                n, uv, p, rm, rc, res, hist = state
                hist = hist.at[n].set(res)
                duv, dp = inner(datas, coarse_inv, Rs, Ps, apacks,
                                rm.astype(jnp.float32),
                                rc.astype(jnp.float32))
                uv = uv + duv.astype(f_mom.dtype)
                p = p + dp.astype(f_mom.dtype)
                rm, rc = _saddle_residual(top64, f_mom, f_cont, uv, p)
                return n + 1, uv, p, rm, rc, _pnorm_pair(rm, rc) / res0, \
                    hist

            one = jnp.asarray(1.0, dtype=f_mom.dtype)
            n, uv, p, rm, rc, res, hist = jax.lax.while_loop(
                cond, body,
                (jnp.asarray(0, jnp.int32), uv0, p0, r0m, r0c, one, hist0))
            hist = hist.at[n].set(res)
            return uv, p, res, n, hist

        fn = shard_map(solve_local_f64, mesh=mesh,
                       in_specs=((P(AXIS),) * 3, data_specs, P(), Rs_specs,
                                 Rs_specs, apack_specs, spec, spec, spec,
                                 spec),
                       out_specs=(spec, spec, P(), P(), P()),
                       check_vma=False)
        return jax.jit(fn)

    def solve_refined(self, rhs_global, u0_global=None, tol=1e-10,
                      n_inner=6, max_outer=20, inner="cycles"):
        """f64-accuracy sharded Stokes solve; returns (u, res, n_outer)."""
        f_mom, f_cont = self._split_fields(
            jnp.asarray(rhs_global, dtype=jnp.float64))
        if u0_global is None:
            uv0, p0 = jnp.zeros_like(f_mom), jnp.zeros_like(f_cont)
        else:
            uv0, p0 = self._split_fields(u0_global)
        fn = self.build_refined(tol=tol, n_inner=n_inner,
                                max_outer=max_outer, inner=inner)
        datas32, cinv32, Rs32, Ps32, packs32 = self._data32()
        top = self.data[-1]
        with self.mesh:
            sh = NamedSharding(self.mesh, P(AXIS))
            args = [jax.device_put(x, sh) for x in (f_mom, f_cont, uv0, p0)]
            uv, p, res, n, hist = fn((top.A, top.D, top.G), datas32, cinv32,
                                     Rs32, Ps32, packs32, *args)
        hist = np.asarray(hist)
        self.history = [float(r) for r in hist[np.isfinite(hist)]]
        return self._join_fields(uv, p), float(res), int(n)
