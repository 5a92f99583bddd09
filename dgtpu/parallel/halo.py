"""Multi-chip element-domain decomposition via shard_map + halo exchange.

The reference is strictly single-process (SURVEY §2: no parallelism of any
kind); this module is the new first-class scaling capability.  The element
grid is decomposed along the j-direction over a 1D ``jax.sharding.Mesh``
axis: each device owns a contiguous band of element rows.  The only
communication in the math is the nearest-neighbor face coupling of the
5-point block stencil, which becomes a one-row halo exchange via
``lax.ppermute`` riding the ICI; p-/penalty-multigrid transfers are
element-local and need no communication at all (SURVEY §5 table).

Data layout per level (j-sharded on axis 0):

    blocks : (Nj, Ni, 5, B, B)   stencil slots [self, iL, iR, jL, jR]
    vecs   : (Nj, Ni, B)

i-direction neighbors are intra-shard rolls (periodic wrap is exact for
O-grids; for Dirichlet topologies the wrapped blocks are zero so the roll is
harmless).  Smoothers in sharded mode are red-black colored (each color is
one batched update + halo refresh) — the documented parallel deviation from
the reference's lexicographic sweeps.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "x"


def make_mesh(n_devices=None, devices=None):
    devices = devices if devices is not None else jax.devices()[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def reshape_level(op, Ni, Nj):
    """StencilOperator -> j-sharded layout (Nj, Ni, 5, B, B)."""
    n, s, br, bc = op.blocks.shape
    assert n == Ni * Nj and s == 5
    return op.blocks.reshape(Nj, Ni, 5, br, bc)


def vec_to_grid(v, Ni, Nj, B):
    return v.reshape(Nj, Ni, B)


def grid_to_vec(g):
    return g.reshape(-1)


# -- inside-shard_map kernels (operate on local blocks, explicit halos) ------


def _halo_exchange(u_local):
    """Fetch the j-neighbor boundary rows from adjacent shards.

    Returns (row_above, row_below) of shape (Ni, B); zeros at the physical
    ends of the mesh (the corresponding stencil blocks are zero there).
    """
    n_dev = jax.lax.axis_size(AXIS)
    idx = jax.lax.axis_index(AXIS)
    up = jax.lax.ppermute(u_local[-1], AXIS,
                          [(d, (d + 1) % n_dev) for d in range(n_dev)])
    down = jax.lax.ppermute(u_local[0], AXIS,
                            [(d, (d - 1) % n_dev) for d in range(n_dev)])
    zero = jnp.zeros_like(up)
    up = jnp.where(idx == 0, zero, up)             # no shard above the first
    down = jnp.where(idx == n_dev - 1, zero, down)
    return up, down


def _local_matvec(blocks, u, halo_up, halo_down):
    """Stencil matvec on the local band given j-halos (roll-based, no gathers)."""
    u_jL = jnp.concatenate([halo_up[None], u[:-1]], axis=0)
    u_jR = jnp.concatenate([u[1:], halo_down[None]], axis=0)
    u_iL = jnp.roll(u, 1, axis=1)
    u_iR = jnp.roll(u, -1, axis=1)
    out = jnp.einsum("jiab,jib->jia", blocks[:, :, 0], u)
    out += jnp.einsum("jiab,jib->jia", blocks[:, :, 1], u_iL)
    out += jnp.einsum("jiab,jib->jia", blocks[:, :, 2], u_iR)
    out += jnp.einsum("jiab,jib->jia", blocks[:, :, 3], u_jL)
    out += jnp.einsum("jiab,jib->jia", blocks[:, :, 4], u_jR)
    return out


def _matvec_with_halo(blocks, u):
    up, down = _halo_exchange(u)
    return _local_matvec(blocks, u, up, down)


def _local_offdiag(blocks, u):
    up, down = _halo_exchange(u)
    u_jL = jnp.concatenate([up[None], u[:-1]], axis=0)
    u_jR = jnp.concatenate([u[1:], down[None]], axis=0)
    u_iL = jnp.roll(u, 1, axis=1)
    u_iR = jnp.roll(u, -1, axis=1)
    out = jnp.einsum("jiab,jib->jia", blocks[:, :, 1], u_iL)
    out += jnp.einsum("jiab,jib->jia", blocks[:, :, 2], u_iR)
    out += jnp.einsum("jiab,jib->jia", blocks[:, :, 3], u_jL)
    out += jnp.einsum("jiab,jib->jia", blocks[:, :, 4], u_jR)
    return out


def _rb_gs_sweep(blocks, Dinv, rhs, u, colors, omega=1.0, n_pass=2):
    """Red-black block-GS sweep; colors (Nj_local, Ni) 0/1."""
    for _ in range(n_pass):
        for c in (0, 1):
            off = _local_offdiag(blocks, u)
            unew = jnp.einsum("jiab,jib->jia", Dinv, rhs - off)
            unew = omega * unew + (1 - omega) * u
            u = jnp.where((colors == c)[:, :, None], unew, u)
    return u


class ShardColorPack:
    """Per-color packed off-diagonal data for the sharded red-black sweep.

    Counterpart of ``ops.smoothers.ColorPack``: each color pass reads only
    its own rows' off-diagonal blocks (~1/2.5 of the stencil traffic) with
    the same update math.  Index sets are built per shard (the checkerboard
    phase flips between shards when the local band has an odd number of
    rows) and padded to a common count with entries that write into a
    scratch slot with a zero Dinv, so any rows-per-shard value works.  All
    four arrays are sharded along the leading (shard-ordered) dimension.
    """

    def __init__(self, blocks, Dinv, nj_loc, Ni):
        import numpy as np
        blocks = np.asarray(blocks)          # (Nj, Ni, 5, B, B), host
        Dinv = np.asarray(Dinv)
        Nj = blocks.shape[0]
        n_dev = Nj // nj_loc
        B = blocks.shape[-1]
        scratch = nj_loc * Ni                 # one-past-the-end write target
        lj, li = np.meshgrid(np.arange(nj_loc), np.arange(Ni), indexing="ij")
        b6 = blocks.reshape(n_dev, nj_loc, Ni, 5, B, B)
        d6 = Dinv.reshape(n_dev, nj_loc, Ni, B, B)
        self.idx, self.off_nbr, self.off_blocks, self.Dinv = [], [], [], []
        ext_ni = Ni                           # u_ext rows: [halo_up, u..., halo_down]
        for c in (0, 1):
            per_shard = []
            for s in range(n_dev):
                # global checkerboard color of local cell (lj, li) on shard s
                sel = ((s * nj_loc + lj + li) % 2) == c
                per_shard.append((lj[sel], li[sel]))
            nc = max(len(a) for a, _ in per_shard)
            idx = np.full((n_dev, nc), scratch, dtype=np.int32)
            nbr = np.zeros((n_dev, nc, 4), dtype=np.int32)
            ob = np.zeros((n_dev, nc, 4, B, B), dtype=blocks.dtype)
            dv = np.zeros((n_dev, nc, B, B), dtype=Dinv.dtype)
            for s, (ljc, lic) in enumerate(per_shard):
                m = len(ljc)
                # flat index into the local (nj_loc, Ni) grid
                idx[s, :m] = ljc * Ni + lic
                # neighbor flat indices into the (nj_loc + 2, Ni) extended
                # grid (row 0 = halo_up, row nj_loc + 1 = halo_down); i wraps
                # like the roll-based matvec (wrapped blocks are zero on
                # Dirichlet grids)
                iL = (ljc + 1) * ext_ni + (lic - 1) % Ni
                iR = (ljc + 1) * ext_ni + (lic + 1) % Ni
                jL = ljc * ext_ni + lic
                jR = (ljc + 2) * ext_ni + lic
                nbr[s, :m] = np.stack([iL, iR, jL, jR], axis=1)
                ob[s, :m] = b6[s, ljc, lic, 1:]
                dv[s, :m] = d6[s, ljc, lic]
            self.idx.append(jnp.asarray(idx.reshape(-1)))
            self.off_nbr.append(jnp.asarray(nbr.reshape(-1, 4)))
            self.off_blocks.append(jnp.asarray(ob.reshape(-1, 4, B, B)))
            self.Dinv.append(jnp.asarray(dv.reshape(-1, B, B)))

    def tree(self):
        return (tuple(self.off_blocks), tuple(self.Dinv),
                tuple(self.idx), tuple(self.off_nbr))

    def specs(self):
        s = P(AXIS)
        return ((s, s), (s, s), (s, s), (s, s))


def _rb_gs_sweep_packed(pack, rhs, u, omega=1.0, n_pass=2):
    """Color-packed sharded sweep; halos refreshed before each color pass.

    ``pack`` is a ShardColorPack.tree() with every leaf shard-local:
    (off_blocks, Dinv, idx, off_nbr) per color.  Padded entries carry a
    zero Dinv and write into the scratch slot past the local grid, so they
    are no-ops regardless of omega.
    """
    off_blocks, Dinv_c, idx, off_nbr = pack
    nj_loc, ni, B = u.shape
    n_cells = nj_loc * ni
    rhs_flat = rhs.reshape(-1, B)
    for _ in range(n_pass):
        for c in (0, 1):
            safe = jnp.minimum(idx[c], n_cells - 1)   # pad reads clip in-range
            up, down = _halo_exchange(u)
            u_ext = jnp.concatenate([up[None], u, down[None]], axis=0)
            u_nbr = u_ext.reshape(-1, B)[off_nbr[c]]       # (nc, 4, B)
            off = jnp.einsum("nsab,nsb->na", off_blocks[c], u_nbr)
            u_flat = u.reshape(-1, B)
            unew = jnp.einsum("nab,nb->na", Dinv_c[c], rhs_flat[safe] - off)
            unew = omega * unew + (1 - omega) * u_flat[safe]
            u_pad = jnp.concatenate(
                [u_flat, jnp.zeros((1, B), dtype=u.dtype)], axis=0)
            u = u_pad.at[idx[c]].set(unew)[:-1].reshape(nj_loc, ni, B)
    return u


def _block_jacobi_sweep(blocks, Dinv, rhs, u, omega=0.8):
    off = _local_offdiag(blocks, u)
    unew = jnp.einsum("jiab,jib->jia", Dinv, rhs - off)
    return omega * unew + (1 - omega) * u


def _chebyshev_sweep(blocks, Dinv, rhs, u, degree, eig_max,
                     eig_ratio=0.3):
    """Chebyshev polynomial smoother over the mesh — the natural sharded
    smoother: ``degree`` halo matvecs + batched block solves, no color
    passes, no extra collectives beyond the matvec's own ppermutes.
    Mathematically identical to ``ops.smoothers.chebyshev`` (the matvec
    with halos IS the global matvec).  ``eig_max`` is REQUIRED — the
    setup-time power-iteration bound (a python float folded into the HLO);
    an underestimated default would make Chebyshev amplify the modes above
    the interval instead of failing loudly (advisor r3, halo.py:217).
    """
    if eig_max is None:
        raise ValueError("chebyshev needs an eig_max bound "
                         "(estimate_rho_dinv_a at setup)")
    lmax = eig_max
    lmin = eig_ratio * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def prec_residual(x):
        r = rhs - _matvec_with_halo(blocks, x)
        return jnp.einsum("jiab,jib->jia", Dinv, r)

    d = prec_residual(u) / theta
    u = u + d
    rho = 1.0 / sigma
    for _ in range(int(degree) - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        z = prec_residual(u)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        u = u + d
        rho = rho_new
    return u


def _pnorm2(x):
    """Global size-normalized L2 norm across shards."""
    s = jax.lax.psum(jnp.sum(x * x), AXIS)
    n = jax.lax.psum(jnp.asarray(x.size, x.dtype), AXIS)
    return jnp.sqrt(s / n)


_KIND_TO_NODE = {"penalty": "penalty_parameter_coarsening",
                 "polynomial": "polynomial_coarsening",
                 "geometric": "geometric_coarsening",
                 # the FVM coarse level and its agglomerated sublevels are
                 # children of geometric coarsening (api.py hierarchy build)
                 "dg_to_fvm": "geometric_coarsening",
                 "geometric_fvm": "geometric_coarsening"}


def shardable_device_counts(levels):
    """Device counts every level's Nj divides over (for error messages)."""
    njs = [l.Nj for l in levels]
    top = min(njs)
    return [d for d in range(1, top + 1) if all(nj % d == 0 for nj in njs)]


def _level_smoother_cfgs(transfer_kinds, settings, pre_iters=None,
                         post_iters=None):
    """Per-level (pre, post) SmootherConfig pairs from the paramfile.

    Level k > 0 smooths with the configs of the coarsening type *beneath*
    it (transfer k-1), exactly like the single-chip MultigridSolver
    (multigrid.py v_cycle / reference solver.py:143-147).  Optional
    pre/post iteration overrides apply to every level (back-compat knob).
    """
    from dgtpu.solvers.multigrid import SmootherConfig
    cfgs = [None]                     # level 0 smooths only as coarse solver
    for kind in transfer_kinds:
        node = getattr(settings.solver.multigrid, _KIND_TO_NODE[kind])
        pre = SmootherConfig.from_settings(node.pre_smoother)
        post = SmootherConfig.from_settings(node.post_smoother)
        if pre_iters is not None:
            pre.iterations = int(pre_iters)
        if post_iters is not None:
            post.iterations = int(post_iters)
        cfgs.append((pre, post))
    return cfgs


class ShardedMultigrid:
    """Sharded Poisson multigrid over a 1D device mesh.

    Supports p-/penalty-coarsening (element-local, communication-free
    transfers) and geometric (h) coarsening: the 2x2 agglomeration is
    shard-local because each device owns whole coarse-element rows — the
    transfer needs no communication either, provided every level's Nj
    divides over the mesh.  Smoother kind, direction, iterations and
    relaxation factor come from the per-coarsening paramfile nodes like
    the single-chip solver; Gauss-Seidel names run red-black (the
    documented parallel deviation), Jacobi names run damped block-Jacobi.
    The coarsest level follows ``coarse grid solver``: direct/amg = one
    replicated dense solve per visit (all_gather), smoother = 10 sweeps.
    """

    def __init__(self, levels, transfers, settings, mesh=None,
                 pre_iters=None, post_iters=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.devices.size
        self.dims = [(l.Ni, l.Nj) for l in levels]
        self.Ni, self.Nj = self.dims[-1]
        for (ni, nj) in self.dims:
            if nj % n_dev:
                ok = shardable_device_counts(levels)
                raise ValueError(
                    f"level with Nj={nj} element rows does not divide over "
                    f"{n_dev} devices; with this hierarchy "
                    f"(Nj per level: {[d[1] for d in self.dims]}) the usable "
                    f"device counts are {ok}")
        for t in transfers:
            if t.kind not in ("polynomial", "penalty", "geometric",
                              "dg_to_fvm", "geometric_fvm"):
                raise NotImplementedError(
                    "sharded multigrid supports p/penalty/geometric/FVM "
                    f"transfers (got {t.kind})")
        self.levels = levels
        self.transfer_meta = [(t.kind, getattr(t, "cf_f", 1),
                               getattr(t, "cf_c", 1)) for t in transfers]
        # tiled transfers (geometric agglomeration) are shard-local only if
        # every device owns whole tiles on both sides
        for k, (kind, cf_f, cf_c) in enumerate(self.transfer_meta):
            nj_f = self.dims[k + 1][1]
            nj_c = self.dims[k][1]
            if (nj_f // n_dev) % cf_f or (nj_c // n_dev) % cf_c:
                raise ValueError(
                    f"{kind} transfer tiles ({cf_f}->{cf_c} rows) do not "
                    f"align with {n_dev} devices "
                    f"(local rows: fine {nj_f // n_dev}, coarse {nj_c // n_dev})")
        self.cfgs = _level_smoother_cfgs([t.kind for t in transfers], settings,
                                         pre_iters, post_iters)
        from dgtpu.ops.smoothers import SMOOTHER_ALIASES
        for pair in self.cfgs[1:]:
            for cfg in pair:
                if SMOOTHER_ALIASES[cfg.name] not in ("gs", "gs_rb",
                                                      "jacobi", "cheby"):
                    raise ValueError(
                        f"smoother {cfg.name!r} is not supported in sharded "
                        "mode (Gauss-Seidel, Jacobi and Chebyshev only)")
        self.blocks = [reshape_level(l.op, ni, nj)
                       for l, (ni, nj) in zip(levels, self.dims)]
        from dgtpu.ops.linalg import host_inv
        self.Dinv = [host_inv(b[:, :, 0]) for b in self.blocks]
        # Chebyshev interval bounds: estimated once at setup on the full
        # (unsharded) operators — rho(D^-1 A) is a global quantity.  Only
        # levels whose own pre/post smoother is chebyshev pay the 30 eager
        # power iterations (the finest level's would otherwise dominate
        # setup even for configs that only smooth coarse levels with it —
        # advisor r3, halo.py:422); level 0 needs one only when the coarse
        # solve falls back to smoothing with cfgs[1]'s pre-smoother.
        from dgtpu.ops.smoothers import estimate_rho_dinv_a

        _coarse = str(settings.solver.multigrid.coarse_grid_solver)

        def _uses_cheby(k):
            if k == 0:
                return (_coarse not in ("direct", "amg") and
                        SMOOTHER_ALIASES[self.cfgs[1][0].name] == "cheby")
            return any(SMOOTHER_ALIASES[cfg.name] == "cheby"
                       for cfg in self.cfgs[k])

        self.eig_max = [1.1 * estimate_rho_dinv_a(l.op)
                        if _uses_cheby(k) else None
                        for k, l in enumerate(levels)]
        # color-packed sweeps (per-shard index sets; any rows-per-shard)
        self.pack_host = [ShardColorPack(b, d, nj // n_dev, ni)
                          for (ni, nj), b, d in
                          zip(self.dims, self.blocks, self.Dinv)]
        # dg->fvm restriction carries a per-cell residual scale (the cell
        # Jacobian, transfer.py row_scale); folded into a per-cell R so it
        # shards with the rows instead of threading an extra tree leaf
        self.R = []
        for k, t in enumerate(transfers):
            if t.kind == "dg_to_fvm" and getattr(t, "row_scale", None) is not None:
                ni_c, nj_c = self.dims[k]
                sc = jnp.asarray(t.row_scale).reshape(nj_c, ni_c)
                self.R.append(sc[:, :, None, None] * t.R[None, None])
            else:
                self.R.append(t.R)
        self.Pr = [t.P for t in transfers]
        self.R_specs = tuple(P(AXIS) if r.ndim == 4 else P() for r in self.R)
        self.coarse_solver = str(settings.solver.multigrid.coarse_grid_solver)
        if self.coarse_solver in ("direct", "amg"):
            # same collapse as the single-chip solver: the coarsest system is
            # small, a cached dense inverse beats an AMG setup there
            from dgtpu.ops.linalg import host_lu_inverse
            self.coarse_inv = host_lu_inverse(levels[0].op.to_dense())
        else:
            self.coarse_inv = jnp.zeros((1, 1), dtype=self.blocks[0].dtype)
        self.colors = []
        for (ni, nj) in self.dims:
            i = jnp.arange(ni)[None, :]
            j = jnp.arange(nj)[:, None]
            self.colors.append(((i + j) % 2).astype(jnp.int32))
        self.tol = settings.solver.multigrid.tolerance
        self.max_cycles = int(settings.solver.multigrid.max_cycles)
        self.cycle_type = str(getattr(settings.solver.multigrid,
                                      "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise NotImplementedError(
                f"the sharded multigrid implements V, W and F, not "
                f"{self.cycle_type!r}")
        self.full_multigrid = bool(getattr(settings.solver.multigrid,
                                           "full_multigrid", False))
        self._built = None

    def _restrict(self, k, R, r):
        """Level k residual -> level k-1 rhs (shard-local)."""
        kind, cf_f, cf_c = self.transfer_meta[k - 1]
        if kind == "geometric":
            cf = cf_f
            nj_loc, ni, B = r.shape
            rows = r.reshape(nj_loc // cf, cf, ni // cf, cf, B)
            rows = rows.transpose(0, 2, 1, 3, 4).reshape(
                nj_loc // cf, ni // cf, cf * cf * B)
            return jnp.einsum("ab,jib->jia", R, rows)
        if kind == "geometric_fvm":
            # cf_f x cf_f fine cells -> cf_c x cf_c coarse cells per tile
            nj_loc, ni, B = r.shape
            njt, nit = nj_loc // cf_f, ni // cf_f
            rows = r.reshape(njt, cf_f, nit, cf_f, B)
            rows = rows.transpose(0, 2, 1, 3, 4).reshape(
                njt, nit, cf_f * cf_f * B)
            out = jnp.einsum("ab,jib->jia", R, rows)
            out = out.reshape(njt, nit, cf_c, cf_c, B).transpose(0, 2, 1, 3, 4)
            return out.reshape(njt * cf_c, nit * cf_c, B)
        if R.ndim == 4:                      # dg->fvm with per-cell scale
            return jnp.einsum("jiab,jib->jia", R, r)
        return jnp.einsum("ab,jib->jia", R, r)

    def _prolong(self, k, Pm, e_c):
        """Level k-1 correction -> level k (shard-local)."""
        kind, cf_f, cf_c = self.transfer_meta[k - 1]
        if kind == "geometric_fvm":
            njc_loc, nic, B = e_c.shape
            njt, nit = njc_loc // cf_c, nic // cf_c
            rows = e_c.reshape(njt, cf_c, nit, cf_c, B)
            rows = rows.transpose(0, 2, 1, 3, 4).reshape(
                njt, nit, cf_c * cf_c * B)
            v = jnp.einsum("ab,jib->jia", Pm, rows)
            v = v.reshape(njt, nit, cf_f, cf_f, B).transpose(0, 2, 1, 3, 4)
            return v.reshape(njt * cf_f, nit * cf_f, B)
        v = jnp.einsum("ab,jib->jia", Pm, e_c)
        if kind == "geometric":
            cf = cf_f
            njc_loc, nic, _ = e_c.shape
            B = v.shape[2] // (cf * cf)
            v = v.reshape(njc_loc, nic, cf, cf, B).transpose(0, 2, 1, 3, 4)
            return v.reshape(njc_loc * cf, nic * cf, B)
        return v

    def _smooth(self, k, data, rhs, u, cfg, iterations=None):
        from dgtpu.ops.smoothers import SMOOTHER_ALIASES
        blocks, Dinv, colors, coarse_inv, packs, Rs, Ps = data
        iters = int(iterations if iterations is not None else cfg.iterations)
        if SMOOTHER_ALIASES[cfg.name] == "cheby":
            if cfg.eig_ratio is not None:
                ratio = cfg.eig_ratio
            else:
                ratio = cfg.omega if 0.0 < cfg.omega < 1.0 else 0.3
            return _chebyshev_sweep(blocks[k], Dinv[k], rhs, u, degree=iters,
                                    eig_max=self.eig_max[k], eig_ratio=ratio)
        if SMOOTHER_ALIASES[cfg.name] == "jacobi":
            for _ in range(iters):
                u = _block_jacobi_sweep(blocks[k], Dinv[k], rhs, u,
                                        omega=cfg.omega)
            return u
        # GS family: red-black colored (symmetric = 2 color passes/iteration,
        # matching ops.smoothers.block_gauss_seidel redblack semantics)
        n_pass = iters * (2 if cfg.direction == "symmetric" else 1)
        return _rb_gs_sweep_packed(packs[k], rhs, u, omega=cfg.omega,
                                   n_pass=n_pass)

    def _v_cycle(self, k, data, rhs, u, mode=None):
        mode = mode or self.cycle_type
        blocks, Dinv, colors, coarse_inv, packs, Rs, Ps = data
        if k == 0:
            if self.coarse_solver not in ("direct", "amg"):
                # 10 sweeps of the lowest coarsening type's pre-smoother
                # (reference solver.py:199-203 semantics)
                pre, _ = self.cfgs[1]
                return self._smooth(0, data, rhs, u, pre, iterations=10)
            # replicated coarse solve: gather the full coarse residual
            r_full = jax.lax.all_gather(rhs, AXIS, axis=0, tiled=True)
            e_full = (coarse_inv @ r_full.reshape(-1)).reshape(r_full.shape)
            n_dev = jax.lax.axis_size(AXIS)
            idx = jax.lax.axis_index(AXIS)
            nj_loc = rhs.shape[0]
            return jax.lax.dynamic_slice_in_dim(e_full, idx * nj_loc, nj_loc, 0)
        pre, post = self.cfgs[k]
        u = self._smooth(k, data, rhs, u, pre)
        r = rhs - _matvec_with_halo(blocks[k], u)
        r_c = self._restrict(k, Rs[k - 1], r)
        e_c = self._v_cycle(k - 1, data, r_c, jnp.zeros_like(r_c), mode=mode)
        if mode in ("W", "F") and k - 1 > 0:
            # F revisits with a plain V (MultigridSolver.v_cycle semantics)
            e_c = self._v_cycle(k - 1, data, r_c, e_c,
                                mode="W" if mode == "W" else "V")
        u = u + self._prolong(k, Ps[k - 1], e_c)
        u = self._smooth(k, data, rhs, u, post)
        return u

    def _fmg(self, data, rhs):
        """Full-multigrid (nested-iteration) guess, shard-local.

        The restrict/prolong are element-local or shard-local agglomeration
        (no communication beyond the cycles' own halo ppermutes), so the
        FMG chain runs entirely inside shard_map — same semantics as
        MultigridSolver.fmg_guess."""
        _, _, _, _, _, Rs, Ps = data
        n_lev = len(self.levels)
        rhss = [rhs]
        for k in range(n_lev - 1, 0, -1):
            rhss.append(self._restrict(k, Rs[k - 1], rhss[-1]))
        rhss = rhss[::-1]                   # coarsest first
        u = self._v_cycle(0, data, rhss[0], jnp.zeros_like(rhss[0]))
        for k in range(1, n_lev):
            u = self._prolong(k, Ps[k - 1], u)
            u = self._v_cycle(k, data, rhss[k], u)
        return u

    def build(self):
        """Construct the jitted sharded solve function."""
        shard_map = jax.shard_map
        mesh = self.mesh
        n_lev = len(self.levels)
        spec = P(AXIS)
        pack_specs = tuple(p.specs() for p in self.pack_host)
        data_specs = (tuple(P(AXIS) for _ in self.blocks),
                      tuple(P(AXIS) for _ in self.Dinv),
                      tuple(P(AXIS) for _ in self.colors), P(), pack_specs,
                      self.R_specs, tuple(P() for _ in self.Pr))
        tol, max_cycles = self.tol, self.max_cycles

        def solve_local(blocks, Dinv, colors, coarse_inv, packs, Rs, Ps,
                        rhs, u0):
            data = (blocks, Dinv, colors, coarse_inv, packs, Rs, Ps)
            if self.full_multigrid:
                # FMG guess; normalization stays ||rhs|| so "res <= tol"
                # keeps its relative-to-zero-iterate meaning (same rule as
                # MultigridSolver._build_solve)
                u0 = u0 + self._fmg(data,
                                    rhs - _matvec_with_halo(blocks[-1], u0))
                res0 = _pnorm2(rhs)
            else:
                res0 = _pnorm2(rhs - _matvec_with_halo(blocks[-1], u0))
            hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=rhs.dtype)

            def cond(state):
                n, u, res, hist = state
                return (n < max_cycles) & (res >= tol) & jnp.isfinite(res)

            def body(state):
                n, u, res, hist = state
                hist = hist.at[n].set(res)
                u = self._v_cycle(n_lev - 1, data, rhs, u)
                res = _pnorm2(rhs - _matvec_with_halo(blocks[-1], u)) / res0
                return n + 1, u, res, hist

            n0 = jnp.asarray(0, dtype=jnp.int32)
            res_init = _pnorm2(rhs - _matvec_with_halo(blocks[-1], u0)) / res0
            n, u, res, hist = jax.lax.while_loop(cond, body,
                                                 (n0, u0, res_init, hist0))
            hist = hist.at[n].set(res)
            return u, res, n, hist

        fn = shard_map(solve_local, mesh=mesh,
                       in_specs=data_specs + (spec, spec),
                       out_specs=(spec, P(), P(), P()),
                       check_vma=False)
        self._built = jax.jit(fn)
        return self._built

    def solve(self, rhs_vec, u0_vec=None):
        B = self.levels[-1].N_DOF_sol_tot
        rhs = vec_to_grid(rhs_vec, self.Ni, self.Nj, B)
        u0 = (vec_to_grid(u0_vec, self.Ni, self.Nj, B) if u0_vec is not None
              else jnp.zeros_like(rhs))
        if self._built is None:
            self.build()
        with self.mesh:
            sh = NamedSharding(self.mesh, P(AXIS))
            rhs = jax.device_put(rhs, sh)
            u0 = jax.device_put(u0, sh)
            packs = tuple(p.tree() for p in self.pack_host)
            args = (tuple(self.blocks), tuple(self.Dinv), tuple(self.colors),
                    self.coarse_inv, packs, tuple(self.R), tuple(self.Pr))
            u, res, n, hist = self._built(*args, rhs, u0)
        hist = np.asarray(hist)
        self.history = [float(r) for r in hist[np.isfinite(hist)]]
        return grid_to_vec(u), float(res), int(n)

    # -- mixed-precision refinement over the mesh ----------------------------

    def _data32(self):
        """Float32 casts of the cycle data (built once, cached)."""
        if getattr(self, "_data32_cache", None) is None:
            f32 = jnp.float32
            packs32 = []
            for p in self.pack_host:
                packs32.append((tuple(b.astype(f32) for b in p.off_blocks),
                                tuple(d.astype(f32) for d in p.Dinv),
                                tuple(p.idx), tuple(p.off_nbr)))
            self._data32_cache = (
                tuple(b.astype(f32) for b in self.blocks),
                tuple(d.astype(f32) for d in self.Dinv),
                tuple(self.colors),
                self.coarse_inv.astype(f32),
                tuple(packs32),
                tuple(r.astype(f32) for r in self.R),
                tuple(pm.astype(f32) for pm in self.Pr))
        return self._data32_cache

    def build_refined(self, tol=1e-10, n_inner=6, max_outer=20):
        """Sharded mixed-precision defect correction (solvers/refinement.py
        composed with the mesh): one defect residual per outer round, the
        inner correction as n_inner f32 sharded V-cycles — >95% of the work
        in native-speed float32 while the outer loop reaches the 1e-10
        BASELINE parity target.

        The residual is a float64 halo matvec — the reference's
        arithmetic.

        With ``solver.multigrid.full_multigrid`` on, the outer loop is
        seeded with the shard-local f32 FMG (nested-iteration) guess
        applied to the initial defect — same seeding as the single-chip
        mixed route (api.py fmg_guess + make_refined_solver) — while the
        convergence criterion stays normalized by the PRE-seed residual so
        ``tol`` keeps its relative-to-zero-iterate meaning.
        """
        shard_map = jax.shard_map
        mesh = self.mesh
        n_lev = len(self.levels)
        spec = P(AXIS)
        pack_specs = tuple(p.specs() for p in self.pack_host)
        data_specs = (tuple(P(AXIS) for _ in self.blocks),
                      tuple(P(AXIS) for _ in self.Dinv),
                      tuple(P(AXIS) for _ in self.colors), P(), pack_specs,
                      self.R_specs, tuple(P() for _ in self.Pr))
        fmg_seed = self.full_multigrid

        def inner(data, r32):
            # fori_loop, not Python unrolling: the HLO carries ONE V-cycle
            # instead of n_inner copies — compile time drops ~n_inner-fold
            # (the dryrun's 8-device CPU compile went minutes -> seconds)
            def one(_, e):
                return self._v_cycle(n_lev - 1, data, r32, e)

            return jax.lax.fori_loop(0, n_inner, one, jnp.zeros_like(r32))

        def solve_local_f64(b64, blocks, Dinv, colors, coarse_inv, packs,
                            Rs, Ps, rhs, u0):
            data = (blocks, Dinv, colors, coarse_inv, packs, Rs, Ps)
            r0 = rhs - _matvec_with_halo(b64, u0)
            res0 = _pnorm2(r0)
            if fmg_seed:
                u0 = u0 + self._fmg(
                    data, r0.astype(jnp.float32)).astype(rhs.dtype)
                r0 = rhs - _matvec_with_halo(b64, u0)
            hist0 = jnp.full((max_outer + 1,), jnp.nan, dtype=rhs.dtype)

            def cond(state):
                n, u, r, res, hist = state
                return (n < max_outer) & (res >= tol) & jnp.isfinite(res)

            def body(state):
                n, u, r, res, hist = state
                hist = hist.at[n].set(res)
                u = u + inner(data, r.astype(jnp.float32)).astype(rhs.dtype)
                r = rhs - _matvec_with_halo(b64, u)
                res = _pnorm2(r) / res0
                return n + 1, u, r, res, hist

            state = (jnp.asarray(0, dtype=jnp.int32), u0, r0,
                     jnp.asarray(1.0, dtype=rhs.dtype), hist0)
            n, u, r, res, hist = jax.lax.while_loop(cond, body, state)
            hist = hist.at[n].set(res)
            return u, res, n, hist

        fn = shard_map(solve_local_f64, mesh=mesh,
                       in_specs=(P(AXIS),) + data_specs + (spec, spec),
                       out_specs=(spec, P(), P(), P()),
                       check_vma=False)
        return jax.jit(fn)

    def solve_refined(self, rhs_vec, u0_vec=None, tol=1e-10, n_inner=6,
                      max_outer=20):
        """f64-accuracy sharded solve; returns (u, res, n_outer)."""
        B = self.levels[-1].N_DOF_sol_tot
        rhs = vec_to_grid(jnp.asarray(rhs_vec, dtype=jnp.float64),
                          self.Ni, self.Nj, B)
        u0 = (vec_to_grid(u0_vec, self.Ni, self.Nj, B) if u0_vec is not None
              else jnp.zeros_like(rhs))
        fn = self.build_refined(tol=tol, n_inner=n_inner, max_outer=max_outer)
        blocks32, Dinv32, colors, cinv32, packs32, R32, P32 = self._data32()
        with self.mesh:
            sh = NamedSharding(self.mesh, P(AXIS))
            rhs = jax.device_put(rhs, sh)
            u0 = jax.device_put(u0, sh)
            u, res, n, hist = fn(self.blocks[-1], blocks32, Dinv32, colors,
                                 cinv32, packs32, R32, P32, rhs, u0)
        hist = np.asarray(hist)
        self.history = [float(r) for r in hist[np.isfinite(hist)]]
        return grid_to_vec(u), float(res), int(n)
