"""Stokes distributive-GS V-cycle in the SoA (cells-in-lanes) layout.

The rolled-layout cycle (``ops/pallas_vcycle.py``) stores operator blocks as
(..., B, B) tiles per cell.  This module keeps the *cells* in the trailing
dimension instead: per color, vectors are ``(B, C)`` and stencils
``(5, B_src, B_dst, C)`` with ``C = Nj * Ni/2`` cells per color, so a block
matvec is B_src broadcast-multiply-adds on ``(B_dst, C)`` planes with no
gathers.  Neighbor fields are rotations of the opposite color's lattice
along the cell axis (the color-split scheme of ``ops/rolled.py``):
i-neighbors are +/-1 rolls (O-grid wrap gets an explicit two-roll blend),
j-neighbors are +/-(Ni/2) rolls.  Geometric (h) transfers and the dense
coarse inverse act across cells, so they are precomputed host-side as
dense per-color-pair tensors applied as multiply-reduce over the cells;
their size grows with the square of the cell count, which bounds the grid
size this cycle can set up (see ROADMAP).

For the saddle system the state is four lattices per level — velocity
``uv[color] (2Nu, C)`` (element-interleaved [u-modes; v-modes]) and
pressure ``p[color] (Np, C)`` — and the three component stencils A
(momentum), G (pressure gradient) and D (divergence) become per-color SoA
tensors.  One jitted graph runs the whole V-cycle: distributive-GS
smoothing (velocity block-GS -> pressure DG-solve -> distributive
back-transform, ``dgfem/relaxation.py:220-441`` semantics in red-black
colored form), saddle residuals, per-component polynomial/geometric
transfers, and the dense pinned coarse inverse as cross-cell tensors.

V-cycle semantics mirror ``dgfem/solver.py:141-207``; the smoother matches
``dgtpu.models.stokes.StencilDGS`` (lsq splitting) bit-for-bit in a
different memory layout, which has no reference counterpart.
"""

import numpy as np

import jax
import jax.numpy as jnp

from dgtpu.utils.jitting import const_jit

_CHILDREN = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dj, di), _tile_restrict order


def _packed_pos(j, i):
    """(color, packed ip) of cell (j, i) under the color-split layout."""
    c = (i + j) % 2
    ip = (i - (j % 2)) // 2 if c == 0 else (i - 1 + (j % 2)) // 2
    return c, ip


def _mac(blk, f):
    """sum_b blk[b] * f[b] for blk (B_src, B_dst, C), f (B_src, C),
    accumulated in f's dtype."""
    B = f.shape[0]
    acc = None
    for b in range(B):
        term = blk[b].astype(f.dtype) * f[b]
        acc = term if acc is None else acc + term
    return acc


def _lane_tensor_apply(T, f):
    """sum_{b, cells} T[b] * f[b] for T (B, A, C_out, C_in).

    The cross-cell linear maps (geometric transfers, dense coarse inverse):
    per source mode b, T[b] is (A, C_out, C_in); contract the C_in cells
    against f[b] and accumulate -> (A, C_out).
    """
    B = f.shape[0]
    acc = None
    for b in range(B):
        term = jnp.sum(T[b] * f[b], axis=-1)
        acc = term if acc is None else acc + term
    return acc


def _soa_blocks(rolled_pair):
    """Color-packed (Nj, nh, 5, a, b) -> (5, b, a, C) per color."""
    out = []
    for x in rolled_pair:
        x = np.asarray(x)
        nj, nh = x.shape[:2]
        out.append(jnp.asarray(
            np.transpose(x, (2, 4, 3, 0, 1))
            .reshape(x.shape[2], x.shape[4], x.shape[3], nj * nh)))
    return tuple(out)


def _soa_diag(packed_pair):
    """Color-packed (Nj, nh, a, b) -> (b, a, C) per color (M^T layout)."""
    out = []
    for x in packed_pair:
        x = np.asarray(x)
        nj, nh = x.shape[:2]
        out.append(jnp.asarray(
            np.transpose(x, (3, 2, 0, 1))
            .reshape(x.shape[3], x.shape[2], nj * nh)))
    return tuple(out)


def _blockdiag2(M):
    """blockdiag(M, M) for the [u; v] interleaved velocity block."""
    M = np.asarray(M)
    a, b = M.shape
    out = np.zeros((2 * a, 2 * b), M.dtype)
    out[:a, :b] = M
    out[a:, b:] = M
    return out


class SoAStokesVCycle:
    """Stokes DGS V-cycle, cells-in-lanes layout.

    Parameters
    ----------
    levels : list of GridLevel, coarsest -> finest, global-order Stokes
        assembly (``block_A/D/G`` set)
    transfers : list of StokesPolynomialTransfer / StokesGeometricTransfer /
        penalty TransferOp, transfers[k] between levels k and k+1
    types : 'penalty'|'polynomial'|'geometric' per transfer
    settings : Settings (smoother iteration counts, coarse-grid solver)

    Requires an even Ni on every level (color-split condition) and
    distributive_gauss_seidel smoothing (the Stokes saddle smoother).
    """

    def __init__(self, levels, transfers, types, settings, dtype=jnp.float32,
                 n_pass=2):
        from dgtpu.ops import rolled
        from dgtpu.ops.linalg import host_inv
        from dgtpu.parallel.stokes_halo import _dg_diag_blocks

        self.dtype = dtype
        self.n_lev = len(levels)
        self.transfers = transfers
        self.types = types
        self.n_pass = n_pass
        self.dims = [(l.Nj, l.Ni) for l in levels]
        self.nu = [l.N_DOF_sol["u"] for l in levels]
        self.npd = [l.N_DOF_sol["p"] for l in levels]
        cast = lambda x: jnp.asarray(np.asarray(x), dtype)

        self.A, self.G, self.D = [], [], []
        self.A_Dinv, self.DG_diag, self.DG_Dinv = [], [], []
        self.masks, self.periodic = [], []
        for lvl in levels:
            if lvl.block_A is None:
                raise ValueError("SoAStokesVCycle needs a global-order "
                                 "Stokes assembly (level.block_A/D/G)")
            nj, ni = lvl.Nj, lvl.Ni
            if ni % 2:
                raise ValueError("SoAStokesVCycle needs an even Ni on every "
                                 f"level (got {ni})")
            nh = ni // 2
            for name, op in (("A", lvl.block_A), ("G", lvl.block_G),
                             ("D", lvl.block_D)):
                rb = rolled.to_rolled(op, ni, nj)
                pair, _ = rolled.pack_operator_colors(np.asarray(rb))
                getattr(self, name).append(
                    tuple(cast(x) for x in _soa_blocks(pair)))
            rb_A = rolled.to_rolled(lvl.block_A, ni, nj)
            Adinv = host_inv(rb_A[:, :, 0])
            _, dpair = rolled.pack_operator_colors(
                np.asarray(rb_A), np.asarray(Adinv))
            self.A_Dinv.append(tuple(cast(x) for x in _soa_diag(dpair)))
            dgd = np.asarray(_dg_diag_blocks(lvl.block_D, lvl.block_G))
            dgd = dgd.reshape(nj, ni, *dgd.shape[1:])
            dgdinv = np.asarray(host_inv(jnp.asarray(dgd)))
            _, pair_d = rolled.pack_operator_colors(
                np.zeros((nj, ni, 5, 1, 1)), dgd)
            _, pair_di = rolled.pack_operator_colors(
                np.zeros((nj, ni, 5, 1, 1)), dgdinv)
            self.DG_diag.append(tuple(cast(x) for x in _soa_diag(pair_d)))
            self.DG_Dinv.append(tuple(cast(x) for x in _soa_diag(pair_di)))
            lanes_j = np.repeat(np.arange(nj), nh)
            lanes_ip = np.tile(np.arange(nh), nj)
            m = np.stack([lanes_j % 2 == 0, lanes_ip == 0, lanes_ip == nh - 1])
            self.masks.append(jnp.asarray(
                m.astype(np.dtype(dtype))[:, None, :]))
            nbr = np.asarray(lvl.block_A.nbr)
            msk = np.asarray(lvl.block_A.mask)
            self.periodic.append(bool(ni > 1 and msk[0, 1]
                                      and nbr[0, 1] == ni - 1))

        # smoother config per coarsening type (iterations of the DGS sweep)
        from dgtpu.ops.smoothers import normalize_smoother_name
        self._cfg = {}
        for t in set(types):
            node = getattr(settings.solver.multigrid, f"{t}_coarsening")
            for side in (node.pre_smoother, node.post_smoother):
                if normalize_smoother_name(side.smoother) != \
                        "distributive_gauss_seidel":
                    raise ValueError(
                        "SoAStokesVCycle smooths with distributive GS; "
                        f"config names {side.smoother!r}")
            self._cfg[t] = (int(node.pre_smoother.iterations),
                            int(node.post_smoother.iterations))

        # transfers
        self.soa_R, self.soa_P = [], []
        for k, t in enumerate(transfers):
            if getattr(t, "kind", None) == "penalty":
                self.soa_R.append(None)
                self.soa_P.append(None)
            elif t.kind == "polynomial":
                Ruv = cast(_blockdiag2(t.Ru))
                Rp = cast(np.asarray(t.Rp))
                self.soa_R.append((Ruv, Rp))
                self.soa_P.append((Ruv.T, Rp.T))
            elif t.kind == "geometric":
                self.soa_R.append(self._geo_tensors(k, t, restrict=True))
                self.soa_P.append(self._geo_tensors(k, t, restrict=False))
            else:
                raise ValueError(t.kind)

        self.cycle_type = str(getattr(settings.solver.multigrid,
                                      "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise NotImplementedError(
                f"the SoA Stokes cycle implements V, W and F, not "
                f"{self.cycle_type!r}")
        self.coarse_solver = settings.solver.multigrid.coarse_grid_solver
        if self.coarse_solver in ("direct", "amg"):
            self.coarse = self._coarse_tensors(levels[0])
        else:
            self.coarse = None

    # -- host-side tensor construction ---------------------------------------

    def _geo_tensors(self, k, t, restrict):
        """Per-component (2, 2, B, B_c, C_out, C_in) cell tensors (cf=2)."""
        njc, nic = self.dims[k]
        nhc, nhf = nic // 2, nic
        Cc, Cf = njc * nhc, (2 * njc) * nhf
        out = []
        for comp, tb in (("uv", t.tu), ("p", t.tp)):
            Bc, Bf4 = np.asarray(tb.R).shape
            Bf = Bf4 // 4
            R4 = np.asarray(tb.R).reshape(Bc, 4, Bf).transpose(1, 0, 2)
            P4 = np.asarray(tb.P).reshape(4, Bf, Bc)
            if comp == "uv":
                R4 = np.stack([_blockdiag2(r) for r in R4])
                P4 = np.stack([_blockdiag2(p) for p in P4])
                Bc, Bf = 2 * Bc, 2 * Bf
            if restrict:
                T = np.zeros((2, 2, Bf, Bc, Cc, Cf), np.float64)
            else:
                T = np.zeros((2, 2, Bc, Bf, Cf, Cc), np.float64)
            for jc in range(njc):
                for ic in range(nic):
                    cc, ipc = _packed_pos(jc, ic)
                    q = jc * nhc + ipc
                    for kk, (dj, di) in enumerate(_CHILDREN):
                        jf, if_ = 2 * jc + dj, 2 * ic + di
                        cf_, ipf = _packed_pos(jf, if_)
                        p = jf * nhf + ipf
                        if restrict:
                            T[cc, cf_, :, :, q, p] += R4[kk].T
                        else:
                            T[cf_, cc, :, :, p, q] += P4[kk].T
            out.append(jnp.asarray(T.astype(np.dtype(self.dtype))))
        return tuple(out)

    def _coarse_tensors(self, lvl):
        """Dense pinned saddle inverse as (2, 2, B0, B0, C0, C0) tensors.

        Per-cell block layout [u-modes; v-modes; p-modes], B0 = 2Nu + Np.
        """
        from dataclasses import replace
        from dgtpu.ops.linalg import host_lu_inverse
        nj0, ni0 = self.dims[0]
        nh0 = ni0 // 2
        C0 = nj0 * nh0
        n = nj0 * ni0
        nu, npd = self.nu[0], self.npd[0]
        B0 = 2 * nu + npd
        op = lvl.op
        if hasattr(op, "pin") and not op.pin:
            op = replace(op, pin=True)
        inv = np.asarray(host_lu_inverse(op.to_dense()))
        # global [all u; all v; all p] row indices of cell m's block
        def rows(m):
            return np.concatenate([
                np.arange(m * nu, (m + 1) * nu),
                np.arange(n * nu + m * nu, n * nu + (m + 1) * nu),
                np.arange(2 * n * nu + m * npd, 2 * n * nu + (m + 1) * npd)])
        pos, blk_rows = [], []
        for j in range(nj0):
            for i in range(ni0):
                c, ip = _packed_pos(j, i)
                pos.append((c, j * nh0 + ip))
                blk_rows.append(rows(j * ni0 + i))
        T = np.zeros((2, 2, B0, B0, C0, C0), np.float64)
        for mo, (co, qo) in enumerate(pos):
            for mi, (ci, qi) in enumerate(pos):
                T[co, ci, :, :, qo, qi] = \
                    inv[np.ix_(blk_rows[mo], blk_rows[mi])].T
        return jnp.asarray(T.astype(np.dtype(self.dtype)))

    # -- stencil matvecs ------------------------------------------------------

    def _nbr_fields(self, o, color, masks, nh, periodic):
        me, mrs, mre = masks[0], masks[1], masks[2]
        roll_p = jnp.roll(o, 1, axis=1)
        roll_m = jnp.roll(o, -1, axis=1)
        if periodic:
            roll_p = (1.0 - mrs) * roll_p + mrs * jnp.roll(o, 1 - nh, axis=1)
            roll_m = (1.0 - mre) * roll_m + mre * jnp.roll(o, nh - 1, axis=1)
        if color == 0:
            iL = me * roll_p + (1.0 - me) * o
            iR = me * o + (1.0 - me) * roll_m
        else:
            iL = me * o + (1.0 - me) * roll_p
            iR = me * roll_m + (1.0 - me) * o
        jL = jnp.roll(o, nh, axis=1)
        jR = jnp.roll(o, -nh, axis=1)
        return iL, iR, jL, jR

    def _off(self, blk, other, color, k):
        nh = self.dims[k][1] // 2
        fields = self._nbr_fields(other, color, self._m(k),
                                  nh, self.periodic[k])
        acc = None
        for s, f in enumerate(fields):
            part = _mac(blk[s + 1], f)
            acc = part if acc is None else acc + part
        return acc

    def _m(self, k):
        return self._masks_r[k]

    def _mv(self, blk_pair, x01, k):
        """Full stencil matvec on both colors: blk (5, src, dst, C)."""
        y0 = _mac(blk_pair[0][0], x01[0]) + self._off(blk_pair[0], x01[1], 0, k)
        y1 = _mac(blk_pair[1][0], x01[1]) + self._off(blk_pair[1], x01[0], 1, k)
        return y0, y1

    # -- distributive GS ------------------------------------------------------

    def _bgs_A(self, k, lv, rhs01, x01):
        """Red-black block-GS passes on the momentum operator A."""
        A0, A1 = lv["A"]
        d0, d1 = lv["A_Dinv"]

        def body(_, xx):
            x0, x1 = xx
            x0 = _mac(d0, rhs01[0] - self._off(A0, x1, 0, k))
            x1 = _mac(d1, rhs01[1] - self._off(A1, x0, 1, k))
            return x0, x1

        return jax.lax.fori_loop(0, self.n_pass, body, x01)

    def _bgs_dg(self, k, lv, rhs01, p01):
        """Red-black GS passes on DG = D@G (diag precomputed)."""
        dgd = lv["DG_diag"]
        dgi = lv["DG_Dinv"]

        def half(c, p01):
            g01 = self._mv(lv["G"], p01, k)
            Gc = lv["D"][c]
            other = 1 - c
            dg_c = (_mac(Gc[0], g01[c])
                    + self._off(Gc, g01[other], c, k))
            off = dg_c - _mac(dgd[c], p01[c])
            pn = _mac(dgi[c], rhs01[c] - off)
            return (pn, p01[1]) if c == 0 else (p01[0], pn)

        def body(_, p01):
            p01 = half(0, p01)
            p01 = half(1, p01)
            return p01

        return jax.lax.fori_loop(0, self.n_pass, body, p01)

    def _dgs_sweep(self, k, lv, f_mom01, f_cont01, uv01, p01):
        """One lsq-splitting distributive GS sweep (StencilDGS.sweep)."""
        A_uv = self._mv(lv["A"], uv01, k)
        G_p = self._mv(lv["G"], p01, k)
        rhs_mom = tuple(f - a - g for f, a, g in zip(f_mom01, A_uv, G_p))
        zero_uv = tuple(jnp.zeros_like(u) for u in uv01)
        du_s = self._bgs_A(k, lv, rhs_mom, zero_uv)
        uv_plus = tuple(u + d for u, d in zip(uv01, du_s))
        D_uv = self._mv(lv["D"], uv_plus, k)
        rhs_cont = tuple(f - d for f, d in zip(f_cont01, D_uv))
        zero_p = tuple(jnp.zeros_like(q) for q in p01)
        dp_s = self._bgs_dg(k, lv, rhs_cont, zero_p)
        G_dp = self._mv(lv["G"], dp_s, k)
        du = tuple(d + g for d, g in zip(du_s, G_dp))
        A_Gdp = self._mv(lv["A"], G_dp, k)
        DA = self._mv(lv["D"], A_Gdp, k)
        rhs_dg = tuple(-x for x in DA)
        dp = self._bgs_dg(k, lv, rhs_dg, zero_p)
        return (tuple(u + d for u, d in zip(uv01, du)),
                tuple(q + d for q, d in zip(p01, dp)))

    def _smooth(self, k, lv, f_mom01, f_cont01, uv01, p01, n_sweeps):
        def body(_, state):
            uv01, p01 = state
            return self._dgs_sweep(k, lv, f_mom01, f_cont01, uv01, p01)

        return jax.lax.fori_loop(0, n_sweeps, body, (uv01, p01))

    def _residual(self, k, lv, f_mom01, f_cont01, uv01, p01):
        A_uv = self._mv(lv["A"], uv01, k)
        G_p = self._mv(lv["G"], p01, k)
        D_uv = self._mv(lv["D"], uv01, k)
        return (tuple(f - a - g for f, a, g in zip(f_mom01, A_uv, G_p)),
                tuple(f - d for f, d in zip(f_cont01, D_uv)))

    # -- transfers ------------------------------------------------------------

    def _restrict(self, k, tr, r_mom01, r_cont01):
        t = self.transfers[k]
        if getattr(t, "kind", None) == "penalty":
            return r_mom01, r_cont01
        if t.kind == "polynomial":
            Ruv, Rp = tr
            mm = tuple(jax.lax.dot_general(Ruv, r, (((1,), (0,)), ((), ())),
                                           preferred_element_type=r.dtype)
                       for r in r_mom01)
            cc = tuple(jax.lax.dot_general(Rp, r, (((1,), (0,)), ((), ())),
                                           preferred_element_type=r.dtype)
                       for r in r_cont01)
            return mm, cc
        Tuv, Tp = tr
        out = []
        for T, r01 in ((Tuv, r_mom01), (Tp, r_cont01)):
            comp = []
            for cc in range(2):
                acc = None
                for cf in range(2):
                    part = _lane_tensor_apply(T[cc, cf], r01[cf])
                    acc = part if acc is None else acc + part
                comp.append(acc)
            out.append(tuple(comp))
        return out[0], out[1]

    def _prolong(self, k, tp, e_mom01, e_cont01):
        t = self.transfers[k]
        if getattr(t, "kind", None) == "penalty":
            return e_mom01, e_cont01
        if t.kind == "polynomial":
            Puv, Pp = tp
            mm = tuple(jax.lax.dot_general(Puv, e, (((1,), (0,)), ((), ())),
                                           preferred_element_type=e.dtype)
                       for e in e_mom01)
            cc = tuple(jax.lax.dot_general(Pp, e, (((1,), (0,)), ((), ())),
                                           preferred_element_type=e.dtype)
                       for e in e_cont01)
            return mm, cc
        Tuv, Tp = tp
        out = []
        for T, e01 in ((Tuv, e_mom01), (Tp, e_cont01)):
            comp = []
            for cf in range(2):
                acc = None
                for cc in range(2):
                    part = _lane_tensor_apply(T[cf, cc], e01[cc])
                    acc = part if acc is None else acc + part
                comp.append(acc)
            out.append(tuple(comp))
        return out[0], out[1]

    # -- cycle ----------------------------------------------------------------

    def _coarse_solve(self, consts, f_mom01, f_cont01, uv01, p01):
        levels, Rs, Ps, coarse = consts
        if coarse is None:
            return self._smooth(0, levels[0], f_mom01, f_cont01,
                                uv01, p01, 10)
        nu, npd = self.nu[0], self.npd[0]
        out_uv, out_p = [], []
        for co in range(2):
            acc = None
            for ci in range(2):
                f = jnp.concatenate([f_mom01[ci], f_cont01[ci]], axis=0)
                part = _lane_tensor_apply(coarse[co, ci], f)
                acc = part if acc is None else acc + part
            out_uv.append(acc[:2 * nu])
            out_p.append(acc[2 * nu:])
        return tuple(out_uv), tuple(out_p)

    def _cycle(self, k, consts, f_mom01, f_cont01, uv01, p01, mode=None):
        mode = mode or self.cycle_type
        levels, Rs, Ps, coarse = consts
        if k == 0:
            return self._coarse_solve(consts, f_mom01, f_cont01, uv01, p01)
        pre, post = self._cfg[self.types[k - 1]]
        uv01, p01 = self._smooth(k, levels[k], f_mom01, f_cont01,
                                 uv01, p01, pre)
        r_mom01, r_cont01 = self._residual(k, levels[k], f_mom01, f_cont01,
                                           uv01, p01)
        rc_mom01, rc_cont01 = self._restrict(k - 1, Rs[k - 1],
                                             r_mom01, r_cont01)
        z_uv = tuple(jnp.zeros_like(r) for r in rc_mom01)
        z_p = tuple(jnp.zeros_like(r) for r in rc_cont01)
        ec_uv, ec_p = self._cycle(k - 1, consts, rc_mom01, rc_cont01,
                                  z_uv, z_p, mode=mode)
        if mode in ("W", "F") and k - 1 > 0:
            # F revisits with a plain V (MultigridSolver.v_cycle semantics)
            ec_uv, ec_p = self._cycle(k - 1, consts, rc_mom01, rc_cont01,
                                      ec_uv, ec_p,
                                      mode="W" if mode == "W" else "V")
        pe_uv, pe_p = self._prolong(k - 1, Ps[k - 1], ec_uv, ec_p)
        uv01 = tuple(u + e for u, e in zip(uv01, pe_uv))
        p01 = tuple(q + e for q, e in zip(p01, pe_p))
        return self._smooth(k, levels[k], f_mom01, f_cont01, uv01, p01, post)

    def _fmg(self, consts, f_mom01, f_cont01):
        """Full-multigrid (nested-iteration) guess on the Stokes saddle
        hierarchy: restrict (f_mom, f_cont) to the coarsest level, solve,
        prolong upward with one configured cycle per level.  SoA analog of
        MultigridSolver.fmg_guess."""
        levels, Rs, Ps, coarse = consts
        rhss = [(f_mom01, f_cont01)]
        for k in range(self.n_lev - 1, 0, -1):
            rhss.append(self._restrict(k - 1, Rs[k - 1], *rhss[-1]))
        rhss = rhss[::-1]                       # coarsest first
        fm, fc = rhss[0]
        z_uv = tuple(jnp.zeros_like(r) for r in fm)
        z_p = tuple(jnp.zeros_like(r) for r in fc)
        uv01, p01 = self._coarse_solve(consts, fm, fc, z_uv, z_p)
        for k in range(1, self.n_lev):
            uv01, p01 = self._prolong(k - 1, Ps[k - 1], uv01, p01)
            uv01, p01 = self._cycle(k, consts, rhss[k][0], rhss[k][1],
                                    uv01, p01)
        return uv01, p01

    def build_fmg(self):
        """fmg(rhs) -> u0: the FMG guess as one jitted XLA graph."""
        consts = self._consts()

        @const_jit
        def fmg(rhs):
            self._masked(consts)
            f = self._to_soa(rhs.astype(self.dtype))
            uv01, p01 = self._fmg(consts, (f[0], f[1]), (f[2], f[3]))
            return self._from_soa(uv01[0], uv01[1], p01[0], p01[1])

        return fmg

    # -- layout conversion (XLA side) -----------------------------------------

    def _to_soa(self, x):
        """Global [all u; all v; all p] -> (uv0, uv1, p0, p1) lattices."""
        from dgtpu.models.stokes import _global_uv_to_elem
        from dgtpu.ops import rolled
        nj, ni = self.dims[-1]
        nh = ni // 2
        n = nj * ni
        nu, npd = self.nu[-1], self.npd[-1]
        uv = _global_uv_to_elem(x[:2 * n * nu], n, nu).reshape(nj, ni, 2 * nu)
        p = x[2 * n * nu:].reshape(nj, ni, npd)
        ev = rolled.parity_mask(nj, x.dtype)
        uv0, uv1 = rolled.pack_colors(uv, ev)
        p0, p1 = rolled.pack_colors(p, ev)
        sh = lambda a: a.reshape(nj * nh, -1).T
        return sh(uv0), sh(uv1), sh(p0), sh(p1)

    def _from_soa(self, uv0, uv1, p0, p1):
        from dgtpu.models.stokes import _elem_uv_to_global
        from dgtpu.ops import rolled
        nj, ni = self.dims[-1]
        nh = ni // 2
        ev = rolled.parity_mask(nj, uv0.dtype)
        un = lambda a, b: rolled.unpack_colors(
            a.T.reshape(nj, nh, -1), b.T.reshape(nj, nh, -1), ev)
        uv = un(uv0, uv1).reshape(-1)
        p = un(p0, p1).reshape(-1)
        n, nu = nj * ni, self.nu[-1]
        return jnp.concatenate([_elem_uv_to_global(uv, n, nu), p])

    # -- graph construction ---------------------------------------------------

    def _consts(self):
        """(levels, Rs, Ps, coarse): the operands the cycle closes over."""
        names = ("A", "G", "D", "A_Dinv", "DG_diag", "DG_Dinv")
        levels = []
        for k in range(self.n_lev):
            lv = {name: tuple(getattr(self, name)[k]) for name in names}
            lv["m"] = self.masks[k]
            levels.append(lv)
        return levels, list(self.soa_R), list(self.soa_P), self.coarse

    def _masked(self, consts):
        """Stage the per-level masks list used by _nbr_fields."""
        levels = consts[0]
        self._masks_r = [lv["m"] for lv in levels]

    def build_xla(self):
        """One Stokes DGS cycle ``(rhs, u) -> u`` as a jitted XLA graph."""
        consts = self._consts()

        @const_jit
        def one_cycle(rhs, u):
            self._masked(consts)
            f = self._to_soa(rhs.astype(self.dtype))
            x = self._to_soa(u.astype(self.dtype))
            uv01, p01 = self._cycle(self.n_lev - 1, consts,
                                    (f[0], f[1]), (f[2], f[3]),
                                    (x[0], x[1]), (x[2], x[3]))
            return self._from_soa(uv01[0], uv01[1], p01[0], p01[1])

        return one_cycle

    def build_matvec(self):
        """f32 finest-level saddle matvec (flat global-order vectors) — the
        operator for Krylov-wrapped refinement
        (``make_refined_solver(inner='gmres')``)."""
        consts = self._consts()
        top = self.n_lev - 1

        @const_jit
        def matvec(x):
            self._masked(consts)
            s = self._to_soa(x.astype(self.dtype))
            zm = (jnp.zeros_like(s[0]), jnp.zeros_like(s[1]))
            zc = (jnp.zeros_like(s[2]), jnp.zeros_like(s[3]))
            # _residual(f, c, u, p) = f - A u; with f = 0 this is -A u
            rm, rc = self._residual(top, consts[0][top], zm, zc,
                                    (s[0], s[1]), (s[2], s[3]))
            return -self._from_soa(rm[0], rm[1], rc[0], rc[1])

        return matvec

    def to_device(self, device):
        put = lambda t: tuple(jax.device_put(x, device) for x in t)
        self.A = [put(t) for t in self.A]
        self.G = [put(t) for t in self.G]
        self.D = [put(t) for t in self.D]
        self.A_Dinv = [put(t) for t in self.A_Dinv]
        self.DG_diag = [put(t) for t in self.DG_diag]
        self.DG_Dinv = [put(t) for t in self.DG_Dinv]
        self.masks = [jax.device_put(m, device) for m in self.masks]
        self.soa_R = [None if r is None else put(r) for r in self.soa_R]
        self.soa_P = [None if p is None else put(p) for p in self.soa_P]
        if self.coarse is not None:
            self.coarse = jax.device_put(self.coarse, device)
        return self
