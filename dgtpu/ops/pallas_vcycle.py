"""The whole multigrid V-cycle as one jitted graph in the rolled layout.

Operators are stored as rolled (Nj, Ni, 5, B, B) lattices (``ops/rolled.py``)
and the cycle — pre-smooths, residual, restriction, recursion, coarse solve,
prolongation, post-smooths — is traced as one XLA program.  It is the f32
inner cycle of the Poisson mixed-precision route (``api.DGFEM``); the XLA
multi-op path (solvers/multigrid.py) remains the reference implementation.

The block matvecs are single-batch ``dot_general``s, colors are selected by
precomputed float masks, tile gathers and scatters are leading-dim reshapes,
and the dense coarse solve is a loop of per-tile block matvecs over a
column-blocked inverse, so the graph size does not grow with the coarse grid.

Supports p-/penalty-/geometric transfers and red-black smoothing in f32/f64.
"""

import jax
import jax.numpy as jnp

from dgtpu.utils.jitting import const_jit

from dgtpu.ops import rolled
from dgtpu.ops.linalg import host_inv, host_lu_inverse


def _tile_restrict(r, R4, nj_c, ni_c):
    """(2nj_c, 2ni_c, B) x (4, B_c, B) -> (nj_c, ni_c, B_c).

    The per-child split of the restriction matrix (host-precomputed) turns
    the tile gather into a sum of four dots, with no last-dim concatenate.
    """
    B = r.shape[-1]
    v = r.reshape(nj_c, 2, ni_c, 2, B)
    acc = None
    for k, (b, a) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        part = jax.lax.dot_general(v[:, b, :, a, :], R4[k],
                                   (((2,), (1,)), ((), ())),
                                   preferred_element_type=r.dtype)
        acc = part if acc is None else acc + part
    return acc


def _tile_prolong(e, P4, nj_c, ni_c):
    """(nj_c, ni_c, B_c) x (4, B, B_c) -> (2nj_c, 2ni_c, B), child interleave."""
    B = P4.shape[1]
    ch = [jax.lax.dot_general(e, P4[k], (((2,), (1,)), ((), ())),
                              preferred_element_type=e.dtype)
          for k in range(4)]                              # (cj, ci) order
    rows = []
    for b in (0, 1):
        c0 = ch[b * 2 + 0].reshape(nj_c, ni_c, 1, B)
        c1 = ch[b * 2 + 1].reshape(nj_c, ni_c, 1, B)
        rows.append(jnp.concatenate([c0, c1], axis=2).reshape(nj_c, 2 * ni_c, B))
    r0 = rows[0].reshape(nj_c, 1, 2 * ni_c, B)
    r1 = rows[1].reshape(nj_c, 1, 2 * ni_c, B)
    return jnp.concatenate([r0, r1], axis=1).reshape(2 * nj_c, 2 * ni_c, B)


class PallasVCycle:
    """Builds the rolled-layout cycle from an assembled hierarchy.

    Parameters mirror MultigridSolver; ``dims``: [(Nj, Ni)] per level,
    coarsest first.  The coarse level follows the configured
    coarse_grid_solver: 'smoother' -> 10 red-black iterations,
    'direct'/'amg' -> cached dense inverse applied as blocked accumulation.
    """

    def __init__(self, ops, transfers, types, settings, dims,
                 dtype=jnp.float32):
        self.settings = settings
        self.types = types
        self.transfers = transfers
        self.dtype = dtype
        self.n_lev = len(ops)
        self.dims = list(dims)
        self.blocks = [rolled.to_rolled(op, self.dims[k][1], self.dims[k][0])
                       .astype(dtype) for k, op in enumerate(ops)]
        self.Dinv = [host_inv(b[:, :, 0]).astype(dtype) for b in self.blocks]
        self.masks = [rolled.color_masks(nj, ni, dtype) for nj, ni in self.dims]
        # color-split packing (gather-free ColorPack): halves the block
        # traffic and FLOPs of every color pass; needs an even Ni per level
        self.use_split = all(ni % 2 == 0 for _, ni in self.dims)
        if self.use_split:
            self.split_blocks, self.split_Dinv, self.evens = [], [], []
            for b, d, (nj, ni) in zip(self.blocks, self.Dinv, self.dims):
                bc, dc = rolled.pack_operator_colors(b, d)
                self.split_blocks.append(bc)
                self.split_Dinv.append(dc)
                self.evens.append(rolled.parity_mask(nj, dtype))
        self.cycle_type = str(getattr(settings.solver.multigrid,
                                      "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise NotImplementedError(
                f"the rolled and SoA cycles implement V, W and F, not "
                f"{self.cycle_type!r}")
        self.coarse_solver = settings.solver.multigrid.coarse_grid_solver
        if self.coarse_solver in ("direct", "amg"):
            nj0, ni0 = self.dims[0]
            B0 = self.blocks[0].shape[-1]
            inv = host_lu_inverse(ops[0].to_dense()).astype(dtype)
            # column-blocked layout (M_src, nj, ni, B_dst, B_src): slice m
            # scales source cell m's rhs into the whole coarse grid.  The
            # solve is then a fori_loop of M bmv-accumulations with dynamic
            # leading-dim indexing — graph size O(1) in the coarse grid
            # (a statically unrolled double loop grows with it).
            import numpy as np
            M0 = nj0 * ni0
            inv_col = (np.asarray(inv).reshape(M0, B0, M0, B0)
                       .transpose(2, 0, 1, 3)
                       .reshape(M0, nj0, ni0, B0, B0))
            self.coarse_inv_col = jnp.asarray(inv_col)
        else:
            self.coarse_inv_col = None
        self._cfg = {}
        for t in set(types):
            node = getattr(settings.solver.multigrid, f"{t}_coarsening")
            self._cfg[t] = (int(node.pre_smoother.iterations),
                            int(node.post_smoother.iterations))
        # geometric transfers are stored per-child: (4, B_c, B) / (4, B, B_c)
        self.R, self.P = [], []
        for t in transfers:
            if t.kind == "geometric":
                B = t.R.shape[1] // 4
                self.R.append(jnp.stack(
                    [t.R[:, k * B:(k + 1) * B] for k in range(4)]).astype(dtype))
                self.P.append(jnp.stack(
                    [t.P[k * B:(k + 1) * B, :] for k in range(4)]).astype(dtype))
            else:
                self.R.append(t.R.astype(dtype))
                self.P.append(t.P.astype(dtype))

    # ---- value-level cycle ----------------------------------------------------

    def _restrict(self, k, R, r):
        t = self.transfers[k]
        nj_c, ni_c = self.dims[k]
        if t.kind == "penalty":
            return r
        if t.kind == "geometric":
            return _tile_restrict(r, R, nj_c, ni_c)
        return jax.lax.dot_general(r, R, (((2,), (1,)), ((), ())),
                                   preferred_element_type=r.dtype)

    def _prolong(self, k, P, e):
        t = self.transfers[k]
        nj_c, ni_c = self.dims[k]
        if t.kind == "penalty":
            return e
        if t.kind == "geometric":
            return _tile_prolong(e, P, nj_c, ni_c)
        return jax.lax.dot_general(e, P, (((2,), (1,)), ((), ())),
                                   preferred_element_type=e.dtype)

    def _smooth(self, k, consts, rhs, u, n_pass):
        blocks, Dinv, sel, Rs, Ps, inv_col = consts
        if self.use_split:
            even = sel[k]
            uc = rolled.pack_colors(u, even)
            rc = rolled.pack_colors(rhs, even)
            u0, u1 = rolled.rb_gs_sweeps_split(blocks[k], Dinv[k], rc, uc,
                                               even, n_pass)
            return rolled.unpack_colors(u0, u1, even)
        return rolled.rb_gs_sweeps_masked(blocks[k], Dinv[k], rhs, u,
                                          sel[k], n_pass)

    def _residual(self, k, consts, rhs, u):
        blocks, Dinv, sel, Rs, Ps, inv_col = consts
        if self.use_split:
            even = sel[k]
            uc = rolled.pack_colors(u, even)
            r0, r1 = rolled.matvec_split(blocks[k], uc, even)
            return rhs - rolled.unpack_colors(r0, r1, even)
        return rhs - rolled.matvec(blocks[k], u)

    def _coarse_solve(self, consts, rhs, u):
        blocks, Dinv, sel, Rs, Ps, inv_col = consts
        nj, ni = self.dims[0]
        if inv_col is None:
            # 10 iterations of the pre-smoother (solver.py:199-204 semantics)
            return self._smooth(0, consts, rhs, u, 20)
        B = rhs.shape[-1]
        rhs_flat = rhs.reshape(nj * ni, B)

        def body(m, acc):
            return acc + rolled.bmv(inv_col[m], rhs_flat[m])

        return jax.lax.fori_loop(0, nj * ni, body, jnp.zeros_like(rhs))

    def _cycle(self, k, consts, rhs, u, mode=None):
        mode = mode or self.cycle_type
        if k == 0:
            return self._coarse_solve(consts, rhs, u)
        _, _, _, Rs, Ps, _ = consts
        pre, post = self._cfg[self.types[k - 1]]
        u = self._smooth(k, consts, rhs, u, 2 * pre)
        r = self._residual(k, consts, rhs, u)
        r_c = self._restrict(k - 1, Rs[k - 1], r)
        e_c = self._cycle(k - 1, consts, r_c, jnp.zeros_like(r_c), mode=mode)
        if mode in ("W", "F") and k - 1 > 0:
            # F revisits with a plain V (MultigridSolver.v_cycle semantics)
            e_c = self._cycle(k - 1, consts, r_c, e_c,
                              mode="W" if mode == "W" else "V")
        u = u + self._prolong(k - 1, Ps[k - 1], e_c)
        u = self._smooth(k, consts, rhs, u, 2 * post)
        return u

    def _fmg(self, consts, rhs):
        """Full-multigrid (nested-iteration) guess in rolled layout:
        restrict the rhs to the coarsest level, solve, prolong upward with
        one configured cycle per level (MultigridSolver.fmg_guess analog)."""
        _, _, _, Rs, Ps, _ = consts
        rhss = [rhs]
        for k in range(self.n_lev - 1, 0, -1):
            rhss.append(self._restrict(k - 1, Rs[k - 1], rhss[-1]))
        rhss = rhss[::-1]                   # coarsest first
        u = self._coarse_solve(consts, rhss[0], jnp.zeros_like(rhss[0]))
        for k in range(1, self.n_lev):
            u = self._prolong(k - 1, Ps[k - 1], u)
            u = self._cycle(k, consts, rhss[k], u)
        return u

    def build_fmg(self):
        """fmg(rhs) -> u0: the FMG guess as one jitted XLA graph."""
        nj, ni = self.dims[-1]
        B = self.blocks[-1].shape[-1]
        consts = self._host_consts() + (list(self.R), list(self.P),
                                        self.coarse_inv_col)

        @const_jit
        def fmg(rhs):
            r = rhs.astype(self.dtype).reshape(nj, ni, B)
            return self._fmg(consts, r).reshape(-1)

        return fmg

    # ---- graph construction --------------------------------------------------

    def _host_consts(self):
        """The per-level operator tuples in the active layout."""
        if self.use_split:
            return (list(self.split_blocks), list(self.split_Dinv),
                    list(self.evens))
        return (list(self.blocks), list(self.Dinv), list(self.masks))

    def build_xla(self):
        """One rolled-layout cycle ``(rhs, u) -> u`` as a jitted XLA graph."""
        nj, ni = self.dims[-1]
        B = self.blocks[-1].shape[-1]
        consts = self._host_consts() + (list(self.R), list(self.P),
                                        self.coarse_inv_col)

        @const_jit
        def one_cycle(rhs, u):
            rhs = rhs.reshape(nj, ni, B).astype(self.dtype)
            u = u.reshape(nj, ni, B).astype(self.dtype)
            out = self._cycle(self.n_lev - 1, consts, rhs, u)
            return out.reshape(-1)

        return one_cycle

    def to_device(self, device):
        for name in ("blocks", "Dinv", "masks", "R", "P"):
            setattr(self, name, [jax.device_put(x, device)
                                 for x in getattr(self, name)])
        if self.use_split:
            self.split_blocks = [tuple(jax.device_put(x, device) for x in bc)
                                 for bc in self.split_blocks]
            self.split_Dinv = [tuple(jax.device_put(x, device) for x in dc)
                               for dc in self.split_Dinv]
            self.evens = [jax.device_put(e, device) for e in self.evens]
        if self.coarse_inv_col is not None:
            self.coarse_inv_col = jax.device_put(self.coarse_inv_col, device)
        return self
