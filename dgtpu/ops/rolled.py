"""Roll-layout stencil operations.

The gather-based StencilOperator is the general representation; the
structured element grid also allows a gather-free layout::

    blocks : (Nj, Ni, 5, B, B)    vectors : (Nj, Ni, B)

where the i-neighbors are circular rolls along axis 1 and the j-neighbors
shifts along axis 0 (zero halos at physical boundaries — the corresponding
blocks are zero, so rolls are harmless even for Dirichlet topologies, and
exact for O-grid wrap).  These value-level functions are shared by the
rolled-layout cycle (``ops/pallas_vcycle.py``), the SoA cycles' layout
conversions, and the shard_map halo version (which replaces the j-shifts
with ppermute exchanges).
"""

import jax
import jax.numpy as jnp


def bmv(blocks, u):
    """Batched block matvec (..., a, b) x (..., b) -> (..., a).

    Leading batch dims are flattened into ONE batch dim and the contraction
    runs as a single-batch ``dot_general``, one batched matrix-vector op
    regardless of the grid shape.

    ``u`` may also be a single vector (b,) broadcast against every block
    (the coarse-solve accumulation uses this).
    """
    a, b = blocks.shape[-2], blocks.shape[-1]
    bf = blocks.reshape(-1, a, b)
    if u.ndim == 1:
        out = jax.lax.dot_general(bf, u, (((2,), (0,)), ((), ())),
                                  preferred_element_type=u.dtype)
    else:
        out = jax.lax.dot_general(bf, u.reshape(-1, b),
                                  (((2,), (1,)), ((0,), (0,))),
                                  preferred_element_type=u.dtype)
    return out.reshape(*blocks.shape[:-2], a)


def to_rolled(op, Ni, Nj):
    """StencilOperator blocks -> (Nj, Ni, 5, B, B)."""
    n, s, br, bc = op.blocks.shape
    assert n == Ni * Nj and s == 5
    return op.blocks.reshape(Nj, Ni, 5, br, bc)


def vec_to_rolled(v, Ni, Nj, B):
    return v.reshape(Nj, Ni, B)


def _shift_j(u, up):
    """Neighbor fields in the j direction with zero halos."""
    if u.shape[0] == 1:
        # a single row's j-neighbors are both zero halos
        return jnp.zeros_like(u)
    zero = jnp.zeros_like(u[:1])
    if up:
        return jnp.concatenate([zero, u[:-1]], axis=0)     # j-1 neighbor values
    return jnp.concatenate([u[1:], zero], axis=0)          # j+1


def neighbor_fields(u):
    """(u_iL, u_iR, u_jL, u_jR) for a (Nj, Ni, B) field."""
    return (jnp.roll(u, 1, axis=1), jnp.roll(u, -1, axis=1),
            _shift_j(u, True), _shift_j(u, False))


def matvec(blocks, u):
    u_iL, u_iR, u_jL, u_jR = neighbor_fields(u)
    out = bmv(blocks[:, :, 0], u)
    out += bmv(blocks[:, :, 1], u_iL)
    out += bmv(blocks[:, :, 2], u_iR)
    out += bmv(blocks[:, :, 3], u_jL)
    out += bmv(blocks[:, :, 4], u_jR)
    return out


def offdiag_matvec(blocks, u):
    u_iL, u_iR, u_jL, u_jR = neighbor_fields(u)
    out = bmv(blocks[:, :, 1], u_iL)
    out += bmv(blocks[:, :, 2], u_iR)
    out += bmv(blocks[:, :, 3], u_jL)
    out += bmv(blocks[:, :, 4], u_jR)
    return out


def checkerboard(Nj, Ni, dtype=jnp.int32):
    j = jnp.arange(Nj)[:, None]
    i = jnp.arange(Ni)[None, :]
    return ((i + j) % 2).astype(dtype)


def rb_gs_sweeps(blocks, Dinv, rhs, u, colors, n_color_passes):
    """n_color_passes red/black half-sweeps (2 per symmetric GS iteration).

    The pass loop is a ``fori_loop`` (value carry) so the body compiles
    once instead of once per pass.
    """
    def body(_, u):
        for c in (0, 1):
            off = offdiag_matvec(blocks, u)
            unew = bmv(Dinv[...], rhs - off)
            u = jnp.where((colors == c)[:, :, None], unew, u)
        return u

    return jax.lax.fori_loop(0, n_color_passes, body, u)


def color_masks(Nj, Ni, dtype):
    """Float checkerboard masks (2, Nj, Ni, 1): colors are selected by
    multiply-blend instead of integer compare + where."""
    import numpy as np
    cb = np.asarray(checkerboard(Nj, Ni))
    return jnp.asarray(np.stack([(cb == 0), (cb == 1)])
                       .astype(np.dtype(dtype))[:, :, :, None])


def rb_gs_sweeps_masked(blocks, Dinv, rhs, u, masks, n_color_passes):
    """rb_gs_sweeps with precomputed float masks."""
    def body(_, u):
        for c in (0, 1):
            off = offdiag_matvec(blocks, u)
            unew = bmv(Dinv[...], rhs - off)
            u = masks[c] * unew + (1.0 - masks[c]) * u
        return u

    return jax.lax.fori_loop(0, n_color_passes, body, u)


def jacobi_sweeps(blocks, Dinv, rhs, u, n, omega=0.8):
    def body(_, u):
        off = offdiag_matvec(blocks, u)
        unew = bmv(Dinv[...], rhs - off)
        return omega * unew + (1 - omega) * u

    return jax.lax.fori_loop(0, n, body, u)


# ---------------------------------------------------------------------------
# Color-split layout: red-black packing with NO gathers (rolls + parity masks)
# ---------------------------------------------------------------------------
#
# For even Ni the checkerboard colors pack into two (Nj, Ni/2, ...) lattices:
# color 0 sits at i = 2*ip + (j % 2), color 1 at i = 2*ip + 1 - (j % 2).
# Neighbor fields of one color are row-parity-dependent rolls of the *other*
# color's lattice, so a packed red-black sweep touches exactly half the
# operator per color pass (the ColorPack win) while staying expressible with
# rolls, shifts and float masks only.


def parity_mask(Nj, dtype):
    """(Nj, 1, 1) float mask: 1.0 on even rows, 0.0 on odd rows."""
    import numpy as np
    return jnp.asarray((np.arange(Nj) % 2 == 0)
                       .astype(np.dtype(dtype))[:, None, None])


def pack_colors(u, even):
    """(Nj, Ni, B) -> (u_c0, u_c1) each (Nj, Ni/2, B).

    ``even``: parity_mask(Nj).  Color 0 occupies even i on even rows.
    """
    Nj, Ni, B = u.shape
    pairs = u.reshape(Nj, Ni // 2, 2, B)
    a, b = pairs[:, :, 0], pairs[:, :, 1]
    u0 = even * a + (1.0 - even) * b
    u1 = even * b + (1.0 - even) * a
    return u0, u1


def unpack_colors(u0, u1, even):
    """Inverse of pack_colors."""
    Nj, Nh, B = u0.shape
    a = even * u0 + (1.0 - even) * u1
    b = even * u1 + (1.0 - even) * u0
    a = a.reshape(Nj, Nh, 1, B)
    b = b.reshape(Nj, Nh, 1, B)
    return jnp.concatenate([a, b], axis=2).reshape(Nj, 2 * Nh, B)


def _rowsel(even, x_even, x_odd):
    return even * x_even + (1.0 - even) * x_odd


def split_neighbor_fields(other, color, even):
    """(iL, iR, jL, jR) neighbor fields of cells of ``color``, read from the
    opposite color's packed lattice ``other`` (Nj, Ni/2, B).

    i-rolls wrap (exact for O-grids; wrapped blocks are zero otherwise);
    j-shifts use zero halos, matching ``neighbor_fields``.
    """
    if other.shape[1] == 1:
        # Ni == 2: the packed lattice is one cell wide, a roll by +-1 is
        # the identity
        roll_p = roll_m = other
    else:
        roll_p = jnp.roll(other, 1, axis=1)     # ip - 1
        roll_m = jnp.roll(other, -1, axis=1)    # ip + 1
    if color == 0:
        u_iL = _rowsel(even, roll_p, other)
        u_iR = _rowsel(even, other, roll_m)
    else:
        u_iL = _rowsel(even, other, roll_p)
        u_iR = _rowsel(even, roll_m, other)
    u_jL = _shift_j(other, True)
    u_jR = _shift_j(other, False)
    return u_iL, u_iR, u_jL, u_jR


def pack_operator_colors(blocks, Dinv=None):
    """Host-side: (Nj, Ni, 5, B, B) -> per-color packed blocks (+ Dinv).

    Returns ((blocks_c0, blocks_c1), (Dinv_c0, Dinv_c1) or None); each
    packed array is (Nj, Ni/2, 5, B, B) in the pack_colors cell ordering.
    """
    import numpy as np
    blocks = np.asarray(blocks)
    Nj, Ni = blocks.shape[:2]
    assert Ni % 2 == 0, "color-split packing needs an even Ni"
    j = np.arange(Nj)[:, None]
    ip = np.arange(Ni // 2)[None, :]
    i_c0 = 2 * ip + (j % 2)
    i_c1 = 2 * ip + 1 - (j % 2)
    jj = np.broadcast_to(j, i_c0.shape)
    out_b = (jnp.asarray(blocks[jj, i_c0]), jnp.asarray(blocks[jj, i_c1]))
    if Dinv is None:
        return out_b, None
    Dinv = np.asarray(Dinv)
    return out_b, (jnp.asarray(Dinv[jj, i_c0]), jnp.asarray(Dinv[jj, i_c1]))


def _split_off(blocks_c, other, color, even):
    u_iL, u_iR, u_jL, u_jR = split_neighbor_fields(other, color, even)
    out = bmv(blocks_c[:, :, 1], u_iL)
    out += bmv(blocks_c[:, :, 2], u_iR)
    out += bmv(blocks_c[:, :, 3], u_jL)
    out += bmv(blocks_c[:, :, 4], u_jR)
    return out


def rb_gs_sweeps_split(blocks_c, Dinv_c, rhs_c, u_c, even, n_color_passes):
    """Packed red-black sweeps in the color-split layout.

    ``blocks_c``/``Dinv_c``/``rhs_c``/``u_c``: (color0, color1) tuples of
    packed arrays; returns the updated (u0, u1).  Bit-identical math to
    ``rb_gs_sweeps_masked`` with half the block traffic and FLOPs per pass.
    """
    def body(_, uu):
        u0, u1 = uu
        off0 = _split_off(blocks_c[0], u1, 0, even)
        u0 = bmv(Dinv_c[0][...], rhs_c[0] - off0)
        off1 = _split_off(blocks_c[1], u0, 1, even)
        u1 = bmv(Dinv_c[1][...], rhs_c[1] - off1)
        return u0, u1

    return jax.lax.fori_loop(0, n_color_passes, body, u_c)


def matvec_split(blocks_c, u_c, even):
    """A @ u in the color-split layout; returns (r0, r1)."""
    u0, u1 = u_c
    r0 = bmv(blocks_c[0][:, :, 0], u0) + _split_off(blocks_c[0], u1, 0, even)
    r1 = bmv(blocks_c[1][:, :, 0], u1) + _split_off(blocks_c[1], u0, 1, even)
    return r0, r1
