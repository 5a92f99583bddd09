"""Block-stencil operators — the batched replacement for scipy BSR.

The reference assembles a scipy ``bsr_array`` with at most 5 blocks per block
row (self + 4 neighbors, ``discrete_system.py:135-145``).  On an accelerator
the natural layout is a dense *stencil tensor*::

    blocks : (N, 5, Br, Bc)   slot order [self, iL, iR, jL, jR]
    nbr    : (N, 5) int32     neighbor element index (self for masked slots)
    mask   : (N, 5) bool      False where no neighbor (blocks are zero there)

Matvec is one gather + one batched einsum — static shapes, no sparse
formats.  Operators compose into saddle-point block matrices for
Stokes (see ``dgtpu/models/stokes.py``).

``DenseOperator`` covers derived operators whose sparsity is wider than the
5-point stencil (Schur complements, D@G products) — at the reference's
problem sizes these are small enough that dense is the fast layout.
"""

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class StencilOperator:
    """5-point block-stencil linear operator on element-blocked vectors."""

    blocks: jnp.ndarray   # (N, 5, Br, Bc)
    nbr: jnp.ndarray      # (N, 5) int32
    mask: jnp.ndarray     # (N, 5) bool

    def tree_flatten(self):
        return (self.blocks, self.nbr, self.mask), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_elem(self):
        return self.blocks.shape[0]

    @property
    def block_shape(self):
        return self.blocks.shape[2], self.blocks.shape[3]

    @property
    def shape(self):
        n, _, br, bc = self.blocks.shape
        return (n * br, n * bc)

    def astype(self, dtype):
        return StencilOperator(self.blocks.astype(dtype), self.nbr, self.mask)

    def matvec(self, u):
        """A @ u for u of shape (N*Bc,) (or (N, Bc))."""
        n, _, br, bc = self.blocks.shape
        u = u.reshape(n, bc)
        u_nbr = u[self.nbr]                       # (N, 5, Bc)
        out = jnp.einsum("nsij,nsj->ni", self.blocks, u_nbr)
        return out.reshape(n * br)

    def diag_blocks(self):
        return self.blocks[:, 0]

    def offdiag_matvec(self, u):
        """(A - D) @ u."""
        n, _, br, bc = self.blocks.shape
        u = u.reshape(n, bc)
        u_nbr = u[self.nbr[:, 1:]]
        out = jnp.einsum("nsij,nsj->ni", self.blocks[:, 1:], u_nbr)
        return out.reshape(n * br)

    def to_dense(self):
        """Materialize the full matrix (for direct solves / tests)."""
        n, _, br, bc = self.blocks.shape
        dense = jnp.zeros((n * br, n * bc), dtype=self.blocks.dtype)
        rows = (jnp.arange(n)[:, None, None, None] * br
                + jnp.arange(br)[None, None, :, None])          # (N,1,Br,1)
        cols = (self.nbr[:, :, None, None] * bc
                + jnp.arange(bc)[None, None, None, :])          # (N,5,1,Bc)
        rows = jnp.broadcast_to(rows, self.blocks.shape)
        cols = jnp.broadcast_to(cols, self.blocks.shape)
        vals = jnp.where(self.mask[:, :, None, None], self.blocks, 0.0)
        return dense.at[rows.ravel(), cols.ravel()].add(vals.ravel())

    def premultiply_blockdiag(self, M):
        """Return ``diag(M) @ A`` for per-element matrices M (N, Br', Br).

        Used for the inverse-mass premultiply (discrete_system.py:139-142).
        """
        blocks = jnp.einsum("nij,nsjk->nsik", M, self.blocks)
        return StencilOperator(blocks, self.nbr, self.mask)

    def scale(self, alpha):
        return StencilOperator(self.blocks * alpha, self.nbr, self.mask)

    def add(self, other):
        """Sum of two stencils on the same topology."""
        return StencilOperator(self.blocks + other.blocks, self.nbr, self.mask)

    def lower_upper_masks(self):
        """Boolean slot masks for the strict block lower (E) / upper (F) parts.

        Matches the reference's ``split_block_EDF`` (relaxation.py:443-492):
        E = blocks with neighbor index < row index, F = index > row.
        """
        n = self.blocks.shape[0]
        row = jnp.arange(n)[:, None]
        lower = (self.nbr < row) & self.mask
        upper = (self.nbr > row) & self.mask
        return lower, upper


def stencil_from_contributions(diag, iL, iR, jL, jR, nbr, mask):
    """Stack per-slot block arrays into a StencilOperator, zeroing masked slots."""
    blocks = jnp.stack([diag, iL, iR, jL, jR], axis=1)
    blocks = jnp.where(mask[:, :, None, None], blocks, 0.0)
    return StencilOperator(blocks, jnp.asarray(nbr, dtype=jnp.int32), jnp.asarray(mask))


@jax.tree_util.register_pytree_node_class
@dataclass
class DenseOperator:
    """A dense matrix with the same operator protocol as StencilOperator."""

    A: jnp.ndarray

    def tree_flatten(self):
        return (self.A,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.A.shape

    def astype(self, dtype):
        return DenseOperator(self.A.astype(dtype))

    def matvec(self, u):
        return self.A @ u

    def to_dense(self):
        return self.A

    def block_partition(self, blocksize):
        n = self.A.shape[0] // blocksize
        return self.A.reshape(n, blocksize, n, blocksize).transpose(0, 2, 1, 3)

    def diag_blocks_of(self, blocksize):
        part = self.block_partition(blocksize)
        return part[jnp.arange(part.shape[0]), jnp.arange(part.shape[0])]


def as_dense_operator(op):
    if isinstance(op, DenseOperator):
        return op
    return DenseOperator(op.to_dense())


# ---------------------------------------------------------------------------
# Generic sequential block Gauss-Seidel on a dense matrix (parity kernel)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(3, 4))
def dense_block_gs_sweep(A, b, x, blocksize, backward=False, Dinv=None):
    """One forward (or backward) block-GS sweep on a dense matrix.

    Semantics of pyamg's ``amg_core.block_gauss_seidel``: for each block row i
    in order, ``x_i <- Dinv_i @ (b_i - sum_{j != i} A_ij x_j)`` with already-
    updated values for preceding rows.  Runs as a lax.scan (sequential, exact
    reference parity); use the red-black variants in ``ops/smoothers.py`` for
    the parallel fast path.
    """
    nb = A.shape[0] // blocksize
    Ab = A.reshape(nb, blocksize, nb * blocksize)
    bb = b.reshape(nb, blocksize)
    if Dinv is None:
        diag = A.reshape(nb, blocksize, nb, blocksize)
        Dinv = jnp.linalg.inv(diag[jnp.arange(nb), :, jnp.arange(nb), :])
    order = jnp.arange(nb)[::-1] if backward else jnp.arange(nb)

    def step(x, i):
        row = Ab[i]                       # (B, N*B)
        xi = jax.lax.dynamic_slice(x, (i * blocksize,), (blocksize,))
        Aii = jax.lax.dynamic_slice(row, (0, i * blocksize), (blocksize, blocksize))
        rhs = bb[i] - (row @ x - Aii @ xi)
        xi_new = Dinv[i] @ rhs
        x = jax.lax.dynamic_update_slice(x, xi_new, (i * blocksize,))
        return x, None

    x, _ = jax.lax.scan(step, x, order)
    return x
