"""Setup-time linear algebra placed on host.

Set-up runs on the host (``dgtpu.utils.device``), so float64 inversions
(mass matrices, block-diagonal smoother inverses, coarse-level dense
factorizations) run on host LAPACK via numpy at setup time.  Everything in
the solver hot loops is then matmul/einsum on the compute device, in f64 or
f32.
"""

import jax.numpy as jnp
import numpy as np


def host_inv(M):
    """Batched matrix inverse computed on host, returned as a jnp array."""
    return jnp.asarray(np.linalg.inv(np.asarray(M)))


def host_solve(A, b):
    return jnp.asarray(np.linalg.solve(np.asarray(A), np.asarray(b)))


def host_lu_inverse(A):
    """Dense inverse for cached coarse/direct solves (applied as a matmul)."""
    return jnp.asarray(np.linalg.inv(np.asarray(A)))
