"""Direct solver: on-device dense LU (reference: SuperLU spsolve, solver.py:56-59).

The reference's problem sizes (e.g. 8x8 p=5 Poisson = 2304 DOF, Stokes local
order ~ 6k DOF) are trivially dense; f32 systems use jnp.linalg.solve on the
device, f64 systems host LAPACK.  For repeated coarse-level solves the LU
factors can be cached with :func:`lu_factor_dense`.
"""

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from dgtpu.ops.stencil import as_dense_operator


def solve_direct(op, rhs):
    A = as_dense_operator(op).A
    if A.dtype == jnp.float64:
        # host LAPACK, like every f64 factorization (see ops.linalg)
        import numpy as np
        return jnp.asarray(np.linalg.solve(np.asarray(A), np.asarray(rhs)))
    return jnp.linalg.solve(A, rhs)


def lu_factor_dense(op):
    A = as_dense_operator(op).A
    return jsl.lu_factor(A)


def lu_solve(lu, rhs):
    return jsl.lu_solve(lu, rhs)
