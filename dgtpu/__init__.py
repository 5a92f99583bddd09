"""dgtpu — a JAX/XLA Discontinuous Galerkin multigrid framework.

Re-designed from scratch with the capabilities of the reference
``thmsdelange/dg-multigrid-solver`` (a NumPy/SciPy/pyAMG thesis code, see
SURVEY.md): SIP-DG discretization of the Poisson and Stokes equations on
structured curvilinear quadrilateral grids (Plot3D input), with direct,
smoother, Krylov, AMG and p-/h-/penalty multigrid solvers, validated by the
Method of Manufactured Solutions.

Architectural translation (not a port):

* per-element/per-face Python objects  ->  batched dense tensors on device
* scipy BSR operator                   ->  block-stencil tensor A[N,5,B,B]
                                           + neighbor index map (gather/einsum)
* pyamg C++ smoother kernels           ->  batched / red-black colored block
                                           solves (XLA)
* sympy manufactured solutions         ->  JAX autodiff of parsed expressions
* per-solve Python loops               ->  jax.lax.while_loop / scan, one jit

Double precision is enabled globally: the reference semantics are float64 and
the parity target is 1e-10. Performance-mode float32 paths are opt-in, and
their matrix products run at full float32 precision ("highest"), so a GPU
does not round them to TF32 and the f32 cycles contract as they do on the
CPU.
"""

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
