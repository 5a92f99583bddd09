"""Device-placement policy and the persistent compile cache.

Setup (geometry, assembly, factorizations) always runs on the host CPU
backend: it executes once, is dominated by many small eager ops, and its
f64 factorizations use host LAPACK.  The solver hot loops are then
explicitly placed on the compute device by moving the operator pytrees
(StencilOperator / StokesGlobalOperator / TransferOp) and vectors; jit
follows the committed inputs.  Nothing here falls back to another device:
a requested platform that is not present is an error.
"""

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(dirname=".jax_cache"):
    """Turn on JAX's persistent compilation cache and return its path.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is; otherwise
    the cache lives at ``<checkout>/<dirname>``.  The path is part of the
    cache key, so it stays fixed.  Entry points call this once, before
    their first compile."""
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, dirname))
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def cpu_device():
    return jax.devices("cpu")[0]


def default_compute_device(settings=None):
    """The device the solve runs on: ``performance.device`` ('auto' = the
    default backend's first device, else a platform name such as 'cpu' or
    'gpu').  Raises when the named platform has no device."""
    name = "auto"
    if settings is not None:
        perf = getattr(settings, "performance", None)
        name = str(getattr(perf, "device", "auto") if perf else "auto")
    if name == "auto":
        return jax.devices()[0]
    try:
        devices = jax.devices(name)
    except RuntimeError as e:
        raise RuntimeError(
            f"performance.device: {name} but JAX has no {name!r} device "
            f"(available: {sorted({d.platform for d in jax.devices()})})"
        ) from e
    return devices[0]


def put_tree(tree, device):
    """device_put every jax array leaf of a pytree / plain object."""
    if tree is None:
        return None
    return jax.device_put(tree, device)


def put_transfer(t, device):
    t.R = jax.device_put(t.R, device)
    t.P = jax.device_put(t.P, device)
    return t


def setup_scope():
    """Context manager placing eager setup computation on the host CPU."""
    return jax.default_device(cpu_device())
