"""Constant-hoisting jit wrapper.

``jax.jit`` embeds arrays captured by closure into the compiled module as
literal constants.  Our solver builders (``MultigridSolver._build_solve``,
the SoA and rolled cycles, the mixed-precision refinement drivers) close over
whole operator hierarchies — at 64x64 p=5 the f64 stencil blocks alone are
~212 MB — so the serialized HLO reaches hundreds of MB, XLA spends minutes
constant-folding them, and the persistent compile cache balloons (observed:
an 871 MB cache entry for one V-cycle loop).

``const_jit`` fixes this generically: on the first call it traces the
function once with ``jax.make_jaxpr``, extracts the closure-captured arrays
(the jaxpr ``consts``), and re-jits an ``eval_jaxpr`` driver that takes them
as *runtime arguments*.  The compiled module then contains parameters instead
of literals — small HLO, fast compiles, same numerics.  ``jax.closure_convert``
does NOT do this (it only hoists tracers from an enclosing transformation;
concrete arrays stay baked — verified on jax 0.9.0).

The reference has no analogue (it never compiles anything); this is purely an
XLA-compilation-model concern.
"""

from __future__ import annotations

import jax
from jax import tree_util

from jax.core import eval_jaxpr as _eval_jaxpr


def _leaf_key(x):
    """Trace-cache key for one argument leaf: its abstract value."""
    aval = jax.typeof(x)
    return (aval.shape, str(aval.dtype), getattr(aval, "weak_type", False))


class const_jit:
    """Drop-in for ``jax.jit(fn)`` (positional-args functions) that hoists
    closure-captured arrays into runtime arguments.

    One trace per distinct argument signature (shapes/dtypes), exactly like
    ``jax.jit``.  Keyword arguments are not supported — every internal jit
    boundary in dgtpu is positional.
    """

    def __init__(self, fn):
        self._fn = fn
        self._cache = {}
        # keep the jax.jit-like attribute surface small but useful
        self.__wrapped__ = fn

    def _entry(self, args):
        leaves, treedef = tree_util.tree_flatten(args)
        key = (treedef, tuple(_leaf_key(x) for x in leaves))
        entry = self._cache.get(key)
        if entry is None:
            closed, out_shape = jax.make_jaxpr(
                self._fn, return_shape=True)(*args)
            out_tree = tree_util.tree_structure(out_shape)
            jaxpr = closed.jaxpr

            def run(consts, flat_args):
                out = _eval_jaxpr(jaxpr, consts, *flat_args)
                return tree_util.tree_unflatten(out_tree, out)

            entry = (jax.jit(run), list(closed.consts))
            self._cache[key] = entry
        return entry

    def __call__(self, *args):
        leaves, _ = tree_util.tree_flatten(args)
        run, consts = self._entry(args)
        return run(consts, leaves)

    def lower(self, *args):
        """Mirror jax.jit's .lower() (used by __graft_entry__ compile checks)."""
        leaves, _ = tree_util.tree_flatten(args)
        run, consts = self._entry(args)
        return run.lower(consts, leaves)
