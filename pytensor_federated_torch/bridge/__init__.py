"""The PyTensor/PyMC bridge: only its pure grouping algorithm so far.

:func:`.grouping.group_independent` partitions the candidate applies of
a graph into groups of mutually independent ones; the ``fed`` window
fusion pass (:mod:`..fed.batching`) plans its windows with it.  The Op
surface, the fusion rewrite and the ``jax_funcify`` dispatches of the
JAX package's ``bridge/`` are not ported yet.
"""

from .grouping import group_independent

__all__ = ["group_independent"]
