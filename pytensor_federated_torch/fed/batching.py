"""Trace-time fusion pass: independent ``fed_map`` calls share a window.

The port of the JAX package's ``fed/batching.py``.  The reference needs
a global PyTensor graph rewrite (``AsyncFusionOptimizer``) to overlap
independent remote applies.  Here the model is ALREADY a graph with
``fed_map`` nodes in it (a :func:`.lowering.program`'s ``torch.fx``
graph), so the rewrite collapses to a planning pass over nodes: find
groups of ``fed_map`` nodes with no (transitive) data dependence
between them, and hand each multi-member group to the placement as ONE
``group_executor`` call — which the pool lane turns into a single
pipelined ``evaluate_many`` window (placements.py).  The independence
algorithm is the one the PyTensor rewriter uses
(``bridge/grouping.group_independent``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

from ..bridge.grouping import group_independent
from .primitives import fed_map_p

__all__ = ["plan_windows"]


def plan_windows(graph: Any) -> Dict[Any, List[Any]]:
    """Map each fused ``fed_map`` node of ``graph`` to its group (a list
    of mutually independent nodes, in graph order).  Only groups of two
    or more appear — singletons lower one call at a time.  Safety is
    inherited from ``group_independent``: dependence is a transitive
    closure over ALL nodes, so members of one group can never reach
    each other through intermediate non-``fed_map`` nodes."""
    nodes = list(graph.nodes)

    def parents(node: Any) -> Iterator[Any]:
        return iter(node.all_input_nodes)

    groups = group_independent(
        nodes,
        parents=parents,
        is_candidate=lambda node: node.target is fed_map_p,
    )
    plan: Dict[Any, List[Any]] = {}
    for g in groups:
        if len(g) >= 2:
            for node in g:
                plan[node] = g
    return plan
