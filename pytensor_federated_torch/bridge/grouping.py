"""Pure grouping algorithm behind the federated fusion rewrite.

Factored out of fusion.py so the algorithm is testable without
PyTensor installed (tests/test_grouping.py runs everywhere; the
fusion rewrite itself can only execute where pytensor is present).
No pytensor imports belong in this module.

The problem: given applies in topological order and, for each node,
its input edges, partition the *candidate* applies into groups whose
members are pairwise independent (neither transitively consumes the
other's outputs).  Fusing such a group into one apply can never create
a graph cycle: a cycle would need a path between two members, which is
exactly what independence excludes — including paths through
non-candidate nodes, because dependence is propagated as a transitive
closure over ALL nodes.
"""

from __future__ import annotations

from typing import Callable, Hashable, Iterable, Sequence

__all__ = ["group_independent"]


def group_independent(
    order: Sequence[Hashable],
    parents: Callable[[Hashable], Iterable[Hashable]],
    is_candidate: Callable[[Hashable], bool],
) -> list[list[Hashable]]:
    """Greedy first-fit grouping of independent candidate nodes.

    ``order`` must be a topological order (parents before children);
    ``parents(n)`` yields the nodes whose outputs ``n`` consumes.
    Returns groups (lists of candidates, in topo order); singleton
    groups are included — the caller decides that fusing them is
    pointless.

    Only the forward direction needs checking when placing a node into
    a group: existing members precede it in topo order, so it can never
    be an ancestor of a member.
    """
    candidates = [n for n in order if is_candidate(n)]
    if len(candidates) < 2:
        # Nothing can group: skip the O(graph) transitive-deps pass —
        # this runs on EVERY default-mode compile (optdb fast_run).
        return [[c] for c in candidates]
    cand_set = set(candidates)
    # deps[n] = the candidate nodes n transitively depends on.
    deps: dict = {}
    for n in order:
        d = set()
        for p in parents(n):
            d |= deps.get(p, set())
            if p in cand_set:
                d.add(p)
        deps[n] = d
    groups: list[list] = []
    for c in candidates:
        for g in groups:
            if not any(m in deps[c] for m in g):
                g.append(c)
                break
        else:
            groups.append([c])
    return groups
