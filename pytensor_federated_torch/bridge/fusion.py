"""Automatic fan-out rewrite: independent federated applies run concurrently.

Registered in PyTensor's global optimizer database, so that every
default-mode compile overlaps independent remote calls: a PyTensor graph
with N independent ``Federated*Op`` applies would otherwise evaluate
them one after another on the C/py linkers.

- The rewrite groups *any* independent ``FederatedArraysToArraysOp`` /
  ``FederatedLogpOp`` / ``FederatedLogpGradOp`` applies — grouping is
  by graph independence (no ancestor path between members), not depth
  equality, so a deep-and-shallow pair still overlaps.
- The fused apply's ``perform`` runs each member's own ``perform`` in a
  shared thread pool.  The member compute functions are network/host
  calls (gRPC, TCP, subprocess) or kernel launches that release the GIL
  while waiting, so threads hide their latency without imposing an
  async signature on user compute functions.
- The fused op works on every linker: ``perform`` serves the C/py
  linkers, and a registered ``pytorch_funcify`` dispatch inlines each
  member's ``torch_fn`` when a PyTorch-mode compile runs the rewrite,
  so the two paths cannot disagree.

Importing this module registers the rewrite in ``optdb`` under
``fast_run`` at position 90: after canonicalize/specialize (which must
see the original applies for CSE/merge) and after the inplace passes
(which know nothing about these host-call ops).
"""

from __future__ import annotations

from pytensor.compile import optdb
from pytensor.graph.basic import Apply
from pytensor.graph.features import ReplaceValidate
from pytensor.graph.op import Op
from pytensor.graph.rewriting.basic import GraphRewriter

from ..fanout_exec import MemberExecutorPool, run_members
from .core import fused_torch_callable, plan_fusion
from .grouping import group_independent
from .pytensor_ops import (
    FederatedArraysToArraysOp,
    FederatedLogpGradOp,
    FederatedLogpOp,
)

__all__ = ["ParallelFederatedOp", "FederatedFusionRewriter"]

_FUSABLE = (FederatedArraysToArraysOp, FederatedLogpOp, FederatedLogpGradOp)


class ParallelFederatedOp(Op):
    """N independent federated applies as one apply; ``perform`` fans
    the members out over a thread pool and blocks for all of them
    (wall-clock = max member latency, not the sum).

    ``members`` are the original ops; ``in_counts``/``out_counts`` give
    each member's slice of the concatenated input/output lists.  No
    ``__props__``: like the member ops, identity is instance identity.
    """

    def __init__(self, members, in_counts, out_counts):
        self.members = list(members)
        self.in_counts = list(in_counts)
        self.out_counts = list(out_counts)

    def make_node(self, *inputs):
        outputs = []
        i = 0
        member_nodes = []
        for op, n_in in zip(self.members, self.in_counts):
            node = op.make_node(*inputs[i : i + n_in])
            member_nodes.append(node)
            outputs.extend(out.type() for out in node.outputs)
            i += n_in
        if i != len(inputs):
            raise ValueError(
                f"ParallelFederatedOp got {len(inputs)} inputs, "
                f"members consume {i}"
            )
        # Template applies reused by perform (member perform signatures
        # need a node argument; these carry only type information).
        self._member_nodes = member_nodes
        return Apply(self, list(inputs), outputs)

    def _templates(self, node):
        # Rebuilt lazily so an op unpickled in another process (a
        # cross-process compile cache) regains its member template applies.
        nodes = getattr(self, "_member_nodes", None)
        if nodes is None:
            i = 0
            nodes = []
            for op, n_in in zip(self.members, self.in_counts):
                nodes.append(op.make_node(*node.inputs[i : i + n_in]))
                i += n_in
            self._member_nodes = nodes
        return nodes

    def __getstate__(self):
        # Template applies reference graph variables, and executor pools
        # are not picklable; both rebuild lazily on the other side.
        state = self.__dict__.copy()
        state.pop("_member_nodes", None)
        state.pop("_pool", None)
        return state

    def _member_pool(self) -> MemberExecutorPool:
        # One PERSISTENT single-thread executor per member, shut down by
        # weakref.finalize when this op is collected (fanout_exec docs
        # explain the thread-pinning requirement).  setdefault is
        # GIL-atomic: concurrent first calls agree on one pool; a losing
        # pool never starts threads (they are lazy), so nothing leaks.
        pool = getattr(self, "_pool", None)
        if pool is None:
            pool = self.__dict__.setdefault(
                "_pool", MemberExecutorPool(len(self.members))
            )
        return pool

    def perform(self, node, inputs, output_storage):
        # The scheduling contract (pinned threads, max-not-sum wall
        # clock, settle-all-then-raise-first, storage slicing) lives in
        # the pure, pytensor-free fanout_exec.run_members, where it is
        # tested directly.
        templates = self._templates(node)
        member_fns = [
            (lambda sub_in, sub_st, op=op, t=t: op.perform(t, sub_in, sub_st))
            for op, t in zip(self.members, templates)
        ]
        run_members(
            member_fns,
            self.in_counts,
            self.out_counts,
            inputs,
            output_storage,
            self._member_pool(),
        )


class FederatedFusionRewriter(GraphRewriter):
    """Replace every maximal group of independent ``Federated*Op``
    applies with one :class:`ParallelFederatedOp` apply.

    Independence is transitive-closure based: apply B joins apply A's
    group only if neither (transitively) consumes the other's outputs.
    Greedy grouping over the toposort keeps this O(nodes x candidates).
    """

    def add_requirements(self, fgraph):
        fgraph.attach_feature(ReplaceValidate())

    def apply(self, fgraph):
        order = fgraph.toposort()
        groups = group_independent(
            order,
            parents=lambda n: (
                inp.owner for inp in n.inputs if inp.owner is not None
            ),
            is_candidate=lambda n: isinstance(n.op, _FUSABLE),
        )
        for g in groups:
            if len(g) < 2:
                continue
            self._fuse_group(fgraph, g)

    @staticmethod
    def _fuse_group(fgraph, group):
        # WHAT replaces what is planned in core.plan_fusion (pure,
        # tested without pytensor); only the Apply construction and the
        # validated replace remain here.
        plan = plan_fusion(
            group,
            op_of=lambda n: n.op,
            inputs_of=lambda n: n.inputs,
            outputs_of=lambda n: n.outputs,
        )
        fused_op = ParallelFederatedOp(
            plan["members"], plan["in_counts"], plan["out_counts"]
        )
        fused_node = fused_op.make_node(*plan["all_inputs"])
        repl = [
            (old, fused_node.outputs[pos])
            for old, pos in plan["replacements"]
        ]
        fgraph.replace_all_validate(
            repl, reason="federated_parallel_fusion"
        )


# PyTorch linker: inline each member's torch_fn (or compose fed members
# into one program, core.fused_torch_callable).
try:  # pragma: no cover - depends on pytensor version layout
    from pytensor.link.pytorch.dispatch import pytorch_funcify

    from .pytensor_ops import _torch_funcify_for_member

    @pytorch_funcify.register(ParallelFederatedOp)
    def _pytorch_funcify_parallel(op, **kwargs):
        return fused_torch_callable(
            [_torch_funcify_for_member(m) for m in op.members],
            op.in_counts,
        )

except ModuleNotFoundError:  # pragma: no cover
    pass


# Import-time registration, at position 90 (after canonicalize/specialize
# — which must see the original applies for CSE/merge — and after the
# inplace passes, which know nothing about these host-call ops).
if "federated_parallel_fusion" not in optdb:
    optdb.register(
        "federated_parallel_fusion",
        FederatedFusionRewriter(),
        "fast_run",
        position=90,
    )
