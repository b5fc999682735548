"""Parallel fan-out of independent host evaluations.

Port of the JAX package's ``ops/fanout.py``.  The federated case is a
fan-out over *host/blackbox* functions — remote nodes — and overlapping
N slow nodes needs an explicit gather: :func:`parallel_host_call` and
:class:`ParallelLogpGrad` run node ``i`` on its own persistent member
thread (:class:`..fanout_exec.MemberExecutorPool`), so the wall time of
one evaluation is the max of the node latencies, not their sum.  The
transports release the GIL while they wait on their sockets.

:func:`fuse` is kept for API parity: in eager torch it simply calls the
functions in order (there is no trace to fuse them into).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..fanout_exec import MemberExecutorPool
from ..signatures import Array, ArraysSpec, ShapeDtypeStruct
from .blackbox import _device_of, from_host, to_numpy
from .ops import refuse_second_order


def fuse(fns: Sequence[Callable]) -> Callable:
    """``fuse([f, g])(args_f, args_g) -> [f(*args_f), g(*args_g)]``."""

    def fused(*args_per_fn):
        if len(args_per_fn) != len(fns):
            raise ValueError(
                f"expected {len(fns)} argument tuples, got {len(args_per_fn)}"
            )
        return [f(*a) for f, a in zip(fns, args_per_fn)]

    return fused


def parallel_host_call(
    host_fns: Sequence[Callable[..., Sequence[np.ndarray]]],
    out_specs: Sequence[ArraysSpec],
) -> Callable[..., List[List[Array]]]:
    """Evaluate N host functions concurrently.

    Returns ``fn(args_0, args_1, ...) -> [outputs_0, outputs_1, ...]``
    where each ``args_i`` is a tuple of arrays for child ``i``; child
    ``i``'s outputs come back as tensors of ``out_specs[i]`` on the
    device of the first tensor input.  ``fn.close()`` stops the member
    threads.
    """
    host_fns = list(host_fns)
    out_specs = [tuple(s) for s in out_specs]
    # One PERSISTENT single-thread executor PER CHILD: node i always runs
    # on its own long-lived thread, so thread-keyed client state (a
    # connection) maps 1:1 to nodes.
    pool = MemberExecutorPool(len(host_fns), name="pft-fanout")

    def close():
        pool.shutdown()

    def fn(*args_per_child) -> List[List[Array]]:
        if len(args_per_child) != len(host_fns):
            raise ValueError(
                f"expected {len(host_fns)} argument tuples, "
                f"got {len(args_per_child)}"
            )
        device = _device_of([x for a in args_per_child for x in a])
        futures = [
            pool.submit(i, lambda f=f, a=a: list(f(*(to_numpy(x) for x in a))))
            for i, (f, a) in enumerate(zip(host_fns, args_per_child))
        ]
        # Every child settles before the first failure (in child order)
        # is raised.
        errors = [fut.exception() for fut in futures]
        for e in errors:
            if e is not None:
                raise e
        return [
            from_host(fut.result(), spec, device)
            for fut, spec in zip(futures, out_specs)
        ]

    fn.close = close
    return fn


class _FanoutLogpGrad(torch.autograd.Function):
    """Node logps and grads from one fan-out; the backward applies each
    node's forward-supplied grads scaled by its logp's cotangent."""

    @staticmethod
    def forward(ctx, op, *flat_inputs):
        args_per_child, i = [], 0
        for k in op._arities:
            args_per_child.append(tuple(x.detach() for x in flat_inputs[i : i + k]))
            i += k
        outs = op._fanout(*args_per_child)
        logps = [o[0] for o in outs]
        grads = [g for o in outs for g in o[1:]]
        ctx.set_materialize_grads(False)
        ctx.arities = op._arities
        ctx.save_for_backward(*grads)
        return (*logps, *grads)

    @staticmethod
    def backward(ctx, *cotangents):
        n = len(ctx.arities)
        g_logps, g_grads = cotangents[:n], cotangents[n:]
        refuse_second_order(g_grads)
        grads = ctx.saved_tensors
        flat, i = [], 0
        for g_logp, k in zip(g_logps, ctx.arities):
            for g in grads[i : i + k]:
                flat.append(None if g_logp is None else g_logp.to(g.dtype) * g)
            i += k
        return (None, *flat)


class ParallelLogpGrad:
    """N blackbox logp+grad nodes evaluated concurrently and differentiably.

    One apply fans out to every node and gathers ``(logp_i, grads_i)``;
    the backward applies the forward-supplied per-node gradients
    (``g_logp_i * grads_i``); second-order autodiff through the boundary
    raises.  ``host_logp_grads[i](*arrays) -> (logp, [grads])`` takes and
    returns numpy; ``in_specs[i]`` fixes the input signature of node
    ``i``, and so the signature of its grads.
    """

    def __init__(
        self,
        host_logp_grads: Sequence[Callable[..., tuple]],
        in_specs: Sequence[ArraysSpec],
        *,
        logp_dtype: torch.dtype = torch.float32,
    ):
        if len(host_logp_grads) != len(in_specs):
            raise ValueError("need one in_spec per node")
        self.n_nodes = len(host_logp_grads)
        self.in_specs = [tuple(s) for s in in_specs]
        scalar = ShapeDtypeStruct((), logp_dtype)
        out_specs = [(scalar,) + spec for spec in self.in_specs]

        def flat_node(i):
            fn = host_logp_grads[i]

            def host(*arrays):
                logp, grads = fn(*arrays)
                return [np.asarray(logp)] + [np.asarray(g) for g in grads]

            return host

        self._fanout = parallel_host_call(
            [flat_node(i) for i in range(self.n_nodes)], out_specs
        )
        self._arities = [len(s) for s in self.in_specs]

    def __call__(self, inputs_per_node: Sequence[Tuple]) -> List[Tuple]:
        """``[(args of node i)] -> [(logp_i, grads_i)]``, one fan-out."""
        if len(inputs_per_node) != self.n_nodes:
            raise ValueError(
                f"expected inputs for {self.n_nodes} nodes, "
                f"got {len(inputs_per_node)}"
            )
        flat = [torch.as_tensor(x) for args in inputs_per_node for x in args]
        out = _FanoutLogpGrad.apply(self, *flat)
        logps, grads = out[: self.n_nodes], out[self.n_nodes :]
        results, i = [], 0
        for lp, k in zip(logps, self._arities):
            results.append((lp, tuple(grads[i : i + k])))
            i += k
        return results

    def total_logp(self, inputs_per_node: Sequence[Tuple]) -> Array:
        """Sum of node logps — the sum-of-potentials reduction."""
        results = self(inputs_per_node)
        return torch.sum(torch.stack([lp for lp, _ in results]))

    def close(self) -> None:
        """Shut down the per-node executor threads."""
        self._fanout.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
