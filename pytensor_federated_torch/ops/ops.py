"""Graph-integration ops: embed compute functions into autograd graphs.

Port of the JAX package's ``ops/ops.py``.  An op is a callable that
coerces its inputs to tensors and is differentiable under the
reference's contract:

- :class:`ArraysToArraysOp` — generic arrays -> arrays.
- :class:`LogpOp` — scalar log-potential.
- :class:`LogpGradOp` — returns ``(logp, grads)`` and takes part in
  ``torch.autograd`` with the *forward-supplied* gradients: the
  backward of ``logp`` w.r.t. input ``i`` is ``g_logp * grads[i]``;
  the compute function itself is never differentiated.  The federated
  boundary is first-order only: a gradient flowing into the ``grads``
  outputs, or a backward run with grad mode on (``create_graph=True``,
  a Hessian), raises instead of silently contributing zero.

The JAX package's ``custom_vjp`` becomes a ``torch.autograd.Function``.
The ``Async*`` names stay as aliases for API parity.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..signatures import Array, ComputeFn, LogpFn, LogpGradFn, check_scalar

_SECOND_ORDER = (
    "gradients with respect to LogpGradOp's grad outputs are not "
    "supported: the federated boundary is first-order only (nodes supply "
    "logp and first grads; second-order information never crosses the "
    "wire). Use the grads output as data (.detach()) if that is intended."
)


def refuse_second_order(g_grads: Sequence) -> None:
    """The first-order contract of every forward-supplied-gradient op.

    Raises when a backward runs with grad mode on (``create_graph=True``:
    the caller wants a graph of this backward, a second derivative the
    nodes never supplied) or when a gradient arrives at a ``grads``
    output (unused outputs arrive as ``None``)."""
    if torch.is_grad_enabled() or any(g is not None for g in g_grads):
        raise NotImplementedError(_SECOND_ORDER)


class ArraysToArraysOp:
    """Wrap an arrays->arrays function with input coercion
    (``torch.as_tensor``; raw Python numbers become tensors)."""

    def __init__(self, fn: ComputeFn):
        self.fn = fn

    def __call__(self, *inputs) -> Sequence[Array]:
        args = tuple(torch.as_tensor(x) for x in inputs)
        return list(self.fn(*args))


class LogpOp:
    """Inputs -> scalar log-potential."""

    def __init__(self, logp_fn: LogpFn):
        self.logp_fn = logp_fn

    def __call__(self, *inputs) -> Array:
        args = tuple(torch.as_tensor(x) for x in inputs)
        return check_scalar(torch.as_tensor(self.logp_fn(*args)), "logp")


def vmap_sequential(function, info, in_dims, *args):
    """The ``vmap`` rule of a host-callback autograd Function: the host
    is called once per chain, in turn, and the outputs are stacked — the
    JAX package's ``vmap_method="sequential"``.  Non-tensor arguments
    (``in_dims`` None) are passed to every call as they are."""
    per_chain = []
    for c in range(info.batch_size):
        chain_args = [a if d is None else a.select(d, c) for a, d in zip(args, in_dims)]
        per_chain.append(function.apply(*chain_args))
    outputs = tuple(torch.stack(o) for o in zip(*per_chain))
    return outputs, (0,) * len(outputs)


class _LogpGrad(torch.autograd.Function):
    """``(logp, *grads)`` from one call of ``logp_grad_fn``; the backward
    scales the saved grads by the cotangent of ``logp``.  Under
    ``torch.func.vmap`` the host is called once per chain, in turn."""

    @staticmethod
    def forward(logp_grad_fn, *inputs):
        logp, grads = logp_grad_fn(*(x.detach() for x in inputs))
        logp = check_scalar(torch.as_tensor(logp), "logp")
        grads = tuple(torch.as_tensor(g) for g in grads)
        if len(grads) != len(inputs):
            raise ValueError(
                f"logp_grad_fn returned {len(grads)} grads for "
                f"{len(inputs)} inputs"
            )
        return (logp, *grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*output[1:])

    @staticmethod
    def backward(ctx, g_logp, *g_grads):
        refuse_second_order(g_grads)
        grads = ctx.saved_tensors
        if g_logp is None:
            return (None, *(torch.zeros_like(g) for g in grads))
        return (None, *(g_logp.to(g.dtype) * g for g in grads))

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_sequential(_LogpGrad, info, in_dims, *args)


class LogpGradOp:
    """Inputs -> ``(logp, grads)`` with the forward-supplied gradient.

    The forward pass already returns the grads; the backward closes over
    them, so ``logp`` and its gradient cost one call of
    ``logp_grad_fn``."""

    def __init__(self, logp_grad_fn: LogpGradFn):
        self.logp_grad_fn = logp_grad_fn

    def __call__(self, *inputs):
        args = tuple(torch.as_tensor(x) for x in inputs)
        logp, *grads = _LogpGrad.apply(self.logp_grad_fn, *args)
        return logp, tuple(grads)

    def logp(self, *inputs) -> Array:
        """Scalar-only view — differentiable via the forward-supplied
        gradient."""
        return self(*inputs)[0]


def from_logp_fn(logp_fn: LogpFn) -> LogpGradOp:
    """LogpGradOp whose gradients come from autograd of ``logp_fn``."""
    from ..wrappers import logp_grad_from_logp

    return LogpGradOp(logp_grad_from_logp(logp_fn))


# API-parity aliases: the JAX package names an Async* variant of each op.
AsyncArraysToArraysOp = ArraysToArraysOp
AsyncLogpOp = LogpOp
AsyncLogpGradOp = LogpGradOp
