"""Adapters between modeling signatures and the flat arrays contract.

Port of the JAX package's ``wrappers.py``: a ``LogpFn`` or
``LogpGradFn`` becomes the flat ``arrays -> [arrays]`` compute function
a node serves, with the same checks and the same error messages (a
scalar logp; exactly one gradient per input, shaped like its input).
:func:`logp_grad_from_logp` derives the gradient by ``torch.autograd``
instead of requiring the node author to hand-derive it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .signatures import Array, ComputeFn, LogpFn, LogpGradFn, check_scalar


def wrap_logp_fn(logp_fn: LogpFn) -> ComputeFn:
    """Adapt a logp function to the ``arrays -> [arrays]`` contract: the
    output is a single scalar tensor; a non-scalar logp is rejected."""

    def compute_fn(*inputs: Array) -> Sequence[Array]:
        logp = logp_fn(*inputs)
        return [check_scalar(torch.as_tensor(logp), "logp")]

    return compute_fn


def wrap_logp_grad_fn(logp_grad_fn: LogpGradFn) -> ComputeFn:
    """Adapt a logp-and-grad function to ``arrays -> [logp, *grads]``:
    exactly one gradient per input, each with its input's shape; scalar
    logp."""

    def compute_fn(*inputs: Array) -> Sequence[Array]:
        logp, grads = logp_grad_fn(*inputs)
        logp = check_scalar(torch.as_tensor(logp), "logp")
        grads = tuple(torch.as_tensor(g) for g in grads)
        if len(grads) != len(inputs):
            raise ValueError(
                f"Expected one gradient per input ({len(inputs)}), "
                f"got {len(grads)}."
            )
        for i, (g, x) in enumerate(zip(grads, inputs)):
            xs = tuple(torch.as_tensor(x).shape)
            if tuple(g.shape) != xs:
                raise ValueError(
                    f"Gradient {i} has shape {tuple(g.shape)}, "
                    f"expected input shape {xs}."
                )
        return [logp, *grads]

    return compute_fn


def logp_grad_from_logp(logp_fn: LogpFn) -> LogpGradFn:
    """Derive a ``LogpGradFn`` from a logp function by one reverse pass.

    The inputs are detached first, so the call never writes into the
    caller's autograd graph; an input the logp does not depend on gets a
    zero gradient."""

    def logp_grad_fn(*inputs: Array):
        args = tuple(torch.as_tensor(x).detach().requires_grad_(True) for x in inputs)
        with torch.enable_grad():
            logp = check_scalar(logp_fn(*args), "logp")
            grads = torch.autograd.grad(logp, args, allow_unused=True)
        grads = tuple(
            torch.zeros_like(a) if g is None else g for a, g in zip(args, grads)
        )
        return logp.detach(), grads

    return logp_grad_fn
