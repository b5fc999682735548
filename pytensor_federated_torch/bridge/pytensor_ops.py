"""PyTensor Ops wrapping framework compute functions, PyTorch-dispatchable.

- :class:`FederatedArraysToArraysOp` — generic arrays->arrays Op.
- :class:`FederatedLogpOp` — scalar log-potential Op.
- :class:`FederatedLogpGradOp` — ``[logp, *grads]`` outputs with the
  symbolic ``.grad()`` bridge, including the "no second-order autodiff
  through the federated boundary" restriction.

The ops carry an optional ``torch_fn``; when a model is compiled through
PyTensor's PyTorch linker (``mode="PYTORCH"``), the registered
``pytorch_funcify`` dispatch inlines that function into the compiled
program, so the federated likelihood runs as torch code on the model's
device (through the Hopper kernel where ``torch_fn`` calls it).  The
``perform`` path (C/py linkers) still works for host compute functions,
so non-torch "blackbox" nodes keep first-class support.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import pytensor
import pytensor.tensor as pt
from pytensor.gradient import DisconnectedType
from pytensor.graph.basic import Apply
from pytensor.graph.op import Op

from ..signatures import ComputeFn, LogpFn, LogpGradFn
from . import core

__all__ = [
    "FederatedArraysToArraysOp",
    "FederatedLogpGradOp",
    "FederatedLogpOp",
    "federated_potential",
]


def _as_tensors(inputs) -> list:
    # Coerce raw python ints/floats too (a plain number as an op input).
    return [pt.as_tensor_variable(i) for i in inputs]


class FederatedArraysToArraysOp(Op):
    """Generic arrays->arrays blackbox Op.

    ``output_types`` gives the PyTensor types of the outputs.

    No ``__props__``: op identity is instance identity, so two ops
    wrapping *different* node functions never compare equal and the merge
    optimizer cannot collapse distinct federated nodes into one apply.
    Re-applying the *same* instance on the same inputs (the ``grad()``
    pattern below) still merges, because identity equality holds.
    """

    def __init__(
        self,
        compute_fn: ComputeFn,
        output_types: Sequence,
        *,
        torch_fn: Optional[Callable] = None,
    ):
        self.compute_fn = compute_fn
        self.output_types = list(output_types)
        self.torch_fn = torch_fn

    def make_node(self, *inputs):
        inputs = _as_tensors(inputs)
        outputs = [t() for t in self.output_types]
        return Apply(self, inputs, outputs)

    def perform(self, node, inputs, output_storage):
        results = self.compute_fn(*[np.asarray(i) for i in inputs])
        outs = core.coerce_outputs(
            results, [v.type.dtype for v in node.outputs]
        )
        for storage, out in zip(output_storage, outs):
            storage[0] = out


class FederatedLogpOp(Op):
    """Inputs -> scalar log-potential.

    No ``__props__`` — see :class:`FederatedArraysToArraysOp`.
    """

    def __init__(self, logp_fn: LogpFn, *, torch_fn: Optional[Callable] = None):
        self.logp_fn = logp_fn
        self.torch_fn = torch_fn

    def make_node(self, *inputs):
        inputs = _as_tensors(inputs)
        return Apply(self, inputs, [pt.scalar()])

    def perform(self, node, inputs, output_storage):
        logp = self.logp_fn(*[np.asarray(i) for i in inputs])
        output_storage[0][0] = core.coerce_logp(
            logp, node.outputs[0].type.dtype
        )


class FederatedLogpGradOp(Op):
    """Inputs -> ``[logp, *grads]`` with the symbolic grad bridge.

    Node outputs are ``[scalar logp]`` plus one grad per input typed like
    the input (int inputs upcast to floatX); ``.grad()`` re-applies self
    on the same inputs (CSE dedups the double apply) and returns
    ``g_logp * grad_i``; connected gradients w.r.t. the grad outputs
    raise — no second-order autodiff through the federated boundary.

    No ``__props__`` — see :class:`FederatedArraysToArraysOp`; instance
    identity keeps distinct nodes un-mergeable while ``grad()``'s
    re-apply of the same instance still CSEs.
    """

    def __init__(
        self, logp_grad_fn: LogpGradFn, *, torch_fn: Optional[Callable] = None
    ):
        self.logp_grad_fn = logp_grad_fn
        self.torch_fn = torch_fn

    def make_node(self, *inputs):
        inputs = _as_tensors(inputs)
        # Grad-output dtype policy (int inputs upcast to floatX so the
        # gradient is not silently truncated) lives in core.py where it
        # is tested without pytensor.
        outputs = [pt.scalar()]
        for i in inputs:
            dt = core.grad_output_dtype(
                i.type.dtype, pytensor.config.floatX
            )
            outputs.append(
                i.type()
                if dt == i.type.dtype
                else pt.TensorType(dt, i.type.shape)()
            )
        return Apply(self, inputs, outputs)

    def perform(self, node, inputs, output_storage):
        logp, grads = self.logp_grad_fn(*[np.asarray(i) for i in inputs])
        logp, grads = core.coerce_logp_grads(
            logp,
            grads,
            node.outputs[0].type.dtype,
            [v.type.dtype for v in node.outputs[1:]],
        )
        output_storage[0][0] = logp
        for storage, g in zip(output_storage[1:], grads):
            storage[0] = g

    def grad(self, inputs, output_grads):
        g_logp, *g_grads = output_grads
        for gg in g_grads:
            if not isinstance(gg.type, DisconnectedType):
                raise NotImplementedError(
                    "gradients with respect to the gradient outputs are not "
                    "supported (no second-order autodiff through the "
                    "federated boundary)"
                )
        outputs = self(*inputs)
        grads = outputs[1:]
        return [g_logp * g for g in grads]

    def connection_pattern(self, node):
        # logp depends on every input; each grad output is treated as
        # disconnected for further differentiation (first order only).
        n_in = len(node.inputs)
        return [[True] + [False] * n_in for _ in range(n_in)]


def federated_potential(logp_grad_fn: LogpGradFn, *inputs, torch_fn=None):
    """Apply a :class:`FederatedLogpGradOp` and return just the logp
    variable — ready for ``pm.Potential``.

    A :class:`~pytensor_federated_torch.fed.FederatedLogpGrad` evaluator
    routes BOTH lanes through its one ``fed.program``: it is itself the
    host ``LogpGradFn`` (perform path), and its ``.torch_fn`` — picked up
    automatically here — is the placement-lowered program for PyTorch
    linker compiles, so mesh/pool/mixed execution and the window fusion
    pass apply without any per-op wiring.
    """
    if torch_fn is None:
        torch_fn = getattr(logp_grad_fn, "torch_fn", None)
    op = FederatedLogpGradOp(logp_grad_fn, torch_fn=torch_fn)
    return op(*inputs)[0]


# -- PyTensor->PyTorch linker dispatch ---------------------------------------
# Registering here (an import side effect) means any PyMC/PyTensor compile
# with mode="PYTORCH" inlines the op's torch_fn into the compiled program.


def _member_kind(op) -> str:
    """Kind tag for :func:`..bridge.core.member_torch_callable`."""
    if isinstance(op, FederatedLogpGradOp):
        return "logp_grad"
    if isinstance(op, FederatedLogpOp):
        return "logp"
    return "arrays"


def _torch_funcify_for_member(op):
    """The torch callable for one federated op, with node-shaped output
    (a tuple matching the op's apply outputs).  Shared by the three
    ``pytorch_funcify`` registrations below and by the fused op's
    dispatch (fusion.py).  The wrapping itself lives in core.py, tested
    without pytensor."""
    return core.member_torch_callable(
        _member_kind(op), op.torch_fn, name=type(op).__name__
    )


try:  # pragma: no cover - depends on pytensor version layout
    from pytensor.link.pytorch.dispatch import pytorch_funcify

    @pytorch_funcify.register(FederatedArraysToArraysOp)
    @pytorch_funcify.register(FederatedLogpOp)
    @pytorch_funcify.register(FederatedLogpGradOp)
    def _pytorch_funcify_federated(op, **kwargs):
        return _torch_funcify_for_member(op)

except ModuleNotFoundError:  # pragma: no cover
    pass
