"""Blackbox / host escape hatch: numpy compute inside an autograd graph.

Port of the JAX package's ``ops/blackbox.py``.  The node function is a
*blackbox* to the driver — any callable behind the wire contract works
(a legacy C/C++/Fortran likelihood, or a remote federated node through
:mod:`..service`), at the price of a host call per evaluation.  Its
output signature is declared up front, the arrays cross as numpy, and
:func:`blackbox_logp_grad` makes it differentiable under the same
forward-supplied-gradient contract as :class:`.ops.LogpGradOp`.  The
JAX package needs ``jax.pure_callback`` to leave its trace; an eager
torch op simply calls the host.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..signatures import Array, ArraysSpec, ShapeDtypeStruct
from .ops import LogpGradOp


def to_numpy(x) -> np.ndarray:
    """A tensor (or anything ``np.asarray`` takes) as a host array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_host(outputs: Sequence, out_spec: ArraysSpec, device) -> List[Array]:
    """Host outputs as tensors of the declared signature on ``device``;
    a shape that disagrees with its declaration raises."""
    out_spec = tuple(out_spec)
    outputs = list(outputs)
    if len(outputs) != len(out_spec):
        raise ValueError(
            f"host function returned {len(outputs)} arrays, "
            f"expected {len(out_spec)}"
        )
    result = []
    for i, (o, s) in enumerate(zip(outputs, out_spec)):
        t = torch.as_tensor(np.asarray(o)).to(device=device, dtype=s.dtype)
        if tuple(t.shape) != tuple(s.shape):
            raise ValueError(
                f"host output {i} has shape {tuple(t.shape)}, "
                f"expected {tuple(s.shape)}"
            )
        result.append(t)
    return result


def _device_of(inputs) -> torch.device:
    for x in inputs:
        if torch.is_tensor(x):
            return x.device
    return torch.device("cpu")


def blackbox_compute(
    host_fn: Callable[..., Sequence[np.ndarray]],
    out_spec: ArraysSpec,
) -> Callable[..., List[Array]]:
    """Wrap a host (numpy) arrays->arrays function as a torch function.

    ``out_spec`` declares the static output signature; outputs land on
    the device of the first tensor input (the CPU without one)."""
    out_spec = tuple(out_spec)

    def fn(*inputs) -> List[Array]:
        outputs = host_fn(*(to_numpy(x) for x in inputs))
        return from_host(outputs, out_spec, _device_of(inputs))

    return fn


def blackbox_logp_grad(
    host_logp_grad: Callable[..., tuple],
    in_spec: ArraysSpec,
    *,
    logp_dtype: torch.dtype = torch.float32,
) -> LogpGradOp:
    """Differentiable blackbox logp+grad op backed by a host callable.

    ``host_logp_grad(*arrays) -> (logp, [grads])`` with numpy semantics
    — the node contract — becomes a :class:`LogpGradOp` whose backward
    uses the host-supplied gradients.  ``in_spec`` fixes each input's
    shape and dtype, and so each gradient's."""
    in_spec = tuple(in_spec)
    out_spec = (ShapeDtypeStruct((), logp_dtype),) + in_spec

    def host_flat(*arrays):
        logp, grads = host_logp_grad(*(np.asarray(a) for a in arrays))
        return [np.asarray(logp)] + [np.asarray(g) for g in grads]

    flat = blackbox_compute(host_flat, out_spec)

    def logp_grad_fn(*inputs):
        out = flat(*inputs)
        return out[0], tuple(out[1:])

    return LogpGradOp(logp_grad_fn)
