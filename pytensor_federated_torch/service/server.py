"""A node's compute on its device, behind the numpy compute contract.

Port of the JAX package's ``service/server.py`` :func:`device_compute_fn`:
a node owns a device (a GPU, where its private data live) and serves a
torch function of tensors through any transport that speaks numpy
(:func:`.tcp.serve_tcp_once`).  The gRPC ``ArraysToArraysService`` of
the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from ..signatures import ComputeFn
from ..utils import resolve_device
from .batching import batched_compute_fn


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:  # a zero-copy request view
        a = a.copy()
    return torch.from_numpy(a).to(device)


def device_compute_fn(
    fn: ComputeFn,
    *,
    device: Any = None,
    batched: bool = False,
    max_batch: int = 32,
) -> Callable:
    """Adapt a torch function into the host compute contract.

    Inputs arrive as numpy and are moved to ``device`` (``None``:
    ``cuda``, raising when there is none — a node never carries on
    quietly on the CPU; pass ``device="cpu"`` to mean the CPU); ``fn``
    runs there and its outputs return as numpy.

    ``batched=True`` additionally attaches a ``.batch`` attribute — a
    ``torch.func.vmap``-vectorized variant on the same device
    (:func:`.batching.batched_compute_fn`) — which executes a window of
    same-signature requests as ONE call instead of K.  ``max_batch``
    bounds the padded-bucket ladder.
    """
    dev = resolve_device(device)

    def compute(*arrays: np.ndarray) -> List[np.ndarray]:
        out = fn(*(_to_device(a, dev) for a in arrays))
        return [
            o.detach().cpu().numpy() if torch.is_tensor(o) else np.asarray(o)
            for o in out
        ]

    compute.device = dev
    if batched:
        compute.batch = batched_compute_fn(fn, device=dev, max_batch=max_batch)
    return compute
