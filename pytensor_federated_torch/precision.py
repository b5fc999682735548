"""True-float32 contraction policy.

Port of the JAX package's ``precision.py``.  There the hazard was a
TPU whose plain float32 matmul multiplied in bfloat16; on Hopper it is
TF32, which tensor cores use for float32 matmuls when
``torch.backends.cuda.matmul.allow_tf32`` (or cuDNN's flag) is on: 10
mantissa bits instead of 23.  One policy knob selects the mechanism:

- ``"default"`` — ``torch.matmul`` as the global flags leave it.
- ``"highest"`` — ``torch.matmul`` with TF32 turned off around the call.
- ``"split"`` — the 6-pass bf16x3 split in user code (:func:`split_dot`):
  each operand is cut into three bf16-representable pieces and the six
  partial products above the 2^-27 line are summed in float32.  The
  pieces carry 8 mantissa bits each, so TF32 (10 bits) multiplies them
  exactly: the split is true-float32 accurate whatever the flags say.
- ``"strict"`` — the split for explicit contraction sites and TF32 off
  for composite-op internals (:func:`matmul_precision_ctx`).

Env override: ``PFTPU_F32_POLICY`` (``default``/``highest``/``split``/
``strict``) rebinds what ``policy=None`` resolves to, so a whole run
can be flipped without touching model code.
"""

from __future__ import annotations

import contextlib
import os
from contextlib import nullcontext
from typing import Callable, Optional

import torch

__all__ = [
    "POLICIES",
    "resolve_policy",
    "split_dot",
    "pdot",
    "matmul_precision_ctx",
    "wrap_policy",
]

POLICIES = ("default", "highest", "split", "strict")


def resolve_policy(policy: Optional[str] = None) -> str:
    """``policy`` if given, else ``$PFTPU_F32_POLICY``, else "default".

    Raises on unknown names — a typo'd policy silently meaning
    "default" would defeat the point of an explicit mechanism.
    """
    if policy is None:
        policy = os.environ.get("PFTPU_F32_POLICY", "default")
    if policy not in POLICIES:
        raise ValueError(
            f"unknown f32 policy {policy!r}; choose from {POLICIES}"
        )
    return policy


def _split3(x: torch.Tensor):
    """Exact 3-piece split ``x ~= x1 + x2 + x3``, each piece
    bf16-representable; the residual is ``<= 2^-27 |x|``."""
    x1 = x.to(torch.bfloat16).float()
    r1 = x - x1
    x2 = r1.to(torch.bfloat16).float()
    r2 = r1 - x2
    x3 = r2.to(torch.bfloat16).float()
    return x1, x2, x3


def split_dot(a, b, base_dot: Optional[Callable] = None) -> torch.Tensor:
    """6-pass bf16x3-split contraction, true-float32 accurate on a
    contraction that multiplies in bf16 (or TF32).

    ``base_dot`` is the underlying contraction — ``torch.matmul`` by
    default; injectable so tests can substitute a simulated
    bf16-multiply backend.  Supports every operand-rank combination
    ``torch.matmul`` does.  The kept partial products are ``a1·b1``,
    ``a1·b2 + a2·b1`` and ``a1·b3 + a2·b2 + a3·b1``, summed
    smallest-magnitude first.
    """
    if base_dot is None:
        base_dot = torch.matmul
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    a1, a2, a3 = _split3(a)
    b1, b2, b3 = _split3(b)
    return (
        (base_dot(a1, b3) + base_dot(a2, b2) + base_dot(a3, b1))
        + (base_dot(a1, b2) + base_dot(a2, b1))
    ) + base_dot(a1, b1)


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for matmuls and cuDNN; both flags restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def pdot(a, b, policy: Optional[str] = None) -> torch.Tensor:
    """Policy-routed matmul/matvec (``torch.matmul`` semantics): the one
    contraction entry point for float32-strict model options."""
    policy = resolve_policy(policy)
    if policy == "default":
        return torch.matmul(a, b)
    if policy == "highest":
        with _tf32_off():
            return torch.matmul(a, b)
    return split_dot(a, b)


def matmul_precision_ctx(policy: Optional[str] = None):
    """Context manager for composite-op internals (Cholesky blocks,
    triangular solves) under ``policy``: TF32 off for ``"highest"`` and
    ``"strict"``, nothing for the others."""
    policy = resolve_policy(policy)
    if policy in ("highest", "strict"):
        return _tf32_off()
    return nullcontext()


def wrap_policy(fn: Callable, policy: Optional[str] = None) -> Callable:
    """Return ``fn`` run under :func:`matmul_precision_ctx`.

    For ``"default"``/``"split"`` this is ``fn`` unchanged (split sites
    are handled inside the model via :func:`pdot`).
    """
    policy = resolve_policy(policy)
    if policy not in ("highest", "strict"):
        return fn

    def wrapped(*args, **kwargs):
        with matmul_precision_ctx(policy):
            return fn(*args, **kwargs)

    return wrapped
