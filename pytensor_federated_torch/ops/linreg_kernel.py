"""Fused logp+grad reductions of the federated linear regression.

Port of the JAX package's ``ops/pallas_kernels.py`` (``linreg_reductions``
and ``linreg_logp_grad_fn``).  One pass over each shard's masked
``(x, y)`` block gives the log-likelihood *and* every gradient reduction:

    ll_i        = sum_n m (-0.5 z^2 - log_sigma - 0.5 log 2pi)
    gmu_i       = sum_n m r / sigma^2          (d ll / d(intercept+offset_i))
    gx_i        = sum_n m r x / sigma^2        (d ll / d slope, per shard)
    gz_i        = sum_n m (z^2 - 1)            (d ll / d log_sigma, per shard)

with ``r = y - mu``, ``z = r / sigma``.  On CUDA tensors
:func:`linreg_reductions` launches the hand-written Hopper kernel in
``csrc/linreg_reductions.cu``; on CPU tensors it runs
:func:`linreg_reductions_ref`, the plain PyTorch version that the kernel
is held against.  There is no other path: any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Callable, Tuple

import torch

from ..utils import LOG_2PI, value_and_grad
from . import _build

Reductions = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_MAX_SHARDS = 65535  # the kernel's grid.y


def linreg_reductions_ref(
    scalars: torch.Tensor,
    offsets: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
) -> Reductions:
    """Plain PyTorch version of the kernel, in the inputs' dtype."""
    intercept, slope, log_sigma = scalars[0], scalars[1], scalars[2]
    inv_s2 = torch.exp(-2.0 * log_sigma)
    mu = (intercept + offsets[:, None]) + slope * x
    r = y - mu
    z2 = r * r * inv_s2
    ll = torch.sum(mask * (-0.5 * z2 - log_sigma - 0.5 * LOG_2PI), dim=1)
    gmu = torch.sum(mask * r, dim=1) * inv_s2
    gx = torch.sum(mask * r * x, dim=1) * inv_s2
    gz = torch.sum(mask * (z2 - 1.0), dim=1)
    return ll, gmu, gx, gz


def _check_shapes(scalars, offsets, x, y, mask) -> None:
    if scalars.shape != (3,):
        raise ValueError(f"scalars must have shape (3,), got {tuple(scalars.shape)}")
    if x.ndim != 2 or y.shape != x.shape or mask.shape != x.shape:
        raise ValueError(
            "x, y and mask must share one (S, N) shape, got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(mask.shape)}"
        )
    if offsets.shape != (x.shape[0],):
        raise ValueError(
            f"offsets must have shape ({x.shape[0]},), got {tuple(offsets.shape)}"
        )


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("linreg_reductions")
    fn = lib.linreg_reductions_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.linreg_chunk.restype = ctypes.c_int
    lib.linreg_error_string.argtypes = [ctypes.c_int]
    lib.linreg_error_string.restype = ctypes.c_char_p
    return lib


def linreg_reductions(
    scalars: torch.Tensor,
    offsets: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
) -> Reductions:
    """Per-shard ``(ll, gmu, gx, gz)`` reductions, one fused data pass.

    ``scalars = [intercept, slope, log_sigma]``; ``offsets``: ``(S,)``;
    ``x, y, mask``: ``(S, N)``.  Returns four ``(S,)`` vectors.  On CUDA
    every input must be contiguous float32 on one device; the kernel
    masks the ragged observation edge itself, so nothing is padded.
    ``linreg_reductions.launches`` counts kernel launches.
    """
    args = (scalars, offsets, x, y, mask)
    _check_shapes(*args)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return linreg_reductions_ref(*args)
    if device.type != "cuda":
        raise ValueError(f"linreg_reductions runs on cuda or cpu, not {device}")
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    S, N = x.shape
    if not 0 < S <= _MAX_SHARDS:
        raise ValueError(f"the kernel takes 1..{_MAX_SHARDS} shards, got {S}")

    lib = _kernel_lib()
    chunk = lib.linreg_chunk()
    n_chunks = max(1, -(-N // chunk))
    partials = torch.empty((S, n_chunks, 4), dtype=torch.float32, device=device)
    out = torch.empty((S, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.linreg_reductions_launch(
            *(t.data_ptr() for t in (scalars, offsets, x, y, mask, partials, out)),
            S,
            N,
            n_chunks,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"linreg_reductions launch failed: {lib.linreg_error_string(err).decode()}"
        )
    linreg_reductions.launches += 1
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3]


linreg_reductions.launches = 0


class _DataLogp(torch.autograd.Function):
    """``Σ_i ll_i`` with the gradient the forward pass already produced.

    The backward only scales the saved reductions by the incoming
    cotangent: value and gradient cost ONE data pass together.
    """

    @staticmethod
    def forward(ctx, intercept, slope, log_sigma, offsets, x, y, mask):
        scalars = torch.stack([intercept, slope, log_sigma]).to(torch.float32)
        ll, gmu, gx, gz = linreg_reductions(
            scalars, offsets.to(torch.float32), x, y, mask
        )
        totals = torch.stack([ll, gmu, gx, gz], dim=1).sum(dim=0)
        ctx.save_for_backward(totals, gmu.to(offsets.dtype))
        return totals[0]

    @staticmethod
    def backward(ctx, g):
        # No second derivative through the kernel, as in the JAX package:
        # under create_graph=True grad mode is on here, so refuse.  (torch's
        # @once_differentiable refuses only when the cotangent itself
        # requires grad; a Hessian of prior + data_logp would otherwise
        # silently lose this term.)
        if torch.is_grad_enabled():
            raise RuntimeError(
                "second-order autodiff through the linreg kernel is unsupported"
            )
        totals, goff = ctx.saved_tensors
        return g * totals[1], g * totals[2], g * totals[3], g * goff, None, None, None


def linreg_logp_grad_fn(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor
) -> Callable[[Any], Any]:
    """Build ``logp_and_grad(params) -> (logp, grads)`` on the kernel.

    ``params`` matches :class:`..models.linear.FederatedLinearRegression`:
    ``{intercept, slope, log_sigma, offsets}``.  The returned function
    carries ``.data_logp(params)``, a differentiable scalar that composes
    with other terms (a prior) under ``torch.autograd``.  Second-order
    autodiff through the kernel raises.  The data stay on their device.
    """
    x, y, mask = (t.to(torch.float32).contiguous() for t in (x, y, mask))

    def data_logp(params):
        return _DataLogp.apply(
            params["intercept"],
            params["slope"],
            params["log_sigma"],
            params["offsets"],
            x,
            y,
            mask,
        )

    def logp_and_grad(params):
        return value_and_grad(data_logp, params)

    logp_and_grad.data_logp = data_logp
    return logp_and_grad
