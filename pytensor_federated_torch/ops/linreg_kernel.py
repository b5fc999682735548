"""Fused logp+grad reductions of the federated linear regression.

Port of the JAX package's ``ops/pallas_kernels.py`` (``linreg_reductions``
and ``linreg_logp_grad_fn``).  One pass over each shard's masked
``(x, y)`` block gives the log-likelihood *and* every gradient reduction:

    ll_i        = sum_n m (-0.5 z^2 - log_sigma - 0.5 log 2pi)
    gmu_i       = sum_n m r / sigma^2          (d ll / d(intercept+offset_i))
    gx_i        = sum_n m r x / sigma^2        (d ll / d slope, per shard)
    gz_i        = sum_n m (z^2 - 1)            (d ll / d log_sigma, per shard)

with ``r = y - mu``, ``z = r / sigma``.

The parameters may carry a leading chain axis: ``C`` parameter sets
against the same data, as ``jax.vmap`` batches the JAX package's
``pallas_call`` into one more grid axis.  On CUDA tensors
:func:`linreg_reductions` launches the hand-written Hopper kernel in
``csrc/linreg_reductions.cu`` once for all chains; on CPU tensors it runs
:func:`linreg_reductions_ref`, the plain PyTorch version that the kernel
is held against.  There is no other path: any other device raises.

Under ``torch.func.vmap`` over a batch of shards instead
(:func:`linreg_shard_logp`, the per-shard form that ``FederatedLogp``
maps over a mesh slot's block), the block's rows go to the kernel as
one launch as well.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Callable, Dict, Sequence, Tuple, Union

import torch

from ..utils import LOG_2PI, value_and_grad
from . import _build

Reductions = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
#: ``[intercept, slope, log_sigma]``: one ``(..., 3)`` tensor, or three
#: tensors of one shape (``()`` for one chain, ``(C,)`` for C chains), of
#: one dtype on one device.
Scalars = Union[torch.Tensor, Sequence[torch.Tensor]]

_MAX_TILES = 1 << 30  # the kernel indexes (chain, tile) pairs with 32-bit ints


def _split_scalars(scalars: Scalars) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if torch.is_tensor(scalars):
        if scalars.ndim == 0 or scalars.shape[-1] != 3:
            raise ValueError(
                f"scalars must have shape (3,) or (C, 3), got {tuple(scalars.shape)}"
            )
        return tuple(scalars.unbind(-1))
    parts = tuple(scalars)
    if len(parts) != 3 or not all(torch.is_tensor(p) for p in parts):
        raise ValueError("scalars must be a (..., 3) tensor or three tensors")
    if len({p.shape for p in parts}) != 1:
        raise ValueError(f"the three scalars differ in shape: {[tuple(p.shape) for p in parts]}")
    if len({p.dtype for p in parts}) != 1:
        raise TypeError(f"the three scalars differ in dtype: {[p.dtype for p in parts]}")
    if len({p.device for p in parts}) != 1:
        raise ValueError(f"the three scalars lie on several devices: {[str(p.device) for p in parts]}")
    return parts


def linreg_reductions_ref(
    scalars: Scalars,
    offsets: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
) -> Reductions:
    """Plain PyTorch version of the kernel, in the inputs' dtype.

    Scalars of batch shape ``B`` and offsets ``B + (S,)`` give four
    ``B + (S,)`` tensors."""
    intercept, slope, log_sigma = (t[..., None, None] for t in _split_scalars(scalars))
    inv_s2 = torch.exp(-2.0 * log_sigma)
    mu = (intercept + offsets[..., :, None]) + slope * x
    r = y - mu
    z2 = r * r * inv_s2
    ll = torch.sum(mask * (-0.5 * z2 - log_sigma - 0.5 * LOG_2PI), dim=-1)
    gmu = torch.sum(mask * r, dim=-1) * inv_s2[..., 0]
    gx = torch.sum(mask * r * x, dim=-1) * inv_s2[..., 0]
    gz = torch.sum(mask * (z2 - 1.0), dim=-1)
    return ll, gmu, gx, gz


def _check_shapes(batch, offsets, x, y, mask) -> None:
    if x.ndim != 2 or y.shape != x.shape or mask.shape != x.shape:
        raise ValueError(
            "x, y and mask must share one (S, N) shape, got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(mask.shape)}"
        )
    want = tuple(batch) + (x.shape[0],)
    if tuple(offsets.shape) != want:
        raise ValueError(f"offsets must have shape {want}, got {tuple(offsets.shape)}")


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("linreg_reductions")
    fn = lib.linreg_reductions_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 6 + [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.linreg_tile.restype = ctypes.c_int
    lib.linreg_persistent_blocks.restype = ctypes.c_int
    lib.linreg_persistent_blocks_batched.restype = ctypes.c_int
    lib.linreg_error_string.argtypes = [ctypes.c_int]
    lib.linreg_error_string.restype = ctypes.c_char_p
    return lib


# One ticket (an unsigned int the kernel's blocks count on) per device and
# stream.  Calls on one stream run one after another, so each finds its
# ticket at 0, as the previous call's last block left it; calls on two
# streams may overlap and use two tickets.
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _launch(
    scalars: Sequence[torch.Tensor],
    offsets: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    *,
    max_blocks: int = 0,
) -> torch.Tensor:
    """One launch of the kernel for every chain; returns ``B + (S + 1,
    4)``: each chain's per-shard ``(ll, gmu, gx, gz)`` rows, then its
    totals.  ``scalars`` are three tensors of batch shape ``B`` (``()``
    or ``(C,)``; more axes are flattened), ``offsets`` ``B + (S,)``.
    ``max_blocks > 0`` caps the grid, for the check that the bits do not
    depend on it."""
    batch = tuple(scalars[0].shape)
    if len(batch) > 1:
        scalars = [t.reshape(-1) for t in scalars]
        offsets = offsets.reshape(-1, offsets.shape[-1])
    C = math.prod(batch)
    for t in (*scalars, offsets, x, y, mask):
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, got {t.dtype}")
    if not all(t.is_contiguous() for t in (x, y, mask)) or offsets.stride(-1) != 1:
        raise ValueError("the kernel takes contiguous x, y, mask and offsets rows")
    S, N = x.shape
    lib = _kernel_lib()
    tiles_per_row = max(1, -(-N // lib.linreg_tile()))
    if not 0 < C * S * tiles_per_row <= _MAX_TILES:
        raise ValueError(
            f"the kernel takes 1..{_MAX_TILES} (chain, tile) pairs, got {C * S * tiles_per_row}"
        )
    device = x.device
    partials = torch.empty((C * S * tiles_per_row, 4), dtype=torch.float32, device=device)
    out = torch.empty((C, S + 1, 4), dtype=torch.float32, device=device)
    strided = []
    for t, event_ndim in zip((*scalars, offsets), (0, 0, 0, 1)):
        strided += [t.data_ptr(), t.stride(0) if C > 1 and t.ndim > event_ndim else 0]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ticket = _tickets.get((device.index, stream))
        if ticket is None:
            ticket = torch.zeros((), dtype=torch.int32, device=device)
            _tickets[(device.index, stream)] = ticket
        err = lib.linreg_reductions_launch(
            *strided,
            *(t.data_ptr() for t in (x, y, mask, partials, out, ticket)),
            C,
            S,
            N,
            tiles_per_row,
            max_blocks,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"linreg_reductions launch failed: {lib.linreg_error_string(err).decode()}"
        )
    linreg_reductions.launches += 1
    return out.reshape(batch + (S + 1, 4))


def _reduce(
    scalars: Scalars,
    offsets: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """``B + (S + 1, 4)``: each chain's per-shard ``(ll, gmu, gx, gz)``
    rows, then their totals over shards.  One kernel launch on CUDA for
    all chains; on the CPU the plain version, its rows summed."""
    scalars = _split_scalars(scalars)
    _check_shapes(scalars[0].shape, offsets, x, y, mask)
    devices = {t.device for t in (*scalars, offsets, x, y, mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        rows = torch.stack(linreg_reductions_ref(scalars, offsets, x, y, mask), dim=-1)
        return torch.cat([rows, rows.sum(dim=-2, keepdim=True)], dim=-2)
    if device.type != "cuda":
        raise ValueError(f"linreg_reductions runs on cuda or cpu, not {device}")
    return _launch(scalars, offsets, x, y, mask)


def linreg_reductions_and_totals(
    scalars: Scalars,
    offsets: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[Reductions, torch.Tensor]:
    """:func:`linreg_reductions` and each chain's four totals over
    shards, ``(sum ll, sum gmu, sum gx, sum gz)`` (``B + (4,)``), from one
    call (on CUDA, one kernel launch)."""
    out = _reduce(scalars, offsets, x, y, mask)
    S = out.shape[-2] - 1
    return (out[..., :S, 0], out[..., :S, 1], out[..., :S, 2], out[..., :S, 3]), out[..., S, :]


def linreg_reductions(
    scalars: Scalars,
    offsets: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
) -> Reductions:
    """Per-shard ``(ll, gmu, gx, gz)`` reductions, one fused data pass.

    ``scalars = [intercept, slope, log_sigma]``, a ``(3,)`` tensor or
    three 0-d tensors; ``offsets``: ``(S,)``; ``x, y, mask``: ``(S, N)``.
    Returns four ``(S,)`` vectors.  With a chain axis, scalars ``(C, 3)``
    (or three ``(C,)`` tensors) and offsets ``(C, S)`` against the same
    data give four ``(C, S)`` tensors from one launch.  On CUDA every
    input must be float32 on one device, the data and the offsets' rows
    contiguous; the kernel masks the ragged observation edge itself, so
    nothing is padded.  ``linreg_reductions.launches`` counts kernel
    launches.
    """
    return linreg_reductions_and_totals(scalars, offsets, x, y, mask)[0]


linreg_reductions.launches = 0

class _LinregLogp(torch.autograd.Function):
    """``Σ_i ll_i`` with the gradient the forward pass already produced.

    Returns ``(logp, ll, out)``: the total (the kernel's totals row), the
    per-shard ``ll_i`` (``(..., S)``), both differentiable, and the
    reductions ``out`` (``(..., S + 1, 4)``, not differentiable).
    :class:`_DataLogp` gives the first; a batch of shard blocks
    (:func:`_shard_batched`) sums the second by block.  The backward
    only scales the saved reductions by the incoming cotangents: value
    and gradient cost ONE data pass together.  On CUDA the forward is the
    kernel's one launch: the parameters enter by pointer and the kernel
    writes the reductions.  The parameters may carry leading chain axes,
    and under ``torch.func.vmap`` the :meth:`vmap` rule moves the vmapped
    axis in front and calls the batched launch once for all chains: it
    never loops over chains.
    """

    @staticmethod
    def forward(intercept, slope, log_sigma, offsets, x, y, mask):
        out = _reduce((intercept, slope, log_sigma), offsets, x, y, mask)
        S = out.shape[-2] - 1
        return out[..., S, 0], out[..., :S, 0], out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_backward(output[2])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g, g_ll, _g_out):
        # No second derivative through the kernel, as in the JAX package:
        # under create_graph=True grad mode is on here, so refuse.  (torch's
        # @once_differentiable refuses only when the cotangent itself
        # requires grad; a Hessian of prior + data_logp would otherwise
        # silently lose this term.)  A torch.func grad transform always
        # builds that graph, so it is refused too.
        if torch.is_grad_enabled():
            raise RuntimeError(
                "second-order autodiff through the linreg kernel is unsupported"
            )
        (out,) = ctx.saved_tensors
        S = out.shape[-2] - 1
        grads = []
        if g is not None:
            totals = out[..., S, :]
            grads.append((g * totals[..., 1], g * totals[..., 2], g * totals[..., 3],
                          g[..., None] * out[..., :S, 1]))
        if g_ll is not None:
            gmu = g_ll * out[..., :S, 1]
            grads.append((gmu.sum(-1), (g_ll * out[..., :S, 2]).sum(-1),
                          (g_ll * out[..., :S, 3]).sum(-1), gmu))
        if not grads:
            return (None,) * 7
        summed = grads[0] if len(grads) == 1 else tuple(a + b for a, b in zip(*grads))
        return (*summed, None, None, None)

    @staticmethod
    def vmap(info, in_dims, intercept, slope, log_sigma, offsets, x, y, mask):
        if any(d is not None for d in in_dims[4:]):
            if any(d is not None for d in in_dims[:3]) or any(d is None for d in in_dims[4:]):
                raise ValueError(
                    "the linreg kernel shares x, y and mask among chains; vmap over the "
                    "parameters only, or over a batch of shards (x, y, mask and offsets "
                    "together) with shared intercept, slope and log_sigma"
                )
            return _shard_batched(info, in_dims, intercept, slope, log_sigma, offsets, x, y, mask)

        def front(t, d):
            if d is None:
                return t.expand(info.batch_size, *t.shape)
            return t.movedim(d, 0)

        params = [front(t, d) for t, d in zip((intercept, slope, log_sigma, offsets), in_dims)]
        return _LinregLogp.apply(*params, x, y, mask), (0, 0, 0)


def _shard_batched(info, in_dims, intercept, slope, log_sigma, offsets, x, y, mask):
    """The vmap rule over a batch of shard blocks (``torch.func.vmap`` of
    a per-shard logp over the shard axis, as ``FederatedLogp`` maps its
    shards): the blocks' rows are stacked into one ``(B S, N)`` call, a
    single launch, with the parameters shared by every block; each
    block's logp is the sum of its rows' ``ll_i``."""
    B = info.batch_size
    x, y, mask = (t.movedim(d, 0).reshape(-1, t.shape[-1]).contiguous()
                  for t, d in zip((x, y, mask), in_dims[4:]))
    offsets = (offsets.expand(B, *offsets.shape) if in_dims[3] is None
               else offsets.movedim(in_dims[3], 0))
    S = offsets.shape[-1]
    _, ll, out = _LinregLogp.apply(intercept, slope, log_sigma,
                                   offsets.reshape(-1).contiguous(), x, y, mask)
    ll, rows = ll.reshape(B, S), out[:-1].reshape(B, S, 4)
    return (ll.sum(-1), ll, torch.cat([rows, rows.sum(-2, keepdim=True)], dim=-2)), (0, 0, 0)


class _DataLogp:
    """The differentiable scalar ``Σ_i ll_i`` of :class:`_LinregLogp`."""

    @staticmethod
    def apply(intercept, slope, log_sigma, offsets, x, y, mask):
        return _LinregLogp.apply(intercept, slope, log_sigma, offsets, x, y, mask)[0]


def linreg_shard_logp(params: Any, shard: Any) -> torch.Tensor:
    """One shard's data log-likelihood through the kernel, in the
    per-shard form ``FederatedLogp`` maps: ``params`` as
    :class:`..models.linear.FederatedLinearRegression`'s, ``shard`` its
    data tree's entry ``((x, y), mask, shard_id)`` with ``x, y, mask`` of
    shape ``(N,)``.  Under ``torch.func.vmap`` over a block of shards it
    is one kernel launch for the block (a mesh slot's whole block); on
    CPU tensors the plain version.  The data are used as given (float32,
    contiguous rows on CUDA)."""
    (x, y), mask, sid = shard
    offset = params["offsets"][sid]
    return _DataLogp.apply(
        params["intercept"], params["slope"], params["log_sigma"], offset[None],
        x[None], y[None], mask[None],
    )


def linreg_logp_grad_fn(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor
) -> Callable[[Any], Any]:
    """Build ``logp_and_grad(params) -> (logp, grads)`` on the kernel.

    ``params`` matches :class:`..models.linear.FederatedLinearRegression`:
    ``{intercept, slope, log_sigma, offsets}``.  The returned function
    carries ``.data_logp(params)``, a differentiable scalar that composes
    with other terms (a prior) under ``torch.autograd``; under
    ``torch.func.vmap`` over chains it is one kernel launch for all of
    them.  Second-order autodiff through the kernel raises.  The data
    stay on their device.
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
