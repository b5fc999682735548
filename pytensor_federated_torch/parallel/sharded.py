"""The sharded evaluator: ``logp(params) = Σ_shards per_shard_logp``.

The port of the JAX package's ``FederatedLogp`` without a mesh: the
per-shard callable is mapped over the leading shard axis of the data
tree with ``torch.func.vmap`` and the per-shard contributions are
summed on the device.  Gradients come from ``torch.autograd`` through
the map and the sum, so one backward pass gives every parameter's
gradient.  The mesh placement (the shards axis across GPUs) is not
ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch

from ..utils import tree_leaves, tree_map, value_and_grad

# per_shard_logp(params, shard_data) -> scalar logp contribution of one shard.
PerShardLogpFn = Callable[[Any, Any], torch.Tensor]
# per_shard_fn(params, shard_data) -> tree of per-shard outputs.
PerShardComputeFn = Callable[[Any, Any], Any]


def _leading_dim(data: Any) -> int:
    leaves = tree_leaves(data)
    if not leaves:
        raise ValueError("data pytree has no leaves")
    dims = {int(leaf.shape[0]) for leaf in leaves}
    if len(dims) != 1:
        raise ValueError(
            f"all data leaves must share a leading shard axis, got {dims}"
        )
    return dims.pop()


class NoFederatedShards:
    """Sentinel for models built without a federated shard axis.

    Assigned to ``model.fed`` when a construction option (e.g.
    ``flatten=True``) collapses the shard axis, so that any attempt to
    use a ``.fed``-dependent API (``logp_minibatch``, mesh placement)
    fails with a targeted message instead of an opaque
    ``AttributeError`` on ``None``.
    """

    def __init__(self, reason: str):
        self._reason = reason

    def __bool__(self) -> bool:
        return False

    def __getattr__(self, name: str):
        raise AttributeError(
            f"this model has no federated shard axis ({self._reason}); "
            f"'.fed.{name}' is unavailable — construct the model without "
            "that option to use federated/minibatch/mesh APIs"
        )


class FederatedLogp:
    """Sharded log-potential over a data tree with a leading shard axis.

    ``data`` leaves carry a leading ``n_shards`` axis (build
    heterogeneous shards with :func:`..parallel.packing.pack_shards`).

    ``remat=True`` saves only the shard map's inputs for the backward
    pass, which recomputes the shards' intermediate tensors instead of
    holding them in device memory: arithmetic traded for memory when
    shards are large (:class:`_Remat`).  It holds inside
    ``torch.func.vmap`` too, as ``jax.checkpoint`` composes with
    ``jax.vmap``: for a batch of chains whose graph a later
    ``torch.autograd.grad`` walks, and under ``torch.func.vjp`` (as
    :func:`..utils.value_and_grad` runs inside ``vmap``), which
    otherwise holds every intermediate until its ``vjp_fn`` runs.
    Values and gradients equal the non-remat path's.

    Every method works under an outer ``torch.func.vmap`` over chains
    (the shard map is then a vmap nested in it).
    """

    def __init__(self, per_shard_logp: PerShardLogpFn, data: Any, *, remat: bool = False):
        self.per_shard_logp = per_shard_logp
        self.n_shards = _leading_dim(data)
        self.data = data
        self.remat = remat

    def _shard_map(self, params: Any, data: Any) -> torch.Tensor:
        def run(params, data):
            return torch.func.vmap(lambda d: self.per_shard_logp(params, d))(data)

        if not self.remat:
            return run(params, data)
        # _Remat differentiates one flat parameter vector: its nested vjp
        # under vmap trips a functorch internal assert (``batched ==
        # nullptr``, torch 2.13) with several differentiated inputs.
        p_leaves, d_leaves = tree_leaves(params), tree_leaves(data)
        meta = [(leaf.shape, leaf.dtype) for leaf in p_leaves]
        flat = torch.cat([leaf.reshape(-1) for leaf in p_leaves])

        def run_flat(flat, *d_leaves):
            parts = torch.split(flat, [math.prod(shape) for shape, _ in meta])
            it_p = (part.reshape(shape).to(dtype) for part, (shape, dtype) in zip(parts, meta))
            it_d = iter(d_leaves)
            return run(tree_map(lambda _: next(it_p), params), tree_map(lambda _: next(it_d), data))

        return _Remat.apply(run_flat, flat, *d_leaves)

    def per_shard_logps(self, params: Any) -> torch.Tensor:
        """Vector of per-shard contributions."""
        return self._shard_map(params, self.data)

    def logp(self, params: Any) -> torch.Tensor:
        """Scalar total log-potential."""
        return self.per_shard_logps(params).sum()

    def logp_and_grad(self, params: Any) -> Tuple[torch.Tensor, Any]:
        """(logp, grads) from one forward and one backward pass."""
        return value_and_grad(self.logp, params)

    __call__ = logp

    def logp_batch(self, params_batch: Any) -> torch.Tensor:
        """Evaluate B parameter sets at once: leaves carry a leading batch
        axis; returns ``(B,)`` logps."""
        return torch.func.vmap(self.logp)(params_batch)

    def logp_minibatch(
        self, params: Any, generator: torch.Generator, num_shards: int
    ) -> torch.Tensor:
        """Unbiased minibatch estimate of :meth:`logp` from a random
        subset of ``num_shards`` shards, drawn without replacement from
        ``generator`` and scaled by ``S/k``.

        The subsample is a gather, not a mask, so compute really drops
        to ``k/S`` of the full pass — the data subsampling of
        stochastic-gradient samplers."""
        return self._minibatch_estimate(params, self._draw_shards(generator, num_shards))

    def logp_and_grad_minibatch(
        self, params: Any, generator: torch.Generator, num_shards: int
    ) -> Tuple[torch.Tensor, Any]:
        """(estimate, grad-estimate) of the minibatch logp — the
        stochastic gradient for SGLD/SGHMC-style samplers."""
        idx = self._draw_shards(generator, num_shards)
        return value_and_grad(lambda p: self._minibatch_estimate(p, idx), params)

    def _minibatch_estimate(self, params: Any, idx: torch.Tensor) -> torch.Tensor:
        """``S/k`` times the summed logp of the shards ``idx`` (``k`` of
        them) — the estimator :meth:`logp_minibatch` evaluates on a
        random draw of ``idx``."""
        sub = tree_map(lambda a: torch.index_select(a, 0, idx.to(a.device)), self.data)
        return self._shard_map(params, sub).sum() * (self.n_shards / int(idx.shape[0]))

    def _draw_shards(self, generator: torch.Generator, num_shards: int) -> torch.Tensor:
        if not (0 < num_shards <= self.n_shards):
            raise ValueError(
                f"num_shards must be in 1..{self.n_shards}, got {num_shards}"
            )
        perm = torch.randperm(self.n_shards, generator=generator, device=generator.device)
        return perm[:num_shards]


class _Remat(torch.autograd.Function):
    """``fn(flat_params, *data)`` whose backward recomputes ``fn``.

    Saves only its inputs; the backward pass runs ``fn`` again under
    ``torch.func.vjp`` with respect to ``flat_params`` (the data need no
    gradient).  A ``setup_context`` Function with a generated vmap rule,
    so it composes with ``torch.func.vmap`` over chains and with a grad
    transform inside it, where ``torch.utils.checkpoint`` cannot
    recompute."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, flat, *data):
        return fn(flat, *data)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, *leaves = inputs
        ctx.fn = fn
        ctx.save_for_backward(*leaves)

    @staticmethod
    def backward(ctx, grad_out):
        flat, *data = ctx.saved_tensors
        _, vjp_fn = torch.func.vjp(lambda p: ctx.fn(p, *data), flat)
        return (None, *vjp_fn(grad_out), *(None,) * len(data))


def sharded_compute(per_shard_fn: PerShardComputeFn, data: Any) -> Callable[[Any], Any]:
    """Generic arrays->arrays over every shard, outputs stacked by shard.

    For compute that is not a log-potential: returns ``fn(params) ->
    tree`` whose leaves have a leading ``n_shards`` axis."""
    _leading_dim(data)

    def fn(params):
        return torch.func.vmap(lambda d: per_shard_fn(params, d))(data)

    return fn
