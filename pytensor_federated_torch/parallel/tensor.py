"""Tensor parallelism: feature-sharded GLM evaluation.

Port of the JAX package's ``parallel/tensor.py``, for the regime where
the DESIGN MATRIX, not the observation count, outgrows a device: ``X``
is ``(n, d)`` with huge ``d``, so ``X`` and the coefficient vector ``w``
are partitioned column-wise over a ``"tp"`` mesh axis and the
contraction ``X @ w`` runs as per-slot partial matvecs that are summed
across the slots.

The JAX module is plain ``jnp`` under GSPMD, which partitions the matmul
and inserts the sum.  A single controller (:mod:`.mesh`) makes the
partition explicit: ``X``'s column block ``j`` lives on slot ``j``'s
device, each slot multiplies it by ``w``'s block ``j`` (a parameter
block on that device), and the partial logits are added on the first
slot's device in slot order.  ``w`` is a tuple of per-slot blocks, so
its gradient comes back per slot too: block ``j``'s gradient stays on
slot ``j``'s device (the JAX package's "stays sharded").  With
``rows_axis`` the mesh is 2-D: ``X`` is tiled over rows and columns,
tile ``(r, j)`` on the device at row ``r`` of ``rows_axis`` and column
``j`` of ``axis``; each row block's partial logits are summed over its
tiles, and the log-likelihood over the row blocks.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..models.linear import _normal_logpdf
from ..utils import resolve_device, tree_map, value_and_grad
from .mesh import Mesh
from .sharded import _cross_slot_sum

TP_AXIS = "tp"

__all__ = ["TP_AXIS", "TensorParallelLogistic"]


def _tile_devices(mesh: Mesh, axis: str, rows_axis: Optional[str]) -> np.ndarray:
    """``(R, K)`` devices: tile ``(r, j)``'s at row ``r`` of ``rows_axis``
    (one row without it) and column ``j`` of ``axis``, the first device
    of its group over any other axis."""
    if rows_axis is None:
        grid = np.empty((1, mesh.shape[axis]), dtype=object)
        grid[0, :] = mesh.slot_devices(axis)
        return grid
    names = list(mesh.axis_names)
    grid = np.moveaxis(mesh.devices, [names.index(rows_axis), names.index(axis)], [0, 1])
    return grid.reshape(grid.shape[0], grid.shape[1], -1)[:, :, 0]


class TensorParallelLogistic:
    """Bernoulli GLM with features (columns of ``X``, entries of ``w``)
    sharded over a mesh axis.

    Same posterior as
    :class:`~pytensor_federated_torch.models.logistic.FederatedLogisticRegression`
    on a single un-split shard — the parallel axis here is the FEATURE
    dimension, complementary to the federated shard axis (rows).  Pass
    ``rows_axis`` to compose both on a 2-D mesh: ``X`` is then row- AND
    column-tiled (``self.X`` is the ``(R, K)`` grid of tiles, each on its
    device), ``y`` row-blocked, ``w`` column-blocked.

    ``X`` and ``y`` become ``dtype`` (float32, as in the JAX package) on
    ``device`` (CUDA unless told otherwise) without a mesh, on the
    mesh's devices with one."""

    def __init__(
        self,
        X,
        y,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = TP_AXIS,
        rows_axis: Optional[str] = None,
        prior_scale: float = 5.0,
        device: Any = None,
        dtype: torch.dtype = torch.float32,
    ):
        self.mesh = mesh
        self.axis = axis
        self.rows_axis = rows_axis
        self.prior_scale = prior_scale
        self.dtype = dtype
        X = torch.as_tensor(np.asarray(X)).to(dtype)
        y = torch.as_tensor(np.asarray(y)).to(dtype)
        self.n, self.d = X.shape
        if mesh is not None:
            k = mesh.shape[axis]
            if self.d % k != 0:
                raise ValueError(
                    f"d={self.d} not divisible by mesh axis {axis!r} "
                    f"of size {k}"
                )
            if rows_axis is not None and self.n % mesh.shape[rows_axis]:
                raise ValueError(
                    f"n={self.n} not divisible by mesh axis "
                    f"{rows_axis!r} of size {mesh.shape[rows_axis]}"
                )
            self._tiles = _tile_devices(mesh, axis, rows_axis)
            self._w_devices = list(self._tiles[0])
            self.device = self._w_devices[0]
            R, K = self._tiles.shape
            nr, dk = self.n // R, self.d // K
            tiles = np.empty((R, K), dtype=object)
            for r in range(R):
                for j in range(K):
                    tiles[r, j] = X[r * nr:(r + 1) * nr, j * dk:(j + 1) * dk].to(
                        self._tiles[r, j]).contiguous()
            self.X = tiles
            self.y = [y[r * nr:(r + 1) * nr].to(self._tiles[r, 0]) for r in range(R)]
        else:
            self.device = resolve_device(device)
            self.X, self.y = X.to(self.device), y.to(self.device)

    @property
    def tile_shape(self) -> tuple:
        """The shape of one slot's tile of ``X`` (``X``'s shape without a
        mesh)."""
        if self.mesh is None:
            return tuple(self.X.shape)
        return tuple(self.X[0, 0].shape)

    def _loglik_rows(self, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.sum(y * logits - torch.logaddexp(torch.zeros_like(logits), logits))

    def logp(self, params: Any) -> torch.Tensor:
        w, b = params["w"], params["b"]
        s = self.prior_scale
        if self.mesh is None:
            ll = self._loglik_rows(self.X @ w + b, self.y)
            return ll + (torch.sum(_normal_logpdf(w, 0.0, s)) + _normal_logpdf(b, 0.0, s))
        R, K = self._tiles.shape
        rows = []
        for r in range(R):
            # Slot (r, j)'s partial matvec with w's block j; the partial
            # logits summed over the row's slots: the TP contraction.
            partial = [self.X[r, j] @ w[j].to(self._tiles[r, j]) for j in range(K)]
            logits = _cross_slot_sum(partial) + b.to(self._tiles[r, 0])
            rows.append(self._loglik_rows(logits, self.y[r]))
        ll = _cross_slot_sum(rows)
        lp = _cross_slot_sum([torch.sum(_normal_logpdf(wj, 0.0, s)) for wj in w])
        return ll + (lp.to(ll.device) + _normal_logpdf(b, 0.0, s).to(ll.device))

    def logp_and_grad(self, params: Any):
        return value_and_grad(self.logp, params)

    def init_params(self) -> Any:
        zeros = lambda n, d: torch.zeros((n,), dtype=self.dtype, device=d)
        if self.mesh is None:
            w = zeros(self.d, self.device)
        else:
            # The coefficient vector lives in blocks from the start; its
            # gradient (and any optimizer state built from it) is
            # blocked the same way — each slot owns d/k coefficients.
            dk = self.d // len(self._w_devices)
            w = tuple(zeros(dk, dev) for dev in self._w_devices)
        return {"w": w, "b": torch.zeros((), dtype=self.dtype, device=self.device)}

    def _place(self, params: Any) -> Any:
        """``params`` with each ``w`` block on its slot's device."""
        if self.mesh is None:
            return params
        w = tuple(wj.to(d) for wj, d in zip(params["w"], self._w_devices))
        return {"w": w, "b": params["b"].to(self.device)}

    def find_map(self, **kwargs):
        from ..samplers import find_map

        # find_map steps one flat vector; it lives on the first slot's
        # device, and logp sends each block to its slot.
        init = tree_map(lambda t: t.to(self.device), self.init_params())
        return self._place(find_map(self.logp, init, **kwargs))


def generate_wide_logistic_data(
    n_obs: int = 256, n_features: int = 64, *, seed: int = 13
):
    """Wide-feature single-shard data for the TP regime (numpy arrays,
    the JAX package's bytes for the same seed)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=n_features) / np.sqrt(n_features)).astype(
        np.float32
    )
    X = rng.normal(size=(n_obs, n_features)).astype(np.float32)
    logits = X @ w
    y = (rng.uniform(size=n_obs) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float32
    )
    return X, y, w
