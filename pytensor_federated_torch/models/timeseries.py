"""Sequence-parallel time-series models (long-context likelihoods).

Port of the JAX package's ``models/timeseries.py``: an AR(1) observation
chain of length T, optionally cut along the ``"seq"`` mesh axis, whose
Markov-factored log-likelihood passes one element per slot between
neighbours (:func:`..parallel.ring.seq_sharded_markov_logp`).

Model:

    y_0 ~ Normal(mu, sigma / sqrt(1 - phi^2))          (stationary init)
    y_t ~ Normal(mu + phi * (y_{t-1} - mu), sigma)     t >= 1

Parameters: ``mu``, ``arctanh_phi`` (unconstrained; phi = tanh), and
``log_sigma`` (unconstrained; sigma = exp), so samplers work in R^3.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import SEQ_AXIS, Mesh
from ..parallel.ring import seq_sharded_markov_logp
from ..utils import LOG_2PI, resolve_device, value_and_grad

__all__ = ["SeqShardedAR1", "generate_ar1_data"]


def generate_ar1_data(
    n_steps: int = 4096,
    *,
    mu: float = 0.5,
    phi: float = 0.8,
    sigma: float = 0.3,
    seed: int = 7,
) -> np.ndarray:
    """Simulate one AR(1) path (float32, stationary start); numpy's
    ``default_rng`` makes it, byte-identical to the JAX package's."""
    rng = np.random.default_rng(seed)
    y = np.empty(n_steps, dtype=np.float32)
    y[0] = mu + rng.normal() * sigma / np.sqrt(1.0 - phi**2)
    eps = rng.normal(size=n_steps).astype(np.float32) * sigma
    for t in range(1, n_steps):
        y[t] = mu + phi * (y[t - 1] - mu) + eps[t]
    return y


def _unpack(params: Any):
    return params["mu"], torch.tanh(params["arctanh_phi"]), torch.exp(params["log_sigma"])


def _trans_logp(params, y_prev, y_curr):
    """Vectorized transition density log N(y_t | mu + phi (y_{t-1}-mu), sigma)."""
    mu, phi, sigma = _unpack(params)
    resid = y_curr - (mu + phi * (y_prev - mu))
    return -0.5 * (resid / sigma) ** 2 - torch.log(sigma) - 0.5 * LOG_2PI


def _init_logp(params, y0):
    mu, phi, sigma = _unpack(params)
    s0 = sigma / torch.sqrt(1.0 - phi**2)
    return -0.5 * ((y0 - mu) / s0) ** 2 - torch.log(s0) - 0.5 * LOG_2PI


def _prior_logp(params):
    """Weak priors keeping the posterior proper: mu,arctanh_phi,log_sigma ~ N(0, 10)."""
    return sum(-0.5 * (params[k] / 10.0) ** 2 for k in ("mu", "arctanh_phi", "log_sigma"))


class SeqShardedAR1:
    """AR(1) likelihood with the sequence cut over the mesh's ``axis``.

    With ``mesh=None`` the same model evaluates on one device in its
    vectorized form (the ground truth of the equivalence tests).  ``y``
    (numpy or a tensor) lands on the first slot's device with a mesh,
    else on ``device`` (``cuda`` unless the caller says otherwise); the
    parameters live there too, and the prior is added there."""

    def __init__(
        self,
        y: Any,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = SEQ_AXIS,
        device: Any = None,
    ):
        dev = mesh.slot_devices(axis)[0] if mesh is not None and axis in mesh.axis_names \
            else resolve_device(device)
        self.y = torch.as_tensor(np.asarray(y) if not torch.is_tensor(y) else y, device=dev)
        self.mesh = mesh
        self.axis = axis
        self.device = self.y.device
        if mesh is not None:
            like = seq_sharded_markov_logp(_trans_logp, _init_logp, self.y, mesh=mesh, axis=axis)
            self._logp = lambda params: like(params) + _prior_logp(params)
        else:
            y_ = self.y

            def logp(params):
                lp = _init_logp(params, y_[0])
                lp = lp + torch.sum(_trans_logp(params, y_[:-1], y_[1:]))
                return lp + _prior_logp(params)

            self._logp = logp

    def init_params(self) -> dict:
        return {k: torch.zeros((), dtype=self.y.dtype, device=self.device)
                for k in ("arctanh_phi", "log_sigma", "mu")}

    def logp(self, params: Any) -> torch.Tensor:
        return self._logp(params)

    def logp_and_grad(self, params: Any):
        return value_and_grad(self._logp, params)

    __call__ = logp
