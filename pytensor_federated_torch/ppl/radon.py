"""The hierarchical radon GLM, written ONCE as an effectful model.

The port of the JAX package's ``ppl/radon.py``: the model the port
ships hand-written (``models/glm.py:HierarchicalRadonGLM``, the BASELINE
"PyMC hierarchical radon GLM" config) expressed through the effect
layer, so one definition drives every execution mode: direct
log-density, NUTS, parallel tempering, batch SVI, and streaming SVI
through the gateway (bench_suite config 20).

Scales are log-parameterized through :class:`~.distributions.
HalfNormalLog` — the HalfNormal(1)-with-Jacobian term ``models/glm.py``
writes by hand — so the parameter vector is fully unconstrained and
plugs straight into the samplers.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ..models.glm import generate_radon_data
from .distributions import HalfNormalLog, Normal
from .handlers import deterministic, plate, sample, subsample

__all__ = ["make_radon_example", "radon_model"]


def radon_model(floor: Any, log_radon: Any, mask: Any) -> None:
    """Partial-pooling radon GLM over county shards (one county = one
    plate position = one federated shard).  Arguments are the packed
    ``(n_counties, n_obs)`` tensors from
    :func:`~..models.glm.generate_radon_data`."""
    mu_alpha = sample("mu_alpha", Normal(0.0, 10.0))
    log_sigma_alpha = sample("log_sigma_alpha", HalfNormalLog(1.0))
    beta = sample("beta", Normal(0.0, 10.0))
    log_sigma = sample("log_sigma", HalfNormalLog(1.0))
    with plate("county", int(floor.shape[0])) as county:
        alpha_raw = sample("alpha_raw", Normal(0.0, 1.0))
        alpha = deterministic("alpha", mu_alpha + torch.exp(log_sigma_alpha) * alpha_raw)
        f = subsample(floor, county)
        y = subsample(log_radon, county)
        m = subsample(mask, county)
        eta = alpha[:, None] + beta * f
        sample("obs", Normal(eta, torch.exp(log_sigma)), obs=y, mask=m)


def make_radon_example(
    n_counties: int = 16,
    *,
    mean_obs: int = 24,
    seed: int = 11,
    device: Any = None,
) -> Tuple[Callable[..., None], Tuple[Any, ...], dict]:
    """Synthetic radon data packed for the effectful model, on
    ``device`` (CUDA unless the caller asks for the CPU): returns
    ``(model, model_args, true_params)`` ready for
    ``ppl.compile(model, model_args, ...)``.  The data's bytes equal the
    JAX package's for the same arguments."""
    data, true = generate_radon_data(n_counties, mean_obs=mean_obs, seed=seed, device=device)
    (floor, y), mask = data.tree()
    return radon_model, (floor, y, mask), true
