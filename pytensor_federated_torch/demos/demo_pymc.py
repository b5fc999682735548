"""PyMC driver demo — a PyMC model whose likelihood is a federated op.

The model is a hierarchical linear regression as a ``pm.Model`` whose
data likelihood is this framework's federated evaluation:

- priors live in PyMC (so transforms/Jacobians are PyMC's business,
  identical between the federated and natively-built models);
- the per-shard data log-likelihood of every shard is ONE call of the
  Hopper kernel (``ops/linreg_kernel.py``) over the packed shards on the
  card — on the CPU its plain version — exposed to PyTensor through
  :func:`bridge.federated_potential` both as a host callable (C/py
  linkers — ``perform``) and as a ``torch_fn`` (PyTensor's PyTorch
  linker, ``mode="PYTORCH"``).

Dtype seam: PyMC computes in float64; the federated boundary is float32
(the kernel's dtype).  Values cross the boundary as float32 and are
cast back — parity with a native float64 PyMC model holds to ~1e-5
relative on O(100) log-densities.

Run: ``python -m pytensor_federated_torch.demos.demo_pymc [--device cpu]``
(requires pymc; the package deliberately does not depend on it).
"""

from __future__ import annotations

import argparse
from typing import Any, Optional

import numpy as np
import torch

from ..models.linear import generate_node_data
from ..ops.linreg_kernel import _LinregLogp
from ..parallel.packing import ShardedData
from ..utils import resolve_device


class _DataTerm:
    """``sum_i logN(y_i | A_i + slope * x_i, sigma)`` over the masked
    shards, and its gradients w.r.t. ``(A, slope, sigma)``, from one
    kernel call: the kernel's intercept is 0, its offsets are ``A`` and
    its scale parameter ``log sigma``.  A module-level class, so the
    bound methods handed to the ops pickle with their data."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> None:
        self.x, self.y, self.mask = (t.to(torch.float32).contiguous() for t in (x, y, mask))
        self.device = self.x.device

    def torch_fn(self, A: torch.Tensor, slope: torch.Tensor, sigma: torch.Tensor):
        """``(logp, [dA, dslope, dsigma])`` for the PyTorch lane.

        ``logp`` keeps the kernel's autograd graph to the inputs (a
        sampler's own backward through the model reaches it); the
        gradients are the reductions the same launch wrote, with no
        graph.  Inputs are cast to float32 for the kernel and the
        outputs back to ``slope``'s dtype."""
        dtype = slope.dtype
        A, slope, sigma = (t.to(self.device, torch.float32) for t in (A, slope, sigma))
        logp, _, out = _LinregLogp.apply(
            torch.zeros_like(slope), slope, torch.log(sigma), A, self.x, self.y, self.mask
        )
        S = out.shape[-2] - 1
        # d ll / d A_i is the kernel's gmu_i; d / d slope its gx total;
        # d / d sigma its d / d log sigma total divided by sigma.
        grads = [out[..., :S, 1], out[..., S, 2], out[..., S, 3] / sigma.detach()]
        return logp.to(dtype), [g.to(dtype) for g in grads]

    def host_fn(self, A: Any, slope: Any, sigma: Any):
        """The host ``LogpGradFn`` (the ``perform`` lane): numpy in,
        float32 across the boundary, numpy out."""
        args = [torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                for a in (A, slope, sigma)]
        with torch.no_grad():
            logp, grads = self.torch_fn(*args)
        return logp.cpu().numpy(), [g.cpu().numpy() for g in grads]


def make_federated_data_logp(data: ShardedData, device: Any = None):
    """``(torch_fn, host_fn)`` computing the shard-summed data
    log-likelihood ``sum_i logN(y_i | A_i + slope * x_i, sigma)`` and
    its gradients w.r.t. ``(A, slope, sigma)``.

    ``A`` is the per-shard intercept vector (global intercept + shard
    offset).  All shards evaluate in one kernel launch on ``device``
    (the data's own device unless given); on the CPU the kernel's plain
    version runs.  ``host_fn`` crosses the numpy boundary (the C/py-linker
    ``perform`` path); ``torch_fn`` takes and returns tensors (the
    PyTorch linker's lane)."""
    (x, y), mask = data.tree()
    dev = mask.device if device is None else torch.device(device)
    term = _DataTerm(x.to(dev), y.to(dev), mask.to(dev))
    return term.torch_fn, term.host_fn


def build_model(
    data: ShardedData,
    *,
    use_torch_fn: bool = True,
    prior_scale: float = 10.0,
    offset_scale: float = 0.3,
):
    """A ``pm.Model`` with the federated data likelihood as a Potential:
    global intercept + per-shard offsets + shared slope + noise scale,
    likelihood behind the federated boundary, on the data's device."""
    import pymc as pm

    from ..bridge import federated_potential

    torch_fn, host_fn = make_federated_data_logp(data)
    n_shards = data.tree()[1].shape[0]

    with pm.Model() as model:
        intercept = pm.Normal("intercept", 0.0, prior_scale)
        offsets = pm.Normal("offsets", 0.0, offset_scale, shape=n_shards)
        slope = pm.Normal("slope", 0.0, prior_scale)
        sigma = pm.HalfNormal("sigma", 1.0)
        pm.Potential(
            "federated_loglik",
            federated_potential(
                host_fn,
                intercept + offsets,
                slope,
                sigma,
                torch_fn=torch_fn if use_torch_fn else None,
            ),
        )
    return model


def build_native_model(
    data: ShardedData,
    *,
    prior_scale: float = 10.0,
    offset_scale: float = 0.3,
):
    """The SAME posterior built natively in PyMC (no federated op) — the
    parity oracle."""
    import pymc as pm

    (x, y), mask = data.tree()
    x = x.cpu().numpy()
    y = y.cpu().numpy()
    mask = mask.cpu().numpy().astype(bool)
    n_shards = x.shape[0]

    with pm.Model() as model:
        intercept = pm.Normal("intercept", 0.0, prior_scale)
        offsets = pm.Normal("offsets", 0.0, offset_scale, shape=n_shards)
        slope = pm.Normal("slope", 0.0, prior_scale)
        sigma = pm.HalfNormal("sigma", 1.0)
        for i in range(n_shards):
            pm.Normal(
                f"y_{i}",
                mu=(intercept + offsets[i]) + slope * x[i][mask[i]],
                sigma=sigma,
                observed=y[i][mask[i]],
            )
    return model


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n-shards", type=int, default=8)
    parser.add_argument("--n-obs", type=int, default=64)
    parser.add_argument("--draws", type=int, default=200)
    parser.add_argument("--tune", type=int, default=200)
    parser.add_argument("--chains", type=int, default=2)
    parser.add_argument(
        "--perform-path",
        action="store_true",
        help="use the host-callable perform path instead of torch_fn",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="device of the data and the kernel (default: cuda; 'cpu' runs "
        "the kernel's plain version)",
    )
    args = parser.parse_args(argv)

    import pymc as pm

    data, offsets_true = generate_node_data(
        args.n_shards, n_obs=args.n_obs, seed=123, device=resolve_device(args.device)
    )
    model = build_model(data, use_torch_fn=not args.perform_path)
    with model:
        map_est = pm.find_MAP(progressbar=False)
        print(
            "MAP: intercept=%.3f slope=%.3f sigma=%.3f"
            % (map_est["intercept"], map_est["slope"], map_est["sigma"])
        )
        idata = pm.sample(
            draws=args.draws,
            tune=args.tune,
            chains=args.chains,
            cores=1,
            progressbar=False,
            random_seed=42,
        )
    post = idata.posterior
    print(
        "posterior: slope median=%.3f intercept median=%.3f"
        % (
            float(post["slope"].median()),
            float(post["intercept"].median()),
        )
    )
    return idata


if __name__ == "__main__":
    main()
