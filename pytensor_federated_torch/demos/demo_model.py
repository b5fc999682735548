"""Driver demo/CLI (reference: demo_model.py).

Port of the JAX package's ``demos/demo_model.py``.  Two modes:

- ``--local`` (default): the federated shards are spread over a mesh of
  the visible GPUs, as the JAX package spreads them over its devices;
  each slot's data term is the linreg kernel (one fused value+grad
  launch per slot and evaluation); MAP and NUTS run on the first
  slot's device.
- ``--remote``: connect to a running node pool (``demo_node.py``) over
  gRPC, embed each remote node as a differentiable blackbox op, fan the
  nodes out concurrently per evaluation, and sample on the CPU — the
  reference's deployment.

Run:  python -m pytensor_federated_torch.demos.demo_model --local
      python -m pytensor_federated_torch.demos.demo_model --remote --ports 50000 50001 50002
"""

from __future__ import annotations

import argparse
import logging
from typing import Any

import numpy as np

_log = logging.getLogger(__name__)


def run_local(n_shards: int = 8, draws: int = 300, device: Any = None):
    """MAP (1,000 Adam steps) and NUTS (2 chains x ``draws`` warmup +
    ``draws`` draws) on the flagship posterior with ``n_shards`` shards
    of 96 observations, on ``device`` (``cuda`` unless ``"cpu"``).

    The mesh is the JAX twin's: one slot per visible GPU when they
    divide ``n_shards``, else none (and none on the CPU).  Each slot's
    block of shards goes through ``linreg_logp_grad_fn`` (the kernel on
    CUDA, its plain version on the CPU) with its own offsets, the
    slots' terms are added on the first slot's device, and the prior is
    the model's."""
    import torch

    from ..models.linear import FederatedLinearRegression, generate_node_data
    from ..ops.linreg_kernel import linreg_logp_grad_fn
    from ..parallel import make_mesh
    from ..parallel.sharded import _cross_slot_sum, _shard_data_to_mesh
    from ..samplers import find_map, sample
    from ..utils import resolve_device

    dev = resolve_device(device)
    data, _ = generate_node_data(n_shards, n_obs=96, device=dev)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 0
    mesh = make_mesh({"shards": n_dev}) if n_dev and n_shards % n_dev == 0 else None
    model = FederatedLinearRegression(data, mesh=mesh)
    blocks = [data.tree()] if mesh is None else _shard_data_to_mesh(data.tree(), mesh, "shards")
    per_slot = n_shards // len(blocks)
    kerns = [(mask.device, linreg_logp_grad_fn(x, y, mask)) for (x, y), mask in blocks]

    def logp(params):
        # The prior first: the order in which the terms enter the graph
        # sets the order in which the backward adds their gradients.
        prior, terms = model.prior_logp(params), []
        for j, (slot_dev, kern) in enumerate(kerns):
            p = {k: v.to(slot_dev) for k, v in params.items()}
            p["offsets"] = p["offsets"][..., j * per_slot : (j + 1) * per_slot]
            terms.append(kern.data_logp(p))
        return prior + _cross_slot_sum(terms)

    est = find_map(logp, model.init_params(), num_steps=1000)
    _log.info("MAP: intercept=%.3f slope=%.3f", float(est["intercept"]), float(est["slope"]))
    res = sample(
        logp,
        model.init_params(),
        generator=torch.Generator(device=dev).manual_seed(0),
        num_warmup=draws,
        num_samples=draws,
        num_chains=2,
        jitter=0.1,
    )
    slope = res.samples["slope"].detach().cpu().numpy()
    _log.info("posterior slope: median=%.3f sd=%.3f (truth 2.0)",
              float(np.median(slope)), float(slope.std()))
    return res


def run_remote(host: str, ports, draws: int = 200, parallel: bool = True):
    """Sample against remote gRPC nodes (reference: demo_model.py:15-45).

    Each node is one term of the posterior; with ``parallel`` the nodes
    evaluate concurrently through one fan-out op.  The driver runs on
    the CPU (it holds two floats)."""
    import torch

    from ..ops import ParallelLogpGrad, blackbox_logp_grad
    from ..samplers import sample
    from ..service import LogpGradServiceClient
    from ..signatures import ShapeDtypeStruct

    spec = (ShapeDtypeStruct((), torch.float32), ShapeDtypeStruct((), torch.float32))
    clients = [LogpGradServiceClient(host, p, use_stream=True) for p in ports]

    if parallel:
        fanout = ParallelLogpGrad([c.evaluate for c in clients], [spec] * len(clients))

        def likelihood(params):
            args = [(params["intercept"], params["slope"])] * len(clients)
            return fanout.total_logp(args)

    else:
        fanout = None
        ops = [blackbox_logp_grad(c.evaluate, spec) for c in clients]

        def likelihood(params):
            return sum(op(params["intercept"], params["slope"])[0] for op in ops)

    def logp(params):
        prior = -0.5 * (params["intercept"] ** 2 + params["slope"] ** 2) / 100.0
        return prior + likelihood(params)

    try:
        res = sample(
            logp,
            {"intercept": torch.zeros(()), "slope": torch.zeros(())},
            generator=torch.Generator().manual_seed(0),
            num_warmup=draws,
            num_samples=draws,
            num_chains=1,
            kernel="metropolis",  # gradient kernels also work; RWM keeps
            # the demo's RPC volume small
            jitter=0.5,
        )
    finally:
        if fanout is not None:
            fanout.close()
    slope = res.samples["slope"].numpy()
    _log.info("remote posterior slope: median=%.3f (truth 2.0)", float(np.median(slope)))
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--local", action="store_true")
    parser.add_argument("--remote", action="store_true")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--ports", type=int, nargs="+", default=list(range(50000, 50003)))
    parser.add_argument("--draws", type=int, default=300)
    parser.add_argument("--sequential", action="store_true")
    parser.add_argument("--device", default=None,
                        help="--local's torch device (default: cuda)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.remote:
        run_remote(args.host, args.ports, args.draws, parallel=not args.sequential)
    else:
        run_local(draws=args.draws, device=args.device)


if __name__ == "__main__":
    main()
