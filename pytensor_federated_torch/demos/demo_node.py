"""Worker-node pool demo/CLI (reference: demo_node.py).

Port of the JAX package's ``demos/demo_node.py``: one gRPC node process
per port, each owning a private linear-regression dataset and serving
its logp+grad over the wire — the true-federation deployment where data
cannot leave the node.  A node computes on ``cuda`` unless started with
``--device cpu``.

Run:  python -m pytensor_federated_torch.demos.demo_node --ports 50000 50001 50002
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
from typing import Any, Sequence

import numpy as np

_log = logging.getLogger(__name__)


def make_node_compute(port: int, *, delay: float = 0.0, seed: int = 123, device: Any = None):
    """Build one node's private compute function.

    Each node generates its own seeded dataset (reference:
    demo_node.py:58-61; the same bytes as the JAX package's node on the
    same port) and serves ``[intercept, slope] -> [logp,
    dlogp/dintercept, dlogp/dslope]``, the gradient by ``torch.autograd``
    of the node-local likelihood, on ``device`` (``cuda`` unless
    ``"cpu"`` is given).
    """
    import time

    import torch

    from ..utils import resolve_device
    from ..wrappers import logp_grad_from_logp, wrap_logp_grad_fn

    dev = resolve_device(device)
    rng = np.random.default_rng(seed + port)
    x = rng.uniform(-3, 3, size=96).astype(np.float32)
    y = (1.5 + 2.0 * x + 0.5 * rng.normal(size=x.size)).astype(np.float32)
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)

    def logp(intercept, slope):
        resid = yt - (intercept + slope * xt)
        return torch.sum(-0.5 * (resid / 0.5) ** 2)

    flat = wrap_logp_grad_fn(logp_grad_from_logp(logp))

    def compute(*arrays):
        if delay:
            time.sleep(delay)
        outs = flat(*(torch.as_tensor(np.asarray(a), device=dev) for a in arrays))
        return [o.detach().cpu().numpy() for o in outs]

    compute.device = dev
    return compute


def _run_one(
    bind: str, port: int, delay: float, getload_wire: str = "npwire", device: Any = None
) -> None:
    logging.basicConfig(level=logging.INFO)
    from ..service import run_node

    run_node(
        make_node_compute(port, delay=delay, device=device),
        bind,
        port,
        getload_wire=getload_wire,
    )


def run_node_pool(
    bind: str = "127.0.0.1",
    ports: Sequence[int] = tuple(range(50000, 50003)),
    delay: float = 0.0,
    *,
    getload_wire: str = "npwire",
    device: Any = None,
) -> None:
    """One server process per port (reference: demo_node.py:98-108).

    ``getload_wire="npproto"`` serves reference-protobuf GetLoad
    replies, so unmodified reference clients can balance over this pool.
    ``device`` is each node's (``cuda`` unless ``"cpu"``).

    Side effect: installs a process-wide SIGTERM handler for the lifetime
    of the pool so a signal tears down every child.  A previously
    installed callable handler is chained (called after the children are
    terminated) and the original disposition is restored when the pool
    shuts down normally.
    """
    ctx = mp.get_context("spawn")
    # daemon=True: node servers must die WITH the pool manager.  A killed
    # manager otherwise orphans live servers that keep ports bound and
    # inherited pipes open.
    procs = [
        ctx.Process(target=_run_one, args=(bind, p, delay, getload_wire, device), daemon=True)
        for p in ports
    ]
    # SIGTERM must tear the whole pool down, not just this manager: the
    # daemon flag is only honored at a graceful parent exit.  Converting
    # the signal to SystemExit runs the terminations and
    # multiprocessing's atexit cleanup.  Installed before the first
    # start() so no child can outlive a signal landing mid-startup;
    # exits 128+signum, the conventional killed-by-signal status.
    import signal

    prev_handler = signal.getsignal(signal.SIGTERM)

    def _terminate_pool(signum, frame):
        for p in procs:
            p.terminate()
        # A host application's own SIGTERM cleanup is chained, but its
        # exit path must not replace the killed-by-signal status.
        if callable(prev_handler):
            try:
                prev_handler(signum, frame)
            except SystemExit:
                pass
            except Exception:
                _log.exception("chained SIGTERM handler failed")
        raise SystemExit(128 + signum)

    installed = False
    try:
        signal.signal(signal.SIGTERM, _terminate_pool)
        installed = True
    except ValueError:  # pragma: no cover - non-main-thread caller
        pass
    try:
        for p in procs:
            p.start()
        _log.info("node pool: %d servers on %s:%s", len(procs), bind, list(ports))
        try:
            for p in procs:
                p.join()
        except KeyboardInterrupt:
            for p in procs:
                p.terminate()
    finally:
        # getsignal() returns None for a handler installed from outside
        # Python; signal.signal(..., None) would raise, so in that case
        # leave ours in place.
        if (
            installed
            and prev_handler is not None
            and signal.getsignal(signal.SIGTERM) is _terminate_pool
        ):
            signal.signal(signal.SIGTERM, prev_handler)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--bind", default="127.0.0.1")
    parser.add_argument("--ports", type=int, nargs="+", default=list(range(50000, 50003)))
    parser.add_argument("--delay", type=float, default=0.0)
    parser.add_argument(
        "--getload-wire",
        choices=("npwire", "npproto"),
        default="npwire",
        help="GetLoad reply format: npproto serves unmodified "
        "reference clients (service.proto GetLoadResult)",
    )
    parser.add_argument("--device", default=None,
                        help="the nodes' torch device (default: cuda)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_node_pool(args.bind, args.ports, args.delay, getload_wire=args.getload_wire,
                  device=args.device)


if __name__ == "__main__":
    main()
