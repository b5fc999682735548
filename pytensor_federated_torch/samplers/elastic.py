"""Elastic sampling: checkpointed MCMC that survives device/host loss.

Port of the JAX package's ``samplers/elastic.py``: in-band failure
detection (``parallel.multihost``: heartbeats + ``detect_dead_peers``),
mesh recovery (``remesh_after_failure``) and chunked checkpoint/resume
(``checkpoint.sample_checkpointed``, bit-identical continuation) in the
one call a long-running job wants:

    def build_logp(mesh):
        data = place_my_shards(mesh)        # host copies re-place
        return FederatedLogp(..., mesh=mesh).logp

    res = elastic_sample(build_logp, init, generator=gen, mesh=mesh,
                         checkpoint_path="run.ckpt", peers=peer_map)

A failed SEGMENT raises (a dead device or peer surfaces as an exception
from the evaluation or the collective), then:

1. an optional replica pool is probed (``node_pool.recover()``), so the
   rebuilt logp routes over the surviving replicas;
2. the optional heartbeat ``peers`` map is probed
   (:func:`~pytensor_federated_torch.parallel.multihost.detect_dead_peers`)
   so the rebuilt mesh drops known-dead processes knowingly;
3. the mesh is rebuilt over the surviving devices
   (:func:`~pytensor_federated_torch.parallel.multihost.remesh_after_failure`,
   or a caller-supplied ``on_failure`` policy);
4. ``build_logp(new_mesh)`` re-places the data, and sampling RESUMES
   from the last completed chunk: each chunk's generator is seeded from
   the base generator's seed and the chunk index, so the draw stream
   does not depend on where the failure happened.

RECOVERY TIERS, in order: the pool, then the remesh — both in-process,
for failures that surface as Python exceptions — then the process
restart: a failure that wedges a cross-process collective cannot be
caught in-process (the survivors wait at the rendezvous until the
backend's timeout, or the process is killed).  Recovery is to run the
SAME ``elastic_sample`` call again in a fresh process: the checkpoint
resumes after the last completed chunk, bit-identically.

Warmup is not chunk-checkpointed (as in ``sample_checkpointed``): a
failure during warmup restarts warmup.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Mapping, Optional, Tuple

import torch

from ..telemetry import flightrec as _flightrec
from ..telemetry import watchdog as _watchdog

__all__ = ["elastic_sample"]

_log = logging.getLogger("pytensor_federated_torch")


def _segment_watchdog_s(value: Optional[float]) -> float:
    """The sampling-segment arm deadline: explicit arg, else
    ``PFTPU_WATCHDOG_SAMPLE_S``, else 0 (disarmed).  Disarmed by
    default because a legitimate segment can run for hours."""
    if value is not None:
        return float(value)
    return _watchdog.env_timeout_s("PFTPU_WATCHDOG_SAMPLE_S", 0.0)


def elastic_sample(
    build_logp: Callable[[Optional[Any]], Callable],
    init_params: Any,
    *,
    generator: torch.Generator,
    checkpoint_path: str,
    mesh: Optional[Any] = None,
    peers: Optional[Mapping[int, Tuple[str, int]]] = None,
    node_pool: Optional[Any] = None,
    max_failures: int = 2,
    on_failure: Optional[Callable[[Optional[Any], list], Optional[Any]]] = None,
    watchdog_s: Optional[float] = None,
    **sample_kwargs,
):
    """Checkpointed sampling with failure-triggered mesh recovery.

    ``build_logp(mesh) -> logp_fn`` must be re-invokable: each call
    places (or re-places) data for the given mesh and returns the logp.
    ``mesh=None`` is allowed (a single-device job still gets
    checkpointed crash tolerance; recovery then just rebuilds).
    ``generator`` seeds the run's streams, as in
    :func:`~pytensor_federated_torch.checkpoint.sample_checkpointed`.

    ``peers`` (process id -> heartbeat address) feeds dead-peer
    DETECTION into recovery; without it, recovery is local-view only.

    ``node_pool`` (a :class:`~pytensor_federated_torch.routing.NodePool`)
    adds a host-lane recovery tier ahead of the mesh one: recovery
    probes the pool NOW, the dead replica's breaker trips, and the
    rebuilt logp routes over the survivors.  ``on_failure(mesh,
    dead_process_ids) -> new_mesh`` overrides the default
    :func:`remesh_after_failure` policy.  ``max_failures`` bounds
    recovery attempts; the failure after the last re-raises.

    ``watchdog_s`` arms the hang watchdog around each sampling segment
    (a participant dying mid-collective can leave the survivors waiting
    at the rendezvous; the armed deadline writes an incident bundle
    first).  Default: ``PFTPU_WATCHDOG_SAMPLE_S``, else disarmed.

    Remaining ``sample_kwargs`` go to ``sample_checkpointed``
    (num_warmup/num_samples/num_chains/checkpoint_every/kernel/...).
    Returns its :class:`SampleResult`.

    Continuation guarantee: when the rebuilt logp is numerically
    identical to the original (same mesh layout: restarts, host-node
    recovery, a rebuild over the same devices) the draws are
    bit-identical to an uninterrupted run.  When recovery SHRINKS the
    mesh, the re-placed data change the order of the federated sum,
    which can move logp values in their last bits: the continuation is
    then exact in distribution, not bit-reproducible."""
    from ..checkpoint import sample_checkpointed

    arm_s = _segment_watchdog_s(watchdog_s)
    failures = 0
    current_mesh = mesh
    while True:
        logp_fn = build_logp(current_mesh)
        try:
            with _watchdog.armed("elastic.sample_segment", arm_s, attempt=failures):
                return sample_checkpointed(
                    logp_fn,
                    init_params,
                    generator=generator,
                    checkpoint_path=checkpoint_path,
                    **sample_kwargs,
                )
        except Exception as e:  # noqa: BLE001 — any device/runtime loss
            failures += 1
            _flightrec.record(
                "sampler.segment_failed",
                attempt=failures,
                max_failures=max_failures,
                error=f"{type(e).__name__}: {e}"[:200],
            )
            if failures > max_failures:
                raise
            _log.warning(
                "elastic_sample: segment failed (%s: %s) — recovering (%d/%d)",
                type(e).__name__,
                e,
                failures,
                max_failures,
            )
            if node_pool is not None:
                # Tier 0, host lane: probe the replica pool so dead nodes
                # are quarantined before the logp is rebuilt.
                healthy = node_pool.recover()
                _flightrec.record(
                    "sampler.pool_recovered",
                    attempt=failures,
                    healthy_replicas=healthy,
                    total_replicas=len(node_pool.replicas),
                )
                _log.warning(
                    "elastic_sample: pool recovery — %d/%d replicas admit traffic",
                    healthy,
                    len(node_pool.replicas),
                )
            dead: list = []
            if peers:
                from ..parallel.multihost import detect_dead_peers

                dead = detect_dead_peers(peers)
            if on_failure is not None:
                current_mesh = on_failure(current_mesh, dead)
            elif current_mesh is not None:
                from ..parallel.multihost import remesh_after_failure

                current_mesh = remesh_after_failure(current_mesh, dead_process_ids=dead)
            _flightrec.record(
                "sampler.recovered",
                attempt=failures,
                dead_process_ids=sorted(dead),
            )
            # Loop: rebuild the logp over the recovered mesh and RESUME
            # from the last completed chunk.
