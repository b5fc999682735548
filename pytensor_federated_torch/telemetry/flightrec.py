"""Black-box flight recorder: a bounded ring of structured events.

The incident half of the telemetry subsystem.  Spans and metrics
(:mod:`.spans`, :mod:`.metrics`) answer "how fast is the steady
state"; the flight recorder answers the question the live-chip
history keeps asking — *what happened in the seconds before this
process wedged/crashed/returned-without-executing*.  It records a small structured event for each
noteworthy state transition:

========================  ====================================================
kind                      emitted by
========================  ====================================================
``span.open``/``span.close``  every telemetry span (hooked from :mod:`.spans`)
``rpc.retry``/``rpc.drop``    driver transports (service/client.py, tcp.py)
``rpc.error``                 in-band server error replies at the driver
``server.error``              node-side decode/compute failures (server.py)
``fanout.member_error``       a fused-fanout member raising (fanout_exec.py)
``fanout.member_retry``       a transient member failure re-run via a pool
``pool.breaker_*``            replica breaker transitions (routing/pool.py)
``pool.failover``             a call/window tail moving onto another replica
``pool.hedge``                a hedged request firing at a second replica
``pool.probe_failed``         a background replica probe failing
``pool.replica_added``/``_removed``  live pool registry changes
``sampler.pool_recovered``    the elastic pool-recovery tier (elastic.py)
``mesh.peer_dead``            a heartbeat death verdict (parallel/multihost.py)
``mesh.remesh``               mesh rebuilt after failure (parallel/multihost.py)
``sampler.run``               one sample() run settling (samplers/mcmc.py)
``sampler.segment_failed``    an elastic segment raising (samplers/elastic.py)
``sampler.recovered``         elastic recovery about to resume
``bench.integrity``           measure_rate verdicts, pass or refusal (bench.py)
``probe.backend``             subprocess backend-liveness probe verdicts (utils)
``watchdog.fired``            an armed deadline expiring (:mod:`.watchdog`)
``incident.bundle``           an incident bundle hitting disk
``fault.<kind>``              every injected fault (faultinject.runtime) with
                              plan id / rule / point / trace id
``fault.plan_*``              fault-plan install/uninstall lifecycle
``server.drain_*``            graceful-drain lifecycle (server.py)
========================  ====================================================

plus anything user code passes to :func:`record`.

Always-on, near-zero when idle: events are only born when something
*happens* (an RPC, a failure, a span), and each costs one small dict
plus a lock-guarded deque append.  When telemetry is disabled —
``PFTPU_TELEMETRY=0`` / ``spans.set_enabled(False)`` — or the recorder
itself is off (:func:`set_enabled`), :func:`record` returns after one
branch (bench.py's overhead gate measures both the micro cost and the
driver-metric delta every run).

Eviction contract: the ring holds the newest ``capacity`` events —
EXCEPT that the ``span.open`` event of every still-open span is held
aside (pinned) until that span closes, so a dump taken mid-operation
always shows how the operation *started*.  Ancestors of an open span
are themselves still open (a parent span cannot exit before its
children), so an open span's whole ancestry survives eviction — the
property tests/test_flightrec.py pins down.  On close, the open event
rejoins the ring (original sequence number) followed by the close
event; :func:`events` merges ring + pinned in sequence order.

Four ways out of the process:

- :func:`events` / :func:`dump_jsonl` — on demand.
- :func:`install_handlers` — ``atexit`` (dump at interpreter exit),
  ``SIGUSR2`` (dump on signal, the classic black-box "read it out
  while it hangs" path — safe because the handler only reads state
  under a lock no signal-interrupted frame can hold while *in* the
  handler... see the function docstring for the precise story), and a
  chained ``sys.excepthook`` that writes a full incident bundle
  (:func:`.watchdog.write_incident_bundle`) on an uncaught exception.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from . import spans as _spans

__all__ = [
    "record",
    "events",
    "clear",
    "enabled",
    "set_enabled",
    "set_capacity",
    "capacity",
    "dump_jsonl",
    "install_handlers",
]

_CAP = int(os.environ.get("PFTPU_FLIGHTREC_CAP", "512"))
_ring: Deque[dict] = deque(maxlen=_CAP)
# span_id -> its span.open event, held OUT of the ring until the span
# closes (the eviction contract in the module docstring).
_pinned: Dict[int, dict] = {}
_lock = threading.Lock()
_seq = itertools.count(1)

# The recorder's own switch, layered under the process-wide telemetry
# switch: effective recording = spans.enabled() AND _ENABLED.  Separate
# so bench.py can isolate the recorder's cost with telemetry still on.
_ENABLED = os.environ.get("PFTPU_FLIGHTREC", "1") != "0"


def enabled() -> bool:
    """Whether the flight recorder is recording (requires telemetry on)."""
    return _ENABLED and _spans.enabled()


def set_enabled(value: bool) -> bool:
    """Flip the recorder on/off (telemetry master switch still applies);
    returns the previous recorder state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(value)
    return prev


def capacity() -> int:
    return _CAP


def set_capacity(n: int) -> None:
    """Resize the event ring (keeps the newest; pinned events unaffected)."""
    global _ring, _CAP
    if n < 1:
        raise ValueError(f"capacity must be >= 1, got {n}")
    with _lock:
        _CAP = int(n)
        _ring = deque(_ring, maxlen=_CAP)


def _event(kind: str, attrs: Dict[str, Any]) -> dict:
    # Caller attrs FIRST, reserved keys last: the record's ordering and
    # identity (seq/ts/kind, plus the ambient trace id) must win over a
    # caller that happens to pass an attr named like them — a forged
    # "seq" would corrupt the sort the eviction contract relies on.
    ev: dict = dict(attrs) if attrs else {}
    ev["seq"] = next(_seq)
    ev["ts"] = time.time()
    ev["kind"] = kind
    tid = _spans.current_trace_id()
    if tid is not None:
        ev["trace_id"] = tid.hex()
    return ev


def record(kind: str, **attrs: Any) -> None:
    """Append one structured event (JSON-friendly ``attrs``) to the
    ring.  The active trace id (if any) is stamped on automatically so
    incident events correlate with span trees.  No-op while disabled."""
    if not (_ENABLED and _spans.enabled()):
        return
    ev = _event(kind, attrs)
    with _lock:
        _ring.append(ev)


# -- span hooks (installed into .spans at import time, bottom of file) ------


def _on_span_open(span) -> None:
    if not _ENABLED:  # spans.enabled() already true or the span is a no-op
        return
    ev = _event(
        "span.open",
        {"name": span.name, "span_id": span.span_id},
    )
    ev["trace_id"] = span.trace_id.hex()  # the span's id, not the ambient one
    with _lock:
        _pinned[span.span_id] = ev


def _on_span_close(span) -> None:
    if not _ENABLED:
        # Still unpin: the open event may have been pinned while the
        # recorder was ON — leaving it would report a closed span as
        # open forever (and leak one dict per such span).
        with _lock:
            _pinned.pop(span.span_id, None)
        return
    close = _event(
        "span.close",
        {
            "name": span.name,
            "span_id": span.span_id,
            "duration_s": span.duration,
        },
    )
    close["trace_id"] = span.trace_id.hex()
    if span.error is not None:
        close["error"] = span.error
    with _lock:
        open_ev = _pinned.pop(span.span_id, None)
        if open_ev is not None:
            # Rejoins with its ORIGINAL seq: events() sorts, so the
            # record reads in true temporal order even though the ring
            # receives it late.
            _ring.append(open_ev)
        _ring.append(close)


def events(n: Optional[int] = None) -> List[dict]:
    """The retained flight record, oldest first: ring events plus the
    pinned ``span.open`` events of still-open spans, merged in sequence
    order.  ``n`` keeps only the newest ``n`` RING events — pinned
    opens are always included regardless of age (the eviction contract:
    a tail-trimmed incident dump must still show how the still-running
    operation started), so the result may slightly exceed ``n``."""
    with _lock:
        ring = list(_ring)
        pinned = list(_pinned.values())
    if n is not None:
        ring = ring[-n:]
    items = sorted(ring + pinned, key=lambda e: e["seq"])
    return items


def clear() -> None:
    """Drop all retained events, pinned included (test isolation)."""
    with _lock:
        _ring.clear()
        _pinned.clear()


def dump_jsonl(path: str, *, n: Optional[int] = None) -> int:
    """Append the flight record to ``path``, one JSON line per event;
    returns the number of lines written."""
    evs = events(n)
    with open(path, "a", encoding="utf-8") as fh:
        for ev in evs:
            # default=str: attrs are free-form (numpy scalars included)
            # and every dump lane — atexit and SIGUSR2 especially —
            # must degrade, never lose the record to a TypeError.
            fh.write(json.dumps(ev, default=str) + "\n")
    return len(evs)


# -- exit / signal / crash handlers -----------------------------------------

_handlers_installed = False
_installed_path: Optional[str] = None
_prev_excepthook = None


def install_handlers(
    path: Optional[str] = None,
    *,
    on_exit: bool = True,
    signum: Optional[int] = None,
    on_crash: bool = True,
) -> str:
    """Install the black-box readout handlers; returns the dump path.

    - ``on_exit``: an ``atexit`` hook appends the flight record to
      ``path`` (default ``$PFTPU_FLIGHTREC_DUMP`` or
      ``<incident dir>/flightrec-<pid>.jsonl``) if any events exist.
    - ``signum`` (default ``SIGUSR2``; pass ``0`` to skip): a signal
      handler that appends the record on demand — the "the process is
      hung, read the black box" path.  The handler itself only SPAWNS
      a short-lived thread that does the locked read + file I/O:
      CPython runs Python signal handlers on the main thread between
      bytecodes, so a handler that took the (non-reentrant) internal
      lock directly would deadlock whenever the signal lands while the
      main thread is inside one of this module's ``with _lock:``
      sections — the suspended frame holds the lock the handler would
      wait on.  A thread blocks safely instead: the main thread
      resumes, finishes its append, releases, and the dump proceeds.
    - ``on_crash``: chains ``sys.excepthook`` so an uncaught exception
      writes a full incident bundle
      (:func:`.watchdog.write_incident_bundle`, reason ``"crash"``)
      before the normal traceback prints.

    Idempotent: a second call changes nothing and returns the path the
    FIRST call installed — the returned path is always where dumps
    actually land (a repeat caller's different ``path`` argument is
    ignored, not silently half-honored).
    """
    import atexit
    import signal as _signal
    import sys

    global _handlers_installed, _installed_path, _prev_excepthook

    if _handlers_installed:
        return _installed_path  # type: ignore[return-value]

    if path is None:
        path = os.environ.get("PFTPU_FLIGHTREC_DUMP")
    if path is None:
        from .watchdog import incident_dir

        path = os.path.join(incident_dir(), f"flightrec-{os.getpid()}.jsonl")

    def _dump(*_a):
        try:
            if events(1):
                dump_jsonl(path)
        except OSError:
            pass  # a dying process must not die harder over its dump

    def _dump_on_signal(*_a):
        # Never touch _lock from the handler frame itself (docstring:
        # the interrupted main-thread frame may HOLD it); hand the
        # locked read to a thread that can block and proceed.
        threading.Thread(
            target=_dump, name="pftpu-flightrec-dump", daemon=True
        ).start()

    if on_exit:
        atexit.register(_dump)
    if signum is None:
        signum = getattr(_signal, "SIGUSR2", 0)
    if signum:
        try:
            _signal.signal(signum, _dump_on_signal)
        except (ValueError, OSError):
            pass  # non-main thread / unsupported platform: skip the lane
    if on_crash:
        _prev_excepthook = sys.excepthook

        def _crash_hook(exc_type, exc, tb):
            try:
                from .watchdog import write_incident_bundle

                write_incident_bundle(
                    "crash",
                    attrs={
                        "exc_type": exc_type.__name__,
                        "exc": str(exc)[:500],
                    },
                )
            except Exception:
                pass
            (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = _crash_hook
    _handlers_installed = True
    _installed_path = path
    return path


# Register the span hooks exactly once, at import time: the flight
# recorder is always-on (module docstring), and its own _ENABLED flag
# is the cheap opt-out the hooks check first.
_spans._set_span_hooks(_on_span_open, _on_span_close)
