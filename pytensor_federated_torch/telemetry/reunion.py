"""Trace reunion: merge driver-side and node-side span trees per call.

The wire carries a 16-byte trace id so both halves of one RPC time
themselves under the same key — but the node's half stayed stranded in
the node process's ring buffer.  This module is the driver-side meeting
point: node span trees travel driver-ward two ways —

- **piggybacked** on the reply of the very call they describe (npwire
  spans flag / npproto field 16; the transports ingest them
  automatically, service/client.py + service/tcp.py), and
- **pulled** via the enriched GetLoad lane
  (:func:`..service.client.get_node_traces`), for spans whose reply
  never arrived — the forensics case.

Ingested trees land in a bounded per-trace store; :func:`merged` (one
trace) and :func:`merge_all` (everything, for incident bundles) line
them up against the driver's own completed root spans
(:func:`.spans.recent_traces`) by trace id, turning "the call took
9 ms" into the end-to-end decomposition — driver encode → call → node
decode/queue/compute/encode → driver decode — with no clock-sync
assumption beyond per-process monotonic durations.

Thread-safe; bounded BOTH ways (``PFTPU_REUNION_CAP`` trace ids,
default 128, oldest evicted; at most ``_BUCKET_CAP`` trees per trace,
duplicates dropped by content) because this is always-on plumbing, not
a profiler — in particular the GetLoad pull lane re-delivers the same
node trees on every poll, and re-ingesting them must be a no-op.
"""

from __future__ import annotations

import json as _json
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

from . import spans as _spans

__all__ = ["ingest", "remote_traces", "merged", "merge_all", "clear"]

_CAP = int(os.environ.get("PFTPU_REUNION_CAP", "128"))
#: Max distinct trees retained per trace id (a trace is one logical
#: call: a handful of trees from retries/multiple nodes, never hundreds).
_BUCKET_CAP = 32
# trace_id hex -> list of remote span trees (dicts, .spans.Span.to_dict
# shape).  OrderedDict for cheap oldest-first eviction.
_remote: "OrderedDict[str, List[dict]]" = OrderedDict()
# trace_id hex -> canonical-JSON keys of the trees already stored (the
# pull lane re-delivers identical trees every poll; see module docstring).
_seen_keys: Dict[str, set] = {}
_lock = threading.Lock()


def ingest(trees: Sequence[dict], *, source: str = "node") -> int:
    """Store remote span trees, keyed by their ``trace_id``; returns how
    many NEW trees were kept.  Trees without a trace id (or malformed
    entries) are dropped silently — an instrumentation lane must never
    make the RPC that carried it fail — and a tree already stored for
    its trace (byte-identical content, e.g. a GetLoad re-poll) is
    deduplicated.  ``source`` annotates each tree."""
    if not _spans.enabled():
        return 0
    kept = 0
    with _lock:
        for tree in trees:
            if not isinstance(tree, dict):
                continue
            tid = tree.get("trace_id")
            if not isinstance(tid, str) or not tid:
                continue
            try:
                key = _json.dumps(tree, sort_keys=True, default=str)
            except (TypeError, ValueError):
                continue  # unserializable sidecar: drop, never raise
            tree = dict(tree)
            tree.setdefault("source", source)
            bucket = _remote.get(tid)
            if bucket is None:
                while len(_remote) >= _CAP:
                    old_tid, _ = _remote.popitem(last=False)
                    _seen_keys.pop(old_tid, None)
                _remote[tid] = bucket = []
                _seen_keys[tid] = set()
            else:
                _remote.move_to_end(tid)
            keys = _seen_keys[tid]
            if key in keys or len(bucket) >= _BUCKET_CAP:
                continue
            keys.add(key)
            bucket.append(tree)
            kept += 1
    return kept


def remote_traces(trace_id: Optional[str] = None) -> List[dict]:
    """Remote trees for one trace id (hex), or every stored tree."""
    with _lock:
        if trace_id is not None:
            return list(_remote.get(trace_id, ()))
        return [t for bucket in _remote.values() for t in bucket]


def merged(trace_id: str) -> dict:
    """One trace's reunion: ``{"trace_id", "driver": [...trees...],
    "remote": [...trees...]}`` — driver side from the local completed-
    root ring, remote side from the ingest store."""
    driver = [
        t for t in _spans.recent_traces() if t.get("trace_id") == trace_id
    ]
    return {
        "trace_id": trace_id,
        "driver": driver,
        "remote": remote_traces(trace_id),
    }


def merge_all() -> List[dict]:
    """Every trace id seen on either side, merged — the incident-bundle
    payload.  Ordered oldest-first by first appearance."""
    ids: "OrderedDict[str, None]" = OrderedDict()
    for t in _spans.recent_traces():
        tid = t.get("trace_id")
        if tid:
            ids.setdefault(tid, None)
    with _lock:
        for tid in _remote:
            ids.setdefault(tid, None)
    return [merged(tid) for tid in ids]


def clear() -> None:
    """Drop the remote-tree store (test isolation)."""
    with _lock:
        _remote.clear()
        _seen_keys.clear()
