"""Contextvar-propagated span trees with wire-portable trace ids.

The structural half of the telemetry subsystem (:mod:`.metrics` is the
quantitative half).  A *span* is one named, monotonic-clock-timed stage
(``span("encode")``, ``span("compute")``); nesting via
``contextvars.ContextVar`` builds a tree per logical operation, and a
16-byte *trace id* — minted at the driver, carried inside the request
payload (npwire flag block / npproto field 15, see
:mod:`..service.npwire` / :mod:`..service.npproto_codec`) — stitches
the driver-side tree to the node-side tree of the same call.  That is
the piece live incidents need: when a rate
looks wrong, the per-stage decomposition (wire encode, queue wait,
compute, decode) says *where* the time went, per correlated call.

Completed ROOT spans land in a bounded ring buffer
(:func:`recent_traces`) — the exemplar store.  Bounded because this is
always-on instrumentation, not a profiler: the last N traces answer
"what did a slow call look like", full traces belong to the JSONL dump
(:func:`~.export.dump_jsonl`).

Cost model: one module-global bool gates everything.  Disabled,
``span()`` returns a shared no-op context manager — no allocation, no
clock read, no contextvar write (bench.py's telemetry-overhead gate
measures this path); enabled, a span costs two ``perf_counter`` reads,
one small object, and two contextvar ops.

ContextVars propagate into ``asyncio`` tasks automatically and into
thread pools only via ``contextvars.copy_context()`` — the fanout
executor does exactly that (:mod:`..fanout_exec`) so member spans
parent correctly across threads.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
import uuid as uuid_mod
from collections import deque
from typing import Any, Deque, Dict, List, Optional

__all__ = [
    "Span",
    "span",
    "trace",
    "enabled",
    "set_enabled",
    "new_trace_id",
    "current_trace_id",
    "current_span",
    "trace_context",
    "recent_traces",
    "clear_traces",
    "set_trace_capacity",
]

# One global bool, read on every telemetry operation (spans AND metric
# mutators in .metrics).  Plain attribute, not a ContextVar: the off
# switch must cost a single LOAD_GLOBAL, and enable/disable is a
# process-level deployment decision, not a per-task one.
_ENABLED = os.environ.get("PFTPU_TELEMETRY", "1") != "0"

_current_span: contextvars.ContextVar[Optional["Span"]] = (
    contextvars.ContextVar("pftpu_current_span", default=None)
)
_current_trace: contextvars.ContextVar[Optional[bytes]] = (
    contextvars.ContextVar("pftpu_current_trace", default=None)
)

_TRACE_CAP = 64
_recent: Deque["Span"] = deque(maxlen=_TRACE_CAP)
_recent_lock = threading.Lock()
_span_counter = itertools.count(1)

# Flight-recorder hooks (set once by .flightrec at its import): called
# with the Span on enter/exit of every ACTIVE span.  Plain module
# globals checked with one load — spans must stay importable without
# flightrec (no cycle), and the disabled path must not pay a registry.
_on_span_open = None
_on_span_close = None


def _set_span_hooks(on_open, on_close) -> None:
    """Install the span open/close listeners (flightrec's registration
    point; ``None`` uninstalls)."""
    global _on_span_open, _on_span_close
    _on_span_open = on_open
    _on_span_close = on_close


def enabled() -> bool:
    """Whether telemetry (spans AND metrics) is recording."""
    return _ENABLED


def set_enabled(value: bool) -> bool:
    """Flip recording on/off process-wide; returns the previous state.
    Env default: ``PFTPU_TELEMETRY=0`` starts disabled."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(value)
    return prev


def new_trace_id() -> bytes:
    """Mint a 16-byte trace id (uuid4 bytes — same width as the wire's
    correlation uuid, so both ride the payload at fixed cost)."""
    return uuid_mod.uuid4().bytes


def current_trace_id() -> Optional[bytes]:
    """The trace id of the innermost active trace, or ``None``."""
    return _current_trace.get()


def current_span() -> Optional["Span"]:
    """The innermost active span, or ``None``."""
    return _current_span.get()


class Span:
    """One timed stage.  Built by :func:`span`; read via
    :meth:`to_dict`/:func:`recent_traces`."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attrs",
        "t_start", "duration", "error", "children",
        "_tok_span", "_tok_trace",
    )

    def __init__(self, name: str, trace_id: bytes, parent: Optional["Span"],
                 attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(_span_counter)
        self.parent_id = parent.span_id if parent is not None else None
        self.attrs = attrs
        self.t_start = 0.0
        self.duration = 0.0
        self.error: Optional[str] = None
        self.children: List["Span"] = []
        self._tok_span = None
        self._tok_trace = None

    def to_dict(self) -> dict:
        """JSON-friendly tree (trace ids as hex)."""
        d: dict = {
            "name": self.name,
            "trace_id": self.trace_id.hex(),
            "span_id": self.span_id,
            "duration_s": self.duration,
        }
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.error is not None:
            d["error"] = self.error
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class _ActiveSpan:
    """Context manager driving one :class:`Span`'s lifetime."""

    __slots__ = ("_span",)

    def __init__(self, s: Span):
        self._span = s

    @property
    def span(self) -> Span:
        return self._span

    def set_attr(self, key: str, value: Any) -> None:
        self._span.attrs[key] = value

    def __enter__(self) -> "_ActiveSpan":
        s = self._span
        s._tok_span = _current_span.set(s)
        if _current_trace.get() != s.trace_id:
            s._tok_trace = _current_trace.set(s.trace_id)
        if _on_span_open is not None:
            _on_span_open(s)
        s.t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        s = self._span
        s.duration = time.perf_counter() - s.t_start
        if exc is not None:
            s.error = f"{exc_type.__name__}: {exc}"
        _current_span.reset(s._tok_span)
        if s._tok_trace is not None:
            _current_trace.reset(s._tok_trace)
        parent = _current_span.get()
        if parent is not None and parent.trace_id == s.trace_id:
            parent.children.append(s)
        else:
            with _recent_lock:
                _recent.append(s)
        if _on_span_close is not None:
            _on_span_close(s)
        return False  # never swallow


class _NoopSpan:
    """Shared disabled-path context manager: no allocation per call."""

    __slots__ = ()

    @property
    def span(self) -> None:
        return None

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopSpan()


def span(name: str, **attrs: Any):
    """Open a span named ``name`` under the current trace.

    With no active trace, a fresh trace id is minted — every root span
    starts a trace, so driver code needs no explicit setup.  Attributes
    are free-form JSON-friendly annotations (``span("fanout",
    width=8)``).  Returns a context manager whose ``.span`` is the live
    :class:`Span` (``None`` when telemetry is disabled).
    """
    if not _ENABLED:
        return _NOOP
    trace_id = _current_trace.get()
    if trace_id is None:
        trace_id = new_trace_id()
    return _ActiveSpan(Span(name, trace_id, _current_span.get(), attrs))


# Root-span alias: reads as "begin a traced operation" at call sites.
trace = span


class _TraceContext:
    """Adopt an externally-supplied trace id (see :func:`trace_context`)."""

    __slots__ = ("_trace_id", "_tok")

    def __init__(self, trace_id: Optional[bytes]):
        self._trace_id = trace_id
        self._tok = None

    def __enter__(self):
        if self._trace_id is not None:
            self._tok = _current_trace.set(self._trace_id)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._tok is not None:
            _current_trace.reset(self._tok)
        return False


def trace_context(trace_id: Optional[bytes]):
    """Bind an existing trace id to the current context — the NODE side
    of correlation: the server decodes the driver's trace id off the
    wire and runs its spans under it, so both halves share one id.
    ``None`` (no id on the wire, or telemetry disabled) is a no-op.
    """
    if not _ENABLED:
        return _NOOP
    return _TraceContext(trace_id)


def recent_traces(n: Optional[int] = None) -> List[dict]:
    """The last ``n`` (default: all retained) completed root spans as
    dict trees, oldest first."""
    with _recent_lock:
        items = list(_recent)
    if n is not None:
        items = items[-n:]
    return [s.to_dict() for s in items]


def clear_traces() -> None:
    """Drop the retained root spans (test isolation)."""
    with _recent_lock:
        _recent.clear()


def set_trace_capacity(n: int) -> None:
    """Resize the root-span ring buffer (keeps the newest entries)."""
    global _recent, _TRACE_CAP
    if n < 1:
        raise ValueError(f"capacity must be >= 1, got {n}")
    with _recent_lock:
        _TRACE_CAP = int(n)
        _recent = deque(_recent, maxlen=_TRACE_CAP)
