"""Composable effect handlers: one model definition, many executions.

The port of the JAX package's ``ppl/handlers.py`` (the NumPyro design,
PAPERS.md: "Composable Effects for Flexible and Accelerated
Probabilistic Programming in NumPyro"): a model is a plain Python
function whose probabilistic statements — :func:`sample`,
:func:`deterministic`, :class:`plate`, :func:`subsample` — emit
*messages* through a stack of handlers instead of executing a fixed
semantics.  Each handler is a context manager on a thread-local stack;
a message travels innermost-to-outermost through ``process_message``
(so the INNERMOST handler that resolves a site's value wins — the
:class:`condition` / :class:`substitute` precedence contract), gets a
default resolution (a draw from the prior if a ``seed`` handler is
active; a loud :class:`PPLError` otherwise), then travels back out
through ``postprocess_message`` (where :class:`trace` records).

The same model function therefore drives every execution mode:
direct log-density evaluation (:func:`~.compiler.log_density`), prior
sampling (``seed`` + ``trace``), NUTS/tempering (via the compiled logp),
and the ``fed``-lowered mesh/pool/mixed programs
(:func:`~.compiler.compile` re-runs the model under
:class:`force_subsample` to extract per-shard likelihoods — the DrJAX
plate→``fed_map`` correspondence).

Handlers run inside ``torch.autograd``, ``torch.func.vmap`` and a
``fed.program``'s recording, so everything here is pure Python
bookkeeping over tensors: no host sync on the evaluation paths, and no
randomness outside an explicit :class:`seed`, which draws from one
``torch.Generator`` in site order where the JAX handler splits a key at
every site.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..fed.lowering import ConcretizationError
from ..utils import resolve_device, tree_leaves, tree_map
from .distributions import Distribution

__all__ = [
    "Messenger",
    "PPLError",
    "block",
    "condition",
    "deterministic",
    "force_subsample",
    "plate",
    "replay",
    "sample",
    "seed",
    "subsample",
    "substitute",
    "trace",
]

Message = Dict[str, Any]


class PPLError(RuntimeError):
    """Loud failure of the effect layer: an unhandled site, a missing
    value, a duplicate name, a geometry mismatch.  A RuntimeError
    subclass on purpose — like :class:`~..service.deadline.
    DeadlineExceeded`, every lane already treats RuntimeError as
    deterministic/non-retryable."""


class _Local(threading.local):
    def __init__(self) -> None:
        self.stack: List["Messenger"] = []


_LOCAL = _Local()


def _stack() -> List["Messenger"]:
    return _LOCAL.stack


class Messenger:
    """Base handler: a context manager on the thread-local stack,
    optionally wrapping a model function (``handler(fn)(*args)`` runs
    ``fn`` with the handler active — handlers compose by nesting)."""

    def __init__(self, fn: Optional[Callable[..., Any]] = None) -> None:
        self.fn = fn

    def __enter__(self) -> "Messenger":
        _stack().append(self)
        return self

    def __exit__(self, *exc: object) -> None:
        popped = _stack().pop()
        if popped is not self:  # pragma: no cover - stack discipline bug
            raise PPLError("handler stack corrupted: __exit__ out of order")

    def process_message(self, msg: Message) -> None:
        """Inbound pass, innermost handler first."""

    def postprocess_message(self, msg: Message) -> None:
        """Outbound pass after the value is resolved."""

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if self.fn is None:
            raise PPLError(
                f"{type(self).__name__} wraps no function; use it as a "
                "context manager or pass fn"
            )
        with self:
            return self.fn(*args, **kwargs)


def apply_stack(msg: Message) -> Message:
    """Run one message through the active handler stack (the NumPyro
    protocol): process innermost→outermost, stopping at a
    :class:`block`; default-resolve the value; postprocess back from
    the stop point inward."""
    stack = _stack()
    pointer = 0
    for pointer, handler in enumerate(reversed(stack)):
        handler.process_message(msg)
        if msg.get("stop"):
            break
    if msg["value"] is None and msg["type"] == "sample":
        if msg["rng_key"] is None:
            raise PPLError(
                f"sample site {msg['name']!r} has no value: provide it "
                "via substitute/condition/replay, or wrap the model in "
                "ppl.seed(...) to draw from the prior"
            )
        dist: Distribution = msg["dist"]
        msg["value"] = dist.sample(msg["rng_key"], tuple(msg["sample_shape"]))
    # Postprocess INNERMOST-first: an inner plate must gather its
    # shard's rows before an outer trace records the site.
    for handler in reversed(stack[len(stack) - pointer - 1 :]):
        handler.postprocess_message(msg)
    return msg


def _message(kind: str, name: str, dist: Any, value: Any, observed: bool, mask: Any) -> Message:
    return {
        "type": kind,
        "name": name,
        "dist": dist,
        "value": value,
        "observed": observed,
        "mask": mask,
        "scale": 1.0,
        "plates": (),
        "rng_key": None,
        "sample_shape": (),
        "stop": False,
    }


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def sample(name: str, dist: Distribution, *, obs: Any = None, mask: Any = None) -> Any:
    """Declare a random variable.  Returns its value under the active
    handler interpretation (observed data, a substituted parameter, a
    replayed draw, or a fresh prior draw under ``seed``)."""
    if not _stack():
        raise PPLError(
            f"sample({name!r}) outside any handler: wrap the model in "
            "ppl.trace / ppl.seed / ppl.substitute / ... before calling"
        )
    msg = _message("sample", name, dist, obs, obs is not None, mask)
    apply_stack(msg)
    return msg["value"]


def deterministic(name: str, value: Any) -> Any:
    """Record a named derived quantity (no log-density contribution);
    returns ``value`` unchanged."""
    if not _stack():
        raise PPLError(
            f"deterministic({name!r}) outside any handler: wrap the "
            "model in ppl.trace / ppl.seed / ... before calling"
        )
    msg = _message("deterministic", name, None, value, False, None)
    apply_stack(msg)
    return msg["value"]


@dataclasses.dataclass(frozen=True)
class PlateFrame:
    """One plate's static identity on a site: name, declared (full)
    size, and the effective size this execution ran with."""

    name: str
    size: int
    effective: int


def _concretize(indices: torch.Tensor) -> Optional[np.ndarray]:
    """``indices`` as a numpy array, or None where their values cannot
    be known: a ``torch.func`` transform's wrapped tensor (under
    ``vmap``), or a value derived from the inputs of a ``fed.program``
    while it records (its concretization raises
    :class:`~..fed.lowering.ConcretizationError` before any node is
    recorded)."""
    if torch._C._functorch.is_functorch_wrapped_tensor(indices):
        return None
    try:
        return indices.numpy(force=True)
    except ConcretizationError:
        return None


def _tensor(x: Any) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def _take(leaf: Any, indices: torch.Tensor) -> torch.Tensor:
    """``leaf``'s rows at ``indices`` (``jnp.take(leaf, idx, axis=0)``)."""
    leaf = _tensor(leaf)
    return torch.index_select(leaf, 0, indices.to(leaf.device))


class plate(Messenger):
    """Vectorized independence context over a LEADING axis.

    Sites declared inside carry the frame in ``msg["plates"]`` — the
    :mod:`.compiler` maps the outermost plate onto ``fed_map`` shards
    (DrJAX's plate→map correspondence).  ``subsample_size`` turns the
    plate into a minibatch plate: under a :class:`seed` handler it draws
    ``subsample_size`` indices without replacement (a ``torch.randperm``
    prefix from the seed's generator), :func:`subsample` gathers
    plate-scoped data by them, and every inside site's log-density is
    scaled by ``size/subsample_size`` so the scaled minibatch logp is an
    unbiased estimate of the full-data logp.

    A :class:`force_subsample` handler overrides the indices from
    outside the model — the compiler's per-shard and minibatch lanes,
    and the unbiasedness tests, use that seam.
    """

    def __init__(self, name: str, size: int, *, subsample_size: Optional[int] = None) -> None:
        super().__init__(None)
        self.name = name
        self.size = int(size)
        if self.size < 1:
            raise PPLError(f"plate {name!r} size must be >= 1")
        self.subsample_size = int(subsample_size) if subsample_size is not None else self.size
        if not (1 <= self.subsample_size <= self.size):
            raise PPLError(
                f"plate {name!r}: subsample_size {self.subsample_size} "
                f"not in 1..{self.size}"
            )
        self._indices: Optional[torch.Tensor] = None
        self._scale: float = 1.0
        # id()s of tensors subsample() returned under THIS entry —
        # provenance that tells an index-ordered value from a raw
        # full-order one when their shapes coincide (see _resize).
        self._gathered: set = set()

    def __enter__(self) -> "plate":
        # The index set first, the stack push last: a refusal here must
        # leave the stack as it found it (``with`` calls no ``__exit__``
        # when ``__enter__`` raises).
        forced = _innermost_force(self.name)
        if forced is not None:
            idx = _tensor(forced.indices[self.name])
            if idx.dim() != 1:
                raise PPLError(
                    f"forced indices for plate {self.name!r} must be "
                    f"1-D, got shape {tuple(idx.shape)}"
                )
            self._indices = idx
            n = int(idx.shape[0])
            self._scale = (self.size / n) if forced.scale else 1.0
        elif self.subsample_size < self.size:
            gen = _subsample_generator(self.name)
            self._indices = torch.randperm(self.size, generator=gen, device=gen.device)[
                : self.subsample_size
            ]
            self._scale = self.size / self.subsample_size
        else:
            self._indices = None
            self._scale = 1.0
        self._gathered = set()
        super().__enter__()
        return self

    @property
    def indices(self) -> torch.Tensor:
        """The active index set (``arange(size)`` when not
        subsampling)."""
        if self._indices is None:
            return torch.arange(self.size)
        return self._indices

    @property
    def effective_size(self) -> int:
        if self._indices is None:
            return self.size
        return int(self._indices.shape[0])

    def process_message(self, msg: Message) -> None:
        if msg["type"] not in ("sample", "deterministic"):
            return
        eff = self.effective_size
        msg["plates"] = (PlateFrame(self.name, self.size, eff),) + msg["plates"]
        msg["scale"] = msg["scale"] * self._scale
        if msg["type"] == "sample" and not msg["observed"] and msg["value"] is None:
            msg["sample_shape"] = (eff,) + tuple(msg["sample_shape"])

    def _resize(self, name: str, what: str, value: Any, *, observed: bool) -> Any:
        """Bring one plate-scoped array onto this execution's index
        set.  LATENTS carry the FULL plate axis by contract (the
        compiler broadcasts whole parameter arrays to every shard), so
        they are ALWAYS gathered — even when the index set is a
        full-length permutation, where an already-the-right-size check
        would silently pair shard i's latent with shard j's data.
        OBSERVED values/masks are either already index-ordered (the
        model gathered them through subsample()) and pass through at
        the effective size, or condition/obs-attached at the FULL size
        and gathered here; anything else is a loud geometry error — a
        full-size value that merely BROADCAST against shard-shaped
        siblings would silently count the whole plate once per shard."""
        eff = self.effective_size
        dim = int(value.shape[0])
        if observed and dim == eff:
            # At eff == size an observed value's SHAPE is ambiguous:
            # an already-index-ordered subsample() output and a raw
            # full-order condition/obs attachment look the same.
            # Provenance disambiguates — subsample() registered its
            # outputs with this plate, so registered values pass;
            # anything else under a non-identity concrete index set
            # refuses loudly (silent row misalignment otherwise).
            # Full-length indices whose values cannot be known (under
            # vmap, or while a fed program records) keep the
            # pass-through: the shipped lanes deliver pre-sliced data
            # there or route it through subsample().
            if eff == self.size and self._indices is not None and id(value) not in self._gathered:
                conc = _concretize(self._indices)
                if conc is not None and not np.array_equal(conc, np.arange(self.size)):
                    raise PPLError(
                        f"{what} of observed site {name!r} inside "
                        f"plate {self.name!r} is full-length under a "
                        "permuted/duplicated index set — whether it "
                        "is already index-ordered is ambiguous; route "
                        "it through subsample() or force a strict "
                        "subset of indices"
                    )
            return value
        if dim == self.size:
            return _take(value, self._indices)
        expected = (
            f"the effective size {eff} (already sliced) or the full "
            f"plate size {self.size} (gathered by the active indices)"
            if observed
            else f"the full plate size {self.size} (latents are "
            "gathered by the active indices)"
        )
        raise PPLError(
            f"{what} of site {name!r} inside plate {self.name!r} has "
            f"leading dim {dim}; expected {expected}"
        )

    def postprocess_message(self, msg: Message) -> None:
        # Under an index override, values carrying the FULL plate axis
        # are gathered onto this execution's rows: substituted LATENTS
        # by contract (the compiler broadcasts whole parameter arrays
        # to every shard), and condition/obs-attached OBSERVATIONS or
        # masks that bypassed subsample() — anything that matches
        # neither the full nor the effective size refuses loudly
        # (never a silently-broadcast full-data likelihood per shard).
        if (
            self._indices is None
            or msg["type"] != "sample"
            or msg["value"] is None
            or msg["rng_key"] is not None  # fresh draw: already sized
        ):
            return
        if not any(f.name == self.name for f in msg["plates"]):  # pragma: no cover - defensive
            return
        value = _tensor(msg["value"])
        if value.dim() < 1:
            if msg["observed"]:
                return  # a scalar obs broadcasts like any torch operand
            raise PPLError(
                f"site {msg['name']!r} inside plate {self.name!r} has "
                "a scalar value; plate-scoped latents must carry the "
                "plate axis leading"
            )
        msg["value"] = self._resize(msg["name"], "value", value, observed=msg["observed"])
        if msg["mask"] is not None and _tensor(msg["mask"]).dim() >= 1:
            msg["mask"] = self._resize(msg["name"], "mask", msg["mask"], observed=True)


def subsample(data: Any, frame: Optional[plate] = None) -> Any:
    """Gather plate-scoped data by the active plate's index set
    (identity when the plate is not subsampling).  ``frame`` defaults
    to the innermost active plate.  Under a :class:`force_subsample`
    with ``slice_data=False`` this is the identity — the compiler's
    streaming lane delivers pre-sliced shard data."""
    pl = frame
    if pl is None:
        for handler in reversed(_stack()):
            if isinstance(handler, plate):
                pl = handler
                break
    if pl is None:
        raise PPLError("subsample() outside any active plate")
    if pl._indices is None:
        return data
    forced = _innermost_force(pl.name)
    if forced is not None and not forced.slice_data:
        # Pre-sliced by the caller (the streaming lane): identity,
        # but still REGISTERED — these leaves are index-ordered.
        for leaf in tree_leaves(data):
            pl._gathered.add(id(leaf))
        return data
    idx = pl._indices
    out = tree_map(lambda leaf: _take(leaf, idx), data)
    for leaf in tree_leaves(out):
        pl._gathered.add(id(leaf))
    return out


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------


class trace(Messenger):
    """Record every site into an ordered dict (model execution order).
    Duplicate site names are a loud :class:`PPLError`."""

    def __init__(self, fn: Optional[Callable[..., Any]] = None) -> None:
        super().__init__(fn)
        self._trace: "collections.OrderedDict[str, Message]" = collections.OrderedDict()

    def __enter__(self) -> "trace":
        super().__enter__()
        self._trace = collections.OrderedDict()
        return self

    def postprocess_message(self, msg: Message) -> None:
        if msg["type"] not in ("sample", "deterministic"):
            return
        name = msg["name"]
        if name in self._trace:
            raise PPLError(f"duplicate site name {name!r} in one trace")
        self._trace[name] = dict(msg)

    def get_trace(self, *args: Any, **kwargs: Any) -> "collections.OrderedDict[str, Message]":
        self(*args, **kwargs)
        return self._trace


class replay(Messenger):
    """Reuse the values of a previously recorded trace (sample sites
    only; sites absent from the trace resolve normally)."""

    def __init__(
        self,
        fn: Optional[Callable[..., Any]] = None,
        guide_trace: Optional[Dict[str, Message]] = None,
    ) -> None:
        super().__init__(fn)
        self.guide_trace = guide_trace or {}

    def process_message(self, msg: Message) -> None:
        if msg["type"] != "sample" or msg["value"] is not None:
            return
        site = self.guide_trace.get(msg["name"])
        if site is not None:
            msg["value"] = site["value"]


class condition(Messenger):
    """Clamp sites to OBSERVED values: the sites contribute likelihood
    terms and count as data downstream.  The innermost handler that
    resolves a site wins (see :class:`substitute`)."""

    def __init__(
        self,
        fn: Optional[Callable[..., Any]] = None,
        data: Optional[Dict[str, Any]] = None,
    ) -> None:
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg: Message) -> None:
        if msg["type"] != "sample" or msg["value"] is not None:
            return
        if msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]
            msg["observed"] = True


class substitute(Messenger):
    """Set site VALUES without marking them observed — parameter
    evaluation (the logp lanes run the model under ``substitute`` with
    the sampler's current position).  Innermost wins: a ``substitute``
    nested inside a ``condition`` takes the site, and vice versa —
    precedence is purely positional."""

    def __init__(
        self,
        fn: Optional[Callable[..., Any]] = None,
        data: Optional[Dict[str, Any]] = None,
    ) -> None:
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg: Message) -> None:
        if msg["type"] != "sample" or msg["value"] is not None:
            return
        if msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]


class seed(Messenger):
    """Supply randomness: each unresolved sample site (in execution
    order) draws from the handler's ``torch.Generator``, so the same
    seed yields the same trace — the determinism contract the compiler's
    seeded-trace tests pin.  Subsampling plates draw their indices from
    it too (:func:`_subsample_generator`).

    ``rng_key`` is an int (a generator seeded with it, on ``device``:
    CUDA unless the caller asks for the CPU) or a ``torch.Generator``,
    whose state at construction is the seed: every entry draws from a
    fresh copy of that state (the JAX handler reuses its key on every
    entry), and the caller's generator is never advanced."""

    def __init__(
        self,
        fn: Optional[Callable[..., Any]] = None,
        rng_key: Union[int, torch.Generator, None] = None,
        *,
        device: Any = None,
    ) -> None:
        super().__init__(fn)
        if rng_key is None:
            raise PPLError("seed(...) requires rng_key")
        if isinstance(rng_key, torch.Generator):
            self._device = rng_key.device
            self._state = rng_key.get_state()
        else:
            self._device = resolve_device(device)
            self._state = torch.Generator(device=self._device).manual_seed(int(rng_key)).get_state()
        self.rng_key = rng_key
        self.generator = self._fresh()

    def _fresh(self) -> torch.Generator:
        gen = torch.Generator(device=self._device)
        gen.set_state(self._state)
        return gen

    def __enter__(self) -> "seed":
        super().__enter__()
        self.generator = self._fresh()  # reentrant determinism
        return self

    def process_message(self, msg: Message) -> None:
        if msg["type"] == "sample" and msg["value"] is None and msg["rng_key"] is None:
            msg["rng_key"] = self.generator


class block(Messenger):
    """Hide matching sites from handlers OUTSIDE this one (an outer
    ``trace`` never records them; an outer ``substitute`` cannot set
    them).  ``hide`` lists names; ``hide_fn`` is a message predicate;
    with neither, everything is hidden."""

    def __init__(
        self,
        fn: Optional[Callable[..., Any]] = None,
        *,
        hide: Optional[List[str]] = None,
        hide_fn: Optional[Callable[[Message], bool]] = None,
    ) -> None:
        super().__init__(fn)
        self.hide = set(hide) if hide is not None else None
        self.hide_fn = hide_fn

    def _hidden(self, msg: Message) -> bool:
        if self.hide_fn is not None:
            return bool(self.hide_fn(msg))
        if self.hide is not None:
            return msg["name"] in self.hide
        return True

    def process_message(self, msg: Message) -> None:
        if self._hidden(msg):
            msg["stop"] = True


class force_subsample(Messenger):
    """Pin plate index sets from OUTSIDE the model — the seam the
    compiler's per-shard/minibatch lanes and the unbiasedness tests
    drive.

    ``indices`` maps plate name → 1-D index tensor.  ``scale=True``
    applies the ``size/len(indices)`` minibatch scaling (the unbiased
    estimator); ``scale=False`` leaves terms unscaled (the compiler's
    full-data per-shard evaluation, where every shard contributes its
    exact term once).  ``slice_data=False`` makes :func:`subsample`
    the identity for the forced plates — the streaming lane delivers
    shard data already sliced, while latent parameter arrays still
    arrive full-size and are gathered by the plate."""

    def __init__(
        self,
        fn: Optional[Callable[..., Any]] = None,
        indices: Optional[Dict[str, Any]] = None,
        *,
        scale: bool = True,
        slice_data: bool = True,
    ) -> None:
        super().__init__(fn)
        self.indices = dict(indices or {})
        self.scale = bool(scale)
        self.slice_data = bool(slice_data)


def _innermost_force(plate_name: str) -> Optional[force_subsample]:
    for handler in reversed(_stack()):
        if isinstance(handler, force_subsample) and plate_name in handler.indices:
            return handler
    return None


def _subsample_generator(plate_name: str) -> torch.Generator:
    for handler in reversed(_stack()):
        if isinstance(handler, seed):
            return handler.generator
    raise PPLError(
        f"plate {plate_name!r} subsamples but no seed handler is "
        "active: wrap the model in ppl.seed(...) (or force indices "
        "with ppl.force_subsample)"
    )
