"""Compile an effectful model to a placement-lowered ``fed.program``.

The port of the JAX package's ``ppl/compiler.py``.  The DrJAX
correspondence (PAPERS.md): a model's outermost
:class:`~.handlers.plate` IS the federated shard axis, so the plate's
likelihood (and its plate-local latent priors) lowers to
``fed_sum(fed_map(per_shard, ...))`` — the canonical
broadcast→map→sum round every placement in :mod:`..fed` executes —
while the global prior stays a driver-side term.  One model definition
therefore runs on mesh slots, RPC pools, or a mix, and the SAME
per-shard function deploys to nodes (:meth:`CompiledModel.node_compute`),
so driver and node cannot drift.

Mechanics: the compiler never inspects model source.  It re-RUNS the
model under handlers —

- discovery: ``trace(seed(model))`` finds the sites, the plates, and
  the parameter shapes;
- per-shard: ``force_subsample({plate: [sid]}, scale=False)`` +
  ``substitute(params)`` evaluates exactly one shard's plate-scoped
  terms (``sid`` is a shard id riding ``fed_map`` as an integer data
  leaf; parameters broadcast whole and the plate gathers the shard's
  rows, which keeps every inexact mapped operand broadcast-derived so
  the reduced-window lowering stays eligible);
- prior: the same with the plate pinned to one shard, summing only
  the NON-plate sites.

``fed.program`` records the model once per signature and runs each
``fed_map``'s per-shard function once on shard 0 while it records: the
handler stack lives and dies inside each run, so no program-derived
value crosses into a per-shard function except as its mapped data.

The subsample lane (:meth:`CompiledModel.logp_indices` /
:meth:`CompiledModel.logp_minibatch`) maps ``fed_map`` over an index
batch instead of ``arange(n_shards)`` and scales the plate terms by
``size/batch`` — the unbiased minibatch estimator streaming SVI
consumes (E[scaled minibatch logp] == full-data logp).

Everything runs on the device of the model's arguments (the compiled
model's :attr:`~CompiledModel.device`); gradients are one first-order
``torch.autograd`` pass, and the logp works under ``torch.func.vmap``
(the samplers' chain batches).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..fed.lowering import canonical_round
from ..fed.lowering import program as fed_program
from ..fed.placements import MeshPlacement, Placement, make_node_compute
from ..fed.primitives import _unflatten, fed_broadcast, fed_map, fed_sum
from ..utils import resolve_device, tree_leaves, tree_map, tree_structure, value_and_grad
from .handlers import Message, PPLError, force_subsample, seed, substitute, trace

__all__ = ["CompiledModel", "compile", "log_density"]

Params = Dict[str, Any]


def site_log_prob(site: Message) -> torch.Tensor:
    """One site's total log-density term: masked, scaled, summed."""
    lp = site["dist"].log_prob(site["value"])
    if site["mask"] is not None:
        lp = lp * site["mask"]
    return site["scale"] * torch.sum(lp)


def _total(terms: List[torch.Tensor]) -> torch.Tensor:
    """``0 + t_1 + t_2 + ...`` in order (the JAX loop's sum; ``0 + t_1``
    is ``t_1`` exactly), with no zero tensor to place on a device."""
    if not terms:
        return torch.zeros(())
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def log_density(model: Callable[..., Any], model_args: Tuple[Any, ...], params: Params) -> torch.Tensor:
    """Direct (non-federated) log-density of ``model`` at ``params``:
    run the model under ``substitute`` and sum every sample site's
    term.  The reference evaluation the compiled lanes are checked
    against; a latent missing from ``params`` is a loud
    :class:`~.handlers.PPLError`."""
    tr = trace(substitute(model, data=dict(params))).get_trace(*model_args)
    return _total([site_log_prob(s) for s in tr.values() if s["type"] == "sample"])


def _in_plate(site: Message, plate_name: str) -> bool:
    return any(f.name == plate_name for f in site["plates"])


def _device_of(model_args: Tuple[Any, ...], device: Any) -> torch.device:
    if device is not None:
        return resolve_device(device)
    for leaf in tree_leaves(model_args):
        if torch.is_tensor(leaf):
            return leaf.device
    return resolve_device(None)


class CompiledModel:
    """One effectful model, every lane (see module docstring).

    Surfaces:

    - :meth:`logp` / :meth:`logp_and_grad` — full-data log density
      under the placement (``torch.autograd`` works through all lanes,
      ``torch.func.vmap`` over a batch of parameter points too).
    - :meth:`logp_indices` / :meth:`logp_minibatch` — the unbiased
      scaled estimator over a shard-index batch (the SVI lanes).
    - :meth:`node_compute` — the per-shard ``[logp, *grads]`` compute
      a pool replica deploys (``service.run_node`` /
      ``serve_tcp_once``), built from the same per-shard function the
      driver maps.
    - :attr:`fed_model` / :meth:`fed_batch_model` — the placement-free
      primitive-level programs (flat parameter leaves).
    - :meth:`init_params` / :meth:`sample_prior` — parameter dicts
      shaped for the samplers.

    ``device`` is the device of the model's tensor arguments (or the
    ``device=`` given, CUDA by default where the arguments hold no
    tensor): discovery draws there, and nodes built by
    :meth:`node_compute` evaluate there.
    """

    def __init__(
        self,
        model: Callable[..., Any],
        model_args: Tuple[Any, ...] = (),
        *,
        placement: Optional[Placement] = None,
        plate: Optional[str] = None,
        batch_size: Optional[int] = None,
        fuse: bool = True,
        device: Any = None,
    ) -> None:
        self.model = model
        self.model_args = tuple(model_args)
        self.placement = placement
        self.device = _device_of(self.model_args, device)
        self._fuse = fuse

        # -- discovery pass 1: sites and plates ------------------------
        tr = trace(seed(model, rng_key=self._discovery_generator())).get_trace(*self.model_args)
        outer: Dict[str, int] = {}
        for site in tr.values():
            if site["plates"]:
                frame = site["plates"][0]
                outer[frame.name] = frame.size
        if plate is None:
            if len(outer) != 1:
                raise PPLError(
                    "compile() needs exactly one outermost plate to map "
                    f"onto shards; found {sorted(outer) or 'none'} — "
                    "pass plate=<name> to pick one"
                )
            plate = next(iter(outer))
        if plate not in outer:
            raise PPLError(f"plate {plate!r} not found in the model (outermost plates: {sorted(outer)})")
        self.plate_name: str = plate
        self.plate_size: int = outer[plate]
        self.n_shards: int = self.plate_size

        # -- discovery pass 2: full-size parameter template ------------
        # Forcing every plate to its full index set makes plate-local
        # latents draw at FULL size even when the author declared
        # subsample_size (the template must cover every shard's rows).
        full = {name: torch.arange(size, device=self.device) for name, size in outer.items()}
        tracer = trace(seed(model, rng_key=self._discovery_generator()))
        with force_subsample(indices=full, scale=False):
            full_trace = tracer.get_trace(*self.model_args)
        self.local_sites: List[str] = []
        self.global_sites: List[str] = []
        template: Params = {}
        batch_default: Optional[int] = None
        for site in full_trace.values():
            if site["type"] != "sample" or site["observed"]:
                continue
            name = site["name"]
            template[name] = torch.zeros_like(site["value"])
            if _in_plate(site, self.plate_name):
                self.local_sites.append(name)
            else:
                self.global_sites.append(name)
        for site in tr.values():
            for frame in site["plates"]:
                if frame.name == self.plate_name and frame.effective < frame.size:
                    batch_default = frame.effective
        self._template = template
        self._treedef = tree_structure(template)
        self._skeleton = tree_map(lambda _: None, template)
        self.batch_size = batch_size or batch_default
        if not template:
            raise PPLError("model has no latent sample sites")

        if isinstance(placement, MeshPlacement):
            axis_size = placement.mesh.shape[placement.axis]
            if self.n_shards % axis_size != 0:
                raise PPLError(
                    f"plate {plate!r} has {self.n_shards} shards, not "
                    f"divisible by mesh axis {placement.axis!r} of size "
                    f"{axis_size}"
                )

        sids = torch.arange(self.n_shards, dtype=torch.int32, device=self.device)
        self._round = canonical_round(self._flat_per_shard, sids, self.n_shards)
        self._program = fed_program(self.fed_model, placement=placement, fuse=fuse)
        self._batch_programs: Dict[int, Callable[..., Any]] = {}

    def _discovery_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(0)

    # -- parameter plumbing -------------------------------------------

    def init_params(self) -> Params:
        """Zero-initialized parameter dict (one entry per latent)."""
        return {k: torch.zeros_like(v) for k, v in self._template.items()}

    def sample_prior(self, generator: torch.Generator) -> Params:
        """One full-size draw from the prior, shaped like
        :meth:`init_params`, from ``generator`` (on its device); the same
        generator state gives the same draw on every placement."""
        full = {self.plate_name: torch.arange(self.plate_size, device=self.device)}
        tracer = trace(seed(self.model, rng_key=generator))
        with force_subsample(indices=full, scale=False):
            tr = tracer.get_trace(*self.model_args)
        return {name: tr[name]["value"] for name in self._template}

    def _leaves(self, params: Params) -> List[Any]:
        if tree_structure(params) != self._treedef:
            raise PPLError(
                f"params structure mismatch: expected latent sites "
                f"{sorted(self._template)}, got "
                f"{sorted(params) if isinstance(params, dict) else type(params)}"
            )
        return tree_leaves(params)

    def _unflatten(self, leaves: Tuple[Any, ...]) -> Params:
        return _unflatten(self._skeleton, list(leaves))

    # -- the effectful re-runs ----------------------------------------

    def _site_sum(self, params: Params, idx: torch.Tensor, *, in_plate: bool) -> torch.Tensor:
        tracer = trace(substitute(self.model, data=dict(params)))
        with force_subsample(indices={self.plate_name: idx}, scale=False):
            tr = tracer.get_trace(*self.model_args)
        return _total([
            site_log_prob(site) for site in tr.values()
            if site["type"] == "sample" and _in_plate(site, self.plate_name) == in_plate
        ])

    def _flat_per_shard(self, *args: Any) -> torch.Tensor:
        """Per-shard plate logp over flat wire operands
        ``(params leaves..., sid)`` — the pool wire contract and the
        ``fed_map`` body, one function."""
        leaves, sid = args[:-1], args[-1]
        params = self._unflatten(leaves)
        idx = sid.to(torch.int32).reshape((1,))
        return self._site_sum(params, idx, in_plate=True)

    def prior_logp(self, params: Params) -> torch.Tensor:
        """The driver-side global prior (every non-plate site)."""
        idx = torch.zeros((1,), dtype=torch.int32, device=self.device)
        return self._site_sum(params, idx, in_plate=False)

    # -- placement-free fed programs ----------------------------------

    def fed_model(self, *leaves: Any) -> torch.Tensor:
        """Full-data placement-free program over flat parameter
        leaves: ``prior + fed_sum(fed_map(per_shard, shard_ids))``."""
        return self.prior_logp(self._unflatten(leaves)) + self._round(*leaves)

    def fed_batch_model(self, m: int) -> Callable[..., torch.Tensor]:
        """The subsample program for batches of ``m`` shard indices:
        ``(*param_leaves, idx) -> prior + (size/m) * fed_sum(...)`` —
        the index batch rides ``fed_map`` as an integer data leaf."""
        m = int(m)
        if not (1 <= m <= self.n_shards):
            raise PPLError(f"batch size {m} not in 1..{self.n_shards}")
        scale = self.plate_size / m

        def batch_model(*args: Any) -> torch.Tensor:
            leaves, idx = args[:-1], args[-1]
            pb = fed_broadcast(tuple(leaves), m)
            lps = fed_map(lambda shard: self._flat_per_shard(*shard[0], shard[1]), (pb, idx))
            return self.prior_logp(self._unflatten(leaves)) + scale * fed_sum(lps)

        return batch_model

    # -- the public evaluation surface --------------------------------

    def logp(self, params: Params) -> torch.Tensor:
        """Full-data log density under the placement."""
        return self._program(*self._leaves(params))

    def logp_and_grad(self, params: Params) -> Tuple[torch.Tensor, Params]:
        """``(logp, grads)`` by one first-order reverse pass."""
        return value_and_grad(self.logp, params)

    def logp_indices(self, params: Params, idx: Any) -> torch.Tensor:
        """Scaled plate logp over an explicit shard-index batch (1-D
        int tensor): ``prior + (size/len(idx)) * Σ_plate``.  With
        ``idx = arange(n_shards)`` this equals :meth:`logp`."""
        idx = torch.as_tensor(idx).to(dtype=torch.int32, device=self.device)
        if idx.dim() != 1:
            raise PPLError(f"idx must be 1-D shard indices, got shape {tuple(idx.shape)}")
        m = int(idx.shape[0])
        prog = self._batch_programs.get(m)
        if prog is None:
            prog = self._batch_programs[m] = fed_program(
                self.fed_batch_model(m), placement=self.placement, fuse=self._fuse
            )
        return prog(*self._leaves(params), idx)

    def logp_minibatch(
        self,
        params: Params,
        generator: torch.Generator,
        *,
        batch_size: Optional[int] = None,
    ) -> torch.Tensor:
        """Unbiased scaled logp over a random minibatch of shards
        (without replacement: a ``torch.randperm`` prefix drawn from
        ``generator``).  ``batch_size`` defaults to the plate's
        declared ``subsample_size``."""
        m = batch_size or self.batch_size
        if m is None:
            raise PPLError(
                "no batch size: declare subsample_size on the plate or pass batch_size="
            )
        idx = torch.randperm(self.n_shards, generator=generator, device=generator.device)[: int(m)]
        return self.logp_indices(params, idx)

    # -- node deployment ----------------------------------------------

    def node_compute(self, *, grads: bool = True) -> Callable[..., list]:
        """Node-side compute matching the wire contract of this
        model's pool-placed ``fed_map``: requests carry
        ``(params leaves..., shard_id)``; replies ``[logp, *grads]``.
        Built from the SAME per-shard function the driver maps, and
        evaluated on :attr:`device`."""
        return make_node_compute(self._flat_per_shard, grads=grads, device=self.device)


def compile(
    model: Callable[..., Any],
    model_args: Tuple[Any, ...] = (),
    *,
    placement: Optional[Placement] = None,
    plate: Optional[str] = None,
    batch_size: Optional[int] = None,
    fuse: bool = True,
    device: Any = None,
) -> CompiledModel:
    """Compile an effectful model to a placement-lowered federated
    program — see :class:`CompiledModel`."""
    return CompiledModel(
        model,
        model_args,
        placement=placement,
        plate=plate,
        batch_size=batch_size,
        fuse=fuse,
        device=device,
    )
