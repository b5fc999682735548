"""Pure, pytensor-free cores of the bridge layer — tested directly.

PyTensor and PyMC are optional: the Apply/optdb glue in
:mod:`.pytensor_ops` and :mod:`.fusion` imports them, and everything
with logic in it is factored out here, where it runs under test without
them (as :mod:`..fanout_exec` holds the fused perform's scheduling and
:mod:`.grouping` the rewrite's independence planning):

- the ``perform``-layer output coercion and validation contracts
  (output arity, scalar logp, one grad per input, dtype cast);
- the grad-output dtype policy (int inputs upcast to floatX so the
  gradient is not silently truncated);
- the PyTorch-dispatch composition: node-shaped output wrapping per op
  kind and the fused op's member inliner (what ``pytorch_funcify``
  returns).
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "coerce_outputs",
    "coerce_logp",
    "coerce_logp_grads",
    "grad_output_dtype",
    "plan_fusion",
    "member_torch_callable",
    "fused_torch_callable",
]


# ---------------------------------------------------------------------------
# perform-layer contracts
# ---------------------------------------------------------------------------


def coerce_outputs(
    results: Sequence, dtypes: Sequence[str]
) -> List[np.ndarray]:
    """Arrays->arrays output contract: arity must match, each output is
    cast to its declared dtype."""
    results = list(results)
    if len(results) != len(dtypes):
        raise ValueError(
            f"compute_fn returned {len(results)} outputs, "
            f"expected {len(dtypes)}"
        )
    return [np.asarray(r, dtype=d) for r, d in zip(results, dtypes)]


def coerce_logp(logp, dtype: str) -> np.ndarray:
    """Scalar log-potential contract."""
    out = np.asarray(logp, dtype=dtype)
    if out.ndim != 0:
        raise ValueError(f"logp must be scalar, got shape {out.shape}")
    return out


def coerce_logp_grads(
    logp, grads: Sequence, logp_dtype: str, grad_dtypes: Sequence[str]
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """``[logp, *grads]`` contract: one grad per input, each cast to its
    declared (possibly upcast — see :func:`grad_output_dtype`) dtype."""
    if len(grads) != len(grad_dtypes):
        raise ValueError(
            f"logp_grad_fn returned {len(grads)} grads for "
            f"{len(grad_dtypes)} inputs"
        )
    return (
        coerce_logp(logp, logp_dtype),
        [np.asarray(g, dtype=d) for g, d in zip(grads, grad_dtypes)],
    )


def grad_output_dtype(input_dtype: str, floatX: str = "float64") -> str:
    """Dtype of the grad output for an input of ``input_dtype``.

    Integer/bool inputs (the raw-python-int coercion path) get floatX:
    an int-typed grad output would silently truncate the float gradient
    at the cast in ``coerce_logp_grads``.
    """
    if str(input_dtype).startswith(("int", "uint", "bool")):
        return floatX
    return str(input_dtype)


# ---------------------------------------------------------------------------
# rewrite replacement planning
# ---------------------------------------------------------------------------


def plan_fusion(
    group: Sequence,
    *,
    op_of: Callable,
    inputs_of: Callable,
    outputs_of: Callable,
):
    """Plan one group's fused replacement: the constructor arguments of
    the fused op plus the (old_output -> fused_output_index) pairing.

    The part of the rewriter that decides WHAT replaces what; the
    ``fgraph.replace_all_validate`` call is the only pytensor left.
    Returns a dict with:

    - ``members``: each node's op, in group order;
    - ``in_counts`` / ``out_counts``: per-member arities;
    - ``all_inputs``: concatenated member inputs (fused apply inputs);
    - ``replacements``: ``[(old_output, fused_output_position), ...]``
      — every member output paired with its index into the fused
      apply's outputs, order-preserving.
    """
    members = [op_of(n) for n in group]
    in_counts = [len(inputs_of(n)) for n in group]
    out_counts = [len(outputs_of(n)) for n in group]
    all_inputs = [i for n in group for i in inputs_of(n)]
    old_outputs = [o for n in group for o in outputs_of(n)]
    replacements = list(zip(old_outputs, range(len(old_outputs))))
    return {
        "members": members,
        "in_counts": in_counts,
        "out_counts": out_counts,
        "all_inputs": all_inputs,
        "replacements": replacements,
    }


# ---------------------------------------------------------------------------
# PyTorch-dispatch composition
# ---------------------------------------------------------------------------


def member_torch_callable(
    kind: str, fn: Callable, *, name: str = "op"
) -> Callable:
    """Node-shaped torch callable for one federated op.

    ``kind``: ``"logp_grad"`` (fn returns ``(logp, [grads])`` ->
    flattened ``(logp, *grads)``), ``"logp"`` (scalar through), or
    ``"arrays"`` (sequence -> tuple).  This is exactly what the
    ``pytorch_funcify`` registrations return; dispatching on an explicit
    kind keeps it testable without pytensor op classes.  ``name`` goes
    into the missing-``torch_fn`` error so a fused graph with several
    federated ops points at the unconfigured one.
    """
    if fn is None:
        raise NotImplementedError(
            f"{name} has no torch_fn; pass torch_fn= to compile through "
            "the PyTorch linker"
        )
    if kind == "logp_grad":

        def logp_grad(*inputs):
            logp, grads = fn(*inputs)
            return (logp, *tuple(grads))

        # A fed.FederatedLogpGrad's bound ``torch_fn`` carries the whole
        # placement-lowered program; tag the wrapper so a FUSED apply
        # (fused_torch_callable) can compose several such members into
        # one fed.program and let the window-fusion pass coalesce
        # their independent fed_maps.
        ev = getattr(fn, "__self__", None)
        if (
            ev is not None
            and callable(getattr(ev, "fed_model", None))
            and getattr(ev, "placement", None) is not None
        ):
            logp_grad._fed_evaluator = ev
        return logp_grad
    if kind == "logp":

        def logp(*inputs):
            return fn(*inputs)

        return logp
    if kind == "arrays":

        def arrays_to_arrays(*inputs):
            return tuple(fn(*inputs))

        return arrays_to_arrays
    raise ValueError(f"unknown member kind {kind!r}")


def fused_torch_callable(
    member_fns: Sequence[Callable], in_counts: Sequence[int]
) -> Callable:
    """Inline N node-shaped member callables into one flat callable —
    the fused op's PyTorch dispatch.  Input/output flattening mirrors
    ``fanout_exec.run_members``'s storage slicing, so the compiled path
    and the perform path cannot disagree about order.

    When every member is a ``fed.FederatedLogpGrad`` potential and the
    members' placements share one ``fusion_key()`` (the tag
    :func:`member_torch_callable` attaches), the members compose into ONE
    ``fed.program`` instead: the fed batching pass then fuses their
    independent ``fed_map`` calls into a single pipelined pool window."""
    member_fns = list(member_fns)
    in_counts = list(in_counts)
    if len(member_fns) != len(in_counts):
        raise ValueError(
            f"{len(member_fns)} member fns but {len(in_counts)} in_counts"
        )
    evs = [getattr(f, "_fed_evaluator", None) for f in member_fns]
    if len(evs) >= 2 and all(e is not None for e in evs):
        # Placement EQUIVALENCE, not object identity: each potential is
        # typically built with its own PoolPlacement over the shared
        # client, and those must still fuse into one window.
        keys = {
            getattr(
                e.placement, "fusion_key", lambda p=e.placement: id(p)
            )()
            for e in evs
        }
        if len(keys) == 1:
            return _fused_fed_callable(evs, in_counts)

    def parallel(*inputs):
        if len(inputs) != sum(in_counts):
            raise ValueError(
                f"fused callable got {len(inputs)} inputs, members "
                f"consume {sum(in_counts)}"
            )
        outs = []
        i = 0
        for fn, n_in in zip(member_fns, in_counts):
            res = fn(*inputs[i : i + n_in])
            outs.extend(res if isinstance(res, tuple) else (res,))
            i += n_in
        return tuple(outs)

    return parallel


def _fused_fed_callable(evaluators, in_counts) -> Callable:
    """Compose N fed logp+grad potentials into ONE placement-lowered
    program.  One first-order ``torch.autograd.grad`` of the members'
    total over the joint program is one forward execution — on a pool
    placement that is ONE fused window for every member's shards, where
    per-member programs would each pay their own round trip.  Output
    layout per member is ``(logp, *grads)``, identical to the inlined
    path, so the perform lane and this lane cannot disagree."""
    import torch

    from ..fed import program as fed_program
    from ..utils import value_and_first_grad

    evaluators = list(evaluators)
    placement = evaluators[0].placement
    n_total = sum(in_counts)

    def joint_model(*inputs):
        lps, i = [], 0
        for ev, n_in in zip(evaluators, in_counts):
            lps.append(ev.fed_model(*inputs[i : i + n_in]))
            i += n_in
        return tuple(lps)

    prog = fed_program(joint_model, placement)

    def parallel(*inputs: Any):
        if len(inputs) != n_total:
            raise ValueError(
                f"fused fed callable got {len(inputs)} inputs, members "
                f"consume {n_total}"
            )
        # The members' logps stacked: the gradient of a vector value is
        # that of its sum, and the logps leave the reverse pass as its
        # value (under vmap nothing captured inside it may escape).
        lps, grads = value_and_first_grad(
            lambda ins: torch.stack(prog(*ins)), tuple(inputs)
        )
        outs, i = [], 0
        for lp, n_in in zip(lps.unbind(), in_counts):
            outs.append(lp)
            outs.extend(grads[i : i + n_in])
            i += n_in
        return tuple(outs)

    return parallel
