"""Export draws to arviz's InferenceData (or its plain-dict shape).

Port of the JAX package's ``samplers/arviz_export.py``: the samplers'
exit ramp to arviz, as ``pm.sample`` returns an InferenceData.

- :func:`to_dataset_dict` — always available: the draws, sample stats,
  and (optionally) pointwise log-likelihoods as plain
  ``{group: {var: ndarray(chains, draws, ...)}}`` dicts in arviz's
  layout.
- :func:`to_inference_data` — the same content as a real
  ``az.InferenceData`` when arviz is installed (imported on call; the
  package does not depend on arviz).

Names follow PyMC's conventions (``log_likelihood`` group,
``sample_stats`` with ``diverging``/``energy``/``tree_depth``) so
``az.loo``, ``az.summary`` and ``az.plot_trace`` work unmodified.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils import tree_leaves

__all__ = ["to_dataset_dict", "to_inference_data"]

# The port's per-draw stat names (samplers/mcmc.py:sample) -> arviz's.
_STAT_RENAMES = {
    "accept_prob": "acceptance_rate",
    "diverging": "diverging",
    "depth": "tree_depth",
    "energy": "energy",
}


def _np(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def to_dataset_dict(
    result: Any,
    *,
    pointwise_fn: Optional[Any] = None,
    mask: Optional[Any] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """arviz-layout dict-of-groups from a ``SampleResult``.

    ``pointwise_fn(params)`` (e.g. ``model.pointwise_loglik``) adds a
    ``log_likelihood`` group evaluated over every kept draw in one
    ``torch.func.vmap``; ``mask`` drops padded observation slots.
    """
    posterior = {k: _np(v) for k, v in _as_mapping(result.samples).items()}
    groups: Dict[str, Dict[str, np.ndarray]] = {"posterior": posterior}
    stats = getattr(result, "stats", None)
    if stats:
        groups["sample_stats"] = {
            _STAT_RENAMES.get(k, k): _np(v) for k, v in stats.items()
        }
    if pointwise_fn is not None:
        from .model_comparison import pointwise_loglik_matrix

        c, d = tree_leaves(result.samples)[0].shape[:2]
        ll = pointwise_loglik_matrix(pointwise_fn, result.samples, mask=mask)
        groups["log_likelihood"] = {"obs": ll.reshape((c, d, -1))}
    return groups


def to_inference_data(
    result: Any,
    *,
    pointwise_fn: Optional[Any] = None,
    mask: Optional[Any] = None,
):
    """``az.InferenceData`` built from :func:`to_dataset_dict`.

    Raises ImportError when arviz is not installed (install the
    ``arviz`` extra); use :func:`to_dataset_dict` for the dependency-
    free layout.
    """
    try:
        import arviz as az
    except ModuleNotFoundError as e:
        raise ImportError(
            "to_inference_data requires arviz (pip install "
            "pytensor-federated-tpu[arviz]); to_dataset_dict gives the "
            "same content as plain dicts"
        ) from e

    groups = to_dataset_dict(result, pointwise_fn=pointwise_fn, mask=mask)
    kwargs = {"posterior": groups["posterior"]}
    if "sample_stats" in groups:
        kwargs["sample_stats"] = groups["sample_stats"]
    if "log_likelihood" in groups:
        kwargs["log_likelihood"] = groups["log_likelihood"]
    return az.from_dict(**kwargs)


def _as_mapping(samples: Any) -> Dict[str, Any]:
    """Params tree -> flat name->array mapping (dicts pass through,
    nested dicts as ``outer.inner``; other trees get positional
    names)."""
    if isinstance(samples, dict):
        out = {}
        for k, v in samples.items():
            if isinstance(v, dict):
                for k2, v2 in _as_mapping(v).items():
                    out[f"{k}.{k2}"] = v2
            else:
                out[k] = v
        return out
    return {f"param_{i}": leaf for i, leaf in enumerate(tree_leaves(samples))}
