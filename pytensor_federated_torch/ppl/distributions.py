"""Minimal distribution objects for the effect-handler front end.

The port of the JAX package's ``ppl/distributions.py``.  Each
distribution is a frozen value object with ``log_prob`` (the elementwise
log-density — sites sum it themselves, so masking and plate scaling
compose outside) and ``sample`` (a reparameterized or direct draw;
prior-predictive discovery and ``seed``-handled traces use it).  The
Gaussian terms go through the one ``models/linear._normal_logpdf`` the
port ships, so a PPL model and its hand-written twin cannot drift.

Everything is elementwise: parameters (Python numbers or tensors)
broadcast against the value as torch arithmetic does, and there is no
event-shape machinery — the :class:`~.handlers.plate` owns independence
structure.  ``sample(generator, sample_shape)`` draws from a
``torch.Generator`` on the generator's device, where the JAX version
takes a PRNG key; the draws are float32 unless a parameter promotes
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from ..models.linear import _normal_logpdf

__all__ = [
    "Bernoulli",
    "Distribution",
    "Exponential",
    "HalfNormal",
    "HalfNormalLog",
    "Normal",
]

_LOG_HALF_NORMAL_CONST = 0.5 * math.log(2.0 / math.pi)
_TINY32 = torch.finfo(torch.float32).tiny


def _log(x: Any) -> Any:
    return torch.log(x) if torch.is_tensor(x) else math.log(x)


def _tensor(x: Any) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def _normal(generator: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


@dataclasses.dataclass(frozen=True)
class Distribution:
    """Base class: elementwise ``log_prob`` + ``sample``."""

    def log_prob(self, value: Any) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, generator: torch.Generator, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        raise NotImplementedError

    def shape(self) -> Tuple[int, ...]:
        """Broadcast shape of the parameters (the per-draw shape)."""
        return tuple(torch.broadcast_shapes(*(
            tuple(getattr(getattr(self, f.name), "shape", ()))
            for f in dataclasses.fields(self)
        )))

    def _draw_shape(self, sample_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(sample_shape) + self.shape()


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    """Gaussian — wraps the port's one ``_normal_logpdf``."""

    loc: Any = 0.0
    scale: Any = 1.0

    def log_prob(self, value: Any) -> torch.Tensor:
        return _normal_logpdf(_tensor(value), self.loc, self.scale)

    def sample(self, generator: torch.Generator, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self.loc + self.scale * _normal(generator, self._draw_shape(sample_shape))


@dataclasses.dataclass(frozen=True)
class HalfNormal(Distribution):
    """Half-Gaussian on ``x > 0`` (support is NOT checked — samplers
    that need an unconstrained parameterization should use
    :class:`HalfNormalLog` instead)."""

    scale: Any = 1.0

    def log_prob(self, value: Any) -> torch.Tensor:
        z = _tensor(value) / self.scale
        return -0.5 * z * z - _log(self.scale) + _LOG_HALF_NORMAL_CONST

    def sample(self, generator: torch.Generator, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return torch.abs(self.scale * _normal(generator, self._draw_shape(sample_shape)))


@dataclasses.dataclass(frozen=True)
class HalfNormalLog(Distribution):
    """The law of ``log(X)`` for ``X ~ HalfNormal(scale)`` — the
    standard unconstrained scale prior (``-0.5 exp(2u)/s^2 + u`` plus
    constants: the HalfNormal log-density at ``exp(u)`` with the
    log-transform Jacobian, the ``models/glm.py`` ``log_tau`` term).
    Sampling NUTS/SVI over this value needs no bijector machinery."""

    scale: Any = 1.0

    def log_prob(self, value: Any) -> torch.Tensor:
        value = _tensor(value)
        x = torch.exp(value) / self.scale
        return -0.5 * x * x + value - _log(self.scale) + _LOG_HALF_NORMAL_CONST

    def sample(self, generator: torch.Generator, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        draw = torch.abs(self.scale * _normal(generator, self._draw_shape(sample_shape)))
        return torch.log(draw + _TINY32)


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    """Exponential(rate) on ``x > 0`` (support not checked)."""

    rate: Any = 1.0

    def log_prob(self, value: Any) -> torch.Tensor:
        return _log(self.rate) - self.rate * _tensor(value)

    def sample(self, generator: torch.Generator, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        shape = self._draw_shape(sample_shape)
        draw = torch.empty(shape, device=generator.device).exponential_(generator=generator)
        return draw / self.rate


@dataclasses.dataclass(frozen=True)
class Bernoulli(Distribution):
    """Bernoulli over {0, 1} parameterized by logits — the stable
    ``y*eta - log(1 + e^eta)`` kernel (``models/logistic.py``)."""

    logits: Any = 0.0

    def log_prob(self, value: Any) -> torch.Tensor:
        logits = _tensor(self.logits)
        return _tensor(value) * logits - torch.logaddexp(torch.zeros_like(logits), logits)

    def sample(self, generator: torch.Generator, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        shape = self._draw_shape(sample_shape)
        p = torch.sigmoid(torch.as_tensor(self.logits, device=generator.device))
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u < p).to(torch.float32)
