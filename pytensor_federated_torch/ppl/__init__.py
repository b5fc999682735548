"""``ppl`` — an effect-handler probabilistic front end that compiles
plate-structured models to ``fed.program``.

The port of the JAX package's ``ppl/``.  One model definition, every
execution mode (the NumPyro composable-effects design, PAPERS.md):
probabilistic statements — :func:`sample`, :func:`deterministic`,
:class:`plate`, :func:`subsample` — emit messages through composable
handlers (:class:`trace`, :class:`replay`, :class:`condition`,
:class:`substitute`, :class:`seed`, :class:`block`), and the compiler
(:func:`compile`) maps the outermost plate onto the ``fed_map`` /
``fed_sum`` primitives (the DrJAX plate→MapReduce correspondence), so
the same model runs

- directly (:func:`log_density`),
- under NUTS / tempering (``samplers.sample(compiled.logp, ...)``),
- as batch SVI through the shared ELBO core (:func:`svi_fit` — which
  ``samplers/advi.py`` and ``samplers/flows.py`` also optimize
  through), and
- as STREAMING SVI over live minibatch traffic through the gateway
  (:class:`StreamingSVI`), under the deadline regime.

Quick shape::

    from pytensor_federated_torch import fed, ppl
    from pytensor_federated_torch.ppl.distributions import Normal

    def model(x, y):
        w = ppl.sample("w", Normal(0.0, 1.0))
        with ppl.plate("shards", x.shape[0]) as sh:
            xs, ys = ppl.subsample(x, sh), ppl.subsample(y, sh)
            ppl.sample("obs", Normal(w * xs, 1.0), obs=ys)

    c = ppl.compile(model, (x, y), placement=fed.MeshPlacement(mesh))
    value, grads = c.logp_and_grad(c.init_params())

Randomness comes from ``torch.Generator``s where the JAX package takes
PRNG keys; everything runs on the device of the model's arguments.
"""

import importlib
from typing import Any

# The names load on first use (PEP 562): ``ppl.elbo`` sits under the
# optimizers, the mesh's ZeRO loop and the VI samplers, which ``fed``
# itself imports, while the compiler sits on ``fed`` — importing it here
# eagerly would close that cycle.
_WHERE = {
    "distributions": (".distributions", None),
    "CompiledModel": (".compiler", "CompiledModel"),
    "compile": (".compiler", "compile"),
    "log_density": (".compiler", "log_density"),
    **{name: (".elbo", name) for name in (
        "gaussian_entropy", "meanfield_draws", "meanfield_neg_elbo", "scan_vi")},
    **{name: (".handlers", name) for name in (
        "Messenger", "PPLError", "block", "condition", "deterministic", "force_subsample",
        "plate", "replay", "sample", "seed", "subsample", "substitute", "trace")},
    "make_radon_example": (".radon", "make_radon_example"),
    "radon_model": (".radon", "radon_model"),
    "StreamingSVI": (".svi", "StreamingSVI"),
    "SVIResult": (".svi", "SVIResult"),
    "svi_fit": (".svi", "svi_fit"),
}


def __getattr__(name: str) -> Any:
    try:
        module, attr = _WHERE[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    mod = importlib.import_module(module, __name__)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value
    return value


def __dir__() -> list:
    return sorted(set(globals()) | set(_WHERE))


__all__ = [
    "CompiledModel",
    "Messenger",
    "PPLError",
    "StreamingSVI",
    "SVIResult",
    "block",
    "compile",
    "condition",
    "deterministic",
    "distributions",
    "force_subsample",
    "gaussian_entropy",
    "log_density",
    "make_radon_example",
    "meanfield_draws",
    "meanfield_neg_elbo",
    "plate",
    "radon_model",
    "replay",
    "sample",
    "scan_vi",
    "seed",
    "subsample",
    "substitute",
    "svi_fit",
    "trace",
]
