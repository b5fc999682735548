"""The shared ELBO core of the variational samplers (``advi``, ``flows``).

Only :mod:`.elbo` is ported so far; the rest of the JAX package's
``ppl/`` (the handlers, the distributions, the compiler and SVI) is not.
"""

from .elbo import gaussian_entropy, meanfield_draws, meanfield_neg_elbo, scan_vi

__all__ = [
    "gaussian_entropy",
    "meanfield_draws",
    "meanfield_neg_elbo",
    "scan_vi",
]
