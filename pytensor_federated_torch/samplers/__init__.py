"""Samplers on flat parameter vectors: NUTS and HMC, warmup, diagnostics."""

from .convergence import effective_sample_size, hdi, split_rhat, summary, tail_ess
from .hmc import (
    HMCInfo,
    HMCState,
    IntegratorState,
    find_reasonable_step_size,
    hmc_init,
    hmc_step,
    kinetic_energy,
    leapfrog,
    sample_momentum,
)
from .mcmc import SampleResult, make_flat_logp_and_grad, make_kernel_step, sample
from .nuts import NUTSInfo, nuts_step
from .util import (
    AdaptSchedule,
    DualAveragingState,
    WelfordState,
    da_init,
    da_update,
    flatten_logp,
    ravel,
    welford_covariance,
    welford_init,
    welford_update,
    welford_variance,
)
