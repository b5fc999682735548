"""Samplers on flat parameter vectors: NUTS, HMC and Metropolis, warmup,
diagnostics, and the MAP point."""

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
from .mcmc import SampleResult, find_map, make_flat_logp_and_grad, make_kernel_step, sample
from .metropolis import MetropolisState, metropolis_init, metropolis_step
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
