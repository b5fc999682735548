"""Samplers on flat parameter vectors: NUTS, HMC and Metropolis, warmup,
ChEES-HMC, parallel tempering, diagnostics, and the MAP point.  Every
chain of a run steps in lockstep, as one batch.  Variational inference
(ADVI, RealNVP flows, Pathfinder), tempered SMC, the ensemble sampler,
stochastic-gradient Langevin samplers and simulation-based calibration,
each evaluating its particles, walkers or draws as one batch.  After a
run: posterior and prior predictive draws, WAIC / PSIS-LOO model
comparison, the Laplace approximation and the arviz export.  Elastic
sampling: checkpointed sampling that recovers from a failed segment."""

from .advi import ADVIResult, FullRankADVIResult, advi_fit, fullrank_advi_fit
from .arviz_export import to_dataset_dict, to_inference_data
from .chees import chees_sample
from .elastic import elastic_sample
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
from .ensemble import EnsembleResult, ensemble_sample
from .flows import FlowADVIResult, realnvp_advi_fit
from .laplace import LaplaceResult, laplace_approximation
from .mcmc import (
    SampleResult,
    find_map,
    make_batch_logp_and_grad,
    make_flat_logp_and_grad,
    make_kernel_step,
    sample,
)
from .model_comparison import compare, pointwise_loglik_matrix, psis_loo, waic
from .pathfinder import PathfinderResult, multipath_pathfinder, pathfinder
from .predictive import posterior_predictive, prior_predictive
from .sbc import SBCResult, sbc_ranks, sbc_uniformity
from .sgld import SGLDResult, polynomial_decay, psgld_sample, sghmc_sample, sgld_sample
from .smc import SMCResult, smc_sample
from .tempering import pt_sample
from .metropolis import MetropolisState, metropolis_init, metropolis_step
from .nuts import NUTSDraws, NUTSInfo, draw_nuts, nuts_step
from .util import (
    AdaptSchedule,
    DualAveragingState,
    WelfordState,
    da_init,
    da_update,
    flatten_logp,
    ravel,
    ravel_batch,
    welford_covariance,
    welford_init,
    welford_update,
    welford_variance,
)

__all__ = [
    "ADVIResult",
    "AdaptSchedule",
    "EnsembleResult",
    "LaplaceResult",
    "PathfinderResult",
    "SGLDResult",
    "SMCResult",
    "advi_fit",
    "fullrank_advi_fit",
    "FullRankADVIResult",
    "FlowADVIResult",
    "realnvp_advi_fit",
    "SBCResult",
    "sbc_ranks",
    "sbc_uniformity",
    "ensemble_sample",
    "smc_sample",
    "HMCState",
    "NUTSInfo",
    "SampleResult",
    "effective_sample_size",
    "find_map",
    "find_reasonable_step_size",
    "laplace_approximation",
    "multipath_pathfinder",
    "pathfinder",
    "polynomial_decay",
    "psgld_sample",
    "sghmc_sample",
    "sgld_sample",
    "flatten_logp",
    "split_rhat",
    "hdi",
    "summary",
    "tail_ess",
    "hmc_init",
    "hmc_step",
    "leapfrog",
    "metropolis_init",
    "metropolis_step",
    "nuts_step",
    "chees_sample",
    "elastic_sample",
    "pt_sample",
    "compare",
    "to_dataset_dict",
    "to_inference_data",
    "pointwise_loglik_matrix",
    "posterior_predictive",
    "psis_loo",
    "waic",
    "prior_predictive",
    "sample",
    # Port only: the samplers' state types, the NUTS draws that tests inject, and the flat-vector and adaptation helpers.
    "DualAveragingState",
    "HMCInfo",
    "IntegratorState",
    "MetropolisState",
    "NUTSDraws",
    "WelfordState",
    "da_init",
    "da_update",
    "draw_nuts",
    "kinetic_energy",
    "make_batch_logp_and_grad",
    "make_flat_logp_and_grad",
    "make_kernel_step",
    "ravel",
    "ravel_batch",
    "sample_momentum",
    "welford_covariance",
    "welford_init",
    "welford_update",
    "welford_variance",
]
