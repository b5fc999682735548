"""Samplers on flat parameter vectors: NUTS, HMC and Metropolis, warmup,
ChEES-HMC, parallel tempering, diagnostics, and the MAP point.  Every
chain of a run steps in lockstep, as one batch.  After a run: posterior
and prior predictive draws, WAIC / PSIS-LOO model comparison, the
Laplace approximation and the arviz export."""

from .arviz_export import to_dataset_dict, to_inference_data
from .chees import chees_sample
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
from .predictive import posterior_predictive, prior_predictive
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
