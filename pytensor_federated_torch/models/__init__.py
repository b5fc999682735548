"""Models: the flagship federated linear regression, BASELINE.json's
radon GLM, Lotka-Volterra ODE and federated logistic regressions, the
other GLM families (count, robust, Gamma, ordinal, softmax, survival),
the Gaussian mixture, the Gaussian processes, the linear-Gaussian
state-space models and the sequence-sharded AR(1) and state-space
models."""

from .countdata import (
    FederatedNegBinGLM,
    FederatedPoissonGLM,
    FederatedZeroInflNegBinGLM,
    FederatedZeroInflPoissonGLM,
    generate_count_data,
    generate_zi_count_data,
)
from .gamma import FederatedGammaGLM, gamma_logpdf, generate_gamma_data
from .glm import HierarchicalRadonGLM, generate_radon_data
from .gp import (
    FederatedExactGP,
    FederatedSparseGP,
    dense_vfe_logp,
    generate_gp_data,
    get_kernel,
)
from .hierbase import HierarchicalGLMBase, linear_predictor, log_halfnormal_draw
from .linear import FederatedLinearRegression, generate_node_data, linreg_suffstats
from .logistic import (
    FederatedLogisticRegression,
    HierarchicalLogisticRegression,
    generate_hier_logistic_data,
    generate_logistic_data,
)
from .mixture import FederatedGaussianMixture, generate_mixture_data, mixture_loglik
from .multinomial import (
    FederatedSoftmaxRegression,
    HierarchicalSoftmaxRegression,
    generate_hier_multinomial_data,
    generate_multinomial_data,
)
from .ode import (
    LotkaVolterraModel,
    generate_lv_data,
    make_lv_model,
    rk4_integrate,
)
from .ordinal import (
    FederatedOrdinalRegression,
    cumulative_logit_loglik,
    generate_ordinal_data,
)
from .robust import FederatedRobustRegression, generate_robust_data, student_t_logpdf
from .statespace import (
    FederatedLGSSMPanel,
    SeqShardedLGSSM,
    ekf_logp,
    generate_lgssm_data,
    kalman_forecast,
    kalman_logp_parallel,
    kalman_logp_seq,
    kalman_smoother_parallel,
    kalman_smoother_seq,
    kalman_smoother_with_lag1,
    lgssm_em,
    panel_em,
    sample_latents,
)
from .survival import (
    FederatedWeibullAFT,
    generate_survival_data,
    weibull_censored_loglik,
)
from .timeseries import SeqShardedAR1, generate_ar1_data

__all__ = [
    "FederatedGammaGLM",
    "FederatedGaussianMixture",
    "FederatedSoftmaxRegression",
    "HierarchicalSoftmaxRegression",
    "generate_hier_multinomial_data",
    "generate_multinomial_data",
    "FederatedExactGP",
    "FederatedNegBinGLM",
    "FederatedOrdinalRegression",
    "FederatedPoissonGLM",
    "FederatedZeroInflNegBinGLM",
    "FederatedZeroInflPoissonGLM",
    "FederatedRobustRegression",
    "FederatedSparseGP",
    "FederatedWeibullAFT",
    "cumulative_logit_loglik",
    "gamma_logpdf",
    "generate_count_data",
    "generate_zi_count_data",
    "get_kernel",
    "generate_gamma_data",
    "generate_mixture_data",
    "mixture_loglik",
    "generate_ordinal_data",
    "generate_robust_data",
    "generate_survival_data",
    "weibull_censored_loglik",
    "student_t_logpdf",
    "SeqShardedAR1",
    "FederatedLGSSMPanel",
    "SeqShardedLGSSM",
    "generate_lgssm_data",
    "ekf_logp",
    "kalman_forecast",
    "kalman_logp_parallel",
    "kalman_logp_seq",
    "kalman_smoother_parallel",
    "kalman_smoother_seq",
    "kalman_smoother_with_lag1",
    "lgssm_em",
    "panel_em",
    "sample_latents",
    "dense_vfe_logp",
    "generate_ar1_data",
    "generate_gp_data",
    "FederatedLinearRegression",
    "FederatedLogisticRegression",
    "HierarchicalLogisticRegression",
    "HierarchicalRadonGLM",
    "LotkaVolterraModel",
    "generate_hier_logistic_data",
    "generate_logistic_data",
    "generate_lv_data",
    "generate_node_data",
    "generate_radon_data",
    "make_lv_model",
    "rk4_integrate",
    # Port only: the base class and helpers the GLM families share, and the flagship's sufficient statistics.
    "HierarchicalGLMBase",
    "linear_predictor",
    "linreg_suffstats",
    "log_halfnormal_draw",
]
