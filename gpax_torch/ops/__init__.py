from .chol import blocked_trtri
from .linalg import (
    chol_tri_factors,
    gp_predictive_mean_var,
    gp_predictive_moments,
    mvn_log_prob_centered,
    mvn_sample_from_cov,
    robust_mvn_sample,
    safe_cholesky,
)

__all__ = [
    "blocked_trtri",
    "chol_tri_factors",
    "mvn_log_prob_centered",
    "safe_cholesky",
    "robust_mvn_sample",
    "gp_predictive_moments",
    "gp_predictive_mean_var",
    "mvn_sample_from_cov",
]
