from .chol import blocked_eligible, blocked_trtri, chol_inv
from .fused_density import gp_mvn_log_prob
from .linalg import (
    cho_solve,
    chol_tri_factors,
    gp_predictive_mean_var,
    gp_predictive_moments,
    mvn_log_prob_centered,
    mvn_sample_from_cov,
    robust_mvn_sample,
    safe_chol_inv,
    safe_cholesky,
    tri_solve,
)
from .panel_chol import panel_chol_factors, panel_cholesky, panel_tri_inv_t

__all__ = [
    "blocked_eligible",
    "blocked_trtri",
    "chol_inv",
    "safe_chol_inv",
    "chol_tri_factors",
    "cho_solve",
    "tri_solve",
    "mvn_log_prob_centered",
    "safe_cholesky",
    "robust_mvn_sample",
    "gp_predictive_moments",
    "gp_predictive_mean_var",
    "mvn_sample_from_cov",
    "gp_mvn_log_prob",
    "panel_cholesky",
    "panel_tri_inv_t",
    "panel_chol_factors",
]
