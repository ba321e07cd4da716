from . import diagnostics
from .diagnostics import effective_sample_size, gelman_rubin, print_summary, split_gelman_rubin, summary
from .mcmc import MCMC
from .nuts import NUTS, run_nuts
from .svi import SVI, Adam, AutoDelta, AutoDiagonalNormal, AutoNormal, SVIRunResult, SVIState, Trace_ELBO

__all__ = [
    "MCMC",
    "NUTS",
    "run_nuts",
    "SVI",
    "AutoDelta",
    "AutoNormal",
    "AutoDiagonalNormal",
    "SVIRunResult",
    "SVIState",
    "Trace_ELBO",
    "Adam",
    "diagnostics",
    "gelman_rubin",
    "split_gelman_rubin",
    "effective_sample_size",
    "summary",
    "print_summary",
]
