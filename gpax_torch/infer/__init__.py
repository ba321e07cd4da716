from . import diagnostics
from .diagnostics import effective_sample_size, gelman_rubin, print_summary, split_gelman_rubin, summary
from .mcmc import MCMC
from .nuts import NUTS, run_nuts

__all__ = [
    "MCMC",
    "NUTS",
    "run_nuts",
    "diagnostics",
    "gelman_rubin",
    "split_gelman_rubin",
    "effective_sample_size",
    "summary",
    "print_summary",
]
