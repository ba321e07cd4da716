from .priors import *  # noqa: F401,F403
from .priors import __all__  # noqa: F401
