from .modules import (
    MLP,
    ConvNet,
    FunctionalModule,
    Module,
    as_module,
    dense,
    module_param,
    random_module,
)

__all__ = ["Module", "FunctionalModule", "as_module", "MLP", "ConvNet", "dense",
           "random_module", "module_param"]
