"""Measurement scripts of the port, run on the card as modules:

    python -m gpax_torch.probes.sparse_precision   # float32 vs float64 on the viSparseGP path
    python -m gpax_torch.probes.svi_step_profile   # where an SVI step's time goes

They are not imported by the package.
"""
