"""Measurement scripts of the port, run on the card as modules:

    python -m gpax_torch.probes.sparse_precision   # float32 vs float64 on the viSparseGP path
    python -m gpax_torch.probes.svi_step_profile   # where an SVI step's time goes
    python -m gpax_torch.probes.mtgp_divergences   # config 4's fit across seeds; its leapfrog

``configs`` holds BASELINE configs 4 and 5's data and fit settings, which
they and ``chip_smoke.py`` share. They are not imported by the package.
"""
