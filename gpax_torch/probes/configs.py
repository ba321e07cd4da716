"""BASELINE configs 4 and 5: their data and fit settings, shared by
``chip_smoke.py`` and the probes that measure those configs
(``mtgp_divergences``, ``svi_step_profile --model vidkl``).

Config 4 (bench.py:471-600) is MultiTaskGP on 320 low- and 64
high-fidelity points, cut from 1000 + 4000 draws to 200 + 200 because the
port's NUTS is driven from the host. Config 5 (bench.py:603-658) is
viDKL's 8-model ensemble on 256 measured points of a 2000-point pool in
d = 784, 1000 SVI steps, at full size.
"""

from __future__ import annotations

import numpy as np

MT_WARMUP, MT_SAMPLES, MT_SEGMENT = 200, 200, 50
MT_DEPTH, MT_DEPTH_CAP, MT_TARGET = 8, (5, 20), 0.7
MT_N_LO, MT_N_HI = 320, 64

VIDKL_POOL, VIDKL_D, VIDKL_MEASURED, VIDKL_MODELS = 2000, 784, 256, 8
VIDKL_STEPS = 1000


def f_hi(x):
    return np.sin(5 * x) * np.exp(-x)


def config4_data():
    """bench.py:471-600's data: 320 low- and 64 high-fidelity points on
    [0, 2], f_hi = sin(5x)·e^(−x), f_lo = 0.8·f_hi + 0.2·cos(3x), noise sd
    0.05, the task index in the last column; float32."""
    rng = np.random.default_rng(0)
    x_lo, x_hi = rng.uniform(0, 2, MT_N_LO), rng.uniform(0, 2, MT_N_HI)
    X = np.concatenate([np.column_stack([x_lo, np.zeros(MT_N_LO)]),
                        np.column_stack([x_hi, np.ones(MT_N_HI)])])
    y = np.concatenate([0.8 * f_hi(x_lo) + 0.2 * np.cos(3 * x_lo), f_hi(x_hi)])
    y = y + 0.05 * rng.normal(size=MT_N_LO + MT_N_HI)
    return X.astype(np.float32), y.astype(np.float32)


def config5_data():
    """bench.py:618-625: the pool, its targets, the measured indices and the
    pool's 2-D latent (which chip_smoke.py's channels phase's second target
    uses)."""
    rng = np.random.default_rng(0)
    latent = rng.normal(size=(VIDKL_POOL, 2))
    mix = rng.normal(size=(2, VIDKL_D)) / np.sqrt(2)
    X_pool = latent @ mix + 0.01 * rng.normal(size=(VIDKL_POOL, VIDKL_D))
    y_pool = np.sin(latent[:, 0] * 2.0) + 0.3 * latent[:, 1]
    measured = rng.choice(VIDKL_POOL, size=VIDKL_MEASURED, replace=False)
    return X_pool.astype(np.float32), y_pool, measured, latent
