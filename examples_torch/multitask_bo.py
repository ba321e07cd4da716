"""Multi-task GP + acquisition in a multi-fidelity BO setting, on gpax_torch.

The gpax_torch form of examples/multitask_bo.py (the reference's
GPax_MultiTaskGP_BO.ipynb): a cheap low-fidelity task informs optimization
of an expensive high-fidelity task through a learned task covariance.
``main(device=None, nuts=None)`` runs on the CUDA card unless ``device``
says otherwise; ``nuts`` is merged into the NUTS fit's keywords. Set
SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch
from gpax_torch.acquisition import EI

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
BUDGET = dict(num_warmup=100, num_samples=100) if SMOKE else dict(num_warmup=1000, num_samples=1000)


def f_hi(x):
    return np.sin(5 * x) * np.exp(-x)


def f_lo(x):
    return 0.8 * f_hi(x) + 0.2 * np.cos(3 * x)  # correlated, biased


def main(device=None, nuts=None):
    budget = {**BUDGET, **(nuts or {})}
    rng = np.random.default_rng(0)
    n_lo, n_hi = (12, 4) if SMOKE else (40, 8)
    X_lo = rng.uniform(0, 2, n_lo)
    X_hi = rng.uniform(0, 2, n_hi)
    # indexed multitask format: task id in the last column
    X = np.concatenate([
        np.column_stack([X_lo, np.zeros(n_lo)]),
        np.column_stack([X_hi, np.ones(n_hi)]),
    ])
    y = np.concatenate([f_lo(X_lo), f_hi(X_hi)])

    key_fit, key_pred = gpax_torch.utils.get_keys()
    mtgp = gpax_torch.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2, rank=2)
    mtgp.fit(key_fit, torch.tensor(X, dtype=torch.float32), torch.tensor(y, dtype=torch.float32),
             print_summary=not SMOKE, progress_bar=False, device=device, **budget)

    # predict the expensive task over a dense grid
    grid = torch.linspace(0, 2, 101)
    X_test = torch.stack([grid, torch.ones_like(grid)], 1)
    mean, samples = mtgp.predict(key_pred, X_test, noiseless=True, device=device)
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - f_hi(grid.numpy())) ** 2)))
    print(f"high-fidelity RMSE from {n_hi} expensive + {n_lo} cheap points: {rmse:.4f}")

    # acquisition on the expensive task (Bayesian-averaged EI)
    acq = EI(key_pred, mtgp, X_test, maximize=True, noiseless=True, device=device)
    print("next expensive measurement at x =", float(grid[int(acq.argmax())]))
    return rmse


if __name__ == "__main__":
    main()
