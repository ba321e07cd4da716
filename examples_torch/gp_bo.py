"""Bayesian optimization loop with ExactGP + acquisition functions, on gpax_torch.

The gpax_torch form of examples/gp_bo.py (the reference's gpax_GPBO.ipynb):
iterate fit -> acquire -> measure on a 1-D objective with UCB and the
'delta' revisit penalty. ``main(device=None, nuts=None)`` runs on the CUDA
card unless ``device`` says otherwise; ``nuts`` is merged into every NUTS
fit's keywords. Set SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch
from gpax_torch.acquisition import UCB

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
BUDGET = dict(num_warmup=150, num_samples=150) if SMOKE else dict(num_warmup=1000, num_samples=1000)


def objective(x):
    """Forrester-like multimodal function (minimize)."""
    return np.sin(6 * x) + 0.6 * (x - 0.4) ** 2


def main(device=None, nuts=None):
    budget = {**BUDGET, **(nuts or {})}
    rng = np.random.default_rng(1)
    X_obs = list(rng.uniform(0, 1, 3))
    y_obs = [float(objective(x)) for x in X_obs]
    X_cand = torch.linspace(0, 1, 201)
    key_fit, key_pred = gpax_torch.utils.get_keys()

    iters = 4 if SMOKE else 12
    for it in range(iters):
        gp = gpax_torch.ExactGP(1, "Matern")
        gp.fit(key_fit, torch.tensor(X_obs, dtype=torch.float32),
               torch.tensor(y_obs, dtype=torch.float32),
               print_summary=False, progress_bar=False, device=device, **budget)
        acq = UCB(key_pred, gp, X_cand, beta=4.0, maximize=False, noiseless=True,
                  penalty="delta", recent_points=np.asarray(X_obs[-2:])[:, None],
                  device=device)
        x_next = float(X_cand[int(acq.nan_to_num(nan=-torch.inf).argmax())])
        X_obs.append(x_next)
        y_obs.append(float(objective(x_next)))
        print(f"iter {it:02d}: x_next={x_next:.3f}  f={y_obs[-1]:+.4f}  "
              f"best={min(y_obs):+.4f}")

    x_best = X_obs[int(np.argmin(y_obs))]
    print(f"best x: {x_best:.3f}, best f: {min(y_obs):.4f}")
    return x_best


if __name__ == "__main__":
    main()
