"""Fully-Bayesian GP regression on sparse noisy 1-D data, on gpax_torch.

The gpax_torch form of examples/simple_gp.py (the reference's
gpax_simpleGP.ipynb): fit ExactGP with NUTS, predict with uncertainty,
sample from the prior. ``main(device=None, nuts=None)`` runs on the CUDA
card unless ``device`` says otherwise; ``nuts`` is merged into the NUTS
fit's keywords (``num_warmup``, ``num_samples``, ``max_tree_depth``).
Set SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
BUDGET = dict(num_warmup=100, num_samples=100) if SMOKE else dict(num_warmup=2000, num_samples=2000)


def main(device=None, nuts=None):
    budget = {**BUDGET, **(nuts or {})}
    rng = np.random.default_rng(0)
    n = 12 if SMOKE else 50
    X = rng.uniform(-2.0, 2.0, n)
    f = lambda x: np.sin(2.5 * x) * np.exp(-0.2 * x**2)  # noqa: E731
    y = f(X) + 0.1 * rng.normal(size=n)
    X = torch.tensor(X, dtype=torch.float32)
    y = torch.tensor(y, dtype=torch.float32)

    key_fit, key_pred = gpax_torch.utils.get_keys()
    gp = gpax_torch.ExactGP(input_dim=1, kernel="Matern")

    # prior predictive sanity check
    prior_draws = gp.sample_from_prior(key_fit, X, num_samples=4, device=device)
    print("prior draws:", tuple(prior_draws.shape))

    gp.fit(key_fit, X, y, progress_bar=False, print_summary=not SMOKE, device=device, **budget)

    X_test = torch.linspace(-2.5, 2.5, 101)
    y_pred, y_samples = gp.predict(key_pred, X_test, noiseless=True, device=device)
    truth = f(X_test.numpy())
    lo, hi = np.percentile(y_samples.cpu().numpy().reshape(-1, 101), [2.5, 97.5], axis=0)
    rmse = float(torch.sqrt(torch.mean((y_pred - torch.tensor(truth, device=y_pred.device)) ** 2)))
    cover = float(np.mean((truth > lo) & (truth < hi)))
    print(f"RMSE vs truth: {rmse:.4f}; 95% interval coverage: {cover:.2f}")
    return rmse


if __name__ == "__main__":
    main()
