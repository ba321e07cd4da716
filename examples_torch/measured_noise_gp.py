"""GP regression with measured (per-point) noise variances, on gpax_torch.

The gpax_torch form of examples/measured_noise_gp.py (the reference's
MeasuredNoiseGP.ipynb). ``main(device=None, nuts=None)`` runs on the CUDA
card unless ``device`` says otherwise; ``nuts``'s ``num_warmup`` and
``num_samples`` are merged into the NUTS fit's budget (MeasuredNoiseGP.fit
takes no other sampler option: it runs at the JAX package's fixed tree
depth of 10). Set SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
BUDGET = dict(num_warmup=100, num_samples=100) if SMOKE else dict(num_warmup=1500, num_samples=1500)


def main(device=None, nuts=None):
    budget = {**BUDGET, **{k: v for k, v in (nuts or {}).items() if k in BUDGET}}
    rng = np.random.default_rng(0)
    n = 14 if SMOKE else 50
    X = np.sort(rng.uniform(-1, 1, n))
    # each point was measured repeatedly: mean + known variance of the mean
    repeats = rng.integers(3, 20, n)
    true_sd = 0.3
    y_mean = np.sin(3 * X) + true_sd / np.sqrt(repeats) * rng.normal(size=n)
    measured_var = true_sd**2 / repeats

    key_fit, key_pred = gpax_torch.utils.get_keys()
    model = gpax_torch.MeasuredNoiseGP(input_dim=1, kernel="Matern")
    model.fit(key_fit, torch.tensor(X, dtype=torch.float32),
              torch.tensor(y_mean, dtype=torch.float32),
              torch.tensor(measured_var, dtype=torch.float32),
              print_summary=not SMOKE, progress_bar=False, device=device, **budget)

    grid = torch.linspace(-1, 1, 41)
    mean, sampled = model.predict(key_pred, grid, n=2, noise_prediction_method="linreg",
                                  device=device)
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - np.sin(3 * grid.numpy())) ** 2)))
    print(f"RMSE vs truth: {rmse:.4f}")
    print("sampled predictions:", tuple(sampled.shape))
    return rmse


if __name__ == "__main__":
    main()
