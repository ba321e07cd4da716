"""Model comparison on one dataset, on gpax_torch: ExactGP (Matern) vs iBNN
(NNGP kernel) vs fully-Bayesian DKL.

The gpax_torch form of examples/compare_gps.py (the reference's
compare_GPs.ipynb): fit several GP flavors to the same sparse noisy
observations and compare predictive RMSE and negative log predictive
density on held-out points. ``main(device=None, nuts=None)`` runs on the
CUDA card unless ``device`` says otherwise; ``nuts`` is merged into every
NUTS fit's keywords. Set SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
BUDGET = (dict(num_warmup=50, num_samples=50) if SMOKE
          else dict(num_warmup=1000, num_samples=1000))


def nlpd(mean, var, y):
    var = np.clip(var, 1e-6, None)
    return float(np.mean(0.5 * np.log(2 * np.pi * var) + 0.5 * (y - mean) ** 2 / var))


def main(device=None, nuts=None):
    budget = {**BUDGET, **(nuts or {})}
    rng = np.random.default_rng(1)
    n = 16 if SMOKE else 60
    f = lambda x: np.sign(x) * 0.6 + 0.3 * np.sin(4 * x)  # noqa: E731  (discontinuous target)
    X = np.sort(rng.uniform(-1.5, 1.5, n))
    y = f(X) + 0.1 * rng.normal(size=n)
    X_test = np.linspace(-1.4, 1.4, 81)
    y_test = f(X_test)
    X, y, X_new = (torch.tensor(a, dtype=torch.float32) for a in (X, y, X_test))

    key_fit, key_pred = gpax_torch.utils.get_keys()
    results = {}

    gp = gpax_torch.ExactGP(1, "Matern")
    gp.fit(key_fit, X, y, progress_bar=False, print_summary=False, device=device, **budget)
    mean, var = gp.predict_moments(key_pred, X_new, noiseless=True, device=device)
    mean, var = mean.cpu().numpy(), var.cpu().numpy()
    results["ExactGP-Matern"] = (float(np.sqrt(np.mean((mean - y_test) ** 2))),
                                 nlpd(mean, var, y_test))

    ibnn = gpax_torch.iBNN(1, depth=3)
    ibnn.fit(key_fit, X, y, progress_bar=False, print_summary=False, device=device, **budget)
    mean_i, samples_i = ibnn.predict(key_pred, X_new, noiseless=True, device=device)
    mean_i = mean_i.cpu().numpy()
    flat = samples_i.cpu().numpy().reshape(-1, X_test.shape[0])
    results["iBNN"] = (float(np.sqrt(np.mean((mean_i - y_test) ** 2))),
                       nlpd(mean_i, flat.var(0), y_test))

    dkl = gpax_torch.DKL(1, z_dim=2, kernel="RBF", hidden_dim=[8, 8] if SMOKE else [32, 16])
    dkl.fit(key_fit, X, y, progress_bar=False, print_summary=False, device=device, **budget)
    mean_d, samples_d = dkl.predict(key_pred, X_new, noiseless=True, device=device)
    mean_d = mean_d.cpu().numpy()
    flat_d = samples_d.cpu().numpy().reshape(-1, X_test.shape[0])
    results["DKL"] = (float(np.sqrt(np.mean((mean_d - y_test) ** 2))),
                      nlpd(mean_d, flat_d.var(0), y_test))

    print(f"{'model':<16} {'RMSE':>8} {'NLPD':>8}")
    for name, (rmse, nl) in results.items():
        print(f"{name:<16} {rmse:>8.4f} {nl:>8.3f}")
    best = min(results, key=lambda k: results[k][0])
    print(f"best RMSE: {best}")
    return results


if __name__ == "__main__":
    main()
