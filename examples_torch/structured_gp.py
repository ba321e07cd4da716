"""Structured (physics-informed mean function) GP vs plain GP, on gpax_torch.

The gpax_torch form of examples/structured_gp.py (the reference's
GP_sGP.ipynb): a GP whose prior mean is a parametric physical model (here a
damped oscillator with unknown amplitude / decay) extrapolates far better
than a zero-mean GP, while the GP part absorbs model misspecification.
``main(device=None, nuts=None)`` runs on the CUDA card unless ``device``
says otherwise; ``nuts`` is merged into every NUTS fit's keywords. Set
SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch
from gpax_torch import distributions as dist
from gpax_torch import ppl

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
BUDGET = (dict(num_warmup=50, num_samples=50) if SMOKE
          else dict(num_warmup=1000, num_samples=1000))


def oscillator(x, params):
    """Parametric hypothesis: A·sin(w·x)·exp(−d·x)."""
    return (params["A"] * torch.sin(params["w"] * x)
            * torch.exp(-params["d"] * x)).squeeze()


def oscillator_prior():
    return {
        "A": ppl.sample("A", dist.LogNormal(0.0, 0.5)),
        "w": ppl.sample("w", dist.Uniform(3.0, 7.0)),
        "d": ppl.sample("d", dist.LogNormal(0.0, 0.5)),
    }


def main(device=None, nuts=None):
    budget = {**BUDGET, **(nuts or {})}
    rng = np.random.default_rng(0)
    truth = lambda x: 1.2 * np.sin(5.0 * x) * np.exp(-0.8 * x)  # noqa: E731
    n = 12 if SMOKE else 30
    # observe only the first half of the domain; extrapolate the rest
    X = np.sort(rng.uniform(0.0, 1.2, n))
    y = truth(X) + 0.05 * rng.normal(size=n)
    X_test = np.linspace(0.0, 2.4, 97)
    X, y, X_new = (torch.tensor(a, dtype=torch.float32) for a in (X, y, X_test))

    key_fit, key_pred = gpax_torch.utils.get_keys()

    sgp = gpax_torch.ExactGP(1, "Matern", mean_fn=oscillator, mean_fn_prior=oscillator_prior)
    sgp.fit(key_fit, X, y, progress_bar=False, print_summary=False, device=device, **budget)
    mean_s, _ = sgp.predict(key_pred, X_new, noiseless=True, device=device)

    gp = gpax_torch.ExactGP(1, "Matern")
    gp.fit(key_fit, X, y, progress_bar=False, print_summary=False, device=device, **budget)
    mean_p, _ = gp.predict(key_pred, X_new, noiseless=True, device=device)

    extrap = X_test > 1.2
    rmse_s = float(np.sqrt(np.mean((mean_s.cpu().numpy()[extrap] - truth(X_test[extrap])) ** 2)))
    rmse_p = float(np.sqrt(np.mean((mean_p.cpu().numpy()[extrap] - truth(X_test[extrap])) ** 2)))
    print(f"extrapolation RMSE  structured-GP: {rmse_s:.4f}   plain GP: {rmse_p:.4f}")
    if not SMOKE:
        assert rmse_s < rmse_p, "structured mean should extrapolate better"
    return rmse_s, rmse_p


if __name__ == "__main__":
    main()
