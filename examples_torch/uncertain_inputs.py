"""Uncertain-input GP: jointly infer latent true inputs and the function, on gpax_torch.

The gpax_torch form of examples/uncertain_inputs.py (the reference's
gpax_UIGP.ipynb). ``main(device=None, nuts=None)`` runs on the CUDA card
unless ``device`` says otherwise; ``nuts`` is merged into the NUTS fit's
keywords. Set SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
BUDGET = dict(num_warmup=100, num_samples=100) if SMOKE else dict(num_warmup=1500, num_samples=1500)


def main(device=None, nuts=None):
    budget = {**BUDGET, **(nuts or {})}
    rng = np.random.default_rng(0)
    n = 14 if SMOKE else 60
    X_true = np.sort(rng.uniform(0, 1, n))
    X_obs = np.clip(X_true + 0.03 * rng.normal(size=n), 0, 1)  # noisy coordinates
    y = np.sin(6 * X_true)

    key_fit, key_pred = gpax_torch.utils.get_keys()
    model = gpax_torch.UIGP(input_dim=1, kernel="Matern",
                            sigma_x_prior_dist=gpax_torch.priors.halfnormal_dist(0.05))
    model.fit(key_fit, torch.tensor(X_obs, dtype=torch.float32),
              torch.tensor(y, dtype=torch.float32),
              print_summary=not SMOKE, progress_bar=False, device=device, **budget)

    s = model.get_samples()
    sigma_x = float(s["sigma_x"].mean())
    X_prime = s["X_prime"].cpu().numpy().mean(0)[:, 0]
    improve = np.abs(X_obs - X_true).mean() - np.abs(X_prime - X_true).mean()
    print(f"inferred input noise sd: {sigma_x:.4f} (truth 0.03)")
    print(f"latent-input recovery improvement: {improve:+.4f} (positive = better)")

    mean, sampled = model.predict(key_pred, torch.linspace(0, 1, 40), n=2, device=device)
    print("predictive mean finite:", bool(torch.isfinite(mean).all()))
    return sigma_x


if __name__ == "__main__":
    main()
