"""Heteroskedastic GP: infer input-dependent noise with a latent noise GP, on gpax_torch.

The gpax_torch form of examples/heteroskedastic_gp.py (the reference's
heteroskedasticGP.ipynb). ``main(device=None, nuts=None)`` runs on the CUDA
card unless ``device`` says otherwise; ``nuts`` is merged into the NUTS
fit's keywords. NUTS builds deep trees on this model (~900 leapfrogs a draw
at the default depth of 10), so the full budget takes a while. Set SMOKE=1
for tiny budgets.
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
    n = 16 if SMOKE else 80
    X = np.sort(rng.uniform(-1, 1, n))
    noise_sd = 0.05 + 0.4 * (X + 1) / 2          # noise grows left -> right
    y = np.sin(4 * X) + noise_sd * rng.normal(size=n)

    key_fit, key_pred = gpax_torch.utils.get_keys()
    model = gpax_torch.VarNoiseGP(input_dim=1, kernel="RBF", noise_kernel="RBF")
    model.fit(key_fit, torch.tensor(X, dtype=torch.float32), torch.tensor(y, dtype=torch.float32),
              print_summary=not SMOKE, progress_bar=False, device=device, **budget)

    # inferred per-point training noise should increase along x
    var_samples = model.get_data_var_samples()
    inferred_sd = np.sqrt(var_samples.cpu().numpy().mean(0))
    left, right = inferred_sd[: n // 4].mean(), inferred_sd[-n // 4:].mean()
    print(f"inferred noise sd: left {left:.3f} vs right {right:.3f} "
          f"(truth {noise_sd[:n//4].mean():.3f} vs {noise_sd[-n//4:].mean():.3f})")

    mean, sampled = model.predict(key_pred, torch.linspace(-1, 1, 50), device=device)
    print("predictive mean finite:", bool(torch.isfinite(mean).all()))
    return left, right


if __name__ == "__main__":
    main()
