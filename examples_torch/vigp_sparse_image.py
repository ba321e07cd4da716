"""Sparse-image reconstruction with a variational GP, on gpax_torch.

The gpax_torch form of examples/vigp_sparse_image.py (the reference's
gpax_viGP.ipynb workflow): take an image with most pixels missing (zeros),
build GP training data from the measured pixels, fit viGP with SVI, and
reconstruct the full grid with batched prediction. ``main(device=None)``
runs on the CUDA card unless ``device`` says otherwise. Set SMOKE=1 for
tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch
from gpax_torch.utils import preprocess_sparse_image

SMOKE = bool(int(os.environ.get("SMOKE", "0")))


def main(device=None):
    rng = np.random.default_rng(0)
    size = 16 if SMOKE else 48
    xx, yy = np.meshgrid(np.arange(size), np.arange(size))
    truth = np.sin(xx / 6.0) * np.cos(yy / 8.0) + 1.5  # strictly positive
    mask = rng.uniform(size=truth.shape) < (0.3 if SMOKE else 0.15)
    sparse = np.where(mask, truth, 0.0)

    coords, values, full_grid = preprocess_sparse_image(sparse)
    print(f"measured {len(values)} / {truth.size} pixels")

    key_fit, key_pred = gpax_torch.utils.get_keys()
    model = gpax_torch.viGP(input_dim=2, kernel="Matern")
    model.fit(key_fit, torch.tensor(coords, dtype=torch.float32),
              torch.tensor(values, dtype=torch.float32),
              num_steps=200 if SMOKE else 2000,
              print_summary=not SMOKE, progress_bar=False, device=device)

    mean, var = model.predict_in_batches(
        key_pred, torch.tensor(full_grid, dtype=torch.float32), batch_size=256, device=device)
    recon = mean.cpu().numpy().reshape(truth.shape)
    rmse = float(np.sqrt(np.mean((recon - truth) ** 2)))
    print(f"reconstruction RMSE: {rmse:.4f} (image std {truth.std():.3f})")
    return rmse


if __name__ == "__main__":
    main()
