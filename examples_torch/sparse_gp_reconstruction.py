"""Large-grid reconstruction with an inducing-point sparse GP (VFE), on gpax_torch.

The gpax_torch form of examples/sparse_gp_reconstruction.py (BASELINE.md
config 3's workflow, "viSparseGP inducing-point large-grid hyperspectral
reconstruction"): many measured points, trainable inducing locations,
full-grid prediction. ``main(device=None)`` runs on the CUDA card unless
``device`` says otherwise. Set SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch

SMOKE = bool(int(os.environ.get("SMOKE", "0")))


def main(device=None):
    rng = np.random.default_rng(0)
    n = 60 if SMOKE else 2000
    X = rng.uniform(0, 4, n)
    y = np.sin(3 * X) * np.exp(-0.3 * X) + 0.05 * rng.normal(size=n)

    key_fit, key_pred = gpax_torch.utils.get_keys()
    model = gpax_torch.viSparseGP(input_dim=1, kernel="RBF")
    model.fit(key_fit, torch.tensor(X, dtype=torch.float32), torch.tensor(y, dtype=torch.float32),
              inducing_points_ratio=0.2 if SMOKE else 0.05,
              inducing_points_selection="uniform",
              num_steps=300 if SMOKE else 3000,
              print_summary=not SMOKE, progress_bar=False, device=device)
    print(f"{model.Xu.shape[0]} inducing points optimized for {n} observations")

    grid = torch.linspace(0, 4, 101 if SMOKE else 2001)
    mean, var = model.predict_in_batches(key_pred, grid, batch_size=512, device=device)
    truth = np.sin(3 * grid.numpy()) * np.exp(-0.3 * grid.numpy())
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - truth) ** 2)))
    print(f"grid reconstruction RMSE: {rmse:.4f} (noise level 0.05)")
    return rmse


if __name__ == "__main__":
    main()
