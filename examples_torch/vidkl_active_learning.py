"""Deep-kernel-learning active learning on high-dimensional inputs, on gpax_torch.

The gpax_torch form of examples/vidkl_active_learning.py (the reference's
viDKL active-learning workflow, gpax_viDKL_plasmons.ipynb shape):
image-patch-like inputs, viDKL embedding to a 2-D latent space,
uncertainty-driven acquisition. ``main(device=None)`` runs on the CUDA card
unless ``device`` says otherwise. Set SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch

SMOKE = bool(int(os.environ.get("SMOKE", "0")))


def main(device=None):
    rng = np.random.default_rng(0)
    n_pool, d = (40, 16) if SMOKE else (400, 64)
    # latent 2-D structure embedded in d dims
    latent = rng.normal(size=(n_pool, 2))
    mix = rng.normal(size=(2, d)) / np.sqrt(2)
    X_pool = torch.tensor(latent @ mix + 0.01 * rng.normal(size=(n_pool, d)),
                          dtype=torch.float32)
    y_pool = torch.tensor(np.sin(latent[:, 0] * 2.0) + 0.3 * latent[:, 1],
                          dtype=torch.float32)

    measured = list(rng.choice(n_pool, size=8, replace=False))
    key_fit, key_pred = gpax_torch.utils.get_keys()

    steps = 2 if SMOKE else 10
    for it in range(steps):
        unmeasured = [i for i in range(n_pool) if i not in measured]
        dkl = gpax_torch.viDKL(input_dim=d, z_dim=2, kernel="RBF")
        dkl.fit(key_fit, X_pool[measured], y_pool[measured],
                num_steps=100 if SMOKE else 1000,
                print_summary=False, progress_bar=False, device=device)
        mean, var = dkl.predict(key_pred, X_pool[unmeasured], device=device)
        nxt = unmeasured[int(torch.argmax(var))]
        measured.append(nxt)
        rmse = float(torch.sqrt(torch.mean((mean - y_pool[unmeasured].to(mean.device)) ** 2)))
        print(f"AL step {it:02d}: pool RMSE {rmse:.4f}, acquired point {nxt}")

    z = dkl.embed(X_pool, device=device)
    print("latent embedding:", tuple(z.shape))
    return rmse


if __name__ == "__main__":
    main()
