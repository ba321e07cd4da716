"""The golden workflows of the bundled examples, on gpax_torch.

The port's form of the statistical gates of tests/test_examples.py:55-188
(BASELINE.md's parity gate on the example notebooks): the simpleGP,
viGP sparse-image, viSparseGP reconstruction, MultiTaskGP BO and viDKL
active-learning workflows, with the JAX test's data, sizes, budgets, NUTS
tree depth (the default of 10) and bands. Each workflow runs on ``device``
(None: the CUDA card) and returns its gates as ``{name: (value, passed,
band)}``. Not a script: tests/test_torch_examples_golden*.py run these
workflows on the CPU and chip_smoke.py on the card, both loading this file
with ``runpy.run_path``.
"""

import numpy as np
import torch

import gpax_torch
from gpax_torch.acquisition import EI
from gpax_torch.utils import get_keys, preprocess_sparse_image

FIT = dict(print_summary=False, progress_bar=False)


def f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)))


def simple_gp_data():
    """48 points of sin(2x) + N(0, 0.1²) on [-2, 2], and the 101-point test
    grid with its truth."""
    rng = np.random.default_rng(1)
    X = np.sort(rng.uniform(-2, 2, 48))
    f = lambda x: np.sin(2 * x)  # noqa: E731
    y = f(X) + 0.1 * rng.normal(size=X.shape)
    X_test = np.linspace(-2, 2, 101)
    return X, y, X_test, f(X_test)


def simple_gp_fit(device=None):
    """The simpleGP fit: ExactGP RBF, 200 + 200 draws."""
    X, y, _, _ = simple_gp_data()
    gp = gpax_torch.ExactGP(1, "RBF")
    gp.fit(get_keys()[0], f32(X), f32(y), num_warmup=200, num_samples=200, device=device, **FIT)
    return gp


def simple_gp_gates(gp, device=None) -> dict:
    """The posterior predictive recovers sin(2x), the noise posterior
    concentrates near the generating sd (0.1; the site is a variance), and
    the central ~95 % intervals cover the truth at a sane rate."""
    _, _, X_test, truth = simple_gp_data()
    mean, var = gp.predict_moments(get_keys()[1], f32(X_test)[:, None], noiseless=True,
                                   device=device)
    mean, sd = mean.cpu().numpy(), np.sqrt(var.cpu().numpy())
    rmse = _rmse(mean, truth)
    noise = float(gp.get_samples()["noise"].cpu().numpy().mean())
    ls = float(gp.get_samples()["k_length"].cpu().numpy().mean())
    inside = float(np.mean(np.abs(mean - truth) < 2.0 * sd))
    return {"rmse": (rmse, rmse < 0.12, "< 0.12"),
            "noise_mean": (noise, 0.004 < noise < 0.05, "(0.004, 0.05)"),
            "k_length_mean": (ls, 0.2 < ls < 3.0, "(0.2, 3.0)"),
            "coverage": (inside, 0.75 <= inside <= 1.0, "[0.75, 1.0]")}


def vigp_sparse_image(device=None) -> dict:
    """A 24×24 image, 25 % of its pixels measured, viGP Matérn, 600 steps;
    reconstruction RMSE < 0.08."""
    rng = np.random.default_rng(0)
    size = 24
    xx, yy = np.meshgrid(np.arange(size), np.arange(size))
    truth = np.sin(xx / 4.0) * np.cos(yy / 5.0) + 1.5
    mask = rng.uniform(size=truth.shape) < 0.25
    coords, values, full_grid = preprocess_sparse_image(np.where(mask, truth, 0.0))
    model = gpax_torch.viGP(input_dim=2, kernel="Matern")
    model.fit(get_keys()[0], f32(coords), f32(values), num_steps=600, device=device, **FIT)
    mean, _ = model.predict(get_keys()[1], f32(full_grid), device=device)
    rmse = _rmse(mean.cpu().numpy().reshape(truth.shape), truth)
    return {"rmse": (rmse, rmse < 0.08, "< 0.08")}


def visparsegp_reconstruction(device=None) -> dict:
    """400 points of sin(3x)·exp(−0.3x) + N(0, 0.05²), viSparseGP RBF with
    inducing ratio 0.1, 800 steps; RMSE on 201 grid points < 0.08."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 4, 400)
    f = lambda x: np.sin(3 * x) * np.exp(-0.3 * x)  # noqa: E731
    y = f(X) + 0.05 * rng.normal(size=X.shape)
    model = gpax_torch.viSparseGP(input_dim=1, kernel="RBF")
    model.fit(get_keys()[0], f32(X), f32(y), inducing_points_ratio=0.1, num_steps=800,
              device=device, **FIT)
    grid = np.linspace(0, 4, 201)
    mean, _ = model.predict(get_keys()[1], f32(grid), device=device)
    rmse = _rmse(mean.cpu().numpy(), f(grid))
    return {"rmse": (rmse, rmse < 0.08, "< 0.08")}


def mtgp_bo_step(device=None) -> dict:
    """MultiTaskGP (Matérn, one latent, two fidelities; 400 + 400 draws at
    target accept 0.7): RMSE < 0.25 on the high-fidelity task, and EI's
    argmax in [0, 0.9] (the optimum is x* ≈ 0.298; the band covers the
    seeds' spread over it and an unexplored high-value region)."""
    def f_hi(x):
        return np.sin(5 * x) * np.exp(-x)

    def f_lo(x):
        return 0.8 * f_hi(x) + 0.2 * np.cos(3 * x)

    rng = np.random.default_rng(0)
    X_lo, X_hi = rng.uniform(0, 2, 32), rng.uniform(0, 2, 10)
    X = np.concatenate([np.column_stack([X_lo, np.zeros(32)]),
                        np.column_stack([X_hi, np.ones(10)])])
    y = np.concatenate([f_lo(X_lo), f_hi(X_hi)]) + 0.05 * rng.normal(size=42)
    mtgp = gpax_torch.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    mtgp.fit(get_keys()[0], f32(X), f32(y), num_warmup=400, num_samples=400,
             target_accept_prob=0.7, device=device, **FIT)
    grid = np.linspace(0, 2, 51)
    X_test = f32(np.column_stack([grid, np.ones_like(grid)]))
    mean, _ = mtgp.predict_in_batches(get_keys()[1], X_test, batch_size=64, device=device)
    rmse = _rmse(mean.cpu().numpy(), f_hi(grid))
    acq = EI(get_keys()[1], mtgp, X_test, maximize=True, noiseless=True, device=device)
    next_x = float(grid[int(acq.argmax())])
    return {"rmse": (rmse, rmse < 0.25, "< 0.25"),
            "ei_argmax_x": (next_x, 0.0 <= next_x <= 0.9, "[0.0, 0.9]")}


def vidkl_active_learning(device=None) -> dict:
    """A pool of 200 points in d = 32 on a 2-D latent, 48 measured, viDKL
    (z_dim 2) 600 steps: pool RMSE < 0.45, a finite (200, 2) embedding, and
    at least 3 of the 5 largest predictive variances on unmeasured points
    (the measured points' variance is suppressed)."""
    rng = np.random.default_rng(0)
    n_pool, d = 200, 32
    latent = rng.normal(size=(n_pool, 2))
    mix = rng.normal(size=(2, d)) / np.sqrt(2)
    X_pool = latent @ mix
    y_pool = np.sin(latent[:, 0] * 2.0) + 0.3 * latent[:, 1]
    measured = rng.choice(n_pool, size=48, replace=False)
    dkl = gpax_torch.viDKL(input_dim=d, z_dim=2, kernel="RBF")
    dkl.fit(get_keys()[0], f32(X_pool[measured]), f32(y_pool[measured]), num_steps=600,
            device=device, **FIT)
    mean, var = dkl.predict(get_keys()[1], f32(X_pool), device=device)
    rmse = _rmse(mean.cpu().numpy(), y_pool)
    z = dkl.embed(f32(X_pool), device=device)
    embedded = tuple(z.shape) == (n_pool, 2) and bool(torch.isfinite(z).all())
    top5 = set(int(i) for i in np.argsort(-var.cpu().numpy())[:5])
    unmeasured = len(top5 - set(int(i) for i in measured))
    return {"rmse": (rmse, rmse < 0.45, "< 0.45"),
            "embedding": (list(z.shape), embedded, "(200, 2), finite"),
            "unmeasured_in_top5": (unmeasured, unmeasured >= 3, ">= 3")}
