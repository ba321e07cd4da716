"""The JAX package's numbers for BASELINE config 4 at chip_smoke.py's cut.

Fits ``gpax_tpu.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)`` on
bench.py:471-600's data (320 low- and 64 high-fidelity points) with
bench.py's fit settings but chip_smoke.py's 200 + 200 draws, then prints
one JSON line: the fit's wall seconds, task 1's noiseless predictive RMSE
against f_hi on the 101-point grid (the reference for chip_smoke.py's
``MT_RMSE_MAX``), the mean accept probability, the divergences, the
leapfrogs, EI's argmax on the grid and the posterior means of the noise
and of W (whose sign tells the posterior's two modes apart).

Run from the repository root on the CPU:
``JAX_PLATFORMS=cpu PYTHONPATH=. python3 reference/config4_jax.py``.
``--seed S`` fits with ``jax.random.PRNGKey(S)`` instead of
``get_keys()[0]``; ``--x64`` runs the whole fit in float64 (data, gram and
factor), which tells the reference's float32 gradient noise apart from the
posterior's own geometry.
"""

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gpax_tpu  # noqa: E402
from gpax_tpu.acquisition import EI  # noqa: E402


def f_hi(x):
    return np.sin(5 * x) * np.exp(-x)


def f_lo(x):
    return 0.8 * f_hi(x) + 0.2 * np.cos(3 * x)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--x64", action="store_true")
    args = ap.parse_args()
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.x64 else jnp.float32
    rng = np.random.default_rng(0)
    n_lo, n_hi = 320, 64
    x_lo, x_hi = rng.uniform(0, 2, n_lo), rng.uniform(0, 2, n_hi)
    X = np.concatenate([np.column_stack([x_lo, np.zeros(n_lo)]),
                        np.column_stack([x_hi, np.ones(n_hi)])])
    y = np.concatenate([f_lo(x_lo), f_hi(x_hi)]) + 0.05 * rng.normal(size=n_lo + n_hi)
    key_fit, key_pred = gpax_tpu.utils.get_keys()
    if args.seed is not None:
        key_fit = jax.random.PRNGKey(args.seed)
    model = gpax_tpu.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    t0 = time.time()
    model.fit(key_fit, jnp.asarray(X, dtype), jnp.asarray(y, dtype),
              num_warmup=200, num_samples=200, segment_size=50, max_tree_depth=8,
              warmup_depth_cap=(5, 20), target_accept_prob=0.7, print_summary=False,
              progress_bar=False)
    fit_s = time.time() - t0
    grid = np.linspace(0, 2, 101)
    X_test = jnp.asarray(np.column_stack([grid, np.ones_like(grid)]), dtype)
    mean, _ = model.predict(key_pred, X_test, noiseless=True)
    stats = model.mcmc.get_extra_fields()
    acq = EI(key_pred, model, X_test, maximize=True, noiseless=True)
    print(json.dumps({
        "seed": args.seed, "x64": args.x64, "fit_s": fit_s,
        "step_size": float(np.asarray(stats["step_size"])[-1]),
        "rmse_task1": float(np.sqrt(np.mean((np.asarray(mean) - f_hi(grid)) ** 2))),
        "accept": float(np.asarray(stats["accept_prob"]).mean()),
        "divergences": int(np.asarray(stats["diverging"]).sum()),
        "leapfrogs": int(np.asarray(stats["segment_leapfrogs"]).sum()),
        "next_x": float(grid[int(np.asarray(acq).argmax())]),
        "noise": np.asarray(model.get_samples()["noise"]).mean(0).tolist(),
        "W": np.asarray(model.get_samples()["W"]).mean(0).ravel().tolist()}))


if __name__ == "__main__":
    main()
