"""The JAX package's numbers for BASELINE config 5 at chip_smoke.py's size.

Runs ``gpax_tpu.viDKL(784, z_dim=2, kernel="RBF").fit_predict`` on
bench.py:603-658's data (a pool of 2000 points in d = 784 from
``np.random.default_rng(0)``, 256 of them measured) with bench.py's settings
(8 models, "vectorized", 1000 SVI steps), with ``get_keys()[0]`` and
``jax.random.PRNGKey(7)``, the two keys of bench.py, and then with
``PRNGKey(1)`` … ``PRNGKey(6)``, and prints one JSON line: per key the wall
seconds, the pool RMSE of the ensemble mean against ``y_pool`` and each
model's pool RMSE; then the median and the largest ensemble RMSE over the
keys; and, per key, how many models stay at the targets' mean (pool RMSE
above ``STALLED_RMSE``), the median RMSE of the others and the best
model's RMSE, with the largest of each over the keys (and the median of
the learned models pooled over all keys). The spread over keys is wide (a
model whose first embedding is saturated stays at the targets' mean, RMSE
~0.74), so chip_smoke.py holds its own ensembles to 1.5 times the largest
ensemble RMSE, to the largest count of stalled models, and to 1.5 times
the largest learned median and best model.

Run from the repository root on the CPU:
``JAX_PLATFORMS=cpu PYTHONPATH=. python3 reference/config5_jax.py``.
"""

import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gpax_tpu  # noqa: E402

STALLED_RMSE = 0.5  # the targets' mean scores ~0.77, a learned model < 0.1


def config5_data():
    """bench.py:618-625: the pool, its targets and the measured indices."""
    rng = np.random.default_rng(0)
    n_pool, d = 2000, 784
    latent = rng.normal(size=(n_pool, 2))
    mix = rng.normal(size=(2, d)) / np.sqrt(2)
    X_pool = latent @ mix + 0.01 * rng.normal(size=(n_pool, d))
    y_pool = np.sin(latent[:, 0] * 2.0) + 0.3 * latent[:, 1]
    measured = rng.choice(n_pool, size=256, replace=False)
    return X_pool, y_pool, measured


def main() -> None:
    X_pool, y_pool, measured = config5_data()
    X = jnp.asarray(X_pool[measured], jnp.float32)
    y = jnp.asarray(y_pool[measured], jnp.float32)
    X_new = jnp.asarray(X_pool, jnp.float32)
    out = {}
    keys = [("get_keys()[0]", gpax_tpu.utils.get_keys()[0]), ("PRNGKey(7)", jax.random.PRNGKey(7))]
    keys += [(f"PRNGKey({s})", jax.random.PRNGKey(s)) for s in range(1, 7)]
    for label, key in keys:
        model = gpax_tpu.viDKL(input_dim=784, z_dim=2, kernel="RBF")
        t0 = time.time()
        mean, var = model.fit_predict(key, X, y, X_new, num_steps=1000, n_models=8,
                                      ensemble_method="vectorized", print_summary=False,
                                      progress_bar=False)
        mean, var = np.asarray(mean), np.asarray(var)
        seconds = time.time() - t0
        out[label] = {
            "seconds": seconds,
            "pool_rmse": float(np.sqrt(np.mean((mean.mean(0) - y_pool) ** 2))),
            "model_rmse": np.sqrt(np.mean((mean - y_pool) ** 2, axis=1)).tolist(),
            "finite": bool(np.isfinite(mean).all() and np.isfinite(var).all()),
        }
    rmse = [v["pool_rmse"] for v in out.values()]
    models = [np.asarray(v["model_rmse"]) for v in out.values()]
    learned = [m[m <= STALLED_RMSE] for m in models]
    print(json.dumps({"runs": out, "pool_rmse_median": float(np.median(rmse)),
                      "pool_rmse_max": float(np.max(rmse)),
                      "stalled": [int((m > STALLED_RMSE).sum()) for m in models],
                      "learned_median": [float(np.median(m)) for m in learned],
                      "best": [float(m.min()) for m in models],
                      "learned_median_pooled": float(np.median(np.concatenate(learned)))}))


if __name__ == "__main__":
    main()
