"""Posterior diagnostics (counterpart of ``gpax_tpu/infer/diagnostics.py``,
numpy code): split Gelman-Rubin R-hat, effective sample size, and a
``print_summary`` equivalent of numpyro.diagnostics. Tensors are copied to
the host first.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws, ...) -> (2*chains, draws//2, ...)"""
    c, n = x.shape[:2]
    half = n // 2
    x = x[:, : 2 * half]
    return x.reshape(c * 2, half, *x.shape[2:])


def gelman_rubin(x) -> np.ndarray:
    """Split R-hat.  Input shape (chains, draws, ...); returns (...)."""
    x = _np(x)
    x = _split_chains(x)
    m, n = x.shape[:2]
    chain_mean = x.mean(axis=1)
    chain_var = x.var(axis=1, ddof=1)
    between = n * chain_mean.var(axis=0, ddof=1)
    within = chain_var.mean(axis=0)
    var_hat = (n - 1) / n * within + between / n
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_hat / within)
    return rhat


split_gelman_rubin = gelman_rubin


def effective_sample_size(x) -> np.ndarray:
    """ESS via Geyer's initial monotone sequence on chain-averaged autocorrelation."""
    x = _np(x)
    x = _split_chains(x)
    m, n = x.shape[:2]
    flat = x.reshape(m, n, -1)
    ess_out = np.empty(flat.shape[-1])
    for j in range(flat.shape[-1]):
        chains = flat[:, :, j]
        # per-chain autocovariance via FFT
        centered = chains - chains.mean(axis=1, keepdims=True)
        size = 2 * n
        f = np.fft.rfft(centered, size, axis=1)
        acov = np.fft.irfft(f * np.conj(f), size, axis=1)[:, :n].real / n
        var_w = acov[:, 0].mean()
        if var_w == 0:
            ess_out[j] = 0.0
            continue
        mean_acov = acov.mean(axis=0)
        chain_var = chains.var(axis=1, ddof=1).mean()
        between = n * chains.mean(axis=1).var(ddof=1) if m > 1 else 0.0
        var_hat = (n - 1) / n * chain_var + between / n
        rho = 1.0 - (chain_var - mean_acov) / var_hat
        # Geyer initial positive + monotone sequence over pair sums
        pair_sum = 0.0
        prev = np.inf
        t = 0
        while t + 1 < n:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            pair = min(pair, prev)
            prev = pair
            pair_sum += pair
            t += 2
        tau = max(-1.0 + 2.0 * pair_sum, 1e-8)
        ess_out[j] = m * n / tau
    return ess_out.reshape(x.shape[2:]) if x.ndim > 2 else ess_out[0]


def summary(samples: Dict[str, torch.Tensor], prob: float = 0.9) -> Dict[str, Dict]:
    """Per-site posterior stats.  ``samples`` values have shape (chains, draws, ...)."""
    out = {}
    for name, arr in samples.items():
        a = _np(arr)
        flat = a.reshape(-1, *a.shape[2:])
        lo, hi = 50 * (1 - prob), 50 * (1 + prob)
        out[name] = {
            "mean": flat.mean(0),
            "std": flat.std(0),
            "median": np.median(flat, 0),
            f"{lo:.1f}%": np.percentile(flat, lo, axis=0),
            f"{hi:.1f}%": np.percentile(flat, hi, axis=0),
            "n_eff": effective_sample_size(a),
            "r_hat": gelman_rubin(a),
        }
    return out


def print_summary(samples: Dict[str, torch.Tensor], prob: float = 0.9) -> None:
    stats = summary(samples, prob)
    lo, hi = 50 * (1 - prob), 50 * (1 + prob)
    cols = ["mean", "std", "median", f"{lo:.1f}%", f"{hi:.1f}%", "n_eff", "r_hat"]
    name_w = max([len(n) for n in stats] + [7]) + 2
    header = " " * name_w + "".join(f"{c:>10}" for c in cols)
    print(header)
    for name, st in stats.items():
        vals = [np.atleast_1d(st[c]) for c in cols]
        k = vals[0].size
        for i in range(k):
            label = name if k == 1 else f"{name}[{i}]"
            row = f"{label:<{name_w}}" + "".join(
                f"{np.atleast_1d(v).reshape(-1)[i]:>10.2f}" for v in vals
            )
            print(row)
    print()
