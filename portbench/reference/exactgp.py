"""Plain reference of the fully Bayesian exact GP (the reference gpax's
``ExactGP``, ``gpax/models/gp.py:166-220``) and its data.

Plain PyTorch, TF32 off (``tf32_products`` turns it on for the scoring
control), one matrix at a time. It imports nothing of the program: it takes
the data the harness makes and, only to judge them, the program's outputs
(posterior draws, their potentials and gradients, EI values).

Scoring (``ei``): the exact moments of the posterior's predictive mixture
over a set of draws, and expected improvement from them, σ = √max(var, 0).

The model, as the configuration file states it: k_length, k_scale and noise
each LogNormal(0, 1); K = k_scale·exp(−½‖(x − x')/ℓ‖²) + (noise + jitter +
base_reg)·I, where ``base_reg`` is the θ-independent 4·n·eps(float32) that
the program adds to every float32 gram before its factor (a departure of the
port and of the JAX package from the reference gpax, kept here because it is
part of the density the sampler targets). NUTS runs in the log space of the
three sites, so U(z) = −log p(y, e^z) − Σz.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
SITES = ("k_length", "k_scale", "noise")


def make_data(cfg: Dict, seed: int):
    """Config 1's data (``bench.py:180-184``), seeded: X ~ U(−2, 2) of (n, 1)
    and y = sin(2x) + 0.1·ε, float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    n = cfg["n"]
    X = rng.uniform(-2, 2, (n, cfg["input_dim"]))
    y = np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


def gram(X: torch.Tensor, Z: torch.Tensor, k_length, k_scale, kind: str = "rbf"):
    """k_scale·map(‖(x − z)/ℓ‖²) from the differences themselves."""
    d = (X[:, None, :] - Z[None, :, :]) / k_length
    r2 = (d * d).sum(-1)
    if kind == "rbf":
        return k_scale * torch.exp(-0.5 * r2)
    s5r = math.sqrt(5.0) * torch.sqrt(torch.clamp(r2, min=1e-10))
    return k_scale * (1.0 + s5r + (5.0 / 3.0) * r2) * torch.exp(-s5r)


def diag_shift(cfg: Dict) -> float:
    """jitter + the base regularization 4·n·eps(float32) on the diagonal."""
    return cfg["jitter"] + 4.0 * cfg["n"] * float(np.finfo(np.float32).eps)


def log_lik(X, y, theta: Dict, cfg: Dict, dtype=torch.float64):
    """log N(y | 0, K) for one draw θ (floats), in ``dtype``."""
    Xd, yd = X.to(dtype), y.to(dtype)
    K = gram(Xd, Xd, float(theta["k_length"]), float(theta["k_scale"]), cfg["kernel"])
    K.diagonal().add_(float(theta["noise"]) + diag_shift(cfg))
    L = torch.linalg.cholesky(K)
    alpha = torch.linalg.solve_triangular(L, yd[:, None], upper=False)[:, 0]
    n = X.shape[0]
    return -0.5 * (alpha @ alpha + n * LOG_2PI) - torch.log(L.diagonal()).sum()


def potential(X, y, theta: Dict, cfg: Dict, dtype=torch.float64):
    """U(z) at the constrained draw θ: −log p(y, θ) − Σ log θ, the LogNormal(0,
    1) priors' terms written out: Σ(½ log 2π + ½ z²) − log N(y | 0, K)."""
    z = torch.log(torch.tensor([float(theta[s]) for s in SITES], dtype=torch.float64))
    prior = float((0.5 * LOG_2PI + 0.5 * z * z).sum())
    return prior - float(log_lik(X, y, theta, cfg, dtype))


def potential_z(X, y, z: torch.Tensor, cfg: Dict):
    """U at the unconstrained point z (3,), differentiable, float64."""
    ls, ks, nz = torch.exp(z)
    Xd, yd = X.to(torch.float64), y.to(torch.float64)
    K = gram(Xd, Xd, ls, ks, cfg["kernel"])
    K = K + (nz + diag_shift(cfg)) * torch.eye(X.shape[0], dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky(K)
    alpha = torch.linalg.solve_triangular(L, yd[:, None], upper=False)[:, 0]
    ll = -0.5 * (alpha @ alpha + X.shape[0] * LOG_2PI) - torch.log(L.diagonal()).sum()
    return (0.5 * LOG_2PI + 0.5 * z * z).sum() - ll


def potential_grad(X, y, theta: Dict, cfg: Dict) -> np.ndarray:
    """∂U/∂z at the constrained draw θ (z = log θ), by autograd, float64."""
    z = torch.log(torch.tensor([float(theta[s]) for s in SITES], dtype=torch.float64,
                               device=X.device)).requires_grad_(True)
    (g,) = torch.autograd.grad(potential_z(X, y, z, cfg), z)
    return g.detach().cpu().numpy()


def posterior_mode(X, y, cfg: Dict, start: Dict, iters: int = 40) -> float:
    """The least U, by Newton steps in the log space from ``start`` (a
    constrained point; the configuration's posterior centre), each step
    halved until U falls."""
    z = torch.log(torch.tensor([float(start[s]) for s in SITES], dtype=torch.float64,
                               device=X.device))
    u = float(potential_z(X, y, z, cfg))
    for _ in range(iters):
        zr = z.clone().requires_grad_(True)
        g = torch.autograd.grad(potential_z(X, y, zr, cfg), zr, create_graph=True)[0]
        H = torch.stack([torch.autograd.grad(g[i], zr, retain_graph=True)[0] for i in range(3)])
        g, H = g.detach(), H.detach()
        ev, V = torch.linalg.eigh(H)
        step = -(V @ ((V.T @ g) / torch.clamp(ev.abs(), min=1e-6)))
        t = 1.0
        while t > 1e-6:
            z_new = z + t * step
            u_new = float(potential_z(X, y, z_new, cfg))
            if u_new < u:
                break
            t *= 0.5
        if t <= 1e-6 or u - u_new < 1e-9:
            break
        z, u = z_new, u_new
    return u


def draws_around(centre: Dict, log_sd: float, count: int, seed: int) -> Dict[str, np.ndarray]:
    """``count`` posterior-like draws, log-normal about ``centre``, float32,
    in the shapes the program's samples have ((S, 1) lengthscales)."""
    rng = np.random.default_rng([seed, 4])
    out = {s: np.exp(np.log(centre[s]) + log_sd * rng.normal(size=count)) for s in SITES}
    out["k_length"] = out["k_length"][:, None]
    return {k: v.astype(np.float32) for k, v in out.items()}


def new_grid(size: int, lo: float, hi: float, generator: torch.Generator, device):
    """``size`` candidates uniform on [lo, hi), (size, 1) float32, drawn on
    ``device``."""
    u = torch.rand((size, 1), generator=generator, device=device)
    return lo + (hi - lo) * u


@contextlib.contextmanager
def tf32_products():
    """Matmuls in TF32 (10-bit mantissa), the step below float32 with TF32
    off."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def predictive_moments(X, y, Xn, draws: Dict, cfg: Dict, factor=torch.float64,
                       products=torch.float64):
    """Mean and variance of the predictive mixture over the draws at Xn:
    E_s[mean_s] and E_s[var_s] + Var_s[mean_s], the noise included. Each
    draw's gram is factored in ``factor`` and W = L⁻¹'s products with the
    cross-covariance and y are taken in ``products``."""
    means, variances = [], []
    for i in range(len(draws["noise"])):
        ls, ks, nz = (float(np.asarray(draws[s][i]).reshape(-1)[0]) for s in SITES)
        Xf = X.to(factor)
        K = gram(Xf, Xf, ls, ks, cfg["kernel"])
        K.diagonal().add_(nz + diag_shift(cfg))
        L = torch.linalg.cholesky(K)
        W = torch.linalg.solve_triangular(
            L, torch.eye(L.shape[0], dtype=factor, device=L.device), upper=False).to(products)
        A = W @ gram(Xn.to(products), X.to(products), ls, ks, cfg["kernel"]).T
        v = W @ y.to(products)
        means.append(A.T @ v)
        variances.append(ks + nz + cfg["jitter"] - (A * A).sum(0))
        del Xf, K, L, W, A
    m, v = torch.stack(means).double(), torch.stack(variances).double()
    return m.mean(0), v.mean(0) + m.var(0, correction=0)


def ei(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Expected improvement below the least predictive mean (minimization)."""
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    u = -(mean - mean.min()) / torch.where(sigma > 0, sigma, 1.0)
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + torch.erf(u / math.sqrt(2.0)))
    return torch.where(sigma > 0, sigma * (phi + u * cdf), 0.0)
