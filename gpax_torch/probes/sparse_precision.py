"""Precision probe of gpax_torch's viSparseGP: float32 against float64 factors.

viSparseGP factors Kuu (every SVI step) and the capacitance B (in predict)
with ``safe_chol_inv_f64``: ``chol_inv`` on K3's float64 instantiation, with
the float32 jitters. This probe fits the same model with those
factorizations in float32 (``safe_chol_inv``, as the JAX package does),
with K3 or with its twin at ``chol_inv``'s leaves, and in float64, through
the public ``fit`` and ``predict_in_batches``, on
bench.py's config-3 data (x ~ U(0, 4), y = sin(3x)·e^(−0.3x) + 0.05ε,
inducing ratio 0.05 "uniform", Adam 5e-3), and reports each fit's losses,
medians, steps/s, grid RMSE and the likelihood's capacitance at its end.

Where a float32 fit turns non-finite, it fits again up to the first
non-finite step, forms the matrix that step gives ``chol_inv``
(K = Kuu + jitter·I, as ``safe_chol_inv`` picks the jitter) and reports
who factors it:

- the library's float32 Cholesky (``cholesky_ex``: the escalation's probe);
- float32 ``chol_inv`` with each of four leaves: K3; K3's factor with the
  library's triangular inverse; the library's factor with K2's inverse
  (the substitution loop K3 shares); the twin (the library's both);
- the same blocked recursion with L21 from a triangular solve instead of
  the product L21 = K21·W11ᵀ (``trsm_recursion``);
- float64 ``chol_inv``;

and, for each 128-leaf of each variant, the smallest eigenvalue of the
Schur complement the recursion hands it (beside the exact one), the leaf
factor's backward error and its inverse's left residual.

    python -m gpax_torch.probes.sparse_precision --save build/kuu.npy
    python -m gpax_torch.probes.sparse_precision --load build/kuu.npy

``--save`` writes that matrix (float32, .npy) for a check by other means;
``--load`` skips the fits and reports who factors a saved matrix.
The last line of the output is one JSON object with every number; ``--out
FILE`` also writes it there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import time
from typing import Tuple

import numpy as np
import torch

import gpax_torch
from gpax_torch.ops import build, chol, linalg
from gpax_torch.ppl import log_density
from gpax_torch.utils import get_keys

PHASES = ((2000, 3000), (20000, 1000))  # (n, SVI steps): config 3 and m = 1000


class Float32Factors(gpax_torch.viSparseGP):
    """viSparseGP with its m×m factorizations in float32."""
    _chol_inv = staticmethod(linalg.safe_chol_inv)


def data(n: int):
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 4, n)
    y = np.sin(3 * X) * np.exp(-0.3 * X) + 0.05 * rng.normal(size=n)
    return X, y


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def fit(cls, n: int, steps: int, dev):
    model = cls(1, "RBF")
    sync(dev)
    t0 = time.perf_counter()
    model.fit(get_keys(0)[0], *data(n), inducing_points_ratio=0.05,
              inducing_points_selection="uniform", num_steps=steps, progress_bar=False,
              print_summary=False, device=dev)
    sync(dev)
    return model, time.perf_counter() - t0


K3 = chol.tile_chol_inv


def _nan_unless(info, L):
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _cusolver_L_k2_W(A):
    L, info = torch.linalg.cholesky_ex(A)
    L = _nan_unless(info, L).contiguous()
    return L, chol.tile_tri_inv(L)


def _k3_L_trsm_W(A):
    L = K3(A)[0]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(L)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


# the fits: float32 factors with K3 or with the twin at chol_inv's leaves,
# and the model's own float64 factors
FITS = (("float32", Float32Factors, K3),
        ("float32_twin_leaves", Float32Factors, chol.tile_chol_inv_twin),
        ("float64", gpax_torch.viSparseGP, K3))

# what chol_inv's leaves run: K3 whole, K3's factor with the library's
# triangular inverse, the library's factor with K2's inverse (the
# substitution loop K3 shares), and the twin (the library's both)
LEAVES = {"k3": K3, "k3_L_trsm_W": _k3_L_trsm_W, "cusolver_L_k2_W": _cusolver_L_k2_W,
          "twin": chol.tile_chol_inv_twin}


@contextlib.contextmanager
def leaves_of(leaf, record: bool = True):
    """chol_inv with ``leaf`` at its leaves; yields the leaves' inputs and
    outputs (if ``record``)."""
    calls = []

    def run(A):
        out = leaf(A)
        if record:
            calls.append((A.clone(), *out))
        return out

    chol.tile_chol_inv = run
    try:
        yield calls
    finally:
        chol.tile_chol_inv = K3


def trsm_recursion(K: torch.Tensor) -> torch.Tensor:
    """L of K (n a multiple of TILE) by chol_inv's blocked recursion with
    L21 = K21·L11⁻ᵀ from a triangular solve and the twin at the leaves."""
    n = K.shape[-1]
    if n <= chol.TILE:
        return chol.tile_chol_inv_twin(K.contiguous())[0]
    h = chol.TILE * ((n // chol.TILE) // 2)
    L11 = trsm_recursion(K[..., :h, :h])
    L21 = torch.linalg.solve_triangular(L11.mT, K[..., h:, :h], upper=True, left=False)
    L22 = trsm_recursion(K[..., h:, h:] - L21 @ L21.mT)
    top = torch.cat([L11, torch.zeros_like(L21.mT)], -1)
    return torch.cat([top, torch.cat([L21, L22], -1)], -2)


def finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def _eigvalsh(A: torch.Tensor) -> torch.Tensor:
    if not finite(A):
        return torch.full(A.shape[-1:], float("nan"), dtype=torch.float64)
    return torch.linalg.eigvalsh(A.double())


def lam_min(A: torch.Tensor) -> float:
    return _eigvalsh(A).min().item()


def kappa(A: torch.Tensor) -> float:
    ev = _eigvalsh(A)
    return (ev.max() / ev.min()).item()


@torch.no_grad()
def failing_matrix(model, save) -> Tuple[torch.Tensor, dict]:
    """The matrix that the fitted model's next step hands ``chol_inv``, K =
    Kuu + jitter·I with the jitter ``safe_chol_inv`` picks, and that step's
    log density and hyperparameters."""
    X, y = model.X_train, model.y_train
    med = model.get_samples()
    log_p, _ = log_density(model.model, (X, y), {"Xu": model.Xu}, med)
    Kuu = model.kernel(model.Xu, model.Xu, med)
    eps = torch.finfo(Kuu.dtype).eps
    j_base = 4.0 * Kuu.shape[-1] * eps
    probe_info = torch.linalg.cholesky_ex(linalg._add_diag(Kuu, j_base))[1].item()
    j = j_base if probe_info == 0 else linalg._escalated_jitter(Kuu, eps).item()
    K = linalg._add_diag(Kuu, j)
    if save:
        np.save(save, K.cpu().numpy())
    return K, {"log_p_at_step": log_p.item(), "noise": med["noise"].item(),
               "k_length": med["k_length"].tolist(), "k_scale": med["k_scale"].item(),
               "jitter": j}


@torch.no_grad()
def capacitance(model) -> dict:
    """The likelihood's capacitance C = I + Wᵀ·D⁻¹·W at the model's current
    parameters, W = (Wuu·Kuf)ᵀ as the model forms it: κ(C) (float64
    eigenvalues) and whether ``cholesky_ex`` factors C formed in float32
    and in float64."""
    med = model.get_samples()
    Kuu = model.kernel(model.Xu, model.Xu, med)
    _, Wuu = model._chol_inv(Kuu)
    W = (Wuu @ model.kernel(model.Xu, model.X_train, med)).mT
    out = {}
    for dtype in (torch.float32, torch.float64):
        Wd = W.to(dtype)
        C = Wd.mT @ (Wd / med["noise"].to(dtype))
        C.diagonal().add_(1.0)
        out[f"cholesky_ex_{str(dtype)[6:]}_info"] = torch.linalg.cholesky_ex(C)[1].item()
    out["kappa"] = kappa(C)
    return out


@torch.no_grad()
def who_factors(K: torch.Tensor) -> dict:
    """Which float32 factorizations of K (m×m) stay finite; per leaf of each
    ``chol_inv`` variant, the smallest eigenvalue of its input, the factor's
    backward error ‖L·Lᵀ − A‖/‖A‖ and the inverse's left residual ‖W·L − I‖
    (which the next Schur update L21 = K21·W11ᵀ inherits), all max-norms in
    float64; and the smallest eigenvalue of each leaf's exact input."""
    m = K.shape[-1]
    ev = _eigvalsh(K)
    out = {"m": m, "kappa": kappa(K), "lam_min": ev.min().item(), "lam_max": ev.max().item(),
           "cholesky_ex_f32_info": torch.linalg.cholesky_ex(K)[1].item()}
    n_pad = -(-m // chol.TILE) * chol.TILE
    Kp = chol._pad_spd(K[None], n_pad)[0]
    out["trsm_recursion_f32_finite"] = finite(trsm_recursion(Kp))
    out["chol_inv_f64_finite"] = finite(*chol.chol_inv(K.double()))
    L64 = torch.linalg.cholesky(Kp.double())
    exact = []
    for i in range(n_pad // chol.TILE):
        rows = slice(i * chol.TILE, (i + 1) * chol.TILE)
        before = L64[rows, :i * chol.TILE]
        exact.append(lam_min(Kp.double()[rows, rows] - before @ before.mT))
    out["leaf_lam_min_exact"] = exact
    eye = torch.eye(chol.TILE, dtype=torch.float64, device=K.device)
    for name, leaf in LEAVES.items():
        with leaves_of(leaf) as calls:
            L, W = chol.chol_inv(K)
        rows = []
        for A, Lt, Wt in calls:
            # the factorizations read A's lower triangle
            A = torch.tril(A[0]) + torch.tril(A[0], -1).mT
            A, Lt, Wt = A.double(), Lt[0].double(), Wt[0].double()
            rows.append({"lam_min": lam_min(A),
                         "backward_err": ((Lt @ Lt.mT - A).abs().max() / A.abs().max()).item(),
                         "left_resid": (Wt @ Lt - eye).abs().max().item()})
        out[name] = {"finite": finite(L, W), "leaves": rows}
    return out


def fit_report(n: int, steps: int, name: str, cls, leaf, dev, save) -> dict:
    """One fit's numbers, with ``leaf`` at chol_inv's leaves; at its first
    non-finite loss, who factors that step's matrix."""
    with leaves_of(leaf, record=False):
        model, fit_s = fit(cls, n, steps, dev)
    losses = model.loss.cpu()
    res = {"factors": name, "n": n, "m": int(model.Xu.shape[0]), "steps": steps,
           "fit_s": fit_s, "steps_per_s": steps / fit_s,
           "loss_first": losses[0].item(), "loss_last": losses[-1].item()}
    bad = (~torch.isfinite(losses)).nonzero()
    if len(bad):
        i = int(bad[0])
        with leaves_of(leaf, record=False):
            again, _ = fit(cls, n, i, dev)
        K, step = failing_matrix(again, save)
        res.update(first_nonfinite_step=i, at_failure=step, who_factors=who_factors(K),
                   capacitance=capacitance(again),
                   refit_loss_max_diff=(again.loss.cpu() - losses[:i]).abs().max().item())
    else:
        res["capacitance"] = capacitance(model)
        res["median"] = {k: v.tolist() for k, v in model.get_samples().items()}
        grid = np.linspace(0, 4, 2001).astype(np.float32)
        mean, _ = model.predict_in_batches(None, grid, batch_size=1024, device=dev)
        truth = np.sin(3 * grid) * np.exp(-0.3 * grid)
        res["rmse"] = float(np.sqrt(np.mean((mean.numpy() - truth) ** 2)))
    print(json.dumps(res), flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", help="write the failing step's matrix here (.npy)")
    ap.add_argument("--load", help="skip the fits: report who factors this saved matrix")
    ap.add_argument("--phases", default=",".join(f"{n}:{s}" for n, s in PHASES),
                    help="the fits' n:steps, comma-separated")
    ap.add_argument("--out")
    args = ap.parse_args()
    dev = gpax_torch.utils.resolve_device(args.device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
        build.library()  # the kernels' build stays out of the first fit's time
    for cls in (Float32Factors, gpax_torch.viSparseGP):
        fit(cls, 2000, 50, dev)  # and so do the libraries' first calls
    res = {"card": card}
    if args.load:
        res["loaded"] = who_factors(torch.as_tensor(np.load(args.load), device=dev))
    else:
        phases = [tuple(map(int, p.split(":"))) for p in args.phases.split(",")]
        res["fits"] = [fit_report(n, steps, name, cls, leaf, dev, args.save)
                       for n, steps in phases for name, cls, leaf in FITS]
    line = json.dumps(res)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
