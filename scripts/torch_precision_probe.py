"""Precision probe of the gpax_torch factor path: float32 against float64.

The ExactGP log-likelihood log N(y | 0, K(θ)) and its gradient with respect
to z = (log k_length, log k_scale, log noise) are evaluated on bench.py's
data (x ~ U(-2, 2), y = sin(2x) + 0.1ε) at a few points z under

- ``float32``: kernel K1's float32 gram, a float32 Cholesky, K2's float32
  blocked inverse W, and ∂/∂K = ½(ββᵀ − WᵀW) in float32 (the JAX
  package's factor path with its "highest" WᵀW);
- ``float32_wtw64``: the same, with WᵀW formed in float64 from the float32 W;
- ``port``: the port's own ``ops.linalg.mvn_log_prob_centered`` on the K1
  gram (float64 factor, inverse and WᵀW);

each against a float64 reference (float64 gram, ``torch.linalg.cholesky``
and autograd) with the same total jitter. It also times the port's
likelihood-and-gradient and its factor path alone with CUDA events.

    python scripts/torch_precision_probe.py                 # n = 4096 on cuda:0
    python scripts/torch_precision_probe.py --n 256 --device cpu

The last line of the output is one JSON object with every number;
``--out FILE`` also writes it there. Run it with
``PYTHONPATH`` set to another checkout to measure that checkout's port.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

# appended, so that a PYTHONPATH naming another checkout wins
sys.path.append(str(pathlib.Path(__file__).resolve().parents[1]))

from gpax_torch.kernels import RBFKernel  # noqa: E402
from gpax_torch.ops import chol, linalg  # noqa: E402

KERNEL_JITTER = 1e-6   # the kernels' default_jitter
# (log k_length, log k_scale, log noise): k_scale swept across the range NUTS visits
POINTS = [(0.3, s, -4.8) for s in (0.3, 1.5, 2.5, 3.5)]


def bench_data(n: int):
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n).astype(np.float32)).astype(np.float32)
    return X, y


def params(z):
    return {"k_length": torch.exp(z[0:1]), "k_scale": torch.exp(z[1]), "period": None}


def gram32(X, z):
    return RBFKernel(X, X, params(z), torch.exp(z[2]))


def loglik_ref(X64, y64, z):
    """float64 reference: float64 gram with the port's total jitter."""
    z = z.to(torch.float64)
    n = X64.shape[0]
    r2 = ((X64 - X64.T) / torch.exp(z[0])) ** 2
    jit = KERNEL_JITTER + 4.0 * n * 2.0**-23  # kernel jitter + the factor path's base jitter
    K = torch.exp(z[1]) * torch.exp(-0.5 * r2) \
        + (torch.exp(z[2]) + jit) * torch.eye(n, dtype=torch.float64, device=X64.device)
    L = torch.linalg.cholesky(K)
    a = torch.linalg.solve_triangular(L, y64[:, None], upper=False)[:, 0]
    return -0.5 * (a @ a + n * math.log(2 * math.pi)) - torch.log(L.diagonal()).sum()


def loglik_f32(K, y, wtw_dtype):
    """float32 factor path; returns (value, ∂/∂K) without autograd."""
    n = K.shape[-1]
    Kj = K.detach() + 4.0 * n * 2.0**-23 * torch.eye(n, device=K.device)
    L, info = torch.linalg.cholesky_ex(Kj)
    if int(info) != 0:
        return float("nan"), torch.zeros_like(K)
    W = chol.blocked_trtri(L)
    alpha = W @ y
    val = -0.5 * (alpha @ alpha + n * math.log(2 * math.pi)) - torch.log(L.diagonal()).sum()
    beta = W.T @ alpha
    Ww = W.to(wtw_dtype)
    dK = 0.5 * (beta[:, None] * beta[None, :] - (Ww.T @ Ww).to(torch.float32))
    return val.item(), dK


def evaluate(X, y, X64, y64, z0):
    out = {}
    z = torch.tensor(z0, dtype=torch.float64, device=X.device, requires_grad=True)
    v = loglik_ref(X64, y64, z)
    (g,) = torch.autograd.grad(v, z)
    ref_v, ref_g = v.item(), g.tolist()
    out["reference"] = {"value": ref_v, "grad": ref_g}
    for name, wtw in (("float32", torch.float32), ("float32_wtw64", torch.float64)):
        z = torch.tensor(z0, dtype=torch.float32, device=X.device, requires_grad=True)
        K = gram32(X, z)
        val, dK = loglik_f32(K, y, wtw)
        (g,) = torch.autograd.grad(K, z, grad_outputs=dK)
        out[name] = {"value_err": val - ref_v, "grad_err": [a - b for a, b in zip(g.tolist(), ref_g)]}
    z = torch.tensor(z0, dtype=torch.float32, device=X.device, requires_grad=True)
    v = linalg.mvn_log_prob_centered(gram32(X, z), y)
    (g,) = torch.autograd.grad(v, z)
    out["port"] = {"value_err": v.item() - ref_v, "grad_err": [a - b for a, b in zip(g.tolist(), ref_g)]}
    return out


def timed_ms(fn, device, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device(args.device)
    X_np, y_np = bench_data(args.n)
    X, y = torch.as_tensor(X_np, device=dev), torch.as_tensor(y_np, device=dev)
    X64, y64 = X.double(), y.double()

    points = []
    for z0 in POINTS:
        res = evaluate(X, y, X64, y64, z0)
        res["z"] = list(z0)
        points.append(res)
        print(f"z={tuple(round(v, 3) for v in z0)} ref grad "
              f"{[round(v, 3) for v in res['reference']['grad']]} | " + " | ".join(
                  f"{k}: dv {res[k]['value_err']:+.3e} dg "
                  f"{[float(f'{v:+.3e}') for v in res[k]['grad_err']]}"
                  for k in ("float32", "float32_wtw64", "port")), flush=True)

    z = torch.tensor(POINTS[1], dtype=torch.float32, device=dev, requires_grad=True)
    K = gram32(X, z).detach()

    def potgrad():
        v = linalg.mvn_log_prob_centered(gram32(X, z), y)
        torch.autograd.grad(v, z)

    timing = {"loglik_and_grad_ms": timed_ms(potgrad, dev),
              "factor_path_ms": timed_ms(lambda: linalg._chol_tri_factors_ld(K), dev)}
    print(f"timing: {timing}", flush=True)
    summary = {"n": args.n, "device": str(dev), "gpax_torch": str(pathlib.Path(
        linalg.__file__).resolve().parents[2]), "points": points, "timing": timing}
    if dev.type == "cuda":
        summary["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    line = json.dumps(summary)
    print(line)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
