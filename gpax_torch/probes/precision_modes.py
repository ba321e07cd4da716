"""The HMC gradient's WᵀW modes on the card: ExactGP at n = 4096.

Fits chip_smoke.py's main path (x ~ U(-2, 2), y = sin(2x) + 0.1ε,
n = 4096, ``ExactGP(1, "RBF")``, 100 + 100 draws at tree depth 7, the same
key) once for each ``hmc_wtw_precision`` of ``--modes`` (None keeps the
port's float64 WᵀW; "highest", "compensated" and "default" are the JAX
package's modes, "default" its default) on each likelihood route of
``--routes`` (fused: ``use_fused_likelihood="always"``; composed:
"never"), with every other setting at the port's defaults. For each it
reports the fit's seconds, leapfrogs, ms a leapfrog (the fit's wall time
over its leapfrogs), the host ms of one potential-and-gradient evaluation
near the posterior (ending in a synchronize), the mean accept probability,
the divergences and the posterior means (the noise's among them). It
changes no default:

    python -m gpax_torch.probes.precision_modes --out FILE

The last line is one JSON object with every number; ``--out FILE`` also
writes it there. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import time

import numpy as np
import torch

import gpax_torch
from gpax_torch.ppl import initialize_model
from gpax_torch.utils import get_keys

MODES = ("none", "highest", "compensated", "default")
ROUTES = {"fused": "always", "composed": "never"}


def _data(n: int, dev):
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n).astype(np.float32)).astype(np.float32)
    return torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev)


def _grad_ms(gp, X, y, reps: int = 20) -> float:
    """Host ms of one potential and gradient near the posterior (ℓ ≈ 0.9,
    k_scale ≈ 1.3, noise ≈ 0.01) under the config's wtw_precision."""
    info = initialize_model(gp.model, torch.Generator(device=X.device).manual_seed(0), (X, y))
    z = {"k_length": torch.tensor([math.log(0.9)], device=X.device),
         "k_scale": torch.tensor(math.log(1.3), device=X.device),
         "noise": torch.tensor(math.log(0.01), device=X.device)}

    def step():
        zz = {k: v.clone().requires_grad_(True) for k, v in z.items()}
        torch.autograd.grad(info.potential_fn(zz), list(zz.values()))

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def fit(mode: str, route: str, n: int, warmup: int, samples: int, depth: int) -> dict:
    """One fit under ``hmc_wtw_precision=mode`` on ``route``."""
    dev = torch.device("cuda", 0)
    X, y = _data(n, dev)
    hmc = None if mode == "none" else mode
    gpax_torch.set_config(hmc_wtw_precision=hmc, use_fused_likelihood=ROUTES[route])
    try:
        gp = gpax_torch.ExactGP(1, "RBF")
        k_fit, _ = get_keys(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp.fit(k_fit, X, y, num_warmup=warmup, num_samples=samples, max_tree_depth=depth,
               print_summary=False, progress_bar=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        # the override binds MCMC.run only: time the gradient in its mode
        gpax_torch.set_config(wtw_precision=hmc or "float64")
        grad_ms = _grad_ms(gp, X, y)
    finally:
        gpax_torch.set_config(hmc_wtw_precision=None, wtw_precision="float64",
                              use_fused_likelihood="auto")
    stats = gp.mcmc.get_extra_fields()
    s = gp.get_samples()
    leapfrogs = gp.mcmc.num_leapfrogs
    return {"hmc_wtw_precision": hmc, "route": route, "fit_s": fit_s, "leapfrogs": leapfrogs,
            "ms_per_leapfrog": 1e3 * fit_s / max(leapfrogs, 1), "grad_ms": grad_ms,
            "accept_mean": stats["accept_prob"].mean().item(),
            "divergences": int(stats["diverging"].sum()),
            "posterior_mean": {k: v.float().mean().item() for k, v in s.items()},
            "posterior_sd": {k: v.float().std().item() for k, v in s.items()},
            "finite": all(bool(torch.isfinite(v).all()) for v in s.values())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    ap.add_argument("--routes", nargs="+", default=list(ROUTES), choices=list(ROUTES))
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--depth", type=int, default=7)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("precision_modes needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__}",
          flush=True)
    rows = []
    for route in args.routes:
        for mode in args.modes:
            row = fit(mode, route, args.n, args.warmup, args.samples, args.depth)
            print(json.dumps(row), flush=True)
            rows.append(row)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "n": args.n,
              "num_warmup": args.warmup, "num_samples": args.samples,
              "max_tree_depth": args.depth, "fits": rows}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
