"""Where a lockstep leapfrog's time goes: ExactGP at n = 4096 on the card.

Builds chip_smoke.py's main-path data (x ~ U(-2, 2), y = sin(2x) + 0.1ε,
n = 4096) and ExactGP(1, "RBF")'s potential on the route "auto" takes
(fused at this n), batched over C chains for each C of ``--chains``
(C = 1: the unbatched potential one chain runs), at one point per chain
near the posterior. It times one potential and gradient evaluation (a
leapfrog's work): the host clock per evaluation ending in a synchronize,
and under ``torch.profiler`` the device time, the number of kernels, and
the device time of the largest kernel groups:

    python -m gpax_torch.probes.lockstep_leapfrog --chains 1 4 --out FILE

The last line is one JSON object with every number; ``--out FILE`` also
writes it there.
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

N = 4096


def _data(dev):
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (N, 1)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=N).astype(np.float32)).astype(np.float32)
    return torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev)


def split(chains: int, reps: int = 20) -> dict:
    """Host ms, device ms, kernels and the top kernel groups of one
    potential-and-gradient evaluation for ``chains`` chains."""
    dev = torch.device("cuda", 0)
    X, y = _data(dev)
    gp = gpax_torch.ExactGP(1, "RBF")
    batch = (chains,) if chains > 1 else ()
    info = initialize_model(gp.model, torch.Generator(device=dev).manual_seed(0), (X, y),
                            batch_shape=batch)
    # near the fit's posterior (chip_smoke.py's main path): ℓ ≈ 0.9, k_scale
    # ≈ 1.3, noise ≈ 0.01, each chain a little apart
    shift = torch.linspace(-0.05, 0.05, max(chains, 1), device=dev)[:chains]
    z = {"k_length": (math.log(0.9) + shift)[:, None], "k_scale": math.log(1.3) + shift,
         "noise": math.log(0.01) + shift}
    if not batch:
        z = {k: v[0] for k, v in z.items()}

    def step():
        zz = {k: v.detach().requires_grad_(True) for k, v in z.items()}
        u = info.potential_fn(zz)
        torch.autograd.grad(u.sum(), list(zz.values()))

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    out = {"chains": chains, "route": "fused" if gp._fused_likelihood_ok(
        X, {"k_length": None, "k_scale": None}) else "composed",
        "host_ms": 1e3 * (time.perf_counter() - t0) / reps,
        "device_ms": "not measured", "kernels": "not measured"}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if kernels:
        out["device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        out["kernels"] = sum(e.count for e in kernels) / reps
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        out["top_kernels_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 / reps for e in top}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "n": N, "splits": []}
    for c in args.chains:
        r = split(c)
        result["splits"].append(r)
        print(json.dumps({"card": card, **r}), flush=True)
    line = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
