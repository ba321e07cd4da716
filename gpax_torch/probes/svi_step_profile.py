"""Where one SVI step of gpax_torch's viSparseGP (or viGP, or viDKL) spends
its time.

Fits bench.py's config-3 data (viSparseGP RBF, inducing ratio 0.05
"uniform", Adam 5e-3; ``--n 20000`` for the m = 1000 phase), with
``--model vigp`` config 2's image (viGP Matérn, Adam 0.05), or with
``--model vidkl`` config 5's 8-model ensemble (viDKL, d = 784, 256 points,
Adam 5e-3; ``configs.config5_data``)
through ``fit_predict`` on 8 of its points, and measures

- the host clock per step: the difference of two fits of ``--warmup`` and
  ``--warmup + --steps`` steps, each ending in ``torch.cuda.synchronize()``;
- under ``torch.profiler``, over one fit of ``--steps`` steps, the device
  time of every kernel per step, summed by group: K1 (gram), K2
  (tile_tri_inv), K3 (tile_chol_inv), GEMMs, the library Cholesky
  (cuSOLVER: the escalation probe and the capacitance), triangular solves,
  and everything else (elementwise, reductions, copies); and the device's
  idle share of the step against the host clock without the profiler.

The profiled fit includes the fit's set-up (one trace of the model), less
than one step's work.

    python -m gpax_torch.probes.svi_step_profile                      # config 3 on the card
    python -m gpax_torch.probes.svi_step_profile --n 20000 --steps 50
    python -m gpax_torch.probes.svi_step_profile --model vigp
    python -m gpax_torch.probes.svi_step_profile --model vidkl --warmup 20 --steps 50

The last line is one JSON object with every number; ``--out FILE`` also
writes it there.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

import gpax_torch
from gpax_torch.probes.configs import VIDKL_D, VIDKL_MODELS, config5_data
from gpax_torch.utils import get_keys, preprocess_sparse_image

GROUPS = (("K1 gram", ("gram_kernel",)), ("K2 tile_tri_inv", ("tile_tri_inv_kernel",)),
          ("K3 tile_chol_inv", ("tile_chol_inv_kernel",)),
          ("GEMM", ("gemm", "gemv", "xmma", "cutlass", "dot_kernel", "splitKreduce")),
          # cuSOLVER's potrf runs as getrf_wo_pivot kernels
          ("library Cholesky", ("potrf", "getrf", "chol", "syrk", "herk")),
          ("triangular solve", ("trsm", "trsv")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def fitter(model_name: str, n: int):
    """(model, fit(num_steps)) on bench.py's data for that model."""
    rng = np.random.default_rng(0)
    key = get_keys(0)[0]
    if model_name == "vidkl":
        X_pool, y_pool, measured, _ = config5_data()
        X, y = X_pool[measured], y_pool[measured].astype(np.float32)
        model = gpax_torch.viDKL(VIDKL_D, z_dim=2, kernel="RBF")

        def fit(num_steps: int) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.fit_predict(key, X, y, X[:8], num_steps=num_steps, n_models=VIDKL_MODELS,
                              progress_bar=False, print_summary=False)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        return model, fit
    if model_name == "vigp":
        xx, yy = np.meshgrid(np.arange(128), np.arange(128))
        truth = np.sin(xx / 16.0) * np.cos(yy / 21.0) + 1.5
        mask = rng.uniform(size=truth.shape) < 0.15
        X, y, _ = preprocess_sparse_image(np.where(mask, truth, 0.0))
        model = gpax_torch.viGP(2, "Matern")
        kw = {"step_size": 0.05}
    else:
        X = rng.uniform(0, 4, n)
        y = np.sin(3 * X) * np.exp(-0.3 * X) + 0.05 * rng.normal(size=n)
        model = gpax_torch.viSparseGP(1, "RBF")
        kw = {"inducing_points_ratio": 0.05, "inducing_points_selection": "uniform"}

    def fit(num_steps: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(key, X, y, num_steps=num_steps, progress_bar=False, print_summary=False, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return model, fit


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("visparsegp", "vigp", "vidkl"), default="visparsegp")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    model, fit = fitter(args.model, args.n)
    fit(args.warmup)
    wall = (fit(args.warmup + args.steps) - fit(args.warmup)) / args.steps

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall = fit(args.steps) / args.steps
    # kernels only: a user annotation on the device's track (the optimizer's
    # "Optimizer.step#Adam.step") spans kernels that are counted already
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    groups, launches = {}, {}
    for evt in kernels:
        t = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if t > 0:
            g = group_of(evt.key)
            groups[g] = groups.get(g, 0.0) + t / 1e3 / args.steps
            launches[g] = launches.get(g, 0) + evt.count / args.steps
    busy = sum(groups.values())
    Xu = getattr(model, "Xu", None)
    out = {"card": card, "model": args.model, "n": int(model.X_train.shape[0]),
           "m": None if Xu is None else int(Xu.shape[0]), "steps": args.steps,
           "wall_ms_per_step": 1e3 * wall, "profiled_wall_ms_per_step": 1e3 * prof_wall,
           "device_ms_per_step": groups, "device_launches_per_step": launches,
           "device_busy_ms_per_step": busy,
           # against the step's wall time without the profiler, and with it
           "device_idle_share": 1.0 - busy / (1e3 * wall),
           "device_idle_share_profiled": 1.0 - busy / (1e3 * prof_wall)}
    top = sorted(((getattr(e, "self_device_time_total", 0.0) or 0.0, e.key, e.count)
                  for e in kernels), reverse=True)[:12]
    for t, k, c in top:
        print(f"  {t / 1e3 / args.steps:9.4f} ms/step  {c / args.steps:7.1f}/step  {k[:110]}")
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
