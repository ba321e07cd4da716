"""chip_smoke.py's config 4 fit across seeds, and where its leapfrog's time
goes.

Fits chip_smoke.py's config 4 phase (its data, ``MultiTaskGP(1, "Matern",
num_latents=1, num_tasks=2)`` and its fit settings: 200 + 200 draws,
segments of 50, tree depth 8, warmup depth cap (5, 20), target accept 0.7)
on the card for each seed of ``--seeds`` (seed s fits with
``get_keys(s)[0]``, as chip_smoke.py fits with seed 0) and prints a JSON
line per fit: wall s, leapfrogs, mean accept of the draws, divergences, the
adapted step size, the posterior means of W, v and the lengthscale, how many
draws changed the sign of W from the draw before (W and −W give the same
task covariance), and the mean |W| of the divergent draws.

With ``--leapfrog``, it then times the potential and its gradient (one
leapfrog's work) at the last fit's last draw: the host clock per
evaluation ending in a synchronize, and under ``torch.profiler`` the device
time and the number of kernels an evaluation. Run from the repository root
(it imports ``chip_smoke``):

    python -m gpax_torch.probes.mtgp_divergences --seeds 0 1 2 3 4 --leapfrog --out FILE

The last line is one JSON object with every number; ``--out FILE`` also
writes it there.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch

import chip_smoke as cs
import gpax_torch
from gpax_torch.infer.nuts import ravel
from gpax_torch.ppl import initialize_model
from gpax_torch.ppl.util import unconstrain
from gpax_torch.utils import get_keys


def fit(seed: int) -> tuple:
    X, y = cs.config4_data()
    model = gpax_torch.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    t0 = time.perf_counter()
    model.fit(get_keys(seed)[0], X, y, num_warmup=cs.MT_WARMUP, num_samples=cs.MT_SAMPLES,
              segment_size=cs.MT_SEGMENT, max_tree_depth=cs.MT_DEPTH,
              warmup_depth_cap=cs.MT_DEPTH_CAP, target_accept_prob=cs.MT_TARGET,
              print_summary=False, progress_bar=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = model.mcmc.get_extra_fields()
    s = model.get_samples()
    num_samples = cs.MT_SAMPLES
    W = s["W"].reshape(num_samples, -1)
    div = st["diverging"].to(W.device)
    return model, {
        "seed": seed, "fit_s": wall, "leapfrogs": model.mcmc.num_leapfrogs,
        "accept": st["accept_prob"].mean().item(), "divergences": int(div.sum()),
        "step_size": st["step_size"][-1].item(),
        "W": W.mean(0).tolist(), "v": s["v"].reshape(num_samples, -1).mean(0).tolist(),
        "k_length": s["k_length"].mean().item(),
        "sign_switches": int((torch.sign(W[1:, 0]) != torch.sign(W[:-1, 0])).sum()),
        "abs_W_divergent": W[div].abs().mean().item() if bool(div.any()) else None}


def leapfrog_split(model, reps: int = 50) -> dict:
    """Host ms and device ms (with its kernel count) of one potential and
    gradient evaluation at the fit's last draw."""
    device = model.X_train.device
    info = initialize_model(model.model, torch.Generator(device=device).manual_seed(0),
                            (model.X_train, model.y_train))
    last = {k: v[-1] for k, v in model.get_samples().items() if k in info.transforms}
    z, unravel = ravel(unconstrain(info.transforms, last))

    def step():
        zz = z.detach().requires_grad_(True)
        u = info.potential_fn(unravel(zz))
        torch.autograd.grad(u, zz)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    out = {"host_ms": 1e3 * (time.perf_counter() - t0) / reps,
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
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--leapfrog", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    runs, model = [], None
    for seed in args.seeds:
        model, r = fit(seed)
        runs.append(r)
        print(json.dumps({"card": card, **r}), flush=True)
    result = {"card": card, "runs": runs}
    if args.leapfrog:
        result["leapfrog"] = leapfrog_split(model)
        print(json.dumps({"card": card, "leapfrog": result["leapfrog"]}), flush=True)
    line = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
