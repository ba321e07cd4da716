"""Time K4 (single-launch panel Cholesky) and K5 (single-launch panel
triangular inverse) of whichever ``gpax_torch`` is first on the path, on one
CUDA card, so that two checkouts can be compared in one run:

    PYTHONPATH=<checkout> python3 scripts/panel_chol_ab.py --label parent

Each case is A·Aᵀ/n + ½I (κ ≤ ~9), made on the card from a seed, at
n = 4096 in float64 and n = 8192 in float64 and float32. Prints one JSON
line per case: the checkout, K4's and K5's CUDA-event means, K4's error
against ``cholesky_ex`` relative to max|L| and K5's against its twin on
K4's L relative to max|Wᵀ|, and K4's phase split where the checkout has
``cholesky_phase_ms``. Exits non-zero without a card or when either error
is above 1e-10 (float64) or 1e-4 (float32).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

import gpax_torch
from gpax_torch.ops import panel_chol

CASES = ((4096, torch.float64), (8192, torch.float64), (8192, torch.float32))
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def spd(n: int, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((n, n), generator=g, device="cuda", dtype=dtype)
    K = A @ A.mT / n
    K.diagonal().add_(0.5)
    return K


def cuda_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
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
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("panel_chol_ab.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    bad = False
    for n, dtype in CASES:
        K = spd(n, dtype, n)
        L = panel_chol.panel_cholesky(K)
        L_ref = torch.linalg.cholesky_ex(K)[0]
        rel = ((L - L_ref).abs().max() / L_ref.abs().max()).item()
        WT_ref = panel_chol.panel_tri_inv_t_twin(L)
        rel5 = ((panel_chol.panel_tri_inv_t(L) - WT_ref).abs().max() / WT_ref.abs().max()).item()
        del WT_ref
        bad |= not (rel <= TOL[dtype] and rel5 <= TOL[dtype])
        t4 = cuda_ms(lambda: panel_chol.panel_cholesky(K), args.iters)
        t5 = cuda_ms(lambda: panel_chol.panel_tri_inv_t(L), args.iters)
        line = {"label": args.label, "gpax_torch": gpax_torch.__file__, "card": card, "n": n,
                "dtype": str(dtype).replace("torch.", ""), "k4_ms": t4, "k5_ms": t5,
                "k4_rel_err": rel, "k5_rel_err": rel5}
        if hasattr(panel_chol, "cholesky_phase_ms"):
            line["k4_phases_ms"] = panel_chol.cholesky_phase_ms(K)
        print(json.dumps(line), flush=True)
        del K, L, L_ref
        torch.cuda.empty_cache()
    if bad:
        raise SystemExit("K4 or K5 disagrees with its reference")


if __name__ == "__main__":
    main()
