"""Time the port's kernels K1-K5 of whichever ``gpax_torch`` is first on the
path, on one CUDA card, so that two checkouts can be compared in one run:

    PYTHONPATH=<checkout> python3 scripts/panel_chol_ab.py --label parent

Every matrix is A·Aᵀ/n + ½I (κ ≤ ~9), made on the card from a seed. Prints
one JSON line per case, each with the checkout and the card:

- K4 (single-launch panel Cholesky) and K5 (single-launch panel triangular
  inverse) at n = 4096 in float64 and n = 8192 in float64 and float32: their
  CUDA-event means, K4's error against ``cholesky_ex`` relative to max|L|
  and K5's against its twin on K4's L relative to max|Wᵀ|, and K4's and
  K5's phase splits where the checkout has ``cholesky_phase_ms`` and
  ``tri_inv_phase_ms``;
- K3 (128-tile Cholesky and inverse) on one leaf in float64 at B = 1 and 8
  and in float32 at B = 1, and ``chol_inv`` at m = 1024 in float64;
- K2 (128-tile triangular inverse) on the 32 diagonal tiles of a float64
  and a float32 factor at n = 4096, and apart the zero fill of the n×n W
  that its wrapper returns;
- K1 (fused gram) at n = m = 4096, d = 1, RBF; at viGP config 2's
  2455 × 2455, d = 2, Matérn; and at ``ExactGP.predict``'s batched
  cross-gram, 32 draws of 1024 × 4096, d = 1, RBF.

Each of K1-K3's lines has its mean and its error against its twin (K3,
``chol_inv``: the worse of L and W) relative to the twin's max. Exits
non-zero without a card or when an error is above the tolerance of
``TOL`` (float64, float32).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

import gpax_torch
from gpax_torch.ops import chol, gram, panel_chol

CASES = ((4096, torch.float64), (8192, torch.float64), (8192, torch.float32))
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
K1_TOL = 1e-5  # relative to max|K|: fp32 r² from norms of a few units


def spd(n: int, dtype, seed: int, batch: int = 1) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((batch, n, n), generator=g, device="cuda", dtype=dtype)
    K = A @ A.mT / n
    K.diagonal(dim1=-2, dim2=-1).add_(0.5)
    return K if batch > 1 else K[0]


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


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def panel_cases(head: dict, iters: int) -> bool:
    bad = False
    for n, dtype in CASES:
        K = spd(n, dtype, n)
        L = panel_chol.panel_cholesky(K)
        L_ref = torch.linalg.cholesky_ex(K)[0]
        err = rel(L, L_ref)
        WT_ref = panel_chol.panel_tri_inv_t_twin(L)
        err5 = rel(panel_chol.panel_tri_inv_t(L), WT_ref)
        del WT_ref
        bad |= not (err <= TOL[dtype] and err5 <= TOL[dtype])
        t4 = cuda_ms(lambda: panel_chol.panel_cholesky(K), iters)
        t5 = cuda_ms(lambda: panel_chol.panel_tri_inv_t(L), iters)
        line = {**head, "n": n, "dtype": str(dtype).replace("torch.", ""), "k4_ms": t4,
                "k5_ms": t5, "k4_rel_err": err, "k5_rel_err": err5}
        if hasattr(panel_chol, "cholesky_phase_ms"):
            line["k4_phases_ms"] = panel_chol.cholesky_phase_ms(K)
        if hasattr(panel_chol, "tri_inv_phase_ms"):
            line["k5_phases_ms"] = panel_chol.tri_inv_phase_ms(L)
        print(json.dumps(line), flush=True)
        del K, L, L_ref
        torch.cuda.empty_cache()
    return bad


def tile_cases(head: dict, iters: int) -> bool:
    """K3, chol_inv, K2 and K1, each against its twin; True if one is off."""
    bad = False

    def emit(kernel: str, case: str, dtype, ms: float, err: float, tol: float) -> None:
        nonlocal bad
        bad |= not err <= tol
        print(json.dumps({**head, "kernel": kernel, "case": case,
                          "dtype": str(dtype).replace("torch.", ""), "ms": ms,
                          "rel_err": err}), flush=True)

    for dtype, B in ((torch.float64, 1), (torch.float64, 8), (torch.float32, 1)):
        A = spd(chol.TILE, dtype, B, batch=B).reshape(B, chol.TILE, chol.TILE).contiguous()
        (L, W), (Lt, Wt) = chol.tile_chol_inv(A), chol.tile_chol_inv_twin(A)
        emit("K3", f"one leaf B={B}", dtype, cuda_ms(lambda: chol.tile_chol_inv(A), 10 * iters),
             max(rel(L, Lt), rel(W, Wt)), TOL[dtype])
    K = spd(1024, torch.float64, 1024, batch=1)[None]
    L, W = chol.chol_inv(K)
    L_ref = torch.linalg.cholesky_ex(K)[0]
    eye = torch.eye(1024, device="cuda", dtype=torch.float64)
    W_ref = torch.linalg.solve_triangular(L_ref, eye, upper=False)
    emit("K3", "chol_inv m=1024 B=1", torch.float64, cuda_ms(lambda: chol.chol_inv(K), iters),
         max(rel(L, L_ref), rel(W, W_ref)), 10 * TOL[torch.float64])
    for dtype in (torch.float64, torch.float32):
        L = torch.linalg.cholesky(spd(4096, dtype, 4096))[None].contiguous()
        err = rel(chol.tile_tri_inv(L), chol.tile_tri_inv_twin(L))
        emit("K2", "32 tiles of n=4096", dtype, cuda_ms(lambda: chol.tile_tri_inv(L), 10 * iters),
             err, TOL[dtype])
        emit("W's zero fill", "n=4096", dtype, cuda_ms(lambda: torch.zeros_like(L), 10 * iters),
             0.0, 0.0)
        del L
    g = torch.Generator(device="cuda").manual_seed(1)

    def uniform(*shape):
        return torch.rand(shape, generator=g, device="cuda") * 4.0 - 2.0

    for case, kind, Xs, Zs in (
            ("n=m=4096 d=1 rbf", "rbf", uniform(1, 4096, 1), None),
            ("config2 2455x2455 d=2 matern52", "matern52",
             torch.rand((1, 2455, 2), generator=g, device="cuda") * 128 / 12, None),
            ("predict k_pX B=32 1024x4096 d=1 rbf", "rbf", uniform(32, 1024, 1),
             uniform(32, 4096, 1))):
        same = Zs is None
        Zs = Xs if same else Zs
        nz = torch.full(Xs.shape[:2], 0.1, device="cuda")
        err = rel(gram.gram_unscaled(Xs, Zs, nz, kind, same),
                  gram.gram_twin(Xs, Zs, nz, kind, same))
        # r²'s rounding grows with the norms (up to ~2·(128/12)² at config 2):
        # K1_TOL scaled as chip_smoke.py scales it
        tol = K1_TOL * max(1.0, 2 * (Xs * Xs).sum(-1).max().item() / 60)
        # a launch takes tens of µs: enough of them that the clock's ramp averages out
        emit("K1", case, torch.float32,
             cuda_ms(lambda: gram.gram_unscaled(Xs, Zs, nz, kind, same), 50 * iters), err, tol)
    torch.cuda.empty_cache()
    return bad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("panel_chol_ab.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    head = {"label": args.label, "gpax_torch": gpax_torch.__file__, "card": card}
    bad = tile_cases(head, args.iters)
    bad |= panel_cases(head, args.iters)
    if bad:
        raise SystemExit("a kernel disagrees with its reference")


if __name__ == "__main__":
    main()
