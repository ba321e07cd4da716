"""Smoke test of the gpax_torch port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine
with a CUDA card, nvcc and PyTorch built for CUDA. It

1. prints the card (``torch.cuda.get_device_name``, ``nvidia-smi`` name and
   power limit) and the torch/CUDA versions;
2. builds the port's CUDA kernels from ``gpax_torch/csrc`` (one nvcc per
   source, in parallel) and times it;
3. holds kernel K1 (fused gram) against its plain PyTorch twin on the card
   over RBF/Matérn, X≡Z with scalar and vector noise, a ragged X≠Z, d ∈ {1, 8}
   and batch ∈ {1, 4}, and a batch of 1×1 grams larger than one launch
   takes, and times both at n = m = 4096, d = 1 and at viGP config 2's
   2455 × 2455, d = 2, Matérn (kernel and twin timed in turns,
   plain-kernel-kernel-plain);
4. holds kernel K2 (128-tile triangular inverse) and ``blocked_trtri`` built
   on it against the twin, in float64 (the factor path's dtype) and float32,
   at n ∈ {4096, 8192} and a batch of 8 at n = 1024, and times K2, the twin
   and ``torch.linalg.solve_triangular`` (on the whole factor, and on the
   diagonal tiles alone: K2's library yardstick); then checks, in both
   dtypes, that a zero pivot at each sub-panel border of a tile leaves every
   entry of that tile's rows from the pivot on non-finite and the rest
   finite;
5. holds kernel K3 (128-tile Cholesky and inverse) against its twin on each
   leaf of ``chol_inv``, and ``chol_inv`` against ``cholesky_ex`` +
   ``solve_triangular(L, I)``, in float32 and float64 at m ∈ {128, 1024}
   and a batch of 8 at m = 1024, on two ill-conditioned RBF tiles (κ ~ 1e6,
   the sparse GP's first leaf) in both dtypes, and a bad pivot at each
   sub-panel border of a tile in both dtypes (L NaN from its column on, W
   non-finite from its row on), and
   times K3, the twin and that library pair;
6. holds kernels K4 (single-launch panel Cholesky) and K5 (single-launch
   panel triangular inverse) against their twins in float32 and float64 at
   n = 8192, a ragged n = 4000 (identity padding), a batch of 4 at n = 1024
   and an indefinite matrix that must come back NaN, checks K4's NaN from a
   bad pivot at each sub-panel border of a tile, and times K4, K5, their
   twins, the library calls and the pair against the composed factor
   (``cholesky_ex`` + ``blocked_trtri``) at n = 8192, with K4's and K5's
   phase splits (products, diagonal tiles, panel TRSM);
7. checks the ExactGP potential and gradient on the card against the CPU
   twins at n = 512 on both likelihood routes (fused and composed), and the
   routes against each other; then times likelihood+grad on both routes at
   n ∈ {512, …, 8192} in turns and prints the crossover that sets
   ``fused_likelihood_max_n``, and which route "auto" takes for ExactGP at
   n = 4096 and viGP at config 2;
8. drives the ExactGP path on the composed route: ``gpax_torch.ExactGP(1,
   "RBF")`` fits NUTS (100 warmup + 100 draws, tree depth 7) on n = 4096
   points of sin(2x) + 0.1·noise, then ``predict_in_batches`` on 2048
   points, counting K1 and K2 launches in each phase;
9. holds K1 and K2 against their twins at that path's own shapes and
   inputs: the fit's 4096×4096 gram, and predict's grams (4096×4096,
   1024×4096, 1024×1024) and float64 factors for one chunk of posterior
   draws, the chunk sized as ``predict`` sizes it, timing K1 on the chunk's
   k_XX and its batched cross-gram k_pX; drives K4/K5's path,
   ``panel_chol_factors`` on that fit's gram (its first posterior draw's,
   with the factor path's base jitter) in float64 and float32, counting their
   launches, holds them against their twins there and times them, the
   twins, the library calls and the pair against the composed factor;
10. drives the same fit on the fused route (``use_fused_likelihood=
    "always"``), with the main path's limits, its posterior means within 4
    posterior sd of the composed fit's, and K1/K2 launches counted;
11. drives the viSparseGP path at BASELINE config 3 (bench.py's data and
    settings: n = 2000, inducing ratio 0.05 "uniform" so m = 100, 3000 SVI
    steps of 5e-3, then ``predict_in_batches`` on 2001 points in batches of
    1024), numpy inputs and no ``device`` argument, counting K1 and K3
    launches in the fit and the predict; then again at n = 20000 (m = 1000,
    eight K3 leaves per ``chol_inv``, 1000 steps); after each, K1 against
    its twin on every gram of the fitted model (Kuu, Kuf, the batch of n
    1×1 grams of the Kff diagonal) and of a predict batch (Kuu, Kuf, Kus,
    Kss), and K3 on every leaf of that batch's Kuu and capacitance B;
12. drives the viGP path at BASELINE config 2 (bench.py's 128×128 image,
    15 % of the pixels, Matérn, 250 steps of 0.05, then the 16384-point
    grid in batches of 1024) on the route "auto" takes, counting K1 and K2
    launches, then holds K1 and K2 against their twins on the fitted
    model's own grams and float64 factors;
13. drives Bayesian optimization on the composed n = 4096 fit of step 8:
    ``EI``, ``UCB``, ``POI`` and ``UE`` over its 100 draws at the 2048
    prediction points (``predict_moments``), ``qEI`` and ``qUCB`` (4 draws
    a subset, ``maximize_distance``), then ``optimize_acq(UCB)`` on the box
    of X, counting K1 and K2 launches and printing points/s of each; holds
    ``EI`` and ``UCB`` on the card against the same port call on the CPU
    (``device="cpu"``) on 4 draws and 256 points, and ``ei`` on EI's own
    moments against EI's float64 closed form;
14. drives BASELINE config 4 (bench.py:471-600's data: 320 low- and 64
    high-fidelity points, ``MultiTaskGP(1, "Matern", num_latents=1,
    num_tasks=2)``) with bench.py's fit settings (``segment_size`` 50,
    depth 8, ``warmup_depth_cap`` (5, 20), target accept 0.7, a
    ``segment_callback`` and a far ``deadline``) but 200 + 200 draws
    instead of 1000 + 4000 (the cut: the port's NUTS is driven from the
    host), checks the callback stream, the leapfrog count, accept,
    divergences and task 1's RMSE against f_hi, then runs ``EI`` on the
    101-point grid at task 1 (``ei`` held against its float64 closed form
    as in step 13) and ``KG`` on 8 of its points, then holds K1 and K2
    against their twins on the fitted model's own grams and float64
    factors: one draw's fit gram, every draw's predictive grams (the
    latent axis in the gram's batch dim) and one draw's KG fantasy grams
    (8 candidate sets of 385 points, whose factors K2 gets padded to 512);
15. fits that MultiTaskGP once more with a deadline already past: one chain
    (20 + 40, segments of 10, ``warmup_depth_cap`` (1, 20)) must freeze at
    10 warmup steps and return 10 finite draws whose trees exceed the cap,
    and two sequential chains must warn and run their whole plan;
16. prints a JSON line of the kernels K1-K5 (time, twin time, library time,
    bound, launches on every path; K4's and K5's phase splits on the fit's gram),
    the card's line, and as the last line
    ``{"ok": true, "device": {...}}``.

Any failed check ends the run with a non-zero exit and no ``ok`` line. It
refuses to run without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

import gpax_torch
from gpax_torch import acquisition as acq
from gpax_torch.ops import build, chol, gram, linalg, panel_chol
from gpax_torch.ppl import initialize_model, log_density
from gpax_torch.utils import get_keys, host_syncs, preprocess_sparse_image, reset_host_syncs

N_MAIN = 4096        # training points of the main path (bench.py's n)
NUM_WARMUP = 100
NUM_SAMPLES = 100
MAX_DEPTH = 7
PREDICT_M = 2048
PREDICT_BATCH = 1024
K1_TOL = 1e-5        # K1 vs twin, relative to max|K| (see check_k1)
K1_MAX_BATCH_CASE = gram._MAX_BATCH + 4465  # a batch of 1×1 grams over two launches
# K2 vs twin, relative to max|W|, and ‖W·L − I‖_max of blocked_trtri, on
# well-conditioned factors (see check_k2)
K2_REL_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
K2_RESID_TOL = {torch.float32: 5e-3, torch.float64: 1e-10}
# K3 vs twin, relative to max|L| and max|W|: at least this, or twice the
# first-order bound 128·eps·κ₂(L) of a factorization and a triangular
# inversion of the tile at hand (see k3_compare)
K3_REL_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# chol_inv vs cholesky_ex + solve_triangular through the recursion's GEMMs,
# relative to max|L| and max|W|, and ‖W·L − I‖_max, ‖L·Lᵀ − K‖_max/max|K|,
# on matrices of κ ≤ ~9 (see check_k3)
CHOL_INV_TOL = {torch.float32: 1e-3, torch.float64: 1e-11}
CHOL_INV_RESID_TOL = {torch.float32: 1e-3, torch.float64: 1e-10}

# K4/K5 vs their twins: L relative to max|L|, Wᵀ (against the twin on K4's
# own L) relative to max|Wᵀ|, ‖L·W − I‖_max and ‖W·L − I‖_max, each at most
# this floor or the first-order bounds 2·n·eps·κ² (L's forward error) and
# 2·n·eps·κ (the inverse), κ = ‖|L|·|W|‖_max; and the lower triangle of
# ‖L·Lᵀ − K‖_max/‖K‖_max ≤ 2·n·eps, the backward error of any Cholesky
# whatever κ (see panel_compare)
PANEL_REL_FLOOR = {torch.float32: 1e-4, torch.float64: 1e-12}
PANEL_CASES = ((8192, 1), (4000, 1), (1024, 4))  # (n, batch); the first is timed
# local indices of a bad pivot in a tile for K2 and K3: borders of the
# blocked routine's 16-column sub-panels, a row inside one, the last row
TILE_NAN_PIVOTS = (15, 16, 60, 63, 64, 127)
# local indices of a bad pivot in a tile: its ends and K4's sub-panel borders
PANEL_NAN_PIVOTS = (0, 15, 16, 31, 32, 127)
# likelihood+grad sizes of the fused/composed crossover
FUSED_NS = (512, 1024, 2048, 4096, 8192)
FUSED_SD = 4.0  # the fused fit's posterior means within this many posterior sd

# BASELINE config 3 (bench.py:433-468) and its wider inducing set
SPARSE_RATIO = 0.05
SPARSE_PHASES = (("config3", 2000, 3000), ("m1000", 20000, 1000))
SPARSE_GRID = 2001
SPARSE_BATCH = 1024
SPARSE_RMSE_MAX = 0.005           # the JAX package on the CPU: 0.00231
SPARSE_NOISE_RANGE = (0.00125, 0.005)  # the JAX package on the CPU: 0.00251
# BASELINE config 2 (bench.py:374-430)
VIGP_SIZE, VIGP_STEPS, VIGP_STEP_SIZE, VIGP_BATCH = 128, 250, 0.05, 1024
VIGP_N = 2455                     # observed pixels of config 2's image
VIGP_RMSE_MAX = 0.01              # the JAX package on the CPU: 0.00136

# Bayesian optimization on the n = 4096 fit: q-function subsets, the
# optimizer's multi-start and steps, and the card-vs-CPU check's size
BO_SUBSAMPLE, BO_STARTS, BO_STEPS = 4, 64, 10
BO_CHECK_DRAWS, BO_CHECK_POINTS = 4, 256
# the card's EI and UCB against the same port call on the CPU: both sides
# solve with float32 grams that agree to ~1e-7 relative (K1 and its twin)
# and float64 factors; cond(K) up to n·k_scale/noise ~ 4e5 at this fit
# amplifies that into the predictive moments, so the tolerance is relative
# to the largest value of the acquisition
BO_CHECK_TOL = 1e-2
# BASELINE config 4 (bench.py:471-600), cut from 1000 + 4000 draws to
# 200 + 200: the port's NUTS is driven from the host
MT_WARMUP, MT_SAMPLES, MT_SEGMENT = 200, 200, 50
MT_DEPTH, MT_DEPTH_CAP, MT_TARGET = 8, (5, 20), 0.7
MT_GRID = 101
MT_KG_POINTS, MT_KG_FANTASIES = 8, 4
MT_RMSE_MAX = 0.03  # the JAX package on the CPU (reference/config4_jax.py): 0.01566
MT_N_LO, MT_N_HI = 320, 64
# EI against its float64 closed form on the same moments: values above
# EI_REF_FLOOR·max(EI) within EI_RTOL (float32's exp(-u²/2) loses ~u²·eps
# relative, ~5e-4 at u = -9), and none below -1e-30 (float32 subnormals)
EI_RTOL, EI_REF_FLOOR = 1e-3, 1e-20
# the freeze: 20 + 40 draws in segments of 10, the head capped at depth 1,
# trees of at most 2^6 - 1 leapfrogs (tests/test_round5.py's depth)
FREEZE_WARMUP, FREEZE_SAMPLES, FREEZE_SEGMENT, FREEZE_CAP = 20, 40, 10, (1, 20)
FREEZE_DEPTH = 6

# the card's published peaks (NVIDIA's H100 SXM data sheet, 700 W): HBM
# bytes/s, and the highest FLOP/s the card offers for each dtype without a
# change of precision: float32 outside the tensor cores (TF32 would round),
# float64 on them (DMMA; cuBLAS runs the recursion's float64 GEMMs there)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms, by CUDA events over ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters: int = 20):
    """(kernel ms, plain ms), each the mean of two timings taken in the order
    plain, kernel, kernel, plain, so that the card's clock ramp favours
    neither side."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def bound(bytes_moved: float, flops: float, dtype=torch.float32) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the dtype's peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def chol_inv_bound(B: int, m: int, dtype) -> dict:
    """K3's work on B matrices of m×m: read K, write L and W; m³/3 flops for
    the Cholesky and m³/3 for the triangular inverse."""
    return bound(3 * B * m * m * dtype.itemsize, B * 2 * m**3 / 3, dtype)


def reset_counts() -> None:
    torch.cuda.synchronize()
    gram.launches = chol.launches = chol.chol_inv_launches = 0
    panel_chol.cholesky_launches = panel_chol.tri_inv_launches = 0


def counts() -> dict:
    return {"gram": gram.launches, "trtri": chol.launches, "cholinv": chol.chol_inv_launches,
            "panel_chol": panel_chol.cholesky_launches,
            "panel_tri_inv": panel_chol.tri_inv_launches}


@contextlib.contextmanager
def route(mode: str):
    """ExactGP's likelihood route (``use_fused_likelihood``) while the block
    runs; "auto" again after it."""
    gpax_torch.set_config(use_fused_likelihood=mode)
    yield
    gpax_torch.set_config(use_fused_likelihood="auto")


def require_launches(path: str, launched: dict, kernels) -> None:
    for phase, c in launched.items():
        for k in kernels:
            if c[k] <= 0:
                fail(f"kernel {k} never launched during {path} {phase}")


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| python {sys.version.split()[0]}", flush=True)
    return smi


def build_phase() -> None:
    build.library()
    print(f"build: {build.build_seconds:.2f} s -> {build.BUILD_DIR}", flush=True)
    for line in build.build_log.splitlines():
        if any(w in line.lower() for w in ("registers", "smem", "error", "entry function")):
            print(f"  ptxas: {line.strip()}")


def check_k1(dev) -> dict:
    """K1 vs its twin. Tolerance 1e-5·max|K|: both sides assemble r² from
    fp32 squared norms of at most ~30 here, so r² carries ~30·eps ≈ 4e-6 of
    rounding, which the maps pass on with slope ≤ 5/6."""
    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = []
    for kind in ("rbf", "matern52"):
        for d in (1, 8):
            for B in (1, 4):
                cases.append((kind, d, B, 1000, 1000, "scalar"))
                cases.append((kind, d, B, 1000, 1000, "vector"))
                cases.append((kind, d, B, 4000, 333, "none"))
    for kind, d, B, n, m, noise in cases:
        Xs = torch.rand((B, n, d), generator=g, device=dev) * 4.0 - 2.0
        Xs = Xs / (0.5 * d**0.5)
        same = noise != "none"
        Zs = Xs if same else (torch.rand((B, m, d), generator=g, device=dev) * 4.0 - 2.0) / (0.5 * d**0.5)
        if noise == "scalar":
            nz = torch.full((B, n), 0.3, device=dev)
        elif noise == "vector":
            nz = torch.rand((B, n), generator=g, device=dev)
        else:
            nz = torch.zeros((B, n), device=dev)
        worst = max(worst, k1_compare(f"{kind:8s} d={d} B={B} {n}x{m} noise={noise:6s}",
                                      Xs, Zs, nz, same, kind))
    # more matrices than one launch's grid takes (the sparse GP's k(x, x)
    # diagonal is a batch of n 1×1 grams): the wrapper launches per slice
    Xd = torch.rand((K1_MAX_BATCH_CASE, 1, 1), generator=g, device=dev)
    worst = max(worst, k1_compare(f"rbf d=1 B={K1_MAX_BATCH_CASE} 1x1 noise=0", Xd, Xd,
                                  torch.zeros((K1_MAX_BATCH_CASE, 1), device=dev), True))
    X = (torch.rand((1, N_MAIN, 1), generator=g, device=dev) * 4.0 - 2.0)
    nz = torch.full((1, N_MAIN), 0.1, device=dev)
    worst = max(worst, k1_compare(f"rbf d=1 B=1 {N_MAIN}x{N_MAIN} noise=scalar", X, X, nz, True))
    # K1 takes tens of µs: 200 launches a timing, so the clock's ramp averages out
    ms, plain = paired_ms(lambda: gram.gram_unscaled(X, X, nz, "rbf", True),
                          lambda: gram.gram_twin(X, X, nz, "rbf", True), 200)
    b = k1_bound(1, N_MAIN, N_MAIN, 1)
    print(f"K1 time n=m={N_MAIN} d=1 rbf: kernel {ms:.4f} ms, twin {plain:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    # viGP config 2's shape: 2455 pixel coordinates in 2-D, Matérn (m % 4 = 3:
    # rows stored element by element where a 16-byte store does not fit)
    Xc = torch.rand((1, VIGP_N, 2), generator=g, device=dev) * VIGP_SIZE / 12.0
    nzc = torch.full((1, VIGP_N), 0.01, device=dev)
    worst = max(worst, k1_compare(f"matern52 d=2 B=1 {VIGP_N}x{VIGP_N} noise=scalar", Xc, Xc,
                                  nzc, True, "matern52"))
    ms_c2, plain_c2 = paired_ms(lambda: gram.gram_unscaled(Xc, Xc, nzc, "matern52", True),
                                lambda: gram.gram_twin(Xc, Xc, nzc, "matern52", True), 200)
    bc = k1_bound(1, VIGP_N, VIGP_N, 2)
    print(f"K1 time config2 n=m={VIGP_N} d=2 matern52: kernel {ms_c2:.4f} ms, twin "
          f"{plain_c2:.4f} ms, bound {bc['bound_ms']:.4f} ms ({bc['bound_by']})", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, "library_ms": None, **b,
            "config2_ms": ms_c2, "config2_plain_ms": plain_c2, "config2_bound_ms": bc["bound_ms"]}


def k1_bound(B: int, n: int, m: int, d: int) -> dict:
    """K1's least time: read Xs, Zs and the noise once, write the gram; per
    element 2d + 4 flops (cross term, r², scale) and one exp. No one PyTorch
    call computes it."""
    return bound(4 * B * (n * d + m * d + n + n * m), B * n * m * (2 * d + 4))


def k1_compare(label: str, Xs, Zs, nz, same: bool, kind: str = "rbf") -> float:
    """max|K1 − twin| on one input, failing past K1_TOL·max|K|, a tolerance
    set for squared norms of at most 30 (see check_k1) and scaled with them
    beyond: r²'s rounding grows with ‖xs‖² + ‖zs‖²."""
    out = gram.gram_unscaled(Xs, Zs, nz, kind, same)
    ref = gram.gram_twin(Xs, Zs, nz, kind, same)
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    norms = (Xs * Xs).sum(-1).max().item() + (Zs * Zs).sum(-1).max().item()
    tol = K1_TOL * max(1.0, norms / 60.0)
    print(f"K1 {label} max|err|={err:.3e} rel={rel:.3e} (tol {tol:.1e})", flush=True)
    if not (rel <= tol):
        fail(f"K1 disagrees with its twin at {label}: rel {rel}")
    return err


def _spd_factor(n: int, B: int, seed: int, dev, dtype) -> torch.Tensor:
    """Cholesky factors of the SPD matrices of :func:`_spd`."""
    return torch.linalg.cholesky(_spd(n, B, seed, dev, dtype)).contiguous()


def twin_trtri(L: torch.Tensor) -> torch.Tensor:
    """blocked_trtri with the twin in place of K2 (n a multiple of 128)."""
    L = L.contiguous()
    W = chol.tile_tri_inv_twin(L)
    chol._trtri_rec(L, W, 0, L.shape[-1])
    return W


def k2_compare(label: str, L: torch.Tensor, W: torch.Tensor, rel_tol: float,
               resid_tol: float) -> float:
    """K2's tiles and ``blocked_trtri``'s W against the twin, and ‖W·L − I‖."""
    L = L.contiguous()
    W_twin = twin_trtri(L)
    err = (W - W_twin).abs().max().item()
    rel = err / W_twin.abs().max().item()
    tiles_twin = chol.tile_tri_inv_twin(L)
    tiles_err = (chol.tile_tri_inv(L) - tiles_twin).abs().max().item()
    tiles_rel = tiles_err / tiles_twin.abs().max().item()
    del W_twin, tiles_twin
    eye = torch.eye(L.shape[-1], device=L.device, dtype=L.dtype)
    resid = (W @ L - eye).abs().max().item()
    print(f"K2 {label}: tiles rel={tiles_rel:.3e} blocked max|err|={err:.3e} rel={rel:.3e} "
          f"(tol {rel_tol:.0e}) |WL-I|max={resid:.3e} (tol {resid_tol:.0e})", flush=True)
    if not (tiles_rel <= rel_tol and rel <= rel_tol and resid <= resid_tol):
        fail(f"K2 check failed at {label}")
    return max(err, tiles_err)


def check_k2(dev) -> dict:
    """K2 and blocked_trtri vs the twin, in float64 (the factor path's dtype)
    and float32. Tolerances rel_tol·max|W|: a tile's inverse carries
    ~κ·128·eps of rounding and κ(L) ≤ 3 for these factors (eps = 2⁻⁵³ or
    2⁻²⁴); the recursion's matmuls are the same on both sides."""
    worst = 0.0
    timing = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        for n, B in ((4096, 1), (8192, 1), (1024, 8)):
            L = _spd_factor(n, B, n + B, dev, dtype)
            W = chol.blocked_trtri(L)
            worst = max(worst, k2_compare(f"{name} n={n} B={B}", L, W,
                                          K2_REL_TOL[dtype], K2_RESID_TOL[dtype]))
            iters = 5 if n == 8192 else 10
            eye = torch.eye(n, device=dev, dtype=dtype)
            t_blk, t_twin = paired_ms(lambda: chol.blocked_trtri(L), lambda: twin_trtri(L), iters)
            t_solve = cuda_ms(lambda: torch.linalg.solve_triangular(L, eye, upper=False), iters)
            t_k2, t_k2_twin = paired_ms(lambda: chol.tile_tri_inv(L),
                                        lambda: chol.tile_tri_inv_twin(L), iters)
            t_fill = cuda_ms(lambda: torch.zeros_like(L), iters)  # the wrapper's W
            # the library call on the diagonal tiles alone, gathered beforehand
            T = n // chol.TILE
            tiles = L.view(B, T, chol.TILE, T, chol.TILE).diagonal(dim1=1, dim2=3)
            tiles = tiles.permute(0, 3, 1, 2).contiguous()
            eye_t = torch.eye(chol.TILE, device=dev, dtype=dtype).expand_as(tiles)
            t_lib = cuda_ms(lambda: torch.linalg.solve_triangular(tiles, eye_t, upper=False), iters)
            # each diagonal tile read once and its inverse written once (the
            # wrapper's zero fill of the rest of W is not the function's
            # work); 128³/3 flops per tile
            b = bound(2 * B * T * chol.TILE**2 * L.element_size(), B * T * chol.TILE**3 / 3, dtype)
            print(f"K2 time {name} n={n} B={B}: tiles K2 {t_k2:.4f} ms (W's zero fill alone "
                  f"{t_fill:.4f}), tiles twin "
                  f"{t_k2_twin:.4f} ms, tiles solve_triangular {t_lib:.4f} ms, bound "
                  f"{b['bound_ms']:.5f} ms ({b['bound_by']}) | blocked_trtri K2 {t_blk:.4f} ms, "
                  f"twin {t_twin:.4f} ms, solve_triangular(L, I) {t_solve:.4f} ms", flush=True)
            if (dtype, n, B) == (torch.float64, 4096, 1):
                timing = {"ms": t_k2, "plain_ms": t_k2_twin, "library_ms": t_lib, **b,
                          "zero_fill_ms": t_fill}
            del L, W, eye, tiles, eye_t
            torch.cuda.empty_cache()
    check_k2_nan(dev)
    return {"max_abs_err": worst, **timing}


def check_k2_nan(dev) -> None:
    """K2 with a zero pivot at local row p of the second of three tiles, for
    each p of TILE_NAN_PIVOTS, in both dtypes: as the Pallas kernel's row
    recurrence gives it, every entry of that tile's rows from p on is
    non-finite, and its rows above p and the other tiles are finite."""
    T = chol.TILE
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        for p in TILE_NAN_PIVOTS:
            L = _spd_factor(3 * T, 1, p, dev, dtype)
            L[0, T + p, T + p] = 0.0
            W = chol.tile_tri_inv(L)[0]
            tiles = [W[T * t:T * (t + 1), T * t:T * (t + 1)] for t in range(3)]
            ok = (bool(torch.isfinite(tiles[0]).all()) and bool(torch.isfinite(tiles[2]).all())
                  and bool(torch.isfinite(tiles[1][:p]).all())
                  and not bool(torch.isfinite(tiles[1][p:]).any()))
            print(f"K2 {name} zero pivot at local row {p} of tile 1: finite above it, non-finite "
                  f"rows from it on: {ok}", flush=True)
            if not ok:
                fail(f"K2 does not propagate a zero pivot at local row {p} ({name})")


def _spd(n: int, B: int, seed: int, dev, dtype) -> torch.Tensor:
    """Well-conditioned SPD matrices A·Aᵀ/n + ½I (κ ≤ ~9)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((B, n, n), generator=g, device=dev, dtype=dtype)
    K = A @ A.mT / n
    K.diagonal(dim1=-2, dim2=-1).add_(0.5)
    return K


def twin_chol_inv(K):
    """chol_inv with the twin in place of K3 at every leaf."""
    k3 = chol.tile_chol_inv
    chol.tile_chol_inv = chol.tile_chol_inv_twin
    try:
        return chol.chol_inv(K)
    finally:
        chol.tile_chol_inv = k3


@contextlib.contextmanager
def captured(module, name: str):
    """The arguments of every call of ``module.name`` (a kernel's wrapper)
    while the block runs, as the path's own code makes them."""
    calls, fn = [], getattr(module, name)

    def capture(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return fn(*args)

    setattr(module, name, capture)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def k1_compare_calls(label: str, calls) -> None:
    """K1 against its twin on each captured call of ``gram_unscaled``."""
    for i, (Xs, Zs, nz, kind, same) in enumerate(calls):
        (B, n, d), m = Xs.shape, Zs.shape[1]
        k1_compare(f"{label} gram {i}: {kind} d={d} B={B} {n}x{m} noise={same}",
                   Xs, Zs, nz, same, kind)


def k3_compare(label: str, A: torch.Tensor) -> float:
    """K3 against its twin on tiles A (B, 128, 128), relative to max|L| and
    max|W|. Tolerance: K3_REL_TOL, or 2·128·eps·κ₂(L) of the worst tile
    where that is larger: each side is within the first-order error bound
    n·eps·κ(L) of a Cholesky factorization and a triangular inversion, which
    an ill-conditioned leaf of a real Kuu reaches, and the two round
    differently (products with 1/L_ii and blocked DMMA or FMA sums against
    cuSOLVER and cuBLAS)."""
    L, W = chol.tile_chol_inv(A)
    Lt, Wt = chol.tile_chol_inv_twin(A)
    kappa = (torch.linalg.matrix_norm(Lt, ord=2) * torch.linalg.matrix_norm(Wt, ord=2)).max().item()
    tol = max(K3_REL_TOL[A.dtype], 2 * chol.TILE * torch.finfo(A.dtype).eps * kappa)
    err_L = (L - Lt).abs().max().item()
    err_W = (W - Wt).abs().max().item()
    rel_L = err_L / Lt.abs().max().item()
    rel_W = err_W / Wt.abs().max().item()
    print(f"K3 {label}: L rel={rel_L:.3e} W rel={rel_W:.3e} (tol {tol:.1e}, kappa2(L) {kappa:.3e})",
          flush=True)
    if not (rel_L <= tol and rel_W <= tol):
        fail(f"K3 disagrees with its twin at {label}")
    return max(err_L, err_W)


def check_k3(dev) -> dict:
    """K3 against its twin on every leaf of chol_inv, and chol_inv against
    ``cholesky_ex`` + ``solve_triangular(L, I)``, in float32 and float64, at
    m ∈ {128, 1024} and a batch of 8 at m = 1024, on A·Aᵀ/m + ½I (κ ≤ ~9;
    tolerances CHOL_INV_TOL relative to max|L| and max|W| and
    CHOL_INV_RESID_TOL on ‖W·L − I‖ and ‖L·Lᵀ − K‖/max|K|: the recursion's
    GEMMs add rounding of order m·eps·κ to the leaves'). Then indefinite
    tiles, which must come back NaN (check_k3_nan). Times K3, its twin and
    the library pair on the leaves, and chol_inv, its twin recursion and the
    library pair on the whole matrix."""
    worst = 0.0
    timing = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for m, B in ((128, 1), (1024, 1), (1024, 8)):
            K = _spd(m, B, m + B, dev, dtype)
            with captured(chol, "tile_chol_inv") as leaves:
                L, W = chol.chol_inv(K)
            for i, (A,) in enumerate(leaves):
                worst = max(worst, k3_compare(f"{name} m={m} B={B} leaf {i}", A))
            L_ref, _ = torch.linalg.cholesky_ex(K)
            eye = torch.eye(m, device=dev, dtype=dtype)
            W_ref = torch.linalg.solve_triangular(L_ref, eye.expand_as(K), upper=False)
            rel_L = ((L - L_ref).abs().max() / L_ref.abs().max()).item()
            rel_W = ((W - W_ref).abs().max() / W_ref.abs().max()).item()
            r_inv = (W @ L - eye).abs().max().item()
            r_fac = ((L @ L.mT - K).abs().max() / K.abs().max()).item()
            print(f"chol_inv {name} m={m} B={B}: {len(leaves)} leaves, L rel={rel_L:.3e} "
                  f"W rel={rel_W:.3e} (tol {CHOL_INV_TOL[dtype]:.0e}) |WL-I|max={r_inv:.3e} "
                  f"|LLt-K|/|K|={r_fac:.3e} (tol {CHOL_INV_RESID_TOL[dtype]:.0e})", flush=True)
            if not (rel_L <= CHOL_INV_TOL[dtype] and rel_W <= CHOL_INV_TOL[dtype]
                    and r_inv <= CHOL_INV_RESID_TOL[dtype]
                    and r_fac <= CHOL_INV_RESID_TOL[dtype]):
                fail(f"chol_inv check failed at {name} m={m} B={B}")

            tiles = K[:, :chol.TILE, :chol.TILE].contiguous()
            eye_t = torch.eye(chol.TILE, device=dev, dtype=dtype).expand_as(tiles)
            t_k3, t_twin = paired_ms(lambda: chol.tile_chol_inv(tiles),
                                     lambda: chol.tile_chol_inv_twin(tiles))
            t_lib = cuda_ms(lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky_ex(tiles)[0], eye_t, upper=False))
            b = chol_inv_bound(B, chol.TILE, dtype)
            line = (f"K3 time {name} B={B} one leaf: K3 {t_k3:.4f} ms, twin {t_twin:.4f} ms, "
                    f"cholesky_ex+solve_triangular {t_lib:.4f} ms, bound {b['bound_ms']:.6f} ms "
                    f"({b['bound_by']})")
            if m > chol.TILE:
                eye_b = eye.expand_as(K)
                t_ci, t_ci_twin = paired_ms(lambda: chol.chol_inv(K), lambda: twin_chol_inv(K), 10)
                t_ci_lib = cuda_ms(lambda: torch.linalg.solve_triangular(
                    torch.linalg.cholesky_ex(K)[0], eye_b, upper=False), 10)
                bm = chol_inv_bound(B, m, dtype)
                line += (f" | chol_inv m={m}: K3 leaves {t_ci:.4f} ms, twin leaves "
                         f"{t_ci_twin:.4f} ms, cholesky_ex+solve_triangular {t_ci_lib:.4f} ms, "
                         f"bound {bm['bound_ms']:.4f} ms ({bm['bound_by']})")
            print(line, flush=True)
            # the kernels line: one float64 leaf, as config 3 launches it
            if (dtype, m, B) == (torch.float64, 128, 1):
                timing = {"ms": t_k3, "plain_ms": t_twin, "library_ms": t_lib, **b}
            del K, L, W, L_ref, W_ref, leaves
            torch.cuda.empty_cache()
    # ill-conditioned tiles as the sparse GP's first leaf sees them: RBF
    # grams of 128 inducing points at the spacing 4/m of bench.py's data,
    # near the fitted ℓ and k_scale, plus the float32 jitter 4·m·eps
    eps32 = torch.finfo(torch.float32).eps
    for spacing, ls, ks, m in ((0.004, 1.15, 2.0, 1000), (0.04, 0.8, 0.9, 100)):
        x = spacing * torch.arange(chol.TILE, device=dev, dtype=torch.float64)
        K = ks * torch.exp(-0.5 * ((x[:, None] - x[None, :]) / ls) ** 2)
        K.diagonal().add_(gpax_torch.get_config().default_jitter + 4 * m * eps32)
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).replace("torch.", "")
            k3_compare(f"{name} RBF tile spacing {spacing} l={ls} k_scale={ks} jitter(m={m})",
                       K.to(dtype)[None].contiguous())
    check_k3_nan(dev)
    return {"max_abs_err": worst, **timing}


def check_k3_nan(dev) -> None:
    """K3 on one batch of a good tile and a tile for each p of
    TILE_NAN_PIVOTS with a bad pivot at row p, in both dtypes: the good tile
    finite; L zero above the diagonal, finite before column p and NaN in
    every lower entry from p on; W non-finite in every entry of its rows from
    p on (above the diagonal too) and finite above p."""
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        A = _spd(chol.TILE, len(TILE_NAN_PIVOTS) + 1, 9, dev, dtype)
        for b, p in enumerate(TILE_NAN_PIVOTS, 1):
            A[b, p, p] = -1.0
        L, W = chol.tile_chol_inv(A)
        if not (bool(torch.isfinite(L[0]).all()) and bool(torch.isfinite(W[0]).all())):
            fail(f"K3 ({name}): the good tile of a batch with bad ones is not finite")
        for b, p in enumerate(TILE_NAN_PIVOTS, 1):
            ok = (torch.count_nonzero(torch.triu(L[b], 1)).item() == 0
                  and panel_nan_from(L[b], p)
                  and bool(torch.isfinite(W[b, :p]).all())
                  and not bool(torch.isfinite(W[b, p:]).any()))
            print(f"K3 {name} bad pivot at row {p}: L finite before it and NaN from it on, W "
                  f"finite above it and non-finite rows from it on: {ok}", flush=True)
            if not ok:
                fail(f"K3 does not propagate NaN from a bad pivot at row {p} ({name})")


def panel_compare(label: str, K: torch.Tensor):
    """K4 and K5 (``panel_chol_factors``) against their twins on K (…, n, n):
    K4's L against ``cholesky_ex``'s, K5's Wᵀ against the twin's on K4's own
    L, ‖L·W − I‖ and ‖W·L − I‖, and ‖tril(L·Lᵀ − K)‖, with the tolerances
    of PANEL_REL_FLOOR. An input the twin cannot factor must come back
    non-finite from K4 too.
    Returns K4's and K5's max|err| against their twins."""
    L, W = panel_chol.panel_chol_factors(K)
    L_t = panel_chol.panel_cholesky_twin(K)
    n, dtype = K.shape[-1], K.dtype
    fin, fin_t = bool(torch.isfinite(L).all()), bool(torch.isfinite(L_t).all())
    if not (fin and fin_t):
        print(f"K4/K5 {label}: finite L {fin}, twin {fin_t}", flush=True)
        if fin != fin_t:
            fail(f"K4 and its twin disagree on whether {label} factors")
        return 0.0, 0.0
    WT_t = panel_chol.panel_tri_inv_t_twin(L)
    eps = torch.finfo(dtype).eps
    kappa = (L.abs() @ W.abs()).amax().item()
    tol_L = max(PANEL_REL_FLOOR[dtype], 2 * n * eps * kappa**2)
    tol_W = max(PANEL_REL_FLOOR[dtype], 2 * n * eps * kappa)
    tol_fac = 2 * n * eps
    err_L = (L - L_t).abs().max().item()
    err_W = (W.mT - WT_t).abs().max().item()
    rel_L = err_L / L_t.abs().max().item()
    rel_W = err_W / WT_t.abs().max().item()
    eye = torch.eye(n, device=K.device, dtype=dtype)
    r_inv = max((L @ W - eye).abs().max().item(), (W @ L - eye).abs().max().item())
    # both factorizations read K's lower triangle only (a float32 gram's r²
    # is symmetric only to rounding)
    r_fac = (torch.tril(L @ L.mT - K).abs().max() / K.abs().max()).item()
    print(f"K4/K5 {label}: kappa {kappa:.3e}; L rel={rel_L:.3e} (tol {tol_L:.1e}) "
          f"W^T rel={rel_W:.3e} max(|LW-I|,|WL-I|)={r_inv:.3e} (tol {tol_W:.1e}) "
          f"|LLt-K|/|K|={r_fac:.3e} (tol {tol_fac:.1e})", flush=True)
    if not (rel_L <= tol_L and rel_W <= tol_W and r_inv <= tol_W and r_fac <= tol_fac):
        fail(f"K4/K5 check failed at {label}")
    return err_L, err_W


def composed_factors(K: torch.Tensor):
    """The port's factor path without its jitter: ``cholesky_ex`` and
    ``blocked_trtri`` (K2), the pair K4/K5 competes with."""
    L = torch.linalg.cholesky_ex(K)[0]
    return L, chol.blocked_trtri(L)


def panel_bound(n: int, dtype) -> dict:
    """K4 or K5 alone on one n×n matrix: read n², write n²; n³/3 flops."""
    return bound(2 * n * n * torch.finfo(dtype).bits // 8, n**3 / 3, dtype)


def panel_phases(kernel: str, label: str, A: torch.Tensor, t: float, reps: int = 5) -> dict:
    """K4's phase split on K (``cholesky_phase_ms``) or K5's on L
    (``tri_inv_phase_ms``): the mean over ``reps`` launches of the ms in the
    products, the diagonal tiles (K4's step, K5's inverses) and the panel
    TRSM, printed beside the kernel's CUDA-event time t."""
    fn = panel_chol.cholesky_phase_ms if kernel == "K4" else panel_chol.tri_inv_phase_ms
    split = np.mean([fn(A) for _ in range(reps)], axis=0)
    total = float(split.sum())
    tiles = A.shape[-1] // chol.TILE
    diag = "diagonal step" if kernel == "K4" else "diagonal inverses"
    print(f"{kernel} phases {label}: products {split[0]:.4f} ms ({split[0] / total:.1%}), {diag} "
          f"{split[1]:.4f} ms ({split[1] / total:.1%}; {split[1] / tiles:.4f} ms a panel), "
          f"panel TRSM {split[2]:.4f} ms ({split[2] / total:.1%}); sum {total:.4f} ms, "
          f"CUDA-event time {t:.4f} ms", flush=True)
    return dict(zip(("products", "diagonal", "trsm"), map(float, split)))


def time_panel(label: str, K: torch.Tensor, iters: int) -> dict:
    """K4, K5, their twins, the library calls and the pair against the
    composed factor on one matrix K (n, n), kernel and plain in turns, and
    K4's and K5's phase splits."""
    n, dtype = K.shape[-1], K.dtype
    L = panel_chol.panel_cholesky(K)
    eye = torch.eye(n, device=K.device, dtype=dtype)
    t4, t4_twin = paired_ms(lambda: panel_chol.panel_cholesky(K),
                            lambda: panel_chol.panel_cholesky_twin(K), iters)
    t4_lib = cuda_ms(lambda: torch.linalg.cholesky_ex(K), iters)
    t5, t5_twin = paired_ms(lambda: panel_chol.panel_tri_inv_t(L),
                            lambda: panel_chol.panel_tri_inv_t_twin(L), iters)
    t5_lib = cuda_ms(lambda: torch.linalg.solve_triangular(L, eye, upper=False).mT, iters)
    t_pair, t_comp = paired_ms(lambda: panel_chol.panel_chol_factors(K),
                               lambda: composed_factors(K), iters)
    b = panel_bound(n, dtype)
    size = torch.finfo(dtype).bits // 8
    reread = n**3 / (2 * chol.TILE) * size
    print(f"K4/K5 time {label}: K4 {t4:.4f} ms, twin {t4_twin:.4f}, cholesky_ex {t4_lib:.4f} | "
          f"K5 {t5:.4f} ms, twin {t5_twin:.4f}, solve_triangular(L, I)^T {t5_lib:.4f} | "
          f"pair {t_pair:.4f} ms, cholesky_ex+blocked_trtri {t_comp:.4f} | bound each "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes {2 * n * n * size / 1e6:.1f} MB, "
          f"left-looking re-reads {reread / 1e9:.2f} GB)", flush=True)
    return {"k4": {"ms": t4, "plain_ms": t4_twin, "library_ms": t4_lib, **b,
                   "phases_ms": panel_phases("K4", label, K, t4)},
            "k5": {"ms": t5, "plain_ms": t5_twin, "library_ms": t5_lib, **b,
                   "phases_ms": panel_phases("K5", label, L, t5)}}


def check_panel_nan(dev, dtype) -> None:
    """An indefinite matrix beside a good one in a batch: K4 and K5 leave the
    good one and the bad one's panels before the failing pivot finite, and
    give NaN from that pivot on, in column 200 of L and rows 200… of W."""
    name = str(dtype).replace("torch.", "")
    K = _spd(300, 2, 7, dev, dtype)
    K[1, 200, 200] = -1.0
    L, W = panel_chol.panel_chol_factors(K)
    nan_ok = (bool(torch.isfinite(L[0]).all()) and bool(torch.isfinite(W[0]).all())
              and bool(torch.isfinite(L[1, :200, :200]).all())
              and bool(torch.isnan(L[1, 200:, 200]).all())
              and not bool(torch.isfinite(W[1, 200:, :200]).any()))
    print(f"K4/K5 {name} indefinite matrix: NaN from the failing pivot on: {nan_ok}",
          flush=True)
    if not nan_ok:
        fail(f"K4/K5 do not propagate NaN from an indefinite pivot ({name})")
    # a bad pivot at each sub-panel border of the second tile, one matrix each
    K = _spd(3 * chol.TILE, len(PANEL_NAN_PIVOTS), 8, dev, dtype)
    for b, q in enumerate(PANEL_NAN_PIVOTS):
        K[b, chol.TILE + q, chol.TILE + q] = -1.0
    L = panel_chol.panel_cholesky(K)
    for b, q in enumerate(PANEL_NAN_PIVOTS):
        ok = panel_nan_from(L[b], chol.TILE + q)
        print(f"K4 {name} bad pivot at local index {q} of tile 1: finite before it, NaN from "
              f"it on: {ok}", flush=True)
        if not ok:
            fail(f"K4 does not propagate NaN from a bad pivot at local index {q} ({name})")


def panel_nan_from(L: torch.Tensor, q: int) -> bool:
    """Columns of L before q finite, and every lower entry of columns q… NaN."""
    low = torch.ones_like(L[q:, q:], dtype=torch.bool).tril()
    return bool(torch.isfinite(L[:, :q]).all()) and bool(torch.isnan(L[q:, q:][low]).all())


def check_panel(dev):
    """K4/K5 against their twins in float32 and float64 on A·Aᵀ/n + ½I at
    n = 8192, a ragged n = 4000 and a batch of 4 at n = 1024, and on an
    indefinite matrix, which must come back NaN from the bad pivot on; then
    timed at n = 8192 in both dtypes. Returns K4's and K5's max|err|."""
    worst = np.zeros(2)
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        probe = torch.zeros((1, chol.TILE, chol.TILE), device=dev, dtype=dtype)
        print(f"K4/K5 {name} cooperative grid: {panel_chol._blocks(0, probe)} / "
              f"{panel_chol._blocks(1, probe)} blocks", flush=True)
        for n, B in PANEL_CASES:
            K = _spd(n, B, n + B, dev, dtype)
            worst = np.maximum(worst, panel_compare(f"{name} n={n} B={B}", K))
            if (n, B) == PANEL_CASES[0]:
                time_panel(f"{name} n={n}", K[0], 5)
            del K
            torch.cuda.empty_cache()
        check_panel_nan(dev, dtype)
    return worst


def bench_data(n: int):
    """The data of bench.py's ExactGP config: x ~ U(-2, 2), y = sin(2x) + 0.1ε."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n).astype(np.float32)).astype(np.float32)
    return X, y


POTENTIAL_Z = {"k_length": [np.log(0.7)], "k_scale": np.log(1.3), "noise": np.log(0.1)}


def potential_and_grad(gp, X, y, device):
    """(potential, its gradient) of gp.model on (X, y) at POTENTIAL_Z, with
    the potential function and a closure that re-evaluates both."""
    info = initialize_model(gp.model, torch.Generator(device=device).manual_seed(0), (X, y))
    zz = {k: torch.tensor(v, dtype=torch.float32, device=device, requires_grad=True)
          for k, v in POTENTIAL_Z.items()}

    def value_and_grad():
        u = info.potential_fn(zz)
        return u, torch.autograd.grad(u, list(zz.values()))

    u, grads = value_and_grad()
    return u.item(), torch.cat([g.reshape(-1) for g in grads]).cpu(), value_and_grad


def check_potential(dev) -> None:
    """ExactGP potential and gradient at a fixed point at n = 512, on the
    composed and the fused likelihood route: CUDA kernels vs the CPU twins
    on each route, and the routes against each other on each device.
    Tolerance 5e-3 relative: the two float32 grams differ by ~1e-6
    relative, which K's condition number (~7e3 here, n·k_scale/noise) can
    amplify; the float64 factor path adds little, and the routes differ only
    in where the diagonal's float32 sum rounds and in the backward's order."""
    X, y = bench_data(N_MAIN)
    gp = gpax_torch.ExactGP(1, "RBF")
    out = {}
    for mode in ("never", "always"):
        with route(mode):
            for device in ("cpu", dev):
                Xd = torch.as_tensor(X[:512], device=device)
                yd = torch.as_tensor(y[:512], device=device)
                out[mode, str(device)] = potential_and_grad(gp, Xd, yd, device)[:2]
    pairs = [(("never", "cpu"), ("never", str(dev))), (("always", "cpu"), ("always", str(dev))),
             (("never", "cpu"), ("always", "cpu")), (("never", str(dev)), ("always", str(dev)))]
    for a, b in pairs:
        (u_a, g_a), (u_b, g_b) = out[a], out[b]
        rel_u = abs(u_b - u_a) / abs(u_a)
        rel_g = ((g_b - g_a).abs().max() / g_a.abs().max()).item()
        print(f"potential n=512 {a} vs {b}: {u_a:.6f} vs {u_b:.6f} rel {rel_u:.2e}; "
              f"grad rel {rel_g:.2e} (tol 5e-3)", flush=True)
        if not (rel_u <= 5e-3 and rel_g <= 5e-3):
            fail(f"ExactGP potential {a} disagrees with {b}")


def fused_crossover(dev) -> int:
    """Likelihood+grad (the potential and its gradient, as a leapfrog calls
    them) on the fused and the composed route at each n of FUSED_NS, timed
    in two rounds of turns (composed, fused, fused, composed); returns the
    largest n at which the fused route's mean was faster (0 if at none)."""
    X, y = bench_data(max(FUSED_NS))
    gp = gpax_torch.ExactGP(1, "RBF")
    crossover = 0
    print("likelihood+grad ms on the H100: n, fused, composed, fused/composed "
          "(means of 4 timings; [min, max] of each)", flush=True)
    for n in FUSED_NS:
        Xd = torch.as_tensor(X[:n], device=dev)
        yd = torch.as_tensor(y[:n], device=dev)
        step = potential_and_grad(gp, Xd, yd, dev)[2]
        iters = 5 if n >= 4096 else 20
        t = {"never": [], "always": []}
        for mode in ("never", "always", "always", "never") * 2:
            with route(mode):
                t[mode].append(cuda_ms(step, iters))
        fused, composed = np.mean(t["always"]), np.mean(t["never"])
        print(f"  {n} {fused:.4f} {composed:.4f} {fused / composed:.4f} "
              f"[{min(t['always']):.4f}, {max(t['always']):.4f}] "
              f"[{min(t['never']):.4f}, {max(t['never']):.4f}]", flush=True)
        if fused < composed:
            crossover = n
    print(f"fused/composed crossover: the fused route is faster up to n = {crossover}; "
          f"committed fused_likelihood_max_n = {gpax_torch.get_config().fused_likelihood_max_n}",
          flush=True)
    return crossover


def auto_routes(dev) -> None:
    """Which route "auto" takes for ExactGP at n = 4096 and for viGP at
    config 2 (2455 observed pixels, Matérn 2-D), on the card."""
    params = {"k_length": torch.ones(1, device=dev), "k_scale": torch.ones((), device=dev),
              "period": None}
    gp = gpax_torch.ExactGP(1, "RBF")
    vgp = gpax_torch.viGP(2, "Matern")
    names = {True: "fused", False: "composed"}
    exact = gp._fused_likelihood_ok(torch.zeros((N_MAIN, 1), device=dev), params)
    vigp = vgp._fused_likelihood_ok(torch.zeros((2455, 2), device=dev),
                                    dict(params, k_length=torch.ones(2, device=dev)))
    print(f"route of \"auto\": ExactGP n={N_MAIN} {names[exact]}, viGP config2 n=2455 "
          f"{names[vigp]}", flush=True)


def main_path(dev, mode: str) -> dict:
    """The ExactGP fit and predict, with the fit's likelihood on the route
    ``mode`` ("never": composed, "always": fused)."""
    X_np, y_np = bench_data(N_MAIN)
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    k_fit, k_pred = get_keys(0)
    gp = gpax_torch.ExactGP(1, "RBF")

    reset_counts()
    reset_host_syncs()
    t0 = time.perf_counter()
    with route(mode):
        gp.fit(k_fit, X, y, num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES,
               max_tree_depth=MAX_DEPTH, print_summary=False, progress_bar=False)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    syncs = host_syncs()
    fit_launch = counts()

    samples = gp.get_samples()
    stats = gp.mcmc.get_extra_fields()
    leapfrogs = gp.mcmc.num_leapfrogs
    accept = stats["accept_prob"].mean().item()
    divergences = int(stats["diverging"].sum())
    finite = all(bool(torch.isfinite(v).all()) for v in samples.values())

    X_new = torch.linspace(-2, 2, PREDICT_M, device=dev)[:, None]
    chunk = gp._chunk_size(NUM_SAMPLES, PREDICT_BATCH, with_test_cov=True)
    reset_counts()
    t0 = time.perf_counter()
    mean, draws = gp.predict_in_batches(k_pred, X_new, batch_size=PREDICT_BATCH, noiseless=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_launch = counts()

    rmse = float(np.sqrt(np.mean((mean.numpy() - np.sin(2 * X_new[:, 0].cpu().numpy())) ** 2)))
    summary = {
        "n": N_MAIN, "num_warmup": NUM_WARMUP, "num_samples": NUM_SAMPLES,
        "max_tree_depth": MAX_DEPTH, "fit_s": fit_s, "leapfrogs": leapfrogs,
        "leapfrogs_per_s": leapfrogs / fit_s, "ms_per_leapfrog": 1e3 * fit_s / max(leapfrogs, 1),
        "accept_mean": accept, "divergences": divergences,
        "host_syncs": syncs, "host_syncs_per_leapfrog": syncs / max(leapfrogs, 1),
        "timing": gp.mcmc.timing, "predict_m": PREDICT_M, "predict_s": pred_s,
        "predict_points_per_s": PREDICT_M / pred_s, "predict_chunk": chunk,
        "posterior_rmse": rmse,
        "posterior_mean": {k: v.float().mean().item() for k, v in samples.items()},
        "launches_fit": fit_launch, "launches_predict": pred_launch,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"main path, use_fused_likelihood={mode}: " + json.dumps(summary), flush=True)
    if not finite:
        fail("non-finite posterior samples")
    if not 0.5 <= accept <= 0.99:
        fail(f"mean accept {accept} outside [0.5, 0.99]")
    if divergences > 0.05 * NUM_SAMPLES:
        fail(f"{divergences} divergences in {NUM_SAMPLES} draws")
    if not (mean.shape == (PREDICT_M,) and draws.shape == (NUM_SAMPLES, 1, PREDICT_M)
            and bool(torch.isfinite(mean).all()) and bool(torch.isfinite(draws).all())):
        fail(f"predict output: shapes {tuple(mean.shape)}, {tuple(draws.shape)} or non-finite")
    if not rmse <= 0.03:
        fail(f"posterior RMSE {rmse} > 0.03")
    launched = {"fit": fit_launch, "predict": pred_launch}
    require_launches("ExactGP", launched, ("gram", "trtri"))
    return launched, gp, chunk


def check_main_shapes(gp, chunk: int) -> None:
    """K1 and K2 against their twins on the main path's own inputs: the
    fitted draws, bench.py's X and the first predict batch. K1 gets the fit's
    gram (one draw) and predict's three grams for ``chunk`` draws; K2 gets
    the float64 factors of that chunk's k_XX, as ``chol_tri_factors`` makes
    them. K2 tolerance 1e-7·max|W| and ‖W·L − I‖ ≤ 1e-6: κ(K) ≤ n·k_scale/noise
    puts κ(L) near 1e3 for these draws, so float64 rounding through the
    recursion stays near κ(L)·n·2⁻⁵³ ≈ 1e-9."""
    X = gp.X_train
    X_new = torch.linspace(-2, 2, PREDICT_M, device=X.device)[:PREDICT_BATCH, None]
    s = {k: v[:chunk] for k, v in gp.get_samples().items()}
    jitter = gpax_torch.get_config().default_jitter
    ls = s["k_length"][:, None, :]                        # (B, 1, d)
    nz_train = ((s["noise"] + jitter) / s["k_scale"])[:, None]
    nz_test = (jitter / s["k_scale"])[:, None]           # noiseless k_pp
    B, n, m = chunk, X.shape[0], X_new.shape[0]
    Xs = (X / ls).contiguous()
    Xn = (X_new / ls).contiguous()
    k1_compare(f"fit k_XX B=1 {n}x{n}", Xs[:1], Xs[:1], nz_train[:1].expand(1, n).contiguous(),
               True)
    k_xx = nz_train.expand(B, n).contiguous()
    k1_compare(f"predict k_XX B={B} {n}x{n}", Xs, Xs, k_xx, True)
    k1_compare(f"predict k_pX B={B} {m}x{n}", Xn, Xs, torch.zeros((B, m), device=X.device),
               False)
    k1_compare(f"predict k_pp B={B} {m}x{m}", Xn, Xn, nz_test.expand(B, m).contiguous(), True)
    ms, plain = paired_ms(lambda: gram.gram_unscaled(Xs, Xs, k_xx, "rbf", True),
                          lambda: gram.gram_twin(Xs, Xs, k_xx, "rbf", True), 5)
    print(f"K1 time predict k_XX B={B} {n}x{n}: kernel {ms:.4f} ms, twin {plain:.4f} ms",
          flush=True)
    del k_xx
    nz0 = torch.zeros((B, m), device=X.device)
    ms, plain = paired_ms(lambda: gram.gram_unscaled(Xn, Xs, nz0, "rbf", False),
                          lambda: gram.gram_twin(Xn, Xs, nz0, "rbf", False), 50)
    b = k1_bound(B, m, n, 1)
    print(f"K1 time predict k_pX B={B} {m}x{n}: kernel {ms:.4f} ms, twin {plain:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)

    K = gp.kernel(X, X, s, s["noise"])
    L, W, _ = linalg._chol_tri_factors_ld(K)
    del K
    k2_compare(f"float64 factors of predict k_XX B={B} n={n}", L, W, 1e-7, 1e-6)
    L = L.contiguous()
    ms, plain = paired_ms(lambda: chol.tile_tri_inv(L), lambda: chol.tile_tri_inv_twin(L), 5)
    print(f"K2 time predict factors B={B} n={n}: tiles K2 {ms:.4f} ms, twin {plain:.4f} ms",
          flush=True)
    del L, W
    torch.cuda.empty_cache()


def panel_path(gp):
    """K4/K5's path: ``panel_chol_factors`` on the main path's own gram, the
    fit's k_XX for its first posterior draw (as ``check_main_shapes`` takes
    it) with the factor path's base jitter 4·n·eps, in float64 (the factor
    path's dtype) and float32, with the launches counted; then K4/K5
    against their twins on those grams, and timed on the float64 one."""
    X = gp.X_train
    s = {k: v[:1] for k, v in gp.get_samples().items()}
    n = X.shape[0]
    K = gp.kernel(X, X, s, s["noise"])
    K.diagonal(dim1=-2, dim2=-1).add_(4.0 * n * torch.finfo(torch.float32).eps)
    grams = {torch.float64: K.double(), torch.float32: K}
    reset_counts()
    for Kd in grams.values():
        L, W = panel_chol.panel_chol_factors(Kd)
    torch.cuda.synchronize()
    launched = {"fit gram": counts()}
    del L, W
    require_launches("ExactGP panel factors", launched, ("panel_chol", "panel_tri_inv"))
    worst = np.zeros(2)
    for dtype, Kd in grams.items():
        name = str(dtype).replace("torch.", "")
        worst = np.maximum(worst, panel_compare(f"{name} fit gram B=1 n={n}", Kd))
    timing = time_panel(f"float64 fit gram n={n}", grams[torch.float64][0], 10)
    del grams, K
    torch.cuda.empty_cache()
    return launched, worst, timing


def check_fused_posterior(composed: dict, fused: dict) -> None:
    """The fused fit's posterior means within FUSED_SD posterior sd of the
    composed fit's (``tests/test_fused_density.py:105-108``)."""
    for site in ("k_length", "k_scale", "noise"):
        mf, mc = fused[site].float().mean().item(), composed[site].float().mean().item()
        sc = composed[site].float().std().item() + 1e-6
        print(f"fused vs composed posterior {site}: mean {mf:.5f} vs {mc:.5f}, "
              f"|diff|/sd {abs(mf - mc) / sc:.3f} (tol {FUSED_SD})", flush=True)
        if not abs(mf - mc) < FUSED_SD * sc:
            fail(f"the fused fit's posterior mean of {site} is off the composed fit's")


def sparse_data(n: int):
    """bench.py's config-3 data: x ~ U(0, 4), y = sin(3x)·e^(−0.3x) + 0.05ε."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 4, n)
    y = np.sin(3 * X) * np.exp(-0.3 * X) + 0.05 * rng.normal(size=n)
    return X, y


def sparse_path(label: str, n: int, num_steps: int):
    """viSparseGP on bench.py's data and settings: numpy inputs and no
    ``device`` argument (the card by default), ratio 0.05 "uniform", Adam
    5e-3, then predict_in_batches on linspace(0, 4, 2001) in batches of
    1024. Counts K1/K3 launches in the fit and the predict."""
    X, y = sparse_data(n)
    key_fit, key_pred = get_keys(0)
    model = gpax_torch.viSparseGP(input_dim=1, kernel="RBF")
    reset_counts()
    reset_host_syncs()
    t0 = time.perf_counter()
    model.fit(key_fit, X, y, inducing_points_ratio=SPARSE_RATIO,
              inducing_points_selection="uniform", num_steps=num_steps,
              print_summary=False, progress_bar=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launch, syncs = counts(), host_syncs()
    losses = model.loss.cpu()
    med = {k: v.detach().cpu() for k, v in model.get_samples().items()}

    grid = np.linspace(0, 4, SPARSE_GRID).astype(np.float32)
    reset_counts()
    t0 = time.perf_counter()
    mean, var = model.predict_in_batches(key_pred, grid, batch_size=SPARSE_BATCH)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_launch = counts()
    truth = np.sin(3 * grid) * np.exp(-0.3 * grid)
    rmse = float(np.sqrt(np.mean((mean.numpy() - truth) ** 2)))
    noise = med["noise"].item()
    summary = {
        "n": n, "m": int(model.Xu.shape[0]), "num_steps": num_steps, "fit_s": fit_s,
        "svi_steps_per_s": num_steps / fit_s, "host_syncs_per_step": syncs / num_steps,
        "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
        "median": {k: v.tolist() for k, v in med.items()},
        "predict_points": SPARSE_GRID, "predict_s": pred_s,
        "predict_points_per_s": SPARSE_GRID / pred_s, "rmse": rmse,
        "var_min": var.min().item(), "var_max": var.max().item(),
        "launches_fit": fit_launch, "launches_predict": pred_launch,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"viSparseGP {label}: " + json.dumps(summary), flush=True)
    finite = (bool(torch.isfinite(losses).all()) and bool(torch.isfinite(mean).all())
              and bool(torch.isfinite(var).all())
              and all(bool(torch.isfinite(v).all()) for v in med.values()))
    if not (finite and mean.shape == var.shape == (SPARSE_GRID,)):
        fail(f"viSparseGP {label}: non-finite values or shapes {tuple(mean.shape)}")
    require_launches(f"viSparseGP {label}", {"fit": fit_launch, "predict": pred_launch},
                     ("gram", "cholinv"))
    if label == "config3":
        if not rmse <= SPARSE_RMSE_MAX:
            fail(f"viSparseGP {label}: RMSE {rmse} > {SPARSE_RMSE_MAX}")
        if not SPARSE_NOISE_RANGE[0] <= noise <= SPARSE_NOISE_RANGE[1]:
            fail(f"viSparseGP {label}: noise {noise} outside {SPARSE_NOISE_RANGE}")
    elif not losses[-1] < losses[0]:
        fail(f"viSparseGP {label}: the last loss is not below the first")
    return {"fit": fit_launch, "predict": pred_launch}, model


def check_sparse_shapes(label: str, model) -> None:
    """K1 and K3 against their twins on the fitted model's own inputs. K1:
    every gram of one evaluation of the model (Kuu, Kuf and the batch of n
    1×1 grams of the Kff diagonal) and of one predict batch (Kuu, Kuf, Kus,
    Kss). K3: every leaf of that batch's factorizations, Kuu and the
    capacitance B, in float64 as the path runs them, and Kuu's first leaf
    cast to float32."""
    X, y = model.X_train, model.y_train
    X_new = torch.linspace(0, 4, SPARSE_GRID, device=X.device)[:SPARSE_BATCH, None]
    med = model.get_samples()
    with torch.no_grad(), captured(gram, "gram_unscaled") as grams:
        log_density(model.model, (X, y), {"Xu": model.Xu}, med)
    k1_compare_calls(f"viSparseGP {label} model", grams)
    with torch.no_grad(), captured(gram, "gram_unscaled") as grams, \
            captured(chol, "tile_chol_inv") as leaves:
        model.get_mvn_posterior(X_new, med)
    k1_compare_calls(f"viSparseGP {label} predict", grams)
    del grams
    half = len(leaves) // 2
    for i, (A,) in enumerate(leaves):
        which = "Kuu" if i < half else "B"
        k3_compare(f"viSparseGP {label} {which} leaf {i % half}", A)
    k3_compare(f"viSparseGP {label} Kuu leaf 0 in float32", leaves[0][0].float())


def check_vigp_shapes(model, X_new) -> None:
    """K1 and K2 against their twins on the fitted viGP's own inputs: every
    gram of one evaluation of the model (the Matérn 2-D k_XX) and of one
    predict batch (k_pp, k_pX, k_XX); K2 on every float64 factor those
    evaluations hand it (padded to 20 tiles), with ExactGP's predict
    tolerances (see check_main_shapes)."""
    X, y = model.X_train, model.y_train
    X_new = model._set_data(X_new, device=X.device)
    med = model.get_samples()
    with torch.no_grad(), captured(gram, "gram_unscaled") as grams, \
            captured(chol, "tile_tri_inv") as factors:
        log_density(model.model, (X, y), {}, med)
        model.get_mvn_posterior(X_new, med)
    k1_compare_calls("viGP config2", grams)
    del grams
    for i, (L,) in enumerate(factors):
        k2_compare(f"viGP config2 float64 factor {i} B={L.shape[0]} n={L.shape[-1]}", L,
                   chol.blocked_trtri(L), 1e-7, 1e-6)


def vigp_path():
    """viGP on bench.py's config-2 image (Matérn, 250 steps of 0.05), then
    the 16384-point grid in batches of 1024. Counts K1/K2 launches."""
    rng = np.random.default_rng(0)
    xx, yy = np.meshgrid(np.arange(VIGP_SIZE), np.arange(VIGP_SIZE))
    truth = np.sin(xx / 16.0) * np.cos(yy / 21.0) + 1.5
    mask = rng.uniform(size=truth.shape) < 0.15
    coords, values, full_grid = preprocess_sparse_image(np.where(mask, truth, 0.0))
    key_fit, key_pred = get_keys(0)
    model = gpax_torch.viGP(input_dim=2, kernel="Matern")
    reset_counts()
    reset_host_syncs()
    t0 = time.perf_counter()
    model.fit(key_fit, coords, values, num_steps=VIGP_STEPS, step_size=VIGP_STEP_SIZE,
              print_summary=False, progress_bar=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launch, syncs = counts(), host_syncs()
    losses = model.loss.cpu()
    reset_counts()
    t0 = time.perf_counter()
    mean, var = model.predict_in_batches(key_pred, full_grid, batch_size=VIGP_BATCH)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_launch = counts()
    rmse = float(np.sqrt(np.mean((mean.numpy().reshape(truth.shape) - truth) ** 2)))
    summary = {
        "n_train": int(values.shape[0]), "num_steps": VIGP_STEPS, "fit_s": fit_s,
        "svi_steps_per_s": VIGP_STEPS / fit_s, "host_syncs_per_step": syncs / VIGP_STEPS,
        "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
        "median": {k: v.detach().cpu().tolist() for k, v in model.get_samples().items()},
        "predict_points": int(full_grid.shape[0]), "predict_s": pred_s,
        "predict_points_per_s": full_grid.shape[0] / pred_s, "rmse": rmse,
        "launches_fit": fit_launch, "launches_predict": pred_launch,
    }
    print("viGP config2: " + json.dumps(summary), flush=True)
    if not (bool(torch.isfinite(losses).all()) and bool(torch.isfinite(mean).all())
            and bool(torch.isfinite(var).all())):
        fail("viGP config2: non-finite values")
    require_launches("viGP config2", {"fit": fit_launch, "predict": pred_launch},
                     ("gram", "trtri"))
    if not rmse <= VIGP_RMSE_MAX:
        fail(f"viGP config2: RMSE {rmse} > {VIGP_RMSE_MAX}")
    return {"fit": fit_launch, "predict": pred_launch}, model, full_grid[:VIGP_BATCH]


def f_hi(x):
    return np.sin(5 * x) * np.exp(-x)


def config4_data():
    """bench.py:471-600's data: 320 low- and 64 high-fidelity points on
    [0, 2], f_hi = sin(5x)·e^(−x), f_lo = 0.8·f_hi + 0.2·cos(3x), noise sd
    0.05, the task index in the last column; float32."""
    rng = np.random.default_rng(0)
    x_lo, x_hi = rng.uniform(0, 2, MT_N_LO), rng.uniform(0, 2, MT_N_HI)
    X = np.concatenate([np.column_stack([x_lo, np.zeros(MT_N_LO)]),
                        np.column_stack([x_hi, np.ones(MT_N_HI)])])
    y = np.concatenate([0.8 * f_hi(x_lo) + 0.2 * np.cos(3 * x_lo), f_hi(x_hi)])
    y = y + 0.05 * rng.normal(size=MT_N_LO + MT_N_HI)
    return X.astype(np.float32), y.astype(np.float32)


def check_ei(label: str, values: torch.Tensor, moments, maximize: bool) -> None:
    """EI's values are ≥ -1e-30, and ``ei`` on the moments EI scored (mean,
    variance) agrees with σ(φ(u) + u·Φ(u)) in float64, Φ by erfc, where that
    exceeds EI_REF_FLOOR·max: a wrong lower tail of ``Normal.cdf`` shows as
    a relative error far above EI_RTOL (the float32 ndtr, 4 % off at u = -5,
    gives ~30) or as negative values."""
    mean, var = moments
    got = acq.ei(moments, maximize=maximize).double()
    m64, sd = mean.double(), var.double().sqrt()
    u = (m64 - (m64.max() if maximize else m64.min())) / sd
    u = u if maximize else -u
    ref = sd * (torch.exp(-u * u / 2) / np.sqrt(2 * np.pi)
                + u * 0.5 * torch.special.erfc(-u / np.sqrt(2)))
    big = ref > EI_REF_FLOOR * ref.max()
    rel = ((got - ref).abs() / ref)[big].max().item()
    low = values.min().item()
    print(f"{label} EI: min {low:.3e}; ei vs float64 closed form on {int(big.sum())} of "
          f"{ref.numel()} points: max rel err {rel:.3e} (tol {EI_RTOL:.0e})", flush=True)
    if not (low >= -1e-30 and rel <= EI_RTOL):
        fail(f"{label}: EI below -1e-30 or off its float64 closed form")


def k2_compare_calls(label: str, calls, sizes) -> None:
    """K2 against its twin on each captured factor of ``tile_tri_inv``, with
    ExactGP's predict tolerances (see check_main_shapes); where the factor's
    own size n (the largest of ``sizes`` that fits) is no multiple of 128,
    so that it came padded, also ``blocked_trtri`` on the unpadded n×n
    factor, which pads it again and launches K2, against the twin's inverse
    of the padded one."""
    for i, (L,) in enumerate(calls):
        B, n_pad = L.shape[0], L.shape[-1]
        n = max(k for k in sizes if k <= n_pad)
        if L.dtype != torch.float64:
            fail(f"{label}: factor {i} is {L.dtype}, not float64")
        k2_compare(f"{label} float64 factor {i} B={B} n={n_pad}", L, chol.blocked_trtri(L),
                   1e-7, 1e-6)
        if n_pad == n:
            continue
        Ln = L[:, :n, :n].contiguous()
        W = chol.blocked_trtri(Ln)
        W_twin = twin_trtri(L)[:, :n, :n]
        rel = (W - W_twin).abs().max().item() / W_twin.abs().max().item()
        resid = (W @ Ln - torch.eye(n, device=L.device, dtype=L.dtype)).abs().max().item()
        print(f"K2 {label} factor {i} unpadded n={n} (padded to {n_pad} by blocked_trtri): "
              f"rel={rel:.3e} (tol 1e-07) |WL-I|max={resid:.3e} (tol 1e-06)", flush=True)
        if not (rel <= 1e-7 and resid <= 1e-6):
            fail(f"K2 check failed at {label} factor {i}, n={n} padded")


def check_config4_shapes(model, X_test: torch.Tensor, X_kg: torch.Tensor, key) -> None:
    """K1 and K2 against their twins on the fitted MultiTaskGP's own inputs:
    the grams and float64 factors of one draw's log density (the fit's),
    of ``get_mvn_posterior`` on the grid for one chunk of draws (all of
    them unless memory forces less; draws × latents in the gram's batch
    dim), and of ``kg`` for one draw on the KG points (the posterior on
    the 8 candidates, then the 8 fantasy training sets of N + 1 = 385
    points each)."""
    X, y = model.X_train, model.y_train
    N = X.shape[0]
    s = model.get_samples()
    chunk = model._chunk_size(MT_SAMPLES, X_test.shape[0], True)
    draw = {k: v[0] for k, v in s.items()}
    cases = (
        ("fit", (N,), lambda: log_density(model.model, (X, y), {}, draw)),
        (f"predict B={chunk}", (N,), lambda: model.get_mvn_posterior(
            X_test, {k: v[:chunk] for k, v in s.items()}, noiseless=True)),
        ("KG", (N, N + 1), lambda: acq.base_acq.kg(
            model, X_kg, draw, acq.base_acq.key_on(key, X.device), MT_KG_FANTASIES, False,
            False)),
    )
    for label, sizes, fn in cases:
        with torch.no_grad(), captured(gram, "gram_unscaled") as grams, \
                captured(chol, "tile_tri_inv") as factors:
            fn()
        k1_compare_calls(f"MultiTaskGP config4 {label}", grams)
        del grams
        k2_compare_calls(f"MultiTaskGP config4 {label}", factors, sizes)
        del factors
    torch.cuda.empty_cache()


def timed(fn):
    """(fn(), its wall seconds ending at a synchronize, the K1-K5 launches it made)."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, counts()


def bo_path(gp) -> dict:
    """Bayesian optimization on the composed n = 4096 fit: each acquisition
    over the 2048 prediction points on the card, with its K1/K2 launches and
    points/s; then EI and UCB on the card against the CPU."""
    dev = gp.X_train.device
    X_new = torch.linspace(-2, 2, PREDICT_M, device=dev)[:, None]
    key = 11
    launched, summary = {}, {}
    runs = {
        "EI": lambda: acq.EI(key, gp, X_new),
        "UCB": lambda: acq.UCB(key, gp, X_new),
        "POI": lambda: acq.POI(key, gp, X_new),
        "UE": lambda: acq.UE(key, gp, X_new),
        "qEI": lambda: acq.qEI(key, gp, X_new, subsample_size=BO_SUBSAMPLE,
                               maximize_distance=True),
        "qUCB": lambda: acq.qUCB(key, gp, X_new, subsample_size=BO_SUBSAMPLE,
                                 maximize_distance=True),
    }
    values = {}
    for name, fn in runs.items():
        values[name], secs, launched[name] = timed(fn)
        v = values[name]
        shape = (BO_SUBSAMPLE, PREDICT_M) if name.startswith("q") else (PREDICT_M,)
        if not (tuple(v.shape) == shape and v.device == dev and bool(torch.isfinite(v).all())):
            fail(f"ExactGP BO {name}: shape {tuple(v.shape)} on {v.device} or non-finite")
        summary[name] = {"s": secs, "points_per_s": PREDICT_M / secs,
                         "argmax_x": X_new[int(v.reshape(-1, PREDICT_M)[0].argmax()), 0].item()}
    check_ei("ExactGP BO", values["EI"],
             acq.acquisition._compute_mean_and_var(key, gp, X_new, 1, False, device=dev), False)
    lo, hi = gp.X_train.min(0).values, gp.X_train.max(0).values
    x_opt, secs, launched["optimize_acq"] = timed(lambda: acq.optimize_acq(
        key, gp, acq.UCB, BO_STARTS, lo, hi, num_steps=BO_STEPS))
    summary["optimize_acq"] = {"s": secs, "x": x_opt.tolist(), "starts": BO_STARTS,
                               "steps": BO_STEPS}
    if not (x_opt.shape == (1,) and bool(((x_opt >= lo) & (x_opt <= hi)).all())):
        fail(f"optimize_acq's point {x_opt.tolist()} is not in the box [{lo.item()}, {hi.item()}]")
    print("ExactGP BO n=4096, 100 draws, 2048 points: " + json.dumps(summary), flush=True)
    require_launches("ExactGP BO", launched, ("gram", "trtri"))

    # the card against the CPU: the same port call on BO_CHECK_DRAWS draws
    # and BO_CHECK_POINTS points
    draws = {k: v[:BO_CHECK_DRAWS] for k, v in gp.get_samples().items()}
    X_chk = X_new[:BO_CHECK_POINTS]
    for name in ("EI", "UCB"):
        fn = getattr(acq, name)
        card = fn(key, gp, X_chk, samples=draws, device=dev).cpu()
        host = fn(key, gp, X_chk.cpu(), samples=draws, device="cpu")
        err = (card - host).abs().max().item()
        scale = host.abs().max().item()
        print(f"ExactGP BO {name} card vs CPU, {BO_CHECK_DRAWS} draws x {BO_CHECK_POINTS} "
              f"points: max|err| {err:.3e}, max|cpu| {scale:.3e} (tol {BO_CHECK_TOL:.0e} "
              f"relative)", flush=True)
        if not err <= BO_CHECK_TOL * scale:
            fail(f"ExactGP BO {name} on the card disagrees with the CPU")
    gp._to_device(dev)
    return launched


def config4_path() -> dict:
    """BASELINE config 4 with bench.py's fit settings and 200 + 200 draws:
    the fit, task 1's posterior mean on the grid, EI there and KG on 8
    of its points."""
    X, y = config4_data()
    k_fit, k_pred = get_keys(0)
    model = gpax_torch.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    calls = []
    reset_host_syncs()
    _, fit_s, fit_launch = timed(lambda: model.fit(
        k_fit, X, y, num_warmup=MT_WARMUP, num_samples=MT_SAMPLES, segment_size=MT_SEGMENT,
        max_tree_depth=MT_DEPTH, warmup_depth_cap=MT_DEPTH_CAP, target_accept_prob=MT_TARGET,
        segment_callback=calls.append, deadline=time.perf_counter() + 3600.0,
        print_summary=False, progress_bar=False))
    syncs = host_syncs()
    stats = model.mcmc.get_extra_fields()
    leapfrogs = model.mcmc.num_leapfrogs
    accept = stats["accept_prob"].mean().item()
    divergences = int(stats["diverging"].sum())
    samples = model.get_samples()

    grid = np.linspace(0, 2, MT_GRID)
    X_test = np.column_stack([grid, np.ones_like(grid)]).astype(np.float32)
    (mean, _), pred_s, pred_launch = timed(lambda: model.predict(k_pred, X_test,
                                                                  noiseless=True))
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - f_hi(grid)) ** 2)))
    ei, ei_s, ei_launch = timed(lambda: acq.EI(k_pred, model, X_test, maximize=True,
                                               noiseless=True))
    X_kg = X_test[::MT_GRID // MT_KG_POINTS][:MT_KG_POINTS]
    kg, kg_s, kg_launch = timed(lambda: acq.KG(k_pred, model, X_kg, n=MT_KG_FANTASIES))
    summary = {
        "n": len(y), "num_warmup": MT_WARMUP, "num_samples": MT_SAMPLES,
        "segment_size": MT_SEGMENT, "max_tree_depth": MT_DEPTH, "fit_s": fit_s,
        "leapfrogs": leapfrogs, "leapfrogs_per_s": leapfrogs / fit_s,
        "ms_per_leapfrog": 1e3 * fit_s / max(leapfrogs, 1),
        "host_syncs_per_leapfrog": syncs / max(leapfrogs, 1),
        "segment_wall_s": stats["segment_wall_s"].tolist(),
        "segment_leapfrogs": stats["segment_leapfrogs"].tolist(),
        "accept_mean": accept, "accept_mean_all": stats["accept_mean_all"].item(),
        "divergences": divergences, "rmse_task1": rmse, "rmse_max": MT_RMSE_MAX,
        "predict_s": pred_s, "ei_s": ei_s, "ei_points_per_s": MT_GRID / ei_s,
        "next_x": float(grid[int(ei.argmax())]), "kg_s": kg_s,
        "kg_points_per_s": MT_KG_POINTS / kg_s,
        "posterior_mean": {k: v.float().mean(0).flatten().tolist() for k, v in samples.items()},
        "launches": {"fit": fit_launch, "predict": pred_launch, "EI": ei_launch,
                     "KG": kg_launch},
    }
    print("MultiTaskGP config4: " + json.dumps(summary), flush=True)
    if len(calls) != -(-(MT_WARMUP + MT_SAMPLES) // MT_SEGMENT) or \
            calls[-1]["steps_done"] != MT_WARMUP + MT_SAMPLES:
        fail(f"config4: {len(calls)} callbacks, last at {calls[-1]['steps_done']} steps")
    if sum(calls[-1]["segment_leapfrogs"]) != leapfrogs or \
            int(stats["segment_leapfrogs"].sum()) != leapfrogs:
        fail("config4: segment_leapfrogs does not sum to the leapfrogs run")
    if not all(bool(torch.isfinite(v).all()) for v in samples.values()):
        fail("config4: non-finite posterior samples")
    if not 0.5 <= accept <= 0.99:
        fail(f"config4: mean accept {accept} outside [0.5, 0.99]")
    if divergences > 0.05 * MT_SAMPLES:
        fail(f"config4: {divergences} divergences in {MT_SAMPLES} draws")
    if not rmse <= MT_RMSE_MAX:
        fail(f"config4: task 1 RMSE {rmse} > {MT_RMSE_MAX}")
    if not (ei.shape == (MT_GRID,) and bool(torch.isfinite(ei).all())):
        fail("config4: EI is not finite on the grid")
    X_test = torch.as_tensor(X_test, device=model.X_train.device)
    check_ei("config4", ei, acq.acquisition._compute_mean_and_var(
        k_pred, model, X_test, 1, True, device=X_test.device), True)
    if not (kg.shape == (MT_SAMPLES, MT_KG_POINTS) and bool(torch.isfinite(kg).all())):
        fail(f"config4: KG shape {tuple(kg.shape)} or non-finite")
    launched = {"fit": fit_launch, "predict": pred_launch, "EI": ei_launch, "KG": kg_launch}
    require_launches("MultiTaskGP config4", launched, ("gram", "trtri"))
    return launched, model, X_test, X_test[::MT_GRID // MT_KG_POINTS][:MT_KG_POINTS], k_pred


def freeze_path() -> dict:
    """The deadline freeze on the card: a deadline already past."""
    X, y = config4_data()
    kw = dict(num_warmup=FREEZE_WARMUP, num_samples=FREEZE_SAMPLES,
              segment_size=FREEZE_SEGMENT, max_tree_depth=FREEZE_DEPTH,
              warmup_depth_cap=FREEZE_CAP, target_accept_prob=MT_TARGET,
              print_summary=False, progress_bar=False)
    one = gpax_torch.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    _, one_s, one_launch = timed(lambda: one.fit(0, X, y, deadline=time.perf_counter() - 1.0,
                                                 **kw))
    st = one.mcmc.get_extra_fields()
    noise = one.get_samples()["noise"]
    steps = st["num_steps"]
    two = gpax_torch.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, two_s, two_launch = timed(lambda: two.fit(
            0, X, y, num_chains=2, deadline=time.perf_counter() - 1.0, **kw))
    st2 = two.mcmc.get_extra_fields(group_by_chain=True)
    warned = any("not threaded" in str(w.message) for w in caught)
    summary = {"one_chain": {"s": one_s, "warmup_steps_run": int(st["warmup_steps_run"][0]),
                             "draws": int(noise.shape[0]), "num_steps": steps.tolist()},
               "two_chains": {"s": two_s, "warned": warned,
                              "warmup_steps_run": st2["warmup_steps_run"].tolist(),
                              "draws": list(two.get_samples(chain_dim=True)["noise"].shape[:2])}}
    print("MultiTaskGP freeze: " + json.dumps(summary), flush=True)
    if not (int(st["warmup_steps_run"][0]) == FREEZE_SEGMENT and noise.shape[0] == FREEZE_SEGMENT
            and bool(torch.isfinite(noise).all())):
        fail("freeze: the one-chain fit did not freeze at the first boundary with 10 draws")
    if not int(steps.max()) > 1:
        fail("freeze: the depth cap leaked into the post-freeze draws")
    if not (warned and st2["warmup_steps_run"].tolist() == [FREEZE_WARMUP] * 2
            and summary["two_chains"]["draws"] == [2, FREEZE_SAMPLES]):
        fail("freeze: the sequential chains did not warn and run their whole plan")
    launched = {"one chain": one_launch, "two chains": two_launch}
    require_launches("MultiTaskGP freeze", launched, ("gram", "trtri"))
    return launched


@contextlib.contextmanager
def phase(name: str):
    """Print the wall time of the block."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s wall", flush=True)


def main() -> None:
    t_start = time.perf_counter()
    smi = device_phase()
    dev = torch.device("cuda", 0)
    with phase("build"):
        build_phase()
    with phase("K1-K5 against their twins"):
        k1 = check_k1(dev)
        k2 = check_k2(dev)
        k3 = check_k3(dev)
        k45_err = check_panel(dev)
    with phase("ExactGP potential and routes"):
        check_potential(dev)
        fused_crossover(dev)
        auto_routes(dev)
    paths = {}
    with phase("ExactGP composed fit and predict"):
        paths["ExactGP"], gp, chunk = main_path(dev, "never")
        check_main_shapes(gp, chunk)
    with phase("ExactGP BO"):
        paths["ExactGP BO"] = bo_path(gp)
    with phase("K4/K5 on the fit's gram"):
        paths["ExactGP panel factors"], panel_err, k45 = panel_path(gp)
    composed = gp.get_samples()
    del gp
    torch.cuda.empty_cache()
    with phase("ExactGP fused fit and predict"):
        paths["ExactGP fused"], gp, _ = main_path(dev, "always")
        check_fused_posterior(composed, gp.get_samples())
    del gp, composed
    torch.cuda.empty_cache()
    for label, n, steps in SPARSE_PHASES:
        with phase(f"viSparseGP {label}"):
            paths[f"viSparseGP {label}"], model = sparse_path(label, n, steps)
            check_sparse_shapes(label, model)
        del model
        torch.cuda.empty_cache()
    with phase("viGP config2"):
        paths["viGP config2"], model, X_new = vigp_path()
        check_vigp_shapes(model, X_new)
    del model
    torch.cuda.empty_cache()
    with phase("MultiTaskGP config4"):
        paths["MultiTaskGP config4"], model, X_test, X_kg, key = config4_path()
        check_config4_shapes(model, X_test, X_kg, key)
    del model
    torch.cuda.empty_cache()
    with phase("MultiTaskGP freeze"):
        paths["MultiTaskGP freeze"] = freeze_path()

    def launches(k):
        by_path = {p: sum(c[k] for c in v.values()) for p, v in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    panel_err = np.maximum(panel_err, k45_err)
    kernels = [
        {"name": "gram", "route": "cuda", "source": "gpax_torch/csrc/gram.cu",
         "replaces": "gpax_tpu/ops/pallas_gram.py:64", **launches("gram"), **k1},
        {"name": "tile_tri_inv", "route": "cuda", "source": "gpax_torch/csrc/trtri.cu",
         "replaces": "gpax_tpu/ops/chol.py:221", **launches("trtri"), **k2},
        {"name": "tile_chol_inv", "route": "cuda", "source": "gpax_torch/csrc/cholinv.cu",
         "replaces": "gpax_tpu/ops/chol.py:55", **launches("cholinv"), **k3},
        {"name": "panel_cholesky", "route": "cuda", "source": "gpax_torch/csrc/panel_chol.cu",
         "replaces": "scripts/panel_chol.py:128", **launches("panel_chol"),
         "max_abs_err": float(panel_err[0]), **k45["k4"]},
        {"name": "panel_tri_inv_t", "route": "cuda", "source": "gpax_torch/csrc/panel_chol.cu",
         "replaces": "scripts/panel_chol.py:170", **launches("panel_tri_inv"),
         "max_abs_err": float(panel_err[1]), **k45["k5"]},
    ]
    print(f"whole run: {time.perf_counter() - t_start:.2f} s wall", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
