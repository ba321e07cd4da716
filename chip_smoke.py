"""Smoke test of the gpax_torch port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine
with a CUDA card, nvcc and PyTorch built for CUDA. It

1. prints the card (``torch.cuda.get_device_name``, ``nvidia-smi`` name and
   power limit) and the torch/CUDA versions;
2. builds the port's CUDA kernels from ``gpax_torch/csrc`` and times it;
3. holds kernel K1 (fused gram) against its plain PyTorch twin on the card
   over RBF/Matérn, X≡Z with scalar and vector noise, a ragged X≠Z, d ∈ {1, 8}
   and batch ∈ {1, 4}, and times both at n = m = 4096, d = 1 (kernel and
   twin timed in turns, plain-kernel-kernel-plain);
4. holds kernel K2 (128-tile triangular inverse) and ``blocked_trtri`` built
   on it against the twin, in float64 (the factor path's dtype) and float32,
   at n ∈ {4096, 8192} and a batch of 8 at n = 1024, and times K2, the twin
   and ``torch.linalg.solve_triangular``;
5. checks the ExactGP potential and gradient on the card against the CPU
   twins at n = 512;
6. drives the main path: ``gpax_torch.ExactGP(1, "RBF")`` fits NUTS
   (100 warmup + 100 draws, tree depth 7) on n = 4096 points of
   sin(2x) + 0.1·noise, then ``predict_in_batches`` on 2048 points, counting
   K1 and K2 launches in each phase;
7. holds K1 and K2 against their twins at the main path's own shapes and
   inputs: the fit's 4096×4096 gram, and predict's grams (4096×4096,
   1024×4096, 1024×1024) and float64 factors for one chunk of posterior
   draws, the chunk sized as ``predict`` sizes it;
8. prints a JSON line of the kernels, the card's line, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check ends the run with a non-zero exit and no ``ok`` line. It
refuses to run without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import gpax_torch
from gpax_torch.ops import build, chol, gram, linalg
from gpax_torch.ppl import initialize_model
from gpax_torch.utils import get_keys, host_syncs, reset_host_syncs

N_MAIN = 4096        # training points of the main path (bench.py's n)
NUM_WARMUP = 100
NUM_SAMPLES = 100
MAX_DEPTH = 7
PREDICT_M = 2048
PREDICT_BATCH = 1024
K1_TOL = 1e-5        # K1 vs twin, relative to max|K| (see check_k1)
# K2 vs twin, relative to max|W|, and ‖W·L − I‖_max of blocked_trtri, on
# well-conditioned factors (see check_k2)
K2_REL_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
K2_RESID_TOL = {torch.float32: 5e-3, torch.float64: 1e-10}


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


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| python {sys.version.split()[0]}", flush=True)
    return smi


def build_phase() -> None:
    build.library()
    print(f"build: {build.build_seconds:.2f} s -> {build.BUILD_DIR}", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "smem" in line or "error" in line.lower():
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
    X = (torch.rand((1, N_MAIN, 1), generator=g, device=dev) * 4.0 - 2.0)
    nz = torch.full((1, N_MAIN), 0.1, device=dev)
    worst = max(worst, k1_compare(f"rbf d=1 B=1 {N_MAIN}x{N_MAIN} noise=scalar", X, X, nz, True))
    ms, plain = paired_ms(lambda: gram.gram_unscaled(X, X, nz, "rbf", True),
                          lambda: gram.gram_twin(X, X, nz, "rbf", True))
    print(f"K1 time n=m={N_MAIN} d=1 rbf: kernel {ms:.4f} ms, twin {plain:.4f} ms", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain}


def k1_compare(label: str, Xs, Zs, nz, same: bool, kind: str = "rbf") -> float:
    """max|K1 − twin| on one input, failing past K1_TOL·max|K|."""
    out = gram.gram_unscaled(Xs, Zs, nz, kind, same)
    ref = gram.gram_twin(Xs, Zs, nz, kind, same)
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    print(f"K1 {label} max|err|={err:.3e} rel={rel:.3e} (tol {K1_TOL:.0e})", flush=True)
    if not (rel <= K1_TOL):
        fail(f"K1 disagrees with its twin at {label}: rel {rel}")
    return err


def _spd_factor(n: int, B: int, seed: int, dev, dtype) -> torch.Tensor:
    """Cholesky factors of well-conditioned SPD matrices A·Aᵀ/n + ½I."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((B, n, n), generator=g, device=dev, dtype=dtype)
    K = A @ A.mT / n
    K.diagonal(dim1=-2, dim2=-1).add_(0.5)
    del A
    return torch.linalg.cholesky(K).contiguous()


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
            print(f"K2 time {name} n={n} B={B}: tiles K2 {t_k2:.4f} ms, tiles twin "
                  f"{t_k2_twin:.4f} ms | blocked_trtri K2 {t_blk:.4f} ms, twin {t_twin:.4f} ms, "
                  f"solve_triangular(L, I) {t_solve:.4f} ms", flush=True)
            if (dtype, n, B) == (torch.float64, 4096, 1):
                timing = {"ms": t_k2, "plain_ms": t_k2_twin}
            del L, W, eye
            torch.cuda.empty_cache()
    return {"max_abs_err": worst, **timing}


def bench_data(n: int):
    """The data of bench.py's ExactGP config: x ~ U(-2, 2), y = sin(2x) + 0.1ε."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n).astype(np.float32)).astype(np.float32)
    return X, y


def check_potential(dev) -> None:
    """ExactGP potential and gradient at a fixed point: CUDA kernels vs the
    CPU twins at n = 512. Tolerance 5e-3 relative: the two float32 grams
    differ by ~1e-6 relative, which K's condition number (~7e3 here,
    n·k_scale/noise) can amplify; the float64 factor path adds little."""
    X, y = bench_data(N_MAIN)
    gp = gpax_torch.ExactGP(1, "RBF")
    z = {"k_length": [np.log(0.7)], "k_scale": np.log(1.3), "noise": np.log(0.1)}
    out = []
    for device in ("cpu", dev):
        Xd = torch.as_tensor(X[:512], device=device)
        yd = torch.as_tensor(y[:512], device=device)
        info = initialize_model(gp.model, torch.Generator(device=device).manual_seed(0), (Xd, yd))
        zz = {k: torch.tensor(v, dtype=torch.float32, device=device, requires_grad=True)
              for k, v in z.items()}
        u = info.potential_fn(zz)
        grads = torch.autograd.grad(u, list(zz.values()))
        out.append((u.item(), torch.cat([g.reshape(-1) for g in grads]).cpu()))
    (u_cpu, g_cpu), (u_gpu, g_gpu) = out
    rel_u = abs(u_gpu - u_cpu) / abs(u_cpu)
    rel_g = ((g_gpu - g_cpu).abs().max() / g_cpu.abs().max()).item()
    print(f"potential n=512: cuda {u_gpu:.6f} cpu {u_cpu:.6f} rel {rel_u:.2e}; "
          f"grad rel {rel_g:.2e} (tol 5e-3)", flush=True)
    if not (rel_u <= 5e-3 and rel_g <= 5e-3):
        fail("ExactGP potential on the card disagrees with the CPU twins")


def main_path(dev) -> dict:
    X_np, y_np = bench_data(N_MAIN)
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    k_fit, k_pred = get_keys(0)
    gp = gpax_torch.ExactGP(1, "RBF")

    torch.cuda.synchronize()
    gram.launches = chol.launches = 0
    reset_host_syncs()
    t0 = time.perf_counter()
    gp.fit(k_fit, X, y, num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES,
           max_tree_depth=MAX_DEPTH, print_summary=False, progress_bar=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    syncs = host_syncs()
    fit_launch = {"gram": gram.launches, "trtri": chol.launches}

    samples = gp.get_samples()
    stats = gp.mcmc.get_extra_fields()
    leapfrogs = gp.mcmc.num_leapfrogs
    accept = stats["accept_prob"].mean().item()
    divergences = int(stats["diverging"].sum())
    finite = all(bool(torch.isfinite(v).all()) for v in samples.values())

    X_new = torch.linspace(-2, 2, PREDICT_M, device=dev)[:, None]
    chunk = gp._chunk_size(NUM_SAMPLES, PREDICT_BATCH, with_test_cov=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, draws = gp.predict_in_batches(k_pred, X_new, batch_size=PREDICT_BATCH, noiseless=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    total_launch = {"gram": gram.launches, "trtri": chol.launches}
    pred_launch = {k: total_launch[k] - fit_launch[k] for k in total_launch}

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
    print("main path: " + json.dumps(summary), flush=True)
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
    for phase, counts in (("fit", fit_launch), ("predict", pred_launch)):
        for k, v in counts.items():
            if v <= 0:
                fail(f"kernel {k} never launched during {phase}")
    return total_launch, gp, chunk


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


def main() -> None:
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    k1 = check_k1(dev)
    k2 = check_k2(dev)
    check_potential(dev)
    launches, gp, chunk = main_path(dev)
    check_main_shapes(gp, chunk)
    kernels = [
        {"name": "gram", "route": "cuda", "source": "gpax_torch/csrc/gram.cu",
         "replaces": "gpax_tpu/ops/pallas_gram.py:64", "launches": launches["gram"], **k1},
        {"name": "tile_tri_inv", "route": "cuda", "source": "gpax_torch/csrc/trtri.cu",
         "replaces": "gpax_tpu/ops/chol.py:221", "launches": launches["trtri"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
