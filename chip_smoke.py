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
   plain-kernel-kernel-plain); then K1's float64 instantiation against its
   float64 twin (max abs error ≤ 1e-12) at 4096², d = 1 RBF (timed, bound
   0.0401 ms), config 2's 2455² Matérn, a batch of 8 cross-grams 1024 ×
   4096 and 1000 × 333, d = 3;
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
9. runs ``gpax_torch.parallel`` on that fit: ``sharded_predict`` and
   ``sharded_acquisition(EI)`` on ``get_mesh()`` (the one card) equal to
   ``predict`` and ``EI`` bit for bit, ``sharded_chol_inv`` (leaf 2048) on
   the fit's gram against the composed factor (L within 1e-9 of max|L|,
   ‖L·W − I‖ ≤ 1e-6), and the potential and gradient under
   ``sharded_linalg`` within 1e-6 relative of the composed route's, with
   K2 launched; then fits the same data under ``enable_x64()`` (float64
   data and draws, the composed route, 100 + 100 at depth 7; only float64
   K1 launches in the fit, and K2; the main path's limits, and means within
   4 sd of the float32 composed fit's), predicts 2048 points in float64
   and runs EI on it, and checks that a model built after
   ``enable_x64(False)`` is float32;
   it also holds K1 and K2 against their twins at that path's own shapes and
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
    posterior sd of the composed fit's, and K1/K2 launches counted; then
    the same data with 2 chains in lockstep (``num_chains=2,
    chain_method="vectorized"``, segments of 50, 100 + 50 draws, depth
    5, the route "auto" takes: fused), printing lockstep and chain leapfrogs,
    ms a lockstep leapfrog beside the single-chain fused fit's ms a
    leapfrog, chain draws/s, host syncs a lockstep leapfrog, K1/K2
    launches and each site's R-hat, and checking one K1 and one K2 launch
    a lockstep leapfrog (not one a chain), at most 2.5 host syncs a
    lockstep leapfrog, accept, divergences, R-hat < 1.1, each chain's
    means within 4 sd of the fused fit's and the pooled predict's RMSE,
    with K1 and K2 held against their twins on the (2, 4096, 4096) gram
    and float64 factors of the chains' last draws; then vExactGP (4 tasks
    × 1024 points, 2 lockstep chains, 100 + 50, depth 5), its launches
    counted and K1/K2 held against their twins on its (2·4, 1024, 1024)
    grams and factors; then VarNoiseGP (n = 128, 50 + 50, depth 5) and
    UIGP (n = 128, 50 + 50, depth 6), MeasuredNoiseGP (n = 256, 100 + 100, noise predicted by LinReg and
    by viGP), iBNN (n = 512, d = 8, 100 + 100, depth 7) and vi_iBNN (n =
    2048, d = 8, 500 steps), each fitted and predicted with its seconds,
    leapfrogs or steps, divergences, K1/K2 launches and finite outputs;
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
16. drives BASELINE config 5 at full size (bench.py:603-658's data: a pool
    of 2000 points in d = 784, 256 measured; ``viDKL(784, z_dim=2)``,
    ``fit_predict(n_models=8, ensemble_method="vectorized",
    num_steps=1000)``), cold and then warm with a second key, printing the
    seconds, model fits/s, ms and host syncs per SVI step and the K1/K2
    launches of the fit and the pool predict; checks each model's losses
    (finite, the last 50 steps' mean below the first), that the 8 models end
    apart, and against the JAX package over eight keys
    (reference/config5_jax.py) the ensemble mean's pool RMSE, the count of
    models left at the targets' mean, the others' median RMSE and the best
    model's; then holds K1 against its twin on
    the fitted ensemble's (8, 256, 256) training gram on the learned
    embedding, its (8, 2000, 256) and (8, 2000, 2000) predictive grams, K2
    on their float64 factors, and the gram's backward into the embedding
    (``_Gram``'s ``dXs``) against autograd of the twin;
17. fits viDKL on two channels of those 256 points (300 steps), then
    ``predict`` and ``embed`` on the pool, checking shapes, values and
    launches;
18. fits DKL by NUTS (n = 128, d = 36, ``hidden_dim=[8, 4]``, 50 + 50
    draws, depth 5) and predicts 256 points, printing leapfrogs, accept and
    divergences;
19. fits viMTDKL on 300 points of two tasks (300 steps) and predicts them,
    with K1 and K2 launched;
20. fits a BNN on 300 points (20 + 20 draws at the JAX package's tree
    depth of 10) and predicts them;
21. drives the structured ExactGP (examples/structured_gp.py at config 1's
    size): n = 4096 points of 1.2·sin(5x)·exp(−0.8x) + N(0, 0.05²) on
    [0, 1.2], Matérn, the mean A·sin(w·x)·exp(−d·x) written for one draw
    with A, d ~ LogNormal(0, 0.5) and w ~ Uniform(3, 7) (the sigmoid
    transform), ``priors.gamma_dist(2, 5)`` lengthscales and
    ``priors.halfnormal_dist(0.1)`` noise; one chain on the fused route
    (100 + 100, depth 7), then 2 lockstep chains ("vectorized", segments
    of 50) whose batched potential must be trusted, then predict on 2048
    points of [0, 2.4]: every w draw in (3, 7), divergences, accept,
    R-hat, each chain's means within 4 sd of the single chain's, one K1
    and one K2 launch a lockstep leapfrog, the posterior mean's RMSE on
    [0, 1.2] (and, printed, on the extrapolation), with K1 and K2 held
    against their twins on the lockstep fit's (2, 4096, 4096) Matérn gram
    and float64 factors;
22. saves the single-chain structured fit and the viGP config-2 model with
    ``utils.save_model`` and loads each onto a fresh model on the card
    (``load_model``'s default) and on the CPU: the card's predict equals
    the original's bit for bit, the CPU's equals the original's CPU predict
    on the same draws, and the card's is held to the CPU's as BO's is;
23. runs examples/hypothesis_learning.py's workflow: linear and quadratic
    hypotheses of 1.5x² − 0.5 on a 512-point grid, 8 points measured to
    start, 4 rounds of ``hypo.step`` on the bandit's pick (eps-greedy;
    200 + 200 draws; sPM, then the hypothesis as an ExactGP's mean, in
    turns), checking each reward vector's shape and sign, K1/K2 launches
    on the GP-wrapped rounds, that both hypotheses were fitted and that the
    quadratic's mean reward beats the linear's;
24. prints a JSON line of the kernels K1-K5 and K1's float64 instantiation
    ("gram_f64") (time, twin time, library time,
    bound, launches on every path; K4's and K5's phase splits on the fit's gram),
    the card's line, and as the last line
    ``{"ok": true, "device": {...}}``.

Any failed check ends the run with a non-zero exit and no ``ok`` line. It
refuses to run without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

import gpax_torch
from gpax_torch import acquisition as acq
from gpax_torch import distributions as tdist
from gpax_torch import hypo, priors
from gpax_torch import ppl as tppl
from gpax_torch.hypo import sample_next, update_record
from gpax_torch.ops import build, chol, gram, linalg, panel_chol
from gpax_torch.ppl import initialize_model, log_density
from gpax_torch.probes.configs import (MT_DEPTH, MT_DEPTH_CAP, MT_SAMPLES, MT_SEGMENT,
                                       MT_TARGET, MT_WARMUP, VIDKL_D, VIDKL_MEASURED,
                                       VIDKL_MODELS, VIDKL_POOL, VIDKL_STEPS, config4_data,
                                       config5_data, f_hi)
from gpax_torch.utils import (get_keys, host_syncs, load_model, preprocess_sparse_image,
                              reset_host_syncs, save_model)

N_MAIN = 4096        # training points of the main path (bench.py's n)
NUM_WARMUP = 100
NUM_SAMPLES = 100
MAX_DEPTH = 7
PREDICT_M = 2048
PREDICT_BATCH = 1024
K1_TOL = 1e-5        # K1 vs twin, relative to max|K| (see check_k1)
K1_F64_TOL = 1e-12   # K1's float64 instantiation vs its twin, max abs (see check_k1_f64)
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
# parallel/ on the card: the split factorization's leaf, and its L against
# the composed factor (relative to max|L|) and ‖L·W − I‖_max, where κ(L) ~
# 1e3 puts float64 rounding near 1e-9; its potential and gradient against
# the composed route's, both float64 factors of the same float32 gram
PAR_LEAF = 2048
PAR_L_TOL, PAR_RESID_TOL, PAR_POT_RTOL = 1e-9, 1e-6, 1e-6

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
# (optimize_acq's steps cut from 10 to 4 in PR 11 for the run's limit)
BO_SUBSAMPLE, BO_STARTS, BO_STEPS = 4, 64, 4
BO_CHECK_DRAWS, BO_CHECK_POINTS = 4, 256
# the card's EI and UCB against the same port call on the CPU: both sides
# solve with float32 grams that agree to ~1e-7 relative (K1 and its twin)
# and float64 factors; cond(K) up to n·k_scale/noise ~ 4e5 at this fit
# amplifies that into the predictive moments, so the tolerance is relative
# to the largest value of the acquisition
BO_CHECK_TOL = 1e-2
# BASELINE config 4 (bench.py:471-600), cut from 1000 + 4000 draws to
# 200 + 200: the port's NUTS is driven from the host
# (gpax_torch/probes/configs.py holds its data and fit settings)
MT_GRID = 101
MT_KG_POINTS, MT_KG_FANTASIES = 8, 4
MT_RMSE_MAX = 0.03  # the JAX package on the CPU (reference/config4_jax.py): 0.01566
# EI against its float64 closed form on the same moments: values above
# EI_REF_FLOOR·max(EI) within EI_RTOL (float32's exp(-u²/2) loses ~u²·eps
# relative, ~5e-4 at u = -9), and none below -1e-30 (float32 subnormals)
EI_RTOL, EI_REF_FLOOR = 1e-3, 1e-20
# the freeze: 20 + 40 draws in segments of 10, the head capped at depth 1,
# trees of at most 2^6 - 1 leapfrogs (tests/test_round5.py's depth)
FREEZE_WARMUP, FREEZE_SAMPLES, FREEZE_SEGMENT, FREEZE_CAP = 20, 40, 10, (1, 20)
FREEZE_DEPTH = 6
# BASELINE config 5 (bench.py:603-658): viDKL's 8-model ensemble, d = 784,
# 256 measured of a 2000-point pool, 1000 SVI steps, at full size. A model
# whose first embedding saturates stays at the targets' mean (pool RMSE
# ~0.74), and the keys differ in how many do, so each run is held to the
# JAX package on the CPU over eight keys (reference/config5_jax.py): the
# ensemble mean's pool RMSE to 1.5 times the largest (0.0190 to 0.3352,
# median 0.1505); the models above VIDKL_STALLED_RMSE to the most on any
# key (0-4); the others' median RMSE to 1.5 times the largest median
# (0.0221 to 0.1039) and the best model to 1.5 times the largest best
# (0.0137 to 0.0233)
VIDKL_WARM_SEED = 7
VIDKL_RMSE_REF = 0.3352339874505331
VIDKL_RMSE_FACTOR = 1.5
VIDKL_STALLED_RMSE, VIDKL_STALLED_MAX = 0.5, 4
VIDKL_LEARNED_MEDIAN_REF = 0.1039403827181703
VIDKL_BEST_REF = 0.023311033385545733
VIDKL_TAIL = 50  # each model's mean loss over its last steps, below its first
VIDKL_CHANNEL_STEPS = 300
# DKL (NUTS over a tanh MLP's weights) at a size the time limit allows
DKL_N, DKL_D, DKL_HIDDEN, DKL_PREDICT = 128, 36, [8, 4], 256
DKL_WARMUP, DKL_SAMPLES, DKL_DEPTH = 50, 50, 5
# viMTDKL (tests/test_models_extra.py:153-167) and BNN (tests/test_dkl.py:138)
# scaled to a few hundred points; the BNN's fit runs at the JAX package's
# tree depth of 10, where its adapted trees take hundreds of leapfrogs a
# draw, so it takes 20 + 20 draws
MTDKL_N0, MTDKL_N1, MTDKL_D, MTDKL_STEPS = 200, 100, 5, 300
BNN_N, BNN_HIDDEN, BNN_WARMUP, BNN_SAMPLES = 300, [8, 4], 20, 20

# lockstep chains on the main path's data, "vectorized" in segments of
# 50 at the main path's draws and depth and on the route "auto" takes
# (fused), cut from 4 chains to 2 (NVIDIA H100 80GB HBM3, 700.00 W): 4
# chains at 100 + 100 took 239 s of a 1305 s run, device-bound at 41 ms a
# lockstep leapfrog; at 50 + 50 they took 199 s (50 warmup steps hold no
# mass window, so trees ran 3x longer) and k_scale's R-hat reached 1.100
LOCK_CHAINS, LOCK_SEGMENT = 2, 50
# PR 11 cut the draws from 100 + 100 to 100 + 50 and the depth from 7 to 5
# for the run's limit (call 1, PR 11: 1164.89 s with the new phases);
# the structured phase runs the same lockstep route at 100 + 100, depth 7
LOCK_WARMUP, LOCK_SAMPLES, LOCK_DEPTH = NUM_WARMUP, 50, 5
LOCK_RHAT_MAX = 1.1
# launches of K1 and K2 outside the tree's lockstep leapfrogs: the model's
# trace in initialize_model, the potential at the start and the doublings
# of the step-size search (at most ~10 a run here)
LOCK_EXTRA_LAUNCHES = 30
LOCK_SYNCS_MAX = 2.5  # host syncs per lockstep leapfrog
# the structured ExactGP (examples/structured_gp.py at config 1's size):
# SGP_N points of 1.2·sin(5x)·exp(−0.8x) + N(0, SGP_NOISE²) on [0, 1.2],
# predicted on [0, 2.4]; the main path's draws, depth and lockstep chains
SGP_N, SGP_NOISE, SGP_TRAIN_HI, SGP_PREDICT_HI = N_MAIN, 0.05, 1.2, 2.4
SGP_RMSE_MAX = 0.03  # the posterior mean against the truth on [0, 1.2]
# checkpoints: predict on CKPT_POINTS points, CKPT_CPU_DRAWS draws on the
# CPU; the CPU restore against the original's CPU predict, and the card's
# predictive mean against the CPU's relative to its largest value, as
# BO's card-vs-CPU check (cond(K) amplifies K1's and its twin's rounding)
CKPT_POINTS, CKPT_CPU_DRAWS = 256, 4
CKPT_RTOL, CKPT_CARD_CPU_TOL = 1e-5, BO_CHECK_TOL
# hypothesis learning (examples/hypothesis_learning.py): the grid, the
# points measured to start, the rounds and each fit's draws
HYPO_GRID, HYPO_START, HYPO_ROUNDS = 512, 8, 4
HYPO_WARMUP, HYPO_SAMPLES = 200, 200
# vExactGP: 4 tasks of 1024 points, 2 lockstep chains
# (draws cut from 100 + 100 to 100 + 50, depth from 7 to 5, in PR 11)
VGP_TASKS, VGP_N, VGP_CHAINS, VGP_SAMPLES, VGP_DEPTH = 4, 1024, 2, 50, 5
# the slice-6 models: (n, warmup, samples, depth) of each NUTS fit
VARNOISE_FIT = (128, 50, 50, 5)   # depth cut from 6 to 5 in PR 11
UIGP_FIT = (128, 50, 50, 6)
MNGP_FIT = (256, 100, 100)        # MeasuredNoiseGP.fit has no depth option: 10
IBNN_FIT = (512, 8, 100, 100, 7)  # n, d, warmup, samples, depth
VIIBNN_FIT = (2048, 8, 500)       # n, d, SVI steps

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
    gram.launches = gram.launches_f64 = chol.launches = chol.chol_inv_launches = 0
    panel_chol.cholesky_launches = panel_chol.tri_inv_launches = 0


def counts() -> dict:
    """Launches since the last reset: K1's float32 ("gram") and float64
    ("gram_f64") instantiations apart, K2-K5."""
    return {"gram": gram.launches - gram.launches_f64, "gram_f64": gram.launches_f64,
            "trtri": chol.launches, "cholinv": chol.chol_inv_launches,
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


def k1_bound(B: int, n: int, m: int, d: int, dtype=torch.float32) -> dict:
    """K1's least time: read Xs, Zs and the noise once, write the gram; per
    element 2d + 4 flops (cross term, r², scale) and one exp. No one PyTorch
    call computes it. In float64 the bytes double; the flops, on the
    float64 units, stay far below the bytes' time."""
    return bound(dtype.itemsize * B * (n * d + m * d + n + n * m), B * n * m * (2 * d + 4),
                 dtype)


def check_k1_f64(dev) -> dict:
    """K1's float64 instantiation against its float64 twin: n = m = 4096,
    d = 1, RBF (timed, with its bound), config 2's 2455² d = 2 Matérn, a
    batch of 8 cross-grams 1024 × 4096 (predict's k_pX), and a shape off
    every tile (1000 × 333, d = 3, Matérn). Max abs error ≤ K1_F64_TOL:
    float64 r² from norms of at most ~230 here rounds at ~1e-13."""
    g = torch.Generator(device=dev).manual_seed(3)
    f64 = {"device": dev, "dtype": torch.float64}

    def rand(*shape):
        return torch.rand(shape, generator=g, **f64)

    X = rand(1, N_MAIN, 1) * 4.0 - 2.0
    nz = torch.full((1, N_MAIN), 0.1, **f64)
    Xc = rand(1, VIGP_N, 2) * VIGP_SIZE / 12.0
    Xb, Zb = rand(8, PREDICT_BATCH, 1) * 4.0 - 2.0, rand(8, N_MAIN, 1) * 4.0 - 2.0
    Xr, Zr = rand(1, 1000, 3) * 2.0, rand(1, 333, 3) * 2.0
    cases = [(f"rbf d=1 B=1 {N_MAIN}x{N_MAIN} noise=scalar", X, X, nz, True, "rbf"),
             (f"matern52 d=2 B=1 {VIGP_N}x{VIGP_N} noise=scalar", Xc, Xc,
              torch.full((1, VIGP_N), 0.01, **f64), True, "matern52"),
             (f"rbf d=1 B=8 {PREDICT_BATCH}x{N_MAIN} noise=none", Xb, Zb,
              torch.zeros((8, PREDICT_BATCH), **f64), False, "rbf"),
             ("matern52 d=3 B=1 1000x333 noise=none", Xr, Zr, torch.zeros((1, 1000), **f64),
              False, "matern52")]
    worst = 0.0
    for label, Xs, Zs, nzs, same, kind in cases:
        before = gram.launches_f64
        out = gram.gram_unscaled(Xs, Zs, nzs, kind, same)
        if gram.launches_f64 != before + 1 or out.dtype != torch.float64:
            fail(f"K1 float64 at {label}: no float64 launch or a {out.dtype} result")
        err = (out - gram.gram_twin(Xs, Zs, nzs, kind, same)).abs().max().item()
        print(f"K1 float64 {label} max|err|={err:.3e} (tol {K1_F64_TOL:.0e})", flush=True)
        if not err <= K1_F64_TOL:
            fail(f"K1 float64 disagrees with its twin at {label}: {err}")
        worst = max(worst, err)
    ms, plain = paired_ms(lambda: gram.gram_unscaled(X, X, nz, "rbf", True),
                          lambda: gram.gram_twin(X, X, nz, "rbf", True), 200)
    b = k1_bound(1, N_MAIN, N_MAIN, 1, torch.float64)
    print(f"K1 float64 time n=m={N_MAIN} d=1 rbf: kernel {ms:.4f} ms, twin {plain:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, "library_ms": None, **b}


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
    return launched, gp, chunk, summary


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


def lockstep_path(dev, fused: dict, fused_summary: dict):
    """The main path's fit with LOCK_CHAINS chains in lockstep
    ("vectorized", segments of LOCK_SEGMENT) on the route "auto" takes
    (fused at n = 4096), then predict on the pooled draws: one K1 and one
    K2 launch per lockstep leapfrog for all chains, host syncs, R-hat, and
    each chain's means against the single-chain fused fit's."""
    X_np, y_np = bench_data(N_MAIN)
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    k_fit, k_pred = get_keys(0)
    gp = gpax_torch.ExactGP(1, "RBF")
    reset_counts()
    reset_host_syncs()
    t0 = time.perf_counter()
    gp.fit(k_fit, X, y, num_warmup=LOCK_WARMUP, num_samples=LOCK_SAMPLES,
           num_chains=LOCK_CHAINS, chain_method="vectorized", segment_size=LOCK_SEGMENT,
           max_tree_depth=LOCK_DEPTH, print_summary=False, progress_bar=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    syncs = host_syncs()
    fit_launch = counts()
    mcmc = gp.mcmc
    lockstep, chain_leapfrogs = mcmc.num_lockstep_leapfrogs, mcmc.num_leapfrogs
    by_chain = gp.get_samples(chain_dim=True)
    stats = mcmc.get_extra_fields(group_by_chain=True)
    accept = stats["accept_prob"].mean().item()
    divergences = int(stats["diverging"].sum())
    rhat = {k: float(np.max(gpax_torch.infer.gelman_rubin(v.float()))) for k, v in by_chain.items()}
    X_new = torch.linspace(-2, 2, PREDICT_M, device=dev)[:, None]
    reset_counts()
    t0 = time.perf_counter()
    mean, draws = gp.predict_in_batches(k_pred, X_new, batch_size=PREDICT_BATCH, noiseless=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_launch = counts()
    rmse = float(np.sqrt(np.mean((mean.numpy() - np.sin(2 * X_new[:, 0].cpu().numpy())) ** 2)))
    summary = {
        "n": N_MAIN, "chains": LOCK_CHAINS, "segment_size": LOCK_SEGMENT,
        "num_warmup": LOCK_WARMUP, "num_samples": LOCK_SAMPLES, "max_tree_depth": LOCK_DEPTH,
        "route": "fused" if gp._fused_likelihood_ok(X, {"k_length": None, "k_scale": None})
        else "composed",
        "fit_s": fit_s, "lockstep_leapfrogs": lockstep, "chain_leapfrogs": chain_leapfrogs,
        "ms_per_lockstep_leapfrog": 1e3 * fit_s / max(lockstep, 1),
        "single_chain_fused_ms_per_leapfrog": fused_summary["ms_per_leapfrog"],
        "chain_draws_per_s": LOCK_CHAINS * LOCK_SAMPLES / fit_s,
        "host_syncs": syncs, "host_syncs_per_lockstep_leapfrog": syncs / max(lockstep, 1),
        "accept_mean": accept, "divergences": divergences, "rhat": rhat,
        "timing": mcmc.timing, "predict_s": pred_s, "posterior_rmse": rmse,
        "chain_means": {k: v.float().reshape(LOCK_CHAINS, LOCK_SAMPLES, -1).mean(1).tolist()
                        for k, v in by_chain.items()},
        "launches_fit": fit_launch, "launches_predict": pred_launch,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("ExactGP lockstep chains: " + json.dumps(summary), flush=True)
    for k in ("gram", "trtri"):
        if not lockstep <= fit_launch[k] <= lockstep + LOCK_EXTRA_LAUNCHES:
            fail(f"lockstep fit: {fit_launch[k]} {k} launches for {lockstep} lockstep "
                 f"leapfrogs (one each, plus at most {LOCK_EXTRA_LAUNCHES})")
    if not syncs / max(lockstep, 1) <= LOCK_SYNCS_MAX:
        fail(f"lockstep fit: {syncs / lockstep:.2f} host syncs per lockstep leapfrog")
    if not all(bool(torch.isfinite(v).all()) for v in by_chain.values()):
        fail("lockstep fit: non-finite posterior samples")
    if not 0.5 <= accept <= 0.99:
        fail(f"lockstep fit: mean accept {accept} outside [0.5, 0.99]")
    if divergences > 0.05 * LOCK_CHAINS * LOCK_SAMPLES:
        fail(f"lockstep fit: {divergences} divergences in {LOCK_CHAINS * LOCK_SAMPLES} draws")
    if not max(rhat.values()) < LOCK_RHAT_MAX:
        fail(f"lockstep fit: R-hat {rhat}")
    for site in ("k_length", "k_scale", "noise"):
        ref, sd = fused[site].float().mean().item(), fused[site].float().std().item() + 1e-6
        for c in range(LOCK_CHAINS):
            m = by_chain[site][c].float().mean().item()
            if not abs(m - ref) < FUSED_SD * sd:
                fail(f"lockstep chain {c}: posterior mean of {site} {m} is off the "
                     f"single-chain fused fit's {ref} (sd {sd})")
    if not (mean.shape == (PREDICT_M,) and draws.shape == (LOCK_CHAINS * LOCK_SAMPLES, 1, PREDICT_M)
            and bool(torch.isfinite(mean).all()) and bool(torch.isfinite(draws).all())):
        fail(f"lockstep predict: shapes {tuple(mean.shape)}, {tuple(draws.shape)} or non-finite")
    if not rmse <= 0.03:
        fail(f"lockstep predict: RMSE {rmse} > 0.03")
    launched = {"fit": fit_launch, "predict": pred_launch}
    require_launches("ExactGP lockstep", launched, ("gram", "trtri"))
    return launched, gp


def check_lockstep_shapes(gp, kind: str = "rbf", label: str = "lockstep fit") -> None:
    """K1 and K2 against their twins on the lockstep fit's own inputs: the
    (C, n, n) gram of the chains' last draws, as the fused op builds it
    (noise_eff with the jitter and base regularization, over k_scale), and
    its float64 factors."""
    X = gp.X_train
    n = X.shape[0]
    last = {k: v[:, -1] for k, v in gp.get_samples(chain_dim=True).items()}
    jitter = gpax_torch.get_config().default_jitter
    noise_eff = last["noise"] + jitter + 4.0 * n * torch.finfo(torch.float32).eps
    Xs = (X / last["k_length"][:, None, :]).contiguous()
    nz = noise_eff[:, None].expand(LOCK_CHAINS, n).contiguous()
    k1_compare(f"{label} gram {kind} B={LOCK_CHAINS} {n}x{n}", Xs, Xs,
               (nz / last["k_scale"][:, None]).contiguous(), True, kind)
    K = last["k_scale"][:, None, None] * gram.gram_unscaled(Xs, Xs, nz, kind, False)
    K.diagonal(dim1=-2, dim2=-1).add_(nz)
    L, W, _ = linalg._chol_tri_factors_ld(K, None)
    del K
    k2_compare(f"float64 factors of the {label}'s grams B={LOCK_CHAINS} n={n}", L, W,
               1e-7, 1e-6)
    del L, W
    torch.cuda.empty_cache()


def vexact_data():
    """VGP_TASKS tasks of VGP_N points, each a shifted sine plus noise."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (VGP_TASKS, VGP_N)).astype(np.float32)
    shift = np.arange(VGP_TASKS, dtype=np.float32)[:, None] * 0.5
    f = np.sin(2 * X + shift)
    return X, f, (f + 0.1 * rng.normal(size=X.shape)).astype(np.float32)


def vexact_path(dev) -> dict:
    """vExactGP on VGP_TASKS × VGP_N points with VGP_CHAINS lockstep chains
    (VGP_SAMPLES draws after the main path's warmup, depth VGP_DEPTH), then
    predict on 256 points a task;
    K1 and K2 against their twins on the (chains·tasks, n, n) grams and
    float64 factors of the chains' last draws."""
    X, f, y = vexact_data()
    k_fit, k_pred = get_keys(0)
    model = gpax_torch.vExactGP(1, "RBF")
    reset_host_syncs()
    _, fit_s, fit_launch = timed(lambda: model.fit(
        k_fit, X, y, num_warmup=NUM_WARMUP, num_samples=VGP_SAMPLES, num_chains=VGP_CHAINS,
        chain_method="vectorized", max_tree_depth=VGP_DEPTH, print_summary=False,
        progress_bar=False))
    syncs = host_syncs()
    mcmc = model.mcmc
    stats = mcmc.get_extra_fields()
    X_new = np.linspace(-2, 2, 256, dtype=np.float32)[None].repeat(VGP_TASKS, 0)
    (mean, draws), pred_s, pred_launch = timed(lambda: model.predict(k_pred, X_new,
                                                                     noiseless=True))
    truth = np.sin(2 * X_new + np.arange(VGP_TASKS, dtype=np.float32)[:, None] * 0.5)
    rmse = np.sqrt(np.mean((mean.cpu().numpy() - truth) ** 2, axis=1)).tolist()
    by_chain = model.get_samples(chain_dim=True)
    summary = {"tasks": VGP_TASKS, "n": VGP_N, "chains": VGP_CHAINS, "fit_s": fit_s,
               "lockstep_leapfrogs": mcmc.num_lockstep_leapfrogs,
               "chain_leapfrogs": mcmc.num_leapfrogs,
               "ms_per_lockstep_leapfrog": 1e3 * fit_s / max(mcmc.num_lockstep_leapfrogs, 1),
               "host_syncs_per_lockstep_leapfrog": syncs / max(mcmc.num_lockstep_leapfrogs, 1),
               "accept_mean": stats["accept_prob"].mean().item(),
               "divergences": int(stats["diverging"].sum()), "predict_s": pred_s,
               "task_rmse": rmse,
               "rhat": {k: float(np.max(gpax_torch.infer.gelman_rubin(v.float())))
                        for k, v in by_chain.items()},
               "launches": {"fit": fit_launch, "predict": pred_launch}}
    print(f"vExactGP lockstep chains: {json.dumps(summary)}", flush=True)
    if mean.shape != (VGP_TASKS, 256) or draws.shape != (VGP_CHAINS * VGP_SAMPLES, 1,
                                                         VGP_TASKS, 256) \
            or not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(draws).all())):
        fail(f"vExactGP: predictions of shape {tuple(mean.shape)}, {tuple(draws.shape)} "
             "or non-finite")
    lock = mcmc.num_lockstep_leapfrogs
    for k in ("gram", "trtri"):
        if not lock <= fit_launch[k] <= lock + LOCK_EXTRA_LAUNCHES:
            fail(f"vExactGP: {fit_launch[k]} {k} launches for {lock} lockstep leapfrogs")
    last = {k: v[:, -1] for k, v in by_chain.items()}            # (chains, tasks, …)
    Xt = model.X_train                                           # (tasks, n, 1)
    B = VGP_CHAINS * VGP_TASKS
    Xs = (Xt / last["k_length"][..., None, :]).reshape(B, VGP_N, 1).contiguous()
    jitter = gpax_torch.get_config().default_jitter
    nz = ((last["noise"] + jitter) / last["k_scale"]).reshape(B, 1).expand(B, VGP_N).contiguous()
    k1_compare(f"vExactGP fit grams B={B} {VGP_N}x{VGP_N}", Xs, Xs, nz, True)
    K = model.kernel(Xt, Xt, last, last["noise"])
    L, W, _ = linalg._chol_tri_factors_ld(K)
    k2_compare(f"float64 factors of vExactGP's grams B={B} n={VGP_N}", L.reshape(B, VGP_N, VGP_N),
               W.reshape(B, VGP_N, VGP_N), 1e-7, 1e-6)
    launched = {"fit": fit_launch, "predict": pred_launch}
    require_launches("vExactGP", launched, ("gram", "trtri"))
    return launched


def _nuts_summary(name: str, model, fit_s: float, fit_launch: dict, extra: dict) -> dict:
    stats = model.mcmc.get_extra_fields()
    summary = {"fit_s": fit_s, "leapfrogs": model.mcmc.num_leapfrogs,
               "ms_per_leapfrog": 1e3 * fit_s / max(model.mcmc.num_leapfrogs, 1),
               "accept_mean": stats["accept_prob"].mean().item(),
               "divergences": int(stats["diverging"].sum()), "launches_fit": fit_launch,
               **extra}
    print(f"{name}: {json.dumps(summary)}", flush=True)
    return summary


def _require_finite(name: str, *tensors) -> None:
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        fail(f"{name}: non-finite outputs")


def slice6_paths() -> dict:
    """VarNoiseGP, UIGP, MeasuredNoiseGP (both noise predictions), iBNN and
    vi_iBNN: each fitted and predicted on the card, with seconds, leapfrogs
    or steps, divergences, K1/K2 launches and finite outputs."""
    rng = np.random.default_rng(0)
    paths = {}
    key_fit, key_pred = get_keys(0)

    n, warm, draws_n, depth = VARNOISE_FIT
    X = rng.uniform(-1, 1, n).astype(np.float32)
    y = (np.sin(3 * X) + np.abs(X) * rng.normal(0, 0.3, n)).astype(np.float32)
    model = gpax_torch.VarNoiseGP(1, "RBF")
    _, fit_s, fit_launch = timed(lambda: model.fit(
        key_fit, X, y, num_warmup=warm, num_samples=draws_n, max_tree_depth=depth,
        print_summary=False, progress_bar=False))
    (mean, draws), pred_s, pred_launch = timed(
        lambda: model.predict(key_pred, np.linspace(-1, 1, 256, dtype=np.float32)))
    var = model.get_data_var_samples()
    _nuts_summary("VarNoiseGP", model, fit_s, fit_launch,
                  {"n": n, "predict_s": pred_s, "launches_predict": pred_launch,
                   "data_var_mean": var.mean().item()})
    _require_finite("VarNoiseGP", mean, draws, var)
    paths["VarNoiseGP"] = {"fit": fit_launch, "predict": pred_launch}

    n, warm, draws_n, depth = UIGP_FIT
    X = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    X = (X - X.min()) / (X.max() - X.min())  # the default sigma_x prior's (0, 1)
    y = (np.sin(5 * X) + 0.05 * rng.normal(size=n)).astype(np.float32)
    model = gpax_torch.UIGP(1, "RBF")
    _, fit_s, fit_launch = timed(lambda: model.fit(
        key_fit, X, y, num_warmup=warm, num_samples=draws_n, max_tree_depth=depth,
        print_summary=False, progress_bar=False))
    (mean, draws), pred_s, pred_launch = timed(
        lambda: model.predict(key_pred, np.linspace(0, 1, 256, dtype=np.float32), n=2))
    _nuts_summary("UIGP", model, fit_s, fit_launch,
                  {"n": n, "predict_s": pred_s, "launches_predict": pred_launch,
                   "sigma_x_mean": model.get_samples()["sigma_x"].mean().item()})
    _require_finite("UIGP", mean, draws)
    paths["UIGP"] = {"fit": fit_launch, "predict": pred_launch}

    n, warm, draws_n = MNGP_FIT
    X = rng.uniform(-1, 1, n).astype(np.float32)
    noise = (0.01 + 0.04 * (X + 1) / 2).astype(np.float32)  # measured, growing with x
    y = (np.sin(3 * X) + np.sqrt(noise) * rng.normal(size=n)).astype(np.float32)
    model = gpax_torch.MeasuredNoiseGP(1, "RBF")
    _, fit_s, fit_launch = timed(lambda: model.fit(
        key_fit, X, y, noise, num_warmup=warm, num_samples=draws_n, print_summary=False,
        progress_bar=False))
    launched = {"fit": fit_launch}
    extra = {"n": n}
    X_new = np.linspace(-1, 1, 64, dtype=np.float32)
    for method in ("linreg", "gpreg"):
        model.noise_predicted = None
        (mean, draws), pred_s, pred_launch = timed(lambda: model.predict(
            key_pred, X_new, n=2, noise_prediction_method=method))
        nz = model.noise_predicted.cpu().numpy()
        extra[method] = {"predict_s": pred_s, "launches": pred_launch,
                         "noise_rmse": float(np.sqrt(np.mean(
                             (nz - (0.01 + 0.04 * (X_new + 1) / 2)) ** 2)))}
        _require_finite(f"MeasuredNoiseGP {method}", mean, draws)
        launched[f"predict {method}"] = pred_launch
    _nuts_summary("MeasuredNoiseGP", model, fit_s, fit_launch, extra)
    paths["MeasuredNoiseGP"] = launched

    n, d, warm, draws_n, depth = IBNN_FIT
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.tanh(X[:, 0]) + 0.5 * np.sin(X[:, 1]) + 0.05 * rng.normal(size=n)).astype(np.float32)
    model = gpax_torch.iBNN(d, depth=3, activation="erf")
    _, fit_s, fit_launch = timed(lambda: model.fit(
        key_fit, X, y, num_warmup=warm, num_samples=draws_n, max_tree_depth=depth,
        print_summary=False, progress_bar=False))
    (mean, draws), pred_s, pred_launch = timed(lambda: model.predict(key_pred, X[:256]))
    _nuts_summary("iBNN", model, fit_s, fit_launch,
                  {"n": n, "d": d, "predict_s": pred_s, "launches_predict": pred_launch,
                   "train_rmse": float(np.sqrt(np.mean((mean.cpu().numpy() - y[:256]) ** 2)))})
    _require_finite("iBNN", mean, draws)
    paths["iBNN"] = {"fit": fit_launch, "predict": pred_launch}
    require_launches("iBNN", paths["iBNN"], ("trtri",))

    n, d, steps = VIIBNN_FIT
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.tanh(X[:, 0]) + 0.5 * np.sin(X[:, 1]) + 0.05 * rng.normal(size=n)).astype(np.float32)
    model = gpax_torch.vi_iBNN(d, depth=3, activation="erf")
    _, fit_s, fit_launch = timed(lambda: model.fit(key_fit, X, y, num_steps=steps,
                                                   print_summary=False, progress_bar=False))
    (mean, var), pred_s, pred_launch = timed(lambda: model.predict(key_pred, X[:512]))
    losses = model.loss.cpu()
    print("vi_iBNN: " + json.dumps({
        "n": n, "d": d, "num_steps": steps, "fit_s": fit_s, "ms_per_svi_step": 1e3 * fit_s / steps,
        "loss_first": losses[0].item(), "loss_last": losses[-1].item(), "predict_s": pred_s,
        "train_rmse": float(np.sqrt(np.mean((mean.cpu().numpy() - y[:512]) ** 2))),
        "launches_fit": fit_launch, "launches_predict": pred_launch}), flush=True)
    _require_finite("vi_iBNN", losses, mean, var)
    paths["vi_iBNN"] = {"fit": fit_launch, "predict": pred_launch}
    require_launches("vi_iBNN", paths["vi_iBNN"], ("trtri",))
    for name in ("VarNoiseGP", "UIGP", "MeasuredNoiseGP"):
        require_launches(name, paths[name], ("gram", "trtri"))
    return paths


def check_fused_posterior(composed: dict, fused: dict, label: str = "fused",
                          offsets: dict = {}) -> None:
    """The fused (or another) fit's posterior means within FUSED_SD
    posterior sd of the composed fit's (``tests/test_fused_density.py:105-108``),
    the composed fit's mean of a site shifted by ``offsets[site]``."""
    for site in ("k_length", "k_scale", "noise"):
        mf, mc = fused[site].float().mean().item(), composed[site].float().mean().item()
        mc += offsets.get(site, 0.0)
        sc = composed[site].float().std().item() + 1e-6
        print(f"{label} vs composed posterior {site}: mean {mf:.5f} vs {mc:.5f}, "
              f"|diff|/sd {abs(mf - mc) / sc:.3f} (tol {FUSED_SD})", flush=True)
        if not abs(mf - mc) < FUSED_SD * sc:
            fail(f"the {label} fit's posterior mean of {site} is off the composed fit's")


def x64_path(dev, composed: dict) -> dict:
    """The main path's fit under ``enable_x64()``: a float64 ExactGP on
    config 1's data (the composed route, since the fused one takes float32
    only), 100 + 100 draws at depth 7, float64 K1 and K2 launched and no
    float32 K1 during the fit; accept, divergences, RMSE and posterior means
    within FUSED_SD sd of the float32 composed fit's (the noise as noise plus
    each dtype's base regularization); then a float64 predict
    on 2048 points and EI on the fit. ``enable_x64(False)`` after, and a new
    model is float32 again."""
    X_np, y_np = bench_data(N_MAIN)
    k_fit, k_pred = get_keys(0)
    gpax_torch.enable_x64()
    try:
        gp = gpax_torch.ExactGP(1, "RBF")
        X, y = gp._set_data(X_np, y_np, device=dev)
        if not (gp.dtype == X.dtype == torch.float64):
            fail(f"x64: the model's dtype {gp.dtype}, the data's {X.dtype}")
        reset_counts()
        t0 = time.perf_counter()
        gp.fit(k_fit, X, y, num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES,
               max_tree_depth=MAX_DEPTH, print_summary=False, progress_bar=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launch = counts()
        samples = gp.get_samples()
        stats = gp.mcmc.get_extra_fields()
        accept = stats["accept_prob"].mean().item()
        divergences = int(stats["diverging"].sum())
        X_new = torch.linspace(-2, 2, PREDICT_M, device=dev, dtype=torch.float64)[:, None]
        reset_counts()
        t0 = time.perf_counter()
        mean, draws = gp.predict_in_batches(k_pred, X_new, batch_size=PREDICT_BATCH,
                                            noiseless=True)
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
        pred_launch = counts()
        ei, ei_s, ei_launch = timed(lambda: acq.EI(11, gp, X_new))
    finally:
        gpax_torch.enable_x64(False)
    rmse = float(np.sqrt(np.mean((mean.numpy() - np.sin(2 * X_new[:, 0].cpu().numpy())) ** 2)))
    summary = {"fit_s": fit_s, "leapfrogs": gp.mcmc.num_leapfrogs,
               "ms_per_leapfrog": 1e3 * fit_s / max(gp.mcmc.num_leapfrogs, 1),
               "accept_mean": accept, "divergences": divergences, "predict_s": pred_s,
               "ei_s": ei_s, "posterior_rmse": rmse,
               "posterior_mean": {k: v.mean().item() for k, v in samples.items()},
               "launches_fit": fit_launch, "launches_predict": pred_launch,
               "launches_ei": ei_launch}
    print(f"ExactGP x64 fit n={N_MAIN}: " + json.dumps(summary), flush=True)
    if not all(v.dtype == torch.float64 and bool(torch.isfinite(v).all())
               for v in samples.values()):
        fail("x64: the samples are not finite float64")
    if fit_launch["gram"] != 0 or fit_launch["gram_f64"] <= 0 or fit_launch["trtri"] <= 0:
        fail(f"x64: the fit's launches {fit_launch}: float64 K1 and K2 only")
    if not 0.5 <= accept <= 0.99:
        fail(f"x64: mean accept {accept} outside [0.5, 0.99]")
    if divergences > 0.05 * NUM_SAMPLES:
        fail(f"x64: {divergences} divergences in {NUM_SAMPLES} draws")
    if not rmse <= 0.03:
        fail(f"x64: posterior RMSE {rmse} > 0.03")
    for name, t in (("predict mean", mean), ("predict draws", draws), ("EI", ei)):
        if not (t.dtype == torch.float64 and bool(torch.isfinite(t).all())):
            fail(f"x64: {name} is not finite float64")
    if not (mean.shape == (PREDICT_M,) and ei.shape == (PREDICT_M,)):
        fail(f"x64: predict {tuple(mean.shape)} or EI {tuple(ei.shape)}")
    # both fits put noise + 4·n·eps of their dtype on K's diagonal (the
    # factor path's base regularization, ops/linalg.py): float32's 0.00195
    # at n = 4096 is float64's noise posterior more, so the noise site is
    # compared as that sum
    base = 4.0 * N_MAIN
    check_fused_posterior(composed, samples, "x64", {"noise": base * (
        torch.finfo(torch.float32).eps - torch.finfo(torch.float64).eps)})
    if gpax_torch.ExactGP(1).dtype != torch.float32 or torch.get_default_dtype() != torch.float32:
        fail("x64: a model built after enable_x64(False) is not float32")
    launched = {"fit": fit_launch, "predict": pred_launch, "EI": ei_launch}
    require_launches("ExactGP x64", launched, ("gram_f64", "trtri"))
    return launched


def parallel_path(gp) -> dict:
    """``gpax_torch.parallel`` on the card, on the float32 composed n = 4096
    fit: ``sharded_predict`` and ``sharded_acquisition(EI)`` on
    ``get_mesh()`` bit for bit against ``predict`` and ``EI`` with the same
    key; ``sharded_chol_inv`` (leaf 2048) against the composed factor of the
    fit's gram; the potential and gradient under ``sharded_linalg`` within
    PAR_POT_RTOL of the composed route's, with K2 launched."""
    dev = gp.X_train.device
    mesh = gpax_torch.parallel.get_mesh()
    X_new = torch.linspace(-2, 2, PREDICT_M, device=dev)[:, None]
    launched = {}

    def fresh(fn):
        # the chunks of draws are sized from the card's free memory: the same
        # free memory for each call, so the same chunks
        torch.cuda.empty_cache()
        return fn()

    (mean_s, draws_s), secs, launched["sharded_predict"] = timed(lambda: fresh(
        lambda: gpax_torch.parallel.sharded_predict(gp, 5, X_new, mesh=mesh, noiseless=True)))
    mean_l, draws_l = fresh(lambda: gp.predict(5, X_new, noiseless=True))
    ei_s, ei_secs, launched["sharded_acquisition"] = timed(lambda: fresh(
        lambda: gpax_torch.parallel.sharded_acquisition(acq.EI, 11, gp, X_new, mesh=mesh)))
    ei_l = fresh(lambda: acq.EI(11, gp, X_new))
    print(f"parallel on {mesh}: sharded_predict {secs:.2f} s, sharded_acquisition(EI) "
          f"{ei_secs:.2f} s; equal to predict/EI: {torch.equal(mean_s, mean_l)}, "
          f"{torch.equal(draws_s, draws_l)}, {torch.equal(ei_s, ei_l)}", flush=True)
    if not (torch.equal(mean_s, mean_l) and torch.equal(draws_s, draws_l)
            and torch.equal(ei_s, ei_l)):
        fail("parallel: sharded_predict/sharded_acquisition differ from predict/EI")

    # the fit's gram for its first draw with the factor path's base jitter,
    # as panel_path takes it; the composed factor is chol_tri_factors'
    s = {k: v[:1] for k, v in gp.get_samples().items()}
    n = gp.X_train.shape[0]
    K = gp.kernel(gp.X_train, gp.X_train, s, s["noise"])[0]
    K64 = K.double()
    K64.diagonal().add_(4.0 * n * torch.finfo(torch.float32).eps)
    reset_counts()
    L, W = gpax_torch.parallel.sharded_chol_inv(K64, mesh, leaf=PAR_LEAF)
    torch.cuda.synchronize()
    launched["sharded_chol_inv"] = counts()
    L_c, W_c = linalg.chol_tri_factors(K64)
    err_l = ((L - L_c).abs().max() / L_c.abs().max()).item()
    resid = (L @ W - torch.eye(n, device=dev, dtype=torch.float64)).abs().max().item()
    print(f"sharded_chol_inv n={n} leaf={PAR_LEAF}: L vs composed rel {err_l:.3e} (tol "
          f"{PAR_L_TOL:.0e}), |L·W − I|_max {resid:.3e} (tol {PAR_RESID_TOL:.0e})", flush=True)
    if not (err_l <= PAR_L_TOL and resid <= PAR_RESID_TOL):
        fail("parallel: sharded_chol_inv disagrees with the composed factor")
    del K, K64, L, W, L_c, W_c

    X, y = gp.X_train, gp.y_train
    with route("never"):
        u_c, g_c = potential_and_grad(gp, X, y, dev)[:2]
    reset_counts()
    with gpax_torch.parallel.sharded_linalg(mesh, leaf=PAR_LEAF):
        u_s, g_s = potential_and_grad(gp, X, y, dev)[:2]
    torch.cuda.synchronize()
    launched["sharded_linalg potential"] = counts()
    rel_u = abs(u_s - u_c) / abs(u_c)
    rel_g = ((g_s - g_c).abs().max() / g_c.abs().max()).item()
    print(f"sharded_linalg potential n={n}: {u_s:.8f} vs composed {u_c:.8f}, rel {rel_u:.2e}; "
          f"grad rel {rel_g:.2e} (tol {PAR_POT_RTOL:.0e})", flush=True)
    if not (rel_u <= PAR_POT_RTOL and rel_g <= PAR_POT_RTOL):
        fail("parallel: the sharded_linalg potential disagrees with the composed route's")
    require_launches("parallel", {k: launched[k] for k in ("sharded_predict",
                                                            "sharded_acquisition")},
                     ("gram", "trtri"))
    require_launches("parallel", {k: launched[k] for k in ("sharded_chol_inv",
                                                            "sharded_linalg potential")},
                     ("trtri",))
    return launched


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
def svi_runs():
    """Per call of ``SVI.run`` while the block runs: its wall seconds (ending
    at a synchronize), the kernel launches and the host syncs counted when
    it returns."""
    runs, run = [], gpax_torch.infer.SVI.run

    def timed_run(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = run(self, *args, **kwargs)
        torch.cuda.synchronize()
        runs.append({"s": time.perf_counter() - t0, "launches": counts(),
                     "host_syncs": host_syncs()})
        return out

    gpax_torch.infer.SVI.run = timed_run
    try:
        yield runs
    finally:
        gpax_torch.infer.SVI.run = run


def vidkl_run(label: str, key, X, y, X_pool, y_pool):
    """One ``fit_predict(n_models=8)`` of config 5 and its checks."""
    model = gpax_torch.viDKL(VIDKL_D, z_dim=2, kernel="RBF")
    reset_host_syncs()
    with svi_runs() as runs:
        (mean, var), seconds, total = timed(lambda: model.fit_predict(
            key, X, y, X_pool, num_steps=VIDKL_STEPS, n_models=VIDKL_MODELS,
            ensemble_method="vectorized", print_summary=False, progress_bar=False))
    fit = runs[0]
    launched = {"fit": fit["launches"],
                "predict": {k: total[k] - fit["launches"][k] for k in total}}
    losses = model.loss.cpu()
    mean_np = mean.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean_np.mean(0) - y_pool) ** 2)))
    model_rmse = np.sqrt(np.mean((mean_np - y_pool) ** 2, axis=1))
    learned = model_rmse[model_rmse <= VIDKL_STALLED_RMSE]
    summary = {
        "run": label, "fit_predict_s": seconds, "model_fits_per_s": VIDKL_MODELS / seconds,
        "fit_s": fit["s"], "ms_per_svi_step": 1e3 * fit["s"] / VIDKL_STEPS,
        "predict_s": seconds - fit["s"],
        "host_syncs_per_step": fit["host_syncs"] / VIDKL_STEPS,
        "loss_first": losses[:, 0].tolist(), "loss_first_steps_max": losses[:, :5].max().item(),
        "loss_tail_mean": losses[:, -VIDKL_TAIL:].mean(1).tolist(),
        "pool_rmse": rmse, "pool_rmse_max": VIDKL_RMSE_FACTOR * VIDKL_RMSE_REF,
        "model_rmse": model_rmse.tolist(), "stalled": int(len(model_rmse) - len(learned)),
        "k_length": model.kernel_params["k_length"].tolist(),
        "noise": model.kernel_params["noise"].tolist(), "launches": launched,
    }
    print(f"viDKL config5: {json.dumps(summary)}", flush=True)
    if not bool(torch.isfinite(losses).all()):
        fail(f"viDKL config5 {label}: non-finite losses")
    if not bool((losses[:, -VIDKL_TAIL:].mean(1) < losses[:, 0]).all()):
        fail(f"viDKL config5 {label}: a model's last {VIDKL_TAIL} losses are not below its first")
    if mean.shape != (VIDKL_MODELS, VIDKL_POOL) or var.shape != mean.shape or \
            not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())):
        fail(f"viDKL config5 {label}: predictions of shape {tuple(mean.shape)} or non-finite")
    w0 = model.nn_params["linear_0"]["w"]
    ls = model.kernel_params["k_length"]
    for b in range(VIDKL_MODELS):
        for c in range(b):
            if torch.equal(w0[b], w0[c]) or torch.equal(ls[b], ls[c]):
                fail(f"viDKL config5 {label}: models {c} and {b} end with equal parameters")
    if not rmse <= VIDKL_RMSE_FACTOR * VIDKL_RMSE_REF:
        fail(f"viDKL config5 {label}: pool RMSE {rmse} > "
             f"{VIDKL_RMSE_FACTOR} x {VIDKL_RMSE_REF}")
    if len(model_rmse) - len(learned) > VIDKL_STALLED_MAX:
        fail(f"viDKL config5 {label}: {len(model_rmse) - len(learned)} models above "
             f"{VIDKL_STALLED_RMSE} (the JAX package's most on a key: {VIDKL_STALLED_MAX})")
    if not np.median(learned) <= VIDKL_RMSE_FACTOR * VIDKL_LEARNED_MEDIAN_REF:
        fail(f"viDKL config5 {label}: the learned models' median RMSE {np.median(learned)} > "
             f"{VIDKL_RMSE_FACTOR} x {VIDKL_LEARNED_MEDIAN_REF}")
    if not model_rmse.min() <= VIDKL_RMSE_FACTOR * VIDKL_BEST_REF:
        fail(f"viDKL config5 {label}: the best model's RMSE {model_rmse.min()} > "
             f"{VIDKL_RMSE_FACTOR} x {VIDKL_BEST_REF}")
    require_launches(f"viDKL config5 {label}", launched, ("gram", "trtri"))
    return launched, model


def vidkl_path():
    """BASELINE config 5 at full size, cold then warm with a second key."""
    X_pool, y_pool, measured, _ = config5_data()
    X, y = X_pool[measured], y_pool[measured].astype(np.float32)
    launched = {}
    for label, key in (("cold", get_keys(0)[0]),
                       ("warm", torch.Generator().manual_seed(VIDKL_WARM_SEED))):
        runs, model = vidkl_run(label, key, X, y, X_pool, y_pool)
        launched.update({f"{label} {k}": v for k, v in runs.items()})
    return launched, model, X_pool


def vidkl_sites(model) -> dict:
    """The fitted ensemble's guide medians under their site names."""
    sites = {f"feature_extractor/{layer}/{p}": v
             for layer, ps in model.nn_params.items() for p, v in ps.items()}
    return {**sites, **model.kernel_params}


def check_vidkl_shapes(model, X_pool) -> None:
    """K1 and K2 against their twins on the fitted ensemble's own inputs:
    every gram of one evaluation of the batched model (the (8, 256, 256)
    training gram on the learned embedding) and of its posterior at the pool
    ((8, 2000, 2000) k_pp, (8, 2000, 256) k_pX, k_XX); K2 on every float64
    factor; then the gram's backward into the embedding (``_Gram``'s closed
    form on K1's forward, the network's gradient path) against autograd of
    the twin on the training gram's inputs."""
    X, y = model.X_train, model.y_train
    X_pool = model._set_data(X_pool, device=X.device)
    with torch.no_grad(), captured(gram, "gram_unscaled") as grams, \
            captured(chol, "tile_tri_inv") as factors:
        log_density(model.model, (X, y), {}, vidkl_sites(model), (VIDKL_MODELS,))
        model.get_mvn_posterior(X_pool, model.nn_params, model.kernel_params)
    k1_compare_calls("viDKL config5", grams)
    Xs, _, nz, kind, _ = grams[0]
    del grams
    k2_compare_calls("viDKL config5", factors, (VIDKL_MEASURED,))
    del factors
    g = torch.randn(Xs.shape[:-1] + Xs.shape[-2:-1], device=Xs.device,
                    generator=torch.Generator(device=Xs.device).manual_seed(0))
    Xa = Xs.clone().requires_grad_(True)
    (gram._Gram.apply(Xa, Xa, nz, kind, False, True) * g).sum().backward()
    Xb = Xs.clone().requires_grad_(True)
    (gram.gram_twin(Xb, Xb, nz, kind, False) * g).sum().backward()
    err = (Xa.grad - Xb.grad).abs().max().item()
    rel = err / Xb.grad.abs().max().item()
    norms = 2 * (Xs * Xs).sum(-1).max().item()
    tol = 10 * K1_TOL * max(1.0, norms / 60.0)
    print(f"K1 viDKL config5 dXs backward {tuple(Xs.shape)}: max|err|={err:.3e} "
          f"rel={rel:.3e} (tol {tol:.1e})", flush=True)
    if not rel <= tol:
        fail(f"viDKL config5: the gram's dXs disagrees with the twin's autograd: rel {rel}")


def vidkl_channels_path():
    """A 2-channel fit of config 5's measured points (y and a second target
    of the same latent), then predict and embed on the pool."""
    X_pool, y_pool, measured, latent = config5_data()
    y2 = np.stack([y_pool, np.cos(2.0 * latent[:, 1]) + 0.3 * latent[:, 0]])
    key_fit, key_pred = get_keys(1)
    model = gpax_torch.viDKL(VIDKL_D, z_dim=2, kernel="RBF")
    reset_host_syncs()
    _, fit_s, fit_launch = timed(lambda: model.fit(
        key_fit, X_pool[measured], y2[:, measured].astype(np.float32),
        num_steps=VIDKL_CHANNEL_STEPS, print_summary=False, progress_bar=False))
    syncs = host_syncs()
    (mean, var), pred_s, pred_launch = timed(lambda: model.predict(key_pred, X_pool))
    z, embed_s, _ = timed(lambda: model.embed(X_pool))
    losses = model.loss.cpu()
    rmse = np.sqrt(np.mean((mean.cpu().numpy() - y2) ** 2, axis=1)).tolist()
    summary = {"channels": 2, "num_steps": VIDKL_CHANNEL_STEPS, "fit_s": fit_s,
               "ms_per_svi_step": 1e3 * fit_s / VIDKL_CHANNEL_STEPS,
               "host_syncs_per_step": syncs / VIDKL_CHANNEL_STEPS,
               "loss_first": losses[:, 0].tolist(), "loss_last": losses[:, -1].tolist(),
               "predict_s": pred_s, "embed_s": embed_s, "pool_rmse": rmse,
               "launches": {"fit": fit_launch, "predict": pred_launch}}
    print(f"viDKL channels: {json.dumps(summary)}", flush=True)
    if losses.shape != (2, VIDKL_CHANNEL_STEPS) or not bool(torch.isfinite(losses).all()):
        fail(f"viDKL channels: losses of shape {tuple(losses.shape)} or non-finite")
    if mean.shape != (2, VIDKL_POOL) or var.shape != mean.shape or \
            z.shape != (2, VIDKL_POOL, 2) or not all(
                bool(torch.isfinite(t).all()) for t in (mean, var, z)):
        fail(f"viDKL channels: shapes {tuple(mean.shape)}, {tuple(z.shape)} or non-finite")
    launched = {"fit": fit_launch, "predict": pred_launch}
    require_launches("viDKL channels", launched, ("gram", "trtri"))
    return launched


def dkl_path():
    """DKL's NUTS fit (a tanh MLP's weights and the GP's hyperparameters),
    then predict at new points."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(DKL_N, DKL_D)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.05 * rng.normal(size=DKL_N)).astype(np.float32)
    X_new = rng.normal(size=(DKL_PREDICT, DKL_D)).astype(np.float32)
    key_fit, key_pred = get_keys(0)
    model = gpax_torch.DKL(DKL_D, z_dim=2, kernel="RBF", hidden_dim=DKL_HIDDEN)
    _, fit_s, fit_launch = timed(lambda: model.fit(
        key_fit, X, y, num_warmup=DKL_WARMUP, num_samples=DKL_SAMPLES,
        max_tree_depth=DKL_DEPTH, print_summary=False, progress_bar=False))
    stats = model.mcmc.get_extra_fields()
    leapfrogs = model.mcmc.num_leapfrogs
    (mean, draws), pred_s, pred_launch = timed(lambda: model.predict(key_pred, X_new))
    summary = {"n": DKL_N, "d": DKL_D, "hidden_dim": DKL_HIDDEN, "num_warmup": DKL_WARMUP,
               "num_samples": DKL_SAMPLES, "max_tree_depth": DKL_DEPTH, "fit_s": fit_s,
               "leapfrogs": leapfrogs, "ms_per_leapfrog": 1e3 * fit_s / max(leapfrogs, 1),
               "accept_mean": stats["accept_prob"].mean().item(),
               "divergences": int(stats["diverging"].sum()), "predict_s": pred_s,
               "launches": {"fit": fit_launch, "predict": pred_launch}}
    print(f"DKL: {json.dumps(summary)}", flush=True)
    if mean.shape != (DKL_PREDICT,) or not (bool(torch.isfinite(mean).all())
                                             and bool(torch.isfinite(draws).all())):
        fail(f"DKL: predictions of shape {tuple(mean.shape)} or non-finite")
    launched = {"fit": fit_launch, "predict": pred_launch}
    require_launches("DKL", launched, ("gram", "trtri"))
    return launched


def mtdkl_path():
    """viMTDKL on two tasks of test_models_extra.py's kind, 300 points."""
    rng = np.random.default_rng(0)
    X = np.concatenate([
        np.column_stack([rng.normal(size=(MTDKL_N0, MTDKL_D)), np.zeros(MTDKL_N0)]),
        np.column_stack([rng.normal(size=(MTDKL_N1, MTDKL_D)), np.ones(MTDKL_N1)])])
    y = np.concatenate([np.sin(X[:MTDKL_N0, 0]), np.cos(X[MTDKL_N0:, 0])])
    X, y = X.astype(np.float32), y.astype(np.float32)
    key_fit, key_pred = get_keys(0)
    model = gpax_torch.viMTDKL(MTDKL_D, z_dim=2, data_kernel="RBF", num_latents=1,
                               num_tasks=2, rank=1)
    _, fit_s, fit_launch = timed(lambda: model.fit(
        key_fit, X, y, num_steps=MTDKL_STEPS, print_summary=False, progress_bar=False))
    (mean, var), pred_s, pred_launch = timed(lambda: model.predict(key_pred, X))
    losses = model.loss.cpu()
    summary = {"n": len(y), "num_steps": MTDKL_STEPS, "fit_s": fit_s,
               "ms_per_svi_step": 1e3 * fit_s / MTDKL_STEPS, "loss_first": losses[0].item(),
               "loss_last": losses[-1].item(), "predict_s": pred_s,
               "rmse": float(np.sqrt(np.mean((mean.cpu().numpy() - y) ** 2))),
               "launches": {"fit": fit_launch, "predict": pred_launch}}
    print(f"viMTDKL: {json.dumps(summary)}", flush=True)
    if not all(bool(torch.isfinite(t).all()) for t in (losses, mean, var)):
        fail("viMTDKL: non-finite losses or predictions")
    launched = {"fit": fit_launch, "predict": pred_launch}
    require_launches("viMTDKL", launched, ("gram", "trtri"))
    return launched


def bnn_path() -> None:
    """BNN (no GP kernel) at 300 points: the NUTS fit and predict."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, BNN_N).astype(np.float32)
    y = np.sin(3 * X).astype(np.float32)
    key_fit, key_pred = get_keys(0)
    model = gpax_torch.BNN(1, 1, hidden_dim=BNN_HIDDEN)
    _, fit_s, _ = timed(lambda: model.fit(
        key_fit, X, y, num_warmup=BNN_WARMUP, num_samples=BNN_SAMPLES,
        print_summary=False, progress_bar=False))
    leapfrogs = model.mcmc.num_leapfrogs
    (y_pred, y_sampled), pred_s, _ = timed(lambda: model.predict(key_pred, X[:, None]))
    rmse = float(np.sqrt(np.mean((y_pred.cpu().numpy()[:, 0] - y) ** 2)))
    print("BNN: " + json.dumps({
        "n": BNN_N, "hidden_dim": BNN_HIDDEN, "fit_s": fit_s, "leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * fit_s / max(leapfrogs, 1), "predict_s": pred_s,
        "rmse": rmse}), flush=True)
    if y_pred.shape != (BNN_N, 1) or not (bool(torch.isfinite(y_pred).all())
                                          and bool(torch.isfinite(y_sampled).all())):
        fail(f"BNN: predictions of shape {tuple(y_pred.shape)} or non-finite")


def osc(x, p):
    """The structured mean A·sin(w·x)·exp(−d·x), written for one draw of its
    parameters (examples/structured_gp.py:23-26)."""
    return (p["A"] * torch.sin(p["w"] * x) * torch.exp(-p["d"] * x)).squeeze()


def osc_prior():
    return {"A": tppl.sample("A", tdist.LogNormal(0.0, 0.5)),
            "w": tppl.sample("w", tdist.Uniform(3.0, 7.0)),
            "d": tppl.sample("d", tdist.LogNormal(0.0, 0.5))}


def structured_gp():
    return gpax_torch.ExactGP(1, "Matern", mean_fn=osc, mean_fn_prior=osc_prior,
                              lengthscale_prior_dist=priors.gamma_dist(2.0, 5.0),
                              noise_prior_dist=priors.halfnormal_dist(0.1))


def sgp_truth(x: np.ndarray) -> np.ndarray:
    return 1.2 * np.sin(5.0 * x) * np.exp(-0.8 * x)


def _sgp_fit(gp, X, y, chains: int) -> dict:
    """Fit the structured GP (one chain, or LOCK_CHAINS in lockstep) and
    return its numbers, its K1/K2 launches and its checks' inputs."""
    k_fit, _ = get_keys(0)
    lockstep = dict(num_chains=chains, chain_method="vectorized", segment_size=LOCK_SEGMENT) \
        if chains > 1 else {}
    reset_counts()
    reset_host_syncs()
    t0 = time.perf_counter()
    gp.fit(k_fit, X, y, num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES, max_tree_depth=MAX_DEPTH,
           print_summary=False, progress_bar=False, **lockstep)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    syncs = host_syncs()
    mcmc = gp.mcmc
    stats = mcmc.get_extra_fields(group_by_chain=True)
    by_chain = gp.get_samples(chain_dim=True)
    steps = mcmc.num_lockstep_leapfrogs
    return {
        "chains": chains, "fit_s": fit_s, "leapfrogs": mcmc.num_leapfrogs,
        "lockstep_leapfrogs": steps, "ms_per_leapfrog": 1e3 * fit_s / max(steps, 1),
        "chain_draws_per_s": chains * NUM_SAMPLES / fit_s,
        "accept_mean": stats["accept_prob"].mean().item(),
        "divergences": int(stats["diverging"].sum()),
        "host_syncs_per_leapfrog": syncs / max(steps, 1),
        "chain_by_chain": mcmc.chain_by_chain,
        "w_range": [by_chain["w"].min().item(), by_chain["w"].max().item()],
        "chain_means": {k: v.float().reshape(chains, NUM_SAMPLES, -1).mean(1).tolist()
                        for k, v in by_chain.items()},
        "launches_fit": counts(),
    }


def structured_path(dev):
    """The structured ExactGP at config 1's size: SGP_N points of the damped
    oscillator on [0, 1.2], its mean written for one draw with w ~
    Uniform(3, 7) through the sigmoid; one chain on the fused route, then
    LOCK_CHAINS lockstep chains ("vectorized", the route "auto" takes),
    then predict over PREDICT_M points of [0, 2.4] from the single chain."""
    rng = np.random.default_rng(0)
    X_np = np.sort(rng.uniform(0.0, SGP_TRAIN_HI, SGP_N)).astype(np.float32)
    y_np = (sgp_truth(X_np) + SGP_NOISE * rng.normal(size=SGP_N)).astype(np.float32)
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    gp = structured_gp()
    with route("always"):
        one = _sgp_fit(gp, X, y, 1)
    lock = structured_gp()
    many = _sgp_fit(lock, X, y, LOCK_CHAINS)
    by_chain = lock.get_samples(chain_dim=True)
    many["rhat"] = {k: float(np.max(gpax_torch.infer.gelman_rubin(v.float())))
                    for k, v in by_chain.items()}
    X_new = torch.linspace(0.0, SGP_PREDICT_HI, PREDICT_M, device=dev)[:, None]
    _, k_pred = get_keys(0)
    reset_counts()
    t0 = time.perf_counter()
    mean, draws = gp.predict_in_batches(k_pred, X_new, batch_size=PREDICT_BATCH, noiseless=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_launch = counts()
    x = X_new[:, 0].cpu().numpy()
    err = mean.numpy() - sgp_truth(x)
    train = x <= SGP_TRAIN_HI
    rmse = float(np.sqrt(np.mean(err[train] ** 2)))
    rmse_extra = float(np.sqrt(np.mean(err[~train] ** 2)))
    summary = {"n": SGP_N, "num_warmup": NUM_WARMUP, "num_samples": NUM_SAMPLES,
               "max_tree_depth": MAX_DEPTH, "segment_size": LOCK_SEGMENT,
               "one_chain_fused": {k: v for k, v in one.items() if k != "launches_fit"},
               "lockstep": {k: v for k, v in many.items() if k != "launches_fit"},
               "predict_m": PREDICT_M, "predict_s": pred_s, "rmse_train_range": rmse,
               "rmse_extrapolation": rmse_extra, "launches_fit": one["launches_fit"],
               "launches_lockstep_fit": many["launches_fit"], "launches_predict": pred_launch}
    print("structured ExactGP: " + json.dumps(summary), flush=True)
    for run, fit in (("one chain", one), ("lockstep", many)):
        w = fit["w_range"]
        if not (3.0 < w[0] and w[1] < 7.0):
            fail(f"structured {run}: w draws {w} leave (3, 7)")
        if fit["divergences"] > 0.05 * fit["chains"] * NUM_SAMPLES:
            fail(f"structured {run}: {fit['divergences']} divergences")
        if not 0.5 <= fit["accept_mean"] <= 0.99:
            fail(f"structured {run}: mean accept {fit['accept_mean']}")
    if many["chain_by_chain"]:
        fail("structured lockstep: the batched potential was not trusted")
    if not max(many["rhat"].values()) < LOCK_RHAT_MAX:
        fail(f"structured lockstep: R-hat {many['rhat']}")
    single = gp.get_samples()
    for site, v in single.items():
        ref, sd = v.float().mean(0), v.float().std(0) + 1e-6
        for c in range(LOCK_CHAINS):
            m = by_chain[site][c].float().mean(0)
            if not bool((abs(m - ref) < FUSED_SD * sd).all()):
                fail(f"structured lockstep chain {c}: posterior mean of {site} {m.tolist()} "
                     f"is off the single chain's {ref.tolist()} (sd {sd.tolist()})")
    steps = many["lockstep_leapfrogs"]
    for k in ("gram", "trtri"):
        if not steps <= many["launches_fit"][k] <= steps + LOCK_EXTRA_LAUNCHES:
            fail(f"structured lockstep fit: {many['launches_fit'][k]} {k} launches for "
                 f"{steps} lockstep leapfrogs (one each, plus at most {LOCK_EXTRA_LAUNCHES})")
    if not (mean.shape == (PREDICT_M,) and draws.shape == (NUM_SAMPLES, 1, PREDICT_M)
            and bool(torch.isfinite(mean).all()) and bool(torch.isfinite(draws).all())):
        fail(f"structured predict: shapes {tuple(mean.shape)}, {tuple(draws.shape)} "
             "or non-finite")
    if not rmse <= SGP_RMSE_MAX:
        fail(f"structured predict: RMSE {rmse} on the training range > {SGP_RMSE_MAX}")
    launched = {"fit": one["launches_fit"], "lockstep fit": many["launches_fit"],
                "predict": pred_launch}
    require_launches("structured ExactGP", launched, ("gram", "trtri"))
    return launched, gp, lock


def _restore_check(label: str, model, build_model, predict, compare, dev) -> dict:
    """save_model ``model`` (under the git-ignored build/), load it onto
    ``build_model()`` on the card and on the CPU. The card's ``predict(m)``
    equals the original's bit for bit; the CPU's ``compare(m, "cpu")``
    equals the original's on the CPU (the same port call) to CKPT_RTOL, and
    the card's mean to CKPT_CARD_CPU_TOL of its largest value. (A variance
    is a difference of terms of the prior's size that cancel near the data,
    so the grams' float32 rounding leaves it agreeing only to ~1e-2 of its
    own size: 9.0e-3 for viGP config 2 in call 1, PR 11; it is printed.)"""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_checkpoints", label.replace(" ", "_"))
    reset_counts()
    save_model(path, model)
    torch.cuda.empty_cache()
    ref = predict(model)
    card = load_model(path, build_model())
    torch.cuda.empty_cache()
    got = predict(card)
    launched = counts()
    cpu = load_model(path, build_model(), device="cpu")
    on_cpu = compare(cpu, "cpu")
    ref_cpu = compare(model, "cpu")
    model._to_device(dev)
    on_card = compare(card, dev)

    def rel(a, b):
        return max(((x.cpu() - y.cpu()).abs().max() / y.abs().max()).item()
                   for x, y in zip(a, b))

    bitwise = all(torch.equal(a, b) for a, b in zip(ref, got))
    out = {"card_bitwise": bitwise, "cpu_vs_original_on_cpu_rel": rel(on_cpu, ref_cpu),
           "card_vs_cpu_mean_rel": rel(on_card[:1], on_cpu[:1]),
           "card_vs_cpu_var_rel": rel(on_card[1:], on_cpu[1:]) if len(on_cpu) > 1 else None,
           "card_device": str(card.X_train.device), "cpu_device": str(cpu.X_train.device),
           "file_bytes": os.path.getsize(path + ".npz")}
    print(f"checkpoint {label}: " + json.dumps(out), flush=True)
    if not bitwise:
        fail(f"checkpoint {label}: the restored model's predict on the card differs")
    if card.X_train.device.type != "cuda" or cpu.X_train.device.type != "cpu":
        fail(f"checkpoint {label}: restored on {card.X_train.device} and {cpu.X_train.device}")
    if not out["cpu_vs_original_on_cpu_rel"] <= CKPT_RTOL:
        fail(f"checkpoint {label}: the CPU restore differs from the original on the CPU")
    if not out["card_vs_cpu_mean_rel"] <= CKPT_CARD_CPU_TOL:
        fail(f"checkpoint {label}: the card's predictive mean differs from the CPU's")
    return launched


def checkpoint_path(dev, sgp, vigp, vigp_X) -> dict:
    """save_model and load_model of the single-chain structured fit (predict
    on CKPT_POINTS points with every draw on the card, and the predictive
    mean of CKPT_CPU_DRAWS draws on the card and the CPU) and of the viGP
    config2 model (a batch of its grid)."""
    X_chk = torch.linspace(0.0, SGP_PREDICT_HI, CKPT_POINTS, device=dev)[:, None]

    def sgp_predict(m):
        return m.predict(1, X_chk, noiseless=True)

    def sgp_compare(m, device):
        few = {k: v[:CKPT_CPU_DRAWS] for k, v in m.get_samples().items()}
        mean, _ = m.predict(1, X_chk.to(device), samples=few, noiseless=True, device=device)
        return (mean,)

    def vigp_compare(m, device):
        return m.predict(1, torch.as_tensor(vigp_X, dtype=torch.float32, device=device),
                         device=device)

    return {"structured ExactGP": _restore_check("structured ExactGP", sgp, structured_gp,
                                                 sgp_predict, sgp_compare, dev),
            "viGP config2": _restore_check(
                "viGP config2", vigp, lambda: gpax_torch.viGP(input_dim=2, kernel="Matern"),
                lambda m: vigp_compare(m, dev), vigp_compare, dev)}


def hypo_linear(x, p):
    return p["a"] * x + p["b"]


def hypo_quadratic(x, p):
    return p["a"] * x**2 + p["b"]


def hypo_prior():
    return {"a": tppl.sample("a", tdist.Normal(0.0, 2.0)),
            "b": tppl.sample("b", tdist.Normal(0.0, 2.0))}


def hypo_path() -> dict:
    """examples/hypothesis_learning.py on the card: linear and quadratic
    hypotheses of 1.5x² − 0.5 + N(0, 0.05²) on a HYPO_GRID grid of [−1, 1],
    HYPO_START points measured to start, HYPO_ROUNDS rounds: the bandit
    (eps-greedy, eps 0.3, numpy seed 0) picks a hypothesis, ``hypo.step``
    fits it (sPM on even rounds, the hypothesis as an ExactGP's mean on
    odd ones), its reward −mean(obj) goes to ``update_record``, and its
    most uncertain point is measured next."""
    rng = np.random.default_rng(0)
    np.random.seed(0)
    grid = np.linspace(-1.0, 1.0, HYPO_GRID).astype(np.float32)
    measured = [int(i) for i in rng.choice(HYPO_GRID, HYPO_START, replace=False)]
    y_all = (1.5 * grid**2 - 0.5 + 0.05 * rng.normal(size=HYPO_GRID)).astype(np.float32)
    models = ((hypo_linear, hypo_prior), (hypo_quadratic, hypo_prior))
    record = np.zeros((len(models), 2))
    launched, rounds = {}, []
    for r in range(HYPO_ROUNDS):
        wrap = r % 2 == 1
        k = sample_next(record[:, 1], "eps-greedy", eps=0.3)
        fn, prior = models[k]
        unmeasured = [i for i in range(HYPO_GRID) if i not in set(measured)]
        reset_counts()
        t0 = time.perf_counter()
        obj, _ = hypo.step(fn, prior, grid[measured], y_all[measured], grid[unmeasured],
                           gp_wrap=wrap, num_warmup=HYPO_WARMUP, num_samples=HYPO_SAMPLES,
                           print_summary=False)
        torch.cuda.synchronize()
        launched[f"round {r}"] = counts()
        if not (tuple(obj.shape) == (len(unmeasured),) and bool(torch.isfinite(obj).all())
                and bool((obj >= 0).all())):
            fail(f"hypothesis learning round {r}: obj of shape {tuple(obj.shape)} (want "
                 f"{len(unmeasured)}), non-finite or negative")
        if wrap:
            require_launches("hypothesis learning GP-wrapped", {f"round {r}": counts()},
                             ("gram", "trtri"))
        reward = -float(obj.mean())
        record = update_record(record, k, reward)
        nxt = unmeasured[int(np.argmax(obj.cpu().numpy()))]
        measured.append(nxt)
        rounds.append({"round": r, "gp_wrap": wrap, "hypothesis": k,
                       "s": time.perf_counter() - t0, "measured": len(measured) - 1,
                       "reward": reward, "next_x": float(grid[nxt]),
                       "launches": launched[f"round {r}"]})
    print("hypothesis learning: " + json.dumps({"grid": HYPO_GRID, "rounds": rounds,
                                                "record": record.tolist()}), flush=True)
    if not (record[:, 0] > 0).all():
        fail(f"hypothesis learning: a hypothesis was never fitted ({record.tolist()})")
    if not record[1, 1] > record[0, 1]:
        fail(f"hypothesis learning: the quadratic's mean reward {record[1, 1]} is not above "
             f"the linear's {record[0, 1]}")
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
        k1_f64 = check_k1_f64(dev)
        k2 = check_k2(dev)
        k3 = check_k3(dev)
        k45_err = check_panel(dev)
    with phase("ExactGP potential and routes"):
        check_potential(dev)
        fused_crossover(dev)
        auto_routes(dev)
    paths = {}
    with phase("ExactGP composed fit and predict"):
        paths["ExactGP"], gp, chunk, _ = main_path(dev, "never")
        check_main_shapes(gp, chunk)
    with phase("ExactGP BO"):
        paths["ExactGP BO"] = bo_path(gp)
    with phase("K4/K5 on the fit's gram"):
        paths["ExactGP panel factors"], panel_err, k45 = panel_path(gp)
    with phase("parallel on the composed fit"):
        paths["parallel"] = parallel_path(gp)
    composed = gp.get_samples()
    del gp
    torch.cuda.empty_cache()
    with phase("ExactGP x64 fit and predict"):
        paths["ExactGP x64"] = x64_path(dev, composed)
    torch.cuda.empty_cache()
    with phase("ExactGP fused fit and predict"):
        paths["ExactGP fused"], gp, _, fused_summary = main_path(dev, "always")
        check_fused_posterior(composed, gp.get_samples())
    fused = gp.get_samples()
    del gp, composed
    torch.cuda.empty_cache()
    with phase("ExactGP lockstep chains"):
        paths["ExactGP lockstep"], gp = lockstep_path(dev, fused, fused_summary)
        check_lockstep_shapes(gp)
    del gp, fused
    torch.cuda.empty_cache()
    with phase("vExactGP lockstep chains"):
        paths["vExactGP"] = vexact_path(dev)
    torch.cuda.empty_cache()
    with phase("slice-6 models"):
        paths.update(slice6_paths())
    torch.cuda.empty_cache()
    for label, n, steps in SPARSE_PHASES:
        with phase(f"viSparseGP {label}"):
            paths[f"viSparseGP {label}"], model = sparse_path(label, n, steps)
            check_sparse_shapes(label, model)
        del model
        torch.cuda.empty_cache()
    with phase("viGP config2"):
        paths["viGP config2"], vigp, vigp_X = vigp_path()
        check_vigp_shapes(vigp, vigp_X)
    torch.cuda.empty_cache()
    with phase("MultiTaskGP config4"):
        paths["MultiTaskGP config4"], model, X_test, X_kg, key = config4_path()
        check_config4_shapes(model, X_test, X_kg, key)
    del model
    torch.cuda.empty_cache()
    with phase("MultiTaskGP freeze"):
        paths["MultiTaskGP freeze"] = freeze_path()
    with phase("viDKL config5"):
        paths["viDKL config5"], model, X_pool = vidkl_path()
        check_vidkl_shapes(model, X_pool)
    del model
    torch.cuda.empty_cache()
    with phase("viDKL channels"):
        paths["viDKL channels"] = vidkl_channels_path()
    with phase("DKL"):
        paths["DKL"] = dkl_path()
    with phase("viMTDKL"):
        paths["viMTDKL"] = mtdkl_path()
    with phase("BNN"):
        bnn_path()
    torch.cuda.empty_cache()
    with phase("structured ExactGP"):
        paths["structured ExactGP"], sgp, lock = structured_path(dev)
        check_lockstep_shapes(lock, "matern52", "structured lockstep fit")
    del lock
    torch.cuda.empty_cache()
    with phase("checkpoint"):
        for label, launched in checkpoint_path(dev, sgp, vigp, vigp_X).items():
            paths[f"checkpoint {label}"] = {"save, load and predict": launched}
    del sgp, vigp
    torch.cuda.empty_cache()
    with phase("hypothesis learning"):
        paths["hypothesis learning"] = hypo_path()

    def launches(k):
        by_path = {p: sum(c[k] for c in v.values()) for p, v in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    panel_err = np.maximum(panel_err, k45_err)
    kernels = [
        {"name": "gram", "route": "cuda", "source": "gpax_torch/csrc/gram.cu",
         "replaces": "gpax_tpu/ops/pallas_gram.py:64", **launches("gram"), **k1},
        {"name": "gram_f64", "route": "cuda", "source": "gpax_torch/csrc/gram.cu",
         "replaces": "gpax_tpu/ops/pallas_gram.py:64", **launches("gram_f64"), **k1_f64},
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
