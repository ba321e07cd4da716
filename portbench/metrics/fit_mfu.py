"""The fit's share of the card's float64 peak: the operations a leapfrog
step of the exact GP needs at the configuration's n and d, counted from the
shapes, times the leapfrogs of the unprofiled segments, over their wall
time, against 67 TFLOP/s (float64 on the tensor cores; K1's float32 gram
runs at the same published rate outside them). The power limit the run
prints stands beside it."""

from portbench.harness.hw import PEAK_FLOPS


def leapfrog_flops(n: int, d: int) -> float:
    """Operations of one likelihood and θ-gradient at n points of d dims:

    - gram: n²·(3d + 3) (differences, squares and sums; −½, exp, k_scale)
    - Cholesky factor: n³/3
    - W = L⁻¹: n³/3
    - α = W·y and β = Wᵀα: n² each
    - K⁻¹ = WᵀW, a symmetric product of a triangular matrix: n³/3
    - D = ββᵀ − K⁻¹ and D∘m: 3n²
    - (D∘m)·[X/ℓ, 1] for the lengthscale and scale gradients: 2n²(d + 1)
    """
    return n**3 + n * n * (3 * d + 3 + 2 + 3 + 2 * (d + 1))


def read(ctx):
    c, cfg = ctx["counters"], ctx["cfg"]
    if not c.get("clean_leapfrogs"):
        return None
    flops = leapfrog_flops(cfg["n"], cfg["input_dim"]) * c["clean_leapfrogs"]
    return 100.0 * flops / (c["clean_wall_s"] * PEAK_FLOPS["float64"])
