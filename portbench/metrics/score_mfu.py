"""The scoring window's share of the card's peak: the operations an EI
request needs over the mixture of the exact GP's draws, counted from the
shapes, times the requests the profiler did not slow, over their latencies,
against 67 TFLOP/s
(float64 on the tensor cores for the factor and the inverse, float32
outside them for the products). The power limit the run prints stands
beside it."""

from portbench.harness.hw import PEAK_FLOPS


def request_flops(n: int, m: int, d: int, draws: int) -> float:
    """Operations of the predictive moments at m candidates from n training
    points of d dims, for each draw:

    - grams k_XX and k_pX: (n² + nm)·(3d + 3), as K1 counts them
    - Cholesky factor of k_XX: n³/3; W = L⁻¹: n³/3
    - A = W·k_pXᵀ, W triangular: n²m; v = W·y: n²
    - mean Aᵀv and the variance's column sums of A∘A: 2nm each
    """
    per_draw = (2 * n**3 / 3 + n * n * m + n * n + 4 * n * m
                + (n * n + n * m) * (3 * d + 3))
    return draws * per_draw


def read(ctx):
    c, cfg, tr = ctx["counters"], ctx["cfg"], ctx["traffic"]
    if not c.get("clean_requests"):
        return None
    flops = request_flops(cfg["n"], tr["points"], cfg["input_dim"], tr["draws"])
    return 100.0 * flops * c["clean_requests"] / (c["clean_s"] * PEAK_FLOPS["float64"])
