"""K1's share of its roofline in the fit: the least time of one n×n gram
(read X/ℓ and the noise once, write the gram; 2d + 4 operations and one exp
an element, as chip_smoke.py counts them) over the mean time of a launch of
``gram_kernel`` in the profiled segments."""

from portbench.harness.hw import bound_s


def k1_bytes_flops(n: int, m: int, d: int, itemsize: int = 4):
    return itemsize * (n * d + m * d + n + n * m), n * m * (2 * d + 4)


def read(ctx):
    t, cfg = ctx["trace"], ctx["cfg"]
    if t is None:
        return None
    s, count = t.kernel_s(r"\bgram_kernel\b")
    if not count:
        return None
    b, f = k1_bytes_flops(cfg["n"], cfg["n"], cfg["input_dim"])
    return 100.0 * bound_s(b, f) / (s / count)
