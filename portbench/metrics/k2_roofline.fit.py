"""K2's share of its roofline in the fit: the least time of the float64
inverses of the n/128 diagonal tiles of one factor (each tile read once and
its inverse written once; 128³/3 operations a tile) over the mean time of a
launch of ``tile_tri_inv_kernel`` in the profiled segments. The wrapper's
zero fill of W is a separate fill, not counted here."""

from portbench.harness.hw import bound_s

TILE = 128


def k2_bytes_flops(n: int, itemsize: int = 8):
    tiles = -(-n // TILE)
    return 2 * tiles * TILE * TILE * itemsize, tiles * TILE**3 / 3


def read(ctx):
    t, cfg = ctx["trace"], ctx["cfg"]
    if t is None:
        return None
    s, count = t.kernel_s(r"\btile_tri_inv_kernel\b")
    if not count:
        return None
    b, f = k2_bytes_flops(cfg["n"])
    return 100.0 * bound_s(b, f, "float64") / (s / count)
