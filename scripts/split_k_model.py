"""The split-K schedule of K4's and K5's products (``Pieces`` in
gpax_torch/csrc/panel_chol.cu), replayed on the host for one matrix: for
each panel, how the 64-row tiles' k-ranges are cut into pieces when the
tiles are fewer than the blocks, and the longest piece, which sets the
panel's product time. Prints, for K5 at a given n and grid, the sum over
the panels of the longest piece in 16-deep k-slices under three rules:
S equal pieces a tile, pieces of at most ceil(slices / (blocks - tiles))
slices, and the least piece length whose pieces fit the blocks (the
kernel's rule); and the sum of slices / blocks, the bound of a perfect
split. No card needed:

    python3 scripts/split_k_model.py --n 8192 --blocks 264
"""

from __future__ import annotations

import argparse

ROWS, PANEL, SLICE = 64, 128, 16  # product tile rows, panel width, k-slice


def longest(slices, blocks: int, rule: str) -> int:
    """The longest piece (in slices) of one panel whose tiles have the
    given k-ranges, under ``rule``."""
    tiles = len(slices)
    if tiles >= blocks:
        return max(slices)
    if rule == "equal":
        S = max(1, min(blocks // tiles, max(slices)))
        return max(-(-s // S) for s in slices)
    if rule == "bound":
        length = max(1, -(-sum(slices) // (blocks - tiles)))
    else:  # "search", as the kernel does it
        lo, hi = 1, max(slices)
        while lo < hi:
            mid = (lo + hi) // 2
            if sum(-(-s // mid) for s in slices) <= blocks:
                hi = mid
            else:
                lo = mid + 1
        length = lo
    return max(-(-s // -(-s // length)) for s in slices)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--blocks", type=int, default=264)
    args = ap.parse_args()
    totals = {"equal": 0, "bound": 0, "search": 0}
    ideal = 0.0
    for j in range(1, args.n // PANEL):
        jT = j * PANEL
        # K5: row tile u of W^T starts at its own panel
        slices = [(jT - (u * ROWS // PANEL) * PANEL) // SLICE for u in range(jT // ROWS)]
        for rule in totals:
            totals[rule] += longest(slices, args.blocks, rule)
        ideal += sum(slices) / args.blocks
    print(f"K5 n={args.n} blocks={args.blocks}: longest pieces summed over the panels, in "
          f"slices: equal {totals['equal']}, bound {totals['bound']}, search "
          f"{totals['search']}; perfect split {ideal:.0f}")


if __name__ == "__main__":
    main()
