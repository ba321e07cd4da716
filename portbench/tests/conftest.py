"""Shared pieces of the benchmark's own tests: a cell cut to a size the CPU
runs in seconds, and the run of a cell in this process (the harness's look for a card
left out)."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.harness import result, spec

# the cells at a size the CPU holds: (configuration, mix) changed from the
# cell's; every other setting as the cell has it
TINY = {
    "gp4096.fit": ({"n": 128, "num_warmup": 10, "max_tree_depth": 4},
                   {"trace_seconds": 1, "check_draws": 8, "check_grad_draws": 4}),
    "gp4096.score": ({"n": 64},
                     {"points": 40, "draws": 4, "check_upto": 3, "check_requests": 2,
                      "trace_from": 1, "trace_requests": 2}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(name: str, root=spec.HERE):
    cell = spec.load_cell(name, root)
    cfg, tr = TINY[name]
    cell.config.update(cfg)
    cell.traffic.update(tr)
    return cell


def run_in_process(cell, seed: int = 2**31 + 11, seconds: float = 1.5, traced: bool = False,
                   control: bool = False, device: str = "cpu"):
    """(result line, numbers beside their limits, Run) of one run in this
    process, on the CPU unless ``device`` says otherwise."""
    driver = spec.module("drivers", cell.traffic["driver"])
    run = driver.run(cell, seed, seconds, traced, device, time.perf_counter(), control)
    line, judged = result.build_line(cell, run, traced, device)
    return line, judged, run
