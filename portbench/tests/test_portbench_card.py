"""On the card, at the cell's own size: a sound run of the program is
correct; the control (the sampler's gradient with the program's own float32
WᵀW, read at the run's draws, and the reference's float32 factor) fails one
of the numbers compared; and
each fault the cell can have, planted in the timed path, comes out not
correct. Skipped without a CUDA card:

    python -m pytest portbench/tests/test_portbench_card.py -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.harness import spec

from .conftest import run_in_process
from .test_portbench_checks import FAULTS

CELL = "gp4096.fit"
SEED = 2147483659


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is measured at the cell's own size")


def _run(control: int, seconds: int):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed", str(SEED),
         "--seconds", str(seconds), "--trace", "0", "--control", str(control)],
        cwd=spec.HERE.parent, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    ctl = [ln for ln in out.stderr.splitlines() if ln.startswith("control readings: ")]
    return line, (json.loads(ctl[-1].split(": ", 1)[1]) if ctl else {})


@pytest.mark.cuda
def test_program_passes_and_control_fails(card):
    line, _ = _run(0, 51)
    assert line["correct"] is True, line["checks"]
    _, ctl = _run(1, 51)
    limits = spec.load_cell(CELL).limits
    assert any(v > limits[k] for k, v in ctl.items()), (ctl, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(FAULTS[CELL]))
def test_a_fault_on_the_card_is_not_correct(card, fault, monkeypatch):
    FAULTS[CELL][fault](monkeypatch)
    line, judged, _ = run_in_process(spec.load_cell(CELL), seed=SEED + 2, seconds=51,
                                     device="cuda")
    assert line["correct"] is False, judged
