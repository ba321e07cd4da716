"""The gpax_torch example scripts of the multi-task, heteroskedastic,
uncertain-input and measured-noise GPs and of the model comparison
(ExactGP, iBNN, DKL), on the CPU under SMOKE=1, at the JAX budgets with
the NUTS tree depth cut to 5 (tests/test_torch_examples.py runs the others;
at the JAX depth of 10, heteroskedastic_gp's trees run to ~900 leapfrogs a
draw)."""

import pytest
import torch

from test_torch_examples import NUTS_CUT, run_script

torch.set_num_threads(1)

NUTS_SCRIPTS = ["multitask_bo.py", "heteroskedastic_gp.py", "uncertain_inputs.py",
                "measured_noise_gp.py", "compare_gps.py"]


@pytest.mark.parametrize("script", NUTS_SCRIPTS)
def test_example_nuts_script(script, monkeypatch, capsys):
    run_script(script, monkeypatch, capsys, nuts=NUTS_CUT)
