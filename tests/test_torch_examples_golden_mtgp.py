"""The MultiTaskGP BO gate of the bundled example workflows
(tests/test_examples.py:130-160) on gpax_torch, on the CPU: the same data,
budgets (400 + 400 draws at target accept 0.7), NUTS tree depth (the
default of 10) and bands as the JAX test, as examples_torch/golden.py
writes them. Its own file, as the largest of the gates
(tests/test_torch_examples_golden.py holds the others)."""

import os
import runpy

import torch

from test_torch_examples_golden import assert_gates

torch.set_num_threads(1)


def test_golden_mtgp_bo_step():
    """MultiTaskGP BO workflow: posterior predictive band on the target task
    and an EI argmax inside the known-good region of the objective."""
    golden = runpy.run_path(os.path.join(os.path.dirname(__file__), "..", "examples_torch",
                                         "golden.py"))
    assert_gates(golden["mtgp_bo_step"]("cpu"))
