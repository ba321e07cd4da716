"""The segmented runner's options on a non-segmented ExactGP fit: the port
warns and runs the ordinary fit where gpax_tpu does
(tests/test_round5.py::test_nonsegmented_run_warns_on_ignored_options), and
still raises on ``segment_size``, whose runner is not ported."""

import time

import numpy as np
import pytest
import torch

import gpax_torch

torch.set_num_threads(1)


def _data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, n).astype(np.float32)
    y = (np.sin(2 * X) + rng.normal(0, 0.1, n)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("option", ["segment_callback", "deadline", "warmup_depth_cap"])
def test_ignored_option_warns_and_fits(option):
    value = {"segment_callback": lambda *a, **k: None,
             "deadline": time.perf_counter() + 3600.0,
             "warmup_depth_cap": (2, 5)}[option]
    X, y = _data()
    gp = gpax_torch.ExactGP(1, "RBF")
    with pytest.warns(UserWarning, match="segment_size"):
        gp.fit(0, X, y, num_warmup=10, num_samples=10, print_summary=False,
               progress_bar=False, device="cpu", **{option: value})
    samples = gp.get_samples()
    assert set(samples) == {"k_length", "k_scale", "noise"}
    assert all(v.shape[0] == 10 and torch.isfinite(v).all() for v in samples.values())


def test_segment_size_still_raises():
    X, y = _data()
    with pytest.raises(NotImplementedError):
        gpax_torch.ExactGP(1, "RBF").fit(0, X, y, num_warmup=10, num_samples=10,
                                         print_summary=False, device="cpu", segment_size=4)
