"""Hypothesis learning, the active-learning driver of arXiv:2112.06649
(counterpart of ``gpax_tpu/hypo.py``, with its own copy of the workflow):
``step`` fits a hypothesis as an sPM or as the mean function of a
structured ExactGP, refitting with a new key while a split R-hat exceeds
1.1 (up to ``num_restarts`` fits), and returns the predictive variance
over the unmeasured points as the reward signal; ``sample_next`` is the
softmax or epsilon-greedy bandit policy; ``update_record`` keeps the
running rewards.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

from .infer.diagnostics import split_gelman_rubin
from .models.gp import ExactGP
from .models.spm import sPM
from .utils import get_keys


def step(model: Callable, model_prior: Callable, X_measured, y_measured,
         X_unmeasured=None, gp_wrap: bool = False, noise_prior: Optional[Callable] = None,
         gp_kernel: str = "Matern", gp_kernel_prior: Optional[Callable] = None,
         gp_input_dim: int = 1, num_warmup: int = 2000, num_samples: int = 2000,
         num_chains: int = 1, num_restarts: int = 1, print_summary: bool = True,
         device=None):
    """Fit the hypothesis ``model(x, params)`` with its prior program (as the
    mean function of an ExactGP if ``gp_wrap``) on ``device`` (None: the
    CUDA card), and return (predictive variance over ``X_unmeasured``, the
    fitted model); the variance is 0 without unmeasured points.

    The fit is repeated with the keys of seed 1, 2, ... while any split
    R-hat exceeds 1.1, at most ``num_restarts`` fits in all
    (``hypo.py:75-93``). The variance is over the posterior's predictive
    draws, with JAX's ddof of 0."""
    model_ = None
    rng_key_predict = None
    for i in range(num_restarts):
        rng_key, rng_key_predict = get_keys(i)
        if gp_wrap:
            model_ = ExactGP(gp_input_dim, gp_kernel, model, gp_kernel_prior, model_prior,
                             noise_prior)
            model_.fit(rng_key, X_measured, y_measured, num_warmup, num_samples, num_chains,
                       print_summary=print_summary, progress_bar=False, device=device)
        else:
            model_ = sPM(model, model_prior, noise_prior)
            model_.fit(rng_key, X_measured, y_measured, num_warmup, num_samples, num_chains,
                       print_summary=print_summary, device=device)
        rhats = []
        for k, v in model_.get_samples(True).items():
            if k == "mu" or v.ndim < 2:
                continue
            rh = np.max(split_gelman_rubin(v))
            # a constant (deterministic) site gives 0/0 = NaN, not a failure
            rhats.append(0.0 if np.isnan(rh) else float(rh))
        if max(rhats, default=0.0) < 1.1:
            break
    obj = 0
    if X_unmeasured is not None:
        _, samples = model_.predict(rng_key_predict, X_unmeasured, device=device)
        obj = samples.squeeze().var(0, correction=0)
    return obj, model_


def sample_next(rewards, method: str = "softmax", temperature: float = 1.0,
                eps: float = 0.4) -> int:
    """The index of the model (or channel) to sample next, by a bandit policy."""
    if method not in ("softmax", "eps-greedy"):
        raise NotImplementedError(
            "The currently implemented sampling methods are 'softmax' and 'eps-greedy'")
    if rewards.ndim != 1:
        raise AttributeError("Pass rewards as 1-dimensional array")
    if method == "softmax":
        return softmax(rewards, temperature)
    return eps_greedy(rewards, eps)


def softmax(logits, temperature: float = 1.0) -> int:
    """Softmax selection policy (numpy's global generator)."""
    logits = np.asarray(logits) / temperature
    logits = logits - logits.max()
    probs = np.exp(logits) / np.sum(np.exp(logits))
    return int(np.random.choice(np.arange(len(probs)), p=probs))


def eps_greedy(rewards, eps: float = 0.4) -> int:
    """Epsilon-greedy selection policy (numpy's global generator)."""
    if np.random.random() > eps:
        return int(np.asarray(rewards).argmax())
    return int(np.random.randint(len(rewards)))


def update_record(record: np.ndarray, action: int, r: Union[int, float]) -> np.ndarray:
    """Running-average reward update of a bandit record of shape (N, 2):
    column 0 counts the pulls, column 1 holds the mean reward."""
    new_r = (record[action, 0] * record[action, 1] + r) / (record[action, 0] + 1)
    record[action, 0] += 1
    record[action, 1] = new_r
    return record
