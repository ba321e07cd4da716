"""Hypothesis-driven active learning (arXiv:2112.06649 workflow), on gpax_torch.

The gpax_torch form of examples/hypothesis_learning.py (the reference's
gpax_hypo.ipynb): compete multiple physical hypotheses (parametric models)
in a bandit loop, rewarding hypotheses whose posterior converges and reduces
predictive uncertainty. ``main(device=None, nuts=None)`` runs on the CUDA
card unless ``device`` says otherwise; ``nuts``'s ``num_warmup`` and
``num_samples`` are merged into every NUTS fit's budget (``hypo.step``
takes no other sampler option: its fits run at the JAX package's fixed
tree depth of 10). Set SMOKE=1 for tiny budgets.
"""

import os

import numpy as np
import torch

import gpax_torch.distributions as dist
from gpax_torch import ppl
from gpax_torch.hypo import sample_next, step, update_record

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
BUDGET = dict(num_warmup=100, num_samples=100) if SMOKE else dict(num_warmup=1000, num_samples=1000)


# competing hypotheses about the measured system
def linear(x, p):
    return p["a"] * x + p["b"]


def quadratic(x, p):
    return p["a"] * x**2 + p["b"]


def linear_prior():
    return {"a": ppl.sample("a", dist.Normal(0.0, 2.0)),
            "b": ppl.sample("b", dist.Normal(0.0, 2.0))}


def quadratic_prior():
    return {"a": ppl.sample("a", dist.Normal(0.0, 2.0)),
            "b": ppl.sample("b", dist.Normal(0.0, 2.0))}


def main(device=None, nuts=None):
    budget = {**BUDGET, **{k: v for k, v in (nuts or {}).items() if k in BUDGET}}
    rng = np.random.default_rng(0)
    truth = lambda x: 1.5 * x**2 - 0.5  # noqa: E731  (quadratic is the correct hypothesis)
    X_all = np.linspace(-1, 1, 25)
    measured_idx = list(rng.choice(25, 5, replace=False))

    models = [(linear, linear_prior), (quadratic, quadratic_prior)]
    record = np.zeros((len(models), 2))

    steps = 3 if SMOKE else 10
    for it in range(steps):
        k = sample_next(record[:, 1], "eps-greedy", eps=0.3)
        model, prior = models[k]
        X_m = torch.tensor(X_all[measured_idx], dtype=torch.float32)
        y_m = torch.tensor(truth(X_all[measured_idx])
                           + 0.05 * rng.normal(size=len(measured_idx)), dtype=torch.float32)
        unmeasured = [i for i in range(25) if i not in measured_idx]
        X_u = torch.tensor(X_all[unmeasured], dtype=torch.float32)
        obj, fitted = step(model, prior, X_m, y_m, X_u, num_restarts=1, print_summary=False,
                           device=device, **budget)
        # reward = negative mean predictive variance (confident hypotheses win)
        obj = obj.cpu().numpy()
        reward = -float(np.mean(obj))
        record = update_record(record, k, reward)
        nxt = unmeasured[int(np.argmax(obj))]
        measured_idx.append(nxt)
        print(f"step {it}: hypothesis={'linear' if k == 0 else 'quadratic'} "
              f"reward={reward:+.4f} next_x={X_all[nxt]:+.2f}")

    print("final running rewards:", np.round(record[:, 1], 4),
          "-> winner:", "quadratic" if record[1, 1] > record[0, 1] else "linear")
    return record


if __name__ == "__main__":
    main()
