"""The program side of the exact GP configurations: ``gpax_torch.ExactGP``
built from the configuration, its NUTS fit's outputs, the scoring of
candidates by ``acquisition.EI`` on injected posterior draws, and their
checks against ``reference/exactgp.py``."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

import gpax_torch
from gpax_torch import acquisition

from ..reference import exactgp as ref


def build(cfg: Dict):
    return gpax_torch.ExactGP(cfg["input_dim"], cfg["kernel_name"])


def fit_data(cfg: Dict, seed: int):
    return ref.make_data(cfg, seed)


@contextlib.contextmanager
def control_path():
    """The program's own path one precision below the configuration's: the
    sampler's K⁻¹ = WᵀW in float32 (``hmc_wtw_precision="highest"``) where
    the configuration states float64. The control's gradient is read at the
    sound run's own draws."""
    old = gpax_torch.get_config().hmc_wtw_precision
    gpax_torch.set_config(hmc_wtw_precision="highest")
    try:
        yield
    finally:
        gpax_torch.set_config(hmc_wtw_precision=old)


@contextlib.contextmanager
def _sampler_precision():
    """The precision ``MCMC.run`` gives the sampler's gradient: a config
    ``hmc_wtw_precision`` is the ``wtw_precision`` of a run."""
    cfg = gpax_torch.get_config()
    hmc = cfg.hmc_wtw_precision
    if not hmc or hmc == cfg.wtw_precision:
        yield
        return
    gpax_torch.set_config(wtw_precision=hmc)
    try:
        yield
    finally:
        gpax_torch.set_config(wtw_precision=cfg.wtw_precision)


def sampled_draws(n_draws: int, traffic: Dict, seed: int) -> np.ndarray:
    """The indices of the draws the check compares, drawn from the seed."""
    if n_draws == 0:
        return np.zeros(0, dtype=np.int64)
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(n_draws, size=min(n_draws, traffic["check_draws"]),
                              replace=False))


def fit_outputs(model, traffic: Dict, seed: int, control: bool = False
                ) -> Dict[str, np.ndarray]:
    """The sampling draws (constrained), their potentials and tree sizes, and
    the program's θ-gradient of U at the first ``check_grad_draws`` of the
    sampled draws: the potential the sampler calls (``ppl.initialize_model``
    on the model and the data the fit holds), differentiated as the sampler
    does, at the sampler's precision; with ``control``, also on
    ``control_path`` (``grad_control``). On the host."""
    samples = model.get_samples()
    stats = model.mcmc.get_extra_fields()
    draws = {k: v.detach().cpu().numpy() for k, v in samples.items()}
    draws["potential_energy"] = stats["potential_energy"].detach().cpu().numpy()
    draws["num_steps"] = stats["num_steps"].detach().cpu().numpy()
    idx = sampled_draws(len(draws["potential_energy"]), traffic, seed)
    X, y = model.X_train, model.y_train
    info = gpax_torch.ppl.initialize_model(
        model.model, torch.Generator(device=X.device).manual_seed(seed % (1 << 62)), (X, y))

    def grads():
        out = []
        with _sampler_precision():
            for i in idx[:traffic["check_grad_draws"]]:
                z = {s: info.transforms[s].inv(samples[s][i]).detach().requires_grad_(True)
                     for s in ref.SITES}
                g = torch.autograd.grad(info.potential_fn(z), [z[s] for s in ref.SITES])
                out.append(torch.cat([t.reshape(-1) for t in g]).detach().double().cpu())
        return torch.stack(out).numpy() if out else np.zeros((0, len(ref.SITES)))

    draws["grad"] = grads()
    if control:
        with control_path():
            draws["grad_control"] = grads()
    return draws


def _grad_gap(g: np.ndarray, g_ref: np.ndarray) -> float:
    """The widest gap of a gradient component from the reference's, over
    that component's root mean square across the draws (at posterior draws,
    about one over the posterior's spread in it)."""
    rms = np.sqrt((g_ref * g_ref).mean(0))
    return float((np.abs(g - g_ref) / rms).max())


def _theta(draws: Dict[str, np.ndarray], i: int) -> Dict[str, float]:
    return {k: float(np.asarray(draws[k][i]).reshape(-1)[0]) for k in ref.SITES}


def check_fit(cfg: Dict, traffic: Dict, data, out: Dict[str, np.ndarray], seed: int,
              device: str, control: bool):
    """(numbers compared, control readings) for a sample of the fit's draws:

    - ``potential_gap``: the widest gap in nats between a draw's potential as
      the sampler recorded it and the reference's U there;
    - ``grad_gap``: the widest gap between a component of the program's
      θ-gradient of U and the reference's, over the root mean square of the
      reference's component at those draws;
    - ``draw_excess``: the highest reference U of a draw above the posterior's
      least U (a chain that never left its start, or drew from elsewhere,
      reads thousands).

    With ``control``, the control's readings at the same draws:
    ``grad_gap`` of the gradient on ``control_path``, and ``potential_gap``
    of the reference with a float32 factor."""
    X, y = (torch.as_tensor(a, device=device) for a in data)
    U = out["potential_energy"]
    if len(U) == 0:
        return {k: float("inf") for k in ("potential_gap", "grad_gap", "draw_excess")}, {}
    idx = sampled_draws(len(U), traffic, seed)
    u_ref = np.array([ref.potential(X, y, _theta(out, i), cfg) for i in idx])
    u_min = min(ref.posterior_mode(X, y, cfg, cfg["mode_start"]), float(u_ref.min()))
    g_ref = np.stack([ref.potential_grad(X, y, _theta(out, i), cfg)
                      for i in idx[:len(out["grad"])]])
    checks = {"potential_gap": float(np.abs(U[idx] - u_ref).max()),
              "grad_gap": _grad_gap(out["grad"], g_ref),
              "draw_excess": float(u_ref.max() - u_min)}
    readings = {}
    if control:
        u32 = np.array([ref.potential(X, y, _theta(out, i), cfg, torch.float32) for i in idx])
        readings = {"potential_gap": float(np.abs(u32 - u_ref).max()),
                    "grad_gap": _grad_gap(out["grad_control"], g_ref)}
    return checks, readings


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a − b| over max|b| (inf if the shapes differ; NaN stays NaN)."""
    if a.shape != b.shape:
        return float("inf")
    return float((a.double() - b).abs().max() / b.abs().max())


class Scorer:
    """EI over new candidate grids on the configuration's data, with the
    posterior's draws made from the seed about the mix's centre and handed
    to ``EI`` as the fully Bayesian model's samples: no fit runs."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.X, self.y = ref.make_data(cfg, seed)
        post = traffic["posterior"]
        self.draws = ref.draws_around(post["centre"], post["log_sd"], traffic["draws"], seed)
        self.model = build(cfg)
        self.model._set_training_data(self.X, self.y, device=device)
        self.model.mcmc = object()  # fully Bayesian: EI scores the samples it is handed
        self.samples = {k: torch.as_tensor(v, device=device) for k, v in self.draws.items()}
        self.key = torch.Generator().manual_seed(seed)

    def inputs(self, i: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(self.seed * 1000003 + i)
        lo, hi = self.traffic["grid"]
        return ref.new_grid(self.traffic["points"], lo, hi, g, self.device)

    def score(self, Xn: torch.Tensor) -> torch.Tensor:
        return acquisition.EI(self.key, self.model, Xn, samples=self.samples)

    def release(self) -> None:
        del self.model, self.samples

    def check(self, requests: List, control: bool):
        """``ei_gap``: the widest gap between the program's EI and the
        reference's, over the reference's largest EI. With ``control``, the
        reference with W's products in TF32 (the step below the stated
        float32) put in the program's place, and, beside it, the reference
        with a float32 factor (``ei_gap_f32_factor``)."""
        X, y = (torch.as_tensor(a, device=self.device) for a in (self.X, self.y))
        gaps, ctl, ctl32 = [], [], []
        for i, out in requests:
            Xn = self.inputs(i)
            e_ref = ref.ei(*ref.predictive_moments(X, y, Xn, self.draws, self.cfg))
            gaps.append(_rel(out, e_ref))
            if control:
                with ref.tf32_products():
                    e_tf = ref.ei(*ref.predictive_moments(X, y, Xn, self.draws, self.cfg,
                                                          products=torch.float32))
                ctl.append(_rel(e_tf, e_ref))
                e_32 = ref.ei(*ref.predictive_moments(X, y, Xn, self.draws, self.cfg,
                                                      factor=torch.float32,
                                                      products=torch.float32))
                ctl32.append(_rel(e_32, e_ref))
        readings = ({"ei_gap": max(ctl), "ei_gap_f32_factor": max(ctl32)} if control else {})
        return {"ei_gap": max(gaps)}, readings
