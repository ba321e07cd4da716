"""Stochastic variational inference: Trace-ELBO, auto-guides and Adam
(counterpart of ``gpax_tpu/infer/svi.py``).

Guides:

  * AutoDelta          — MAP point estimates (delta posteriors) in constrained space.
  * AutoNormal         — per-site mean-field normal in unconstrained space.
  * AutoDiagonalNormal — joint diagonal normal over the flattened unconstrained vector.

The JAX package compiles the whole fit as one ``lax.scan``. Here
:meth:`SVI.run` is a Python loop over steps on the data's device: each step
evaluates the negative ELBO, differentiates it by autograd and takes one
Adam step. The losses stay on the device until the run ends, so a step reads
nothing back to the host.

Given a list of B generators, :meth:`SVI.run` fits B models at once, where
the JAX package vmaps the whole fit: every guide and param site gets a
leading dim of B, each model's initial values come from its own generator,
the model is evaluated once on the batched values (the model must broadcast
over that dim: viDKL's network, gram and MVN do), and the step
backpropagates the sum of the B negative ELBOs. Adam is elementwise, so each
model takes exactly the steps its own fit would.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..distributions import Normal, biject_to
from ..distributions.distributions import _randn
from ..ppl import get_latent_structure, log_density, seed, trace
from ..ppl.core import sum_batched
from ..ppl.util import constrain, transform_log_det, unconstrain
from ..utils.utils import resolve_device, spawn, tree_map


class AutoGuide:
    """Base: a guide is three functions over a flat dict of parameters:
    ``init_params(key) -> params``, ``sample_and_log_prob(params, key) ->
    (latents, log q)`` and ``median(params) -> constrained latents``.

    ``batch_shape`` is () for one model, or (B,) while :class:`SVI` fits B
    models at once: the parameters then lead with it, ``rng_key`` is a list
    of B generators (model b's draws come from the b-th) and log q has
    that shape."""

    def __init__(self, model):
        self.model = model
        self._transforms = None
        self._site_shapes = None
        self.prototype_initialized = False
        self.batch_shape = ()

    def _init_unconstrained(self, rng_key, model_args=(), model_kwargs=None
                            ) -> Dict[str, torch.Tensor]:
        """One prior draw of every latent site, unconstrained; the first call
        also records the sites' transforms and shapes."""
        values, supports = get_latent_structure(self.model, rng_key, model_args,
                                                model_kwargs)
        if not self.prototype_initialized:
            self._transforms = {n: biject_to(s) for n, s in supports.items()}
            self._site_shapes = {n: v.shape for n, v in values.items()}
            self.prototype_initialized = True
        return unconstrain(self._transforms, values)

    def init_params(self, rng_key, model_args=(), model_kwargs=None) -> Dict:
        raise NotImplementedError

    def sample_and_log_prob(self, params: Dict, rng_key) -> Tuple[Dict, torch.Tensor]:
        """Returns (constrained latents, log q(z)), the Jacobian included, so
        that the ELBO = E_q[log p(x, constrain(u)) + logdet] − E_q[log q(u)]
        is right in unconstrained space."""
        raise NotImplementedError

    def median(self, params: Dict) -> Dict:
        raise NotImplementedError

    # numpyro-compat alias
    def get_posterior_median(self, params):
        return self.median(params)


class AutoDelta(AutoGuide):
    """MAP estimation: q(z) = delta(z − theta). The ELBO reduces to log p(x, theta)."""

    def init_params(self, rng_key, model_args=(), model_kwargs=None):
        u = self._init_unconstrained(rng_key, model_args, model_kwargs)
        return {f"{n}_loc": v for n, v in u.items()}

    def sample_and_log_prob(self, params, rng_key):
        u = {n: params[f"{n}_loc"] for n in self._transforms}
        # MAP in constrained space (numpyro's AutoDelta): the delta guide's
        # log q cancels the model-side change of variables, so the objective
        # is log p(x, z) with no Jacobian term
        log_q = torch.zeros(self.batch_shape, device=next(iter(u.values())).device)
        return constrain(self._transforms, u), log_q

    def median(self, params):
        u = {n: params[f"{n}_loc"] for n in self._transforms}
        return constrain(self._transforms, u)


class AutoNormal(AutoGuide):
    """Mean-field normal per site, in unconstrained space."""

    def __init__(self, model, init_scale: float = 0.1):
        super().__init__(model)
        self.init_scale = init_scale

    def init_params(self, rng_key, model_args=(), model_kwargs=None):
        params = {}
        for n, v in self._init_unconstrained(rng_key, model_args, model_kwargs).items():
            params[f"{n}_loc"] = v
            params[f"{n}_scale_log"] = torch.full_like(v, math.log(self.init_scale))
        return params

    def sample_and_log_prob(self, params, rng_key):
        eps = {n: _draw(rng_key, params[f"{n}_loc"], self.batch_shape)
               for n in self._transforms}
        return self.from_eps(params, eps)

    def from_eps(self, params, eps: Dict[str, torch.Tensor]):
        """``sample_and_log_prob`` given the standard normal draws ε of each
        site, u = loc + scale·ε."""
        z, log_q = {}, 0.0
        for n, t in self._transforms.items():
            q = Normal(params[f"{n}_loc"], torch.exp(params[f"{n}_scale_log"]))
            u = q.loc + q.scale * eps[n]
            v = t(u)
            log_q = log_q + sum_batched(q.log_prob(u) - t.log_abs_det_jacobian(u, v),
                                        self.batch_shape, n)
            z[n] = v
        return z, log_q

    def median(self, params):
        u = {n: params[f"{n}_loc"] for n in self._transforms}
        return constrain(self._transforms, u)


class AutoDiagonalNormal(AutoGuide):
    """Joint diagonal normal over the flattened unconstrained latent vector.
    The sites are flattened in sorted name order, as ``ravel_pytree`` does
    for the JAX package's dict."""

    def __init__(self, model, init_scale: float = 0.1):
        super().__init__(model)
        self.init_scale = init_scale

    def _unravel(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, i = {}, 0
        for n in sorted(self._site_shapes):
            shape = self._site_shapes[n]
            size = shape.numel()
            out[n] = flat[..., i:i + size].reshape(flat.shape[:-1] + shape)
            i += size
        return out

    def init_params(self, rng_key, model_args=(), model_kwargs=None):
        u = self._init_unconstrained(rng_key, model_args, model_kwargs)
        flat = torch.cat([u[n].reshape(-1) for n in sorted(u)])
        return {"auto_loc": flat,
                "auto_scale_log": torch.full_like(flat, math.log(self.init_scale))}

    def sample_and_log_prob(self, params, rng_key):
        return self.from_eps(params, _draw(rng_key, params["auto_loc"], self.batch_shape))

    def from_eps(self, params, eps: torch.Tensor):
        """``sample_and_log_prob`` given the standard normal draws ε of the
        flat vector, u = loc + scale·ε."""
        q = Normal(params["auto_loc"], torch.exp(params["auto_scale_log"]))
        uf = q.loc + q.scale * eps
        u = self._unravel(uf)
        z = constrain(self._transforms, u)
        return z, (sum_batched(q.log_prob(uf), self.batch_shape)
                   - transform_log_det(self._transforms, u, z, self.batch_shape))

    def median(self, params):
        return constrain(self._transforms, self._unravel(params["auto_loc"]))


def _draw(rng_key, like: torch.Tensor, batch_shape) -> torch.Tensor:
    """Standard normal draws of ``like``'s shape: from ``rng_key``, or for a
    batch of models, model b's slice from the b-th generator of the list."""
    if not batch_shape:
        return _randn(rng_key, like.shape, like)
    return torch.stack([_randn(k, like.shape[1:], like) for k in rng_key])


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


class Adam:
    """Adam with ``optax.adam``'s update: m ← b1·m + (1−b1)·g,
    v ← b2·v + (1−b2)·g², p ← p − lr·m̂/(√v̂ + eps), m̂ and v̂ bias-corrected.
    ``torch.optim.Adam`` computes the same update; calling this object
    builds one over the given parameters."""

    def __init__(self, step_size: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.step_size, self.b1, self.b2, self.eps = step_size, b1, b2, eps

    def __call__(self, params) -> torch.optim.Optimizer:
        return torch.optim.Adam(params, lr=self.step_size, betas=(self.b1, self.b2),
                                eps=self.eps)


class SVIState(NamedTuple):
    params: Dict
    opt_state: object
    rng_key: torch.Generator


class SVIRunResult(NamedTuple):
    params: Dict
    state: SVIState
    losses: torch.Tensor


class Trace_ELBO:
    """Pathwise ELBO estimator, averaged over ``num_particles`` draws."""

    def __init__(self, num_particles: int = 1):
        self.num_particles = num_particles


def _data_device(model_args, model_kwargs, device=None) -> torch.device:
    """The device of the first tensor among the model's arguments; for a
    model without tensor arguments, ``device`` (None: the CUDA card, see
    ``utils.resolve_device``)."""
    for a in (*model_args, *model_kwargs.values()):
        if torch.is_tensor(a):
            return a.device
    return resolve_device(device)


class SVI:
    """``SVI(model, guide, optim, loss)``; ``optim`` is an :class:`Adam`, a
    learning rate (Adam with the defaults) or a callable that builds a
    ``torch.optim.Optimizer`` over a list of parameters. ``device`` is where
    a model without tensor arguments runs (None: the CUDA card)."""

    def __init__(self, model, guide: AutoGuide,
                 optim: Union[Adam, float, Callable], loss: Optional[Trace_ELBO] = None,
                 device=None):
        self.model = model
        self.device = device
        self.guide = guide
        if isinstance(optim, (int, float)):
            optim = Adam(optim)
        self.optim = optim
        self.loss = loss or Trace_ELBO()

    def _neg_elbo(self, guide_params, model_params, rng_key, model_args, model_kwargs):
        latents, log_q = self.guide.sample_and_log_prob(guide_params, rng_key)
        log_p, _ = log_density(self.model, model_args, model_kwargs,
                               {**latents, **model_params}, self.guide.batch_shape)
        return -(log_p - log_q)

    def _collect_model_params(self, rng_key, model_args, model_kwargs):
        """The model's ``param`` sites (e.g. the sparse GP's inducing inputs
        Xu, ``sparse_gp.py:48``, or an MLE network's parameter tree),
        optimized jointly with the guide's."""
        tr = trace(seed(self.model, rng_key)).get_trace(*model_args, **model_kwargs)
        return {n: s["init_value"] for n, s in tr.items() if s["type"] == "param"}

    def run(self, rng_key: Union[torch.Generator, int, Sequence], num_steps: int,
            *model_args, progress_bar: bool = False, **model_kwargs) -> SVIRunResult:
        """``num_steps`` Adam steps on the negative ELBO, on the device of the
        model's tensor arguments (the constructor's ``device`` for a model
        without any). ``rng_key`` is a CPU generator or a seed;
        the guide's initial draw and the steps' draws come from generators
        spawned from it on that device. Returns the final parameters (guide
        and model params in one dict), the state and the per-step losses.

        A list of B keys fits B models at once (see the module docstring):
        the parameters lead with B, and the losses are (B, num_steps)."""
        device = _data_device(model_args, model_kwargs, self.device)
        batched = isinstance(rng_key, (list, tuple))
        keys = list(rng_key) if batched else [rng_key]
        k_init = [spawn(k, device) for k in keys]
        k_steps = [spawn(k, device) for k in keys]
        batch = (len(keys),) if batched else ()
        self.guide.batch_shape = ()
        inits = [self.guide.init_params(k, model_args, model_kwargs) for k in k_init]
        guide_params = {n: torch.stack([p[n] for p in inits]) if batched else inits[0][n]
                        for n in inits[0]}
        model_params = tree_map(lambda v: torch.as_tensor(v, device=device).expand(
            batch + tuple(torch.as_tensor(v).shape)),
            self._collect_model_params(k_init[0], model_args, model_kwargs))
        self.guide.batch_shape = batch
        params = {"guide": tree_map(lambda v: v.detach().clone().requires_grad_(True),
                                     guide_params),
                  "model": tree_map(lambda v: v.detach().clone().requires_grad_(True),
                                     model_params)}
        opt = self.optim(_tree_leaves(params))
        step_key = k_steps if batched else k_steps[0]
        n_particles = self.loss.num_particles
        losses = torch.empty(batch + (num_steps,), device=device)
        for i in range(num_steps):
            opt.zero_grad(set_to_none=True)
            loss = sum(self._neg_elbo(params["guide"], params["model"], step_key,
                                      model_args, model_kwargs)
                       for _ in range(n_particles)) / n_particles
            loss.sum().backward()
            opt.step()
            losses[..., i] = loss.detach()
        final = tree_map(lambda v: v.detach(), params)
        state = SVIState(final, opt.state_dict(), step_key)
        return SVIRunResult(self.get_params(state), state, losses)

    def get_params(self, state: SVIState) -> Dict:
        return {**state.params["guide"], **state.params["model"]}
