"""Multi-task and coregionalization kernels (counterpart of
``gpax_tpu/kernels/mtkernels.py``).

``index_kernel`` gathers the task covariance B = W·Wᵀ + diag(v) at index
pairs. ``MultitaskKernel`` (the task index in the last input column) is the
data kernel times the gathered B, elementwise, with the per-task noise on the
diagonal; ``MultivariateKernel`` (tasks sharing the inputs) is the Kronecker
product of the data kernel and B, with the noise on the block diagonal;
``LCMKernel`` sums such kernels over latent GPs.

The data kernel is called with noise 0, so for same-shaped inputs it still
puts the jitter on its diagonal; the product scales that by B's diagonal, and
``noise[task] + jitter`` is added on top, as in the JAX package. The LCM sums
over the latent axis, the last batch dim of every parameter but ``noise``
(the JAX package vmaps over it): all latents' data grams come from ONE call
of the data kernel (one K1 launch for RBF/Matérn), the latent axis being the
gram's batch dim, and the noise, shared, lands on the diagonal once per
latent, as the vmapped sum puts it there. Parameters may carry leading batch
dims of posterior draws before the latent axis, and the inputs leading batch
dims of their own (a fantasy training set per candidate); the two broadcast
against each other, right-aligned.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..config import get_config
from .kernels import get_kernel

kernel_fn_type = Callable[..., torch.Tensor]


def get_in_axes(data: Dict) -> tuple:
    """``in_dims`` of ``torch.func.vmap`` over the LCM's latent axis
    (``mtkernels.py:27-30``): every parameter maps over its leading axis
    but the shared noise. The port's LCM sums over the latent batch dim
    without a vmap; this is for user code that maps a kernel itself."""
    return ({key: (0 if key != "noise" else None) for key in data.keys()},)


def _one_hot(idx: torch.Tensor, num_tasks: int, like: torch.Tensor) -> torch.Tensor:
    """(…, n, num_tasks) rows selecting each point's task, in ``like``'s
    dtype and device: gathers become products that sum one term and zeros,
    exact forward, and whose backward is a matmul rather than a scatter of
    atomic adds, so a fit's gradients are the same from run to run on the
    card."""
    return torch.nn.functional.one_hot(idx.to(like.device), num_tasks).to(like.dtype)


def _plus_diag(K: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K + diag(d), d broadcast against K's diagonal (…, n)."""
    return K + torch.diag_embed(d.expand(torch.broadcast_shapes(d.shape, K.shape[:-1])))


def _jitter(kwargs) -> float:
    jitter = kwargs.get("jitter")
    return get_config().default_jitter if jitter is None else jitter


def _task_index(X: torch.Tensor) -> torch.Tensor:
    return X[..., -1].long()


def index_kernel(indices1: torch.Tensor, indices2: torch.Tensor,
                 params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """B[i, j] at index pairs, with B = W·Wᵀ + diag(v) in full float32.

    params: 'W' (…, num_tasks, rank), 'v' (…, num_tasks); indices1 (…, n)
    and indices2 (…, m) integer tensors. Returns (…, n, m)."""
    W, v = params["W"], params["v"]
    B = W @ W.mT + torch.diag_embed(v)
    T = B.shape[-1]
    return _one_hot(indices1, T, B) @ B @ _one_hot(indices2, T, B).mT


def MultitaskKernel(base_kernel, **kwargs1) -> kernel_fn_type:
    """ICM kernel for tasks observed at different inputs: the task index is
    the last column of X and Z, K = k_data(x, z) ⊙ B[i, j], and the per-task
    noise vector (…, num_tasks), or one noise, lands on the diagonal."""
    data_kernel = get_kernel(base_kernel, **kwargs1)

    def multi_task_kernel(X, Z, params, noise=0, **kwargs2):
        X_data, idx_X = X[..., :-1], _task_index(X)
        Z_data = X_data if Z is X else Z[..., :-1]
        k_data = data_kernel(X_data, Z_data, params, 0, **kwargs2)
        K = k_data * index_kernel(idx_X, _task_index(Z), params)
        if X.shape == Z.shape:
            nz = torch.as_tensor(noise, dtype=K.dtype, device=K.device)
            if nz.ndim and nz.shape[-1] > 1:  # each point's task noise
                nz = (_one_hot(idx_X, nz.shape[-1], K) * nz[..., None, :]).sum(-1)
            elif nz.ndim:
                nz = nz[..., :1]
            K = _plus_diag(K, nz + _jitter(kwargs2))
        return K

    return multi_task_kernel


def MultivariateKernel(base_kernel, num_tasks: int, **kwargs1) -> kernel_fn_type:
    """Multi-output kernel for tasks sharing the inputs: K = kron(k_data, B)
    (row i·num_tasks + t for point i and task t), with the per-task noise on
    the block diagonal."""
    data_kernel = get_kernel(base_kernel, **kwargs1)
    labels = torch.arange(num_tasks)

    def multivariate_kernel(X, Z, params, noise=0, **kwargs2):
        k_data = data_kernel(X, Z, params, 0, **kwargs2)
        B = index_kernel(labels, labels, params)
        n, m = k_data.shape[-2:]
        K = k_data[..., :, None, :, None] * B[..., None, :, None, :]
        K = K.reshape(K.shape[:-4] + (n * num_tasks, m * num_tasks))
        if X.shape == Z.shape:
            nz = torch.as_tensor(noise, dtype=K.dtype, device=K.device)
            nz = nz[..., None] if nz.ndim == 0 else nz
            nz = nz.expand(nz.shape[:-1] + (num_tasks,)) + _jitter(kwargs2)
            diag = nz[..., None, :].expand(nz.shape[:-1] + (n, num_tasks))
            K = _plus_diag(K, diag.reshape(diag.shape[:-2] + (n * num_tasks,)))
        return K

    return multivariate_kernel


def LCMKernel(base_kernel, shared_input_space: bool = True, num_tasks: int = None,
              **kwargs1) -> kernel_fn_type:
    """Linear model of coregionalization: the sum over ``num_latents`` ICM
    kernels, the latent axis being the last batch dim of every parameter but
    ``noise`` (k_length (…, L, d), k_scale (…, L), W (…, L, T, R), v (…, L, T))."""
    if shared_input_space:
        multi_kernel = MultivariateKernel(base_kernel, num_tasks, **kwargs1)
    else:
        multi_kernel = MultitaskKernel(base_kernel, **kwargs1)

    def lcm_kernel(X, Z, params, noise=0, **kwargs2):
        params = dict(params)
        ls = torch.as_tensor(params["k_length"])
        if ls.ndim == torch.as_tensor(params["k_scale"]).ndim:
            params["k_length"] = ls[..., None]  # the model squeezed out d = 1
        Xl = X.unsqueeze(-3)  # a latent axis the parameters' one broadcasts into
        Zl = Xl if Z is X else Z.unsqueeze(-3)
        nz = torch.as_tensor(noise)
        nz = nz.unsqueeze(-2) if nz.ndim else nz  # shared by the latents
        return multi_kernel(Xl, Zl, params, nz, **kwargs2).sum(-3)

    return lcm_kernel
