"""General utilities (counterpart of ``gpax_tpu/utils/utils.py``): RNG
generators, the entry points' device, batching of tensors and of dicts,
the device memory budget, the count of host reads of device values,
inducing points, sparse images and a distribution's histogram."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import enable_x64  # re-exported, as gpax.utils.enable_x64
from .monitor import span

__all__ = ["enable_x64", "get_keys", "spawn", "resolve_device", "split_in_batches", "split_dict",
           "random_sample_dict", "dviz", "device_memory_budget", "host_bool", "host_syncs", "reset_host_syncs",
           "initialize_inducing_points", "preprocess_sparse_image", "get_haiku_dict",
           "tree_map"]

_MAX_SEED = 2**62

_host_reads = [0]


def get_keys(seed: int = 0):
    """Two independent generators (fit, predict) from one integer seed
    (``utils.py:32-34``). They live on the CPU; the samplers derive their own
    generators on the data's device from them with :func:`spawn`."""
    root = torch.Generator().manual_seed(seed)
    return spawn(root), spawn(root)


def spawn(key: Union[torch.Generator, int],
          device: Optional[torch.device] = None) -> torch.Generator:
    """A new generator on ``device`` (default CPU), seeded from ``key`` — the
    port's ``jax.random.split``. ``key`` is a CPU generator (advanced by one
    draw) or an integer seed."""
    if isinstance(key, int):
        key = torch.Generator().manual_seed(key)
    if key.device.type != "cpu":
        raise ValueError("spawn: derive generators from a CPU generator "
                         "(reading a device generator's draw would sync)")
    s = int(torch.randint(_MAX_SEED, (), generator=key))
    return torch.Generator(device=device or "cpu").manual_seed(s)


def resolve_device(device=None) -> torch.device:
    """The device of a model entry point: ``None`` means the CUDA card (its
    current index), anything else is taken as given. Without a CUDA device,
    ``None`` raises: the CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gpax_torch runs on the CUDA card by default and none is available; "
                'pass device="cpu" to run on the CPU')
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def split_in_batches(X_new: torch.Tensor, batch_size: int = 100, dim: int = 0) -> List:
    """Chunk a tensor along dim 0 or 1 (trailing remainder kept as a short
    chunk)."""
    if dim not in (0, 1):
        raise NotImplementedError("'dim' must be 0 or 1")
    return list(torch.split(X_new, batch_size, dim=dim))


def split_dict(data: Dict[str, torch.Tensor], chunk_size: int) -> List[Dict[str, torch.Tensor]]:
    """Split a dict of equal-length tensors (or arrays) into chunks along the
    leading dim (``utils.py:49-55``)."""
    n = len(next(iter(data.values())))
    return [{k: v[start:min(start + chunk_size, n)] for k, v in data.items()}
            for start in range(0, n, chunk_size)]


def random_sample_dict(data: Dict[str, torch.Tensor], num_samples: int,
                       rng_key: Union[torch.Generator, int]) -> Dict[str, torch.Tensor]:
    """The same random rows of every tensor in the dict (``utils.py:58-63``):
    the first ``num_samples`` of ``torch.randperm`` on the data's device,
    drawn with a generator there spawned from ``rng_key`` (a generator or an
    integer seed) unless ``rng_key`` already lives there."""
    first = next(iter(data.values()))
    n = len(first)
    device = first.device if torch.is_tensor(first) else torch.device("cpu")
    if isinstance(rng_key, int) or rng_key.device != device:
        rng_key = spawn(rng_key, device)
    idx = torch.randperm(n, generator=rng_key, device=device)[:num_samples]
    return {k: v[idx if torch.is_tensor(v) else idx.numpy()] for k, v in data.items()}


def dviz(d, samples: int = 1000) -> None:
    """Histogram of ``samples`` draws of the distribution ``d`` (seed 0), with
    a KDE where seaborn is installed (``utils.py:84-95``); matplotlib and
    seaborn are imported only here."""
    import matplotlib.pyplot as plt

    draws = d.sample(torch.Generator().manual_seed(0), (samples,)).detach().cpu().numpy()
    plt.figure(dpi=100)
    try:
        import seaborn as sns

        sns.histplot(draws, kde=True, fill=False)
    except ImportError:
        plt.hist(draws, bins=50, histtype="step")
    plt.show()


def device_memory_budget(device: Optional[torch.device] = None,
                         fraction: float = 0.4, default: int = 1 << 31) -> int:
    """Usable scratch budget in bytes for chunked computations: ``fraction``
    of the free memory that ``torch.cuda.mem_get_info`` reports on a CUDA
    device (at least 64 MiB), ``default`` (2 GiB) on the CPU."""
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(int(fraction * free), 64 << 20)
    return default


def host_read(site: str):
    """Count one blocking read of device values by the host
    (:func:`host_syncs`) and return the span that covers it,
    ``gpax.host_read.<site>`` (``monitor.span``): ``with host_read("nuts_segment"):
    ...``. The site names the place in the program that waits."""
    _host_reads[0] += 1
    return span("gpax.host_read." + site)


def host_bool(flag: torch.Tensor, site: str) -> bool:
    """Read a device flag on the host. On a CUDA tensor this waits for the
    device to produce it and stalls the launch queue, so every read is
    counted (:func:`host_syncs`) and spanned at its ``site``
    (:func:`host_read`)."""
    with host_read(site):
        return bool(flag)


def host_syncs() -> int:
    """Host reads of device flags since the last :func:`reset_host_syncs`."""
    return _host_reads[0]


def reset_host_syncs() -> None:
    _host_reads[0] = 0


def initialize_inducing_points(X: torch.Tensor, ratio: float = 0.1, method: str = "uniform",
                               key: Optional[Union[torch.Generator, int]] = None
                               ) -> torch.Tensor:
    """Inducing points for sparse GPs (``utils.py:112-134``): ``"uniform"``
    index spacing, a ``"random"`` subsample without replacement drawn with
    ``key`` (a generator or an integer seed), or ``"kmeans"`` centres
    (scikit-learn, imported only then). m = int(n·ratio) points, on X's
    device.

    ``"uniform"`` takes the indices floor((n−1)·i/(m−1)) in float32 with the
    last one n−1, the formula of ``jnp.linspace(0, n−1, m, dtype=int32)``.
    (XLA on the CPU may round the division differently and then pick a
    neighbouring index at rare sizes.)"""
    if not 0 < ratio < 1:
        raise ValueError("The 'ratio' value must be between 0 and 1")
    n = X.shape[0]
    m = int(n * ratio)
    if method == "uniform":
        if m < 2:
            return X[:m]
        step = torch.arange(m - 1, dtype=torch.float32) / (m - 1)
        idx = torch.cat([torch.floor((n - 1) * step).long(), torch.tensor([n - 1])])
        return X[idx.to(X.device)]
    if method == "random":
        if key is None:
            raise ValueError("A random generator (key) must be provided for random selection")
        if isinstance(key, int) or key.device != X.device:
            key = spawn(key, X.device)
        return X[torch.randperm(n, generator=key, device=X.device)[:m]]
    if method == "kmeans":
        try:
            from sklearn.cluster import KMeans
        except ImportError as e:
            raise ImportError("scikit-learn is required for method='kmeans'") from e
        centers = KMeans(n_clusters=m, random_state=0, n_init="auto").fit(X.cpu().numpy())
        return torch.as_tensor(centers.cluster_centers_, dtype=X.dtype, device=X.device)
    raise ValueError("Method must be 'uniform', 'random', or 'kmeans'")


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a nested dict (a network's parameters, or a
    param site that holds them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def get_haiku_dict(kernel_params: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """Regroup the flat 'feature_extractor/<module>/<param>' SVI parameters
    into the nested ``{module: {param: ...}}`` tree that ``Module.apply``
    takes (``utils.py:66-80``), nesting by every remaining part of the path;
    other entries are dropped."""
    out: Dict[str, Dict] = {}
    for key, val in kernel_params.items():
        if key.startswith("feature_extractor/"):
            parts = key.split("/")[1:]
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
    return out


def preprocess_sparse_image(sparse_image: np.ndarray):
    """A sparse image (zeros = missing pixels) as GP training data
    (``utils.py:98-109``): (coords (N, D), values (N,), full grid
    (N_full, D)), numpy arrays of the image's dtype."""
    dtype = sparse_image.dtype
    nz = np.nonzero(sparse_image)
    gp_input = np.column_stack(nz)
    targets = sparse_image[nz]
    full_indices = np.array(
        np.meshgrid(*[np.arange(dim) for dim in sparse_image.shape])
    ).T.reshape(-1, sparse_image.ndim)
    return gp_input.astype(dtype), targets.astype(dtype), full_indices.astype(dtype)
