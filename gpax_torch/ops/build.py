"""Build the port's hand-written CUDA kernels and bind them with ctypes.

The JAX package has no counterpart: its Pallas kernels compile inside XLA.
Here the sources in ``gpax_torch/csrc`` are compiled by ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, at first use, into
``build/gpax_torch_kernels/`` beside the package. That takes seconds, where
``torch.utils.cpp_extension.load`` (which compiles PyTorch's headers) takes
minutes. The library's name carries a hash of the sources, the headers they
include and the flags, so an edited source is never served by a stale
library.

Nothing here runs at import: the CPU has no ``nvcc``, and the wrappers only
call :func:`library` for a CUDA tensor. There is no fallback: a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "gpax_torch_kernels"
SOURCES = ("gram.cu", "trtri.cu", "cholinv.cu", "panel_chol.cu")
# the blocked 128-tile routine of K2, K3, K4's diagonal step and K5's
# diagonal inverses
HEADERS = ("tile_chol_blocked.cuh",)
# no --use_fast_math: K1's expf/sqrtf must be the accurate ones
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output (ptxas register/shared-memory report)
build_seconds = None    # wall time of the build (or the load of a cached one)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: gpax_torch builds its CUDA kernels from "
            "gpax_torch/csrc at first use and needs the CUDA toolkit")
    return path


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in (lib.gpax_gram_f32, lib.gpax_gram_f32c, lib.gpax_gram_f64):
        entry.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        entry.restype = i
    for entry in (lib.gpax_tile_tri_inv_f32, lib.gpax_tile_tri_inv_f64):
        entry.argtypes = [p, p, i, i, p]
        entry.restype = i
    for entry in (lib.gpax_tile_chol_inv_f32, lib.gpax_tile_chol_inv_f64):
        entry.argtypes = [p, p, p, i, p]
        entry.restype = i
    lib.gpax_panel_grid.argtypes = [i, i, ctypes.POINTER(i)]
    lib.gpax_panel_grid.restype = i
    for entry in (lib.gpax_panel_cholesky_f32, lib.gpax_panel_cholesky_f64,
                  lib.gpax_panel_tri_inv_t_f32, lib.gpax_panel_tri_inv_t_f64):
        entry.argtypes = [p, p, p, p, i, i, i, p, p]  # ..., stream, phase_ns
        entry.restype = i


def _run(procs) -> str:
    """Wait for nvcc processes; raise with their output if any failed."""
    log = ""
    failed = False
    for proc in procs:
        out, _ = proc.communicate()
        log += out
        failed |= proc.returncode != 0
    if failed:
        raise RuntimeError(f"nvcc failed:\n{log}")
    return log


def library():
    """The loaded kernel library, built on first call."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        srcs = [CSRC / s for s in SOURCES]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs + [CSRC / s for s in HEADERS]:
            h.update(s.read_bytes())
        tag = h.hexdigest()[:16]
        out = BUILD_DIR / f"libgpax_torch_kernels_{tag}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc, pid = _nvcc(), os.getpid()
            objs = [BUILD_DIR / f"{s.stem}_{tag}.{pid}.o" for s in srcs]
            build_log = _run([
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(srcs, objs)])
            tmp = out.with_name(f"{out.name}.{pid}.tmp")
            build_log += _run([subprocess.Popen(
                [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)])
            for o in objs:
                o.unlink()
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
