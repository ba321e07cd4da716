"""Run one cell of the port's benchmark on the card it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the mix names the driver that sets up,
measures for ``--seconds`` and checks the outputs against the plain
reference. The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a traced part of the window. ``--control 1``
also prints, on standard error, the readings of the control (the reference
in the next lower precision put in the program's place) on the same inputs;
the benchmark's own runs leave it off.

Without a CUDA card, or with fewer cards than the cell asks for, the run
exits with code 3 and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench_cache"


def _environment() -> None:
    """One intra-op thread (the program's work is on the card; idle CPU
    threads that spin only compete with the launching thread on a shared
    host), and every build and kernel cache at a fixed path inside the
    checkout, so only a checkout's first run builds."""
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # a build cut off mid-way may leave a lock that a later load would wait on
    (ROOT / "build" / "gpax_torch_kernels" / "lock").unlink(missing_ok=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if pathlib.Path(p or ".").resolve() != ROOT / "portbench"]
    _environment()
    import torch

    torch.set_num_threads(1)

    from portbench.harness import result, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    driver = spec.module("drivers", cell.traffic["driver"])
    seed = args.seed % (1 << 63)
    run = driver.run(cell, seed, args.seconds, bool(args.trace), "cuda", T_START,
                     bool(args.control))

    found = result.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures gpax_torch alone",
              file=sys.stderr)
        return 4
    power = _power_limit()
    print(f"card: {power}", file=sys.stderr)
    print("counters: " + json.dumps(run.counters), file=sys.stderr)
    if run.control:
        print("control readings: " + json.dumps(run.control), file=sys.stderr)

    line, judged = result.build_line(cell, run, bool(args.trace),
                                     torch.cuda.get_device_name(0))
    result.emit(line, judged)
    return 0


if __name__ == "__main__":
    sys.exit(main())
