"""BENCHMARK.json against the rules of its format, its pieces found by
name, a new configuration, mix and metric found as new files alone, and the
operation and byte counts of the per-layer metrics at small shapes."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench.harness import hw, spec

from .conftest import run_in_process

BENCH = json.loads((spec.HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")
E2E = ("setup_s", "leapfrogs_per_s", "score_points_per_s")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.fullmatch(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert LINE.fullmatch(text), text
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])


def test_metrics_and_cells_by_name():
    assert [m["name"] for m in BENCH["end_to_end"]] == list(E2E)
    assert [w["name"] for w in BENCH["workloads"]] == ["gp4096.fit", "gp4096.score"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e_cells = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= e2e_cells[m["moves"]], m["name"]
    for c in cells:
        assert "setup_s" in {m for m, ws in e2e_cells.items() if c in ws}
        assert any(c in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_pieces(cell):
    c = spec.load_cell(cell)
    assert spec.module("drivers", c.traffic["driver"]).run
    assert spec.module("families", c.config["family"])
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert c.limits, f"{cell} has no limits file"
    cfg_entry = next(e for e in BENCH["configs"] if e["name"] == c.config["name"])
    assert cfg_entry["reduced"] == c.config["reduced"]
    assert (spec.HERE.parent / cfg_entry["file"]).exists()


def test_new_config_mix_and_metric_are_found_as_new_files(tmp_path):
    """A copy of the benchmark's data with one more configuration, mix,
    metric and cell, each a new file or entry: the harness runs the new cell
    and reports the new metric, with no file that was there edited."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((root / "configs" / "exactgp-rbf-n4096.json").read_text())
    cfg.update(n=48, kernel_name="Matern", kernel="matern52")
    (root / "configs" / "exactgp-matern-n48.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "nuts_fit.json").read_text())
    mix.update(check_draws=4, segment_size=2)
    (root / "traffic" / "nuts_fit_small.json").write_text(json.dumps(mix))
    (root / "metrics" / "draws_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['counters']['transitions'])\n")
    (root / "limits" / "gp48.fit.json").write_text(
        (root / "limits" / "gp4096.fit.json").read_text())
    bench["configs"].append({"name": "exactgp-matern-n48", "source": "https://example.org",
                             "file": "portbench/configs/exactgp-matern-n48.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "gp48.fit", "config": "exactgp-matern-n48",
                               "traffic": "nuts_fit_small", "chips": 1, "why": "test"})
    bench["end_to_end"][1]["workloads"].append("gp48.fit")
    bench["per_layer"].append({"name": "draws_seen", "unit": "draws", "better": "higher",
                               "source": "program_counter", "layer": "sampler",
                               "moves": "leapfrogs_per_s", "workloads": ["gp48.fit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("gp48.fit", root)
    assert cell.config["kernel"] == "matern52" and cell.traffic["check_draws"] == 4
    cell.config.update(num_warmup=6, max_tree_depth=3)
    line, judged, run = run_in_process(cell, seconds=1.0, traced=True)
    assert line["metrics"]["draws_seen"]["value"] == run.counters["transitions"] > 0
    assert set(judged) == {"potential_gap", "grad_gap", "draw_excess"}


def test_roofline_counts_by_hand():
    k1 = spec.metric_reader("k1_roofline.fit").__globals__["k1_bytes_flops"]
    # n = 2, m = 3, d = 1: read 2 + 3 coordinates and 2 noises, write 6 entries
    assert k1(2, 3, 1) == (4 * (2 + 3 + 2 + 6), 6 * 6)
    k2 = spec.metric_reader("k2_roofline.fit").__globals__["k2_bytes_flops"]
    # one 128-tile read and written in float64; 128³/3 operations
    assert k2(128) == (2 * 128 * 128 * 8, 128**3 / 3)
    assert k2(200) == (2 * 2 * 128 * 128 * 8, 2 * 128**3 / 3)
    flops = spec.metric_reader("fit_mfu").__globals__["leapfrog_flops"]
    # n³ for the factor, inverse and WᵀW; n²(5d + 10) for the rest
    assert flops(2, 1) == 8 + 4 * 15
    req = spec.metric_reader("score_mfu").__globals__["request_flops"]
    # n = 2, m = 3, d = 1, 2 draws: 16/3 + 12 + 4 + 24 + 10·6 a draw
    assert req(2, 3, 1, 2) == 2 * (16 / 3 + 12 + 4 + 24 + 60)
    assert hw.bound_s(3.35e12, 0.0) == 1.0 and hw.bound_s(0.0, 67e12, "float64") == 1.0


def test_tiny_run_loads_no_jax():
    """A tiny run of every driver in a fresh process leaves no module whose
    top-level name is jax, jaxlib, flax or gpax_tpu loaded."""
    code = (
        "import torch; torch.set_num_threads(1)\n"
        "from portbench.tests.conftest import run_in_process, tiny_cell\n"
        "from portbench.harness.result import forbidden_modules\n"
        "for c in ('gp4096.score', 'gp4096.fit'):\n"
        "    run_in_process(tiny_cell(c), seconds=0.5)\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
