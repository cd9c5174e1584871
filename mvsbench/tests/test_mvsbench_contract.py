"""CPU checks of the benchmark's files and command.

    python -m pytest -q -p no:cacheprovider mvsbench/tests

Names, units and limits of BENCHMARK.json, the files each cell finds by
name, the roofline count at a tiny shape, a run without CUDA failing with
no result line, and the modules a run and the reference load.
"""

from __future__ import annotations

import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "mvsbench/run.py"]
    assert BENCH["paths"] == ["mvsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for sec in ("configs", "workloads") for e in BENCH[sec]]
    names += [m["name"] for m in _metrics()]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[sec]]
        assert len(got) == len(set(got)), sec
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in _metrics():
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


def test_cells_find_their_files():
    from mvsbench import harness

    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("mvsbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert "assumed" in cfg and "guarantee" in cfg
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for trace in (False, True):
            cell = harness.find_cell(BENCH, w["name"], trace)
            assert cell.config["name"] == w["config"]
            assert cell.traffic["name"] == w["traffic"]
            assert cell.limits["limits"]
            for m in cell.metrics:
                assert callable(harness.reader(m["name"]).read)
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}


def test_roofline_counts_at_a_tiny_shape():
    from mvsbench import roofline as R

    # 4 x 6 map, 2 views, 4 taps: two rounds of one iteration = 4
    # half-steps, each scoring 9 then 5 planes at half the pixels
    got = R.launches(4, 6, rounds=2, iterations=1)
    assert got == [(12, 9), (12, 5)] * 4
    evals = sum(p * c for p, c in got) * 2
    flops = evals * 4 * R.TAP_FLOPS
    assert flops == 12 * 14 * 4 * 2 * 4 * 30
    t = R.least_seconds(4, 6, 2, 4, rounds=2, iterations=1, geom=False)
    per = [max(12 * c * 2 * 4 * 30 / R.FP32_FLOP_PER_S,
               (24 * 4 + 2 * 24 * 2 + 12 * c * 16 + 12 * c * 2 * 4)
               / R.HBM_BYTES_PER_S) for c in (9, 5)] * 4
    assert t == pytest.approx(sum(per), rel=1e-12)
    tg = R.least_seconds(4, 6, 2, 4, rounds=2, iterations=1, geom=True)
    assert tg > t


def test_run_without_cuda_fails_with_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "mvsbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def _loaded_tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_run_loads_no_jax():
    mods = ["mvsbench.run", "mvsbench.harness", "mvsbench.control",
            "mvsbench.faults"] + [
        f"mvsbench.metrics.{m['name']}" for m in _metrics()]
    code = ("import sys; sys.path.insert(0, '.')\n"
            + "\n".join(f"import {m}" for m in mods)
            + "\nimport acmmp_spherical_torch.pipeline.pass_runner")
    tops = _loaded_tops(code)
    assert not tops & {"jax", "jaxlib", "flax", "acmmp_spherical_tpu"}


def test_reference_loads_nothing_of_either_package():
    ref = sorted(p.stem for p in (ROOT / "mvsbench/reference").glob("*.py")
                 if p.stem != "__init__")
    code = ("import sys; sys.path.insert(0, '.')\n"
            + "\n".join(f"import mvsbench.reference.{m}" for m in ref))
    tops = _loaded_tops(code)
    assert not tops & {"jax", "jaxlib", "flax", "acmmp_spherical_tpu",
                       "acmmp_spherical_torch"}
    for m in ref:
        importlib.import_module(f"mvsbench.reference.{m}")
