"""The port's quality report (``python -m acmmp_spherical_torch.quality_report``,
the twin of ``scripts/quality_report.py``) on the CPU.

* A 32x24 3-view cube ring on the exact path (``--fast off --rect off
  --device cpu``, ~45 s): the JSON line holds the JAX script's keys, with
  the depth error, the cloud's accuracy, completeness and share on the
  surface in range.
* ``slow``: the same arguments through the JAX script (a subprocess on the
  CPU, ~75 s) against the port's report: the fused point count within 5%
  and the median relative depth error within 2x (the JAX package's run
  gave 622 points and 0.0023, the port's 603 and 0.0024).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.quality_report import main  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--size", "32", "24", "--views", "3", "--fast", "off", "--rect",
        "off"]
KEYS = {"scene", "fast_ncc", "rect_ncc", "wall_s", "n_points",
        "median_rel_err", "mean_rel_err", "frac_below_1pct",
        "frac_below_2pct", "accuracy", "completeness", "frac_on_surface"}


@pytest.fixture(scope="module")
def port_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("quality") / "report.json"
    assert main(ARGS + ["--device", "cpu", "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_quality_report_keys_and_ranges(port_report):
    r = port_report
    assert set(r) == KEYS
    assert r["scene"] == "cube_room_pinhole_32x24x3v"
    assert (r["fast_ncc"], r["rect_ncc"]) == ("off", "off")
    assert r["n_points"] > 300
    assert 0.0 < r["median_rel_err"] < 0.01
    assert r["frac_below_2pct"] > 0.9
    for k in ("accuracy", "completeness", "frac_on_surface"):
        assert 0.0 <= r[k] <= 1.0
    assert r["frac_on_surface"] > 0.8


@pytest.mark.slow
def test_quality_report_matches_jax_script(port_report):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "scripts/quality_report.py",
                          *ARGS], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(ref) == KEYS and ref["scene"] == port_report["scene"]
    assert abs(port_report["n_points"] - ref["n_points"]) <= (
        0.05 * ref["n_points"])
    ratio = port_report["median_rel_err"] / ref["median_rel_err"]
    assert 0.5 <= ratio <= 2.0, (port_report, ref)
