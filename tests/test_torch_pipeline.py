"""The port's serial coarse-to-fine pipeline against the JAX package's.

``run_pipeline`` on the CPU (the exact path: ``fast_ncc`` and ``rect_ncc``
"auto" are off off the card) on the 96x64 4-view golden ring written in the
on-disk layout, with ``size_bound=64``, so two scales run (48x32, then
96x64 after JBU with hierarchy passes), each with the planar-prior round
and two geometric passes.  Held against tests/fixtures/golden_pipeline_
stats.json, made by the JAX package's ``run_pipeline`` (serial, the exact
path) on the same scene:

* every view's final depths_geom.dmb: region statistics (quadrant means and
  medians, 10th and 90th percentiles) within drift_gate's 2e-2 (8+ passes
  and two scales compound the ulp-level accept flips of each half-step,
  ROADMAP Queue 3 item 2);
* the fused cloud: point count within 2%, accuracy (fraction within 0.08 of
  the cube surface) within 0.01.

Regenerate the fixture from the JAX package (CPU, about 2.5 minutes):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_pipeline.py --regen
"""

import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.config import PipelineConfig  # noqa: E402
from acmmp_spherical_torch.io import read_depth_dmb, read_ply  # noqa: E402
from acmmp_spherical_torch.io.scene import ScenePaths  # noqa: E402
from acmmp_spherical_torch.pipeline.multiscale import run_pipeline  # noqa: E402
from acmmp_spherical_torch.utils.metrics import cube_surface_distance  # noqa: E402
from acmmp_spherical_torch.utils.synthetic import (  # noqa: E402
    CubeRoom, make_ring_of_cameras, render_scene,
    write_synthetic_scene_to_disk,
)

FIXTURE = (pathlib.Path(__file__).parent / "fixtures"
           / "golden_pipeline_stats.json")
W, H, N_VIEWS, FOCAL, SIZE_BOUND = 96, 64, 4, 80.0, 64
TAU = 0.08                 # 1% of the 8-unit room
STAT_TOL = 2e-2            # scripts/drift_gate.py
COUNT_RTOL = 0.02
ACCURACY_TOL = 0.01


def write_scene(root):
    cams = make_ring_of_cameras(N_VIEWS, width=W, height=H, focal=FOCAL,
                                device="cpu")
    write_synthetic_scene_to_disk(root, cams,
                                  render_scene(cams, CubeRoom(), W, H)[0])


def depth_stats(d: np.ndarray) -> dict:
    out = {}
    h, w = d.shape
    for qi, sl in enumerate([np.s_[: h // 2, : w // 2], np.s_[: h // 2, w // 2:],
                             np.s_[h // 2:, : w // 2], np.s_[h // 2:, w // 2:]]):
        out[f"depth_mean_q{qi}"] = float(np.mean(d[sl]))
        out[f"depth_median_q{qi}"] = float(np.median(d[sl]))
    out["depth_p10"] = float(np.percentile(d, 10))
    out["depth_p90"] = float(np.percentile(d, 90))
    return out


def pipeline_stats(root, n_points: int) -> dict:
    """Per-view final-depth statistics, the fused count and accuracy."""
    sp = ScenePaths(root)
    pts = read_ply(sp.ply_file())[0]
    return {
        "views": [depth_stats(read_depth_dmb(sp.depth_file(v, geom=True)))
                  for v in range(N_VIEWS)],
        "fused_points": int(n_points),
        "accuracy": float(np.mean(cube_surface_distance(pts, CubeRoom().half)
                                  < TAU)),
    }


def test_pipeline_matches_reference_fixture(tmp_path):
    root = tmp_path / "scene"
    write_scene(root)
    n = run_pipeline(root, PipelineConfig(size_bound=SIZE_BOUND),
                     device="cpu")
    got, ref = pipeline_stats(root, n), json.loads(FIXTURE.read_text())
    manifest = json.loads(ScenePaths(root).manifest_file().read_text())
    assert sorted(manifest) == sorted(
        f"{p}_s{s}" for s, first in ((1, "photometric"), (0, "hierarchy"))
        for p in (first, "geom0", "geom1"))
    assert all(sorted(v) == list(range(N_VIEWS)) for v in manifest.values())
    for v, (g, r) in enumerate(zip(got["views"], ref["views"])):
        for k, x in r.items():
            assert abs(g[k] - x) <= max(STAT_TOL, STAT_TOL * abs(x)), (
                v, k, g[k], x)
    assert abs(got["fused_points"] - ref["fused_points"]) <= (
        COUNT_RTOL * ref["fused_points"]), (got["fused_points"],
                                            ref["fused_points"])
    assert abs(got["accuracy"] - ref["accuracy"]) <= ACCURACY_TOL, (
        got["accuracy"], ref["accuracy"])


def reference_stats(root) -> dict:
    """The JAX package's pipeline on the same scene folder, serial."""
    from acmmp_spherical_tpu.config import PipelineConfig as JConfig
    from acmmp_spherical_tpu.pipeline.multiscale import run_pipeline as jrun

    write_scene(root)
    n = jrun(root, JConfig(size_bound=SIZE_BOUND, batch_problems="off"))
    return pipeline_stats(root, n)


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import os
        import tempfile

        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
        with tempfile.TemporaryDirectory() as tmp:
            FIXTURE.write_text(json.dumps(
                reference_stats(pathlib.Path(tmp) / "scene"), indent=1))
        print(f"wrote {FIXTURE}")
