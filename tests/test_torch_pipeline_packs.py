"""The port's rectified pipeline with both bf16 packs on (``rect_tap_pack``
and ``rect_backmap_pack``, the defaults of both packages) against the JAX
package's.

``run_pipeline`` on the CPU, serial, with ``rect_ncc="on"`` (the rectified
path on its plain versions, which the card's kernels equal bit for bit) on
the 32x24 3-view ring of tests/test_torch_batch_runner.py: one scale, the
photometric pass with its planar-prior round, then two geometric passes,
one PatchMatch iteration in the photometric pass.  Held against
tests/fixtures/golden_packed_pipeline_stats.json, made by the JAX package's
serial ``run_pipeline`` on the same scene with the same configuration
(Pallas interpreted):

* every view's final depths_geom.dmb: region statistics within drift_gate's
  2e-2, and its median relative depth error against ground truth below
  0.02 (tests/test_batch_runner.py) and within ``ERR_TOL`` of the JAX
  package's;
* more than 90% of the fused points within 0.08 of the cube surface.

The fixture also keeps the JAX package's per-view errors of the same run
with both packs off (``median_rel_err_packs_off``): how far the packs move
the reference's own pipeline at this size.

Regenerate the fixture from the JAX package (CPU, Pallas interpreted, about
twenty minutes):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_pipeline_packs.py --regen
"""

import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.io import read_depth_dmb  # noqa: E402
from acmmp_spherical_torch.io.scene import ScenePaths  # noqa: E402
from acmmp_spherical_torch.pipeline import multiscale  # noqa: E402
from acmmp_spherical_torch.utils.metrics import depth_error_stats  # noqa: E402

from test_torch_batch_runner import (  # noqa: E402
    DEPTH_ERR_MAX, N_VIEWS, ON_SURFACE_MIN, STAT_TOL, pipeline_cfg,
    pipeline_stats, write_scene,
)

FIXTURE = (pathlib.Path(__file__).parent / "fixtures"
           / "golden_packed_pipeline_stats.json")
ERR_TOL = 1e-3             # per-view median relative error, port - JAX


def packed_stats(root, n_points: int, gt) -> dict:
    """``pipeline_stats`` and each view's median relative depth error."""
    sp = ScenePaths(root)
    out = pipeline_stats(root, n_points)
    out["median_rel_err"] = [
        depth_error_stats(read_depth_dmb(sp.depth_file(v, geom=True)),
                          gt[v])["median_rel_err"] for v in range(N_VIEWS)]
    return out


def test_packed_pipeline_matches_reference_fixture(tmp_path):
    root = tmp_path / "scene"
    gt = write_scene(root)
    cfg = pipeline_cfg(packs=True, batch_problems="off")
    assert cfg.patchmatch.rect_tap_pack and cfg.patchmatch.rect_backmap_pack
    n = multiscale.run_pipeline(root, cfg, device="cpu")
    got, ref = packed_stats(root, n, gt), json.loads(FIXTURE.read_text())
    for v, (g, r) in enumerate(zip(got["views"], ref["views"], strict=True)):
        for k, x in r.items():
            assert abs(g[k] - x) <= max(STAT_TOL, STAT_TOL * abs(x)), (
                v, k, g[k], x)
    for v, (g, r) in enumerate(zip(got["median_rel_err"],
                                   ref["median_rel_err"], strict=True)):
        assert g < DEPTH_ERR_MAX and abs(g - r) <= ERR_TOL, (v, g, r)
    assert got["accuracy"] > ON_SURFACE_MIN, got["accuracy"]


def reference_stats(root, packs: bool) -> dict:
    """The JAX package's serial pipeline on the same scene folder."""
    from acmmp_spherical_tpu.config import (
        PatchMatchParams as JParams, PipelineConfig as JConfig,
    )
    from acmmp_spherical_tpu.pipeline.multiscale import run_pipeline as jrun

    gt = write_scene(root)
    n = jrun(root, pipeline_cfg(JConfig, JParams, packs=packs,
                                batch_problems="off"))
    return packed_stats(root, n, gt)


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import os
        import tempfile

        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
        with tempfile.TemporaryDirectory() as tmp:
            out = reference_stats(pathlib.Path(tmp) / "on", True)
            out["median_rel_err_packs_off"] = reference_stats(
                pathlib.Path(tmp) / "off", False)["median_rel_err"]
        FIXTURE.write_text(json.dumps(out, indent=1))
        print(f"wrote {FIXTURE}")
