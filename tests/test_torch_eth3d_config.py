"""The ``eth3d_pinhole`` benchmark configuration stays on the path its cell
measures (host only, a few seconds).

``mvsbench/configs/eth3d_pinhole.json`` is ETH3D high-res at ACMMP's
3200-px cap: 3200x2133 pinhole frames, 11 views on a ring, 10 sources a
view.  Its cameras, with blank images of the configuration's size, go
through the pipeline's own set-up: ``compute_multiscale_settings`` must
give a 3-level pyramid (long sides 800, 1600 and 3200, ACMMP's
``size_bound`` 1000), every problem must pass ``host_rectifiable`` at every
scale, and the scene-wide rect settings at 3200 must be the compute grid
and live-tile budget the cell was sized with.  A change to the ring or to
the rectifier that moved the cell off the rectified path, or changed the
kernels' grid, fails here first.

    python -m pytest -q tests/test_torch_eth3d_config.py
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from acmmp_spherical_torch.config import PipelineConfig
from acmmp_spherical_torch.core.camera import stack_cameras
from acmmp_spherical_torch.io.scene import ScenePaths, read_pair_file
from acmmp_spherical_torch.ops import rectify as RT
from acmmp_spherical_torch.pipeline import pass_runner
from acmmp_spherical_torch.pipeline.multiscale import (
    compute_multiscale_settings,
)
from mvsbench import workspace

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "mvsbench/configs/eth3d_pinhole.json").read_text())
# (long side, (w, h) of the maps) per scale, coarsest first: 2133 / 4 =
# 533.25 and 2133 / 2 = 1066.5 round (half to even) as ACMMP.cpp:605-643's
# rescale does in the pipeline
SCALES = [(800, (800, 533)), (1600, (1600, 1066)), (3200, (3200, 2133))]
# scene-wide rect settings at 3200 (compute grid, live tiles per source)
COMP_HW_3200 = (3864, 3968)
LIVE_N_3200 = 7200


def _write_cameras(root: Path) -> None:
    """The configuration's cameras and pair file in the pipeline's layout,
    with blank images (only their size is read here)."""
    import cv2

    cams = workspace.config_cameras(CONFIG)
    (root / "images").mkdir()
    (root / "cams").mkdir()
    blank = np.zeros((CONFIG["height"], CONFIG["width"]), np.uint8)
    for i, cam in enumerate(cams):
        assert cv2.imwrite(str(root / "images" / f"{i:08d}.jpg"), blank)
        workspace.write_camera(root / "cams" / f"{i:08d}_cam.txt", cam)
    n = len(cams)
    with open(root / "pair.txt", "w") as f:
        f.write(f"{n}\n")
        for i in range(n):
            src = [j for j in range(n) if j != i][: CONFIG["sources_per_view"]]
            f.write(f"{i}\n{len(src)} " + "".join(f"{j} 100 " for j in src)
                    + "\n")


def test_eth3d_pyramid_stays_rectified(tmp_path):
    assert (CONFIG["width"], CONFIG["height"]) == (3200, 2133)
    assert CONFIG["views"] == 11 and CONFIG["sources_per_view"] == 10
    assert CONFIG["pipeline"] == {}
    _write_cameras(tmp_path)
    sp = ScenePaths(tmp_path)
    problems = read_pair_file(sp.pair_file)
    cfg = PipelineConfig()
    assert compute_multiscale_settings(sp, problems, cfg) == len(SCALES) - 1
    for size, (w, h) in SCALES:
        # the scale loop of run_pipeline (main.cpp:392-482), as the
        # benchmark's harness sets it up
        for p in problems:
            if p.num_downscale >= 0:
                p.cur_image_size = p.max_image_size // 2 ** p.num_downscale
                p.num_downscale -= 1
        assert {p.cur_image_size for p in problems} == {size}
        assert workspace.scaled_size(CONFIG["width"], CONFIG["height"],
                                     size) == (w, h)
        for p in problems:
            ref, ph, pw = pass_runner._view_geometry(sp, p.ref_image_id, size)
            assert (pw, ph) == (w, h)
            src = stack_cameras([
                pass_runner._view_geometry(sp, s, size)[0]
                for s in p.src_image_ids[: cfg.max_src_views]])
            assert src.K.shape[0] == CONFIG["sources_per_view"]
            assert RT.host_rectifiable(ref, src, RT.rect_shape(ph, pw)), (
                size, p.ref_image_id)
        unify = pass_runner.compute_scene_rect_settings(sp, problems, cfg)
        assert unify is not None and not unify.failed
    assert unify.comp_hw == COMP_HW_3200
    assert unify.live_n == LIVE_N_3200
