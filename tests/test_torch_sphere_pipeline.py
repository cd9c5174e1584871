"""The port's pipeline on a SPHERE scene, on the CPU.

An equirect CubeRoom ring (128x64, 4 views, every view taking the other 3)
is written in the on-disk layout and reconstructed by ``run_pipeline`` with
``PipelineConfig(rect_ncc="on")`` (photometric pass with its planar-prior
round, two geometric passes, fusion; every pass on the pole-rotated
rectified path, the kernels' plain versions on the CPU), and held to the
gates of the JAX package's sphere end-to-end test
(tests/test_multiscale_sphere.py:77-81): each view's final depth within a
median relative error of 0.08, more than 1500 fused points, more than 70%
of them within 0.2 of the cube surface.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from acmmp_spherical_torch.config import PipelineConfig  # noqa: E402
from acmmp_spherical_torch.core.camera import SPHERE  # noqa: E402
from acmmp_spherical_torch.io import read_depth_dmb, read_ply  # noqa: E402
from acmmp_spherical_torch.io.scene import ScenePaths  # noqa: E402
from acmmp_spherical_torch.pipeline.multiscale import run_pipeline  # noqa: E402
from acmmp_spherical_torch.utils.metrics import (  # noqa: E402
    cube_surface_distance,
)
from acmmp_spherical_torch.utils.synthetic import (  # noqa: E402
    CubeRoom, make_ring_of_cameras, render_scene,
    write_synthetic_scene_to_disk,
)

W, H, N_VIEWS = 128, 64, 4


def test_sphere_pipeline_meets_reference_gates(tmp_path):
    room = CubeRoom()
    cams = make_ring_of_cameras(N_VIEWS, model=SPHERE, width=W, height=H,
                                device="cpu")
    images, depths, _ = render_scene(cams, room, W, H)
    root = tmp_path / "dense"
    write_synthetic_scene_to_disk(root, cams, images)
    n_points = run_pipeline(root, PipelineConfig(rect_ncc="on"),
                            device="cpu")
    sp = ScenePaths(root)
    manifest = json.loads(sp.manifest_file().read_text())
    for name in ("photometric_s0", "geom0_s0", "geom1_s0"):
        assert sorted(manifest[name]) == list(range(N_VIEWS)), manifest
    for v in range(N_VIEWS):
        d = read_depth_dmb(sp.depth_file(v, geom=True))
        assert d.shape == (H, W)
        rel = np.abs(d - depths[v]) / depths[v]
        assert np.median(rel) < 0.08, (v, np.median(rel))
    assert n_points > 1500, n_points
    pts = read_ply(sp.ply_file())[0]
    on = np.mean(cube_surface_distance(pts, room.half) < 0.2)
    assert on > 0.7, on
