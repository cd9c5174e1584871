"""The port's ``reconstruct`` command on the CPU: a 64x48 3-view ring (one
scale: the planar-prior round and two geometric passes per view) writes the
JAX package's file layout -- per view depths.dmb, depths_geom.dmb,
normals.dmb, costs.dmb and triangulation.png, the manifest and
ACMMP_model.ply, at the paths of the JAX package's ``ScenePaths`` -- with a
fused cloud on the cube surface; ``--resume`` then runs no pass and fuses
again.  ``--device cuda`` without CUDA raises rather than running elsewhere.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from acmmp_spherical_torch.io import read_ply  # noqa: E402
from acmmp_spherical_torch.pipeline import multiscale  # noqa: E402
from acmmp_spherical_torch.pipeline.cli import main  # noqa: E402
from acmmp_spherical_torch.utils.metrics import cube_surface_distance  # noqa: E402
from acmmp_spherical_torch.utils.synthetic import (  # noqa: E402
    CubeRoom, make_ring_of_cameras, render_scene,
    write_synthetic_scene_to_disk,
)

W, H, N_VIEWS = 64, 48, 3


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli") / "scene"
    cams = make_ring_of_cameras(N_VIEWS, width=W, height=H, focal=56.0,
                                device="cpu")
    write_synthetic_scene_to_disk(root, cams,
                                  render_scene(cams, CubeRoom(), W, H)[0])
    return root


def _layout(root: pathlib.Path) -> set:
    from acmmp_spherical_tpu.io.scene import ScenePaths

    sp = ScenePaths(root)
    files = {sp.ply_file(), sp.manifest_file()}
    for v in range(N_VIEWS):
        files |= {sp.depth_file(v, geom=False), sp.depth_file(v, geom=True),
                  sp.normal_file(v), sp.cost_file(v),
                  sp.result_dir(v) / "triangulation.png"}
    return {p.relative_to(root) for p in files}


def test_reconstruct_then_resume(scene, monkeypatch):
    assert main(["reconstruct", str(scene), "--device", "cpu"]) == 0
    out = {p.relative_to(scene) for p in (scene / "ACMMP").rglob("*")
           if p.is_file()}
    assert out == _layout(scene)
    pts = read_ply(scene / "ACMMP" / "ACMMP_model.ply")[0]
    assert len(pts) > 1000
    assert np.mean(cube_surface_distance(pts, CubeRoom().half) < 0.08) > 0.9

    def no_pass(*args, **kw):
        raise AssertionError("--resume ran a pass")

    monkeypatch.setattr(multiscale, "process_problem", no_pass)
    (scene / "ACMMP" / "ACMMP_model.ply").unlink()
    assert main(["reconstruct", str(scene), "--device", "cpu",
                 "--resume"]) == 0
    assert len(read_ply(scene / "ACMMP" / "ACMMP_model.ply")[0]) == len(pts)


def test_cuda_device_without_cuda_raises(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["reconstruct", str(scene), "--resume"])
