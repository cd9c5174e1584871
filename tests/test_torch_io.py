"""The port's io against the JAX package's, byte for byte, both ways.

* ``.dmb`` depth (h, w) and normal (h, w, 3) rasters: a file written by one
  package reads back equal in the other, and both packages' writers (native
  and numpy) write the same bytes;
* PLY clouds: the same bytes from both writers, and each reader reads the
  other's file (non-finite points zeroed);
* camera files and pair.txt: the same bytes from both writers, each parses
  the other's to the same camera and problems; the synthetic scene writer
  writes the same images, cameras and pair list;
* the resume manifest: written by one, read by the other;
* ``scale_camera`` equals the reference's; a SPHERE camera file reads as the
  reference reads it.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.core.camera import scale_camera  # noqa: E402
from acmmp_spherical_torch.io import dmb as TD  # noqa: E402
from acmmp_spherical_torch.io import ply as TPLY  # noqa: E402
from acmmp_spherical_torch.io import scene as TS  # noqa: E402

from torch_port_util import jax_cam_dict  # noqa: E402


@pytest.fixture
def arrays():
    rng = np.random.default_rng(3)
    return {"depth": rng.random((13, 9)).astype(np.float32) * 5,
            "normal": rng.normal(size=(13, 9, 3)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["depth", "normal"])
def test_dmb_bytes_both_ways(tmp_path, arrays, kind):
    from acmmp_spherical_tpu.io import dmb as JD

    a = arrays[kind]
    read = {"depth": (TD.read_depth_dmb, JD.read_depth_dmb),
            "normal": (TD.read_normal_dmb, JD.read_normal_dmb)}[kind]
    TD.write_dmb(tmp_path / "t.dmb", a)
    JD.write_dmb(tmp_path / "j.dmb", a)
    TD.write_dmb_numpy(tmp_path / "tn.dmb", a)
    raw = (tmp_path / "j.dmb").read_bytes()
    assert (tmp_path / "t.dmb").read_bytes() == raw
    assert (tmp_path / "tn.dmb").read_bytes() == raw
    np.testing.assert_array_equal(read[1](tmp_path / "t.dmb"), a)
    np.testing.assert_array_equal(read[0](tmp_path / "j.dmb"), a)
    np.testing.assert_array_equal(TD.read_dmb_numpy(tmp_path / "j.dmb"), a)


def test_ply_bytes_both_ways(tmp_path):
    from acmmp_spherical_tpu.io import ply as JPLY

    rng = np.random.default_rng(5)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    pts[4] = [np.nan, 1.0, np.inf]
    nrm = rng.normal(size=(40, 3)).astype(np.float32)
    col = rng.uniform(-10, 270, (40, 3))
    TPLY.write_ply(tmp_path / "t.ply", pts, nrm, col)
    JPLY.write_ply(tmp_path / "j.ply", pts, nrm, col)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for a, b in zip(JPLY.read_ply(tmp_path / "t.ply"),
                    TPLY.read_ply(tmp_path / "j.ply")):
        np.testing.assert_array_equal(a, b)
    p, _, c = TPLY.read_ply(tmp_path / "t.ply")
    np.testing.assert_array_equal(p[4], 0.0)
    np.testing.assert_array_equal(c, np.clip(col, 0, 255).astype(np.uint8))
    # the numpy writer zeroes only the non-finite coordinates of a point
    TPLY.write_ply_numpy(tmp_path / "n.ply", np.delete(pts, 4, 0),
                         np.delete(nrm, 4, 0), np.delete(col, 4, 0))
    JPLY.write_ply(tmp_path / "jn.ply", np.delete(pts, 4, 0),
                   np.delete(nrm, 4, 0), np.delete(col, 4, 0))
    assert (tmp_path / "n.ply").read_bytes() == (tmp_path / "jn.ply").read_bytes()


def _cam_fields(R, t, K):
    return dict(K=K, depth_min=1.2, depth_max=10.0,
                depth_interval=float(np.float32(8.8 / 191)), num_planes=192)


def test_camera_and_pair_files_both_ways(tmp_path):
    from acmmp_spherical_tpu.io import scene as JS

    rng = np.random.default_rng(1)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    t = rng.normal(size=3)
    K = np.array([[80.0, 0.0, 48.0], [0.0, 81.0, 32.5], [0.0, 0.0, 1.0]])
    TS.write_camera_file(tmp_path / "t.txt", "pinhole", R, t,
                         **_cam_fields(R, t, K))
    JS.write_camera_file(tmp_path / "j.txt", "pinhole", R, t,
                         **_cam_fields(R, t, K))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    jc = jax_cam_dict(JS.read_camera_file(tmp_path / "t.txt"))
    tc = TS.read_camera_file(tmp_path / "j.txt", device="cpu")
    for k, v in jc.items():
        np.testing.assert_array_equal(getattr(tc, k).numpy(), v, err_msg=k)
    # the C++ reader's "dmin dmax d d" convention
    (tmp_path / "c.txt").write_text((tmp_path / "t.txt").read_text().replace(
        f"1.2 {_cam_fields(R, t, K)['depth_interval']} 192 10.0",
        "1.5 7.0 0 0"))
    np.testing.assert_array_equal(
        TS.read_camera_file(tmp_path / "c.txt", device="cpu").depth_range,
        np.asarray(JS.read_camera_file(tmp_path / "c.txt").depth_range))

    nbrs = [[(1, 120.0), (2, 0.0), (3, 7.0)], [(0, 5.0)], [], [(2, 3.0)]]
    TS.write_pair_file(tmp_path / "tp.txt", nbrs)
    JS.write_pair_file(tmp_path / "jp.txt", nbrs)
    assert (tmp_path / "tp.txt").read_text() == (
        tmp_path / "jp.txt").read_text()
    for a, b in zip(TS.read_pair_file(tmp_path / "jp.txt"),
                    JS.read_pair_file(tmp_path / "tp.txt")):
        assert (a.ref_image_id, a.src_image_ids) == (b.ref_image_id,
                                                     b.src_image_ids)


def test_sphere_camera_file_raises(tmp_path):
    """A SPHERE camera file reads as the JAX package reads it; one cut
    before its depth line raises in both packages."""
    from acmmp_spherical_tpu.io import scene as JS

    JS.write_camera_file(tmp_path / "s.txt", "sphere", np.eye(3), np.zeros(3),
                         sphere_params=[100.0, 50.0, 25.0])
    tc = TS.read_camera_file(tmp_path / "s.txt", device="cpu")
    jc = JS.read_camera_file(tmp_path / "s.txt")
    assert tc.model == jc.model == "sphere"
    for k, v in jax_cam_dict(jc).items():
        np.testing.assert_array_equal(getattr(tc, k).numpy(), v, err_msg=k)
    cut = tmp_path / "cut.txt"
    cut.write_text((tmp_path / "s.txt").read_text().rsplit("\n\n", 1)[0])
    with pytest.raises(StopIteration):
        JS.read_camera_file(cut)
    with pytest.raises(StopIteration):
        TS.read_camera_file(cut, device="cpu")


def test_scale_camera_matches_reference():
    from acmmp_spherical_tpu.core.camera import make_camera
    from acmmp_spherical_tpu.core.camera import scale_camera as jscale
    from acmmp_spherical_torch import interop

    K = np.array([[81.3, 0.2, 47.9], [0.0, 80.1, 31.7], [0.0, 0.0, 1.0]])
    jc = make_camera(np.eye(3), np.ones(3), K=K, width=96, height=64)
    tc = interop.camera(jax_cam_dict(jc), device="cpu")
    for args in ((0.5, 0.5, 48, 32), (1600 / 96, 1200 / 64, 1600, 1200)):
        j, t = jax_cam_dict(jscale(jc, *args)), scale_camera(tc, *args)
        for k in ("K", "wh"):
            np.testing.assert_array_equal(getattr(t, k).numpy(), j[k])


def test_synthetic_scene_writer_matches_reference(tmp_path):
    from acmmp_spherical_tpu.core.camera import PINHOLE
    from acmmp_spherical_tpu.utils import synthetic as JSYN
    from acmmp_spherical_torch import interop
    from acmmp_spherical_torch.utils import synthetic as TSYN

    cams = JSYN.make_ring_of_cameras(3, model=PINHOLE, width=64, height=48,
                                     focal=56.0)
    images = JSYN.render_scene(cams, JSYN.CubeRoom(), 64, 48)[0]
    JSYN.write_synthetic_scene_to_disk(tmp_path / "j", cams, images)
    TSYN.write_synthetic_scene_to_disk(
        tmp_path / "t", [interop.camera(jax_cam_dict(c), "cpu") for c in cams],
        images)
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert len(files) == 7
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (
            tmp_path / "j" / f).read_bytes(), f


def test_manifest_both_ways(tmp_path):
    from acmmp_spherical_tpu.io import scene as JS

    tsp, jsp = TS.ScenePaths(tmp_path), JS.ScenePaths(tmp_path)
    TS.mark_pass_complete(tsp, "photometric_s1", 3)
    JS.mark_pass_complete(jsp, "photometric_s1", 5)
    JS.mark_pass_complete(jsp, "geom0_s0", 3)
    TS.mark_pass_complete(tsp, "geom0_s0", 3)
    assert json.loads(tsp.manifest_file().read_text()) == {
        "photometric_s1": [3, 5], "geom0_s0": [3]}
    assert TS.is_pass_complete(tsp, "photometric_s1", 5)
    assert JS.is_pass_complete(jsp, "photometric_s1", 3)
    assert not TS.is_pass_complete(tsp, "geom0_s0", 5)
    assert tsp.ply_file() == jsp.ply_file()
    assert tsp.depth_file(7, geom=True) == jsp.depth_file(7, geom=True)
