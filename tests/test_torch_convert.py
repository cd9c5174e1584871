"""The port's COLMAP converter (pipeline/colmap.py, pipeline/convert.py and
the CLI's ``convert``) against the JAX package's ``convert_colmap_scene``.

Synthetic COLMAP models of the CubeRoom ring (5 views, real tracks;
``utils.synthetic.write_synthetic_colmap``) in the text and binary formats,
with a PINHOLE camera and with the custom SPHERE model id 11, go through
both converters: the camera files, pair.txt and the converted images must
be byte-identical, and the scene folder must read back through the port's
own readers (SPHERE cameras as SPHERE, depth ranges bracketing the true
depths).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.core.camera import PINHOLE, SPHERE  # noqa: E402
from acmmp_spherical_torch.io.scene import (  # noqa: E402
    read_camera_file, read_pair_file,
)
from acmmp_spherical_torch.pipeline import colmap as TCol  # noqa: E402
from acmmp_spherical_torch.pipeline.cli import main as cli_main  # noqa: E402
from acmmp_spherical_torch.utils.synthetic import (  # noqa: E402
    CubeRoom, make_ring_of_cameras, render_scene, write_synthetic_colmap,
)

N_VIEWS = 5
OPTS = dict(top_k=4, min_shared=5, theta0=0.05)


def _colmap(root, model, binary):
    W, H = (64, 48) if model == PINHOLE else (64, 32)
    cams = make_ring_of_cameras(N_VIEWS, model=model, width=W, height=H,
                                focal=56.0, device="cpu")
    images, depths, _ = render_scene(cams, CubeRoom(), W, H)
    write_synthetic_colmap(root, cams, images, depths, binary=binary)
    return cams, depths


@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
@pytest.mark.parametrize("model", [PINHOLE, SPHERE])
def test_convert_matches_reference(tmp_path, model, binary):
    from acmmp_spherical_tpu.pipeline import colmap as JCol
    from acmmp_spherical_tpu.pipeline.convert import (
        ConvertOptions, convert_colmap_scene,
    )

    root = tmp_path / "colmap"
    cams, depths = _colmap(root, model, binary)
    ext = ".bin" if binary else ".txt"
    # both packages' readers parse the model alike
    jm, tm = JCol.read_model(root / "sparse", ext), TCol.read_model(
        root / "sparse", ext)
    assert tm[0][1].model == ("SPHERE" if model == SPHERE else "PINHOLE")
    for jd, td in zip(jm, tm):
        assert sorted(jd) == sorted(td)
    convert_colmap_scene(root, tmp_path / "j",
                         ConvertOptions(model_ext=ext, **OPTS))
    assert cli_main(["convert", "--dense_folder", str(root), "--save_folder",
                     str(tmp_path / "t"), "--model_ext", ext, "--top_k", "4",
                     "--min_shared", "5", "--theta0", "0.05"]) == 0
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert len(files) == 2 * N_VIEWS + 1
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == (
            tmp_path / "t" / f).read_bytes(), f

    problems = read_pair_file(tmp_path / "t" / "pair.txt")
    assert len(problems) == N_VIEWS
    assert all(len(p.src_image_ids) >= 2 for p in problems)
    for i in range(N_VIEWS):
        cam = read_camera_file(tmp_path / "t" / "cams" / f"{i:08d}_cam.txt",
                               device="cpu")
        assert cam.model == model
        dmin, dmax = cam.depth_range.tolist()
        assert dmin < np.median(depths[i]) < dmax
        np.testing.assert_allclose(cam.R.numpy(), cams[i].R.numpy(),
                                   atol=1e-6)
