"""The occluded and hostile scenes of the port's ``utils/synthetic.py``
against the JAX package's, and the discontinuity golden on the port.

* ``OccludedRoom`` renders and ``render_scene_hostile`` (seed 0; its
  specular lobe, exposure, noise and JPEG round trip) equal the reference's
  bit for bit at 48x32 with 3 views, pinhole and SPHERE;
* the occluder occludes at the discontinuity golden's size (96x64x4,
  focal 80): an edge band over 3% of the frame and a depth ratio over 1.5
  (tests/test_discontinuity.py);
* the port of tests/test_discontinuity.py's four cases (the exact,
  windowed and rectified paths, and the rectified one with
  ``rect_prescreen``), at the same gates: median relative depth error <
  0.02 and < 0.06 in the edge band.  Marked slow as there.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_tpu.core.camera import PINHOLE, SPHERE  # noqa: E402
from acmmp_spherical_tpu.utils import synthetic as JS  # noqa: E402
from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.utils import synthetic as TS  # noqa: E402

from torch_port_util import jax_cam_dict  # noqa: E402

W, H, N = 96, 64, 4


def _rings(model, width, height, n, **kw):
    cams = JS.make_ring_of_cameras(n, model=model, width=width, height=height,
                                   **kw)
    tcams = [interop.camera(dict(jax_cam_dict(c), model=c.model),
                            device="cpu") for c in cams]
    return cams, tcams


@pytest.mark.parametrize("model", [PINHOLE, SPHERE])
@pytest.mark.parametrize("hostile", [False, True], ids=["clean", "hostile"])
def test_occluded_renders_equal_reference(model, hostile):
    kw = dict(focal=40.0) if model == PINHOLE else {}
    cams, tcams = _rings(model, 48, 32, 3, **kw)
    if hostile:
        ref = JS.render_scene_hostile(cams, JS.OccludedRoom(), 48, 32, seed=0)
        got = TS.render_scene_hostile(tcams, TS.OccludedRoom(), 48, 32,
                                      seed=0)
    else:
        ref = JS.render_scene(cams, JS.OccludedRoom(), 48, 32)
        got = TS.render_scene(tcams, TS.OccludedRoom(), 48, 32)
    for a, b in zip(ref, got, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    clean = TS.render_scene(tcams, TS.OccludedRoom(), 48, 32)[0]
    # the hostile images are not the clean ones, and only the images differ
    assert hostile == (not np.array_equal(got[0], clean))


def test_hostile_seed_and_options_follow_reference():
    cams, tcams = _rings(PINHOLE, 48, 32, 3, focal=40.0)
    opts = dict(seed=5, specular_ks=10.0, noise_sigma=4.0, jpeg_quality=50,
                gain_range=(0.7, 1.3), bias_range=(-20.0, 5.0))
    ref = JS.render_scene_hostile(cams, JS.CubeRoom(), 48, 32, **opts)
    got = TS.render_scene_hostile(tcams, TS.CubeRoom(), 48, 32, **opts)
    np.testing.assert_array_equal(ref[0], got[0])
    other = TS.render_scene_hostile(tcams, TS.CubeRoom(), 48, 32, seed=0)
    assert not np.array_equal(got[0], other[0])


def _box_scene():
    tcams = TS.make_ring_of_cameras(N, model=PINHOLE, width=W, height=H,
                                    focal=80.0, device="cpu")
    images, depths, _ = TS.render_scene(tcams, TS.OccludedRoom(), W, H)
    gt = depths[0]
    # edge band: pixels within 3 px of a ground-truth depth step > 5%
    band = np.maximum(np.abs(np.diff(gt, axis=0, prepend=gt[:1])),
                      np.abs(np.diff(gt, axis=1, prepend=gt[:, :1]))
                      ) > 0.05 * gt
    for _ in range(3):
        band[1:] |= band[:-1]
        band[:-1] |= band[1:]
        band[:, 1:] |= band[:, :-1]
        band[:, :-1] |= band[:, 1:]
    return tcams, images, gt, band


def test_box_scene_has_occlusions():
    _, _, gt, band = _box_scene()
    assert band.mean() > 0.03, band.mean()
    assert gt.max() / gt.min() > 1.5


@pytest.mark.slow
@pytest.mark.parametrize("path", ["exact", "window", "rect",
                                  "rect_prescreen"])
def test_discontinuity_quality(path):
    from acmmp_spherical_torch.config import PatchMatchParams
    from acmmp_spherical_torch.core.camera import stack_cameras
    from acmmp_spherical_torch.ops.propagate import PatchMatchInputs
    from acmmp_spherical_torch.ops.rng import key
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch

    tcams, images, gt, band = _box_scene()
    fast, rect = {"exact": (False, False), "window": (True, False),
                  "rect": (True, True), "rect_prescreen": (True, True)}[path]
    params = dataclasses.replace(PatchMatchParams(), fast_ncc=fast,
                                 rect_ncc=rect, rect_init=rect,
                                 rect_prescreen=path == "rect_prescreen")
    imgs = torch.from_numpy(images)
    inputs = PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=tcams[0],
        src_cams=stack_cameras(tcams[1:]),
        src_valid=torch.ones(N - 1, dtype=torch.bool),
        depth_range=tcams[0].depth_range)
    d = run_patchmatch(inputs, params, key(3))[0].numpy()
    rel = np.abs(d - gt) / gt
    interior = np.s_[6:-6, 6:-6]
    med = np.median(rel[interior])
    med_band = np.median(rel[interior][band[interior]])
    assert med < 0.02, (path, med)
    assert med_band < 0.06, (path, med_band)
