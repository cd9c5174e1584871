"""The port never imports JAX or the JAX package, and its passes never
import OpenCV: tiny photometric passes and geometric passes seeded from
them on the rectified, windowed and exact paths, an odd-frame pass and the
windowed sampler, and SPHERE photometric and geometric passes on the
pole-rotated and exact paths run in a fresh interpreter, which also imports
the profiling script and every module of the serial pipeline (io, prior,
JBU, fusion, pass runner, multiscale, COLMAP converter, CLI) and then must
not hold ``jax``, ``jaxlib``, ``acmmp_spherical_tpu`` or ``cv2`` in
``sys.modules``; then the ``reconstruct`` command runs a tiny pinhole scene
and a tiny SPHERE scene on the CPU (planar prior, two geometric passes,
fusion; its images are read and written with OpenCV, as in the JAX
package), the ``convert`` command turns a tiny SPHERE COLMAP model into a
scene folder, and ``jax``, ``jaxlib`` and ``acmmp_spherical_tpu`` must
still be absent."""

import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import torch
    torch.set_num_threads(2)
    from acmmp_spherical_torch.config import PatchMatchParams
    from acmmp_spherical_torch.core.camera import stack_cameras
    from acmmp_spherical_torch.ops import rectify as RT
    from acmmp_spherical_torch.ops.propagate import PatchMatchInputs
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_torch.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene)

    W, H = 64, 48
    cams = make_ring_of_cameras(3, width=W, height=H, focal=60.0,
                                device="cpu")
    images, depths, _ = render_scene(cams, CubeRoom(), W, H)
    src = stack_cameras(cams[1:])
    rhw = RT.rect_shape(H, W)
    chw = RT.rect_comp_shape(cams[0], src, rhw)
    params = dataclasses.replace(
        PatchMatchParams(), max_iterations=1, rect_ncc=True, rect_init=True,
        rect_comp_hw=chw,
        rect_live_n=RT.rect_live_tile_count(cams[0], src, rhw, chw),
        rect_warp_hw=RT.rect_warp_window(cams[0], src, rhw),
        rect_inv_attrib=RT.rect_inv_attrib_ok(cams[0], src, rhw))
    imgs = torch.from_numpy(images)
    inputs = PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0],
        src_cams=src, src_valid=torch.ones(2, dtype=torch.bool),
        depth_range=cams[0].depth_range)
    depth, normal = run_patchmatch(inputs, params, 0)[:2]
    assert depth.shape == (H, W) and bool(torch.isfinite(depth).all())
    geom = dataclasses.replace(inputs, src_depths=torch.from_numpy(depths[1:]))
    gdepth = run_patchmatch(geom, params.with_geom(False), 1,
                            seed_normal_world=normal, seed_depth=depth)[0]
    assert bool(torch.isfinite(gdepth).all())
    # the windowed and exact paths, photometric and geometric, and an odd
    # frame on the exact path
    for fast in (True, False):
        p = dataclasses.replace(params, rect_ncc=False, fast_ncc=fast)
        d, n = run_patchmatch(inputs, p, 0)[:2]
        g = run_patchmatch(geom, p.with_geom(False), 1,
                           seed_normal_world=n, seed_depth=d)[0]
        assert bool(torch.isfinite(d).all() and torch.isfinite(g).all())
    ocams = make_ring_of_cameras(3, width=W - 1, height=H, focal=60.0,
                                 device="cpu")
    oimgs = torch.from_numpy(render_scene(ocams, CubeRoom(), W - 1, H)[0])
    odd = dataclasses.replace(inputs, ref_image=oimgs[0],
                              src_images=oimgs[1:], ref_cam=ocams[0],
                              src_cams=stack_cameras(ocams[1:]))
    d = run_patchmatch(odd, dataclasses.replace(params, rect_ncc=False), 0)[0]
    assert d.shape == (H, W - 1) and bool(torch.isfinite(d).all())
    from acmmp_spherical_torch.ops.kernels.window_sample import windowed_sample
    ys, xs = torch.meshgrid(torch.arange(8.0), torch.arange(128.0),
                            indexing="ij")
    v, ok = windowed_sample(imgs[1], xs * 0.4 + 0.3, ys * 0.9 + 1.1,
                            src_h=H, src_w=W)
    assert bool(ok.any())
    from acmmp_spherical_torch.bench import make_sphere_problem
    sin, sp_, _, _ = make_sphere_problem(48, 24, 2, "cpu")
    for rect in (True, False):
        p = dataclasses.replace(sp_, max_iterations=1, rect_ncc=rect)
        d, n = run_patchmatch(sin, p, 0)[:2]
        g = run_patchmatch(dataclasses.replace(sin, src_depths=d.expand(
            2, *d.shape).contiguous()), p.with_geom(False), 1,
            seed_normal_world=n, seed_depth=d)[0]
        assert bool(torch.isfinite(d).all() and torch.isfinite(g).all())
    import acmmp_spherical_torch.profile_pass  # noqa: F401
    from acmmp_spherical_torch import io, utils  # noqa: F401
    from acmmp_spherical_torch.ops import fusion, jbu  # noqa: F401
    from acmmp_spherical_torch.pipeline import (  # noqa: F401
        cli, colmap, convert, multiscale, pass_runner, prior)
    from acmmp_spherical_torch.utils import log, metrics  # noqa: F401
    forbidden = lambda names: sorted(
        m for m in sys.modules if m.split(".")[0] in names)
    bad = forbidden(("jax", "jaxlib", "acmmp_spherical_tpu", "cv2"))
    print("FORBIDDEN", bad)
    if bad:
        sys.exit(1)
    import tempfile
    from acmmp_spherical_torch.utils.synthetic import (
        write_synthetic_colmap, write_synthetic_scene_to_disk)
    with tempfile.TemporaryDirectory() as tmp:
        sc = make_ring_of_cameras(3, width=48, height=32, focal=42.0,
                                  device="cpu")
        write_synthetic_scene_to_disk(
            tmp, sc, render_scene(sc, CubeRoom(), 48, 32)[0])
        assert cli.main(["reconstruct", tmp, "--device", "cpu"]) == 0
    with tempfile.TemporaryDirectory() as tmp:
        sc = make_ring_of_cameras(3, model="sphere", width=48, height=24,
                                  device="cpu")
        imgs, deps, _ = render_scene(sc, CubeRoom(), 48, 24)
        write_synthetic_colmap(tmp + "/colmap", sc, imgs, deps)
        assert cli.main(["convert", "--dense_folder", tmp + "/colmap",
                         "--save_folder", tmp + "/scene", "--top_k", "2",
                         "--min_shared", "5", "--theta0", "0.05"]) == 0
        assert cli.main(["reconstruct", tmp + "/scene", "--device",
                         "cpu"]) == 0
    bad = forbidden(("jax", "jaxlib", "acmmp_spherical_tpu"))
    print("FORBIDDEN", bad)
    sys.exit(1 if bad else 0)
""")


def test_port_imports_no_jax_or_cv2():
    res = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("FORBIDDEN []") == 2
