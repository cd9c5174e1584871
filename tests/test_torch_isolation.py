"""The port never imports JAX or OpenCV: a tiny pass of the port runs in a
fresh interpreter, which then must not hold ``jax`` or ``cv2`` in
``sys.modules`` (the GPU host has neither)."""

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
    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_torch.core.camera import stack_cameras
    from acmmp_spherical_torch.ops import rectify as RT
    from acmmp_spherical_torch.ops.propagate import PatchMatchInputs
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_torch.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene)

    W, H = 64, 48
    cams = make_ring_of_cameras(3, width=W, height=H, focal=60.0)
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
    depth = run_patchmatch(inputs, params, 0)[0]
    assert depth.shape == (H, W) and bool(torch.isfinite(depth).all())
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "cv2"))
    print("FORBIDDEN", bad)
    sys.exit(1 if bad else 0)
""")


def test_port_imports_no_jax_or_cv2():
    res = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "FORBIDDEN []" in res.stdout
