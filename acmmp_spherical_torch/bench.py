"""Benchmark of the port: photometric passes per second on one GPU.

    python -m acmmp_spherical_torch.bench

The counterpart of the photometric section of the repository's ``bench.py``:
one full photometric PatchMatch pass (random init, 3 iterations of black/red
propagation with view selection and refinement, depth extraction, median
filter) on the CubeRoom scene at 1024x768 with 8 source views, on the
rectified kernel path.  Prints one JSON line with the same keys
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``compile_s``); the
geometric and spherical sections are not ported yet and report null.
Needs a CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_torch.core.camera import stack_cameras
from acmmp_spherical_torch.ops import rectify as RT
from acmmp_spherical_torch.ops.propagate import PatchMatchInputs
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
from acmmp_spherical_torch.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene,
)

BASELINE_PASSES_PER_S = 1.6  # analytic GTX 1080 Ti anchor (BASELINE.md)


def make_problem(width: int, height: int, n_src: int, device, *,
                 focal: float, radius: float):
    """A CubeRoom ring problem on the rectified path (reference bench.py
    settings: host mirrors for the compute grid, live tiles, init window,
    warp window and the attribution gate; both bf16 packs off).
    Returns (inputs, params, ground-truth depths (V, H, W) numpy)."""
    cams = make_ring_of_cameras(1 + n_src, width=width, height=height,
                                focal=focal, radius=radius, device=device)
    images, depths, _ = render_scene(cams, CubeRoom(), width, height)
    src = stack_cameras(cams[1:])
    rhw = RT.rect_shape(height, width)
    if not RT.host_rectifiable(cams[0], src, rhw):
        raise RuntimeError("the bench scene must pass host_rectifiable")
    chw = RT.rect_comp_shape(cams[0], src, rhw)
    iwin = RT.rect_init_window(cams[0], src, rhw)
    params = dataclasses.replace(
        PatchMatchParams().with_depth_range(*cams[0].depth_range.tolist()),
        rect_ncc=True, rect_comp_hw=chw,
        rect_live_n=RT.rect_live_tile_count(cams[0], src, rhw, chw),
        rect_init=iwin > 0, rect_init_win=iwin or 384,
        rect_warp_hw=RT.rect_warp_window(cams[0], src, rhw),
        rect_inv_attrib=RT.rect_inv_attrib_ok(cams[0], src, rhw),
        rect_tap_pack=False, rect_backmap_pack=False)
    imgs = torch.as_tensor(images, device=device)
    inputs = PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0], src_cams=src,
        src_valid=torch.ones(n_src, dtype=torch.bool, device=device),
        depth_range=cams[0].depth_range)
    return inputs, params, depths


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the port's bench needs a CUDA device")
    W, H, n_src, reps = 1024, 768, 8, 3
    dev = torch.device("cuda", 0)
    print(f"[bench] device: {torch.cuda.get_device_name(0)}", file=sys.stderr)
    t0 = time.perf_counter()
    inputs, params, gt = make_problem(W, H, n_src, dev, focal=0.9 * W,
                                      radius=0.25)
    print(f"[bench] scene setup {time.perf_counter() - t0:.1f}s; "
          f"comp_hw={params.rect_comp_hw} live_n={params.rect_live_n} "
          f"init_win={params.rect_init_win} warp_hw={params.rect_warp_hw}",
          file=sys.stderr)

    t0 = time.perf_counter()
    run_patchmatch(inputs, params, 0)          # kernel build + first pass
    torch.cuda.synchronize()
    compile_s = {"photometric": round(time.perf_counter() - t0, 1)}
    times = []
    for r in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_patchmatch(inputs, params, r + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    depth = out[0].cpu().numpy()
    g = gt[0][8:-8, 8:-8]
    rel = np.abs(depth[8:-8, 8:-8] - g) / g
    print(f"[bench] pass times: {['%.3f' % t for t in times]}; "
          f"median rel depth err {np.median(rel):.4f}", file=sys.stderr)
    value = 1.0 / min(times)
    print(json.dumps({
        "metric": "depth_maps_per_s_per_chip",
        "value": round(value, 4),
        "unit": f"{W}x{H}x{n_src}src photometric passes/s",
        "vs_baseline": round(value / BASELINE_PASSES_PER_S, 4),
        "geom_value": None,
        "geom_unit": f"{W}x{H}x{n_src}src geometric passes/s",
        "sphere_value": None,
        "sphere_unit": "1024x512x6src spherical photometric passes/s",
        "sphere_geom_value": None,
        "sphere_geom_unit": "1024x512x6src spherical geometric passes/s",
        "compile_s": compile_s,
    }))


if __name__ == "__main__":
    main()
