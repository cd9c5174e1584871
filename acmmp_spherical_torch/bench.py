"""Benchmark of the port: photometric and geometric passes per second on one
GPU.

    python -m acmmp_spherical_torch.bench

The counterpart of the repository's ``bench.py`` on the CubeRoom scene, on
the rectified kernel path: at 1024x768 with 8 source views, one full
photometric PatchMatch pass (random init, 3 iterations of black/red
propagation with view selection and refinement, depth extraction, median
filter), and one geometric-consistency pass (2 iterations) seeded from the
photometric result, with every source view's own photometric pass (keys
1000 + i) as its source depths; then the same two passes on the
equirectangular ring at 1024x512 with 6 source views through the
pole-rotated path (source depths from keys 2000 + i).  Every pass runs
twice: with both bf16 packs off (f32 taps and back-map) and with both on
(the defaults of ``PatchMatchParams``).  Prints one JSON line with the same
keys (``metric``, ``value``, ``unit``, ``vs_baseline``, ``geom_value``,
``sphere_value``, ``sphere_geom_value``, ``compile_s``), which stay the f32
passes', the median relative depth errors (``err``, ``geom_err``,
``sphere_err``, ``sphere_geom_err``) and the packed passes' rates and errors
under the same names with ``_pk``.  The sphere's depth error is reported
over the latitude band that ``LAT_CAP_DEG`` leaves and over the pole band
separately.  Needs a CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from acmmp_spherical_torch.config import PatchMatchParams, PriorConfig
from acmmp_spherical_torch.core.camera import (
    SPHERE, camera_index, stack_cameras,
)
from acmmp_spherical_torch.ops import rectify as RT
from acmmp_spherical_torch.ops import rng as R
from acmmp_spherical_torch.ops import sphere_rect as SR
from acmmp_spherical_torch.ops.propagate import (
    PatchMatchInputs, prepare_inputs,
)
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
from acmmp_spherical_torch.pipeline.prior import build_planar_prior
from acmmp_spherical_torch.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene,
)

BASELINE_PASSES_PER_S = 1.6  # analytic GTX 1080 Ti anchor (BASELINE.md)


BENCH_SCENE = dict(width=1024, height=768, n_src=8, focal=921.6, radius=0.25)
GOLDEN_SCENE = dict(width=96, height=64, n_src=3, focal=80.0, radius=0.35)
GOLDEN_KEY = 2333
SPHERE_BENCH_SCENE = dict(width=1024, height=512, n_src=6)
SPHERE_GOLDEN_SCENE = dict(width=128, height=64, n_src=3)


def make_problem(width: int, height: int, n_src: int, device, *,
                 focal: float, radius: float, packs: bool = False,
                 scene: CubeRoom = CubeRoom(), render=render_scene):
    """A ring problem on the rectified path (reference bench.py settings:
    host mirrors for the compute grid, live tiles, init window, warp window
    and the attribution gate; both bf16 packs off unless ``packs``) in
    ``scene``, rendered by ``render``.  Returns (inputs, params,
    ground-truth depths (V, H, W) and world normals (V, H, W, 3), numpy)."""
    cams = make_ring_of_cameras(1 + n_src, width=width, height=height,
                                focal=focal, radius=radius, device=device)
    images, depths, normals = render(cams, scene, width, height)
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
        rect_tap_pack=packs, rect_backmap_pack=packs)
    imgs = torch.as_tensor(images, device=device)
    inputs = PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0], src_cams=src,
        src_valid=torch.ones(n_src, dtype=torch.bool, device=device),
        depth_range=cams[0].depth_range)
    return inputs, params, depths, normals


def make_sphere_problem(width: int, height: int, n_src: int, device, *,
                        packs: bool = False):
    """An equirect CubeRoom ring problem on the pole-rotated rectified path
    (reference bench.py settings: the init window and the live-tile budget
    from the host mirrors; both bf16 packs off unless ``packs``).  Returns
    (inputs, params,
    ground-truth radial depths (V, H, W) and world normals (V, H, W, 3),
    numpy)."""
    cams = make_ring_of_cameras(1 + n_src, model=SPHERE, width=width,
                                height=height, device=device)
    images, depths, normals = render_scene(cams, CubeRoom(), width, height)
    src = stack_cameras(cams[1:])
    if not SR.sphere_rectifiable(cams[0], src):
        raise RuntimeError("the sphere scene must pass sphere_rectifiable")
    iwin = SR.sphere_init_window(cams[0], src)
    params = dataclasses.replace(
        PatchMatchParams().with_depth_range(*cams[0].depth_range.tolist()),
        rect_ncc=True, rect_init=iwin > 0, rect_init_win=iwin or 384,
        sphere_live_n=SR.sphere_live_tile_count(cams[0]),
        rect_tap_pack=packs, rect_backmap_pack=packs)
    imgs = torch.as_tensor(images, device=device)
    inputs = PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0], src_cams=src,
        src_valid=torch.ones(n_src, dtype=torch.bool, device=device),
        depth_range=cams[0].depth_range)
    return inputs, params, depths, normals


def sphere_band_errors(depth: np.ndarray, gt: np.ndarray, cam) -> dict:
    """Median relative depth error of an equirect depth map over the
    latitude band that ``LAT_CAP_DEG`` leaves (|lat| <= the cap) and over
    the pole band beyond it, from the camera's own latitude of each row."""
    H = depth.shape[0]
    cy = float(cam.params[2])
    lat = -(np.arange(H) - cy) / H * 180.0
    band = np.abs(lat) <= SR.LAT_CAP_DEG
    rel = np.abs(depth - gt) / gt
    return {"band": float(np.median(rel[band])),
            "pole": float(np.median(rel[~band])),
            "band_rows": int(band.sum())}


def golden_geom_fields(depths, normals):
    """numpy inputs of the golden geometric pass
    (tests/fixtures/golden_geom_pass_stats_rect.json) from the rendered
    depths (V, H, W) and world normals (V, H, W, 3): source depths
    GT x (1 + 0.01 cos(i)), seed depth GT x (1 + 0.01 sin(i)), seed normals
    GT, with i the flat pixel index of each map.  Returns (src_depths,
    seed_depth, seed_normal_world), float32."""
    H, W = depths.shape[1:]
    i = np.arange(H * W, dtype=np.float64).reshape(H, W)
    return ((depths[1:] * (1.0 + 0.01 * np.cos(i))).astype(np.float32),
            (depths[0] * (1.0 + 0.01 * np.sin(i))).astype(np.float32),
            normals[0].astype(np.float32))


def golden_geom_problem(device):
    """The 96x64x3src golden ring set up for its geometric pass (key
    ``GOLDEN_KEY``).  Returns (inputs with src_depths, geom params, seed
    keyword arguments of run_patchmatch, ground-truth depths)."""
    inputs, params, depths, normals = make_problem(**GOLDEN_SCENE,
                                                   device=device)
    src, seed_d, seed_n = golden_geom_fields(depths, normals)
    t = lambda a: torch.as_tensor(a, device=device)
    inputs = dataclasses.replace(inputs, src_depths=t(src))
    seeds = dict(seed_normal_world=t(seed_n), seed_depth=t(seed_d))
    return inputs, params.with_geom(multi_geometry=False), seeds, depths


def golden_prior_pass(inputs: PatchMatchInputs, params, key: int = GOLDEN_KEY):
    """The golden planar-prior pass (tests/fixtures/golden_prior_pass_stats_*
    .json), as the pass runner chains it: a photometric pass (``key``), the
    planar prior built from its depth and cost over the working range, then
    the prior pass from its state with ``fold_in(key, 1)``.  Returns the
    prior pass's (depth, normal_world, cost, state)."""
    inputs = prepare_inputs(inputs, params)
    depth, _, cost, state = run_patchmatch(inputs, params, key)
    dmin, dmax = inputs.depth_range.cpu().numpy()
    prior_normal, prior_w, mask, _ = build_planar_prior(
        inputs.ref_cam, depth.cpu().numpy(), cost.cpu().numpy(), dmin, dmax,
        PriorConfig())
    t = lambda a: torch.as_tensor(a, device=depth.device)
    prior_inputs = dataclasses.replace(
        inputs, prior_normal=t(prior_normal), prior_w=t(prior_w),
        prior_mask=t(mask))
    return run_patchmatch(prior_inputs, params.with_planar_prior(),
                          R.fold_in(R.key(key), 1), prev_state=state)


def golden_hier_pass(inputs: PatchMatchInputs, params, depths, normals,
                     key: int = GOLDEN_KEY):
    """The golden hierarchy pass (tests/fixtures/golden_hier_pass_stats_rect
    .json): seeded from ``golden_geom_fields``' seed depth and normals, on
    the photometric costs, with the hierarchy commit guard."""
    _, seed_d, seed_n = golden_geom_fields(depths, normals)
    t = lambda a: torch.as_tensor(a, device=inputs.ref_image.device)
    return run_patchmatch(inputs, params.with_hierarchy(), key,
                          seed_normal_world=t(seed_n), seed_depth=t(seed_d))


def source_depths(inputs: PatchMatchInputs, params, key_base: int = 1000):
    """(S, H, W): each source view's own photometric pass (key
    ``key_base + i`` for view i, every other view of the scene as its
    sources), the geometric pass's source depths (the reference exchanges
    the previous pass's depth maps, ACMMP.cpp:653-678)."""
    S = inputs.src_images.shape[0]
    cams = [inputs.ref_cam] + [camera_index(inputs.src_cams, j)
                               for j in range(S)]
    imgs = torch.cat([inputs.ref_image[None], inputs.src_images])
    depths = []
    for i in range(1, S + 1):
        others = [j for j in range(S + 1) if j != i]
        view = PatchMatchInputs(
            ref_image=imgs[i], src_images=imgs[others], ref_cam=cams[i],
            src_cams=stack_cameras([cams[j] for j in others]),
            src_valid=inputs.src_valid, depth_range=cams[i].depth_range)
        depths.append(run_patchmatch(view, params, key_base + i)[0])
    return torch.stack(depths)


def timed_passes(fn, reps: int, key0: int):
    """Pass times (s) of ``fn(key0 + 1 + r)`` for r < ``reps`` after a warm
    ``fn(key0)``; returns (warm seconds, times, the last output)."""
    t0 = time.perf_counter()
    fn(key0)
    torch.cuda.synchronize()
    warm = round(time.perf_counter() - t0, 1)
    times = []
    for r in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(key0 + 1 + r)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return warm, times, out


def median_rel_err(depth, gt) -> float:
    """Median relative depth error inside an 8-pixel border."""
    g = gt[8:-8, 8:-8]
    return float(np.median(np.abs(depth.cpu().numpy()[8:-8, 8:-8] - g) / g))


def pinhole_section(dev, reps: int, packs: bool):
    """The 1024x768x8src photometric pass (key 0 warm, 1..reps timed) and
    the geometric pass seeded from its last run (key 100 warm, 101..
    timed) with each view's own photometric pass (keys 1000 + i) as its
    source depths, as root bench.py:194-248.  Returns {times, err,
    geom_times, geom_err, compile_s}."""
    inputs, params, gt, _ = make_problem(**BENCH_SCENE, device=dev,
                                         packs=packs)
    warm, times, out = timed_passes(
        lambda k: run_patchmatch(inputs, params, k), reps, 0)
    geom_inputs = dataclasses.replace(
        inputs, src_depths=source_depths(inputs, params))
    geom_params = params.with_geom(multi_geometry=False)
    seed = dict(seed_normal_world=out[1], seed_depth=out[0])
    gwarm, gtimes, gout = timed_passes(
        lambda k: run_patchmatch(geom_inputs, geom_params, k, **seed), reps,
        100)
    res = dict(times=times, err=median_rel_err(out[0], gt[0]),
               geom_times=gtimes, geom_err=median_rel_err(gout[0], gt[0]),
               compile_s={"photometric": warm, "geom": gwarm})
    print(f"[bench] packs={packs} {res}", file=sys.stderr)
    return res


def sphere_section(dev, reps: int, packs: bool):
    """The spherical passes of the bench (equirect ring 1024x512x6src,
    pole-rotated path), as root bench.py:250-357: the photometric pass (key
    0 warm, 1..reps timed) and the geometric pass seeded from its last run
    (key 50 warm, 51.. timed) with each view's own photometric pass (keys
    2000 + i) as its source depths.  Returns {times, err, geom_times,
    geom_err, compile_s}, the errors over the latitude band."""
    inputs, params, gt, _ = make_sphere_problem(**SPHERE_BENCH_SCENE,
                                                device=dev, packs=packs)
    warm, times, out = timed_passes(
        lambda k: run_patchmatch(inputs, params, k), reps, 0)
    err = sphere_band_errors(out[0].cpu().numpy(), gt[0], inputs.ref_cam)
    geom_inputs = dataclasses.replace(inputs, src_depths=source_depths(
        inputs, params, key_base=2000))
    geom_params = params.with_geom(multi_geometry=False)
    seed = dict(seed_normal_world=out[1], seed_depth=out[0])
    gwarm, gtimes, gout = timed_passes(
        lambda k: run_patchmatch(geom_inputs, geom_params, k, **seed), reps,
        50)
    gerr = sphere_band_errors(gout[0].cpu().numpy(), gt[0], inputs.ref_cam)
    print(f"[bench] sphere packs={packs} init_win={params.rect_init_win} "
          f"live_n={params.sphere_live_n} pass times: {times}, {err}; geom "
          f"pass times {gtimes}, {gerr}", file=sys.stderr)
    return dict(times=times, err=err["band"], geom_times=gtimes,
                geom_err=gerr["band"],
                compile_s={"sphere": warm, "sphere_geom": gwarm})


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the port's bench needs a CUDA device")
    W, H, n_src, reps = (BENCH_SCENE["width"], BENCH_SCENE["height"],
                         BENCH_SCENE["n_src"], 3)
    dev = torch.device("cuda", 0)
    print(f"[bench] device: {torch.cuda.get_device_name(0)}", file=sys.stderr)
    res, compile_s = {}, {}
    for packs, tag in ((False, ""), (True, "_pk")):
        pin = pinhole_section(dev, reps, packs)
        sph = sphere_section(dev, reps, packs)
        if not packs:
            compile_s = {**pin["compile_s"], **sph["compile_s"]}
        res.update({
            "value" + tag: round(1.0 / min(pin["times"]), 4),
            "err" + tag: pin["err"],
            "geom_value" + tag: round(1.0 / min(pin["geom_times"]), 4),
            "geom_err" + tag: pin["geom_err"],
            "sphere_value" + tag: round(1.0 / min(sph["times"]), 4),
            "sphere_err" + tag: sph["err"],
            "sphere_geom_value" + tag: round(1.0 / min(sph["geom_times"]), 4),
            "sphere_geom_err" + tag: sph["geom_err"]})
    value = res["value"]
    print(json.dumps({
        "metric": "depth_maps_per_s_per_chip",
        "value": value,
        "unit": f"{W}x{H}x{n_src}src photometric passes/s",
        "vs_baseline": round(value / BASELINE_PASSES_PER_S, 4),
        "geom_unit": f"{W}x{H}x{n_src}src geometric passes/s",
        "sphere_unit": "1024x512x6src spherical photometric passes/s",
        "sphere_geom_unit": "1024x512x6src spherical geometric passes/s",
        **res,
        "compile_s": compile_s,
    }))


if __name__ == "__main__":
    main()
