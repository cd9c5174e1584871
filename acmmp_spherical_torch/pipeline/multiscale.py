"""The coarse-to-fine pipeline (counterpart of
acmmp_spherical_tpu/pipeline/multiscale.py; reference ``main()``,
main.cpp:392-482): per-image pyramid settings, then per scale a photometric
pass (a hierarchy pass after a JBU depth upsample on later scales) with its
planar-prior round, then ``geom_iterations`` geometric passes; finally all
views are fused into a coloured point cloud.

Passes run one problem after the other on one device.  Each (pass, view)
that completes is recorded in the manifest, so ``skip_if_complete`` resumes
a run; a pass that fails is retried once on the same device and then the
view is skipped (fusion and the later passes tolerate its missing files).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from acmmp_spherical_torch.config import PipelineConfig
from acmmp_spherical_torch.core.camera import scale_camera, stack_cameras
from acmmp_spherical_torch.io import dmb
from acmmp_spherical_torch.io.ply import write_ply
from acmmp_spherical_torch.io.scene import (
    Problem, ScenePaths, image_size, is_pass_complete, load_image_color,
    load_image_gray, mark_pass_complete, read_camera_file, read_pair_file,
    resize_linear,
)
from acmmp_spherical_torch.ops.fusion import fuse_all_views
from acmmp_spherical_torch.ops.jbu import joint_bilateral_upsample
from acmmp_spherical_torch.pipeline.pass_runner import (
    _pad_stack, camera_to, compute_scene_rect_settings, process_problem,
)
from acmmp_spherical_torch.utils.log import Timings, get_logger

log = get_logger(__name__)


def compute_multiscale_settings(sp: ScenePaths, problems: Sequence[Problem],
                                cfg: PipelineConfig) -> int:
    """Per-image pyramid depth (reference ComputeMultiScaleSettings,
    main.cpp:35-71).  Returns the largest number of downscales."""
    max_k = -1
    for p in problems:
        max_size = min(max(image_size(str(sp.image_file(p.ref_image_id)))),
                       cfg.patchmatch.max_image_size)
        p.max_image_size = max_size
        k = 0
        while max_size > cfg.size_bound:
            max_size //= 2
            k += 1
        p.num_downscale = k
        max_k = max(max_k, k)
    return max_k


def joint_bilateral_upsampling_pass(sp: ScenePaths, problem: Problem,
                                    target_size: int, device="cuda") -> None:
    """Upsample depths_geom.dmb to the next scale's resolution into the
    depths.dmb seed (reference JointBilateralUpsampling, main.cpp:212-238,
    and RunJBU, ACMMP.cpp:1071-1122).  A view whose previous pass was
    skipped has no depth: it is left out, and its next pass starts from a
    random field."""
    dpath = sp.depth_file(problem.ref_image_id, geom=True)
    try:
        depth = dmb.read_depth_dmb(dpath)
    except (OSError, ValueError):
        log.warning("JBU skip (missing/unreadable %s) image=%08d", dpath,
                    problem.ref_image_id)
        return
    img = load_image_gray(sp.image_file(problem.ref_image_id))
    h, w = img.shape
    factor = min(target_size / w, target_size / h)
    nw, nh = round(w * factor), round(h * factor)
    guide = resize_linear(img, nw, nh)
    if max(nh // depth.shape[0], nw // depth.shape[1]) == 1:
        log.info("JBU skip (scale ratio 1) image=%08d", problem.ref_image_id)
        return
    up = joint_bilateral_upsample(torch.from_numpy(depth).to(device),
                                  torch.from_numpy(guide).to(device))
    dmb.write_dmb(sp.depth_file(problem.ref_image_id, geom=False),
                  up.cpu().numpy())


def run_fusion(sp: ScenePaths, problems: Sequence[Problem],
               cfg: PipelineConfig, *, geom: bool = True,
               device="cuda") -> int:
    """Load every view's final results and fuse them (RunFusionCuda analog,
    ACMMP.cu:1817-2105).  Returns the number of fused points."""
    depths, normals, colors, cams, ids = [], [], [], [], []
    for p in problems:
        dpath = sp.depth_file(p.ref_image_id, geom=geom)
        npath = sp.normal_file(p.ref_image_id)
        if not dpath.exists() or not npath.exists():
            log.warning("fusion: missing results for %08d, skipping",
                        p.ref_image_id)
            continue
        depth = dmb.read_depth_dmb(dpath)
        img = load_image_color(sp.image_file(p.ref_image_id))
        h, w = depth.shape
        # RescaleImageAndCamera: image and intrinsics at the depth's size
        sy, sx = h / img.shape[0], w / img.shape[1]
        if img.shape[:2] != (h, w):
            img = resize_linear(img, w, h)
        cam = read_camera_file(sp.camera_file(p.ref_image_id), device="cpu")
        ids.append(p.ref_image_id)
        depths.append(depth)
        normals.append(dmb.read_normal_dmb(npath))
        colors.append(img.astype(np.float32))
        cams.append(scale_camera(cam, sx, sy, w, h))
    if not depths:
        log.warning("fusion: nothing to fuse")
        return 0

    # up to fusion.max_src_views sources per reference view (reference
    # FusionProblem, ACMMP.cu:1656-1661, 2000-2017), whatever cap the
    # PatchMatch stacks had
    id_to_index = {im_id: i for i, im_id in enumerate(ids)}
    K = cfg.fusion.max_src_views
    src_idx = np.full((len(ids), K), -1, np.int32)
    for row, p in enumerate(q for q in problems
                            if q.ref_image_id in id_to_index):
        srcs = [id_to_index[s] for s in p.src_image_ids if s in id_to_index]
        src_idx[row, : min(K, len(srcs))] = srcs[:K]

    dstack = _pad_stack(depths)
    hp, wp = dstack.shape[1:]
    nstack = np.zeros((len(ids), hp, wp, 3), np.float32)
    cstack = np.zeros((len(ids), hp, wp, 3), np.float32)
    for i, (nr, co) in enumerate(zip(normals, colors)):
        nstack[i, : nr.shape[0], : nr.shape[1]] = nr
        cstack[i, : co.shape[0], : co.shape[1]] = co
    t = lambda a: torch.from_numpy(a).to(device)
    pts, nrm, col = fuse_all_views(
        t(dstack), t(nstack), t(cstack),
        camera_to(stack_cameras(cams), device), src_idx, cfg.fusion)
    sp.output_dir.mkdir(parents=True, exist_ok=True)
    write_ply(sp.ply_file(), pts, nrm, col)
    log.info("fusion wrote %d points -> %s", len(pts), sp.ply_file())
    return len(pts)


def run_pipeline(root, cfg: PipelineConfig = PipelineConfig(), *,
                 device="cuda", timings: Optional[Timings] = None) -> int:
    """Full coarse-to-fine reconstruction of a scene folder on ``device``;
    returns the fused point count.  Per scale: a photometric pass (a
    hierarchy pass after the first scale) with its planar-prior round, then
    ``geom_iterations`` geometric passes (the second with multi_geometry).
    ``timings`` (optional) collects the wall time per pass kind and scale
    (``photometric_s1``, ``geom0_s0``, ...), per JBU pass, per fusion and
    the ``load``, ``prior_build`` and ``write`` scopes of the passes."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_pipeline: device cuda asked for, but CUDA is "
                           "not available (pass device='cpu' to run on the "
                           "CPU)")
    timings = Timings() if timings is None else timings
    sp = ScenePaths(root)
    problems = read_pair_file(sp.pair_file)
    sp.output_dir.mkdir(parents=True, exist_ok=True)
    log.info("%d problems on %s", len(problems), device)

    def run_one(idx, pass_name, **kw):
        pid = problems[idx].ref_image_id
        # outputs are idempotent: a failed pass is run once more on the
        # same device, then the view is skipped
        for attempt in range(2):
            try:
                with timings.scope(pass_name):
                    process_problem(sp, problems, idx, cfg, device=device,
                                    timings=timings, **kw)
                mark_pass_complete(sp, pass_name, pid)
                return
            except Exception:
                log.exception("pass %s image=%08d failed%s", pass_name, pid,
                              "; retrying" if attempt == 0
                              else " twice; skipping the view")

    def run_all(tag, scale, **kw):
        pass_name = f"{tag}_s{scale}"
        order = [i for i in range(len(problems))
                 if not (cfg.skip_if_complete and is_pass_complete(
                     sp, pass_name, problems[i].ref_image_id))]
        if cfg.skip_if_complete:
            log.info("%s: %d problems to run", pass_name, len(order))
        for i in order:
            run_one(i, pass_name, **kw)

    max_k = compute_multiscale_settings(sp, problems, cfg)
    base_cfg = cfg
    for scale in range(max_k, -1, -1):
        log.info("=== scale %d ===", scale)
        for p in problems:
            if p.num_downscale >= 0:
                p.cur_image_size = p.max_image_size // (2 ** p.num_downscale)
                p.num_downscale -= 1
        cfg = dataclasses.replace(
            base_cfg,
            rect_unify=compute_scene_rect_settings(sp, problems, base_cfg))
        log.info("scale %d unified rect settings: %s", scale, cfg.rect_unify)
        if scale == max_k:
            run_all("photometric", scale, planar_prior=cfg.planar_prior)
        else:
            for p in problems:
                with timings.scope(f"jbu_s{scale}"):
                    joint_bilateral_upsampling_pass(sp, p, p.cur_image_size,
                                                    device)
            run_all("hierarchy", scale, planar_prior=cfg.planar_prior,
                    hierarchy=True)
        for gi in range(cfg.geom_iterations):
            run_all(f"geom{gi}", scale, geom=True, multi_geometry=gi > 0)

    with timings.scope("fusion"):
        n = run_fusion(sp, problems, cfg, geom=True, device=device)
    log.info("pipeline timings: %s", timings.summary())
    return n
