"""The coarse-to-fine pipeline (counterpart of
acmmp_spherical_tpu/pipeline/multiscale.py; reference ``main()``,
main.cpp:392-482): per-image pyramid settings, then per scale a photometric
pass (a hierarchy pass after a JBU depth upsample on later scales) with its
planar-prior round, then ``geom_iterations`` geometric passes; finally all
views are fused into a coloured point cloud.

Passes run one problem after the other on one device, or in chunks over a
mesh of device slots (``cfg.batch_problems``, ``pipeline/batch_runner``),
or one problem after the other with each depth map cut into width tiles
over a mesh of slots (``cfg.tile_shard``, ``parallel/tile.py``; exact
path, no batching).
When a batched pass fails, the failure is logged and the problems whose
files it had not yet written run serially.  A problem that fails within
its writes leaves some of its files rewritten, and its serial rerun may
then read them as its seed, so the result can differ from a serial run's.
A failed multi-geometry pass re-raises instead: it reads the depths it
rewrites, and its outputs depend on the order.  Each (pass, view) that
completes is recorded in the manifest, so ``skip_if_complete`` resumes a
run; a serial pass that fails is retried once on the same device and then
the view is skipped (fusion and the later passes tolerate its missing
files).

Several processes (the CLI's ``--distributed``, which starts a
``torch.distributed`` process group) split a scene round-robin: rank ``r``
of ``n`` runs problems ``r, r + n, ...`` of every pass and JBU step, the
ranks meet at a barrier after each, and rank 0 alone fuses.  Depth maps
cross between ranks through the scene folder, the reference's own exchange
(ACMMP.cpp:653-678).  A multi-geometry pass runs in waves
(``pass_runner.exchange_waves``) with a barrier after each, so every rank
reads the depths the serial order reads and the outputs equal a
one-process run's.
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
    _pad_stack, camera_to, compute_scene_rect_settings, exchange_waves,
    process_problem,
)
from acmmp_spherical_torch.utils.log import Timings, get_logger

log = get_logger(__name__)


def process_group() -> tuple[int, int]:
    """(rank, world size) of the started ``torch.distributed`` group, or
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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


def fusion_inputs(sp: ScenePaths, problems: Sequence[Problem],
                  cfg: PipelineConfig, *, geom: bool = True, device="cuda"):
    """Every view's final depths, normals and colours, padded and stacked
    on ``device``, its cameras at the depths' size and the source indices
    (V, K) of ``fuse_all_views``; None when no view has results."""
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
        return None

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
    return (t(dstack), t(nstack), t(cstack),
            camera_to(stack_cameras(cams), device), src_idx)


def run_fusion(sp: ScenePaths, problems: Sequence[Problem],
               cfg: PipelineConfig, *, geom: bool = True,
               device="cuda") -> int:
    """Load every view's final results and fuse them (RunFusionCuda analog,
    ACMMP.cu:1817-2105).  Returns the number of fused points."""
    inputs = fusion_inputs(sp, problems, cfg, geom=geom, device=device)
    if inputs is None:
        log.warning("fusion: nothing to fuse")
        return 0
    pts, nrm, col = fuse_all_views(*inputs, cfg.fusion)
    sp.output_dir.mkdir(parents=True, exist_ok=True)
    write_ply(sp.ply_file(), pts, nrm, col)
    log.info("fusion wrote %d points -> %s", len(pts), sp.ply_file())
    return len(pts)


def run_pipeline(root, cfg: PipelineConfig = PipelineConfig(), *,
                 device="cuda", mesh=None, tile_mesh=None,
                 timings: Optional[Timings] = None) -> int:
    """Full coarse-to-fine reconstruction of a scene folder on ``device``;
    returns the fused point count (0 on ranks other than 0).  Per scale: a
    photometric pass (a hierarchy pass after the first scale) with its
    planar-prior round, then ``geom_iterations`` geometric passes (the
    second with multi_geometry).  Batched passes (``cfg.batch_problems``)
    run over ``mesh`` (default: every local CUDA device in a one-process
    run, else ``device`` alone).  With ``cfg.tile_shard > 1``, or a
    ``tile_mesh`` given, every pass cuts its depth map into width tiles
    over ``tile_mesh`` (default: ``cfg.tile_shard`` slots over the local
    CUDA devices in a one-process run, else slots of ``device``), on the
    exact path, and batching is off.  ``timings`` (optional) collects the wall
    time per pass kind and scale (``photometric_s1``, ``geom0_s0``, ...;
    per problem, or per batched pass), per JBU pass, per fusion and the
    ``load``, ``prior_build`` and ``write`` scopes of the passes (and the
    ``load_wait`` scope of batched ones), and the spans inside the passes
    (``process_problem`` and the batched slots make it current)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_pipeline: device cuda asked for, but CUDA is "
                           "not available (pass device='cpu' to run on the "
                           "CPU)")
    timings = Timings() if timings is None else timings
    sp = ScenePaths(root)
    problems = read_pair_file(sp.pair_file)
    sp.output_dir.mkdir(parents=True, exist_ok=True)
    rank, world = process_group()
    log.info("%d problems on %s, rank %d of %d", len(problems), device, rank,
             world)

    def barrier(name: str) -> None:
        if world > 1:
            import torch.distributed as dist

            log.info("barrier %s", name)
            dist.barrier()

    local_devices = None if device.type == "cuda" and world == 1 \
        else [device]
    if tile_mesh is None and cfg.tile_shard > 1:
        from acmmp_spherical_torch.parallel.tile import make_tile_mesh

        tile_mesh = make_tile_mesh(cfg.tile_shard, devices=local_devices)
    if tile_mesh is not None:
        log.info("tile-parallel passes: width tiles over %d slots %s (exact "
                 "path; batching off)", tile_mesh.size,
                 [str(d) for d in tile_mesh.devices])
    batched = tile_mesh is None and (cfg.batch_problems == "on" or (
        cfg.batch_problems == "auto" and device.type == "cuda" and world == 1
        and torch.cuda.device_count() > 1))
    if batched:
        from acmmp_spherical_torch.parallel.mesh import make_view_mesh
        from acmmp_spherical_torch.pipeline.batch_runner import (
            run_pass_batched,
        )

        if mesh is None:
            mesh = make_view_mesh(devices=local_devices)
        log.info("batched passes over %d slots: %s", mesh.size,
                 [str(d) for d in mesh.devices])

    def run_one(idx, pass_name, **kw):
        pid = problems[idx].ref_image_id
        # outputs are idempotent: a failed pass is run once more on the
        # same device, then the view is skipped
        for attempt in range(2):
            try:
                with timings.scope(pass_name):
                    process_problem(sp, problems, idx, cfg, device=device,
                                    timings=timings, tile_mesh=tile_mesh,
                                    **kw)
                mark_pass_complete(sp, pass_name, pid)
                return
            except Exception:
                log.exception("pass %s image=%08d failed%s", pass_name, pid,
                              "; retrying" if attempt == 0
                              else " twice; skipping the view")

    def run_batched(order, pass_name, **kw) -> list:
        """Run ``order`` batched; returns the problems left for the serial
        path: none, or after a failure those not yet written (a
        multi-geometry pass re-raises instead)."""
        written = set()

        def on_written(i):
            written.add(i)
            mark_pass_complete(sp, pass_name, problems[i].ref_image_id)

        try:
            with timings.scope(pass_name):
                run_pass_batched(sp, problems, order, cfg, mesh=mesh,
                                 timings=timings, on_written=on_written,
                                 **kw)
        except Exception:
            if kw.get("multi_geometry"):
                raise
            log.exception("batched pass %s failed; falling back to serial "
                          "execution of its %d unwritten problems",
                          pass_name, len(order) - len(written))
            return [i for i in order if i not in written]
        return []

    def run_all(tag, scale, **kw):
        pass_name = f"{tag}_s{scale}"
        # a multi-geometry pass reads the depths it rewrites: across ranks
        # its problems run in waves that keep the serial order's exchange
        waves = (exchange_waves(problems, cfg)
                 if world > 1 and kw.get("multi_geometry")
                 else [range(len(problems))])
        for w, wave in enumerate(waves):
            order = [i for i in wave if i % world == rank
                     and not (cfg.skip_if_complete and is_pass_complete(
                         sp, pass_name, problems[i].ref_image_id))]
            if cfg.skip_if_complete:
                log.info("%s: %d problems to run", pass_name, len(order))
            if batched and order:
                order = run_batched(order, pass_name, **kw)
            for i in order:
                run_one(i, pass_name, **kw)
            if w + 1 < len(waves):
                barrier(f"{pass_name} wave {w}")
        barrier(pass_name)

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
            for p in problems[rank::world]:
                with timings.scope(f"jbu_s{scale}"):
                    joint_bilateral_upsampling_pass(sp, p, p.cur_image_size,
                                                    device)
            barrier(f"jbu_s{scale}")
            run_all("hierarchy", scale, planar_prior=cfg.planar_prior,
                    hierarchy=True)
        for gi in range(cfg.geom_iterations):
            run_all(f"geom{gi}", scale, geom=True, multi_geometry=gi > 0)

    n = 0
    if rank == 0:
        with timings.scope("fusion"):
            n = run_fusion(sp, problems, cfg, geom=True, device=device)
    barrier("fusion")
    log.info("pipeline timings: %s", timings.summary())
    return n
