"""Per-image pass runner: the host orchestration of one PatchMatch pass
(counterpart of acmmp_spherical_tpu/pipeline/pass_runner.py; reference
``ProcessProblem``, main.cpp:73-210, and ``InuputInitialization`` /
``CudaSpaceInitialization``, ACMMP.cpp:567-845).

Load and rescale the view cluster, move it to the device, run the
(optionally seeded) pass, run the planar-prior second round when asked, and
write depth, normal and cost as ``.dmb``.  Pinhole and SPHERE scenes.
Source views are padded to a scene-wide even count, as in the reference, so
every problem of a scale has the same source axis.

A load decodes its images and reads its ``.dmb`` files on one thread pool
shared by every caller (OpenCV's decoder and the native reader release the
interpreter lock), straight into the stacks it uploads; for a CUDA device
those are page-locked and uploaded without the host waiting, so the pass's
first kernels follow the copies on the stream (the few bytes of cameras,
source mask and depth range are copied first, from pageable memory, since
such a copy waits for the stream).  PyTorch's caching host
allocator reuses a page-locked block only once the copies out of it have
ended.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Optional, Sequence

import numpy as np
import torch

from acmmp_spherical_torch.config import PatchMatchParams, PipelineConfig
from acmmp_spherical_torch.core.camera import (
    Camera, PINHOLE, SPHERE, scale_camera, stack_cameras,
)
from acmmp_spherical_torch.io import dmb
from acmmp_spherical_torch.io.scene import (
    Problem, ScenePaths, decode_gray, image_size, read_camera_file,
    resize_linear, write_image,
)
from acmmp_spherical_torch.ops import rectify as RT
from acmmp_spherical_torch.ops import rng as R
from acmmp_spherical_torch.ops import sphere_rect as SR
from acmmp_spherical_torch.ops.jbu import joint_bilateral_upsample
from acmmp_spherical_torch.ops.propagate import (
    PatchMatchInputs, prepare_inputs,
)
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
from acmmp_spherical_torch.pipeline.prior import (
    build_planar_prior, draw_triangulation,
)
from acmmp_spherical_torch.utils.log import Timings, get_logger, span

log = get_logger(__name__)

# bytes the loads have uploaded, by the route of their host buffer:
# "pinned" (page-locked, not waited for) or "pageable" (waited for)
LOAD_BYTES = {"pinned": 0, "pageable": 0}
_LOAD_LOCK = threading.Lock()
_READ_POOL: Optional[ThreadPoolExecutor] = None


@dataclasses.dataclass(frozen=True)
class RectUnify:
    """Scene-wide rect-kernel settings of one scale (the reference's
    ``rect_unify`` tuple).  Pinhole entries (None without a rectifiable
    pinhole problem): the max over the rectifiable problems of the compute
    grid and live-tile budget, the init window (0 if any problem needs the
    exact init), the warp window (None if any problem has none) and the AND
    of the attribution gate.  SPHERE entries (None without a rectifiable
    SPHERE problem): the init window, reduced the same way, and the max
    live-tile budget.  ``failed``: the problems whose derivation failed
    (they derive their own settings)."""

    comp_hw: Optional[tuple]
    live_n: Optional[int]
    init_win: Optional[int]
    warp_hw: Optional[tuple]
    inv_attrib: bool
    failed: frozenset
    sphere_init_win: Optional[int] = None
    sphere_live_n: Optional[int] = None


def _min_window(a: Optional[int], b: int) -> int:
    """Reduce two init windows: 0 (the exact init) wins, else the widest."""
    return b if a is None else (0 if 0 in (a, b) else max(a, b))


def camera_to(cam: Camera, device) -> Camera:
    return dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).to(device)
        for f in dataclasses.fields(cam) if f.name != "model"})


def _rescaled_hw(h: int, w: int, max_size: int) -> tuple[int, int]:
    """(h, w) of an image after the downscale to ``max_size``
    (ACMMP.cpp:605-643)."""
    if w > max_size or h > max_size:
        factor = min(max_size / w, max_size / h)
        return round(h * factor), round(w * factor)
    return h, w


def _rescale(cam: Camera, h: int, w: int, max_size: int):
    """The camera of an (h, w) image after the downscale to ``max_size``
    (ACMMP.cpp:605-643), and the new (h, w)."""
    cam = scale_camera(cam, 1.0, 1.0, w, h)
    nh, nw = _rescaled_hw(h, w, max_size)
    if (nh, nw) != (h, w):
        return scale_camera(cam, nw / w, nh / h, nw, nh), nh, nw
    return cam, h, w


def _read_pool() -> ThreadPoolExecutor:
    """The loads' thread pool, one per process and shared by every caller
    (a batched pass's loader thread and slots too), made at first use with
    a thread per core."""
    global _READ_POOL
    with _LOAD_LOCK:
        if _READ_POOL is None:
            _READ_POOL = ThreadPoolExecutor(max_workers=os.cpu_count() or 1,
                                            thread_name_prefix="pass-read")
        return _READ_POOL


def _run_all(jobs: Sequence) -> None:
    """Call each of ``jobs`` (decodes, file reads and fills, which release
    the interpreter lock) on the read pool, or in the calling thread where
    there is one job.  Every job has ended before an error is raised, so
    none writes into a buffer after."""
    if len(jobs) <= 1:
        for job in jobs:
            job()
        return
    futures = [_read_pool().submit(job) for job in jobs]
    wait(futures)
    for f in futures:
        f.result()


def _host_buffer(shape, device: torch.device) -> torch.Tensor:
    """An uninitialised float32 host buffer, page-locked for a CUDA
    device."""
    return torch.empty(tuple(shape), dtype=torch.float32,
                       pin_memory=device.type == "cuda")


def _fill(slot: np.ndarray, a: np.ndarray) -> None:
    """``a`` into the top left of ``slot`` as float32, the rest zero."""
    h, w = a.shape
    slot[:h, :w] = a
    slot[h:] = 0
    slot[:h, w:] = 0


def _read_view_into(slot: np.ndarray, path: str, hw: tuple,
                    max_size: int) -> None:
    """One view's grayscale pixels at ``max_size`` (ACMMP.cpp:576-643) into
    its slot, the rest zero; ``hw`` is the file's (h, w) as ``image_size``
    gave it, from which the stack and the camera were sized."""
    img = decode_gray(path)
    if img.shape != hw:
        raise ValueError(f"{path}: {img.shape} pixels, {hw} when first read")
    nh, nw = _rescaled_hw(*hw, max_size)
    if (nh, nw) != hw:
        img = resize_linear(img.astype(np.float32), nw, nh)
    _fill(slot, img)


def _stack_hw(shapes) -> tuple[int, int]:
    """The (Hp, Wp) a stack pads its 2D arrays to; an absent array (None)
    counts as the 1x1 zero map it stands for."""
    shapes = [s or (1, 1) for s in shapes]
    return (max((s[0] for s in shapes), default=1),
            max((s[1] for s in shapes), default=1))


def _read_depth_into(slot: np.ndarray, path, shape) -> None:
    """A source's depth map into its slot of the depth stack, the rest
    zero; an absent file (``shape`` None) leaves the slot zero."""
    if shape is None:
        slot[:] = 0
    elif tuple(shape) == slot.shape:
        dmb.read_into(path, slot)
    else:
        a = np.empty(shape, np.float32)
        dmb.read_into(path, a)
        _fill(slot, a)


def _upload(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``buf`` on ``device``, its bytes counted in ``LOAD_BYTES`` under its
    route: a page-locked buffer by a copy the host does not wait for;
    ``buf`` itself on a CPU device (nothing counted)."""
    if device.type == "cpu":
        return buf
    route = "pinned" if buf.is_pinned() else "pageable"
    with _LOAD_LOCK:
        LOAD_BYTES[route] += buf.nbytes
    return buf.to(device, non_blocking=route == "pinned")


def _depth_file(path) -> tuple:
    return path, dmb.check_depth_shape(path, dmb.read_shape(path))


def _normal_file(path) -> tuple:
    return path, dmb.check_normal_shape(path, dmb.read_shape(path))


def _read_fields(files: Sequence, device: torch.device) -> list:
    """The ``(path, shape)`` ``.dmb`` files read at once, each into a host
    buffer of its own (``_host_buffer``)."""
    bufs = [_host_buffer(shape, device) for _, shape in files]
    _run_all([functools.partial(dmb.read_into, path, buf.numpy())
              for (path, _), buf in zip(files, bufs)])
    return bufs


def _view_geometry(sp: ScenePaths, image_id: int, max_size: int):
    """(host camera, h, w) after the rescale, without keeping pixels."""
    cam = read_camera_file(sp.camera_file(image_id), device="cpu")
    return _rescale(cam, *image_size(str(sp.image_file(image_id))), max_size)


def _src_ids(problem: Problem, cfg: PipelineConfig):
    return problem.src_image_ids[: cfg.max_src_views]


def _cur_size(by_id: dict, sid: int, problem: Problem) -> int:
    return by_id[sid].cur_image_size if sid in by_id else problem.cur_image_size


def compute_scene_rect_settings(sp: ScenePaths, problems: Sequence[Problem],
                                cfg: PipelineConfig) -> Optional[RectUnify]:
    """Scene-wide rect-kernel settings for the current scale, or None when
    no problem rectifies.  The reference unifies them so every problem of a
    scale compiles to one program; the unified compute grid, tile budget,
    init window and warp window are also what the kernels of every problem
    see, so the port keeps them (a wider window or budget only adds
    coverage, but it changes which taps and tiles are evaluated)."""
    by_id = {p.ref_image_id: p for p in problems}
    comp = live = iwin = warp = iwin_s = live_s = None
    warp_none = False
    inv_ok = True
    failed = set()
    for problem in problems:
        try:
            ref_cam, h, w = _view_geometry(sp, problem.ref_image_id,
                                           problem.cur_image_size)
            src = [_view_geometry(sp, sid, _cur_size(by_id, sid, problem))[0]
                   for sid in _src_ids(problem, cfg)]
            if not src:
                continue
            stacked = stack_cameras(src)
            if ref_cam.model == SPHERE:
                if SR.sphere_rectifiable(ref_cam, stacked):
                    iwin_s = _min_window(iwin_s, SR.sphere_init_window(
                        ref_cam, stacked, min_scale=cfg.depth_min_scale))
                    ln = SR.sphere_live_tile_count(ref_cam)
                    live_s = ln if live_s is None else max(live_s, ln)
                continue
            rhw = RT.rect_shape(h, w)
            if not RT.host_rectifiable(ref_cam, stacked, rhw):
                continue
            chw = RT.rect_comp_shape(ref_cam, stacked, rhw)
            ln = RT.rect_live_tile_count(ref_cam, stacked, rhw, chw)
            iw = RT.rect_init_window(ref_cam, stacked, rhw,
                                     min_scale=cfg.depth_min_scale,
                                     max_scale=cfg.depth_max_scale)
            comp = chw if comp is None else (max(comp[0], chw[0]),
                                             max(comp[1], chw[1]))
            live = ln if live is None else max(live, ln)
            iwin = _min_window(iwin, iw)
            whw = RT.rect_warp_window(ref_cam, stacked, rhw)
            if whw is None:
                warp_none = True
            elif not warp_none:
                warp = whw if warp is None else (max(warp[0], whw[0]),
                                                 max(warp[1], whw[1]))
            inv_ok = inv_ok and RT.rect_inv_attrib_ok(ref_cam, stacked, rhw)
        except Exception:
            # a problem whose geometry cannot be derived is left out of the
            # reduction (and never clamped onto it): it derives its own
            failed.add(problem.ref_image_id)
            log.exception("rect settings for image %08d failed; it derives "
                          "its own settings", problem.ref_image_id)
    if comp is None and iwin_s is None:
        return None
    return RectUnify(comp_hw=comp, live_n=live, init_win=iwin,
                     warp_hw=None if warp_none else warp, inv_attrib=inv_ok,
                     failed=frozenset(failed), sphere_init_win=iwin_s,
                     sphere_live_n=live_s)


def exchange_predecessors(problems: Sequence[Problem],
                          cfg: PipelineConfig) -> dict:
    """For a multi-geometry pass: problem index -> the earlier problems it
    must follow.  Such a pass reads its source views' depths_geom.dmb,
    which the same pass rewrites, so in the serial order (main.cpp:441-446)
    a problem sees the new depths of the sources before it and the old ones
    of the sources after it.  A later problem follows an earlier one when
    either is a source of the other: it may not read the earlier one's
    depths before they are written, nor write its own before the earlier
    one has read them."""
    pos = {p.ref_image_id: i for i, p in enumerate(problems)}
    src = [{pos[s] for s in _src_ids(p, cfg) if s in pos} for p in problems]
    return {k: {j for j in range(k) if j in src[k] or k in src[j]}
            for k in range(len(problems))}


def exchange_waves(problems: Sequence[Problem],
                   cfg: PipelineConfig) -> list:
    """The problems of a multi-geometry pass in waves: a problem's wave is
    one past the last wave of the problems it follows
    (``exchange_predecessors``), so the problems of a wave may run at once
    and the pass reads what the serial order reads when the waves run one
    after the other."""
    follow = exchange_predecessors(problems, cfg)
    level: dict = {}
    for k in range(len(problems)):
        level[k] = 1 + max((level[j] for j in follow[k]), default=-1)
    waves = [[] for _ in range(1 + max(level.values(), default=-1))]
    for k in range(len(problems)):
        waves[level[k]].append(k)
    return waves


def _pad_stack(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Zero-pad 2D arrays to a common (Hp, Wp) and stack."""
    hp = max(a.shape[0] for a in arrays)
    wp = max(a.shape[1] for a in arrays)
    out = np.zeros((len(arrays), hp, wp), np.float32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0], : a.shape[1]] = a
    return out


@dataclasses.dataclass
class LoadedProblem:
    inputs: PatchMatchInputs
    ref_image_np: np.ndarray
    ref_cam: Camera          # on the host
    height: int
    width: int


def _path_params(params: PatchMatchParams, cfg: PipelineConfig, problem,
                 ref_cam, src_cams, hw, device) -> PatchMatchParams:
    """The cost path of one problem: the windowed kernel (pinhole problems)
    and the rectified kernel (pinhole problems that pass
    ``host_rectifiable``, SPHERE ones that pass ``sphere_rectifiable``),
    each on when its option says "on", or "auto" on a CUDA device."""
    on = lambda opt: opt == "on" or (opt == "auto" and device.type == "cuda")
    if cfg.fast_ncc == "on" or (on(cfg.fast_ncc) and ref_cam.model == PINHOLE):
        params = dataclasses.replace(params, fast_ncc=True)
    if not (on(cfg.rect_ncc) and src_cams):
        return params
    stacked = stack_cameras(src_cams)
    unify = cfg.rect_unify
    unified = unify is not None and problem.ref_image_id not in unify.failed
    if ref_cam.model == SPHERE:
        if not SR.sphere_rectifiable(ref_cam, stacked):
            return params
        if unified and unify.sphere_init_win is not None:
            iwin, live_s = unify.sphere_init_win, unify.sphere_live_n
        else:
            iwin = SR.sphere_init_window(ref_cam, stacked,
                                         min_scale=cfg.depth_min_scale)
            live_s = SR.sphere_live_tile_count(ref_cam)
        return dataclasses.replace(
            params, rect_ncc=True, sphere_live_n=live_s, rect_init=iwin > 0,
            rect_init_win=iwin or 384)
    rhw = RT.rect_shape(*hw)
    if not RT.host_rectifiable(ref_cam, stacked, rhw):
        return params
    if unified and unify.comp_hw is not None:
        chw = (min(unify.comp_hw[0], rhw[0]), min(unify.comp_hw[1], rhw[1]))
        live_n, iwin = unify.live_n, unify.init_win
        warp_hw, inv = unify.warp_hw, unify.inv_attrib
    else:
        iwin = RT.rect_init_window(ref_cam, stacked, rhw,
                                   min_scale=cfg.depth_min_scale,
                                   max_scale=cfg.depth_max_scale)
        chw = RT.rect_comp_shape(ref_cam, stacked, rhw)
        live_n = RT.rect_live_tile_count(ref_cam, stacked, rhw, chw)
        warp_hw = RT.rect_warp_window(ref_cam, stacked, rhw)
        inv = RT.rect_inv_attrib_ok(ref_cam, stacked, rhw)
    return dataclasses.replace(
        params, rect_ncc=True, rect_comp_hw=chw, rect_live_n=live_n,
        rect_init=iwin > 0, rect_init_win=iwin or 384, rect_warp_hw=warp_hw,
        rect_inv_attrib=inv)


def load_problem(sp: ScenePaths, problems: Sequence[Problem], idx: int,
                 cfg: PipelineConfig, *, geom: bool = False,
                 multi_geometry: bool = False, device="cuda"
                 ) -> tuple[LoadedProblem, PatchMatchParams]:
    """The device inputs and pass parameters of one problem
    (InuputInitialization analog).  The images and source depths are read
    in the span ``read`` and moved to the device in ``upload``."""
    device = torch.device(device)
    problem = problems[idx]
    by_id = {p.ref_image_id: p for p in problems}
    src_ids = _src_ids(problem, cfg)
    views = [(problem.ref_image_id, problem.cur_image_size)] + [
        (sid, _cur_size(by_id, sid, problem)) for sid in src_ids]
    n_src = len(src_ids)
    # pad to the scene-wide source count rounded up to even: padded views
    # are masked but still computed, so no more than that
    scene_max = max((min(len(p.src_image_ids), cfg.max_src_views)
                     for p in problems), default=1)
    n_pad = max(1, -(-scene_max // 2) * 2)
    files = [str(sp.image_file(i)) for i, _ in views]
    # each view's camera and (h, w) after the rescale, from the size of its
    # file (decoded once per process), so the stacks exist before a decode
    fitted = [_rescale(read_camera_file(sp.camera_file(i), device="cpu"),
                       *image_size(f), size)
              for f, (i, size) in zip(files, views)]
    ref_cam, *src_cams = [cam for cam, _, _ in fitted]
    height, width = fitted[0][1:]
    src_depths = None
    with span("read"):
        ref_image = _host_buffer((height, width), device)
        src_images = _host_buffer(
            (n_pad, *_stack_hw([hw for _, *hw in fitted[1:]])), device)
        src = src_images.numpy()
        src[n_src:] = 0
        jobs = [functools.partial(_read_view_into, slot, f, image_size(f),
                                  size)
                for slot, f, (_, size) in zip(
                    [ref_image.numpy(), *src], files, views)]
        if geom:
            # the previous pass's depth maps of every source view
            # (ACMMP.cpp:653-678); the suffix follows multi_geometry
            paths = [sp.depth_file(sid, geom=multi_geometry)
                     for sid in src_ids]
            shapes = [_depth_file(p)[1] if p.exists() else None
                      for p in paths]
            src_depths = _host_buffer((n_pad, *_stack_hw(shapes)), device)
            deps = src_depths.numpy()
            deps[n_src:] = 0
            jobs += [functools.partial(_read_depth_into, deps[k], p, s)
                     for k, (p, s) in enumerate(zip(paths, shapes))]
        _run_all(jobs)
    src_valid = np.zeros(n_pad, bool)
    src_valid[:n_src] = True
    params = _path_params(cfg.patchmatch, cfg, problem, ref_cam, src_cams,
                          (height, width), device)
    src_cams += [src_cams[0] if n_src else ref_cam] * (n_pad - n_src)
    if geom:
        params = params.with_geom(multi_geometry)

    dmin, dmax = ref_cam.depth_range.numpy()
    depth_range = np.array([cfg.depth_min_scale * dmin,
                            cfg.depth_max_scale * dmax], np.float32)
    with span("upload"):
        t = lambda a: _upload(a, device)
        # the small pageable copies first: each waits for the stream, so
        # after the page-locked ones it would wait for those too
        cams = camera_to(ref_cam, device), camera_to(
            stack_cameras(src_cams), device)
        valid = t(torch.from_numpy(src_valid))
        working_range = t(torch.from_numpy(depth_range))
        inputs = PatchMatchInputs(
            ref_image=t(ref_image), src_images=t(src_images),
            ref_cam=cams[0], src_cams=cams[1], src_valid=valid,
            depth_range=working_range,
            src_depths=None if src_depths is None else t(src_depths))
    return LoadedProblem(inputs=inputs, ref_image_np=ref_image.numpy(),
                         ref_cam=ref_cam, height=height,
                         width=width), params


def _load_seed(sp: ScenePaths, image_id: int, *, multi_geometry: bool,
               device):
    """The previous pass's fields, the seed of a geometric pass
    (CudaSpaceInitialization, ACMMP.cpp:753-785): (normal, depth)."""
    with span("read"):
        depth, normal = _read_fields(
            [_depth_file(sp.depth_file(image_id, geom=multi_geometry)),
             _normal_file(sp.normal_file(image_id))], device)
    with span("upload"):
        return _upload(normal, device), _upload(depth, device)


def _load_hierarchy_seed(sp: ScenePaths, lp: LoadedProblem, image_id: int,
                         device):
    """The coarse scale's fields, the seed of a hierarchy pass
    (ACMMP.cpp:788-844): the JBU pass between scales has written the
    full-resolution depths.dmb; the normals are still coarse and are
    upsampled here with the same guided filter (ACMMP.cu:713-779)."""
    H, W = lp.height, lp.width
    with span("read"):
        depth = _depth_file(sp.depth_file(image_id, geom=False))
        normal = _normal_file(sp.normal_file(image_id))
        if depth[1] != (H, W):
            # the JBU pass was skipped (scale ratio 1): the freshest depth
            gpath = sp.depth_file(image_id, geom=True)
            if gpath.exists() and _depth_file(gpath)[1] == (H, W):
                depth = (gpath, (H, W))
        depth, normal = _read_fields([depth, normal], device)
    with span("upload"):
        normal, depth = _upload(normal, device), _upload(depth, device)
    if normal.shape[:2] == (H, W) and depth.shape == (H, W):
        return normal, depth
    guide = torch.from_numpy(lp.ref_image_np).to(device)
    if normal.shape[:2] != (H, W):
        normal = joint_bilateral_upsample(normal, guide)
        normal = normal / torch.clamp(
            torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-12)
    if depth.shape != (H, W):
        depth = joint_bilateral_upsample(depth, guide)
    return normal, depth


def load_seeds(sp: ScenePaths, lp: LoadedProblem, image_id: int, *,
               geom: bool, hierarchy: bool, multi_geometry: bool,
               device) -> dict:
    """The seed fields of a geometric or hierarchy pass, as
    ``run_patchmatch`` keywords (a hierarchy pass's in the span
    ``hier_seed``); empty for a photometric pass."""
    device = torch.device(device)
    if geom:
        fields = _load_seed(sp, image_id, multi_geometry=multi_geometry,
                            device=device)
    elif hierarchy:
        with span("hier_seed"):
            fields = _load_hierarchy_seed(sp, lp, image_id, device)
    else:
        return {}
    return dict(zip(("seed_normal_world", "seed_depth"), fields))


def problem_key(cfg: PipelineConfig, image_id: int,
                seed: Optional[int] = None):
    """The pass key of a problem: ``fold_in(key(seed), image_id)``."""
    return R.fold_in(R.key(cfg.seed if seed is None else seed), image_id)


def main_round(inputs: PatchMatchInputs, params: PatchMatchParams, key,
               seeds: dict, shard_state=None):
    """The pass's first round, the span ``main_round``: (prepared inputs,
    depth, normal_world, cost, state); ``shard_state`` as in
    ``run_patchmatch``."""
    with span("main_round"):
        with span("context"):
            inputs = prepare_inputs(inputs, params)
        return (inputs, *run_patchmatch(inputs, params, key,
                                        shard_state=shard_state, **seeds))


def prior_build(sp: ScenePaths, lp: LoadedProblem, image_id: int, depth,
                cost, cfg: PipelineConfig, timings: Timings):
    """The Delaunay planar prior of the first round's fields, on the host
    (ACMMP.cpp:904-1011), with ``triangulation.png`` written: (normal, w,
    mask), or None when the prior is empty and the prior round is
    skipped.  Timed as ``prior_build``, with the copies of ``depth`` and
    ``cost`` to the host (a wait for the device's queue) its ``fetch``,
    ``build_planar_prior``'s spans (``support``, ``triangulate``,
    ``raster``) and ``draw``, the overlay and its PNG."""
    with timings.scope("prior_build"):
        with timings.scope("fetch"):
            depth, cost = depth.cpu().numpy(), cost.cpu().numpy()
        dmin, dmax = lp.ref_cam.depth_range.numpy()
        prior_normal, prior_w, mask, tris = build_planar_prior(
            lp.ref_cam, depth, cost, cfg.depth_min_scale * dmin,
            cfg.depth_max_scale * dmax, cfg.prior)
        with timings.scope("draw"):
            write_image(sp.result_dir(image_id) / "triangulation.png",
                        draw_triangulation(lp.ref_image_np, tris))
    return (prior_normal, prior_w, mask) if mask.any() else None


def prior_round(inputs: PatchMatchInputs, state, prior,
                params: PatchMatchParams, key, shard_state=None):
    """The second round with the planar prior (main.cpp:113-197), on the
    first round's prepared inputs and state, drawing from ``fold_in(key,
    1)``, the span ``prior_round``: (depth, normal_world, cost, state);
    ``shard_state`` as in ``run_patchmatch``."""
    t = lambda a: torch.from_numpy(a).to(inputs.ref_image.device)
    with span("prior_round"):
        prior_inputs = dataclasses.replace(
            inputs, prior_normal=t(prior[0]), prior_w=t(prior[1]),
            prior_mask=t(prior[2]))
        return run_patchmatch(prior_inputs, params.with_planar_prior(),
                              R.fold_in(key, 1), prev_state=state,
                              shard_state=shard_state)


def write_results(sp: ScenePaths, image_id: int, depth, normal_world, cost,
                  *, geom: bool, timings: Timings) -> None:
    """Write the pass's depth, normal and cost ``.dmb`` files; timed as
    ``write``, with the copies to the host its ``fetch``."""
    with timings.scope("write"):
        with timings.scope("fetch"):
            fields = [a.cpu().numpy() for a in (depth, normal_world, cost)]
        for path, a in zip((sp.depth_file(image_id, geom=geom),
                            sp.normal_file(image_id), sp.cost_file(image_id)),
                           fields):
            dmb.write_dmb(path, a)


def process_problem(sp: ScenePaths, problems: Sequence[Problem], idx: int,
                    cfg: PipelineConfig, *, geom: bool = False,
                    planar_prior: bool = False, hierarchy: bool = False,
                    multi_geometry: bool = False, seed: Optional[int] = None,
                    device="cuda", timings: Optional[Timings] = None,
                    tile_mesh=None) -> None:
    """Run one pass for one problem and write its results (ProcessProblem
    analog, main.cpp:73-210): ``main_round``, then, with the planar prior,
    ``prior_build`` and ``prior_round``, then ``write_results``.
    ``timings`` gets the ``load``, ``prior_build`` and ``write`` scopes,
    and is current for the call, so that it gets the pass's spans too
    (``utils/log.span``).
    ``tile_mesh``: both rounds cut the depth map into width tiles over the
    mesh's slots (``parallel/tile.py``), on the exact path: the windowed
    and rectified paths are turned off, as the JAX package does."""
    device = torch.device(device)
    timings = Timings() if timings is None else timings
    with timings.current():
        image_id = problems[idx].ref_image_id
        sp.result_dir(image_id).mkdir(parents=True, exist_ok=True)

        with timings.scope("load"):
            lp, params = load_problem(sp, problems, idx, cfg, geom=geom,
                                      multi_geometry=multi_geometry,
                                      device=device)
            if hierarchy:
                params = params.with_hierarchy()
            seeds = load_seeds(sp, lp, image_id, geom=geom,
                               hierarchy=hierarchy,
                               multi_geometry=multi_geometry, device=device)
        shard_state = None
        if tile_mesh is not None:
            from acmmp_spherical_torch.parallel.tile import (
                make_state_sharder,
            )

            params = dataclasses.replace(
                params, fast_ncc=False, rect_ncc=False, rect_comp_hw=None,
                rect_live_n=None, rect_init=False, rect_warp_hw=None)
            shard_state = make_state_sharder(tile_mesh)
        key = problem_key(cfg, image_id, seed)
        log.info("pass image=%08d size=%dx%d geom=%s prior=%s hier=%s "
                 "multi=%s path=%s", image_id, lp.width, lp.height, geom,
                 planar_prior, hierarchy, multi_geometry,
                 "rect" if params.rect_ncc
                 else "window" if params.fast_ncc else "exact")
        inputs, depth, normal_world, cost, state = main_round(
            lp.inputs, params, key, seeds, shard_state)
        if planar_prior:
            prior = prior_build(sp, lp, image_id, depth, cost, cfg, timings)
            if prior is not None:
                depth, normal_world, cost, state = prior_round(
                    inputs, state, prior, params, key, shard_state)
        write_results(sp, image_id, depth, normal_world, cost, geom=geom,
                      timings=timings)
