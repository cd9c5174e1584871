"""numpy -> torch converters for the state of a pass.

The system has no weights; what a pass carries is its parameters, cameras,
inputs, plane state and rectified working set.  These converters take plain
dicts of numpy arrays (field name -> array, nested for sub-structures), so
state produced elsewhere -- for instance by the JAX reference package, read
out with ``numpy.asarray`` -- can be handed to the port unchanged.  This
module takes numpy only.  Tensors go to the CUDA device unless ``device``
says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core.camera import Camera, PINHOLE
from acmmp_spherical_torch.core.plane import PlaneState
from acmmp_spherical_torch.ops.ncc import RefTapContext
from acmmp_spherical_torch.ops.propagate import PatchMatchInputs
from acmmp_spherical_torch.ops.rectify import PairRect, RectContext, TransportMaps


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def params(d: dict) -> PatchMatchParams:
    """PatchMatchParams from a field dict (``dataclasses.asdict`` of the
    reference's parameters)."""
    return PatchMatchParams(**d)


def camera(d: dict, device="cuda") -> Camera:
    """Camera (single or batched) from R, t, K, params, wh, depth_range."""
    f = lambda k: _t(d[k], torch.float32, device)
    return Camera(R=f("R"), t=f("t"), K=f("K"), params=f("params"), wh=f("wh"),
                  depth_range=f("depth_range"), model=d.get("model", PINHOLE))


def plane_state(d: dict, device="cuda") -> PlaneState:
    f = lambda k: _t(d[k], torch.float32, device)
    return PlaneState(normal=f("normal"), w=f("w"), cost=f("cost"),
                      selected=_t(d["selected"], torch.bool, device),
                      pre_cost=f("pre_cost"))


def transport_maps(d: dict, device="cuda") -> TransportMaps:
    i64 = lambda k: _t(d[k], torch.int64, device)
    return TransportMaps(
        fwd_idx=_t(d["fwd_idx"], torch.int32, device),
        fwd_valid=_t(d["fwd_valid"], torch.float32, device),
        bwd_cidx=i64("bwd_cidx"), bwd_x=i64("bwd_x"), bwd_y=i64("bwd_y"),
        bwd_valid=_t(d["bwd_valid"], torch.bool, device))


def rect_context(d: dict, device="cuda") -> RectContext:
    """RectContext from {pr: {...}, rect_ref, rect_src, maps: [3 dicts],
    tile_oy, tile_ox, srow[, rect_sdisp]}."""
    f = lambda a: _t(a, torch.float32, device)
    pr = PairRect(**{k: f(v) for k, v in d["pr"].items()})
    sdisp = d.get("rect_sdisp")
    return RectContext(
        pr=pr, rect_ref=f(d["rect_ref"]), rect_src=f(d["rect_src"]),
        maps=tuple(transport_maps(m, device) for m in d["maps"]),
        tile_oy=_t(d["tile_oy"], torch.int32, device),
        tile_ox=_t(d["tile_ox"], torch.int32, device), srow=f(d["srow"]),
        rect_sdisp=None if sdisp is None else f(sdisp))


def sphere_rect_context(d: dict, device="cuda"):
    """SphereRectContext from {rect_ref, rect_src, maps: [3 dicts], tile_oy,
    tile_ox, srow, rays_cam, slat, lat, baseline[, rect_sdisp]}."""
    from acmmp_spherical_torch.ops.sphere_rect import SphereRectContext

    f = lambda a: _t(a, torch.float32, device)
    sdisp = d.get("rect_sdisp")
    return SphereRectContext(
        rect_ref=f(d["rect_ref"]), rect_src=f(d["rect_src"]),
        maps=tuple(transport_maps(m, device) for m in d["maps"]),
        tile_oy=_t(d["tile_oy"], torch.int32, device),
        tile_ox=_t(d["tile_ox"], torch.int32, device), srow=f(d["srow"]),
        rays_cam=f(d["rays_cam"]), rect_sdisp=None if sdisp is None
        else f(sdisp), slat=f(d["slat"]), lat=f(d["lat"]),
        baseline=f(d["baseline"]))


def ref_tap_context(d: dict, device="cuda") -> RefTapContext:
    """RefTapContext from {offsets, ref_taps, weights, center, xs, ys}."""
    return RefTapContext(**{k: _t(d[k], torch.float32, device) for k in (
        "offsets", "ref_taps", "weights", "center", "xs", "ys")})


def patchmatch_inputs(d: dict, device="cuda") -> PatchMatchInputs:
    """PatchMatchInputs from {ref_image, src_images, ref_cam: {...},
    src_cams: {...}, src_valid, depth_range[, src_depths][, rect: {...}]};
    without ``rect`` the windowed and exact paths (or a rectified pass that
    builds its own context in ``prepare_inputs``)."""
    f = lambda k: _t(d[k], torch.float32, device)
    rect = d.get("rect")
    return PatchMatchInputs(
        ref_image=f("ref_image"), src_images=f("src_images"),
        ref_cam=camera(d["ref_cam"], device),
        src_cams=camera(d["src_cams"], device),
        src_valid=_t(d["src_valid"], torch.bool, device),
        depth_range=f("depth_range"),
        src_depths=None if d.get("src_depths") is None else f("src_depths"),
        rect=None if rect is None else rect_context(rect, device))
