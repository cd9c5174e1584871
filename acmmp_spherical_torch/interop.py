"""numpy -> torch converters for the state of a pass.

The system has no weights; what a pass carries is its cameras, its inputs,
its plane state and its rectified working set.  These converters take plain
dicts of numpy arrays (field name -> array, nested for sub-structures), so
state produced elsewhere -- for instance by the JAX reference package, read
out with ``numpy.asarray`` -- can be handed to the port unchanged.  This
module takes numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

from acmmp_spherical_torch.core.camera import Camera, PINHOLE
from acmmp_spherical_torch.core.plane import PlaneState
from acmmp_spherical_torch.ops.propagate import PatchMatchInputs
from acmmp_spherical_torch.ops.rectify import PairRect, RectContext, TransportMaps


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def camera(d: dict, device="cpu") -> Camera:
    """Camera (single or batched) from R, t, K, params, wh, depth_range."""
    f = lambda k: _t(d[k], torch.float32, device)
    return Camera(R=f("R"), t=f("t"), K=f("K"), params=f("params"), wh=f("wh"),
                  depth_range=f("depth_range"), model=d.get("model", PINHOLE))


def plane_state(d: dict, device="cpu") -> PlaneState:
    f = lambda k: _t(d[k], torch.float32, device)
    return PlaneState(normal=f("normal"), w=f("w"), cost=f("cost"),
                      selected=_t(d["selected"], torch.bool, device),
                      pre_cost=f("pre_cost"))


def transport_maps(d: dict, device="cpu") -> TransportMaps:
    i64 = lambda k: _t(d[k], torch.int64, device)
    return TransportMaps(
        fwd_idx=_t(d["fwd_idx"], torch.int32, device),
        fwd_valid=_t(d["fwd_valid"], torch.float32, device),
        bwd_cidx=i64("bwd_cidx"), bwd_x=i64("bwd_x"), bwd_y=i64("bwd_y"),
        bwd_valid=_t(d["bwd_valid"], torch.bool, device))


def rect_context(d: dict, device="cpu") -> RectContext:
    """RectContext from {pr: {...}, rect_ref, rect_src, maps: [3 dicts],
    tile_oy, tile_ox, srow}."""
    f = lambda a: _t(a, torch.float32, device)
    pr = PairRect(**{k: f(v) for k, v in d["pr"].items()})
    return RectContext(
        pr=pr, rect_ref=f(d["rect_ref"]), rect_src=f(d["rect_src"]),
        maps=tuple(transport_maps(m, device) for m in d["maps"]),
        tile_oy=_t(d["tile_oy"], torch.int32, device),
        tile_ox=_t(d["tile_ox"], torch.int32, device), srow=f(d["srow"]))


def patchmatch_inputs(d: dict, device="cpu") -> PatchMatchInputs:
    """PatchMatchInputs from {ref_image, src_images, ref_cam: {...},
    src_cams: {...}, src_valid, depth_range[, rect: {...}]}."""
    f = lambda k: _t(d[k], torch.float32, device)
    rect = d.get("rect")
    return PatchMatchInputs(
        ref_image=f("ref_image"), src_images=f("src_images"),
        ref_cam=camera(d["ref_cam"], device),
        src_cams=camera(d["src_cams"], device),
        src_valid=_t(d["src_valid"], torch.bool, device),
        depth_range=f("depth_range"),
        rect=None if rect is None else rect_context(rect, device))
