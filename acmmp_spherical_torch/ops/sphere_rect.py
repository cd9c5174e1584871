"""Pole-rotated spherical fast path (counterpart of
acmmp_spherical_tpu/ops/sphere_rect.py): equirect pairs for the rectified
kernel.

Each (ref, src) pair is rotated so its baseline becomes the pole axis of a
shared equirectangular frame.  A scene point then keeps its longitude and
moves only in latitude between the two rotated views, so meridians are the
epipolar curves.  The rotated frames are stored transposed (rows =
longitude, lanes = latitude), which makes every match a same-row lane
displacement: the contract of the rectified kernel (``rect_ncc``, kernels 1
and 4), whose taps sample at ``(x + dx - disp, y + dy)`` with
``disp(x+dx, y+dy) ~= D + A dx + B dy``.  A plane hypothesis gives
``lat_src = atan2(d sin(lat) + B, d cos(lat))`` with ``d`` the plane depth
along the pixel ray; finite differences at the +1 lane and +1 row targets
give (D, A, B).  Pixels within ``LAT_CAP_DEG`` of a pair's rotated poles
(its epipoles) are masked for that pair only.

The per-pass context is plain torch: the bicubic warps (wrapping in x), the
rounded backward map, the compacted transport maps (the scatter
attribution: the largest original flat index of each parity claims a
rotated pixel), the hoisted target rays and the displacement bounds
``srow``.  ``sphere_batched_ncc`` computes the affine coefficients in plain
torch, gathers them onto the compact pixels (``warp_transport_plain``, the
reference's XLA gather) and evaluates the cost with ``rect_ncc`` -- the
CUDA kernel on CUDA tensors, its plain version on CPU ones -- then maps it
back with ``backmap``; the two bf16 packs (``rect_tap_pack``,
``rect_backmap_pack``) apply as on the pinhole path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from acmmp_spherical_torch.core import geometry as G
from acmmp_spherical_torch.core.camera import (
    Camera, Cameras, camera_center, camera_index,
)
from acmmp_spherical_torch.ops.kernels.ncc_rect import (
    backmap, pack_ab, rect_ncc, warp_transport_plain,
)
from acmmp_spherical_torch.ops.rectify import (
    PAD_X, PAD_Y, SENTINEL, _attribution_scatter, _mm, _norm, _np,
    build_transport_maps,
)
from acmmp_spherical_torch.ops.sampling import (
    grid_coords, sample_bicubic, sample_nearest_trunc,
)

PI = math.pi
LAT_CAP_DEG = 78.0   # per-pair polar cap: |rotated latitude| above it is
#                      masked (the pair's epipoles; the affine model degrades)


@dataclasses.dataclass(frozen=True)
class SphereRectContext:
    """Per-pass pole-rotated working set (the sphere's RectContext)."""

    rect_ref: torch.Tensor   # (S, Wt+2*PAD_Y, Ht+2*PAD_X) transposed rotated
    #                          equirect reference (rows = lon, lanes = lat)
    rect_src: torch.Tensor   # (S, ..., ...) transposed rotated sources
    maps: tuple              # (full, parity0, parity1) TransportMaps; odd
    #                          frames: (full,)
    tile_oy: torch.Tensor    # (S, N) int32 live-tile row origins
    tile_ox: torch.Tensor    # (S, N) int32
    srow: torch.Tensor       # (S, 128): [0] disp_lo, [1] disp_hi, [2] = [3]
    #                          = 0, [4] = 1 (lane pixels and equirect pixels
    #                          share the H/pi-per-radian scale)
    rays_cam: torch.Tensor   # (S, H, W, 3, 3) ref-cam rays of each pixel's
    #                          claimed target at (+0, +1 lane, +1 row)
    rect_sdisp: "torch.Tensor | None"
    #                          (S, Rp, Lp) source depths as the implied lane
    #                          displacement (SENTINEL where invalid)
    slat: torch.Tensor       # (S, H, W, 3) sin(rotated lat) at the targets
    lat: torch.Tensor        # (S, H, W, 3) rotated lat (radians)
    baseline: torch.Tensor   # (S,)
    # packed taps: the pair words of rect_src (ncc_rect.with_src_pairs)
    rect_src_pk: "torch.Tensor | None" = None


# ---------------------------------------------------------------------------
# host-side (numpy, float64) mirrors
# ---------------------------------------------------------------------------

def sphere_rectifiable(ref_cam: Camera, src_cams: Cameras) -> bool:
    """Every pair has a usable baseline (its pole basis exists)."""
    R0, t0 = _np(ref_cam.R), _np(ref_cam.t)
    C0 = -R0.T @ t0
    Rs, ts = _np(src_cams.R), _np(src_cams.t)
    for s in range(Rs.shape[0]):
        b = R0 @ (-Rs[s].T @ ts[s] - C0)
        bn = np.linalg.norm(b)
        # the basis degenerates only for a zero baseline or one exactly
        # along the optical axis
        if bn < 1e-9 or abs(b[2] / bn) > 1.0 - 1e-9:
            return False
    return True


def _frame_shape(H: int, W: int):
    """(Ht, Wt): lanes (latitude) 128-aligned, rows (longitude) 8-aligned."""
    return -(-H // 128) * 128, -(-W // 8) * 8


def sphere_live_tile_count(ref_cam: Camera, *,
                           lat_cap_deg: float = LAT_CAP_DEG,
                           margin_tiles: int = 1) -> int:
    """Static live-tile budget of the rotated frame: the lane tiles of the
    band ``cy +- lat_cap / pi * H`` that claimed pixels occupy (the same for
    every pair: the band is centred on the rotated equator), plus
    ``margin_tiles``, times the row tiles.  An overflow drops only the
    emptiest tiles."""
    H = int(_np(ref_cam.height))
    W = int(_np(ref_cam.width))
    cy = float(_np(ref_cam.params)[2])
    Ht, Wt = _frame_shape(H, W)
    cap_h = math.radians(lat_cap_deg) / PI * H
    lo = max(0, int(math.floor(cy - cap_h)) - 1)
    hi = min(H - 1, int(math.ceil(cy + cap_h)) + 1)
    n_lane_tiles = min(hi // 128 - lo // 128 + 1 + margin_tiles, Ht // 128)
    return (Wt // 8) * n_lane_tiles


def sphere_init_window(ref_cam: Camera, src_cams: Cameras, *,
                       lat_cap_deg: float = LAT_CAP_DEG,
                       min_scale: float = 1.0) -> int:
    """Smallest source window (384/512/640) covering every pair's full
    plausible lane displacement (largest at d = dmin, evaluated on a
    latitude grid), or 0: with one, a random plane field evaluates with full
    tap coverage and the init rides the kernel."""
    R0, t0 = _np(ref_cam.R), _np(ref_cam.t)
    C0 = -R0.T @ t0
    dmin = float(_np(ref_cam.depth_range)[0]) * min_scale
    H = float(_np(ref_cam.height))
    if not dmin > 0:
        return 0
    Rs, ts = _np(src_cams.R), _np(src_cams.t)
    cap = math.radians(lat_cap_deg)
    lats = np.linspace(-cap, cap, 181)
    span = 0.0
    for s in range(Rs.shape[0]):
        B = np.linalg.norm(-Rs[s].T @ ts[s] - C0)
        if B < 1e-9:
            return 0
        disp = (np.arctan2(dmin * np.sin(lats) + B, dmin * np.cos(lats))
                - lats) * (H / PI)
        span = max(span, float(np.max(np.abs(disp))))
    for win in (384, 512, 640):
        if span + 4.0 <= win - 144:
            return win
    return 0


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def _pole_basis(ref_cam: Camera, src_cams: Cameras):
    """Per-pair pole basis in the ref-cam frame: ``R_rot`` (S, 3, 3) cam ->
    rotated (pole axis = +baseline), ``R_rel`` (S, 3, 3) ref-cam -> src-cam
    and the baseline norms ``Bn`` (S,)."""
    C0 = camera_center(ref_cam)
    b_cam = G._mat3_vec(ref_cam.R, camera_center(src_cams) - C0)
    Bn = _norm(b_cam)[:, 0]
    e2 = b_cam / torch.clamp(Bn, min=1e-20)[:, None]
    z = torch.tensor([0.0, 0.0, 1.0], device=e2.device)
    e3 = z[None] - e2 * e2[:, 2:3]
    e3 = e3 / torch.clamp(_norm(e3), min=1e-20)
    e1 = torch.linalg.cross(e2, e3)
    R_rot = torch.stack([e1, e2, e3], -2)
    S = R_rot.shape[0]
    R_rel = _mm(src_cams.R, ref_cam.R.T.expand(S, 3, 3))
    return R_rot, R_rel, Bn


def _rotated_grid_rays(ref_cam: Camera, hw, device):
    """The ray of every pixel of the padded transposed rotated frame, in its
    own rotated frame, and that pixel's latitude: (Rp, Lp, 3), (Rp, Lp)."""
    H, W = hw
    Ht, Wt = _frame_shape(H, W)
    lanes, rows = grid_coords(Wt + 2 * PAD_Y, Ht + 2 * PAD_X, device)
    lon_g = (rows - PAD_Y - ref_cam.params[1]) / W * (2.0 * PI)
    lat_g = -(lanes - PAD_X - ref_cam.params[2]) / H * PI
    return G.equirect_ray(lon_g, lat_g), lat_g


def _lat_lon(ray):
    """(lat, lon) of unit rays in their camera's frame."""
    return (-torch.arcsin(torch.clamp(ray[..., 1], -1.0, 1.0)),
            torch.arctan2(ray[..., 0], ray[..., 2]))


def _src_pixels(ray_rot_g, Rr, Rl, cam: Camera):
    """Source-camera equirect pixel (px, py) of each rotated-frame ray."""
    lat, lon = _lat_lon(G._mat3_vec(Rl, G._mat3t_vec(Rr, ray_rot_g)))
    return (lon / (2.0 * PI) * cam.width + cam.params[1],
            -lat / PI * cam.height + cam.params[2])


def build_sphere_sdisp(ref_cam: Camera, src_cams: Cameras, src_depths, hw):
    """Each source's depth map (radial, so rotation-invariant) warped into
    its pair's rotated transposed frame as the implied lane displacement:
    the exact inverse of the candidate mapping, so a consistent depth gives
    a zero mismatch.  Trunc-nearest lookup wrapping in x; SENTINEL where the
    source has no depth.  The only piece of the working set that changes
    between the passes of one (image, scale)."""
    H, W = hw
    R_rot, R_rel, Bn = _pole_basis(ref_cam, src_cams)
    ray_rot_g, lat_g = _rotated_grid_rays(ref_cam, hw, src_depths.device)
    sin_g, cos_g = torch.sin(lat_g), torch.cos(lat_g)
    out = []
    for s in range(R_rot.shape[0]):
        cam = camera_index(src_cams, s)
        px, py = _src_pixels(ray_rot_g, R_rot[s], R_rel[s], cam)
        d_s, ok = sample_nearest_trunc(src_depths[s], px, py, cam.width,
                                       cam.height, wrap_x=True)
        lat_r = torch.arctan2(d_s * sin_g - Bn[s], d_s * cos_g)
        g = (lat_g - lat_r) * (H / PI)
        out.append(torch.where(ok & (d_s > 0), g, SENTINEL))
    return torch.stack(out)


def build_sphere_rect_context(ref_image, src_images, ref_cam: Camera,
                              src_cams: Cameras, depth_range, *,
                              lat_cap_deg: float = LAT_CAP_DEG,
                              src_depths=None, live_n=None,
                              reuse: "SphereRectContext | None" = None
                              ) -> SphereRectContext:
    """The per-pass pole-rotated working set.  ``src_depths`` (S, Hp, Wp)
    also builds ``rect_sdisp``; ``reuse``, a context built for another pass
    of the same (image, scale), is kept but for ``rect_sdisp``."""
    H, W = ref_image.shape
    if reuse is not None:
        return dataclasses.replace(reuse, rect_sdisp=None if src_depths is None
                                   else build_sphere_sdisp(
                                       ref_cam, src_cams, src_depths, (H, W)))
    dev = ref_image.device
    Ht, Wt = _frame_shape(H, W)
    cx, cy = ref_cam.params[1], ref_cam.params[2]
    lat_cap = math.radians(lat_cap_deg)
    R_rot, R_rel, Bn = _pole_basis(ref_cam, src_cams)
    S = R_rot.shape[0]

    # ---- warps into the transposed rotated frames (bicubic, x wraps) ------
    ray_rot_g, _ = _rotated_grid_rays(ref_cam, (H, W), dev)
    rect_ref, rect_src = [], []
    for s in range(S):
        lat, lon = _lat_lon(G._mat3t_vec(R_rot[s], ray_rot_g))
        rect_ref.append(sample_bicubic(
            ref_image, lon / (2.0 * PI) * W + cx, -lat / PI * H + cy,
            ref_cam.width, ref_cam.height, wrap_x=True)[0])
        cam = camera_index(src_cams, s)
        px, py = _src_pixels(ray_rot_g, R_rot[s], R_rel[s], cam)
        rect_src.append(sample_bicubic(src_images[s], px, py, cam.width,
                                       cam.height, wrap_x=True)[0])
    rect_ref, rect_src = torch.stack(rect_ref), torch.stack(rect_src)
    rect_sdisp = (None if src_depths is None else
                  build_sphere_sdisp(ref_cam, src_cams, src_depths, (H, W)))

    # ---- backward map: original pixel -> nearest transposed rotated pixel -
    xs, ys = grid_coords(H, W, dev)
    ray_o = G.pixel_ray(ref_cam, xs, ys)
    rows, lanes, valid = [], [], []
    for s in range(S):
        lat_r, lon_r = _lat_lon(G._mat3_vec(R_rot[s], ray_o))
        row = torch.remainder(
            torch.round(lon_r / (2.0 * PI) * W + cx).to(torch.int64), W)
        lane = torch.round(-lat_r / PI * H + cy).to(torch.int64)
        rows.append(row)
        lanes.append(lane)
        valid.append((lat_r.abs() <= lat_cap) & (lane >= 0) & (lane < H))
    row_q, lane_q, bwd_ok = (torch.stack(rows), torch.stack(lanes),
                             torch.stack(valid))

    # ---- compacted transport maps: the frame's "x" is the lane, "y" the
    # row; claimants by the scatter attribution, tiles ranked by claims ----
    bwd_x = torch.clamp(lane_q, 0, Ht - 1).reshape(S, -1)
    bwd_y = row_q.reshape(S, -1)
    zero = torch.zeros(S, dtype=torch.int64, device=dev)
    attrib = _attribution_scatter(bwd_x, bwd_y, bwd_ok, (Wt, Ht), (H, W))
    maps, tile_oy, tile_ox = build_transport_maps(
        bwd_x, bwd_y, bwd_ok, (Wt, Ht), (H, W), zero, zero, attrib,
        live_n=live_n, count_claims=True)

    # ---- hoisted target rays (centre, +1 lane, +1 row) --------------------
    rays, slats, lats = [], [], []
    for dr, dc in ((0, 0), (0, 1), (1, 0)):
        lon_q = (row_q.to(torch.float32) + dr - cx) / W * (2.0 * PI)
        lat_q = -(lane_q.to(torch.float32) + dc - cy) / H * PI
        rr = G.equirect_ray(lon_q, lat_q)
        rays.append(G._mat3t_vec(R_rot.reshape(S, 1, 1, 3, 3), rr))
        slats.append(torch.sin(lat_q))
        lats.append(lat_q)
    rays_cam = torch.stack(rays, -2)
    slat, lat = torch.stack(slats, -1), torch.stack(lats, -1)

    # ---- global displacement bounds ---------------------------------------
    sl0 = slat[..., 0]
    cl0 = torch.sqrt(torch.clamp(1.0 - sl0 * sl0, min=1e-12))
    B3 = Bn.reshape(S, 1, 1)

    def disp_at(d):   # lane_ref - lane_src: positive with the +baseline pole
        d = torch.clamp(d, min=1e-6)
        return (torch.arctan2(d * sl0 + B3, d * cl0) - lat[..., 0]) * (H / PI)

    d_lo, d_hi = disp_at(depth_range[0]), disp_at(depth_range[1])
    inf = torch.tensor(float("inf"), device=dev)
    big = torch.where(bwd_ok, torch.maximum(d_lo, d_hi), -inf)
    sml = torch.where(bwd_ok, torch.minimum(d_lo, d_hi), inf)
    srow = torch.zeros((S, 128), dtype=torch.float32, device=dev)
    srow[:, 0] = sml.reshape(S, -1).amin(1) - 2.0
    srow[:, 1] = big.reshape(S, -1).amax(1) + 2.0
    srow[:, 4] = 1.0
    return SphereRectContext(
        rect_ref=rect_ref, rect_src=rect_src, maps=maps, tile_oy=tile_oy,
        tile_ox=tile_ox, srow=srow, rays_cam=rays_cam, rect_sdisp=rect_sdisp,
        slat=slat, lat=lat, baseline=Bn)


def _pack_hw_axes(arr, parity: int):
    """checkerboard_pack over axes (1, 2) of (S, H, W, ...) hoisted arrays."""
    even = arr[:, 0::2, parity::2]
    odd = arr[:, 1::2, (1 - parity)::2]
    return torch.stack([even, odd], 2).reshape(
        arr.shape[0], arr.shape[1], arr.shape[2] // 2, *arr.shape[3:])


def sphere_coefficient_tables(ctx: SphereRectContext, normals, ws, parity):
    """The affine lane-displacement coefficients of C plane fields (normals
    (C, H, Wg, 3), ws (C, H, Wg)) at each pixel's claimed target: D
    (S, C, H*Wg) f32 (-1e9 where any of the three target depths is behind
    the ray or the displacement is not finite) and the packed (A, B) words
    (S, C, H*Wg) int32."""
    C, H_eval, Wg = ws.shape
    S = ctx.baseline.shape[0]
    H = ctx.rays_cam.shape[1]
    if parity is None:
        rays, slat, lat = ctx.rays_cam, ctx.slat, ctx.lat
    else:
        rays, slat, lat = (_pack_hw_axes(a, parity)
                           for a in (ctx.rays_cam, ctx.slat, ctx.lat))
    n = normals.movedim(0, 2)[None]                # (1, H, Wg, C, 3)
    wsl = ws.movedim(0, -1)[None]                  # (1, H, Wg, C)
    Bn = ctx.baseline.reshape(S, 1, 1, 1)
    disps, oks = [], []
    for k in range(3):
        r = rays[..., k, None, :]                  # (S, H, Wg, 1, 3)
        ndot = (n[..., 0] * r[..., 0] + n[..., 1] * r[..., 1]
                + n[..., 2] * r[..., 2])
        d = -wsl / torch.where(ndot.abs() < 1e-20,
                               torch.full_like(ndot, 1e-20), ndot)
        sl = slat[..., k, None]
        cl = torch.sqrt(torch.clamp(1.0 - sl * sl, min=1e-12))
        v = d * cl
        disp = (torch.arctan2(d * sl + Bn, v) - lat[..., k, None]) * (H / PI)
        disps.append(disp)
        oks.append((d > 0) & (v > 0) & torch.isfinite(disp))
    good = oks[0] & oks[1] & oks[2]
    D = torch.where(good, disps[0], -1e9)
    A = torch.where(good, disps[1] - disps[0], 0.0)
    B = torch.where(good, disps[2] - disps[0], 0.0)
    flat = lambda a: a.permute(0, 3, 1, 2).reshape(S, C, H_eval * Wg)
    return flat(D).contiguous(), flat(pack_ab(A, B)).contiguous()


def sphere_batched_ncc(ctx: SphereRectContext, normals, ws, params, *,
                       with_geom: bool = False, parity=None):
    """Evaluate C candidate plane fields against S sources -> (C, S, H, Wg)
    costs (``with_geom``: also the geometric costs against
    ``ctx.rect_sdisp``).  ``parity`` None: full-grid fields with the full
    map; 0/1: checkerboard-packed half-grid fields with that colour's map.
    The cost is kernel 1 (kernel 4 with ``with_geom``) on CUDA tensors."""
    C, H_eval, Wg = ws.shape
    maps = ctx.maps[0 if parity is None else 1 + parity]
    D, AB = warp_transport_plain(
        *sphere_coefficient_tables(ctx, normals, ws, parity), maps.fwd_idx,
        maps.fwd_valid)
    args = (ctx.srow, ctx.tile_oy, ctx.tile_ox, ctx.rect_ref, ctx.rect_src,
            D, AB, maps.fwd_valid, params)
    pack = params.rect_backmap_pack
    if not with_geom:
        return backmap(rect_ncc(*args, src_pk=ctx.rect_src_pk), maps,
                       (H_eval, Wg), params.cost_max, pack)
    if ctx.rect_sdisp is None:
        raise ValueError("with_geom needs the context's rect_sdisp")
    cost, geom = rect_ncc(*args, sdisp=ctx.rect_sdisp,
                          src_pk=ctx.rect_src_pk)
    return (backmap(cost, maps, (H_eval, Wg), params.cost_max, pack),
            backmap(geom, maps, (H_eval, Wg), params.geom_max_cost, pack))
