"""Epipolar rectification for the rectified NCC path (counterpart of
acmmp_spherical_tpu/ops/rectify.py, pinhole pairs).

Each (ref, src) pair is rotated onto its baseline so a plane hypothesis
becomes an affine disparity along rows.  This module builds the per-pass
working set: the pair rectifications, the warped reference (edge-clamped
bicubic, plain torch) and source frames (kernel ``warp_src_frames``), the
compacted transport maps between original pixels and live (8, 128) rect
tiles, and in geometric passes the source depths warped into implied rect
disparities (kernel ``warp_src_disparities``).

The transport attribution is always scatter-free or deterministic: with
``inv_attrib`` it is the reference's inverse check of the 3x3 neighbourhood;
otherwise a ``scatter_reduce("amax")`` of the original flat index per
parity.  Both pick the largest flat index of the parity as the collision
winner (the reference's scatter leaves that winner to the backend).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from acmmp_spherical_torch.core.camera import Camera, Cameras, camera_center
from acmmp_spherical_torch.ops.sampling import (
    checkerboard_pack, grid_coords, sample_bicubic,
)

PAD_Y = 8
PAD_X = 128
SENTINEL = -1.0e4
SENTINEL_THRESH = -0.5


# ---------------------------------------------------------------------------
# host-side (numpy, float64) mirrors: static shapes and gates per problem
# ---------------------------------------------------------------------------

def rect_shape(height: int, width: int) -> tuple[int, int]:
    """Static rectified frame size for an (H, W) problem (the full-resolution
    warped reference fits under any in-plane rotation, plus x-slack)."""
    diag = int(math.ceil((height * height + width * width) ** 0.5))
    hr = -(-(diag + 16) // 8) * 8
    wr = -(-(diag + 160) // 128) * 128
    return hr, wr


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy().astype(np.float64)
    return np.asarray(a, np.float64)


@dataclasses.dataclass
class _PairMirror:
    """float64 mirror of one pair of build_pair_rect."""

    bn: float             # baseline length
    R_rr: np.ndarray      # ref-cam -> rect rotation
    uv0: tuple            # ref-corner rect rays (u, v), 4 each
    uv1: tuple            # src-corner rect rays
    f: float              # fitted rect focal
    cx: float
    cy: float


def _pair_mirrors(ref_cam: Camera, src_cams: Cameras, rect_hw):
    """Per source view, the f64 rectification of ``build_pair_rect``, or None
    for a degenerate pair (zero baseline, near-forward motion, a corner
    behind the rotated frame, non-finite focal).  Returns (pairs, f0)."""
    hr, wr = rect_hw
    margin = 2.0
    R0, t0, K0 = _np(ref_cam.R), _np(ref_cam.t), _np(ref_cam.K)
    C0 = -R0.T @ t0
    Rs, ts, Ks, whs = (_np(src_cams.R), _np(src_cams.t), _np(src_cams.K),
                       _np(src_cams.wh))
    f0 = K0[0, 0]
    W0, H0_ = float(_np(ref_cam.width)), float(_np(ref_cam.height))

    def corner_uv(R_cr, K, W_, H_):
        corners = np.array([[0.0, 0.0, 1.0], [W_ - 1.0, 0.0, 1.0],
                            [0.0, H_ - 1.0, 1.0], [W_ - 1.0, H_ - 1.0, 1.0]])
        q = corners @ (R_cr @ np.linalg.inv(K)).T
        if np.any(q[:, 2] <= 1e-6):
            return None
        return q[:, 0] / q[:, 2], q[:, 1] / q[:, 2]

    pairs = []
    for s in range(Rs.shape[0]):
        b = -Rs[s].T @ ts[s] - C0
        bn = np.linalg.norm(b)
        if bn < 1e-9:
            pairs.append(None)
            continue
        e1 = b / bn
        e2 = np.cross(R0[2], e1)
        n2 = np.linalg.norm(e2)
        if n2 < 1e-3:
            pairs.append(None)
            continue
        e2 = e2 / n2
        R_rect = np.stack([e1, e2, np.cross(e1, e2)])
        R_rr = R_rect @ R0.T
        uv0 = corner_uv(R_rr, K0, W0, H0_)
        uv1 = corner_uv(R_rect @ Rs[s].T, Ks[s], whs[s, 0], whs[s, 1])
        if uv0 is None or uv1 is None:
            pairs.append(None)
            continue
        u = np.concatenate([uv0[0], uv1[0]])
        v = np.concatenate([uv0[1], uv1[1]])
        du = max(u.max() - u.min(), 1e-12)
        dv = max(v.max() - v.min(), 1e-12)
        f = min(f0, (wr - 1.0 - 2 * margin) / du, (hr - 1.0 - 2 * margin) / dv)
        if not np.isfinite(f):
            pairs.append(None)
            continue
        pairs.append(_PairMirror(bn=bn, R_rr=R_rr, uv0=uv0, uv1=uv1, f=f,
                                 cx=margin - f * u.min(),
                                 cy=margin - f * v.min()))
    return pairs, f0


def host_rectifiable(ref_cam, src_cams, rect_hw, *, min_scale=0.55) -> bool:
    """True when every pair rectifies at a focal >= ``min_scale`` x f_ref."""
    pairs, f0 = _pair_mirrors(ref_cam, src_cams, rect_hw)
    return all(p is not None and p.f / f0 >= min_scale for p in pairs)


def rect_comp_shape(ref_cam, src_cams, rect_hw) -> tuple[int, int]:
    """Static compute-grid size: the max-over-pairs warped-reference bbox,
    padded and quantised (rows to 32, cols to 128)."""
    hr, wr = rect_hw
    pairs, _ = _pair_mirrors(ref_cam, src_cams, rect_hw)
    if any(p is None for p in pairs):
        return hr, wr
    bw = max(p.f * (p.uv0[0].max() - p.uv0[0].min()) for p in pairs)
    bh = max(p.f * (p.uv0[1].max() - p.uv0[1].min()) for p in pairs)
    wb = min(wr, -(-int(bw + 128 + 10) // 128) * 128)
    hb = min(hr, -(-int(bh + 16 + 10) // 32) * 32)
    return hb, wb


def rect_live_tile_count(ref_cam, src_cams, rect_hw, comp_hw) -> int:
    """Static budget of live (8, 128) compute-grid tiles per pair: the
    warped-reference quad rasterised at tile granularity (1-px dilation),
    max over pairs, plus 16, quantised to 32."""
    hr, wr = rect_hw
    hb, wb = comp_hw
    ty, tx = hb // 8, wb // 128
    pairs, _ = _pair_mirrors(ref_cam, src_cams, rect_hw)
    if any(p is None for p in pairs):
        return ty * tx
    best = 0
    for p in pairs:
        qx = p.f * p.uv0[0] + p.cx
        qy = p.f * p.uv0[1] + p.cy
        ox = np.clip(np.floor((qx.min() - 2.0) / 128.0) * 128.0, 0, wr - wb)
        oy = np.clip(np.floor((qy.min() - 2.0) / 8.0) * 8.0, 0, hr - hb)
        hull = np.stack([qx - ox, qy - oy], axis=1)[[0, 1, 3, 2]]
        count = 0
        for ti in range(ty):
            y_lo, y_hi = ti * 8 - 1.0, ti * 8 + 9.0
            xs_band = []
            for k in range(4):
                (x1, y1), (x2, y2) = hull[k], hull[(k + 1) % 4]
                if max(y1, y2) < y_lo or min(y1, y2) > y_hi:
                    continue
                for yc in (max(y_lo, min(y1, y2)), min(y_hi, max(y1, y2))):
                    if abs(y2 - y1) > 1e-12:
                        t = np.clip((yc - y1) / (y2 - y1), 0.0, 1.0)
                        xs_band.append(x1 + t * (x2 - x1))
                    else:
                        xs_band.extend([x1, x2])
            if not xs_band:
                continue
            j0 = int(np.floor((min(xs_band) - 1.0) / 128.0))
            j1 = int(np.floor((max(xs_band) + 1.0) / 128.0))
            count += max(0, min(j1, tx - 1) - max(j0, 0) + 1)
        best = max(best, count)
    if best <= 0:
        return ty * tx
    best = best + 16
    return min(ty * tx, -(-best // 32) * 32)


def _footprint_jacobians(ref_cam, src_cams, rect_hw):
    """Per pair, the finite-difference Jacobians (jx, jy) of H0^-1 at the
    warped-reference corners; None when a pair is degenerate."""
    pairs, _ = _pair_mirrors(ref_cam, src_cams, rect_hw)
    if any(p is None for p in pairs):
        return None
    K0 = _np(ref_cam.K)
    out = []
    for p in pairs:
        Km = np.array([[p.f, 0.0, p.cx], [0.0, p.f, p.cy], [0.0, 0.0, 1.0]])
        H0inv = K0 @ p.R_rr.T @ np.linalg.inv(Km)

        def orig(px, py):
            q = H0inv @ np.array([px, py, 1.0])
            return q[:2] / q[2]

        for qx, qy in zip(p.f * p.uv0[0] + p.cx, p.f * p.uv0[1] + p.cy):
            o0 = orig(qx, qy)
            out.append((orig(qx + 1.0, qy) - o0, orig(qx, qy + 1.0) - o0))
    return out


def rect_warp_window(ref_cam, src_cams, rect_hw, *, max_wr: int = 152,
                     max_wc: int = 1024):
    """Static (WR, WC) claimant window of the warp transport, or None when
    the rect->orig Jacobian makes it exceed (max_wr, max_wc)."""
    jac = _footprint_jacobians(ref_cam, src_cams, rect_hw)
    if jac is None:
        return None
    best_x = max([0.0] + [8.0 * abs(jy[0]) + 128.0 * abs(jx[0]) for jx, jy in jac])
    best_y = max([0.0] + [8.0 * abs(jy[1]) + 128.0 * abs(jx[1]) for jx, jy in jac])
    WR = -(-int(np.ceil(best_y + 6.0)) // 8) * 8
    WC = -(-int(np.ceil(best_x + 8.0)) // 128) * 128
    if WR > max_wr or WC > max_wc:
        return None
    return max(8, WR), max(128, WC)


def warp_windows(warp_hw):
    """(full, parity) claimant windows: parity tables are half-grids."""
    WR, WC = warp_hw
    WCp = max(128, -(-(WC // 2 + 4) // 128) * 128)
    return (WR, WC), (WR, WCp)


def rect_inv_attrib_ok(ref_cam, src_cams, rect_hw, *, max_lip: float = 2.0
                       ) -> bool:
    """Gate of the scatter-free attribution: the local Lipschitz bound of
    H0^-1 (inf-norm row sums of the corner Jacobians) stays below
    ``max_lip``, so the 3x3 candidate set holds every claimant."""
    jac = _footprint_jacobians(ref_cam, src_cams, rect_hw)
    if jac is None:
        return False
    return all(max(abs(jx[0]) + abs(jy[0]), abs(jx[1]) + abs(jy[1])) <= max_lip
               for jx, jy in jac)


def rect_span_fits(ref_cam, src_cams, rect_hw, *, usable: int = 240,
                   min_scale: float = 1.0, max_scale: float = 1.0) -> bool:
    """Does every pair's full plausible disparity span fit ``usable``?"""
    dmin, dmax = _np(ref_cam.depth_range)
    if not (dmin > 0 and dmax > dmin):
        return False
    pairs, _ = _pair_mirrors(ref_cam, src_cams, rect_hw)
    for p in pairs:
        if p is None:
            return False
        span = p.f * p.bn * (1.0 / (min_scale * dmin)
                             - 1.0 / (max_scale * dmax)) + 4.0
        if span > usable:
            return False
    return True


def rect_init_window(ref_cam, src_cams, rect_hw, *, min_scale: float = 1.0,
                     max_scale: float = 1.0) -> int:
    """Smallest source-window width (384/512/640) covering the full span."""
    for win in (384, 512, 640):
        if rect_span_fits(ref_cam, src_cams, rect_hw, usable=win - 144,
                          min_scale=min_scale, max_scale=max_scale):
            return win
    return 0


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PairRect:
    """Per-(ref, src) rectification, batched over the source axis S."""

    R_rr: torch.Tensor      # (S, 3, 3) ref-cam -> rect rotation
    K: torch.Tensor         # (S, 3) rect f, cx, cy
    baseline: torch.Tensor  # (S,)
    H0: torch.Tensor        # (S, 3, 3) original ref pixel -> rect pixel
    H0inv: torch.Tensor     # (S, 3, 3)
    H1inv: torch.Tensor     # (S, 3, 3) rect pixel -> original src pixel
    R_sr: torch.Tensor      # (S, 3, 3) src-cam -> rect rotation
    scale: torch.Tensor     # (S,) f_rect / f_ref


def _mm(a, b):
    """Batched 3x3 @ 3x3, summed in index order in f32."""
    return (a[..., :, 0, None] * b[..., None, 0, :]
            + a[..., :, 1, None] * b[..., None, 1, :]
            + a[..., :, 2, None] * b[..., None, 2, :])


def _k_mat(f, cx, cy):
    z, o = torch.zeros_like(f), torch.ones_like(f)
    return torch.stack([torch.stack([f, z, cx], -1), torch.stack([z, f, cy], -1),
                        torch.stack([z, z, o], -1)], -2)


def _k_inv(K):
    """Analytic inverse of [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]."""
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([1.0 / fx, z, -cx / fx], -1),
                        torch.stack([z, 1.0 / fy, -cy / fy], -1),
                        torch.stack([z, z, o], -1)], -2)


def _norm(v):
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def build_pair_rect(ref_cam: Camera, src_cams: Cameras, rect_hw) -> PairRect:
    """Rectification rotations + intrinsics for every (ref, src) pair
    (Fusiello-style; K fitted over the union of both footprints)."""
    hr, wr = rect_hw
    margin = 2.0
    S = src_cams.t.shape[0]
    C0 = camera_center(ref_cam)
    b = camera_center(src_cams) - C0[None]
    bnorm = _norm(b)
    e1 = b / torch.clamp(bnorm, min=1e-20)
    z0 = ref_cam.R[2].expand(S, 3)
    e2 = torch.linalg.cross(z0, e1)
    e2 = e2 / torch.clamp(_norm(e2), min=1e-20)
    e3 = torch.linalg.cross(e1, e2)
    R_rect = torch.stack([e1, e2, e3], -2)
    R_rr = _mm(R_rect, ref_cam.R.T.expand(S, 3, 3))
    R_sr = _mm(R_rect, src_cams.R.transpose(-1, -2))
    Kref = ref_cam.K.expand(S, 3, 3)

    def corner_rays(K, R_cr, Wc, Hc):
        P = _mm(R_cr, _k_inv(K))
        zero, one = torch.zeros_like(Wc), torch.ones_like(Wc)
        cs = torch.stack([torch.stack([zero, zero, one], -1),
                          torch.stack([Wc - 1.0, zero, one], -1),
                          torch.stack([zero, Hc - 1.0, one], -1),
                          torch.stack([Wc - 1.0, Hc - 1.0, one], -1)], -2)
        q = [cs[..., 0] * P[..., i, None, 0] + cs[..., 1] * P[..., i, None, 1]
             + cs[..., 2] * P[..., i, None, 2] for i in range(3)]
        qz = torch.clamp(q[2], min=1e-6)
        return q[0] / qz, q[1] / qz

    u0, v0 = corner_rays(Kref, R_rr, ref_cam.width.expand(S),
                         ref_cam.height.expand(S))
    u1, v1 = corner_rays(src_cams.K, R_sr, src_cams.width, src_cams.height)
    u = torch.cat([u0, u1], -1)
    v = torch.cat([v0, v1], -1)
    f0 = ref_cam.K[0, 0]
    f = torch.minimum(
        f0, torch.minimum((wr - 1.0 - 2 * margin) / (u.amax(-1) - u.amin(-1)),
                          (hr - 1.0 - 2 * margin) / (v.amax(-1) - v.amin(-1))))
    cx = margin - f * u.amin(-1)
    cy = margin - f * v.amin(-1)
    Km = _k_mat(f, cx, cy)
    Kminv = _k_inv(Km)
    H0 = _mm(Km, _mm(R_rr, _k_inv(Kref)))
    H0inv = _mm(_mm(Kref, R_rr.transpose(-1, -2)), Kminv)
    H1inv = _mm(_mm(src_cams.K, R_sr.transpose(-1, -2)), Kminv)
    return PairRect(R_rr=R_rr, K=torch.stack([f, cx, cy], -1),
                    baseline=bnorm[:, 0], H0=H0, H0inv=H0inv, H1inv=H1inv,
                    R_sr=R_sr, scale=f / f0)


def rect_coords(H, x, y):
    """Apply a (3, 3) pixel homography; returns (xr, yr, z), z the
    projective denominator (z <= 0: behind the rotated frame)."""
    z = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    xr = (H[0, 0] * x + H[0, 1] * y + H[0, 2]) / zs
    yr = (H[1, 0] * x + H[1, 1] * y + H[1, 2]) / zs
    return xr, yr, z


def rect_frame_coords(rect_hw, device):
    """Unpadded rect coords (xs, ys) of every padded-frame pixel."""
    hr, wr = rect_hw
    xs, ys = grid_coords(hr + 2 * PAD_Y, wr + 2 * PAD_X, device)
    return xs - PAD_X, ys - PAD_Y


def warp_to_rect(img, Hinv, width: int, height: int, rect_hw):
    """Edge-clamped Catmull-Rom warp of an original image into the padded
    rect frame (the reference-frame variant: border taps clamp)."""
    xs, ys = rect_frame_coords(rect_hw, img.device)
    ox, oy, _ = rect_coords(Hinv, xs, ys)
    return sample_bicubic(img, ox, oy, width, height)[0]


@dataclasses.dataclass(frozen=True)
class TransportMaps:
    """Compacted transport maps (full grid or one checkerboard parity).

    Slot ``k`` of pair ``s`` is the live (8, 128) compute-grid tile whose
    storage-frame origin is ``(tile_oy[s, k], tile_ox[s, k])``."""

    fwd_idx: torch.Tensor    # (S, N*1024) int32: compact px -> table row
    fwd_valid: torch.Tensor  # (S, N*8, 128) float32 0/1
    bwd_cidx: torch.Tensor   # (S, M) int64: table row -> compact flat idx
    bwd_x: torch.Tensor      # (S, M) int64 claimed rect px, bbox coords
    bwd_y: torch.Tensor      # (S, M) int64
    bwd_valid: torch.Tensor  # (S, H, Wg) bool


def _clear_outside_window(fidx, fval, Wt, win):
    """Clear claimants outside the static claimant window of their tile from
    the validity plane (the reference's warp_tables, rectify.py:826-847):
    such pixels read back as invalid rather than as another plane."""
    if win is None:
        return fval
    WRw, WCw = win
    S = fidx.shape[0]
    big = 1 << 28
    fy = fidx // Wt
    fx = fidx - fy * Wt
    ok = (fval.reshape(S, -1) > 0.5).reshape(S, -1, 1024)
    fy = fy.reshape(S, -1, 1024)
    fx = fx.reshape(S, -1, 1024)
    oy_t = torch.where(ok, fy, big).amin(2, keepdim=True)
    ox_t = torch.where(ok, fx, big).amin(2, keepdim=True)
    oy_t = torch.where(oy_t >= big, 0, oy_t)
    ox_t = torch.where(ox_t >= big, 0, ox_t)
    inw = ok & (fy - oy_t < WRw) & (fx - ox_t < WCw)
    return fval * inw.reshape(fval.shape).float()


def build_transport_maps(bwd_x, bwd_y, bwd_ok, comp_hw, hw, oy, ox, attrib,
                         *, live_n=None, warp_hw=None,
                         count_claims: bool = False):
    """Compacted transport maps (full, parity0, parity1; odd frames: full
    only) from the backward map and the per-parity content-grid attribution
    ``attrib`` (two (S, hb, wb) int64 grids of original flat index + 1,
    0 = no claimant).

    Tiles are ranked by ``argsort(-counts, stable=True)`` and the first
    ``live_n`` kept; ``count_claims`` ranks by claims (the reference's
    scatter branch) instead of live pixels (its inverse-attribution branch).
    Returns ``(maps, tile_oy, tile_ox)``."""
    hb, wb = comp_hw
    H, W = hw
    ty, tx = hb // 8, wb // 128
    T = ty * tx
    N = T if live_n is None else min(live_n, T)
    S = bwd_x.shape[0]
    dev = bwd_x.device
    okf = bwd_ok.reshape(S, -1)
    tile_of = (bwd_y // 8) * tx + bwd_x // 128

    if N == T:
        tile_idx = torch.arange(T, device=dev).expand(S, T)
        slot = torch.where(okf, tile_of, 0)
        okc = okf
    else:
        if count_claims:
            counts = torch.zeros(S, T + 1, dtype=torch.int64, device=dev)
            counts.scatter_add_(1, torch.where(okf, tile_of, T),
                                torch.ones_like(tile_of))
            counts = counts[:, :T]
        else:
            live_px = (attrib[0] > 0) | (attrib[1] > 0)
            counts = live_px.reshape(S, ty, 8, tx, 128).sum((2, 4)).reshape(S, T)
        tile_idx = torch.argsort(-counts, dim=1, stable=True)[:, :N]
        tile_slot = torch.full((S, T), -1, dtype=torch.int64, device=dev)
        tile_slot.scatter_(1, tile_idx,
                           torch.arange(N, device=dev).expand(S, N).contiguous())
        slot = torch.gather(tile_slot, 1, tile_of)
        okc = okf & (slot >= 0)
        slot = torch.clamp(slot, min=0)

    within = (bwd_y % 8) * 128 + bwd_x % 128
    bwd_cidx = torch.where(okc, slot * 1024 + within, 0)

    def tile_gather(arr):
        t = arr.reshape(S, ty, 8, tx, 128).permute(0, 1, 3, 2, 4)
        t = t.reshape(S, T, 1024)
        return torch.gather(t, 1, tile_idx[..., None].expand(S, N, 1024)
                            ).reshape(S, N * 1024)

    win_full = win_par = None
    if warp_hw is not None:
        win_full, win_par = warp_windows(warp_hw)

    if H % 2 or W % 2:
        # odd frames: the full map only (the half-step runs on the full grid,
        # reference rectify.py:931-952).  The reference's odd-frame scatter
        # keeps the last writer, the largest flat index; its inverse
        # attribution prefers the parity-1 claimant.
        afull = (torch.maximum(attrib[0], attrib[1]) if count_claims
                 else torch.where(attrib[1] > 0, attrib[1], attrib[0]))
        fc = tile_gather(afull)
        fidx = torch.clamp(fc - 1, min=0)
        fval = _clear_outside_window(
            fidx, (fc > 0).float().reshape(S, N * 8, 128), W, win_full)
        maps = [TransportMaps(fwd_idx=fidx.to(torch.int32), fwd_valid=fval,
                              bwd_cidx=bwd_cidx, bwd_x=bwd_x, bwd_y=bwd_y,
                              bwd_valid=okc.reshape(S, H, W))]
    else:
        maps = _parity_maps(attrib, tile_gather, bwd_cidx, bwd_x, bwd_y, okc,
                            (H, W), N, win_full, win_par)

    ti = tile_idx // tx
    tj = tile_idx - ti * tx
    tile_oy = (oy[:, None].to(torch.int64) + 8 * ti).to(torch.int32)
    tile_ox = (ox[:, None].to(torch.int64) + 128 * tj).to(torch.int32)
    return tuple(maps), tile_oy.contiguous(), tile_ox.contiguous()


@dataclasses.dataclass(frozen=True)
class RectContext:
    """Per-pass rectified working set."""

    pr: PairRect
    rect_ref: torch.Tensor   # (S, hr+2*PAD_Y, wr+2*PAD_X) clamp-warped ref
    rect_src: torch.Tensor   # (S, ..., ...) sentinel-warped sources
    maps: tuple              # (full, parity0, parity1) TransportMaps; odd
    #                          frames: (full,)
    tile_oy: torch.Tensor    # (S, N) int32 live-tile storage-row origins
    tile_ox: torch.Tensor    # (S, N) int32
    srow: torch.Tensor       # (S, 128): disp_lo, disp_hi, oy, ox, 1/scale
    # geometric passes: (S, hr+2*PAD_Y, wr+2*PAD_X) source depths warped into
    # each pair's rect frame as the implied rect disparity f*B/z_rect
    # (SENTINEL where there is no valid source depth)
    rect_sdisp: "torch.Tensor | None" = None


def _parity_maps(attrib, tile_gather, bwd_cidx, bwd_x, bwd_y, okc, hw, N,
                 win_full, win_par):
    """(full, parity0, parity1) maps of an even frame: each colour's own
    claimants in its packed half-grid, the full map preferring parity 1."""
    H, W = hw
    S = bwd_x.shape[0]

    def to_packed(q1):
        q = torch.clamp(q1 - 1, min=0)
        fy = q // W
        fx = q - fy * W
        return torch.where(q1 > 0, fy * (W // 2) + fx // 2 + 1, 0)

    def unpack_orig(packed1, p):
        q = torch.clamp(packed1 - 1, min=0)
        fy = q // (W // 2)
        fx = 2 * (q - fy * (W // 2)) + (p + fy) % 2
        return fy * W + fx

    pm = [to_packed(tile_gather(attrib[p])) for p in (0, 1)]
    full_idx = torch.where(pm[1] > 0, unpack_orig(pm[1], 1),
                           torch.where(pm[0] > 0, unpack_orig(pm[0], 0), 0))
    fval_full = ((pm[0] > 0) | (pm[1] > 0)).float().reshape(S, N * 8, 128)
    fval_full = _clear_outside_window(full_idx, fval_full, W, win_full)
    maps = [TransportMaps(fwd_idx=full_idx.to(torch.int32), fwd_valid=fval_full,
                          bwd_cidx=bwd_cidx, bwd_x=bwd_x, bwd_y=bwd_y,
                          bwd_valid=okc.reshape(S, H, W))]

    def packf(a):
        return checkerboard_pack(a.reshape(S, H, W), p).reshape(S, -1)

    for p in (0, 1):
        fidx_p = torch.clamp(pm[p] - 1, min=0)
        fval_p = (pm[p] > 0).float().reshape(S, N * 8, 128)
        fval_p = _clear_outside_window(fidx_p, fval_p, W // 2, win_par)
        maps.append(TransportMaps(
            fwd_idx=fidx_p.to(torch.int32), fwd_valid=fval_p,
            bwd_cidx=packf(bwd_cidx), bwd_x=packf(bwd_x), bwd_y=packf(bwd_y),
            bwd_valid=checkerboard_pack(okc.reshape(S, H, W), p)))
    return maps


def _attribution_inverse(pr, off_y, off_x, comp_hw, hw):
    """Scatter-free claimant attribution (reference rectify.py:1107-1132):
    per compute-grid pixel, the claimants among the 3x3 neighbourhood of
    round(H0^-1(c)), verified with the forward computation of the backward
    map; winner = largest original flat index of each parity."""
    hb, wb = comp_hw
    H, W = hw
    S = pr.H0.shape[0]
    xbc, ybc = grid_coords(hb, wb, pr.H0.device)
    out = []
    for s in range(S):
        H0, H0inv = pr.H0[s], pr.H0inv[s]
        oy, ox = off_y[s], off_x[s]
        xo_f, yo_f, _ = rect_coords(H0inv, xbc + ox, ybc + oy)
        xo0 = torch.round(xo_f).to(torch.int64)
        yo0 = torch.round(yo_f).to(torch.int64)
        win = [torch.zeros((hb, wb), dtype=torch.int64, device=xbc.device)
               for _ in range(2)]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                xo = xo0 + dx
                yo = yo0 + dy
                inb = (xo >= 0) & (xo < W) & (yo >= 0) & (yo < H)
                xr, yr, z = rect_coords(H0, xo.float(), yo.float())
                claim = (inb & (z > 0) & (torch.round(xr) - ox == xbc)
                         & (torch.round(yr) - oy == ybc))
                oflat1 = yo * W + xo + 1
                par = (yo + xo) % 2
                for p in (0, 1):
                    win[p] = torch.maximum(
                        win[p], torch.where(claim & (par == p), oflat1, 0))
        out.append(win)
    return tuple(torch.stack([w[p] for w in out]) for p in (0, 1))


def _attribution_scatter(bwd_x, bwd_y, bwd_ok, comp_hw, hw):
    """Claimant attribution by ``scatter_reduce("amax")`` of the original
    flat index + 1 per parity: deterministic, same winner rule as the
    inverse check (used where rect_inv_attrib_ok fails)."""
    hb, wb = comp_hw
    H, W = hw
    S = bwd_x.shape[0]
    dev = bwd_x.device
    okf = bwd_ok.reshape(S, -1)
    oflat = torch.arange(H * W, device=dev)
    par = ((oflat // W) + (oflat % W)) % 2
    tgt = bwd_y * wb + bwd_x
    out = []
    for p in (0, 1):
        vals = torch.where(okf & (par == p)[None], oflat + 1, 0)
        grid = torch.zeros(S, hb * wb, dtype=torch.int64, device=dev)
        grid.scatter_reduce_(1, tgt, vals, "amax", include_self=True)
        out.append(grid.reshape(S, hb, wb))
    return tuple(out)


def build_rect_context(ref_image, src_images, ref_cam: Camera,
                       src_cams: Cameras, depth_range, *, comp_hw=None,
                       live_n=None, warp_hw=None, inv_attrib: bool = False,
                       src_depths=None) -> RectContext:
    """Build the per-pass rectified working set; ``src_depths`` (S, Hp, Wp)
    also builds ``rect_sdisp`` for geometric passes."""
    from acmmp_spherical_torch.ops.kernels.warp_image import warp_src_frames

    H, W = ref_image.shape
    hr, wr = rect_shape(H, W)
    hb, wb = comp_hw if comp_hw is not None else (hr, wr)
    pr = build_pair_rect(ref_cam, src_cams, (hr, wr))
    S = pr.H0.shape[0]
    dev = ref_image.device

    # (8, 128)-aligned compute-grid offset: the warped ref footprint's corner
    cxs = torch.tensor([0.0, W - 1.0, 0.0, W - 1.0], device=dev)
    cys = torch.tensor([0.0, 0.0, H - 1.0, H - 1.0], device=dev)
    off_y, off_x = [], []
    for s in range(S):
        xr, yr, _ = rect_coords(pr.H0[s], cxs, cys)
        off_x.append(torch.clamp(torch.floor((xr.amin() - 2.0) / 128.0) * 128.0,
                                 0.0, float(wr - wb)))
        off_y.append(torch.clamp(torch.floor((yr.amin() - 2.0) / 8.0) * 8.0,
                                 0.0, float(hr - hb)))
    off_y = torch.stack(off_y)
    off_x = torch.stack(off_x)

    Wi, Hi = int(ref_cam.width), int(ref_cam.height)
    rect_ref = torch.stack([warp_to_rect(ref_image, pr.H0inv[s], Wi, Hi,
                                         (hr, wr)) for s in range(S)])
    rect_src = warp_src_frames(src_images, pr.H1inv, src_cams.width,
                               src_cams.height, (hr, wr), warp_hw)

    # backward map: original pixel -> nearest rect pixel (bbox coords)
    xs_o, ys_o = grid_coords(H, W, dev)
    bx, by, bok = [], [], []
    for s in range(S):
        xr, yr, z = rect_coords(pr.H0[s], xs_o, ys_o)
        xb = torch.round(xr) - off_x[s]
        yb = torch.round(yr) - off_y[s]
        bok.append((z > 0) & (xb >= 0) & (xb < wb) & (yb >= 0) & (yb < hb))
        bx.append(torch.clamp(xb, 0, wb - 1).to(torch.int64).reshape(-1))
        by.append(torch.clamp(yb, 0, hb - 1).to(torch.int64).reshape(-1))
    bwd_x, bwd_y, bwd_ok = torch.stack(bx), torch.stack(by), torch.stack(bok)

    if inv_attrib:
        attrib = _attribution_inverse(pr, off_y, off_x, (hb, wb), (H, W))
    else:
        attrib = _attribution_scatter(bwd_x, bwd_y, bwd_ok, (hb, wb), (H, W))
    maps, tile_oy, tile_ox = build_transport_maps(
        bwd_x, bwd_y, bwd_ok, (hb, wb), (H, W), off_y, off_x, attrib,
        live_n=live_n, warp_hw=warp_hw, count_claims=not inv_attrib)

    dmin, dmax = depth_range
    fB = pr.K[:, 0] * pr.baseline
    srow = torch.zeros((S, 128), dtype=torch.float32, device=dev)
    srow[:, 0] = fB / torch.clamp(dmax, min=1e-6) - 2.0
    srow[:, 1] = fB / torch.clamp(dmin, min=1e-6) + 2.0
    srow[:, 2] = off_y
    srow[:, 3] = off_x
    srow[:, 4] = 1.0 / torch.clamp(pr.scale, min=1e-6)
    rect_sdisp = None
    if src_depths is not None:
        rect_sdisp = build_rect_sdisp(pr, src_depths, src_cams, (hr, wr),
                                      warp_hw)
    return RectContext(pr=pr, rect_ref=rect_ref, rect_src=rect_src, maps=maps,
                       tile_oy=tile_oy, tile_ox=tile_ox, srow=srow,
                       rect_sdisp=rect_sdisp)


def build_rect_sdisp(pr: PairRect, src_depths, src_cams: Cameras, rect_hw,
                     warp_hw):
    """Warp each source depth map into its pair's rect frame as the implied
    rect disparity (kernel ``warp_src_disparities``): trunc-nearest depth
    lookup like the reference's depth reads (ACMMP.cu:657), SENTINEL where
    the source has no valid depth.  ``warp_hw`` enables the per-tile gate of
    the TPU kernel; None is the reference's ungated XLA ``warp_disp``."""
    from acmmp_spherical_torch.ops.kernels.warp_image import (
        warp_src_disparities,
    )

    return warp_src_disparities(
        src_depths, pr.H1inv, pr.R_sr, src_cams.K, pr.K[:, 0] * pr.baseline,
        src_cams.width, src_cams.height, rect_hw, warp_hw)
