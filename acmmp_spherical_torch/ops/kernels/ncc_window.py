"""Windowed multi-view bilateral-NCC of a batch of plane fields on the
unrectified pinhole path (counterpart of
acmmp_spherical_tpu/ops/pallas/ncc_window.py, which evaluates one field per
call).

Per (field, source view, 8x128 tile of the evaluation grid) a 40x384 source
window is placed from the centre-tap projections (``compute_center_windows``,
plain torch as in the reference's XLA pre-pass); every tap's plane depth is
moved into the source frame with the pair's relative pose
(``pack_pair_params``), projected and sampled bilinearly *from that window*:
a sample is used only where it lies in the image and its corner lies in the
window.  The window is part of the algorithm (ROADMAP, "the 8x128 tile keeps
its meaning"), so both versions below keep it exactly.  Each field's costs
depend on that field alone: a batch of C fields gives, field by field, the
bits of C one-field calls.

* ``windowed_multiview_ncc_plain`` -- plain torch, the CPU path and the
  reference the kernel is checked against on the card;
* ``windowed_multiview_ncc`` -- kernel ``ncc_window`` (csrc/ncc_window.cu,
  one launch for the batch) on CUDA tensors, the plain version on CPU
  tensors; with ``src_depths`` the with_geom variant (``ncc_window_geom``),
  which also returns the truncated-lookup forward-backward geometric cost
  from the same window.

Two rules of the Pallas kernel that differ from the exact path are kept:
the +1 bilinear corners are read from the storage row/column after the
floored corner, not clamped at the logical border; and the ``bad`` mask
tests only the centre's *in-image* projection.  The reference's docstring
says a centre outside the window costs ``cost_max``; its code does not do
that, and neither does the port.
"""

from __future__ import annotations

import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core import geometry as G
from acmmp_spherical_torch.core.camera import (
    Camera, Cameras, camera_center, expand_views,
)
from acmmp_spherical_torch.ops.kernels import _lib
from acmmp_spherical_torch.ops.sampling import to_index

TILE_H = 8
TILE_W = 128
WIN_H = 40     # window rows: 8-aligned origin plus slack
WIN_W = 384    # window columns: 128-aligned origin plus slack
_MARGIN_Y = 10
_MARGIN_X = 24
MAX_TAPS = 64  # the kernel keeps the tap offsets in shared memory
MAX_VIEWS = 64  # and a record per view


def pack_pair_params(ref_cam: Camera, src_cams: Cameras) -> torch.Tensor:
    """(S, 128) float32 rows of each (ref, src) pair: [0:9] R_rel (row
    major), [9:12] t_rel, [12] 1/fx_ref, [13] 1/fy_ref, [14] cx_ref,
    [15] cy_ref, [16] fx_src, [17] fy_src, [18] cx_src, [19] cy_src,
    [20] src width, [21] src height, [22] fx_ref, [23] fy_ref, [24] 1/fx_src,
    [25] 1/fy_src; ``X_src = R_rel (depth ray_ref) + t_rel``."""
    S = src_cams.R.shape[0]
    R_rel = (src_cams.R[:, :, None, :] * ref_cam.R[None, None, :, :]).sum(-1)
    dc = camera_center(ref_cam)[None] - camera_center(src_cams)
    t_rel = (src_cams.R * dc[:, None, :]).sum(-1)
    Kr, Ks = ref_cam.K, src_cams.K
    row = torch.zeros((S, 128), dtype=torch.float32, device=R_rel.device)
    row[:, 0:9] = R_rel.reshape(S, 9)
    row[:, 9:12] = t_rel
    row[:, 12] = 1.0 / Kr[0, 0]
    row[:, 13] = 1.0 / Kr[1, 1]
    row[:, 14] = Kr[0, 2]
    row[:, 15] = Kr[1, 2]
    row[:, 16] = Ks[:, 0, 0]
    row[:, 17] = Ks[:, 1, 1]
    row[:, 18] = Ks[:, 0, 2]
    row[:, 19] = Ks[:, 1, 2]
    row[:, 20] = src_cams.width
    row[:, 21] = src_cams.height
    row[:, 22] = Kr[0, 0]
    row[:, 23] = Kr[1, 1]
    row[:, 24] = 1.0 / Ks[:, 0, 0]
    row[:, 25] = 1.0 / Ks[:, 1, 1]
    return row


def _window_origin(vmin: torch.Tensor, margin: int, tile: int,
                   span: int, win: int) -> torch.Tensor:
    """Floor of the per-tile minimum minus ``margin``, floored to the tile
    grid and clipped so the window stays inside ``span``, in the
    reference's int32 arithmetic: the floor saturates to int32 as XLA's
    convert does (clamped in float64: torch's cast of an out-of-range float
    differs between devices) and the margin is subtracted with int32
    wraparound, so a minimum at or below -2^31 places the window at the far
    edge."""
    v = torch.floor(vmin).to(torch.float64).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    v = (v.to(torch.int64) - margin + 2 ** 31) % 2 ** 32 - 2 ** 31
    off = torch.div(v, tile, rounding_mode="floor") * tile
    return off.clamp(0, max((span - win) // tile * tile, 0))


def compute_center_windows(src_cams: Cameras, ref_cam: Camera, normals, ws,
                           xs, ys, src_shape):
    """Per (field, view, tile) window origins from the centre-tap
    projections of the fields (normals (C, H, W, 3), ws (C, H, W)):
    (off_y, off_x) int32 (C, S, TY*TX), tiles in row-major order.
    Non-finite or far-off (|p| >= 1e7) projections count as 1e9."""
    C, H, W = ws.shape
    ty, tx = H // TILE_H, W // TILE_W
    depth = G.depth_from_plane(ref_cam, xs, ys, normals, ws)
    X = G.unproject_world(ref_cam, xs, ys, depth)
    px, py, _ = G.project(expand_views(src_cams, 3), X)
    px, py = px.transpose(0, 1), py.transpose(0, 1)
    ok = (torch.isfinite(px) & torch.isfinite(py) & (px.abs() < 1e7)
          & (py.abs() < 1e7))
    S = px.shape[1]
    tmin = lambda p: torch.where(ok, p, 1e9).reshape(
        C, S, ty, TILE_H, tx, TILE_W).amin((3, 5))
    off_y = _window_origin(tmin(py), _MARGIN_Y, TILE_H, src_shape[0], WIN_H)
    off_x = _window_origin(tmin(px), _MARGIN_X, TILE_W, src_shape[1], WIN_W)
    return (off_y.reshape(C, S, -1).to(torch.int32).contiguous(),
            off_x.reshape(C, S, -1).to(torch.int32).contiguous())


def pad_to_window(stack: torch.Tensor) -> torch.Tensor:
    """Zero-pad a (S, Hp, Wp) stack to at least WIN_H x WIN_W, so every
    window lies inside it."""
    ph, pw = max(WIN_H - stack.shape[1], 0), max(WIN_W - stack.shape[2], 0)
    if ph or pw:
        stack = torch.nn.functional.pad(stack, (0, pw, 0, ph))
    return stack.contiguous()


def _setup(src_images, src_cams, ref_cam, normals, ws, ctx, src_depths):
    """The kernel's operands for C plane fields (normals (C, H, W, 3), ws
    (C, H, W)): padded stacks, window origins, pair rows and the fields
    channel-first."""
    H, W = ws.shape[1:]
    if H % TILE_H or W % TILE_W:
        raise ValueError(f"the evaluation grid {(H, W)} must be a multiple "
                         f"of the {TILE_H}x{TILE_W} tile")
    src = pad_to_window(src_images)
    dep = None if src_depths is None else pad_to_window(src_depths)
    off_y, off_x = compute_center_windows(src_cams, ref_cam, normals, ws,
                                          ctx.xs, ctx.ys, src.shape[1:])
    return dict(src=src, dep=dep, off_y=off_y, off_x=off_x,
                cam=pack_pair_params(ref_cam, src_cams),
                nrm=normals.movedim(-1, 1).contiguous(), w=ws.contiguous(),
                xs=ctx.xs.contiguous(), ys=ctx.ys.contiguous(),
                taps=ctx.ref_taps.contiguous(),
                weights=ctx.weights.contiguous(),
                toff=ctx.offsets.contiguous())


def ncc_window_plain(src, dep, off_y, off_x, cam, nrm, w, xs, ys, taps,
                     weights, toff, params: PatchMatchParams):
    """Plain torch kernel 6 on the operands of ``_setup``: (C, S, H, W)
    costs, or (costs, geometric costs) when ``dep`` is given, one field
    after the other.  Every operation and its order are the kernel's, so on
    the card the two agree bit for bit."""
    outs = [_ncc_window_field(src, dep, off_y[c], off_x[c], cam, nrm[c],
                              w[c], xs, ys, taps, weights, toff, params)
            for c in range(w.shape[0])]
    if dep is None:
        return torch.stack(outs)
    return (torch.stack([cv for cv, _ in outs]),
            torch.stack([gv for _, gv in outs]))


def _ncc_window_field(src, dep, off_y, off_x, cam, nrm, w, xs, ys, taps,
                      weights, toff, params: PatchMatchParams):
    """``ncc_window_plain`` of one field: off_y, off_x (S, TY*TX), nrm
    (3, H, W), w (H, W); (S, H, W) costs [, geometric costs]."""
    S, Hp, Wp = src.shape
    H, W = w.shape
    ty, tx = H // TILE_H, W // TILE_W
    c = lambda k: cam[:, k].reshape(S, 1, 1)
    tile = lambda off: off.to(torch.int64).reshape(S, ty, 1, tx, 1).expand(
        S, ty, TILE_H, tx, TILE_W).reshape(S, H, W)
    y0, x0 = tile(off_y), tile(off_x)
    nx, ny, nz = nrm[0], nrm[1], nrm[2]
    src_flat = src.reshape(S, -1)

    def project(dx: float, dy: float):
        rx = (xs + dx - c(14)) * c(12)
        ry = (ys + dy - c(15)) * c(13)
        denom = nx * rx + ny * ry + nz
        depth = torch.where(denom.abs() < 1e-6, 1e6, -w / denom)
        Xx = rx * depth
        Xy = ry * depth
        sx = c(0) * Xx + c(1) * Xy + c(2) * depth + c(9)
        sy = c(3) * Xx + c(4) * Xy + c(5) * depth + c(10)
        sz = c(6) * Xx + c(7) * Xy + c(8) * depth + c(11)
        inv_z = 1.0 / torch.where(sz.abs() < 1e-6, 1e-6, sz)
        px = (c(16) * sx) * inv_z + c(18)
        py = (c(17) * sy) * inv_z + c(19)
        in_img = (px >= 0.0) & (px < c(20)) & (py >= 0.0) & (py < c(21))
        return px, py, in_img

    _, _, center_in = project(0.0, 0.0)
    s_bw = s_r = s_rr = s_s = s_ss = s_rs = torch.zeros(
        (S, H, W), dtype=torch.float32, device=src.device)
    for t, (dx, dy) in enumerate(toff.tolist()):
        px, py, in_img = project(dx, dy)
        val, in_win = window_bilinear_plain(src_flat, Wp, y0, x0, px, py)
        wgt = torch.where(in_img & in_win, weights[t], 0.0)
        ref = taps[t]
        s_bw = s_bw + wgt
        s_r = s_r + wgt * ref
        s_rr = s_rr + wgt * ref * ref
        s_s = s_s + wgt * val
        s_ss = s_ss + wgt * val * val
        s_rs = s_rs + wgt * ref * val
    inv_bw = 1.0 / torch.clamp(s_bw, min=1e-12)
    m_ref = s_r * inv_bw
    m_src = s_s * inv_bw
    var_ref = s_rr * inv_bw - m_ref * m_ref
    var_src = s_ss * inv_bw - m_src * m_src
    covar = s_rs * inv_bw - m_ref * m_src
    ncc = 1.0 - covar * torch.rsqrt(torch.clamp(var_ref * var_src, min=1e-30))
    cost = torch.clamp(ncc, 0.0, params.cost_max)
    bad = (s_bw < 1e-6) | (var_ref < 1e-5) | (var_src < 1e-5) | ~center_in
    cost = torch.where(bad, params.cost_max, cost)
    if dep is None:
        return cost

    # fused geometric cost (ACMMP.cu:646-671): the source depth at the
    # C-truncated centre projection, read from the NCC window's origin
    gmax = params.geom_max_cost
    pxc, pyc, _ = project(0.0, 0.0)
    xi, yi = to_index(pxc), to_index(pyc)
    in_img = ((pxc >= 0.0) & (xi < c(20).to(torch.int64))
              & (pyc >= 0.0) & (yi < c(21).to(torch.int64)))
    relx, rely = xi - x0, yi - y0
    ok = (in_img & (relx >= 0) & (relx <= WIN_W - 1) & (rely >= 0)
          & (rely <= WIN_H - 1))
    flat = (y0 + rely.clamp(0, WIN_H - 1)) * Wp + x0 + relx.clamp(0, WIN_W - 1)
    src_d = torch.gather(dep.reshape(S, -1), 1, flat.reshape(S, -1)
                         ).reshape(S, H, W)
    rxs = (pxc - c(18)) * c(24)
    rys = (pyc - c(19)) * c(25)
    ax = rxs * src_d - c(9)
    ay = rys * src_d - c(10)
    az = src_d - c(11)
    Xr_x = c(0) * ax + c(3) * ay + c(6) * az
    Xr_y = c(1) * ax + c(4) * ay + c(7) * az
    Xr_z = c(2) * ax + c(5) * ay + c(8) * az
    inv_z = 1.0 / torch.where(Xr_z.abs() < 1e-6, 1e-6, Xr_z)
    bx = (c(22) * Xr_x) * inv_z + c(14)
    by = (c(23) * Xr_y) * inv_z + c(15)
    ex, ey = xs - bx, ys - by
    err = torch.sqrt(ex * ex + ey * ey)
    gcost = torch.where(ok & (src_d > 0.0), torch.clamp(err, max=gmax), gmax)
    return cost, gcost


def window_bilinear_plain(src_flat, Wp, y0, x0, px, py):
    """Bilinear value of each frame of ``src_flat`` (B, Hp*Wp) at (px, py)
    (B, ...) read at the corner clamped into the WIN_H x WIN_W window at
    (y0, x0), and whether the floored corner lies in [0, WIN_W-2] x
    [0, WIN_H-2] of it.  Rows interpolate first, then columns of rows; the
    +1 corners are the next storage column and row (shared with kernel 7)."""
    pxf = torch.floor(px)
    pyf = torch.floor(py)
    fx = px - pxf
    fy = py - pyf
    relx = to_index(pxf) - x0
    rely = to_index(pyf) - y0
    in_win = ((relx >= 0) & (relx <= WIN_W - 2) & (rely >= 0)
              & (rely <= WIN_H - 2))
    flat = ((y0 + rely.clamp(0, WIN_H - 2)) * Wp
            + x0 + relx.clamp(0, WIN_W - 2))
    B = src_flat.shape[0]
    at = lambda i: torch.gather(src_flat, 1, i.reshape(B, -1)).reshape(i.shape)
    g00, g01 = at(flat), at(flat + 1)
    g10, g11 = at(flat + Wp), at(flat + Wp + 1)
    a0 = g00 + (g01 - g00) * fx
    a1 = g10 + (g11 - g10) * fx
    return a0 + (a1 - a0) * fy, in_win


def ncc_window(src, dep, off_y, off_x, cam, nrm, w, xs, ys, taps, weights,
               toff, params: PatchMatchParams):
    """Kernel 6 (csrc/ncc_window.cu), one launch for the C fields, on CUDA
    tensors; the plain version on CPU tensors.  Operands as
    ``ncc_window_plain``."""
    if src.device.type == "cpu":
        return ncc_window_plain(src, dep, off_y, off_x, cam, nrm, w, xs, ys,
                                taps, weights, toff, params)
    S, Hp, Wp = src.shape
    C, H, W = w.shape
    T = taps.shape[0]
    n_tiles = (H // TILE_H) * (W // TILE_W)
    dev = src.device
    if (H % TILE_H or W % TILE_W or T > MAX_TAPS or S > MAX_VIEWS
            or n_tiles > 65535 or C > 65535 or Hp * Wp >= 2 ** 31
            or T * H * W >= 2 ** 31):
        raise ValueError(f"ncc_window: {C} fields of {(H, W)} against "
                         f"{S} views of {(Hp, Wp)} with {T} taps are not "
                         f"supported")
    _lib.require(src, "src", torch.float32, (S, Hp, Wp), dev)
    _lib.require(off_y, "off_y", torch.int32, (C, S, n_tiles), dev)
    _lib.require(off_x, "off_x", torch.int32, (C, S, n_tiles), dev)
    _lib.require(cam, "cam", torch.float32, (S, 128), dev)
    _lib.require(nrm, "nrm", torch.float32, (C, 3, H, W), dev)
    _lib.require(w, "w", torch.float32, (C, H, W), dev)
    for name, t in (("xs", xs), ("ys", ys)):
        _lib.require(t, name, torch.float32, (H, W), dev)
    _lib.require(taps, "taps", torch.float32, (T, H, W), dev)
    _lib.require(weights, "weights", torch.float32, (T, H, W), dev)
    _lib.require(toff, "toff", torch.float32, (T, 2), dev)
    out = torch.empty((C, S, H, W), dtype=torch.float32, device=dev)
    lib = _lib.library()
    common = (off_y.data_ptr(), off_x.data_ptr(), cam.data_ptr(),
              nrm.data_ptr(), w.data_ptr(), xs.data_ptr(), ys.data_ptr(),
              taps.data_ptr(), weights.data_ptr(), toff.data_ptr(),
              out.data_ptr())
    shape = (C, S, H, W, Hp, Wp, T)
    if dep is None:
        with torch.cuda.device(dev):
            err = lib.acmmp_ncc_window(src.data_ptr(), *common, *shape,
                                       params.cost_max, _lib.stream_ptr(out))
        _lib.check(err, "ncc_window")
        _lib.LAUNCHES["ncc_window"] += 1
        return out
    _lib.require(dep, "dep", torch.float32, (S, Hp, Wp), dev)
    gout = torch.empty_like(out)
    with torch.cuda.device(dev):
        err = lib.acmmp_ncc_window_geom(
            src.data_ptr(), dep.data_ptr(), *common, gout.data_ptr(), *shape,
            params.cost_max, params.geom_max_cost, _lib.stream_ptr(out))
    _lib.check(err, "ncc_window_geom")
    _lib.LAUNCHES["ncc_window_geom"] += 1
    return out, gout


def windowed_multiview_ncc(src_images, src_cams: Cameras, ref_cam: Camera,
                           normals, ws, ctx, params: PatchMatchParams,
                           src_depths=None):
    """(C, S, H, W) costs of C plane fields (normals (C, H, W, 3), ws
    (C, H, W) on ``ctx``'s grid, H and W multiples of 8 and 128) against the
    padded source stack (S, Hp, Wp); with ``src_depths`` (S, Hp, Wp) also
    the geometric costs, returned as (cost, geom).  One launch of kernel 6
    on CUDA tensors."""
    return ncc_window(**_setup(src_images, src_cams, ref_cam, normals, ws,
                               ctx, src_depths), params=params)


def windowed_multiview_ncc_plain(src_images, src_cams: Cameras,
                                 ref_cam: Camera, normals, ws, ctx,
                                 params: PatchMatchParams, src_depths=None):
    """``windowed_multiview_ncc`` through the plain version on any device."""
    return ncc_window_plain(**_setup(src_images, src_cams, ref_cam, normals,
                                     ws, ctx, src_depths), params=params)
