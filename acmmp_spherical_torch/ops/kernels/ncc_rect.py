"""Rectified bilateral-NCC evaluation of candidate plane batches (counterpart
of acmmp_spherical_tpu/ops/pallas/ncc_rect.py, pinhole path).

``rect_batched_ncc`` moves each pair's affine disparity coefficients onto
the compacted live tiles (kernel ``warp_transport``, entry
``coefficient_transport``: D and the packed AB word are computed at each
claimed pixel from the plane fields, so no coefficient table is written),
evaluates the cost (kernel ``rect_ncc``; in geometric passes its with_geom
variant, which also returns the fused geometric cost) and maps the cost
planes back to the evaluation grid with a gather by ``bwd_cidx``.  The
transport's plain version is ``coefficient_tables`` (the reference's XLA
pre-step in plain torch) followed by ``warp_transport_plain`` (the masked
gather the Pallas kernel computes).  A and B ride as one bf16 pair word
(``pack_ab``): the reference applies that rounding unconditionally, so it is
part of the algorithm.

The reference's two bf16 packs, both on by default, take effect here as
there.  ``params.rect_tap_pack``: the Pallas kernel reads both bilinear
x-neighbours of a tap as one bf16 pair word, which rounds every source value
a tap or the centre check samples to bf16 (round to nearest even) and
changes nothing else -- the reference side and the with_geom disparity
window stay f32.  So the packed kernel is the f32 kernel on a source frame
rounded to bf16 (``round_bf16``).  Kernel 1 reads the pair words from a
frame that kernel ``pack_src_pairs`` makes once per context
(``with_src_pairs``, kept as ``rect_src_pk``): one 32-bit load per tap; the
plain version rounds the f32 frame.  ``params.rect_backmap_pack`` (C > 1): cost
pairs ride one bf16 pair word through the back-map gather, which rounds
every mapped-back cost (the geometric one too) to bf16; the fill of
unclaimed pixels stays exact f32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.ops.kernels import _lib
from acmmp_spherical_torch.ops.rectify import (
    PAD_X, SENTINEL, SENTINEL_THRESH, RectContext,
)

TILE_H = 8
TILE_W = 128


def _to_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even bf16 bits of an f32 tensor, as int64; NaN ->
    0x7FC0 with its sign bit (the reference's conversion).  Done on the bits,
    the same on every device: torch's own ``.to(torch.bfloat16)`` writes
    other NaN words (0xFFFF on the CPU)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rne = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF
    return torch.where(torch.isnan(x), ((u >> 16) & 0x8000) | 0x7FC0, rne)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 by ``_to_bf16_bits``' rule, as f32."""
    bits = _to_bf16_bits(x) << 16
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(torch.float32)


def pack_ab(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(bf16(A), bf16(B)) in one 32-bit word, returned as int32 bits."""
    word = (_to_bf16_bits(A) << 16) | _to_bf16_bits(B)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def unpack_ab(ab: torch.Tensor):
    """Inverse of pack_ab: the two bf16-rounded values as f32."""
    u = ab.to(torch.int64) & 0xFFFFFFFF
    hi = u & 0xFFFF0000
    lo = (u << 16) & 0xFFFFFFFF
    to_f = lambda v: torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(
        torch.int32).view(torch.float32)
    return to_f(hi), to_f(lo)


# ---------------------------------------------------------------------------
# the pair-word source frame of the packed taps
# ---------------------------------------------------------------------------

def pack_src_pairs_plain(rect_src: torch.Tensor) -> torch.Tensor:
    """Plain torch ``pack_src_pairs``: the (S, Hp, Wp) int32 pair words of
    an f32 frame.  Word x holds bf16(src[x]) high and bf16(src[x + 1]) low
    (``pack_ab``); the last column's low half, which no tap reads, holds
    SENTINEL's."""
    nxt = torch.cat([rect_src[..., 1:],
                     torch.full_like(rect_src[..., :1], SENTINEL)], -1)
    return pack_ab(rect_src, nxt)


def pack_src_pairs(rect_src: torch.Tensor) -> torch.Tensor:
    """Kernel ``pack_src_pairs`` (csrc/pack_src_pairs.cu) on a CUDA tensor,
    word for word ``pack_src_pairs_plain``, which runs on a CPU one."""
    if rect_src.device.type == "cpu":
        return pack_src_pairs_plain(rect_src)
    if rect_src.dim() != 3:
        raise ValueError(f"rect_src must be (S, Hp, Wp), got "
                         f"{tuple(rect_src.shape)}")
    S, Hp, Wp = rect_src.shape
    _lib.require(rect_src, "rect_src", torch.float32)
    out = torch.empty((S, Hp, Wp), dtype=torch.int32, device=rect_src.device)
    lib = _lib.library()
    with torch.cuda.device(rect_src.device):
        err = lib.acmmp_pack_src_pairs(rect_src.data_ptr(), out.data_ptr(),
                                       S * Hp, Wp, _lib.stream_ptr(out))
    _lib.check(err, "pack_src_pairs")
    _lib.count_launch("pack_src_pairs")
    return out


def with_src_pairs(ctx, params: PatchMatchParams):
    """``ctx`` (a ``RectContext`` or ``SphereRectContext``) with its
    pair-word frame ``rect_src_pk`` when ``params.rect_tap_pack``: made
    once, so a context that has it (the prior round reuses its pass's)
    keeps it."""
    if not params.rect_tap_pack or ctx.rect_src_pk is not None:
        return ctx
    return dataclasses.replace(ctx, rect_src_pk=pack_src_pairs(ctx.rect_src))


# ---------------------------------------------------------------------------
# kernel 2: coefficient transport onto the live tiles
# ---------------------------------------------------------------------------

def coefficient_tables(rect: RectContext, maps, normals, ws):
    """Per-pair affine disparity tables on the evaluation grid:
    D (S, C, H*Wg) f32 at each pixel's rounded rect coordinates (invalid or
    huge -> -1e9) and the packed (A, B) words (S, C, H*Wg) int32."""
    C, H, Wg = ws.shape
    S = rect.pr.R_rr.shape[0]
    R = rect.pr.R_rr.reshape(S, 1, 3, 3, 1, 1)
    n = normals.movedim(-1, 1)[None]                       # (1, C, 3, H, Wg)
    n_r = [n[:, :, 0] * R[:, :, i, 0] + n[:, :, 1] * R[:, :, i, 1]
           + n[:, :, 2] * R[:, :, i, 2] for i in range(3)]  # (S, C, H, Wg)
    f = rect.pr.K[:, 0].reshape(S, 1, 1, 1)
    wply = ws[None]
    scale = -rect.pr.baseline.reshape(S, 1, 1, 1) / torch.where(
        wply.abs() < 1e-20, torch.full_like(wply, 1e-20), wply)
    A = scale * n_r[0]
    B = scale * n_r[1]
    cterm = scale * n_r[2] * f
    cx = rect.pr.K[:, 1].reshape(S, 1, 1, 1)
    cy = rect.pr.K[:, 2].reshape(S, 1, 1, 1)
    off_x = rect.srow[:, 3].reshape(S, 1, 1, 1)
    off_y = rect.srow[:, 2].reshape(S, 1, 1, 1)
    xb = maps.bwd_x.to(torch.float32).reshape(S, 1, H, Wg)
    yb = maps.bwd_y.to(torch.float32).reshape(S, 1, H, Wg)
    D = A * (xb + off_x - cx) + B * (yb + off_y - cy) + cterm
    D = torch.where(torch.isfinite(D) & (D.abs() < 1e8), D,
                    torch.full_like(D, -1e9))
    return (D.reshape(S, C, H * Wg).contiguous(),
            pack_ab(A, B).reshape(S, C, H * Wg).contiguous())


def warp_transport_plain(tab_d, tab_ab, fwd_idx, fwd_valid):
    """``table[fwd_idx]`` masked by ``fwd_valid`` (invalid: D=-1e9, AB=0),
    the function of the Pallas transport kernel.
    tab_d (S, C, M) f32, tab_ab (S, C, M) int32; fwd_idx (S, P) int32;
    fwd_valid (S, K8, 128).  Returns D, AB (C, S, K8, 128)."""
    S, C, M = tab_d.shape
    K8 = fwd_valid.shape[1]
    P = fwd_idx.shape[1]
    idx = fwd_idx.to(torch.int64)[:, None, :].expand(S, C, P)
    ok = fwd_valid.reshape(S, 1, P) > 0.5
    d = torch.where(ok, torch.gather(tab_d, 2, idx), -1e9)
    ab = torch.where(ok, torch.gather(tab_ab, 2, idx), 0)
    shape = (C, S, K8, TILE_W)
    return (d.transpose(0, 1).reshape(shape).contiguous(),
            ab.transpose(0, 1).reshape(shape).contiguous())


def coefficient_transport_plain(rect: RectContext, maps, normals, ws):
    """Plain torch kernel 2: the coefficient tables of C plane fields
    (normals (C, H, Wg, 3), ws (C, H, Wg)) on one map's grid, gathered onto
    its compact pixels -> D (C, S, K8, 128) f32, AB (C, S, K8, 128) int32."""
    return warp_transport_plain(*coefficient_tables(rect, maps, normals, ws),
                                maps.fwd_idx, maps.fwd_valid)


def coefficient_transport(rect: RectContext, maps, normals, ws):
    """Kernel 2 (csrc/warp_transport.cu) on CUDA tensors: D and AB computed
    at each claimed pixel, bit-identical to ``coefficient_transport_plain``,
    which runs on CPU tensors."""
    if ws.device.type == "cpu":
        return coefficient_transport_plain(rect, maps, normals, ws)
    C, H, Wg = ws.shape
    S = rect.pr.R_rr.shape[0]
    M = H * Wg
    K8 = maps.fwd_valid.shape[1]
    P = K8 * TILE_W
    dev = ws.device
    if P % (TILE_H * TILE_W):
        raise ValueError(f"fwd_valid has {K8} rows, not whole tiles")
    _lib.require(normals, "normals", torch.float32, (C, H, Wg, 3), dev)
    _lib.require(ws, "ws", torch.float32, (C, H, Wg), dev)
    _lib.require(maps.bwd_x, "bwd_x", torch.int64, (S, M), dev)
    _lib.require(maps.bwd_y, "bwd_y", torch.int64, (S, M), dev)
    _lib.require(maps.fwd_idx, "fwd_idx", torch.int32, (S, P), dev)
    _lib.require(maps.fwd_valid, "fwd_valid", torch.float32, (S, K8, TILE_W),
                 dev)
    _lib.require(rect.pr.R_rr, "R_rr", torch.float32, (S, 3, 3), dev)
    _lib.require(rect.pr.K, "K", torch.float32, (S, 3), dev)
    _lib.require(rect.pr.baseline, "baseline", torch.float32, (S,), dev)
    _lib.require(rect.srow, "srow", torch.float32, (S, 128), dev)
    for name, t in (("fwd_idx", maps.fwd_idx), ("fwd_valid", maps.fwd_valid)):
        if t.data_ptr() % 16:   # read as 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    out_d = torch.empty((C, S, K8, TILE_W), dtype=torch.float32, device=dev)
    out_ab = torch.empty((C, S, K8, TILE_W), dtype=torch.int32, device=dev)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.acmmp_warp_transport(
            normals.data_ptr(), ws.data_ptr(), maps.bwd_x.data_ptr(),
            maps.bwd_y.data_ptr(), maps.fwd_idx.data_ptr(),
            maps.fwd_valid.data_ptr(), rect.pr.R_rr.data_ptr(),
            rect.pr.K.data_ptr(), rect.pr.baseline.data_ptr(),
            rect.srow.data_ptr(), out_d.data_ptr(), out_ab.data_ptr(), C, S,
            M, P, _lib.stream_ptr(out_d))
    _lib.check(err, "warp_transport")
    _lib.count_launch("warp_transport")
    return out_d, out_ab


# ---------------------------------------------------------------------------
# kernel 1: the rectified NCC cost
# ---------------------------------------------------------------------------

# The tap patterns (radius, increment) that kernel 1 has unrolled builds
# of (csrc/rect_ncc.cu, ``launch_pattern``), with the suffix of their
# launch keys: the default 11x11 stride-2 pattern (36 taps) and
# ``rect_prescreen``'s coarse 11x11 stride-5 pattern (9 taps).  Any other
# pattern runs the build with runtime tap bounds, counted under the key
# without a suffix.
UNROLLED_TAPS = {(5, 2): "", (5, 5): "_t9"}
# the builds by their offsets per axis (the kernel's kNOff template
# argument, which names them in ptxas' log and the SASS): the unrolled
# patterns and the runtime tap bounds (0)
TAP_BUILDS = {"0": "_runtime", **{str(len(range(-r, r + 1, i))): s or
                                  "_default"
                                  for (r, i), s in UNROLLED_TAPS.items()}}


def launch_key(params: PatchMatchParams, with_geom: bool,
               runtime_taps: bool = False) -> str:
    """The ``LAUNCHES`` key that a ``rect_ncc`` launch at ``params`` counts
    under: ``rect_ncc``, ``_geom`` for the with_geom variant, ``_pk`` for
    packed taps, ``_t9`` for the 9-tap build of the coarse pattern."""
    pattern = (params.patch_size // 2, params.radius_increment)
    return ("rect_ncc" + ("_geom" if with_geom else "")
            + ("_pk" if params.rect_tap_pack else "")
            + ("" if runtime_taps else UNROLLED_TAPS.get(pattern, "")))


def _weight_consts(params: PatchMatchParams):
    inv_2ss = 1.0 / (2.0 * params.sigma_spatial * params.sigma_spatial)
    inv_2sc = 1.0 / (2.0 * params.sigma_color * params.sigma_color)
    r = params.patch_size // 2
    offs = list(range(-r, r + 1, params.radius_increment))
    return inv_2ss, inv_2sc, 40.0 / inv_2sc, r, offs


def rect_ncc_plain(srow, tile_oy, tile_ox, rect_ref, rect_src, D, AB,
                   fwd_valid, params: PatchMatchParams, sdisp=None,
                   src_pk=None):
    """Plain torch kernel 1: loops over candidates and taps and keeps only
    the six running sums per candidate, never a (C, S, taps, 8N, 128)
    tensor.  Same per-tile rules, weight formula and summation order as the
    Pallas kernel; with ``params.rect_tap_pack`` the source values it
    samples are rounded to bf16 (``round_bf16`` of the frame), as the
    reference's packed taps are.  ``src_pk``, the kernel's pair-word frame,
    is not read: rounding ``rect_src`` here holds the kernel and its pair
    frame to account together.  With ``sdisp`` (the with_geom variant) also
    the geometric cost: ``min(geom_max_cost, |D - sdisp| * srow[4])`` with
    sdisp read at the centre tap's source column, ``geom_max_cost`` where
    the centre is invalid or sdisp is SENTINEL; returns (cost, geom)."""
    C, S, K8, _ = D.shape
    N = K8 // TILE_H
    dev = D.device
    win_w = params.rect_win_w or 384
    Hp, Wp = rect_ref.shape[1:]
    if win_w > Wp:
        raise ValueError(f"rect_win_w {win_w} exceeds the frame width {Wp}")
    inv_2ss, inv_2sc, clampv, _, offs = _weight_consts(params)
    cost_max = params.cost_max

    rr = torch.arange(TILE_H, device=dev).reshape(1, 1, TILE_H, 1)
    ll = torch.arange(TILE_W, device=dev).reshape(1, 1, 1, TILE_W)
    oy = tile_oy.to(torch.int64).reshape(S, N, 1, 1)
    ox = tile_ox.to(torch.int64).reshape(S, N, 1, 1)
    sidx = torch.arange(S, device=dev).reshape(S, 1, 1, 1)
    ep = torch.exp(torch.clamp(rect_ref, -clampv, clampv) * inv_2sc)
    en = 1.0 / ep

    def ref_at(frame, dy, dx):   # (S, N, 8, 128) window value at tap (dx, dy)
        return frame[sidx, oy + TILE_H + dy + rr, ox + PAD_X + dx + ll]

    cen_p = ref_at(ep, 0, 0)
    cen_n = ref_at(en, 0, 0)
    taps = []
    for dy in offs:
        for dx in offs:
            sw = math.exp(-float((dx * dx + dy * dy) ** 0.5) * inv_2ss)
            ref_pix = ref_at(rect_ref, dy, dx)
            wgt = sw * torch.minimum(ref_at(ep, dy, dx) * cen_n,
                                     ref_at(en, dy, dx) * cen_p)
            taps.append((dx, dy, wgt, wgt * ref_pix, wgt * ref_pix * ref_pix))

    valid = fwd_valid.reshape(S, N, TILE_H, TILE_W) > 0.5
    dlo = srow[:, 0].reshape(S, 1, 1, 1)
    dhi = srow[:, 1].reshape(S, 1, 1, 1)
    xg = ox.to(torch.float32) + ll.to(torch.float32)
    src_flat = (round_bf16(rect_src) if params.rect_tap_pack
                else rect_src).reshape(S, -1)
    out = torch.empty_like(D)
    gout = None if sdisp is None else torch.empty_like(D)
    for c in range(C):
        Dc = D[c].reshape(S, N, TILE_H, TILE_W)
        Ac, Bc = unpack_ab(AB[c].reshape(S, N, TILE_H, TILE_W))
        lo = (xg - torch.clamp(Dc, dlo, dhi)).amin((2, 3), keepdim=True)
        cmin = torch.floor((lo - 6.0) / TILE_W).to(torch.int64) * TILE_W
        cmin = torch.clamp(cmin, -PAD_X, Wp - PAD_X - win_w)

        def sample(dx: int, dy: int):
            xsrc = xg + dx - (Dc + Ac * dx + Bc * dy)
            xf = torch.floor(xsrc)
            rel = xf.clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64) - cmin
            inwin = (rel >= 0) & (rel <= win_w - 2)
            col = cmin + PAD_X + rel.clamp(0, win_w - 2)
            flat = (oy + TILE_H + dy + rr) * Wp + col
            g0 = torch.gather(src_flat, 1, flat.reshape(S, -1)).reshape(flat.shape)
            g1 = torch.gather(src_flat, 1, (flat + 1).reshape(S, -1)
                              ).reshape(flat.shape)
            ok = inwin & (g0 > SENTINEL_THRESH) & (g1 > SENTINEL_THRESH)
            val = torch.where(ok, g0 + (g1 - g0) * (xsrc - xf), 0.0)
            return val, ok, flat

        _, ok_c, flat_c = sample(0, 0)
        center_ok = ok_c & (Dc > 0.0) & valid
        if sdisp is not None:
            # the centre tap's column: in the window wherever center_ok
            dval = torch.gather(sdisp.reshape(S, -1), 1,
                                flat_c.reshape(S, -1)).reshape(flat_c.shape)
            gok = center_ok & (dval > SENTINEL_THRESH)
            err = (Dc - dval).abs() * srow[:, 4].reshape(S, 1, 1, 1)
            gmax = params.geom_max_cost
            gout[c] = torch.where(gok, torch.clamp(err, max=gmax),
                                  gmax).reshape(S, K8, TILE_W)
        s_bw = s_r = s_rr = s_s = s_ss = s_rs = torch.zeros_like(Dc)
        for dx, dy, wgt, wr, wrr in taps:
            val, ok, _ = sample(dx, dy)
            okf = ok.float()
            w_t = okf * wgt
            s_bw = s_bw + w_t
            s_r = s_r + okf * wr
            s_rr = s_rr + okf * wrr
            s_s = s_s + w_t * val
            s_ss = s_ss + w_t * val * val
            s_rs = s_rs + okf * wr * val
        inv_bw = 1.0 / torch.clamp(s_bw, min=1e-12)
        m_ref = s_r * inv_bw
        m_src = s_s * inv_bw
        var_ref = s_rr * inv_bw - m_ref * m_ref
        var_src = s_ss * inv_bw - m_src * m_src
        covar = s_rs * inv_bw - m_ref * m_src
        ncc = 1.0 - covar * torch.rsqrt(torch.clamp(var_ref * var_src, min=1e-30))
        cost = torch.clamp(ncc, 0.0, cost_max)
        bad = ((s_bw < 1e-6) | (var_ref < 1e-5) | (var_src < 1e-5)
               | ~center_ok)
        out[c] = torch.where(bad, cost_max, cost).reshape(S, K8, TILE_W)
    return out if sdisp is None else (out, gout)


def rect_ncc(srow, tile_oy, tile_ox, rect_ref, rect_src, D, AB, fwd_valid,
             params: PatchMatchParams, sdisp=None, src_pk=None, *,
             runtime_taps: bool = False):
    """Kernel 1 (csrc/rect_ncc.cu) on CUDA tensors; the plain version on CPU
    tensors.  Returns the (C, S, 8N, 128) cost planes; with ``sdisp`` (S, Hp,
    Wp) the with_geom variant, returning (cost, geom) planes.  With
    ``params.rect_tap_pack`` the packed-tap variant runs on ``src_pk``,
    ``pack_src_pairs(rect_src)`` (the context's ``rect_src_pk``).  The
    default tap pattern and ``rect_prescreen``'s coarse one run their
    unrolled builds (``UNROLLED_TAPS``), any other pattern -- or any pattern
    with ``runtime_taps``, to time the two side by side -- the build with
    runtime tap bounds.  Counted under ``launch_key``."""
    if D.device.type == "cpu":
        return rect_ncc_plain(srow, tile_oy, tile_ox, rect_ref, rect_src, D,
                              AB, fwd_valid, params, sdisp)
    C, S, K8, _ = D.shape
    N = K8 // TILE_H
    dev = D.device
    Hp, Wp = rect_ref.shape[1:]
    win_w = params.rect_win_w or 384
    if win_w > Wp or K8 % TILE_H:
        raise ValueError(f"bad rect_ncc shapes: win_w={win_w}, frame "
                         f"{(Hp, Wp)}, K8={K8}")
    _lib.require(srow, "srow", torch.float32, (S, 128), dev)
    _lib.require(tile_oy, "tile_oy", torch.int32, (S, N), dev)
    _lib.require(tile_ox, "tile_ox", torch.int32, (S, N), dev)
    _lib.require(rect_ref, "rect_ref", torch.float32, (S, Hp, Wp), dev)
    _lib.require(rect_src, "rect_src", torch.float32, (S, Hp, Wp), dev)
    _lib.require(D, "D", torch.float32, (C, S, K8, TILE_W), dev)
    _lib.require(AB, "AB", torch.int32, (C, S, K8, TILE_W), dev)
    _lib.require(fwd_valid, "fwd_valid", torch.float32, (S, K8, TILE_W), dev)
    pack = bool(params.rect_tap_pack)
    if pack:
        if src_pk is None:
            raise ValueError("rect_tap_pack needs src_pk, the pair-word "
                             "frame pack_src_pairs(rect_src)")
        _lib.require(src_pk, "src_pk", torch.int32, (S, Hp, Wp), dev)
    inv_2ss, inv_2sc, clampv, r, offs = _weight_consts(params)
    if len(offs) ** 2 > 64 or r > 8:
        raise ValueError("rect_ncc supports patch radius <= 8 and <= 64 taps")
    out = torch.empty((C, S, K8, TILE_W), dtype=torch.float32, device=dev)
    lib = _lib.library()
    common = (srow.data_ptr(), tile_oy.data_ptr(), tile_ox.data_ptr(),
              rect_ref.data_ptr(), rect_src.data_ptr(), D.data_ptr(),
              AB.data_ptr(), fwd_valid.data_ptr(), out.data_ptr())
    shape = (C, S, N, Hp, Wp, win_w, r, params.radius_increment,
             int(runtime_taps), src_pk.data_ptr() if pack else None)
    key = launch_key(params, sdisp is not None, runtime_taps)
    if sdisp is None:
        with torch.cuda.device(dev):
            err = lib.acmmp_rect_ncc(*common, *shape, inv_2sc, clampv,
                                     params.cost_max, inv_2ss,
                                     _lib.stream_ptr(out))
        _lib.check(err, key)
        _lib.count_launch(key)
        return out
    _lib.require(sdisp, "sdisp", torch.float32, (S, Hp, Wp), dev)
    gout = torch.empty_like(out)
    with torch.cuda.device(dev):
        err = lib.acmmp_rect_ncc_geom(
            *common, sdisp.data_ptr(), gout.data_ptr(), *shape, inv_2sc,
            clampv, params.cost_max, params.geom_max_cost, inv_2ss,
            _lib.stream_ptr(out))
    _lib.check(err, key)
    _lib.count_launch(key)
    return out, gout


# ---------------------------------------------------------------------------
# the batched evaluation around the kernels
# ---------------------------------------------------------------------------

def backmap(cost, maps, out_hw, fill, pack: bool = False):
    """(C, S, 8N, 128) cost planes -> (C, S, H, Wg) through ``bwd_cidx``;
    pixels without a claimed rect pixel read ``fill``.  ``pack``
    (``params.rect_backmap_pack``) with C > 1: the mapped-back costs are
    rounded to bf16, which is what the reference's pair-packed gather and
    unpack compute (its zero pad of an odd C is never read)."""
    C, S = cost.shape[:2]
    H, Wg = out_hw
    flat = cost.reshape(C, S, -1)
    idx = maps.bwd_cidx[None].expand(C, S, H * Wg)
    out = torch.gather(flat, 2, idx).reshape(C, S, H, Wg)
    if pack and C > 1:
        out = round_bf16(out)
    return torch.where(maps.bwd_valid[None], out, torch.full_like(out, fill))


def rect_batched_ncc(rect: RectContext, normals, ws, params: PatchMatchParams,
                     *, parity=None, with_geom: bool = False):
    """Evaluate C candidate plane fields (C, H, Wg[, 3]) against S sources ->
    (C, S, H, Wg).  ``parity`` None: full-grid fields with the full map;
    0/1: checkerboard-packed half-grid fields with that colour's map.
    ``with_geom`` also returns the geometric cost planes against
    ``rect.rect_sdisp`` -> (cost, geom); pixels without a rect pixel read
    ``geom_max_cost`` there."""
    C, H, Wg = ws.shape
    maps = rect.maps[0 if parity is None else 1 + parity]
    D, AB = coefficient_transport(rect, maps, normals, ws)
    args = (rect.srow, rect.tile_oy, rect.tile_ox, rect.rect_ref,
            rect.rect_src, D, AB, maps.fwd_valid, params)
    pack = params.rect_backmap_pack
    if not with_geom:
        return backmap(rect_ncc(*args, src_pk=rect.rect_src_pk), maps,
                       (H, Wg), params.cost_max, pack)
    if rect.rect_sdisp is None:
        raise ValueError("with_geom needs the context's rect_sdisp")
    cost, geom = rect_ncc(*args, sdisp=rect.rect_sdisp,
                          src_pk=rect.rect_src_pk)
    return (backmap(cost, maps, (H, Wg), params.cost_max, pack),
            backmap(geom, maps, (H, Wg), params.geom_max_cost, pack))
