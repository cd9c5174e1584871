"""The bf16 pair-word source frame of the packed taps (``pack_src_pairs``)
and the read of kernels 1p / 4p that rests on it, on the CPU.

(a) ``pack_src_pairs_plain`` equals ``pack_ab`` of the frame and the frame
    shifted by one column, word for word -- the port's ``pack_ab`` and the
    JAX package's -- on numpy-seeded frames that hold SENTINEL, +-inf, NaN
    of both signs with payloads, bf16 ties to even, subnormals and values
    that round up to inf, at an odd width; the last column's low half is
    SENTINEL's word, and ``pack_src_pairs`` on a CPU tensor is the plain
    version;
(b) unpacking the pair frame gives ``round_bf16(src[x])`` and
    ``round_bf16(src[x + 1])`` bit for bit at every column <= Wp - 2 (the
    columns the rect kernel reads);
(c) a pure-torch emulation of the packed kernel's read -- one pair word per
    tap and per centre check, unpacked, the window test, the select-based
    sums and the operation order of ``csrc/rect_ncc.cu`` -- equals
    ``rect_ncc_plain`` with ``rect_tap_pack`` (which rounds the f32 frame)
    bit for bit, photometric and with_geom, on the 96x64x3src pinhole
    context and the 128x64x3src SPHERE context, and differs from the f32
    variant;
(d) ``prepare_inputs`` attaches the pair frame once, only with the pack on:
    preparing a prepared problem (the prior round) keeps it.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.bench import (  # noqa: E402
    GOLDEN_SCENE, SPHERE_GOLDEN_SCENE, make_problem, make_sphere_problem,
)
from acmmp_spherical_torch.ops import rng as R  # noqa: E402
from acmmp_spherical_torch.ops import sphere_rect as SR  # noqa: E402
from acmmp_spherical_torch.ops.kernels import ncc_rect as NR  # noqa: E402
from acmmp_spherical_torch.ops.propagate import prepare_inputs  # noqa: E402
from acmmp_spherical_torch.ops.rectify import (  # noqa: E402
    PAD_X, SENTINEL, SENTINEL_THRESH,
)
from acmmp_spherical_torch.ops.sampling import (  # noqa: E402
    checkerboard_pack, grid_coords,
)

# f32 words the frames must hold: ties to even on both parities, the
# largest finite value (rounds to inf), infinities, NaN of both signs with
# payloads, subnormals, SENTINEL
SPECIAL_WORDS = np.array(
    [0x3F808000, 0x3F818000, 0x3F80FFFF, 0x3F807FFF, 0x7F7FFFFF, 0xFF7FFFFF,
     0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345,
     0x00018000, 0x80028000, 0x00000000, 0x80000000], dtype=np.uint32)


def _frame(seed: int, shape=(2, 5, 37)) -> torch.Tensor:
    """A seeded frame of image-like values with every special word, and
    SENTINEL runs as the rect warps leave them."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 255.0, shape).astype(np.float32)
    bits = f.view(np.uint32)
    flat = bits.reshape(-1)
    pos = rng.choice(flat.size, 3 * SPECIAL_WORDS.size, replace=False)
    flat[pos] = np.tile(SPECIAL_WORDS, 3)
    ties = rng.random(flat.size) < 0.2          # more ties, both parities
    flat[ties] = (flat[ties] & 0xFFFF0000) | 0x8000
    f[..., : shape[-1] // 5] = SENTINEL
    f[:, 0, -3:] = SENTINEL
    return torch.from_numpy(f.copy())


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy().view(np.uint32)


def _jax_pack_ab(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    import jax.numpy as jnp

    from acmmp_spherical_tpu.ops.pallas import ncc_rect as JNR

    out = JNR.pack_ab(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    return np.asarray(out).view(np.uint32)


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_src_pairs_plain_is_pack_ab_of_the_shifted_frame(seed, package):
    src = _frame(seed)
    words = NR.pack_src_pairs_plain(src)
    assert words.dtype == torch.int32 and words.shape == src.shape
    pack = ((lambda a, b: _bits(NR.pack_ab(a, b))) if package == "port"
            else _jax_pack_ab)
    got = _bits(words)
    np.testing.assert_array_equal(got[..., :-1],
                                  pack(src[..., :-1], src[..., 1:]))
    np.testing.assert_array_equal(
        got[..., -1], pack(src[..., -1], torch.full_like(src[..., -1],
                                                         SENTINEL)))
    # every special word went through, and the last low half is SENTINEL's
    assert np.isin(SPECIAL_WORDS, _bits(src)).all()
    assert (got[..., -1] & 0xFFFF == 0xC61C).all()
    assert torch.equal(NR.pack_src_pairs(src), words)


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_frame_unpacks_to_rounded_neighbours(seed):
    src = _frame(seed)
    hi, lo = NR.unpack_ab(NR.pack_src_pairs_plain(src))
    rounded = _bits(NR.round_bf16(src))
    np.testing.assert_array_equal(_bits(hi)[..., :-1], rounded[..., :-1])
    np.testing.assert_array_equal(_bits(lo)[..., :-1], rounded[..., 1:])
    # the NaN words keep their sign and read back as NaN
    nan = torch.isnan(src[..., :-1])
    assert bool(nan.any()) and torch.isnan(hi[..., :-1][nan]).all()
    assert torch.equal(torch.signbit(hi[..., :-1][nan]),
                       torch.signbit(src[..., :-1][nan]))


def _kernel_read(srow, tile_oy, tile_ox, rect_ref, src_pk, D, AB, fwd_valid,
                 params, sdisp=None):
    """The packed kernel's read in plain torch, in csrc/rect_ncc.cu's order:
    per candidate the window's middle column and the centre check from one
    pair word; per tap one pair word at ``inwin ? trunc(xf) : 0``, unpacked
    (``unpack_ab``), and the six sums kept by selects."""
    C, S, K8, _ = D.shape
    N = K8 // NR.TILE_H
    win_w = params.rect_win_w or 384
    Hp, Wp = rect_ref.shape[1:]
    inv_2ss, inv_2sc, clampv, _, offs = NR._weight_consts(params)
    rr = torch.arange(NR.TILE_H).reshape(1, 1, NR.TILE_H, 1)
    ll = torch.arange(NR.TILE_W).reshape(1, 1, 1, NR.TILE_W)
    oy = tile_oy.to(torch.int64).reshape(S, N, 1, 1)
    ox = tile_ox.to(torch.int64).reshape(S, N, 1, 1)
    sidx = torch.arange(S).reshape(S, 1, 1, 1)
    ep = torch.exp(torch.clamp(rect_ref, -clampv, clampv) * inv_2sc)
    en = 1.0 / ep
    ref_at = lambda fr, dy, dx: fr[sidx, oy + NR.TILE_H + dy + rr,
                                   ox + PAD_X + dx + ll]
    cen_p, cen_n = ref_at(ep, 0, 0), ref_at(en, 0, 0)
    valid = fwd_valid.reshape(S, N, NR.TILE_H, NR.TILE_W) > 0.5
    xg = ox.to(torch.float32) + ll.to(torch.float32)
    half_w = 0.5 * float(win_w - 2)
    words = src_pk.reshape(S, -1)

    def pair(dy, xi):   # the unpacked word at column xi of the tap's row
        flat = (oy + NR.TILE_H + dy + rr) * Wp + PAD_X + xi
        w = torch.gather(words, 1, flat.reshape(S, -1)).reshape(flat.shape)
        return (*NR.unpack_ab(w), flat)

    out = torch.empty_like(D)
    gout = None if sdisp is None else torch.empty_like(D)
    for c in range(C):
        Dc = D[c].reshape(S, N, NR.TILE_H, NR.TILE_W)
        Ac, Bc = NR.unpack_ab(AB[c].reshape(S, N, NR.TILE_H, NR.TILE_W))
        lo = (xg - torch.clamp(Dc, srow[:, 0].reshape(S, 1, 1, 1),
                               srow[:, 1].reshape(S, 1, 1, 1))
              ).amin((2, 3), keepdim=True)
        cmin = torch.floor((lo - 6.0) / 128.0).to(torch.int64) * 128
        cmin = torch.clamp(cmin, -PAD_X, Wp - PAD_X - win_w)
        mid_c = cmin.to(torch.float32) + half_w

        def tap(dx, dy, mid):
            xsrc = (xg + dx) - ((Dc + Ac * dx) + Bc * dy)
            xf = torch.floor(xsrc)
            inwin = (xf - mid).abs() <= half_w
            xi = torch.where(inwin, xf, 0.0).to(torch.int64)
            g0, g1, flat = pair(dy, xi)
            ok = inwin & (g0 > SENTINEL_THRESH) & (g1 > SENTINEL_THRESH)
            return xsrc, xf, g0, g1, ok, flat

        _, _, _, _, ok_c, flat_c = tap(0, 0, mid_c)
        ok_c = ok_c & (Dc > 0.0) & valid
        mid = torch.where(ok_c, mid_c, math.inf)
        if sdisp is not None:
            dval = torch.gather(sdisp.reshape(S, -1), 1, flat_c.reshape(
                S, -1)).reshape(flat_c.shape)
            gv = torch.clamp((Dc - dval).abs() * srow[:, 4].reshape(
                S, 1, 1, 1), max=params.geom_max_cost)
            gout[c] = torch.where(ok_c & (dval > SENTINEL_THRESH), gv,
                                  params.geom_max_cost).reshape(D[c].shape)
        s_bw = s_r = s_rr = s_s = s_ss = s_rs = torch.zeros_like(Dc)
        for dy in offs:
            for dx in offs:
                sw = math.exp(-float((dx * dx + dy * dy) ** 0.5) * inv_2ss)
                ref_pix = ref_at(rect_ref, dy, dx)
                wgt = sw * torch.minimum(ref_at(ep, dy, dx) * cen_n,
                                         ref_at(en, dy, dx) * cen_p)
                wr = wgt * ref_pix
                wrr = wr * ref_pix
                # a candidate that failed its centre check has mid = inf
                xsrc, xf, g0, g1, ok, _ = tap(dx, dy, mid)
                v = g0 + (g1 - g0) * (xsrc - xf)
                wv = wgt * v
                s_bw = torch.where(ok, s_bw + wgt, s_bw)
                s_r = torch.where(ok, s_r + wr, s_r)
                s_rr = torch.where(ok, s_rr + wrr, s_rr)
                s_s = torch.where(ok, s_s + wv, s_s)
                s_ss = torch.where(ok, s_ss + wv * v, s_ss)
                s_rs = torch.where(ok, s_rs + wr * v, s_rs)
        inv_bw = 1.0 / torch.clamp(s_bw, min=1e-12)
        m_ref, m_src = s_r * inv_bw, s_s * inv_bw
        var_ref = s_rr * inv_bw - m_ref * m_ref
        var_src = s_ss * inv_bw - m_src * m_src
        covar = s_rs * inv_bw - m_ref * m_src
        ncc = 1.0 - covar * torch.rsqrt(torch.clamp(var_ref * var_src,
                                                    min=1e-30))
        cost = torch.clamp(ncc, 0.0, params.cost_max)
        bad = ((s_bw < 1e-6) | (var_ref < 1e-5) | (var_src < 1e-5)
               | (mid == math.inf))
        out[c] = torch.where(bad, params.cost_max, cost).reshape(D[c].shape)
    return out if sdisp is None else (out, gout)


@pytest.fixture(scope="module")
def problems():
    """(inputs, params, ground-truth reference depth and world normals) of
    the pinhole and SPHERE golden rings with both packs on, the ground
    truth as the source depths."""
    out = {}
    for kind in ("pinhole", "sphere"):
        inputs, params, gt, nrm = (
            make_problem(**GOLDEN_SCENE, device="cpu", packs=True)
            if kind == "pinhole" else
            make_sphere_problem(**SPHERE_GOLDEN_SCENE, device="cpu",
                                packs=True))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        inputs = dataclasses.replace(inputs, src_depths=t(gt[1:]))
        out[kind] = (inputs, params, t(gt[0]), t(nrm[0]))
    return out


def _operands(kind, problem, with_geom):
    """The packed kernel's operands on the context: 5 candidate planes of
    the parity-1 half-grid, random ones or (with_geom) the ground truth's
    with w scaled by 1 + 0.01 k, transported -> (context, frame args,
    candidate args, params)."""
    from acmmp_spherical_torch.core import geometry as G

    inputs, params, depth, normal_world = problem
    p = params.with_geom(multi_geometry=False) if with_geom else params
    ctx = prepare_inputs(inputs, p).rect
    H, W = inputs.ref_image.shape
    xs, ys = grid_coords(H, W, "cpu")
    cam = inputs.ref_cam
    if with_geom:
        n = G.normalize(G.normal_world_to_cam(cam, normal_world))
        w = G.dist_to_origin(cam, xs, ys, depth, n)
        planes = [(n, w * (1.0 + 0.01 * k)) for k in range(-2, 3)]
    else:
        planes = [R.random_plane_hypothesis(
            R.key(70 + k), cam, xs, ys, *inputs.depth_range)
            for k in range(5)]
    normals = torch.stack([checkerboard_pack(a.movedim(-1, 0), 1).movedim(
        0, -1) for a, _ in planes]).contiguous()
    ws = torch.stack([checkerboard_pack(b, 1) for _, b in planes])
    maps = ctx.maps[2]
    if kind == "pinhole":
        D, AB = NR.coefficient_transport_plain(ctx, maps, normals, ws)
    else:
        D, AB = NR.warp_transport_plain(*SR.sphere_coefficient_tables(
            ctx, normals, ws, 1), maps.fwd_idx, maps.fwd_valid)
    return ctx, (ctx.srow, ctx.tile_oy, ctx.tile_ox, ctx.rect_ref), (
        D, AB, maps.fwd_valid), p


@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
@pytest.mark.parametrize("kind", ["pinhole", "sphere"])
def test_packed_kernel_read_matches_rect_ncc_plain(problems, kind,
                                                   with_geom):
    ctx, frame_args, cand_args, p = _operands(kind, problems[kind],
                                              with_geom)
    sd = dict(sdisp=ctx.rect_sdisp) if with_geom else {}
    assert torch.equal(ctx.rect_src_pk, NR.pack_src_pairs_plain(ctx.rect_src))
    want = NR.rect_ncc_plain(*frame_args, ctx.rect_src, *cand_args, p, **sd)
    got = _kernel_read(*frame_args, ctx.rect_src_pk, *cand_args, p, **sd)
    for a, b in zip(got, want) if with_geom else ((got, want),):
        assert torch.equal(a, b)
    cost = want[0] if with_geom else want
    live = cost < p.cost_max
    assert float(live.float().mean()) > 0.05
    if with_geom:
        assert bool((want[1] < p.geom_max_cost).any())
    f32 = NR.rect_ncc_plain(*frame_args, ctx.rect_src, *cand_args,
                            dataclasses.replace(p, rect_tap_pack=False), **sd)
    assert not torch.equal(f32[0] if with_geom else f32, cost)


@pytest.mark.parametrize("kind", ["pinhole", "sphere"])
def test_prepare_inputs_makes_the_pair_frame_once(problems, kind):
    inputs, params = problems[kind][:2]
    prepared = prepare_inputs(inputs, params)
    pk = prepared.rect.rect_src_pk
    assert torch.equal(pk, NR.pack_src_pairs_plain(prepared.rect.rect_src))
    again = prepare_inputs(prepared, params.with_planar_prior())
    assert again is prepared and again.rect.rect_src_pk is pk
    off = dataclasses.replace(params, rect_tap_pack=False)
    assert prepare_inputs(inputs, off).rect.rect_src_pk is None
    # a context made without the pack gains the frame when the pack is on
    late = prepare_inputs(prepare_inputs(inputs, off), params)
    assert torch.equal(late.rect.rect_src_pk, pk)
