"""Port parity of the rectified path's two bf16 packs, ``rect_tap_pack`` and
``rect_backmap_pack`` (both on by default in both packages), on the golden
96x64x3src problem; the Pallas kernels run in interpret mode.  The
reference's packed ``rect_batched_ncc`` runs once per case, op by op (its
``jit`` undone) with its pallas_calls recorded; (1), (2) and (4) share it.

(1) kernels 1 and 4: ``rect_ncc_plain`` with packed taps against the
    reference's interpreted rect kernel with ``rect_tap_pack=True`` on the
    same transported coefficients (the reference's warp transport's D and
    AB; its cost planes taken as the pallas_call returns them),
    photometric and with_geom, both parities: the kernel-1
    tolerance of test_torch_kernels.py (``bad`` mask identical on >= 99.9%,
    costs within 1e-4 on >= 99.9% of the rest and 5e-4 on all of it) and
    the geometric tolerance of test_torch_geom_kernels.py;
(2) the rule the port's packed kernel rests on, on the JAX side alone: the
    interpreted packed kernel equals the interpreted f32 kernel run on the
    source frame rounded to bf16, bit for bit (the reference window and the
    disparity window stay f32), on the operands of (1).  Each interpreted
    kernel compiles for about 10 s on a CPU, so only the with_geom parity-1
    case of (1), (2) and (4) -- its kernel also computes the photometric
    cost -- runs in the fast set; the others are marked slow;
(3) the back-map: the port's ``backmap(pack=True)`` against the reference's
    packed back-map (``run_rect_kernel`` with its pallas_call replaced by
    the given cost planes) at C=1 (not packed), C=5 (odd: a zero pad), C=9,
    and the even C=2 and C=8 of a prescreened half-step, with_geom too: bit
    for bit, with the fill of the pixels a random fifth of the backward map
    leaves unclaimed at its exact f32 value;
(4) ``rect_batched_ncc`` and ``sphere_batched_ncc`` with both packs on
    against the JAX functions (the pinhole one run op by op: the run of
    (1)), on all three pairs: the tolerances of the
    f32 tests (test_torch_kernels.py and test_torch_geom_kernels.py; the
    sphere's end-to-end shares of test_torch_sphere_rect.py).  The back-map
    rounds each cost to bf16, so two costs an f32 rounding apart that
    straddle a bf16 rounding boundary come out one bf16 step apart (2^-7 of
    the cost's binade: 2^-7 for costs in [1, 2)); about 0.2% of the costs
    straddle here.  So the pinhole shares are held at the f32 tests' 1e-4
    on >= 99.7% of the costs (99.9% less the straddlers), and only the
    largest difference may add that step.  The sphere case is marked
    slow (25 s);
(5) the port's rectified golden passes with both packs on, as the
    reference's fixtures were made: ``golden_pass_stats_rect.json`` (no
    claimant window) and ``golden_pass_stats_warp.json`` at the fixtures'
    own 2e-3.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_tpu.core import geometry as JG  # noqa: E402
from acmmp_spherical_tpu.core.camera import stack_cameras as jstack  # noqa: E402
from acmmp_spherical_tpu.ops import rectify as JRT  # noqa: E402
from acmmp_spherical_tpu.ops.pallas import ncc_rect as JNR  # noqa: E402
from acmmp_spherical_tpu.ops.sampling import (  # noqa: E402
    checkerboard_pack, grid_coords,
)
from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.bench import golden_geom_fields  # noqa: E402
from acmmp_spherical_torch.ops.kernels import ncc_rect as TNR  # noqa: E402
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch  # noqa: E402

from test_regression_fixture import (  # noqa: E402
    FIXTURE_RECT, FIXTURE_WARP, _stats, check_against_fixture,
)
from torch_port_util import (  # noqa: E402
    H, W, golden_scene, port_inputs, port_params, rect_dict, rect_params,
)

KEY = 2333
KERNEL_CASES = [pytest.param(False, 0, marks=pytest.mark.slow),
                pytest.param(False, 1, marks=pytest.mark.slow),
                pytest.param(True, 0, marks=pytest.mark.slow), (True, 1)]
KERNEL_IDS = ["phot-parity0", "phot-parity1", "geom-parity0", "geom-parity1"]


@pytest.fixture(scope="module")
def setup():
    cams, tcams, images, depths, normals = golden_scene()
    p = rect_params(cams, packs=True)
    src_depths = golden_geom_fields(depths, normals)[0]
    ctx = JRT.build_rect_context(
        jnp.asarray(images[0]), jnp.asarray(images[1:]), cams[0],
        jstack(cams[1:]), (cams[0].depth_range[0], cams[0].depth_range[1]),
        comp_hw=p.rect_comp_hw, live_n=p.rect_live_n, warp_hw=p.rect_warp_hw,
        inv_attrib=True, src_depths=jnp.asarray(src_depths))
    xs, ys = grid_coords(H, W)
    n_cam = JG.normal_world_to_cam(cams[0], jnp.asarray(normals[0]))
    w = JG.dist_to_origin(cams[0], xs, ys, jnp.asarray(depths[0]), n_cam)
    # the ground-truth plane and one 1% off it
    planes = (jnp.stack([n_cam, n_cam]), jnp.stack([w, w * 1.01]))
    return dict(cams=cams, tcams=tcams, images=images, p=p, ctx=ctx,
                tctx=_tctx(ctx), planes=planes)


def _tctx(ctx):
    return interop.rect_context(rect_dict(ctx), device="cpu")


def _packed(planes, parity):
    n, w = planes
    if parity is None:
        return n, w
    return (jnp.moveaxis(checkerboard_pack(jnp.moveaxis(n, -1, 1), parity), 1,
                         -1), checkerboard_pack(w, parity))


class _Planes:
    """Replaces ``pl.pallas_call`` inside ``run_rect_kernel``: without
    ``fixed`` the real call runs and ``seen`` keeps what it returns; with
    ``fixed`` those planes come back and no kernel runs."""

    def __init__(self, monkeypatch, fixed=None):
        self.seen = []
        real = JNR.pl.pallas_call

        def pallas_call(*args, **kw):
            kernel = real(*args, **kw)

            def call(*operands):
                out = fixed if fixed is not None else kernel(*operands)
                self.seen.append(out)
                return out
            return call
        monkeypatch.setattr(JNR.pl, "pallas_call", pallas_call)


def _jax_raw(setup, monkeypatch, D, AB, parity, with_geom, params,
             rect_src=None):
    """The interpreted kernel's raw (C, S, 8N, 128) planes, as a tuple."""
    ctx = setup["ctx"]
    rec = _Planes(monkeypatch)
    JNR.run_rect_kernel(
        ctx.srow, ctx.rect_ref, ctx.rect_src if rect_src is None else rect_src,
        D, AB, ctx.maps[1 + parity], ctx.tile_oy, ctx.tile_ox, params,
        out_hw=(H, W // 2), interpret=True,
        rect_sdisp=ctx.rect_sdisp if with_geom else None)
    (out,) = rec.seen
    return tuple(np.asarray(a) for a in (out if with_geom else (out,)))


@pytest.fixture(scope="module")
def packed_runs():
    """Cache of the reference's packed evaluation per case."""
    return {}


def _packed_run(setup, monkeypatch, packed_runs, with_geom, parity):
    """The reference's ``rect_batched_ncc`` with both packs on, run op by
    op (its ``jit`` undone) with both Pallas kernels interpreted, once per
    case for (1), (2) and (4): the transported D and AB (the warp
    transport's output), the rect kernel's raw planes as its pallas_call
    returns them, and the mapped-back output."""
    key = (with_geom, parity)
    if key not in packed_runs:
        rec = _Planes(monkeypatch)
        n, w = _packed(setup["planes"], parity)
        out = JNR.rect_batched_ncc.__wrapped__(
            setup["ctx"], n, w, setup["p"], interpret=True, parity=parity,
            with_geom=with_geom)
        (D, AB), raw = rec.seen
        packed_runs[key] = dict(
            D=D, AB=AB, raw=tuple(np.asarray(a) for a in (
                raw if with_geom else (raw,))),
            out=tuple(np.asarray(a) for a in (out if with_geom else (out,))))
    return packed_runs[key]


def _assert_kernel_match(tc, jc, p, tg=None, jg=None):
    bj, bt = jc >= p.cost_max, tc >= p.cost_max
    assert (bj == bt).mean() >= 0.999, (bj == bt).mean()
    assert (~bj).mean() > 0.05
    d = np.abs(tc - jc)[~bj & ~bt]
    assert np.mean(d <= 1e-4) >= 0.999 and d.max() <= 5e-4, d.max()
    if tg is not None:
        gj, gt = jg < p.geom_max_cost, tg < p.geom_max_cost
        assert (gj == gt).mean() >= 0.999, (gj == gt).mean()
        assert gj.mean() > 0.05
        np.testing.assert_allclose(tg[gj & gt], jg[gj & gt], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("with_geom,parity", KERNEL_CASES, ids=KERNEL_IDS)
def test_plain_packed_taps_match_pallas(setup, monkeypatch, packed_runs,
                                        with_geom, parity):
    """(1) rect_ncc_plain with rect_tap_pack against the interpreted packed
    kernel on the same coefficients."""
    run = _packed_run(setup, monkeypatch, packed_runs, with_geom, parity)
    ref = run["raw"]
    D = torch.from_numpy(np.array(run["D"]))
    AB = torch.from_numpy(np.array(run["AB"]).view(np.int32))
    t = setup["tctx"]
    tp = port_params(setup["p"])
    assert tp.rect_tap_pack
    got = TNR.rect_ncc_plain(t.srow, t.tile_oy, t.tile_ox, t.rect_ref,
                             t.rect_src, D, AB, t.maps[1 + parity].fwd_valid,
                             tp, sdisp=t.rect_sdisp if with_geom else None)
    got = tuple(a.numpy() for a in (got if with_geom else (got,)))
    _assert_kernel_match(got[0], ref[0], tp, *(
        (got[1], ref[1]) if with_geom else ()))
    # the packed taps do change costs: the f32 variant differs somewhere
    f32 = TNR.rect_ncc_plain(t.srow, t.tile_oy, t.tile_ox, t.rect_ref,
                             t.rect_src, D, AB, t.maps[1 + parity].fwd_valid,
                             dataclasses.replace(tp, rect_tap_pack=False))
    assert not np.array_equal((f32[0] if with_geom else f32).numpy(), got[0])


@pytest.mark.parametrize("with_geom,parity", KERNEL_CASES, ids=KERNEL_IDS)
def test_pallas_packed_taps_are_f32_taps_on_a_rounded_source(
        setup, monkeypatch, packed_runs, with_geom, parity):
    """(2) the interpreted packed kernel == the interpreted f32 kernel on
    bf16(rect_src), bit for bit, the JAX package alone."""
    run = _packed_run(setup, monkeypatch, packed_runs, with_geom, parity)
    ref = run["raw"]
    ctx = setup["ctx"]
    rounded = ctx.rect_src.astype(jnp.bfloat16).astype(jnp.float32)
    assert not np.array_equal(np.asarray(rounded), np.asarray(ctx.rect_src))
    f32 = _jax_raw(setup, monkeypatch, run["D"], run["AB"], parity, with_geom,
                   dataclasses.replace(setup["p"], rect_tap_pack=False),
                   rect_src=rounded)
    for a, b in zip(ref, f32, strict=True):
        np.testing.assert_array_equal(a, b)
    # and the port's rounding of the frame is the reference's
    np.testing.assert_array_equal(
        TNR.round_bf16(setup["tctx"].rect_src).numpy(), np.asarray(rounded))


@pytest.mark.parametrize("C,with_geom", [(1, False), (2, False), (5, False),
                                         (8, False), (9, False), (5, True),
                                         (9, True)])
def test_packed_backmap_matches_reference(setup, monkeypatch, C, with_geom):
    """(3) the packed back-map on identical cost planes, bit for bit; the
    fill keeps its exact f32 value (fills chosen off the bf16 grid)."""
    ctx, t = setup["ctx"], setup["tctx"]
    parity = 0
    p = dataclasses.replace(setup["p"], cost_max=1.2345679,
                            geom_max_cost=3.3333333)
    rng = np.random.default_rng(C)
    maps = ctx.maps[1 + parity]
    unclaimed = rng.random(maps.bwd_valid.shape) < 0.2
    maps = maps._replace(bwd_valid=maps.bwd_valid & ~unclaimed)
    tmaps = t.maps[1 + parity]
    tmaps = dataclasses.replace(tmaps, bwd_valid=torch.from_numpy(
        np.asarray(maps.bwd_valid)).reshape(tmaps.bwd_valid.shape))
    shape = (C,) + tuple(maps.fwd_valid.shape)
    planes = [rng.uniform(0.0, p.cost_max, shape).astype(np.float32),
              rng.uniform(0.0, p.geom_max_cost, shape).astype(np.float32)]
    planes[0][rng.random(shape) < 0.1] = p.cost_max
    planes = planes if with_geom else planes[:1]
    fixed = [jnp.asarray(a) for a in planes]
    _Planes(monkeypatch, fixed if with_geom else fixed[0])
    ref = JNR.run_rect_kernel(
        ctx.srow, ctx.rect_ref, ctx.rect_src, jnp.zeros(shape, jnp.float32),
        jnp.zeros(shape, jnp.float32), maps, ctx.tile_oy, ctx.tile_ox, p,
        out_hw=(H, W // 2), rect_sdisp=ctx.rect_sdisp if with_geom else None)
    ref = ref if with_geom else (ref,)
    valid = tmaps.bwd_valid.reshape(1, -1, H, W // 2).expand(
        C, -1, -1, -1).numpy()
    assert 0.7 < valid.mean() < 0.9
    for plane, r, fill in zip(planes, ref, (p.cost_max, p.geom_max_cost)):
        got = TNR.backmap(torch.from_numpy(plane), tmaps, (H, W // 2), fill,
                          pack=True).numpy()
        r = np.asarray(r)
        np.testing.assert_array_equal(got.view(np.int32), r.view(np.int32))
        assert np.all(got[~valid] == np.float32(fill))
        unpacked = TNR.backmap(torch.from_numpy(plane), tmaps, (H, W // 2),
                               fill).numpy()
        if C == 1:
            np.testing.assert_array_equal(got, unpacked)
        else:
            step = np.abs(got - unpacked)[valid]
            assert np.all(step <= 2.0 ** -8 * np.abs(unpacked[valid]))
            assert np.any(step > 0)


def _bf16_step(x):
    """One bf16 step (2^-7 relative to the binade's floor) at |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("with_geom,parity", [
    pytest.param(False, 0, marks=pytest.mark.slow), (True, 1)],
    ids=["phot-parity0", "geom-parity1"])
def test_rect_batched_ncc_with_packs_matches_reference(
        setup, monkeypatch, packed_runs, with_geom, parity):
    """(4) the whole pinhole batched evaluation, both packs on."""
    p = setup["p"]
    n, w = _packed(setup["planes"], parity)
    ref = _packed_run(setup, monkeypatch, packed_runs, with_geom,
                      parity)["out"]
    got = TNR.rect_batched_ncc(setup["tctx"], torch.tensor(np.asarray(n)),
                               torch.tensor(np.asarray(w)), port_params(p),
                               parity=parity, with_geom=with_geom)
    got = tuple(a.numpy() for a in (got if with_geom else (got,)))
    tc, jc = got[0], ref[0]
    bj, bt = jc >= p.cost_max, tc >= p.cost_max
    assert (bj == bt).mean() >= 0.999, (bj == bt).mean()
    assert (~bj).mean() > 0.3
    both = ~bj & ~bt
    d = np.abs(tc - jc)[both]
    assert np.mean(d <= 1e-4) >= 0.997, np.mean(d <= 1e-4)
    assert np.all(d <= 5e-4 + _bf16_step(jc[both])), d.max()
    if with_geom:
        tg, jg = got[1], ref[1]
        gj, gt = jg < p.geom_max_cost, tg < p.geom_max_cost
        assert (gj == gt).mean() >= 0.999
        dg = np.abs(tg - jg)[gj & gt]
        assert np.mean(dg <= 1e-4) >= 0.997, np.mean(dg <= 1e-4)
        assert np.all(dg <= 1e-4 + _bf16_step(jg[gj & gt])), dg.max()


@pytest.mark.slow
def test_sphere_batched_ncc_with_packs_matches_reference():
    """(4) the pole-rotated batched evaluation, both packs on, C=2 on
    parity 0 with the geometric cost, each package on its own context: the
    agreement shares of test_torch_sphere_rect.py's end-to-end case."""
    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_tpu.core.camera import SPHERE
    from acmmp_spherical_tpu.ops import sphere_rect as JSR
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )
    from acmmp_spherical_torch.core.camera import stack_cameras as tstack
    from acmmp_spherical_torch.ops import sphere_rect as TSR

    from torch_port_util import jax_cam_dict

    Ws, Hs, n = 128, 64, 4
    params = PatchMatchParams()
    assert params.rect_tap_pack and params.rect_backmap_pack
    cams = make_ring_of_cameras(n, model=SPHERE, width=Ws, height=Hs)
    images, depths, normals = render_scene(cams, CubeRoom(), Ws, Hs)
    tcams = [interop.camera(dict(jax_cam_dict(c), model=c.model),
                            device="cpu") for c in cams]
    dr = np.asarray(cams[0].depth_range)
    jctx = JSR.build_sphere_rect_context(
        jnp.asarray(images[0]), jnp.asarray(images[1:]), cams[0],
        jstack(cams[1:]), (dr[0], dr[1]), src_depths=jnp.asarray(depths[1:]))
    tctx = TSR.build_sphere_rect_context(
        torch.from_numpy(images[0]), torch.from_numpy(images[1:]), tcams[0],
        tstack(tcams[1:]), torch.from_numpy(dr.astype(np.float32)),
        src_depths=torch.from_numpy(depths[1:]))
    xs, ys = grid_coords(Hs, Ws)
    n_cam = JG.normal_world_to_cam(cams[0], jnp.asarray(normals[0]))
    w = JG.dist_to_origin(cams[0], xs, ys, jnp.asarray(depths[0]), n_cam)
    nn, ww = _packed((jnp.stack([n_cam, n_cam]), jnp.stack([w, w * 1.3])), 0)
    ref = JSR.sphere_batched_ncc(jctx, nn, ww, params, interpret=True,
                                 with_geom=True, parity=0)
    got = TSR.sphere_batched_ncc(tctx, torch.tensor(np.asarray(nn)),
                                 torch.tensor(np.asarray(ww)),
                                 port_params(params), with_geom=True,
                                 parity=0)
    (jc, jg), (tc, tg) = ((np.asarray(a) for a in ref),
                          (a.numpy() for a in got))
    cm = params.cost_max
    assert ((jc >= cm) == (tc >= cm)).mean() >= 0.999
    d = np.abs(jc - tc)
    assert d.mean() < 1e-3 and (d > 1e-2).mean() < 0.01, (d.mean(),
                                                         (d > 1e-2).mean())
    assert (np.abs(jg - tg) > 1e-2).mean() < 0.02
    # the wrong plane costs clearly more than the ground truth
    assert tc[1].mean() > 2.0 * tc[0].mean()


@pytest.mark.parametrize("fixture,warp", [(FIXTURE_RECT, False),
                                          (FIXTURE_WARP, True)],
                         ids=["rect", "warp"])
def test_golden_pass_with_packs_matches_reference_fixture(setup, fixture,
                                                          warp):
    """(5) the port's photometric pass at the reference's defaults (both
    packs on, the scatter attribution) against the statistics the reference
    committed, at their own 2e-3."""
    cams, tcams, images = setup["cams"], setup["tcams"], setup["images"]
    p = rect_params(cams, inv_attrib=False, packs=True)
    if not warp:
        p = dataclasses.replace(p, rect_warp_hw=None)
    d, n, c, _ = run_patchmatch(port_inputs(tcams, images), port_params(p),
                                KEY)
    assert bool(torch.isfinite(d).all())
    check_against_fixture(_stats(d.numpy(), n.numpy(), c.numpy()),
                          json.loads(fixture.read_text()))


def test_packs_are_the_default_and_reach_the_kernel(setup):
    """The port's defaults are the reference's: both packs on, and
    ``rect_batched_ncc`` at the defaults equals the packed plain kernel
    with the packed back-map (and differs from the f32 variant)."""
    from acmmp_spherical_tpu.config import PatchMatchParams as JParams
    from acmmp_spherical_torch.config import PatchMatchParams

    for name in ("rect_tap_pack", "rect_backmap_pack"):
        assert getattr(PatchMatchParams(), name) is True
        assert getattr(JParams(), name) is True
    t = setup["tctx"]
    p = port_params(setup["p"])
    n, w = (torch.tensor(np.asarray(a)) for a in _packed(setup["planes"], 0))
    maps = t.maps[1]
    D, AB = TNR.coefficient_transport(t, maps, n, w)
    args = (t.srow, t.tile_oy, t.tile_ox, t.rect_ref, t.rect_src, D, AB,
            maps.fwd_valid)
    want = TNR.backmap(TNR.rect_ncc_plain(*args, p), maps, (H, W // 2),
                       p.cost_max, pack=True)
    assert torch.equal(TNR.rect_batched_ncc(t, n, w, p, parity=0), want)
    off = dataclasses.replace(p, rect_tap_pack=False, rect_backmap_pack=False)
    assert torch.equal(TNR.rect_batched_ncc(t, n, w, off, parity=0),
                       TNR.backmap(TNR.rect_ncc_plain(*args, off), maps,
                                   (H, W // 2), p.cost_max))
    assert not torch.equal(TNR.rect_batched_ncc(t, n, w, off, parity=0), want)


def test_round_bf16_bit_rule():
    """round_bf16 rounds to nearest even on the bits, keeps infinities and
    writes NaN as 0x7FC0 with its sign, as the reference's conversion."""
    words = np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x3F808001,
                      0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00001,
                      0xFF812345, 0x00008000, 0x80018000, 0xC61C4000],
                     dtype=np.uint32)
    x = words.view(np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32)).view(np.uint32)
    got = TNR.round_bf16(torch.from_numpy(x.copy())).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[:6], [0x3F800000, 0x3F820000, 0x3F810000, 0x3F810000,
                  0x7F800000, 0x7F800000])
    assert got[7] == 0x7FC00000 and got[8] == 0xFFC00000
