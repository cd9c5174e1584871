"""Port parity: ops/rectify.py on the golden problem (96x64x3src).

Tolerances: every host mirror exact (same float64 numpy); the pair
rectification within 1e-5 relative (3x3 products may round in another
order); transport maps, live-tile order and window clearing bit-exact when
built from the reference's own backward map and pair rectification; the
scatter-free and the scatter_reduce("amax") attributions identical; the
clamp-warped reference frame within 2e-3 greylevels of the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_tpu.core.camera import stack_cameras as jstack  # noqa: E402
from acmmp_spherical_tpu.ops import rectify as JRT  # noqa: E402
from acmmp_spherical_tpu.utils.synthetic import make_ring_of_cameras  # noqa: E402
from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.core.camera import stack_cameras as tstack  # noqa: E402
from acmmp_spherical_torch.ops import rectify as TRT  # noqa: E402

from torch_port_util import (  # noqa: E402
    H, W, golden_scene, jax_cam_dict, np_tree, rect_params,
)


@pytest.fixture(scope="module")
def scene():
    cams, tcams, images, depths, normals = golden_scene()
    p = rect_params(cams)
    dr = (cams[0].depth_range[0], cams[0].depth_range[1])
    kw = dict(comp_hw=p.rect_comp_hw, live_n=p.rect_live_n,
              warp_hw=p.rect_warp_hw)
    jctx = {inv: JRT.build_rect_context(
        jnp.asarray(images[0]), jnp.asarray(images[1:]), cams[0],
        jstack(cams[1:]), dr, inv_attrib=inv, **kw) for inv in (True, False)}
    return cams, tcams, images, p, jctx


def _camera_sets():
    """(name, jax ref cam, jax src cams, torch ref, torch srcs, (H, W))."""
    out = []
    for name, (w, h, n, f, r, jit) in {
            "golden": (96, 64, 4, 80.0, 0.35, 0.0),
            "bench": (1024, 768, 9, 921.6, 0.25, 0.0),
            "jittered": (320, 240, 5, 250.0, 0.3, 0.2)}.items():
        cams = make_ring_of_cameras(n, width=w, height=h, focal=f, radius=r,
                                    look_jitter=jit)
        tc = [interop.camera(jax_cam_dict(c), device="cpu") for c in cams]
        out.append((name, cams[0], jstack(cams[1:]), tc[0], tstack(tc[1:]),
                    (h, w)))
    # forward motion: a degenerate pair the gates must reject
    cams = make_ring_of_cameras(3, width=96, height=64, focal=80.0)
    fwd = jax_cam_dict(cams[1])
    fwd["t"] = np.asarray(cams[0].t) + np.array([0.0, 0.0, -0.5], np.float32)
    from acmmp_spherical_tpu.core.camera import make_camera

    jf = make_camera(fwd["R"], fwd["t"], K=fwd["K"], width=96, height=64,
                     depth_min=1.2, depth_max=10.0)
    tc = [interop.camera(jax_cam_dict(c), device="cpu") for c in (cams[0], jf)]
    out.append(("forward", cams[0], jstack([jf]), tc[0], tstack(tc[1:]),
                (64, 96)))
    return out


@pytest.mark.parametrize("case", _camera_sets(), ids=lambda c: c[0])
def test_host_mirrors_match(case):
    _, jr, js, tr, ts, (h, w) = case
    rhw = JRT.rect_shape(h, w)
    assert TRT.rect_shape(h, w) == rhw
    chw = JRT.rect_comp_shape(jr, js, rhw)
    assert TRT.rect_comp_shape(tr, ts, rhw) == chw
    assert (TRT.rect_live_tile_count(tr, ts, rhw, chw)
            == JRT.rect_live_tile_count(jr, js, rhw, chw))
    whw = JRT.rect_warp_window(jr, js, rhw)
    assert TRT.rect_warp_window(tr, ts, rhw) == whw
    if whw is not None:
        assert TRT.warp_windows(whw) == JRT.warp_windows(whw)
    assert TRT.rect_inv_attrib_ok(tr, ts, rhw) == JRT.rect_inv_attrib_ok(jr, js, rhw)
    assert TRT.host_rectifiable(tr, ts, rhw) == JRT.host_rectifiable(jr, js, rhw)
    for usable in (240, 368):
        assert (TRT.rect_span_fits(tr, ts, rhw, usable=usable)
                == JRT.rect_span_fits(jr, js, rhw, usable=usable))
    assert TRT.rect_init_window(tr, ts, rhw) == JRT.rect_init_window(jr, js, rhw)


def test_pair_rect_matches(scene):
    cams, tcams, *_ = scene
    rhw = JRT.rect_shape(H, W)
    jp = JRT.build_pair_rect(cams[0], jstack(cams[1:]), rhw)
    tp = TRT.build_pair_rect(tcams[0], tstack(tcams[1:]), rhw)
    for f in jp._fields:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


def _bwd(jctx):
    m0 = jctx.maps[0]
    S = m0.bwd_x.shape[0]
    i64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64)
    return (i64(m0.bwd_x), i64(m0.bwd_y),
            torch.tensor(np.asarray(m0.bwd_valid)).reshape(S, H, W),
            torch.tensor(np.asarray(jctx.srow[:, 2])),
            torch.tensor(np.asarray(jctx.srow[:, 3])))


def _port_maps(jctx, p, attrib, count_claims, live_n=-1, warp_hw=-1):
    bx, by, bok, oy, ox = _bwd(jctx)
    return TRT.build_transport_maps(
        bx, by, bok, p.rect_comp_hw, (H, W), oy, ox, attrib,
        live_n=p.rect_live_n if live_n == -1 else live_n,
        warp_hw=p.rect_warp_hw if warp_hw == -1 else warp_hw,
        count_claims=count_claims)


def test_attribution_matches_reference_maps(scene):
    """From the reference's backward map and pair rectification, the port's
    inverse-check attribution reproduces the reference context's maps, tile
    order and window clearing bit for bit; the scatter_reduce("amax")
    fallback picks the same winners."""
    _, _, _, p, jctx = scene
    ref = jctx[True]
    pr = TRT.PairRect(**{k: torch.tensor(v) for k, v in
                         np_tree(ref.pr).items()})
    bx, by, bok, oy, ox = _bwd(ref)
    attrib = TRT._attribution_inverse(pr, oy, ox, p.rect_comp_hw, (H, W))
    maps, toy, tox = _port_maps(ref, p, attrib, count_claims=False)
    np.testing.assert_array_equal(toy.numpy(), np.asarray(ref.tile_oy))
    np.testing.assert_array_equal(tox.numpy(), np.asarray(ref.tile_ox))
    for mi, (tm, jm) in enumerate(zip(maps, ref.maps)):
        for f in MAP_FIELDS:
            np.testing.assert_array_equal(
                getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                err_msg=f"map {mi} {f}")
    scat = TRT._attribution_scatter(bx, by, bok, p.rect_comp_hw, (H, W))
    for a, b in zip(attrib, scat):
        assert torch.equal(a, b)


MAP_FIELDS = ("fwd_idx", "fwd_valid", "bwd_cidx", "bwd_x", "bwd_y",
              "bwd_valid")


@pytest.mark.parametrize("live", ["budget", "all_tiles"])
@pytest.mark.parametrize("warp", ["window", "no_window"])
def test_transport_maps_bit_exact(scene, live, warp):
    """build_transport_maps against the reference's, fed the same backward
    map and attribution, with the live-tile budget on or off (identity
    compaction) and the claimant window on or off."""
    _, _, _, p, jctx = scene
    ref = jctx[True]
    bx, by, bok, oy, ox = _bwd(ref)
    attrib = TRT._attribution_scatter(bx, by, bok, p.rect_comp_hw, (H, W))
    live_n = p.rect_live_n if live == "budget" else None
    warp_hw = p.rect_warp_hw if warp == "window" else None
    jm, jtoy, jtox = JRT.build_transport_maps(
        jnp.asarray(bx.numpy(), jnp.int32), jnp.asarray(by.numpy(), jnp.int32),
        jnp.asarray(bok.numpy()), p.rect_comp_hw, (H, W),
        jnp.asarray(oy.numpy()), jnp.asarray(ox.numpy()), live_n=live_n,
        warp_hw=warp_hw, attrib=tuple(jnp.asarray(a.numpy(), jnp.int32)
                                      for a in attrib))
    tm, ttoy, ttox = _port_maps(ref, p, attrib, False, live_n, warp_hw)
    np.testing.assert_array_equal(ttoy.numpy(), np.asarray(jtoy))
    np.testing.assert_array_equal(ttox.numpy(), np.asarray(jtox))
    for mi, (a, b) in enumerate(zip(tm, jm)):
        for f in MAP_FIELDS:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f"map {mi} {f}")


def test_claim_count_tile_order(scene):
    """With the scatter branch's claim counts, the live-tile order (a stable
    argsort) equals the reference's scatter-branch order."""
    _, _, _, p, jctx = scene
    ref = jctx[False]
    bx, by, bok, _, _ = _bwd(ref)
    scat = TRT._attribution_scatter(bx, by, bok, p.rect_comp_hw, (H, W))
    maps, toy, tox = _port_maps(ref, p, scat, count_claims=True)
    np.testing.assert_array_equal(toy.numpy(), np.asarray(ref.tile_oy))
    np.testing.assert_array_equal(tox.numpy(), np.asarray(ref.tile_ox))
    # claimant existence does not depend on the collision winner
    for tm, jm in zip(maps, ref.maps):
        np.testing.assert_array_equal(tm.fwd_valid.numpy(),
                                      np.asarray(jm.fwd_valid))


def test_build_rect_context_matches(scene):
    """The port's own context: srow and offsets exact, maps equal on >= 99.9%
    of entries (its pair rectification rounds in another order), the
    reference frame within 2e-3 greylevels and the source SENTINEL masks
    equal on >= 99.9% of pixels."""
    cams, tcams, images, p, jctx = scene
    ref = jctx[True]
    t = TRT.build_rect_context(
        torch.from_numpy(images[0]), torch.from_numpy(images[1:]), tcams[0],
        tstack(tcams[1:]), (tcams[0].depth_range[0], tcams[0].depth_range[1]),
        comp_hw=p.rect_comp_hw, live_n=p.rect_live_n, warp_hw=p.rect_warp_hw,
        inv_attrib=True)
    np.testing.assert_allclose(t.srow.numpy(), np.asarray(ref.srow),
                               rtol=1e-5)
    np.testing.assert_allclose(t.rect_ref.numpy(), np.asarray(ref.rect_ref),
                               atol=2e-3)
    vs = t.rect_src.numpy() > TRT.SENTINEL_THRESH
    assert (vs == (np.asarray(ref.rect_src) > TRT.SENTINEL_THRESH)).mean() > 0.999
    for tm, jm in zip(t.maps, ref.maps):
        assert (tm.fwd_idx.numpy() == np.asarray(jm.fwd_idx)).mean() > 0.999
        assert (tm.bwd_cidx.numpy() == np.asarray(jm.bwd_cidx)).mean() > 0.999


@pytest.mark.parametrize("inv", [True, False], ids=["inv_attrib", "scatter"])
def test_odd_frame_context_has_the_full_map_only(inv):
    """An odd frame (95x64) builds only the full-grid map, as the reference
    does (its half-step then runs on the full grid): same tile origins,
    maps equal on >= 99.9% of entries, as test_build_rect_context_matches."""
    from torch_port_util import rect_params

    cams, tcams, images, _, _ = golden_scene(95, 64)
    p = rect_params(cams, hw=(64, 95))
    dr = (cams[0].depth_range[0], cams[0].depth_range[1])
    kw = dict(comp_hw=p.rect_comp_hw, live_n=p.rect_live_n,
              warp_hw=p.rect_warp_hw, inv_attrib=inv)
    ref = JRT.build_rect_context(jnp.asarray(images[0]),
                                 jnp.asarray(images[1:]), cams[0],
                                 jstack(cams[1:]), dr, **kw)
    t = TRT.build_rect_context(
        torch.from_numpy(images[0]), torch.from_numpy(images[1:]), tcams[0],
        tstack(tcams[1:]), (tcams[0].depth_range[0], tcams[0].depth_range[1]),
        **kw)
    assert len(ref.maps) == 1 and len(t.maps) == 1
    np.testing.assert_array_equal(t.tile_oy.numpy(), np.asarray(ref.tile_oy))
    np.testing.assert_array_equal(t.tile_ox.numpy(), np.asarray(ref.tile_ox))
    tm, jm = t.maps[0], ref.maps[0]
    assert tm.bwd_valid.shape == (3, 64, 95)
    for f in ("fwd_idx", "fwd_valid", "bwd_cidx"):
        assert (getattr(tm, f).numpy() == np.asarray(getattr(jm, f))
                ).mean() > 0.999, f
