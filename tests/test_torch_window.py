"""The port's windowed (``fast_ncc``) path and odd frame sizes against the
reference.

Kernel scene: the 128x48x3src ring of tests/test_fast_ncc.py, its
ground-truth plane field ("gt") and the same field with its offsets
scaled by 1 + 0.01 N(0, 1) per pixel ("perturbed", numpy seed 0); the
reference's tap context is handed to the port through ``interop``.

* window origins (``compute_center_windows``, ``compute_window_offsets``)
  equal the reference's;
* ``windowed_multiview_ncc_plain`` against the Pallas kernel in interpret
  mode, photometric and with_geom: ``bad`` masks (cost_max) agree and costs
  are within 1e-4 on >= 99.5% of pixels, geometric costs within 1e-4 with
  the geom < geom_max_cost masks agreeing on >= 99.5%.  The gap is f32
  conditioning, not a rule: the moment form var = E[x^2] - E[x]^2 cancels
  about four digits at greylevels ~100, and XLA's CPU backend fuses the
  sums into multiply-adds; against a float64 run of the same rules the
  reference itself is off by more than 1e-4 on ~0.3% of the perturbed
  field's pixels (ROADMAP Queue 3);
* ``windowed_sample_plain`` against the Pallas sampler on the cases of
  tests/test_pallas_window.py, and on tile minima at and beyond the int32
  range and non-finite samples (``torch_port_util.WINDOW_EDGE_CASES``):
  equal window origins and ok masks, values within 1e-5;
* ``_fast_cost_vectors`` on a grid that is no tile multiple (95x64, the
  ground-truth field): padded to 128x64 and cropped back, agreeing as the
  kernel does;
* one windowed half-step from the same state and key: accept masks equal
  on >= 99.5% of pixels (99.93% measured), costs within 1e-4 on >= 97%
  (97.6% measured).  The half-step evaluates the random init's scattered
  planes, whose grazing projections amplify last-ulp differences: on such
  a field each package is off a float64 run of the same kernel by more
  than 1e-4 on ~2% of pixels (ROADMAP Queue 3);
* a 2-iteration windowed pass at 128x32x3src (tests/test_fast_ncc.py's)
  against the reference's, and the windowed golden pass (96x64x3src, key
  2333) against tests/fixtures/golden_pass_stats_window.json: region
  statistics within 1e-2 (worst measured 1.6x and 1.1x the CPU fixture's
  2e-3: those per-pixel flips compound over the pass);
* a 95x64 odd-frame pass on each of the rectified, windowed and exact paths
  against tests/fixtures/golden_pass_stats_odd.json: within 2e-3, the
  windowed one within 1e-2 (worst measured 2.6x 2e-3).

The reference's side of the windowed half-step and of the 2-iteration pass
is stored in tests/fixtures/ref_window_halfstep.npz (on the tap context of
ref_golden_context.npz) and ref_window_two_iterations.npz.

Regenerate those and both JSON fixtures from the reference (CPU,
interpret mode, about 6 minutes):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_window.py --regen
Median depth error of both packages' windowed passes on the bench ring at
smaller sizes (CPU; the reference in interpret mode):
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_window.py \\
        --depth-error 256x192 512x384
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.core.camera import stack_cameras as tstack  # noqa: E402
from acmmp_spherical_torch.ops import propagate as TP  # noqa: E402
from acmmp_spherical_torch.ops import rng as TR  # noqa: E402
from acmmp_spherical_torch.ops.kernels import ncc_window as NW  # noqa: E402
from acmmp_spherical_torch.ops.kernels import window_sample as WS  # noqa: E402
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch  # noqa: E402

from test_regression_fixture import _stats, check_against_fixture  # noqa: E402
from torch_port_util import (  # noqa: E402
    WINDOW_EDGE_CASES, check_golden_context, golden_context, golden_scene,
    jax_inputs, np_tree, port_inputs, port_params, rect_params,
    reference_arrays, regen_references, window_edge_case,
)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
FIXTURE_WINDOW = FIXTURES / "golden_pass_stats_window.json"
FIXTURE_ODD = FIXTURES / "golden_pass_stats_odd.json"
KEY = 2333
WINDOW_TOL = 1e-2  # windowed passes: the f32 gap above, 2.6x 2e-3 measured
ODD_W, ODD_H = 95, 64


def _window_params(**kw):
    from acmmp_spherical_tpu.config import PatchMatchParams

    return dataclasses.replace(PatchMatchParams(), fast_ncc=True, **kw)


def _odd_params(path, cams):
    """The reference's params of the odd-frame pass on ``path``."""
    from acmmp_spherical_tpu.config import PatchMatchParams

    if path == "rect":
        return rect_params(cams, hw=(ODD_H, ODD_W))
    return PatchMatchParams(fast_ncc=path == "window")


def _agree(a, b, fill):
    """(fraction of equal ``>= fill`` masks, fraction of pixels live in
    both and within 1e-4 among those live in both)."""
    ba, bb = a >= fill, b >= fill
    live = ~ba & ~bb
    return (ba == bb).mean(), (np.abs(a - b)[live] <= 1e-4).mean()


@pytest.fixture(scope="module")
def kernel_scene():
    from acmmp_spherical_tpu.core import geometry as G
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context
    from acmmp_spherical_tpu.ops.sampling import grid_coords

    cams, tcams, images, depths, normals = golden_scene(128, 48, focal=90.0)
    params = _window_params()
    xs, ys = grid_coords(48, 128)
    n = G.normal_world_to_cam(cams[0], jnp.asarray(normals[0]))
    w = G.dist_to_origin(cams[0], xs, ys, jnp.asarray(depths[0]), n)
    noise = np.random.default_rng(0).standard_normal(w.shape)
    fields = {"gt": (n, w),
              "perturbed": (n, w * jnp.asarray(1.0 + 0.01 * noise,
                                                jnp.float32))}
    ctx = ref_tap_context(jnp.asarray(images[0]), cams[0], params)
    return dict(cams=cams, src_cams=stack_cameras(cams[1:]), tcams=tcams,
                images=images, depths=depths, params=params, fields=fields,
                ctx=ctx, tctx=interop.ref_tap_context(np_tree(ctx), "cpu"))


def _port_field(field):
    n, w = field
    return torch.from_numpy(np.asarray(n)), torch.from_numpy(np.asarray(w))


@pytest.mark.parametrize("field", ["gt", "perturbed"])
def test_window_origins_match(kernel_scene, field):
    from acmmp_spherical_tpu.ops.pallas.ncc_window import (
        compute_center_windows,
    )

    ks = kernel_scene
    n, w = ks["fields"][field]
    jy, jx = compute_center_windows(ks["src_cams"], ks["cams"][0], n, w,
                                    ks["ctx"].xs, ks["ctx"].ys, (48, 384))
    tn, tw = _port_field(ks["fields"][field])
    ty, tx = NW.compute_center_windows(
        tstack(ks["tcams"][1:]), ks["tcams"][0], tn[None], tw[None],
        ks["tctx"].xs, ks["tctx"].ys, (48, 384))
    np.testing.assert_array_equal(ty[0].numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx[0].numpy(), np.asarray(jx))


@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
@pytest.mark.parametrize("field", ["gt", "perturbed"])
def test_windowed_ncc_plain_matches_reference(kernel_scene, field,
                                              with_geom):
    from acmmp_spherical_tpu.ops.pallas.ncc_window import (
        windowed_multiview_ncc,
    )

    ks = kernel_scene
    n, w = ks["fields"][field]
    dep = ks["depths"][1:] if with_geom else None
    ref = windowed_multiview_ncc(
        jnp.asarray(ks["images"][1:]), ks["src_cams"], ks["cams"][0], n, w,
        ks["ctx"], ks["params"], None if dep is None else jnp.asarray(dep),
        interpret=True)
    tn, tw = _port_field(ks["fields"][field])
    out = NW.windowed_multiview_ncc_plain(
        torch.from_numpy(ks["images"][1:]), tstack(ks["tcams"][1:]),
        ks["tcams"][0], tn[None], tw[None], ks["tctx"],
        port_params(ks["params"]),
        None if dep is None else torch.from_numpy(dep.copy()))
    out = (out[0][0], out[1][0]) if with_geom else out[0]
    cv, jcv = (out[0], ref[0]) if with_geom else (out, ref)
    bad_agree, close = _agree(cv.numpy(), np.asarray(jcv), 2.0)
    assert bad_agree >= 0.995 and close >= 0.995, (bad_agree, close)
    assert (np.asarray(jcv) < 2.0).mean() > 0.5
    if with_geom:
        g, jg = out[1].numpy(), np.asarray(ref[1])
        gok_agree, gclose = _agree(g, jg, 3.0)
        assert gok_agree >= 0.995 and gclose >= 0.995, (gok_agree, gclose)
        assert (jg < 3.0).mean() > 0.5


@pytest.mark.parametrize("case", ["smooth", "wild"])
def test_windowed_sample_plain_matches_reference(case):
    """The coordinate cases of tests/test_pallas_window.py (seed 1234)."""
    from acmmp_spherical_tpu.ops.pallas.window_sample import (
        compute_window_offsets, windowed_sample,
    )

    rng = np.random.default_rng(1234)
    Hs, Ws = 64, 256
    src = rng.random((Hs, Ws)).astype(np.float32)
    if case == "smooth":
        ys, xs = np.mgrid[0:32, 0:256].astype(np.float32)
        x = xs * 0.9 + 3.7 + 2 * np.sin(ys / 17)
        y = ys * 0.8 + 1.2 + 1.5 * np.cos(xs / 23)
    else:
        x = rng.uniform(0, Ws - 2, (16, 128))
        y = rng.uniform(0, Hs - 2, (16, 128))
    x, y = x.astype(np.float32), y.astype(np.float32)
    jv, jok = windowed_sample(jnp.asarray(src), jnp.asarray(x),
                              jnp.asarray(y), src_h=Hs, src_w=Ws,
                              interpret=True)
    tv, tok = WS.windowed_sample_plain(torch.from_numpy(src),
                                       torch.from_numpy(x),
                                       torch.from_numpy(y), src_h=Hs,
                                       src_w=Ws)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    oy, ox = compute_window_offsets(jnp.asarray(x), jnp.asarray(y), Hs, 384)
    toy, tox = WS.compute_window_offsets(torch.from_numpy(x),
                                         torch.from_numpy(y), Hs, 384)
    np.testing.assert_array_equal(toy.numpy(), np.asarray(oy))
    np.testing.assert_array_equal(tox.numpy(), np.asarray(ox))


@pytest.mark.parametrize("case", WINDOW_EDGE_CASES)
def test_windowed_sample_edge_origins_match_reference(case):
    """Tile minima at and beyond the int32 range, and non-finite samples:
    the window origins follow the reference's int32 arithmetic (XLA's
    saturating convert, then the margin subtracted with wraparound), so a
    minimum at or below -2^31 puts the window at the far edge.  Origins and
    ok equal, values within 1e-5 (XLA's CPU backend contracts the lerps
    into multiply-adds)."""
    from acmmp_spherical_tpu.ops.pallas.window_sample import (
        compute_window_offsets, windowed_sample,
    )

    src, x, y, Hs, Ws = window_edge_case(case)
    jv, jok = windowed_sample(jnp.asarray(src), jnp.asarray(x),
                              jnp.asarray(y), src_h=Hs, src_w=Ws,
                              interpret=True)
    t = torch.from_numpy
    tv, tok = WS.windowed_sample_plain(t(src), t(x), t(y), src_h=Hs,
                                       src_w=Ws)
    oy, ox = compute_window_offsets(jnp.asarray(x), jnp.asarray(y), Hs, Ws)
    toy, tox = WS.compute_window_offsets(t(x), t(y), Hs, Ws)
    np.testing.assert_array_equal(toy.numpy(), np.asarray(oy))
    np.testing.assert_array_equal(tox.numpy(), np.asarray(ox))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    assert bool(tok.any())


@pytest.fixture(scope="module")
def odd_scene():
    return golden_scene(ODD_W, ODD_H)


@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
def test_fast_cost_vector_off_tile_grid(odd_scene, with_geom):
    """95x64 is padded to 128x64 for the kernel and cropped back."""
    from acmmp_spherical_tpu.core import geometry as G
    from acmmp_spherical_tpu.ops import propagate as JP
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context

    cams, tcams, images, depths, normals = odd_scene
    params = _window_params(geom_consistency=with_geom)
    jin = JP.prepare_inputs(jax_inputs(cams, images, depths[1:]), params)
    ctx = ref_tap_context(jin.ref_image, cams[0], params)
    n = G.normal_world_to_cam(cams[0], jnp.asarray(normals[0]))
    w = G.dist_to_origin(cams[0], ctx.xs, ctx.ys, jnp.asarray(depths[0]), n)
    ref = JP._fast_cost_vector(jin, ctx, n, w, params, with_geom=with_geom)
    out = TP._fast_cost_vectors(
        port_inputs(tcams, images, depths[1:]),
        interop.ref_tap_context(np_tree(ctx), "cpu"),
        torch.from_numpy(np.asarray(n))[None],
        torch.from_numpy(np.asarray(w))[None], port_params(params),
        with_geom=with_geom)
    out = (out[0][0], out[1][0]) if with_geom else out[0]
    pairs = [(out[0], ref[0], 2.0), (out[1], ref[1], 3.0)] if with_geom \
        else [(out, ref, 2.0)]
    for t, j, fill in pairs:
        assert t.shape == (3, ODD_H, ODD_W)
        agree, close = _agree(t.numpy(), np.asarray(j), fill)
        assert agree >= 0.995 and close >= 0.995, (agree, close)


def build_halfstep_reference():
    """The reference's side of the windowed half-step: its init state (key
    2333) and one half-step's ``w`` and costs, on the stored golden tap
    context."""
    from acmmp_spherical_tpu.ops import propagate as JP
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context

    cams, _, images, _, _ = golden_scene()
    params = _window_params()
    jin = JP.prepare_inputs(jax_inputs(cams, images), params)
    ctx = ref_tap_context(jin.ref_image, jin.ref_cam, params)
    check_golden_context(taps=ctx)
    k_init, k_iters = jax.random.split(jax.random.key(KEY))
    state = JP.initialize_state(jin, params, k_init, ctx=ctx)
    k0, _ = jax.random.split(jax.random.fold_in(k_iters, 0))
    out = JP.checkerboard_halfstep(state, jin, ctx, params, k0, 0, 0)
    return dict(state=np_tree(state), halfstep_w=np.asarray(out.w),
                halfstep_cost=np.asarray(out.cost))


REFERENCES = {"ref_window_halfstep": build_halfstep_reference}


def test_windowed_halfstep_from_identical_state():
    cams, tcams, images, _, _ = golden_scene()
    params = _window_params()
    ref = reference_arrays("ref_window_halfstep", build_halfstep_reference)
    tstate = interop.plane_state(ref["state"], device="cpu")
    tk0, _ = TR.split(TR.fold_in(TR.split(TR.key(KEY))[1], 0))
    tout = TP.checkerboard_halfstep(
        tstate, port_inputs(tcams, images), port_params(params), tk0, 0, 0,
        ctx=interop.ref_tap_context(golden_context()["taps"], "cpu"))
    j_acc = ref["halfstep_w"] != ref["state"]["w"]
    t_acc = tout.w.numpy() != tstate.w.numpy()
    assert (j_acc == t_acc).mean() >= 0.995, (j_acc == t_acc).mean()
    assert j_acc.mean() > 0.1
    dc = np.abs(ref["halfstep_cost"] - tout.cost.numpy())
    assert np.mean(dc <= 1e-4) >= 0.97, np.mean(dc <= 1e-4)


def build_two_iteration_reference():
    """The reference's 2-iteration windowed pass of
    ``test_two_iteration_windowed_pass_matches_reference``: depth, normal
    and cost."""
    from acmmp_spherical_tpu.pipeline.patchmatch import (
        run_patchmatch as jax_run,
    )

    cams, _, images, _, _ = golden_scene(128, 32, focal=100.0)
    jd, jn, jc, _ = jax_run(jax_inputs(cams, images),
                            _window_params(max_iterations=2),
                            jax.random.key(0))
    return dict(depth=np.asarray(jd), normal=np.asarray(jn),
                cost=np.asarray(jc))


REFERENCES["ref_window_two_iterations"] = build_two_iteration_reference


def test_two_iteration_windowed_pass_matches_reference():
    """tests/test_fast_ncc.py's pass: 128x32x3src, focal 100, key 0."""
    _, tcams, images, depths, _ = golden_scene(128, 32, focal=100.0)
    params = _window_params(max_iterations=2)
    ref = reference_arrays("ref_window_two_iterations",
                           build_two_iteration_reference)
    td, tn, tc, _ = run_patchmatch(port_inputs(tcams, images),
                                   port_params(params), 0)
    check_against_fixture(_stats(td.numpy(), tn.numpy(), tc.numpy()),
                          _stats(ref["depth"], ref["normal"], ref["cost"]),
                          rtol=WINDOW_TOL, atol=WINDOW_TOL)
    rel = np.abs(td.numpy() - depths[0]) / depths[0]
    assert np.median(rel[4:-4, 8:-8]) < 0.05


def test_windowed_golden_pass_matches_fixture():
    cams, tcams, images, depths, _ = golden_scene()
    d, n, c, _ = run_patchmatch(port_inputs(tcams, images),
                                port_params(_window_params()), KEY)
    assert bool(torch.isfinite(d).all())
    check_against_fixture(_stats(d.numpy(), n.numpy(), c.numpy()),
                          json.loads(FIXTURE_WINDOW.read_text()),
                          rtol=WINDOW_TOL, atol=WINDOW_TOL)
    rel = np.abs(d.numpy() - depths[0]) / depths[0]
    assert np.median(rel[8:-8, 8:-8]) < 0.01


@pytest.mark.parametrize("path", ["rect", "window", "exact"])
def test_odd_frame_pass_matches_reference(odd_scene, path):
    cams, tcams, images, depths, _ = odd_scene
    d, n, c, _ = run_patchmatch(port_inputs(tcams, images),
                                port_params(_odd_params(path, cams)), KEY)
    assert d.shape == (ODD_H, ODD_W) and bool(torch.isfinite(d).all())
    tol = WINDOW_TOL if path == "window" else 2e-3
    check_against_fixture(_stats(d.numpy(), n.numpy(), c.numpy()),
                          json.loads(FIXTURE_ODD.read_text())[path],
                          rtol=tol, atol=tol)
    rel = np.abs(d.numpy() - depths[0]) / depths[0]
    assert np.median(rel[8:-8, 8:-8]) < 0.01


def reference_pass(scene, params, key):
    """Region statistics of the reference's pass on a rendered ring."""
    from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch as jrun

    cams, _, images, _, _ = scene
    d, n, c, _ = jrun(jax_inputs(cams, images), params, jax.random.key(key))
    return _stats(np.asarray(d), np.asarray(n), np.asarray(c))


def depth_errors(sizes, key=3):
    """Median relative depth error over [8:-8, 8:-8] of the windowed pass of
    each package on the bench ring (focal 0.9 W, radius 0.25, 8 sources,
    default parameters, ``fast_ncc``) at each ``WxH`` size."""
    from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch as jrun

    out = {}
    for size in sizes:
        W, H = map(int, size.split("x"))
        cams, tcams, images, depths, _ = golden_scene(
            W, H, n_views=9, focal=0.9 * W)
        params = _window_params()
        jd = np.asarray(jrun(jax_inputs(cams, images), params,
                             jax.random.key(key))[0])
        td = run_patchmatch(port_inputs(tcams, images), port_params(params),
                            key)[0].numpy()
        g = depths[0][8:-8, 8:-8]
        err = lambda d: float(np.median(np.abs(d[8:-8, 8:-8] - g) / g))
        out[size] = {"reference": err(jd), "port": err(td)}
    return out


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    if "--regen" in sys.argv:
        regen_references(REFERENCES)
        FIXTURE_WINDOW.write_text(json.dumps(reference_pass(
            golden_scene(), _window_params(), KEY), indent=1))
        odd = golden_scene(ODD_W, ODD_H)
        FIXTURE_ODD.write_text(json.dumps(
            {p: reference_pass(odd, _odd_params(p, odd[0]), KEY)
             for p in ("rect", "window", "exact")}, indent=1))
        print(f"wrote {FIXTURE_WINDOW} and {FIXTURE_ODD}")
    if "--depth-error" in sys.argv:
        sizes = sys.argv[sys.argv.index("--depth-error") + 1:]
        print(json.dumps(depth_errors(sizes)))
