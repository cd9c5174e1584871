"""The port's SPHERE passes against the reference's statistics.

The equirect golden ring (128x64, 3 source views, key 2333, both bf16
packs off; ``bench.make_sphere_problem``): the photometric pass on the
exact path (``rect_ncc`` off) and on the pole-rotated rectified path; on
the rectified path, the geometric pass seeded from
``bench.golden_geom_fields`` (ground truth x (1 + 0.01 sin(i)) seed depth,
ground-truth normals, source depths ground truth x (1 + 0.01 cos(i))), the
hierarchy pass from the same seed (``bench.golden_hier_pass``) and the
planar-prior round after the photometric pass (``bench.golden_prior_pass``:
prior built from its depth and cost, ``fold_in(key, 1)``).  Each is held to
tests/fixtures/golden_sphere_pass_stats_{exact,rect,geom,hier,prior}.json,
made by the reference on the CPU (interpret mode): region statistics within
``TOL`` (relative, or absolute below 1), and the median relative depth
error over the band that ``LAT_CAP_DEG`` leaves within ``ERR_TOL`` of the
reference's.  The two packages' transcendentals differ by ulps (XLA's CPU
atan2/asin against torch's), so the passes are not bit-comparable: a few
accept decisions differ and the statistics drift (when the fixtures were
made: at most 1.8e-3 on the photometric, geometric and hierarchy passes,
3.9e-3 on the prior pass's mean cost of one quadrant).

Regenerate the fixtures from the reference (CPU, about 12 minutes):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_sphere_pass.py --regen

``--geom-seeded WxH`` runs, in both packages on the exact path, the
photometric pass of the equirect ring at that size with 6 source views
(key 3), each view's own photometric pass (keys 2000 + i) and the
geometric pass seeded from the first with those as its source depths (key
50) -- in the port also with the ground-truth source depths -- and prints
the median relative depth errors over the band that ``LAT_CAP_DEG`` leaves
and over the pole band (about 5 minutes at 256x128):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_sphere_pass.py --geom-seeded 256x128
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_torch.bench import (  # noqa: E402
    GOLDEN_KEY, SPHERE_GOLDEN_SCENE, golden_geom_fields, golden_hier_pass,
    golden_prior_pass, make_sphere_problem, sphere_band_errors,
)
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch  # noqa: E402

from test_regression_fixture import _stats, check_against_fixture  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
FIXTURE = {p: FIXTURES / f"golden_sphere_pass_stats_{p}.json"
           for p in ("exact", "rect", "geom", "hier", "prior")}
TOL = 5e-3       # region statistics (depths ~3-6, costs ~0.03-0.3)
ERR_TOL = 2e-3   # band median relative depth error against the reference's


def _check(path, out, depths, cam):
    d, n, c = (a.numpy() for a in out[:3])
    assert np.all(np.isfinite(d)) and d.shape == depths[0].shape
    golden = json.loads(FIXTURE[path].read_text())
    err = golden.pop("band_median_rel_err")
    check_against_fixture(_stats(d, n, c), golden, rtol=TOL, atol=TOL)
    band = sphere_band_errors(d, depths[0], cam)["band"]
    assert abs(band - err) < ERR_TOL, (band, err)


@pytest.mark.parametrize("path", ["exact", "rect"])
def test_sphere_photometric_pass_matches_fixture(path):
    inputs, params, depths, _ = make_sphere_problem(**SPHERE_GOLDEN_SCENE,
                                                    device="cpu")
    if path == "exact":
        params = dataclasses.replace(params, rect_ncc=False)
    _check(path, run_patchmatch(inputs, params, GOLDEN_KEY), depths,
           inputs.ref_cam)


def test_sphere_geometric_pass_matches_fixture():
    inputs, params, depths, normals = make_sphere_problem(
        **SPHERE_GOLDEN_SCENE, device="cpu")
    src, seed_d, seed_n = golden_geom_fields(depths, normals)
    out = run_patchmatch(
        dataclasses.replace(inputs, src_depths=torch.from_numpy(src)),
        params.with_geom(multi_geometry=False), GOLDEN_KEY,
        seed_normal_world=torch.from_numpy(seed_n),
        seed_depth=torch.from_numpy(seed_d))
    _check("geom", out, depths, inputs.ref_cam)


@pytest.mark.parametrize("path", ["hier", "prior"])
def test_sphere_hierarchy_and_prior_passes_match_fixture(path):
    inputs, params, depths, normals = make_sphere_problem(
        **SPHERE_GOLDEN_SCENE, device="cpu")
    out = (golden_hier_pass(inputs, params, depths, normals)
           if path == "hier" else golden_prior_pass(inputs, params))
    _check(path, out, depths, inputs.ref_cam)


def reference_sphere_passes():
    """The reference's statistics of the five passes, with its band error
    under ``band_median_rel_err``."""
    from acmmp_spherical_tpu.config import PatchMatchParams, PriorConfig
    from acmmp_spherical_tpu.core.camera import SPHERE, stack_cameras
    from acmmp_spherical_tpu.ops import sphere_rect as JSR
    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs
    from acmmp_spherical_tpu.pipeline.patchmatch import (
        run_patchmatch as jrun,
    )
    from acmmp_spherical_tpu.pipeline.prior import build_planar_prior
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )

    sc = SPHERE_GOLDEN_SCENE
    W, H, n_src = sc["width"], sc["height"], sc["n_src"]
    cams = make_ring_of_cameras(1 + n_src, model=SPHERE, width=W, height=H)
    images, depths, normals = render_scene(cams, CubeRoom(), W, H)
    src = stack_cameras(cams[1:])
    iwin = JSR.sphere_init_window(cams[0], src)
    params = dataclasses.replace(
        PatchMatchParams().with_depth_range(*np.asarray(cams[0].depth_range)),
        rect_ncc=True, rect_init=iwin > 0, rect_init_win=iwin or 384,
        sphere_live_n=JSR.sphere_live_tile_count(cams[0]),
        rect_tap_pack=False, rect_backmap_pack=False)
    imgs = jnp.asarray(images)
    inputs = PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0],
        src_cams=src, src_valid=jnp.ones(n_src, bool),
        depth_range=jnp.asarray(np.asarray(cams[0].depth_range), jnp.float32))
    key = jax.random.key(GOLDEN_KEY)
    src_d, seed_d, seed_n = golden_geom_fields(depths, normals)
    runs = {
        "exact": lambda: jrun(inputs, dataclasses.replace(params,
                                                          rect_ncc=False), key),
        "rect": lambda: jrun(inputs, params, key),
        "geom": lambda: jrun(
            inputs._replace(src_depths=jnp.asarray(src_d)),
            params.with_geom(multi_geometry=False), key,
            seed_normal_world=jnp.asarray(seed_n),
            seed_depth=jnp.asarray(seed_d)),
        "hier": lambda: jrun(inputs, params.with_hierarchy(), key,
                             seed_normal_world=jnp.asarray(seed_n),
                             seed_depth=jnp.asarray(seed_d)),
    }

    def prior():
        d, _, c, state = jrun(inputs, params, key)
        dmin, dmax = np.asarray(inputs.depth_range)
        pn, pw, mask, _ = build_planar_prior(
            cams[0], np.asarray(d), np.asarray(c), dmin, dmax, PriorConfig())
        return jrun(inputs._replace(prior_normal=jnp.asarray(pn),
                                    prior_w=jnp.asarray(pw),
                                    prior_mask=jnp.asarray(mask)),
                    params.with_planar_prior(), jax.random.fold_in(key, 1),
                    prev_state=state)

    runs["prior"] = prior
    tcam = make_sphere_problem(**sc, device="cpu")[0].ref_cam
    out = {}
    for path, run in runs.items():
        d, n, c = (np.asarray(a) for a in run()[:3])
        out[path] = dict(_stats(d, n, c), band_median_rel_err=(
            sphere_band_errors(d, depths[0], tcam)["band"]))
    return out


def seeded_geometric_errors(width, height, n_src=6):
    """(band, pole) errors of the photometric, source and seeded geometric
    passes on the exact path, reference and port (see the module doc)."""
    from acmmp_spherical_tpu.core.camera import SPHERE, stack_cameras
    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs
    from acmmp_spherical_tpu.pipeline.patchmatch import (
        run_patchmatch as jrun,
    )
    from acmmp_spherical_tpu.utils.synthetic import make_ring_of_cameras

    from acmmp_spherical_torch.bench import source_depths

    inputs, params, depths, _ = make_sphere_problem(width, height, n_src,
                                                    "cpu")
    params = dataclasses.replace(params, rect_ncc=False)
    err = lambda d, i: tuple(sphere_band_errors(
        np.asarray(d), depths[i], inputs.ref_cam)[k] for k in ("band", "pole"))
    out = {}
    d, n = run_patchmatch(inputs, params, 3)[:2]
    src = source_depths(inputs, params, key_base=2000)
    g = run_patchmatch(dataclasses.replace(inputs, src_depths=src),
                       params.with_geom(False), 50, seed_normal_world=n,
                       seed_depth=d)[0]
    gg = run_patchmatch(dataclasses.replace(
        inputs, src_depths=torch.from_numpy(depths[1:])),
        params.with_geom(False), 50, seed_normal_world=n, seed_depth=d)[0]
    out["port"] = dict(phot=err(d, 0), src=[err(src[i], i + 1)
                                            for i in range(n_src)],
                       geom=err(g, 0), geom_gt_src=err(gg, 0))
    cams = make_ring_of_cameras(1 + n_src, model=SPHERE, width=width,
                                height=height)
    imgs = jnp.asarray(np.stack([inputs.ref_image.numpy(),
                                 *inputs.src_images.numpy()]))

    def view(i):
        others = [j for j in range(1 + n_src) if j != i]
        return PatchMatchInputs(
            ref_image=imgs[i], src_images=imgs[jnp.asarray(others)],
            ref_cam=cams[i], src_cams=stack_cameras([cams[j] for j in others]),
            src_valid=jnp.ones(n_src, bool), depth_range=jnp.asarray(
                np.asarray(cams[i].depth_range), jnp.float32))

    from acmmp_spherical_tpu.config import PatchMatchParams as JP

    jp = JP(**dataclasses.asdict(params))
    d, n = jrun(view(0), jp, jax.random.key(3))[:2]
    src = [np.asarray(jrun(view(i), jp, jax.random.key(2000 + i))[0])
           for i in range(1, 1 + n_src)]
    g = jrun(view(0)._replace(src_depths=jnp.asarray(np.stack(src))),
             jp.with_geom(False), jax.random.key(50), seed_normal_world=n,
             seed_depth=d)[0]
    out["reference"] = dict(phot=err(d, 0), src=[err(s_, i + 1)
                                                 for i, s_ in enumerate(src)],
                            geom=err(g, 0))
    return out


if __name__ == "__main__":
    if "--geom-seeded" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        w_, h_ = map(int, sys.argv[sys.argv.index("--geom-seeded") + 1]
                     .split("x"))
        print(json.dumps(seeded_geometric_errors(w_, h_)))
    if "--regen" in sys.argv:
        import os

        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        jax.config.update("jax_platforms", "cpu")
        for path, stats in reference_sphere_passes().items():
            FIXTURE[path].write_text(json.dumps(stats, indent=1))
        print(f"wrote {list(FIXTURE.values())}")
