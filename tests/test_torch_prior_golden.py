"""The port's golden planar-prior and hierarchy passes against the
reference's statistics.

``bench.golden_prior_pass`` (photometric pass, prior build, prior pass, as
the pass runner chains them) on the rectified and windowed paths and
``bench.golden_hier_pass`` (seeded from ``bench.golden_geom_fields``) on the
rectified path, on the golden problem (96x64x3src, both bf16 packs off,
key 2333), against tests/fixtures/golden_prior_pass_stats_{rect,window}.json
and golden_hier_pass_stats_rect.json, made by the reference chained the
same way: region statistics within the CPU fixtures' 2e-3 on the rectified
path and 1e-2 on the windowed one (the windowed pass's f32 gap, ROADMAP
Queue 3 item 7); median relative depth error < 0.01.

Regenerate the three fixtures from the reference (CPU, interpret mode,
about 13 minutes):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_prior_golden.py --regen
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

from acmmp_spherical_torch.bench import (  # noqa: E402
    GOLDEN_KEY, GOLDEN_SCENE, golden_geom_fields, golden_hier_pass,
    golden_prior_pass, make_problem,
)

from test_regression_fixture import _stats, check_against_fixture  # noqa: E402
from torch_port_util import golden_scene, jax_inputs, rect_params  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
FIXTURE_PRIOR = {p: FIXTURES / f"golden_prior_pass_stats_{p}.json"
                 for p in ("rect", "window")}
FIXTURE_HIER = FIXTURES / "golden_hier_pass_stats_rect.json"
TOL = {"rect": 2e-3, "window": 1e-2}


@pytest.mark.parametrize("path", ["rect", "window"])
def test_golden_prior_pass_matches_fixture(path):
    inputs, params, depths, _ = make_problem(**GOLDEN_SCENE, device="cpu")
    if path == "window":
        params = dataclasses.replace(params, rect_ncc=False, fast_ncc=True)
    d, n, c, _ = golden_prior_pass(inputs, params)
    assert bool(torch.isfinite(d).all())
    check_against_fixture(_stats(d.numpy(), n.numpy(), c.numpy()),
                          json.loads(FIXTURE_PRIOR[path].read_text()),
                          rtol=TOL[path], atol=TOL[path])
    rel = np.abs(d.numpy() - depths[0]) / depths[0]
    assert np.median(rel[8:-8, 8:-8]) < 0.01


def test_golden_hier_pass_matches_fixture():
    inputs, params, depths, normals = make_problem(**GOLDEN_SCENE,
                                                   device="cpu")
    d, n, c, _ = golden_hier_pass(inputs, params, depths, normals)
    check_against_fixture(_stats(d.numpy(), n.numpy(), c.numpy()),
                          json.loads(FIXTURE_HIER.read_text()),
                          rtol=TOL["rect"], atol=TOL["rect"])
    rel = np.abs(d.numpy() - depths[0]) / depths[0]
    assert np.median(rel[8:-8, 8:-8]) < 0.01


def reference_golden_passes():
    """Region statistics of the reference's golden prior passes (rect,
    window) and golden hierarchy pass, chained as ``bench.golden_prior_pass``
    and ``bench.golden_hier_pass`` chain the port's."""
    from acmmp_spherical_tpu.config import PriorConfig
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops import rectify as RT
    from acmmp_spherical_tpu.ops.propagate import prepare_inputs
    from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_tpu.pipeline.prior import build_planar_prior

    cams, _, images, depths, normals = golden_scene()
    inv = RT.rect_inv_attrib_ok(cams[0], stack_cameras(cams[1:]),
                                RT.rect_shape(*depths.shape[1:]))
    base = rect_params(cams, inv_attrib=inv)
    key = jax.random.key(GOLDEN_KEY)
    out = {}
    for path, params in (("rect", base), ("window", dataclasses.replace(
            base, rect_ncc=False, fast_ncc=True))):
        jin = prepare_inputs(jax_inputs(cams, images), params)
        d, _, c, state = run_patchmatch(jin, params, key)
        dmin, dmax = np.asarray(jin.depth_range)
        pn, pw, mask, _ = build_planar_prior(
            cams[0], np.asarray(d), np.asarray(c), dmin, dmax, PriorConfig())
        jin = jin._replace(prior_normal=jnp.asarray(pn),
                           prior_w=jnp.asarray(pw),
                           prior_mask=jnp.asarray(mask))
        out[path] = _stats(*(np.asarray(a) for a in run_patchmatch(
            jin, params.with_planar_prior(), jax.random.fold_in(key, 1),
            prev_state=state)[:3]))
    _, seed_d, seed_n = golden_geom_fields(depths, normals)
    out["hier"] = _stats(*(np.asarray(a) for a in run_patchmatch(
        jax_inputs(cams, images), base.with_hierarchy(), key,
        seed_normal_world=jnp.asarray(seed_n),
        seed_depth=jnp.asarray(seed_d))[:3]))
    return out


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import os

        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        jax.config.update("jax_platforms", "cpu")
        stats = reference_golden_passes()
        for path, f in FIXTURE_PRIOR.items():
            f.write_text(json.dumps(stats[path], indent=1))
        FIXTURE_HIER.write_text(json.dumps(stats["hier"], indent=1))
        print(f"wrote {list(FIXTURE_PRIOR.values())} and {FIXTURE_HIER}")
