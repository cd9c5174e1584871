#!/usr/bin/env python3
"""Where ``rect_prescreen`` moves the depth error of geometric passes, and
whether the geometric term that its refinement leaves out (ROADMAP Queue 3
hazard g) accounts for it.  A diagnostic of the port on the card; the term
is put back only inside this script.

    python scripts/prescreen_geom_term.py

Each case runs three ways: ``default`` (prescreen off), ``prescreen`` (on,
as the JAX package computes it) and ``prescreen+geom`` (on, with the
prescreened refinement ranking its 5 candidates and costing its winner with
``geom_weight_refine`` x the geometric term, as the refinement without
prescreen does: a copy of ``ops/propagate._prescreened_refinement`` patched
in for the run).  The cases:

* the bench geometric pass (CubeRoom 1024x768x8src, ``chip_smoke.py``
  phases 4 and 4b) in two chains, ``packed`` (both bf16 packs on, source
  depths from packed passes) and ``f32`` (packs off): the source depths are
  made once per chain and shared by the three ways, the seeds come from the
  photometric pass of the same way;
* the SPHERE bench geometric pass (1024x512x6src, packs on, source depths
  from keys 2000 + i), error over the latitude band;
* ``chip_smoke.py`` phase 11's SPHERE scene (6 views at 1024x512, two
  scales) through ``run_pipeline`` at ``PipelineConfig()`` defaults: per
  view the median relative depth error of the last scale's hierarchy pass
  (``depths.dmb``) and of the final depth (``depths_geom.dmb``), and the
  fused points.

Prints one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from acmmp_spherical_torch.bench import (  # noqa: E402
    BENCH_SCENE, SPHERE_BENCH_SCENE, make_problem, make_sphere_problem,
    sphere_band_errors, source_depths,
)
from acmmp_spherical_torch.config import (  # noqa: E402
    PatchMatchParams, PipelineConfig,
)
from acmmp_spherical_torch.core import geometry as G  # noqa: E402
from acmmp_spherical_torch.io import read_depth_dmb  # noqa: E402
from acmmp_spherical_torch.io.scene import ScenePaths  # noqa: E402
from acmmp_spherical_torch.ops import propagate as TP  # noqa: E402
from acmmp_spherical_torch.pipeline import multiscale  # noqa: E402
from acmmp_spherical_torch.pipeline.patchmatch import (  # noqa: E402
    run_patchmatch,
)

from chip_smoke import (  # noqa: E402
    SPHERE_PIPELINE_SCENE, write_pipeline_scene,
)

WAYS = ("default", "prescreen", "prescreen+geom")


def refinement_with_geom(inputs, ctx, params, sel, normal, w, depth, cost,
                         cand_normals, cand_w, cand_depth_at, can_refine,
                         dmin, dmax, parity):
    """``_prescreened_refinement`` with the geometric term in the coarse
    ranking and in the winner's full-tap cost."""
    cv5, gv5 = TP._batched_cost_vectors(inputs, ctx, TP.coarse_params(params),
                                        cand_normals, cand_w, parity=parity)
    valid5 = (can_refine[None] & (cand_depth_at >= dmin)
              & (cand_depth_at <= dmax) & (cand_depth_at < G.INVALID_DEPTH))
    pre = torch.stack([
        TP._aggregate(cv5[i], None if gv5 is None else gv5[i], sel.weights,
                      sel.weight_norm, params.geom_weight_refine)
        for i in range(5)])
    pre = torch.where(valid5, pre, torch.full_like(pre, float("inf")))
    pick = torch.argmin(pre, 0)
    take = lambda a: torch.gather(a, 0, pick[None])[0]
    win_n = torch.gather(cand_normals, 0,
                         pick[None, ..., None].expand(1, *normal.shape))[0]
    win_w, win_d = take(cand_w), take(cand_depth_at)
    win_valid = take(valid5.to(torch.int32)) > 0
    cv1, gv1 = TP._batched_cost_vectors(inputs, ctx, params, win_n[None],
                                        win_w[None], parity=parity)
    win_cost = TP._aggregate(cv1[0], None if gv1 is None else gv1[0],
                             sel.weights, sel.weight_norm,
                             params.geom_weight_refine)
    accept = win_valid & (win_cost < cost)
    return (torch.where(accept[..., None], win_n, normal),
            torch.where(accept, win_w, w), torch.where(accept, win_d, depth),
            torch.where(accept, win_cost, cost))


@contextlib.contextmanager
def way(name):
    """The parameters' prescreen flag for ``name``, with the refinement
    patched for "prescreen+geom"."""
    kept = TP._prescreened_refinement
    if name == "prescreen+geom":
        TP._prescreened_refinement = refinement_with_geom
    try:
        yield name != "default"
    finally:
        TP._prescreened_refinement = kept


def median_rel_err(depth, gt, border=8):
    d = depth.cpu().numpy()[border:-border, border:-border]
    g = gt[border:-border, border:-border]
    return float(np.median(np.abs(d - g) / g))


def geometric_passes(inputs, params, src_inputs, key_base, err):
    """The geometric pass each way, seeded from the photometric pass of
    the same way; returns {way: error}."""
    out = {}
    for name in WAYS:
        with way(name) as on:
            p = dataclasses.replace(params, rect_prescreen=on)
            d, n = run_patchmatch(inputs, p, 3)[:2]
            g = run_patchmatch(src_inputs, p.with_geom(multi_geometry=False),
                               key_base + 3, seed_normal_world=n,
                               seed_depth=d)[0]
            torch.cuda.synchronize()
            out[name] = dict(photometric=err(d), geometric=err(g))
    return out


def scene_runs(dev, work):
    """Phase 11's scene each way: per-view errors and fused points."""
    sc = SPHERE_PIPELINE_SCENE
    gt, _ = write_pipeline_scene(sc, work / "scene")
    out = {}
    for name in WAYS:
        root = work / name.replace("+", "_")
        subprocess.run(["cp", "-r", str(work / "scene"), str(root)],
                       check=True)
        with way(name) as on:
            cfg = PipelineConfig(patchmatch=dataclasses.replace(
                PatchMatchParams(), rect_prescreen=on))
            t0 = time.perf_counter()
            points = multiscale.run_pipeline(root, cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        sp = ScenePaths(root)
        errs = {k: [float(np.median(np.abs(read_depth_dmb(sp.depth_file(
            v, geom=geom)) - gt[v]) / gt[v])) for v in range(sc["n_views"])]
            for k, geom in (("hierarchy", False), ("final", True))}
        out[name] = dict(errs, fused_points=int(points), wall_s=wall)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("prescreen_geom_term needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(card=card.strip().splitlines()[0] if card else None)
    for chain, packs in (("packed", True), ("f32", False)):
        inputs, params, gt = make_problem(**BENCH_SCENE, device=dev,
                                          packs=packs)[:3]
        src = dataclasses.replace(inputs,
                                  src_depths=source_depths(inputs, params))
        out[f"bench {chain}"] = geometric_passes(
            inputs, params, src, 100, lambda d: median_rel_err(d, gt[0]))
        print(json.dumps({f"bench {chain}": out[f"bench {chain}"]}),
              file=sys.stderr, flush=True)
        del inputs, src
    inputs, params, gt = make_sphere_problem(**SPHERE_BENCH_SCENE,
                                             device=dev, packs=True)[:3]
    src = dataclasses.replace(inputs, src_depths=source_depths(
        inputs, params, key_base=2000))
    out["sphere bench"] = geometric_passes(
        inputs, params, src, 50,
        lambda d: sphere_band_errors(d.cpu().numpy(), gt[0],
                                     inputs.ref_cam)["band"])
    print(json.dumps({"sphere bench": out["sphere bench"]}), file=sys.stderr,
          flush=True)
    del inputs, src
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["sphere scene"] = scene_runs(dev, pathlib.Path(tmp))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
