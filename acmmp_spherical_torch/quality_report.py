"""Quality report: reconstruct a synthetic golden scene with the port and
print ETH3D-style accuracy / completeness and depth-error statistics as one
JSON line (counterpart of scripts/quality_report.py, which drives the JAX
package).

    python -m acmmp_spherical_torch.quality_report [--model pinhole|sphere]
        [--size W H] [--views N] [--fast on|off|auto] [--rect on|off|auto]
        [--scene cube|occluded] [--hostile] [--tau T] [--out FILE]
        [--device cuda|cpu]

The options and the printed keys are the JAX script's, plus ``--device``
(default cuda; "auto" paths turn the kernel paths on only on CUDA).  The
golden is the analytic cube room (``utils/synthetic``): ground truth is
exact, so the numbers measure the engine, not the fixture.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import tempfile
import time

import numpy as np


def report(args) -> dict:
    """Run the pipeline on the scene ``args`` describes; the report dict."""
    import torch

    from acmmp_spherical_torch.config import PipelineConfig
    from acmmp_spherical_torch.core import geometry as G
    from acmmp_spherical_torch.io import read_ply
    from acmmp_spherical_torch.io.dmb import read_depth_dmb
    from acmmp_spherical_torch.io.scene import ScenePaths
    from acmmp_spherical_torch.pipeline.multiscale import run_pipeline
    from acmmp_spherical_torch.utils.metrics import (
        cloud_accuracy_completeness, cube_surface_distance, depth_error_stats,
    )
    from acmmp_spherical_torch.utils.synthetic import (
        CubeRoom, OccludedRoom, make_ring_of_cameras, render_scene,
        render_scene_hostile, write_synthetic_scene_to_disk,
    )

    W, H = args.size
    scene = OccludedRoom() if args.scene == "occluded" else CubeRoom()
    cams = make_ring_of_cameras(args.views, model=args.model, width=W,
                                height=H, focal=0.9 * W, device="cpu")
    render = render_scene_hostile if args.hostile else render_scene
    images, gt_depths, _ = render(cams, scene, W, H)
    cfg = dataclasses.replace(PipelineConfig(), fast_ncc=args.fast,
                              rect_ncc=args.rect)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp) / "dense"
        write_synthetic_scene_to_disk(root, cams, images)
        t0 = time.time()
        n_points = run_pipeline(root, cfg, device=args.device)
        wall = time.time() - t0
        sp = ScenePaths(root)
        depth_stats = depth_error_stats(
            read_depth_dmb(sp.depth_file(0, geom=True)), gt_depths[0])
        pts = read_ply(sp.ply_file())[0]

    # the ground-truth cloud: every view's true depth unprojected
    gt_pts = []
    ys, xs = (torch.from_numpy(a) for a in
              np.mgrid[0:H, 0:W].astype(np.float32))
    for v, cam in enumerate(cams):
        gt_pts.append(G.unproject_world(
            cam, xs, ys, torch.from_numpy(gt_depths[v])).numpy()
            .reshape(-1, 3))
    gt_pts = np.concatenate(gt_pts)[::7]   # subsampled for the KD-tree
    cloud = cloud_accuracy_completeness(pts, gt_pts, args.tau)
    cloud["frac_on_surface"] = float(
        np.mean(cube_surface_distance(pts, scene.half) < args.tau))
    return {
        "scene": f"{args.scene}_room_{args.model}_{W}x{H}x{args.views}v"
                 + ("_hostile" if args.hostile else ""),
        "fast_ncc": args.fast,
        "rect_ncc": args.rect,
        "wall_s": round(wall, 1),
        "n_points": int(n_points),
        **{k: round(v, 4) for k, v in depth_stats.items()},
        **{k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in cloud.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="acmmp_spherical_torch.quality_report")
    ap.add_argument("--model", default="pinhole", choices=["pinhole", "sphere"])
    ap.add_argument("--size", type=int, nargs=2, default=[128, 96])
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--fast", default="auto", choices=["on", "off", "auto"])
    ap.add_argument("--rect", default="auto", choices=["on", "off", "auto"])
    ap.add_argument("--scene", default="cube", choices=["cube", "occluded"])
    ap.add_argument("--hostile", action="store_true",
                    help="per-view gain/bias + specular lobe + sensor noise "
                         "+ JPEG round-trip (render_scene_hostile)")
    ap.add_argument("--tau", type=float, default=0.08,
                    help="accuracy threshold (scene units; room is 8 units)")
    ap.add_argument("--out", default="", help="also write the JSON here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device every pass runs on")
    args = ap.parse_args(argv)
    out = report(args)
    print(json.dumps(out))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
