"""Command-line interface (counterpart of acmmp_spherical_tpu/pipeline/cli.py):

.. code-block:: bash

    python -m acmmp_spherical_torch reconstruct <dense_folder> [--no-prior]
        [--resume] [--seed N] [--max-src-views K] [--size-bound B]
        [--device {cuda,cpu}]
    python -m acmmp_spherical_torch convert --dense_folder <colmap>
        --save_folder <scene> [--model_ext {.txt,.bin}] [--max_d D]
        [--interval_scale S] [--theta0 T] [--top_k K] [--min_shared M]

The reference's binary takes the scene folder alone (main.cpp:392-399).
The run is on the CUDA device unless ``--device cpu`` asks for the CPU.
``convert`` turns a COLMAP sparse model (pinhole models or the SPHERE model
id 11) into a scene folder, on the host (colmap2mvsnet_acm.py).
"""

from __future__ import annotations

import argparse
import sys


def _reconstruct(args) -> int:
    from acmmp_spherical_torch.config import PipelineConfig
    from acmmp_spherical_torch.pipeline.multiscale import run_pipeline

    cfg = PipelineConfig(planar_prior=not args.no_prior, seed=args.seed,
                         skip_if_complete=args.resume,
                         max_src_views=args.max_src_views,
                         size_bound=args.size_bound)
    return 0 if run_pipeline(args.dense_folder, cfg, device=args.device) > 0 \
        else 1


def _convert(args) -> int:
    from acmmp_spherical_torch.pipeline.convert import (
        ConvertOptions, convert_colmap_scene,
    )

    convert_colmap_scene(args.dense_folder, args.save_folder, ConvertOptions(
        model_ext=args.model_ext, max_d=args.max_d,
        interval_scale=args.interval_scale, theta0=args.theta0,
        top_k=args.top_k, min_shared=args.min_shared))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="acmmp_spherical_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("reconstruct",
                       help="dense reconstruction of a scene folder")
    r.add_argument("dense_folder")
    r.add_argument("--no-prior", action="store_true",
                   help="disable the planar-prior second round")
    r.add_argument("--resume", action="store_true",
                   help="skip passes recorded complete in the manifest")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--max-src-views", type=int, default=20)
    r.add_argument("--size-bound", type=int, default=1000,
                   help="pyramid coarsest-scale bound (reference main.cpp:38)")
    r.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device every pass runs on")
    r.set_defaults(fn=_reconstruct)

    c = sub.add_parser("convert", help="COLMAP sparse model -> scene folder")
    c.add_argument("--dense_folder", required=True)
    c.add_argument("--save_folder", required=True)
    c.add_argument("--model_ext", default=".txt", choices=[".txt", ".bin"])
    c.add_argument("--max_d", type=int, default=192)
    c.add_argument("--interval_scale", type=float, default=1.0)
    c.add_argument("--theta0", type=float, default=1.0)
    c.add_argument("--top_k", type=int, default=20)
    c.add_argument("--min_shared", type=int, default=10)
    c.set_defaults(fn=_convert)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
