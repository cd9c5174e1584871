"""Command-line interface (counterpart of acmmp_spherical_tpu/pipeline/cli.py):

.. code-block:: bash

    python -m acmmp_spherical_torch reconstruct <dense_folder> [--no-prior]
        [--resume] [--seed N] [--max-src-views K] [--size-bound B]
        [--device {cuda,cpu}]

The reference's binary takes the scene folder alone (main.cpp:392-399).
The run is on the CUDA device unless ``--device cpu`` asks for the CPU.
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
