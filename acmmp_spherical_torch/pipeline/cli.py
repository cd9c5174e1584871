"""Command-line interface (counterpart of acmmp_spherical_tpu/pipeline/cli.py):

.. code-block:: bash

    python -m acmmp_spherical_torch reconstruct <dense_folder> [--no-prior]
        [--resume] [--seed N] [--max-src-views K] [--size-bound B]
        [--batch {auto,on,off}] [--tile-shard N] [--device {cuda,cpu}]
        [--distributed [--coordinator HOST:PORT] [--num-processes N]
         [--process-id R]]
    python -m acmmp_spherical_torch convert --dense_folder <colmap>
        --save_folder <scene> [--model_ext {.txt,.bin}] [--max_d D]
        [--interval_scale S] [--theta0 T] [--top_k K] [--min_shared M]

The reference's binary takes the scene folder alone (main.cpp:392-399).
The run is on the CUDA device unless ``--device cpu`` asks for the CPU.
``--tile-shard N`` cuts every depth map into N width tiles over N slots of
the local CUDA devices (round-robin: N slots of the one card on a host with
one GPU; N slots of the CPU with ``--device cpu``; a rank's own device
under ``--distributed``).
``--distributed`` runs the command as one rank of several processes (one
command per rank, on one or several hosts sharing the scene folder): it
starts a gloo process group at ``tcp://<coordinator>``, or from torchrun's
environment (``env://``) without ``--coordinator``; a rank runs on CUDA
device ``(LOCAL_RANK or its rank) % device_count``.  The ranks exchange
only files and barriers, so gloo serves, and several ranks may share one
GPU.  A barrier that waits longer than ``ACMMP_BARRIER_TIMEOUT_S``
seconds (an environment variable; default 1800, gloo's own) fails the run,
so a rank that died does not hang the others.
``convert`` turns a COLMAP sparse model (pinhole models or the SPHERE model
id 11) into a scene folder, on the host (colmap2mvsnet_acm.py).
"""

from __future__ import annotations

import argparse
import sys


def _init_distributed(args):
    """Start the gloo process group; returns (rank, device)."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=(f"tcp://{args.coordinator}" if args.coordinator
                             else "env://"),
        world_size=-1 if args.num_processes is None else args.num_processes,
        rank=-1 if args.process_id is None else args.process_id,
        timeout=datetime.timedelta(seconds=float(os.environ.get(
            "ACMMP_BARRIER_TIMEOUT_S", "1800"))))
    rank = dist.get_rank()
    if args.device == "cpu":
        return rank, "cpu"
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(f"rank {rank}: --device cuda, but this host has "
                           "no CUDA device")
    index = int(os.environ.get("LOCAL_RANK", rank)) % n
    torch.cuda.set_device(index)
    return rank, f"cuda:{index}"


def _reconstruct(args) -> int:
    from acmmp_spherical_torch.config import PipelineConfig
    from acmmp_spherical_torch.pipeline.multiscale import run_pipeline

    rank, device = 0, args.device
    if args.distributed:
        rank, device = _init_distributed(args)
    cfg = PipelineConfig(planar_prior=not args.no_prior, seed=args.seed,
                         skip_if_complete=args.resume,
                         max_src_views=args.max_src_views,
                         size_bound=args.size_bound,
                         batch_problems=args.batch,
                         tile_shard=args.tile_shard)
    try:
        n = run_pipeline(args.dense_folder, cfg, device=device)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    # rank 0 fuses; the other ranks succeed by finishing their share
    return 0 if n > 0 or rank > 0 else 1


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
    r.add_argument("--batch", default="auto", choices=["auto", "on", "off"],
                   help="chunked pass execution over the local devices"
                        " (auto: on when >1 CUDA device, in one process)")
    r.add_argument("--tile-shard", type=int, default=1,
                   help="intra-image tile parallelism: cut each depth map "
                        "along the image width into N tiles over N local "
                        "device slots (halo exchange) for frames too large "
                        "for one device; forces the exact path and disables "
                        "batching")
    r.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device every pass runs on")
    r.add_argument("--distributed", action="store_true",
                   help="run as one rank of a torch.distributed (gloo) "
                        "group; each rank runs this same command against "
                        "the shared scene folder")
    r.add_argument("--coordinator", default="",
                   help="rank 0's address host:port (default: torchrun's "
                        "MASTER_ADDR/MASTER_PORT environment)")
    r.add_argument("--num-processes", type=int, default=None)
    r.add_argument("--process-id", type=int, default=None)
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
