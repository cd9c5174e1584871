#!/usr/bin/env python3
"""Time the rect kernels with packed taps (1p, 4p) beside their f32 variants
(1, 4) on the same operands, and the pair-word frame they read
(``pack_src_pairs``), for one tree of the PyTorch/CUDA port on one GPU.

    python scripts/time_packed_taps.py [ROOT]

``ROOT`` (default: this checkout) is the tree whose ``acmmp_spherical_torch``
is imported, so a parent unpacked beside it can be timed in the same call
(A B B A); a tree whose ``ncc_rect`` has no ``pack_src_pairs`` runs its
packed variant without a pair frame.  Operands, as ``chip_smoke.py``'s:
the 1024x768x8src bench context with random planes (keys 100 + i; C=9 on
parity 0, C=5 on parity 1, C=1 at the init window), its geometric context
with the ground-truth source depths and planes around the ground truth
(C=9, C=5), and the 1024x512x6src SPHERE context with random planes (keys
300 + i).  Each case prints the CUDA-event ms of both variants (5 calls a
turn, turns f32, packed, packed, f32) and the operations bound; the pair
frame's ms (20 calls) with its bytes bound.  One JSON line, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    a = ap.parse_args()
    root = pathlib.Path(a.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_packed_taps: needs a CUDA device", file=sys.stderr)
        return 2
    import acmmp_spherical_torch
    from acmmp_spherical_torch.bench import (
        BENCH_SCENE, SPHERE_BENCH_SCENE, make_problem, make_sphere_problem,
    )
    from acmmp_spherical_torch.core import geometry as G
    from acmmp_spherical_torch.ops import rng as R
    from acmmp_spherical_torch.ops import sphere_rect as SR
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR
    from acmmp_spherical_torch.ops.propagate import prepare_inputs
    from acmmp_spherical_torch.ops.sampling import grid_coords

    if not pathlib.Path(acmmp_spherical_torch.__file__).is_relative_to(root):
        raise RuntimeError(f"imported {acmmp_spherical_torch.__file__}, "
                           f"not the package under {root}")
    cs = _chip_smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _lib.library()
    pairs = getattr(NR, "pack_src_pairs", None)
    out = dict(card=card, root=str(root), pair_frame=pairs is not None,
               cases={}, pack_src_pairs={})

    def case(name, ctx, maps, normals, ws, parity, p, with_geom, sphere):
        if sphere:
            D, AB = NR.warp_transport_plain(*SR.sphere_coefficient_tables(
                ctx, normals, ws, parity), maps.fwd_idx, maps.fwd_valid)
        else:
            D, AB = NR.coefficient_transport(ctx, maps, normals, ws)
        args = (ctx.srow, ctx.tile_oy, ctx.tile_ox, ctx.rect_ref,
                ctx.rect_src, D, AB, maps.fwd_valid)
        sd = dict(sdisp=ctx.rect_sdisp) if with_geom else {}
        pp = dataclasses.replace(p, rect_tap_pack=True)
        fp = dataclasses.replace(p, rect_tap_pack=False)
        pk = {} if pairs is None else dict(src_pk=pairs(ctx.rect_src))
        t = [cs.cuda_ms(lambda q=q, k=k: NR.rect_ncc(*args, q, **sd, **k), 5)
             for q, k in ((fp, {}), (pp, pk), (pp, pk), (fp, {}))]
        C, S, K8, _ = D.shape
        live = int((maps.fwd_valid.reshape(S, K8 // 8, 1024).amax(-1)
                    > 0.5).sum())
        n_taps = len(range(-(p.patch_size // 2), p.patch_size // 2 + 1,
                           p.radius_increment)) ** 2
        out["cases"][name] = dict(
            C=C, pk_ms=(t[1] + t[2]) / 2, f32_ms=(t[0] + t[3]) / 2,
            turns=t, bound_ms=cs.bound(
                0, live * 1024 * C * n_taps * cs.TAP_FLOPS)[0])

    def frame(name, src):
        if pairs is None:
            return
        words = pairs(src)
        out["pack_src_pairs"][name] = dict(
            shape=list(src.shape), ms=cs.cuda_ms(lambda: pairs(src), 20),
            bound_ms=cs.bound(cs.nbytes(src, words), 0)[0])

    def planes(inputs, key0, n):
        H, W = inputs.ref_image.shape
        xs, ys = grid_coords(H, W, dev)
        return [R.random_plane_hypothesis(R.key(key0 + i), inputs.ref_cam, xs,
                                          ys, *inputs.depth_range)
                for i in range(n)]

    def stack(pl, C, parity):
        return cs.packed(torch.stack([n for n, _ in pl[:C]]),
                         torch.stack([w for _, w in pl[:C]]), parity)

    # the pinhole bench context
    inputs, params, gt, gn = make_problem(**BENCH_SCENE, device=dev)
    ctx = prepare_inputs(inputs, params).rect
    frame("pinhole", ctx.rect_src)
    pl = planes(inputs, 100, 9)
    for name, C, parity, p in (
            ("C9_parity0", 9, 0, params), ("C5_parity1", 5, 1, params),
            ("C1_init", 1, None, dataclasses.replace(
                params, rect_win_w=params.rect_init_win))):
        case(name, ctx, ctx.maps[0 if parity is None else 1 + parity],
             *stack(pl, C, parity), parity, p, False, False)
    # its geometric context: ground-truth source depths, planes around the
    # ground truth
    gparams = params.with_geom(multi_geometry=False)
    gctx = prepare_inputs(dataclasses.replace(
        inputs, src_depths=torch.as_tensor(gt[1:], device=dev)),
        gparams).rect
    H, W = inputs.ref_image.shape
    xs, ys = grid_coords(H, W, dev)
    cam = inputs.ref_cam
    n = G.normalize(G.normal_world_to_cam(cam, torch.as_tensor(
        gn[0], device=dev)))
    w = G.dist_to_origin(cam, xs, ys, torch.as_tensor(gt[0], device=dev), n)
    for name, C, parity in (("geom_C9_parity0", 9, 0),
                            ("geom_C5_parity1", 5, 1)):
        scale = 1.0 + 0.005 * (torch.arange(C, device=dev) - C // 2)
        case(name, gctx, gctx.maps[1 + parity], *cs.packed(
            n.expand(C, *n.shape), w * scale[:, None, None], parity), parity,
             gparams, True, False)
    del ctx, gctx
    # the SPHERE bench context
    sinputs, sparams = make_sphere_problem(**SPHERE_BENCH_SCENE,
                                           device=dev)[:2]
    sctx = prepare_inputs(sinputs, sparams).rect
    frame("sphere", sctx.rect_src)
    pl = planes(sinputs, 300, 9)
    for name, C, parity, p in (
            ("sphere_C1_init", 1, None, dataclasses.replace(
                sparams, rect_win_w=sparams.rect_init_win)),
            ("sphere_C9_parity0", 9, 0, sparams),
            ("sphere_C5_parity1", 5, 1, sparams)):
        case(name, sctx, sctx.maps[0 if parity is None else 1 + parity],
             *stack(pl, C, parity), parity, p, False, True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
