#!/usr/bin/env python3
"""Time the disparity warp (kernel 5) and the windowed sampler (kernel 7) of
one tree of the PyTorch/CUDA port at the bench shapes, on one GPU.

    python scripts/time_disp_sampler.py [ROOT]

``ROOT`` (default: this checkout) is the tree whose ``acmmp_spherical_torch``
is imported, so a parent unpacked beside it can be timed in the same call
(A B B A).  Inputs: the 1024x768x8src bench scene, its ground-truth source
depths (kernel 5, gate on) and the centre-tap projections of its
ground-truth depth into source view 0 (kernel 7).  For each kernel it
prints ``ms`` (device time of the kernel per call, torch.profiler),
``call_ms`` (CUDA events around the Python entry point), the device kernels
per launch and the bound, as one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
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
        print("time_disp_sampler: needs a CUDA device", file=sys.stderr)
        return 2
    import acmmp_spherical_torch
    from acmmp_spherical_torch.bench import BENCH_SCENE, make_problem
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.ops.kernels import warp_image as WI
    from acmmp_spherical_torch.ops.kernels import window_sample as WS
    from acmmp_spherical_torch.ops.propagate import prepare_inputs
    from acmmp_spherical_torch.ops.rectify import SENTINEL_THRESH, rect_shape

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
    inputs, params, depths = make_problem(**BENCH_SCENE, device=dev)[:3]
    rect = prepare_inputs(inputs, params).rect
    H, W = inputs.ref_image.shape
    src = inputs.src_cams
    dargs = (torch.as_tensor(depths[1:], device=dev), rect.pr.H1inv,
             rect.pr.R_sr, src.K, rect.pr.K[:, 0] * rect.pr.baseline,
             src.width, src.height, rect_shape(H, W), params.rect_warp_hw)
    out = dict(card=card, root=str(root))

    disp = lambda: WI.warp_src_disparities(*dargs)
    k = disp()
    valid = int((k > SENTINEL_THRESH).sum())
    ms, per_call = cs.device_ms(disp, "warp_disp_kernel", 50)
    out["warp_src_disparities"] = dict(
        ms=ms, call_ms=cs.cuda_ms(disp, 50), device_kernels_per_call=per_call,
        bound_ms=cs.bound(cs.nbytes(dargs[0], k),
                          valid * cs.DISP_FLOPS)[0])

    px, py = cs.centre_projections(inputs, torch.as_tensor(depths[0],
                                                           device=dev))
    sargs = (inputs.src_images[0], px[0], py[0])
    samp = lambda: WS.windowed_sample(*sargs, src_h=H, src_w=W)
    v, ok = samp()
    ms, per_call = cs.device_ms(samp, "window_sample_kernel", 50)
    out["window_sample"] = dict(
        ms=ms, call_ms=cs.cuda_ms(samp, 50), device_kernels_per_call=per_call,
        bound_ms=cs.bound(cs.nbytes(*sargs, v, ok),
                          H * W * cs.SAMPLE_FLOPS)[0],
        ok_fraction=float(ok.float().mean()))

    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
