"""Synthetic problem batches for multi-slot runs and tests (counterpart of
acmmp_spherical_tpu/parallel/synthetic_batch.py).

A B-problem batch from one synthetic scene with B cameras: problem b
reconstructs view b with its nearest ring neighbours as sources, the
structure a real scene's pair.txt gives, so the view-parallel step and its
depth exchange run as on a real scene.
"""

from __future__ import annotations

import numpy as np
import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core.camera import PINHOLE, stack_cameras
from acmmp_spherical_torch.parallel.mesh import tree_map
from acmmp_spherical_torch.parallel.view_parallel import ProblemBatch
from acmmp_spherical_torch.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene,
)


def make_synthetic_batch(n_problems: int, *, model: str = PINHOLE,
                         width: int = 32, height: int = 24, n_src: int = 3,
                         focal: float = 28.0, device="cuda"):
    """Returns (ProblemBatch on ``device``, params, gt depths (B, H, W)
    numpy)."""
    cams = make_ring_of_cameras(n_problems, model=model, width=width,
                                height=height, focal=focal, device="cpu")
    images, depths, _ = render_scene(cams, CubeRoom(), width, height)

    B = n_problems
    src_ids = np.zeros((B, n_src), np.int32)
    for b in range(B):
        # nearest ring neighbours: +-1, +-2, ...
        order = []
        for d in range(1, B):
            order += [(b + d) % B, (b - d) % B]
        src_ids[b] = np.array(sorted(set(order), key=order.index)[:n_src])

    imgs = np.zeros((B, 1 + n_src, height, width), np.float32)
    stacks = []
    for b in range(B):
        imgs[b, 0] = images[b]
        for v, s in enumerate(src_ids[b]):
            imgs[b, 1 + v] = images[int(s)]
        stacks.append(stack_cameras([cams[b]] + [cams[int(s)]
                                                 for s in src_ids[b]]))
    batch_cams = stack_cameras(stacks)

    dmin, dmax = cams[0].depth_range.numpy()
    params = PatchMatchParams().with_depth_range(dmin, dmax)
    batch = ProblemBatch(
        images=torch.as_tensor(imgs, device=device),
        cams=tree_map(lambda t: t.to(device), batch_cams),
        src_valid=torch.ones((B, n_src), dtype=torch.bool, device=device),
        src_view_global=torch.as_tensor(src_ids, device=device))
    return batch, params, depths
