"""Fusion with the reference-view loop over the slots of a mesh
(counterpart of acmmp_spherical_tpu/parallel/fusion.py).

Fusion needs every view's depth, normal and colour rasters: they are copied
to every slot's device once, each slot fuses its contiguous share of the
reference views (``ops/fusion.fuse_reference_view``), and the host
concatenates the valid points in view order, as ``fuse_all_views`` does.
"""

from __future__ import annotations

import numpy as np

from acmmp_spherical_torch.config import FusionParams
from acmmp_spherical_torch.core.camera import Cameras
from acmmp_spherical_torch.ops.fusion import fuse_reference_view
from acmmp_spherical_torch.parallel.mesh import ViewMesh, run_slots, tree_map


def fuse_all_views_sharded(mesh: ViewMesh, depths, normals, colors,
                           cams: Cameras, src_indices: np.ndarray,
                           params: FusionParams):
    """``fuse_all_views`` with the reference views split into
    ``mesh.size`` contiguous shares, one per slot.  ``depths`` (V, Hp, Wp),
    ``normals`` and ``colors`` (V, Hp, Wp, 3), ``cams`` view-batched,
    ``src_indices`` (V, K) int, -1 padded.  Returns numpy (N, 3) points,
    normals, colours."""
    V = depths.shape[0]
    shares = [s for s in np.array_split(np.arange(V), mesh.size) if len(s)]

    def fuse(slot, views):
        dev = mesh.devices[slot]
        d, n, c, cm = tree_map(lambda t: t.to(dev),
                               (depths, normals, colors, cams))
        out = []
        for i in views:
            p, nr, co, v = fuse_reference_view(d, n, c, cm, int(i),
                                               src_indices[i], params)
            out.append(tuple(a[v].cpu().numpy() for a in (p, nr, co)))
        return out

    per_view = [o for outs in run_slots(mesh, fuse, shares) for o in outs]
    cat = lambda a: np.concatenate(a) if a else np.zeros((0, 3), np.float32)
    return tuple(cat([o[k] for o in per_view]) for k in range(3))
