"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

The golden problem is the 96x64x3src ring of test_regression_fixture.py:
its rect frame is 136x384, with a 136x256 compute grid and 32 live tiles.
Inputs come from numpy and are handed to the JAX reference and to the port
alike; JAX state crosses over as numpy dicts through
``acmmp_spherical_torch.interop``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

W, H, N_VIEWS = 96, 64, 4


def np_tree(x):
    """A JAX NamedTuple/dataclass pytree -> nested dict of numpy arrays."""
    if hasattr(x, "_asdict"):
        return {k: np_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return [np_tree(v) for v in x]
    if x is None:
        return None
    return np.asarray(x)


def jax_cam_dict(cam) -> dict:
    return {k: np.asarray(getattr(cam, k)) for k in
            ("R", "t", "K", "params", "wh", "depth_range")}


def rect_params(cams_jax, *, inv_attrib=True, iterations=3):
    """The golden problem's rect+warp PatchMatchParams, both bf16 packs off
    (host mirrors from the reference package)."""
    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops import rectify as RT

    src = stack_cameras(cams_jax[1:])
    rhw = RT.rect_shape(H, W)
    chw = RT.rect_comp_shape(cams_jax[0], src, rhw)
    iwin = RT.rect_init_window(cams_jax[0], src, rhw)
    return dataclasses.replace(
        PatchMatchParams(), max_iterations=iterations, rect_ncc=True,
        rect_comp_hw=chw,
        rect_live_n=RT.rect_live_tile_count(cams_jax[0], src, rhw, chw),
        rect_init=iwin > 0, rect_init_win=iwin or 384,
        rect_warp_hw=RT.rect_warp_window(cams_jax[0], src, rhw),
        rect_inv_attrib=inv_attrib, rect_tap_pack=False,
        rect_backmap_pack=False)


def golden_scene():
    """(JAX cameras, torch cameras, images, depths, normals) of the golden
    ring, rendered by the reference package."""
    from acmmp_spherical_tpu.core.camera import PINHOLE
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )
    from acmmp_spherical_torch import interop

    cams = make_ring_of_cameras(N_VIEWS, model=PINHOLE, width=W, height=H,
                                focal=80.0)
    images, depths, normals = render_scene(cams, CubeRoom(), W, H)
    tcams = [interop.camera(jax_cam_dict(c)) for c in cams]
    return cams, tcams, images, depths, normals
