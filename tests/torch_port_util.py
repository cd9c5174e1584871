"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

The golden problem is the 96x64x3src ring of test_regression_fixture.py:
its rect frame is 136x384, with a 136x256 compute grid and 32 live tiles.
Inputs come from numpy and are handed to the JAX reference and to the port
alike; JAX state crosses over as numpy dicts through
``acmmp_spherical_torch.interop``, onto the CPU (the port's entry points
default to the CUDA device).
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


def port_params(params):
    """The port's PatchMatchParams with the fields of the reference's."""
    from acmmp_spherical_torch import interop

    return interop.params(dataclasses.asdict(params))


def rect_params(cams_jax, *, inv_attrib=True, iterations=3, hw=(H, W),
                packs=False):
    """The golden problem's rect+warp PatchMatchParams, both bf16 packs off
    unless ``packs`` (host mirrors from the reference package); ``hw`` the
    frame size."""
    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops import rectify as RT

    src = stack_cameras(cams_jax[1:])
    rhw = RT.rect_shape(*hw)
    chw = RT.rect_comp_shape(cams_jax[0], src, rhw)
    iwin = RT.rect_init_window(cams_jax[0], src, rhw)
    return dataclasses.replace(
        PatchMatchParams(), max_iterations=iterations, rect_ncc=True,
        rect_comp_hw=chw,
        rect_live_n=RT.rect_live_tile_count(cams_jax[0], src, rhw, chw),
        rect_init=iwin > 0, rect_init_win=iwin or 384,
        rect_warp_hw=RT.rect_warp_window(cams_jax[0], src, rhw),
        rect_inv_attrib=inv_attrib, rect_tap_pack=packs,
        rect_backmap_pack=packs)


def golden_scene(width=W, height=H, n_views=N_VIEWS, focal=80.0):
    """(JAX cameras, torch cameras, images, depths, normals) of the golden
    ring (or a ring of another size), rendered by the reference package."""
    from acmmp_spherical_tpu.core.camera import PINHOLE
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )
    from acmmp_spherical_torch import interop

    cams = make_ring_of_cameras(n_views, model=PINHOLE, width=width,
                                height=height, focal=focal)
    images, depths, normals = render_scene(cams, CubeRoom(), width, height)
    tcams = [interop.camera(jax_cam_dict(c), device="cpu") for c in cams]
    return cams, tcams, images, depths, normals


def jax_inputs(cams, images, src_depths=None):
    """The reference's PatchMatchInputs of a rendered ring."""
    import jax.numpy as jnp

    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs

    imgs = jnp.asarray(images)
    return PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0],
        src_cams=stack_cameras(cams[1:]),
        src_valid=jnp.ones(len(cams) - 1, bool),
        depth_range=jnp.asarray(np.asarray(cams[0].depth_range), jnp.float32),
        src_depths=None if src_depths is None else jnp.asarray(src_depths))


def port_inputs(tcams, images, src_depths=None):
    """The port's PatchMatchInputs of the same ring, on the CPU."""
    import torch

    from acmmp_spherical_torch.core.camera import stack_cameras
    from acmmp_spherical_torch.ops.propagate import PatchMatchInputs

    imgs = torch.from_numpy(images)
    return PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=tcams[0],
        src_cams=stack_cameras(tcams[1:]),
        src_valid=torch.ones(len(tcams) - 1, dtype=torch.bool),
        depth_range=tcams[0].depth_range,
        src_depths=None if src_depths is None else torch.from_numpy(
            np.ascontiguousarray(src_depths)))


# Sample grids for the windowed sampler's window placement at the edges of
# the int32 range: "<axis>_<value>" puts one sample of tile (0, 0) at that
# coordinate; "nonfinite_tile" makes every coordinate of tile (1, 1)
# non-finite; "nan_inf_mixed" mixes NaN and +-inf into tile (0, 1).
WINDOW_EDGE_CASES = (
    "x_-3e9", "x_-1e12", "x_-2^31", "x_-2^31+128", "x_+3e9", "x_+1e30",
    "x_-1e30", "y_-3e9", "y_-2^31", "nonfinite_tile", "nan_inf_mixed")


def window_edge_case(case: str):
    """(src (96, 640), x, y (16, 256), src_h, src_w), float32: smooth
    in-image samples over 2x2 tiles of 8x128, edited as ``case`` says.  The
    source is wider and taller than the 40x384 window, so an origin clipped
    to the far edge differs from one clipped to 0."""
    rng = np.random.default_rng(7)
    Hs, Ws = 96, 640
    src = rng.random((Hs, Ws)).astype(np.float32)
    ys, xs = np.mgrid[0:16, 0:256].astype(np.float32)
    x = (xs * 1.5 + 3.7 + 2 * np.sin(ys / 17)).astype(np.float32)
    y = (ys * 2.5 + 1.2 + 1.5 * np.cos(xs / 23)).astype(np.float32)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    if case == "nonfinite_tile":
        x[8:16, 128:256] = np.where(xs[8:16, 128:256] % 3 == 0, nan,
                                    np.where(xs[8:16, 128:256] % 3 == 1,
                                             inf, -inf))
        y[8:16, 128:256] = np.where(ys[8:16, 128:256] % 2 == 0, -inf, nan)
    elif case == "nan_inf_mixed":
        x[0, 130:140] = nan
        x[2, 150:160] = inf
        x[5, 200:210] = -inf
        y[3, 140:150] = nan
        y[6, 240:250] = -inf
        y[7, 129] = inf
    else:
        axis, value = case.split("_")
        v = {"-3e9": -3e9, "-1e12": -1e12, "-2^31": -2.0 ** 31,
             "-2^31+128": -2.0 ** 31 + 128, "+3e9": 3e9, "+1e30": 1e30,
             "-1e30": -1e30}[value]
        (x if axis == "x" else y)[3, 17] = np.float32(v)
    return src, x, y, Hs, Ws
