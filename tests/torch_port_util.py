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
import pathlib

import numpy as np

W, H, N_VIEWS = 96, 64, 4
FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def np_tree(x):
    """A JAX NamedTuple/dataclass pytree -> nested dict of numpy arrays."""
    if hasattr(x, "_asdict"):
        return {k: np_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return [np_tree(v) for v in x]
    if x is None:
        return None
    return np.asarray(x)


def _flatten(tree, key, out, nones):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{key}{k}/", out, nones)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{key}#{i}/", out, nones)
    elif tree is None:
        nones.append(key[:-1])
    else:
        out[key[:-1]] = np.asarray(tree)


def _unflatten(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        *path, last = key.split("/")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[last] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [lists(node[f"#{i}"]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def save_tree(path, tree: dict):
    """Write a nested dict/list tree of arrays (and Nones) losslessly."""
    flat, nones = {}, []
    _flatten(tree, "", flat, nones)
    np.savez_compressed(path, **flat, __none__=np.array(nones, dtype=str))


def load_tree(path) -> dict:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__none__"}
        flat.update((k, None) for k in z["__none__"])
    return _unflatten(flat)


def reference_arrays(name: str, build, regen: bool = False) -> dict:
    """The JAX package's outputs stored in tests/fixtures/<name>.npz: a tree
    of numpy arrays, in the dtypes the JAX package returned.  With
    ``regen``, ``build()`` (the code that runs the JAX package) makes the
    tree and the file is written anew.  The tests read the file, so none of
    them compiles the reference's interpret-mode Pallas programs;
    tests/test_torch_reference_fixtures.py (slow) rebuilds every file and
    requires it equal, bit for bit."""
    path = FIXTURES / f"{name}.npz"
    if regen:
        save_tree(path, build())
        print(f"wrote {path}", flush=True)
    return load_tree(path)


def regen_references(references: dict):
    """``--regen`` of a test file: rebuild each of its stored references,
    with JAX set up as under pytest."""
    import conftest  # noqa: F401

    for name, build in references.items():
        reference_arrays(name, build, regen=True)


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


def rect_dict(rect) -> dict:
    """The reference's rectified context (pinhole or SPHERE) as
    ``interop.rect_context`` or ``interop.sphere_rect_context`` reads it:
    its transport maps less the fields the port does not take."""
    d = np_tree(rect)
    d["maps"] = [{k: m[k] for k in ("fwd_idx", "fwd_valid", "bwd_cidx",
                                    "bwd_x", "bwd_y", "bwd_valid")}
                 for m in d["maps"]]
    return d


def input_dict(jin) -> dict:
    """The reference's prepared inputs as ``interop.patchmatch_inputs``
    reads them, less the images, the source depths and the rectified
    context."""
    return dict(ref_cam=jax_cam_dict(jin.ref_cam),
                src_cams=jax_cam_dict(jin.src_cams),
                src_valid=np.asarray(jin.src_valid),
                depth_range=np.asarray(jin.depth_range))


def assert_tree_equal(got, want, where=""):
    """Equal trees of arrays: the same keys, dtypes and shapes, and the same
    bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            assert_tree_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{where}/{i}")
    elif want is None:
        assert got is None, where
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (where, g.dtype,
                                                          w.dtype)
        assert g.tobytes() == w.tobytes(), where


def build_golden_context() -> dict:
    """The reference's contexts of the golden problem that the port's
    half-step tests run on: its tap context (``taps``: the exact and
    windowed paths'; it depends on the patch and the sigmas only), the
    rectified context of ``rect_params`` (``rect``) and the source
    disparities of the geometric pass's, on ``bench.golden_geom_fields``'s
    source depths (``rect_sdisp``; the rest of that context is ``rect``'s)."""
    from acmmp_spherical_torch.bench import golden_geom_fields
    from acmmp_spherical_tpu.ops import propagate as JP
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context

    cams, _, images, depths, normals = golden_scene()
    params = rect_params(cams)
    jin = JP.prepare_inputs(jax_inputs(cams, images), params)
    ctx = ref_tap_context(jin.ref_image, jin.ref_cam, params)
    src = golden_geom_fields(depths, normals)[0]
    geom = rect_dict(JP.prepare_inputs(jax_inputs(cams, images, src),
                                       params.with_geom(False)).rect)
    rect = rect_dict(jin.rect)
    assert_tree_equal(dict(geom, rect_sdisp=None), rect, "rect_geom")
    return dict(taps=np_tree(ctx), rect=rect, rect_sdisp=geom["rect_sdisp"])


def golden_context() -> dict:
    """``build_golden_context``'s stored tree, with the geometric pass's
    whole rectified context (``rect_geom``)."""
    gold = reference_arrays("ref_golden_context", build_golden_context)
    return dict(gold, rect_geom=dict(gold["rect"],
                                     rect_sdisp=gold["rect_sdisp"]))


def check_golden_context(**contexts):
    """In a reference's build: its own contexts (``taps=``, ``rect=``,
    ``rect_geom=``; JAX objects) are the stored golden ones that the port's
    side reads."""
    gold = golden_context()
    for name, ctx in contexts.items():
        assert_tree_equal(np_tree(ctx) if name == "taps" else rect_dict(ctx),
                          gold[name], name)


def stored_port_inputs(inputs: dict, images, rect=None, src_depths=None):
    """The port's PatchMatchInputs, on the CPU, of a stored reference's
    inputs and rectified context, with the scene's images."""
    from acmmp_spherical_torch import interop

    return interop.patchmatch_inputs(dict(
        inputs, ref_image=images[0], src_images=images[1:], rect=rect,
        src_depths=src_depths), device="cpu")


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
