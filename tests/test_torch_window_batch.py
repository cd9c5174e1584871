"""The windowed kernel's batched interface: C plane fields in one call.

Kernel scene: the 128x48x3src ring of tests/test_torch_window.py with four
fields whose window origins differ -- the ground truth, its perturbed copy
(numpy seed 0), and the ground truth's depth scaled by 0.5 and by 1.3.

* the batched ``windowed_multiview_ncc_plain`` against the reference's
  one-field ``windowed_multiview_ncc`` (Pallas in interpret mode), field by
  field, photometric and with_geom, at the tolerances of
  ``test_windowed_ncc_plain_matches_reference``;
* each field of a batch equals its own C=1 evaluation bit for bit (costs,
  geometric costs, window origins), on the tile grid and through the
  padding of ``_fast_cost_vectors`` on a 95x48 grid;
* a windowed half-step makes exactly two windowed evaluations, of 9 fields
  (the 8 propagation candidates and the current plane) and of 5 (the
  refinement candidates): photometric and geometric on the packed
  half-grid, and on an odd frame's full grid.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_torch.core.camera import stack_cameras as tstack  # noqa: E402
from acmmp_spherical_torch.ops import propagate as TP  # noqa: E402
from acmmp_spherical_torch.ops import rng as TR  # noqa: E402
from acmmp_spherical_torch.ops.kernels import ncc_window as NW  # noqa: E402

from test_torch_window import _agree, kernel_scene  # noqa: E402,F401
from torch_port_util import port_params  # noqa: E402

SCALES = {"gt": 1.0, "perturbed": 1.0, "near": 0.5, "far": 1.3}


def _fields(ks):
    """{name: (JAX normal, JAX w)} of the batch, in SCALES's order."""
    out = {}
    for name, scale in SCALES.items():
        n, w = ks["fields"]["perturbed" if name == "perturbed" else "gt"]
        out[name] = (n, w * scale)
    return out


def _port_batch(fields):
    n = torch.stack([torch.from_numpy(np.asarray(a)) for a, _ in
                     fields.values()])
    w = torch.stack([torch.from_numpy(np.asarray(b)) for _, b in
                     fields.values()])
    return n, w


def _port_args(ks, with_geom):
    dep = ks["depths"][1:] if with_geom else None
    return dict(src_images=torch.from_numpy(ks["images"][1:]),
                src_cams=tstack(ks["tcams"][1:]), ref_cam=ks["tcams"][0],
                ctx=ks["tctx"], params=port_params(ks["params"]),
                src_depths=None if dep is None else torch.from_numpy(
                    dep.copy()))


@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
def test_batched_plain_matches_reference(kernel_scene, with_geom):
    from acmmp_spherical_tpu.ops.pallas.ncc_window import (
        windowed_multiview_ncc,
    )

    ks = kernel_scene
    fields = _fields(ks)
    n, w = _port_batch(fields)
    off_y, off_x = NW.compute_center_windows(
        tstack(ks["tcams"][1:]), ks["tcams"][0], n, w, ks["tctx"].xs,
        ks["tctx"].ys, (48, 384))
    # the fields place their windows differently
    assert len({tuple(o.flatten().tolist()) for o in off_y}) >= 3
    out = NW.windowed_multiview_ncc_plain(normals=n, ws=w,
                                          **_port_args(ks, with_geom))
    cv, gv = out if with_geom else (out, None)
    assert cv.shape == (len(SCALES), 3, 48, 128)
    dep = ks["depths"][1:] if with_geom else None
    for i, (jn, jw) in enumerate(fields.values()):
        ref = windowed_multiview_ncc(
            jnp.asarray(ks["images"][1:]), ks["src_cams"], ks["cams"][0], jn,
            jw, ks["ctx"], ks["params"],
            None if dep is None else jnp.asarray(dep), interpret=True)
        jcv = ref[0] if with_geom else ref
        bad_agree, close = _agree(cv[i].numpy(), np.asarray(jcv), 2.0)
        assert bad_agree >= 0.995 and close >= 0.995, (i, bad_agree, close)
        assert (np.asarray(jcv) < 2.0).mean() > 0.3
        if with_geom:
            g, jg = gv[i].numpy(), np.asarray(ref[1])
            gok_agree, gclose = _agree(g, jg, 3.0)
            assert gok_agree >= 0.995, (i, gok_agree)
            # the scaled fields are consistent with no source depth
            if i == 0:
                assert (jg < 3.0).mean() > 0.5
            if (jg < 3.0).any():
                assert gclose >= 0.995, (i, gclose)


@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
def test_batch_fields_equal_single_calls(kernel_scene, with_geom):
    ks = kernel_scene
    n, w = _port_batch(_fields(ks))
    args = _port_args(ks, with_geom)
    batch = NW.windowed_multiview_ncc_plain(normals=n, ws=w, **args)
    oy, ox = NW.compute_center_windows(args["src_cams"], args["ref_cam"], n,
                                       w, ks["tctx"].xs, ks["tctx"].ys,
                                       (48, 384))
    for i in range(n.shape[0]):
        one = NW.windowed_multiview_ncc_plain(normals=n[i:i + 1],
                                              ws=w[i:i + 1], **args)
        for b, o in zip(batch, one) if with_geom else ((batch, one),):
            assert torch.equal(b[i], o[0]), i
        oy1, ox1 = NW.compute_center_windows(
            args["src_cams"], args["ref_cam"], n[i:i + 1], w[i:i + 1],
            ks["tctx"].xs, ks["tctx"].ys, (48, 384))
        assert torch.equal(oy[i], oy1[0]) and torch.equal(ox[i], ox1[0])


@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
def test_padded_batch_fields_equal_single_calls(kernel_scene, with_geom):
    """95 columns of the scene, padded to 128 and cropped back."""
    from acmmp_spherical_torch.ops.ncc import RefTapContext
    from acmmp_spherical_torch.ops.propagate import PatchMatchInputs

    ks = kernel_scene
    n, w = _port_batch(_fields(ks))
    n, w = n[:, :, :95].contiguous(), w[:, :, :95].contiguous()
    c = ks["tctx"]
    crop = lambda a: a[..., :95].contiguous()
    ctx = RefTapContext(c.offsets, crop(c.ref_taps), crop(c.weights),
                        crop(c.center), crop(c.xs), crop(c.ys))
    args = _port_args(ks, with_geom)
    inputs = PatchMatchInputs(
        ref_image=torch.from_numpy(ks["images"][0]),
        src_images=args["src_images"], ref_cam=args["ref_cam"],
        src_cams=args["src_cams"], src_valid=torch.ones(3, dtype=torch.bool),
        depth_range=args["ref_cam"].depth_range,
        src_depths=args["src_depths"])
    p = dataclasses.replace(args["params"], geom_consistency=with_geom)
    batch = TP._fast_cost_vectors(inputs, ctx, n, w, p, with_geom=with_geom)
    for i in range(n.shape[0]):
        one = TP._fast_cost_vectors(inputs, ctx, n[i:i + 1], w[i:i + 1], p,
                                    with_geom=with_geom)
        for b, o in zip(batch, one) if with_geom else ((batch, one),):
            assert b.shape == (n.shape[0], 3, 48, 95)
            assert torch.equal(b[i], o[0]), i


def _small_problem(width, height, geom):
    """A 3-view ring of the port's own renderer (no JAX), its windowed
    parameters and a random plane state."""
    from acmmp_spherical_torch.config import PatchMatchParams
    from acmmp_spherical_torch.core.camera import stack_cameras
    from acmmp_spherical_torch.core.plane import PlaneState
    from acmmp_spherical_torch.ops.ncc import ref_tap_context
    from acmmp_spherical_torch.ops.propagate import PatchMatchInputs
    from acmmp_spherical_torch.ops.sampling import grid_coords
    from acmmp_spherical_torch.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )

    cams = make_ring_of_cameras(3, width=width, height=height, focal=60.0,
                                device="cpu")
    images, depths, _ = render_scene(cams, CubeRoom(), width, height)
    imgs = torch.from_numpy(images)
    inputs = PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0],
        src_cams=stack_cameras(cams[1:]),
        src_valid=torch.ones(2, dtype=torch.bool),
        depth_range=cams[0].depth_range,
        src_depths=torch.from_numpy(depths[1:]) if geom else None)
    params = dataclasses.replace(PatchMatchParams(), rect_ncc=False,
                                 fast_ncc=True, geom_consistency=geom)
    xs, ys = grid_coords(height, width, "cpu")
    dr = cams[0].depth_range
    normal, w = TR.random_plane_hypothesis(TR.key(5), cams[0], xs, ys, dr[0],
                                           dr[1])
    ctx = ref_tap_context(inputs.ref_image, cams[0], params)
    cost = torch.full((height, width), 1.0)
    state = PlaneState(normal=normal, w=w, cost=cost,
                       selected=torch.zeros((2, height, width), dtype=bool),
                       pre_cost=cost)
    return inputs, params, state, ctx


@pytest.mark.parametrize("case", ["phot", "geom", "odd"])
def test_windowed_halfstep_makes_two_batched_calls(monkeypatch, case):
    width = 63 if case == "odd" else 64
    inputs, params, state, ctx = _small_problem(width, 32, case == "geom")
    calls = []
    real = TP.windowed_multiview_ncc

    def counted(src_images, src_cams, ref_cam, normals, ws, ctx, params,
                src_depths=None):
        calls.append((ws.shape[0], src_depths is not None))
        return real(src_images, src_cams, ref_cam, normals, ws, ctx, params,
                    src_depths)

    monkeypatch.setattr(TP, "windowed_multiview_ncc", counted)
    out = TP.checkerboard_halfstep(state, inputs, params, TR.key(7), 0, 0,
                                   ctx=ctx)
    geom = case == "geom"
    assert calls == [(9, geom), (5, geom)]
    assert bool(torch.isfinite(out.cost).all())
    assert bool((out.w != state.w).any())
