"""Port parity of ``rect_prescreen``: the candidates of a half-step ranked at
a coarse tap pattern (``radius_increment = prescreen_increment``, 9 taps
of the 11x11 patch), the winner evaluated at full taps.  The golden
96x64x3src problem (key 2333) at the JAX package's defaults, both bf16
packs on, with prescreen on; the Pallas kernels run in interpret mode.

Cases (1)-(3) share one context, the JAX package's, built once with the
geometric pass's source depths (``bench.golden_geom_fields``) and handed
to the port; the photometric half-steps start from the port's init state,
handed to the JAX package, and the geometric ones from the JAX package's
own seeded init state, handed to the port.

(1) one photometric half-step of each package from the same state, inputs
    and key (a C=8 coarse and a C=2 full evaluation in the propagation, C=5
    coarse and C=1 full in the refinement): the accept mask equal on
    >= 99.5% of the pixels, and the costs within 1e-4 on >= 99.5% -- one
    bf16 step more (``test_torch_tap_pack.py`` case 4's rule) where the
    packed back-map rounded a C=2 propagation cost;
(2) the same for one geometric half-step, where only the refinement is
    prescreened, and its ranking and winner's cost leave the geometric term
    out (the JAX package's ``_aggregate(cv, None, ...)``);
(3) ``rect_ncc_plain`` at the coarse pattern against the interpreted
    Pallas kernel on the same transported coefficients (C=2, parity 1):
    the kernel-1 tolerance of ``test_torch_tap_pack.py`` (1); packed
    photometric fast, with_geom and the f32 taps marked slow;
(4) the port's prescreen pass on the golden problem on the CPU: median
    relative depth error over [8:-8, 8:-8] < 0.01, the JAX package's gate
    (tests/test_rect_ncc.py:95) (the exact path, which prescreen does not
    touch: tests/test_torch_pass.py::test_unported_branches_raise);
(5) one SPHERE prescreen half-step (128x64x3src equirect ring) of each
    package, the port on the JAX package's own context, from the same
    state: the accept masks agree on >= 99%, and the costs by the
    end-to-end shares of test_torch_sphere_rect.py (mean difference < 1e-3,
    < 1% of them more than 1e-2 apart);
(6) the tap patterns with unrolled builds of kernel 1: the coarse pattern
    is one, its launches count under the ``_t9`` keys (any other pattern,
    and the runtime-bounds build, under the key without the suffix), and
    the kernel source instantiates exactly those patterns beside the
    runtime-bounds build.

Case (1) is marked slow: its reference half-step compiles four
interpreted kernel calls (about 90 s on a CPU).  The JAX package's side of
case (2) and of (3)'s fast case (the seeded init state (2) starts from
included) is stored in tests/fixtures/ref_prescreen.npz, on the geometric
rectified context of ref_golden_context.npz.  Regenerate it (CPU,
interpret mode, about 3 minutes):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_prescreen.py --regen
"""

import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.bench import golden_geom_fields  # noqa: E402
from acmmp_spherical_torch.ops import propagate as TP  # noqa: E402
from acmmp_spherical_torch.ops import rng as TR  # noqa: E402
from acmmp_spherical_torch.ops.kernels import ncc_rect as TNR  # noqa: E402
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch  # noqa: E402

from test_torch_tap_pack import (  # noqa: E402
    _assert_kernel_match, _bf16_step, _packed, _Planes,
)
from torch_port_util import (  # noqa: E402
    H, W, check_golden_context, golden_context, golden_scene, input_dict,
    jax_cam_dict, jax_inputs, np_tree, port_inputs, port_params, rect_dict,
    rect_params, reference_arrays, regen_references, stored_port_inputs,
)

KEY = 2333


@pytest.fixture(scope="module")
def scene():
    return golden_scene()


def _params(cams, geom=False):
    p = dataclasses.replace(rect_params(cams, packs=True), rect_prescreen=True)
    return p.with_geom(False) if geom else p


def _pinhole_rect(rect):
    return interop.rect_context(rect_dict(rect), device="cpu")


def _port_in(cams, images, jin, src_depths=None, port_rect=_pinhole_rect):
    """The port's inputs on the JAX package's prepared context."""
    model = cams[0].model
    tin = interop.patchmatch_inputs(dict(
        ref_image=images[0], src_images=images[1:],
        ref_cam=dict(jax_cam_dict(cams[0]), model=model),
        src_cams=dict(jax_cam_dict(jin.src_cams), model=model),
        src_valid=np.asarray(jin.src_valid),
        depth_range=np.asarray(jin.depth_range), src_depths=src_depths),
        device="cpu")
    return dataclasses.replace(tin, rect=port_rect(jin.rect))


def _port_init(tin, params, seeds=None):
    tk_init, _ = TR.split(TR.key(KEY))
    return TP.initialize_state(tin, port_params(params), tk_init, **(
        {} if seeds is None else {k: torch.from_numpy(v)
                                  for k, v in seeds.items()}))


def _jax_halfstep(jin, state, params):
    """The JAX package's parity-0 half-step (key 2333) from ``state``, a
    ``PlaneState``."""
    from acmmp_spherical_tpu.ops import propagate as JP
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context

    ctx = ref_tap_context(jin.ref_image, jin.ref_cam, params)
    _, k_iters = jax.random.split(jax.random.key(KEY))
    k0, _ = jax.random.split(jax.random.fold_in(k_iters, 0))
    return JP.checkerboard_halfstep(state, jin, ctx, params, k0, 0, 0)


def _jax_state(tstate):
    """The port's plane state as the JAX package's ``PlaneState``."""
    from acmmp_spherical_tpu.core.plane import PlaneState

    return PlaneState(**{f: jnp.asarray(getattr(tstate, f).numpy())
                         for f in PlaneState._fields})


def _port_halfstep(tstate, tin, params):
    _, tk_iters = TR.split(TR.key(KEY))
    tk0, _ = TR.split(TR.fold_in(tk_iters, 0))
    return TP.checkerboard_halfstep(tstate, tin, port_params(params), tk0,
                                    0, 0)


def _halfstep_pair(jin, tin, params, seeds=None):
    """One parity-0 half-step of each package (key 2333) from the port's
    init state, handed to the JAX package: returns (state, JAX output, the
    port's output); the port runs on the JAX package's context."""
    tstate = _port_init(tin, params, seeds)
    return (tstate, _jax_halfstep(jin, _jax_state(tstate), params),
            _port_halfstep(tstate, tin, params))


def _check_halfstep(tstate, out, tout, min_accept):
    j_acc = np.asarray(out.w) != tstate.w.numpy()
    t_acc = tout.w.numpy() != tstate.w.numpy()
    assert (j_acc == t_acc).mean() >= 0.995, (j_acc == t_acc).mean()
    assert j_acc.mean() > min_accept, j_acc.mean()
    jc, tc = np.asarray(out.cost), tout.cost.numpy()
    dc = np.abs(jc - tc)
    assert np.mean(dc <= 1e-4 + _bf16_step(jc)) >= 0.995, np.mean(
        dc <= 1e-4 + _bf16_step(jc))
    assert np.mean(dc <= 1e-4) >= 0.99, np.mean(dc <= 1e-4)


def _geom_fields(scene):
    _, _, _, depths, normals = scene
    src, seed_d, seed_n = golden_geom_fields(depths, normals)
    return src, dict(seed_normal_world=seed_n, seed_depth=seed_d)


@pytest.fixture(scope="module")
def prepared(scene):
    """The JAX package's prepared inputs of the golden problem with the
    geometric pass's source depths (its context carries the source
    disparities, which the photometric half-step ignores) and the port's on
    that context (the slow cases)."""
    from acmmp_spherical_tpu.ops import propagate as JP

    cams, _, images, _, _ = scene
    src = _geom_fields(scene)[0]
    jin = JP.prepare_inputs(jax_inputs(cams, images, src),
                            _params(cams, geom=True))
    return dict(jin=jin, tin=_port_in(cams, images, jin, src))


def _coarse_planes(scene):
    """C=2 planes: the ground truth and 1% off it."""
    from acmmp_spherical_tpu.core import geometry as JG
    from acmmp_spherical_tpu.ops.sampling import grid_coords

    cams, _, _, depths, normals = scene
    xs, ys = grid_coords(H, W)
    n_cam = JG.normal_world_to_cam(cams[0], jnp.asarray(normals[0]))
    w = JG.dist_to_origin(cams[0], xs, ys, jnp.asarray(depths[0]), n_cam)
    return jnp.stack([n_cam, n_cam]), jnp.stack([w, w * 1.01])


def _coarse_params(cams, packs):
    return dataclasses.replace(_params(cams), radius_increment=5,
                               rect_tap_pack=packs, rect_backmap_pack=packs)


def _coarse_reference(scene, ctx, monkeypatch, with_geom, packs,
                      parity=1):
    """The 9-tap pattern through the reference's whole batched evaluation
    on its context ``ctx``, its pallas_calls recorded: the transported D
    and AB, and the rect kernel's raw planes (a tuple)."""
    from acmmp_spherical_tpu.ops.pallas import ncc_rect as JNR

    rec = _Planes(monkeypatch)
    n, w = _packed(_coarse_planes(scene), parity)
    JNR.rect_batched_ncc.__wrapped__(ctx, n, w,
                                     _coarse_params(scene[0], packs),
                                     interpret=True, parity=parity,
                                     with_geom=with_geom)
    (D, AB), raw = rec.seen
    return D, AB, tuple(np.asarray(a) for a in (raw if with_geom
                                                 else (raw,)))


def build_reference():
    """The JAX package's side of (2) and of (3)'s fast case, on
    ``prepared``'s context (the stored golden geometric one): the inputs it
    hands the port, its own seeded init state (key 2333), its geometric
    half-step's ``w`` and costs from that state, and the coarse pattern's
    transported D and AB and raw planes (packed, photometric)."""
    from acmmp_spherical_tpu.ops import propagate as JP
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context

    scene = golden_scene()
    cams, _, images, _, _ = scene
    src, seeds = _geom_fields(scene)
    params = _params(cams, geom=True)
    jin = JP.prepare_inputs(jax_inputs(cams, images, src), params)
    check_golden_context(rect_geom=jin.rect)
    k_init, _ = jax.random.split(jax.random.key(KEY))
    state = JP.initialize_state(
        jin, params, k_init,
        ctx=ref_tap_context(jin.ref_image, jin.ref_cam, params),
        **{k: jnp.asarray(v) for k, v in seeds.items()})
    out = _jax_halfstep(jin, state, params)
    with pytest.MonkeyPatch.context() as mp:
        D, AB, (raw,) = _coarse_reference(scene, jin.rect, mp, False, True)
    return dict(inputs=input_dict(jin), state=np_tree(state),
                halfstep_w=np.asarray(out.w),
                halfstep_cost=np.asarray(out.cost),
                coarse=dict(D=np.asarray(D), AB=np.asarray(AB), raw=raw))


REFERENCES = {"ref_prescreen": build_reference}


@pytest.fixture(scope="module")
def stored(scene):
    """The JAX package's stored side of (2) and (3), and the port's inputs
    on the same context."""
    ref = reference_arrays("ref_prescreen", build_reference)
    tin = stored_port_inputs(ref["inputs"], scene[2],
                             golden_context()["rect_geom"],
                             _geom_fields(scene)[0])
    return ref, tin


@pytest.mark.slow
def test_photometric_halfstep_from_identical_state(scene, prepared):
    """(1)"""
    _check_halfstep(*_halfstep_pair(prepared["jin"], prepared["tin"],
                                    _params(scene[0])), 0.1)


def test_geometric_halfstep_from_identical_state(scene, stored):
    """(2)"""
    ref, tin = stored
    tstate = interop.plane_state(ref["state"], device="cpu")
    out = types.SimpleNamespace(w=ref["halfstep_w"],
                                cost=ref["halfstep_cost"])
    _check_halfstep(tstate, out, _port_halfstep(
        tstate, tin, _params(scene[0], geom=True)), 0.05)


@pytest.mark.parametrize("with_geom,packs", [
    (False, True), pytest.param(True, True, marks=pytest.mark.slow),
    pytest.param(False, False, marks=pytest.mark.slow)],
    ids=["packed", "packed-geom", "f32"])
def test_plain_kernel_at_coarse_pattern_matches_pallas(
        scene, stored, request, monkeypatch, with_geom, packs):
    """(3) the 9-tap pattern through the reference's whole batched
    evaluation (its pallas_calls recorded; the fast case's stored), the
    port's plain kernel on the transported D and AB."""
    parity = 1
    if (with_geom, packs) == (False, True):
        c = stored[0]["coarse"]
        D, AB, ref = c["D"], c["AB"], (c["raw"],)
    else:
        D, AB, ref = _coarse_reference(
            scene, request.getfixturevalue("prepared")["jin"].rect,
            monkeypatch, with_geom, packs, parity)
    t = stored[1].rect
    tp = port_params(_coarse_params(scene[0], packs))
    assert len(TNR._weight_consts(tp)[4]) == 3      # offsets -5, 0, 5
    got = TNR.rect_ncc_plain(
        t.srow, t.tile_oy, t.tile_ox, t.rect_ref, t.rect_src,
        torch.from_numpy(np.array(D)),
        torch.from_numpy(np.array(AB).view(np.int32)),
        t.maps[1 + parity].fwd_valid, tp,
        sdisp=t.rect_sdisp if with_geom else None)
    got = tuple(a.numpy() for a in (got if with_geom else (got,)))
    _assert_kernel_match(got[0], ref[0], tp, *(
        (got[1], ref[1]) if with_geom else ()))
    # the coarse pattern is a different cost from the default one
    full = TNR.rect_ncc_plain(
        t.srow, t.tile_oy, t.tile_ox, t.rect_ref, t.rect_src,
        torch.from_numpy(np.array(D)),
        torch.from_numpy(np.array(AB).view(np.int32)),
        t.maps[1 + parity].fwd_valid, dataclasses.replace(tp,
                                                          radius_increment=2))
    assert not np.array_equal((full[0] if with_geom else full).numpy(),
                              got[0])


def test_prescreen_pass_quality(scene):
    """(4)"""
    cams, tcams, images, depths, _ = scene
    d = run_patchmatch(port_inputs(tcams, images), port_params(_params(cams)),
                       KEY)[0].numpy()
    rel = np.abs(d - depths[0]) / depths[0]
    assert np.median(rel[8:-8, 8:-8]) < 0.01, np.median(rel[8:-8, 8:-8])


def test_unrolled_tap_builds_and_launch_keys():
    """(6)"""
    import re

    from acmmp_spherical_torch.config import PatchMatchParams
    from acmmp_spherical_torch.ops.kernels import _lib

    p = PatchMatchParams()
    assert p.rect_tap_pack
    coarse = TP.coarse_params(p)
    assert (coarse.patch_size // 2, coarse.radius_increment) == (5, 5)
    f32 = dataclasses.replace(coarse, rect_tap_pack=False)
    assert TNR.launch_key(p, False) == "rect_ncc_pk"
    assert TNR.launch_key(coarse, False) == "rect_ncc_pk_t9"
    assert TNR.launch_key(coarse, True) == "rect_ncc_geom_pk_t9"
    assert TNR.launch_key(f32, False) == "rect_ncc_t9"
    assert TNR.launch_key(coarse, True, runtime_taps=True) == \
        "rect_ncc_geom_pk"
    for other in (dataclasses.replace(p, radius_increment=3),
                  dataclasses.replace(coarse, patch_size=9)):
        assert TNR.launch_key(other, False) == "rect_ncc_pk"
    for q in (p, coarse, f32):
        for geom in (False, True):
            assert TNR.launch_key(q, geom) in _lib.LAUNCHES
    assert TNR.TAP_BUILDS == {"0": "_runtime", "6": "_default", "3": "_t9"}
    # the kernel source unrolls exactly these patterns beside the
    # runtime-bounds build
    src = (_lib.CSRC / "rect_ncc.cu").read_text()
    built = set(re.findall(
        r"rect_ncc_kernel<kGeom, kTapPack, (\d+), (\d+), (\d+)>", src))
    assert built == {("0", "0", "0")} | {
        (str(len(range(-r, r + 1, i))), str(r), str(i))
        for r, i in TNR.UNROLLED_TAPS}


@pytest.mark.slow
def test_sphere_halfstep_from_identical_state():
    """(5)"""
    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_tpu.core.camera import SPHERE
    from acmmp_spherical_tpu.ops import sphere_rect as JSR
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )

    Ws, Hs, n = 128, 64, 4
    cams = make_ring_of_cameras(n, model=SPHERE, width=Ws, height=Hs)
    images, _, _ = render_scene(cams, CubeRoom(), Ws, Hs)
    from acmmp_spherical_tpu.core.camera import stack_cameras as jstack

    iwin = JSR.sphere_init_window(cams[0], jstack(cams[1:]))
    params = dataclasses.replace(
        PatchMatchParams(), rect_ncc=True, rect_init=iwin > 0,
        rect_init_win=iwin or 384,
        sphere_live_n=JSR.sphere_live_tile_count(cams[0]),
        rect_prescreen=True)
    assert params.rect_tap_pack and params.rect_backmap_pack
    from acmmp_spherical_tpu.ops import propagate as JP

    jin = JP.prepare_inputs(jax_inputs(cams, images), params)
    tin = _port_in(cams, images, jin, port_rect=lambda r: (
        interop.sphere_rect_context(rect_dict(r), device="cpu")))
    tstate, out, tout = _halfstep_pair(jin, tin, params)
    j_acc = np.asarray(out.w) != tstate.w.numpy()
    t_acc = tout.w.numpy() != tstate.w.numpy()
    assert (j_acc == t_acc).mean() >= 0.99, (j_acc == t_acc).mean()
    assert j_acc.mean() > 0.1
    dc = np.abs(np.asarray(out.cost) - tout.cost.numpy())
    assert dc.mean() < 1e-3 and (dc > 1e-2).mean() < 0.01, (
        dc.mean(), (dc > 1e-2).mean())


def sphere_pipeline_witness(work, width=128, height=64, n_views=4,
                            size_bound=64):
    """Both packages' ``run_pipeline`` on one equirect CubeRoom ring
    (``n_views`` views each taking the others, two pyramid scales at
    ``size_bound``), rectified path on, one problem at a time (the serial
    order of the multi-geometry passes), ``rect_prescreen`` off and on: per
    package and setting, each view's median relative depth error of its
    final-scale hierarchy pass (``depths.dmb``) and of its final depth
    (``depths_geom.dmb``), and the fused points.  The JAX package runs its
    Pallas kernels in interpret mode (minutes per run)."""
    import pathlib
    import shutil

    from acmmp_spherical_tpu.config import PatchMatchParams as JPM
    from acmmp_spherical_tpu.config import PipelineConfig as JPC
    from acmmp_spherical_tpu.core.camera import SPHERE
    from acmmp_spherical_tpu.io.dmb import read_depth_dmb
    from acmmp_spherical_tpu.io.scene import ScenePaths
    from acmmp_spherical_tpu.pipeline.multiscale import (
        run_pipeline as jax_pipeline,
    )
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
        write_synthetic_scene_to_disk,
    )

    from acmmp_spherical_torch.config import PatchMatchParams as TPM
    from acmmp_spherical_torch.config import PipelineConfig as TPC
    from acmmp_spherical_torch.pipeline.multiscale import (
        run_pipeline as port_pipeline,
    )

    work = pathlib.Path(work)
    cams = make_ring_of_cameras(n_views, model=SPHERE, width=width,
                                height=height)
    images, depths, _ = render_scene(cams, CubeRoom(), width, height)
    write_synthetic_scene_to_disk(work / "scene", cams, images)

    def errors(sp, geom):
        return [float(np.median(np.abs(read_depth_dmb(sp.depth_file(
            v, geom=geom)) - depths[v]) / depths[v])) for v in range(n_views)]

    out = {}
    for name, run, pm, pc in (
            ("port", lambda root, cfg: port_pipeline(root, cfg, device="cpu"),
             TPM, TPC),
            ("jax", jax_pipeline, JPM, JPC)):
        for prescreen in (False, True):
            root = work / f"{name}_{int(prescreen)}"
            shutil.copytree(work / "scene", root)
            cfg = pc(rect_ncc="on", size_bound=size_bound,
                     batch_problems="off", patchmatch=dataclasses.replace(
                         pm(), rect_prescreen=prescreen))
            points = run(root, cfg)
            sp = ScenePaths(root)
            out[f"{name} prescreen={prescreen}"] = dict(
                hierarchy=errors(sp, False), final=errors(sp, True),
                fused_points=int(points))
            print(json.dumps({f"{name} prescreen={prescreen}":
                              out[f"{name} prescreen={prescreen}"]}),
                  flush=True)
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_prescreen.py
    # [WORK_DIR]: the SPHERE pipeline witness (tens of minutes on a CPU);
    # with --regen: the stored reference of (2) and (3)
    import sys
    import tempfile

    import conftest  # noqa: F401  (JAX on the CPU)

    if "--regen" in sys.argv:
        regen_references(REFERENCES)
        sys.exit()
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(sphere_pipeline_witness(
            sys.argv[1] if len(sys.argv) > 1 else tmp)), flush=True)
