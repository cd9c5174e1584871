"""The pass runner's load (``load_problem``, ``load_seeds``): images decoded
and ``.dmb`` files read on a thread pool straight into the stacks it
uploads, page-locked and uploaded without a wait on a CUDA device.

* (a) ``load_problem`` and ``load_seeds`` give tensors, cameras and
  parameters bit-identical to a frozen copy of the serial construction
  they replace (one view after another, then ``_pad_stack``): a
  photometric problem at a rescaled scale, geometric problems with
  ``multi_geometry`` off and on (a source depth of another size and an
  absent one among them), and hierarchy seeds at full size, from the
  freshest depth, and through the JBU of coarse fields.  The same cases
  against the reference package's ``load_problem``, ``_load_seed`` and
  ``_load_hierarchy_seed``: the images, stacks, source mask, depth range
  and cameras bit for bit, an upsampled seed field to the JBU tolerance.
* (b) A file rewritten between two loads is read afresh by the second,
  and the first load's tensors keep what they read; loads from more
  threads than cores at once each give the serial construction's tensors.
* (d, ``gpu``) On CUDA the host buffers are page-locked, ``LOAD_BYTES``
  counts every upload under its route, and the device tensors equal the
  CPU load's.
* The benchmark's ``load_read_s`` reads the ``read`` spans.

The spans ``read`` and ``upload`` inside ``load`` are in
``test_torch_spans.py`` (c).  Only the reference comparisons import JAX,
inside the tests, so on the GPU host:
``python -m pytest --noconftest -m gpu tests/test_torch_load.py``.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.config import PipelineConfig  # noqa: E402
from acmmp_spherical_torch.core.camera import (  # noqa: E402
    scale_camera, stack_cameras,
)
from acmmp_spherical_torch.io import dmb  # noqa: E402
from acmmp_spherical_torch.io.scene import (  # noqa: E402
    ScenePaths, load_image_gray, read_camera_file, read_pair_file,
    resize_linear, write_image,
)
from acmmp_spherical_torch.ops.jbu import (  # noqa: E402
    joint_bilateral_upsample,
)
from acmmp_spherical_torch.pipeline import pass_runner as PR  # noqa: E402
from acmmp_spherical_torch.utils.synthetic import (  # noqa: E402
    CubeRoom, make_ring_of_cameras, render_scene,
    write_synthetic_scene_to_disk,
)

W, H, N_VIEWS, FOCAL = 48, 32, 4, 42.0
FULL, COARSE = 48, 24          # max image sizes: as written, and halved


# -- the frozen serial construction (the pass runner before the pool) -----

def _frozen_rescale(cam, h, w, max_size):
    cam = scale_camera(cam, 1.0, 1.0, w, h)
    if w > max_size or h > max_size:
        factor = min(max_size / w, max_size / h)
        nw, nh = round(w * factor), round(h * factor)
        return scale_camera(cam, nw / w, nh / h, nw, nh), nh, nw
    return cam, h, w


def _frozen_view(sp, image_id, max_size):
    img = load_image_gray(sp.image_file(image_id))
    cam = read_camera_file(sp.camera_file(image_id), device="cpu")
    cam, nh, nw = _frozen_rescale(cam, *img.shape, max_size)
    if (nh, nw) != img.shape:
        img = resize_linear(img, nw, nh)
    return img.astype(np.float32), cam


def _frozen_pad_stack(arrays):
    hp = max(a.shape[0] for a in arrays)
    wp = max(a.shape[1] for a in arrays)
    out = np.zeros((len(arrays), hp, wp), np.float32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0], : a.shape[1]] = a
    return out


def frozen_load(sp, problems, idx, cfg, *, geom=False,
                multi_geometry=False):
    device = torch.device("cpu")
    problem = problems[idx]
    by_id = {p.ref_image_id: p for p in problems}
    ref_img, ref_cam = _frozen_view(sp, problem.ref_image_id,
                                    problem.cur_image_size)
    src_imgs, src_cams = [], []
    for sid in PR._src_ids(problem, cfg):
        im, cm = _frozen_view(sp, sid, PR._cur_size(by_id, sid, problem))
        src_imgs.append(im)
        src_cams.append(cm)
    n_src = len(src_imgs)
    scene_max = max((min(len(p.src_image_ids), cfg.max_src_views)
                     for p in problems), default=1)
    n_pad = max(1, -(-scene_max // 2) * 2)
    src_valid = np.zeros(n_pad, bool)
    src_valid[:n_src] = True
    params = PR._path_params(cfg.patchmatch, cfg, problem, ref_cam,
                             src_cams, ref_img.shape, device)
    while len(src_imgs) < n_pad:
        src_imgs.append(np.zeros((1, 1), np.float32))
        src_cams.append(src_cams[0] if n_src else ref_cam)
    if geom:
        params = params.with_geom(multi_geometry)
    src_depths = None
    if geom:
        deps = []
        for sid in PR._src_ids(problem, cfg):
            path = sp.depth_file(sid, geom=multi_geometry)
            deps.append(dmb.read_depth_dmb(path) if path.exists()
                        else np.zeros((1, 1), np.float32))
        while len(deps) < n_pad:
            deps.append(np.zeros((1, 1), np.float32))
        src_depths = torch.from_numpy(_frozen_pad_stack(deps))
    dmin, dmax = ref_cam.depth_range.numpy()
    t = lambda a: torch.as_tensor(a, device=device)
    inputs = PR.PatchMatchInputs(
        ref_image=t(ref_img), src_images=t(_frozen_pad_stack(src_imgs)),
        ref_cam=ref_cam, src_cams=stack_cameras(src_cams),
        src_valid=t(src_valid),
        depth_range=t(np.array([cfg.depth_min_scale * dmin,
                                cfg.depth_max_scale * dmax], np.float32)),
        src_depths=src_depths)
    return PR.LoadedProblem(inputs=inputs, ref_image_np=ref_img,
                            ref_cam=ref_cam, height=ref_img.shape[0],
                            width=ref_img.shape[1]), params


def frozen_seed(sp, image_id, multi_geometry):
    depth = dmb.read_depth_dmb(sp.depth_file(image_id, geom=multi_geometry))
    normal = dmb.read_normal_dmb(sp.normal_file(image_id))
    return torch.from_numpy(normal), torch.from_numpy(depth)


def frozen_hierarchy_seed(sp, lp, image_id):
    depth = dmb.read_depth_dmb(sp.depth_file(image_id, geom=False))
    normal = dmb.read_normal_dmb(sp.normal_file(image_id))
    H_, W_ = lp.height, lp.width
    if depth.shape != (H_, W_):
        gpath = sp.depth_file(image_id, geom=True)
        if gpath.exists():
            d2 = dmb.read_depth_dmb(gpath)
            if d2.shape == (H_, W_):
                depth = d2
    guide = torch.from_numpy(lp.ref_image_np)
    normal = torch.from_numpy(normal)
    depth = torch.from_numpy(depth)
    if normal.shape[:2] != (H_, W_):
        normal = joint_bilateral_upsample(normal, guide)
        normal = normal / torch.clamp(
            torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-12)
    if depth.shape != (H_, W_):
        depth = joint_bilateral_upsample(depth, guide)
    return normal, depth


# -- the scene -------------------------------------------------------------

def _write_fields(sp, problems, rng, *, coarse_seed=False):
    """Depth, geometric depth and normal files of every view: source depths
    of the frame's size but one of another size and one absent (view 3's
    ``depths.dmb``; view 2's ``depths_geom.dmb`` is 20x30); with
    ``coarse_seed`` view 0's depth and normals are at half size and its
    ``depths_geom.dmb`` at full size."""
    for p in problems:
        i = p.ref_image_id
        sp.result_dir(i).mkdir(parents=True, exist_ok=True)
        for geom in (False, True):
            path = sp.depth_file(i, geom=geom)
            path.unlink(missing_ok=True)
            if (i, geom) == (3, False):
                continue
            hw = (20, 30) if (i, geom) == (2, True) else (H, W)
            if i == 0 and coarse_seed and not geom:
                hw = (H // 2, W // 2)
            dmb.write_dmb(path, rng.uniform(1, 9, hw).astype(np.float32))
        hw = (H // 2, W // 2) if i == 0 and coarse_seed else (H, W)
        n = rng.normal(size=(*hw, 3)).astype(np.float32)
        dmb.write_dmb(sp.normal_file(i),
                      n / np.linalg.norm(n, axis=-1, keepdims=True))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("load")
    cams = make_ring_of_cameras(N_VIEWS, width=W, height=H, focal=FOCAL,
                                device="cpu")
    write_synthetic_scene_to_disk(root, cams,
                                  render_scene(cams, CubeRoom(), W, H)[0])
    sp = ScenePaths(root)
    problems = read_pair_file(sp.pair_file)
    return sp, problems


@pytest.fixture(autouse=True)
def dirty_buffers(monkeypatch):
    """Host buffers handed out holding NaN, as a reused block holds an
    earlier load's data: a load has to write every element it uploads."""
    make = PR._host_buffer
    monkeypatch.setattr(PR, "_host_buffer", lambda shape, device: make(
        shape, device).fill_(float("nan")))


def _at(problems, size):
    out = [dataclasses.replace(p) for p in problems]
    for p in out:
        p.max_image_size = p.cur_image_size = size
    return out


def _equal_tree(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a.cpu(), b.cpu()), what
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal_tree(getattr(a, f.name), getattr(b, f.name),
                        f"{what}.{f.name}")
    else:
        assert a == b, what


def _check(lp, params, want, want_params):
    _equal_tree(lp.inputs, want.inputs, "inputs")
    _equal_tree(lp.ref_cam, want.ref_cam, "ref_cam")
    assert params == want_params
    assert (lp.height, lp.width) == (want.height, want.width)
    assert lp.ref_image_np.dtype == np.float32
    assert np.array_equal(lp.ref_image_np, want.ref_image_np)


# -- (a) bit-identical to the serial construction --------------------------

@pytest.mark.parametrize("case", ["photometric_rescaled", "geom",
                                  "geom_multi"])
def test_load_problem_matches_serial(scene, case):
    sp, problems = scene
    _write_fields(sp, problems, np.random.default_rng(1))
    probs = _at(problems, COARSE if case == "photometric_rescaled" else FULL)
    kw = dict(geom=case != "photometric_rescaled",
              multi_geometry=case == "geom_multi")
    cfg = PipelineConfig()
    for idx in range(len(probs)):
        lp, params = PR.load_problem(sp, probs, idx, cfg, device="cpu", **kw)
        want, want_params = frozen_load(sp, probs, idx, cfg, **kw)
        _check(lp, params, want, want_params)
        if kw["geom"]:
            pid, multi = probs[idx].ref_image_id, kw["multi_geometry"]
            load = lambda: PR.load_seeds(sp, lp, pid, geom=True,
                                         hierarchy=False,
                                         multi_geometry=multi, device="cpu")
            if not sp.depth_file(pid, geom=multi).exists():
                # view 3's absent seed depth: both raise
                with pytest.raises(OSError):
                    frozen_seed(sp, pid, multi)
                with pytest.raises(OSError):
                    load()
                continue
            seeds = load()
            normal, depth = frozen_seed(sp, pid, multi)
            _equal_tree(seeds["seed_normal_world"], normal, "normal")
            _equal_tree(seeds["seed_depth"], depth, "depth")
    if case == "photometric_rescaled":
        assert lp.inputs.src_images.shape[1:] == (H // 2, W // 2)


@pytest.mark.parametrize("case", ["full", "freshest_depth", "jbu"])
def test_hierarchy_seed_matches_serial(scene, case):
    sp, problems = scene
    _write_fields(sp, problems, np.random.default_rng(2),
                  coarse_seed=case != "full")
    if case == "jbu":
        sp.depth_file(0, geom=True).unlink()
    probs = _at(problems, FULL)
    cfg = PipelineConfig()
    lp, _ = PR.load_problem(sp, probs, 0, cfg, device="cpu")
    seeds = PR.load_seeds(sp, lp, 0, geom=False, hierarchy=True,
                          multi_geometry=False, device="cpu")
    normal, depth = frozen_hierarchy_seed(sp, lp, 0)
    _equal_tree(seeds["seed_normal_world"], normal, "normal")
    _equal_tree(seeds["seed_depth"], depth, "depth")
    assert depth.shape == (H, W)


# -- (a) against the reference package -------------------------------------

def jax_load(sp, size, idx, *, geom=False, multi_geometry=False,
             seed=None):
    """The reference package's load of problem ``idx`` at ``size`` as host
    arrays, and its seed fields (``seed`` "geom" or "hierarchy")."""
    from acmmp_spherical_tpu.config import PipelineConfig as JaxConfig
    from acmmp_spherical_tpu.io import scene as jscene
    from acmmp_spherical_tpu.pipeline import pass_runner as JPR

    jsp = jscene.ScenePaths(sp.root)
    probs = [dataclasses.replace(p, max_image_size=size, cur_image_size=size)
             for p in jscene.read_pair_file(jsp.pair_file)]
    lp, _ = JPR.load_problem(jsp, probs, idx, JaxConfig(), geom=geom,
                             multi_geometry=multi_geometry)
    pid = probs[idx].ref_image_id
    fields = (None if seed is None else
              JPR._load_seed(jsp, pid, multi_geometry=multi_geometry)
              if seed == "geom" else JPR._load_hierarchy_seed(jsp, lp, pid))
    return lp, fields


def _equal_cam(got, want, what):
    for k in ("R", "t", "K", "params", "wh", "depth_range"):
        np.testing.assert_array_equal(getattr(got, k).cpu().numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=f"{what}.{k}")
    assert got.model == want.model, what


def _equal_reference(lp, want):
    """Every host-comparable input of a load, bit for bit."""
    for k in ("ref_image", "src_images", "src_valid", "depth_range",
              "src_depths"):
        a, b = getattr(lp.inputs, k), getattr(want.inputs, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.shape == b.shape, k
            np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b),
                                          err_msg=k)
    _equal_cam(lp.inputs.ref_cam, want.inputs.ref_cam, "ref_cam")
    _equal_cam(lp.inputs.src_cams, want.inputs.src_cams, "src_cams")
    _equal_cam(lp.ref_cam, want.ref_cam, "host ref_cam")
    np.testing.assert_array_equal(lp.ref_image_np, want.ref_image_np)
    assert (lp.height, lp.width) == (want.height, want.width)


@pytest.mark.parametrize("case", ["photometric_rescaled", "geom",
                                  "geom_multi"])
def test_load_problem_matches_reference(scene, case):
    """The inputs and geometric seeds equal the reference package's bit for
    bit (``load_problem``, ``_load_seed``)."""
    sp, problems = scene
    _write_fields(sp, problems, np.random.default_rng(6))
    size = COARSE if case == "photometric_rescaled" else FULL
    geom, multi = case != "photometric_rescaled", case == "geom_multi"
    probs = _at(problems, size)
    for idx in range(len(probs)):
        pid = probs[idx].ref_image_id
        has_seed = geom and sp.depth_file(pid, geom=multi).exists()
        lp, _ = PR.load_problem(sp, probs, idx, PipelineConfig(),
                                device="cpu", geom=geom,
                                multi_geometry=multi)
        want, fields = jax_load(sp, size, idx, geom=geom,
                                multi_geometry=multi,
                                seed="geom" if has_seed else None)
        _equal_reference(lp, want)
        if has_seed:
            seeds = PR.load_seeds(sp, lp, pid, geom=True, hierarchy=False,
                                  multi_geometry=multi, device="cpu")
            for k, w in zip(("seed_normal_world", "seed_depth"), fields):
                np.testing.assert_array_equal(seeds[k].numpy(),
                                              np.asarray(w), err_msg=k)


@pytest.mark.parametrize("case", ["full", "freshest_depth", "jbu"])
def test_hierarchy_seed_matches_reference(scene, case):
    """The hierarchy seed equals the reference package's: bit for bit where
    a field is read at full size, to the JBU parity tolerance
    (``test_torch_fusion_prior.py``) where it is upsampled."""
    sp, problems = scene
    _write_fields(sp, problems, np.random.default_rng(7),
                  coarse_seed=case != "full")
    if case == "jbu":
        sp.depth_file(0, geom=True).unlink()
    probs = _at(problems, FULL)
    lp, _ = PR.load_problem(sp, probs, 0, PipelineConfig(), device="cpu")
    seeds = PR.load_seeds(sp, lp, 0, geom=False, hierarchy=True,
                          multi_geometry=False, device="cpu")
    want, (normal, depth) = jax_load(sp, FULL, 0, seed="hierarchy")
    _equal_reference(lp, want)
    for k, w, upsampled in (("seed_normal_world", normal, case != "full"),
                            ("seed_depth", depth, case == "jbu")):
        got, w = seeds[k].numpy(), np.asarray(w)
        assert got.shape == w.shape, k
        if upsampled:
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, w, err_msg=k)


# -- (b) no staleness, no cross-talk ----------------------------------------

def test_rewritten_files_are_read_afresh(scene):
    sp, problems = scene
    rng = np.random.default_rng(3)
    _write_fields(sp, problems, rng)
    probs = _at(problems, FULL)
    cfg = PipelineConfig()
    kw = dict(geom=True, multi_geometry=False)
    first, _ = PR.load_problem(sp, probs, 0, cfg, device="cpu", **kw)
    seed1 = PR.load_seeds(sp, first, 0, geom=True, hierarchy=False,
                          multi_geometry=False, device="cpu")
    kept = [t.clone() for t in (first.inputs.ref_image,
                                first.inputs.src_images,
                                first.inputs.src_depths,
                                seed1["seed_depth"])]
    # a new reference image, new source depths and a new seed depth
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    write_image(sp.image_file(0), img, jpeg_quality=98)
    _write_fields(sp, problems, rng)
    second, _ = PR.load_problem(sp, probs, 0, cfg, device="cpu", **kw)
    seed2 = PR.load_seeds(sp, second, 0, geom=True, hierarchy=False,
                          multi_geometry=False, device="cpu")
    want, _ = frozen_load(sp, probs, 0, cfg, **kw)
    _equal_tree(second.inputs, want.inputs, "second")
    _equal_tree(seed2["seed_depth"], frozen_seed(sp, 0, False)[1], "seed")
    assert not torch.equal(second.inputs.ref_image, kept[0])
    assert not torch.equal(second.inputs.src_depths, kept[2])
    assert not torch.equal(seed2["seed_depth"], kept[3])
    for a, b in zip(kept, (first.inputs.ref_image, first.inputs.src_images,
                           first.inputs.src_depths, seed1["seed_depth"])):
        assert torch.equal(a, b)


def test_concurrent_loads_keep_their_own_buffers(scene):
    sp, problems = scene
    _write_fields(sp, problems, np.random.default_rng(4))
    probs = _at(problems, FULL)
    cfg = PipelineConfig()
    kw = dict(geom=True, multi_geometry=True)
    want = [frozen_load(sp, probs, i, cfg, **kw)[0] for i in range(N_VIEWS)]
    n_threads = 16
    got: list = [None] * n_threads
    errors: list = []

    def load(k):
        try:
            got[k] = PR.load_problem(sp, probs, k % N_VIEWS, cfg,
                                     device="cpu", **kw)[0]
        except Exception as e:   # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=load, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for k, lp in enumerate(got):
        _equal_tree(lp.inputs, want[k % N_VIEWS].inputs, f"thread {k}")


# -- (d) the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (page-locked buffers and "
                    "uploads)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_loads_pinned_and_equal(scene, cuda):
    sp, problems = scene
    _write_fields(sp, problems, np.random.default_rng(5))
    probs = _at(problems, FULL)
    cfg = PipelineConfig()
    kw = dict(geom=True, multi_geometry=False)
    before = dict(PR.LOAD_BYTES)
    lp, _ = PR.load_problem(sp, probs, 1, cfg, device=cuda, **kw)
    seeds = PR.load_seeds(sp, lp, 1, geom=True, hierarchy=False,
                          multi_geometry=False, device=cuda)
    torch.cuda.synchronize(cuda)
    assert torch.from_numpy(lp.ref_image_np).is_pinned()
    big = [lp.inputs.ref_image, lp.inputs.src_images, lp.inputs.src_depths,
           seeds["seed_normal_world"], seeds["seed_depth"]]
    small = [lp.inputs.src_valid, lp.inputs.depth_range]
    assert all(t.is_cuda for t in big + small)
    assert PR.LOAD_BYTES["pinned"] - before["pinned"] == sum(
        t.nbytes for t in big)
    assert PR.LOAD_BYTES["pageable"] - before["pageable"] == sum(
        t.nbytes for t in small)
    cpu, _ = PR.load_problem(sp, probs, 1, cfg, device="cpu", **kw)
    cpu_seeds = PR.load_seeds(sp, cpu, 1, geom=True, hierarchy=False,
                              multi_geometry=False, device="cpu")
    _equal_tree(lp.inputs, cpu.inputs, "inputs")
    for k in seeds:
        _equal_tree(seeds[k], cpu_seeds[k], k)


# -- the benchmark's reader of the read spans -------------------------------

def test_load_read_s_reader():
    """``load_read_s`` is the mean of the calls' ``read`` spans, failed
    calls left out, and nothing where no call has the span (a program
    that opens none)."""
    from mvsbench import harness

    read = harness.reader("load_read_s").read
    run = lambda spans: harness.Run(cell=None, calls=[
        harness.CallRecord(view=i, kwargs={}, spans=s)
        for i, s in enumerate(spans)])
    assert read(run([])) is None
    assert read(run([{"load": 0.4}, {"load": 0.5}])) is None
    assert read(run([{"load": 0.4, "read": 0.1},
                     {"load": 0.5, "read": 0.3}])) == pytest.approx(0.2)
    failed = run([{"read": 0.1}, {"read": 9.0}])
    failed.calls[1].failed = True
    assert read(failed) == pytest.approx(0.1)
