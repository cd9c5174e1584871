"""The port's tile-parallel pass (``parallel/tile.py``) on CPU slots.

* (a) A ``rng.Cols`` window draws, bit for bit, the columns of the full
  draw: ``bits``, ``uniform``, ``normal`` (a trailing axis of 3), a
  (V, H, W) vote-shaped draw, ``_slab_uniform`` with a tile edge inside
  an 8x128 slab, and a window wrapped across a SPHERE seam.
* (b) ``tile_parallel_pass`` on 4 CPU slots against the JAX package's
  ``tile_parallel_pass`` on 4 virtual CPU devices, on
  ``make_synthetic_batch(4, width=64, height=32, n_src=3)``'s problem 0
  and key 0 (``tests/test_parallel.py:47-74``): the plane depth within
  1e-3 relative on at least 95% of the pixels, and the JAX test's median
  error against ground truth below 0.25.  Both packages' tiled passes
  equal their one-slot passes bit for bit here, and the init depths of
  the two packages agree on every pixel; after the one iteration 96.0%
  agree (98.1% on [4:-4, 4:-4]), under the 99.2% of ROADMAP Queue 3 item
  2's golden problem: this problem's exact init costs already differ by
  more than 1e-4 on 5.3% of the pixels, in rows 0, 1, 3 and 5 (f32
  conditioning of the exact NCC, Queue 3 item 6), and the accept flips
  follow.  95% is the share ``tests/test_torch_parallel.py`` holds
  ``multichip_step`` to.  These shares: ``JAX_PLATFORMS=cpu
  PYTHONPATH=.:tests python tests/test_torch_tile.py`` (~40 s).  The JAX
  package's depth is stored in tests/fixtures/ref_tile_pass.npz; rebuild
  it with ``--regen`` after that command (~30 s).
* (c) The port on 4 slots against 1 slot: the pinhole problem of (b) and
  the SPHERE golden ring at 128x64x3 (its ring halo crosses the seam),
  depth, normal and cost within ``rtol=1e-5, atol=1e-4`` at every pixel
  (they are equal bit for bit on this CPU); an odd-width frame (the
  full-grid fallback) through ``run_patchmatch(shard_state=)`` on 2
  slots, likewise; ``slow``: the geometric, hierarchy and planar-prior
  passes of the 96x64 golden ring on 3 slots.
* (d) ``reconstruct --tile-shard 2 --device cpu`` through ``cli.main`` on
  a 32x24 3-view ring against the serial run (a ``reconstruct``
  subprocess started at the same time): the JAX pipeline test's bounds
  (``tests/test_parallel.py:150-154``) on view 0's final depth, equal
  manifest entries and the fused point count within 2%.
* (e) ``slow``: the twin of ``test_tile_shard_pipeline_matches_serial``,
  ``run_pipeline`` with ``tile_shard=4`` against ``tile_shard=1`` at
  64x48x4.
* The tile layout (even edges, the remainder on the first tiles, halos
  clipped or wrapped), round-robin slots, ``make_view_tile_mesh``, and the
  ``ValueError`` on the windowed and rectified paths.

The slots of one device run one after the other (``parallel/tile.py``
docstring); the card runs the same passes (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 16).
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.ops import rng as R  # noqa: E402
from acmmp_spherical_torch.ops.propagate import _slab_uniform  # noqa: E402
from acmmp_spherical_torch.parallel import (  # noqa: E402
    make_state_sharder, make_tile_mesh, make_view_tile_mesh,
    tile_parallel_pass,
)
from acmmp_spherical_torch.parallel.synthetic_batch import (  # noqa: E402
    make_synthetic_batch,
)
from acmmp_spherical_torch.parallel.tile import (  # noqa: E402
    HALO, _halo_tiles, tile_bounds,
)
from acmmp_spherical_torch.parallel.view_parallel import (  # noqa: E402
    _problem_inputs,
)
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch  # noqa: E402

from torch_port_util import reference_arrays, regen_references  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
W, H, N_SRC = 64, 32, 3
AGREE_REL, AGREE_MIN = 1e-3, 0.95     # see the module docstring
RTOL, ATOL = 1e-5, 1e-4               # tests/test_parallel.py:71


def _cpu_tiles(n):
    return make_tile_mesh(n, devices=["cpu"])


def _exact(params, **kw):
    return dataclasses.replace(params, rect_ncc=False, fast_ncc=False,
                               rect_init=False, rect_comp_hw=None,
                               rect_live_n=None, rect_warp_hw=None, **kw)


def _assert_close(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL,
                                   atol=ATOL)


# (a) -- the column windows of the random stream

@pytest.mark.parametrize("x0,n,width", [(0, 16, 64), (22, 18, 64),
                                        (40, 24, 64), (56, 20, 64)],
                         ids=["first", "inner", "last", "wrapped"])
def test_rng_window_equals_slice_of_full_draw(x0, n, width):
    k = R.fold_in(R.key(5), 17)
    cols = np.arange(x0, x0 + n) % width
    c = R.Cols(x0, width)
    full = R.bits(k, (7, width), "cpu")
    assert torch.equal(R.bits(k, (7, n), "cpu", c), full[:, cols])
    full = R.uniform(k, (7, width), "cpu", 0.25, 3.0)
    assert torch.equal(R.uniform(k, (7, n), "cpu", 0.25, 3.0, cols=c),
                       full[:, cols])
    full = R.normal(k, (7, width, 3), "cpu")
    assert torch.equal(R.normal(k, (7, n, 3), "cpu", c, -2), full[:, cols])
    # the votes' (V, H, W) draw
    full = R.uniform(k, (15, 5, width), "cpu")
    assert torch.equal(R.uniform(k, (15, 5, n), "cpu", cols=c),
                       full[..., cols])


@pytest.mark.parametrize("x0,n", [(100, 60), (250, 40), (280, 60)],
                         ids=["slab_edge_inside", "inner", "wrapped"])
def test_slab_uniform_window_equals_slice(x0, n):
    width, k = 300, R.key(9)
    full = _slab_uniform(k, (20, width), "cpu")
    cols = np.arange(x0, x0 + n) % width
    got = _slab_uniform(k, (20, n), "cpu", R.Cols(x0, width))
    assert torch.equal(got, full[:, cols])


def test_random_plane_window_equals_slice():
    from acmmp_spherical_torch.ops.sampling import grid_coords
    from acmmp_spherical_torch.utils.synthetic import make_ring_of_cameras

    cam = make_ring_of_cameras(2, model="sphere", width=48, height=24,
                               device="cpu")[0]
    xs, ys = grid_coords(24, 48, "cpu")
    k, x0, n = R.key(3), 40, 16
    cols = np.arange(x0, x0 + n) % 48
    nf, wf = R.random_plane_hypothesis(k, cam, xs, ys, 1.0, 5.0)
    xw, yw = xs[:, cols], ys[:, cols]
    nw, ww = R.random_plane_hypothesis(k, cam, xw, yw, 1.0, 5.0,
                                       R.Cols(x0, 48))
    assert torch.equal(nw, nf[:, cols]) and torch.equal(ww, wf[:, cols])


# the tile layout and the mesh

def test_tile_bounds_and_halos():
    assert tile_bounds(64, 4) == [(0, 16), (16, 32), (32, 48), (48, 64)]
    assert tile_bounds(70, 4) == [(0, 18), (18, 36), (36, 54), (54, 70)]
    assert tile_bounds(95, 3) == [(0, 32), (32, 64), (64, 95)]
    with pytest.raises(ValueError):
        tile_bounds(6, 4)
    pin = _halo_tiles(64, 4, sphere=False)
    assert [(t.lo, int(c[0]), int(c[-1])) for t, c in pin] == [
        (0, 0, 39), (16, 0, 55), (HALO, 8, 63), (HALO, 24, 63)]
    sph = _halo_tiles(128, 4, sphere=True)
    t, c = sph[0]
    assert t.lo == HALO and list(c[:HALO]) == list(range(104, 128))
    t, c = sph[3]
    assert list(c[-HALO:]) == list(range(HALO))


def test_tile_mesh_round_robin():
    mesh = make_tile_mesh(3, devices=["cpu"])
    assert mesh.size == 3 and set(mesh.devices) == {torch.device("cpu")}
    vt = make_view_tile_mesh(2, 3, devices=["cpu", "cpu"])
    assert vt.shape == (2, 3) and vt.tile_mesh(1).size == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_tile_mesh(2)


def test_tiles_refuse_kernel_paths():
    batch, params, _ = make_synthetic_batch(2, width=32, height=24, n_src=2,
                                            device="cpu")
    inputs = _problem_inputs(batch, 0, params)
    for change in (dict(rect_ncc=True), dict(fast_ncc=True)):
        p = dataclasses.replace(params, **change)
        with pytest.raises(ValueError):
            tile_parallel_pass(_cpu_tiles(2), p)
        with pytest.raises(ValueError):
            make_state_sharder(_cpu_tiles(2))(inputs, p)


# (b), (c) -- the tiled pass

@pytest.fixture(scope="module")
def synthetic():
    batch, params, gt = make_synthetic_batch(4, width=W, height=H,
                                             n_src=N_SRC, device="cpu")
    inputs = _problem_inputs(batch, 0, params)
    out = {n: tile_parallel_pass(_cpu_tiles(n), params)(inputs, R.key(0))
           for n in (1, 4)}
    return out, gt[0]


def _jax_tile_pass(n_iterations=1):
    """The JAX package's tile_parallel_pass on 4 virtual devices, on the
    same problem and key (tests/test_parallel.py:47-74): (depth, normal,
    cost) as numpy."""
    import jax
    from jax.sharding import Mesh

    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs
    from acmmp_spherical_tpu.parallel.synthetic_batch import (
        make_synthetic_batch as jbatch,
    )
    from acmmp_spherical_tpu.parallel.tile import (
        tile_parallel_pass as jtile,
    )

    batch, params, _ = jbatch(4, width=W, height=H, n_src=N_SRC)
    inputs = PatchMatchInputs(
        ref_image=batch.images[0, 0], src_images=batch.images[0, 1:],
        ref_cam=jax.tree.map(lambda a: a[0, 0], batch.cams),
        src_cams=jax.tree.map(lambda a: a[0, 1:], batch.cams),
        src_valid=batch.src_valid[0])
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("tile",))
    out = jtile(mesh, params, n_iterations=n_iterations)(inputs,
                                                         jax.random.key(0))
    assert len(out[0].sharding.device_set) == 4
    return [np.asarray(a) for a in out]


def build_tile_reference():
    return dict(depth=_jax_tile_pass()[0])


REFERENCES = {"ref_tile_pass": build_tile_reference}


def test_tile_pass_matches_reference(synthetic):
    out, gt = synthetic
    depth = out[4][0].numpy()
    ref = reference_arrays("ref_tile_pass", build_tile_reference)["depth"]
    agree = float(np.mean(np.abs(depth - ref) / ref < AGREE_REL))
    assert agree >= AGREE_MIN, agree
    assert np.median(np.abs(depth - gt) / gt) < 0.25


def test_tile_pass_matches_one_slot_pinhole(synthetic):
    out, _ = synthetic
    assert out[4][0].shape == (H, W)
    _assert_close(out[4], out[1])


def test_tile_pass_matches_one_slot_sphere():
    from acmmp_spherical_torch.bench import (
        SPHERE_GOLDEN_SCENE, make_sphere_problem,
    )

    inputs, params, _, _ = make_sphere_problem(**SPHERE_GOLDEN_SCENE,
                                               device="cpu")
    params = _exact(params)
    out = {n: tile_parallel_pass(_cpu_tiles(n), params)(inputs, R.key(4))
           for n in (1, 4)}
    assert out[4][0].shape == (64, 128)
    _assert_close(out[4], out[1])


@pytest.fixture(scope="module")
def golden():
    """The golden ring's exact one-iteration photometric params, its
    inputs with source depths and its seeds (``bench.golden_geom_problem``)."""
    from acmmp_spherical_torch.bench import (
        GOLDEN_SCENE, golden_geom_problem, make_problem,
    )

    inputs, _, seeds, _ = golden_geom_problem("cpu")
    params = make_problem(**GOLDEN_SCENE, device="cpu")[1]
    return inputs, _exact(params, max_iterations=1), seeds


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["geometric", "hierarchy"])
def test_sharded_seeded_passes_match_one_slot(golden, kind):
    inputs, params, seeds = golden
    if kind == "hierarchy":
        inputs = dataclasses.replace(inputs, src_depths=None)
        params = params.with_hierarchy()
    else:
        params = params.with_geom(False)
    out = [run_patchmatch(inputs, params, 11, shard_state=sh, **seeds)
           for sh in (None, make_state_sharder(_cpu_tiles(3)))]
    _assert_close(out[1][:3], out[0][:3])


@pytest.mark.slow
def test_sharded_prior_pass_matches_one_slot(golden):
    from acmmp_spherical_torch.config import PriorConfig
    from acmmp_spherical_torch.pipeline.prior import build_planar_prior

    inputs, params, _ = golden
    inputs = dataclasses.replace(inputs, src_depths=None)
    depth, _, cost, state = run_patchmatch(inputs, params, 7)
    dmin, dmax = inputs.depth_range.numpy()
    pn, pw, mask, _ = build_planar_prior(inputs.ref_cam, depth.numpy(),
                                         cost.numpy(), dmin, dmax,
                                         PriorConfig())
    assert 0.1 < mask.mean() < 1.0
    prior_inputs = dataclasses.replace(
        inputs, prior_normal=torch.from_numpy(pn),
        prior_w=torch.from_numpy(pw), prior_mask=torch.from_numpy(mask))
    out = [run_patchmatch(prior_inputs, params.with_planar_prior(),
                          R.fold_in(R.key(7), 1), prev_state=state,
                          shard_state=sh)
           for sh in (None, make_state_sharder(_cpu_tiles(3)))]
    _assert_close(out[1][:3], out[0][:3])


def test_sharded_odd_frame_matches_one_slot():
    from acmmp_spherical_torch.bench import make_problem

    inputs, params, _, _ = make_problem(width=45, height=32, n_src=2,
                                        focal=40.0, radius=0.35,
                                        device="cpu")
    params = _exact(params, max_iterations=1)
    out = [run_patchmatch(inputs, params, 3, shard_state=sh)
           for sh in (None, make_state_sharder(_cpu_tiles(2)))]
    assert out[1][0].shape == (32, 45)
    _assert_close(out[1][:3], out[0][:3])


# (d), (e) -- the pipeline

def _ring(root, width, height, n_views):
    from acmmp_spherical_torch.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
        write_synthetic_scene_to_disk,
    )

    cams = make_ring_of_cameras(n_views, width=width, height=height,
                                focal=0.875 * width, device="cpu")
    images, depths, _ = render_scene(cams, CubeRoom(), width, height)
    write_synthetic_scene_to_disk(root, cams, images)
    return depths


def _final_depth(root, view=0):
    from acmmp_spherical_torch.io.dmb import read_depth_dmb
    from acmmp_spherical_torch.io.scene import ScenePaths

    return read_depth_dmb(ScenePaths(root).depth_file(view, geom=True))


def _manifest(root):
    from acmmp_spherical_torch.io.scene import ScenePaths

    m = json.loads(ScenePaths(root).manifest_file().read_text())
    return {k: sorted(v) for k, v in m.items()}


def _assert_pipeline_bounds(tiled, serial, gt):
    """tests/test_parallel.py:150-154."""
    rel = np.abs(tiled - serial) / np.maximum(serial, 1e-6)
    assert np.median(rel) < 1e-5, np.median(rel)
    assert np.mean(rel < 1e-3) > 0.99, np.mean(rel < 1e-3)
    gt_rel = np.abs(tiled - gt) / gt
    assert np.median(gt_rel[4:-4, 4:-4]) < 0.02


def test_reconstruct_tile_shard_matches_serial(tmp_path, caplog):
    import logging

    from acmmp_spherical_torch.pipeline.cli import main

    gt = None
    for name in ("serial", "tiled"):
        gt = _ring(tmp_path / name, 32, 24, 3)
    serial = subprocess.Popen(
        [sys.executable, "-m", "acmmp_spherical_torch", "reconstruct",
         str(tmp_path / "serial"), "--device", "cpu"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with caplog.at_level(logging.INFO):
            assert main(["reconstruct", str(tmp_path / "tiled"), "--device",
                         "cpu", "--tile-shard", "2"]) == 0
        log_serial = serial.communicate(timeout=600)[0]
    finally:
        if serial.poll() is None:
            serial.kill()
            serial.wait()
    assert serial.returncode == 0, log_serial[-3000:]
    assert "tile-parallel passes: width tiles over 2 slots" in caplog.text
    assert "path=rect" not in caplog.text
    _assert_pipeline_bounds(_final_depth(tmp_path / "tiled"),
                            _final_depth(tmp_path / "serial"), gt[0])
    assert _manifest(tmp_path / "tiled") == _manifest(tmp_path / "serial")
    points = [int(line.split("fusion wrote ")[1].split()[0])
              for line in (caplog.text, log_serial)
              for line in line.splitlines() if "fusion wrote" in line]
    assert len(points) == 2 and abs(points[0] - points[1]) <= 0.02 * points[1]


@pytest.mark.slow
def test_tile_shard_pipeline_matches_serial(tmp_path):
    """The twin of tests/test_parallel.py::
    test_tile_shard_pipeline_matches_serial."""
    from acmmp_spherical_torch.config import PipelineConfig
    from acmmp_spherical_torch.pipeline.multiscale import run_pipeline

    results = {}
    for shard in (1, 4):
        root = tmp_path / f"dense_{shard}"
        gt = _ring(root, 64, 48, 4)
        cfg = PipelineConfig(tile_shard=shard, batch_problems="off")
        n_pts = run_pipeline(root, cfg, device="cpu")
        assert n_pts > 500, (shard, n_pts)
        results[shard] = _final_depth(root)
    _assert_pipeline_bounds(results[4], results[1], gt[0])


def agreement_report() -> dict:
    """The shares quoted in the module docstring: the port's tiled pass
    against the JAX package's, after the init and after one iteration."""
    batch, params, _ = make_synthetic_batch(4, width=W, height=H,
                                            n_src=N_SRC, device="cpu")
    inputs = _problem_inputs(batch, 0, params)
    rel = lambda a, b: np.abs(a - b) / np.abs(b)
    out = {}
    for n in (0, 1):
        port = [a.numpy() for a in tile_parallel_pass(
            _cpu_tiles(4), params, n_iterations=n)(inputs, R.key(0))]
        ref = _jax_tile_pass(n)
        r = rel(port[0], ref[0])
        bad = np.abs(port[2] - ref[2]) > 1e-4
        out[f"iterations_{n}"] = dict(
            depth_agree=float(np.mean(r < AGREE_REL)),
            depth_agree_interior=float(np.mean(r[4:-4, 4:-4] < AGREE_REL)),
            cost_differ_1e4=float(np.mean(bad)),
            cost_differ_rows=np.nonzero(bad.any(1))[0].tolist())
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_tile.py
    # [--regen]
    import conftest  # noqa: F401  (the 8 virtual CPU devices)

    if "--regen" in sys.argv:
        regen_references(REFERENCES)
    else:
        print(json.dumps(agreement_report(), indent=1))
