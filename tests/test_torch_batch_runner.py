"""The port's batched pass runner (pipeline/batch_runner) on CPU slots.

* Chunking: on the JAX package's batch scene (48x36, 5 views, as
  tests/test_batch_runner.py) over 3 slots, the port's ``_chunks`` groups
  the problems as the JAX package's does (3 + 2), with the same chunk-wide
  rect reductions, and the trailing chunk holds only its 2 real problems
  (the JAX package pads it to 3); a multi-geometry pass over a ring, where
  every view is a source of every other, runs one problem per chunk.
* Batched pipeline: ``run_pipeline`` with ``batch_problems="on"`` over a
  mesh of 3 CPU slots, with the serial ``process_problem`` made to raise,
  on a 32x24 3-view ring (one scale: photometric pass with its prior
  round, then two geometric passes, on the rectified path with its plain
  versions; one PatchMatch iteration in the photometric pass to keep the
  run short) writes every file the serial run
  writes, equal to it byte for byte, and the same manifest.  Its
  statistics hold within drift_gate's 2e-2 of tests/fixtures/
  golden_batched_pipeline_stats.json, made by the JAX package's batched
  ``run_pipeline`` on the same scene over 3 virtual devices (region
  statistics of each view's final depth).  The JAX package's
  multi-geometry chunks read their sources' depths whenever its loader
  gets to them, so its second geometric pass does not follow the serial
  order; 2e-2 holds that too.  The fused cloud of a scene this small (about
  700 points) is held to the JAX package's own batched-pipeline gates
  (tests/test_batch_runner.py: each view's median relative depth error
  < 0.02) and more than 90% of its points within 0.08 of the surface, not
  to the fixture's count and accuracy: a few accept flips move them by
  several percent (the JAX package's serial and batched runs of the exact
  path fuse 495 and 461 points, the port's 414).
* Fallback: when a batched pass fails after writing its first problem,
  only the unwritten problems run serially; a failed multi-geometry pass
  re-raises.
* The launch counters lose no count when 4 threads add to them at once.

Regenerate the fixture from the JAX package (CPU, Pallas interpreted):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_batch_runner.py --regen
"""

import dataclasses
import filecmp
import json
import pathlib
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.config import (  # noqa: E402
    PatchMatchParams, PipelineConfig,
)
from acmmp_spherical_torch.io import read_depth_dmb, read_ply  # noqa: E402
from acmmp_spherical_torch.io.scene import (  # noqa: E402
    ScenePaths, read_pair_file,
)
from acmmp_spherical_torch.parallel.mesh import make_view_mesh  # noqa: E402
from acmmp_spherical_torch.pipeline import multiscale  # noqa: E402
from acmmp_spherical_torch.utils.metrics import (  # noqa: E402
    cube_surface_distance, depth_error_stats,
)
from acmmp_spherical_torch.utils.synthetic import (  # noqa: E402
    CubeRoom, make_ring_of_cameras, render_scene,
    write_synthetic_scene_to_disk,
)

FIXTURE = (pathlib.Path(__file__).parent / "fixtures"
           / "golden_batched_pipeline_stats.json")
W, H, N_VIEWS, FOCAL, SLOTS = 32, 24, 3, 28.0, 3
TAU = 0.08                 # 1% of the 8-unit room
STAT_TOL = 2e-2            # scripts/drift_gate.py
DEPTH_ERR_MAX = 0.02       # tests/test_batch_runner.py
ON_SURFACE_MIN = 0.9


def pipeline_cfg(cls=PipelineConfig, params=PatchMatchParams, packs=False,
                 **kw):
    """The test's configuration (either package's classes): the rectified
    path, as on the card, with both bf16 packs off (the f32 variant, as the
    fixture was made; tests/test_torch_pipeline_packs.py runs them on), one
    PatchMatch iteration in the photometric pass."""
    return cls(patchmatch=params(max_iterations=1, rect_tap_pack=packs,
                                 rect_backmap_pack=packs),
               rect_ncc="on", **kw)


def write_scene(root, width=W, height=H, n_views=N_VIEWS, focal=FOCAL):
    """Write the ring scene; returns its ground-truth depths."""
    cams = make_ring_of_cameras(n_views, width=width, height=height,
                                focal=focal, device="cpu")
    images, depths, _ = render_scene(cams, CubeRoom(), width, height)
    write_synthetic_scene_to_disk(root, cams, images)
    return depths


def depth_stats(d: np.ndarray) -> dict:
    h, w = d.shape
    out = {}
    for qi, sl in enumerate([np.s_[: h // 2, : w // 2], np.s_[: h // 2, w // 2:],
                             np.s_[h // 2:, : w // 2], np.s_[h // 2:, w // 2:]]):
        out[f"depth_mean_q{qi}"] = float(np.mean(d[sl]))
        out[f"depth_median_q{qi}"] = float(np.median(d[sl]))
    out["depth_p10"] = float(np.percentile(d, 10))
    out["depth_p90"] = float(np.percentile(d, 90))
    return out


def pipeline_stats(root, n_points: int) -> dict:
    sp = ScenePaths(root)
    pts = read_ply(sp.ply_file())[0]
    return {
        "views": [depth_stats(read_depth_dmb(sp.depth_file(v, geom=True)))
                  for v in range(N_VIEWS)],
        "fused_points": int(n_points),
        "accuracy": float(np.mean(cube_surface_distance(pts, CubeRoom().half)
                                  < TAU)),
    }


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loaded_scene(tmp_path, width, height, n_views, focal):
    root = tmp_path / "scene"
    write_scene(root, width, height, n_views, focal)
    sp = ScenePaths(root)
    problems = read_pair_file(sp.pair_file)
    multiscale.compute_multiscale_settings(sp, problems, PipelineConfig())
    for p in problems:
        p.cur_image_size = p.max_image_size // (2 ** max(p.num_downscale, 0))
    return sp, problems


def test_chunks_match_reference(tmp_path):
    """The JAX package's grouping and reductions on its own batch scene;
    the trailing chunk unpadded; multi-geometry chunks in the serial
    exchange order."""
    from acmmp_spherical_tpu.config import PipelineConfig as JConfig
    from acmmp_spherical_tpu.parallel.mesh import make_view_mesh as jmesh
    from acmmp_spherical_tpu.pipeline.batch_runner import _chunks as jchunks
    from acmmp_spherical_torch.pipeline.batch_runner import _chunks
    from acmmp_spherical_torch.utils.log import Timings

    sp, problems = _loaded_scene(tmp_path, 48, 36, 5, 42.0)
    mesh = make_view_mesh(devices=["cpu"] * SLOTS)
    for rect in ("off", "on"):
        got = list(_chunks(sp, problems, range(len(problems)),
                           PipelineConfig(rect_ncc=rect), mesh, geom=False,
                           multi_geometry=False, timings=Timings()))
        ref = list(jchunks(sp, problems, range(len(problems)),
                           JConfig(rect_ncc=rect), jmesh(SLOTS), geom=False,
                           multi_geometry=False))
        assert [c.indices for c in got] == [c.indices for c in ref] == [
            [0, 1, 2], [3, 4]]
        assert [len(c.lps) for c in got] == [3, 2]
        assert [len(c.lps) for c in ref] == [3, 3]
        for g, r in zip(got, ref):
            gp, rp = dataclasses.asdict(g.params), dataclasses.asdict(r.params)
            for k in ("rect_ncc", "rect_comp_hw", "rect_live_n", "rect_init",
                      "rect_init_win", "rect_warp_hw", "rect_inv_attrib",
                      "fast_ncc", "geom_consistency"):
                assert gp[k] == rp[k], (rect, k, gp[k], rp[k])
            assert g.params.rect_ncc == (rect == "on")
            for lp, rlp in zip(g.lps, r.lps):
                np.testing.assert_array_equal(
                    lp.inputs.src_images.numpy(),
                    np.asarray(rlp.inputs.src_images))
    for p in problems:
        assert sorted(p.src_image_ids) == sorted(
            q.ref_image_id for q in problems if q is not p)
    geom1 = list(_chunks(sp, problems, range(len(problems)), PipelineConfig(),
                         mesh, geom=True, multi_geometry=True,
                         timings=Timings()))
    assert [c.indices for c in geom1] == [[i] for i in range(len(problems))]


def _outputs(root: pathlib.Path) -> list:
    return sorted(p.relative_to(root) for p in (root / "ACMMP").rglob("*")
                  if p.is_file())


def test_batched_pipeline_equals_serial(tmp_path, monkeypatch, one_thread):
    serial, batched = tmp_path / "serial", tmp_path / "batched"
    write_scene(serial)
    gt = write_scene(batched)
    n_serial = multiscale.run_pipeline(
        serial, pipeline_cfg(batch_problems="off"), device="cpu")

    def no_serial(*args, **kw):
        raise AssertionError("the batched pass fell back to process_problem")

    monkeypatch.setattr(multiscale, "process_problem", no_serial)
    n = multiscale.run_pipeline(
        batched, pipeline_cfg(batch_problems="on"), device="cpu",
        mesh=make_view_mesh(devices=["cpu"] * SLOTS))
    assert n == n_serial > 0
    files = _outputs(serial)
    assert files == _outputs(batched)
    # 4 .dmb and triangulation.png per view, the PLY and the manifest
    assert len(files) == 5 * N_VIEWS + 2
    differ = [str(f) for f in files
              if not filecmp.cmp(serial / f, batched / f, shallow=False)]
    assert differ == []

    got, ref = pipeline_stats(batched, n), json.loads(FIXTURE.read_text())
    for v, (g, r) in enumerate(zip(got["views"], ref["views"])):
        for k, x in r.items():
            assert abs(g[k] - x) <= max(STAT_TOL, STAT_TOL * abs(x)), (
                v, k, g[k], x)
    sp = ScenePaths(batched)
    for v in range(N_VIEWS):
        err = depth_error_stats(read_depth_dmb(sp.depth_file(v, geom=True)),
                                gt[v])["median_rel_err"]
        assert err < DEPTH_ERR_MAX, (v, err)
    assert got["accuracy"] > ON_SURFACE_MIN, got["accuracy"]


def test_failed_batched_pass_reruns_only_unwritten(tmp_path, monkeypatch):
    """A batched pass that fails after writing its first problem leaves the
    other problems to the serial path; a failed multi-geometry pass
    re-raises."""
    from acmmp_spherical_torch.pipeline import batch_runner

    root = tmp_path / "scene"
    write_scene(root)
    serial = []

    def failing(sp, problems, order, cfg, *, on_written,
                multi_geometry=False, **kw):
        if multi_geometry:
            raise RuntimeError("multi-geometry pass failed")
        on_written(order[0])
        raise RuntimeError("second chunk failed")

    def process_problem(sp, problems, idx, cfg, *, geom=False, **kw):
        serial.append((geom, idx))

    monkeypatch.setattr(batch_runner, "run_pass_batched", failing)
    monkeypatch.setattr(multiscale, "process_problem", process_problem)
    with pytest.raises(RuntimeError, match="multi-geometry"):
        multiscale.run_pipeline(root, PipelineConfig(batch_problems="on"),
                                device="cpu",
                                mesh=make_view_mesh(devices=["cpu"] * SLOTS))
    assert serial == [(False, 1), (False, 2), (True, 1), (True, 2)]
    manifest = json.loads(ScenePaths(root).manifest_file().read_text())
    assert {k: sorted(v) for k, v in manifest.items()} == {
        "photometric_s0": [0, 1, 2], "geom0_s0": [0, 1, 2]}


def test_launch_counts_lose_nothing_across_threads():
    from acmmp_spherical_torch.ops.kernels import _lib

    names = list(_lib.LAUNCHES)
    n_threads, per_thread = 4, 20000
    before = dict(_lib.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(per_thread):
                _lib.count_launch(names[(t + i) % len(names)])

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    added = {k: _lib.LAUNCHES[k] - before[k] for k in names}
    assert sum(added.values()) == n_threads * per_thread
    expected = dict.fromkeys(names, 0)
    for t in range(n_threads):
        for i in range(per_thread):
            expected[names[(t + i) % len(names)]] += 1
    assert added == expected
    _lib.reset_launch_counts()
    assert set(_lib.LAUNCHES.values()) == {0}


def reference_stats(root) -> dict:
    """The JAX package's batched pipeline on the same scene folder."""
    from acmmp_spherical_tpu.config import (
        PatchMatchParams as JParams, PipelineConfig as JConfig,
    )
    from acmmp_spherical_tpu.pipeline.multiscale import run_pipeline as jrun

    write_scene(root)
    n = jrun(root, pipeline_cfg(JConfig, JParams, batch_problems="on"))
    return pipeline_stats(root, n)


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import os
        import tempfile

        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   f"--xla_force_host_platform_device_count"
                                   f"={SLOTS}").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
        assert jax.local_device_count() == SLOTS
        with tempfile.TemporaryDirectory() as tmp:
            FIXTURE.write_text(json.dumps(
                reference_stats(pathlib.Path(tmp) / "scene"), indent=1))
        print(f"wrote {FIXTURE}")
