"""The port's parallel/ modules on CPU slots, against the JAX package's.

* ``make_synthetic_batch`` equals the JAX package's arrays exactly (images,
  cameras, source ids, ground truth), and ``interop.problem_batch`` of the
  JAX batch equals the port's.
* ``shard_batch_over_views`` puts contiguous blocks of problems on the
  slots in order.
* ``multichip_step`` (photometric pass, depth exchange, geometric pass) on 4
  problems at 32x24 with 2 sources: over 3 slots it equals, bit for bit,
  the same step on one slot (every problem's passes in turn), so the
  threads and the exchange change nothing and the step repeats its bits;
  against tests/fixtures/multichip_step_depths.json, the JAX package's
  ``multichip_train_step`` on the same batch and key over 4 virtual
  devices: at least 95% of the pixels within 1e-3 relative depth (two
  passes compound the ulp-level accept flips of each half-step, ROADMAP
  Queue 3 item 2: 99.2% agree after one iteration of the golden pass) and
  each problem's region statistics within drift_gate's 2e-2.
* ``fuse_all_views_sharded`` over 3 slots gives ``fuse_all_views``'s
  points, normals and colours (sorted by point).
* ``utils/profiling``: ``trace`` writes a Chrome trace of the scope.

Regenerate the fixture from the JAX package (CPU, about 1 minute):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_parallel.py --regen
"""

import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.config import FusionParams  # noqa: E402
from acmmp_spherical_torch.ops import rng as R  # noqa: E402
from acmmp_spherical_torch.parallel import (  # noqa: E402
    make_view_mesh, multichip_step, shard_batch_over_views,
)
from acmmp_spherical_torch.parallel.synthetic_batch import (  # noqa: E402
    make_synthetic_batch,
)

FIXTURE = (pathlib.Path(__file__).parent / "fixtures"
           / "multichip_step_depths.json")
B, W, H, N_SRC, KEY = 4, 32, 24, 2, 3
AGREE_REL, AGREE_MIN = 1e-3, 0.95
STAT_TOL = 2e-2            # scripts/drift_gate.py


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n):
    return make_view_mesh(devices=["cpu"] * n)


def test_synthetic_batch_matches_reference():
    from acmmp_spherical_tpu.parallel.synthetic_batch import (
        make_synthetic_batch as jbatch,
    )
    from acmmp_spherical_torch import interop
    from torch_port_util import jax_cam_dict

    jb, jp, jgt = jbatch(5, width=W, height=H, n_src=3)
    tb, tp, tgt = make_synthetic_batch(5, width=W, height=H, n_src=3,
                                       device="cpu")
    np.testing.assert_array_equal(tb.images.numpy(), np.asarray(jb.images))
    np.testing.assert_array_equal(tb.src_valid.numpy(),
                                  np.asarray(jb.src_valid))
    np.testing.assert_array_equal(tb.src_view_global.numpy(),
                                  np.asarray(jb.src_view_global))
    np.testing.assert_array_equal(tgt, jgt)
    for k, v in jax_cam_dict(jb.cams).items():
        np.testing.assert_array_equal(getattr(tb.cams, k).numpy(), v)
    assert (tp.depth_min, tp.depth_max) == (jp.depth_min, jp.depth_max)
    ib = interop.problem_batch({
        "images": np.asarray(jb.images), "cams": jax_cam_dict(jb.cams),
        "src_valid": np.asarray(jb.src_valid),
        "src_view_global": np.asarray(jb.src_view_global)}, device="cpu")
    for a, b in ((ib.images, tb.images), (ib.cams.R, tb.cams.R),
                 (ib.src_view_global, tb.src_view_global)):
        assert torch.equal(a, b)


def test_shard_batch_over_views():
    batch = make_synthetic_batch(5, width=W, height=H, n_src=2,
                                 device="cpu")[0]
    shards = shard_batch_over_views(_cpu_mesh(3), batch)
    assert [s.images.shape[0] for s in shards] == [2, 2, 1]
    assert torch.equal(torch.cat([s.images for s in shards]), batch.images)
    assert torch.equal(torch.cat([s.cams.K for s in shards]), batch.cams.K)
    one_each = shard_batch_over_views(_cpu_mesh(5), batch)
    for i, s in enumerate(one_each):
        assert torch.equal(s.src_view_global[0], batch.src_view_global[i])


def _depth_stats(d: np.ndarray) -> list:
    h, w = d.shape
    quads = [d[: h // 2, : w // 2], d[: h // 2, w // 2:], d[h // 2:, : w // 2],
             d[h // 2:, w // 2:]]
    return ([float(np.mean(q)) for q in quads]
            + [float(np.median(q)) for q in quads]
            + [float(np.percentile(d, 10)), float(np.percentile(d, 90))])


def test_multichip_step_matches_serial_and_reference(one_thread):
    batch, params, gt = make_synthetic_batch(B, width=W, height=H,
                                             n_src=N_SRC, device="cpu")
    out = {}
    for n in (3, 1):
        mesh = _cpu_mesh(n)
        per_slot = multichip_step(mesh, params, n_iterations=1)(
            shard_batch_over_views(mesh, batch), R.key(KEY))
        out[n] = [torch.cat(a) for a in zip(*per_slot)]
    for a, b in zip(out[3], out[1]):
        assert a.shape[0] == B
        assert torch.equal(a, b)
    depth = out[3][0].numpy()
    assert np.isfinite(depth).all()
    assert np.median(np.abs(depth - gt) / gt) < 0.2

    ref = np.asarray(json.loads(FIXTURE.read_text())["depth"], np.float32)
    agree = float(np.mean(np.abs(depth - ref) / ref < AGREE_REL))
    assert agree >= AGREE_MIN, agree
    for b in range(B):
        for g, r in zip(_depth_stats(depth[b]), _depth_stats(ref[b])):
            assert abs(g - r) <= max(STAT_TOL, STAT_TOL * abs(r)), (b, g, r)


def test_sharded_fusion_matches_serial():
    from acmmp_spherical_torch.core.camera import PINHOLE
    from acmmp_spherical_torch.ops.fusion import fuse_all_views
    from acmmp_spherical_torch.parallel.fusion import fuse_all_views_sharded
    from acmmp_spherical_torch.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )
    from acmmp_spherical_torch.core.camera import stack_cameras

    cams = make_ring_of_cameras(5, model=PINHOLE, width=W, height=H,
                                focal=28.0, device="cpu")
    images, depths, normals = render_scene(cams, CubeRoom(), W, H)
    rng = np.random.default_rng(7)
    depths = depths * (1.0 + 0.002 * rng.standard_normal(depths.shape)
                       ).astype(np.float32)
    colors = np.repeat(images[..., None], 3, axis=-1)
    src = np.array([[j for j in range(5) if j != i] + [-1]
                    for i in range(5)], np.int32)
    args = (torch.from_numpy(depths), torch.from_numpy(normals),
            torch.from_numpy(colors), stack_cameras(cams), src,
            FusionParams())
    ref = fuse_all_views(*args)
    got = fuse_all_views_sharded(_cpu_mesh(3), *args)
    assert len(ref[0]) > 1000
    order = lambda pts: np.lexsort(pts.T[::-1])
    ro, go = order(ref[0]), order(got[0])
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g[go], r[ro])


def test_profiling_trace_and_time_fn(tmp_path):
    from acmmp_spherical_torch.utils.profiling import trace

    x = torch.arange(4096.0)
    with trace(str(tmp_path / "trace")) as prof:
        (x * 2.0).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert events["traceEvents"]
    assert any("mul" in ev.key for ev in prof.key_averages())


def reference_depths() -> dict:
    """The JAX package's multichip_train_step on the test's batch."""
    import jax

    from acmmp_spherical_tpu.parallel import (
        make_view_mesh as jmesh, multichip_train_step,
        shard_batch_over_views as jshard,
    )
    from acmmp_spherical_tpu.parallel.synthetic_batch import (
        make_synthetic_batch as jbatch,
    )

    batch, params, _ = jbatch(B, width=W, height=H, n_src=N_SRC)
    mesh = jmesh(B)
    depth = multichip_train_step(mesh, params, n_iterations=1)(
        jshard(mesh, batch), jax.random.key(KEY))[0]
    return {"depth": np.asarray(depth).tolist()}


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import os

        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   f"--xla_force_host_platform_device_count"
                                   f"={B}").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
        FIXTURE.write_text(json.dumps(reference_depths()))
        print(f"wrote {FIXTURE}")
