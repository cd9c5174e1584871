"""The spans inside the pass (``utils/log.span``) and the attribution of
device activity to them (``utils/profiling.by_span``), on the CPU.

* ``process_problem`` with the planar prior, on a 32x24 ring of 3 views
  (the exact path, one iteration, 5x5 patches: short), records ``load``, ``main_round`` and
  ``prior_round`` with ``context``, ``init``, ``2 x max_iterations``
  ``halfstep`` and ``extract`` inside each round, every ``cost`` and
  ``rng`` inside an ``init`` or a ``halfstep``, and ``fetch`` inside
  ``prior_build`` and ``write``; no name opens inside itself, and the
  spans' totals stay inside the call's latency.
* ``load``'s ``read`` (the pool's decodes and reads) and ``upload`` open
  inside it, once for the problem and once more for a geometric or
  hierarchy pass's seed fields (inside ``hier_seed`` for the latter).
* ``run_patchmatch``'s outputs are bit-identical with no ``Timings``
  current, with one current, and with one that has a hook.
* ``run_pass_batched`` over two CPU slots: each slot thread's spans lie
  inside that thread's rounds, with ``2 x max_iterations`` half-steps in
  each.
* ``by_span`` joins device activity to its launch by correlation id and
  puts it down to the innermost span open at the launch; activity with no
  launch, or launched outside every span, is unattributed.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.config import (  # noqa: E402
    PatchMatchParams, PipelineConfig,
)
from acmmp_spherical_torch.io import dmb  # noqa: E402
from acmmp_spherical_torch.io.scene import (  # noqa: E402
    ScenePaths, read_pair_file,
)
from acmmp_spherical_torch.parallel.mesh import make_view_mesh  # noqa: E402
from acmmp_spherical_torch.pipeline import multiscale  # noqa: E402
from acmmp_spherical_torch.pipeline import pass_runner  # noqa: E402
from acmmp_spherical_torch.pipeline.batch_runner import (  # noqa: E402
    run_pass_batched,
)
from acmmp_spherical_torch.pipeline.patchmatch import (  # noqa: E402
    run_patchmatch,
)
from acmmp_spherical_torch.utils.log import Timings, span  # noqa: E402
from acmmp_spherical_torch.utils.profiling import (  # noqa: E402
    UNATTRIBUTED, by_span,
)
from acmmp_spherical_torch.utils.synthetic import (  # noqa: E402
    CubeRoom, make_ring_of_cameras, render_scene,
    write_synthetic_scene_to_disk,
)

W, H, N_VIEWS, FOCAL, ITERS = 32, 24, 3, 28.0, 1
ROUNDS = ("main_round", "prior_round")
STAGES = ("context", "init", "halfstep", "extract")


class Recorder:
    """A ``Timings`` hook keeping ``(thread name, span name, start_ns,
    end_ns)`` of every span, and failing a name that opens inside itself
    in its thread."""

    def __init__(self):
        self.spans = []
        self._open = {}
        self._lock = threading.Lock()

    def __call__(self, name, opened):
        key = (threading.get_ident(), name)
        t = time.perf_counter_ns()
        with self._lock:
            if opened:
                assert key not in self._open, f"{name} opened inside itself"
                self._open[key] = t
            else:
                self.spans.append((threading.current_thread().name, name,
                                   self._open.pop(key), t))

    def named(self, name, thread=None):
        return [s for s in self.spans if s[1] == name
                and (thread is None or s[0] == thread)]


def inside(s, outer) -> bool:
    return s[0] == outer[0] and outer[2] <= s[2] and s[3] <= outer[3]


def cfg():
    return PipelineConfig(patchmatch=PatchMatchParams(max_iterations=ITERS,
                                                      patch_size=5),
                          rect_ncc="off")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    cams = make_ring_of_cameras(N_VIEWS, width=W, height=H, focal=FOCAL,
                                device="cpu")
    write_synthetic_scene_to_disk(root, cams,
                                  render_scene(cams, CubeRoom(), W, H)[0])
    sp = ScenePaths(root)
    problems = read_pair_file(sp.pair_file)
    multiscale.compute_multiscale_settings(sp, problems, cfg())
    for p in problems:
        p.cur_image_size = p.max_image_size // (2 ** max(p.num_downscale, 0))
    return sp, problems


def test_process_problem_spans(scene):
    sp, problems = scene
    rec = Recorder()
    timings = Timings(hook=rec)
    t0 = time.perf_counter()
    pass_runner.process_problem(sp, problems, 0, cfg(), planar_prior=True,
                                device="cpu", timings=timings)
    latency = time.perf_counter() - t0
    rounds = [r for name in ROUNDS for r in rec.named(name)]
    assert [r[1] for r in sorted(rounds, key=lambda r: r[2])] == list(ROUNDS)
    for r in rounds:
        for name in STAGES:
            got = [s for s in rec.named(name) if inside(s, r)]
            assert len(got) == (2 * ITERS if name == "halfstep" else
                                2 if (name, r[1]) == ("context", ROUNDS[0])
                                else 1), (r[1], name)
    # main_round's prepare_inputs, and each run_patchmatch's own
    assert len(rec.named("context")) == 3
    steps = rec.named("init") + rec.named("halfstep")
    for name in ("cost", "rng"):
        assert rec.named(name)
        for s in rec.named(name):
            assert any(inside(s, o) for o in steps), name
    for outer in ("prior_build", "write"):
        (o,) = rec.named(outer)
        assert sum(inside(s, o) for s in rec.named("fetch")) == 1
    assert len(rec.named("fetch")) == 2
    for name, total in timings.totals.items():
        assert 0.0 <= total <= latency, name
    top = ("load",) + ROUNDS + ("prior_build", "write")
    assert sum(timings.totals[k] for k in top) <= latency
    (load,) = rec.named("load")
    for name in ("read", "upload"):
        (s,) = rec.named(name)
        assert inside(s, load), name
    assert rec.named("read")[0][3] <= rec.named("upload")[0][2]


@pytest.mark.parametrize("kind", ["geom", "hierarchy"])
def test_seed_loads_read_and_upload_inside_load(scene, kind):
    """A seeded pass reads its seed fields in a second ``read`` and
    ``upload`` inside ``load`` (a hierarchy pass's inside ``hier_seed``);
    the load itself, not the pass, is what is checked."""
    sp, problems = scene
    cams = make_ring_of_cameras(N_VIEWS, width=W, height=H, focal=FOCAL,
                                device="cpu")
    _, depths, normals = render_scene(cams, CubeRoom(), W, H)
    for p in problems:
        i = p.ref_image_id
        sp.result_dir(i).mkdir(parents=True, exist_ok=True)
        for geom in (False, True):
            dmb.write_dmb(sp.depth_file(i, geom=geom), depths[i])
        dmb.write_dmb(sp.normal_file(i), normals[i])
    rec = Recorder()
    timings = Timings(hook=rec)
    with timings.current(), timings.scope("load"):
        lp, _ = pass_runner.load_problem(sp, problems, 1, cfg(),
                                         geom=kind == "geom", device="cpu")
        seeds = pass_runner.load_seeds(sp, lp, 1, geom=kind == "geom",
                                       hierarchy=kind == "hierarchy",
                                       multi_geometry=False, device="cpu")
    assert set(seeds) == {"seed_normal_world", "seed_depth"}
    (load,) = rec.named("load")
    reads, uploads = rec.named("read"), rec.named("upload")
    assert len(reads) == len(uploads) == 2
    for s in reads + uploads:
        assert inside(s, load)
    if kind == "hierarchy":
        (hier,) = rec.named("hier_seed")
        assert inside(reads[1], hier) and inside(uploads[1], hier)
        assert not inside(reads[0], hier)


def test_spans_leave_outputs_alone(scene):
    sp, problems = scene
    lp, params = pass_runner.load_problem(sp, problems, 1, cfg(),
                                          device="cpu")
    run = lambda: run_patchmatch(lp.inputs, params, 5)[:3]
    with span("ignored"):    # no Timings current: a span does nothing
        plain = run()
    for timings in (Timings(), Timings(hook=Recorder())):
        with timings.current():
            got = run()
        assert timings.counts["halfstep"] == 2 * ITERS
        for a, b in zip(plain, got):
            assert torch.equal(a, b)
    with Timings().current() as outer:
        with Timings().current():
            pass
        with span("after"):
            pass
    assert outer.counts == {"after": 1}


def test_slot_threads_keep_their_spans(scene):
    sp, problems = scene
    rec = Recorder()
    run_pass_batched(sp, problems, [0, 1], cfg(),
                     mesh=make_view_mesh(devices=["cpu"] * 2),
                     timings=Timings(hook=rec))
    rounds = rec.named("main_round")
    threads = {r[0] for r in rounds}
    assert len(rounds) == 2 and len(threads) == 2
    assert threading.current_thread().name not in threads
    for r in rounds:
        mine = [s for s in rec.spans if s[0] == r[0] and s[1] != "main_round"]
        assert mine and all(inside(s, r) for s in mine)
        assert len(rec.named("halfstep", r[0])) == 2 * ITERS


def test_by_span_joins_and_nests():
    spans = [("halfstep", 100, 200), ("rng", 120, 140), ("init", 300, 400)]
    launches = {1: 110, 2: 130, 3: 150, 4: 350, 5: 500}
    device = [("k1", 1000, 1010, 1), ("k2", 1010, 1030, 2),
              ("k3", 1030, 1040, 3), ("copy", 1040, 1100, 4),
              ("late", 1100, 1105, 5), ("orphan", 1105, 1125, 9)]
    got = by_span(device, launches, spans)
    assert got["count"] == {"halfstep": 2, "rng": 1, "init": 1,
                            UNATTRIBUTED: 2}
    assert got["device_s"]["halfstep"] == pytest.approx(20e-9)
    assert got["device_s"]["rng"] == pytest.approx(20e-9)
    assert got["device_s"]["init"] == pytest.approx(60e-9)
    assert got["device_s"][UNATTRIBUTED] == pytest.approx(25e-9)
    assert got["attributed"] == pytest.approx(100 / 125)
    assert by_span([], {}, spans)["attributed"] == 0.0
