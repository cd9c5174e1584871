"""The ``reconstruct`` command as two ranks of a gloo process group on the
CPU (``--distributed --device cpu``, coordinator on 127.0.0.1).

* On a 32x24 3-view ring (one scale, ``PipelineConfig`` defaults but the
  planar-prior round, ``--no-prior``, to keep the file short: the prior
  round has no part in the exchange), the two processes exit 0; rank 0
  runs views 0 and 2 of every pass, rank 1 view 1 (round-robin); only
  rank 0 fuses and writes the PLY; every output file
  equals a one-process run's byte for byte (the second geometric pass runs
  in waves, ``pass_runner.exchange_waves``), and the manifest holds the
  same (pass, view) entries (their order within a pass follows completion).
* A rank that exits early (its scene folder is missing) makes the other
  (on a 2-view ring) fail at its next barrier, within the barrier timeout.
"""

import filecmp
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from acmmp_spherical_torch.utils.synthetic import (  # noqa: E402
    CubeRoom, make_ring_of_cameras, render_scene,
    write_synthetic_scene_to_disk,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
W, H, N_VIEWS, FOCAL = 32, 24, 3, 28.0
TIMEOUT_S = 240


def _write_scene(root, n_views=N_VIEWS):
    cams = make_ring_of_cameras(n_views, width=W, height=H, focal=FOCAL,
                                device="cpu")
    write_synthetic_scene_to_disk(root, cams,
                                  render_scene(cams, CubeRoom(), W, H)[0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reconstruct(scene, *extra, env=()):
    env = dict(os.environ, OMP_NUM_THREADS="1", **dict(env))
    return subprocess.Popen(
        [sys.executable, "-m", "acmmp_spherical_torch", "reconstruct",
         str(scene), "--device", "cpu", "--no-prior", *extra], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _ranks(scenes, timeout_s=TIMEOUT_S, barrier_timeout=None):
    port = _free_port()
    env = {} if barrier_timeout is None else {
        "ACMMP_BARRIER_TIMEOUT_S": str(barrier_timeout)}
    procs = [_reconstruct(scene, "--distributed", "--coordinator",
                          f"127.0.0.1:{port}", "--num-processes", "2",
                          "--process-id", str(r), env=env)
             for r, scene in enumerate(scenes)]
    try:
        outs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _files(root):
    return sorted(p.relative_to(root) for p in (root / "ACMMP").rglob("*")
                  if p.is_file())


def test_two_ranks_equal_one_process(tmp_path):
    serial, dist = tmp_path / "serial", tmp_path / "dist"
    _write_scene(serial)
    _write_scene(dist)
    one = _reconstruct(serial)
    out, _ = one.communicate(timeout=TIMEOUT_S)
    assert one.returncode == 0, out

    rcs, outs = _ranks([dist, dist])
    assert rcs == [0, 0], outs
    for r, out in enumerate(outs):
        ran = {int(m) for m in re.findall(r"pass image=(\d+)", out)}
        assert ran == set(range(r, N_VIEWS, 2)), (r, ran)
    assert "fusion wrote" in outs[0]
    assert "fusion wrote" not in outs[1]

    files = _files(serial)
    assert files == _files(dist)
    manifest = pathlib.Path("ACMMP/manifest.json")
    differ = [str(f) for f in files if f != manifest and not filecmp.cmp(
        serial / f, dist / f, shallow=False)]
    assert differ == []
    m1, m2 = (json.loads((root / manifest).read_text())
              for root in (serial, dist))
    assert {k: sorted(v) for k, v in m1.items()} == {
        k: sorted(v) for k, v in m2.items()}


def test_dead_rank_fails_the_other(tmp_path):
    scene = tmp_path / "scene"
    _write_scene(scene, n_views=2)
    t0 = time.monotonic()
    rcs, outs = _ranks([scene, tmp_path / "missing"], barrier_timeout=30)
    assert rcs[1] != 0, outs[1]
    assert rcs[0] != 0, outs[0]
    assert "fusion wrote" not in outs[0]
    assert time.monotonic() - t0 < TIMEOUT_S
