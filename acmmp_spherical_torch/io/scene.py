"""Scene layout, camera files, pair lists, images and the resume manifest
(counterpart of acmmp_spherical_tpu/io/scene.py), in the reference's
on-disk contract::

    <dense>/images/%08d.jpg          input images
    <dense>/cams/%08d_cam.txt        text camera files
    <dense>/pair.txt                 view-selection lists
    <dense>/ACMMP/2333_%08d/         per-view results: depths.dmb,
                                     depths_geom.dmb, normals.dmb, costs.dmb
    <dense>/ACMMP/ACMMP_model.ply    fused cloud
    <dense>/ACMMP/manifest.json      completed (pass, view) entries

Images are read and written with OpenCV (``cv2``), as the JAX package does;
without it the image functions raise ImportError naming ``cv2``.  Camera
files hold pinhole (``K``) or SPHERE (``f cx cy``) intrinsics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import functools
import json
import os
from pathlib import Path
from typing import Sequence

import numpy as np

from acmmp_spherical_torch.core.camera import (
    Camera, PINHOLE, SPHERE, make_camera,
)
from acmmp_spherical_torch.utils.log import get_logger

log = get_logger(__name__)

RESULT_DIR_FMT = "2333_{:08d}"  # reference main.cpp:79
OUTPUT_SUBDIR = "ACMMP"


@dataclasses.dataclass
class Problem:
    """One view cluster: a reference image and its selected source views
    (reference main.h:58-64)."""

    ref_image_id: int
    src_image_ids: list[int]
    max_image_size: int = 3200
    num_downscale: int = 0
    cur_image_size: int = 3200


def read_camera_file(path: str | os.PathLike, device="cuda") -> Camera:
    """Parse a cam.txt (reference ReadCamera, ACMMP.cpp:146-209) into a
    camera on ``device``.  Width and height are not in the file; the loader
    fills them in from the image.  A SPHERE file's depth line is
    ``dmin dint nplanes dmax``.  The pinhole depth line comes
    in two conventions, the converter's ``dmin dint nplanes dmax`` and the
    C++ reader's ``dmin dmax d d``; the converter's is recognised by
    ``dint * (nplanes - 1) == dmax - dmin`` or by a "dmax" below dmin, as
    the JAX package does."""
    tokens = Path(path).read_text().split()
    it = iter(tokens)
    next_f = lambda: float(next(it))

    tok = next(it)
    if tok != "extrinsic":
        raise ValueError(f"{path}: expected 'extrinsic', got {tok!r}")
    E = np.array([next_f() for _ in range(16)]).reshape(4, 4)
    tok = next(it)
    if tok != "intrinsic":
        raise ValueError(f"{path}: expected 'intrinsic', got {tok!r}")
    tok = next(it)
    if tok == "SPHERE":
        f, cx, cy = next_f(), next_f(), next_f()
        dmin, _dint, _nplanes, dmax = next_f(), next_f(), next_f(), next_f()
        return make_camera(E[:3, :3], E[:3, 3], model=SPHERE,
                           sphere_params=[f, cx, cy], depth_min=dmin,
                           depth_max=dmax, device=device)
    K = np.array([float(tok)] + [next_f() for _ in range(8)]).reshape(3, 3)
    vals = []
    for _ in range(4):
        try:
            vals.append(next_f())
        except StopIteration:
            break
    dmin = vals[0] if vals else 0.0
    dmax = vals[1] if len(vals) > 1 else 1.0
    if len(vals) == 4:
        a, b, c, d = vals
        span_id = (c >= 2 and abs(c - round(c)) < 1e-6
                   and abs(b * (round(c) - 1) - (d - a))
                   <= 0.02 * max(d - a, 1e-9))
        if b <= a or span_id:
            if b > a:
                log.warning(
                    "%s: pinhole depth line %r matched the converter format "
                    "dmin dint nplanes dmax (dint*(nplanes-1) ~= dmax-dmin); "
                    "using depth range (%g, %g). If this file is in the C++ "
                    "'dmin dmax d d' convention, the intended range was "
                    "(%g, %g).", path, vals, a, d, a, b)
            dmin, dmax = a, d
    return make_camera(E[:3, :3], E[:3, 3], model=PINHOLE, K=K,
                       depth_min=dmin, depth_max=dmax, device=device)


def write_camera_file(path, camera_model: str, R, t, *, K=None,
                      sphere_params=None, depth_min=0.0, depth_max=1.0,
                      depth_interval=0.0, num_planes=192) -> None:
    """Write a cam.txt in the converter's format
    (colmap2mvsnet_acm.py:365-388): ``K`` for a pinhole camera,
    ``sphere_params`` ``[f, cx, cy]`` for a SPHERE one; one depth-line
    format for both."""
    E = np.eye(4)
    E[:3, :3] = np.asarray(R).reshape(3, 3)
    E[:3, 3] = np.asarray(t).reshape(3)
    lines = ["extrinsic"]
    lines += [" ".join(repr(float(v)) for v in E[r]) for r in range(4)]
    lines += ["", "intrinsic"]
    if camera_model == SPHERE:
        f, cx, cy = sphere_params[:3]
        lines += ["SPHERE", f"{f} {cx} {cy}"]
    else:
        K = np.asarray(K).reshape(3, 3)
        lines += [" ".join(repr(float(v)) for v in K[r]) for r in range(3)]
    lines += ["", f"{depth_min} {depth_interval} {num_planes} {depth_max}"]
    Path(path).write_text("\n".join(lines) + "\n")


def read_pair_file(path) -> list[Problem]:
    """Parse pair.txt into Problems; non-positive scores are dropped
    (reference GenerateSampleList, main.cpp:4-33)."""
    it = iter(Path(path).read_text().split())
    problems = []
    for _ in range(int(next(it))):
        ref_id = int(next(it))
        src_ids = []
        for _ in range(int(next(it))):
            sid, score = int(next(it)), float(next(it))
            if score > 0.0:
                src_ids.append(sid)
        problems.append(Problem(ref_image_id=ref_id, src_image_ids=src_ids))
    return problems


def write_pair_file(path, neighbors: Sequence[Sequence[tuple[int, float]]]
                    ) -> None:
    """``neighbors[i]`` is a ranked list of (src_id, score) for image i
    (colmap2mvsnet_acm.py:390-397)."""
    with open(path, "w") as f:
        f.write(f"{len(neighbors)}\n")
        for i, nbrs in enumerate(neighbors):
            f.write(f"{i}\n{len(nbrs)} ")
            for j, s in nbrs:
                f.write(f"{j} {int(s)} ")
            f.write("\n")


class ScenePaths:
    """The files of one scene folder."""

    def __init__(self, root):
        self.root = Path(root)

    @property
    def images_dir(self) -> Path:
        return self.root / "images"

    @property
    def cams_dir(self) -> Path:
        return self.root / "cams"

    @property
    def pair_file(self) -> Path:
        return self.root / "pair.txt"

    @property
    def output_dir(self) -> Path:
        return self.root / OUTPUT_SUBDIR

    def image_file(self, image_id: int) -> Path:
        return self.images_dir / f"{image_id:08d}.jpg"

    def camera_file(self, image_id: int) -> Path:
        return self.cams_dir / f"{image_id:08d}_cam.txt"

    def result_dir(self, image_id: int) -> Path:
        return self.output_dir / RESULT_DIR_FMT.format(image_id)

    def depth_file(self, image_id: int, geom: bool) -> Path:
        name = "depths_geom.dmb" if geom else "depths.dmb"
        return self.result_dir(image_id) / name

    def normal_file(self, image_id: int) -> Path:
        return self.result_dir(image_id) / "normals.dmb"

    def cost_file(self, image_id: int) -> Path:
        return self.result_dir(image_id) / "costs.dmb"

    def ply_file(self) -> Path:
        return self.output_dir / "ACMMP_model.ply"

    def manifest_file(self) -> Path:
        return self.output_dir / "manifest.json"


def _imread(path, flag_name: str) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), getattr(cv2, flag_name))
    if img is None:
        raise FileNotFoundError(path)
    return img


def load_image_gray(path) -> np.ndarray:
    """Grayscale float32 image in 0..255 (reference ACMMP.cpp:578-580)."""
    return _imread(path, "IMREAD_GRAYSCALE").astype(np.float32)


def load_image_color(path) -> np.ndarray:
    """RGB uint8 image (fusion colours)."""
    return _imread(path, "IMREAD_COLOR")[..., ::-1].copy()


@functools.lru_cache(maxsize=None)
def image_size(path: str) -> tuple[int, int]:
    """(height, width) of an image file, decoded once per process."""
    return load_image_gray(path).shape


def resize_linear(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize`` with INTER_LINEAR (ACMMP.cpp:605-643)."""
    import cv2

    return cv2.resize(image, (width, height), interpolation=cv2.INTER_LINEAR)


def write_image(path, image: np.ndarray, jpeg_quality: int | None = None
                ) -> None:
    """Write a uint8 image (gray, or RGB); ``jpeg_quality`` for .jpg."""
    import cv2

    img = image[..., ::-1] if image.ndim == 3 else image
    params = ([] if jpeg_quality is None
              else [cv2.IMWRITE_JPEG_QUALITY, int(jpeg_quality)])
    if not cv2.imwrite(str(path), np.ascontiguousarray(img), params):
        raise IOError(f"cv2.imwrite({path}) failed")


@contextlib.contextmanager
def _locked_manifest(mf: Path, exclusive: bool):
    """The manifest opened under an ``flock`` (shared to read, exclusive to
    update), since the ranks of a distributed run mark the same file."""
    fd = os.open(mf, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
        with os.fdopen(os.dup(fd), "r+") as f:
            yield f
    finally:
        os.close(fd)


def mark_pass_complete(paths: ScenePaths, pass_name: str,
                       image_id: int) -> None:
    mf = paths.manifest_file()
    mf.parent.mkdir(parents=True, exist_ok=True)
    with _locked_manifest(mf, exclusive=True) as f:
        text = f.read()
        data = json.loads(text) if text else {}
        data.setdefault(pass_name, [])
        if image_id not in data[pass_name]:
            data[pass_name].append(image_id)
        f.seek(0)
        f.truncate()
        f.write(json.dumps(data))


def is_pass_complete(paths: ScenePaths, pass_name: str, image_id: int) -> bool:
    mf = paths.manifest_file()
    if not mf.exists():
        return False
    with _locked_manifest(mf, exclusive=False) as f:
        text = f.read()
    return image_id in (json.loads(text) if text else {}).get(pass_name, [])
