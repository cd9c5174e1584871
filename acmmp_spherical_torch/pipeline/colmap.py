"""COLMAP sparse-model readers (the port's numpy copy of
acmmp_spherical_tpu/pipeline/colmap.py).

Text and binary readers for cameras/images/points3D, supporting the 11
standard COLMAP camera models plus the custom SPHERE model id 11
(reference colmap2mvsnet_acm.py:32-167).  Host code, numpy only.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

# model_id -> (name, num_params) (reference colmap2mvsnet_acm.py:48-61)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
    11: ("SPHERE", 3),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}

# parameter layout per model (reference colmap2mvsnet_acm.py:264-277)
PARAM_NAMES = {
    "SIMPLE_PINHOLE": ["f", "cx", "cy"],
    "PINHOLE": ["fx", "fy", "cx", "cy"],
    "SIMPLE_RADIAL": ["f", "cx", "cy", "k"],
    "RADIAL": ["f", "cx", "cy", "k1", "k2"],
    "OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"],
    "OPENCV_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"],
    "FULL_OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2",
                    "k3", "k4", "k5", "k6"],
    "FOV": ["fx", "fy", "cx", "cy", "omega"],
    "SIMPLE_RADIAL_FISHEYE": ["f", "cx", "cy", "k"],
    "RADIAL_FISHEYE": ["f", "cx", "cy", "k1", "k2"],
    "THIN_PRISM_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2",
                           "k3", "k4", "sx1", "sy1"],
    "SPHERE": ["f", "cx", "cy"],
}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        vals = dict(zip(PARAM_NAMES[self.model], self.params))
        if "f" in vals:
            vals.setdefault("fx", vals["f"])
            vals.setdefault("fy", vals["f"])
        K = np.eye(3)
        K[0, 0] = vals["fx"]
        K[1, 1] = vals["fy"]
        K[0, 2] = vals["cx"]
        K[1, 2] = vals["cy"]
        return K


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray

    @property
    def R(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q) -> np.ndarray:
    """(reference colmap2mvsnet_acm.py:172-178)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R) -> np.ndarray:
    """Inverse of qvec2rotmat (for writing synthetic COLMAP fixtures)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


# ---------------------------------------------------------------------------
# text readers (reference colmap2mvsnet_acm.py:73-143)
# ---------------------------------------------------------------------------

def read_cameras_text(path) -> dict[int, ColmapCamera]:
    cams = {}
    for ln in Path(path).read_text().splitlines():
        if not ln.strip() or ln.lstrip().startswith("#"):
            continue
        s = ln.split()
        cams[int(s[0])] = ColmapCamera(
            id=int(s[0]), model=s[1], width=int(s[2]), height=int(s[3]),
            params=np.array([float(v) for v in s[4:]]),
        )
    return cams


def read_images_text(path) -> dict[int, ColmapImage]:
    imgs = {}
    lines = [ln for ln in Path(path).read_text().splitlines()
             if ln.strip() and not ln.lstrip().startswith("#")]
    for meta, track in zip(lines[0::2], lines[1::2]):
        s = meta.split()
        t = track.split()
        imgs[int(s[0])] = ColmapImage(
            id=int(s[0]),
            qvec=np.array([float(v) for v in s[1:5]]),
            tvec=np.array([float(v) for v in s[5:8]]),
            camera_id=int(s[8]),
            name=s[9],
            xys=np.column_stack([
                [float(v) for v in t[0::3]], [float(v) for v in t[1::3]]
            ]) if t else np.zeros((0, 2)),
            point3D_ids=np.array([int(v) for v in t[2::3]], int),
        )
    return imgs


def read_points3D_text(path) -> dict[int, ColmapPoint3D]:
    pts = {}
    for ln in Path(path).read_text().splitlines():
        if not ln.strip() or ln.lstrip().startswith("#"):
            continue
        s = ln.split()
        pts[int(s[0])] = ColmapPoint3D(
            id=int(s[0]),
            xyz=np.array([float(v) for v in s[1:4]]),
            rgb=np.array([int(v) for v in s[4:7]]),
            error=float(s[7]),
            image_ids=np.array([int(v) for v in s[8::2]], int),
            point2D_idxs=np.array([int(v) for v in s[9::2]], int),
        )
    return pts


# ---------------------------------------------------------------------------
# binary readers (reference colmap2mvsnet_acm.py:83-156)
# ---------------------------------------------------------------------------

def _read(fid, nbytes, fmt):
    return struct.unpack("<" + fmt, fid.read(nbytes))


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, mid, w, h = _read(f, 24, "iiQQ")
            name, num = CAMERA_MODELS[mid]
            params = np.array(_read(f, 8 * num, "d" * num))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            vals = _read(f, 64, "idddddddi")
            iid = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cid = vals[8]
            name = b""
            while True:
                (c,) = _read(f, 1, "c")
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, 8, "Q")
            data = _read(f, 24 * npts, "ddq" * npts)
            xys = np.column_stack([data[0::3], data[1::3]]) if npts else np.zeros((0, 2))
            pids = np.array(data[2::3], int)
            imgs[iid] = ColmapImage(iid, qvec, tvec, cid, name.decode(), xys, pids)
    return imgs


def read_points3D_binary(path) -> dict[int, ColmapPoint3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            pid, x, y, z, r, g, b, err = _read(f, 43, "QdddBBBd")
            (length,) = _read(f, 8, "Q")
            track = _read(f, 8 * length, "ii" * length)
            pts[pid] = ColmapPoint3D(
                pid, np.array([x, y, z]), np.array([r, g, b]), err,
                np.array(track[0::2], int), np.array(track[1::2], int),
            )
    return pts


def read_model(sparse_dir, ext=".txt"):
    sparse_dir = Path(sparse_dir)
    if ext == ".txt":
        return (
            read_cameras_text(sparse_dir / "cameras.txt"),
            read_images_text(sparse_dir / "images.txt"),
            read_points3D_text(sparse_dir / "points3D.txt"),
        )
    return (
        read_cameras_binary(sparse_dir / "cameras.bin"),
        read_images_binary(sparse_dir / "images.bin"),
        read_points3D_binary(sparse_dir / "points3D.bin"),
    )
