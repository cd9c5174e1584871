"""Binary PLY point clouds (counterpart of acmmp_spherical_tpu/io/ply.py):
the reference's vertex layout (ACMMP.cpp:481-534), little-endian
``x y z nx ny nz`` float32 and ``red green blue`` uint8, in true RGB (the
reference swaps red and blue between fusion and its writer).
"""

from __future__ import annotations

import numpy as np

from acmmp_spherical_torch.io import native

_DTYPE = np.dtype([
    ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
    ("red", "u1"), ("green", "u1"), ("blue", "u1"),
])


def write_ply_numpy(path, points: np.ndarray, normals: np.ndarray,
                    colors: np.ndarray) -> None:
    """The numpy writer, used when the native library is unavailable."""
    n = len(points)
    points = np.asarray(points, np.float32)
    points = np.where(np.isfinite(points), points, 0.0)
    rec = np.empty(n, _DTYPE)
    rec["x"], rec["y"], rec["z"] = points.T
    rec["nx"], rec["ny"], rec["nz"] = np.asarray(normals, np.float32).T
    col = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = col.T
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def write_ply(path, points: np.ndarray, normals: np.ndarray,
              colors: np.ndarray) -> None:
    """Write a coloured point cloud with normals: ``points``/``normals``
    (N, 3) float, ``colors`` (N, 3) RGB in 0..255.  Non-finite coordinates
    are zeroed like the reference (ACMMP.cpp:514-518)."""
    if native.available():
        native.ply_write(path, points, normals, colors)
    else:
        write_ply_numpy(path, points, normals, colors)


def read_ply(path):
    """Read a PLY written by :func:`write_ply` -> (points, normals, colors)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PLY header")
            header += line
        n = None
        for ln in header.decode("ascii").splitlines():
            if ln.startswith("element vertex"):
                n = int(ln.split()[-1])
        if n is None:
            raise ValueError(f"{path}: no vertex element")
        rec = np.frombuffer(f.read(n * _DTYPE.itemsize), _DTYPE)
    points = np.stack([rec["x"], rec["y"], rec["z"]], -1)
    normals = np.stack([rec["nx"], rec["ny"], rec["nz"]], -1)
    colors = np.stack([rec["red"], rec["green"], rec["blue"]], -1)
    return points, normals, colors
