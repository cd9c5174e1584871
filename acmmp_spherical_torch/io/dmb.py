"""The ``.dmb`` binary raster format (counterpart of
acmmp_spherical_tpu/io/dmb.py), byte-compatible with the reference codec
(ACMMP.cpp:363-479): a little-endian header of four int32s
``(type=1, h, w, nb)``, then ``h*w*nb`` float32s, row-major,
channel-interleaved.  These files carry every pass's results to the next
pass and are the pipeline's checkpoints.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from acmmp_spherical_torch.io import native

_HEADER = struct.Struct("<iiii")
_DMB_TYPE_FLOAT = 1


def read_dmb_numpy(path: str | os.PathLike) -> np.ndarray:
    """The numpy reader, used when the native library is unavailable."""
    with open(path, "rb") as f:
        raw = f.read()
    dtype_tag, h, w, nb = _HEADER.unpack_from(raw, 0)
    if dtype_tag != _DMB_TYPE_FLOAT:
        raise ValueError(f"{path}: unsupported dmb type {dtype_tag}")
    data = np.frombuffer(raw, np.float32, count=h * w * nb,
                         offset=_HEADER.size)
    return data.reshape(h, w) if nb == 1 else data.reshape(h, w, nb)


def write_dmb_numpy(path: str | os.PathLike, array: np.ndarray) -> None:
    """The numpy writer, used when the native library is unavailable."""
    array = np.ascontiguousarray(array, np.float32)
    if array.ndim not in (2, 3):
        raise ValueError(f"dmb arrays must be 2D or 3D, got {array.shape}")
    h, w = array.shape[:2]
    nb = 1 if array.ndim == 2 else array.shape[2]
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_DMB_TYPE_FLOAT, h, w, nb))
        f.write(array.tobytes())


def read_dmb(path: str | os.PathLike) -> np.ndarray:
    """Read a .dmb file -> (h, w) or (h, w, nb) float32 array."""
    if native.available():
        return native.dmb_read(path)
    return read_dmb_numpy(path)


def write_dmb(path: str | os.PathLike, array: np.ndarray) -> None:
    """Write an (h, w) or (h, w, nb) float32 array as .dmb."""
    array = np.ascontiguousarray(array, np.float32)
    if array.ndim in (2, 3) and native.available():
        native.dmb_write(path, array)
    else:
        write_dmb_numpy(path, array)


def read_depth_dmb(path) -> np.ndarray:
    a = read_dmb(path)
    if a.ndim != 2:
        raise ValueError(
            f"{path}: expected single-channel depth, got {a.shape}")
    return a


def read_normal_dmb(path) -> np.ndarray:
    a = read_dmb(path)
    if a.ndim != 3 or a.shape[-1] != 3:
        raise ValueError(f"{path}: expected 3-channel normals, got {a.shape}")
    return a
