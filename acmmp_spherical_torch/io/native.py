"""ctypes bindings of the repository's native C++ host library
(``native/libacmmp_native.so``; counterpart of
acmmp_spherical_tpu/io/native.py).

The library is built with ``make -C native`` at first use, into a temporary
name that is then renamed, so processes that start together never load a
half-written file.  Every wrapper has a numpy fallback in its caller
(``io/dmb.py``, ``io/ply.py``, ``pipeline/prior.py``) with the same output,
used when the library cannot be built.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libacmmp_native.so"


def _build() -> bool:
    tmp = f"{_LIB_PATH.name}.tmp{os.getpid()}"
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR), f"TARGET={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(_NATIVE_DIR / tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


@functools.cache
def load() -> ctypes.CDLL | None:
    """The native library (built if necessary), or None if unavailable."""
    if not _LIB_PATH.exists() and not _build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32ptr = ctypes.POINTER(ctypes.c_int32)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.dmb_read_header.argtypes = [ctypes.c_char_p, i32ptr, i32ptr, i32ptr]
    lib.dmb_read_header.restype = ctypes.c_int
    lib.dmb_read_data.argtypes = [ctypes.c_char_p, f32p, i64]
    lib.dmb_read_data.restype = ctypes.c_int
    lib.dmb_write.argtypes = [ctypes.c_char_p, f32p, i32, i32, i32]
    lib.dmb_write.restype = ctypes.c_int
    lib.ply_write.argtypes = [ctypes.c_char_p, f32p, f32p, u8p, i64]
    lib.ply_write.restype = ctypes.c_int
    lib.support_points.argtypes = [f32p, i32, i32, i32, ctypes.c_float, i32p]
    lib.support_points.restype = i64
    return lib


def available() -> bool:
    return load() is not None


def dmb_write(path, array: np.ndarray) -> None:
    a = np.ascontiguousarray(array, np.float32)
    h, w = a.shape[:2]
    nb = 1 if a.ndim == 2 else a.shape[2]
    rc = load().dmb_write(str(path).encode(), a.reshape(-1), h, w, nb)
    if rc != 0:
        raise IOError(f"dmb_write({path}) failed rc={rc}")


def dmb_read(path) -> np.ndarray:
    lib = load()
    h, w, nb = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.dmb_read_header(str(path).encode(), ctypes.byref(h),
                             ctypes.byref(w), ctypes.byref(nb))
    if rc != 0:
        raise IOError(f"dmb_read_header({path}) failed rc={rc}")
    out = np.empty(h.value * w.value * nb.value, np.float32)
    rc = lib.dmb_read_data(str(path).encode(), out, out.size)
    if rc != 0:
        raise IOError(f"dmb_read_data({path}) failed rc={rc}")
    shape = ((h.value, w.value) if nb.value == 1
             else (h.value, w.value, nb.value))
    return out.reshape(shape)


def ply_write(path, points, normals, colors) -> None:
    p = np.ascontiguousarray(points, np.float32)
    n = np.ascontiguousarray(normals, np.float32)
    c = np.ascontiguousarray(np.clip(colors, 0, 255), np.uint8)
    rc = load().ply_write(str(path).encode(), p.reshape(-1), n.reshape(-1),
                          c.reshape(-1), len(p))
    if rc != 0:
        raise IOError(f"ply_write({path}) failed rc={rc}")


def support_points(cost: np.ndarray, cell: int, threshold: float) -> np.ndarray:
    c = np.ascontiguousarray(cost, np.float32)
    h, w = c.shape
    out = np.empty(2 * (-(-h // cell)) * (-(-w // cell)), np.int32)
    n = load().support_points(c.reshape(-1), h, w, cell, threshold, out)
    return out[: 2 * n].reshape(-1, 2).copy()
