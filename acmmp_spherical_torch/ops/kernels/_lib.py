"""Build, load and count the CUDA kernels of ``acmmp_spherical_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per
source, all started together) and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The build runs at first use, into
``acmmp_spherical_torch/_build/<hash>/`` keyed by a hash of the sources and
flags, so a checkout builds everything it needs from its own files.  Every C
entry point returns ``cudaGetLastError()`` after its launch.

``LAUNCHES`` counts kernel launches per wrapper (and nothing else): a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"rect_ncc": 0, "rect_ncc_geom": 0, "warp_transport": 0,
            "warp_src_frames": 0, "warp_src_disparities": 0,
            "ncc_window": 0, "ncc_window_geom": 0, "window_sample": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "acmmp_rect_ncc": [_P] * 9 + [_I] * 8 + [_F] * 3 + [_D, _P],
    "acmmp_rect_ncc_geom": [_P] * 11 + [_I] * 8 + [_F] * 4 + [_D, _P],
    "acmmp_warp_transport": [_P] * 12 + [_I] * 4 + [_P],
    "acmmp_warp_src_frames": [_P] * 3 + [_I] * 8 + [_P],
    "acmmp_warp_src_disparities": [_P] * 3 + [_I] * 8 + [_P],
    "acmmp_ncc_window": [_P] * 12 + [_I] * 7 + [_F, _P],
    "acmmp_ncc_window_geom": [_P] * 14 + [_I] * 7 + [_F] * 2 + [_P],
    "acmmp_window_sample": [_P] * 5 + [_I] * 5 + [_F] * 2 + [_P],
}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build() -> pathlib.Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libacmmp_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_dir = pathlib.Path(tempfile.mkdtemp(dir=out_dir))
    nvcc = _nvcc()
    objs = [tmp_dir / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    logs = []
    for src, proc in zip(sources, procs):
        out, err = proc.communicate()
        logs.append(f"== {src.name}\n{out}{err}")
        if proc.returncode != 0:
            for other in procs:
                other.wait()
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{err}")
    tmp = tmp_dir / lib_path.name
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *[str(o) for o in objs]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, lib_path)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    (out_dir / "ptxas.log").write_text("".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (``ptxas.log`` beside it holds
    each kernel's registers and spills)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.acmmp_error_string.argtypes = [ctypes.c_int]
        lib.acmmp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().acmmp_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
