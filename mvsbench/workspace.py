"""The scene workspace a run drives: the configuration's ring rendered from
the seed and written in the pipeline's on-disk layout (``images/%08d.jpg``
at JPEG quality 98, ``cams/%08d_cam.txt``, ``pair.txt`` in which every view
takes every other), and, for a mix that starts from earlier passes, the
seed and source fields those passes would have written.

Everything here is the benchmark's: the program only reads what it writes.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

from mvsbench.reference import scene as S

RESULT_DIR = "ACMMP/2333_{:08d}"   # the pipeline's per-view result folder


def config_cameras(config: dict) -> list:
    """The configuration's ring at the size of its image files."""
    ring = config["ring"]
    return S.ring_cameras(config["views"], model=config["camera"],
                          width=config["width"], height=config["height"],
                          focal=ring.get("focal", 0.0),
                          radius=ring["radius"])


def scaled_size(width: int, height: int, max_size: int) -> tuple[int, int]:
    """(w, h) of an image after the pipeline's downscale to ``max_size``
    (ACMMP.cpp:605-643)."""
    if width > max_size or height > max_size:
        f = min(max_size / width, max_size / height)
        return round(width * f), round(height * f)
    return width, height


def write_camera(path: Path, cam: S.RingCamera) -> None:
    """A cam.txt in the converter's format (colmap2mvsnet_acm.py:365-388)."""
    E = np.eye(4)
    E[:3, :3] = cam.R
    E[:3, 3] = cam.t
    lines = ["extrinsic"]
    lines += [" ".join(repr(float(v)) for v in E[r]) for r in range(4)]
    lines += ["", "intrinsic"]
    if cam.model == "sphere":
        lines += ["SPHERE", " ".join(repr(float(v)) for v in cam.sphere)]
    else:
        lines += [" ".join(repr(float(v)) for v in cam.K[r])
                  for r in range(3)]
    dint = (cam.depth_max - cam.depth_min) / 191
    lines += ["", f"{cam.depth_min} {dint} 192 {cam.depth_max}"]
    path.write_text("\n".join(lines) + "\n")


def write_dmb(path: Path, array: np.ndarray) -> None:
    """A ``.dmb`` raster: int32 header (1, h, w, channels), float32 data."""
    a = np.ascontiguousarray(array, np.float32)
    nb = 1 if a.ndim == 2 else a.shape[2]
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, a.shape[0], a.shape[1], nb))
        f.write(a.tobytes())


def read_dmb(path: Path) -> np.ndarray:
    """A ``.dmb`` raster as float32 (h, w) or (h, w, channels)."""
    raw = np.fromfile(path, np.uint8)
    kind, h, w, nb = struct.unpack_from("<iiii", raw.tobytes()[:16])
    if kind != 1 or raw.size != 16 + 4 * h * w * nb:
        raise ValueError(f"{path}: not a float32 dmb of its header's size")
    data = raw[16:].view(np.float32)
    return data.reshape(h, w) if nb == 1 else data.reshape(h, w, nb)


def write_scene(root: Path, config: dict, device) -> tuple:
    """Render the ring on ``device`` and write it under ``root``; returns
    (cameras, the source views of each view)."""
    import cv2

    cams = config_cameras(config)
    (root / "images").mkdir(parents=True)
    (root / "cams").mkdir()
    for i, cam in enumerate(cams):
        img, _, _ = S.render(cam, device, image=True)
        img = img.to(torch.float32).clamp(0, 255).to(torch.uint8).cpu()
        if not cv2.imwrite(str(root / "images" / f"{i:08d}.jpg"),
                           img.numpy(), [cv2.IMWRITE_JPEG_QUALITY, 98]):
            raise IOError(f"writing image {i} failed")
        write_camera(root / "cams" / f"{i:08d}_cam.txt", cam)
    n = len(cams)
    sources = [[j for j in range(n) if j != i][: config["sources_per_view"]]
               for i in range(n)]
    with open(root / "pair.txt", "w") as f:
        f.write(f"{n}\n")
        for i, src in enumerate(sources):
            f.write(f"{i}\n{len(src)} " + "".join(f"{j} 100 " for j in src)
                    + "\n")
    return cams, sources


def write_seed_fields(root: Path, cams: list, max_size: int, spec: dict,
                      seed: int, device) -> None:
    """The fields a geometric pass starts from, as the passes before it
    would have left them at the scale of ``max_size``: ``depths.dmb`` and
    ``depths_geom.dmb`` the true depth times ``1 + p u`` (``u`` uniform in
    [-1, 1], drawn from the seed, a fresh draw per file; ``p`` is
    ``depth_perturbation``) and ``normals.dmb`` the true world normals."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p = spec["depth_perturbation"]
    for i, cam in enumerate(cams):
        w, h = scaled_size(cam.width, cam.height, max_size)
        _, depth, normal = S.render(cam.scaled(w, h), device)
        out = root / RESULT_DIR.format(i)
        out.mkdir(parents=True, exist_ok=True)
        for name in ("depths.dmb", "depths_geom.dmb"):
            u = torch.rand(depth.shape, generator=gen, device=device,
                           dtype=torch.float64) * 2.0 - 1.0
            write_dmb(out / name, (depth * (1.0 + p * u)).cpu().numpy())
        write_dmb(out / "normals.dmb", normal.cpu().numpy())

