"""COLMAP sparse reconstruction -> scene folder converter (the port's numpy
copy of acmmp_spherical_tpu/pipeline/convert.py; camera and pair files are
byte-identical to that package's).

Equivalent of the reference's ``colmap2mvsnet_acm.py`` (P1-P5 in SURVEY.md):
per-image depth ranges from sparse track depths, KD-tree candidate pairs,
shared-track + triangulation-angle pair scoring, ranked neighbour lists, and
the cams/ pair.txt images/ output layout consumed by the pipeline.

Differences from the reference: scoring is vectorised numpy instead of an
mp.Pool of per-pair workers, and images are converted with OpenCV only when
not already jpg (same behaviour, reference py:399-406).
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

import numpy as np

from acmmp_spherical_torch.io.scene import (
    load_image_color, write_camera_file, write_image, write_pair_file,
)
from acmmp_spherical_torch.pipeline.colmap import read_model
from acmmp_spherical_torch.utils.log import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class ConvertOptions:
    """(reference colmap2mvsnet_acm.py:411-430)."""

    model_ext: str = ".txt"
    max_d: int = 192
    interval_scale: float = 1.0
    theta0: float = 1.0       # min triangulation angle (deg)
    top_k: int = 20           # max neighbours kept per image
    min_shared: int = 10      # min shared tracks to keep a pair


def compute_depth_ranges(images, points3d, extrinsics, cams, opts: ConvertOptions):
    """Per-image (dmin, dint, dnum, dmax) from sparse track depths
    (reference compute_depth_ranges, py:183-217).

    SPHERE uses radial depth, pinhole z; dmin/dmax are the 20th/80th
    percentiles scaled by 0.75/1.25.  Images without positive-depth tracks are
    dropped (the reference crashes on them; we skip, matching its
    "robust skip" intent).
    """
    ranges = {}
    for i, img in images.items():
        model = cams[img.camera_id].model
        pids = img.point3D_ids
        pids = pids[pids >= 0]
        if len(pids) == 0:
            continue
        X = np.stack([points3d[p].xyz for p in pids if p in points3d])
        if len(X) == 0:
            continue
        E = extrinsics[i]
        Xc = X @ E[:3, :3].T + E[:3, 3]
        d = np.linalg.norm(Xc, axis=1) if model == "SPHERE" else Xc[:, 2]
        d = d[d > 0]
        if len(d) == 0:
            continue
        ds = np.sort(d)
        dmin = ds[int(len(ds) * 0.2)] * 0.75
        dmax = ds[int(len(ds) * 0.8)] * 1.25
        if opts.max_d == 0:
            # inverse-depth plane count (reference py:204-213): the number of
            # inverse-depth steps between dmin and dmax such that one step
            # moves the principal point by ~1 px.  ||P2-P1|| below is the
            # world-space distance spanned by a 1-px shift at depth dmin.
            K = cams[img.camera_id].K
            Rw = E[:3, :3]
            p1 = np.array([K[0, 2], K[1, 2], 1.0])
            p2 = p1 + np.array([1.0, 0.0, 0.0])
            P1 = Rw.T @ (np.linalg.inv(K) @ p1 * dmin - E[:3, 3])
            P2 = Rw.T @ (np.linalg.inv(K) @ p2 * dmin - E[:3, 3])
            dnum = int(
                (1.0 / dmin - 1.0 / dmax)
                / (1.0 / dmin - 1.0 / (dmin + np.linalg.norm(P2 - P1)))
            )
            dnum = max(dnum, 2)  # guard the dint division (robustness fix)
        else:
            dnum = opts.max_d
        dint = (dmax - dmin) / (dnum - 1) / opts.interval_scale
        ranges[i] = (dmin, dint, dnum, dmax)
    return ranges


def _pair_score(img_i, img_j, points3d, ci, cj, theta0):
    """Shared-track count, zeroed when the 75th-percentile triangulation angle
    is below theta0 (reference calc_score, py:232-244)."""
    shared = set(img_i.point3D_ids[img_i.point3D_ids >= 0]) & set(
        img_j.point3D_ids[img_j.point3D_ids >= 0]
    )
    shared = [p for p in shared if p in points3d]
    if not shared:
        return 0.0
    P = np.stack([points3d[p].xyz for p in shared])
    vi = ci[None] - P
    vj = cj[None] - P
    cosang = np.sum(vi * vj, axis=1) / (
        np.linalg.norm(vi, axis=1) * np.linalg.norm(vj, axis=1) + 1e-30
    )
    angs = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
    if np.percentile(angs, 75) < theta0:
        return 0.0
    return float(len(shared))


def convert_colmap_scene(
    dense_folder, save_folder, opts: ConvertOptions = ConvertOptions()
) -> None:
    """Full conversion (reference process_scene, py:249-406)."""
    dense = Path(dense_folder)
    save = Path(save_folder)
    (save / "images").mkdir(parents=True, exist_ok=True)
    (save / "cams").mkdir(parents=True, exist_ok=True)

    cams, imgs_raw, pts = read_model(dense / "sparse", opts.model_ext)
    # renumber images densely by sorted original id (reference py:260)
    imgs = {i + 1: imgs_raw[k] for i, k in enumerate(sorted(imgs_raw))}
    N = len(imgs)
    log.info("converting %d images, %d points", N, len(pts))

    extr = {}
    for i, img in imgs.items():
        E = np.eye(4)
        E[:3, :3] = img.R
        E[:3, 3] = img.tvec
        extr[i] = E

    ranges = compute_depth_ranges(imgs, pts, extr, cams, opts)

    # candidate pairs by camera-centre proximity (reference py:302-330)
    from scipy.spatial import cKDTree

    keys = sorted(ranges.keys())
    centers = np.stack([-(extr[i][:3, :3].T @ extr[i][:3, 3]) for i in keys])
    tree = cKDTree(centers)
    k_search = min(opts.top_k + 1, len(keys))
    _, nnidx = tree.query(centers, k=k_search)
    nnidx = np.atleast_2d(nnidx)
    candidate_pairs = set()
    for src_idx, neighs in enumerate(nnidx):
        src = keys[src_idx] - 1
        for nb in np.atleast_1d(neighs):
            if nb == src_idx:
                continue
            dst = keys[int(nb)] - 1
            candidate_pairs.add((min(src, dst), max(src, dst)))

    # shared-track filter with per-image top_k budget (reference py:331-346)
    def shared_count(pair):
        i, j = pair
        a = imgs[i + 1].point3D_ids
        b = imgs[j + 1].point3D_ids
        return len(set(a[a >= 0]) & set(b[b >= 0]))

    all_pairs = list(candidate_pairs)
    counts = [shared_count(p) for p in all_pairs]
    top_pairs = []
    bins = {i - 1: 0 for i in ranges.keys()}
    for pair, c in sorted(zip(all_pairs, counts), key=lambda x: x[1], reverse=True):
        if c < opts.min_shared:
            break
        i, j = pair
        if bins[i] < opts.top_k and bins[j] < opts.top_k:
            bins[i] += 1
            bins[j] += 1
            top_pairs.append(pair)
    log.info("kept %d pairs (<=%d per image, >=%d shared)", len(top_pairs),
             opts.top_k, opts.min_shared)

    # triangulation-angle scoring (reference py:348-356)
    score = np.zeros((N, N))
    for i, j in top_pairs:
        ci = -(extr[i + 1][:3, :3].T @ extr[i + 1][:3, 3])
        cj = -(extr[j + 1][:3, :3].T @ extr[j + 1][:3, 3])
        s = _pair_score(imgs[i + 1], imgs[j + 1], pts, ci, cj, opts.theta0)
        score[i, j] = score[j, i] = s

    # ranked neighbour lists (reference py:358-363)
    view_sel = []
    for i in range(N):
        top = np.argsort(score[i])[::-1]
        view_sel.append([(int(k), float(score[i, k])) for k in top
                         if score[i, k] > 0][: opts.top_k])

    # camera files (reference py:365-388)
    for i in range(N):
        if (i + 1) not in ranges:
            continue
        cam = cams[imgs[i + 1].camera_id]
        d0, dint, nd, dmax = ranges[i + 1]
        kwargs = dict(depth_min=d0, depth_max=dmax, depth_interval=dint,
                      num_planes=nd)
        if cam.model == "SPHERE":
            write_camera_file(
                save / "cams" / f"{i:08d}_cam.txt", "sphere",
                extr[i + 1][:3, :3], extr[i + 1][:3, 3],
                sphere_params=cam.params[:3], **kwargs)
        else:
            write_camera_file(
                save / "cams" / f"{i:08d}_cam.txt", "pinhole",
                extr[i + 1][:3, :3], extr[i + 1][:3, 3], K=cam.K, **kwargs)

    write_pair_file(save / "pair.txt", view_sel)

    # images (reference py:399-406)
    img_dir = dense / "images"
    for i in range(N):
        src = img_dir / imgs[i + 1].name
        dst = save / "images" / f"{i:08d}.jpg"
        if not src.exists():
            log.warning("missing image %s", src)
            continue
        if src.suffix.lower() != ".jpg":
            write_image(dst, load_image_color(src))
        else:
            shutil.copyfile(src, dst)
