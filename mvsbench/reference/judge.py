"""The comparison that decides ``correct``: every depth, normal and cost
map the window's calls wrote, against the scene's exact ground truth and
against the photometric cost the written planes really have.

The program is a randomised optimiser, so no second program can repeat its
answers pixel for pixel; what it guarantees is a depth and normal map of
the scene and, in the cost map, the photo-consistency of each pixel's
plane.  The reference works the truth out again for each map from the
camera the map was computed for (the configuration's camera, rescaled as
the pipeline rescales it), evaluates the written planes again with an
exact, unrectified, float64 NCC (``photo.py``), and judges the maps by the
worst call:

* ``err_med``: the largest per-map median relative depth error;
* ``bad_share``: the largest per-map share of pixels whose relative depth
  error exceeds ``tau``;
* ``normal_deg``: the largest per-map median angle between the written
  world normal and the true one, in degrees;
* ``cost_excess``: the largest per-map median, over ``COST_SAMPLES``
  pixels drawn from the seed, of the written cost less the exact top-k
  cost of the written plane (the program's cost is its own view-weighted
  mean, with the geometric term in a geometric pass);
* ``unchanged_share``: in a seeded pass, the largest per-map share of
  pixels whose written normal is the normal the call was seeded with (to
  ``UNCHANGED_DEG``): a pass that ran keeps few planes exactly;
* ``stale``: calls whose depth, normal or cost file was not rewritten by
  the call (the configuration's guarantee; exact, limit 0).

Pixels are a map's interior (``errors.interior``).  Imports nothing of the
program.
"""

from __future__ import annotations

from pathlib import Path

import torch

from mvsbench.reference import errors as E
from mvsbench.reference import photo as P
from mvsbench.reference import scene as S

NUMBERS = ("err_med", "bad_share", "normal_deg", "cost_excess",
           "unchanged_share", "stale")
COST_SAMPLES = 2048
UNCHANGED_DEG = 0.01


def _worse(a: float, b: float) -> float:
    """The larger of two readings; a NaN is the worst there is."""
    return float("nan") if a != a or b != b else max(a, b)


class Judge:
    """The reference of one run's scene: ``cams`` at the image files' size,
    ``sources[v]`` the source views of view ``v``, ``images`` the folder
    of the image files the program read."""

    def __init__(self, cams: list, sources: list, images: Path, tau: float,
                 seed: int, device):
        self.cams, self.sources, self.images = cams, sources, images
        self.tau, self.device = tau, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self._truth: dict = {}
        self._imgs: dict = {}

    def _cam(self, v: int, h: int, w: int) -> S.RingCamera:
        return self.cams[v].scaled(w, h)

    def truth(self, v: int, h: int, w: int):
        if (v, h, w) not in self._truth:
            _, d, n = S.render(self._cam(v, h, w), self.device)
            self._truth[(v, h, w)] = (d, n)
        return self._truth[(v, h, w)]

    def image(self, v: int, h: int, w: int):
        if (v, h, w) not in self._imgs:
            self._imgs[(v, h, w)] = P.load_gray(
                self.images / f"{v:08d}.jpg", w, h, self.device)
        return self._imgs[(v, h, w)]

    def map_numbers(self, v: int, depth, normal, cost,
                    seed_normal=None) -> dict:
        """Numbers of one written map of view ``v`` (numpy arrays), seeded
        with ``seed_normal`` where the pass starts from given fields."""
        h, w = depth.shape
        gt_d, gt_n = self.truth(v, h, w)
        cam = self._cam(v, h, w)
        rows, cols = E.interior(cam.model, h, w, float(cam.sphere[2]))
        d = torch.as_tensor(depth, device=self.device)
        rel = E.rel_errors(d[rows, cols], gt_d[rows, cols])
        out = {"err_med": E.median(rel),
               "bad_share": float((rel > self.tau).double().mean()),
               "rel": rel.to(torch.float32)}
        n = torch.as_tensor(normal, device=self.device)
        out["normal_deg"] = E.median(E.normal_angles_deg(
            n[rows, cols], gt_n[rows, cols]))
        # the written planes' exact cost at pixels drawn from the seed
        ys = torch.randint(rows.start, rows.stop, (COST_SAMPLES,),
                           generator=self.gen, device=self.device)
        xs = torch.randint(cols.start, cols.stop, (COST_SAMPLES,),
                           generator=self.gen, device=self.device)
        src = self.sources[v]
        exact = P.top_k_mean(P.plane_costs(
            cam, [self._cam(s, h, w) for s in src], self.image(v, h, w),
            [self.image(s, h, w) for s in src], xs.double(), ys.double(),
            d[ys, xs], n[ys, xs]))
        written = torch.as_tensor(cost, device=self.device)[ys, xs].double()
        out["cost_excess"] = E.median(written - exact)
        if seed_normal is not None:
            seed = torch.as_tensor(seed_normal, device=self.device)
            kept = E.normal_angles_deg(n[rows, cols], seed[rows, cols])
            out["unchanged_share"] = float(
                (kept < UNCHANGED_DEG).double().mean())
        return out

    def judge(self, calls: list) -> tuple:
        """(numbers, pooled relative errors): the compared numbers over
        the window's calls (each a dict with ``view``, ``depth``,
        ``normal``, ``cost``, ``seed_normal`` and ``fresh``) and, for
        ``depth_err_median``,
        the relative depth errors of every interior pixel of every map,
        float32."""
        worst = {}
        pooled = []
        for c in calls:
            if not c["fresh"]:
                continue
            m = self.map_numbers(c["view"], c["depth"], c["normal"],
                                 c["cost"], c.get("seed_normal"))
            pooled.append(m.pop("rel"))
            for k, val in m.items():
                worst[k] = _worse(worst.get(k, val), val)
        worst["stale"] = sum(0 if c["fresh"] else 1 for c in calls)
        pooled = (torch.cat(pooled) if pooled
                  else torch.empty(0, device=self.device))
        return worst, pooled


def verdict(numbers: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for every number the cell compares."""
    out = []
    for name in NUMBERS:
        lim = limits["limits"].get(name)
        if lim is None:
            continue
        v = numbers.get(name, float("nan"))
        out.append((name, v, lim, v == v and v <= lim))
    return out
