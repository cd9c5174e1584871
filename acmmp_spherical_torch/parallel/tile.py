"""Intra-image tile parallelism (counterpart of
acmmp_spherical_tpu/parallel/tile.py).

For frames whose working set is too large for one device, one depth map is
cut along its width into tiles, one per slot of a mesh.  The JAX package
pins the plane state to a width sharding and lets GSPMD write the halo
exchange; PyTorch runs eagerly, so here the exchange is explicit.  The full
plane state (about 32 B per pixel) lives on the lead slot; before each
half-step every slot receives its core columns and a halo of ``HALO``
columns on each side, runs the half-step on them
(``propagate.checkerboard_halfstep(tile=)``) and returns its core, and the
lead joins the cores.  Pinhole halos stop at the image edges; SPHERE halos
wrap around the longitude ring, so the last tile feeds the first.  The
heavy per-pass memory -- the reference tap context and the NCC temporaries
-- is each slot's own tile.  Images, cameras and source depths are
replicated on every slot: the taps and the source samples read frame
coordinates.

A tile's pixels keep their frame coordinates and draw their columns of the
frame's random numbers (``rng.Cols``), so the tiled pass computes what the
one-slot pass computes, pixel by pixel.  Only the exact path is tiled:
the windowed and rectified kernels are built for whole frames, and the
sharder raises on them (the pipeline's ``--tile-shard`` mode forces the
exact path, as the JAX package's does).

``tile_parallel_pass`` is the single-problem analogue of
``view_parallel.multichip_step``; ``make_state_sharder`` is the hook of
``pipeline.patchmatch.run_patchmatch(shard_state=)``.  The slots run in
turn in the calling thread (``mesh.run_slots(threads=False)``), on one
device or several: the exact path makes thousands of small launches per
cost field and syncs the host after each field, and slot threads only
queued behind each other at the interpreter lock.  The 1024x768x8src photometric pass
took 30.2 s over 2 slots of one H100 and 76.6 s over 3 in threads, against
12.7 s and 15.1 s in turn and 6.6 s on one slot; in threads over 2, 3 and
4 H100s 26.5 s, 70.4 s and 158.8 s against 6.3 s on one slot
(``scripts/time_tile_slots.py``, NVIDIA H100 80GB HBM3, 700 W).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core.camera import SPHERE
from acmmp_spherical_torch.core.plane import PlaneState
from acmmp_spherical_torch.ops import rng as R
from acmmp_spherical_torch.ops.ncc import ref_tap_context
from acmmp_spherical_torch.ops.propagate import (
    PatchMatchInputs, Tile, check_exact_path, checkerboard_halfstep,
    extract_depth_and_normal, initialize_state,
)
from acmmp_spherical_torch.parallel.mesh import ViewMesh, run_slots, tree_map
from acmmp_spherical_torch.utils.log import get_logger

log = get_logger(__name__)

# halo columns on each side of a tile: the far candidate strips reach 23
# columns (ops/candidates.py), so a core pixel never reads past the halo
HALO = 24


def make_tile_mesh(n: int, *, devices: Optional[Sequence] = None
                   ) -> ViewMesh:
    """``n`` tile slots over ``devices`` (default: every local CUDA device,
    which must exist).  Where there are fewer devices than slots, the slots
    take the devices round-robin (the JAX package asserts ``n`` devices):
    on a host with one GPU, ``n`` slots of that card."""
    if n < 1:
        raise ValueError(f"make_tile_mesh: {n} slots")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_tile_mesh: no CUDA device (pass devices="
                               "[torch.device('cpu')] for CPU slots)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_tile_mesh: no devices")
    slots = tuple(devices[i % len(devices)] for i in range(n))
    log.info("tile mesh: %d slots on %s", n, [str(d) for d in slots])
    return ViewMesh(devices=slots)


def tile_bounds(width: int, n: int) -> list:
    """The core columns ``[(x0, x1), ...]`` of ``n`` contiguous width tiles:
    column pairs split as ``np.array_split`` does (the first tiles take the
    remainder), so every edge is even; an odd frame's last column goes to
    the last tile."""
    if width // 2 < n:
        raise ValueError(f"a frame {width} columns wide has no {n} tiles of "
                         "at least two columns")
    pairs = np.cumsum([0] + [len(a) for a in
                             np.array_split(np.arange(width // 2), n)])
    edges = [2 * int(p) for p in pairs]
    edges[-1] = width
    return list(zip(edges[:-1], edges[1:]))


def _halo_tiles(width: int, n: int, sphere: bool):
    """Per tile: its ``Tile`` (``lo`` halo columns before the core) and the
    frame columns of its core with halos, in order (int64 numpy)."""
    out = []
    for x0, x1 in tile_bounds(width, n):
        if sphere:
            lo, cols = HALO, np.arange(x0 - HALO, x1 + HALO) % width
        else:
            a, b = max(0, x0 - HALO), min(width, x1 + HALO)
            lo, cols = x0 - a, np.arange(a, b)
        out.append((Tile(x0, x1, width, lo), cols))
    return out


def _columns(a: torch.Tensor, cols, axis: int) -> torch.Tensor:
    """The columns ``cols`` (a slice or an index tensor) of ``a`` on its
    axis ``axis``."""
    if isinstance(cols, slice):
        return a[(slice(None),) * (a.dim() + axis) + (cols,)]
    return a.index_select(a.dim() + axis, cols)


def _cut_state(state: PlaneState, cols) -> PlaneState:
    """The columns ``cols`` of every field of ``state``."""
    return PlaneState(normal=_columns(state.normal, cols, -2),
                      w=_columns(state.w, cols, -1),
                      cost=_columns(state.cost, cols, -1),
                      selected=_columns(state.selected, cols, -1),
                      pre_cost=_columns(state.pre_cost, cols, -1))


def _join_states(parts: Sequence[PlaneState], device) -> PlaneState:
    cat = lambda name, axis: torch.cat(
        [getattr(p, name).to(device) for p in parts], axis)
    return PlaneState(normal=cat("normal", -2), w=cat("w", -1),
                      cost=cat("cost", -1), selected=cat("selected", -1),
                      pre_cost=cat("pre_cost", -1))


class TiledPass:
    """One pass of one problem over the slots of a mesh: ``initialize``,
    ``halfstep`` and ``extract`` mirror ``propagate.initialize_state``,
    ``checkerboard_halfstep`` and ``extract_depth_and_normal`` on the full
    frame, and take and return full-frame fields on the lead slot
    (``mesh.devices[0]``)."""

    def __init__(self, mesh: ViewMesh, inputs: PatchMatchInputs,
                 params: PatchMatchParams):
        check_exact_path(params)
        self.mesh, self.params = mesh, params
        self.lead = mesh.devices[0]
        tiles = _halo_tiles(inputs.ref_image.shape[1], mesh.size,
                            inputs.ref_cam.model == SPHERE)
        self.tiles = [t for t, _ in tiles]
        self.halo_cols = [torch.as_tensor(c, device=self.lead)
                          for _, c in tiles]
        # images, cameras and source depths on every slot; the planar-prior
        # fields cut to each core
        self.inputs = []
        for dev, tile in zip(mesh.devices, self.tiles):
            core = slice(tile.x0, tile.x1)
            moved = tree_map(lambda t: t.to(dev), inputs)
            if params.planar_prior:
                moved = dataclasses.replace(
                    moved, prior_normal=moved.prior_normal[:, core],
                    prior_w=moved.prior_w[:, core],
                    prior_mask=moved.prior_mask[:, core])
            self.inputs.append(moved)
        self.ctx = [None] * mesh.size

    def _run(self, fn, items) -> list:
        return run_slots(self.mesh, fn, items, threads=False)

    def _cores(self, fields: dict) -> list:
        """Per slot, the core columns of each full-frame field of
        ``fields`` (a ``PlaneState``, an (H, W, 3) or an (H, W) tensor, or
        None), on the slot's device."""
        out = []
        for dev, tile in zip(self.mesh.devices, self.tiles):
            core = slice(tile.x0, tile.x1)

            def cut(v):
                if v is None:
                    return None
                v = (_cut_state(v, core) if isinstance(v, PlaneState)
                     else _columns(v, core, -2 if v.dim() == 3 else -1))
                return tree_map(lambda t: t.to(dev), v)

            out.append({k: cut(v) for k, v in fields.items()})
        return out

    def initialize(self, key, *, prev_state: Optional[PlaneState] = None,
                   seed_normal_world=None, seed_depth=None) -> PlaneState:
        """``initialize_state`` on every tile; builds each slot's tap
        context on its core."""
        fields = self._cores(dict(prev_state=prev_state,
                                  seed_normal_world=seed_normal_world,
                                  seed_depth=seed_depth))

        def init(slot, kw):
            inputs, tile = self.inputs[slot], self.tiles[slot]
            if self.ctx[slot] is None:
                self.ctx[slot] = ref_tap_context(
                    inputs.ref_image, inputs.ref_cam, self.params,
                    x0=tile.x0, x1=tile.x1)
            return initialize_state(inputs, self.params, key,
                                    ctx=self.ctx[slot], tile=tile, **kw)

        return _join_states(self._run(init, fields), self.lead)

    def halfstep(self, state: PlaneState, params: PatchMatchParams, key,
                 iteration: int, parity: int) -> PlaneState:
        """``checkerboard_halfstep`` on every tile: each slot gets its core
        and halos of ``state`` and returns its core."""
        check_exact_path(params)
        state = tree_map(lambda t: t.to(self.lead), state)

        def step(slot, cols):
            dev = self.mesh.devices[slot]
            ext = tree_map(lambda t: t.to(dev), _cut_state(state, cols))
            return checkerboard_halfstep(
                ext, self.inputs[slot], params, key, iteration, parity,
                ctx=self.ctx[slot], tile=self.tiles[slot])

        return _join_states(self._run(step, self.halo_cols),
                            self.lead)

    def extract(self, state: PlaneState):
        """``extract_depth_and_normal`` on every tile: (depth (H, W),
        world normal (H, W, 3)) on the lead slot."""
        parts = self._cores(dict(state=state))

        def ex(slot, kw):
            return extract_depth_and_normal(
                kw["state"], self.inputs[slot].ref_cam,
                x0=self.tiles[slot].x0)

        outs = self._run(ex, parts)
        return (torch.cat([d.to(self.lead) for d, _ in outs], -1),
                torch.cat([n.to(self.lead) for _, n in outs], -2))


def make_state_sharder(mesh: ViewMesh):
    """The width-tiling hook of ``run_patchmatch(shard_state=)`` over
    ``mesh``'s slots (the pipeline's ``--tile-shard`` mode):
    ``sharder(inputs, params)`` starts a ``TiledPass`` of one problem, and
    raises ``ValueError`` on params that select the windowed or rectified
    path."""
    return functools.partial(TiledPass, mesh)


def tile_parallel_pass(mesh: ViewMesh, params: PatchMatchParams,
                       n_iterations: int = 1):
    """A photometric pass with the plane state cut into width tiles over
    ``mesh``: ``run(inputs, key)`` returns (depth (H, W), world normal
    (H, W, 3), cost (H, W)) on the lead slot.  The JAX function's key
    schedule: the init draws from ``key``, iteration ``i`` splits
    ``fold_in(key, i + 1)`` into its two half-step keys; no median
    filter."""
    check_exact_path(params)
    sharder = make_state_sharder(mesh)

    def run(inputs: PatchMatchInputs, key):
        if isinstance(key, int):
            key = R.key(key)
        tiled = sharder(inputs, params)
        state = tiled.initialize(key)
        for i in range(n_iterations):
            k0, k1 = R.split(R.fold_in(key, i + 1))
            state = tiled.halfstep(state, params, k0, i, 0)
            state = tiled.halfstep(state, params, k1, i, 1)
        depth, normal = tiled.extract(state)
        return depth, normal, state.cost

    return run
