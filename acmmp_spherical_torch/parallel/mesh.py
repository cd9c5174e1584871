"""Device slots for multi-problem runs (counterpart of
acmmp_spherical_tpu/parallel/mesh.py).

The JAX package names a 1D ``view`` mesh of devices and lets XLA partition
one batched program over it.  PyTorch runs eagerly, so a mesh here is an
ordered list of device slots, and ``run_slots`` drives each slot from a
host thread of its own, under its device and on a CUDA stream of its own.
A device may fill several slots: three slots of one GPU keep three problems
in flight on it, and slots of the CPU stand for the JAX tests' virtual
devices.  ``make_view_tile_mesh`` lays slots out as problems x width
tiles (``parallel/tile.py`` runs one problem's tiles over a row).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

_SLOT = threading.local()


@dataclasses.dataclass(frozen=True)
class ViewMesh:
    """Ordered device slots; a device may repeat."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_view_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> ViewMesh:
    """A mesh over ``devices`` (default: every local CUDA device, which
    must exist), cut to the first ``n_devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_view_mesh: no CUDA device (pass devices="
                               "[torch.device('cpu')] * n for CPU slots)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_view_mesh: no device slots")
    return ViewMesh(devices=tuple(devices))


@dataclasses.dataclass(frozen=True)
class ViewTileMesh:
    """Slots in a grid of problems x width tiles: ``devices[v][t]`` is the
    slot of tile ``t`` of problem slot ``v``; a device may repeat."""

    devices: tuple

    @property
    def shape(self) -> tuple:
        return len(self.devices), len(self.devices[0])

    def tile_mesh(self, v: int) -> ViewMesh:
        """The tile slots of problem slot ``v``, for ``parallel/tile``."""
        return ViewMesh(devices=tuple(self.devices[v]))


def make_view_tile_mesh(n_view: int, n_tile: int,
                        devices: Optional[Sequence] = None) -> ViewTileMesh:
    """An ``n_view`` x ``n_tile`` grid of slots over ``devices`` (default:
    every local CUDA device, which must exist), filled row by row; where
    there are fewer devices than slots they repeat round-robin."""
    devs = make_view_mesh(devices=devices).devices
    flat = [devs[i % len(devs)] for i in range(n_view * n_tile)]
    return ViewTileMesh(devices=tuple(
        tuple(flat[v * n_tile:(v + 1) * n_tile]) for v in range(n_view)))


def tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a tree of dataclasses, NamedTuples,
    tuples, lists and dicts; other leaves are kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch_over_views(mesh: ViewMesh, batch) -> list:
    """Split the leading (problem) axis of every tensor of ``batch`` into
    ``mesh.size`` contiguous blocks (the first ``B % size`` one longer) and
    put block ``i`` on ``mesh.devices[i]``; with ``B == mesh.size`` slot
    ``i`` holds problem ``i``."""
    sizes = []
    tree_map(lambda t: sizes.append(t.shape[0]) or t, batch)
    B = sizes[0]
    if B < mesh.size:
        raise ValueError(f"a batch of {B} problems over {mesh.size} slots")
    bounds = np.cumsum([0] + [len(a) for a in
                              np.array_split(np.arange(B), mesh.size)])
    return [tree_map(lambda t: t[lo:hi].to(dev), batch)
            for dev, lo, hi in zip(mesh.devices, bounds[:-1], bounds[1:])]


def slot_streams(mesh: ViewMesh) -> list:
    """One CUDA stream per slot (None for a CPU slot)."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in mesh.devices]


def current_slot() -> Optional[int]:
    """The slot index of the calling ``run_slots`` thread, else None."""
    return getattr(_SLOT, "index", None)


@contextlib.contextmanager
def slot_context(device: torch.device, stream=None):
    """``device`` (and ``stream``) current for the calling thread."""
    with contextlib.ExitStack() as stack:
        if device.type == "cuda":
            stack.enter_context(torch.cuda.device(device))
            if stream is not None:
                stack.enter_context(torch.cuda.stream(stream))
        yield


def run_slots(mesh: ViewMesh, fn: Callable, items: Sequence,
              streams: Optional[Sequence] = None, *,
              threads: bool = True) -> list:
    """``fn(slot, items[slot])`` for each item, item ``i`` on slot ``i``,
    each in a thread of its own under the slot's device and stream (from
    ``streams``, or the device's current one); a slot's stream is
    synchronised before its thread ends, so the results are complete on
    return.  Returns the results in slot order; raises the first slot's
    exception once every thread has ended.  ``threads=False`` runs the
    slots one after the other in the calling thread, with the same slot
    index and context."""
    if len(items) > mesh.size:
        raise ValueError(f"{len(items)} items over {mesh.size} slots")
    results: list = [None] * len(items)
    errors: list = [None] * len(items)

    def run(i):
        _SLOT.index = i
        dev = mesh.devices[i]
        stream = None if streams is None else streams[i]
        try:
            with slot_context(dev, stream):
                results[i] = fn(i, items[i])
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
        except BaseException as e:  # re-raised in the caller below
            errors[i] = e
        finally:
            _SLOT.index = None

    if threads:
        started = [threading.Thread(target=run, args=(i,), name=f"slot-{i}")
                   for i in range(len(items))]
        for t in started:
            t.start()
        for t in started:
            t.join()
    else:
        for i in range(len(items)):
            run(i)
    for e in errors:
        if e is not None:
            raise e
    return results
