"""Chunked pass execution over a mesh of device slots (counterpart of
acmmp_spherical_tpu/pipeline/batch_runner.py).

The reference runs its per-image loop strictly serially on one GPU
(main.cpp:431-446).  Here the problems of a pass are grouped into chunks of
at most ``mesh.size`` problems of one shape key (reference shape, source
stack shape, camera model, rectified path), and the problems of a chunk
run together, problem ``i`` on slot ``i`` (``parallel/mesh.run_slots``:
one host thread per slot, under the slot's device, on a CUDA stream of its
own).  The JAX package runs a chunk as one vmapped program; threads are
PyTorch's way to keep several devices, or several streams of one device,
busy.  The next chunk is loaded on a thread of its own while the current
one runs (``_prefetched``), so image and ``.dmb`` io overlaps device work.

Each problem runs ``pass_runner.process_problem``'s own helpers
(``load_seeds``, ``main_round``, ``prior_build``, ``prior_round``,
``write_results``) with the chunk's rect settings (``_make_chunk``: the
JAX package's reductions) and the same keys, so the same ``.dmb`` files
and ``triangulation.png`` are written, equal to the serial run's byte for
byte.  Three departures
from the JAX package, all for the serial path's results: a trailing chunk
runs only its real problems (a padded slot would be a whole extra pass
here, not a masked lane); a problem whose planar prior is empty skips the
prior round, as the serial path does (the JAX vmap runs it with an empty
mask); and a multi-geometry pass, which reads the depths it rewrites,
chunks and loads in the serial order's exchange (``_chunks``), where the
JAX package loads each chunk's source depths whenever its loader gets to
them.  The planar-prior builds run on the host, one problem after another,
between the chunk's two rounds.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Optional, Sequence

import torch

from acmmp_spherical_torch.config import PatchMatchParams, PipelineConfig
from acmmp_spherical_torch.io.scene import Problem, ScenePaths
from acmmp_spherical_torch.parallel.mesh import (
    ViewMesh, make_view_mesh, run_slots, slot_context, slot_streams,
    tree_map,
)
from acmmp_spherical_torch.pipeline.pass_runner import (
    LoadedProblem, exchange_predecessors, load_problem, load_seeds,
    main_round, prior_build, prior_round, problem_key, write_results,
)
from acmmp_spherical_torch.utils.log import Timings, get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class _Chunk:
    indices: list              # problem indices, one per slot
    lps: list                  # LoadedProblem per slot
    params: PatchMatchParams   # the chunk's shared parameters
    ready: Optional[object] = None  # CUDA event after the loads, or None


def _chunks(sp: ScenePaths, problems: Sequence[Problem], order, cfg,
            mesh: ViewMesh, *, geom: bool, multi_geometry: bool,
            timings: Timings):
    """Load problems into chunks of at most ``mesh.size`` problems of one
    shape key (the JAX package's grouping), which flush as they fill; the
    groups left at the end follow in the order they were opened.  A
    multi-geometry pass instead cuts ``order`` into runs of consecutive
    problems of one key in which no problem follows another
    (``exchange_predecessors``), and a chunk is flushed before a problem
    that follows one of it is loaded, so the pass reads what the serial
    order reads.  Inputs load onto ``mesh.devices[0]`` (a slot on another
    device copies them over)."""
    follow = exchange_predecessors(problems, cfg) if multi_geometry else None
    groups: dict = {}
    for idx in order:
        if follow is not None:
            for key, g in list(groups.items()):
                if follow[idx] & set(g[0]):
                    del groups[key]
                    yield _loaded(_make_chunk(g), mesh.devices[0])
        with timings.scope("load"):
            lp, params = load_problem(sp, problems, idx, cfg, geom=geom,
                                      multi_geometry=multi_geometry,
                                      device=mesh.devices[0])
        key = (tuple(lp.inputs.ref_image.shape),
               tuple(lp.inputs.src_images.shape), lp.ref_cam.model,
               params.rect_ncc)
        if follow is not None:
            for other, g in list(groups.items()):
                if other != key:
                    del groups[other]
                    yield _loaded(_make_chunk(g), mesh.devices[0])
        g = groups.setdefault(key, ([], [], []))
        g[0].append(idx)
        g[1].append(lp)
        g[2].append(params)
        if len(g[0]) == mesh.size:
            del groups[key]
            yield _loaded(_make_chunk(g), mesh.devices[0])
    for g in groups.values():
        yield _loaded(_make_chunk(g), mesh.devices[0])


def _loaded(chunk: _Chunk, device: torch.device) -> _Chunk:
    """Mark the chunk's loads on the loading thread's stream."""
    if device.type == "cuda":
        chunk.ready = torch.cuda.Event()
        chunk.ready.record(torch.cuda.current_stream(device))
    return chunk


def _make_chunk(g) -> _Chunk:
    """The chunk's parameters: the first problem's, with the rect settings
    reduced over the chunk as the JAX package reduces them (the compute
    grid, live-tile budget, init window and warp window take their max, or
    None if any is None; ``rect_init`` and ``rect_inv_attrib`` hold only if
    they hold for every problem).  Under the pipeline's scene-wide
    ``rect_unify`` every problem of a scale already has the same settings,
    so the reduction changes nothing."""
    idxs, lps, plist = g
    params = plist[0]
    if params.rect_ncc:
        def max_or_none(vals):
            if any(v is None for v in vals):
                return None
            if isinstance(vals[0], tuple):
                return tuple(max(v[i] for v in vals)
                             for i in range(len(vals[0])))
            return max(vals)

        params = dataclasses.replace(
            params,
            rect_comp_hw=max_or_none([p.rect_comp_hw for p in plist]),
            rect_live_n=max_or_none([p.rect_live_n for p in plist]),
            rect_init=all(p.rect_init for p in plist),
            rect_init_win=max(p.rect_init_win for p in plist),
            rect_warp_hw=max_or_none([p.rect_warp_hw for p in plist]),
            rect_inv_attrib=all(p.rect_inv_attrib for p in plist))
    return _Chunk(indices=list(idxs), lps=list(lps), params=params)


def _prefetched(it, *, device: torch.device, timings: Timings,
                lookahead: int = 1):
    """Iterate ``it`` on a loader thread (under ``device``, on a stream of
    its own) up to ``lookahead`` items ahead of the consumer, so the next
    chunk's io overlaps the current chunk's device work.  The consumer's
    waits are the ``load_wait`` scope.  Loader errors are raised in the
    consumer; a consumer that stops early stops the loader."""
    q: "queue.Queue" = queue.Queue(maxsize=lookahead)
    stop = threading.Event()
    end = object()
    stream = torch.cuda.Stream(device=device) if device.type == "cuda" \
        else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            with slot_context(device, stream):
                for item in it:
                    if not put(item):
                        return
            put(end)
        except BaseException as e:  # raised again in the consumer
            put(e)

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            with timings.scope("load_wait"):
                item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def _adopt(inputs, ready, device: torch.device):
    """The loader's tensors for use on the calling slot's current stream:
    wait for the loads, copy to the slot's device where it differs, and
    record the stream on each tensor so the allocator keeps its memory
    until the slot's work on it is done."""
    def take(t):
        if t.is_cuda:
            if ready is not None:
                torch.cuda.current_stream(t.device).wait_event(ready)
            t.record_stream(torch.cuda.current_stream(t.device))
        if t.device != device:
            t = t.to(device)
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(device))
        return t

    return tree_map(take, inputs)


def run_pass_batched(sp: ScenePaths, problems: Sequence[Problem],
                     order: Sequence[int], cfg: PipelineConfig, *,
                     geom: bool = False, planar_prior: bool = False,
                     hierarchy: bool = False, multi_geometry: bool = False,
                     seed: Optional[int] = None,
                     mesh: Optional[ViewMesh] = None,
                     timings: Optional[Timings] = None,
                     on_written: Optional[Callable[[int], None]] = None
                     ) -> None:
    """One pass over ``order``'s problems, chunked over ``mesh`` (default:
    every local CUDA device); the batched counterpart of
    ``pass_runner.process_problem``, through the same round, prior and
    write helpers.  ``on_written(idx)`` is called once a problem's files
    are written.  ``timings`` gets the ``load`` (loader thread),
    ``load_wait``, ``prior_build`` and ``write`` scopes, and is current in
    each slot's thread for its rounds (their spans, ``utils/log.span``)."""
    mesh = make_view_mesh() if mesh is None else mesh
    timings = Timings() if timings is None else timings
    streams = slot_streams(mesh)
    chunks = _chunks(sp, problems, order, cfg, mesh, geom=geom,
                     multi_geometry=multi_geometry, timings=timings)
    if not multi_geometry:
        # a multi-geometry chunk may read what the chunk before it writes,
        # so it loads only once that one is written
        chunks = _prefetched(chunks, device=mesh.devices[0], timings=timings)
    for chunk in chunks:
        params = chunk.params.with_hierarchy() if hierarchy else chunk.params
        ids = [problems[i].ref_image_id for i in chunk.indices]
        keys = [problem_key(cfg, pid, seed) for pid in ids]
        log.info("batched pass B=%d ids=%s geom=%s prior=%s hier=%s "
                 "multi=%s path=%s", len(ids), ids, geom, planar_prior,
                 hierarchy, multi_geometry, "rect" if params.rect_ncc
                 else "window" if params.fast_ncc else "exact")
        for pid in ids:
            sp.result_dir(pid).mkdir(parents=True, exist_ok=True)

        def first(slot: int, lp: LoadedProblem):
            dev = mesh.devices[slot]
            seeds = load_seeds(sp, lp, ids[slot], geom=geom,
                               hierarchy=hierarchy,
                               multi_geometry=multi_geometry, device=dev)
            with timings.current():
                return main_round(_adopt(lp.inputs, chunk.ready, dev),
                                  params, keys[slot], seeds)

        outs = run_slots(mesh, first, chunk.lps, streams)

        if planar_prior:
            # the priors on the host, one problem after another, then the
            # prior round of the problems that have one
            priors = [prior_build(sp, lp, pid, out[1], out[3], cfg, timings)
                      for lp, pid, out in zip(chunk.lps, ids, outs)]

            def second(slot: int, item):
                out, prior = item
                if prior is None:
                    return out
                with timings.current():
                    return (out[0], *prior_round(out[0], out[4], prior,
                                                 params, keys[slot]))

            outs = run_slots(mesh, second, list(zip(outs, priors)), streams)

        for idx, pid, out in zip(chunk.indices, ids, outs):
            write_results(sp, pid, *out[1:4], geom=geom, timings=timings)
            if on_written is not None:
                on_written(idx)
