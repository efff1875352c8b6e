"""Compiled chunk programs: one CUDA graph per chunk shape.

The JAX package never launches a chunk program op by op: its factories
``nvorbis_tpu/parallel/batch.py:61`` (``_batch_program``, through :169) and
``nvorbis_tpu/engine/bulk.py:50`` (``_bulk_program``, through :132) are
``functools.lru_cache(maxsize=64)`` caches of ``jax.jit`` executables keyed
by the chunk's static cfg, and the host pads every shape so that the cfg
repeats from chunk to chunk.  Here :class:`ProgramCache` plays that part:
each cfg's program (``parallel/batch.py::batch_program``,
``engine/bulk.py::bulk_program``) is captured once into a
``torch.cuda.CUDAGraph``, whose replay launches the whole chunk program at
once.

The streaming programs and the mesh take the same cache.  The JAX
package's ``_synth_program`` and ``_synth_program_sym``
(``nvorbis_tpu/synth/device.py:261-297``, jitted on their static
arguments) are ``synth/device.py::synth_program`` and
``synth_program_sym``, one window bucket of one mode.  Its
``_batch_program(cfg, mesh_key)`` (``nvorbis_tpu/parallel/batch.py:
171-188``), one program over the whole mesh, is two kinds here, because a
capture records one device's work and the caching allocator keeps its
graph pools per device: ``parallel/batch.py::mesh_shard_program``, one
shard's rows on the shard's device, and ``mesh_out_program``, the gather
and the epilogues on the output device.  Its ``make_sharded_synth``
(``nvorbis_tpu/parallel/sharded.py:61-107``, jitted over the mesh) is three
kinds of ``parallel/sharded.py`` for the same reason: ``sharded_floor`` per
shard, ``sharded_part`` per grid cell and ``sharded_out`` per shard.

**Key**: ``(device, kind, cfg, signature)``, kind ``"batch"``, ``"bulk"``,
``"synth"``, ``"synth_sym"``, ``"mesh_shard"``, ``"mesh_out"``,
``"sharded_floor"``, ``"sharded_part"`` or ``"sharded_out"``, the
signature the shape and dtype of every flat argument (what ``jax.jit``
keys its own traces on beneath the ``lru_cache``: two groups of one cfg
whose tables differ in size are two programs).  A mesh kind's cfg names
the mesh's devices as strings, never the mesh object, so two meshes over
the same cards share their graphs.  The cache is module-level
(:data:`CACHE`), so a second ``read_all`` of a stream with the same shapes
replays, as opening a new file never recompiles in the JAX package (JAX
synth/device.py:281-291).  It holds at most ``MAX_ENTRIES`` keys, and its
graphs at most a quarter of the card's memory; the least recently used
goes first.

**When a chunk captures** (:meth:`ProgramCache.plan`): the first chunk of a
key runs eagerly, op by op on fresh uploads, and its output is used.  That
run is the warm-up PyTorch requires before a capture: the first use of a
device fills lazily cached tables (``inverse_db_table``, the kernel's
``twiddle_table``, ``plan_tables``) from pageable host memory, which a
capture cannot record (each of those fills raises inside one).  The
``CAPTURE_AT``-th chunk of the key (the second) captures the program and
replays it; every later chunk replays.  A CPU device never builds a graph:
every chunk runs eagerly (the test path).

**Static slots**: a captured graph reads fixed addresses.  Every numpy
argument (the chunk's staging arrays) is uploaded straight into its slot
on the current stream, without the calling thread waiting for the copy
where the array is page-locked (the fleet's staging ring,
``utils/staging.py``, whose caller keeps the array unwritten until the
copy is through); a table argument (a device tensor) is copied into
its slot unless it is the very tensor last copied there.  The slots are
the entry's own tensors on the entry's device, never the caller's, and
the entry holds every tensor it reads by address.  A tensor argument on
another card (a mesh shard's rows) is copied into its slot with
``copy_``, which PyTorch orders against both devices' current streams.

**The output** is a static tensor that the next replay of the key
overwrites, while ``decode_all`` keeps up to two chunks pending on its
fetch worker: each replay copies its first ``rows`` rows into a fresh
tensor on the current stream, and the fetch takes that copy.

**Capture** runs on one stream per device (:func:`_capture_stream`, of
its own priority so that no other stream of the port is it), between
``capture_begin``/``capture_end`` in ``capture_error_mode="thread_local"``
(the ``nvt-fetch`` worker may be waiting on a copy's event or emitting
while the main thread captures), with a memory pool per graph and without
the ``synchronize``, ``gc.collect`` and ``empty_cache`` that
``torch.cuda.graph`` runs on entry.  Each entry records its capture's
milliseconds, the memory it holds (its slots, plus the growth of
``torch.cuda.memory_reserved`` over the capture) and, per hand kernel of
:data:`KERNELS`, the launches the capture recorded, which every replay
adds to that kernel's ``launches`` (``ops.imdct``, ``ops.floor``,
``ops.floor.sym``, ``ops.residue``, ``ops.ola``): each
count stays the number of kernels that ran.

**Threads**: a lock per entry is held from the slot upload through the
replay and the output copy, and the next user's stream waits on an event
recorded after that copy before it writes the slots.  Captures take one
lock per process.

**Tracing** (``utils/profiling.py``): a span named ``<kind>.upload``
(``batch.upload`` on the fleet path, ``bulk.upload`` on ``read_all``)
wraps every write of a chunk's arguments from the host: the eager path's
uploads, a capture's slot creation and a replay's slot fills.  The counter
``upload.bytes`` adds the ``nbytes`` of every numpy argument of every run,
on every device (on the CPU, the bytes handed to the program); tables that
are device tensors already do not count.  The counter ``stage.pinned_bytes``
adds those of them that a CUDA run takes from page-locked memory (0 on the
CPU).

There is no fallback: a capture or replay that fails raises.
"""

import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from nvorbis_tpu_torch.ops import (
    floor as _floor,
    imdct as _imdct,
    ola as _ola,
    residue as _residue,
)
from nvorbis_tpu_torch.utils import profiling
from nvorbis_tpu_torch.utils.device import upload

# the hand kernels by name: the module (or, for the floor kernel's symbol
# form, the counter) of each, whose ``launches`` a replay adds to and whose
# ``recorded_launches`` a capture reads
KERNELS = {"imdct_window": _imdct, "floor_couple": _floor,
           "floor_sym": _floor.sym, "residue_rebuild": _residue,
           "overlap_add": _ola}

MAX_ENTRIES = 64  # the JAX factories' lru_cache(maxsize=64)
CAPTURE_AT = 2  # the chunk of a key that captures; earlier ones run eagerly
MODES = ("eager", "captured", "replayed")

# captures, one at a time in the process, and their stream per device
_capture_lock = threading.Lock()
_capture_streams = {}


def _capture_stream(device):
    """The stream every capture on ``device`` runs on.  ``torch.cuda.Stream``
    hands out the streams of a pool of 32 per priority in turn, so two
    objects can be one CUDA stream: a ``PinnedFetch`` side stream (priority
    0) would then be the capturing one, and the host allocator's event,
    recorded on it when the fetch worker frees a pinned buffer, would join
    the capture.  No other code of the port takes a stream of higher
    priority, so captures do.  Caller holds ``_capture_lock``."""
    s = _capture_streams.get(device)
    if s is None:
        s = _capture_streams[device] = torch.cuda.Stream(device=device,
                                                         priority=-1)
    return s


def signature(flat):
    """Shape and dtype of every flat argument (None for a None one)."""
    return tuple(None if a is None else (tuple(a.shape), str(a.dtype))
                 for a in flat)


def uploaded(flat, device):
    """``flat`` with every numpy array uploaded to ``device`` (a fresh
    tensor each; on the CPU a view of the array) and every tensor on
    another device copied there (a mesh shard's rows); a tensor already on
    ``device`` is passed as it is."""
    return [None if a is None else upload(a, device) for a in flat]


def copied(flat, device):
    """``flat`` as :func:`uploaded` gives it, but every numpy array in a
    tensor of its own, on the CPU too, where an upload is a view of the
    array (a staging ring's, which a later chunk rewrites)."""
    return [torch.tensor(a, device=device) if isinstance(a, np.ndarray)
            else None if a is None else upload(a, device) for a in flat]


def _count_uploads(flat, device):
    """Add the bytes of ``flat``'s numpy arguments, which every run writes
    to its device, to the ``upload.bytes`` counter, and those of them that
    are page-locked on a CUDA ``device`` to ``stage.pinned_bytes``."""
    if profiling.enabled():
        host = [a for a in flat if isinstance(a, np.ndarray)]
        profiling.count("upload.bytes", sum(a.nbytes for a in host))
        profiling.count("stage.pinned_bytes", sum(
            a.nbytes for a in host
            if device.type == "cuda"
            and torch.from_numpy(np.ascontiguousarray(a)).is_pinned()))


def new_counts():
    """A decoder's ``programs`` counters: chunks run eagerly, chunks that
    captured their program, and chunks replayed from a graph (a chunk that
    captured is also replayed)."""
    return dict.fromkeys(MODES, 0)


def count(counts, mode):
    """Add one chunk run in ``mode`` (:meth:`ProgramCache.run`) to a
    decoder's ``counts``."""
    counts[mode] += 1
    if mode == "captured":
        counts["replayed"] += 1


class Entry:
    """One key's program: its chunk count, and once captured its graph,
    slots, output and costs."""

    __slots__ = ("key", "seen", "graph", "slots", "sources", "out",
                 "launches", "capture_ms", "nbytes", "lock", "done")

    def __init__(self, key):
        self.key = key
        self.seen = 0  # chunks of this key planned
        self.graph = None
        self.slots = None  # the graph's inputs, one per flat argument
        self.sources = None  # the table last copied into each slot
        self.out = None  # the graph's static output
        self.launches = {}  # kernel name -> its launches per replay
        self.capture_ms = None
        self.nbytes = 0  # device memory held: slots and the graph's pool
        self.lock = threading.Lock()
        self.done = None  # event after the last replay's output copy


class ProgramCache:
    """Chunk programs by key, captured at the ``capture_at``-th chunk of a
    key (None: never) and replayed after; at most ``MAX_ENTRIES`` keys and,
    per device, ``max_bytes`` of graph memory (None: a quarter of the
    card's), least recently used evicted first.  ``counts`` adds up the
    chunks run in each mode."""

    def __init__(self, capture_at=CAPTURE_AT, max_bytes=None):
        self.capture_at = capture_at
        self.max_bytes = max_bytes
        self.counts = new_counts()
        self._entries = OrderedDict()
        self._lock = threading.Lock()  # the table and the counts

    def __len__(self):
        return len(self._entries)

    def entries(self):
        """The entries, least recently used first."""
        with self._lock:
            return list(self._entries.values())

    def entry(self, key):
        with self._lock:
            return self._entries.get(key)

    def plan(self, key):
        """``(entry, mode)`` for the next chunk of ``key``: ``"eager"``
        before its ``capture_at``-th chunk, then ``"captured"`` until a
        graph exists, then ``"replayed"``; marks the key most recently
        used and evicts past ``MAX_ENTRIES``."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = Entry(key)
            else:
                self._entries.move_to_end(key)
            e.seen += 1
            if e.graph is not None:
                mode = "replayed"
            elif self.capture_at is not None and e.seen >= self.capture_at:
                mode = "captured"
            else:
                mode = "eager"
            self._evict(key)
        return e, mode

    def _evict(self, keep):
        """Drop least recently used entries (never ``keep``) while more
        than ``MAX_ENTRIES`` are held or, on a device, their graphs hold
        more than its byte bound.  Caller holds ``_lock``."""
        while len(self._entries) > MAX_ENTRIES:
            self._entries.pop(next(k for k in self._entries if k != keep))
        held = {}
        for k, e in self._entries.items():
            held[k[0]] = held.get(k[0], 0) + e.nbytes
        for dev, total in held.items():
            if not total:
                continue
            bound = self._byte_bound(dev)
            for k in [k for k in self._entries if k[0] == dev]:
                if total <= bound:
                    break
                if k != keep and self._entries[k].nbytes:
                    total -= self._entries.pop(k).nbytes

    def _byte_bound(self, device):
        if self.max_bytes is not None:
            return self.max_bytes
        return torch.cuda.get_device_properties(device).total_memory // 4

    def run(self, kind, program, cfg, flat, device, rows):
        """``program(cfg, *flat)[:rows]`` on ``device`` as the key's mode
        says; returns ``(out, mode)``.  ``flat`` holds numpy arrays (the
        chunk's staging), device tensors (tables) and None; ``out`` is
        fresh for every chunk, never a graph's static output."""
        device = torch.device(device)
        _count_uploads(flat, device)
        if device.type != "cuda":
            with profiling.span(f"{kind}.upload"):
                args = uploaded(flat, device)
            return program(cfg, *args)[:rows], "eager"
        with torch.cuda.device(device):
            return self._run_cached((device, kind, cfg, signature(flat)),
                                    program, cfg, flat, device, rows)

    def _run_cached(self, key, program, cfg, flat, device, rows):
        e, mode = self.plan(key)
        if mode == "eager":
            with profiling.span(f"{key[1]}.upload"):
                args = uploaded(flat, device)
            out = program(cfg, *args)[:rows]
        else:
            with e.lock:
                if e.graph is None:
                    self._capture(e, program, cfg, flat, device)
                    mode = "captured"
                else:
                    self._fill(e, flat)
                    mode = "replayed"
                out = self._replay(e, rows)
            if mode == "captured":
                with self._lock:
                    self._evict(key)
        with self._lock:
            count(self.counts, mode)
        return out, mode

    def _fill(self, e, flat):
        """Write the chunk's arguments into ``e``'s slots on the current
        stream, once the last replay's output copy is through."""
        stream = torch.cuda.current_stream(e.out.device)
        if e.done is not None:
            stream.wait_event(e.done)
        with profiling.span(f"{e.key[1]}.upload"):
            for i, a in enumerate(flat):
                if isinstance(a, np.ndarray):
                    e.slots[i].copy_(
                        torch.from_numpy(np.ascontiguousarray(a)),
                        non_blocking=True)
                elif a is not None and a is not e.sources[i]:
                    e.slots[i].copy_(a, non_blocking=True)
                    e.sources[i] = a

    def _capture(self, e, program, cfg, flat, device):
        """Make ``e``'s slots from this chunk's arguments and capture
        ``program`` over them on the capture stream."""
        slots = []
        with profiling.span(f"{e.key[1]}.upload"):
            for a in flat:
                if isinstance(a, np.ndarray):
                    t = torch.empty(a.shape,
                                    dtype=torch.from_numpy(a[:0]).dtype,
                                    device=device)
                    t.copy_(torch.from_numpy(np.ascontiguousarray(a)),
                            non_blocking=True)
                else:
                    t = None if a is None else a.to(device, copy=True)
                slots.append(t)
        slot_bytes = sum(t.numel() * t.element_size() for t in slots
                         if t is not None)
        stream = torch.cuda.current_stream(device)
        with _capture_lock:
            side = _capture_stream(device)
            reserved = torch.cuda.memory_reserved(device)
            side.wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            recorded = {k: m.recorded_launches() for k, m in KERNELS.items()}
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                    capture_error_mode="thread_local")
                try:
                    out = program(cfg, *slots)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is void; the program's error stands
                    raise
                graph.capture_end()
            e.capture_ms = (time.perf_counter() - t0) * 1e3
            e.launches = {k: m.recorded_launches() - recorded[k]
                          for k, m in KERNELS.items()}
            e.nbytes = slot_bytes + max(
                0, torch.cuda.memory_reserved(device) - reserved)
        stream.wait_stream(side)
        e.slots, e.out, e.graph = slots, out, graph
        e.sources = [a if torch.is_tensor(a) else None for a in flat]

    def _replay(self, e, rows):
        """Replay ``e``'s graph on the current stream; returns a fresh copy
        of its first ``rows`` output rows."""
        stream = torch.cuda.current_stream(e.out.device)
        e.graph.replay()
        for k, n in e.launches.items():
            KERNELS[k].launches += n
        out = e.out[:rows].clone()
        e.done = torch.cuda.Event()
        e.done.record(stream)
        return out


CACHE = ProgramCache()


def run(kind, program, cfg, flat, device, rows):
    """:meth:`ProgramCache.run` on the module's cache, :data:`CACHE`."""
    return CACHE.run(kind, program, cfg, flat, device, rows)
