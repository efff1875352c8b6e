"""Host staging of the chunk programs' arguments, reused chunk to chunk.

A fleet chunk hands its program a few dozen host arrays (each bucket's
dense residue or symbols, posts, flags, window and table ids, and the
segment tables), about 60 MB a chunk on a 5.1 fleet.  Fresh arrays would
cost a page fault per page on first touch, and a copy from pageable memory
holds the calling thread for the whole transfer (CUDA stages it through
a bounce buffer).  :class:`StagingRing` keeps ``DEPTH`` regions of
host memory instead: page-locked (``torch.empty(..., pin_memory=True)``)
for a CUDA device, so that each argument's copy to the card is an
asynchronous DMA on the current stream, and plain ``np.empty`` for the CPU,
which runs the same ring logic.

A chunk takes the next region (:meth:`StagingRing.begin`), carves its
arguments from it as consecutive, C-contiguous views (:meth:`take`), and
once its programs are enqueued records an event on each device's current
stream (:meth:`release`); the region is written again two chunks later,
after that event.  PyTorch's caching host allocator records no event for
a copy from a ``torch.from_numpy`` view, so the ring keeps its own.  The
regions grow together, past the most bytes any chunk has taken, and never
shrink; each region allocated adds one to the ``stage.ring_allocs``
counter.

Rings outlive the decoder that used them: :func:`borrowed` lends a device's
idle ring for one decode and takes it back after, so the jobs of a fleet
service stage into the same warm regions, and two decodes at once each
hold their own.
"""

import contextlib
import threading

import numpy as np
import torch

from nvorbis_tpu_torch.utils import profiling

DEPTH = 2  # regions a ring cycles through
ALIGN = 256  # bytes: where every argument starts within its region
GRAIN = 1 << 21  # bytes: regions are whole multiples of it

_idle = {}  # torch.device -> rings no decode holds
_idle_lock = threading.Lock()


class StagingRing:
    """``DEPTH`` host regions of one device (page-locked for a CUDA
    device), all of one size, that the chunks of a decode carve their
    arguments from in turn."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self._regions = [None] * DEPTH  # uint8 numpy view of each region
        self._size = 0  # bytes of each region
        self._events = [[] for _ in range(DEPTH)]  # after each one's use
        # regions outgrown in the middle of a chunk, dropped once that
        # chunk's events are through
        self._retired = [[] for _ in range(DEPTH)]
        self._slot = DEPTH - 1
        self._off = 0

    def regions(self):
        """The allocated regions, as flat uint8 numpy arrays."""
        return [r for r in self._regions if r is not None]

    def _wait(self, s):
        for ev in self._events[s]:
            ev.synchronize()
        self._events[s] = []
        self._retired[s] = []

    def _grow(self, nbytes):
        """Every region anew, a quarter larger than ``nbytes`` (so that a
        chunk that outgrows the ring grows it once, not at each argument
        after): the other regions once their copies are through, this
        chunk's kept alive for the views already taken from it."""
        self._size = size = max(GRAIN,
                                -(-(nbytes * 5 // 4) // GRAIN) * GRAIN)
        for s in range(DEPTH):
            if s != self._slot:
                self._wait(s)
            elif self._regions[s] is not None:
                self._retired[s].append(self._regions[s])
            profiling.count("stage.ring_allocs", 1)
            if self.pinned:
                raw = torch.empty(size + ALIGN, dtype=torch.uint8,
                                  pin_memory=True).numpy()
            else:
                raw = np.empty(size + ALIGN, dtype=np.uint8)
            start = -raw.ctypes.data % ALIGN
            self._regions[s] = raw[start : start + size]

    def begin(self):
        """Start a chunk in the next region, once the copies out of the
        chunk that last used it are through."""
        self._slot = (self._slot + 1) % DEPTH
        self._wait(self._slot)
        self._off = 0

    def take(self, shape, dtype):
        """A C-contiguous array of ``shape`` and ``dtype`` in the chunk's
        region, after the ones taken before it; its contents are whatever
        the region held."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        start = -(-self._off // ALIGN) * ALIGN
        self._off = end = start + nbytes
        if end > self._size or self._regions[self._slot] is None:
            self._grow(end)
        region = self._regions[self._slot]
        return region[start:end].view(dtype).reshape(shape)

    def release(self, devices):
        """Mark the chunk's copies as queued: an event on the current
        stream of each CUDA device of ``devices``, which the region's next
        :meth:`begin` waits for."""
        if not self.pinned:
            return
        for dev in dict.fromkeys(torch.device(d) for d in devices):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self._events[self._slot].append(ev)


def idle_rings(device):
    """The rings of ``device`` that no decode holds now."""
    with _idle_lock:
        return list(_idle.get(torch.device(device), ()))


@contextlib.contextmanager
def borrowed(device):
    """A ring of ``device`` for the block: one an earlier decode left idle,
    else a new one; idle again after the block."""
    device = torch.device(device)
    with _idle_lock:
        free = _idle.setdefault(device, [])
        ring = free.pop() if free else StagingRing(device)
    try:
        yield ring
    finally:
        with _idle_lock:
            _idle[device].append(ring)
