"""The staging ring of the fleet's chunk programs (``utils/staging.py``):
how a chunk carves its arguments, how the regions grow and are lent, and,
on a card, that every host argument of a fleet decode is page-locked.

The card's test imports neither jax nor the JAX package, so it runs on the
card's machine; fleet decodes on a card are held to the same fleet decoded
on the CPU device within ``5e-6 * max(1, max|ref|)``, the bound
tests/test_torch_batch.py holds the card's fleet to."""

import numpy as np
import pytest
import torch

import nvorbis_tpu_torch as nvt
import nvorbis_tpu_torch.parallel.batch as tbatch
from nvorbis_tpu_torch.engine import programs
from nvorbis_tpu_torch.testgen.vorbis_writer import make_simple_spec
from nvorbis_tpu_torch.utils import profiling, staging


def _nbytes(a):
    return a.size * a.itemsize


def test_a_chunk_carves_consecutive_aligned_views():
    """Each argument is a C-contiguous view of the chunk's region, after
    the one before it and aligned; the next chunk takes the next region,
    and after ``DEPTH`` chunks the first one again."""
    ring = staging.StagingRing("cpu")
    firsts = []
    for _ in range(staging.DEPTH + 1):
        ring.begin()
        a = ring.take((5, 3, 7), np.float32)
        b = ring.take(11, np.int16)
        c = ring.take((2, 3), bool)
        for x in (a, b, c):
            assert x.flags.c_contiguous and x.flags.writeable
            assert x.ctypes.data % staging.ALIGN == 0
        assert b.ctypes.data >= a.ctypes.data + _nbytes(a)
        assert c.ctypes.data >= b.ctypes.data + _nbytes(b)
        assert (a.shape, b.shape, c.shape) == ((5, 3, 7), (11,), (2, 3))
        assert (a.dtype, b.dtype, c.dtype) == (np.float32, np.int16, bool)
        firsts.append(a.ctypes.data)
    assert len(set(firsts[: staging.DEPTH])) == staging.DEPTH
    assert firsts[staging.DEPTH] == firsts[0]
    assert len(ring.regions()) == staging.DEPTH


def test_regions_grow_together_and_keep_the_chunk_views():
    """A chunk that outgrows the ring grows every region at once to a
    quarter past what it took, counting each region allocated; the views
    it took before keep their contents, and no later chunk of that size
    allocates."""
    was = profiling.enabled()
    profiling.enable(True)
    profiling.reset()
    try:
        ring = staging.StagingRing("cpu")
        ring.begin()
        small = ring.take(1000, np.float32)
        small[:] = np.arange(1000)
        assert profiling.counters()["stage.ring_allocs"] == staging.DEPTH
        big = staging.GRAIN  # floats: twice a grain of bytes
        large = ring.take(big, np.float32)
        large[:] = 1.0
        np.testing.assert_array_equal(small, np.arange(1000))
        assert profiling.counters()["stage.ring_allocs"] == 2 * staging.DEPTH
        sizes = {len(r) for r in ring.regions()}
        assert len(sizes) == 1 and sizes.pop() >= 4 * big * 5 // 4
        for _ in range(2 * staging.DEPTH):
            ring.begin()
            ring.take(1000, np.float32)
            ring.take(big, np.float32)
        assert profiling.counters()["stage.ring_allocs"] == 2 * staging.DEPTH
    finally:
        profiling.enable(was)
        profiling.reset()


def test_borrowed_lends_each_decode_its_own_ring():
    """Two decodes at once hold two rings of the device; a later decode
    takes one of them back from the idle rings."""
    dev = torch.device("cpu")
    with staging.borrowed(dev) as a, staging.borrowed(dev) as b:
        assert a is not b
        held = {id(a), id(b)}
        assert not held & {id(r) for r in staging.idle_rings(dev)}
    assert held <= {id(r) for r in staging.idle_rings(dev)}
    with staging.borrowed("cpu") as c:
        assert id(c) in held


def _fleet():
    """Three 5.1 streams and a stereo one: two groups, several chunks of
    at most 256 packets."""
    surround = dict(channels=6, sample_rate=48000, residue_type=2,
                    couplings=[(0, 1), (2, 3), (4, 5)])
    rng = np.random.default_rng(18)
    return ([make_simple_spec(**surround).build_stream(rng, 300, serial=s)
             for s in (1, 2, 3)]
            + [make_simple_spec(channels=2, residue_type=2).build_stream(
                rng, 400, serial=4)])


@pytest.mark.cuda
@pytest.mark.parametrize("lane", ["dense", "symbol"])
def test_card_fleet_stages_from_page_locked_memory(monkeypatch, lane):
    """Three jobs of one fleet on the card: every host argument of every
    chunk program is page-locked, so ``stage.pinned_bytes`` equals
    ``upload.bytes``; the ring's regions are page-locked and none is
    allocated after the first job; each job's output equals the fleet's
    decode on the CPU device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if lane == "dense":
        monkeypatch.setenv("NVT_NO_SYMBOLS", "1")
    monkeypatch.setattr(tbatch, "CHUNK_FRAMES", 256)
    monkeypatch.setattr(tbatch, "CAP_PER_SIZE", 128)
    srcs = _fleet()
    want = nvt.BatchDecoder(srcs, device="cpu").decode_all()
    run = programs.run
    unpinned = []

    def recorded(kind, program, cfg, flat, device, rows):
        unpinned.extend(
            a.shape for a in flat if isinstance(a, np.ndarray)
            and not (a.flags.c_contiguous
                     and torch.from_numpy(a).is_pinned()))
        return run(kind, program, cfg, flat, device, rows)
    monkeypatch.setattr(programs, "run", recorded)
    was = profiling.enabled()
    profiling.enable(True)
    profiling.reset()
    allocs = []
    try:
        for _ in range(3):
            bd = nvt.BatchDecoder(srcs, device="cuda")
            outs = bd.decode_all()
            assert bd.chunks > staging.DEPTH
            got = profiling.counters()
            allocs.append(got.get("stage.ring_allocs", 0))
            assert got["stage.pinned_bytes"] == got["upload.bytes"] > 0
            for a, b in zip(outs, want):
                assert len(a) == len(b) > 0
                tol = 5e-6 * max(1.0, float(np.abs(b).max()))
                assert float(np.abs(a - b).max()) <= tol
    finally:
        profiling.enable(was)
        profiling.reset()
    assert not unpinned
    assert allocs[1] == allocs[2] == allocs[0]
    rings = staging.idle_rings(bd._device)
    assert rings and all(torch.from_numpy(r).is_pinned()
                         for ring in rings for r in ring.regions())
