"""What decides ``correct``: the timed path's PCM against the reference.

Every job of the window decodes the same streams, so each answer (a
stream's PCM) can be checked on its own.  Two numbers are compared:

* ``length_mismatches``: streams of every job of the window whose PCM
  length differs from the reference's (the stream's final granule), limit
  0;
* ``pcm_gap``: the largest ``|program - reference|`` over a sample of
  segments, short runs of consecutive audio packets, in every job of the
  window.  The sample is drawn from ``--seed`` once for the run: every
  stream's first and last packets, and one segment in each of ``strata``
  equal parts of the fleet's packets taken in fleet order, so that every
  chunk the program runs over more than two parts' packets holds a
  segment.  The reference decodes each segment once, from the packet before
  it (:mod:`vorbench.reference.vorbis`, float64), and clips as the
  program's epilogue does.

The program's outputs are kept only where the sample needs them: the slices
of the segments, copied out of each job's PCM before the next job starts.
"""

import numpy as np

from vorbench.reference.vorbis import Stream


def starts(sizes):
    """The first output sample of each audio packet: packet i returns
    (n[i-1] + n[i]) / 4 samples, the first none."""
    n = np.asarray(sizes, dtype=np.int64)
    ret = np.zeros(len(n), dtype=np.int64)
    ret[1:] = (n[:-1] + n[1:]) // 4
    return np.concatenate([[0], np.cumsum(ret)])


class Sample:
    """The segments of one run, drawn from ``seed``: ``(stream, first
    packet, packet count)`` of each stream's first and last ``packets``
    audio packets, then of one run of ``packets`` at a seeded place in each
    of ``strata`` equal parts of all the job's packets in fleet order."""

    def __init__(self, seed, sizes, strata, packets):
        self.sizes = sizes  # per stream: block size of each audio packet
        self.starts = [starts(s) for s in sizes]
        counts = [len(s) for s in sizes]
        segments = []
        for s, n in enumerate(counts):
            count = min(packets, n)
            segments.append((s, 0, count))
            if n > count:
                segments.append((s, n - count, count))
        offsets = np.concatenate([[0], np.cumsum(counts)])
        total = int(offsets[-1])
        rng = np.random.default_rng([seed, 0x73747261])
        for j in range(strata):
            lo = j * total // strata
            hi = max(lo + 1, (j + 1) * total // strata)
            g = int(rng.integers(lo, hi))
            s = int(np.searchsorted(offsets, g, side="right")) - 1
            count = min(packets, counts[s])
            segments.append((s, min(g - int(offsets[s]), counts[s] - count),
                             count))
        self.segments = segments


class Keeper:
    """Keeps, of each job's outputs, every stream's length and the slices
    of the sample's segments."""

    def __init__(self, sample, channels):
        self.sample = sample
        self.channels = channels
        self.lengths = []  # per job: each stream's PCM length, in samples
        self.slices = []  # per job: each segment's PCM

    def keep(self, job, outputs):
        C = self.channels
        self.lengths.append([len(o) // C for o in outputs])
        kept = []
        for s, first, count in self.sample.segments:
            st = self.sample.starts[s]
            kept.append(np.array(outputs[s][st[first] * C:
                                            st[first + count] * C]))
        self.slices.append(kept)


def compare(blobs, keeper):
    """``(numbers, info)``: the compared numbers, and what was compared."""
    refs = {}
    setups = {}

    def ref(s):
        if s not in refs:
            refs[s] = Stream(blobs[s], setups)
        return refs[s]

    want = [ref(s).length for s in range(len(blobs))]
    mismatches = sum(got != w for job in keeper.lengths
                     for got, w in zip(job, want))
    gap = 0.0
    compared = clipped = 0
    for i, (s, first, count) in enumerate(keeper.sample.segments):
        want_pcm = ref(s).decode(first, count)
        clipped += int(np.count_nonzero(np.abs(want_pcm) >= 1.0))
        for job in keeper.slices:
            got = job[i]
            if len(got) != len(want_pcm):
                gap = float("inf")
                continue
            d = np.abs(got.astype(np.float64) - want_pcm)
            g = float(d.max()) if len(d) else 0.0
            gap = max(gap, g if np.isfinite(g) else float("inf"))
            compared += len(d)
    numbers = {"pcm_gap": gap, "length_mismatches": int(mismatches)}
    info = {"segments": len(keeper.sample.segments), "samples": compared,
            "clipped_samples": clipped,
            "answers": sum(len(j) for j in keeper.lengths)}
    return numbers, info


def verdict(numbers, limits):
    """``correct``: every compared number within its limit."""
    return all(numbers[k] <= limits[k] for k in limits)


def control_keeper(blobs, sample, channels):
    """A :class:`Keeper` of one job that the control answered: the
    reference with its IMDCT in TF32, put in the program's place, gives
    every stream's length and every segment's PCM."""
    keeper = Keeper(sample, channels)
    setups = {}
    refs = [Stream(b, setups) for b in blobs]
    keeper.lengths.append([r.length for r in refs])
    keeper.slices.append([refs[s].decode(first, count, imdct="tf32")
                          for s, first, count in sample.segments])
    return keeper
