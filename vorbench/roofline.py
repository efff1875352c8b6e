"""The card's peaks and the least time a window's synthesis needs.

The work is counted from the window's own audio, not from the program's
launches, so it reads the same whatever implements it: the float32 PCM
written once, the Vorbis audio packets read once, and the IMDCT's float32
operations at the count of an FFT-based transform.  The least time is the
larger of the bytes over the memory bandwidth and the operations over the
float32 rate.
"""

import numpy as np

# NVIDIA's H100 data sheet (SXM, dense, at the full 700 W power limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops_per_s": 67e12,
                              "bytes_per_s": 3.35e12},
}


def imdct_flops(n):
    """float32 operations of one channel's ``n``-point IMDCT through an
    ``n/4``-point complex FFT: ``5 (n/4) log2(n/4)`` for the FFT and a
    complex multiply (6 operations) per point before and after it.  ``n``
    may be an array of block sizes."""
    q = np.asarray(n, dtype=np.float64) / 4
    return 5 * q * np.log2(q) + 12 * q


def job_work(sizes_per_stream, samples_per_stream, packet_bytes, channels):
    """``(bytes, flops)`` of one job: every stream's float32 PCM written
    once and its audio packets read once; an IMDCT per channel of every
    audio packet."""
    pcm = 4 * channels * sum(samples_per_stream)
    flops = channels * sum(float(imdct_flops(s).sum())
                           for s in sizes_per_stream)
    return pcm + packet_bytes, flops


def least_seconds(nbytes, flops, device):
    """``(seconds, bound)``: the least time of the work on ``device`` and
    whether bytes or operations bind it."""
    peak = PEAKS[device]
    tb = nbytes / peak["bytes_per_s"]
    tf = flops / peak["fp32_flops_per_s"]
    return (tb, "bytes") if tb >= tf else (tf, "flops")
