"""The symbol form of the floor kernel against its roofline: the least
time of the window's work at the card's memory bandwidth
(vorbench/roofline.py: one float32 spectrum value per PCM sample written
once, the audio packets read once) over the traced device time of the
``floor_couple_kernel`` instantiations with a stage count S >= 1 (the
residue rebuilt from VQ symbols; S = 0 is the dense form) among the
trace's top device operations."""

import re

from vorbench import roofline

# the demangled name, or the same with its punctuation made underscores
SYMBOL_FORM = re.compile(r"floor_couple_kernel[<_](\d+)")


def read(ctx):
    t = ctx["trace"]
    if t is None or ctx["device"] not in roofline.PEAKS:
        return None
    seconds = 0.0
    for name, s in t["device_ops"]:
        m = SYMBOL_FORM.search(name)
        if m and int(m.group(1)) >= 1:
            seconds += s
    if not seconds:
        return None
    least = ctx["work"]["bytes"] / roofline.PEAKS[ctx["device"]][
        "bytes_per_s"]
    return 100.0 * least / seconds
