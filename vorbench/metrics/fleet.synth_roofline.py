"""The window's synthesis against its roofline: the least time its work
needs on the card (vorbench/roofline.py: the float32 PCM written once and
the audio packets read once, against the IMDCT's float32 operations) over
the summed time of every kernel in the traced window."""

from vorbench import roofline


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["kernel_s"] or ctx["device"] not in roofline.PEAKS:
        return None
    least, _ = roofline.least_seconds(ctx["work"]["bytes"],
                                      ctx["work"]["flops"], ctx["device"])
    return 100.0 * least / t["kernel_s"]
