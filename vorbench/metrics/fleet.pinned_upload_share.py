"""Share of the bytes that the chunk programs took from the host which
came from page-locked memory: the program's ``stage.pinned_bytes`` counter
over its ``upload.bytes`` counter, both over the window.  100 when every
argument is staged in the fleet's page-locked ring, 0 on the CPU; a
program without the first counter reads nothing."""


def read(ctx):
    from nvorbis_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    totals = counters()
    pinned = totals.get("stage.pinned_bytes")
    total = totals.get("upload.bytes")
    if pinned is None or not total:
        return None
    return 100.0 * pinned / total
