"""Megabytes that the chunk programs took from the host per audio second
of the window: the program's ``upload.bytes`` counter (the numpy arguments
of every program run, the dense residue among them) over the window's
audio.  The harness resets the program's recorder when the trace starts,
so the total covers the window; a program without the counter reads
nothing."""


def read(ctx):
    from nvorbis_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None or not ctx["audio_s"]:
        return None
    n = counters().get("upload.bytes")
    return None if n is None else n / 1e6 / ctx["audio_s"]
