"""Share of the window spent constructing each job's ``BatchDecoder``
(opening every source: ``VorbisReader``, the packet tables, per-stream
state), by the harness's ``bench.open`` span."""


def read(ctx):
    s = ctx["spans"].get("bench.open")
    return None if s is None else 100.0 * s / ctx["window_s"]
