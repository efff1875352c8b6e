"""Share of the window in the program's ``batch.upload`` span: every write
of a chunk program's arguments from the host (a replay's slot fills, a
capture's slots, an eager run's uploads), inside ``batch.program`` on the
main thread."""


def read(ctx):
    s = ctx["spans"].get("batch.upload")
    return None if s is None else 100.0 * s / ctx["window_s"]
