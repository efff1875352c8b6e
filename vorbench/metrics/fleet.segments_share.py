"""Share of the window in the program's ``batch.segments`` span: the per-
stream segment tables, the carried frames and the chunk's segment arrays,
inside ``batch.dispatch`` on the main thread."""


def read(ctx):
    s = ctx["spans"].get("batch.segments")
    return None if s is None else 100.0 * s / ctx["window_s"]
