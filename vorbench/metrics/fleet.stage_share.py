"""Share of the window in the program's ``batch.stage`` span: the bucketing
of each chunk's frames and the per-bucket staging arrays, padded to the
bucket's extent, inside ``batch.dispatch`` on the main thread."""


def read(ctx):
    s = ctx["spans"].get("batch.stage")
    return None if s is None else 100.0 * s / ctx["window_s"]
