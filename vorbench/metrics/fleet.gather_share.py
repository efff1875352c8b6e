"""Share of the window in the program's ``batch.gather`` span: the
concatenation of each chunk's per-stream arrays (the dense residue among
them) into the chunk's, inside ``batch.collect`` on the main thread."""


def read(ctx):
    s = ctx["spans"].get("batch.gather")
    return None if s is None else 100.0 * s / ctx["window_s"]
