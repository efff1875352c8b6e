"""Share of the window in the program's ``batch.wait`` span: the main
thread waiting for the fetch worker (``nvt-fetch``) to finish a chunk's
copy and emit, when two chunks are already pending and at the end of each
group."""


def read(ctx):
    s = ctx["spans"].get("batch.wait")
    return None if s is None else 100.0 * s / ctx["window_s"]
