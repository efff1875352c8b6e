"""Share of the window in the program's ``batch.pull`` span: the packet
windows of each chunk, sliced out of the streams' packet tables, inside
``batch.collect`` on the main thread."""


def read(ctx):
    s = ctx["spans"].get("batch.pull")
    return None if s is None else 100.0 * s / ctx["window_s"]
