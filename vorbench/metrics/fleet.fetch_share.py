"""Share of the window in the program's ``batch.fetch`` span: the wait on
each chunk's copy and its emit, on the fetch worker (it overlaps the main
thread's shares)."""


def read(ctx):
    s = ctx["spans"].get("batch.fetch")
    return None if s is None else 100.0 * s / ctx["window_s"]
