"""Share of the window in the program's ``batch.unpack`` span: the C++
unpack of each chunk's packets, on the main thread."""


def read(ctx):
    s = ctx["spans"].get("batch.unpack")
    return None if s is None else 100.0 * s / ctx["window_s"]
