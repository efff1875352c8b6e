"""Share of the window in the program's ``batch.dispatch`` span: staging,
uploads and the chunk program's launch, on the main thread."""


def read(ctx):
    s = ctx["spans"].get("batch.dispatch")
    return None if s is None else 100.0 * s / ctx["window_s"]
