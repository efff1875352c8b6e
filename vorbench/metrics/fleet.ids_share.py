"""Share of the window in the program's ``batch.ids`` span: the symbol
lane's VQ classes and ids put into the staging ring (the carried frames'
copies, the classes of the chunk's rows, ``flatten_ids`` and ``pad_ids``),
inside ``batch.stage`` on the main thread.  A dense-lane fleet, or a
program without the span, reads nothing."""


def read(ctx):
    s = ctx["spans"].get("batch.ids")
    return None if s is None else 100.0 * s / ctx["window_s"]
