"""Share of the window's chunk-program runs that replayed a graph captured
before the window: under 100, a capture or an eager run fell inside it."""


def read(ctx):
    p = ctx["programs"]
    runs = p.get("eager", 0) + p.get("replayed", 0)
    if not runs:
        return None
    return 100.0 * (p.get("replayed", 0) - p.get("captured", 0)) / runs
