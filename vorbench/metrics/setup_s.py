"""Seconds from the harness's start to the window's: imports, the card's
start, the streams' assembly and the warm-up jobs (the builds and captures
on a checkout's first run)."""


def read(ctx):
    return ctx["setup_s"]
