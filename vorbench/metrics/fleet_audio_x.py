"""Audio seconds decoded per second of the window's wall: every job of the
window whole, the clock stopped at the end of the last."""


def read(ctx):
    return ctx["audio_s"] / ctx["window_s"]
