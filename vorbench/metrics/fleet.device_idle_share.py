"""Share of the traced window in which no kernel, memcpy or memset ran on
the card."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
