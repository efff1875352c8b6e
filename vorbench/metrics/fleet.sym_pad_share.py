"""Share of the symbol lane's staged VQ ids that are padding: the
program's ``sym.ids_staged`` counter (every bucket's id vector as the
chunk programs receive it, padded to ``IDS_QUANTUM``) less its ``sym.ids``
counter (the ids of the chunk's frames and carried frames), over the
first, both over the window.  A dense-lane fleet, or a program without the
counters, reads nothing."""


def read(ctx):
    from nvorbis_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    totals = counters()
    staged = totals.get("sym.ids_staged")
    held = totals.get("sym.ids")
    if not staged or held is None:
        return None
    return 100.0 * (staged - held) / staged
