"""Reading a ``torch.profiler`` trace of the window.

The device's busy time is the union of its kernel, memcpy and memset
intervals inside the window, which a ``bench.window`` span on the main
thread marks (not the annotations by which the profiler mirrors host spans
on the device's timeline).  The idle time between them is put down, piece
by piece, to the innermost host span (``bench.*`` of the harness,
``batch.*`` of the program) that the main thread was in, or to ``host``
where it was in none.
"""

from collections import defaultdict

WINDOW = "bench.window"


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return f()
    return int(getattr(e, f"{what}_us")() * 1000)


def summarize(prof, groups=("batch.", "bench.")):
    """``{window_s, busy_s, kernel_s, device_ops, idle_gaps}`` of the
    profiler ``prof`` after it stopped; None where the trace holds no
    window span.  ``groups`` are the prefixes of the host spans."""
    events = prof.profiler.kineto_results.events()
    window = None
    host = []
    device = []
    for e in events:
        name = e.name()
        if "CUDA" in str(e.device_type()):
            # the device's own work: not the copies of host spans that the
            # profiler lays on the device's timeline as annotations
            kind = str(getattr(e, "activity_type", lambda: "")())
            if "annotation" not in kind and not name.startswith(groups):
                device.append((_ns(e, "start"), _ns(e, "end"), name))
        elif name == WINDOW:
            window = (_ns(e, "start"), _ns(e, "end"), e.start_thread_id())
        elif name.startswith(groups):
            host.append((_ns(e, "start"), _ns(e, "end"), name,
                         e.start_thread_id()))
    if window is None:
        return None
    w0, w1, main = window
    device = [(max(a, w0), min(b, w1), n) for a, b, n in device
              if b > w0 and a < w1]
    device.sort()
    by_name = defaultdict(int)
    kernel_ns = 0
    for a, b, n in device:
        by_name[n] += b - a
        if not n.startswith(("Memcpy", "Memset")):
            kernel_ns += b - a
    # the union of the device's intervals, and the gaps between them
    busy = 0
    gaps = []
    cur = w0
    for a, b, _ in device:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    idle = defaultdict(int)
    segs = _innermost_timeline([h for h in host if h[3] == main], w0, w1)
    k = 0
    for a, b in gaps:  # both lists sorted and disjoint: one sweep
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        m = k
        while m < len(segs) and segs[m][0] < b:
            sa, sb, name = segs[m]
            idle[name] += min(b, sb) - max(a, sa)
            m += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "device_ops": [[n[:96], ns / 1e9] for n, ns in top],
        "idle_gaps": [[n, ns / 1e9] for n, ns in gap_top],
    }


def _innermost_timeline(spans, w0, w1):
    """The window cut into ``(start, end, name)`` pieces by the innermost
    span open on one thread (spans on one thread nest), ``host`` where
    none is."""
    edges = []
    for a, b, name, _ in spans:
        edges.append((a, 1, name))
        edges.append((b, 0, name))
    edges.sort(key=lambda e: (e[0], e[1]))
    out = []
    stack = []
    t = w0
    for at, opening, name in edges:
        at = min(max(at, w0), w1)
        if at > t:
            out.append((t, at, stack[-1] if stack else "host"))
            t = at
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if t < w1:
        out.append((t, w1, stack[-1] if stack else "host"))
    return out
