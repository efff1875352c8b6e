"""Tracing of the port: host spans, counters and device-stage spans.

``span(label)`` accumulates wall time + call counts per label; disabled, it
is a flag test in a no-op context.  Enable with
``NVT_TRACE=1`` (or :func:`enable`); the decode engines wrap their phases
(collect / unpack / dispatch / fetch, and their leaves) so a decode prints
a phase breakdown via :func:`report`, with the threads each phase ran on
(:func:`threads`): the fetch and emit run on the fetch worker, so the
totals overlap and do not add up to the wall.  While a ``torch.profiler``
records the current thread (the one that started it), an enabled span is
also a ``record_function`` span of the same name, so the profiler stamps
it on the CUDA activity's timeline, nested in the spans around it.

``count(name, n)`` adds ``n`` to a counter while tracing is enabled
(:func:`counters`); ``upload.bytes`` counts the numpy arguments that the
chunk programs take from the host (``engine/programs.py``); on the symbol
lane ``sym.ids`` counts the VQ ids a chunk stages, ``sym.ids_copied`` those
the native row copy wrote (equal to it) and ``sym.ids_staged`` the padded
id vectors (``parallel/batch.py``).

``stage(name)`` names the torch launches made inside it for
``torch.profiler``: a ``record_function`` span, by which chip_smoke.py's
``trace_split`` attributes device time to a stage (``nvt.rows``,
``nvt.floor``, ``nvt.imdct``, ...).  The span is entered only while a
profiler runs; outside one it would still cost a dispatcher call of host
time per span on paths that the host's launch rate binds.
"""

import contextlib
import os
import threading
import time
from collections import defaultdict
from contextlib import nullcontext

import torch
from torch.profiler import record_function

_enabled = os.environ.get("NVT_TRACE", "") not in ("", "0")
_lock = threading.Lock()
_spans = defaultdict(lambda: [0.0, 0])  # label -> [seconds, calls]
_threads = defaultdict(set)  # label -> names of the threads it ran on
_counters = defaultdict(int)  # name -> total
_OFF = nullcontext()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def span(label: str):
    """Time a block under ``label`` (no-op unless tracing is enabled); while
    a profiler records this thread, the block is its ``record_function``
    span too (:func:`stage`)."""
    if not _enabled:
        yield
        return
    with stage(label):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            name = threading.current_thread().name
            with _lock:
                s = _spans[label]
                s[0] += dt
                s[1] += 1
                _threads[label].add(name)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` (a no-op unless tracing is
    enabled)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] += int(n)


def reset() -> None:
    with _lock:
        _spans.clear()
        _threads.clear()
        _counters.clear()


def snapshot():
    """{label: (seconds, calls)} accumulated since the last reset."""
    with _lock:
        return {k: tuple(v) for k, v in _spans.items()}


def threads():
    """{label: sorted names of the threads its spans ran on} since the
    last reset.  Spans of different threads overlap in time (the chunk
    loops' fetch worker), so their totals do not add up to a wall."""
    with _lock:
        return {k: sorted(v) for k, v in _threads.items()}


def counters():
    """{name: total} counted since the last reset."""
    with _lock:
        return dict(_counters)


def report(stream=None) -> str:
    """Render (and optionally print) the span table, slowest first, with
    the threads each span ran on, and the counters under it."""
    rows = sorted(snapshot().items(), key=lambda kv: -kv[1][0])
    on = threads()
    width = max((len(k) for k, _ in rows), default=5)
    lines = [f"{'span':<{width}}  {'total_s':>9}  {'calls':>7}  "
             f"{'ms/call':>8}  threads"]
    for label, (sec, calls) in rows:
        lines.append(
            f"{label:<{width}}  {sec:>9.3f}  {calls:>7d}  "
            f"{sec / calls * 1e3:>8.2f}  {','.join(on.get(label, ()))}"
        )
    totals = sorted(counters().items())
    if totals:
        width = max(len(k) for k, _ in totals)
        lines.append("")
        lines.append(f"{'counter':<{width}}  {'total':>15}")
        lines += [f"{k:<{width}}  {v:>15,}" for k, v in totals]
    text = "\n".join(lines)
    if stream is not None:
        print(text, file=stream)
    return text


def stage(name):
    """A ``record_function(name)`` span while a profiler runs, else a
    no-op context."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF
