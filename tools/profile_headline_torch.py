"""Span-traced run of ``bench_torch.py``'s headline on the card: where the
wall of one warm ``BatchDecoder`` decode of the headline goes.

One warm-up decode, then one decode with the port's spans enabled
(``nvorbis_tpu_torch/utils/profiling.py``).  The span table
(``profiling.report``) goes to stderr; stdout carries one JSON line with
each span's seconds, calls and the threads it ran on (``SPANS``), the
wall, x-realtime and chunks of the traced decode, and the card's
nvidia-smi name and power limit.  ``NESTED`` names
the span each lies in: ``batch.headers`` and ``batch.packetize`` in
``batch.open``; ``batch.pull``, ``batch.unpack``, ``batch.plan`` and
``batch.gather`` in ``batch.collect``; ``batch.stage``,
``batch.segments``, ``batch.program`` and ``batch.copy_start`` in
``batch.dispatch``; ``batch.upload`` in ``batch.program``; ``batch.emit``
in ``batch.fetch``.  ``batch.fetch`` runs on the ``nvt-fetch`` worker
while the main thread collects and dispatches the next chunk, and
``batch.wait`` is the main thread waiting for it, so the spans overlap
and do not add up to the wall.

Usage: python tools/profile_headline_torch.py [streams] [repeats]
(defaults ``bench_torch.py``'s: ``NVT_BENCH_STREAMS``, 8 copies, of the
stereo stream at ``NVT_BENCH_REPEATS``, 4 repeats: 422 s each).  The
port's benchmarks run on the card's machine: without a CUDA card this
exits 2 and prints nothing on stdout.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench_torch  # noqa: E402  (the repo root, inserted above)

SPANS = ("batch.open", "batch.headers", "batch.packetize", "batch.collect",
         "batch.pull", "batch.unpack", "batch.plan", "batch.gather",
         "batch.dispatch", "batch.stage", "batch.segments", "batch.program",
         "batch.upload", "batch.copy_start", "batch.wait", "batch.fetch",
         "batch.emit")
NESTED = {"batch.headers": "batch.open", "batch.packetize": "batch.open",
          "batch.pull": "batch.collect", "batch.unpack": "batch.collect",
          "batch.plan": "batch.collect", "batch.gather": "batch.collect",
          "batch.stage": "batch.dispatch",
          "batch.segments": "batch.dispatch",
          "batch.program": "batch.dispatch",
          "batch.copy_start": "batch.dispatch",
          "batch.upload": "batch.program", "batch.emit": "batch.fetch"}


def profile(raws, device="cuda"):
    """A warm-up and one span-traced ``BatchDecoder`` decode of ``raws`` on
    ``device``; returns the JSON line's fields (without the card's)."""
    import nvorbis_tpu_torch as nvt
    from nvorbis_tpu_torch.utils import profiling

    def once():
        bd = nvt.BatchDecoder(raws, device=device)
        outs = bd.decode_all()
        if bd.routes != ["device"] * len(raws):
            raise RuntimeError(f"routes {sorted(set(bd.routes))}, "
                               "not all device")
        return bench_torch.audio_of(bd, outs), bd.chunks

    once()
    was = profiling.enabled()
    profiling.enable(True)
    profiling.reset()
    try:
        t0 = time.perf_counter()
        audio, chunks = once()
        wall = time.perf_counter() - t0
        spans, on = profiling.snapshot(), profiling.threads()
        table = profiling.report()
    finally:
        profiling.enable(was)
        profiling.reset()
    return {
        "metric": "profile_headline", "device": str(device),
        "streams": len(raws), "audio_seconds": audio, "chunks": chunks,
        "wall_seconds": wall, "x_realtime": audio / wall,
        "spans": {k: {"seconds": spans.get(k, (0.0, 0))[0],
                      "calls": spans.get(k, (0.0, 0))[1],
                      "threads": on.get(k, [])} for k in SPANS},
        "nested": NESTED, "report": table,
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not bench_torch.have_card("profile_headline_torch"):
        return 2
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    for name, value in zip(("NVT_BENCH_STREAMS", "NVT_BENCH_REPEATS"), argv):
        os.environ[name] = value
    line = profile(bench_torch.headline_raws())
    print(line.pop("report"), file=sys.stderr)
    line.update({"card": bench_torch.card_info(),
                 "kind": torch.cuda.get_device_name(0)})
    bench_torch.assert_no_jax()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
