"""Run one cell of the benchmark once.

    python -m vorbench.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

Set-up assembles the cell's streams from the committed pool, orders the
fleet by ``--seed`` and decodes whole jobs of the cell's own composition
until a job runs no program eagerly (every program key captured; the next
jobs replay).  The window then runs jobs back to back until ``--seconds``
have passed and stops the clock at the end of the job in flight.  After it,
the sample of the window's PCM is held to the reference
(:mod:`vorbench.check`), and the metrics of ``BENCHMARK.json`` are read by
their files under ``vorbench/metrics/``.  The last line of standard output
is the result, one JSON object; the last lines of standard error give each
compared number beside its limit.  ``--trace 1`` reports the per-layer
metrics instead of the end-to-end ones, from the program's spans and a
``torch.profiler`` trace of the window.

Exits 2 without printing a result when the machine has fewer cards than the
cell asks for, and 3 when a JAX module or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from collections import Counter, defaultdict  # noqa: E402

import numpy as np  # noqa: E402

from vorbench import cells, check, roofline, streams, window  # noqa: E402

BANNED = frozenset({"jax", "jaxlib", "flax", "nvorbis_tpu"})
MAX_WARMUP_JOBS = 4


HOST_COUNTERS = ("cpu_s", "sys_s", "main_cpu_s")


def host_counters():
    """This process's user and system CPU seconds and its main thread's CPU
    seconds, as :data:`HOST_COUNTERS` names them."""
    me = resource.getrusage(resource.RUSAGE_SELF)
    main = resource.getrusage(resource.RUSAGE_THREAD)
    return me.ru_utime, me.ru_stime, main.ru_utime + main.ru_stime


def banned_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


class Spans:
    """The harness's own spans: totals by name, and on the profiler's
    timeline too while ``timeline`` is set."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.timeline = False

    @contextlib.contextmanager
    def span(self, name):
        if self.timeline:
            from torch.profiler import record_function
            ctx = record_function(name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0


class Cell:
    """A cell's streams, assembled once; :meth:`jobs` orders them by seed."""

    def __init__(self, bench, name, root=cells.ROOT):
        self.workload = cells.workload(bench, name)
        self.config = cells.config(bench, self.workload["config"], root)
        self.traffic = cells.traffic(self.workload["traffic"], root)
        self.entry = cells.entry(self.traffic["entry"], root)
        rate = self.config["sample_rate"]
        self.channels = self.config["channels"]
        headers, runs = streams.segments(self.config)
        self.blobs, self.sizes, self.packet_bytes = [], [], 0
        for k, n in enumerate(streams.stream_lengths(self.traffic, rate)):
            order = np.random.default_rng(
                [self.traffic["lengths_seed"], k, 0x6F72]).permutation(
                len(runs))
            blob, packets, sizes = streams.assemble(headers, runs, n, order,
                                                    serial=k + 1)
            self.blobs.append(blob)
            self.sizes.append(np.asarray(sizes))
            self.packet_bytes += sum(len(p) for p in packets)
        samples = [int(check.starts(s)[-1]) for s in self.sizes]
        self.audio_s = sum(samples) / rate
        self.work = roofline.job_work(self.sizes, samples, self.packet_bytes,
                                      self.channels)

    def jobs(self, seed):
        """``(blobs, sample)``: the job's streams in the seed's order, and
        the seed's check sample over them."""
        perm = np.random.default_rng([seed, 0x666C]).permutation(
            len(self.blobs))
        blobs = [self.blobs[i] for i in perm]
        sizes = [self.sizes[i] for i in perm]
        spec = self.traffic["check"]
        return blobs, check.Sample(seed, sizes, spec["strata"],
                                   spec["packets"])


def run_cell(bench, name, seed, seconds, trace, device, root=cells.ROOT,
             max_warmup=MAX_WARMUP_JOBS):
    """One run of a cell: ``(result, compared, info)``."""
    import torch

    t_cell = time.perf_counter()
    cell = Cell(bench, name, root)
    blobs, sample = cell.jobs(seed)
    t_cell = time.perf_counter() - t_cell
    spans = Spans()
    programs = Counter()

    job_stats = []  # per job: what :func:`host_counters` moved

    def run_job():
        before = host_counters()
        outputs, runs = cell.entry.run_job(blobs, device, spans)
        programs.update(runs)
        after = host_counters()
        job_stats.append([round(a - b, 3) for a, b in zip(after, before)])
        return outputs

    warm = []
    for _ in range(max_warmup):
        programs.clear()
        t0 = time.perf_counter()
        run_job()
        warm.append({**programs, "s": time.perf_counter() - t0})
        if programs["eager"] == 0:
            break
    programs.clear()
    spans.totals.clear()
    del job_stats[:]
    keeper = check.Keeper(sample, cell.channels)
    gc.collect()
    gc.freeze()  # what set-up made is never traversed in the window

    prof = None
    on_card = torch.device(device).type == "cuda"
    if trace:
        prof = _start_trace(spans, on_card)
    setup_s = time.perf_counter() - T_START
    with (spans.span("bench.window") if trace else contextlib.nullcontext()):
        wall, walls = window.run_window(lambda k: run_job(), seconds,
                                        keeper.keep)
    port_spans = {}
    summary = None
    if trace:
        port_spans = _stop_trace(prof)
        from vorbench import trace as trace_mod
        summary = trace_mod.summarize(prof)
    jobs = len(walls)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.unfreeze()
    gc.collect()

    limits = cell.config["check"]
    compared, info = check.compare(blobs, keeper)
    correct = check.verdict(compared, limits)
    failed = compared["length_mismatches"] + (
        0 if compared["pcm_gap"] <= limits["pcm_gap"] else 1)

    ctx = {
        "setup_s": setup_s, "window_s": wall, "jobs": jobs,
        "job_walls": walls, "audio_s": cell.audio_s * jobs,
        "spans": {**port_spans, **spans.totals},
        "programs": dict(programs), "trace": summary,
        "work": {"bytes": cell.work[0] * jobs, "flops": cell.work[1] * jobs},
        "device": torch.cuda.get_device_name() if on_card else "cpu",
    }
    metrics = {}
    for m in cells.metrics(bench, name, trace):
        value = cells.metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": ctx["device"],
           "count": cell.workload["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": info["answers"],
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": compared[k], "limit": limits[k]}
                        for k in limits}
    info.update(jobs=jobs, window_s=wall, job_walls=walls, warmup=warm,
                programs=dict(programs), setup_s=setup_s, cell_s=t_cell,
                job_stats=job_stats, job_stats_keys=HOST_COUNTERS,
                audio_s_per_job=cell.audio_s)
    return result, compared, info


def _start_trace(spans, on_card):
    """Enable the program's spans, put them on the profiler's timeline
    beside the harness's, and start the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from nvorbis_tpu_torch.parallel import batch
    from nvorbis_tpu_torch.utils import profiling

    program_span = profiling.span

    @contextlib.contextmanager
    def span_on_timeline(label):
        with program_span(label), record_function(label):
            yield

    batch.span = span_on_timeline
    profiling.enable(True)
    profiling.reset()
    spans.timeline = True
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_trace(prof):
    """Stop the profiler; the program's span totals over the window."""
    from nvorbis_tpu_torch.utils import profiling

    prof.__exit__(None, None, None)
    totals = {k: v[0] for k, v in profiling.snapshot().items()}
    profiling.enable(False)
    return totals


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = cells.load_benchmark()
    chips = cells.workload(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vorbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result, compared, info = run_cell(bench, args.workload, args.seed,
                                      args.seconds, bool(args.trace), "cuda")
    found = banned_modules()
    if found:
        print(f"vorbench: loaded {', '.join(found)}, which the port must "
              "not import", file=sys.stderr)
        return 3
    print("run " + json.dumps({k: info[k] for k in (
        "jobs", "window_s", "job_walls", "setup_s", "cell_s",
        "audio_s_per_job", "warmup", "job_stats_keys", "job_stats",
        "programs", "segments", "samples", "clipped_samples", "answers")}),
        file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
