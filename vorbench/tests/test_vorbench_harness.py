"""The benchmark harness on the CPU, at tiny sizes.

Run with ``python -m pytest vorbench/tests``.  The cells run here through
``run_cell(..., device="cpu")``, the chip check skipped; the ``cuda``-marked
test runs a tiny cell on the card and skips without one.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from vorbench import cells, check, roofline, run, streams, window
from vorbench.reference import vorbis as rv

REPO = cells.ROOT
TINY = {"entry": "fleet", "streams": 3, "seconds": [4, 6], "lengths_seed": 1,
        "check": {"strata": 64, "packets": 4}}


def tiny_root(tmp_path, traffic=TINY, config="stereo44k_q5"):
    """A copy of the benchmark's files (the pool left where it is) whose
    BENCHMARK.json has one more cell, ``<config>.tiny``, of ``traffic``,
    in every per-layer metric's list, and ``config`` among its
    configurations.  The stereo configuration, which no cell of the
    benchmark runs yet, takes the symbol lane; the 5.1 one the dense."""
    shutil.copytree(os.path.join(REPO, "vorbench"), tmp_path / "vorbench",
                    ignore=shutil.ignore_patterns("pool", "__pycache__"))
    bench = cells.load_benchmark()
    if config not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({
            "name": config, "source": "test", "reduced": [], "why": "test",
            "file": f"vorbench/configs/{config}.json"})
    name = f"{config}.tiny"
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "vorbench" / "traffic" / "tiny.json").write_text(
        json.dumps(traffic))
    return bench, name


def test_window_ends_on_a_job_boundary():
    """Jobs of 3 s against a 10 s window: the fourth job is in flight at
    10 s, and the clock stops at its end, 12 s; the rate counts all four."""
    now = [0.0]
    kept = []

    def job(k):
        now[0] += 3.0
        return k

    wall, walls = window.run_window(job, 10.0, lambda k, r: kept.append(r),
                                    clock=lambda: now[0])
    assert (wall, walls, kept) == (12.0, [3.0] * 4, [0, 1, 2, 3])
    rate = cells.metric_reader("fleet_audio_x")(
        {"audio_s": 100.0 * len(walls), "window_s": wall})
    assert rate == 400.0 / 12.0


def test_synth_roofline_counts_pcm_and_packets_once():
    """A tiny stream: the work is its float32 PCM written once plus its
    audio packets read once, and an FFT-sized IMDCT per channel and
    packet."""
    config = json.load(open(os.path.join(REPO, "vorbench", "configs",
                                         "stereo44k_q5.json")))
    headers, runs = streams.segments(config)
    blob, packets, sizes = streams.assemble(headers, runs, 44100, [0], 9)
    samples = int(check.starts(sizes)[-1])
    assert samples == rv.Stream(blob).length >= 44100
    nbytes, flops = roofline.job_work([np.asarray(sizes)], [samples],
                                      sum(map(len, packets)), 2)
    assert nbytes == 4 * 2 * samples + sum(map(len, packets))
    n = np.asarray(sizes)
    assert flops == pytest.approx(
        2 * sum(5 * (k / 4) * np.log2(k / 4) + 3 * k for k in n))
    secs, bound = roofline.least_seconds(nbytes, flops,
                                         "NVIDIA H100 80GB HBM3")
    assert bound == "bytes" and secs == nbytes / 3.35e12


def test_the_sample_reaches_every_run_of_two_strata():
    """Every stream's first and last packets are compared, and every run of
    the fleet's packets (in fleet order) as long as two strata holds the
    first packet of a segment, so no chunk of that size goes unchecked."""
    rng = np.random.default_rng(4)
    sizes = [rng.choice([256, 2048], int(n)) for n in (90, 7, 300, 45)]
    strata, packets = 40, 4
    sample = check.Sample(123, sizes, strata, packets)
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in sizes])])
    firsts = sorted(int(offsets[s]) + f for s, f, _ in sample.segments)
    for s, n in enumerate(len(x) for x in sizes):
        assert (s, 0, min(n, packets)) in sample.segments
        assert (s, n - packets, packets) in sample.segments or n <= packets
    assert all(f + c <= len(sizes[s]) for s, f, c in sample.segments)
    assert len(sample.segments) == 2 * len(sizes) + strata
    run_len = 2 * -(-int(offsets[-1]) // strata)
    for a in range(int(offsets[-1]) - run_len + 1):
        assert any(a <= f < a + run_len for f in firsts), a


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("nvorbis_tpu_torch", "nvorbis_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert "nvorbis_tpu" not in run.banned_modules()
    for name, top in (("nvorbis_tpu.ops", "nvorbis_tpu"), ("jax", "jax"),
                      ("jaxlib.xla", "jaxlib"), ("flax.nn", "flax")):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert top in run.banned_modules()


def test_a_cell_run_loads_no_jax(tmp_path):
    """A whole run of a tiny cell, in a process of its own, leaves no JAX
    module and nothing of the JAX package in ``sys.modules``."""
    tiny_root(tmp_path)
    code = (
        "import json, sys; from vorbench import cells, run; "
        f"root = {str(tmp_path)!r}; "
        "bench = cells.load_benchmark(root); "
        "res, _, _ = run.run_cell(bench, 'stereo44k_q5.tiny', 3, 0.1, "
        "False, 'cpu', root=root, max_warmup=1); "
        "print(json.dumps([res['correct'], run.banned_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    assert json.loads(out.splitlines()[-1]) == [True, []]


def test_cells_traffic_and_metrics_are_found_as_files(tmp_path):
    """A cell, its traffic and a per-layer metric added as files and
    entries only: the harness runs the cell and reports the metric."""
    bench, name = tiny_root(tmp_path)
    (tmp_path / "vorbench" / "metrics" / "fleet.jobs.py").write_text(
        "def read(ctx):\n    return float(ctx['jobs'])\n")
    bench["per_layer"].append({
        "name": "fleet.jobs", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "device",
        "moves": "fleet_audio_x", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = cells.load_benchmark(str(tmp_path))
    result, compared, info = run.run_cell(bench, name, 11, 0.5, True, "cpu",
                                          root=str(tmp_path), max_warmup=1)
    assert result["correct"], compared
    assert result["metrics"]["fleet.jobs"]["value"] == info["jobs"] >= 1
    assert "fleet.open_share" in result["metrics"]
    assert list(result)[-1] == "checks"
    e2e, _, _ = run.run_cell(bench, name, 11, 0.2, False, "cpu",
                             root=str(tmp_path), max_warmup=1)
    assert set(e2e["metrics"]) == {"fleet_audio_x", "setup_s"}


def test_ogg_crc_matches_the_pool_pages():
    path = streams.pool_files({"name": "stereo44k_q5"})[0]
    data = open(path, "rb").read()
    pos = 0
    for _ in range(6):
        nseg = data[pos + 26]
        end = pos + 27 + nseg + sum(data[pos + 27:pos + 27 + nseg])
        page = bytearray(data[pos:end])
        crc = int.from_bytes(page[22:26], "little")
        page[22:26] = bytes(4)
        assert streams.ogg_crc(bytes(page)) == crc
        pos = end


@pytest.mark.parametrize("config", ["stereo44k_q5", "surround51_48k_q5"])
def test_reference_agrees_with_libvorbis(tmp_path, config):
    """The reference decodes an assembled stream (runs of two encodes
    joined) as libvorbisfile does, and a run of packets from the packet
    before it as the whole decode does."""
    from ctypes.util import find_library
    if find_library("vorbisfile") is None:
        pytest.skip("libvorbisfile is not installed")
    import ctypes
    cfg = json.load(open(os.path.join(REPO, "vorbench", "configs",
                                      f"{config}.json")))
    headers, runs = streams.segments(cfg)
    seconds = cfg["pool"]["seconds"] + 5  # past the seam of the runs
    blob, _, _ = streams.assemble(headers, runs[:2],
                                  seconds * cfg["sample_rate"], [1, 0], 5)
    st = rv.Stream(blob)
    whole = st.decode(0, len(st.audio))
    path = tmp_path / "s.ogg"
    path.write_bytes(blob)
    vf = ctypes.CDLL(find_library("vorbisfile"))
    ov = ctypes.create_string_buffer(8192)
    vf.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    assert vf.ov_fopen(str(path).encode(), ov) == 0
    vf.ov_read_float.restype = ctypes.c_long
    vf.ov_read_float.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p]
    pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
    got = []
    while True:
        n = vf.ov_read_float(ov, ctypes.byref(pcm), 4096, None)
        if n <= 0:
            break
        got.append(np.stack([np.ctypeslib.as_array(pcm[c], (n,)).copy()
                             for c in range(st.channels)], 1))
    vf.ov_clear.argtypes = [ctypes.c_void_p]
    vf.ov_clear(ov)
    lib = np.clip(np.concatenate(got).reshape(-1), -1, 1)
    assert len(lib) == len(whole) == st.length * st.channels
    assert np.abs(lib - whole).max() < 1e-6
    a = 100
    part = st.decode(a, 37)
    assert np.array_equal(part, whole[st.start[a] * st.channels:][:len(part)])


@pytest.mark.cuda
def test_a_tiny_cell_is_correct_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench, name = tiny_root(tmp_path)
    bench = cells.load_benchmark(str(tmp_path))
    result, compared, _ = run.run_cell(bench, name, 5, 1.0, True, "cuda",
                                       root=str(tmp_path))
    assert result["correct"], compared
    assert result["metrics"]["fleet.replayed_share"]["value"] == 100.0


class _Event:
    def __init__(self, name, device, start, end, thread=1, kind=""):
        self._v = (name, device, start, end, thread, kind)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]


def test_trace_reading_splits_idle_time_by_innermost_span():
    """Busy is the union of the device's intervals (not the annotations
    that mirror host spans); each idle piece goes to the innermost span
    the main thread was in."""
    from vorbench import trace

    ev = [_Event("bench.window", "CPU", 0, 100),
          _Event("bench.decode", "CPU", 0, 90),
          _Event("batch.collect", "CPU", 10, 40),
          _Event("batch.unpack", "CPU", 20, 30),
          _Event("batch.fetch", "CPU", 0, 100, thread=2),
          _Event("batch.collect", "CUDA", 10, 40, kind="gpu_user_annotation"),
          _Event("kern", "CUDA", 40, 50, kind="kernel"),
          _Event("Memcpy HtoD (Pageable -> Device)", "CUDA", 45, 60,
                 kind="gpu_memcpy")]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    s = trace.summarize(prof)
    assert s["window_s"] == 100e-9 and s["busy_s"] == 20e-9
    assert s["kernel_s"] == 10e-9
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"bench.decode": 40e-9, "batch.collect": 20e-9,
         "batch.unpack": 10e-9, "host": 10e-9})
