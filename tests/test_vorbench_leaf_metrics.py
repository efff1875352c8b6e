"""The benchmark's per-layer metrics of the fleet's leaf spans and
counters, read from traced tiny CPU runs of the 5.1 configuration (the
dense lane) and the stereo one (the symbol lane), as the harness reads them
on the card; the symbol-form roofline on hand-made traces; and the cells of
``BENCHMARK.json`` found as files."""

import pytest

from nvorbis_tpu_torch.utils import profiling
from vorbench import cells, run
from vorbench.tests.test_vorbench_harness import tiny_root

LEAF_METRICS = (
    "fleet.packetize_share", "fleet.pull_share", "fleet.plan_share",
    "fleet.gather_share", "fleet.stage_share", "fleet.segments_share",
    "fleet.upload_share", "fleet.wait_share", "fleet.upload_mb_per_audio_s",
)


def test_a_traced_run_reports_every_leaf_metric(tmp_path):
    """Each of the nine metrics is a number; the shares lie in [0, 100],
    the dispatch's leaves add up to no more than it, and the upload
    volume is the dense residue's 6 x 48,000 float32 an audio second and
    at most a quarter more (bucket padding, posts and segment tables)."""
    bench, name = tiny_root(tmp_path, config="surround51_48k_q5")
    bench = cells.load_benchmark(str(tmp_path))
    result, compared, _ = run.run_cell(bench, name, 2**31 + 17, 0.3, True,
                                       "cpu", root=str(tmp_path),
                                       max_warmup=1)
    assert result["correct"], compared
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for m in LEAF_METRICS:
        assert isinstance(got.get(m), float), m
        assert 0.0 <= got[m] <= 100.0, (m, got[m])
    assert result["metrics"]["fleet.upload_mb_per_audio_s"]["unit"] == \
        "MB/audio_s"
    assert 1.152 <= got["fleet.upload_mb_per_audio_s"] <= 1.152 * 1.25 + 0.05
    dispatch = got["fleet.stage_share"] + got["fleet.segments_share"]
    assert dispatch <= got["fleet.dispatch_share"]


@pytest.mark.parametrize("pinned, total, want", [
    (None, 4096, None),  # a program without the counter: nothing
    (0, 4096, 0.0),  # the CPU device: nothing page-locked
    (1024, 4096, 25.0),
    (4096, 4096, 100.0),  # every argument from the card's staging ring
    (0, 0, None),  # no upload in the window
])
def test_pinned_upload_share_reads_the_two_counters(pinned, total, want):
    """``fleet.pinned_upload_share`` is ``stage.pinned_bytes`` over
    ``upload.bytes`` in percent, and nothing where the first counter is
    missing or nothing was uploaded."""
    read = cells.metric_reader("fleet.pinned_upload_share")
    was = profiling.enabled()
    profiling.enable(True)
    profiling.reset()
    try:
        profiling.count("upload.bytes", total)
        if pinned is not None:
            profiling.count("stage.pinned_bytes", pinned)
        assert read({"audio_s": 1.0, "window_s": 1.0, "spans": {}}) == want
    finally:
        profiling.enable(was)
        profiling.reset()


# a fleet_tracks-shaped cell at a size the CPU decodes in seconds
TINY_TRACKS = {"entry": "fleet", "streams": 3, "seconds": [2, 4],
               "lengths_seed": 3, "check": {"strata": 32, "packets": 4}}


def test_a_traced_stereo_run_reads_the_symbol_lane(tmp_path):
    """A traced tiny run of the stereo configuration is correct, takes the
    symbol lane (its id counters move), and reads ``fleet.ids_share`` and
    ``fleet.sym_pad_share`` as numbers in [0, 100]; off the card the
    symbol-form roofline reads nothing."""
    bench, name = tiny_root(tmp_path, traffic=TINY_TRACKS,
                            config="stereo44k_q5")
    bench = cells.load_benchmark(str(tmp_path))
    try:
        result, compared, _ = run.run_cell(bench, name, 2**31 + 29, 0.3,
                                           True, "cpu", root=str(tmp_path),
                                           max_warmup=1)
        totals = profiling.counters()
    finally:
        profiling.reset()
    assert result["correct"], compared
    assert totals["sym.ids_staged"] >= totals["sym.ids"] > 0
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for m in ("fleet.ids_share", "fleet.sym_pad_share"):
        assert isinstance(got.get(m), float), m
        assert 0.0 <= got[m] <= 100.0, (m, got[m])
        assert result["metrics"][m]["unit"] == "%"
    assert got["fleet.ids_share"] <= got["fleet.stage_share"]
    assert "fleet.floor_sym_roofline" not in got


H100 = "NVIDIA H100 80GB HBM3"
SYM8 = ("void (anonymous namespace)::floor_couple_kernel<8>((anonymous "
        "namespace)::Args, (anonymous namespace)::Coupling)")
DENSE = SYM8.replace("<8>", "<0>")


@pytest.mark.parametrize("device, ops, want", [
    ("cpu", [[SYM8, 0.004]], None),  # off the card
    (H100, [[DENSE, 0.004], ["imdct_window_kernel<11>", 0.5]], None),
    (H100, [[SYM8, 0.004]], 25.0),
    (H100, [[DENSE, 1.0], [SYM8, 0.004], ["Memcpy HtoD", 2.0]], 25.0),
    (H100, [[SYM8, 0.003], [SYM8.replace("<8>", "<2>"), 0.001]], 25.0),
    # the names with their punctuation made underscores
    (H100, [["void__anonymous_namespace_::floor_couple_kernel_8___anon",
             0.002], ["void__anonymous_namespace_::floor_couple_kernel_0___",
                      0.5]], 50.0),
])
def test_floor_sym_roofline_reads_the_symbol_form_alone(device, ops, want):
    """``fleet.floor_sym_roofline`` is the window's bytes at 3.35 TB/s over
    the device time of the floor kernel's instantiations with S >= 1; the
    dense form (S = 0) and every other op are left out, and a run off the
    card or without the symbol form reads nothing."""
    read = cells.metric_reader("fleet.floor_sym_roofline")
    ctx = {"device": device, "work": {"bytes": 3.35e9, "flops": 1.0},
           "trace": {"device_ops": ops, "kernel_s": 1.0, "busy_s": 1.0,
                     "window_s": 2.0}}
    got = read(ctx)
    assert got == (None if want is None else pytest.approx(want))
    assert read({**ctx, "trace": None}) is None


@pytest.mark.parametrize("staged, held, want", [
    (None, None, None),  # a dense-lane fleet, or a program without them
    (4096, 4096, 0.0),
    (4096, 3072, 25.0),
    (0, 0, None),
])
def test_sym_pad_share_reads_the_two_counters(staged, held, want):
    """``fleet.sym_pad_share`` is the padding's share of the staged ids in
    percent, and nothing where the counters are missing or empty."""
    read = cells.metric_reader("fleet.sym_pad_share")
    was = profiling.enabled()
    profiling.enable(True)
    profiling.reset()
    try:
        if staged is not None:
            profiling.count("sym.ids_staged", staged)
            profiling.count("sym.ids", held)
        assert read({"audio_s": 1.0, "window_s": 1.0, "spans": {}}) == want
    finally:
        profiling.enable(was)
        profiling.reset()


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  cells.load_benchmark()["workloads"]])
def test_every_cell_resolves_as_files(cell):
    """Each cell of ``BENCHMARK.json`` finds its configuration, traffic
    and entry kind as files, asks for one card, and every per-layer metric
    that lists it has a reader under ``vorbench/metrics/``."""
    bench = cells.load_benchmark()
    w = cells.workload(bench, cell)
    assert cell == f"{w['config']}.{w['traffic']}" and w["chips"] == 1
    assert cells.config(bench, w["config"])["name"] == w["config"]
    traffic = cells.traffic(w["traffic"])
    assert callable(cells.entry(traffic["entry"]).run_job)
    listed = [m["name"] for m in bench["per_layer"]
              if cell in m.get("workloads", ())]
    assert listed
    for m in listed + [m["name"] for m in cells.metrics(bench, cell, False)]:
        assert callable(cells.metric_reader(m)), m


def test_the_tracks_cell_is_the_stereo_symbol_lane_fleet():
    """``stereo44k_q5.fleet_tracks``: the committed stereo configuration,
    cut in nothing, and 32 tracks of 180-300 s in one fleet, with the
    three symbol-lane metrics listing it."""
    bench = cells.load_benchmark()
    conf = next(c for c in bench["configs"] if c["name"] == "stereo44k_q5")
    assert conf["file"] == "vorbench/configs/stereo44k_q5.json"
    assert conf["reduced"] == []
    traffic = cells.traffic("fleet_tracks")
    assert {k: traffic[k] for k in ("entry", "streams", "seconds",
                                    "lengths_seed", "check")} == {
        "entry": "fleet", "streams": 32, "seconds": [180, 300],
        "lengths_seed": 32, "check": {"strata": 512, "packets": 4}}
    mine = {m["name"] for m in bench["per_layer"]
            if "stereo44k_q5.fleet_tracks" in m.get("workloads", ())}
    assert mine == {"fleet.ids_share", "fleet.sym_pad_share",
                    "fleet.floor_sym_roofline"}
