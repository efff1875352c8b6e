"""The benchmark's per-layer metrics of the fleet's leaf spans and upload
counter, read from a traced tiny CPU run of the 5.1 configuration (the
dense lane), as the harness reads them on the card."""

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
