"""The port's tracing (``nvorbis_tpu_torch/utils/profiling.py``): the
device-stage spans, entered as ``record_function`` spans while
``torch.profiler`` runs and a no-op outside one; the host spans, which a
running profiler stamps on its own timeline; the counters; and the leaf
spans and the ``upload.bytes`` counter of a fleet decode."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from nvorbis_tpu_torch.engine import programs
from nvorbis_tpu_torch.parallel import batch as batch_mod
from nvorbis_tpu_torch.parallel.batch import BatchDecoder
from nvorbis_tpu_torch.synth.residue_sym import flatten_ids, pad_ids
from nvorbis_tpu_torch.testgen.vorbis_writer import make_simple_spec
from nvorbis_tpu_torch.utils import profiling
from nvorbis_tpu_torch.utils.profiling import stage

# the spans of a fleet decode below the phases that profile_headline_torch
# reads, with the span each lies in (None: at the top of the chunk loop)
LEAVES = {
    "batch.open": None, "batch.headers": "batch.open",
    "batch.packetize": "batch.open", "batch.pull": "batch.collect",
    "batch.plan": "batch.collect", "batch.gather": "batch.collect",
    "batch.stage": "batch.dispatch", "batch.segments": "batch.dispatch",
    "batch.copy_start": "batch.dispatch", "batch.upload": "batch.program",
    "batch.wait": None,
}


def _span_names(prof):
    return {e.name for e in prof.events()}


@pytest.fixture
def tracing():
    """Tracing on and the recorder empty for the test, off and empty
    after it."""
    profiling.enable(True)
    profiling.reset()
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.reset()


def _fleet(streams=2, packets=300, seed=0):
    return [make_simple_spec(channels=2, residue_type=2).build_stream(
        np.random.default_rng(seed + k), packets, serial=k + 1)
        for k in range(streams)]


def test_stage_is_a_span_under_the_profiler():
    """Under a profiler, ``stage`` names the ops launched inside it, as
    chip_smoke.py's trace split needs."""
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stage("nvt.probe"):
            y = x * 2 + 1
    assert float(y.sum()) == 24.0
    assert "nvt.probe" in _span_names(prof)


def test_stage_is_a_noop_without_profiler():
    """Outside a profiler, ``stage`` enters no ``record_function``: it
    returns the shared no-op context, whatever the name."""
    a, b = stage("nvt.a"), stage("nvt.b")
    assert a is b
    assert not isinstance(a, record_function)
    with a:
        assert float((torch.ones(3) + 1).sum()) == 6.0


def test_enabled_span_is_a_profiler_event_inside_its_parent(tracing):
    """Under a profiler, an enabled span is an event of its own name,
    nested in time inside the span around it on the same thread, and its
    total is kept as without a profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("t.outer"):
            x = torch.ones(64) * 2
            with profiling.span("t.inner"):
                y = x + 1
            z = y * 3
    assert float(z.sum()) == 64 * 9
    ev = {e.name: e for e in prof.events()
          if e.name in ("t.outer", "t.inner")}
    assert set(ev) == {"t.outer", "t.inner"}
    outer, inner = ev["t.outer"], ev["t.inner"]
    assert inner.thread == outer.thread
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    snap = profiling.snapshot()
    assert snap["t.outer"][1] == snap["t.inner"][1] == 1
    assert snap["t.outer"][0] >= snap["t.inner"][0] > 0


def test_disabled_span_and_count_record_nothing(monkeypatch):
    """Disabled, ``span`` times nothing and enters no ``record_function``,
    even under a profiler, and ``count`` adds to no counter."""
    was = profiling.enabled()
    profiling.enable(False)
    profiling.reset()

    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")

    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            monkeypatch.setattr(profiling, "record_function", entered)
            with profiling.span("t.off"):
                torch.ones(4).sum()
            monkeypatch.undo()
        profiling.count("t.bytes", 5)
        assert "t.off" not in _span_names(prof)
        assert profiling.snapshot() == {}
        assert profiling.counters() == {}
    finally:
        profiling.enable(was)


def test_reset_clears_spans_and_counters(tracing):
    """Counters add up while enabled, ``report`` prints them under the
    span table, and ``reset`` clears both."""
    with profiling.span("t.span"):
        pass
    profiling.count("t.bytes", 3)
    profiling.count("t.bytes", np.int64(4))
    assert profiling.counters() == {"t.bytes": 7}
    text = profiling.report()
    assert text.index("t.span") < text.index("t.bytes")
    profiling.reset()
    assert profiling.snapshot() == {} and profiling.counters() == {}
    assert profiling.threads() == {}


@pytest.mark.parametrize("lane", ["dense", "symbol"])
def test_fleet_records_every_leaf_span(tracing, monkeypatch, lane):
    """A traced CPU fleet decode records each leaf span at least once, on
    the dense lane (``NVT_NO_SYMBOLS``) and on the symbol lane."""
    if lane == "dense":
        monkeypatch.setenv("NVT_NO_SYMBOLS", "1")
    else:
        monkeypatch.delenv("NVT_NO_SYMBOLS", raising=False)
    bd = BatchDecoder(_fleet(), device="cpu")
    bd.decode_all()
    assert bd._sym == (lane == "symbol")
    snap = profiling.snapshot()
    on = profiling.threads()
    for name in LEAVES:
        assert snap.get(name, (0, 0))[1] >= 1, name
        assert on[name] == ["MainThread"], name
    assert snap["batch.packetize"][1] == snap["batch.headers"][1] == 2
    assert profiling.counters()["upload.bytes"] > 0


def test_leaf_spans_nest_in_their_phases_on_the_timeline(tracing):
    """Under a profiler, each leaf span of a fleet decode lies inside the
    phase span it splits, on the main thread."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        BatchDecoder(_fleet(), device="cpu").decode_all()
    events = [e for e in prof.events() if e.name.startswith("batch.")]
    for name, parent in LEAVES.items():
        mine = [e for e in events if e.name == name]
        assert mine, name
        if parent is None:
            continue
        outer = [e for e in events if e.name == parent]
        for e in mine:
            assert any(o.thread == e.thread
                       and o.time_range.start <= e.time_range.start
                       and e.time_range.end <= o.time_range.end
                       for o in outer), (name, parent)


def test_upload_bytes_is_the_chunk_programs_numpy_arguments(
        tracing, monkeypatch):
    """On the dense lane, ``upload.bytes`` is the sum of the ``nbytes`` of
    every numpy argument handed to a chunk program, counted here from the
    arguments themselves; the tables, device tensors already, do not
    count."""
    monkeypatch.setenv("NVT_NO_SYMBOLS", "1")
    want = {"bytes": 0, "runs": 0, "tensor_bytes": 0}
    run = programs.run

    def counted(kind, program, cfg, flat, device, rows):
        want["runs"] += 1
        for a in flat:
            if isinstance(a, np.ndarray):
                want["bytes"] += a.nbytes
            elif torch.is_tensor(a):
                want["tensor_bytes"] += a.numel() * a.element_size()
        return run(kind, program, cfg, flat, device, rows)

    monkeypatch.setattr(programs, "run", counted)
    bd = BatchDecoder(_fleet(streams=2, packets=2600, seed=7), device="cpu")
    bd.decode_all()
    assert not bd._sym and bd.chunks == want["runs"] >= 2
    assert want["tensor_bytes"] > 0
    assert profiling.counters()["upload.bytes"] == want["bytes"] > 0


def _sym_fleet_ids(monkeypatch):
    """Record, around every ``BatchDecoder._dispatch`` and chunk program of
    a fleet decode, the VQ ids its chunk holds (the unpack's per-frame
    counts of the good rows, and each carried frame's ids) and the length
    of every symbol bucket's id vector that the program receives.  Each
    bucket's staged ids and frame bases are held to what ``flatten_ids``
    and ``pad_ids`` build from the same chunk and carries (``buckets``
    counts them).  Chunks of 256 packets, so the streams carry frames from
    chunk to chunk."""
    seen = {"held": 0, "staged": 0, "carried": 0, "runs": 0, "buckets": 0}
    dispatch = batch_mod.BatchDecoder._dispatch
    stage_ids = batch_mod.BatchDecoder._stage_ids
    run = programs.run

    def held(self, chunk, *args):
        ok = chunk["plan_arr"][:, 0] == 1
        seen["held"] += int(chunk["meta"][ok, 5].sum())
        for st, *_ in chunk["stream_rows"]:
            if st.carry is not None and self._sym:
                seen["held"] += len(st.carry[0]["ids"])
                seen["carried"] += 1
        return dispatch(self, chunk, *args)

    def checked(self, n, carries, chunk, ridx, B_pad):
        parts = [st.carry[0]["ids"] for st in carries]
        bases = list(np.cumsum([0] + [len(p) for p in parts])[:-1])
        if len(ridx):
            flat, base = flatten_ids(np.concatenate(chunk["ids"])[ridx],
                                     chunk["meta"][ridx, 5])
            bases += list(sum(map(len, parts)) + base)
            parts.append(flat)
        geom, (cls_b, base_b), ids = stage_ids(self, n, carries, chunk,
                                               ridx, B_pad)
        np.testing.assert_array_equal(
            ids, pad_ids(parts, sum(map(len, parts))))
        j = len(carries) + len(ridx)
        np.testing.assert_array_equal(base_b[:j], bases)
        assert not base_b[j:].any()
        seen["buckets"] += 1
        return geom, (cls_b, base_b), ids

    def staged(kind, program, cfg, flat, device, rows):
        seen["runs"] += 1
        at = 0
        for bucket in cfg[3]:
            if bucket[0] == "s":
                ids = flat[at + 1]
                assert ids.dtype == np.int16 and ids.ndim == 1
                assert len(ids) == bucket[-1]
                seen["staged"] += len(ids)
            at += batch_mod._BUCKET_ARGS[bucket[0]]
        return run(kind, program, cfg, flat, device, rows)

    monkeypatch.setattr(batch_mod.BatchDecoder, "_dispatch", held)
    monkeypatch.setattr(batch_mod.BatchDecoder, "_stage_ids", checked)
    monkeypatch.setattr(programs, "run", staged)
    monkeypatch.setattr(batch_mod, "CHUNK_FRAMES", 256)
    monkeypatch.setattr(batch_mod, "CAP_PER_SIZE", 128)
    return seen


def test_symbol_lane_counts_the_ids_it_holds_and_stages(tracing,
                                                        monkeypatch):
    """On the symbol lane, ``sym.ids`` is the unpack's per-frame id counts
    of every chunk's rows and carried frames, and ``sym.ids_staged`` the
    lengths of the id vectors that the chunk programs receive, padding
    included; ``sym.ids_copied``, the ids of the native row copy, equals
    ``sym.ids``, and every bucket's staged ids are those of
    ``flatten_ids`` and ``pad_ids``; ``batch.ids`` runs once a bucket,
    inside ``batch.stage``."""
    monkeypatch.delenv("NVT_NO_SYMBOLS", raising=False)
    seen = _sym_fleet_ids(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bd = BatchDecoder(_fleet(streams=3, packets=180, seed=5),
                          device="cpu")
        bd.decode_all()
    assert bd._sym and bd.chunks == seen["runs"] >= 3
    assert seen["carried"] >= 2
    totals = profiling.counters()
    assert totals["sym.ids"] == seen["held"] > 0
    assert totals["sym.ids_copied"] == totals["sym.ids"]
    assert seen["buckets"] >= bd.chunks
    assert totals["sym.ids_staged"] == seen["staged"] >= totals["sym.ids"]
    assert profiling.snapshot()["batch.ids"][1] >= bd.chunks
    events = [e for e in prof.events() if e.name.startswith("batch.")]
    stages = [e for e in events if e.name == "batch.stage"]
    mine = [e for e in events if e.name == "batch.ids"]
    assert mine
    for e in mine:
        assert any(o.thread == e.thread
                   and o.time_range.start <= e.time_range.start
                   and e.time_range.end <= o.time_range.end
                   for o in stages)


def test_dense_lane_records_no_symbol_tracing(tracing, monkeypatch):
    """Under ``NVT_NO_SYMBOLS`` the same fleet takes the dense lane and
    records neither ``batch.ids`` nor any symbol counter."""
    monkeypatch.setenv("NVT_NO_SYMBOLS", "1")
    seen = _sym_fleet_ids(monkeypatch)
    bd = BatchDecoder(_fleet(streams=3, packets=180, seed=5), device="cpu")
    bd.decode_all()
    assert not bd._sym and bd.chunks == seen["runs"] >= 3
    assert seen["staged"] == 0
    assert "batch.ids" not in profiling.snapshot()
    assert "batch.stage" in profiling.snapshot()
    totals = profiling.counters()
    assert "sym.ids" not in totals and "sym.ids_staged" not in totals
    assert "sym.ids_copied" not in totals
    assert seen["buckets"] == 0
    assert totals["upload.bytes"] > 0
