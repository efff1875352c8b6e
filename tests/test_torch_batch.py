"""The torch port's many-stream ``BatchDecoder`` against the JAX package's
``BatchDecoder`` (jax on the CPU) and against each stream's single-stream
port decode (``read_all``), on a mixed fleet of testgen streams.

PCM within 2e-6 abs of the JAX package (the bound the reference holds its
own jax path to, tests/test_chained.py:49); lengths, ``has_clipped`` and
each stream's route identical.  The JAX package under both of its
overlap-add index forms (the port has one), chunk carries, the int16
epilogue, the no-native fallback and a refused ``mesh=`` that is not a
mesh (tests/test_torch_sharded.py decodes over meshes).  The chunk
program itself (``batch_program``) runs on the arguments the JAX program
was given, captured through the reference's ``_capture`` hook.  Fleet decodes are shared through module-level caches:
each distinct JAX batch configuration compiles afresh.
"""

import numpy as np
import pytest
import torch

import nvorbis_tpu.parallel.batch as jbatch
import nvorbis_tpu_torch as nvt
import nvorbis_tpu_torch.parallel.batch as tbatch
from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec
from nvorbis_tpu_torch.convert import group_tables
from nvorbis_tpu_torch.engine import programs
from nvorbis_tpu_torch.engine.bulk import overlap_add
from nvorbis_tpu_torch.ops import imdct as op
from nvorbis_tpu_torch.parallel.batch import batch_program
from nvorbis_tpu_torch.utils import profiling, staging
from test_torch_bulk import corrupt_packet

TOL = 2e-6
I16_BOUND = 1.0 / 32767 + 1e-6  # one quantization step, plus rounding

# name -> (make_simple_spec kwargs, packets, seed); the three stereo r2
# streams share one group (sample rate is not part of the group key)
SPECS = {
    "stereo_r2_a": (dict(channels=2, residue_type=2), 150, 61),
    "stereo_r2_b": (dict(channels=2, residue_type=2), 120, 62),
    "stereo_r2_48k": (dict(channels=2, sample_rate=48000, residue_type=2),
                      100, 63),
    "stereo_r1": (dict(channels=2, residue_type=1), 100, 64),
    "mono_r1": (dict(channels=1, residue_type=1, couplings=[]), 100, 65),
    "surround51_r2": (dict(channels=6, sample_rate=48000, residue_type=2,
                           couplings=[(0, 1), (2, 3), (4, 5)]), 80, 66),
    "floor0": (dict(channels=2, residue_type=1, floor_type=0), 40, 67),
}
# the fleet: every spec, a corrupt-packet stream and a duplicated blob
FLEET = [*SPECS, "corrupt", "stereo_r2_a"]
ROUTES = {"floor0": "host_spec"}

_blobs = {}
_decodes = {}


def _blob(name):
    if name not in _blobs:
        if name == "corrupt":
            _blobs[name] = corrupt_packet(_blob("stereo_r2_b"))
        else:
            kw, n, seed = SPECS[name]
            _blobs[name] = make_simple_spec(**kw).build_stream(
                np.random.default_rng(seed), n)
    return _blobs[name]


def _fleet():
    # one bytes object per name, so the duplicate is the same source
    return [_blob(name) for name in FLEET]


def _run(kind, names=None):
    """(pcm list, has_clipped list, decoder) of one fleet decode; ``kind``
    is "port" (device="cpu"), "port_host" (engine="host") or "jax"."""
    srcs = _fleet() if names is None else [_blob(n) for n in names]
    if kind == "jax":
        bd = jbatch.BatchDecoder(srcs, engine="jax")
    elif kind == "port_host":
        bd = nvt.BatchDecoder(srcs, device="cpu", engine="host")
    else:
        bd = nvt.BatchDecoder(srcs, device="cpu")
    outs = bd.decode_all()
    return outs, [st.decoder.has_clipped for st in bd._streams], bd


def _cached(key, kind, env=(), names=None, patch=()):
    """One decode per (key, kind), shared by every test that asks."""
    if (key, kind) not in _decodes:
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env:
                mp.setenv(k, v)
            for attr, v in patch:
                mp.setattr(jbatch, attr, v)
                mp.setattr(tbatch, attr, v)
            _decodes[(key, kind)] = _run(kind, names)
    return _decodes[(key, kind)]


def _single(name):
    key = ("single", name)
    if key not in _decodes:
        r = nvt.VorbisReader(_blob(name), device="cpu")
        _decodes[key] = r.read_all()
        r.dispose()
    return _decodes[key]


def _assert_fleet_parity(got, want, names=FLEET, tol=TOL):
    for i, name in enumerate(names):
        a, b = got[0][i], want[0][i]
        assert a.dtype == np.float32
        assert len(a) == len(b) > 0, name
        assert got[1][i] == want[1][i], name
        assert float(np.abs(a - b).max()) <= tol, name


@pytest.mark.parametrize("i", range(len(FLEET)),
                         ids=[f"{i}-{n}" for i, n in enumerate(FLEET)])
def test_fleet_matches_jax_and_single_stream(i):
    """Each stream of the mixed fleet: the JAX BatchDecoder's PCM, length,
    ``has_clipped`` and route, and the port's own single-stream decode."""
    got = _cached("default", "port")
    want = _cached("default", "jax")
    name = FLEET[i]
    pcm = got[0][i]
    assert got[2].routes[i] == ROUTES.get(name, "device")
    assert len(pcm) == len(want[0][i]) > 0
    assert got[1][i] == want[1][i]
    assert float(np.abs(pcm - want[0][i]).max()) <= TOL
    single = _single(name)
    assert len(pcm) == len(single)
    assert float(np.abs(pcm - single).max()) <= TOL


def test_fleet_groups_and_duplicate():
    """Four co-batched groups (stereo r2 with its 48 kHz twin, stereo r1,
    mono, 5.1), one chunk each; the duplicated source decodes equal."""
    outs, _, bd = _cached("default", "port")
    keys = {bd._group_key(st.decoder._setup, st.native)
            for st, route in zip(bd._streams, bd.routes)
            if route == "device"}
    assert len(keys) == 4
    assert bd.chunks == 4
    np.testing.assert_array_equal(outs[0], outs[-1])


def test_floor_tables_by_tid_match_jax(monkeypatch):
    """A 4-stream fleet whose buckets pass their floor tables whole with
    each frame's table id (``bucket_rows`` gathers no per-frame copy), and
    one ``read_all``, on the CPU against ``engine="jax"`` within 2e-6."""
    import nvorbis_tpu as nv

    names = ["stereo_r2_a", "stereo_r2_b", "stereo_r2_48k", "surround51_r2"]
    seen = []
    core, core_sym = tbatch.synth_core, tbatch.synth_core_sym

    def recorded(*args, tid=None):  # the dense lane's body
        seen.append((args[5].shape, int(torch.unique(tid).numel())))
        return core(*args, tid=tid)

    def recorded_sym(*args, tid=None):  # the symbol lane's body
        seen.append((args[9].shape, int(torch.unique(tid).numel())))
        return core_sym(*args, tid=tid)
    monkeypatch.setattr(tbatch, "synth_core", recorded)
    monkeypatch.setattr(tbatch, "synth_core_sym", recorded_sym)
    got = _run("port", names)
    monkeypatch.setattr(tbatch, "synth_core", core)
    monkeypatch.setattr(tbatch, "synth_core_sym", core_sym)
    # stereo: 3 streams x 2 modes of table rows, frames over several
    assert any(len(shape) == 3 and shape[0] == 6 and ids > 1
               for shape, ids in seen)
    _assert_fleet_parity(got, _cached("tid4", "jax", names=names), names)
    blob = _blob("surround51_r2")
    pcm = nvt.VorbisReader(blob, device="cpu").read_all()
    want = nv.VorbisReader(blob, engine="jax").read_all()
    assert len(pcm) == len(want) > 0
    assert float(np.abs(pcm - want).max()) <= TOL


def test_searchsorted_ola_form_matches(monkeypatch):
    """``NVT_NO_OLA_SCAN`` switches the JAX package to its searchsorted
    overlap-add; the port's one form (searchsorted), which reads no switch,
    matches it there as it matches the JAX scatter+cumsum default, and its
    decode under the switch equals its default one bit for bit."""
    env = (("NVT_NO_OLA_SCAN", "1"),)
    got = _cached("searchsorted", "port", env=env)
    _assert_fleet_parity(got, _cached("searchsorted", "jax", env=env))
    _assert_fleet_parity(got, _cached("default", "port"), tol=0.0)


CARRY_NAMES = ["stereo_r2_a", "corrupt", "stereo_r2_48k", "surround51_r2"]
CARRY_PATCH = (("CHUNK_FRAMES", 48), ("CAP_PER_SIZE", 24))


@pytest.mark.parametrize("form", ["scan", "searchsorted"])
def test_chunk_carries_match_jax(form):
    """Chunks of at most 48 packets (each package's batch module's
    ``CHUNK_FRAMES``/``CAP_PER_SIZE``, patched alike) carry frames across many
    chunk boundaries, a bad packet among them; the JAX package under each
    of its overlap-add forms."""
    env = (("NVT_NO_OLA_SCAN", "1"),) if form == "searchsorted" else ()
    key = "carry-" + form
    got = _cached(key, "port", env=env, names=CARRY_NAMES, patch=CARRY_PATCH)
    want = _cached(key, "jax", env=env, names=CARRY_NAMES, patch=CARRY_PATCH)
    _assert_fleet_parity(got, want, CARRY_NAMES)
    assert got[2].chunks >= 8


def test_int16_epilogue_matches_jax():
    """``NVT_FETCH_INT16=1``: the chunk program quantizes to int16 on the
    device; the host dequantizes.  Within one quantization step of the JAX
    int16 output and of the port's float32 output, and quantized for real.
    """
    env = (("NVT_FETCH_INT16", "1"),)
    got = _cached("int16", "port", env=env)
    _assert_fleet_parity(got, _cached("int16", "jax", env=env),
                         tol=I16_BOUND)
    exact = _cached("default", "port")
    _assert_fleet_parity(got, exact, tol=I16_BOUND)
    quantized = [i for i, n in enumerate(FLEET) if n not in ROUTES]
    assert all(np.abs(got[0][i] - exact[0][i]).max() > 0 for i in quantized)


def test_no_native_plane_routes_every_stream_to_oracle(monkeypatch):
    """``NVT_NO_NATIVE``: every stream falls back to the reference's oracle
    read loop, as in the JAX package."""
    from nvorbis_tpu import native
    from nvorbis_tpu_torch import native as own_native

    monkeypatch.setenv("NVT_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_unpacker_cache", {})
    monkeypatch.setattr(own_native, "_unpacker_cache", {})
    names = ["stereo_r2_b", "floor0"]
    got = _run("port", names)
    assert got[2].routes == ["oracle", "oracle"] and got[2].chunks == 0
    _assert_fleet_parity(got, _run("jax", names), names)


def test_host_engine_matches_device_path():
    """``engine="host"``: the reference's host engine reached through the
    port (5e-6 * max(1, max|ref|), the reference's host-engine bound)."""
    got = _cached("default", "port_host")
    assert got[2].routes == ["host"] * len(FLEET)
    want = _cached("default", "port")
    for a, b in zip(got[0], want[0]):
        assert len(a) == len(b)
        assert float(np.abs(a - b).max()) <= 5e-6 * max(
            1.0, float(np.abs(b).max()))


def test_mesh_is_refused():
    """``mesh=`` takes a ``build_mesh`` mesh: any other object is refused
    before a source opens, as is an engine the port does not have."""
    with pytest.raises(TypeError, match="build_mesh"):
        nvt.BatchDecoder([_blob("stereo_r1")], device="cpu", mesh=object())
    with pytest.raises(ValueError):
        nvt.BatchDecoder([_blob("stereo_r1")], device="cpu", engine="jax")


def test_batch_program_on_jax_arguments():
    """The port's chunk program on exactly the arguments the JAX program
    was given (captured), and the port's stacked group tables equal the
    JAX group's."""
    names = ["stereo_r2_a", "stereo_r2_48k", "surround51_r2"]
    bd = jbatch.BatchDecoder([_blob(n) for n in names], engine="jax")
    bd._capture = []
    bd.decode_all()
    assert len(bd._capture) == 2
    for cfg, args, L_real in bd._capture:
        want = np.asarray(jbatch._batch_program(cfg)(*args))
        targs = [torch.from_numpy(np.array(a)) for a in args]
        got = batch_program(cfg, *targs).numpy()
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= TOL
    # the first capture is the stereo group (streams 0 and 1): the port's
    # tables from its own parse of the same streams equal the JAX group's
    # xs_t, win_t, sl_t
    readers = [nvt.VorbisReader(_blob(n), engine="oracle") for n in names[:2]]
    setups = [r._stream_decoder._setup for r in readers]
    P = max(r._stream_decoder._max_posts for r in readers)
    for r in readers:
        r.dispose()
    tables = group_tables(setups, P)
    cfg, args = bd._capture[0][:2]
    i = 0
    for b in cfg[3]:
        at = i + (8 if b[0] == "s" else 6)  # xs_t, win_t, basis, sl_t
        for want, got in zip((args[at], args[at + 1], args[at + 3]),
                             tables[b[2]]):
            np.testing.assert_array_equal(np.asarray(want), got)
        i += 15 if b[0] == "s" else 10


def _ola_loop(rows, segE, prim, sec, sec_len, L):
    """The lapping rule one sample at a time: sample ``p`` of segment
    ``f`` (the last ``segE[f] <= p``) at offset ``t`` adds the primary row
    and, while ``t < sec_len[f]``, the secondary row."""
    out = np.zeros((L, rows.shape[1]), np.float32)
    for p in range(L):
        f = max(0, np.searchsorted(segE, p, side="right") - 1)
        f = min(f, len(prim) - 1)
        t = p - segE[f]
        out[p] = rows[min(max(prim[f] + t, 0), len(rows) - 1)]
        if t < sec_len[f]:
            out[p] += rows[min(max(sec[f] + t, 0), len(rows) - 1)]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ola_forms_agree_with_padding_segments(seed):
    """The port's overlap-add on random segment tables whose tail is
    padding (starts past ``L``, as the batch plane lays them out) and whose
    last secondary ends past ``L``; every other secondary ends inside its
    own segment, as the planner lays them.  Bit-equal to the lapping rule
    taken one sample at a time."""
    rng = np.random.default_rng(seed)
    L, n_segs, S_pad, nrows = 500, 12, 32, 900
    starts = np.sort(rng.choice(np.arange(1, L), n_segs - 1, replace=False))
    segE = np.empty(S_pad + 1, np.int32)
    segE[0], segE[1:n_segs] = 0, starts
    segE[n_segs:] = L + 1 + np.arange(S_pad + 1 - n_segs)
    seg_len = np.diff(np.append(segE[:n_segs], L))
    prim = np.zeros(S_pad, np.int32)
    sec = np.zeros(S_pad, np.int32)
    sec_len = np.zeros(S_pad, np.int32)
    prim[:n_segs] = rng.integers(0, nrows - L, n_segs)
    sec[:n_segs] = rng.integers(0, nrows - L, n_segs)
    sec_len[:n_segs] = rng.integers(0, seg_len + 1)
    sec_len[n_segs - 1] = seg_len[-1] + 7  # ends past the output
    rows = rng.standard_normal((nrows, 3)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (rows, segE, prim, sec, sec_len)]
    np.testing.assert_array_equal(
        overlap_add(*t, L).numpy(),
        _ola_loop(rows, segE, prim, sec, sec_len, L))


# a fleet of many short chunks: each of the staging ring's regions is
# reused several times, with carries, a bad packet and both group kinds
RING_NAMES = ["stereo_r2_a", "corrupt", "stereo_r2_48k", "surround51_r2"]
RING_PATCH = (("CHUNK_FRAMES", 32), ("CAP_PER_SIZE", 16))
LANES = {"dense": (("NVT_NO_SYMBOLS", "1"),), "symbol": ()}


def _ring_decode(monkeypatch, lane, fresh=False):
    """The ring fleet's (pcm list, decoder, inputs) on ``lane``, where
    ``inputs`` holds each chunk program's host arguments as (dtype, shape,
    bytes); ``fresh`` stages each argument in a fresh zeroed array
    instead, as before the ring."""
    inputs = []
    run = programs.run

    def recorded(kind, program, cfg, flat, device, rows):
        inputs.append([(a.dtype.str, a.shape, a.tobytes()) for a in flat
                       if isinstance(a, np.ndarray)])
        return run(kind, program, cfg, flat, device, rows)
    with monkeypatch.context() as mp:
        for k, v in LANES[lane]:
            mp.setenv(k, v)
        for attr, v in RING_PATCH:
            mp.setattr(tbatch, attr, v)
        if fresh:
            mp.setattr(staging.StagingRing, "take",
                       lambda self, shape, dtype: np.zeros(shape, dtype))
        mp.setattr(programs, "run", recorded)
        bd = nvt.BatchDecoder([_blob(n) for n in RING_NAMES], device="cpu")
        return bd.decode_all(), bd, inputs


def _assert_bit_equal(got, want):
    """Two ring fleet decodes: the same PCM and the same bytes handed to
    every chunk program, padding rows and tables' tails included."""
    for name, a, b in zip(RING_NAMES, got[0], want[0]):
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(got[2]) == len(want[2]) > 0
    for k, (a, b) in enumerate(zip(got[2], want[2])):
        assert a == b, f"chunk {k}: the program's host arguments differ"


@pytest.mark.parametrize("lane", sorted(LANES))
def test_staging_ring_reused_bit_equal(monkeypatch, lane):
    """Chunks of at most 32 packets cycle through the staging ring, each
    region taken several times: every stream bit-equal to its own
    ``read_all``, and the PCM and every chunk program's host arguments
    bit-equal to the same decode staged in fresh zeroed arrays."""
    begun = []
    begin = staging.StagingRing.begin

    def counted(self):
        begin(self)
        begun.append(self._slot)
    monkeypatch.setattr(staging.StagingRing, "begin", counted)
    got = _ring_decode(monkeypatch, lane)
    bd = got[1]
    assert bd._sym == (lane == "symbol")
    assert bd.chunks >= 4 * staging.DEPTH
    assert all(begun.count(s) >= 4 for s in range(staging.DEPTH))
    for name, pcm in zip(RING_NAMES, got[0]):
        np.testing.assert_array_equal(pcm, _single(name), err_msg=name)
    _assert_bit_equal(got, _ring_decode(monkeypatch, lane, fresh=True))


@pytest.mark.parametrize("lane", sorted(LANES))
def test_staging_ring_prefilled_with_nan(monkeypatch, lane):
    """Every byte of the CPU's idle rings set to NaN's before a decode that
    grows none of them: the padding rows, the carry rows' tails and the
    tables' tails are written on every chunk, so the PCM and every chunk
    program's host arguments are bit-equal to a decode staged in fresh
    zeroed arrays."""
    for _ in range(2):  # the regions at the size of the fleet's chunks
        _ring_decode(monkeypatch, lane)
    rings = staging.idle_rings("cpu")
    assert rings and all(r.regions() for r in rings)
    for r in rings:
        for region in r.regions():
            region.view(np.float32)[:] = np.nan
    was = profiling.enabled()
    profiling.enable(True)
    profiling.reset()
    try:
        got = _ring_decode(monkeypatch, lane)
        allocs = profiling.counters().get("stage.ring_allocs", 0)
    finally:
        profiling.enable(was)
        profiling.reset()
    assert allocs == 0
    _assert_bit_equal(got, _ring_decode(monkeypatch, lane, fresh=True))


@pytest.mark.parametrize("lane", sorted(LANES))
def test_staging_ring_captured_chunks_replay(monkeypatch, lane):
    """With the capture hook armed, every recorded chunk replays to its own
    recorded output after the decode has rewritten the ring many times."""
    with monkeypatch.context() as mp:
        for k, v in LANES[lane]:
            mp.setenv(k, v)
        for attr, v in RING_PATCH:
            mp.setattr(tbatch, attr, v)
        bd = nvt.BatchDecoder([_blob(n) for n in RING_NAMES], device="cpu")
        bd._capture = []
        bd.decode_all()
    assert len(bd._capture) == len(bd._capture_out) == bd.chunks
    assert bd.chunks >= 4 * staging.DEPTH
    for (cfg, flat, L_real), want in zip(bd._capture, bd._capture_out):
        assert torch.equal(batch_program(cfg, *flat)[:L_real], want)


@pytest.mark.cuda
def test_fleet_on_card_matches_plain_path():
    """The card's co-batched decode against the port's plain path
    (``device="cpu"``) on the same fleet: the kernel launched, every route
    as on the CPU, ``5e-6 * max(1, max|ref|)`` (the reference's host-engine
    bound; the kernel's FFT and the twin's basis product round apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    before = op.launches
    bd = nvt.BatchDecoder(_fleet(), device="cuda")
    outs = bd.decode_all()
    assert op.launches > before
    want = _cached("default", "port")
    assert bd.routes == want[2].routes
    for i, name in enumerate(FLEET):
        ref = want[0][i]
        assert len(outs[i]) == len(ref) > 0, name
        assert bd._streams[i].decoder.has_clipped == want[1][i], name
        tol = 5e-6 * max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(outs[i] - ref).max()) <= tol, name
