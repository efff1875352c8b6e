"""Residue rebuild from symbols in the torch port
(nvorbis_tpu_torch/synth/residue_sym.py) against the JAX package's
``reconstruct_spectrum`` on the same native-unpacked symbols.

The rebuild is gathers plus stage-ordered fp32 adds in both, so the spectra
must be bit-equal: for residue types 0, 1 and 2, in the width-grouped lane
and the per-element lane (NVT_SYM_WIDE=0), with undecoded partitions
(CLASS_SENTINEL) and missing ids (-1) injected.  The port's plans come from
its own parse of the same stream bytes; the symbols are the JAX package's
native unpack.
"""

import numpy as np
import pytest
import jax
import torch

import nvorbis_tpu as nv
import nvorbis_tpu_torch as nvt
from nvorbis_tpu.native import NativeUnpacker
from nvorbis_tpu.synth import residue_sym as jrs
from nvorbis_tpu.testgen.vorbis_writer import make_simple_spec
from nvorbis_tpu_torch import native as own_native
from nvorbis_tpu_torch.synth import residue_sym as trs

SPECS = {
    0: dict(channels=1, residue_type=0, couplings=[]),
    1: dict(channels=2, residue_type=1),
    2: dict(channels=6, sample_rate=48000, residue_type=2,
            couplings=[(0, 1), (2, 3), (4, 5)]),
}

_jit_reconstruct = jax.jit(jrs.reconstruct_spectrum,
                           static_argnames=("st", "channels"))


def _symbols(rtype, n_packets=40, seed=21):
    blob = make_simple_spec(**SPECS[rtype]).build_stream(
        np.random.default_rng(seed), n_packets)
    r = nv.VorbisReader(blob, engine="oracle")
    dec = r._stream_decoder
    raw = []
    while True:
        p = dec._packet_provider.get_next_packet()
        if p is None:
            break
        raw.append(bytes(p.data))
        p.done()
    native = NativeUnpacker(dec._setup, dec._max_posts)
    assert native.sym_plans is not None
    setup = dec._setup
    r.dispose()
    own = nvt.VorbisReader(blob, engine="oracle")
    od = own._stream_decoder
    own_plans = own_native.unpacker_for(od._setup, od._max_posts).sym_plans
    # the port's plan of each residue, by the residue's index
    plans = [(native.sym_plans[id(a)], own_plans[id(b)])
             for a, b in zip(setup.residues, od._setup.residues)
             if id(a) in native.sym_plans]
    own.dispose()
    return setup, native, plans, native.unpack_sym(raw)


@pytest.mark.parametrize("wide", ["1", "0"])
@pytest.mark.parametrize("rtype", [0, 1, 2])
def test_reconstruct_bit_equal(rtype, wide, monkeypatch):
    monkeypatch.setenv("NVT_SYM_WIDE", wide)
    setup, native, plans, (classes, ids, _, _, _, meta) = _symbols(rtype)
    own_plan = dict((id(a), b) for a, b in plans)
    rng = np.random.default_rng(rtype)
    C = setup.channels
    checked = 0
    for mi, mode in enumerate(setup.modes):
        rows = np.flatnonzero((meta[:, 0] == 1) & (meta[:, 1] == mi))
        if not len(rows):
            continue
        plan = native.sym_plans[id(setup.residues[
            mode.mapping.submap_residue[0]])]
        st = trs.plan_static(own_plan[id(plan)], mode.block_size)
        assert st == jrs.plan_static(plan, mode.block_size)
        if wide == "1" and rtype != 0:
            assert max(st.widths) > 1  # the width-grouped lane runs
        cls_b = classes[rows][:, :st.chr_count, :max(1, st.n_part)].copy()
        # undecoded partitions in a few frames
        cls_b[rng.random(cls_b.shape) < 0.15] = trs.CLASS_SENTINEL
        flat, base = trs.flatten_ids(ids[rows], meta[rows, 5])
        flat = flat.copy()
        flat[rng.random(flat.shape) < 0.1] = -1  # missing ids
        flat = np.concatenate([flat, np.full(3, -1, np.int16)])

        want = np.asarray(_jit_reconstruct(
            cls_b.astype(np.int32), flat.astype(np.int32), base,
            jrs.plan_tables_dev(plan), st=st, channels=C))
        got = trs.reconstruct_spectrum(
            torch.from_numpy(cls_b), torch.from_numpy(flat),
            torch.from_numpy(base), trs.plan_tables(own_plan[id(plan)], "cpu"),
            st, C)
        assert got.dtype == torch.float32
        assert got.shape == (len(rows), C, mode.block_size // 2)
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.any(want)
        checked += 1
    assert checked


def test_plan_tables_cached_per_plan_and_device():
    """The port's plan tables, uploaded once per (plan, device), equal the
    JAX package's plan of the same residue."""
    setup, native, plans, _ = _symbols(2, n_packets=4)
    ref_plan, plan = plans[0]
    a = trs.plan_tables(plan, "cpu")
    assert trs.plan_tables(plan, torch.device("cpu")) is a
    for t, ref in zip(a, (ref_plan.groups_np, ref_plan.pair_np,
                          ref_plan.vq_mega_np)):
        np.testing.assert_array_equal(t.numpy(), ref)


def _stage_case(rng, widths, rows_per_job, carry_lens, picked, zeros=0.0,
                counts=None):
    """A bucket's inputs as the fleet stages them: job arrays of id rows
    (every id past a row's count is junk, as the unpack leaves it), each
    row's count, the carried frames' compact ids, and the rows ``ridx``
    the bucket takes out of the jobs' concatenation."""
    jobs = [rng.integers(-1, 30000, size=(r, w), dtype=np.int16)
            for r, w in zip(rows_per_job, widths)]
    if counts is None:
        counts = np.concatenate([rng.integers(0, w + 1, size=r)
                                 for r, w in zip(rows_per_job, widths)])
        counts[rng.random(len(counts)) < zeros] = 0
    carries = [rng.integers(0, 30000, size=n, dtype=np.int16)
               for n in carry_lens]
    total = sum(rows_per_job)
    ridx = np.sort(rng.choice(total, size=min(picked, total), replace=False))
    return jobs, counts.astype(np.int32), carries, ridx


def _stage_reference(jobs, counts, carries, ridx):
    """The layout of ``flatten_ids`` and ``pad_ids``: the carried ids, then
    ``flatten_ids`` of the rows (none without rows), padded by
    ``pad_ids``; bases the carries' offsets, then the rows'."""
    parts, bases, pos = [], [], 0
    for c in carries:
        parts.append(c)
        bases.append(pos)
        pos += len(c)
    if len(ridx):
        flat, base = trs.flatten_ids(np.concatenate(jobs)[ridx],
                                     counts[ridx])
        parts.append(flat)
        bases += list(pos + base)
        pos += len(flat)
    return trs.pad_ids(parts, pos), np.array(bases, np.int32), pos


def _stage_native(jobs, counts, carries, ridx, fill=None):
    src = np.concatenate(
        [np.array([c.ctypes.data for c in carries], np.int64),
         np.concatenate([own_native.row_pointers(a) for a in jobs])[ridx]])
    cnt = np.concatenate([np.array([len(c) for c in carries], np.int32),
                          counts[ridx]])
    bases = np.full(len(src), 7777, np.int32)
    empty = np.empty
    if fill is not None:
        # a reused buffer: every element must be written
        def empty(size, dtype):
            return np.full(size, fill, dtype)
    ids, pos = own_native.stage_ids(src, cnt, bases, empty)
    return ids, bases, pos


STAGE_CASES = {
    # name: (widths, rows per job, carry lengths, rows picked, zero share)
    "mixed": ((2832, 2832), (40, 25), (530, 0, 17), 50, 0.0),
    "zero_counts": ((300, 300, 300), (20, 20, 20), (5,), 45, 0.4),
    "empty_ridx": ((64, 64), (8, 8), (12, 3), 0, 0.0),
    "carries_only": ((64,), (0,), (1, 2832, 40), 0, 0.0),
    "no_carries": ((128, 128), (30, 30), (), 60, 0.1),
    "width_1": ((1, 1), (50, 50), (1,), 70, 0.3),
    "width_7": ((7, 7), (33, 10), (), 40, 0.0),
    "width_2832": ((2832, 2832, 2832), (30, 30, 30), (), 90, 0.0),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_native_row_copy_matches_flatten_and_pad(case):
    """``native.stage_ids``, one native copy of each row's prefix into the
    id vector, gives the vector and the frame bases of ``pad_ids`` over the
    carried ids and ``flatten_ids`` of the rows, element for element, and
    writes every element of a reused buffer."""
    widths, rows, carry_lens, picked, zeros = STAGE_CASES[case]
    rng = np.random.default_rng(sorted(STAGE_CASES).index(case))
    inputs = _stage_case(rng, widths, rows, carry_lens, picked, zeros)
    want_ids, want_bases, want_pos = _stage_reference(*inputs)
    for fill in (None, 12345):
        ids, bases, pos = _stage_native(*inputs, fill=fill)
        assert pos == want_pos
        assert ids.dtype == np.int16 and len(ids) == trs.round_ids(pos + 1)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(bases, want_bases)


@pytest.mark.parametrize("extra", [0, 1, -1])
def test_native_row_copy_at_the_quantum(extra):
    """Ids that fill ``IDS_QUANTUM`` exactly get one more quantum, all -1,
    as ``pad_ids`` gives them; one id fewer or more gives the same
    layout as it does."""
    q = trs.IDS_QUANTUM
    rng = np.random.default_rng(7 + extra)
    # a carry of 100 ids, 63 full rows of 2048 and one of the rest
    counts = np.full(66, 2048, np.int32)
    counts[63] = q + extra - 100 - 63 * 2048
    counts[64:] = 0
    inputs = _stage_case(rng, (2048, 2048), (40, 26), (100,), 66,
                         counts=counts)
    want_ids, want_bases, want_pos = _stage_reference(*inputs)
    assert want_pos == q + extra
    ids, bases, pos = _stage_native(*inputs, fill=3)
    assert pos == q + extra
    assert len(ids) == (2 * q if extra >= 0 else q)
    assert ids[-1] == -1
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(bases, want_bases)


def test_native_row_copy_refuses_a_negative_count():
    """A negative count raises before anything is written."""
    row = np.arange(8, dtype=np.int16)
    src = np.array([row.ctypes.data] * 2, np.int64)
    bases = np.full(2, 5, np.int32)
    with pytest.raises(ValueError):
        own_native.stage_ids(src, np.array([4, -1], np.int32), bases)
    np.testing.assert_array_equal(bases, [5, 5])
