"""Many-stream co-batched decoding on torch devices.

N streams are grouped by synthesis topology (channels, block sizes,
per-mode coupling and, for the symbol lane, the residue tables' content).
Within a group every chunk of at most ``CHUNK_FRAMES`` packets, pulled
across the group's streams, runs on the device:

* per block size (:func:`bucket_rows`),
  :func:`~nvorbis_tpu_torch.synth.device.synth_core_sym` (symbols: the
  residue rebuilt inside the floor kernel) or
  :func:`~nvorbis_tpu_torch.synth.device.synth_core` (dense spectra),
  whose prologue runs in the floor kernel over the stacked per-(stream,
  mode) floor tables, each frame reading its row by table id ``tid``, and
  whose IMDCT and window run in the IMDCT kernel over the group's whole
  window table (row ``tid * W + widx``);
* the overlap-add of every stream into its own contiguous range of the
  chunk output (:func:`~nvorbis_tpu_torch.engine.bulk.overlap_add`, the
  overlap-add kernel on a card, which finds each sample's segment by a
  binary search as ``read_all``'s does; the JAX package's scatter+cumsum
  form computes the same samples with more launches), the
  clip epilogue and, under ``NVT_FETCH_INT16=1``, the int16 one
  (:func:`chunk_output`).

Without a mesh these are one program, :func:`batch_program`, on the JAX
package's padded layout and cfg; on a card a cfg's first chunk runs it op
by op and every later chunk of that cfg replays one CUDA graph
(:mod:`~nvorbis_tpu_torch.engine.programs`).  Under a mesh they are a
program per shard (:func:`mesh_shard_program`) and an output program
(:func:`mesh_out_program`), each cached the same way.

The chunk is then copied once to pinned host memory on a side stream
(:class:`~nvorbis_tpu_torch.utils.fetch.PinnedFetch`).  One fetch worker
thread (``nvt-fetch``) waits on each chunk's copy and writes each stream's
samples, in chunk order, into its preallocated output, while the main
thread collects and dispatches the next chunk; at most two chunks are
pending.

``mesh=`` (a :class:`~nvorbis_tpu_torch.parallel.sharded.Mesh`) spreads
each bucket's frames over the mesh's ``stream`` axis: the bucket is padded
to a multiple of that extent, split into contiguous shards, and each
shard's residue rebuild and synthesis run on its own device (the device at
``freq`` 0 of its row; the group's tables are uploaded once per device and
the chunk's flat id stream is replicated), every bucket of a shard in one
program.  The rows are gathered onto ``mesh.devices[0, 0]`` for the
overlap-add and the epilogues, in one more program.  Rows are
independent, so every stream decodes bit-equal to the mesh-free decode.
This is the JAX package's one program over the mesh
(``nvorbis_tpu/parallel/batch.py:171-188``: frame-axis arguments sharded
over ``stream``, ids and tables replicated, the output replicated) as one
graph per shard and device plus the output's.

The host plane: packet pulls (a packet table per stream when the C++
packetizer can represent it), the C++ unpack, the lapping plans
(:meth:`BatchDecoder._collect_chunk`), Floor0 streams on the host engine's
spectrum lane, the oracle read loop without a native plane, and
``engine="host"``.
"""

import ctypes
import hashlib
import os
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from nvorbis_tpu_torch.convert import group_tables
from nvorbis_tpu_torch.engine import programs
from nvorbis_tpu_torch.engine.bulk import overlap_add
from nvorbis_tpu_torch.engine.host import HostBulkDecoder
from nvorbis_tpu_torch.engine.plan import (
    CAP_PER_SIZE,
    CHUNK_FRAMES,
    L_QUANTUM,
    StreamPlanner,
    build_segments,
    pad_quantum,
    peek_mode_index,
    round_up,
)
from nvorbis_tpu_torch.native import row_pointers, stage_ids, unpacker_for
from nvorbis_tpu_torch.ogg.fast_packets import (
    PacketTableCursor,
    plan_job_arr,
    table_for_decoder,
)
from nvorbis_tpu_torch.ops import imdct as _op
from nvorbis_tpu_torch.parallel.sharded import Mesh
from nvorbis_tpu_torch.reader import VorbisReader
from nvorbis_tpu_torch.synth.device import (
    inverse_db_table,
    synth_core,
    synth_core_sym,
)
from nvorbis_tpu_torch.synth.residue_sym import (
    CLASS_SENTINEL,
    plan_static,
    plan_tables,
)
from nvorbis_tpu_torch.utils.bitmath import CLIP_LIMIT
from nvorbis_tpu_torch.utils.device import resolve_device
from nvorbis_tpu_torch.utils.fetch import (
    PinnedFetch,
    int16_transport_enabled,
    quantize_i16,
)
from nvorbis_tpu_torch.utils import staging
from nvorbis_tpu_torch.utils.hostmem import enable_page_recycling
from nvorbis_tpu_torch.utils.profiling import count, span, stage

# arguments per bucket kind in batch_program's flat layout
_BUCKET_ARGS = {"s": 15, "d": 10}


def _fetch_and_emit(finish):
    """One chunk's ``finish`` (the wait on its copy, then its emit), under
    the ``batch.fetch`` span."""
    with span("batch.fetch"):
        finish()


def _bucket_size(b: int, shard_mult: int = 1) -> int:
    """Padded frame-batch extent for one bucket (min 16; see
    engine/plan.pad_quantum for the grid).

    ``shard_mult``: the mesh ``stream`` extent — a bucket splits into that
    many equal contiguous shards, so its extent must be divisible by it."""
    q = pad_quantum(b, 16)
    if shard_mult > 1 and q % shard_mult:
        q = ((q + shard_mult - 1) // shard_mult) * shard_mult
    return q


def bucket_rows(bucket, args, C, n_max):
    """One bucket's synthesized rows ``[B, n_max, C]`` on the device of its
    tensors.  ``bucket`` is ``("d", B_pad, n, P, W, T, coupling)`` (dense
    residue; ``args`` residue, ys, used, has_floor, widx, tid, xs_t, win_t,
    basis, sl_t) or ``("s", B_pad, n, P, W, T, coupling, st, N)`` (symbols;
    ``args`` classes, ids_flat, frame_base, ys, used, has_floor, widx, tid,
    xs_t, win_t, basis, sl_t, then the plan's three tables).  ``basis``
    feeds only the IMDCT's CPU twin and may be None."""
    n = bucket[2]
    coupling = bucket[6]
    if bucket[0] == "s":
        (classes, ids_flat, frame_base, ys, used, has_floor, widx, tid,
         xs_t, win_t, basis, sl_t, g_t, pr_t, mg_t) = args
    else:
        (residue, ys, used, has_floor, widx, tid, xs_t, win_t, basis,
         sl_t) = args
    T, W = win_t.shape[:2]
    # the floor tables by table id, which the floor kernel reads itself;
    # the window by its row of the group's whole [T * W, n] table, which
    # the IMDCT kernel indexes itself
    with stage("nvt.tables"):
        rows_w = tid.to(torch.int32) * W + widx.to(torch.int32)
    windows = win_t.reshape(T * W, n)
    idb = inverse_db_table(ys.device)
    if bucket[0] == "s":
        pcm = synth_core_sym(classes, ids_flat, frame_base,
                             (g_t, pr_t, mg_t), bucket[7], ys, used,
                             has_floor, rows_w, xs_t, windows, basis,
                             coupling, sl_t, idb, C, tid=tid)
    else:
        pcm = synth_core(residue, ys, used, has_floor, rows_w, xs_t, windows,
                         basis, coupling, sl_t, idb, tid=tid)
    pcm = pcm.transpose(1, 2)  # [B, n, C]
    if n < n_max:
        with stage("nvt.rows"):
            pcm = F.pad(pcm, (0, 0, 0, n_max - n))
    return pcm


def chunk_output(rows, segE, prim, sec, sec_len, C, L_pad, clip, i16):
    """The chunk output ``[L_pad, C]`` from every bucket's rows (a list, in
    flat-row order): overlap-add, then the clip and int16 epilogues."""
    with stage("nvt.rows"):
        rows = torch.cat(rows, dim=0).reshape(-1, C)
    with stage("nvt.ola"):
        out = overlap_add(rows, segE, prim, sec, sec_len, L_pad)
    with stage("nvt.epilogue"):
        if clip:
            out = out.clamp(-CLIP_LIMIT, CLIP_LIMIT)
        if i16:
            out = quantize_i16(out)
    return out


def batch_program(cfg, *flat):
    """One chunk of a group on one device, with the JAX package's
    ``_batch_program(cfg)(*flat)`` configuration and argument layout;
    returns the chunk output ``[L_pad, C]`` (float32, or int16 under the
    int16 epilogue).

    ``cfg = (C, L_pad, S_pad, buckets, clip, i16, ola_scan)``, where
    ``ola_scan`` (the JAX package's choice of overlap-add form) is ignored:
    both forms give the same samples, and the port has one.  Each bucket's
    arguments (:func:`bucket_rows`) follow in bucket order, then the
    segment table segE, prim, sec, sec_len."""
    C, L_pad, S_pad, buckets, clip, i16, _ = cfg
    n_max = max(b[2] for b in buckets)
    i = 0
    rows = []
    for b in buckets:
        k = _BUCKET_ARGS[b[0]]
        rows.append(bucket_rows(b, flat[i : i + k], C, n_max))
        i += k
    return chunk_output(rows, *flat[i : i + 4], C, L_pad, clip, i16)


def mesh_shard_program(cfg, *flat):
    """One shard's rows of a meshed chunk on the shard's device: every
    bucket's rows (:func:`bucket_rows`), concatenated ``[sum_b B_b / K,
    n_max, C]``.  ``cfg = (C, buckets, devices, shard)``: the bucket cfgs
    of :func:`batch_program` (each ``B_pad`` the whole bucket's), the
    mesh's ``K`` shard devices as strings and this shard's index.  ``flat``
    holds each bucket's arguments in :func:`batch_program`'s layout, the
    frame-axis ones this shard's contiguous slice, the flat ids whole, the
    tables this device's."""
    C, buckets, _, _ = cfg
    n_max = max(b[2] for b in buckets)
    i = 0
    rows = []
    for b in buckets:
        k = _BUCKET_ARGS[b[0]]
        rows.append(bucket_rows(b, flat[i : i + k], C, n_max))
        i += k
    return torch.cat(rows, dim=0)


def mesh_out_program(cfg, *flat):
    """A meshed chunk's output ``[L_pad, C]`` on the output device, from
    every shard program's rows: the rows in :func:`batch_program`'s order
    (bucket-major, the shards in order within a bucket), then
    :func:`chunk_output`.  ``cfg = (C, L_pad, S_pad, per, clip, i16,
    devices)``: ``per`` a shard's row count in each bucket, ``devices`` the
    ``K`` shard devices as strings.  ``flat`` is the ``K`` shards' rows,
    then segE, prim, sec, sec_len on the output device."""
    C, L_pad, _, per, clip, i16, devices = cfg
    shards, seg = flat[: len(devices)], flat[len(devices) :]
    dev = seg[0].device
    rows = []
    r0 = 0
    for p in per:
        rows += [s[r0 : r0 + p].to(dev, non_blocking=True) for s in shards]
        r0 += p
    return chunk_output(rows, *seg, C, L_pad, clip, i16)


def mesh_program(cfg, *flat):
    """A whole meshed chunk op by op, as the capture hook records it: cfg
    ``("mesh", shard_cfgs, out_cfg)``; ``flat`` each shard's
    :func:`mesh_shard_program` arguments in turn, then
    :func:`mesh_out_program`'s without the rows.  Returns the chunk output
    ``[L_pad, C]``."""
    _, shard_cfgs, out_cfg = cfg
    k = sum(_BUCKET_ARGS[b[0]] for b in shard_cfgs[0][1])
    rows = [mesh_shard_program(c, *flat[i * k : (i + 1) * k])
            for i, c in enumerate(shard_cfgs)]
    return mesh_out_program(out_cfg, *rows, *flat[len(shard_cfgs) * k :])


class _StreamState:
    """Per-stream decode state inside a batch."""

    __slots__ = (
        "reader", "decoder", "native", "planner", "carry", "chunk_base",
        "out", "done", "pcm", "last_plan", "table", "cursor", "ov_tab",
        "blk_tab", "out_pos",
    )


class BatchDecoder:
    """Co-batched decoder over many sources on ``device``.

    ``decode_all()`` returns one interleaved float32 array per source, each
    equal (to float rounding) to that source's single-stream decode.
    ``engine="host"`` decodes every stream on the host engine (no device,
    no co-batching), as does ``"auto"`` without a mesh under
    ``NVT_ENGINE=host`` (``device`` still resolved); ``"auto"`` co-batches
    on ``device``, or over ``mesh``
    (see the module docstring; ``device`` is then ignored and the gathered
    output lives on ``mesh.devices[0, 0]``).  After ``decode_all``,
    ``routes[i]`` says how source ``i`` was decoded: ``"device"``
    (co-batched), ``"host_spec"`` (a Floor0 stream, on the host engine's
    spectrum lane), ``"oracle"`` (no native plane: the oracle read loop) or
    ``"host"`` (``engine="host"``); ``chunks`` counts the chunks
    dispatched, ``programs`` how their programs ran (eager, captured,
    replayed; :func:`~nvorbis_tpu_torch.engine.programs.new_counts`; under
    a mesh a chunk runs one program per shard and the output program, each
    counted) and
    ``shard_launches[k]`` the IMDCT kernel launches of shard ``k`` (one
    shard without a mesh; a replayed program counts the launches its graph
    runs).  Only the host routes set a
    stream's ``has_clipped``: the device path's clamp rides the chunk
    epilogue.
    """

    def __init__(self, sources, device="cuda", clip_samples=True,
                 engine="auto", mesh=None):
        if engine not in ("auto", "host"):
            raise ValueError(f"unknown engine {engine!r} (auto or host)")
        if (engine == "auto" and mesh is None
                and os.environ.get("NVT_ENGINE") == "host"):
            # a CUDA request without a card raises on every route
            resolve_device(device)
            engine = "host"
        self._host_mode = engine == "host"
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a nvorbis_tpu_torch.parallel."
                            f"sharded.Mesh (build_mesh), not {type(mesh)}")
        # one device per shard of a bucket's frames: the mesh's 'stream'
        # rows (each at freq 0), or the one device
        if self._host_mode:
            self._device = None
            self._shards = []
        elif mesh is not None:
            self._shards = list(mesh.devices[:, 0])
            self._device = mesh.devices[0, 0]
        else:
            self._device = resolve_device(device)
            self._shards = [self._device]
        # the mesh programs' cfgs name the shard devices, not the mesh
        self._mesh_devices = (tuple(str(d) for d in self._shards)
                              if mesh is not None else None)
        self._fetch = (PinnedFetch(self._device)
                       if self._device is not None else None)
        # the chunk-program capture hook (tools/device_synth_torch.py): a
        # list makes _dispatch record (cfg, flat, L_real) per chunk, the
        # chunk's arrays uploaded afresh, so that batch_program(cfg, *flat)
        # (mesh_program under a mesh) replays it, and keep the chunk's
        # output in _capture_out; _capture_only skips the fetch and the
        # emit
        self._capture = None
        self._capture_only = False
        self.routes = None
        self.chunks = 0  # chunks dispatched by decode_all
        self.programs = programs.new_counts()
        self.shard_launches = [0] * len(self._shards)
        # the collect's fresh arrays every chunk (the unpack's outputs and
        # their concatenations): the page-recycling allocator policy keeps
        # their pages warm (NVT_NO_MALLOPT opts out)
        enable_page_recycling()
        self.clip_samples = clip_samples

        self._streams = []
        unpackers = {}  # id(setup) -> NativeUnpacker|None (setups are
        # shared across same-header streams via the setup cache, and the
        # unpacker is stateless per call, so one instance serves them all)
        tables_by_src = {}  # (id(src), serial) -> packet table: duplicate
        # source objects (a fleet decoding N copies of one blob) share one
        # container packetization pass; tables are read-only per cursor
        with span("batch.open"):
            for src in sources:
                self._streams.append(
                    self._open_stream(src, unpackers, tables_by_src))

    def _open_stream(self, src, unpackers, tables_by_src):
        """One source's :class:`_StreamState`: its reader, its unpacker
        (shared by setup in ``unpackers``), its packet table (shared by
        source and serial in ``tables_by_src``) and its planner."""
        st = _StreamState()
        with span("batch.headers"):
            st.reader = VorbisReader(src, engine="oracle")
            st.decoder = st.reader._stream_decoder
            skey = id(st.decoder._setup)
            if skey in unpackers:
                st.native = unpackers[skey]
            else:
                try:
                    st.native = unpacker_for(
                        st.decoder._setup, st.decoder._max_posts
                    )
                except RuntimeError:
                    # no native plane (NVT_NO_NATIVE, missing toolchain):
                    # this stream takes the oracle read loop instead of
                    # failing the batch
                    st.native = None
                unpackers[skey] = st.native
        # clean-path packet table: one C++ pass packetizes the whole
        # logical stream (ogg/fast_packets.py); any anomaly —
        # corruption, resync, unbuffered source — keeps the Python
        # provider, which owns the reference's recovery semantics
        st.table = None
        st.cursor = None  # PacketTableCursor when the table exists
        if st.native is not None:
            tkey = (id(src),
                    st.decoder._packet_provider.stream_serial)
            if tkey in tables_by_src:
                table = tables_by_src[tkey]
            else:
                with span("batch.packetize"):
                    table = table_for_decoder(st.decoder)
                tables_by_src[tkey] = table
            if table is not None:
                st.table = table
                st.cursor = PacketTableCursor(table)
        # vectorized (mode, window) -> (start, valid, total) and block
        # size lookups for the windowed planner fast path
        setup = st.decoder._setup
        w_max = max(len(m.overlaps) for m in setup.modes)
        st.ov_tab = np.zeros((len(setup.modes), w_max, 3), dtype=np.int64)
        st.blk_tab = np.zeros(len(setup.modes), dtype=np.int64)
        for mi, m in enumerate(setup.modes):
            st.blk_tab[mi] = m.block_size
            for wi, svt in enumerate(m.overlaps):
                st.ov_tab[mi, wi] = svt
        st.planner = StreamPlanner()
        st.carry = None
        st.last_plan = None
        st.chunk_base = 0
        st.out = []
        st.out_pos = 0
        st.pcm = None
        if st.table is not None:
            # final granule bounds the output (end-trim only shrinks):
            # preallocate the stream's PCM so chunk fetches write in
            # place — no end-of-decode concatenate pass
            gran, fl = st.table[2], st.table[3]
            with_g = gran[(fl & 2) != 0]
            if len(with_g):
                bound = int(with_g[-1]) + setup.block1_size
                st.pcm = np.empty(
                    bound * setup.channels, dtype=np.float32
                )
        st.done = False
        return st

    @property
    def _capture(self):
        return self._capture_list

    @_capture.setter
    def _capture(self, records):
        self._capture_list = records
        self._capture_out = []  # out[:L_real] of each recorded chunk

    def _route(self, st):
        if st.native is None:
            return "oracle"
        if self._host_mode:
            return "host"
        return "host_spec" if getattr(st.native, "spec_only", False) \
            else "device"

    # -- grouping ------------------------------------------------------------

    @staticmethod
    def _group_key(setup, native):
        # block_flag matters even when block0 == block1 (spec-legal): same-
        # size modes can differ in window count, and win_tables are sized
        # from members[0] only
        modes_key = tuple(
            (m.block_size, m.block_flag,
             tuple(zip(m.mapping.coupling_mag, m.mapping.coupling_ang)))
            for m in setup.modes
        )
        # symbol mode shares residue tables group-wide, so the tables'
        # content is part of the key (identical files co-batch; different
        # codebooks split into separate groups)
        plans = getattr(native, "sym_plans", None)
        if plans is None:
            sym_key = "dense"
        else:
            h = hashlib.md5()
            for m in setup.modes:
                plan = plans[id(setup.residues[m.mapping.submap_residue[0]])]
                for arr in (plan.groups_np, plan.pair_np, plan.vq_mega_np):
                    h.update(arr.tobytes())
                h.update(bytes([plan.residue_type]))
                h.update(plan.begin.to_bytes(4, "little"))
                h.update(plan.psize.to_bytes(4, "little"))
            sym_key = h.hexdigest()
        return (setup.channels, setup.block0_size, setup.block1_size,
                modes_key, sym_key)

    def decode_all(self):
        """One interleaved float32 array per source (see the class)."""
        self.routes = [self._route(st) for st in self._streams]
        self.chunks = 0
        self.programs = programs.new_counts()
        self.shard_launches = [0] * len(self._shards)
        if self._host_mode:
            return self._decode_all_host()
        groups = defaultdict(list)
        for st in self._streams:
            if st.native is None or getattr(st.native, "spec_only", False):
                # fallback: no native plane -> per-stream oracle decode;
                # spec-only native (Floor0) -> the host engine's spectrum
                # lane (the device planes have no Floor0 form)
                st.reader.clip_samples = self.clip_samples
                st.pcm = None  # fallback decoders return their own buffer
                if st.native is not None:
                    st.decoder._started = True
                    hb = HostBulkDecoder(st.decoder, st.native,
                                         table=st.table,
                                         clip=self.clip_samples)
                    st.out = [hb.run()]
                    if self.clip_samples and hb.maxabs > CLIP_LIMIT:
                        st.decoder._has_clipped = True
                else:
                    st.out = [st.reader.read_all()]
                st.done = True
                continue
            groups[self._group_key(st.decoder._setup, st.native)].append(st)

        try:
            # the chunks' program arguments are carved from a staging ring
            # of the device, page-locked on a card (utils/staging.py)
            with staging.borrowed(self._device) as self._ring:
                for key, members in groups.items():
                    self._decode_group(members)
        finally:
            self._ring = None
            if self._unpack_pool is not None:
                self._unpack_pool.shutdown(wait=False)
                self._unpack_pool = None

        # clipping happened on the device (the chunk epilogue) or inside the
        # fallback reader — no whole-output host pass here
        results = []
        for st in self._streams:
            if st.pcm is not None:
                pcm = st.pcm[: st.out_pos]
            elif st.out:
                pcm = st.out[0] if len(st.out) == 1 else np.concatenate(st.out)
            else:
                pcm = np.zeros(0, dtype=np.float32)
            results.append(pcm)
            st.reader.dispose()
        return results

    def _decode_all_host(self):
        """Host-engine decode of every stream (no device, no co-batching).

        Per-stream host bulk decode: host-side there is no
        dispatch/transfer overhead for co-batching to amortize, so N
        streams decode at the single-stream host rate — and streams are
        INDEPENDENT, so on multi-core hosts they fan out over a thread
        pool (the heavy stages — C++ unpack, pocketfft DCT, C++
        window/OLA — all release the GIL; the shared unpacker is
        stateless per call with thread-local C++ scratch).
        ``NVT_HOST_THREADS`` overrides the default ``min(streams,
        cpu_count)``; single-core hosts keep the sequential loop.
        Streams without a native plane (Floor0 / NVT_NO_NATIVE) use their
        reader's oracle read loop, as in the device path's fallback."""
        threads = int(os.environ.get("NVT_HOST_THREADS", "0") or 0)
        if threads <= 0:
            threads = min(len(self._streams), os.cpu_count() or 1)
        threads = max(1, min(threads, len(self._streams)))

        def _one(st):
            st.pcm = None  # the host decoder returns its own buffer
            if st.native is None:
                st.reader.clip_samples = self.clip_samples
                pcm = st.reader.read_all()
            else:
                st.decoder._started = True
                hb = HostBulkDecoder(st.decoder, st.native, table=st.table,
                                     clip=self.clip_samples)
                # outer per-stream threading owns the cores: keep the
                # unpack's internal packet pool at one thread
                hb.unpack_threads = 1 if threads > 1 else 0
                pcm = hb.run()
                # the clamp rides the OLA store; maxabs is pre-clamp
                if self.clip_samples and hb.maxabs > CLIP_LIMIT:
                    st.decoder._has_clipped = True
            st.out = [pcm]
            st.done = True
            st.reader.dispose()
            return pcm

        if threads == 1:
            return [_one(st) for st in self._streams]
        with ThreadPoolExecutor(max_workers=threads) as pool:
            return list(pool.map(_one, self._streams))

    # -- group decode --------------------------------------------------------

    def _decode_group(self, members):
        setup0 = members[0].decoder._setup
        C = setup0.channels
        P = max(st.decoder._max_posts for st in members)
        n_modes = len(setup0.modes)
        # the group's stacked tables, uploaded once per device
        tables = group_tables([st.decoder._setup for st in members], P)
        tabs = {
            dev: {n: (torch.as_tensor(xs, device=dev),
                      torch.as_tensor(win, device=dev), None,
                      torch.as_tensor(sl, device=dev))
                  for n, (xs, win, sl) in tables.items()}
            for dev in dict.fromkeys(self._shards)
        }

        # the symbol lane needs one residue plan per block size (buckets
        # are keyed by size); NVT_NO_SYMBOLS forces the dense lane, the
        # A/B twin
        sym_plans = (None if os.environ.get("NVT_NO_SYMBOLS")
                     else getattr(members[0].native, "sym_plans", None))
        plan_of = {}
        if sym_plans is not None:
            for m in setup0.modes:
                plan = sym_plans[id(setup0.residues[
                    m.mapping.submap_residue[0]])]
                if plan_of.setdefault(m.block_size, plan) is not plan:
                    plan_of = None
                    break
        self._sym = bool(plan_of)
        self._sym_info = {
            n: (plan_static(p, n),
                {dev: plan_tables(p, dev) for dev in tabs})
            for n, p in (plan_of or {}).items()
        }

        self._stream_slot = {id(st): i for i, st in enumerate(members)}
        active = list(members)

        def collect():
            with span("batch.collect"):
                return self._collect_chunk(active, P, n_modes)

        def dispatch(chunk):
            with span("batch.dispatch"):
                return self._dispatch(chunk, C, P, setup0, tabs)

        # the fetch worker: the main thread collects and dispatches chunk
        # k+1 while the worker waits on chunk k's copy and emits it; one
        # worker keeps each stream's chunk order, and at most two chunks
        # are pending
        pending = deque()
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="nvt-fetch") as pool:
            while active:
                chunk = collect()
                if chunk is None:
                    break
                pending.append(pool.submit(_fetch_and_emit, dispatch(chunk)))
                while len(pending) > 2:
                    with span("batch.wait"):
                        pending.popleft().result()
                active = [st for st in active if not st.done]
            while pending:
                with span("batch.wait"):
                    pending.popleft().result()

        for st in members:
            dec = st.decoder
            dec._eos_found = True
            dec._prev_buf = None
            dec._started = True
            dec._current_position = st.planner.stream_pos0 + st.planner.emitted

    def _collect_chunk(self, active, P, n_modes):
        """Pull up to CHUNK_FRAMES packets across active streams.

        Returns per-frame arrays + per-stream segment info, or None when all
        streams are exhausted.
        """
        residues = []
        classes_l = []
        ids_l = []
        yss = []
        useds = []
        hfs = []
        metas = []

        # phase 1: pull packet windows per stream.  Streams with a packet
        # table (one prior C++ packetization pass) slice it with vectorized
        # mode peeks; others walk the Python provider per packet.
        with span("batch.pull"):
            # dicts: st, n, view|raws, granules, eos, resync, ovh_bits
            jobs = []
            budget = CHUNK_FRAMES
            size_counts = {}
            for st in active:
                if st.done or budget <= 0:
                    continue
                if size_counts and max(size_counts.values()) >= CAP_PER_SIZE:
                    break
                job = (self._pull_table if st.table is not None
                       else self._pull_provider)(st, budget, size_counts)
                if job is not None:
                    budget -= job["n"]
                    jobs.append(job)
        if not jobs:
            return None

        # phase 2: bit-serial unpack, all streams concurrently (the C++
        # core releases the GIL and threads internally; multiple windows
        # in flight keep its pool fed when per-stream windows are small)
        def _unpack(job):
            st = job["st"]
            view = job.get("view")
            if view is not None:
                if self._sym:
                    return st.native.unpack_sym_view(*view)
                return st.native.unpack_view(*view)
            if self._sym:
                return st.native.unpack_sym(job["raws"])
            return st.native.unpack(job["raws"])

        with span("batch.unpack"):
            if len(jobs) == 1:
                unpacked = [_unpack(jobs[0])]
            else:
                # persistent pool: per-chunk executor create/join costs
                # ~5-8 ms/chunk in pure thread churn
                ex = self._unpack_pool
                if ex is None:
                    ex = self._unpack_pool = ThreadPoolExecutor(
                        max_workers=4, thread_name_prefix="nvt-unpack"
                    )
                unpacked = list(ex.map(_unpack, jobs))

        # phase 3: per-packet lapping plans + stats (order-sensitive)
        with span("batch.plan"):
            stream_rows = []  # (st, r0, r1, plans|None, last_plan)
            plan_cols = []    # per job: [nj, 5] int64 (ok, pos_base, start,
                              # valid, total) — the dispatch-plane view; the
                              # boxed FramePlan list exists only on the
                              # sequential fallback path (bad packets)
            r0 = 0
            for job, arrs in zip(jobs, unpacked):
                st = job["st"]
                dec = st.decoder
                setup = dec._setup
                if self._sym:
                    classes, ids, ys, used, has_floor, meta = arrs
                    classes_l.append(classes)
                    ids_l.append(ids)
                else:
                    residue, ys, used, has_floor, meta = arrs
                pa, new_plans, st.last_plan = plan_job_arr(
                    st.planner, st.ov_tab, st.blk_tab, setup, meta, job,
                    dec._stats, st.last_plan,
                )
                plan_cols.append(pa)
                stream_rows.append((st, r0, r0 + len(pa), new_plans,
                                    st.last_plan))
                r0 += len(pa)
                if not self._sym:
                    residues.append(residue)
                yss.append(ys)
                useds.append(used)
                hfs.append(has_floor)
                metas.append(meta)
        with span("batch.gather"):
            chunk = {
                "ys": self._pad_cat(yss, P),
                "used": self._pad_cat(useds, P),
                "has_floor": np.concatenate(hfs),
                "plan_arr": np.concatenate(plan_cols),
                "stream_rows": stream_rows,
                "meta": np.concatenate(metas),
            }
            if self._sym:
                chunk["classes"] = np.concatenate(classes_l)
                # the ids stay in the unpack's per-job [rows, max_ids]
                # arrays: _stage_ids copies each row's prefix straight
                # into the ring, by the address of its row
                chunk["ids"] = ids_l
                chunk["id_rows"] = np.concatenate(
                    [row_pointers(a) for a in ids_l])
            else:
                chunk["residue"] = np.concatenate(residues)
        return chunk

    def _pull_provider(self, st, budget, size_counts):
        """Per-packet pull through the Python provider (robust path)."""
        dec = st.decoder
        setup = dec._setup
        mfb = setup.mode_field_bits
        nm = len(setup.modes)
        raws, granules, eos, resync, ovh_bits = [], [], [], [], []
        while len(raws) < budget:
            if size_counts and max(size_counts.values()) >= CAP_PER_SIZE:
                break
            p = dec._packet_provider.get_next_packet()
            if p is None:
                st.done = True
                break
            data = bytes(p.data)
            raws.append(data)
            granules.append(p.granule_position)
            eos.append(p.is_end_of_stream)
            resync.append(p.is_resync)
            ovh_bits.append(p.container_overhead_bits)
            p.done()
            mi = peek_mode_index(data, mfb)
            if mi is not None and mi < nm:
                n = setup.modes[mi].block_size
                size_counts[n] = size_counts.get(n, 0) + 1
        if not raws:
            return None
        return {
            "st": st, "n": len(raws), "raws": raws, "granules": granules,
            "eos": eos, "resync": resync, "ovh_bits": ovh_bits,
        }

    def _pull_table(self, st, budget, size_counts):
        """Vectorized window slice out of the stream's packet table."""
        job = st.cursor.pull(
            st.decoder._setup, st.blk_tab, budget, size_counts, CAP_PER_SIZE
        )
        if st.cursor.done:
            st.done = True
        if job is not None:
            job["st"] = st
        return job

    @staticmethod
    def _pad_cat(arrs, P):
        out = []
        for a in arrs:
            if a.shape[2] < P:
                a = np.pad(a, [(0, 0), (0, 0), (0, P - a.shape[2])])
            out.append(a)
        return np.concatenate(out)

    def _dispatch(self, chunk, C, P, setup0, tabs):
        """Stage one chunk's bucket tensors and segment tables, synthesize
        each bucket shard by shard (:func:`bucket_rows` on each shard's
        device), run :func:`chunk_output` on the output device and start
        the chunk's copy to the host; returns a callable that waits for it
        and writes each stream's samples.  Bucketing, flat-row assignment
        and the per-stream segment tables are whole-array numpy; streams
        whose window holds a bad packet take build_segments' scalar walk,
        which owns the drain-the-previous-tail semantics
        (``NVorbis/StreamDecoder.cs:352-356``)."""
        ring = self._ring
        with span("batch.stage"):
            ring.begin()
            # [R, 5]: ok, pos_base, start, valid, total
            arr = chunk["plan_arr"]
            meta_all = chunk["meta"]
            stream_rows = chunk["stream_rows"]
            n_modes = len(setup0.modes)
            R = arr.shape[0]
            out_dev = self._device
            n_shards = len(self._shards)

            ok = arr[:, 0] == 1
            mode_r = meta_all[:, 1].astype(np.int64)
            widx_r = meta_all[:, 2].astype(np.int64)
            blk_vec = np.array([m.block_size for m in setup0.modes],
                               dtype=np.int64)
            # bad rows may carry garbage mode fields: clamp the index, zero
            # the size so they never match a bucket
            bsz = np.where(ok, blk_vec[np.minimum(mode_r, n_modes - 1)], 0)

            slot_r = np.empty(R, dtype=np.int64)  # stream slot per chunk row
            for st, r0, r1, _, _ in stream_rows:
                slot_r[r0:r1] = self._stream_slot[id(st)]

            # bucket sizes present, plus carry-only block sizes
            ns = {int(n) for n in np.unique(bsz[ok])} if ok.any() else set()
            carries = []
            for st, _, _, _, _ in stream_rows:
                if st.carry is not None:
                    carries.append(st)
                    ns.add(setup0.modes[st.carry[0]["meta"][1]].block_size)

            row_base = 0
            # chunk row -> flat bucket row
            gr = np.full(R, -1, dtype=np.int64)
            n_max = max(ns) if ns else setup0.block1_size
            carry_rows = {}
            # per bucket: (cfg bucket, frame-major arrays, flat ids or None,
            # per-frame arrays), each array padded to the bucket's B_pad and
            # carved from the staging ring: every element is written below
            staged = []

            for n in sorted(ns):
                ridx = np.flatnonzero(ok & (bsz == n))
                n2 = n // 2
                # carries whose frame uses this block size
                cs = [st for st in carries if
                      setup0.modes[st.carry[0]["meta"][1]].block_size == n]
                B_pad = _bucket_size(len(ridx) + len(cs), n_shards)
                if not self._sym:
                    res_b = ring.take((B_pad, C, n2), np.float32)
                ys_b = ring.take((B_pad, C, P), np.int16)
                used_b = ring.take((B_pad, C, P), bool)
                hf_b = ring.take((B_pad, C), bool)
                widx_b = ring.take(B_pad, np.int32)
                tid_b = ring.take(B_pad, np.int32)

                j = 0
                for st in cs:
                    crow, _ = st.carry
                    if not self._sym:
                        res_b[j] = crow["residue"][:, :n2]
                    w = crow["ys"].shape[1]
                    ys_b[j, :, :w] = crow["ys"]
                    ys_b[j, :, w:] = 0
                    w = crow["used"].shape[1]
                    used_b[j, :, :w] = crow["used"]
                    used_b[j, :, w:] = False
                    hf_b[j] = crow["has_floor"]
                    widx_b[j] = crow["meta"][2]
                    tid_b[j] = crow["tid"]
                    carry_rows[id(st)] = row_base + j
                    j += 1
                if len(ridx):
                    Rn = len(ridx)
                    dst = slice(j, j + Rn)
                    ys_b[dst] = chunk["ys"][ridx]
                    used_b[dst] = chunk["used"][ridx]
                    hf_b[dst] = chunk["has_floor"][ridx]
                    widx_b[dst] = widx_r[ridx]
                    tid_b[dst] = slot_r[ridx] * n_modes + mode_r[ridx]
                    if not self._sym:
                        # one pass into the ring; mode="clip" (the indices
                        # are in range) writes straight into it, where
                        # "raise" would fill a temporary first
                        src = chunk["residue"]
                        if src.shape[2] == n2:
                            np.take(src, ridx, axis=0, out=res_b[dst],
                                    mode="clip")
                        else:
                            res_b[dst] = src[ridx, :, :n2]
                    gr[ridx] = row_base + j + np.arange(Rn)
                    j += Rn
                # the padding rows, which no write above covers: zero
                pad = slice(j, B_pad)
                if not self._sym:
                    res_b[pad] = 0
                ys_b[pad] = 0
                used_b[pad] = False
                hf_b[pad] = False
                widx_b[pad] = 0
                tid_b[pad] = 0

                T, W = tabs[out_dev][n][1].shape[:2]
                # the group key guarantees every mode of this block size
                # shares the coupling topology
                m = next(m for m in setup0.modes if m.block_size == n)
                cpl = tuple(zip(m.mapping.coupling_mag,
                                m.mapping.coupling_ang))
                per_frame = (ys_b, used_b, hf_b, widx_b, tid_b)
                if self._sym:
                    with span("batch.ids"):
                        st_geom, frame_major, ids = self._stage_ids(
                            n, cs, chunk, ridx, B_pad)
                    staged.append((("s", B_pad, n, P, W, T, cpl, st_geom,
                                    len(ids)), frame_major, ids, per_frame))
                else:
                    staged.append((("d", B_pad, n, P, W, T, cpl), (res_b,),
                                   None, per_frame))
                row_base += B_pad

        # --- per-stream segment tables laid out consecutively -------------
        with span("batch.segments"):
            seg_s, seg_prim, seg_sec, seg_sl = [], [], [], []
            ranges = []
            out_off = 0
            for i, (st, r0, r1, plan_objs, last_plan_obj) in enumerate(
                    stream_rows):
                sid = id(st)
                chunk_base = st.chunk_base
                prev_plan = st.carry[1] if st.carry is not None else None
                prev_row = carry_rows.get(sid)
                okm = ok[r0:r1]
                if r1 > r0:
                    s_, prim_, sec_, sl_ = build_segments(
                        arr[r0:r1], gr[r0:r1], n_max, prev_plan,
                        prev_row if prev_row is not None else 0, chunk_base,
                    )
                    seg_s.append(out_off + s_)
                    seg_prim.append(prim_)
                    seg_sec.append(sec_)
                    seg_sl.append(sl_)

                length_total = st.planner.emitted - chunk_base
                if length_total > 0:
                    ranges.append((st, out_off, length_total))
                    out_off += length_total

                # carry the last good frame into the next chunk (its tail may
                # still lap into samples emitted there)
                good_idx = np.flatnonzero(okm)
                if len(good_idx):
                    k = r0 + int(good_idx[-1])
                    meta_k = meta_all[k]
                    crow = {
                        "ys": chunk["ys"][k].copy(),
                        "used": chunk["used"][k].copy(),
                        "has_floor": chunk["has_floor"][k].copy(),
                        "meta": meta_k,
                        "tid": (self._stream_slot[sid] * n_modes
                                + int(meta_k[1])),
                    }
                    if self._sym:
                        crow["classes"] = chunk["classes"][k].copy()
                        crow["ids"] = (
                            chunk["ids"][i][k - r0, : int(meta_k[5])].copy())
                    else:
                        crow["residue"] = chunk["residue"][k].copy()
                    # the vectorized plan path boxes only the window's
                    # final plan; with every frame good, the last good row
                    # is it
                    st.carry = (crow, plan_objs[k - r0]
                                if plan_objs is not None else last_plan_obj)
                st.chunk_base = st.planner.emitted

            L_real = out_off
            if L_real == 0:
                return lambda: None
            self.chunks += 1
            # quantized shapes, as the JAX package lays them out: padding
            # segments start past L_pad, and the fetch takes only [0, L_real)
            L_pad = pad_quantum(L_real, L_QUANTUM)
            segs_s = (np.concatenate(seg_s) if seg_s
                      else np.zeros(0, dtype=np.int64))
            n_segs = len(segs_s)
            S_pad = round_up(max(1, n_segs), 256)
            segE = ring.take(S_pad + 1, np.int32)
            seg = ring.take((3, S_pad), np.int32)  # prim, sec, sec_len
            segE[:n_segs] = segs_s
            segE[n_segs:] = L_pad + 1 + np.arange(n_segs, S_pad + 1,
                                                  dtype=np.int32)
            seg[:, n_segs:] = 0
            if n_segs:
                seg[0, :n_segs] = np.concatenate(seg_prim)
                seg[1, :n_segs] = np.concatenate(seg_sec)
                seg[2, :n_segs] = np.concatenate(seg_sl)
        i16 = int16_transport_enabled()
        with span("batch.program"):
            if self._mesh_devices is not None:
                cfg, parts, out = self._run_mesh(
                    staged, C, tabs, L_pad, S_pad, i16, [segE, *seg], L_real)
            else:
                # batch_program's cfg; its last entry is the JAX package's
                # ola_scan, False: the port's one overlap-add is its
                # searchsorted form
                cfg = (C, L_pad, S_pad, tuple(b[0] for b in staged),
                       self.clip_samples, i16, False)
                flat = []
                for bucket, frame_major, ids, per_frame in staged:
                    flat += self._bucket_args(bucket, frame_major, ids,
                                              per_frame, tabs, out_dev)
                flat += [segE, *seg]
                before = _op.launches
                out, mode = programs.run("batch", batch_program, cfg, flat,
                                         out_dev, L_real)
                self.shard_launches[0] += _op.launches - before
                programs.count(self.programs, mode)
                parts = [(flat, out_dev)]
            # the ring's region is written again once these copies are
            # through
            ring.release(self._shards)
        if self._capture is not None:
            # batch_program(cfg, *flat), or mesh_program under a mesh,
            # replays this chunk: the chunk's arrays copied afresh (a
            # graph's slots and the staging ring are rewritten by later
            # chunks), the tables as they are
            self._capture.append(
                (cfg, [a for f, dev in parts
                       for a in programs.copied(f, dev)], L_real))
            self._capture_out.append(out)
            if self._capture_only:
                return lambda: None
        with span("batch.copy_start"):
            fetched = self._fetch(out, quantized=i16)

        def finish():
            # runs on the fetch worker (decode_all): it touches only
            # st.pcm, st.out_pos and st.out, and the main thread's collect
            # and dispatch of the next chunk only st.planner, st.carry,
            # st.chunk_base, st.done, st.last_plan and st.cursor, so the
            # two never share a field
            host = fetched()
            with span("batch.emit"):
                for st, off, length in ranges:
                    flat = host[off : off + length].reshape(-1)
                    if st.pcm is not None:
                        # preallocated from the packet table's final
                        # granule: no end-of-decode concatenate pass
                        end = st.out_pos + flat.size
                        if end <= st.pcm.size:
                            if (flat.flags.c_contiguous
                                    and flat.dtype == st.pcm.dtype):
                                # ctypes.memmove releases the GIL during
                                # the copy (a slice assignment holds it),
                                # so the emit does not hold up the main
                                # thread's collect of the next chunk
                                ctypes.memmove(
                                    st.pcm.ctypes.data
                                    + st.out_pos * st.pcm.itemsize,
                                    flat.ctypes.data, flat.nbytes)
                            else:
                                st.pcm[st.out_pos : end] = flat
                            st.out_pos = end
                            continue
                        # past the estimate (a trim-free stream): spill
                        st.out.append(st.pcm[: st.out_pos].copy())
                        st.pcm = None
                    st.out.append(flat.copy())

        return finish

    def _stage_ids(self, n, carries, chunk, ridx, B_pad):
        """One symbol bucket's VQ classes, frame bases and flat ids, carved
        from the staging ring: the ``carries``' frames first, then the
        chunk's rows ``ridx``, then class sentinels on the padding rows.
        The ids go in one native row copy (:func:`stage_ids`): each frame's
        prefix from its carried ids or its row of the unpack's ids.
        Counts the ids before padding (``sym.ids``), the ids the row copy
        wrote (``sym.ids_copied``) and the padded vector handed to the
        program (``sym.ids_staged``).  Returns ``(geometry, (classes, frame
        bases), ids)``."""
        ring = self._ring
        st_geom = self._sym_info[n][0]
        n_part, chr_c = st_geom.n_part, st_geom.chr_count
        cls_b = ring.take((B_pad, chr_c, max(1, n_part)), np.uint8)
        base_b = ring.take(B_pad, np.int32)
        j = len(carries) + len(ridx)
        src = np.empty(j, np.int64)
        counts = np.empty(j, np.int32)
        for k, st in enumerate(carries):
            crow = st.carry[0]
            cls_b[k, :, :n_part] = crow["classes"][:chr_c, :n_part]
            src[k] = crow["ids"].ctypes.data
            counts[k] = len(crow["ids"])
        if len(ridx):
            dst = slice(len(carries), j)
            cls_b[dst, :, :n_part] = chunk["classes"][ridx][:, :chr_c, :n_part]
            src[dst] = chunk["id_rows"][ridx]
            counts[dst] = chunk["meta"][ridx, 5]
        cls_b[:j, :, n_part:] = CLASS_SENTINEL
        cls_b[j:] = CLASS_SENTINEL
        base_b[j:] = 0
        ids, pos = stage_ids(src, counts, base_b[:j], ring.take)
        count("sym.ids", int(counts.sum(dtype=np.int64)))
        count("sym.ids_copied", pos)
        count("sym.ids_staged", len(ids))
        return st_geom, (cls_b, base_b), ids

    def _bucket_args(self, bucket, frame_major, ids, per_frame, tabs, dev):
        """One bucket's arguments in :func:`batch_program`'s layout: its
        numpy arrays, then the group's tables on ``dev``."""
        n = bucket[2]
        if ids is None:
            return [*frame_major, *per_frame, *tabs[dev][n]]
        return [frame_major[0], ids, frame_major[1], *per_frame,
                *tabs[dev][n], *self._sym_info[n][1][dev]]

    def _run_mesh(self, staged, C, tabs, L_pad, S_pad, i16, seg, L_real):
        """One meshed chunk: a :func:`mesh_shard_program` per shard on its
        device (each bucket's frames in contiguous shards, one per mesh
        stream row; the flat ids, whose frame_base holds absolute offsets,
        and the tables go whole), then :func:`mesh_out_program` on the
        output device over ``seg`` (segE, prim, sec, sec_len).  Returns
        ``(cfg, parts, out)``: :func:`mesh_program`'s cfg, ``(flat,
        device)`` of each program without the rows, and the chunk output's
        first ``L_real`` rows."""
        K = len(self._shards)
        buckets = tuple(b[0] for b in staged)
        per = tuple(b[1] // K for b in buckets)
        cfgs, parts, rows = [], [], []
        for k, dev in enumerate(self._shards):
            cfg = (C, buckets, self._mesh_devices, k)
            flat = []
            for (bucket, frame_major, ids, per_frame), p in zip(staged, per):
                own = slice(k * p, (k + 1) * p)
                flat += self._bucket_args(
                    bucket, [a[own] for a in frame_major], ids,
                    [a[own] for a in per_frame], tabs, dev)
            before = _op.launches
            r, mode = programs.run("mesh_shard", mesh_shard_program, cfg,
                                   flat, dev, sum(per))
            self.shard_launches[k] += _op.launches - before
            programs.count(self.programs, mode)
            cfgs.append(cfg)
            parts.append((flat, dev))
            rows.append(r)
        out_cfg = (C, L_pad, S_pad, per, self.clip_samples, i16,
                   self._mesh_devices)
        out, mode = programs.run("mesh_out", mesh_out_program, out_cfg,
                                 [*rows, *seg], self._device, L_real)
        programs.count(self.programs, mode)
        parts.append((seg, self._device))
        return ("mesh", tuple(cfgs), out_cfg), parts, out

    _stream_slot = None  # set in _decode_group per group
    _ring = None  # the staging ring decode_all holds (utils/staging.py)
    _unpack_pool = None  # persistent C++-unpack thread pool (decode_all)
