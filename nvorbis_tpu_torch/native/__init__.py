"""Native host plane: build-on-demand C++ packet unpack with ctypes bindings.

The C++ core (``host_decode.cpp``) mirrors the Python host plane
(``codec/frames.py``) bit-for-bit; this module serializes a parsed stream
setup into flat blobs the C side parses once, and exposes
:class:`NativeUnpacker` which unpacks a whole window of packets into dense
batched tensors in one call (releasing the GIL, fanned out over C++ threads).

The library is compiled with g++ on first use into the package's
``_build/`` directory (never next to the source), named by a hash of the
source and the flags, so a changed source rebuilds and an unchanged one is
reused; every consumer falls back to the pure-Python path when the
toolchain or the setup shape (e.g. Floor0 streams) is not supported.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

from nvorbis_tpu_torch.codec.floor import Floor1

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_decode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = (
    "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
    # no FP contraction: the fused finish+OLA computes (±g*0.5f)*w + o
    # in one expression, and an FMA there rounds once where the
    # two-pass lane (store to rows_all, then add) rounds twice — the
    # bit-equality contract across lanes requires the same double
    # rounding.  Nothing else in this TU contracts (the other hot
    # loops are pure adds or integer), measured no ceiling change.
    "-ffp-contract=off",
)

_MAGIC = 0x4E565432

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False
lib_path = None  # the library the process loaded, once load() succeeded
# a built library to open instead of building one (None: build); an A/B
# of two builds in one process (tools/ab_so_torch.py) sets it, then reset()
_SO = None


def _so_path(flags) -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR,
                        f"libnvt_host_decode_{digest.hexdigest()[:16]}.so")


def _build(flags) -> str:
    """The library for ``flags``, compiled unless it exists; an exclusive
    lock on ``_build/`` keeps concurrent processes from compiling it
    twice.  Raises on a failed compile."""
    so = _so_path(flags)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".host_decode.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *flags, "-o", tmp, _SRC],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return so


def _build_and_open():
    """Build (or reuse) and open the library.  -march=native won every
    adjacent pair of an in-process A/B on the bit-serial unpack (BMI2
    shifts; +1-5% steady state); the library builds on first use on the
    machine that runs it, so native is normally safe.  Set
    NVT_NATIVE_PORTABLE=1 when the build directory is shared across
    heterogeneous CPUs (the flag is also dropped when the local toolchain
    rejects it).  A library that does not open (a foreign-arch file from a
    copied checkout) is rebuilt once.  With :data:`_SO` set, that library is
    opened as it is, and nothing is built."""
    global lib_path
    if _SO is not None:
        lib = ctypes.CDLL(_SO)
        lib_path = _SO
        return lib
    variants = [_FLAGS]
    if not os.environ.get("NVT_NATIVE_PORTABLE"):
        variants.insert(0, ("-march=native",) + _FLAGS)
    for i, flags in enumerate(variants):
        try:
            so = _build(flags)
        except (subprocess.CalledProcessError, OSError):
            if i + 1 < len(variants):
                continue
            raise
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            os.remove(so)
            so = _build(flags)
            lib = ctypes.CDLL(so)
        lib_path = so
        return lib
    raise OSError("no g++ build of host_decode.cpp")


def reset():
    """Forget the cached load outcome (and the shared unpackers).

    ``load()`` caches its first success *and* its first failure for the
    process lifetime; tests that toggle ``NVT_NO_NATIVE`` or repair the
    toolchain mid-process call this to force a fresh attempt."""
    global _lib, _lib_failed
    with _lib_lock:
        _lib = None
        _lib_failed = False
        _unpacker_cache.clear()


def load():
    """Load (building if needed) the native library; None when unavailable.

    ``NVT_NO_NATIVE=1`` disables it (pure-python host plane), for testing
    the fallback and for environments without a toolchain.  The first
    outcome (success or failure) is cached per process; use :func:`reset`
    to retry after a transient build failure."""
    global _lib, _lib_failed
    if os.environ.get("NVT_NO_NATIVE", "") not in ("", "0"):
        return None
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = _build_and_open()
            lib.nvt_setup_create.restype = ctypes.c_void_p
            lib.nvt_setup_create.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.nvt_setup_destroy.argtypes = [ctypes.c_void_p]
            lib.nvt_unpack_window.argtypes = [
                ctypes.c_void_p,  # setup
                ctypes.c_void_p,  # bytes
                ctypes.c_void_p,  # offsets
                ctypes.c_int32,   # n_packets
                ctypes.c_void_p,  # residue
                ctypes.c_void_p,  # ys
                ctypes.c_void_p,  # used
                ctypes.c_void_p,  # has_floor
                ctypes.c_void_p,  # meta
                ctypes.c_int32,   # n_threads
            ]
            lib.nvt_unpack_window_spec.argtypes = [
                ctypes.c_void_p,  # setup
                ctypes.c_void_p,  # bytes
                ctypes.c_void_p,  # offsets
                ctypes.c_int32,   # n_packets
                ctypes.c_void_p,  # spec
                ctypes.c_void_p,  # meta
                ctypes.c_int32,   # n_threads
            ]
            lib.nvt_unpack_window_spec_sv.argtypes = [
                ctypes.c_void_p,  # setup
                ctypes.c_void_p,  # bytes
                ctypes.c_void_p,  # starts
                ctypes.c_void_p,  # ends
                ctypes.c_int32,   # n_packets
                ctypes.c_void_p,  # spec
                ctypes.c_void_p,  # meta
                ctypes.c_int32,   # n_threads
            ]
            lib.nvt_unpack_window_spec_ptr.argtypes = [
                ctypes.c_void_p,  # setup
                ctypes.c_void_p,  # bytes
                ctypes.c_void_p,  # starts
                ctypes.c_void_p,  # ends
                ctypes.c_int32,   # n_packets
                ctypes.c_void_p,  # out_ptrs [n] i64 (float* each)
                ctypes.c_void_p,  # strides [n] i64
                ctypes.c_void_p,  # meta
                ctypes.c_int32,   # n_threads
            ]
            lib.nvt_has_spec.restype = ctypes.c_int32
            lib.nvt_has_spec.argtypes = [ctypes.c_void_p]
            lib.nvt_cycles_read.argtypes = [ctypes.c_void_p]
            lib.nvt_imdct_finish.argtypes = [
                ctypes.c_void_p,  # g
                ctypes.c_int64,   # b
                ctypes.c_int32,   # C
                ctypes.c_int32,   # n
                ctypes.c_void_p,  # idx
                ctypes.c_void_p,  # widx
                ctypes.c_void_p,  # win_tab
                ctypes.c_void_p,  # rows_all
                ctypes.c_int64,   # n_max
            ]
            lib.nvt_ola.argtypes = [
                ctypes.c_void_p,  # rows_all
                ctypes.c_int64,   # n_max
                ctypes.c_int32,   # C
                ctypes.c_void_p,  # s
                ctypes.c_void_p,  # prim
                ctypes.c_void_p,  # sec
                ctypes.c_void_p,  # sl
                ctypes.c_void_p,  # lens
                ctypes.c_int64,   # nseg
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # maxabs in/out (f32 scalar; NULL = skip)
                ctypes.c_float,   # clip_limit (>0: clamp at store time)
            ]
            lib.nvt_finish_ola.argtypes = [
                ctypes.c_void_p,  # gs (const float* const*)
                ctypes.c_void_p,  # fbuck [nF+1] i64
                ctypes.c_void_p,  # frow  [nF+1] i64
                ctypes.c_void_p,  # fns   [nF+1] i32
                ctypes.c_void_p,  # fwin  [nF+1] float* as i64
                ctypes.c_void_p,  # carry_row [C, n_max]
                ctypes.c_int64,   # n_max
                ctypes.c_int32,   # C
                ctypes.c_void_p,  # s
                ctypes.c_void_p,  # prim
                ctypes.c_void_p,  # sec
                ctypes.c_void_p,  # sl
                ctypes.c_void_p,  # lens
                ctypes.c_int64,   # nseg
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # maxabs in/out
                ctypes.c_float,   # clip_limit
            ]
            lib.nvt_crc32.restype = ctypes.c_uint32
            lib.nvt_crc32.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.nvt_build_segments.restype = ctypes.c_int64
            lib.nvt_build_segments.argtypes = [
                ctypes.c_int64,   # nF
                ctypes.c_void_p,  # pa [nF,5] i64
                ctypes.c_void_p,  # rof [nF] i64 (NULL = identity)
                ctypes.c_int64,   # n_max
                ctypes.c_int32,   # has_prev
                ctypes.c_void_p,  # prev [5] i64
                ctypes.c_int64,   # chunk_base
                ctypes.c_void_p,  # s_out
                ctypes.c_void_p,  # prim_out
                ctypes.c_void_p,  # sec_out
                ctypes.c_void_p,  # sl_out
            ]
            lib.nvt_bucket_prep.restype = ctypes.c_int64
            lib.nvt_bucket_prep.argtypes = [
                ctypes.c_int64,   # nF
                ctypes.c_void_p,  # pa [nF,5] i64
                ctypes.c_void_p,  # meta [nF,8] i32
                ctypes.c_int64,   # n_modes
                ctypes.c_void_p,  # blk [n_modes] i64
                ctypes.c_void_p,  # win_ptrs [n_modes] i64
                ctypes.c_void_p,  # fbuck [nF+1] i64
                ctypes.c_void_p,  # frow [nF+1] i64
                ctypes.c_void_p,  # fns [nF+1] i32
                ctypes.c_void_p,  # fwidx [nF+1] i32
                ctypes.c_void_p,  # fwin [nF+1] i64
                ctypes.c_void_p,  # bucket_m [n_modes] i64
                ctypes.c_void_p,  # bucket_lo
                ctypes.c_void_p,  # bucket_cnt
            ]
            lib.nvt_plan_window.restype = ctypes.c_int32
            lib.nvt_plan_window.argtypes = [
                ctypes.c_int64,   # n
                ctypes.c_void_p,  # meta [n,8] i32
                ctypes.c_int64,   # n_modes
                ctypes.c_int64,   # w_max
                ctypes.c_void_p,  # ov_tab [n_modes, w_max, 3] i64
                ctypes.c_void_p,  # blk_tab [n_modes] i64
                ctypes.c_void_p,  # gran [n] i64
                ctypes.c_void_p,  # has_gran [n] u8
                ctypes.c_void_p,  # eos [n] u8
                ctypes.c_void_p,  # resync [n] u8
                ctypes.c_void_p,  # state [11] i64 in/out
                ctypes.c_void_p,  # pa [n,5] i64 out
                ctypes.c_void_p,  # samples [n] i64 out
                ctypes.c_void_p,  # last_plan [5] i64 out
            ]
            lib.nvt_packetize.restype = ctypes.c_int64
            lib.nvt_packetize.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.nvt_unpack_window_sym.argtypes = [
                ctypes.c_void_p,  # setup
                ctypes.c_void_p,  # bytes
                ctypes.c_void_p,  # offsets
                ctypes.c_int32,   # n_packets
                ctypes.c_void_p,  # classes
                ctypes.c_void_p,  # ids
                ctypes.c_void_p,  # ys
                ctypes.c_void_p,  # used
                ctypes.c_void_p,  # has_floor
                ctypes.c_void_p,  # meta
                ctypes.c_int32,   # n_part_max
                ctypes.c_int32,   # chr_max
                ctypes.c_int32,   # max_ids
                ctypes.c_int32,   # n_threads
            ]
            lib.nvt_stage_ids.restype = ctypes.c_int64
            lib.nvt_stage_ids.argtypes = [
                ctypes.c_int64,   # n_rows
                ctypes.c_void_p,  # src [n_rows] i64 (int16* each)
                ctypes.c_void_p,  # counts [n_rows] i32
                ctypes.c_void_p,  # out [out_len] i16
                ctypes.c_int64,   # out_len
                ctypes.c_void_p,  # bases [n_rows] i32
            ]
            _lib = lib
        except Exception:
            _lib_failed = True
            return None
    return _lib


PKT_EOS = 1      # flag bits returned by packetize
PKT_HAS_GRANULE = 2


def packetize(container_bytes, serial: int):
    """Fast-lane whole-stream packetization of one logical stream.

    One C++ pass over the container: page scan + CRC + lacing walk +
    continuation stitching (host_decode.cpp nvt_packetize).  Returns
    ``(data, offsets, granules, flags, overhead)`` — packet ``i`` is
    ``data[offsets[i]:offsets[i+1]]`` — or ``None`` on any anomaly
    (corruption, resync, sequence gap) or when the native plane is
    unavailable; callers then use the Python provider, which owns the
    reference's recovery semantics."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(container_bytes, dtype=np.uint8)
    n_bytes = np.zeros(1, dtype=np.int64)
    n = lib.nvt_packetize(
        buf.ctypes.data, buf.size, serial, None, 0,
        None, None, None, None, 0, n_bytes.ctypes.data,
    )
    if n < 0:
        return None
    n = int(n)
    data = np.empty(int(n_bytes[0]), dtype=np.uint8)
    offsets = np.zeros(n + 1, dtype=np.int64)
    granules = np.full(n, -1, dtype=np.int64)
    flags = np.zeros(n, dtype=np.int32)
    overhead = np.zeros(n, dtype=np.int32)
    n2 = lib.nvt_packetize(
        buf.ctypes.data, buf.size, serial, data.ctypes.data, data.size,
        offsets.ctypes.data, granules.ctypes.data, flags.ctypes.data,
        overhead.ctypes.data, n, None,
    )
    if n2 != n:
        return None
    return data, offsets, granules, flags, overhead


def row_pointers(rows):
    """The address of each row of the C-contiguous 2-D array ``rows``,
    int64 ``[len(rows)]``: the ``src`` of :func:`stage_ids`, valid while
    ``rows`` lives."""
    if rows.ndim != 2 or not rows.flags.c_contiguous:
        raise ValueError("row_pointers takes a C-contiguous 2-D array")
    return rows.ctypes.data + np.arange(len(rows), dtype=np.int64) * (
        rows.strides[0])


def stage_ids(src, counts, bases, empty=np.empty):
    """One symbol bucket's flat int16 ids in one native row copy: the first
    ``counts[k]`` ids at address ``src[k]`` (int64; :func:`row_pointers`
    of an unpack's ids, or a compact row's ``ctypes.data``) for each row
    in order, then -1 up to ``round_ids(pos + 1)``, where ``pos`` is
    ``counts``' sum; each row's exclusive-cumsum base is written to
    ``bases`` (int32, C-contiguous, ``len(src)`` long).  The layout of
    ``pad_ids([flatten_ids(rows, counts)], pos)`` and its bases
    (synth/residue_sym.py).  The vector is ``empty(size, np.int16)`` (a
    staging ring's ``take``, say).  Returns ``(ids, pos)``."""
    from nvorbis_tpu_torch.synth.residue_sym import round_ids

    src = np.ascontiguousarray(src, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    n = len(src)
    if (len(counts) != n or len(bases) != n or bases.dtype != np.int32
            or not bases.flags.c_contiguous):
        raise ValueError("stage_ids: src, counts and int32 C-contiguous "
                         "bases of one length")
    ids = empty(round_ids(int(counts.sum(dtype=np.int64)) + 1), np.int16)
    pos = load().nvt_stage_ids(n, src.ctypes.data, counts.ctypes.data,
                               ids.ctypes.data, len(ids), bases.ctypes.data)
    if pos < 0:
        raise ValueError("negative id count, or over 2**31 ids")
    return ids, pos


def _native_table_bits() -> int:
    """Prefix-table width for the native blob (``NVT_NATIVE_TABLE_BITS``,
    default 10): codes up to this length decode via one table hit; longer
    ones fall to the sorted overflow scan.  Widening to 12 was A/B'd
    (2026-08-17) and LOST on the 8-stream host-plane workload — ~40 books
    x 32 KB of widened tables evict more cache than the 11/12-bit
    overflow scans cost (w10 won the adjacent pairs 872/804 and 909/779).
    The knob stays for hardware with bigger L2 per core."""
    v = os.environ.get("NVT_NATIVE_TABLE_BITS", "")
    try:
        return max(10, int(v)) if v else 10
    except ValueError:
        return 10


def serialize_setup(setup, max_posts):
    """Flatten a parsed setup into (int32 blob, float32 blob).

    Layout must match nvt_setup_create in host_decode.cpp.  Floor0 setups
    serialize their precomputed bark/w maps (spec-mode-only native plane;
    see NativeUnpacker.spec_only).
    """
    ints = []
    floats = []
    book_index = {id(b): i for i, b in enumerate(setup.codebooks)}

    block0, block1 = setup.block0_size, setup.block1_size
    # the Vorbis I inverse-dB table travels in the float blob so the
    # spectrum-mode unpack (floor render + multiply fused in C++, consumed
    # by engine/host.py) uses the exact same 256 constants as
    # codec/floor.py — float-bit-identical curves
    from nvorbis_tpu_torch.codec.floor import INVERSE_DB_TABLE

    inv_db_off = len(floats)
    floats.extend(np.asarray(INVERSE_DB_TABLE, dtype=np.float32).tolist())
    ints += [
        _MAGIC, setup.channels, setup.mode_field_bits,
        len(setup.codebooks), len(setup.floors), len(setup.residues),
        len(setup.mappings), len(setup.modes),
        max_posts, block0, block1, block1 // 2, inv_db_off,
    ]

    for b in setup.codebooks:
        has_lookup = 1 if b.lookup is not None else 0
        lookup_off = len(floats)
        if has_lookup:
            floats.extend(np.asarray(b.lookup, dtype=np.float32).ravel().tolist())
        # Both decoders keep the reference's 2^10 prefix table by default
        # (widening to 12 bits LOST its A/B — cache pollution beat the
        # saved overflow scans; NOTES round 3).  The folding below only
        # activates when NVT_NATIVE_TABLE_BITS raises the width: each
        # folded code then replaces a linear overflow-list scan, and
        # LSB-first codes make the widening a pure tile (index low bits
        # select the original entry).
        tb, overflow = b.table_bits, b._overflow
        tv = np.asarray(b._tbl_value[: 1 << tb], dtype=np.int64)
        tl = np.asarray(b._tbl_length[: 1 << tb], dtype=np.int64)
        W = min(b.max_bits, _native_table_bits())
        if W > tb:
            reps = 1 << (W - tb)
            tv = np.tile(tv, reps)
            tl = np.tile(tl, reps)
            remaining = []
            for code, mask, length, value in overflow:
                if length <= W:
                    step = 1 << length
                    tv[code::step] = value
                    tl[code::step] = length
                else:
                    remaining.append((code, mask, length, value))
            tb, overflow = W, remaining
        ints += [
            b.dimensions, b.entries, tb, b.max_bits,
            len(overflow), has_lookup, lookup_off,
        ]
        ints.extend(tv.tolist())
        ints.extend(tl.tolist())
        for code, mask, length, value in overflow:
            ints += [code, mask, length, value]

    for f in setup.floors:
        if not isinstance(f, Floor1):
            # Floor0 (LSP): ship the precomputed bark/w maps so the C++
            # curve evaluation is float-identical to codec/floor.py's
            # (spec-mode-only: Floor0 has no ys-posts form — see
            # NativeUnpacker.spec_only)
            ints += [0, f.order, f.amp_bits, f.amp_ofs, f.book_bits,
                     len(f.books)]
            ints.extend(book_index[id(b)] for b in f.books)
            for bs in (block0, block1):
                bark = np.asarray(f._bark_maps[bs], dtype=np.int64)
                assert bark.shape[0] == bs // 2 + 1
                ints.extend(bark.astype(np.int32).tolist())
            for bs in (block0, block1):
                w = np.asarray(f._w_maps[bs], dtype=np.float32)
                assert w.shape[0] == bs // 2
                ints.append(len(floats))
                floats.extend(w.tolist())
            continue
        max_class = len(f.class_dims)
        ints += [1, len(f.partition_class), max_class, f.post_count,
                 f.y_bits, f.range, f.multiplier]
        ints.extend(f.partition_class)
        ints.extend(f.class_dims)
        ints.extend(f.class_subclasses)
        ints.extend(
            book_index[id(b)] if b is not None else -1 for b in f.masterbooks
        )
        for books in f.subclass_books:
            row = [book_index[id(b)] if b is not None else -1 for b in books]
            row += [-1] * (8 - len(row))
            ints.extend(row)
        ints.extend(f.x_list)
        ints.extend(f.l_neigh)
        ints.extend(f.h_neigh)
        ints.extend(f.sort_idx)

    for r in setup.residues:
        partvals, cb_dims = r.decode_map.shape
        ints += [
            r.residue_type, r.begin, r.end, r.partition_size,
            r.classifications, book_index[id(r.classbook)], r.max_stages,
            partvals, cb_dims,
        ]
        ints.extend(r.cascade)
        for row in r.books:
            srow = [book_index[id(b)] if b is not None else -1 for b in row]
            srow += [-1] * (r.max_stages - len(srow))
            ints.extend(srow)
        ints.extend(r.decode_map.ravel().tolist())

    for m in setup.mappings:
        ints += [m.submap_count, len(m.coupling_mag)]
        ints.extend(m.coupling_mag)
        ints.extend(m.coupling_ang)
        ints.extend(m.mux)
        ints.extend(m.submap_floor)
        ints.extend(m.submap_residue)

    for md in setup.modes:
        ints += [1 if md.block_flag else 0, md.block_size, md.mapping_idx]

    return (
        np.asarray(ints, dtype=np.int32),
        np.asarray(floats, dtype=np.float32),
    )


class NativeUnpacker:
    """Per-stream native unpack context.

    ``unpack(packet_bytes_list)`` returns dense window tensors:
    residue ``[B, C, n2max]`` f32, ys ``[B, C, P]`` i32, used/has_floor u8,
    meta ``[B, 8]`` i32 (status, mode_idx, window_index, bits_read,
    total_bits, 0, 0, 0).
    """

    def __init__(self, setup, max_posts):
        self._handle = None
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        blobs = serialize_setup(setup, max_posts)
        if blobs is None:
            raise RuntimeError("setup not supported natively")
        bi, bf = blobs
        self._blob_i = bi  # keep alive
        self._blob_f = bf
        handle = lib.nvt_setup_create(
            bi.ctypes.data, bi.size, bf.ctypes.data, bf.size
        )
        if not handle:
            raise RuntimeError("native setup rejected")
        self._lib = lib
        self._handle = handle
        self.channels = setup.channels
        self.max_posts = max_posts
        self.n2max = setup.block1_size // 2
        # Floor0 setups have no ys-posts (dense/symbol) form: only the
        # spectrum-mode entry points are valid (the C++ twins guard too)
        self.spec_only = any(not isinstance(f, Floor1) for f in setup.floors)

        # residue symbol mode (see synth/residue_sym.py): available when the
        # setup's residues admit partition-local symbol addressing
        from nvorbis_tpu_torch.synth.residue_sym import plan_for_setup, sym_geometry

        self.sym_plans = None if self.spec_only else plan_for_setup(setup)
        if self.sym_plans is not None:
            self._sym_geom = sym_geometry(setup, self.sym_plans)

    def __del__(self):
        if self._handle:
            try:
                self._lib.nvt_setup_destroy(self._handle)
            except Exception:
                pass
            self._handle = None

    def unpack(self, packets, n_threads=0):
        B = len(packets)
        offsets = np.zeros(B + 1, dtype=np.int64)
        for i, pk in enumerate(packets):
            offsets[i + 1] = offsets[i] + len(pk)
        data = b"".join(packets)
        buf = np.frombuffer(data, dtype=np.uint8)
        return self.unpack_view(buf, offsets, n_threads)

    def unpack_view(self, buf, offsets, n_threads=0):
        """Zero-copy variant of :meth:`unpack` (see unpack_sym_view)."""
        B = len(offsets) - 1
        C, P, n2 = self.channels, self.max_posts, self.n2max

        residue = np.zeros((B, C, n2), dtype=np.float32)
        ys = np.zeros((B, C, P), dtype=np.int32)
        used = np.zeros((B, C, P), dtype=np.uint8)
        has_floor = np.zeros((B, C), dtype=np.uint8)
        meta = np.zeros((B, 8), dtype=np.int32)

        self._lib.nvt_unpack_window(
            self._handle,
            buf.ctypes.data,
            offsets.ctypes.data,
            B,
            residue.ctypes.data,
            ys.ctypes.data,
            used.ctypes.data,
            has_floor.ctypes.data,
            meta.ctypes.data,
            n_threads,
        )
        return residue, ys, used, has_floor, meta

    @property
    def has_spec(self) -> bool:
        """True when the spectrum-mode unpack is available for this setup."""
        return bool(self._lib.nvt_has_spec(self._handle))

    def unpack_spec(self, packets, n_threads=0):
        """Spectrum-mode unpack: ready-to-IMDCT rows (engine/host.py).

        Returns (spec ``[B, C, n2max]`` f32, meta ``[B, 8]`` i32): residue
        decode, inverse coupling and the floor curve multiply all run in
        C++ (NVorbis/Mapping.DecodePacket:95-198 minus the transform).
        """
        B = len(packets)
        offsets = np.zeros(B + 1, dtype=np.int64)
        for i, pk in enumerate(packets):
            offsets[i + 1] = offsets[i] + len(pk)
        data = b"".join(packets)
        buf = np.frombuffer(data, dtype=np.uint8)
        return self.unpack_spec_view(buf, offsets, n_threads)

    def unpack_spec_view(self, buf, offsets, n_threads=0):
        """Zero-copy variant of :meth:`unpack_spec` (see unpack_sym_view).

        np.empty is safe: the C++ side memsets every row a consumer may
        read ([0, n2) of audio frames; non-audio rows are never gathered).
        """
        B = len(offsets) - 1
        C, n2 = self.channels, self.n2max
        spec = np.empty((B, C, n2), dtype=np.float32)
        meta = np.empty((B, 8), dtype=np.int32)
        self._lib.nvt_unpack_window_spec(
            self._handle,
            buf.ctypes.data,
            offsets.ctypes.data,
            B,
            spec.ctypes.data,
            meta.ctypes.data,
            n_threads,
        )
        return spec, meta

    def unpack_spec_sv(self, buf, starts, ends, n_threads=0):
        """Spectrum unpack over permuted per-packet spans (int64 arrays):
        packet ``k`` is ``buf[starts[k]:ends[k]]`` and writes spec/meta row
        ``k`` — the host engine passes a mode-sorted permutation so each
        synthesis bucket is a contiguous row range (engine/host.py)."""
        B = len(starts)
        C, n2 = self.channels, self.n2max
        spec = np.empty((B, C, n2), dtype=np.float32)
        meta = np.empty((B, 8), dtype=np.int32)
        self._lib.nvt_unpack_window_spec_sv(
            self._handle,
            buf.ctypes.data,
            starts.ctypes.data,
            ends.ctypes.data,
            B,
            spec.ctypes.data,
            meta.ctypes.data,
            n_threads,
        )
        return spec, meta

    def unpack_spec_ptr(self, buf, starts, ends, out_ptrs, strides,
                        n_threads=0):
        """Spectrum unpack into PER-PACKET buffers with tight row strides.

        ``out_ptrs[k]`` (int64) is the float* of packet k's ``[C,
        strides[k]]`` block — the host engine points each mode-sorted
        packet into its bucket's tight buffer, so the short-block bucket
        feeds the DCT with no reshape copy.  The caller owns keeping the
        target buffers alive and correctly sized (stride must be >= the
        packet's n2; the mode is implied by the first-byte peek that
        built the buckets, and a packet that decodes to a different/bad
        mode writes nothing and returns ok=0 in its meta row)."""
        B = len(starts)
        meta = np.empty((B, 8), dtype=np.int32)
        self._lib.nvt_unpack_window_spec_ptr(
            self._handle,
            buf.ctypes.data,
            starts.ctypes.data,
            ends.ctypes.data,
            B,
            out_ptrs.ctypes.data,
            strides.ctypes.data,
            meta.ctypes.data,
            n_threads,
        )
        return meta

    def unpack_sym(self, packets, n_threads=0):
        """Symbol-mode unpack: residues as classes + canonical entry ids.

        Returns (classes [B, CHR, n_part_max] u8, ids [B, max_ids] i16,
        ys, used, has_floor, meta) with meta[:, 5] = per-frame id count.
        Requires ``sym_plans`` (caller checks).
        """
        B = len(packets)
        offsets = np.zeros(B + 1, dtype=np.int64)
        for i, pk in enumerate(packets):
            offsets[i + 1] = offsets[i] + len(pk)
        data = b"".join(packets)
        buf = np.frombuffer(data, dtype=np.uint8)
        return self.unpack_sym_view(buf, offsets, n_threads)

    def unpack_sym_view(self, buf, offsets, n_threads=0):
        """Zero-copy variant of :meth:`unpack_sym`: ``buf`` is a uint8 array
        holding the packets back to back and ``offsets`` their [B+1]
        boundaries (offsets[0] == 0) — exactly the layout
        :func:`packetize` returns, so the table fast path skips re-joining
        packet bytes."""
        B = len(offsets) - 1
        C, P = self.channels, self.max_posts
        n_part_max, chr_max, max_ids = self._sym_geom

        # np.empty, not zeros: the C++ side initializes everything a
        # consumer may read (classes/meta are memset per row; ys/used/
        # has_floor are written for every audio frame; ids beyond each
        # row's meta[:,5] count are undefined by contract and rows of
        # non-audio packets are never gathered).  Zeroing here memset
        # ~15-20 MB per 4096-packet window for nothing.
        classes = np.empty((B, chr_max, n_part_max), dtype=np.uint8)
        ids = np.empty((B, max_ids), dtype=np.int16)
        ys = np.empty((B, C, P), dtype=np.int32)
        used = np.empty((B, C, P), dtype=np.uint8)
        has_floor = np.empty((B, C), dtype=np.uint8)
        meta = np.empty((B, 8), dtype=np.int32)

        self._lib.nvt_unpack_window_sym(
            self._handle,
            buf.ctypes.data,
            offsets.ctypes.data,
            B,
            classes.ctypes.data,
            ids.ctypes.data,
            ys.ctypes.data,
            used.ctypes.data,
            has_floor.ctypes.data,
            meta.ctypes.data,
            n_part_max,
            chr_max,
            max_ids,
            n_threads,
        )
        return classes, ids, ys, used, has_floor, meta


_unpacker_cache = {}  # id(setup) -> (setup strong ref, {subkey: unpacker})
_UNPACKER_CACHE_MAX = 16  # matches the header-keyed setup cache bound


def unpacker_for(setup, max_posts):
    """Shared :class:`NativeUnpacker` for a (cached) setup.

    Construction costs ~7 ms (Python setup serialization + C++ parse +
    table packing), which dominated small-file decodes — the setup cache
    (codec/setup.py) already dedupes parsed setups by header bytes, so a
    service decoding many files of the same encoder class reuses one
    unpacker.  Unpackers are stateless per call (thread-local scratch in
    C++; the Setup* is read-only after create), so one instance serves
    concurrent readers.  The subkey carries the env switches sampled at
    create time (table width, A/B gates) so tests flipping them get a
    fresh instance; holding the setup strong ref keeps ``id()`` valid.
    """
    sub_key = (
        max_posts,
        _native_table_bits(),
        os.environ.get("NVT_NO_T2CH2") or "",
        os.environ.get("NVT_FLOOR_DIV") or "",
    )
    key = id(setup)
    hit = _unpacker_cache.get(key)
    if hit is None or hit[0] is not setup:
        if len(_unpacker_cache) >= _UNPACKER_CACHE_MAX:
            _unpacker_cache.pop(next(iter(_unpacker_cache)))
        hit = (setup, {})
        _unpacker_cache[key] = hit
    sub = hit[1]
    nu = sub.get(sub_key)
    if nu is None:
        nu = NativeUnpacker(setup, max_posts)
        sub[sub_key] = nu
    return nu
