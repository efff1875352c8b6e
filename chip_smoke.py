"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. probe: versions, the card, ``nvidia-smi`` name and power limit; TF32 off;
2. build: the four CUDA kernel sources (IMDCT+window; coupling+floor
   render+floor multiply, on a dense residue or on one rebuilt from
   symbols inside it; the standalone residue rebuild; the overlap-add),
   each compiled by nvcc
   from ``nvorbis_tpu_torch/csrc`` for sm_90a, and the port's C++ host
   plane, compiled by g++ from
   ``nvorbis_tpu_torch/native/host_decode.cpp``, all five started
   together in threads; all into ``nvorbis_tpu_torch/_build/``, and the
   host plane must load (its loader falls back to the Python unpack
   without a word, so a broken build would otherwise pass as a slow run);
3. kernel vs its plain torch twin (the basis product) at every block size
   the kernel takes and the decode's row counts, and at the batch path's
   shapes (the group's whole window table, ``BATCH_TABLES``, indexed
   across all its rows, at the bucket row counts) and the mesh phase's
   (``MESH_TABLES``, at shard-sized and bucket row counts), dead rows (window
   index below 0 or past the table) required zero, each held to
   ``|d| <= 1e-4 + 2e-4 * |ref|`` (the tolerance the JAX package holds its
   Pallas kernel to) and, against an fp64 product, to at most
   ``FP64_FACTOR`` times the twin's own error, with both times from CUDA
   events (median of 25) and the kernel's share of the card's memory
   bandwidth (``4 * rows * (n/2 + n)`` bytes over its time, over
   ``HBM_BYTES_PER_S``), and its bound (:func:`kernel_bound`); at the
   summary shape both also as CUDA graph replays over rotated input
   copies (:func:`graph_ms`, the card's time without the wrapper's host
   time; line ``kernel_summary``); then ``synth_spectra`` (the kernel
   with a one-row window table of ones) on the card against its CPU twin
   at ``SPECTRA_NS``, same tolerance; then
   phase ``floor_kernel``: the floor kernel (``ops/floor.py``) against its
   plain twin on the card at every row of ``FLOOR_SHAPES`` (the fleet's
   buckets with tables by table id, also at 32 and 65 posts; one stream's
   tables; the generic form without a bin map, sorted and shuffled; a
   Floor0 channel; no coupling; the last twentieth of the frames padding),
   bit for bit, both times from CUDA events around one call
   (:func:`cuda_ms`, median of 25, the wrapper's host time included) and
   as CUDA graph replays over rotated input copies (:func:`graph_ms`), and
   the bound (:func:`floor_bound`);
4. two whole-stream decodes of seeded synthetic streams through
   ``nvorbis_tpu_torch.VorbisReader(blob, device="cuda").read_all()``,
   held to the port's plain path on the same machine (``device="cpu"``:
   every stage in torch on the host CPU, the kernel's torch twin in place
   of the kernel): equal length, equal to the stream's own final granule,
   equal ``has_clipped``, ``max|d| <= 5e-6 * max(1, max|ref|)``, finite
   samples, the symbol lane, and kernel launches counted on that run; a
   second card decode of each, bit-equal to the first; the chunk programs
   of both passes recorded (:func:`program_runs`) and every chunk that ran
   from a CUDA graph held bit-equal to the eager program on its own inputs
   (:func:`check_programs`, a ``programs`` line: distinct programs, chunks
   eager / captured / replayed, each capture's ms and device memory);
   x-realtime of both paths from the median of 5 alternating decodes each;
5. batch: 64 sources (``FLEET``: 48 stereo 44.1 kHz streams of 2048
   packets from 8 seeds, 16 5.1 48 kHz streams of 1024 packets from 4
   seeds; two co-batched groups, about 1470 s of audio) through
   ``nvorbis_tpu_torch.BatchDecoder(sources, device="cuda").decode_all()``:
   every route ``"device"``, kernel launches counted on that run, each
   stream's length equal to its final granule (plus ``FLEET_SURPLUS``)
   and within
   ``5e-6 * max(1, max|ref|)`` of its single-stream card ``read_all``, the
   first stream of each setup within that of the plain path
   (``device="cpu"``); its chunk programs, key by key, those the host plan
   gives on the CPU (:func:`planned_programs`), and its ``programs`` line
   as in phase 4; the ``NVT_FETCH_INT16=1`` output within
   ``1/32767 + 5e-6`` of the float32 one, every kernel call of that int16
   decode held to the twin on its own inputs (``twin_checked``, every
   chunk eager), and the same decode through the graphs bit-equal to it
   (``programs`` line ``batch_int16``); every
   chunk of the counted decode finished on the ``nvt-fetch`` worker
   (:func:`finish_threads`; phase ``fetch_worker``, with its wall).
   Aggregate x-realtime (median of
   3, alternating in one process) of the card ``BatchDecoder``, of
   ``BatchDecoder(engine="host")`` (the reference's host engine, reached
   through the port) and of the 64 single-stream card ``read_all`` calls
   one after another; the card's busy share from one ``torch.profiler``
   trace of a card decode (``chiprun_out/batch_trace.json``) and device
   time by stage (``trace_split``) from one trace of an eager replay of the
   counted decode's recorded chunk programs
   (``chiprun_out/batch_stage_trace.json``: a graph's kernels carry no
   ``nvt.*`` span); then phase ``dense``: the fleet once more under
   ``NVT_NO_SYMBOLS=1`` (the dense lane: spectra rebuilt on the host, the
   floor kernel's dense form), counted as the path ``dense``, every
   stream within ``5e-6 * max(1, max|ref|)`` of the symbol decode;
6. streaming: ``read_samples`` of the first decode stream in 1 s pieces on
   the card (``TorchPipeline``, device windows and kernel launches
   counted on that run), held to the plain path's ``read_all`` of phase 4
   as is; two more such passes, bit-equal to the first; the window
   programs of all three recorded, each pass's keys those the host plan
   of the read gives on the CPU (:func:`planned_stream_programs`), and a
   ``programs`` line as in phase 4 with graphs captured and replayed;
   then granule-exact seeks to ``SEEK_TARGETS`` with
   ``AFTER_SEEK`` samples read after each, held to the plain path's seeks,
   and those to the plain path's ``read_all`` at the target plus
   ``SEEK_READ_ALL_OFFSET`` (the seek lands on granule positions, which
   can sit off ``read_all``'s count: at 2,500,000 the reference's host
   engine, and the port, land 448 samples past it;
   tests/test_torch_chip_smoke.py::test_seeks_on_full_stream_match_host_engine
   holds both to that on the CPU); x-realtime (median of 3 passes) and
   seeks per second;
7. mesh: ``BatchDecoder(sources, mesh=build_mesh(...))`` over the first
   ``MESH_SOURCES`` of the batch fleet at stream extents ``MESH_EXTENTS``,
   the mesh's devices the visible cards in turn (``cuda:0`` repeated on a
   one-card machine): the mesh-free card decode of the same sources within
   ``5e-6 * max(1, max|ref|)`` of the batch phase's checked decode; one
   decode per extent with every kernel call held to the twin on the
   shard's own inputs (``twin_checked``, each call seen); then, counted,
   every route ``"device"``, every stream bit-equal to the mesh-free
   decode, every shard launched the kernel (launches per shard counted on
   that run), every chunk finished on the ``nvt-fetch`` worker; a second
   decode per extent over a new mesh of the same cards, with the first's
   program keys, launches per shard and PCM; the shard and the output
   programs of both recorded, a ``programs`` line of each kind per extent
   with graphs captured and replayed; x-realtime (both sides replaying
   graphs) with and
   without the mesh (median of ``MESH_REPEATS``, alternating);
8. sharded: ``make_sharded_synth`` on every grid of ``SHARDED_GRIDS`` on
   the cards at ``SHARDED_SHAPE``, called three times: the program runs of
   each call, per kind (``sharded_floor`` per shard, ``sharded_part`` per
   grid cell, ``sharded_out`` per shard), eager, then captured, then
   replayed; the captured and replayed calls bit-equal to the eager one,
   which lies within ``SHARDED_TOL`` of the same grid on the CPU; a new
   ``Mesh`` of the same cards replays every key, on inputs of another seed
   within ``SHARDED_TOL`` of the CPU; no IMDCT kernel launched; per grid
   and kind each graph's capture ms and MiB, and the median synchronised
   wall of an eager call (a cache that never captures) against a replayed
   one over ``SHARDED_REPS`` alternating calls;
9. cli: ``nvorbis_tpu_torch.__main__.main([in, out, "--device", "cuda"])``
   on both decode streams, plain and ``--forward-only`` (launches counted
   on those runs), each WAV read back with ``read_wav``: the stream's rate
   and channels, equal length, within ``5e-6 * max(1, max|ref|)`` of phase
   4's plain path, and a ``programs`` line; one ``python -m
   nvorbis_tpu_torch`` subprocess, exit 0, its WAV byte-equal to the
   in-process one;
10. containers: a chained file (stereo, 5.1, stereo: the decode streams at
   full length, serials ``CHAIN_SERIALS``) and a multiplexed one (the first
   two interleaved) through ``VorbisReader(path, device="cuda")``: every
   link found by ``find_next_stream``, ``switch_streams`` True on each
   change of parameters, each link's ``read_all`` launching the kernel
   (counted) and within the same bound of its plain output, a ``programs``
   line; one link's decode again under ``twin_checked``;
11. auto: the sweep (:func:`sweep`) of ``read_all`` on the card against the
   host engine at ``SWEEP_SECONDS`` and full length per shape, the default
   of ``NVT_DEVICE_MIN_SECS`` it gives (:func:`sweep_default`), and
   ``stream_decoder.DEVICE_MIN_SECS`` required between its verdicts at
   ``SWEEP_SHARE`` -/+ ``SWEEP_SLACK`` (:func:`default_in_band`); then
   ``engine="auto"`` on a stream below the default (no launch, bit-equal
   to ``engine="host"``), on the stereo stream above it (launches counted,
   bit-equal to ``engine="torch"``, a ``programs`` line) and on that under
   ``NVT_ENGINE=host`` (no launch);
12. device_synth: the batch phase's fleet decoded once with
   ``BatchDecoder``'s capture hook armed and no fetch
   (``tools/device_synth_torch.py``), then every captured chunk replayed
   through ``batch_program``: one eager pass counted (kernel launches),
   one with every kernel call held to the twin (``twin_checked``), each
   bit-equal to the output its capture kept; then the tool's report at
   ``SYNTH_REPS`` reps: the replay eager and as a CUDA graph
   (``device_synth_eager_x``, ``device_synth_graph_x``), held bit-equal
   again, the stage matrix and the per-chunk lines; then phase
   ``residue_kernel``: the residue kernel (``ops/residue.py``) against its
   plain twin on the card, bit for bit, at the capture's symbol buckets
   (stereo and 5.1, n2 1024 and 128; the stereo long one again with
   undecoded partitions and missing ids injected), at residue types 0 and
   1 from testgen streams (``RESIDUE_TYPED``) and at plans of libvorbis's
   geometry (``RESIDUE_GEOMETRIES``: partitions of 32, 10 classes, 8
   stages, dims 2/4/8; a prefix longer than the kernel's shared-memory
   tile; no partitions), with both times around one call and as graph
   replays and the bound (:func:`residue_bound`); and phase
   ``ola_kernel``: the overlap-add kernel (``ops/ola.py``) likewise at the
   capture's longest stereo and 5.1 chunks (rows from ``bucket_rows``) and
   at random tables with a padding tail and the last secondary past ``L``
   at ``OLA_CHANNELS`` (:func:`ola_bound`); and phase
   ``floor_sym_kernel``: the floor kernel's symbol form
   (``ops/floor.py::floored_spectrum_sym``) against its composed twin
   (the residue twin, then the floor twin), bit for bit, at every symbol
   bucket of the capture (with its own posts and tables; the stereo long
   one again with undecoded partitions and missing ids) and at the
   ``RESIDUE_GEOMETRIES`` plans with seeded posts (``FLOOR_SYM_POSTS``
   posts, ``FLOOR_SYM_TABLES`` table rows), with both times, the bound
   (:func:`floor_sym_bound`) and beside it the pair it replaces (the
   residue kernel, then the floor kernel's dense form) as one CUDA graph
   over the same rotated inputs;
13. recon_gathers: ``tools/ab_recon_gathers_torch.py`` on the first
   ``RECON_SOURCES`` sources of the fleet: the first symbol-mode chunk of a
   capture decode, its variants ``full``, ``narrow``, ``wide`` (the twin's
   op chain) and ``kernel`` (the hand kernel) bit-equal to the twin, and
   each variant's ms per iteration (a CUDA graph replayed K = 2, 12, 42
   times, the least marginal rate);
14. bench: ``bench_torch.py`` in a subprocess at a reduced size
   (``BENCH_ENV``) within ``BENCH_TIMEOUT`` seconds: exit 0, and its stdout
   exactly one JSON line, the headline, with ``backend`` ``"cuda"``.

At the end neither jax nor ``nvorbis_tpu`` may be in ``sys.modules``.

The script imports neither jax nor the JAX package ``nvorbis_tpu``: its
streams come from the port's testgen (``vorbis_stream``, byte for byte the
streams of ``nvorbis_tpu.testgen``'s ``make_simple_spec(...).build_stream``)
and it builds its own IMDCT basis.  The CPU tests
(tests/test_torch_chip_smoke.py) prove the streams identical and hold the
plain path to the JAX package's decode.

Kernel launches are counted where they run: a chunk replayed from a CUDA
graph adds the launches its capture recorded (``engine/programs.py``).
Every kernel is counted on every path; ``twin_checked`` holds every call
of the floor kernel (either form) and of the overlap-add of its decodes
to its twin bit for bit beside the IMDCT calls.  The line before the last
is the kernel summary as JSON, an entry per kernel (its launches are
those of the counted runs, with the paths that launched it; the floor
kernel's symbol form must have launched on every decode path, its dense
form on the sharded step and the dense decode and nowhere else, the
standalone residue rebuild on no path, the overlap-add on every decode
path but streaming, whose windows lap on the host (``MUST_LAUNCH``);
``ms`` and ``plain_ms`` are
CUDA-event medians around one call, the wrapper's host time included,
``graph_ms`` and ``plain_graph_ms`` the card's time per call in a CUDA
graph over rotated input copies); the last line is ``{"ok": true,
"device": {...}}``.
Without a usable CUDA card the script exits with code 2 before any
phase.
"""

import contextlib
import hashlib
import json
import os
import statistics
import struct
import sys
import tempfile
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPS = 25
GRAPH_CALLS = 10  # calls per graph replay of graph_ms
L2_BYTES = 50 * 2**20  # H100 SXM L2 cache, NVIDIA's data sheet
REPEATS = 5  # timed decodes per path and stream
KERNEL_NS = tuple(1 << b for b in range(6, 14))  # every n the kernel takes
KERNEL_ROWS = (16, 130)
# the long-block row counts, timed at these n
LARGE_NS = (64, 256, 2048, 8192)
LARGE_ROWS = (8192, 2048 * 6)
# an fp32 FFT and cuBLAS's fp32 sums land within a few times of each other
# against fp64; a TF32 or bf16 product is hundreds of times worse
FP64_FACTOR = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores, ditto
# the kernel line's times: a long-block 5.1 chunk (n=2048, rows=2048*6)
SUMMARY_SHAPE = (2048, 2048 * 6)
# the batch path hands the kernel its group's whole window table, [T*W, n]
# rows with T = streams x 2 modes and W the windows of a mode of size n (4
# long, 1 short), indexed by tid*W + widx: the fleet's stereo group (48
# streams) and 5.1 group (16), per block size
BATCH_TABLES = {256: (96, 32), 2048: (384, 128)}
# the same for the mesh phase's sources (MESH_SOURCES: 12 stereo, 4 5.1)
MESH_TABLES = {256: (24, 8), 2048: (96, 32)}
BLOCKS = (256, 2048)
STREAMS = (
    # name, vorbis_stream kwargs, packets, seed
    ("stereo44k_r2", dict(channels=2, sample_rate=44100,
                          couplings=[(0, 1)]), 8192, 101),
    ("surround51_48k_r2", dict(channels=6, sample_rate=48000,
                               couplings=[(0, 1), (2, 3), (4, 5)]), 4096, 102),
)
FLEET = (
    # name, vorbis_stream kwargs, packets, seeds, copies of each seed
    ("stereo44k", dict(channels=2, sample_rate=44100, couplings=[(0, 1)]),
     2048, tuple(range(201, 209)), 6),
    ("surround51_48k", dict(channels=6, sample_rate=48000,
                            couplings=[(0, 1), (2, 3), (4, 5)]),
     1024, (211, 212, 213, 214), 4),
)
# samples per channel by which a fleet stream's decode exceeds its final
# granule, by seed: the reference's end trim leaves a long-block transition
# surplus of (block1 - block0) / 4 on these (NVorbis's block-transition
# accounting, tests/test_golden_libvorbis.py::test_start_trim_quirk); every
# engine of the reference and the port decode these lengths
# (tests/test_torch_chip_smoke.py checks them against the reference)
FLEET_SURPLUS = {205: 448, 207: 448, 214: 448}
BATCH_REPEATS = 3  # timed decodes per path, alternating
I16_TOL = 1.0 / 32767 + 5e-6
SEEK_TARGETS = (1234, 1_000_000, 2_500_000, 4_100_000)  # samples
AFTER_SEEK = 4096
# samples per channel by which a seek target's read lies past read_all's
# sample of the same number (granule positions vs decoded count)
SEEK_READ_ALL_OFFSET = {2_500_000: 448}
SEEK_ROUNDS = 5
# the mesh phase: the first sources of each fleet setup (16 of the 64)
MESH_SOURCES = {"stereo44k": 12, "surround51_48k": 4}
# mesh 'stream' extents; 3 leaves most bucket sizes of the 16-quantum
# grid (16, 20, 32, 2048, ...) to be padded up to a multiple
MESH_EXTENTS = (1, 2, 3)
MESH_REPEATS = 3
# make_sharded_synth: (stream, freq) grids, and (frames, channels, n, posts)
SHARDED_GRIDS = ((1, 1), (2, 1), (1, 2), (2, 2), (3, 1))
SHARDED_SHAPE = (48, 2, 2048, 8)
SHARDED_TOL = 2e-6  # the JAX package's bound for its jax path
SHARDED_REPS = 9  # timed calls per form (eager, replayed), alternating
RECON_SOURCES = 4  # fleet sources of the recon_gathers phase's capture
TRACE_OUT = os.path.join("chiprun_out", "batch_trace.json")
STAGE_TRACE_OUT = os.path.join("chiprun_out", "batch_stage_trace.json")
# synth_spectra on the card against its CPU twin at these block sizes, over
# (frames, channels, posts)
SPECTRA_NS = (256, 2048)
SPECTRA_SHAPE = (48, 2, 8)
# the floor_kernel phase: (form, n2, channels, frames, table rows T, posts
# P) of every floor kernel check, P None for the fleet streams' post count.
# "table": the fleet's buckets (frames as LARGE_ROWS over the channels; T =
# streams x 2 modes, as BATCH_TABLES) with each frame's table id, and the
# stereo long-block bucket again at the post counts of real encoders'
# floors (tens of posts, 65 at most); "stream": one stream's tables
# (read_all, streaming); "generic": per-frame posts without a bin map (the
# sharded step at SHARDED_SHAPE); "shuffled": the same with each row's
# posts shuffled, pads among them; "f0": one stream's tables with a Floor0
# channel.  Coupling: the fleet's steps for the channel count, and none on
# the row marked so
FLOOR_SHAPES = (
    ("table", 128, 2, 4096, 96, None), ("table", 1024, 2, 4096, 96, None),
    ("table", 128, 6, 2048, 32, None), ("table", 1024, 6, 2048, 32, None),
    ("table", 1024, 2, 4096, 96, 32), ("table", 1024, 2, 4096, 96, 65),
    ("table_uncoupled", 1024, 2, 4096, 96, None),
    ("stream", 1024, 2, 4096, 1, None), ("stream", 128, 6, 2048, 1, None),
    ("generic", SHARDED_SHAPE[2] // 2, SHARDED_SHAPE[1], SHARDED_SHAPE[0],
     SHARDED_SHAPE[0], SHARDED_SHAPE[3]),
    ("shuffled", SHARDED_SHAPE[2] // 2, SHARDED_SHAPE[1], SHARDED_SHAPE[0],
     SHARDED_SHAPE[0], SHARDED_SHAPE[3]),
    ("f0", 1024, 2, 512, 1, None),
)
# the kernel line's times: the fleet's stereo long-block bucket
FLOOR_SUMMARY = ("table", 1024, 2, 4096, 96, None)
FLOOR_COUPLING = {1: (), 2: ((0, 1),), 5: ((0, 1), (2, 3)),
                  6: ((0, 1), (2, 3), (4, 5))}
# the residue_kernel phase: the fleet's symbol buckets (the first with the
# most frames of each channel count and block size, as the device_synth
# phase's capture records them), the stereo long one again with undecoded
# partitions and missing ids injected; residue types 0 and 1 from testgen
# streams (tests/test_torch_residue_sym.py's SPECS at BLOCKS), each a
# capture of RESIDUE_STREAMS copies of RESIDUE_PACKETS packets; and plans
# at libvorbis's geometry (RESIDUE_GEOMETRY's classes, stages and entries;
# a SimpleNamespace residue, since the testgen plans have psize = coded/8):
# (form, residue type, channels, block size, frames, psize, dims, begin,
# end), "long_prefix" with more (channel, partition) pairs than the
# kernel's shared-memory tile, "no_partitions" with its coded range past
# the spectrum
RESIDUE_TYPED = (
    ("type0_mono", dict(channels=1, sample_rate=44100, couplings=[],
                        residue_type=0), 301),
    ("type1_stereo", dict(channels=2, sample_rate=44100,
                          couplings=[(0, 1)], residue_type=1), 302),
)
RESIDUE_STREAMS, RESIDUE_PACKETS = 4, 2048
RESIDUE_GEOMETRY = dict(n_cls=10, stages=8, entries=64)
RESIDUE_GEOMETRIES = (
    ("libvorbis", 2, 2, 2048, 4096, 32, (2, 4, 8), 0, 1 << 20),
    ("libvorbis", 1, 2, 2048, 4096, 32, (2, 4, 8), 0, 1 << 20),
    ("libvorbis", 0, 6, 2048, 2048, 32, (2, 4, 8), 0, 1 << 20),
    ("long_prefix", 1, 5, 8192, 512, 16, (2, 4, 8, 16), 0, 1 << 20),
    ("long_prefix", 2, 5, 8192, 512, 16, (2, 4, 8, 16), 0, 1 << 20),
    ("no_partitions", 2, 2, 2048, 4096, 32, (2, 4, 8), 1 << 20, 1 << 20),
)
# the kernels line's residue numbers: the fleet's stereo long bucket
RESIDUE_SUMMARY = ("fleet", 2, 1024)
# the floor_sym_kernel phase's posts and table rows at RESIDUE_GEOMETRIES
# (a real encoder's floor has tens of posts); its kernels line numbers:
# the fleet's stereo long symbol bucket
FLOOR_SYM_POSTS, FLOOR_SYM_TABLES = 32, 32
FLOOR_SYM_SUMMARY = ("fleet", 2, 1024)
# the ola_kernel phase: the fleet's recorded chunk tables (the longest
# chunk of each channel count), and random tables (OLA_RANDOM_L samples,
# a segment every OLA_SEG samples on average, a padding tail, the last
# secondary past L) at each of OLA_CHANNELS
OLA_RANDOM_L = 1 << 21
OLA_SEG = 512
OLA_CHANNELS = (1, 2, 6, 8)
# the kernels line's overlap-add numbers: the fleet's stereo chunk
OLA_SUMMARY = ("fleet", 2)
# the containers phase: the serials of the chained links (stereo, 5.1,
# stereo); the multiplexed file interleaves the first two
CHAIN_SERIALS = (0x4C4E4B31, 0x4C4E4B32, 0x4C4E4B33)
# the auto phase's sweep: each decode stream's shape at these lengths (s)
# and at its own full length, card against host engine, median of
# SWEEP_REPEATS alternating decodes; NVT_DEVICE_MIN_SECS's default is the
# shortest length from which the card's x-realtime is at least SWEEP_SHARE
# of the host engine's on both shapes, else the JAX package's.  From 30 s
# up the two engines are level within the spread between sweeps (a ratio
# of 0.69-1.42 over eighteen sweeps on five H100 machines), so the verdict
# at SWEEP_SHARE alone moves between 30 s, the 5.1 stream's 49.84 s and no
# length from run to run: the code's default must match the verdict at
# some share within SWEEP_SLACK of SWEEP_SHARE
SWEEP_SECONDS = (1, 3, 10, 30)
SWEEP_REPEATS = 25
SWEEP_SHARE = 0.9
SWEEP_SLACK = 0.2
JAX_DEVICE_MIN_SECS = 3.0
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
# the device_synth phase: timed reps of the replay, passes per rep
SYNTH_REPS = 3
SYNTH_PASSES = 1
# the bench phase: bench_torch.py's headline and host ceiling on two
# copies of the 105.58 s stereo stream
BENCH_ENV = {"NVT_BENCH_CONFIGS": "longform_batch,host_ceiling",
             "NVT_BENCH_REPEATS": "1", "NVT_BENCH_STREAMS": "2"}
BENCH_TIMEOUT = 300


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# -- seeded test streams ------------------------------------------------------


def vorbis_stream(seed, packets, channels, sample_rate, couplings,
                  serial=0x74657374, residue_type=2):
    """A seeded Ogg Vorbis stream of ``packets`` audio packets, written by
    the port's testgen (``make_simple_spec`` with residue ``residue_type``
    and blocks ``BLOCKS``): floor 1, one mapping with the given couplings,
    a short and a long mode.  Returns ``(blob, samples per channel)``, the
    sample count being the final granule."""
    from nvorbis_tpu_torch.testgen.ogg_writer import split_pages
    from nvorbis_tpu_torch.testgen.vorbis_writer import make_simple_spec

    blob = make_simple_spec(
        channels=channels, sample_rate=sample_rate, couplings=couplings,
        residue_type=residue_type, block0=BLOCKS[0], block1=BLOCKS[1],
    ).build_stream(np.random.default_rng(seed), packets, serial=serial)
    return blob, struct.unpack_from("<q", split_pages(blob)[-1], 6)[0]


def fleet_sources(packets=None):
    """The batch phase's sources: ``(setup name, seed, blob, samples per
    channel, sample rate, channels)`` per source, the copies of one seed
    the same bytes object.  ``packets`` overrides every setup's packet
    count (the CPU tests)."""
    out = []
    for name, kw, n, seeds, copies in FLEET:
        for seed in seeds:
            blob, samples = vorbis_stream(seed, packets or n, **kw)
            out += [(name, seed, blob, samples, kw["sample_rate"],
                     kw["channels"])] * copies
    return out


@contextlib.contextmanager
def planning(keys):
    """While active, every program run through ``engine/programs.py``
    appends its key ``(kind, cfg, signature)`` to ``keys`` and returns
    zeros of its output's shape instead of running: the cfg and the
    arguments' shapes depend on the host plan only, so a decode on the CPU
    gives the keys a card sees.  A synth kind's last argument, the IMDCT
    basis, which only a CPU synth holds, is keyed as None, as a card passes
    it."""
    from nvorbis_tpu_torch.engine import programs

    def planned(kind, program, cfg, flat, device, rows):
        if kind.startswith("synth"):
            # [b, C, n]: C is the cfg's last entry, n the window table's
            n = flat[8 if kind == "synth_sym" else 7].shape[-1]
            keys.append((kind, cfg, programs.signature([*flat[:-1], None])))
            return torch.zeros((rows, cfg[2], n)), "eager"
        keys.append((kind, cfg, programs.signature(flat)))
        i16 = cfg[5] if kind == "batch" else cfg[4]
        return torch.zeros((rows, cfg[0]), dtype=torch.int16 if i16
                           else torch.float32), "eager"

    run = programs.run
    programs.run = planned
    try:
        yield keys
    finally:
        programs.run = run


def planned_programs(blobs):
    """The program key ``(kind, cfg, signature)`` of every chunk of a
    ``BatchDecoder`` decode of ``blobs``, from the host plan alone
    (:func:`planning`)."""
    import nvorbis_tpu_torch as nvt

    with planning([]) as keys:
        nvt.BatchDecoder(blobs, device="cpu").decode_all()
    return keys


def sequential(reader, ch, sr):
    """``reader``'s samples from its position to the end, read in pieces
    of 1 s (the streaming phase's reads)."""
    buf = np.zeros(sr * ch, np.float32)
    parts = []
    while True:
        n = reader.read_samples(buf)
        if not n:
            return np.concatenate(parts)
        parts.append(buf[:n].copy())


def planned_stream_programs(blob, ch, sr):
    """The program key ``(kind, cfg, signature)`` of every window bucket of
    a sequential read of ``blob`` (:func:`sequential`) through
    ``TorchPipeline``, from the host plan alone (:func:`planning`)."""
    import nvorbis_tpu_torch as nvt

    with planning([]) as keys:
        r = nvt.VorbisReader(blob, device="cpu")
        sequential(r, ch, sr)
        r.dispose()
    return keys


def trace_split(events):
    """Device time in a chrome trace of ``torch.profiler`` (its
    ``traceEvents``): ``(busy_us, {stage: us})``.  ``busy_us`` is the union
    of the kernel, memcpy and memset intervals.  Host-device copies count
    under their direction; every other device event under the innermost
    ``nvt.*`` span (``record_function``) around the runtime call that
    launched it, matched by correlation id, or ``other``."""
    launch_at = {}  # correlation id -> (thread, time) of the runtime call
    spans = defaultdict(list)  # thread -> [(start, end, name)]
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver"):
            launch_at[args.get("correlation")] = (e.get("tid"), e["ts"])
        elif cat == "user_annotation" and e["name"].startswith("nvt."):
            spans[e.get("tid")].append((e["ts"], e["ts"] + e["dur"],
                                        e["name"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(e)
    by_stage = defaultdict(float)
    for e in device:
        name = e.get("name", "")
        if "HtoD" in name or "DtoH" in name:
            stage = "copy " + ("HtoD" if "HtoD" in name else "DtoH")
        else:
            stage = "other"
            hit = launch_at.get((e.get("args") or {}).get("correlation"))
            if hit is not None:
                tid, ts = hit
                inside = [s for s in spans.get(tid, ()) if s[0] <= ts <= s[1]]
                if inside:
                    stage = min(inside, key=lambda s: s[1] - s[0])[2]
        by_stage[stage] += e["dur"]
    busy, end = 0.0, None
    for e in sorted(device, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy, dict(by_stage)


def imdct_basis(n):
    """The [n/2, n] IMDCT matrix of block size n, as the decode uses it."""
    k = np.arange(n // 2, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi / (2 * n) * (2 * i + 1 + n / 2)
                  * (2 * k + 1)).astype(np.float32)


# -- phases -------------------------------------------------------------------

DECODE_PATHS = ("read_all", "batch", "streaming", "mesh", "cli",
                "containers", "auto", "device_synth")
# the paths on which each kernel but the IMDCT (whose launches main()
# counts by path) must launch: the floor kernel's symbol form on every
# decode path (each takes the symbol lane), its dense form on the sharded
# step and the dense decode (``NVT_NO_SYMBOLS=1``), the standalone residue
# rebuild on none (the symbol form rebuilds inside the floor kernel), the
# overlap-add on every decode path but the streaming windows, which lap on
# the host
MUST_LAUNCH = {
    "floor_sym": DECODE_PATHS,
    "floor_couple": ("sharded", "dense"),
    "residue_rebuild": (),
    "overlap_add": tuple(p for p in DECODE_PATHS if p != "streaming")
    + ("dense",),
}
# launches per kernel and path, summed over each path's counted runs
BY_PATH = {name: {} for name in MUST_LAUNCH}


def kernel_modules():
    """The hand kernels' wrapper modules by kernel name, as
    ``engine/programs.py::KERNELS`` holds them."""
    from nvorbis_tpu_torch.engine.programs import KERNELS

    return KERNELS


def zero_launches():
    """Sets every hand kernel's launch count to 0: a counted run starts."""
    for m in kernel_modules().values():
        m.launches = 0


def add_launches(name, path, n):
    """Adds ``n`` launches of kernel ``name`` to ``path``'s count."""
    BY_PATH[name][path] = BY_PATH[name].get(path, 0) + n


def path_launches(path):
    """Adds each kernel's launches since :func:`zero_launches` (the IMDCT
    aside) to ``path``'s counts; fails unless the run launched the floor
    kernel in one of its forms (each run of every path does).  Whether each
    kernel launched on every path that must launch it and on no other,
    ``main`` checks over the paths' sums."""
    mods = kernel_modules()
    check(mods["floor_sym"].launches + mods["floor_couple"].launches > 0,
          f"{path}: a counted run launched the floor kernel no time")
    for name in MUST_LAUNCH:
        add_launches(name, path, mods[name].launches)


def check_path_launches():
    """Fails unless every kernel launched on every path of its
    ``MUST_LAUNCH`` entry, and on no other path but with a count of 0."""
    for name, paths in MUST_LAUNCH.items():
        got = BY_PATH[name]
        check(all(got.get(p, 0) > 0 for p in paths),
              f"{name} launches by path {got}: a path that must launch it "
              "launched it no time")
        check(all(n == 0 for p, n in got.items() if p not in paths),
              f"{name} launches by path {got}: a path that must not launch "
              "it did")


def cuda_ms(fn, reps=REPS):
    """Median milliseconds of ``fn()`` on the current stream, from CUDA
    events around each call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def input_copies(args):
    """Copies of the argument list ``args`` (its tensors cloned, other
    values shared), enough that their tensors' bytes are at least twice
    ``L2_BYTES``, at most ``GRAPH_CALLS``: calls that rotate over them find
    no input in L2 from the call before."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if torch.is_tensor(a))
    n = min(GRAPH_CALLS, max(1, -(-2 * L2_BYTES // max(nbytes, 1))))
    return [list(args)] + [
        [a.clone() if torch.is_tensor(a) else a for a in args]
        for _ in range(n - 1)]


def graph_ms(fn, args, calls=GRAPH_CALLS, reps=REPS):
    """Median device milliseconds of one ``fn(*args)`` call with no host
    work around it: ``calls`` calls captured into one CUDA graph (after a
    warm-up call on the capture's side stream), rotating over
    :func:`input_copies` of ``args`` and each writing its own output, the
    graph replayed between CUDA events ``reps`` times.  :func:`cuda_ms` of
    the same call adds the wrapper's host time before the launch, which
    small shapes show."""
    copies = input_copies(args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*copies[i % len(copies)]) for i in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph, outs, copies
    return statistics.median(times)


def kernel_bound(n, W, widx):
    """``(bound_ms, bound_by)`` of one ``imdct_window`` call: the larger of
    its bytes over ``HBM_BYTES_PER_S`` (the live rows' spectra, the window
    table and the indices read once, every output row written once) and
    its operations over ``FP32_FLOPS_PER_S``: per live row (the kernel
    neither loads nor transforms a dead row) the flops of its algorithm,
    the pre- and the post-twiddle's ``n/4`` complex multiplies (6 flops
    each), the ``n/4``-point complex FFT's ``5 (n/4) log2(n/4)`` and the
    window's ``n`` multiplies."""
    rows = len(widx)
    live = int(((widx >= 0) & (widx < W)).sum())
    nbytes = 4.0 * (live * (n // 2) + W * n + rows + rows * n)
    m = n // 4
    ops = live * (5.0 * m * np.log2(m) + 2 * 6.0 * m + n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_shapes():
    """``(n, W, rows)`` of every kernel check: a mode's four-row window
    table at every n the kernel takes, with the decode's row counts, the
    batch path's whole-group tables (``BATCH_TABLES``) at its bucket row
    counts, and the mesh phase's group tables (``MESH_TABLES``) at the
    shard-sized and the bucket row counts."""
    for n in KERNEL_NS:
        for rows in KERNEL_ROWS + (LARGE_ROWS if n in LARGE_NS else ()):
            yield n, 4, rows
    for n, tables in sorted(BATCH_TABLES.items()):
        for W in tables:
            for rows in LARGE_ROWS:
                yield n, W, rows
    for n, tables in sorted(MESH_TABLES.items()):
        for W in tables:
            for rows in KERNEL_ROWS + LARGE_ROWS:
                yield n, W, rows


@contextlib.contextmanager
def twin_checked(op, log, logs=None):
    """While active, every ``imdct_window`` call of the decode plane (the
    name ``synth/device.py::synth_imdct`` calls) also runs the kernel's
    plain twin on the same inputs, and is held to the kernel phase's
    tolerance with dead rows zero; ``log`` gets ``(device, n, W, rows,
    max|d|)`` per call.  Every ``floored_spectrum`` call (the names
    ``synth/device.py::synth_core`` and ``parallel/sharded.py`` call),
    every ``floored_spectrum_sym`` call (the name
    ``synth/device.py::synth_core_sym`` calls) and every ``overlap_add``
    call (the names ``parallel/batch.py`` and ``engine/bulk.py`` call)
    likewise runs its kernel's twin and is held to it bit for bit; the
    list ``logs[name]`` (each when given, by kernel name: ``floor_couple``,
    ``floor_sym``, ``overlap_add``) gets ``(device, B, C, n2)`` per floor
    call and ``(device, L, C)`` per overlap-add.  The twins do not count
    as launches.  No decode path calls the standalone residue rebuild
    (``MUST_LAUNCH``).  A replayed CUDA graph calls no wrapper, so
    meanwhile the chunk programs run through a cache that never captures:
    every chunk eager, each kernel call seen (the graph replays are held
    bit-equal to the eager program apart, :func:`check_programs`)."""
    from nvorbis_tpu_torch.engine import bulk as eb, programs
    from nvorbis_tpu_torch.ops import floor as fop, ola as oop
    from nvorbis_tpu_torch.parallel import batch as pb, sharded as sh
    from nvorbis_tpu_torch.synth import device as sd

    kernel = sd.imdct_window
    floor_kernel = sd.floored_spectrum
    sym_kernel = sd.floored_spectrum_sym
    ola_kernel = pb.overlap_add
    cache = programs.CACHE
    logs = {} if logs is None else logs

    def logged(name, entry):
        if name in logs:
            logs[name].append(entry)

    def floor_checked(*args, **kwargs):
        out = floor_kernel(*args, **kwargs)
        want = fop.floored_spectrum_ref(*args, **kwargs)
        B, C, n2 = out.shape
        check(bits_equal(out, want),
              f"floor kernel differs from its twin on the decode's inputs "
              f"at B={B} C={C} n2={n2} on {out.device}")
        logged("floor_couple", (str(out.device), B, C, n2))
        return out

    def sym_checked(*args):
        out = sym_kernel(*args)
        want = fop.floored_spectrum_sym_ref(*args)
        B, C, n2 = out.shape
        check(bits_equal(out, want),
              f"floor kernel's symbol form differs from its twin on the "
              f"decode's inputs at B={B} C={C} n2={n2} type "
              f"{args[4].residue_type} on {out.device}")
        logged("floor_sym", (str(out.device), B, C, n2))
        return out

    def ola_checked(*args):
        out = ola_kernel(*args)
        want = oop.overlap_add_ref(*args)
        L, C = out.shape
        check(bits_equal(out, want),
              f"overlap-add kernel differs from its twin on the decode's "
              f"inputs at L={L} C={C} on {out.device}")
        logged("overlap_add", (str(out.device), L, C))
        return out

    def checked(spectrum, windows, widx, basis=None):
        out = kernel(spectrum, windows, widx, basis)
        want = op.imdct_window_ref(spectrum, windows, widx)
        rows, n = out.shape
        W = windows.shape[0]
        shape = f"n={n} W={W} rows={rows} on {out.device}"
        err = (out - want).abs()
        check(bool((err <= 1e-4 + 2e-4 * want.abs()).all()),
              f"kernel disagrees with its twin on the decode's inputs at "
              f"{shape}")
        dead = (widx < 0) | (widx >= W)
        check(bool((out[dead] == 0).all()),
              f"kernel wrote a dead row on the decode's inputs at {shape}")
        log.append((str(out.device), n, W, rows,
                    float(err.max()) if rows else 0.0))
        return out

    sd.imdct_window = checked
    sd.floored_spectrum = sh.floored_spectrum = floor_checked
    sd.floored_spectrum_sym = sym_checked
    pb.overlap_add = eb.overlap_add = ola_checked
    programs.CACHE = programs.ProgramCache(capture_at=None)
    try:
        yield log
    finally:
        sd.imdct_window = kernel
        sd.floored_spectrum = sh.floored_spectrum = floor_kernel
        sd.floored_spectrum_sym = sym_kernel
        pb.overlap_add = eb.overlap_add = ola_kernel
        programs.CACHE = cache


def bits_equal(a, b):
    """``a`` and ``b`` float32 of one shape, equal bit for bit (a signed
    zero or a NaN payload included)."""
    return (a.shape == b.shape and a.dtype == b.dtype == torch.float32
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


@contextlib.contextmanager
def program_runs(log):
    """While active, every chunk program run through
    ``engine/programs.py`` appends ``(key, program, cfg, inputs, rows,
    out, mode)`` to ``log``: its cache key, its inputs copied afresh (a
    graph's slots and the fleet's staging ring are rewritten by later
    chunks; tables as they are), the rows it returned and how it ran.  The
    recording wraps the module function the decoders call and launches
    nothing itself."""
    from nvorbis_tpu_torch.engine import programs

    run = programs.run

    def recorded(kind, program, cfg, flat, device, rows):
        key = (torch.device(device), kind, cfg, programs.signature(flat))
        out, mode = run(kind, program, cfg, flat, device, rows)
        log.append((key, program, cfg, programs.copied(flat, device), rows,
                    out, mode))
        return out, mode

    programs.run = recorded
    try:
        yield log
    finally:
        programs.run = run


def check_programs(path, log, smi, **extra):
    """The chunk programs of one path's recorded runs
    (:func:`program_runs`): every chunk that ran from a CUDA graph equal,
    bit for bit, to the eager program on its own inputs; emits the
    ``programs`` line (distinct keys, chunks by mode, the capture ms
    and device memory of each graph captured on the path, and ``extra``)
    and returns it."""
    from nvorbis_tpu_torch.engine import programs

    check(log, f"{path}: no chunk program ran")
    counts = programs.new_counts()
    graphs = []
    for key, program, cfg, inputs, rows, out, mode in log:
        programs.count(counts, mode)
        if mode == "eager":
            continue
        want = program(cfg, *inputs)[:rows]
        check(want.shape == out.shape and want.dtype == out.dtype
              and torch.equal(want, out),
              f"{path}: a {mode} {key[1]} chunk differs from the eager "
              "program on its inputs")
        if mode == "captured":
            e = programs.CACHE.entry(key)
            check(e is not None and e.graph is not None,
                  f"{path}: a captured program is not in the cache")
            graphs.append({"kind": key[1], "rows": rows,
                           "capture_ms": e.capture_ms, "bytes": e.nbytes,
                           "launches_per_replay": e.launches})
    line = {"phase": "programs", "path": path, **extra, "chunks": len(log),
            "cfgs": len({r[0] for r in log}), **counts,
            "graphs_checked": counts["replayed"], "captures": graphs,
            "capture_ms": sum(g["capture_ms"] for g in graphs),
            "graph_bytes_max": max((g["bytes"] for g in graphs), default=0),
            "cache_entries": len(programs.CACHE),
            "cache_graph_bytes": sum(e.nbytes
                                     for e in programs.CACHE.entries()),
            "card": smi}
    emit(line)
    return line


@contextlib.contextmanager
def finish_threads(names):
    """While active, every chunk's finish of ``BatchDecoder`` appends the
    name of the thread that ran it to ``names``.  The recording wraps the
    Python callable ``_dispatch`` hands out and launches nothing."""
    from nvorbis_tpu_torch.parallel.batch import BatchDecoder

    dispatch = BatchDecoder._dispatch

    def wrapped(*args, **kwargs):
        finish = dispatch(*args, **kwargs)

        def recorded():
            names.append(threading.current_thread().name)
            return finish()
        return recorded

    BatchDecoder._dispatch = wrapped
    try:
        yield names
    finally:
        BatchDecoder._dispatch = dispatch


def check_finish_threads(names, what):
    """Fails unless chunks were finished, each on the ``nvt-fetch`` worker;
    returns the names seen."""
    check(names, f"{what}: no chunk was finished")
    check(all(n.startswith("nvt-fetch") for n in names),
          f"{what}: chunks finished on {sorted(set(names))}, not the "
          "nvt-fetch worker")
    return sorted(set(names))


def kernel_phase(op):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst = 0.0
    summary = None
    bases = {}
    for n, W, rows in kernel_shapes():
        if n not in bases:
            bases[n] = torch.as_tensor(imdct_basis(n), device=dev)
        basis = bases[n]
        # decode-scale inputs: |pcm| ~ 1 after the transform, windows in
        # [0, 1) like the Vorbis power-sine windows
        win = torch.as_tensor(
            rng.random((W, n)).astype(np.float32), device=dev)
        spec = torch.as_tensor(
            (rng.standard_normal((rows, n // 2))
             * np.sqrt(4.0 / n)).astype(np.float32), device=dev)
        # rows over the whole table, and dead rows below and past it (a
        # padding frame; an index the table does not hold): all write zeros
        widx_np = rng.integers(0, W, size=rows).astype(np.int32)
        widx_np[:2] = W - 1, 0
        widx_np[2::61] = -1
        widx_np[3::67] = W
        widx = torch.as_tensor(widx_np, device=dev)
        got = op.imdct_window(spec, win, widx)
        want = op.imdct_window_ref(spec, win, widx, basis)
        # fp64 ground truth: how far each fp32 result is from the exact
        exact = op.imdct_window_ref(spec.double(), win.double(), widx,
                                    basis.double())
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= 1e-4 + 2e-4 * want.abs()).all())
        dead = torch.as_tensor((widx_np < 0) | (widx_np >= W), device=dev)
        dead_zero = bool((got[dead] == 0).all())
        max_err = float(err.max())
        err64 = float((got.double() - exact).abs().max())
        plain_err64 = float((want.double() - exact).abs().max())
        del exact
        ms = cuda_ms(lambda: op.imdct_window(spec, win, widx))
        plain_ms = cuda_ms(
            lambda: op.imdct_window_ref(spec, win, widx, basis))
        gflop = 2.0 * rows * (n // 2) * n / 1e9
        hbm_bytes = 4.0 * rows * (n // 2 + n)
        bound_ms, bound_by = kernel_bound(n, W, widx_np)
        emit({"phase": "kernel", "n": n, "windows": W, "rows": rows,
              "max_abs_err": max_err, "within_tol": ok,
              "dead_rows_zero": dead_zero,
              "kernel_err_vs_fp64": err64,
              "plain_err_vs_fp64": plain_err64, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by,
              "kernel_gbps": hbm_bytes / ms / 1e6,
              "hbm_share": hbm_bytes / (ms * 1e-3) / HBM_BYTES_PER_S,
              "plain_tflops": gflop / plain_ms})
        shape = f"n={n} W={W} rows={rows}"
        check(ok, f"kernel disagrees with its twin at {shape}: "
                  f"max|d|={max_err}")
        check(dead_zero, f"kernel wrote a dead row at {shape}")
        check(err64 <= FP64_FACTOR * plain_err64,
              f"kernel's fp64 error {err64} at {shape} exceeds "
              f"{FP64_FACTOR}x the twin's {plain_err64}")
        worst = max(worst, max_err)
        if (n, W, rows) == (SUMMARY_SHAPE[0], 4, SUMMARY_SHAPE[1]):
            summary = (
                ms, plain_ms, bound_ms, bound_by,
                graph_ms(op.imdct_window, (spec, win, widx)),
                graph_ms(op.imdct_window_ref, (spec, win, widx, basis)))
            emit({"phase": "kernel_summary", "n": n, "windows": W,
                  "rows": rows, "ms": ms, "plain_ms": plain_ms,
                  "graph_ms": summary[4], "plain_graph_ms": summary[5],
                  "bound_ms": bound_ms,
                  "graph_bound_share": bound_ms / summary[4]})
        del spec, widx, got, want, err, dead
    return worst, summary


def fleet_posts():
    """The floor post count of each fleet setup's streams by channel count:
    the last extent of the batch path's floor tables."""
    import nvorbis_tpu_torch as nvt

    out = {}
    for _, kw, _, seeds, _ in FLEET:
        r = nvt.VorbisReader(vorbis_stream(seeds[0], 8, **kw)[0],
                             device="cpu")
        out[kw["channels"]] = r._stream_decoder._max_posts
        r.dispose()
    return out


def floor_inputs(rng, form, n2, C, B, T, P, device="cuda"):
    """Seeded arguments of ``floored_spectrum`` on ``device``, in its order,
    for one row of ``FLOOR_SHAPES`` with ``P`` posts: each table row's
    channel has 0, n2 and sorted distinct positions between (the last one
    or two slots padded at random; the form "shuffled" shuffles each row,
    pads included), the used flags of its real posts at
    0.8, the whole multiplied-Y range, a floor on 0.9 of the channels; the
    last twentieth of the frames padding as a bucket pads them (no floor,
    no used post, zero residue, table row 0)."""
    from nvorbis_tpu_torch.codec.floor import INVERSE_DB_TABLE
    from nvorbis_tpu_torch.ops.floor import _XS_PAD
    from nvorbis_tpu_torch.synth.device import floor1_bin_map

    dev = torch.device(device)
    pad = int(_XS_PAD)
    inner = np.sort(rng.random((T, C, n2 + n2 // 4 - 1)).argsort(axis=-1)
                    [..., : P - 2] + 1, axis=-1)
    xs = np.concatenate([np.zeros((T, C, 1), np.int64),
                         np.full((T, C, 1), n2), inner], axis=-1)
    xs.sort(axis=-1)
    xs[np.arange(P) >= rng.integers(P - 2, P + 1, (T, C, 1))] = pad
    xs = xs.astype(np.int32)
    if form == "shuffled":
        xs = np.take_along_axis(xs, rng.random(xs.shape).argsort(axis=-1),
                                axis=-1)
    if form == "f0":
        xs[:, 1] = pad  # channel 1 is a Floor0 channel
    tid = None
    if form.startswith("table"):
        tid = rng.integers(0, T, size=B).astype(np.int32)
        tid[:2] = 0, T - 1
        rows = xs[tid]
    else:
        rows = np.broadcast_to(xs, (B, C, P))
    residue = rng.standard_normal((B, C, n2)).astype(np.float32)
    ys = rng.integers(-126, 382, size=(B, C, P)).astype(np.int16)
    used = (rng.random((B, C, P)) < 0.8) & (rows < pad)
    has_floor = rng.random((B, C)) < 0.9
    tail = slice(B - B // 20, B)
    residue[tail], used[tail], has_floor[tail] = 0.0, False, False
    if tid is not None:
        tid[tail] = 0
    generic = form in ("generic", "shuffled")
    sl = None if generic else floor1_bin_map(xs, n2)
    if T == 1 and not generic:
        xs, sl = xs[0], sl[0]
    f0 = (rng.random((B, C, n2)).astype(np.float32) if form == "f0"
          else None)
    coupling = () if form == "table_uncoupled" else FLOOR_COUPLING[C]

    def on(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    return (on(residue), on(ys), on(used), on(has_floor), on(xs), on(sl),
            on(tid), coupling,
            torch.as_tensor(INVERSE_DB_TABLE, dtype=torch.float32,
                            device=dev),
            on(f0))


def floor_bound(args):
    """``(bound_ms, bound_by)`` of one ``floored_spectrum`` call on
    ``args``: the larger of its bytes over ``HBM_BYTES_PER_S`` (each input
    read once: the residue, the posts and flags, the tables ``T x C x (P +
    n2)`` with the bin map, the table ids, the inverse-dB table, the Floor0
    curves; the output written once) and its fp32 operations over
    ``FP32_FLOPS_PER_S`` (the floor multiply and one add or subtract per
    coupling step, per bin and frame; the render's integer work is left
    out, the data sheet giving no int32 rate)."""
    residue, coupling = args[0], args[7]
    nbytes = residue.numel() * 4.0 + sum(
        t.numel() * t.element_size() for t in args if torch.is_tensor(t))
    B, C, n2 = residue.shape
    ops = float(B * n2 * (C + len(coupling)))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def floor_kernel_phase(fop, smi):
    """The floor kernel against its plain twin on the card at every row of
    ``FLOOR_SHAPES``, bit for bit (equal float32 bit patterns: signed zeros
    count), with both times around one call (:func:`cuda_ms`) and as
    graph replays (:func:`graph_ms`) and the kernel's bound
    (:func:`floor_bound`); returns the worst ``max|d|`` (0 when every shape
    is bit-equal) and the summary shape's ``(ms, plain_ms, bound_ms,
    bound_by, graph_ms, plain_graph_ms)``."""
    posts = fleet_posts()
    rng = np.random.default_rng(12)
    summary = None
    worst = 0.0
    for row in FLOOR_SHAPES:
        form, n2, C, B, T, P = row
        P = P or posts[C]
        args = floor_inputs(rng, form, n2, C, B, T, P)
        before = fop.launches
        got = fop.floored_spectrum(*args)
        want = fop.floored_spectrum_ref(*args)
        torch.cuda.synchronize()
        shape = f"{form} n2={n2} C={C} B={B} T={T} P={P}"
        check(fop.launches == before + 1,
              f"floor kernel at {shape}: {fop.launches - before} launches")
        equal = bits_equal(got, want)
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: fop.floored_spectrum(*args))
        plain_ms = cuda_ms(lambda: fop.floored_spectrum_ref(*args))
        g_ms = graph_ms(fop.floored_spectrum, args)
        plain_g_ms = graph_ms(fop.floored_spectrum_ref, args)
        bound_ms, bound_by = floor_bound(args)
        emit({"phase": "floor_kernel", "form": form, "n2": n2, "channels": C,
              "frames": B, "tables": T, "posts": P,
              "coupling_steps": len(args[7]), "bit_equal": equal,
              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "plain_over_kernel": plain_ms / ms, "graph_ms": g_ms,
              "plain_graph_ms": plain_g_ms,
              "plain_over_kernel_graph": plain_g_ms / g_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_share": bound_ms / ms,
              "graph_bound_share": bound_ms / g_ms, "card": smi})
        check(equal, f"floor kernel differs from its twin at {shape}")
        worst = max(worst, err)
        if row == FLOOR_SUMMARY:
            summary = (ms, plain_ms, bound_ms, bound_by, g_ms, plain_g_ms)
        del args, got, want
    return worst, summary


def symbol_buckets(records):
    """``floored_spectrum_sym``'s arguments ``(classes, ids_flat,
    frame_base, tabs, st, ys, used, has_floor, xs_t, sl_t, tid, coupling,
    idb_table, C)`` of captured chunks' symbol buckets
    (``tools/device_synth_torch.py::capture``), by ``(C, block size)``:
    the first bucket with the most frames, with the floor arguments its
    chunk program hands the op (the group's floor tables by table id);
    :func:`residue_args` of each is ``reconstruct_spectrum``'s."""
    from nvorbis_tpu_torch.parallel.batch import _BUCKET_ARGS
    from nvorbis_tpu_torch.synth.device import inverse_db_table

    out = {}
    for cfg, flat, _ in records:
        i = 0
        for b in cfg[3]:
            k = _BUCKET_ARGS[b[0]]
            key = (cfg[0], b[2])
            if b[0] == "s" and (key not in out
                                or out[key][0].shape[0] < b[1]):
                a = flat[i : i + k]
                out[key] = (a[0], a[1], a[2], tuple(a[12:15]), b[7],
                            a[3], a[4], a[5], a[8], a[11], a[7], b[6],
                            inverse_db_table(a[0].device), cfg[0])
            i += k
    return out


def residue_args(args):
    """``reconstruct_spectrum``'s arguments ``(classes, ids_flat,
    frame_base, tabs, st, C)`` of ``floored_spectrum_sym``'s."""
    return (*args[:5], args[-1])


def injected(rng, args, sentinel=0.15, missing=0.1):
    """``args`` of ``reconstruct_spectrum`` with ``sentinel`` of the
    classes undecoded and ``missing`` of the ids -1 (copies)."""
    from nvorbis_tpu_torch.synth.residue_sym import CLASS_SENTINEL

    classes, ids, *rest = args
    cls = classes.cpu().numpy().copy()
    cls[rng.random(cls.shape) < sentinel] = CLASS_SENTINEL
    flat = ids.cpu().numpy().copy()
    flat[rng.random(flat.shape) < missing] = -1
    return (torch.as_tensor(cls, device=classes.device),
            torch.as_tensor(flat, device=ids.device), *rest)


def geometry_args(rng, rtype, C, block, B, psize, dims, begin, end,
                  n_cls, stages, entries, sentinel=0.1, missing=0.1,
                  device="cuda"):
    """Seeded ``reconstruct_spectrum`` arguments on ``device`` for a plan at
    libvorbis's geometry: ``n_cls`` classes, each with a random cascade
    over ``stages`` stages (class 0 none, the last every stage) and a book
    of dims from ``dims`` and ``entries`` entries at each set stage (some
    values -0.0); ``B`` frames of classes (``sentinel`` undecoded), each
    frame's ids at its slots (``missing`` -1), padded as ``pad_ids``
    pads a bucket."""
    from types import SimpleNamespace

    from nvorbis_tpu_torch.synth.residue_sym import (
        CLASS_SENTINEL,
        ResiduePlan,
        pad_ids,
        plan_static,
    )

    books, cascade = [], []
    for cls in range(n_cls):
        bits = (0 if cls == 0 else (1 << stages) - 1 if cls == n_cls - 1
                else int(rng.integers(1, 1 << stages)))
        row = []
        for s in range(stages):
            book = None
            if bits >> s & 1:
                d = int(rng.choice(dims))
                lookup = rng.standard_normal(entries * d).astype(np.float32)
                lookup[rng.random(lookup.shape) < 0.05] = -0.0
                book = SimpleNamespace(dimensions=d, entries=entries,
                                       lookup=lookup)
            row.append(book)
        books.append(row)
        cascade.append(bits)
    plan = ResiduePlan(SimpleNamespace(
        residue_type=rtype, begin=begin, end=end, partition_size=psize,
        classifications=n_cls, max_stages=stages, cascade=cascade,
        books=books), C)
    st = plan_static(plan, block)
    classes = rng.integers(0, n_cls, (B, st.chr_count, max(1, st.n_part)))
    classes[rng.random(classes.shape) < sentinel] = CLASS_SENTINEL
    counts = plan.groups_np[classes[:, :, :st.n_part]].sum(axis=(1, 2, 3))
    base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    total = int(counts.sum())
    ids = rng.integers(0, entries, total).astype(np.int16)
    ids[rng.random(total) < missing] = -1

    def on(a):
        return torch.as_tensor(a, device=device)

    return (on(classes.astype(np.uint8)), on(pad_ids([ids], total)),
            on(base), tuple(on(t) for t in (plan.groups_np, plan.pair_np,
                                             plan.vq_mega_np)), st, C)


def residue_bound(args):
    """``(bound_ms, bound_by)`` of one ``reconstruct_spectrum`` call on
    ``args``: the larger of its bytes over ``HBM_BYTES_PER_S`` (the output
    written once, the ids the frames' classes address read once at 2
    bytes, the classes and ``frame_base``; the plan's tables, a few KiB
    to a few hundred KiB read by every frame, are taken as L2-resident and
    left out) and its fp32 adds (one per stage and coded bin) over
    ``FP32_FLOPS_PER_S``."""
    classes, _, base, tabs, st, C = args
    B = classes.shape[0]
    n2 = st.half // C if st.residue_type == 2 else st.half
    n_ids = (int(tabs[0][classes[:, :, :st.n_part].long()].sum())
             if st.n_part else 0)
    nbytes = (4.0 * B * C * n2 + 2.0 * n_ids + classes.numel()
              + base.numel() * base.element_size())
    ops = float(B * st.chr_count * st.n_part * st.psize * st.stages)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timed_kernel(phase, name, mod, kernel, twin, args, bound, smi, **shape):
    """One kernel check of the ``residue_kernel`` and ``ola_kernel``
    phases: the kernel once (one launch counted) against its twin on
    ``args``, bit for bit; both timed around one call (:func:`cuda_ms`)
    and as graph replays (:func:`graph_ms`); the bound from ``bound``.
    Emits the phase line; returns ``(max|d|, ms, plain_ms, bound_ms,
    bound_by, graph_ms, plain_graph_ms)``."""
    before = mod.launches
    got = kernel(*args)
    want = twin(*args)
    torch.cuda.synchronize()
    what = f"{phase} {name} {shape}"
    check(mod.launches == before + 1,
          f"{what}: {mod.launches - before} launches")
    equal = bits_equal(got, want)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    del got, want
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: twin(*args))
    g_ms = graph_ms(kernel, args)
    plain_g_ms = graph_ms(twin, args)
    bound_ms, bound_by = bound(args)
    emit({"phase": phase, "form": name, **shape, "bit_equal": equal,
          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
          "plain_over_kernel": plain_ms / ms, "graph_ms": g_ms,
          "plain_graph_ms": plain_g_ms,
          "plain_over_kernel_graph": plain_g_ms / g_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_share": bound_ms / ms,
          "graph_bound_share": bound_ms / g_ms, "card": smi})
    check(equal, f"{what}: the kernel differs from its twin")
    return err, ms, plain_ms, bound_ms, bound_by, g_ms, plain_g_ms


def residue_kernel_phase(rop, smi, capture):
    """The residue kernel against its plain twin on the card at the fleet's
    symbol buckets (``capture``: the device_synth phase's capturing
    decoder), the types 0 and 1 streams, the libvorbis-geometry plans
    (``RESIDUE_TYPED``, ``RESIDUE_GEOMETRIES``), bit for bit, with the
    bound (:func:`residue_bound`); returns the worst ``max|d|`` (0 when
    every shape is bit-equal) and the summary shape's numbers."""
    ds = load_tool(os.path.join("tools", "device_synth_torch.py"))
    rng = np.random.default_rng(13)
    fleet = symbol_buckets(capture._capture)
    cases = [("fleet", residue_args(a)) for _, a in sorted(fleet.items())]
    check(len(cases) >= 4, f"fleet symbol buckets {sorted(fleet)}")
    cases.append(("fleet_injected",
                  residue_args(injected(rng, fleet[(2, BLOCKS[1])]))))
    for name, kw, seed in RESIDUE_TYPED:
        blob = vorbis_stream(seed, RESIDUE_PACKETS, **kw)[0]
        bd = ds.capture([blob] * RESIDUE_STREAMS)
        typed = symbol_buckets(bd._capture)
        check(typed, f"{name}: no symbol bucket captured")
        cases += [(name, residue_args(a)) for _, a in sorted(typed.items())]
        del bd
    for form, *geom in RESIDUE_GEOMETRIES:
        cases.append((form, geometry_args(rng, *geom, **RESIDUE_GEOMETRY)))
    worst, summary = 0.0, None
    for name, args in cases:
        st, C = args[4], args[5]
        n2 = st.half // C if st.residue_type == 2 else st.half
        shape = {"residue_type": st.residue_type, "channels": C, "n2": n2,
                 "frames": args[0].shape[0], "psize": st.psize,
                 "n_part": st.n_part, "stages": st.stages,
                 "prefix_pairs": st.chr_count * st.n_part}
        res = timed_kernel("residue_kernel", name, rop,
                           rop.reconstruct_spectrum,
                           rop.reconstruct_spectrum_ref, args,
                           residue_bound, smi, **shape)
        worst = max(worst, res[0])
        if (name, C, n2) == RESIDUE_SUMMARY:
            summary = res[1:] + (shape,)
    check(summary is not None, "residue summary shape not timed")
    return worst, summary


def geometry_sym_args(rng, rtype, C, block, B, psize, dims, begin, end,
                      device="cuda"):
    """Seeded ``floored_spectrum_sym`` arguments on ``device`` for one row
    of ``RESIDUE_GEOMETRIES``: :func:`geometry_args`' symbols, and the
    floor phase's posts of the form ``"table"`` (:func:`floor_inputs`:
    ``FLOOR_SYM_TABLES`` table rows of ``FLOOR_SYM_POSTS`` posts, each
    frame's row by table id, the last twentieth of the frames
    padding)."""
    classes, ids, base, tabs, st, _ = geometry_args(
        rng, rtype, C, block, B, psize, dims, begin, end, device=device,
        **RESIDUE_GEOMETRY)
    (_, ys, used, has_floor, xs, sl, tid, coupling, idb,
     _) = floor_inputs(rng, "table", block // 2, C, B, FLOOR_SYM_TABLES,
                       FLOOR_SYM_POSTS, device=device)
    return (classes, ids, base, tabs, st, ys, used, has_floor, xs, sl, tid,
            coupling, idb, C)


def floor_sym_bound(args):
    """``(bound_ms, bound_by)`` of one ``floored_spectrum_sym`` call on
    ``args``, in :func:`floor_bound`'s and :func:`residue_bound`'s
    conventions without the residue's write and read: the larger of its
    bytes over ``HBM_BYTES_PER_S`` (the output written once; the ids the
    frames' classes address read once at 2 bytes, the classes and
    ``frame_base``; the posts and flags, the floor tables with the bin
    map, the table ids and the inverse-dB table; the plan's tables taken
    as L2-resident and left out) and its fp32 operations over
    ``FP32_FLOPS_PER_S`` (one add per stage and coded bin, the floor
    multiply and one add or subtract per coupling step, per bin and
    frame)."""
    (classes, _, base, tabs, st, ys, used, has_floor, xs, sl, tid, coupling,
     idb, C) = args
    B = classes.shape[0]
    n2 = st.half // C if st.residue_type == 2 else st.half
    n_ids = (int(tabs[0][classes[:, :, :st.n_part].long()].sum())
             if st.n_part else 0)
    nbytes = (4.0 * B * C * n2 + 2.0 * n_ids + classes.numel()
              + base.numel() * base.element_size()
              + sum(t.numel() * t.element_size()
                    for t in (ys, used, has_floor, xs, sl, tid, idb)
                    if t is not None))
    ops = float(B * st.chr_count * st.n_part * st.psize * st.stages
                + B * n2 * (C + len(coupling)))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def floor_sym_kernel_phase(fop, rop, smi, capture):
    """The floor kernel's symbol form against its composed twin (the
    residue twin, then the floor twin) on the card at every symbol bucket
    of the fleet's capture (``capture``: the device_synth phase's
    capturing decoder; the stereo long one again with undecoded partitions
    and missing ids) and at the ``RESIDUE_GEOMETRIES`` plans with seeded
    posts (:func:`geometry_sym_args`), bit for bit, one launch counted on
    ``fop.sym`` each; both times around one call and as graph replays, the
    bound (:func:`floor_sym_bound`), and beside them the pair the symbol
    lane ran before, the residue kernel then the dense form, around one
    call and as one graph over the same rotated inputs, equal to the
    symbol form bit for bit.  Returns the worst ``max|d|`` and the summary
    shape's numbers."""
    rng = np.random.default_rng(15)
    fleet = symbol_buckets(capture._capture)
    cases = [("fleet", a) for _, a in sorted(fleet.items())]
    check(len(cases) >= 4, f"fleet symbol buckets {sorted(fleet)}")
    cases.append(("fleet_injected", injected(rng, fleet[(2, BLOCKS[1])])))
    for form, *geom in RESIDUE_GEOMETRIES:
        cases.append((form, geometry_sym_args(rng, *geom)))

    def pair(*args):
        residue = rop.reconstruct_spectrum(*residue_args(args))
        return fop.floored_spectrum(residue, *args[5:13])

    worst, summary = 0.0, None
    for name, args in cases:
        st, C = args[4], args[-1]
        n2 = st.half // C if st.residue_type == 2 else st.half
        shape = {"residue_type": st.residue_type, "channels": C, "n2": n2,
                 "frames": args[0].shape[0], "psize": st.psize,
                 "n_part": st.n_part, "stages": st.stages,
                 "posts": args[8].shape[-1],
                 "tables": args[8].shape[0] if args[8].dim() == 3 else 1,
                 "coupling_steps": len(args[11])}
        what = f"floor_sym_kernel {name} {shape}"
        def counts():
            return fop.sym.launches, fop.launches, rop.launches

        before = counts()
        got = fop.floored_spectrum_sym(*args)
        want = fop.floored_spectrum_sym_ref(*args)
        torch.cuda.synchronize()
        check(counts() == (before[0] + 1, *before[1:]),
              f"{what}: launches {before} -> {counts()}")
        equal = bits_equal(got, want)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        pair_equal = bits_equal(pair(*args), got)
        del got, want
        ms = cuda_ms(lambda: fop.floored_spectrum_sym(*args))
        plain_ms = cuda_ms(lambda: fop.floored_spectrum_sym_ref(*args))
        pair_ms = cuda_ms(lambda: pair(*args))
        g_ms = graph_ms(fop.floored_spectrum_sym, args)
        plain_g_ms = graph_ms(fop.floored_spectrum_sym_ref, args)
        pair_g_ms = graph_ms(pair, args)
        bound_ms, bound_by = floor_sym_bound(args)
        emit({"phase": "floor_sym_kernel", "form": name, **shape,
              "bit_equal": equal, "pair_bit_equal": pair_equal,
              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "pair_ms": pair_ms, "graph_ms": g_ms,
              "plain_graph_ms": plain_g_ms, "pair_graph_ms": pair_g_ms,
              "graph_over_pair": g_ms / pair_g_ms,
              "plain_over_kernel_graph": plain_g_ms / g_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_share": bound_ms / ms,
              "graph_bound_share": bound_ms / g_ms,
              "pair_graph_bound_share": bound_ms / pair_g_ms, "card": smi})
        check(equal, f"{what}: the kernel differs from its twin")
        check(pair_equal, f"{what}: the kernel differs from the pair")
        worst = max(worst, err)
        if (name, C, n2) == FLOOR_SYM_SUMMARY:
            summary = (ms, plain_ms, bound_ms, bound_by, g_ms, plain_g_ms,
                       pair_g_ms, shape)
    check(summary is not None, "floor_sym summary shape not timed")
    return worst, summary


def ola_tables(rng, L, C, seg=OLA_SEG, device="cuda"):
    """Seeded ``overlap_add`` arguments on ``device``: about ``L / seg``
    segments tiling ``[0, L)``, a padding tail of a quarter as many
    starting past ``L``, each secondary inside its own segment but the
    last, which ends past ``L``; rows ``[2 L, C]``."""
    n_segs = L // seg
    S = n_segs + n_segs // 4
    starts = np.sort(rng.choice(np.arange(1, L), n_segs - 1, replace=False))
    segE = np.empty(S + 1, np.int32)
    segE[0], segE[1:n_segs] = 0, starts
    segE[n_segs:] = L + 1 + np.arange(S + 1 - n_segs)
    seg_len = np.diff(np.append(segE[:n_segs], L))
    prim, sec, sec_len = (np.zeros(S, np.int32) for _ in range(3))
    prim[:n_segs] = rng.integers(0, L, n_segs)
    sec[:n_segs] = rng.integers(0, L, n_segs)
    sec_len[:n_segs] = rng.integers(0, seg_len + 1)
    sec_len[n_segs - 1] = seg_len[-1] + 7
    rows = rng.standard_normal((2 * L, C)).astype(np.float32)
    return (*(torch.as_tensor(a, device=device)
              for a in (rows, segE, prim, sec, sec_len)), L)


def chunk_tables(records):
    """``overlap_add``'s arguments ``(rows, segE, prim, sec, sec_len,
    L_pad)`` of captured chunks, by channel count: the chunk with the most
    output samples, its rows synthesized by ``bucket_rows``."""
    from nvorbis_tpu_torch.parallel.batch import _BUCKET_ARGS, bucket_rows

    best = {}
    for cfg, flat, _ in records:
        if cfg[0] not in best or best[cfg[0]][0][1] < cfg[1]:
            best[cfg[0]] = (cfg, flat)
    out = {}
    for C, (cfg, flat) in sorted(best.items()):
        n_max = max(b[2] for b in cfg[3])
        rows = []
        i = 0
        for b in cfg[3]:
            k = _BUCKET_ARGS[b[0]]
            rows.append(bucket_rows(b, flat[i : i + k], C, n_max))
            i += k
        out[C] = (torch.cat(rows).reshape(-1, C), *flat[i : i + 4], cfg[1])
    return out


def ola_bound(args):
    """``(bound_ms, bound_by)`` of one ``overlap_add`` call on ``args``:
    the larger of its bytes over ``HBM_BYTES_PER_S`` (the output written
    once, each sample's primary row value read once, a secondary value
    read only where a tail laps: ``min(sec_len, segment length)`` samples
    of each segment, and the segment table) and its fp32 adds (one per
    output value) over ``FP32_FLOPS_PER_S``."""
    rows, segE, prim, sec, sec_len, L = args
    C = rows.shape[1]
    S = prim.shape[0]
    e = segE.long().cpu().numpy()
    lo = np.minimum(e[:S], L)
    hi = np.minimum(e[1:], L)
    hi[S - 1] = L  # the last segment runs on (the segment index clamps)
    lapped = np.minimum(np.maximum(sec_len.long().cpu().numpy(), 0),
                        np.maximum(hi - lo, 0)).sum()
    nbytes = 4.0 * (2 * L * C + lapped * C + (S + 1) + 3 * S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = L * C / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ola_kernel_phase(oop, smi, capture):
    """The overlap-add kernel against its plain twin on the card at the
    fleet's recorded chunk tables (``capture``) and at random tables
    (:func:`ola_tables`) of each of ``OLA_CHANNELS``, bit for bit, with the
    bound (:func:`ola_bound`); returns the worst ``max|d|`` and the summary
    shape's numbers."""
    rng = np.random.default_rng(14)
    cases = [("fleet", a) for _, a in sorted(
        chunk_tables(capture._capture).items())]
    check(len(cases) == 2, f"fleet chunk tables of {len(cases)} groups")
    cases += [("random", ola_tables(rng, OLA_RANDOM_L, C))
              for C in OLA_CHANNELS]
    worst, summary = 0.0, None
    for name, args in cases:
        C = args[0].shape[1]
        shape = {"channels": C, "samples": args[5],
                 "rows": args[0].shape[0], "segments": args[2].shape[0]}
        res = timed_kernel("ola_kernel", name, oop, oop.overlap_add,
                           oop.overlap_add_ref, args, ola_bound, smi,
                           **shape)
        worst = max(worst, res[0])
        if (name, C) == OLA_SUMMARY:
            summary = res[1:] + (shape,)
    check(summary is not None, "overlap-add summary shape not timed")
    return worst, summary


def decode_phase(op, smi):
    import nvorbis_tpu_torch as nvt

    def decode(blob, device):
        r = nvt.VorbisReader(blob, device=device)
        pcm = r.read_all()
        dec = r._stream_decoder
        out = (pcm, dec.has_clipped, dec._bulk, r.channels, r.sample_rate)
        r.dispose()
        return out

    streams = []
    for name, kw, packets, seed in STREAMS:
        t0 = time.perf_counter()
        blob, samples = vorbis_stream(seed, packets, **kw)
        emit({"phase": "build_stream", "stream": name, "packets": packets,
              "bytes": len(blob), "sha256": hashlib.sha256(blob).hexdigest(),
              "seconds": time.perf_counter() - t0})
        # warm-up: first use of every op of both paths, the host unpacker
        warm = vorbis_stream(seed, 64, **kw)[0]
        decode(warm, "cuda")
        decode(warm, "cpu")
        streams.append((name, blob, samples))
    torch.cuda.synchronize()

    # the main path, counted: one card decode of each stream, then one
    # more (its chunks replay the graphs the first captured), each chunk
    # program recorded
    runs = []
    zero_launches()
    with program_runs(runs):
        decoded = [decode(blob, "cuda") for _, blob, _ in streams]
    launches = op.launches
    path_launches("read_all")
    with program_runs(runs):
        again = [decode(blob, "cuda")[0] for _, blob, _ in streams]
    for (name, _, _), (pcm, *_), pcm2 in zip(streams, decoded, again):
        check(np.array_equal(pcm, pcm2),
              f"{name}: the second card decode differs from the first")
    check_programs("read_all", runs, smi)
    del runs, again

    plain = []
    for (name, blob, samples), (pcm, clipped, bulk, ch, sr) in zip(
            streams, decoded):
        ref, ref_clipped = decode(blob, "cpu")[:2]
        plain.append((name, blob, samples, ref, ch, sr))
        max_ref = float(np.abs(ref).max()) if len(ref) else 0.0
        max_d = (float(np.abs(pcm - ref).max())
                 if len(pcm) == len(ref) and len(ref) else float("inf"))
        tol = 5e-6 * max(1.0, max_ref)
        lane = bulk.lane if bulk is not None else None
        check(len(pcm) == len(ref) == samples * ch > 0,
              f"{name}: length {len(pcm)}, plain path {len(ref)}, stream "
              f"{samples} x {ch}")
        check(clipped == ref_clipped, f"{name}: has_clipped differs")
        check(max_d <= tol, f"{name}: max|d| {max_d} > {tol}")
        check(lane == "symbol", f"{name}: bulk lane {lane!r}, not symbol")
        check(bool(np.isfinite(pcm).all()), f"{name}: non-finite samples")
        # wall clock, alternating paths: median of REPEATS each
        times = {"cuda": [], "cpu": []}
        for device in ("cuda", "cpu", "cpu", "cuda") * (REPEATS // 2) + (
                ("cuda", "cpu") if REPEATS % 2 else ()):
            t0 = time.perf_counter()
            decode(blob, device)
            times[device].append(time.perf_counter() - t0)
        audio_s = samples / sr
        emit({"phase": "decode", "stream": name, "channels": ch,
              "sample_rate": sr, "samples": samples,
              "audio_seconds": audio_s, "len_equal": True,
              "has_clipped": [clipped, ref_clipped], "max_abs_diff": max_d,
              "tol": tol, "lane": lane, "chunks": bulk.chunks,
              "port_seconds": times["cuda"], "plain_seconds": times["cpu"],
              "port_x_realtime": audio_s / statistics.median(times["cuda"]),
              "plain_x_realtime": audio_s / statistics.median(times["cpu"]),
              "card": smi})
    check(launches > 0, "the decodes launched the kernel no time")
    return launches, plain


def batch_phase(op, smi):
    import nvorbis_tpu_torch as nvt

    t0 = time.perf_counter()
    fleet = fleet_sources()
    blobs = [f[2] for f in fleet]
    audio_s = sum(f[3] / f[4] for f in fleet)
    emit({"phase": "build_fleet", "sources": len(fleet),
          "distinct": len({id(b) for b in blobs}), "audio_seconds": audio_s,
          "bytes": sum(len(b) for b in blobs),
          "seconds": time.perf_counter() - t0})

    def card():
        bd = nvt.BatchDecoder(blobs, device="cuda")
        return bd.decode_all(), bd

    def host():
        return nvt.BatchDecoder(blobs, engine="host").decode_all()

    def singles():
        out = []
        for blob in blobs:
            r = nvt.VorbisReader(blob, device="cuda")
            out.append(r.read_all())
            r.dispose()
        return out

    # warm-up: the first use of every op of the batch path and of the host
    # engine's allocator policy, on a two-stream fleet
    small = [vorbis_stream(seeds[0], 64, **kw)[0]
             for _, kw, _, seeds, _ in FLEET]
    nvt.BatchDecoder(small, device="cuda").decode_all()
    nvt.BatchDecoder(small, engine="host").decode_all()
    torch.cuda.synchronize()

    # the chunk programs the host plan gives the fleet, on the CPU
    t0 = time.perf_counter()
    planned = planned_programs(blobs)
    plan_s = time.perf_counter() - t0

    # the main path, counted: one card decode of the fleet, each chunk
    # finished on the fetch worker, each chunk program recorded
    names = []
    runs = []
    zero_launches()
    with finish_threads(names), program_runs(runs):
        t0 = time.perf_counter()
        outs, bd = card()
        wall = time.perf_counter() - t0
    launches = op.launches
    path_launches("batch")
    card_keys = [r[0][1:] for r in runs]
    check(card_keys == planned,
          f"the card ran {len(card_keys)} chunks of {len(set(card_keys))} "
          f"programs, the host plan on the CPU {len(planned)} of "
          f"{len(set(planned))}")
    line = check_programs("batch", runs, smi)
    check(line["eager"] + line["replayed"] == bd.chunks
          and bd.programs == {k: line[k] for k in bd.programs},
          f"batch programs {bd.programs}, recorded {line}")
    emit({"phase": "programs_plan", "path": "batch", "chunks": len(planned),
          "cfgs": len(set(planned)), "seconds": plan_s,
          "equal_to_card": True})

    # device time by stage: one profiled eager replay of the recorded
    # chunk programs (a graph replay's kernels carry no nvt.* span)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, program, cfg, inputs, rows, _, _ in runs:
            program(cfg, *inputs)
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(STAGE_TRACE_OUT), exist_ok=True)
    prof.export_chrome_trace(STAGE_TRACE_OUT)
    with open(STAGE_TRACE_OUT) as f:
        stage_busy_us, by_stage = trace_split(json.load(f)["traceEvents"])
    check(stage_busy_us > 0, "the profiled replay shows no device time")
    del runs, prof
    check(launches > 0, "the batch decode launched the kernel no time")
    check(bd.routes == ["device"] * len(blobs),
          f"batch routes {sorted(set(bd.routes))}, not all device")
    emit({"phase": "fetch_worker", "path": "batch", "sources": len(blobs),
          "launches": launches, "chunks": len(names),
          "finish_threads": check_finish_threads(names, "batch"),
          "seconds": wall, "card": smi})

    times = {"card": [], "host": [], "singles": []}
    runs = {"card": card, "host": host, "singles": singles}
    first = {}
    for order in (("card", "host", "singles"), ("singles", "host", "card"),
                  ("card", "singles", "host"))[:BATCH_REPEATS]:
        for k in order:
            t0 = time.perf_counter()
            res = runs[k]()
            times[k].append(time.perf_counter() - t0)
            first.setdefault(k, res)
    refs = first["singles"]
    host_out = first["host"]
    worst = {"single": 0.0, "host": 0.0}
    for i, (name, seed, blob, samples, sr, ch) in enumerate(fleet):
        pcm = outs[i]
        want_len = (samples + FLEET_SURPLUS.get(seed, 0)) * ch
        check(len(pcm) == len(refs[i]) == want_len > 0,
              f"fleet {i} ({name}/{seed}): length {len(pcm)}, single "
              f"{len(refs[i])}, expected {want_len}")
        check(bool(np.isfinite(pcm).all()), f"fleet {i}: non-finite")
        for key, ref in (("single", refs[i]), ("host", host_out[i])):
            tol = 5e-6 * max(1.0, float(np.abs(ref).max()))
            d = float(np.abs(pcm - ref).max())
            check(d <= tol, f"fleet {i} ({name}/{seed}) vs {key}: max|d| "
                            f"{d} > {tol}")
            worst[key] = max(worst[key], d)
    del refs, host_out, first

    # one stream of each setup against the plain path
    plain_d = {}
    for name, *_ in FLEET:
        i = next(k for k, f in enumerate(fleet) if f[0] == name)
        (ref,) = nvt.BatchDecoder([blobs[i]], device="cpu").decode_all()
        tol = 5e-6 * max(1.0, float(np.abs(ref).max()))
        d = float(np.abs(outs[i] - ref).max()) if len(ref) == len(
            outs[i]) else float("inf")
        check(d <= tol, f"{name}: batch vs plain path max|d| {d} > {tol}")
        plain_d[name] = d

    # the int16 epilogue, with every kernel call held to its twin on the
    # decode's own inputs (every chunk eager), then through the graphs
    runs = []
    logs = {"floor_sym": [], "overlap_add": []}
    os.environ["NVT_FETCH_INT16"] = "1"
    try:
        with twin_checked(op, [], logs) as twin_log:
            q_outs = card()[0]
        with program_runs(runs):
            q_graph = card()[0]
    finally:
        del os.environ["NVT_FETCH_INT16"]
    check(twin_log, "the twin-checked batch decode called the kernel no time")
    check(logs["floor_sym"] and logs["overlap_add"],
          f"the twin-checked batch decode called the floor kernel's symbol "
          f"form {len(logs['floor_sym'])} and the overlap-add "
          f"{len(logs['overlap_add'])} times")
    i16_d = max(float(np.abs(q - o).max()) for q, o in zip(q_outs, outs))
    check(i16_d <= I16_TOL, f"int16 output off by {i16_d} > {I16_TOL}")
    check(i16_d > 0, "int16 output equals the float32 one")
    check(all(np.array_equal(a, b) for a, b in zip(q_graph, q_outs)),
          "the int16 decode through the graphs differs from the eager one")
    check_programs("batch_int16", runs, smi)
    del q_outs, q_graph, runs

    # the card's busy share: one profiled card decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        card()
        prof_wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(TRACE_OUT), exist_ok=True)
    prof.export_chrome_trace(TRACE_OUT)
    with open(TRACE_OUT) as f:
        busy_us = trace_split(json.load(f)["traceEvents"])[0]
    check(busy_us > 0, "the profiled batch decode shows no device time")

    med = {k: statistics.median(v) for k, v in times.items()}
    emit({"phase": "batch", "sources": len(fleet), "groups": 2,
          "chunks": bd.chunks, "audio_seconds": audio_s,
          "launches": launches, "routes": "device",
          "max_abs_diff_vs_single": worst["single"],
          "max_abs_diff_vs_host": worst["host"],
          "max_abs_diff_vs_plain": plain_d, "int16_max_abs_diff": i16_d,
          "twin_checked_calls": len(twin_log),
          "twin_max_abs_err": max(e[4] for e in twin_log),
          "twin_checked_calls_by_kernel": {k: len(v)
                                           for k, v in logs.items()},
          "card_seconds": times["card"], "host_seconds": times["host"],
          "singles_seconds": times["singles"],
          "card_x_realtime": audio_s / med["card"],
          "host_x_realtime": audio_s / med["host"],
          "singles_x_realtime": audio_s / med["singles"],
          "profiled_wall_ms": prof_wall * 1e3,
          "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e6 / prof_wall,
          "eager_replay_busy_ms": stage_busy_us / 1e3,
          "device_ms_by_stage": {k: v / 1e3 for k, v in sorted(
              by_stage.items(), key=lambda kv: -kv[1])},
          "card": smi})
    return launches, fleet, outs, max(e[4] for e in twin_log)


def dense_phase(op, smi, fleet, batch_outs):
    """The batch phase's fleet once more on the dense lane
    (``NVT_NO_SYMBOLS=1``: the residue as the host unpacks it, the floor
    kernel's dense form), counted as the path ``dense``: every route
    ``"device"``, every stream within ``5e-6 * max(1, max|ref|)`` of the
    symbol decode (``batch_outs``); returns the IMDCT's launches."""
    import nvorbis_tpu_torch as nvt

    blobs = [f[2] for f in fleet]
    os.environ["NVT_NO_SYMBOLS"] = "1"
    try:
        zero_launches()
        t0 = time.perf_counter()
        bd = nvt.BatchDecoder(blobs, device="cuda")
        outs = bd.decode_all()
        wall = time.perf_counter() - t0
        launches = op.launches
        counts = {k: m.launches for k, m in kernel_modules().items()}
        path_launches("dense")
    finally:
        del os.environ["NVT_NO_SYMBOLS"]
    check(bd.routes == ["device"] * len(blobs),
          f"dense routes {sorted(set(bd.routes))}, not all device")
    worst = 0.0
    for i, (pcm, ref) in enumerate(zip(outs, batch_outs)):
        tol = 5e-6 * max(1.0, float(np.abs(ref).max()))
        check(len(pcm) == len(ref) > 0,
              f"dense stream {i}: length {len(pcm)}, symbol {len(ref)}")
        d = float(np.abs(pcm - ref).max())
        check(d <= tol, f"dense stream {i} vs the symbol decode: max|d| "
                        f"{d} > {tol}")
        worst = max(worst, d)
    emit({"phase": "dense", "sources": len(blobs), "chunks": bd.chunks,
          "launches": launches, "launches_by_kernel": counts,
          "max_abs_diff_vs_symbol": worst, "seconds": wall, "card": smi})
    return launches


def streaming_phase(op, smi, stream):
    import nvorbis_tpu_torch as nvt
    from nvorbis_tpu_torch.engine import programs
    from nvorbis_tpu_torch.engine.batcher import TorchPipeline

    name, blob, samples, ref, ch, sr = stream
    tol = 5e-6 * max(1.0, float(np.abs(ref).max()))

    def read():
        r = nvt.VorbisReader(blob, device="cuda")
        return r, sequential(r, ch, sr)

    # the window programs the host plan gives a sequential read, on the CPU
    t0 = time.perf_counter()
    planned = planned_stream_programs(blob, ch, sr)
    plan_s = time.perf_counter() - t0

    # the main path, counted: one sequential pass, its window programs
    # recorded
    runs = []
    zero_launches()
    with program_runs(runs):
        r, pcm = read()
    launches = op.launches
    path_launches("streaming")
    pipe = r._stream_decoder._pipeline
    check(isinstance(pipe, TorchPipeline),
          f"streaming pipeline {type(pipe).__name__}, not TorchPipeline")
    check(pipe.device_windows > 0, "no streaming window reached the card")
    check(launches > 0, "the streaming reads launched the kernel no time")
    check(len(pcm) == len(ref) == samples * ch,
          f"streamed {len(pcm)} samples, plain path {len(ref)}")
    check(bool(np.isfinite(pcm).all()), "streaming: non-finite samples")
    d = float(np.abs(pcm - ref).max())
    check(d <= tol, f"streaming vs plain path max|d| {d} > {tol}")
    counts = programs.new_counts()
    for x in runs:
        programs.count(counts, x[6])
    check(pipe.programs == counts,
          f"streaming programs {pipe.programs}, recorded {counts}")
    passes = [[x[0][1:] for x in runs]]

    plain_r = nvt.VorbisReader(blob, device="cpu")
    want = {}
    for target in SEEK_TARGETS:
        plain_r.sample_position = target
        want[target] = np.zeros(AFTER_SEEK * ch, np.float32)
        check(plain_r.read_samples(want[target]) == AFTER_SEEK * ch,
              f"plain path seek {target}: short read")
        at = (target + SEEK_READ_ALL_OFFSET.get(target, 0)) * ch
        d_all = float(np.abs(want[target] - ref[at : at + len(want[target])]
                             ).max())
        check(d_all <= tol, f"plain path seek {target} vs its read_all: "
                            f"max|d| {d_all} > {tol}")
    plain_r.dispose()
    seek_d = 0.0
    buf = np.zeros(AFTER_SEEK * ch, np.float32)
    t0 = time.perf_counter()
    for _ in range(SEEK_ROUNDS):
        for target in SEEK_TARGETS:
            r.sample_position = target
            n = r.read_samples(buf)
            check(n == len(buf), f"seek {target}: read {n} samples")
            check(r.sample_position == target + AFTER_SEEK,
                  f"seek {target}: position {r.sample_position}")
            seek_d = max(seek_d, float(np.abs(buf - want[target]).max()))
    seek_wall = time.perf_counter() - t0
    check(seek_d <= tol, f"seek reads vs plain path max|d| {seek_d} > {tol}")
    windows = pipe.device_windows
    r.dispose()

    # two more recorded passes: the second captures the window programs
    # the first ran eagerly, the third replays them; each pass's programs
    # are the host plan's, and its PCM the first pass's
    for _ in range(2):
        n0 = len(runs)
        with program_runs(runs):
            r, again = read()
        r.dispose()
        check(np.array_equal(again, pcm),
              "a streaming pass through the graphs differs from the first")
        passes.append([x[0][1:] for x in runs[n0:]])
    for i, keys in enumerate(passes):
        check(keys == planned,
              f"streaming pass {i}: {len(keys)} window programs of "
              f"{len(set(keys))} keys, the host plan on the CPU "
              f"{len(planned)} of {len(set(planned))}")
    line = check_programs("streaming", runs, smi)
    check(line["captured"] > 0 and line["replayed"] > 0,
          f"streaming: {line['captured']} captured, {line['replayed']} "
          "replayed")
    emit({"phase": "programs_plan", "path": "streaming",
          "windows": len(planned), "cfgs": len(set(planned)),
          "seconds": plan_s, "equal_to_card": True})
    del runs, passes

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        read()[0].dispose()
        walls.append(time.perf_counter() - t0)
    emit({"phase": "streaming", "stream": name, "audio_seconds": samples / sr,
          "launches": launches, "device_windows": windows,
          "max_abs_diff": d, "seek_max_abs_diff": seek_d, "tol": tol,
          "seconds": walls,
          "x_realtime": samples / sr / statistics.median(walls),
          "seeks": SEEK_ROUNDS * len(SEEK_TARGETS),
          "seeks_per_s": SEEK_ROUNDS * len(SEEK_TARGETS) / seek_wall,
          "card": smi})
    return launches


def mesh_devices(k):
    """``k`` cards for a mesh: the visible cards in turn, repeated when
    there are fewer than ``k``."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(k)]


def sharded_inputs(seed=0):
    """``make_sharded_synth``'s eight arguments at ``SHARDED_SHAPE``, numpy:
    coupled channels, six used posts, per-frame tables, the spectrum scaled
    so that |pcm| is about 1."""
    from nvorbis_tpu_torch.codec.mode import calc_window
    from nvorbis_tpu_torch.synth.device import _XS_PAD

    B, C, n, P = SHARDED_SHAPE
    n2, W = n // 2, 4
    rng = np.random.default_rng(seed)
    residue = (rng.standard_normal((B, C, n2))
               * np.sqrt(4.0 / n)).astype(np.float32)
    xs = np.full((B, C, P), _XS_PAD, dtype=np.int32)
    xs[:, :, :6] = np.array([0, 64, 128, 256, 700, n2], dtype=np.int32)
    ys = rng.integers(0, 256, size=(B, C, P)).astype(np.int32)
    used = xs < _XS_PAD
    has_floor = rng.random((B, C)) < 0.9
    widx = rng.integers(0, W, size=B).astype(np.int32)
    windows = (np.stack([np.stack([calc_window(n, n, n)] * W)] * B)
               * rng.random((B, W, 1)).astype(np.float32))
    return (residue, ys, used, has_floor, widx, xs, windows,
            imdct_basis(n))


def mesh_phase(op, smi, fleet, batch_outs):
    import nvorbis_tpu_torch as nvt
    from nvorbis_tpu_torch.engine import programs
    from nvorbis_tpu_torch.parallel.sharded import build_mesh

    idx = []
    for name, count in MESH_SOURCES.items():
        idx += [i for i, f in enumerate(fleet) if f[0] == name][:count]
    picked = [fleet[i] for i in idx]
    blobs = [f[2] for f in picked]
    audio_s = sum(f[3] / f[4] for f in picked)

    def free():
        return nvt.BatchDecoder(blobs, device="cuda").decode_all()

    def meshed(k):
        mesh = build_mesh(k, model_parallel=1, devices=mesh_devices(k))
        bd = nvt.BatchDecoder(blobs, mesh=mesh)
        return bd.decode_all(), bd

    # warm-up, and the mesh-free decode every extent must equal, itself
    # held to the batch phase's checked decode of the same sources
    ref = free()
    free_d = 0.0
    for i, pcm in zip(idx, ref):
        want = batch_outs[i]
        tol = 5e-6 * max(1.0, float(np.abs(want).max()))
        check(len(pcm) == len(want) > 0,
              f"mesh-free stream {i}: length {len(pcm)}, batch {len(want)}")
        d = float(np.abs(pcm - want).max())
        check(d <= tol, f"mesh-free stream {i} vs the batch phase: max|d| "
                        f"{d} > {tol}")
        free_d = max(free_d, d)
    # every shard's kernel calls held to the twin on the shard's own inputs
    # (its group tables, its row counts), all of them seen
    twin_log = []
    logs = {"floor_sym": [], "overlap_add": []}
    mods = kernel_modules()
    for k in MESH_EXTENTS:
        before, calls = op.launches, len(twin_log)
        seen = {name: (mods[name].launches, len(log))
                for name, log in logs.items()}
        with twin_checked(op, twin_log, logs):
            meshed(k)
        check(op.launches - before
              == sum(1 for e in twin_log[calls:] if e[3] > 0) > 0,
              f"extent {k}: {op.launches - before} launches, "
              f"{len(twin_log) - calls} twin-checked calls")
        # a call launches unless its output is empty
        for name, log in logs.items():
            n0, c0 = seen[name]
            n = mods[name].launches - n0
            check(n == sum(1 for e in log[c0:] if e[1] > 0) > 0,
                  f"extent {k}: {n} {name} launches, {len(log) - c0} "
                  "twin-checked calls")
    torch.cuda.synchronize()

    # the main path, counted: one decode per extent, each chunk finished
    # on the fetch worker
    launches = 0
    by_extent = {}
    names = []
    for k in MESH_EXTENTS:
        runs = []
        zero_launches()
        with finish_threads(names), program_runs(runs):
            outs, bd = meshed(k)
        n = op.launches
        path_launches("mesh")
        shards = list(bd.shard_launches)
        check(n > 0 and sum(shards) == n,
              f"extent {k}: {n} launches, per shard {shards}")
        check(len(shards) == k and all(s > 0 for s in shards),
              f"extent {k}: a shard launched the kernel no time: {shards}")
        check(bd.routes == ["device"] * len(blobs),
              f"extent {k}: routes {sorted(set(bd.routes))}, not all device")
        for i, (pcm, want) in enumerate(zip(outs, ref)):
            check(len(pcm) == len(want) > 0 and np.array_equal(pcm, want),
                  f"extent {k}: stream {i} differs from the mesh-free decode")
        # a second decode over a new mesh of the same cards: the same
        # program keys, so its programs capture or replay the first's
        n0 = len(runs)
        with program_runs(runs):
            again, bd2 = meshed(k)
        check([x[0] for x in runs[n0:]] == [x[0] for x in runs[:n0]],
              f"extent {k}: a new mesh of the same cards ran other programs")
        check(list(bd2.shard_launches) == shards,
              f"extent {k}: launches per shard {bd2.shard_launches} through "
              f"the graphs, {shards} before")
        for i, (pcm, want) in enumerate(zip(again, ref)):
            check(np.array_equal(pcm, want),
                  f"extent {k}: stream {i} through the graphs differs from "
                  "the mesh-free decode")
        lines = {}
        for kind in ("mesh_shard", "mesh_out"):
            lines[kind] = check_programs(
                "mesh", [x for x in runs if x[0][1] == kind], smi, extent=k,
                kind=kind)
            check(lines[kind]["captured"] > 0 and lines[kind]["replayed"] > 0,
                  f"extent {k}: {kind} {lines[kind]['captured']} captured, "
                  f"{lines[kind]['replayed']} replayed")
        by_extent[k] = {"launches": n, "shard_launches": shards,
                        "devices": [str(d) for d in mesh_devices(k)],
                        "programs": {kind: {m: line[m] for m in
                                            ("cfgs", *programs.MODES)}
                                     for kind, line in lines.items()}}
        launches += n
        del outs, again, runs
    threads_seen = check_finish_threads(names, "mesh")

    times = {"free": []}
    times.update({k: [] for k in MESH_EXTENTS})
    order = ["free", *MESH_EXTENTS]
    for rep in range(MESH_REPEATS):
        for k in (order if rep % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            if k == "free":
                free()
            else:
                meshed(k)
            times[k].append(time.perf_counter() - t0)

    med = {k: statistics.median(v) for k, v in times.items()}
    emit({"phase": "mesh", "sources": len(blobs), "audio_seconds": audio_s,
          "cards": torch.cuda.device_count(), "launches": launches,
          "by_extent": by_extent, "bit_equal_to_mesh_free": True,
          "finish_threads": threads_seen,
          "mesh_free_max_abs_diff_vs_batch": free_d,
          "twin_checked": sorted({e[:4] for e in twin_log}),
          "twin_max_abs_err": max(e[4] for e in twin_log),
          "floor_sym_twin_checked": sorted(set(logs["floor_sym"])),
          "ola_twin_checked": sorted(set(logs["overlap_add"])),
          "seconds": {str(k): v for k, v in times.items()},
          "x_realtime": {str(k): audio_s / v for k, v in med.items()},
          "card": smi})
    return launches, max(e[4] for e in twin_log)


def sync_ms(fn):
    """Wall milliseconds of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def sharded_phase(op, smi):
    """``make_sharded_synth`` (see phase 8 of the module docstring); emits
    one line per grid and a summary."""
    from nvorbis_tpu_torch.engine import programs
    from nvorbis_tpu_torch.ops import floor as fop
    from nvorbis_tpu_torch.parallel.sharded import (
        KINDS,
        build_mesh,
        make_sharded_synth,
    )

    args = sharded_inputs()
    other = sharded_inputs(seed=1)
    coupling = ((0, 1),)
    before = op.launches
    mods = kernel_modules()
    others = {k: mods[k].launches for k in ("floor_sym", "residue_rebuild",
                                            "overlap_add")}
    by_grid = {}
    for s, f in SHARDED_GRIDS:
        grid = f"{s}x{f}"
        card_mesh = build_mesh(s * f, model_parallel=f,
                               devices=mesh_devices(s * f))
        cpu_mesh = build_mesh(s * f, model_parallel=f,
                              devices=["cpu"] * (s * f))
        want = make_sharded_synth(cpu_mesh, coupling)(*args)
        synth = make_sharded_synth(card_mesh, coupling)
        runs = {"sharded_floor": s, "sharded_part": s * f, "sharded_out": s}
        outs = []
        floor_before = fop.launches
        for mode in programs.MODES:
            seen = {k: dict(v) for k, v in synth.programs.items()}
            outs.append(synth(*args))
            for kind, n in runs.items():
                check(synth.programs[kind][mode] - seen[kind][mode] == n,
                      f"grid {grid}: the {mode} call ran {kind} "
                      f"{synth.programs[kind]} (from {seen[kind]})")
        # each call launches the floor kernel once per shard, a replay
        # through the launch its capture recorded
        n_floor = fop.launches - floor_before
        check(n_floor == len(programs.MODES) * s,
              f"grid {grid}: {n_floor} floor launches in "
              f"{len(programs.MODES)} calls over {s} shards")
        add_launches("floor_couple", "sharded", n_floor)
        got = outs[0]
        check(got.device.type == "cuda", f"grid {grid}: output on {got.device}")
        check(tuple(got.shape) == tuple(want.shape) == SHARDED_SHAPE[:3],
              f"grid {grid}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"grid {grid}: non-finite")
        for mode, out in zip(programs.MODES[1:], outs[1:]):
            check(torch.equal(out, got),
                  f"grid {grid}: the {mode} call differs from the eager one")
        d = float((got.cpu() - want).abs().max())
        check(d <= SHARDED_TOL,
              f"sharded synthesis {grid}: card vs CPU max|d| {d}")
        # another seed through the graphs, and a new Mesh of the same cards
        again = make_sharded_synth(build_mesh(
            s * f, model_parallel=f, devices=mesh_devices(s * f)), coupling)
        d_other = float((again(*other).cpu() - make_sharded_synth(
            cpu_mesh, coupling)(*other)).abs().max())
        check(d_other <= SHARDED_TOL,
              f"sharded synthesis {grid}, seed 1: card vs CPU max|d| "
              f"{d_other}")
        check(all(c["eager"] == c["captured"] == 0 and c["replayed"] > 0
                  for c in again.programs.values()),
              f"grid {grid}: a new Mesh of the same cards ran "
              f"{again.programs}")
        names = tuple(tuple(str(x) for x in row)
                      for row in card_mesh.devices)
        captures = {kind: [] for kind in KINDS}
        for e in programs.CACHE.entries():
            if e.key[1] in KINDS and names in e.key[2] and e.graph is not None:
                captures[e.key[1]].append({"capture_ms": e.capture_ms,
                                           "mib": e.nbytes / 2**20})
        check(all(len(captures[k]) == n for k, n in runs.items()),
              f"grid {grid}: graphs {({k: len(v) for k, v in captures.items()})}"
              f", runs {runs}")
        # an eager call (a cache that never captures) against a replay,
        # alternating
        eager_cache = programs.ProgramCache(capture_at=None)
        cache = programs.CACHE
        eager_fn = make_sharded_synth(card_mesh, coupling)
        times = {"eager": [], "replayed": []}
        for _ in range(SHARDED_REPS):
            programs.CACHE = eager_cache
            try:
                times["eager"].append(sync_ms(lambda: eager_fn(*args)))
            finally:
                programs.CACHE = cache
            times["replayed"].append(sync_ms(lambda: synth(*args)))
        check(all(c["captured"] == c["replayed"] == 0
                  for c in eager_fn.programs.values()),
              f"grid {grid}: the eager calls ran {eager_fn.programs}")
        med = {k: statistics.median(v) for k, v in times.items()}
        line = {"phase": "sharded", "grid": grid, "shape": SHARDED_SHAPE,
                "programs": synth.programs, "captures": captures,
                "eager_ms": med["eager"], "replayed_ms": med["replayed"],
                "eager_over_replayed": med["eager"] / med["replayed"],
                "spread_ms": {k: [min(v), max(v)] for k, v in times.items()},
                "floor_launches": n_floor,
                "replays_bit_equal": True, "max_abs_diff_vs_cpu": d,
                "max_abs_diff_vs_cpu_seed1": d_other, "tol": SHARDED_TOL,
                "card": smi}
        emit(line)
        by_grid[grid] = line
        del outs, got, again, eager_fn
    check(op.launches == before,
          f"the sharded step launched the IMDCT kernel "
          f"{op.launches - before} times")
    # the sharded step takes dense spectra and laps nothing
    for k, n in others.items():
        add_launches(k, "sharded", mods[k].launches - n)
    emit({"phase": "sharded_summary", "grids": list(by_grid),
          "eager_ms": {g: v["eager_ms"] for g, v in by_grid.items()},
          "replayed_ms": {g: v["replayed_ms"] for g, v in by_grid.items()},
          "max_abs_diff_vs_cpu": max(max(v["max_abs_diff_vs_cpu"],
                                         v["max_abs_diff_vs_cpu_seed1"])
                                     for v in by_grid.values()),
          "card": smi})


def spectra_check():
    """``synth_spectra`` (the kernel with a one-row window table of ones)
    on the card against the same call on the CPU (the kernel's twin) at
    every n of ``SPECTRA_NS``, held to the kernel phase's tolerance."""
    from nvorbis_tpu_torch.synth.device import (
        _XS_PAD,
        floor1_bin_map,
        synth_spectra,
    )

    B, C, P = SPECTRA_SHAPE
    worst = {}
    for n in SPECTRA_NS:
        n2 = n // 2
        rng = np.random.default_rng(n)
        xs = np.full((C, P), _XS_PAD, dtype=np.int32)
        xs[:, :6] = [0, n2 // 16, n2 // 8, n2 // 4, n2 * 11 // 16, n2]
        args = [(rng.standard_normal((B, C, n2))
                 * np.sqrt(4.0 / n)).astype(np.float32),
                rng.integers(0, 256, size=(B, C, P)).astype(np.int32),
                np.broadcast_to(xs < _XS_PAD, (B, C, P)).copy(),
                rng.random((B, C)) < 0.9, xs]
        sl = floor1_bin_map(xs, n2)
        out = {}
        for dev in ("cuda", "cpu"):
            t = [torch.as_tensor(a, device=dev) for a in args]
            out[dev] = synth_spectra(*t, None, ((0, 1),),
                                     torch.as_tensor(sl, device=dev))
        got, want = out["cuda"].cpu(), out["cpu"]
        check(got.shape == want.shape == (B, C, n),
              f"synth_spectra n={n}: shape {tuple(got.shape)}")
        err = (got - want).abs()
        check(bool((err <= 1e-4 + 2e-4 * want.abs()).all()),
              f"synth_spectra n={n}: card vs CPU max|d| {float(err.max())}")
        worst[n] = float(err.max())
    emit({"phase": "synth_spectra", "shape": SPECTRA_SHAPE,
          "max_abs_err": worst})
    return max(worst.values())


def within_plain(what, pcm, ref):
    """``max|pcm - ref|``; fails unless the lengths are equal and it lies
    within ``5e-6 * max(1, max|ref|)``."""
    check(len(pcm) == len(ref) > 0,
          f"{what}: length {len(pcm)}, plain path {len(ref)}")
    check(bool(np.isfinite(pcm).all()), f"{what}: non-finite samples")
    tol = 5e-6 * max(1.0, float(np.abs(ref).max()))
    d = float(np.abs(pcm - ref).max())
    check(d <= tol, f"{what}: max|d| {d} > {tol}")
    return d


def cli_phase(op, smi, plain, tmp):
    """``python -m nvorbis_tpu_torch`` on the decode phase's streams: in
    process through ``main`` (plain and ``--forward-only``, counted), its
    WAV read back and held to the plain path's ``read_all``, then once as a
    subprocess, whose WAV must equal the in-process one byte for byte."""
    import subprocess

    from nvorbis_tpu_torch.__main__ import main as cli
    from nvorbis_tpu_torch.wave_io import read_wav

    def wav(path):
        with open(path, "rb") as f:
            return f.read()

    launches = 0
    rows = []
    runs = []
    for name, blob, samples, ref, ch, sr in plain:
        src = os.path.join(tmp, f"{name}.ogg")
        with open(src, "wb") as f:
            f.write(blob)
        for extra in ((), ("--forward-only",)):
            out = os.path.join(tmp, f"{name}{''.join(extra)}.wav")
            zero_launches()
            t0 = time.perf_counter()
            with program_runs(runs):
                check(cli([src, out, "--device", "cuda", *extra]) == 0,
                      f"cli {name} {extra}: exit code")
            wall = time.perf_counter() - t0
            n = op.launches
            path_launches("cli")
            check(n > 0, f"cli {name} {extra}: launched the kernel no time")
            launches += n
            pcm, rate, channels = read_wav(out)
            check((rate, channels) == (sr, ch),
                  f"cli {name}: WAV {rate} Hz x {channels}")
            d = within_plain(f"cli {name} {extra}", pcm, ref)
            rows.append({"stream": name, "forward_only": bool(extra),
                         "launches": n, "max_abs_diff": d, "seconds": wall,
                         "x_realtime": samples / sr / wall})
    check_programs("cli", runs, smi)
    del runs
    name = plain[0][0]
    out = os.path.join(tmp, f"{name}.subprocess.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "nvorbis_tpu_torch",
         os.path.join(tmp, f"{name}.ogg"), out, "--device", "cuda"],
        capture_output=True, text=True, timeout=600, cwd=REPO_DIR)
    check(proc.returncode == 0,
          f"python -m nvorbis_tpu_torch exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check(wav(out) == wav(os.path.join(tmp, f"{name}.wav")),
          "the subprocess's WAV differs from the in-process one")
    emit({"phase": "cli", "runs": rows, "launches": launches,
          "subprocess": proc.stdout.strip(), "subprocess_wav_equal": True,
          "card": smi})
    return launches


def containers_phase(op, smi, plain, tmp):
    """A chained file (the decode phase's stereo, 5.1 and stereo streams as
    three links of distinct serials) and a multiplexed one (the stereo and
    5.1 links interleaved) through ``VorbisReader(path, device="cuda")``:
    every link found, ``switch_streams`` reporting the parameter changes,
    each link's ``read_all`` launching the kernel and held to its plain
    output; one link's decode with every kernel call held to the twin."""
    import nvorbis_tpu_torch as nvt
    from nvorbis_tpu_torch.testgen.ogg_writer import interleave_streams

    (s_name, _, _, s_ref, _, s_sr), (m_name, _, _, m_ref, _, m_sr) = plain
    kws = {name: (kw, packets, seed) for name, kw, packets, seed in STREAMS}
    links = []
    for name, serial in zip((s_name, m_name, s_name), CHAIN_SERIALS):
        kw, packets, seed = kws[name]
        links.append(vorbis_stream(seed, packets, serial=serial, **kw)[0])
    chain = os.path.join(tmp, "chain.ogg")
    with open(chain, "wb") as f:
        f.write(b"".join(links))
    mux = os.path.join(tmp, "mux.ogg")
    with open(mux, "wb") as f:
        f.write(interleave_streams(links[0], links[1]))
    want = {CHAIN_SERIALS[0]: (s_name, s_ref, s_sr),
            CHAIN_SERIALS[1]: (m_name, m_ref, m_sr),
            CHAIN_SERIALS[2]: (s_name, s_ref, s_sr)}

    def open_all(path, count):
        r = nvt.VorbisReader(path, device="cuda")
        while len(r.streams) < count and r.find_next_stream():
            pass
        check(len(r.streams) == count,
              f"{os.path.basename(path)}: {len(r.streams)} streams found, "
              f"not {count}")
        return r, [d._packet_provider.stream_serial for d in r.streams]

    launches = 0
    rows = []
    runs = []
    for path, count in ((chain, 3), (mux, 2)):
        kind = os.path.basename(path).split(".")[0]
        r, serials = open_all(path, count)
        check(sorted(serials) == sorted(CHAIN_SERIALS[:count]),
              f"{kind}: serials {serials}")
        if kind == "chain":
            check(serials == list(CHAIN_SERIALS), f"chain: order {serials}")
        for i, serial in enumerate(serials):
            name, ref, sr = want[serial]
            if i:
                changed = r.switch_streams(i)
                check(changed is (want[serials[i - 1]][0] != name),
                      f"{kind}: switch_streams({i}) returned {changed}")
            zero_launches()
            t0 = time.perf_counter()
            with program_runs(runs):
                pcm = r.read_all()
            wall = time.perf_counter() - t0
            n = op.launches
            path_launches("containers")
            check(n > 0, f"{kind} link {i}: launched the kernel no time")
            launches += n
            d = within_plain(f"{kind} link {i} ({name})", pcm, ref)
            rows.append({"file": kind, "link": i, "serial": serial,
                         "stream": name, "launches": n, "max_abs_diff": d,
                         "seconds": wall,
                         "x_realtime": len(ref) / r.channels / sr / wall})
        r.dispose()
    check_programs("containers", runs, smi)
    del runs
    # the 5.1 link again, every kernel call held to the twin
    r, _ = open_all(chain, 2)
    r.switch_streams(1)
    mods = kernel_modules()
    before = {name: m.launches for name, m in mods.items()}
    logs = {"floor_sym": [], "overlap_add": []}
    with twin_checked(op, [], logs) as twin_log:
        within_plain("chain link 1, twin-checked", r.read_all(), m_ref)
    r.dispose()
    logs["imdct_window"] = twin_log
    for name, log in logs.items():
        n = mods[name].launches - before[name]
        check(n == len(log) > 0,
              f"chain link 1: {n} {name} launches, {len(log)} twin-checked "
              "calls")
    twin_worst = max(e[4] for e in twin_log)
    emit({"phase": "containers", "links": rows, "launches": launches,
          "twin_checked_calls": len(twin_log), "twin_max_abs_err": twin_worst,
          "twin_checked_calls_by_kernel": {k: len(v) for k, v in logs.items()},
          "card": smi})
    return launches, twin_worst


def sweep_default(ratios, share=SWEEP_SHARE):
    """The shortest swept length ``d`` (seconds) at which every shape of
    the sweep's ``{shape: {seconds: card x-realtime / host engine
    x-realtime}}`` has a swept length at or above ``d`` and reaches
    ``share`` at each of them; None where no length does (the default
    then stays the JAX package's ``JAX_DEVICE_MIN_SECS``)."""
    for d in sorted({s for by_len in ratios.values() for s in by_len}):
        if all(any(s >= d for s in by_len)
               and all(v >= share for s, v in by_len.items() if s >= d)
               for by_len in ratios.values()):
            return d
    return None


def default_in_band(code, ratios):
    """``(ok, low, high)``: ``low`` and ``high`` are :func:`sweep_default`
    at ``SWEEP_SHARE`` less and plus ``SWEEP_SLACK`` (None: no length), and
    the code's default ``code`` is consistent with the sweep when it lies
    between them, no length counting as longer than every length (the JAX
    package's default then stands for it)."""
    low = sweep_default(ratios, SWEEP_SHARE - SWEEP_SLACK)
    high = sweep_default(ratios, SWEEP_SHARE + SWEEP_SLACK)
    inf = float("inf")
    ok = ((inf if low is None else low) <= code
          <= (inf if high is None else high)) or (
        high is None and code == JAX_DEVICE_MIN_SECS)
    return ok, low, high


def sweep(smi, plain):
    """The auto phase's sweep: ``read_all`` of each decode stream's shape at
    every length of ``SWEEP_SECONDS`` (a swept stream is its nominal length
    to a few percent over) and at its full length, on the card
    (``engine="torch"``) and on the host engine.  ``SWEEP_REPEATS`` rounds,
    each timing every stream once per engine in alternating order, so that
    a drift of the machine spreads over every length alike; the median of
    each.  Returns ``{shape: {seconds: card x-realtime / host engine
    x-realtime}}``."""
    import nvorbis_tpu_torch as nvt

    def wall(blob, **kw):
        t0 = time.perf_counter()
        r = nvt.VorbisReader(blob, **kw)
        r.read_all()
        r.dispose()
        return time.perf_counter() - t0

    engines = {"card": dict(engine="torch", device="cuda"),
               "host": dict(engine="host")}
    by_name = {p[0]: p for p in plain}
    swept = []  # (shape, nominal seconds, blob, samples, rate)
    for name, kw, packets, seed in STREAMS:
        _, full, samples, _, _, sr = by_name[name]
        per_s = packets * sr / samples  # packets per second of audio
        for secs in SWEEP_SECONDS:
            # a stream's length varies with its block sizes: aim 3% long
            n = int(np.ceil(secs * per_s * 1.03)) + 1
            blob, got = vorbis_stream(seed, n, **kw)
            while got < secs * sr:
                n = int(n * 1.03) + 1
                blob, got = vorbis_stream(seed, n, **kw)
            swept.append((name, secs, blob, got, sr))
        swept.append((name, samples / sr, full, samples, sr))
    for k in engines:  # warm-up
        wall(swept[0][2], **engines[k])
    times = [{"card": [], "host": []} for _ in swept]
    for rep in range(SWEEP_REPEATS):
        for t, (_, _, blob, _, _) in zip(times, swept):
            for k in (("card", "host"), ("host", "card"))[rep % 2]:
                t[k].append(wall(blob, **engines[k]))
    ratios = defaultdict(dict)
    for t, (name, secs, _, got, sr) in zip(times, swept):
        xr = {k: got / sr / statistics.median(v) for k, v in t.items()}
        ratios[name][secs] = xr["card"] / xr["host"]
        emit({"phase": "auto_sweep", "stream": name, "seconds": secs,
              "audio_seconds": got / sr, "repeats": SWEEP_REPEATS,
              "card_x_realtime": xr["card"], "host_x_realtime": xr["host"],
              "card_over_host": ratios[name][secs],
              "card_seconds": t["card"], "host_seconds": t["host"],
              "card": smi})
    return dict(ratios)


def auto_phase(op, smi, plain):
    """``engine="auto"``: the sweep (:func:`sweep`) that sets
    ``NVT_DEVICE_MIN_SECS``'s default (:func:`sweep_default`), the code's
    default held to it (:func:`default_in_band`), then the routing on the
    card: a stream below the
    default launches nothing and equals ``engine="host"``, the stereo
    decode stream (above it) launches the kernel (counted) and equals
    ``engine="torch"``, and under ``NVT_ENGINE=host`` it launches nothing
    and equals the host engine."""
    import nvorbis_tpu_torch as nvt
    from nvorbis_tpu_torch import stream_decoder
    from nvorbis_tpu_torch.engine.batcher import HostPipeline, TorchPipeline

    def decode(blob, **kw):
        r = nvt.VorbisReader(blob, **kw)
        pcm = r.read_all()
        pipe = r._stream_decoder._pipeline
        r.dispose()
        return pcm, pipe

    saved = {k: os.environ.pop(k, None)
             for k in ("NVT_ENGINE", "NVT_DEVICE_MIN_SECS")}
    try:
        ratios = sweep(smi, plain)
        swept = sweep_default(ratios)
        code = stream_decoder.DEVICE_MIN_SECS
        ok, low, high = default_in_band(code, ratios)
        emit({"phase": "auto_default", "code": code, "share": SWEEP_SHARE,
              "swept": JAX_DEVICE_MIN_SECS if swept is None else swept,
              "slack": SWEEP_SLACK, "band": [low, high], "card": smi})
        check(ok, f"stream_decoder.DEVICE_MIN_SECS is {code}; the sweep "
                  f"gives {swept} at a share of {SWEEP_SHARE}, {low} to "
                  f"{high} within {SWEEP_SLACK} of it (None: no length)")

        # routing, at the code's default
        name, kw, packets, seed = STREAMS[0]
        _, full, samples, _, _, sr = plain[0]
        short, short_n = vorbis_stream(
            seed, max(1, int(code * packets * sr / samples / 2)), **kw)
        check(short_n < code * sr <= samples,
              f"routing streams of {short_n} and {samples} samples around "
              f"{code} s")
        host = dict(engine="host")
        routes = {}
        runs = []
        for what, blob, env, want, pipe_type in (
                ("short", short, None, host, HostPipeline),
                ("long", full, None, dict(engine="torch", device="cuda"),
                 TorchPipeline),
                ("long, NVT_ENGINE=host", full, "host", host, HostPipeline)):
            if env:
                os.environ["NVT_ENGINE"] = env
            zero_launches()
            try:
                with program_runs(runs):
                    pcm, pipe = decode(blob, engine="auto", device="cuda")
            finally:
                os.environ.pop("NVT_ENGINE", None)
            n = op.launches
            counts = {k: m.launches for k, m in kernel_modules().items()}
            check(isinstance(pipe, pipe_type),
                  f"auto, {what}: {type(pipe).__name__}")
            # the card route launches every kernel the decode paths must,
            # and no other; the host route none
            check(all((v > 0) is (pipe_type is TorchPipeline
                                  and (k == "imdct_window"
                                       or "auto" in MUST_LAUNCH[k]))
                      for k, v in counts.items()),
                  f"auto, {what}: launches {counts}")
            if pipe_type is TorchPipeline:
                path_launches("auto")
            check(np.array_equal(pcm, decode(blob, **want)[0]),
                  f"auto, {what}: not bit-equal to engine="
                  f"{want['engine']!r}")
            routes[what] = {"pipeline": type(pipe).__name__, "launches": n}
        check_programs("auto", runs, smi)
        del runs
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    emit({"phase": "auto", "default": code, "routes": routes, "card": smi})
    return routes["long"]["launches"]


def load_tool(rel):
    """The module at ``rel`` (a script of the repo outside the package)."""
    import importlib.util

    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO_DIR, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_synth_phase(op, smi, fleet):
    """The fleet's chunk program replayed on the card from a capture (see
    phase 12 of the module docstring); returns the launches of the counted
    eager pass, the twin-checked pass's worst error and the capturing
    decoder (``_capture``: each chunk's ``(cfg, flat, L_real)``)."""
    ds = load_tool(os.path.join("tools", "device_synth_torch.py"))
    blobs = [f[2] for f in fleet]
    t0 = time.perf_counter()
    bd = ds.capture(blobs)
    capture_s = time.perf_counter() - t0
    records = bd._capture
    check(bd.routes == ["device"] * len(blobs),
          f"capture routes {sorted(set(bd.routes))}, not all device")
    check(len(records) == bd.chunks > 0,
          f"{len(records)} chunks captured of {bd.chunks} dispatched")
    replay = ds.make_pass(records, "full")

    # the main path, counted: one eager replay of every chunk
    zero_launches()
    outs = replay()
    torch.cuda.synchronize()
    launches = op.launches
    counts = {k: m.launches for k, m in kernel_modules().items()}
    path_launches("device_synth")
    check(launches > 0, "the replay launched the kernel no time")
    ds.assert_bit_equal(outs, bd._capture_out, "eager replay")
    logs = {"floor_sym": [], "overlap_add": []}
    with twin_checked(op, [], logs) as twin_log:
        ds.assert_bit_equal(replay(), bd._capture_out,
                            "twin-checked replay")
    check(len(twin_log) == launches,
          f"{len(twin_log)} twin-checked calls, {launches} launches")
    for k, log in logs.items():
        check(len(log) == counts[k],
              f"{len(log)} twin-checked {k} calls, {counts[k]} launches")
    del outs
    summary = ds.replay_report(bd, ds.STAGES, reps=SYNTH_REPS,
                               passes=SYNTH_PASSES, say=lambda line: None)
    twin_worst = max(e[4] for e in twin_log)
    emit({"phase": "device_synth", "sources": len(blobs),
          "capture_seconds": capture_s, "launches": launches,
          "launches_by_kernel": counts, "twin_checked_calls": len(twin_log),
          "twin_checked_calls_by_kernel": {k: len(v)
                                           for k, v in logs.items()},
          "twin_max_abs_err": twin_worst, **summary, "card": smi})
    return launches, twin_worst, bd


def recon_phase(smi, fleet):
    """``tools/ab_recon_gathers_torch.py`` on a small fleet (see phase 13
    of the module docstring)."""
    rg = load_tool(os.path.join("tools", "ab_recon_gathers_torch.py"))
    blobs = [f[2] for f in fleet[:RECON_SOURCES]]
    bd = rg.ds.capture(blobs)
    cfg, flat = rg.symbol_chunk(bd)
    rg.check_exact(cfg, flat)
    ms = rg.measure(cfg, flat, rg.VARIANTS, say=lambda line: None)
    emit({"phase": "recon_gathers", "sources": len(blobs),
          "chunks": len(bd._capture),
          "buckets": [list(b[:3]) for b in cfg[3]],
          "widths": [list(b[7].widths) for b in cfg[3] if b[0] == "s"],
          "ms_per_iter": ms,
          "ids_gather_ms": ms["full"] - ms["noids"],
          "mega_gather_ms": ms["full"] - ms["nomega"],
          "full_over_kernel": ms["full"] / ms["kernel"],
          "exact_variants_bit_equal": list(rg.EXACT), "card": smi})


def bench_phase(smi):
    """``bench_torch.py`` at ``BENCH_ENV``'s size in a subprocess: exit 0,
    one stdout line, the card's headline; every config line error-free."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_DIR, "bench_torch.py")],
        env={**os.environ, **BENCH_ENV}, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT, cwd=REPO_DIR)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench_torch.py exit {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    out = proc.stdout.splitlines()
    check(len(out) == 1, f"bench_torch.py printed {len(out)} stdout lines")
    head = json.loads(out[0])
    check(head.get("metric") == "decode_throughput_stereo_44k1_longform_batch"
          and head.get("backend") == "cuda" and head.get("value", 0) > 0,
          f"bench_torch.py headline {out[0][:500]}")
    lines = [json.loads(ln) for ln in proc.stderr.splitlines()
             if ln.startswith("{")]
    ran = [ln.get("config") for ln in lines]
    check(ran == BENCH_ENV["NVT_BENCH_CONFIGS"].split(",")
          and not any("error" in ln for ln in lines),
          f"bench_torch.py config lines: {proc.stderr[-2000:]}")
    emit({"phase": "bench", "seconds": wall, "env": BENCH_ENV,
          "headline": head, "lines": lines, "card": smi})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "card", file=sys.stderr)
        return 2

    from nvorbis_tpu_torch import native
    from nvorbis_tpu_torch.ops import floor as fop, imdct as op
    from nvorbis_tpu_torch.ops import ola as oop, residue as rop
    from nvorbis_tpu_torch.utils.device import probe

    info = probe()
    emit({"phase": "probe", **info})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = info["nvidia_smi"]
    check(smi, "nvidia-smi did not report the card's name and power limit")

    def timed(fn):
        t = time.perf_counter()
        return fn(), time.perf_counter() - t

    # every build started together: one nvcc per kernel source, and g++
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        builds = {m.SOURCE: pool.submit(m.build)
                  for m in (op, fop, rop, oop)}
        host = pool.submit(timed, native.load)
        nvcc_s = {k: f.result() for k, f in builds.items()}
        host_lib, host_s = host.result()
    emit({"phase": "build",
          "sources": [f"nvorbis_tpu_torch/csrc/{k}" for k in nvcc_s],
          "nvcc_seconds": nvcc_s, "seconds": time.perf_counter() - t0})
    check(host_lib is not None,
          "the port's native host plane did not load (g++ build of "
          "nvorbis_tpu_torch/native/host_decode.cpp)")
    check(os.path.dirname(os.path.realpath(native.lib_path))
          == os.path.realpath(native.BUILD_DIR),
          f"host library {native.lib_path} not in {native.BUILD_DIR}")
    emit({"phase": "build_host",
          "source": "nvorbis_tpu_torch/native/host_decode.cpp",
          "library": os.path.relpath(native.lib_path), "seconds": host_s})

    worst, summary = kernel_phase(op)
    check(summary is not None, "summary shape not timed")
    floor_worst, floor_summary = floor_kernel_phase(fop, smi)
    check(floor_summary is not None, "floor summary shape not timed")
    worst = max(worst, spectra_check())
    by_path = {}
    by_path["read_all"], plain = decode_phase(op, smi)
    by_path["batch"], fleet, batch_outs, batch_twin = batch_phase(op, smi)
    by_path["dense"] = dense_phase(op, smi, fleet, batch_outs)
    by_path["streaming"] = streaming_phase(op, smi, plain[0])
    by_path["mesh"], mesh_twin = mesh_phase(op, smi, fleet, batch_outs)
    del batch_outs
    sharded_phase(op, smi)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["cli"] = cli_phase(op, smi, plain, tmp)
        by_path["containers"], chain_twin = containers_phase(op, smi, plain,
                                                             tmp)
    by_path["auto"] = auto_phase(op, smi, plain)
    by_path["device_synth"], synth_twin, capture = device_synth_phase(
        op, smi, fleet)
    residue_worst, residue_summary = residue_kernel_phase(rop, smi, capture)
    ola_worst, ola_summary = ola_kernel_phase(oop, smi, capture)
    sym_worst, sym_summary = floor_sym_kernel_phase(fop, rop, smi, capture)
    del capture
    recon_phase(smi, fleet)
    del fleet
    torch.cuda.empty_cache()
    bench_phase(smi)
    worst = max(worst, batch_twin, mesh_twin, chain_twin, synth_twin)

    loaded = sorted({k.split(".")[0] for k in sys.modules}
                    & {"jax", "jaxlib", "nvorbis_tpu"})
    check(not loaded, f"the run imported {loaded}")

    check_path_launches()

    def launched(name):
        paths = {p: n for p, n in BY_PATH[name].items() if n > 0}
        return {"launches": sum(paths.values()), "paths": list(paths),
                "launches_by_path": paths}

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "imdct_window",
        "route": "cuda",
        "source": "nvorbis_tpu_torch/csrc/imdct_window.cu",
        "replaces": "nvorbis_tpu/ops/pallas_imdct.py:99",
        "launches": sum(by_path.values()),
        "paths": [k for k, v in by_path.items() if v > 0],
        "launches_by_path": by_path,
        "max_abs_err": worst,
        "ms": summary[0],
        "plain_ms": summary[1],
        "bound_ms": summary[2],
        "bound_by": summary[3],
        "graph_ms": summary[4],
        "plain_graph_ms": summary[5],
        # no one PyTorch call computes a windowed IMDCT; the plain twin
        # (plain_ms) is the cuBLAS basis product times the window
        "library_ms": None,
        "shape": {"n": SUMMARY_SHAPE[0], "rows": SUMMARY_SHAPE[1]},
    }, {
        "name": "floor_sym",
        "route": "cuda",
        "source": "nvorbis_tpu_torch/csrc/floor_couple.cu",
        # no pallas_call: the JAX package leaves reconstruct_spectrum and
        # _floored_spectrum to XLA
        "replaces": "nvorbis_tpu/synth/residue_sym.py:255 + "
                    "nvorbis_tpu/synth/device.py:174 (XLA fusions)",
        **launched("floor_sym"),
        "max_abs_err": sym_worst,
        "ms": sym_summary[0],
        "plain_ms": sym_summary[1],
        "bound_ms": sym_summary[2],
        "bound_by": sym_summary[3],
        "graph_ms": sym_summary[4],
        "plain_graph_ms": sym_summary[5],
        # what the symbol lane ran before: the residue kernel, then the
        # dense floor kernel, as one graph on the same inputs
        "pair_graph_ms": sym_summary[6],
        # no one PyTorch call rebuilds and floors a spectrum; the plain
        # twin (plain_ms) is the two torch op chains
        "library_ms": None,
        "shape": {"form": FLOOR_SYM_SUMMARY[0], **sym_summary[7]},
    }, {
        "name": "floor_couple",
        "route": "cuda",
        "source": "nvorbis_tpu_torch/csrc/floor_couple.cu",
        # no pallas_call: the JAX package leaves _floored_spectrum to XLA
        "replaces": "nvorbis_tpu/synth/device.py:174 (XLA fusion)",
        **launched("floor_couple"),
        "max_abs_err": floor_worst,
        "ms": floor_summary[0],
        "plain_ms": floor_summary[1],
        "bound_ms": floor_summary[2],
        "bound_by": floor_summary[3],
        "graph_ms": floor_summary[4],
        "plain_graph_ms": floor_summary[5],
        # no one PyTorch call computes coupling and the floor render; the
        # plain twin (plain_ms) is the torch op chain
        "library_ms": None,
        "shape": dict(zip(("form", "n2", "channels", "frames", "tables"),
                          FLOOR_SUMMARY[:5])),
    }, {
        "name": "residue_rebuild",
        "route": "cuda",
        "source": "nvorbis_tpu_torch/csrc/residue_rebuild.cu",
        # no pallas_call: the JAX package leaves reconstruct_spectrum to XLA
        "replaces": "nvorbis_tpu/synth/residue_sym.py:255 (XLA fusion)",
        **launched("residue_rebuild"),
        "max_abs_err": residue_worst,
        "ms": residue_summary[0],
        "plain_ms": residue_summary[1],
        "bound_ms": residue_summary[2],
        "bound_by": residue_summary[3],
        "graph_ms": residue_summary[4],
        "plain_graph_ms": residue_summary[5],
        # no one PyTorch call rebuilds a spectrum from VQ symbols; the plain
        # twin (plain_ms) is the torch op chain of gathers and adds
        "library_ms": None,
        "shape": {"form": RESIDUE_SUMMARY[0], **residue_summary[6]},
    }, {
        "name": "overlap_add",
        "route": "cuda",
        "source": "nvorbis_tpu_torch/csrc/overlap_add.cu",
        # no pallas_call: the JAX package's chunk programs leave the
        # overlap-add to XLA
        "replaces": "nvorbis_tpu/engine/bulk.py:114-122, "
                    "nvorbis_tpu/parallel/batch.py:118-155 (XLA fusion)",
        **launched("overlap_add"),
        "max_abs_err": ola_worst,
        "ms": ola_summary[0],
        "plain_ms": ola_summary[1],
        "bound_ms": ola_summary[2],
        "bound_by": ola_summary[3],
        "graph_ms": ola_summary[4],
        "plain_graph_ms": ola_summary[5],
        # no one PyTorch call laps rows by a segment table (index_add_
        # would need the index tensors the twin builds); the plain twin
        # (plain_ms) is the searchsorted and gather chain
        "library_ms": None,
        "shape": {"form": OLA_SUMMARY[0], **ola_summary[6]},
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
