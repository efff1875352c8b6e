"""Streams of any length from the committed pool of libvorbis encodes.

The pool (``vorbench/pool/<config>/*.ogg``, written by ``python -m
vorbench.corpus``) holds a few distinct encodes of one configuration.  From
each, :func:`segments` keeps the run of audio packets that starts after a
long block and ends before one, so that any two runs can follow each other:
at every seam a long block with its next-window flag set meets a long block
with its previous-window flag set, as inside an encode.  :func:`assemble`
writes a stream of a given length from the runs, in an order of its own,
with the configuration's three headers and libogg's paging (a page closes
once its body reaches 4096 bytes, or at 255 lacing values).  The packets are
the encoder's own; only the pages and their granules are new.
"""

import os
import zlib

import numpy as np

from vorbench.reference.vorbis import Bits, Stream, ilog, ogg_packets

HERE = os.path.dirname(os.path.abspath(__file__))
POOL_DIR = os.path.join(HERE, "pool")

# each byte with its bits reversed: Ogg's CRC (polynomial 0x04C11DB7, MSB
# first, no reflection, init 0) is zlib's reflected CRC-32 over reversed
# bytes, reversed
_REV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def ogg_crc(data):
    raw = zlib.crc32(data.translate(_REV), 0xFFFFFFFF) ^ 0xFFFFFFFF
    return int(f"{raw:032b}"[::-1], 2)


def pool_files(config):
    root = os.path.join(POOL_DIR, config["name"])
    return sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.endswith(".ogg"))


def _flags(stream, packet):
    """(long, previous long, next long) of one audio packet."""
    b = Bits(packet[:4])
    b.read(1)
    flag = stream.modes[b.read(ilog(len(stream.modes) - 1))][0]
    if not flag:
        return False, False, False
    return True, bool(b.read(1)), bool(b.read(1))


def segments(config):
    """``(headers, runs)``: the pool's three header packets (one setup for
    the whole pool) and, per encode, its run of joinable audio packets as
    ``(packets, block sizes)``."""
    headers = st = None
    runs = []
    for path in pool_files(config):
        with open(path, "rb") as f:
            data = f.read()
        packets, _ = ogg_packets(data)
        if headers is None:
            headers = packets[:3]
            st = Stream(data)  # the pool's one setup
        elif packets[:3] != headers:
            raise ValueError(f"{path}: headers differ from the pool's")
        audio = packets[3:]
        flags = [_flags(st, p) for p in audio]
        joinable = [i for i in range(1, len(flags))
                    if flags[i - 1][0] and flags[i][0] and flags[i][1]]
        a, b = joinable[0], joinable[-1]
        sizes = [st.block[f[0]] for f in flags[a:b]]
        runs.append((audio[a:b], sizes))
    return headers, runs


def assemble(headers, runs, samples, order, serial):
    """One stream of ``samples`` samples (per channel): the runs in
    ``order``, over again as needed, cut after the first packet that
    reaches ``samples``.  Returns ``(ogg bytes, audio packets, block
    sizes)``."""
    packets, sizes = [], []
    total = 0
    prev = 0
    k = 0
    while total < samples:
        run_packets, run_sizes = runs[order[k % len(order)]]
        k += 1
        for p, n in zip(run_packets, run_sizes):
            total += (prev + n) // 4 if prev else 0
            prev = n
            packets.append(p)
            sizes.append(n)
            if total >= samples:
                break
    return write(headers, packets, sizes, serial), packets, sizes


def write(headers, audio, sizes, serial):
    """An Ogg Vorbis stream of ``headers`` and ``audio`` (block sizes
    ``sizes``): the identification header alone on the first page, the
    comment and setup headers on the next, then the audio packets paged as
    libogg does, each page's granule the samples returned through its last
    complete packet."""
    pages = []  # (lacing, body parts, granule, continued)
    pages.append(([*_lacing(headers[0])], [headers[0]], 0, False))
    pages.append(([*_lacing(headers[1]), *_lacing(headers[2])],
                  [headers[1], headers[2]], 0, False))
    lac, body, blen, gran, cont = [], [], 0, -1, False
    done = 0
    prev = 0
    for p, n in zip(audio, sizes):
        done += (prev + n) // 4 if prev else 0
        prev = n
        vals = _lacing(p)
        at = 0
        for j, v in enumerate(vals):
            lac.append(v)
            body.append(p[at:at + v])
            at += v
            blen += v
            last = j == len(vals) - 1
            if last:
                gran = done
            if len(lac) == 255:
                pages.append((lac, body, gran, cont))
                lac, body, blen, gran, cont = [], [], 0, -1, not last
        if blen >= 4096:
            pages.append((lac, body, gran, cont))
            lac, body, blen, gran, cont = [], [], 0, -1, False
    if lac:
        pages.append((lac, body, gran, cont))
    out = []
    for seq, (lac, body, gran, cont) in enumerate(pages):
        htype = (1 if cont else 0) | (2 if seq == 0 else 0) | \
            (4 if seq == len(pages) - 1 else 0)
        head = bytearray(b"OggS\x00" + bytes([htype])
                         + gran.to_bytes(8, "little", signed=True)
                         + serial.to_bytes(4, "little")
                         + seq.to_bytes(4, "little") + bytes(4)
                         + bytes([len(lac)]) + bytes(lac))
        payload = b"".join(body)
        head[22:26] = ogg_crc(bytes(head) + payload).to_bytes(4, "little")
        out.append(bytes(head))
        out.append(payload)
    return b"".join(out)


def _lacing(packet):
    return [255] * (len(packet) // 255) + [len(packet) % 255]


def stream_lengths(traffic, rate):
    """Samples (per channel) of each stream of a job: the traffic's
    ``seconds`` ([low, high], or one number) drawn from its ``lengths_seed``,
    the same for every ``--seed``."""
    secs = traffic["seconds"]
    lo, hi = secs if isinstance(secs, list) else (secs, secs)
    rng = np.random.default_rng([traffic["lengths_seed"], 0x6C656E])
    return [int(round(s * rate))
            for s in rng.uniform(lo, hi, size=traffic["streams"])]
