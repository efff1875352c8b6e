"""A plain NumPy decoder of Vorbis I in Ogg: the benchmark's reference.

It follows the Vorbis I specification (Xiph.Org, 2020) section by section,
in float64, and shares no code or table with the program under test: Ogg
pages (RFC 3533), the three headers (spec 4.2), codebooks with their
codeword assignment and VQ lookup (3.2), floor 1 (7), residues 0, 1 and 2
(8), mapping 0 with inverse coupling (4.3.5), the IMDCT as a product with a
cosine basis (4.3.6), the windows (4.3.1) and the overlap-add (4.3.8).
Floor 0 is not implemented: libvorbis has not written it since 2001.

:class:`Stream` parses a stream's pages and headers once; its
:meth:`Stream.decode` decodes any run of audio packets from the packet
before it, since a Vorbis packet depends only on its predecessor's window.
That is how the benchmark checks a sample of a long decode in little time.
``imdct="tf32"`` computes the IMDCT with both operands rounded to TF32 (10
mantissa bits) and float32 sums: the control that the comparison must
reject.
"""

import numpy as np

# -- Ogg (RFC 3533) -----------------------------------------------------------


def ogg_pages(data):
    """Yield ``(header_type, granule, serial, sequence, lacing, body)`` of
    every page of ``data``, in order; CRCs are not checked."""
    mv = memoryview(data)
    pos = 0
    end = len(data)
    while pos + 27 <= end:
        if mv[pos:pos + 4] != b"OggS":
            nxt = bytes(mv[pos + 1:]).find(b"OggS")
            if nxt < 0:
                return
            pos += 1 + nxt
            continue
        htype = mv[pos + 5]
        granule = int.from_bytes(mv[pos + 6:pos + 14], "little", signed=True)
        serial = int.from_bytes(mv[pos + 14:pos + 18], "little")
        seq = int.from_bytes(mv[pos + 18:pos + 22], "little")
        nseg = mv[pos + 26]
        lacing = bytes(mv[pos + 27:pos + 27 + nseg])
        body_at = pos + 27 + nseg
        body_len = sum(lacing)
        yield htype, granule, serial, seq, lacing, bytes(
            mv[body_at:body_at + body_len])
        pos = body_at + body_len


def ogg_packets(data):
    """The packets of the first logical stream of ``data`` and the granule
    of its last page: ``(packets, last_granule)``."""
    packets = []
    part = []
    serial0 = None
    last_granule = -1
    for htype, granule, serial, _, lacing, body in ogg_pages(data):
        if serial0 is None:
            serial0 = serial
        if serial != serial0:
            continue
        at = 0
        for lace in lacing:
            part.append(body[at:at + lace])
            at += lace
            if lace < 255:
                packets.append(b"".join(part))
                part = []
        if granule != -1:
            last_granule = granule
        if htype & 4:
            break
    return packets, last_granule


# -- bits (spec 2) ------------------------------------------------------------


class Bits:
    """LSB-first reader over one packet.  ``w[i]`` holds the 64 bits from
    byte ``i`` on, so any read of up to 57 bits is one shift and mask."""

    __slots__ = ("w", "pos", "nbits")

    def __init__(self, packet):
        n = len(packet)
        pad = bytes(packet) + bytes(16)
        words = np.empty(n + 1, dtype=np.uint64)
        for k in range(8):
            dst = words[k::8]
            dst[:] = np.frombuffer(pad, dtype="<u8", count=len(dst),
                                   offset=k)
        self.w = words.tolist()
        self.pos = 0
        self.nbits = 8 * n

    def read(self, k):
        p = self.pos
        self.pos = p + k
        return (self.w[p >> 3] >> (p & 7)) & ((1 << k) - 1)

    def eop(self):
        """True once a read has gone past the end of the packet."""
        return self.pos > self.nbits


def ilog(x):
    return int(x).bit_length() if x > 0 else 0


def float32_unpack(x):
    mantissa = x & 0x1FFFFF
    exponent = (x & 0x7FE00000) >> 21
    if x & 0x80000000:
        mantissa = -mantissa
    return float(mantissa) * 2.0 ** (exponent - 788)


def lookup1_values(entries, dim):
    r = int(round(entries ** (1.0 / dim)))
    while r ** dim > entries:
        r -= 1
    while (r + 1) ** dim <= entries:
        r += 1
    return r


# -- codebooks (spec 3) -------------------------------------------------------


def _bitrev(v, n):
    return int(format(v, f"0{n}b")[::-1], 2) if n else 0


class Codebook:
    """One codebook: its codewords as lookup tables keyed by the next bits
    of the packet, and its VQ vectors ``vq [entries, dim]`` (float64)."""

    def __init__(self, b):
        if b.read(24) != 0x564342:
            raise ValueError("codebook sync pattern")
        self.dim = b.read(16)
        self.entries = b.read(24)
        lengths = np.zeros(self.entries, dtype=np.int64)
        if b.read(1):  # ordered
            cur = 0
            length = b.read(5) + 1
            while cur < self.entries:
                num = b.read(ilog(self.entries - cur))
                lengths[cur:cur + num] = length
                cur += num
                length += 1
        else:
            sparse = b.read(1)
            for i in range(self.entries):
                if not sparse or b.read(1):
                    lengths[i] = b.read(5) + 1
        self.lookup_type = b.read(4)
        self.vq = None
        if self.lookup_type in (1, 2):
            minimum = float32_unpack(b.read(32))
            delta = float32_unpack(b.read(32))
            value_bits = b.read(4) + 1
            sequence_p = b.read(1)
            nvals = (lookup1_values(self.entries, self.dim)
                     if self.lookup_type == 1 else self.entries * self.dim)
            mult = np.array([b.read(value_bits) for _ in range(nvals)],
                            dtype=np.float64)
            self.vq = self._unquantize(mult, minimum, delta, sequence_p,
                                       nvals)
        elif self.lookup_type != 0:
            raise ValueError(f"codebook lookup type {self.lookup_type}")
        self._tables(lengths)

    def _unquantize(self, mult, minimum, delta, sequence_p, nvals):
        e = np.arange(self.entries)
        vq = np.zeros((self.entries, self.dim))
        last = np.zeros(self.entries)
        div = 1
        for i in range(self.dim):
            if self.lookup_type == 1:
                off = (e // div) % nvals
                div *= nvals
            else:
                off = e * self.dim + i
            vq[:, i] = mult[off] * delta + minimum + last
            if sequence_p:
                last = vq[:, i]
        return vq

    def _tables(self, lengths):
        """Assign codewords (the lowest free codeword of each length, in
        entry order, spec 3.2.1) and build the decode tables: ``tab``,
        indexed by the next ``T`` bits, holds ``entry << 6 | length`` for
        codewords of up to ``T`` bits and ``~k`` for sub-table ``k`` of the
        longer ones, indexed by the bits after those ``T``."""
        used = [(j, int(n)) for j, n in enumerate(lengths) if n > 0]
        if not used:
            raise ValueError("codebook without entries")
        marker = [0] * 33
        codes = []
        if len(used) == 1:
            # a single used entry decodes whatever its bits say (as
            # libvorbis does)
            j, n = used[0]
            self.T, self.mask, self.subs = n, (1 << n) - 1, []
            self.tab = [(j << 6) | n] * (1 << n)
            return
        else:
            for j, n in used:
                code = marker[n]
                if n < 32 and code >> n:
                    raise ValueError("overspecified codebook")
                codes.append((j, n, code))
                for i in range(n, 0, -1):
                    if marker[i] & 1:
                        marker[i] = marker[i - 1] << 1 if i > 1 else \
                            marker[1] + 1
                        break
                    marker[i] += 1
                for i in range(n + 1, 33):
                    if (marker[i] >> 1) == code:
                        code = marker[i]
                        marker[i] = marker[i - 1] << 1
                    else:
                        break
        maxlen = max(n for _, n, _ in codes)
        T = min(maxlen, 10)
        tab = np.full(1 << T, -1, dtype=np.int64)
        long_by_prefix = {}
        for j, n, code in codes:
            rev = _bitrev(code, n)
            if n <= T:
                tab[rev + (np.arange(1 << (T - n)) << n)] = (j << 6) | n
            else:
                long_by_prefix.setdefault(rev & ((1 << T) - 1), []).append(
                    (j, n, rev >> T))
        self.T = T
        self.mask = (1 << T) - 1
        self.subs = []
        for prefix, items in long_by_prefix.items():
            L = max(n for _, n, _ in items) - T
            sub = np.full(1 << L, -1, dtype=np.int64)
            for j, n, rest in items:
                k = n - T
                sub[rest + (np.arange(1 << (L - k)) << k)] = (j << 6) | n
            tab[prefix] = ~len(self.subs)
            self.subs.append(((1 << L) - 1, sub.tolist()))
        self.tab = tab.tolist()

    def decode(self, b):
        """The next entry number, or -1 past the end of the packet."""
        p = b.pos
        v = b.w[p >> 3] >> (p & 7)
        e = self.tab[v & self.mask]
        if e < 0:
            mask, sub = self.subs[~e]
            e = sub[(v >> self.T) & mask]
            if e < 0:
                raise ValueError("undecodable codeword")
        b.pos = p + (e & 63)
        if b.pos > b.nbits:
            return -1
        return e >> 6

    def decode_many(self, b, count, out):
        """Append ``count`` entry numbers to ``out``; False past the end of
        the packet (``out`` then holds some of them)."""
        w = b.w
        tab = self.tab
        mask = self.mask
        p = b.pos
        for _ in range(count):
            v = w[p >> 3] >> (p & 7)
            e = tab[v & mask]
            if e < 0:
                smask, sub = self.subs[~e]
                e = sub[(v >> self.T) & smask]
                if e < 0:
                    raise ValueError("undecodable codeword")
            p += e & 63
            out.append(e >> 6)
        b.pos = p
        return p <= b.nbits


# -- floor 1 (spec 7) ---------------------------------------------------------

# spec 10.1: floor1_inverse_dB_table, a geometric series from 1.0649863e-07
# to 1.0 in 255 steps
INVERSE_DB = 1.0649863e-07 ** ((255 - np.arange(256)) / 255.0)
_RANGES = (256, 128, 86, 64)


class Floor1:
    def __init__(self, b):
        parts = b.read(5)
        self.part_class = [b.read(4) for _ in range(parts)]
        ncls = max(self.part_class) + 1 if parts else 0
        self.cdim, self.csub, self.cmaster, self.cbooks = [], [], [], []
        for _ in range(ncls):
            self.cdim.append(b.read(3) + 1)
            sub = b.read(2)
            self.csub.append(sub)
            self.cmaster.append(b.read(8) if sub else -1)
            self.cbooks.append([b.read(8) - 1 for _ in range(1 << sub)])
        self.mult = b.read(2) + 1
        rangebits = b.read(4)
        self.xs = [0, 1 << rangebits]
        for c in self.part_class:
            for _ in range(self.cdim[c]):
                self.xs.append(b.read(rangebits))
        xs = self.xs
        n = len(xs)
        # neighbours (spec 9.2.4, 9.2.5)
        self.low = [0] * n
        self.high = [0] * n
        for i in range(2, n):
            lo = max((j for j in range(i) if xs[j] < xs[i]),
                     key=lambda j: xs[j])
            hi = min((j for j in range(i) if xs[j] > xs[i]),
                     key=lambda j: xs[j])
            self.low[i], self.high[i] = lo, hi
        self.order = sorted(range(n), key=lambda i: xs[i])

    def decode(self, b, books):
        """The packet's Y values (spec 7.2.3), or None for an unused
        floor."""
        if not b.read(1):
            return None
        rng = _RANGES[self.mult - 1]
        bits = ilog(rng - 1)
        ys = [b.read(bits), b.read(bits)]
        for c in self.part_class:
            cdim, cbits = self.cdim[c], self.csub[c]
            csub = (1 << cbits) - 1
            cval = books[self.cmaster[c]].decode(b) if cbits else 0
            for _ in range(cdim):
                book = self.cbooks[c][cval & csub]
                cval >>= cbits
                ys.append(books[book].decode(b) if book >= 0 else 0)
        if b.eop():
            return None
        return ys

    def curve(self, ys, n):
        """The floor curve over ``n`` bins (spec 7.2.4), float64."""
        xs = self.xs
        rng = _RANGES[self.mult - 1]
        count = len(xs)
        final = list(ys[:2]) + [0] * (count - 2)
        step2 = [True, True] + [False] * (count - 2)
        for i in range(2, count):
            lo, hi = self.low[i], self.high[i]
            pred = _render_point(xs[lo], final[lo], xs[hi], final[hi], xs[i])
            val = ys[i]
            highroom = rng - pred
            lowroom = pred
            room = 2 * (highroom if highroom < lowroom else lowroom)
            if val:
                step2[lo] = step2[hi] = step2[i] = True
                if val >= room:
                    final[i] = (val - lowroom + pred if highroom > lowroom
                                else pred - val + highroom - 1)
                elif val & 1:
                    final[i] = pred - (val + 1) // 2
                else:
                    final[i] = pred + val // 2
            else:
                final[i] = pred
        out = np.empty(max(n, xs[1]) + 1, dtype=np.int64)
        lx, ly = 0, final[0] * self.mult
        hx = hy = 0
        for i in self.order[1:]:
            if step2[i]:
                hy = final[i] * self.mult
                hx = xs[i]
                _render_line(lx, ly, hx, hy, out)
                lx, ly = hx, hy
        if hx < n:
            _render_line(hx, hy, n, hy, out)
        return INVERSE_DB[np.clip(out[:n], 0, 255)]


def _trunc_div(a, b):
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _render_point(x0, y0, x1, y1, x):
    dy = y1 - y0
    adx = x1 - x0
    off = abs(dy) * (x - x0) // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, out):
    """Spec 9.2.7 in closed form: after k steps Bresenham's error term has
    wrapped floor(k * ady / adx) times."""
    if x1 <= x0:
        return
    dy = y1 - y0
    adx = x1 - x0
    base = _trunc_div(dy, adx)
    ady = abs(dy) - abs(base) * adx
    sy = -1 if dy < 0 else 1
    k = np.arange(x1 - x0)
    out[x0:x1] = y0 + k * base + sy * ((k * ady) // adx)


# -- residue (spec 8) ---------------------------------------------------------


class Residue:
    def __init__(self, b, kind):
        self.kind = kind
        self.begin = b.read(24)
        self.end = b.read(24)
        self.psize = b.read(24) + 1
        self.ncls = b.read(6) + 1
        self.classbook = b.read(8)
        cascade = []
        for _ in range(self.ncls):
            low = b.read(3)
            high = b.read(5) if b.read(1) else 0
            cascade.append(high * 8 + low)
        self.books = [[b.read(8) if c & (1 << j) else -1 for j in range(8)]
                      for c in cascade]

    def decode(self, b, books, n, dnd):
        """The residue vectors ``[len(dnd), n]`` of one submap's channels;
        ``dnd[j]`` marks a channel not to decode (spec 8.6.2)."""
        ch = len(dnd)
        out = np.zeros((ch, n))
        if self.kind == 2:
            if all(dnd):
                return out
            flat = self._decode(b, books, n * ch, [False], 1)[0]
            return flat.reshape(n, ch).T.copy()
        vecs = self._decode(b, books, n, dnd, 0 if self.kind == 0 else 1)
        return vecs

    def _decode(self, b, books, size, dnd, fmt):
        ch = len(dnd)
        out = np.zeros((ch, size))
        begin = min(self.begin, size)
        end = min(self.end, size)
        psize = self.psize
        nparts = (end - begin) // psize
        if nparts <= 0:
            return out
        cbook = books[self.classbook]
        cpc = cbook.dim
        ncls = self.ncls
        classes = [[0] * (nparts + cpc) for _ in range(ch)]
        live = [j for j in range(ch) if not dnd[j]]
        # per channel and book: entry numbers, and the partition offsets
        # they fill in order
        got = {}
        for stage in range(8):
            pc = 0
            while pc < nparts:
                if stage == 0:
                    for j in live:
                        temp = cbook.decode(b)
                        if temp < 0:
                            return self._apply(out, got, books, psize, fmt)
                        row = classes[j]
                        for i in range(cpc - 1, -1, -1):
                            row[pc + i] = temp % ncls
                            temp //= ncls
                for _ in range(cpc):
                    if pc >= nparts:
                        break
                    for j in live:
                        bk = self.books[classes[j][pc]][stage]
                        if bk < 0:
                            continue
                        book = books[bk]
                        ents = []
                        if not book.decode_many(b, psize // book.dim, ents):
                            return self._apply(out, got, books, psize, fmt)
                        rec = got.setdefault((j, bk), ([], []))
                        rec[0].extend(ents)
                        rec[1].append(begin + pc * psize)
                    pc += 1
        return self._apply(out, got, books, psize, fmt)

    @staticmethod
    def _apply(out, got, books, psize, fmt):
        """Add every decoded partition's VQ vectors into ``out``."""
        for (j, bk), (ents, offs) in got.items():
            book = books[bk]
            dim = book.dim
            vals = book.vq[np.asarray(ents)]  # [parts * psize/dim, dim]
            offs = np.asarray(offs)[:, None]
            if fmt == 1:  # consecutive: entry t fills dim*t .. dim*t+dim-1
                pos = offs + np.arange(psize)[None, :]
                vals = vals.reshape(len(offs), psize)
            else:  # format 0: entry t's element i lands at t + i*step
                step = psize // dim
                t = np.arange(step)
                idx = (t[:, None] + np.arange(dim)[None, :] * step).ravel()
                pos = offs + idx[None, :]
                vals = vals.reshape(len(offs), step * dim)
            np.add.at(out[j], pos.ravel(), vals.ravel())
        return out


# -- the stream ---------------------------------------------------------------


class _Mapping:
    def __init__(self, b, channels):
        nsub = b.read(4) + 1 if b.read(1) else 1
        self.coupling = []
        if b.read(1):
            bits = ilog(channels - 1)
            for _ in range(b.read(8) + 1):
                self.coupling.append((b.read(bits), b.read(bits)))
        if b.read(2):
            raise ValueError("mapping reserved bits")
        self.mux = ([b.read(4) for _ in range(channels)] if nsub > 1
                    else [0] * channels)
        self.submaps = []
        for _ in range(nsub):
            b.read(8)
            self.submaps.append((b.read(8), b.read(8)))  # floor, residue


_BASES = {}


def imdct_basis(n):
    """``[n/2, n]`` float64: row k is cos(2 pi / n (i + 1/2 + n/4)(k + 1/2))
    over i (spec 4.3.6)."""
    if n not in _BASES:
        i = np.arange(n)[None, :]
        k = np.arange(n // 2)[:, None]
        _BASES[n] = np.cos(2 * np.pi / n * (i + 0.5 + n / 4) * (k + 0.5))
    return _BASES[n]


def _tf32(x):
    """float32 with the mantissa rounded to TF32's 10 bits."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def window(n, long_left, long_right, b0, b1):
    """The window of a block of ``n`` samples (spec 4.3.1); the flags say
    whether the neighbour on each side is a long block."""
    w = np.zeros(n)
    if n == b1:
        ls, le = ((0, n // 2) if long_left
                  else (n // 4 - b0 // 4, n // 4 + b0 // 4))
        rs, re = ((n // 2, n) if long_right
                  else (3 * n // 4 - b0 // 4, 3 * n // 4 + b0 // 4))
    else:
        ls, le, rs, re = 0, n // 2, n // 2, n
    ln, rn = le - ls, re - rs
    x = (np.arange(ln) + 0.5) / ln * np.pi / 2
    w[ls:le] = np.sin(np.pi / 2 * np.sin(x) ** 2)
    w[le:rs] = 1.0
    x = (np.arange(rn) + 0.5) / rn * np.pi / 2 + np.pi / 2
    w[rs:re] = np.sin(np.pi / 2 * np.sin(x) ** 2)
    return w


class Stream:
    """One logical Vorbis stream: its headers parsed, its audio packets,
    each packet's block size and the output sample at which it starts."""

    def __init__(self, data, setups=None):
        """``setups``, a dict, keeps parsed setups by their header bytes
        for the streams of one corpus, which share them."""
        packets, self.last_granule = ogg_packets(data)
        if len(packets) < 3:
            raise ValueError("fewer than three header packets")
        self._ident(Bits(packets[0]))
        key = (packets[0], packets[2])
        if setups is not None and key in setups:
            (self.books, self.floors, self.residues, self.mappings,
             self.modes) = setups[key]
        else:
            self._setup(Bits(packets[2]))
            if setups is not None:
                setups[key] = (self.books, self.floors, self.residues,
                               self.mappings, self.modes)
        self.audio = packets[3:]
        modebits = ilog(len(self.modes) - 1)
        sizes = []
        for p in self.audio:
            if not p or p[0] & 1:
                sizes.append(0)  # not an audio packet: no output
                continue
            mode = (p[0] >> 1) & ((1 << modebits) - 1)
            sizes.append(self.block[self.modes[mode][0]])
        self.sizes = np.array(sizes, dtype=np.int64)
        # packet i returns samples from the centre of the last audio
        # packet before it to its own centre; the first returns none
        out = np.zeros(len(sizes), dtype=np.int64)
        prev = 0
        for i, n in enumerate(sizes):
            if n:
                out[i] = (prev + n) // 4 if prev else 0
                prev = n
        self.returns = out
        self.start = np.concatenate([[0], np.cumsum(out)[:-1]])
        total = int(out.sum())
        self.length = (min(total, self.last_granule)
                       if self.last_granule >= 0 else total)

    def _ident(self, b):
        if b.read(8) != 1 or bytes(b.read(8) for _ in range(6)) != b"vorbis":
            raise ValueError("not a Vorbis identification header")
        if b.read(32) != 0:
            raise ValueError("Vorbis version")
        self.channels = b.read(8)
        self.rate = b.read(32)
        b.read(32), b.read(32), b.read(32)
        self.block = (1 << b.read(4), 1 << b.read(4))

    def _setup(self, b):
        if b.read(8) != 5 or bytes(b.read(8) for _ in range(6)) != b"vorbis":
            raise ValueError("not a Vorbis setup header")
        self.books = [Codebook(b) for _ in range(b.read(8) + 1)]
        for _ in range(b.read(6) + 1):
            b.read(16)
        self.floors = []
        for _ in range(b.read(6) + 1):
            kind = b.read(16)
            if kind != 1:
                raise ValueError("floor 0 is not implemented")
            self.floors.append(Floor1(b))
        self.residues = []
        for _ in range(b.read(6) + 1):
            self.residues.append(Residue(b, b.read(16)))
        self.mappings = []
        for _ in range(b.read(6) + 1):
            if b.read(16) != 0:
                raise ValueError("mapping type")
            self.mappings.append(_Mapping(b, self.channels))
        self.modes = []
        for _ in range(b.read(6) + 1):
            flag = b.read(1)
            b.read(16), b.read(16)
            self.modes.append((flag, b.read(8)))
        if not b.read(1):
            raise ValueError("setup framing bit")

    # -- one packet -------------------------------------------------------

    def _spectrum(self, packet):
        """``(n, long_left, long_right, spectra [channels, n/2])`` of one
        audio packet, the floor applied; None for a packet to skip."""
        if not packet or packet[0] & 1:
            return None
        b = Bits(packet)
        b.read(1)
        flag, mapno = self.modes[b.read(ilog(len(self.modes) - 1))]
        n = self.block[flag]
        long_left = long_right = False
        if flag:
            long_left, long_right = bool(b.read(1)), bool(b.read(1))
        half = n // 2
        mapping = self.mappings[mapno]
        C = self.channels
        floors = [None] * C
        for c in range(C):
            fl = self.floors[mapping.submaps[mapping.mux[c]][0]]
            ys = fl.decode(b, self.books)
            if ys is not None:
                floors[c] = fl.curve(ys, half)
        dnd = [f is None for f in floors]
        for m, a in mapping.coupling:
            if not dnd[m] or not dnd[a]:
                dnd[m] = dnd[a] = False
        res = np.zeros((C, half))
        for s, (_, rno) in enumerate(mapping.submaps):
            chans = [c for c in range(C) if mapping.mux[c] == s]
            vecs = self.residues[rno].decode(b, self.books, half,
                                             [dnd[c] for c in chans])
            res[chans] = vecs
        for m, a in reversed(mapping.coupling):
            M, A = res[m].copy(), res[a].copy()
            pos_m, pos_a = M > 0, A > 0
            res[m] = np.where(pos_m, np.where(pos_a, M, M + A),
                              np.where(pos_a, M, M - A))
            res[a] = np.where(pos_m, np.where(pos_a, M - A, M),
                              np.where(pos_a, M + A, M))
        for c in range(C):
            res[c] = 0.0 if floors[c] is None else res[c] * floors[c]
        return n, long_left, long_right, res

    # -- a run of packets ---------------------------------------------------

    def decode(self, first, count, imdct="float64"):
        """Interleaved PCM ``[samples * channels]`` (float64, clamped to
        [-1, 1] as the clip epilogue does) of the audio packets ``first ..
        first + count - 1``: samples ``start[first]`` to ``start[first +
        count]``, cut at the stream's length.  The packet before ``first``
        is decoded for its overlap."""
        lo = max(first - 1, 0)
        hi = min(first + count, len(self.audio))
        specs = [self._spectrum(self.audio[i]) for i in range(lo, hi)]
        # IMDCT: every block of one size in one product
        frames = [None] * len(specs)
        for n in set(s[0] for s in specs if s is not None):
            idx = [i for i, s in enumerate(specs) if s is not None
                   and s[0] == n]
            X = np.stack([specs[i][3] for i in idx])  # [F, C, n/2]
            basis = imdct_basis(n)
            if imdct == "tf32":
                Y = (_tf32(X) @ _tf32(basis)).astype(np.float64)
            else:
                Y = X @ basis
            for i, y in zip(idx, Y):
                frames[i] = y
        C = self.channels
        b0, b1 = self.block
        t0 = int(self.start[first])
        t1 = int(self.start[hi - 1] + self.returns[hi - 1])
        out = np.zeros((C, t1 - t0))
        prev = None  # (n, right half) of the last audio packet
        for j, s in enumerate(specs):
            if s is None:
                continue
            n, ll, lr, _ = s
            y = frames[j] * window(n, ll, lr, b0, b1)[None, :]
            i = lo + j
            if prev is not None and i >= first:
                pn, pr = prev
                # the samples from the previous block's centre to this
                # one's: its right half from the start, this left half
                # from pn/4 - n/4 (the parts outside are zero by the
                # windows' shapes)
                a = int(self.start[i]) - t0
                L = pn // 4 + n // 4
                seg = out[:, a:a + L]
                k = min(L, pn // 2)
                seg[:, :k] += pr[:, :k]
                o = pn // 4 - n // 4
                if o >= 0:
                    seg[:, o:] += y[:, :n // 2]
                else:
                    seg += y[:, -o:n // 2]
            prev = (n, y[:, n // 2:])
        out = out[:, :max(0, min(t1, self.length) - t0)]
        np.clip(out, -1.0, 1.0, out=out)
        return out.T.reshape(-1)
