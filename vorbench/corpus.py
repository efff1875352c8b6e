"""The benchmark's corpus: seeded music-like PCM, encoded by libvorbis.

The encoder is the Xiph reference encoder, ``libvorbisenc``, driven through
``ctypes`` in VBR quality mode (``vorbis_encode_init_vbr``), as a user's own
encode of a music library or a film soundtrack would be.  Its input is
seeded PCM: tonal partials on a beat, plus noise shaped towards the low
bands, at a level that moves from block to block, its loud blocks peaking
just below full scale.

The machine with the card has no libvorbis, so the pool is encoded once,
where the library is, by ``python -m vorbench.corpus <config> ...``, and
committed under ``vorbench/pool/<config>/``: a few distinct encodes of the
configuration's ``pool`` parameters.  Streams of any length are assembled
from them at run time (:mod:`vorbench.streams`); nothing is written to
disk, and PCM never is.
"""

import ctypes
import ctypes.util
import io
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK_SECONDS = 4  # PCM made and handed to the encoder per block


class _OggPage(ctypes.Structure):
    _fields_ = [("header", ctypes.POINTER(ctypes.c_ubyte)),
                ("header_len", ctypes.c_long),
                ("body", ctypes.POINTER(ctypes.c_ubyte)),
                ("body_len", ctypes.c_long)]


class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.POINTER(ctypes.c_ubyte)),
                ("bytes", ctypes.c_long),
                ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long),
                ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]


_libs = None
_libs_lock = threading.Lock()


def _find(name, soname):
    path = ctypes.util.find_library(name)
    return ctypes.CDLL(path or soname)


def libraries():
    """(libvorbisenc, libvorbis, libogg) as ``ctypes.CDLL``; OSError where
    the machine lacks one."""
    global _libs
    with _libs_lock:
        if _libs is None:
            ogg = _find("ogg", "libogg.so.0")
            vorbis = _find("vorbis", "libvorbis.so.0")
            enc = _find("vorbisenc", "libvorbisenc.so.2")
            P = ctypes.c_void_p
            for fn, res, args in (
                (vorbis.vorbis_info_init, None, [P]),
                (vorbis.vorbis_info_clear, None, [P]),
                (vorbis.vorbis_comment_init, None, [P]),
                (vorbis.vorbis_comment_clear, None, [P]),
                (vorbis.vorbis_analysis_init, ctypes.c_int, [P, P]),
                (vorbis.vorbis_block_init, ctypes.c_int, [P, P]),
                (vorbis.vorbis_block_clear, ctypes.c_int, [P]),
                (vorbis.vorbis_dsp_clear, None, [P]),
                (vorbis.vorbis_analysis_headerout, ctypes.c_int,
                 [P, P, P, P, P]),
                (vorbis.vorbis_analysis_buffer,
                 ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                 [P, ctypes.c_int]),
                (vorbis.vorbis_analysis_wrote, ctypes.c_int,
                 [P, ctypes.c_int]),
                (vorbis.vorbis_analysis_blockout, ctypes.c_int, [P, P]),
                (vorbis.vorbis_analysis, ctypes.c_int, [P, P]),
                (vorbis.vorbis_bitrate_addblock, ctypes.c_int, [P]),
                (vorbis.vorbis_bitrate_flushpacket, ctypes.c_int, [P, P]),
                (vorbis.vorbis_version_string, ctypes.c_char_p, []),
                (enc.vorbis_encode_init_vbr, ctypes.c_int,
                 [P, ctypes.c_long, ctypes.c_long, ctypes.c_float]),
                (ogg.ogg_stream_init, ctypes.c_int, [P, ctypes.c_int]),
                (ogg.ogg_stream_clear, ctypes.c_int, [P]),
                (ogg.ogg_stream_packetin, ctypes.c_int, [P, P]),
                (ogg.ogg_stream_pageout, ctypes.c_int, [P, P]),
                (ogg.ogg_stream_flush, ctypes.c_int, [P, P]),
            ):
                fn.restype = res
                fn.argtypes = args
            _libs = (enc, vorbis, ogg)
    return _libs


def encoder_version():
    """libvorbis's own version string, or None where it is missing."""
    try:
        return libraries()[1].vorbis_version_string().decode()
    except OSError:
        return None


def _opaque():
    # libvorbis and libogg state structs, larger than any of them
    return ctypes.create_string_buffer(16384)


def _write_pages(ogg, os_, out, flush):
    page = _OggPage()
    step = ogg.ogg_stream_flush if flush else ogg.ogg_stream_pageout
    while step(os_, ctypes.byref(page)):
        out.write(ctypes.string_at(page.header, page.header_len))
        out.write(ctypes.string_at(page.body, page.body_len))


def encode(blocks, channels, rate, quality, serial):
    """Ogg Vorbis bytes of the float32 ``[channels, n]`` arrays that the
    iterable ``blocks`` yields, encoded by libvorbisenc in VBR mode at
    ``quality`` (-0.1..1.0; 0.5 is "q5").  The ctypes calls release the
    GIL, so several streams encode at once from several threads."""
    enc, vorbis, ogg = libraries()
    vi, vc, vd, vb, os_ = (_opaque() for _ in range(5))
    vorbis.vorbis_info_init(vi)
    if enc.vorbis_encode_init_vbr(vi, channels, rate, quality) != 0:
        raise RuntimeError(f"vorbis_encode_init_vbr refused {channels} ch, "
                           f"{rate} Hz, quality {quality}")
    vorbis.vorbis_comment_init(vc)
    vorbis.vorbis_analysis_init(vd, vi)
    vorbis.vorbis_block_init(vd, vb)
    ogg.ogg_stream_init(os_, serial)
    out = io.BytesIO()
    try:
        heads = [_OggPacket() for _ in range(3)]
        vorbis.vorbis_analysis_headerout(vd, vc, *(ctypes.byref(h)
                                                   for h in heads))
        for h in heads:
            ogg.ogg_stream_packetin(os_, ctypes.byref(h))
        _write_pages(ogg, os_, out, flush=True)
        packet = _OggPacket()

        def drain():
            while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                vorbis.vorbis_analysis(vb, None)
                vorbis.vorbis_bitrate_addblock(vb)
                while vorbis.vorbis_bitrate_flushpacket(
                        vd, ctypes.byref(packet)):
                    ogg.ogg_stream_packetin(os_, ctypes.byref(packet))
                    _write_pages(ogg, os_, out, flush=False)

        for block in blocks:
            block = np.ascontiguousarray(block, dtype=np.float32)
            n = block.shape[1]
            buf = vorbis.vorbis_analysis_buffer(vd, n)
            for ch in range(channels):
                ctypes.memmove(buf[ch], block[ch].ctypes.data, n * 4)
            vorbis.vorbis_analysis_wrote(vd, n)
            drain()
        vorbis.vorbis_analysis_wrote(vd, 0)
        drain()
        _write_pages(ogg, os_, out, flush=True)
    finally:
        ogg.ogg_stream_clear(os_)
        vorbis.vorbis_block_clear(vb)
        vorbis.vorbis_dsp_clear(vd)
        vorbis.vorbis_comment_clear(vc)
        vorbis.vorbis_info_clear(vi)
    return out.getvalue()


# -- the music-like source ----------------------------------------------------

_SCALE = np.array([0, 2, 3, 5, 7, 8, 10])  # natural minor, in semitones


def music_blocks(rng, seconds, rate, channels, lfe=None, levels=None):
    """Yield float32 ``[channels, n]`` blocks of ``seconds`` of seeded
    music-like PCM.  Each block is a chord of three notes of a minor scale,
    six partials each (amplitudes falling as 1/k), struck on every beat with
    a 2 ms attack and an exponential decay, panned per channel, plus noise
    tilted towards the low bands; the block's peak is set to 0.999 (two
    blocks in five, as mastered music peaks, so that the decode overshoots
    full scale and clips now and then) or to a level drawn in [0.35,
    0.95].  ``lfe``, a channel index, gets only what lies under
    120 Hz; ``levels`` scales each channel before the peak is set."""
    total = int(round(seconds * rate))
    beat = int(rate * rng.uniform(0.3, 0.6))
    per = max(beat, (BLOCK_SECONDS * rate) // beat * beat)
    root = rng.uniform(48, 60)  # MIDI note of the key's root
    pans = rng.uniform(0.2, 1.0, size=(channels, 3))
    done = 0
    while done < total:
        n = min(per, total - done)
        t = (done + np.arange(n)) / rate
        notes = root + _SCALE[rng.integers(0, 7, size=3)] + \
            12 * rng.integers(-1, 2, size=3)
        f0 = 440.0 * 2.0 ** ((notes - 69) / 12)
        env = np.exp(-((np.arange(n) % beat) / (beat / rng.uniform(2, 5))))
        env *= np.minimum(1.0, (np.arange(n) % beat) / (0.002 * rate))
        voices = np.zeros((3, n))
        for v in range(3):
            for k in range(1, 7):
                f = f0[v] * k
                if f >= rate / 2:
                    break
                voices[v] += np.sin(2 * np.pi * f * t
                                    + rng.uniform(0, 2 * np.pi)) / k
        voices *= env
        nfft = 1 << (n - 1).bit_length()  # a fast length; cut back to n
        freqs = np.fft.rfftfreq(nfft, 1 / rate)
        spec = np.fft.rfft(rng.standard_normal((channels, nfft)), axis=1)
        spec *= 1.0 / np.sqrt(np.maximum(freqs, 40.0) / 40.0)
        noise = np.fft.irfft(spec, n=nfft, axis=1)[:, :n]
        block = pans @ voices + noise * rng.uniform(0.02, 0.12)
        if lfe is not None:
            low = np.fft.rfft(block[lfe], n=nfft)
            low[freqs >= 120.0] = 0.0
            block[lfe] = np.fft.irfft(low, n=nfft)[:n]
        if levels is not None:
            block *= np.asarray(levels)[:, None]
        peak = 0.999 if rng.random() < 0.4 else rng.uniform(0.35, 0.95)
        block *= peak / max(np.abs(block).max(), 1e-9)
        yield block.astype(np.float32)
        done += n


# -- the pool -----------------------------------------------------------------


def make_pool(config, out_dir, threads=None):
    """Encode the configuration's pool (``pool``: ``encodes`` streams of
    ``seconds`` each from ``seed``) into ``out_dir/NN.ogg``; returns the
    bitrate reached, in kb/s over all of them."""
    pool = config["pool"]
    os.makedirs(out_dir, exist_ok=True)

    def one(i):
        rng = np.random.default_rng([pool["seed"], i])
        data = encode(music_blocks(rng, pool["seconds"],
                                   config["sample_rate"],
                                   config["channels"],
                                   config.get("lfe_channel"),
                                   config.get("channel_levels")),
                      config["channels"], config["sample_rate"],
                      config["quality"], serial=1000 + i)
        with open(os.path.join(out_dir, f"{i:02d}.ogg"), "wb") as f:
            f.write(data)
        return len(data)

    n = threads or os.cpu_count() or 1
    with ThreadPoolExecutor(max_workers=min(n, pool["encodes"])) as ex:
        sizes = list(ex.map(one, range(pool["encodes"])))
    return sum(sizes) * 8 / (pool["encodes"] * pool["seconds"]) / 1000


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Encode a configuration's pool into vorbench/pool/.")
    ap.add_argument("config", nargs="+", help="names under vorbench/configs")
    args = ap.parse_args(argv)
    for name in args.config:
        with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
            config = json.load(f)
        kbps = make_pool(config, os.path.join(HERE, "pool", name))
        print(f"{name}: {kbps:.1f} kb/s ({encoder_version()})")


if __name__ == "__main__":
    main()
