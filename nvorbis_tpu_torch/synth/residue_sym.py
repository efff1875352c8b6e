"""Residue spectra rebuilt from VQ symbols.

The C++ host plane emits per-partition classification bytes and the raw
codebook entry ids in a canonical (stage, channel, partition)-major layout
(``native/host_decode.cpp`` residue symbol emission) instead of dense
``[C, n2]`` spectra; :func:`reconstruct_spectrum` (``ops/residue.py``: the
CUDA kernel ``csrc/residue_rebuild.cu`` on a card, its torch twin on the
CPU) rebuilds each frame's spectrum on the device with table gathers:

    value(bin) = sum over stages of VQ[book(class(bin), s)][id(bin, s), elem]

Additions run in stage order, one contribution per stage per bin, as the
bitstream accumulates them, so the result is bit-equal to the dense spectra
(NVorbis/Residue0.cs:119-201 semantics) and to the JAX reconstruction.

The host half builds the static plan (:class:`ResiduePlan`) and the
chunk-level id layout.  Gating (``plan_for_setup`` returns None otherwise):
single-submap mappings, stage-book entry counts that fit int16, and — for
residue types 1/2 — vector dims dividing the partition size (otherwise
vectors overshoot partition boundaries, which the partition-local
addressing cannot express; the dense path handles those).
"""

import os
from math import gcd
from typing import NamedTuple

import numpy as np
import torch

from nvorbis_tpu_torch.ops.residue import (  # noqa: F401 (re-exported)
    reconstruct_spectrum,
)
from nvorbis_tpu_torch.utils.device import refuse_in_capture

CLASS_SENTINEL = 255

# ids arrays are padded to multiples of this so chunk programs re-compile
# only when the symbol volume crosses a large quantum
IDS_QUANTUM = 1 << 17


class ResiduePlan:
    """Static symbol-layout tables for one residue config."""

    __slots__ = (
        "residue_type", "begin", "end", "psize", "S", "n_cls", "channels",
        "groups_np", "pair_np", "vq_mega_np", "stage_widths",
    )

    def __init__(self, residue, channels):
        self.residue_type = residue.residue_type
        self.begin = residue.begin
        self.end = residue.end
        self.psize = residue.partition_size
        self.S = max(1, residue.max_stages)
        self.n_cls = residue.classifications
        self.channels = channels

        psize, S, n_cls = self.psize, self.S, self.n_cls
        groups = np.zeros((256, S), dtype=np.int32)
        # per-(cls, stage) ROW table, gathered once per PARTITION on device
        # (index count B*CHR*n_part, psize x fewer than element gathers —
        # the element-wise (div, vq_base, dims) triple's three big gathers
        # measured ~35% of the whole on-chip chunk program each; see NOTES
        # round 5).  pair_np[cls*S+s, w] packs the two per-element words:
        #   [..., 0]: (slot_group << 16) | dims   (-1 = dead element)
        #   [..., 1]: vq_base + element_offset    (addr = base + id*dims)
        div = np.full((n_cls, S, psize), -1, dtype=np.int32)
        base_t = np.zeros((n_cls, S, psize), dtype=np.int32)
        mega = []
        mega_off = {}
        mega_len = 0
        live_dims = [[] for _ in range(S)]

        for cls in range(n_cls):
            row = residue.books[cls]
            for s in range(len(row)):
                book = row[s]
                if book is None or not (residue.cascade[cls] & (1 << s)):
                    continue
                d = book.dimensions
                live_dims[s].append(d)
                if id(book) not in mega_off:
                    # 4-float book alignment: keeps every element address
                    # ``vb + (w % d) + id*d`` a multiple of the stage's
                    # group width W (W | d, W | w), so the device can fetch
                    # W consecutive values as ONE row gather of a
                    # [N/W, W]-reshaped table (the two element gathers are
                    # ~100% of the on-chip reconstruction — see NOTES r5)
                    pad = (-mega_len) % 4
                    if pad:
                        mega.append(np.zeros(pad, dtype=np.float32))
                        mega_len += pad
                    mega_off[id(book)] = mega_len
                    arr = np.asarray(book.lookup, dtype=np.float32).ravel()
                    mega.append(arr)
                    mega_len += arr.size
                vb = mega_off[id(book)]
                w = np.arange(psize)
                if self.residue_type == 0:
                    steps = psize // d
                    groups[cls, s] = steps
                    if steps > 0:
                        valid = w < steps * d
                        g = w % steps
                        e = w // steps
                        div[cls, s] = np.where(valid, (g << 16) | d, -1)
                        base_t[cls, s] = np.where(valid, vb + e, 0)
                else:
                    groups[cls, s] = -(-psize // d)
                    div[cls, s] = ((w // d) << 16) | d
                    base_t[cls, s] = vb + (w % d)
        self.groups_np = groups
        self.pair_np = np.stack([div, base_t], axis=-1).reshape(
            n_cls * S, psize, 2
        )
        if mega:
            tail = (-mega_len) % 4
            if tail:
                mega.append(np.zeros(tail, dtype=np.float32))
            self.vq_mega_np = np.concatenate(mega)
        else:
            self.vq_mega_np = np.zeros(4, dtype=np.float32)
        # per-stage element-group width: the largest power of two (<= 4)
        # dividing every live book's dims in that stage.  Within a group of
        # W elements the slot index is constant (g = w // d, W | d) and the
        # VQ addresses are consecutive, so the device gathers ids once per
        # group and mega values W at a time.  Residue type 0 interleaves
        # groups element-wise (g = w % steps) — no grouping there.
        widths = []
        for s in range(S):
            if self.residue_type == 0 or not live_dims[s]:
                widths.append(1)
                continue
            g = 0
            for d in live_dims[s]:
                g = gcd(g, d)
            widths.append(4 if g % 4 == 0 else (2 if g % 2 == 0 else 1))
        self.stage_widths = tuple(widths)

    # -- per-block-size geometry ------------------------------------------------

    def chr_count(self) -> int:
        return 1 if self.residue_type == 2 else self.channels

    def half(self, block_size: int) -> int:
        if self.residue_type == 2:
            return block_size * self.channels // 2
        return block_size // 2

    def n_part(self, block_size: int) -> int:
        end = min(self.end, self.half(block_size))
        return max(0, (end - self.begin) // self.psize)

    def max_ids(self, block_size: int) -> int:
        per_stage = self.groups_np[: self.n_cls].max(axis=0)  # [S]
        return int(per_stage.sum()) * self.chr_count() * self.n_part(block_size)


def plan_for_setup(setup):
    """Build ResiduePlans for a setup; None when symbol mode cannot apply."""
    for m in setup.mappings:
        if m.submap_count != 1:
            return None
    plans = {}
    for mode in setup.modes:
        res = setup.residues[mode.mapping.submap_residue[0]]
        if id(res) in plans:
            continue
        for cls in range(res.classifications):
            for s, book in enumerate(res.books[cls]):
                if book is None or not (res.cascade[cls] & (1 << s)):
                    continue
                if book.entries > 32767:
                    return None
                if res.residue_type != 0 and res.partition_size % book.dimensions:
                    return None
                if book.dimensions > 65535:
                    return None  # packed (group << 16) | dims table
        if res.partition_size > 32767:
            return None  # slot group must fit the packed table's high half
        plans[id(res)] = ResiduePlan(res, setup.channels)
    return plans


def sym_geometry(setup, plans):
    """(n_part_max, chr_max, max_ids_max) over all modes — the native unpack
    buffer shape."""
    n_part_max = chr_max = ids_max = 1
    for mode in setup.modes:
        plan = plans[id(setup.residues[mode.mapping.submap_residue[0]])]
        n_part_max = max(n_part_max, plan.n_part(mode.block_size))
        chr_max = max(chr_max, plan.chr_count())
        ids_max = max(ids_max, plan.max_ids(mode.block_size))
    return n_part_max, chr_max, ids_max


def flatten_ids(ids_rows, counts):
    """Compact per-frame id rows ``[R, max_ids]`` into one flat int16 array
    plus per-frame exclusive-cumsum bases — the chunk-level layout every
    dispatcher uploads (ids beyond each row's count are undefined)."""
    counts = counts.astype(np.int64)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    # the row width is sized for the chunk's longest frame; a bucket of
    # short frames masks a fraction of it (an O(R*max) boolean compress
    # beat a repeat+2-D-gather 4-5x in an A/B, but only on used columns)
    width = int(counts.max()) if len(counts) else 0
    ids_rows = ids_rows[:, :width]
    keep = np.arange(width)[None, :] < counts[:, None]
    return ids_rows[keep].astype(np.int16, copy=False), base


class SymStatic(NamedTuple):
    """Hashable static geometry for the jitted reconstruction."""

    begin: int
    psize: int
    n_part: int
    chr_count: int
    stages: int
    n_cls: int
    half: int
    residue_type: int
    # per-stage gather-group widths (see ResiduePlan.stage_widths);
    # NVT_SYM_WIDE=0 pins them to 1 (the per-element twin lane).  Only the
    # CPU twin reads them: the card's kernel has the per-element lane alone
    widths: tuple = ()


def plan_static(plan, block_size):
    # NVT_SYM_WIDE picks the CPU twin's lane; the CUDA kernel ignores widths
    widths = plan.stage_widths
    if os.environ.get("NVT_SYM_WIDE", "1") == "0":
        widths = (1,) * plan.S
    return SymStatic(
        plan.begin, plan.psize, plan.n_part(block_size), plan.chr_count(),
        plan.S, plan.n_cls, plan.half(block_size), plan.residue_type,
        widths,
    )


def round_ids(n: int) -> int:
    """Pad symbol counts to a coarse quantum to bound recompiles."""
    return max(IDS_QUANTUM, -(-n // IDS_QUANTUM) * IDS_QUANTUM)


def pad_ids(parts, pos, empty=np.empty):
    """A chunk bucket's flat ids: the concatenated ``parts`` (``pos`` ids
    in all) as int16, padded with -1 (missing) to ``round_ids(pos + 1)``.
    That is the JAX package's ``round_ids(pos)`` (parallel/batch.py:993,
    engine/bulk.py:521) wherever ``pos`` is not a multiple of
    ``IDS_QUANTUM``; at a multiple it is one quantum more, so that the
    vector always ends in a -1: :func:`reconstruct_spectrum` clamps a slot
    past the ids to the last one, which then reads a missing id.  The
    array is ``empty(size, np.int16)`` (a staging ring's ``take``, say),
    every element written."""
    flat = empty(round_ids(pos + 1), np.int16)
    flat[pos:] = -1
    if pos:
        np.concatenate(parts, out=flat[:pos], casting="unsafe")
    return flat


_tables = {}  # (id(plan), device) -> (plan, (groups, pair, mega))
_TABLES_MAX = 64


def plan_tables(plan, device):
    """The plan's constant tables ``(groups [256, S] int32, pair
    [n_cls*S, psize, 2] int32, mega [M] float32)`` on ``device``, uploaded
    once per (plan, device).  ``ResiduePlan`` has ``__slots__``, so the cache
    is this module's dict; it holds the plan, so its id stays valid."""
    device = torch.device(device)
    key = (id(plan), str(device))
    hit = _tables.get(key)
    if hit is not None and hit[0] is plan:
        return hit[1]
    refuse_in_capture("a residue plan's tables", device)
    if len(_tables) >= _TABLES_MAX:
        _tables.pop(next(iter(_tables)))
    tabs = (
        torch.as_tensor(plan.groups_np, device=device),
        torch.as_tensor(plan.pair_np, device=device),
        torch.as_tensor(plan.vq_mega_np, device=device),
    )
    _tables[key] = (plan, tabs)
    return tabs
