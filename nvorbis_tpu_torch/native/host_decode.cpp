// Native host plane of nvorbis_tpu_torch: bit-serial Vorbis packet unpack.
//
// This is the C++ twin of codec/frames.py::unpack_audio_packet —
// everything between "raw packet bytes" and "dense per-frame tensors" that
// is inherently sequential and therefore runs on the host:
//
//   * LSB-first bit reader            (reference: NVorbis/DataPacket.cs:168-283)
//   * codebook scalar (Huffman) decode (NVorbis/Codebook.cs:294-320,
//                                       prefix table NVorbis/Huffman.cs:15-76)
//   * floor1 post decode + unwrap     (NVorbis/Floor1.cs:135-184, 224-297)
//   * residue 0/1/2 partition decode  (NVorbis/Residue0.cs:119-201,
//                                      Residue1.cs:6-27, Residue2.cs:6-48)
//   * coupling no-energy propagation  (NVorbis/Mapping.cs:112-119)
//
// The per-stream setup (codebooks, floors, residues, mappings, modes) is
// serialized by Python into one int32 blob + one float32 blob
// (see native/__init__.py) and parsed here once per stream.  Packets within
// an unpack window are independent, so the window fans out over a thread
// pool; each packet writes only its own output rows.
//
// Float accumulation is element-wise float32 adds in the same order as the
// numpy reference path, so outputs are bit-identical to frames.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <thread>
#include <atomic>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- bit reader

struct BitReader {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos = 0;
  bool is_short = false;

  BitReader(const uint8_t* d, int64_t nbytes) : data(d), nbits(nbytes * 8) {}

  // Peek up to `count` (<=57) bits; returns bits actually available in *got.
  inline uint64_t try_peek(int count, int* got) const {
    int64_t avail = nbits - pos;
    if (avail <= 0) { *got = 0; return 0; }
    int n = count < (int)avail ? count : (int)avail;
    int64_t byte0 = pos >> 3;
    int bit0 = (int)(pos & 7);
    int64_t nbytes_total = (nbits + 7) >> 3;
    uint64_t chunk;
    if (byte0 + 8 <= nbytes_total) {
      // hot path: one unaligned little-endian load (this peek runs up to
      // twice per Huffman symbol — the byte-at-a-time rebuild was the
      // single largest cost of the whole unpack).  64 - bit0 >= 57 bits
      // land in the window, matching the documented count bound.
      std::memcpy(&chunk, data + byte0, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
      chunk = __builtin_bswap64(chunk);
#endif
    } else {
      // tail: assemble only the bytes that exist
      chunk = 0;
      int64_t need = (bit0 + n + 7) >> 3;
      int64_t take = std::min<int64_t>(need, nbytes_total - byte0);
      for (int64_t i = take - 1; i >= 0; --i)
        chunk = (chunk << 8) | data[byte0 + i];
    }
    uint64_t value = (chunk >> bit0) & ((n >= 64) ? ~0ull : ((1ull << n) - 1));
    *got = n;
    return value;
  }

  inline void skip(int count) {
    if (count <= 0) return;
    pos += count;
    if (pos > nbits) { pos = nbits; is_short = true; }
  }

  inline uint64_t read(int count) {
    int got;
    uint64_t v = try_peek(count, &got);
    skip(count);
    return v;
  }

  inline bool read_bit() { return read(1) != 0; }
};

// ---------------------------------------------------------------- setup model

struct Codebook {
  int32_t dims, entries, table_bits, max_bits, ov_count;
  const int64_t* tbl_pack;    // [1 << table_bits]: (length << 32) | value —
                              // one cache access per prefix hit instead of
                              // two parallel int32 arrays
  const int32_t* ov;          // [ov_count][4]: code, mask, length, value
  const float* lookup;        // [entries * dims] or nullptr

  // NVorbis/Codebook.cs:294-320
  inline int decode_scalar(BitReader& br) const {
    if (max_bits < 0) {  // all-unused codebook
      return -1;
    }
    int got;
    uint64_t data = br.try_peek(table_bits, &got);
    if (got == 0) return -1;
    int64_t e = tbl_pack[data];
    int32_t len = (int32_t)(e >> 32);
    if (len > 0) {
      br.skip(len);
      return (int32_t)(uint32_t)e;
    }
    data = br.try_peek(max_bits, &got);
    for (int i = 0; i < ov_count; ++i) {
      const int32_t* o = &ov[i * 4];
      if ((uint32_t)o[0] == ((uint32_t)data & (uint32_t)o[1])) {
        br.skip(o[2]);
        return o[3];
      }
    }
    return -1;
  }
};

struct Floor1 {
  int32_t partition_count, max_class, post_count, y_bits, range, multiplier;
  const int32_t* partition_class;  // [partition_count]
  const int32_t* class_dims;       // [max_class]
  const int32_t* class_subclasses; // [max_class]
  const int32_t* masterbooks;      // [max_class] (-1 = none)
  const int32_t* subclass_books;   // [max_class * 8] (-1 = none)
  const int32_t* x_list;           // [post_count]
  const int32_t* l_neigh;          // [post_count]
  const int32_t* h_neigh;          // [post_count]
  const int32_t* sort_idx;         // [post_count]
  const int32_t* xs_sorted;        // [post_count] (derived at setup_create)
  const int64_t* rp_const;         // [post_count] (x-lx) * (2^47/adx + 1):
                                   // division-free render_point (see
                                   // floor1_unpack; i < 2 slots are 0)
};

// LSP floor on the Bark scale (floor type 0 — legacy, rarely used).
// Bark/w maps are precomputed host-side (codec/floor.py Floor0) and travel
// in the setup blob so curves are float-identical to the python oracle.
// Reference: NVorbis/Floor0.cs.
struct Floor0c {
  int32_t order, amp_bits, amp_ofs, book_bits, n_books;
  const int32_t* book_idx;  // [n_books]
  const int32_t* bark0;     // [block0/2 + 1]
  const int32_t* bark1;     // [block1/2 + 1]
  const float* w0;          // [block0/2]
  const float* w1;          // [block1/2]
};

struct Residue {
  int32_t type, begin, end, partition_size, classifications, classbook,
      max_stages, partvals, cb_dims;
  const int32_t* cascade;     // [classifications]
  const int32_t* books;       // [classifications * max_stages] (-1 = none)
  const int32_t* decode_map;  // [partvals * cb_dims]
  const int32_t* groups_tab;  // [classifications * max_stages]: precomputed
                              // sym_groups(cls, stage) — recomputing it per
                              // partition was measurable in both the decode
                              // and finalize loops
  int32_t wr_slack;           // max VQ dims over this residue's books: a
                              // type-1/2 vector may overshoot `end` by up
                              // to dims-1 (clamped at half), so the
                              // guaranteed-zero tail starts at
                              // min(end + wr_slack, half)
};

struct Mapping {
  int32_t submap_count, coupling_count;
  const int32_t* mag;            // [coupling_count]
  const int32_t* ang;            // [coupling_count]
  const int32_t* mux;            // [channels]
  const int32_t* submap_floor;   // [submap_count]
  const int32_t* submap_residue; // [submap_count]
};

struct Mode {
  int32_t block_flag, block_size, mapping_idx;
};

struct Setup {
  int32_t channels, mode_field_bits, max_posts, block0, block1, n2max;
  std::vector<Codebook> books;
  std::vector<Floor1> floors;    // valid where floor_types[i] == 1
  std::vector<Floor0c> floor0s;  // valid where floor_types[i] == 0
  std::vector<int32_t> floor_types;
  int32_t f0_max_order = 0;  // scratch sizing for Floor0 coefficients
  std::vector<Residue> residues;
  std::vector<Mapping> mappings;
  std::vector<Mode> modes;
  std::vector<int32_t> blob_i;  // owned copies
  std::vector<float> blob_f;
  std::vector<std::vector<int64_t>> tbl_packs;  // per-book packed prefix
  std::vector<std::vector<int32_t>> groups_tabs;  // per-residue (see Residue)
  std::vector<std::vector<int32_t>> xs_sorteds;   // per-floor sorted x lists
  std::vector<std::vector<int64_t>> rp_consts;    // per-floor render_point magics
  const float* inv_db;  // [256] Vorbis I inverse-dB table (spec mode)
  // A/B switches, sampled from the environment once per setup_create so
  // in-process alternating benchmarks (tools/ab_variants.py pattern) can
  // flip them between decoder constructions:
  bool no_t2ch2;      // NVT_NO_T2CH2: disable the stereo type-2 fast lane
  bool no_tgen;       // NVT_NO_TGEN: disable the generalized aligned lane
  bool floor_div;     // NVT_FLOOR_DIV: per-bin closed-form division in
                      // floor_apply instead of the incremental renderer
  bool floor_inc;     // NVT_FLOOR_INC: incremental (base/err) renderer
                      // instead of the magic-reciprocal closed form
};

constexpr int32_t kMagic = 0x4E565432;  // "NVT2"

// ------------------------------------------------ residue symbol buffering

struct SymEntry {
  int16_t stage, ch, part, gidx;
  int32_t id;
};

struct SymSink {
  std::vector<SymEntry> entries;
  inline void add(int stage, int ch, int part, int gidx, int id) {
    entries.push_back({(int16_t)stage, (int16_t)ch, (int16_t)part,
                       (int16_t)gidx, id});
  }
};

// per-thread reusable scratch: the unpack runs per packet on a pool, and
// per-frame vector construction (sink entries, class caches, prefix bases,
// floor posts) was pure allocator churn.  `cache` is shared by the dense
// and symbol residue decoders — a frame runs exactly one of them.
struct Scratch {
  SymSink sink;
  std::vector<const int32_t*> cache;
  std::vector<int32_t> base;
  std::vector<int> posts;
  std::vector<int> final_y;              // floor1 unwrap temporaries
  std::vector<uint8_t> post_used;
  std::vector<uint8_t> execute, dnd;
  std::vector<float*> bufs;              // per-submap channel pointers
  std::vector<int32_t> spec_ys;          // spectrum mode: floor posts stay
  std::vector<uint8_t> spec_used;        // thread-local, never leave
  std::vector<uint8_t> has_floor;
  std::vector<float> f0_amp;             // Floor0: per-channel amplitude
  std::vector<float> f0_coeffs;          // Floor0: [C, max_order+1] LSP
};
inline Scratch& scratch() {
  static thread_local Scratch sc;
  return sc;
}

// ------------------------------------------------- cycle-split diagnostics
//
// NVT_CYCLES=1 accumulates rdtsc cycles per unpack_one_spec stage into
// process-wide counters (read+reset via nvt_cycles_read).  Zero overhead
// when off (one predictable branch per stage boundary).  This is the
// measurement that drove the round-3/4 unpack ladder — keep it.

static std::atomic<uint64_t> g_cycles[6];  // floor_unpack, residue,
                                           // coupling, floor_apply,
                                           // memset, total
inline bool cycles_on() {
  static const bool v = std::getenv("NVT_CYCLES") != nullptr;
  return v;
}
#if defined(__x86_64__)
static inline uint64_t tsc() {
  unsigned lo, hi;
  __asm__ volatile("rdtsc" : "=a"(lo), "=d"(hi));
  return ((uint64_t)hi << 32) | lo;
}
#else
static inline uint64_t tsc() { return 0; }
#endif

// ------------------------------------------------------------- floor1 unpack

// Reference: NVorbis/Floor1.cs:299-314
inline int render_point(int x0, int y0, int x1, int y1, int x) {
  int dy = y1 - y0;
  int adx = x1 - x0;
  int off = (int)(((int64_t)std::abs(dy) * (x - x0)) / adx);
  return dy < 0 ? y0 - off : y0 + off;
}

// Decode + unwrap one channel's floor1 posts.  Outputs ys (sorted-X order,
// pre-multiplied) and used flags; returns has_floor.
// Reference: NVorbis/Floor1.cs:135-184 (unpack), 224-297 (unwrap).
bool floor1_unpack(const Setup& s, const Floor1& f, BitReader& br,
                   int32_t* ys_out, uint8_t* used_out, int P) {
  std::memset(ys_out, 0, sizeof(int32_t) * P);
  std::memset(used_out, 0, P);
  if (!br.read_bit()) return false;

  std::vector<int>& posts = scratch().posts;
  posts.assign(f.post_count, 0);
  posts[0] = (int)br.read(f.y_bits);
  posts[1] = (int)br.read(f.y_bits);
  int post_idx = 2;
  for (int pi = 0; pi < f.partition_count; ++pi) {
    int cls = f.partition_class[pi];
    int cdim = f.class_dims[cls];
    int cbits = f.class_subclasses[cls];
    int csub = (1 << cbits) - 1;
    int cval = 0;
    if (cbits > 0) {
      cval = s.books[f.masterbooks[cls]].decode_scalar(br);
      if (cval == -1) return false;
    }
    for (int d = 0; d < cdim; ++d) {
      int32_t bnum = f.subclass_books[cls * 8 + (cval & csub)];
      cval >>= cbits;
      if (bnum >= 0) {
        int val = s.books[bnum].decode_scalar(br);
        if (val == -1) return false;
        posts[post_idx] = val;
      }
      ++post_idx;
    }
  }

  // unwrap (scratch-backed: this runs per channel per packet, and the
  // per-call vector construction was pure allocator churn)
  std::vector<int>& final_y = scratch().final_y;
  std::vector<uint8_t>& used = scratch().post_used;
  final_y.resize(f.post_count);
  used.assign(f.post_count, 0);
  final_y[0] = posts[0];
  final_y[1] = posts[1];
  used[0] = used[1] = 1;
  for (int i = 2; i < f.post_count; ++i) {
    int lo = f.l_neigh[i], hi = f.h_neigh[i];
    // render_point without the per-post integer division: |dy| is < 256
    // for every spec-range y (range <= 256); the guard keeps the exact
    // division for the out-of-range values a hostile codebook can emit
    int y0 = final_y[lo], y1 = final_y[hi];
    int dy = y1 - y0;
    int ady = dy < 0 ? -dy : dy;
    int predicted;
    int64_t rpc = f.rp_const[i];
    if (ady < 256 && rpc) {
      int off = (int)(((int64_t)ady * rpc) >> 47);
      predicted = dy < 0 ? y0 - off : y0 + off;
    } else {
      predicted = render_point(f.x_list[lo], y0, f.x_list[hi], y1,
                               f.x_list[i]);
    }
    int val = posts[i];
    int high_room = f.range - predicted;
    int low_room = predicted;
    int room = 2 * (high_room < low_room ? high_room : low_room);
    if (val != 0) {
      used[lo] = used[hi] = used[i] = 1;
      if (val >= room) {
        final_y[i] = high_room > low_room ? val - low_room + predicted
                                          : predicted - val + high_room - 1;
      } else {
        final_y[i] = (val & 1) ? predicted - ((val + 1) >> 1)
                               : predicted + (val >> 1);
      }
    } else {
      used[i] = 0;
      final_y[i] = predicted;
    }
  }
  for (int i = 0; i < f.post_count; ++i) {
    int si = f.sort_idx[i];
    ys_out[i] = final_y[si] * f.multiplier;
    used_out[i] = used[si];
  }
  return true;
}

// Floor0 (LSP) unpack: amplitude + LSP coefficients from one codebook,
// with the last-of-vector "averaging" carry.  Float op order matches the
// python oracle (codec/floor.py Floor0.unpack) exactly.
// Reference: NVorbis/Floor0.cs:98-150.
bool floor0_unpack(const Setup& s, const Floor0c& f, BitReader& br,
                   float* amp_out, float* coeffs) {
  int64_t ampi = (int64_t)br.read(f.amp_bits);
  if (ampi <= 0) return false;
  float amp = (float)ampi / (float)((1u << f.amp_bits) - 1)
              * (float)f.amp_ofs;
  int bn = (int)br.read(f.book_bits);
  if (bn >= f.n_books) return false;
  const Codebook& book = s.books[f.book_idx[bn]];
  if (book.lookup == nullptr) return false;
  const int order = f.order, dims = book.dims;
  for (int k = 0; k <= order; ++k) coeffs[k] = 0.0f;
  int i = 0;
  while (i < order) {
    int e = book.decode_scalar(br);
    if (e == -1) return false;
    const float* row = &book.lookup[(int64_t)e * dims];
    for (int j = 0; i < order && j < dims; ++j, ++i) coeffs[i] = row[j];
  }
  float last = 0.0f;
  int j = 0;
  while (j < order) {
    for (int k = 0; j < order && k < dims; ++k, ++j) coeffs[j] += last;
    last = coeffs[j - 1];
  }
  *amp_out = amp;
  return true;
}

// Floor0 curve multiply: evaluate the LSP filter response per bark run and
// scale the residue row in place.  p/q chains run in float32 in the
// oracle's exact op order; the 2cos(lsp) precompute is f64 -> f32 like the
// oracle's.  Reference: NVorbis/Floor0.cs:152-212.
// `xmax` clamps the curve evaluation + multiply (<= n2): bins at/after it
// are known-zero residue (the caller's residue write bound), and 0 * curve
// is 0 — skipping them is exact and skips the expensive p/q chain too.
void floor0_apply(const Floor0c& f, const int32_t* bark, const float* wmap,
                  int n2, float amp, const float* lsp, float* row,
                  int xmax) {
  const int order = f.order;
  float cos2[256];  // order is an 8-bit field
  for (int j2 = 0; j2 < order; ++j2)
    cos2[j2] = (float)(2.0 * std::cos((double)lsp[j2]));
  const float amp_ofs = (float)f.amp_ofs;
  int i = 0;
  while (i < xmax) {
    const int k = bark[i];
    float p = 0.5f, q = 0.5f;
    const float w = wmap[k];
    int j = 1;
    for (; j < order; j += 2) {
      q = q * (w - cos2[j - 1]);
      p = p * (w - cos2[j]);
    }
    if (j == order) {  // odd order
      q = q * (w - cos2[j - 1]);
      p = p * p * (4.0f - w * w);
      q = q * q;
    } else {
      p = p * p * (2.0f - w);
      q = q * q * (2.0f + w);
    }
    float v = amp / std::sqrt(p + q) - amp_ofs;
    v = std::exp(v * 0.11512925f);
    row[i] *= v;
    for (;;) {
      ++i;
      if (i >= xmax || bark[i] != k) break;
      row[i] *= v;
    }
  }
}

// ------------------------------------------------------------ residue decode

// Accumulate one partition's VQ vectors; returns true on packet truncation.
// Reference: NVorbis/Residue0.cs:180-201 (type 0), Residue1.cs:8-26.
inline bool write_vectors(const Codebook& book, BitReader& br, float* res,
                          int64_t res_len, int offset, int psize, int type) {
  int dims = book.dims;
  if (type == 0) {
    int steps = psize / dims;
    // dimension-major: res[offset + d*steps + i] += lookup[e_i, d]
    // entries first (matching the numpy batch layout exactly)
    int stack_entries[256];
    std::vector<int> heap_entries;
    int* entries = stack_entries;
    if (steps > 256) {
      heap_entries.resize(steps);
      entries = heap_entries.data();
    }
    for (int i = 0; i < steps; ++i) {
      int e = book.decode_scalar(br);
      if (e == -1) return true;
      entries[i] = e;
    }
    for (int d = 0; d < dims; ++d)
      for (int i = 0; i < steps; ++i)
        res[offset + d * steps + i] += book.lookup[entries[i] * dims + d];
    return false;
  }
  // types 1/2: contiguous vectors until i >= psize (may overshoot when dims
  // does not divide psize); truncated packets keep the vectors read so far
  int steps = (psize + dims - 1) / dims;
  int o = offset;
  for (int i = 0; i < steps; ++i) {
    int e = book.decode_scalar(br);
    if (e == -1) return true;
    const float* row = &book.lookup[(int64_t)e * dims];
    for (int d = 0; d < dims && o < res_len; ++d, ++o) res[o] += row[d];
  }
  return false;
}

// Decode residue for the channels of one submap.
// `bufs[c]` points at the channel's dense residue row (length n2 for types
// 0/1); for type 2 decoding is logically over one interleaved vector of
// length n2*ch and de-interleaved on the fly.
// Reference: NVorbis/Residue0.cs:119-178.
void residue_decode(const Setup& s, const Residue& r, BitReader& br,
                    const std::vector<float*>& bufs,
                    const std::vector<uint8_t>& do_not_decode, int block_size) {
  int ch = (int)bufs.size();
  bool all_dnd = true;
  for (uint8_t d : do_not_decode) all_dnd &= (d != 0);
  if (all_dnd) return;

  int type = r.type;
  int64_t half = (type == 2) ? (int64_t)block_size * ch / 2 : block_size / 2;
  int eff_ch = (type == 2) ? 1 : ch;

  int end = (int)std::min<int64_t>(r.end, half);
  int n = end - r.begin;
  if (n <= 0) return;
  int psize = r.partition_size;
  int partitions = n / psize;
  const Codebook& cb = s.books[r.classbook];
  int cb_dims = r.cb_dims;
  int part_words = (partitions + cb_dims - 1) / cb_dims;

  // classword cache: [eff_ch][part_words] -> decode_map row
  std::vector<const int32_t*>& cache = scratch().cache;
  cache.assign((size_t)eff_ch * part_words, nullptr);

  for (int stage = 0; stage < r.max_stages; ++stage) {
    int pi = 0, ei = 0;
    while (pi < partitions) {
      if (stage == 0) {
        for (int c = 0; c < eff_ch; ++c) {
          if (eff_ch > 1 && do_not_decode[c]) continue;
          int idx = cb.decode_scalar(br);
          if (idx < 0 || idx >= r.partvals) return;  // bail, keep partial
          cache[(size_t)c * part_words + ei] = &r.decode_map[(int64_t)idx * cb_dims];
        }
      }
      for (int d = 0; d < cb_dims && pi < partitions; ++d, ++pi) {
        int offset = r.begin + pi * psize;
        for (int c = 0; c < eff_ch; ++c) {
          if (eff_ch > 1 && do_not_decode[c]) continue;
          const int32_t* row = cache[(size_t)c * part_words + ei];
          int cls = row[d];
          if (r.cascade[cls] & (1 << stage)) {
            int32_t bnum = r.books[(int64_t)cls * r.max_stages + stage];
            if (bnum >= 0) {
              const Codebook& book = s.books[bnum];
              if (type == 2) {
                // inline de-interleaved write_vectors (types 1/2 layout).
                // The interleaved position o maps to channel o % ch, bin
                // o / ch — tracked incrementally (one div per partition
                // instead of two per sample)
                int dims = book.dims;
                int steps = (psize + dims - 1) / dims;
                int64_t o = offset;
                if (ch == 2 && (dims & 1) == 0 && (o & 1) == 0 &&
                    steps * dims == psize && !s.no_t2ch2) {
                  // stereo fast lane (the dominant wire layout): when the
                  // vector cannot overshoot (dims | psize) and the
                  // partition starts channel-aligned, elements land in
                  // strict (L,R) bin pairs — no per-element bound check,
                  // no channel-wrap branch.  Adds execute in the exact
                  // order of the generic loop (bit-identical floats).
                  float* b0 = bufs[0];
                  float* b1 = bufs[1];
                  int64_t oi = o >> 1;
                  if (dims == 2) {  // dominant books: exact unrolls keep
                    for (int i = 0; i < steps; ++i) {  // the accumulate
                      int e = book.decode_scalar(br);  // off the decode
                      if (e == -1) return;             // chain's critical
                      const float* rowv = &book.lookup[(int64_t)e * 2];
                      b0[oi] += rowv[0];
                      b1[oi] += rowv[1];
                      ++oi;
                    }
                    continue;
                  }
                  if (dims == 4) {
                    for (int i = 0; i < steps; ++i) {
                      int e = book.decode_scalar(br);
                      if (e == -1) return;
                      const float* rowv = &book.lookup[(int64_t)e * 4];
                      b0[oi] += rowv[0];
                      b1[oi] += rowv[1];
                      b0[oi + 1] += rowv[2];
                      b1[oi + 1] += rowv[3];
                      oi += 2;
                    }
                    continue;
                  }
                  for (int i = 0; i < steps; ++i) {
                    int e = book.decode_scalar(br);
                    if (e == -1) return;  // bail, keep partial
                    const float* rowv = &book.lookup[(int64_t)e * dims];
                    for (int dd = 0; dd < dims; dd += 2, ++oi) {
                      b0[oi] += rowv[dd];
                      b1[oi] += rowv[dd + 1];
                    }
                  }
                  continue;
                }
                int cc = (int)(o % ch);
                int64_t oi = o / ch;
                // no-overshoot partitions (dims | psize) skip the
                // per-element bound check: offset + psize <= end <= half
                const bool exact = steps * dims == psize;
                if (exact && cc == 0 && psize % ch == 0 && ch <= 16 &&
                    (ch & 1) == 0 && !s.no_tgen) {
                  // generalized aligned lane (the stereo trick for any
                  // even channel count, e.g. 5.1): partitions start
                  // channel-aligned and cover whole bins, so the channel
                  // cursor advances deterministically — the wrap check
                  // moves from per-element to per-run, and local channel
                  // pointers skip the vector indirection.  Adds execute
                  // in the generic loop's exact order (bit-identical).
                  float* bp[16];
                  for (int c2 = 0; c2 < ch; ++c2) bp[c2] = bufs[c2];
                  int cc2 = 0;
                  if (dims == 2) {  // dominant books: cc2 stays even, so
                    for (int i = 0; i < steps; ++i) {  // no mid-vector
                      int e = book.decode_scalar(br);  // wrap ever
                      if (e == -1) return;
                      const float* rowv = &book.lookup[(int64_t)e * 2];
                      bp[cc2][oi] += rowv[0];
                      bp[cc2 + 1][oi] += rowv[1];
                      cc2 += 2;
                      if (cc2 == ch) { cc2 = 0; ++oi; }
                    }
                    continue;
                  }
                  for (int i = 0; i < steps; ++i) {
                    int e = book.decode_scalar(br);
                    if (e == -1) return;
                    const float* rowv = &book.lookup[(int64_t)e * dims];
                    int dd = 0;
                    while (dd < dims) {
                      int run = std::min(dims - dd, ch - cc2);
                      for (int k2 = 0; k2 < run; ++k2)
                        bp[cc2 + k2][oi] += rowv[dd + k2];
                      dd += run;
                      cc2 += run;
                      if (cc2 == ch) { cc2 = 0; ++oi; }
                    }
                  }
                  continue;
                }
                bool bail = false;
                for (int i = 0; i < steps && !bail; ++i) {
                  int e = book.decode_scalar(br);
                  if (e == -1) { bail = true; break; }
                  const float* rowv = &book.lookup[(int64_t)e * dims];
                  if (exact) {
                    for (int dd = 0; dd < dims; ++dd) {
                      bufs[cc][oi] += rowv[dd];
                      if (++cc == ch) { cc = 0; ++oi; }
                    }
                    o += dims;
                    continue;
                  }
                  for (int dd = 0; dd < dims && o < half; ++dd, ++o) {
                    bufs[cc][oi] += rowv[dd];
                    if (++cc == ch) { cc = 0; ++oi; }
                  }
                }
                if (bail) return;
              } else {
                if (write_vectors(book, br, bufs[c], block_size / 2, offset,
                                  psize, type))
                  return;
              }
            }
          }
        }
      }
      ++ei;
    }
  }
}

// --------------------------------------------------- residue symbol emission
//
// Symbol mode defers VQ accumulation to the device: instead of dense float
// spectra, each frame emits (a) its per-partition classification bytes and
// (b) the decoded codebook entry ids, compacted into a canonical
// (stage, channel, partition)-major layout whose slot counts are a pure
// function of the classes — so the device can recompute every id's address
// from the classes alone and reconstruct the spectrum with gathers.
// Decode order is the bitstream's interleaved order (same as
// residue_decode); ids are buffered with their coordinates and scattered
// into canonical slots afterwards.

constexpr uint8_t kClassSentinel = 0xFF;  // partition not decoded / no class


// groups (= id slots) per partition for (class, stage); 0 when no book
inline int sym_groups(const Setup& s, const Residue& r, int cls, int stage) {
  int32_t bnum = r.books[(int64_t)cls * r.max_stages + stage];
  if (bnum < 0) return 0;
  if (!(r.cascade[cls] & (1 << stage))) return 0;
  int dims = s.books[bnum].dims;
  if (r.type == 0) return r.partition_size / dims;
  return (r.partition_size + dims - 1) / dims;
}

// Clone of residue_decode that records entry ids instead of accumulating.
// classes_out: [eff_ch * n_part] (caller pre-fills with kClassSentinel).
void residue_decode_sym(const Setup& s, const Residue& r, BitReader& br,
                        int ch, const std::vector<uint8_t>& do_not_decode,
                        int block_size, uint8_t* classes_out, int n_part_row,
                        SymSink& sink) {
  bool all_dnd = true;
  for (uint8_t d : do_not_decode) all_dnd &= (d != 0);
  if (all_dnd) return;

  int type = r.type;
  int64_t half = (type == 2) ? (int64_t)block_size * ch / 2 : block_size / 2;
  int eff_ch = (type == 2) ? 1 : ch;

  int end = (int)std::min<int64_t>(r.end, half);
  int n = end - r.begin;
  if (n <= 0) return;
  int psize = r.partition_size;
  int partitions = n / psize;
  const Codebook& cb = s.books[r.classbook];
  int cb_dims = r.cb_dims;
  int part_words = (partitions + cb_dims - 1) / cb_dims;

  std::vector<const int32_t*>& cache = scratch().cache;
  cache.assign((size_t)eff_ch * part_words, nullptr);

  for (int stage = 0; stage < r.max_stages; ++stage) {
    int pi = 0, ei = 0;
    while (pi < partitions) {
      if (stage == 0) {
        for (int c = 0; c < eff_ch; ++c) {
          if (eff_ch > 1 && do_not_decode[c]) continue;
          int idx = cb.decode_scalar(br);
          if (idx < 0 || idx >= r.partvals) return;  // bail, keep partial
          const int32_t* row = &r.decode_map[(int64_t)idx * cb_dims];
          cache[(size_t)c * part_words + ei] = row;
          for (int d = 0; d < cb_dims && pi + d < partitions; ++d)
            classes_out[(size_t)c * n_part_row + pi + d] = (uint8_t)row[d];
        }
      }
      for (int d = 0; d < cb_dims && pi < partitions; ++d, ++pi) {
        for (int c = 0; c < eff_ch; ++c) {
          if (eff_ch > 1 && do_not_decode[c]) continue;
          const int32_t* row = cache[(size_t)c * part_words + ei];
          int cls = row[d];
          if (r.cascade[cls] & (1 << stage)) {
            int32_t bnum = r.books[(int64_t)cls * r.max_stages + stage];
            if (bnum >= 0) {
              const Codebook& book = s.books[bnum];
              int groups = r.groups_tab[(int64_t)cls * r.max_stages + stage];
              for (int g = 0; g < groups; ++g) {
                int e = book.decode_scalar(br);
                if (e == -1) return;  // bail: emitted ids stay (partial data)
                sink.add(stage, c, pi, g, e);
              }
            }
          }
        }
      }
      ++ei;
    }
  }
}

// Single-effective-channel specialization (residue type 2 — all coupled
// content, the dominant case): within a stage the canonical
// (stage, ch=0, part) order IS the bitstream decode order, so ids write
// straight into their canonical slots as they decode — no sink buffer, no
// finalize scatter.  Bails leave a contiguous written prefix [0, w); the
// caller fills [w, count) with -1.  groups_tab==0 already encodes every
// skip case (cascade bit off, no book), matching the general path's bit
// consumption exactly.
int residue_decode_sym_direct(const Setup& s, const Residue& r,
                              BitReader& br, int ch, int block_size,
                              uint8_t* classes_out, int16_t* ids_out,
                              int max_ids) {
  int64_t half = (int64_t)block_size * ch / 2;  // type 2 layout
  int end = (int)std::min<int64_t>(r.end, half);
  int n = end - r.begin;
  if (n <= 0) return 0;
  int psize = r.partition_size;
  int partitions = n / psize;
  const Codebook& cb = s.books[r.classbook];
  int cb_dims = r.cb_dims;
  int part_words = (partitions + cb_dims - 1) / cb_dims;

  std::vector<const int32_t*>& cache = scratch().cache;
  cache.assign((size_t)part_words, nullptr);

  int w = 0;
  for (int stage = 0; stage < r.max_stages; ++stage) {
    int pi = 0, ei = 0;
    while (pi < partitions) {
      if (stage == 0) {
        int idx = cb.decode_scalar(br);
        if (idx < 0 || idx >= r.partvals) return w;  // bail, keep prefix
        const int32_t* row = &r.decode_map[(int64_t)idx * cb_dims];
        cache[ei] = row;
        for (int d = 0; d < cb_dims && pi + d < partitions; ++d)
          classes_out[pi + d] = (uint8_t)row[d];
      }
      for (int d = 0; d < cb_dims && pi < partitions; ++d, ++pi) {
        int cls = cache[ei][d];
        int groups = r.groups_tab[(int64_t)cls * r.max_stages + stage];
        if (groups) {
          const Codebook& book =
              s.books[r.books[(int64_t)cls * r.max_stages + stage]];
          for (int g = 0; g < groups; ++g) {
            int e = book.decode_scalar(br);
            if (e == -1) return w;  // bail, keep prefix
            if (w < max_ids) ids_out[w] = (int16_t)e;
            ++w;
          }
        }
      }
      ++ei;
    }
  }
  return w;
}

// Scatter buffered ids into the canonical (stage, ch, part)-major layout.
// Returns the layout size (total slots derived from classes); ids beyond
// max_ids are dropped (callers size max_ids from the setup so this cannot
// happen for well-formed packets).
int sym_finalize(const Setup& s, const Residue& r, const uint8_t* classes,
                 int eff_ch, int n_part, int n_part_row, int16_t* ids_out,
                 int max_ids, const SymSink& sink) {
  // prefix[(stage*eff_ch + ch)*n_part + part] = canonical slot base
  int L = r.max_stages * eff_ch * n_part;
  std::vector<int32_t>& base = scratch().base;
  base.assign((size_t)L + 1, 0);
  int32_t acc = 0;
  for (int stg = 0; stg < r.max_stages; ++stg)
    for (int c = 0; c < eff_ch; ++c)
      for (int part = 0; part < n_part; ++part) {
        base[(size_t)(stg * eff_ch + c) * n_part + part] = acc;
        uint8_t cls = classes[(size_t)c * n_part_row + part];
        if (cls != kClassSentinel)
          acc += r.groups_tab[(int64_t)cls * r.max_stages + stg];
      }
  base[L] = acc;
  int count = std::min(acc, max_ids);
  for (int i = 0; i < count; ++i) ids_out[i] = -1;
  for (const SymEntry& e : sink.entries) {
    int32_t slot =
        base[(size_t)(e.stage * eff_ch + e.ch) * n_part + e.part] + e.gidx;
    if (slot < max_ids) ids_out[slot] = (int16_t)e.id;
  }
  return count;
}

// ------------------------------------------------------------ packet unpack

// meta layout per packet: [status, mode_idx, window_index, bits_read,
//                          total_bits, 0, 0, 0]
// status: 1 = audio frame; 0 = not audio; -1 = malformed (treated as bad)
void unpack_one(const Setup& s, const uint8_t* bytes, int64_t nbytes,
                float* residue_out,  // [C, n2max]
                int32_t* ys_out,     // [C, P]
                uint8_t* used_out,   // [C, P]
                uint8_t* has_floor_out,  // [C]
                int32_t* meta) {
  int C = s.channels;
  int P = s.max_posts;
  BitReader br(bytes, nbytes);
  std::memset(meta, 0, sizeof(int32_t) * 8);
  meta[4] = (int32_t)br.nbits;
  if (s.f0_max_order) {  // Floor0 has no ys-posts form: spec mode only
    meta[0] = -1;        // (python gates via NativeUnpacker.spec_only;
    return;              // this is defense in depth)
  }

  if (br.read_bit()) {  // not an audio packet
    meta[0] = 0;
    meta[3] = (int32_t)br.pos;
    return;
  }
  int mode_idx = (int)br.read(s.mode_field_bits);
  // NVorbis/Mode.cs:119-127: a packet exhausted before the window flags is
  // not decodable (mirrors the python path's is_short check)
  if (mode_idx >= (int)s.modes.size() || br.is_short) {
    meta[0] = -1;
    meta[3] = (int32_t)br.pos;
    return;
  }
  const Mode& mode = s.modes[mode_idx];
  int window_index = 0;
  if (mode.block_flag) {
    bool prev_flag = br.read_bit();
    bool next_flag = br.read_bit();
    window_index = (prev_flag ? 1 : 0) + (next_flag ? 2 : 0);
  }
  const Mapping& mapping = s.mappings[mode.mapping_idx];
  int n = mode.block_size;
  int n2 = n / 2;

  // floors, per channel (NVorbis/Mapping.cs:100-109)
  for (int c = 0; c < C; ++c) {
    const Floor1& f = s.floors[mapping.submap_floor[mapping.mux[c]]];
    bool hf = floor1_unpack(s, f, br, &ys_out[(int64_t)c * P],
                            &used_out[(int64_t)c * P], P);
    has_floor_out[c] = hf ? 1 : 0;
  }

  // coupling no-energy propagation (NVorbis/Mapping.cs:112-119)
  std::vector<uint8_t>& execute = scratch().execute;
  execute.assign(has_floor_out, has_floor_out + C);
  for (int i = 0; i < mapping.coupling_count; ++i) {
    int m = mapping.mag[i], a = mapping.ang[i];
    if (execute[m] || execute[a]) execute[m] = execute[a] = 1;
  }

  // residues per submap (NVorbis/Mapping.cs:121-134)
  std::vector<float*>& bufs = scratch().bufs;
  std::vector<uint8_t>& dnd = scratch().dnd;
  for (int i = 0; i < mapping.submap_count; ++i) {
    bufs.clear();
    dnd.clear();
    for (int c = 0; c < C; ++c) {
      if (mapping.mux[c] == i) {
        bufs.push_back(&residue_out[(int64_t)c * s.n2max]);
        dnd.push_back(execute[c] ? 0 : 1);
      }
    }
    const Residue& r = s.residues[mapping.submap_residue[i]];
    residue_decode(s, r, br, bufs, dnd, n);
  }

  meta[0] = 1;
  meta[1] = mode_idx;
  meta[2] = window_index;
  meta[3] = (int32_t)br.pos;
  (void)n2;
}

// ------------------------------------------------------- spectrum mode

// Multiply one channel's floor curve into its residue row, fusing the
// polyline render (exact integer form of codec/floor.py:render_polyline —
// same enclosing-used-post pairs, same min(hx, n2) slope clip quirk,
// Floor1.Apply + RenderLineMulti, NVorbis/Floor1.cs:186-222, 316-341) with
// the inverse-dB lookup and the spectrum multiply
// (NVorbis/Mapping.cs:184-191).  Posts arrive in sorted-x order
// (floor1_unpack applies sort_idx; ys are post-multiplier).
// `xmax` clamps the STORES only (bins at/after xmax are known-zero residue
// — the caller's residue write bound); segment geometry (the adx clip
// quirk) still uses n2, so rendered values below xmax are bit-identical
// to an unclamped render.  Pass xmax = n2 for the full multiply.
void floor_apply(const Floor1& f, const float* inv_db, const int32_t* ys,
                 const uint8_t* used, int n2, float* row, bool use_div,
                 bool use_inc, int xmax) {
  int p = f.post_count;
  const int32_t* xs = f.xs_sorted;
  int prev = -1;
  int x_cursor = 0;
  for (int i = 0; i < p && x_cursor < xmax; ++i) {
    if (!used[i]) continue;
    if (prev < 0) {
      prev = i;
      continue;  // xs_sorted[0] == 0 and post 0 is always used when the
                 // floor decoded, so no bins precede the first used post
    }
    int lx = xs[prev];
    int64_t ly = ys[prev];
    int hx = xs[i];
    int64_t dy = (int64_t)ys[i] - ly;
    int64_t ady = dy < 0 ? -dy : dy;
    int end = hx < n2 ? hx : n2;
    int64_t adx = (int64_t)end - lx;  // min(hx, n2) - lx: the clip quirk
    int x = lx > x_cursor ? lx : x_cursor;
    const int send = end < xmax ? end : xmax;  // store bound
    if (adx > 0) {
      if (use_div) {
        // closed-form reference (NVT_FLOOR_DIV=1): one integer division
        // per bin, kept as the A/B twin of the incremental renderer
        for (; x < send; ++x) {
          int64_t off = (int64_t)(x - lx) * ady / adx;
          int64_t y = ly + (dy < 0 ? -off : off);
          y = y < 0 ? 0 : (y > 255 ? 255 : y);
          row[x] *= inv_db[y];
        }
      } else if (adx >= 4 && !use_inc) {
        // division-free CLOSED form: off(x) = (x-lx)*ady/adx computed
        // per bin via a per-segment magic reciprocal — exact
        // (m = 2^39/adx + 1; num*(adx - 2^39 mod adx) < 2^39 holds for
        // num = d*ady <= 2^21 and adx <= 2048), and every bin is
        // INDEPENDENT, so out-of-order execution overlaps iterations
        // that the incremental (base/err) renderer's serial carry chain
        // forced to retire one at a time.  When both endpoint y values
        // sit in [0, 255] (the overwhelmingly common case), the
        // monotone line never needs the per-bin clamp either.
        // NB: no zero-bin skip here — 62% of long-block bins ARE zero,
        // but they interleave with nonzeros mid-spectrum and the
        // data-dependent branch mispredicted so badly the loop ran 3x
        // SLOWER (0.86 -> 2.6 Gcyc measured); the unconditional
        // multiply is the fast form.  The all-zero TAIL (after the
        // last used post) keeps its skip below — those zeros cluster.
        const int64_t m = (int64_t)((1ll << 39) / adx) + 1;
        const int64_t yend = ly + dy;  // exact endpoint (off(hx) = ady)
        if (ly >= 0 && ly <= 255 && yend >= 0 && yend <= 255) {
          if (dy < 0) {
            for (; x < send; ++x) {
              int64_t num = (int64_t)(x - lx) * ady;
              int64_t y = ly - ((num * m) >> 39);
              row[x] *= inv_db[y];
            }
          } else {
            for (; x < send; ++x) {
              int64_t num = (int64_t)(x - lx) * ady;
              int64_t y = ly + ((num * m) >> 39);
              row[x] *= inv_db[y];
            }
          }
        } else {
          for (; x < send; ++x) {
            int64_t num = (int64_t)(x - lx) * ady;
            int64_t off = (num * m) >> 39;
            int64_t y = ly + (dy < 0 ? -off : off);
            y = y < 0 ? 0 : (y > 255 ? 255 : y);
            row[x] *= inv_db[y];
          }
        }
      } else {
        // incremental renderer: off(x) = (x-lx)*ady/adx advanced by
        // (base, remainder-carry) per bin — integer-exact equal to the
        // closed form (off*adx + err == (x-lx)*ady with 0 <= err < adx
        // is the loop invariant), two divisions per SEGMENT instead of
        // one per bin.  Same scheme as the reference's own renderer
        // (NVorbis/Floor1.cs RenderLineMulti, 316-341).
        int64_t base = ady / adx;
        int64_t rem = ady - base * adx;
        int64_t d0 = (int64_t)x - lx;
        int64_t off = d0 * ady / adx;
        int64_t err = d0 * ady - off * adx;
        for (; x < send; ++x) {
          int64_t y = ly + (dy < 0 ? -off : off);
          y = y < 0 ? 0 : (y > 255 ? 255 : y);
          row[x] *= inv_db[y];
          off += base;
          err += rem;
          if (err >= adx) {
            err -= adx;
            ++off;
          }
        }
      }
    } else {
      int64_t y = ly < 0 ? 0 : (ly > 255 ? 255 : ly);
      const float m = inv_db[y];
      for (; x < send; ++x) {
        float v = row[x];
        if (v != 0.0f) row[x] = v * m;
      }
    }
    if (end > x_cursor) x_cursor = end;
    prev = i;
  }
  if (prev >= 0 && x_cursor < xmax) {
    // bins at/after the last used post hold its y; this tail region is
    // mostly untouched (zero) residue — the skip leaves it zero
    int64_t y = ys[prev] < 0 ? 0 : (ys[prev] > 255 ? 255 : ys[prev]);
    const float m = inv_db[y];
    for (int x = x_cursor; x < xmax; ++x) {
      float v = row[x];
      if (v != 0.0f) row[x] = v * m;
    }
  }
}

// Spectrum-mode variant of unpack_one: emits the ready-to-IMDCT spectrum
// (residue decode -> inverse coupling -> floor multiply, the full
// NVorbis/Mapping.DecodePacket:95-198 pipeline minus the transform).  The
// host engine (engine/host.py) feeds these rows straight into its DCT-IV.
// Floor posts stay in per-thread scratch; only spec + meta leave.
void unpack_one_spec(const Setup& s, const uint8_t* bytes, int64_t nbytes,
                     float* spec_out,  // [C, stride] (stride >= frame n2)
                     int32_t* meta, int64_t stride) {
  int C = s.channels;
  int P = s.max_posts;
  BitReader br(bytes, nbytes);
  std::memset(meta, 0, sizeof(int32_t) * 8);
  meta[4] = (int32_t)br.nbits;

  if (br.read_bit()) {
    meta[0] = 0;
    meta[3] = (int32_t)br.pos;
    return;
  }
  int mode_idx = (int)br.read(s.mode_field_bits);
  if (mode_idx >= (int)s.modes.size() || br.is_short) {
    meta[0] = -1;
    meta[3] = (int32_t)br.pos;
    return;
  }
  const Mode& mode = s.modes[mode_idx];
  int window_index = 0;
  if (mode.block_flag) {
    bool prev_flag = br.read_bit();
    bool next_flag = br.read_bit();
    window_index = (prev_flag ? 1 : 0) + (next_flag ? 2 : 0);
  }
  const Mapping& mapping = s.mappings[mode.mapping_idx];
  int n = mode.block_size;
  int n2 = n / 2;

  const bool cyc = cycles_on();
  uint64_t t0 = cyc ? tsc() : 0;

  // Per-channel residue write bound for this (mapping, block size): no
  // residue store can land at/after bin `lim` (type 1/2 vectors overshoot
  // `end` by < wr_slack, clamped at half; type 2 interleaves over the
  // submap's channels), and coupling/floor preserve zeros — so the
  // coupling pass and both floor multiplies clamp their work to `lim`.
  // The stage-0 memset still zeroes [0, n2): the caller hands np.empty
  // rows, so the tail must be zeroed exactly once here.
  int lim = 0;
  for (int i = 0; i < mapping.submap_count; ++i) {
    int chs = 0;
    for (int c = 0; c < C; ++c)
      if (mapping.mux[c] == i) ++chs;
    if (!chs) continue;
    const Residue& r = s.residues[mapping.submap_residue[i]];
    int64_t half = (r.type == 2) ? (int64_t)n2 * chs : (int64_t)n2;
    int64_t ext = (int64_t)r.end + r.wr_slack;
    if (ext > half) ext = half;
    int l = (r.type == 2) ? (int)((ext + chs - 1) / chs) : (int)ext;
    if (l > lim) lim = l;
  }
  if (lim > n2) lim = n2;

  Scratch& sc = scratch();
  sc.spec_ys.assign((size_t)C * P, 0);
  sc.spec_used.assign((size_t)C * P, 0);
  sc.execute.assign(C, 0);
  if (s.f0_max_order) {
    sc.f0_amp.assign(C, 0.0f);
    sc.f0_coeffs.assign((size_t)C * (s.f0_max_order + 1), 0.0f);
  }
  for (int c = 0; c < C; ++c) {
    const int fi = mapping.submap_floor[mapping.mux[c]];
    if (s.floor_types[fi] == 0) {
      sc.execute[c] = floor0_unpack(
          s, s.floor0s[fi], br, &sc.f0_amp[c],
          &sc.f0_coeffs[(size_t)c * (s.f0_max_order + 1)]) ? 1 : 0;
    } else {
      const Floor1& f = s.floors[fi];
      sc.execute[c] = floor1_unpack(s, f, br, &sc.spec_ys[(size_t)c * P],
                                    &sc.spec_used[(size_t)c * P], P)
                          ? 1 : 0;
    }
    std::memset(spec_out + (int64_t)c * stride, 0, sizeof(float) * n2);
  }
  if (cyc) {
    uint64_t t1 = tsc();
    g_cycles[0] += t1 - t0;
    t0 = t1;
  }
  if (cyc) {  // memset share probe: re-time stage-0's zeroing in isolation
    uint64_t tm = tsc();
    for (int c = 0; c < C; ++c)
      std::memset(spec_out + (int64_t)c * stride, 0, sizeof(float) * n2);
    g_cycles[4] += tsc() - tm;
    t0 = tsc();
  }
  std::vector<uint8_t>& has_floor = sc.has_floor;
  has_floor.assign(sc.execute.begin(), sc.execute.end());

  // coupling no-energy propagation (NVorbis/Mapping.cs:112-119)
  for (int i = 0; i < mapping.coupling_count; ++i) {
    int m = mapping.mag[i], a = mapping.ang[i];
    if (sc.execute[m] || sc.execute[a]) sc.execute[m] = sc.execute[a] = 1;
  }

  std::vector<float*>& bufs = sc.bufs;
  std::vector<uint8_t>& dnd = sc.dnd;
  for (int i = 0; i < mapping.submap_count; ++i) {
    bufs.clear();
    dnd.clear();
    for (int c = 0; c < C; ++c) {
      if (mapping.mux[c] == i) {
        bufs.push_back(&spec_out[(int64_t)c * stride]);
        dnd.push_back(sc.execute[c] ? 0 : 1);
      }
    }
    const Residue& r = s.residues[mapping.submap_residue[i]];
    residue_decode(s, r, br, bufs, dnd, n);
  }
  if (cyc) {
    uint64_t t1 = tsc();
    g_cycles[1] += t1 - t0;
    t0 = t1;
  }

  // inverse square-polar coupling, reverse step order, exact float ops
  // (NVorbis/Mapping.cs:137-182; codec/frames.py:apply_inverse_coupling)
  for (int i = mapping.coupling_count - 1; i >= 0; --i) {
    int m = mapping.mag[i], a = mapping.ang[i];
    if (!(sc.execute[m] || sc.execute[a])) continue;
    float* rm = &spec_out[(int64_t)m * stride];
    float* ra = &spec_out[(int64_t)a * stride];
    for (int x = 0; x < lim; ++x) {  // bins >= lim are (0, 0) -> (0, 0)
      float M = rm[x], A = ra[x], nm, na;
      if (M > 0.0f) {
        if (A > 0.0f) { nm = M; na = M - A; }
        else          { nm = M + A; na = M; }
      } else {
        if (A > 0.0f) { nm = M; na = M + A; }
        else          { nm = M - A; na = M; }
      }
      rm[x] = nm; ra[x] = na;
    }
  }

  if (cyc) {
    uint64_t t1 = tsc();
    g_cycles[2] += t1 - t0;
    t0 = t1;
  }

  // floor multiply; channels without their own floor energy are silence
  // even when coupling forced their residue (Mapping.cs:192-196,
  // Floor1.cs:218-221)
  for (int c = 0; c < C; ++c) {
    float* row = &spec_out[(int64_t)c * stride];
    if (!has_floor[c]) {
      std::memset(row, 0, sizeof(float) * lim);  // the tail is still zero
      continue;
    }
    const int fi = mapping.submap_floor[mapping.mux[c]];
    if (s.floor_types[fi] == 0) {
      const Floor0c& f0 = s.floor0s[fi];
      const bool short_blk = (n2 == s.block0 / 2);
      floor0_apply(f0, short_blk ? f0.bark0 : f0.bark1,
                   short_blk ? f0.w0 : f0.w1, n2, sc.f0_amp[c],
                   &sc.f0_coeffs[(size_t)c * (s.f0_max_order + 1)], row,
                   lim);
      continue;
    }
    const Floor1& f = s.floors[fi];
    floor_apply(f, s.inv_db, &sc.spec_ys[(size_t)c * P],
                &sc.spec_used[(size_t)c * P], n2, row, s.floor_div,
                s.floor_inc, lim);
  }
  if (cyc) g_cycles[3] += tsc() - t0;

  meta[0] = 1;
  meta[1] = mode_idx;
  meta[2] = window_index;
  meta[3] = (int32_t)br.pos;
}

// Symbol-mode variant of unpack_one: floors as usual, residues emitted as
// classes + canonical ids (single-submap setups only; the caller gates).
// meta[5] = id count (canonical layout size).
void unpack_one_sym(const Setup& s, const uint8_t* bytes, int64_t nbytes,
                    uint8_t* classes_out,  // [CHR_max, n_part_max]
                    int16_t* ids_out,      // [max_ids]
                    int32_t* ys_out, uint8_t* used_out, uint8_t* has_floor_out,
                    int32_t* meta, int n_part_max, int chr_max, int max_ids) {
  int C = s.channels;
  int P = s.max_posts;
  BitReader br(bytes, nbytes);
  std::memset(meta, 0, sizeof(int32_t) * 8);
  std::memset(classes_out, kClassSentinel, (size_t)chr_max * n_part_max);
  meta[4] = (int32_t)br.nbits;
  if (s.f0_max_order) {  // Floor0: spec mode only (see unpack_one)
    meta[0] = -1;
    return;
  }

  if (br.read_bit()) {
    meta[0] = 0;
    meta[3] = (int32_t)br.pos;
    return;
  }
  int mode_idx = (int)br.read(s.mode_field_bits);
  if (mode_idx >= (int)s.modes.size() || br.is_short) {
    meta[0] = -1;
    meta[3] = (int32_t)br.pos;
    return;
  }
  const Mode& mode = s.modes[mode_idx];
  int window_index = 0;
  if (mode.block_flag) {
    bool prev_flag = br.read_bit();
    bool next_flag = br.read_bit();
    window_index = (prev_flag ? 1 : 0) + (next_flag ? 2 : 0);
  }
  const Mapping& mapping = s.mappings[mode.mapping_idx];
  int n = mode.block_size;

  for (int c = 0; c < C; ++c) {
    const Floor1& f = s.floors[mapping.submap_floor[mapping.mux[c]]];
    bool hf = floor1_unpack(s, f, br, &ys_out[(int64_t)c * P],
                            &used_out[(int64_t)c * P], P);
    has_floor_out[c] = hf ? 1 : 0;
  }

  std::vector<uint8_t>& execute = scratch().execute;
  execute.assign(has_floor_out, has_floor_out + C);
  for (int i = 0; i < mapping.coupling_count; ++i) {
    int m = mapping.mag[i], a = mapping.ang[i];
    if (execute[m] || execute[a]) execute[m] = execute[a] = 1;
  }

  const Residue& r = s.residues[mapping.submap_residue[0]];
  std::vector<uint8_t>& dnd = scratch().dnd;
  dnd.clear();
  for (int c = 0; c < C; ++c) dnd.push_back(execute[c] ? 0 : 1);

  int64_t half = (r.type == 2) ? (int64_t)n * C / 2 : n / 2;
  int eff_ch = (r.type == 2) ? 1 : C;
  int end = (int)std::min<int64_t>(r.end, half);
  int n_part = std::max(0, (end - r.begin) / r.partition_size);
  int count;
  bool all_dnd = true;
  for (int c = 0; c < C; ++c) all_dnd &= (dnd[c] != 0);
  if (eff_ch == 1) {
    int w = 0;
    if (!all_dnd)
      w = residue_decode_sym_direct(s, r, br, C, n, classes_out, ids_out,
                                    max_ids);
    int64_t acc = 0;  // slot count from the (possibly partial) classes
    for (int stg = 0; stg < r.max_stages; ++stg)
      for (int part = 0; part < n_part; ++part) {
        uint8_t cls = classes_out[part];
        if (cls != kClassSentinel)
          acc += r.groups_tab[(int64_t)cls * r.max_stages + stg];
      }
    count = (int)std::min<int64_t>(acc, max_ids);
    for (int i = w; i < count; ++i) ids_out[i] = -1;
  } else {
    SymSink& sink = scratch().sink;
    sink.entries.clear();
    residue_decode_sym(s, r, br, C, dnd, n, classes_out, n_part_max, sink);
    count = sym_finalize(s, r, classes_out, eff_ch, n_part, n_part_max,
                         ids_out, max_ids, sink);
  }

  meta[0] = 1;
  meta[1] = mode_idx;
  meta[2] = window_index;
  meta[3] = (int32_t)br.pos;
  meta[5] = count;
}

}  // namespace

namespace {
struct FrameSrc {
  const int64_t* fbuck;      // [nF+1] bucket id, -1 = carry row
  const int64_t* frow;       // [nF+1] row group within bucket
  const int32_t* fns;        // [nF+1] block size n
  const float* const* gs;    // bucket base pointers
  const float* const* fwin;  // [nF+1] window row (length n)
  const float* carry_row;    // [C, n_max]
  int64_t n_max;
  int32_t C;
};

// Emit one (frame, channel) slice [off, off+L) into o (stride C),
// storing (Add=false) or accumulating (Add=true), applying `fin` to
// elements at t >= fin_from (the final-value positions).
template <bool Add, typename Fin>
inline void emit_role(const FrameSrc& fs, int64_t f, int c, int64_t off,
                      int64_t L, float* o, int32_t C, int64_t fin_from,
                      Fin&& fin) {
  if (fs.fbuck[f] < 0) {  // carry row: already finished+windowed
    const float* p = fs.carry_row + (int64_t)c * fs.n_max + off;
    for (int64_t t = 0; t < L; ++t) {
      float v = Add ? o[t * C + c] + p[t] : p[t];
      o[t * C + c] = t >= fin_from ? fin(v) : v;
    }
    return;
  }
  const int n = fs.fns[f];
  const int n2 = n / 2, n4 = n / 4;
  const float* g = fs.gs[fs.fbuck[f]] + (fs.frow[f] * C + c) * (int64_t)n2;
  const float* w = fs.fwin[f];
  int64_t t = 0;
  // region A: x in [0, n4): v = (g[n4+x] * 0.5f) * w[x]
  for (int64_t hi = std::min<int64_t>(L, n4 - off); t < hi; ++t) {
    int64_t x = off + t;
    float v = (g[n4 + x] * 0.5f) * w[x];
    if (Add) v += o[t * C + c];
    o[t * C + c] = t >= fin_from ? fin(v) : v;
  }
  // region B: x in [n4, 3n4): v = (-g[3n4-1-x] * 0.5f) * w[x]
  for (int64_t hi = std::min<int64_t>(L, 3 * (int64_t)n4 - off); t < hi;
       ++t) {
    int64_t x = off + t;
    float v = (-g[3 * n4 - 1 - x] * 0.5f) * w[x];
    if (Add) v += o[t * C + c];
    o[t * C + c] = t >= fin_from ? fin(v) : v;
  }
  // region C: x in [3n4, n)
  for (; t < L; ++t) {
    int64_t x = off + t;
    float v = (-g[x - 3 * n4] * 0.5f) * w[x];
    if (Add) v += o[t * C + c];
    o[t * C + c] = t >= fin_from ? fin(v) : v;
  }
}

// Interleaved all-channels emit: same values and op order as C calls of
// emit_role, but ONE contiguous pass over the interleaved output instead
// of C stride-C passes (the 6-pass walk was 40% of a 5.1 decode; writes
// revisit every output cache line C*samples/line times).  Channel g rows
// are hoisted into a pointer array; capped at kMaxChI channels (callers
// fall back to the per-channel walk above beyond that).
constexpr int kMaxChI = 16;

// CT > 0: compile-time channel count (the c-loops fully unroll; 2/4/6/8
// cover every common layout); CT == -1: dynamic fallback.
template <bool Add, int CT, typename Fin>
inline void emit_all(const FrameSrc& fs, int64_t f, int64_t off, int64_t L,
                     float* o, int32_t C_dyn, int64_t fin_from, Fin&& fin) {
  const int C = CT > 0 ? CT : C_dyn;
  const float* gp[kMaxChI];
  if (fs.fbuck[f] < 0) {  // carry row: already finished+windowed
    for (int c = 0; c < C; ++c)
      gp[c] = fs.carry_row + (int64_t)c * fs.n_max + off;
    for (int64_t t = 0; t < L; ++t) {
      float* ot = o + t * C;
      const bool fi = t >= fin_from;
      for (int c = 0; c < C; ++c) {
        float v = Add ? ot[c] + gp[c][t] : gp[c][t];
        ot[c] = fi ? fin(v) : v;
      }
    }
    return;
  }
  const int n = fs.fns[f];
  const int n2 = n / 2, n4 = n / 4;
  const float* g0 = fs.gs[fs.fbuck[f]] + (fs.frow[f] * C) * (int64_t)n2;
  for (int c = 0; c < C; ++c) gp[c] = g0 + (int64_t)c * n2;
  const float* w = fs.fwin[f];
  int64_t t = 0;
  // region A: x in [0, n4): v = (g[n4+x] * 0.5f) * w[x]
  for (int64_t hi = std::min<int64_t>(L, n4 - off); t < hi; ++t) {
    int64_t x = off + t;
    float* ot = o + t * C;
    const bool fi = t >= fin_from;
    for (int c = 0; c < C; ++c) {
      float v = (gp[c][n4 + x] * 0.5f) * w[x];
      if (Add) v += ot[c];
      ot[c] = fi ? fin(v) : v;
    }
  }
  // region B: x in [n4, 3n4): v = (-g[3n4-1-x] * 0.5f) * w[x]
  for (int64_t hi = std::min<int64_t>(L, 3 * (int64_t)n4 - off); t < hi;
       ++t) {
    int64_t x = off + t;
    float* ot = o + t * C;
    const bool fi = t >= fin_from;
    for (int c = 0; c < C; ++c) {
      float v = (-gp[c][3 * n4 - 1 - x] * 0.5f) * w[x];
      if (Add) v += ot[c];
      ot[c] = fi ? fin(v) : v;
    }
  }
  // region C: x in [3n4, n)
  for (; t < L; ++t) {
    int64_t x = off + t;
    float* ot = o + t * C;
    const bool fi = t >= fin_from;
    for (int c = 0; c < C; ++c) {
      float v = (-gp[c][x - 3 * n4] * 0.5f) * w[x];
      if (Add) v += ot[c];
      ot[c] = fi ? fin(v) : v;
    }
  }
}

// ---- single-store lapped-prefix emit (pair of frames, region-precut) ----
//
// The two-pass form stores the lapped prefix raw, then reloads it for the
// secondary add: ~5 memory touches per lapped sample.  This form computes
// fin(sec + prim) in one store — but WITHOUT the per-element region
// compares that made a naive combined pass lose an A/B (see the note in
// nvt_finish_ola): the prefix is pre-split at the region breakpoints of
// BOTH frames (<= 5 sub-segments), and each sub-segment runs a tight
// fixed-formula loop selected from 16 (regionP x regionS) template
// instantiations.  Per-element ops and their order match the two-pass
// form exactly (float add is commutative bitwise), so outputs are
// bit-equal.

// region value: 0 = A, 1 = B, 2 = C (emit_role's finish formulas),
// 3 = carry row (pre-offset pointer, indexed by t)
template <int R>
inline float reg_val(const float* g, const float* w, int n4, int64_t x,
                     int64_t t) {
  if constexpr (R == 0) return (g[n4 + x] * 0.5f) * w[x];
  if constexpr (R == 1) return (-g[3 * n4 - 1 - x] * 0.5f) * w[x];
  if constexpr (R == 2) return (-g[x - 3 * n4] * 0.5f) * w[x];
  return g[t];  // R == 3
}

template <int CT, int RP, int RS, typename Fin>
inline void pair_loop(const float* const* gP, const float* wP, int nP4,
                      int64_t poff, const float* const* gS,
                      const float* wS, int nS4, int64_t soff, int64_t t0,
                      int64_t t1, float* o, int C_dyn, Fin&& fin) {
  const int C = CT > 0 ? CT : C_dyn;
  // __restrict copies: 2C+3 live pointers exceed gcc's alias-versioning
  // budget (the two-frame form has more streams than emit_all), which
  // silently dropped this loop to scalar — the sources never alias the
  // output, so promise it
  const float* __restrict g1[kMaxChI];
  const float* __restrict g2[kMaxChI];
  for (int c = 0; c < C; ++c) { g1[c] = gP[c]; g2[c] = gS[c]; }
  const float* __restrict w1 = wP;
  const float* __restrict w2 = wS;
  float* __restrict orr = o;
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t xP = poff + t, xS = soff + t;
    float* __restrict ot = orr + t * C;
    for (int c = 0; c < C; ++c) {
      float vp = reg_val<RP>(g1[c], w1, nP4, xP, t);
      float vs = reg_val<RS>(g2[c], w2, nS4, xS, t);
      ot[c] = fin(vs + vp);
    }
  }
}

// one frame's per-channel source pointers + region geometry
struct PairSide {
  const float* gp[kMaxChI];
  const float* w = nullptr;
  int n4 = 0;
  bool carry = false;
};

inline void pair_side_init(const FrameSrc& fs, int64_t f, int64_t off,
                           int C, PairSide& ps) {
  if (fs.fbuck[f] < 0) {
    ps.carry = true;
    for (int c = 0; c < C; ++c)
      ps.gp[c] = fs.carry_row + (int64_t)c * fs.n_max + off;
    return;
  }
  const int n = fs.fns[f];
  const int n2 = n / 2;
  ps.n4 = n / 4;
  const float* g0 = fs.gs[fs.fbuck[f]] + (fs.frow[f] * C) * (int64_t)n2;
  for (int c = 0; c < C; ++c) ps.gp[c] = g0 + (int64_t)c * n2;
  ps.w = fs.fwin[f];
}

// region of x for a finish-mapped frame: A [0,n4), B [n4,3n4), C [3n4,n)
inline int reg_of(int64_t x, int n4) {
  return x < n4 ? 0 : (x < 3 * n4 ? 1 : 2);
}
inline int64_t reg_end(int64_t x, int n4) {
  return x < n4 ? n4 : (x < 3 * n4 ? 3 * (int64_t)n4 : INT64_MAX);
}

template <int CT, typename Fin>
inline void emit_pair_all(const FrameSrc& fs, int64_t fp, int64_t poff,
                          int64_t fsec, int64_t soff, int64_t S, float* o,
                          int32_t C_dyn, Fin&& fin) {
  const int C = CT > 0 ? CT : C_dyn;
  PairSide P, Q;
  pair_side_init(fs, fp, poff, C, P);
  pair_side_init(fs, fsec, soff, C, Q);
  int64_t t = 0;
  while (t < S) {
    int rp = P.carry ? 3 : reg_of(poff + t, P.n4);
    int rs = Q.carry ? 3 : reg_of(soff + t, Q.n4);
    int64_t hi = S;
    if (!P.carry) {
      int64_t e = reg_end(poff + t, P.n4) - poff;
      if (e < hi) hi = e;
    }
    if (!Q.carry) {
      int64_t e = reg_end(soff + t, Q.n4) - soff;
      if (e < hi) hi = e;
    }
    switch (rp * 4 + rs) {
#define NVT_PAIR_CASE(RP, RS)                                          \
  case RP * 4 + RS:                                                    \
    pair_loop<CT, RP, RS>(P.gp, P.w, P.n4, poff, Q.gp, Q.w, Q.n4,      \
                          soff, t, hi, o, C, fin);                     \
    break;
      NVT_PAIR_CASE(0, 0) NVT_PAIR_CASE(0, 1) NVT_PAIR_CASE(0, 2)
      NVT_PAIR_CASE(0, 3) NVT_PAIR_CASE(1, 0) NVT_PAIR_CASE(1, 1)
      NVT_PAIR_CASE(1, 2) NVT_PAIR_CASE(1, 3) NVT_PAIR_CASE(2, 0)
      NVT_PAIR_CASE(2, 1) NVT_PAIR_CASE(2, 2) NVT_PAIR_CASE(2, 3)
      NVT_PAIR_CASE(3, 0) NVT_PAIR_CASE(3, 1) NVT_PAIR_CASE(3, 2)
      NVT_PAIR_CASE(3, 3)
#undef NVT_PAIR_CASE
    }
    t = hi;
  }
}

// ---- non-temporal tile emit -------------------------------------------
//
// The OLA output is written once and never re-read inside the kernel, but
// regular stores read-for-ownership every destination cache line first —
// for a 6-channel decode that is an extra ~227 MB of DRAM reads per
// round.  Strategy: compute each segment in L1-resident tiles through the
// existing vectorized emit loops, then stream the tile to the real
// destination with non-temporal stores (values bit-identical — the copy
// is exact).  AVX-512 only (the -march=native build on the target host);
// portable builds take the plain path.

#ifdef __AVX512F__
#include <immintrin.h>

inline void nt_copy(float* dst, const float* src, int64_t n) {
  int64_t i = 0;
  // scalar head until dst is 64-byte aligned
  while (i < n && (((uintptr_t)(dst + i)) & 63)) { dst[i] = src[i]; ++i; }
  for (; i + 16 <= n; i += 16)
    _mm512_stream_ps(dst + i, _mm512_loadu_ps(src + i));
  for (; i < n; ++i) dst[i] = src[i];
}
constexpr bool kHaveNT = true;
#else
inline void nt_copy(float* dst, const float* src, int64_t n) {
  std::memcpy(dst, src, (size_t)n * sizeof(float));
}
constexpr bool kHaveNT = false;
#endif

}  // namespace

// ------------------------------------------------------------------ C API

extern "C" {

// Parse the serialized setup blobs; returns nullptr when the setup cannot be
// handled natively (e.g. contains a Floor0).
void* nvt_setup_create(const int32_t* blob_i, int64_t ni, const float* blob_f,
                       int64_t nf) {
  if (ni < 13 || blob_i[0] != kMagic) return nullptr;
  Setup* s = new Setup();
  s->no_t2ch2 = std::getenv("NVT_NO_T2CH2") != nullptr;
  s->no_tgen = std::getenv("NVT_NO_TGEN") != nullptr;
  s->floor_div = std::getenv("NVT_FLOOR_DIV") != nullptr;
  s->floor_inc = std::getenv("NVT_FLOOR_INC") != nullptr;
  s->blob_i.assign(blob_i, blob_i + ni);
  s->blob_f.assign(blob_f, blob_f + nf);
  const int32_t* p = s->blob_i.data();
  const float* fp = s->blob_f.data();

  int64_t i = 1;
  s->channels = p[i++];
  s->mode_field_bits = p[i++];
  int n_books = p[i++];
  int n_floors = p[i++];
  int n_residues = p[i++];
  int n_mappings = p[i++];
  int n_modes = p[i++];
  s->max_posts = p[i++];
  s->block0 = p[i++];
  s->block1 = p[i++];
  s->n2max = p[i++];
  int64_t inv_db_off = p[i++];  // index into blob_f; -1 = absent
  s->inv_db = (inv_db_off >= 0 && inv_db_off + 256 <= nf)
                  ? &fp[inv_db_off] : nullptr;

  for (int b = 0; b < n_books; ++b) {
    Codebook cb;
    cb.dims = p[i++]; cb.entries = p[i++]; cb.table_bits = p[i++];
    cb.max_bits = p[i++]; cb.ov_count = p[i++];
    int has_lookup = p[i++];
    int64_t lookup_off = p[i++];
    int64_t tbl = 1ll << cb.table_bits;
    const int32_t* tv = &p[i]; i += tbl;
    const int32_t* tl = &p[i]; i += tbl;
    std::vector<int64_t> pk((size_t)tbl);
    for (int64_t k = 0; k < tbl; ++k)
      pk[(size_t)k] = ((int64_t)tl[k] << 32) | (uint32_t)tv[k];
    s->tbl_packs.push_back(std::move(pk));
    cb.tbl_pack = s->tbl_packs.back().data();
    cb.ov = &p[i]; i += (int64_t)cb.ov_count * 4;
    cb.lookup = has_lookup ? &fp[lookup_off] : nullptr;
    s->books.push_back(cb);
  }
  for (int f = 0; f < n_floors; ++f) {
    int type = p[i++];
    s->floor_types.push_back(type);
    if (type == 0) {
      // Floor0 (LSP): bark/w maps precomputed host-side travel in the
      // blobs; spectrum-mode unpack evaluates the curve natively.  The
      // dense (ys-posts) plane has no Floor0 representation — python
      // gates those paths (NativeUnpacker.spec_only).
      Floor0c f0{};
      f0.order = p[i++]; f0.amp_bits = p[i++]; f0.amp_ofs = p[i++];
      f0.book_bits = p[i++]; f0.n_books = p[i++];
      f0.book_idx = &p[i]; i += f0.n_books;
      f0.bark0 = &p[i]; i += s->block0 / 2 + 1;
      f0.bark1 = &p[i]; i += s->block1 / 2 + 1;
      int w0o = p[i++], w1o = p[i++];
      f0.w0 = fp + w0o;
      f0.w1 = fp + w1o;
      if (f0.order < 1 || f0.order > 255 || f0.amp_bits < 0 ||
          f0.amp_bits > 63 || f0.n_books < 1) {
        delete s;
        return nullptr;
      }
      if (f0.order > s->f0_max_order) s->f0_max_order = f0.order;
      s->floor0s.push_back(f0);
      s->floors.push_back(Floor1{});  // placeholder: keeps indexing flat
      s->xs_sorteds.emplace_back();
      s->rp_consts.emplace_back();
      continue;
    }
    if (type != 1) { delete s; return nullptr; }
    s->floor0s.push_back(Floor0c{});  // placeholder
    Floor1 fl;
    fl.partition_count = p[i++]; fl.max_class = p[i++]; fl.post_count = p[i++];
    fl.y_bits = p[i++]; fl.range = p[i++]; fl.multiplier = p[i++];
    fl.partition_class = &p[i]; i += fl.partition_count;
    fl.class_dims = &p[i]; i += fl.max_class;
    fl.class_subclasses = &p[i]; i += fl.max_class;
    fl.masterbooks = &p[i]; i += fl.max_class;
    fl.subclass_books = &p[i]; i += (int64_t)fl.max_class * 8;
    fl.x_list = &p[i]; i += fl.post_count;
    fl.l_neigh = &p[i]; i += fl.post_count;
    fl.h_neigh = &p[i]; i += fl.post_count;
    fl.sort_idx = &p[i]; i += fl.post_count;
    std::vector<int32_t> xs((size_t)fl.post_count);
    for (int k = 0; k < fl.post_count; ++k) xs[k] = fl.x_list[fl.sort_idx[k]];
    s->xs_sorteds.push_back(std::move(xs));
    fl.xs_sorted = s->xs_sorteds.back().data();
    // division-free render_point constants: for post i (>= 2),
    // off = |dy| * (x - lx) / adx with x/lx/adx static per post, so
    // (x-lx) * (2^47/adx + 1) folds into one int64; (|dy| * c) >> 47
    // is EXACT for |dy| < 256 (worst error term |dy|*dx*(adx - 2^47
    // mod adx)/adx < 2^8 * adx * adx <= 2^40 < 2^47 for adx <= 2^16;
    // x_list fields are 16-bit) — unpack guards |dy| and falls back
    // to the division otherwise
    std::vector<int64_t> rpc((size_t)fl.post_count, 0);
    for (int k = 2; k < fl.post_count; ++k) {
      int lx = fl.x_list[fl.l_neigh[k]];
      int hx = fl.x_list[fl.h_neigh[k]];
      int64_t adx = (int64_t)hx - lx;
      if (adx > 0 && adx <= 65536)
        rpc[(size_t)k] =
            (int64_t)(fl.x_list[k] - lx) * (((1ll << 47) / adx) + 1);
    }
    s->rp_consts.push_back(std::move(rpc));
    fl.rp_const = s->rp_consts.back().data();
    s->floors.push_back(fl);
  }
  for (int r = 0; r < n_residues; ++r) {
    Residue rs;
    rs.type = p[i++]; rs.begin = p[i++]; rs.end = p[i++];
    rs.partition_size = p[i++]; rs.classifications = p[i++];
    rs.classbook = p[i++]; rs.max_stages = p[i++]; rs.partvals = p[i++];
    rs.cb_dims = p[i++];
    rs.cascade = &p[i]; i += rs.classifications;
    rs.books = &p[i]; i += (int64_t)rs.classifications * rs.max_stages;
    rs.decode_map = &p[i]; i += (int64_t)rs.partvals * rs.cb_dims;
    std::vector<int32_t> gt((size_t)rs.classifications * rs.max_stages);
    for (int cls = 0; cls < rs.classifications; ++cls)
      for (int stg = 0; stg < rs.max_stages; ++stg)
        gt[(size_t)cls * rs.max_stages + stg] = sym_groups(*s, rs, cls, stg);
    s->groups_tabs.push_back(std::move(gt));
    rs.groups_tab = s->groups_tabs.back().data();
    rs.wr_slack = 0;
    for (int cls = 0; cls < rs.classifications; ++cls)
      for (int stg = 0; stg < rs.max_stages; ++stg) {
        int32_t b = rs.books[(int64_t)cls * rs.max_stages + stg];
        if (b >= 0 && b < (int32_t)s->books.size() &&
            s->books[b].dims > rs.wr_slack)
          rs.wr_slack = s->books[b].dims;
      }
    s->residues.push_back(rs);
  }
  for (int m = 0; m < n_mappings; ++m) {
    Mapping mp;
    mp.submap_count = p[i++]; mp.coupling_count = p[i++];
    mp.mag = &p[i]; i += mp.coupling_count;
    mp.ang = &p[i]; i += mp.coupling_count;
    mp.mux = &p[i]; i += s->channels;
    mp.submap_floor = &p[i]; i += mp.submap_count;
    mp.submap_residue = &p[i]; i += mp.submap_count;
    s->mappings.push_back(mp);
  }
  for (int m = 0; m < n_modes; ++m) {
    Mode md;
    md.block_flag = p[i++]; md.block_size = p[i++]; md.mapping_idx = p[i++];
    s->modes.push_back(md);
  }
  if (i > ni) { delete s; return nullptr; }
  return s;
}

void nvt_setup_destroy(void* setup) { delete (Setup*)setup; }

// Unpack a window of packets into dense tensors (outputs must be
// zero-initialized by the caller).  `offsets` has n_packets+1 entries into
// `bytes`.  Fans out over an internal thread pool.
void nvt_unpack_window(void* setup, const uint8_t* bytes,
                       const int64_t* offsets, int32_t n_packets,
                       float* residue,      // [n_packets, C, n2max]
                       int32_t* ys,         // [n_packets, C, P]
                       uint8_t* used,       // [n_packets, C, P]
                       uint8_t* has_floor,  // [n_packets, C]
                       int32_t* meta,       // [n_packets, 8]
                       int32_t n_threads) {
  Setup* s = (Setup*)setup;
  int C = s->channels;
  int P = s->max_posts;
  int64_t n2max = s->n2max;

  auto work = [&](int k) {
    unpack_one(*s, bytes + offsets[k], offsets[k + 1] - offsets[k],
               residue + (int64_t)k * C * n2max, ys + (int64_t)k * C * P,
               used + (int64_t)k * C * P, has_floor + (int64_t)k * C,
               meta + (int64_t)k * 8);
  };

  int hw = (int)std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : std::max(1, std::min(hw, 16));
  nt = std::min(nt, n_packets);
  if (nt <= 1) {
    for (int k = 0; k < n_packets; ++k) work(k);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int k = next.fetch_add(1);
        if (k >= n_packets) break;
        work(k);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Spectrum-mode window unpack: one ready-to-IMDCT [C, n2] f32 row set per
// packet (unpack_one_spec).  Unlike nvt_unpack_window the outputs need NOT
// be zero-initialized (rows are memset here, cache-warm).  Requires the
// blob to carry the inverse-dB table (inv_db_off >= 0).
void nvt_unpack_window_spec(void* setup, const uint8_t* bytes,
                            const int64_t* offsets, int32_t n_packets,
                            float* spec,     // [n_packets, C, n2max]
                            int32_t* meta,   // [n_packets, 8]
                            int32_t n_threads) {
  Setup* s = (Setup*)setup;
  int C = s->channels;
  int64_t n2max = s->n2max;

  auto work = [&](int k) {
    unpack_one_spec(*s, bytes + offsets[k], offsets[k + 1] - offsets[k],
                    spec + (int64_t)k * C * n2max, meta + (int64_t)k * 8,
                    n2max);
  };

  int hw = (int)std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : std::max(1, std::min(hw, 16));
  nt = std::min(nt, n_packets);
  if (nt <= 1) {
    for (int k = 0; k < n_packets; ++k) work(k);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int k = next.fetch_add(1);
        if (k >= n_packets) break;
        work(k);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Scatter/gather variant of nvt_unpack_window_spec: per-packet byte spans
// arrive as separate (starts, ends) arrays instead of contiguous
// boundaries, so the caller can unpack packets in a PERMUTED order (the
// host engine sorts a chunk's packets by mode, making each synthesis
// bucket a contiguous row range — no per-bucket gather copy) without
// moving any packet bytes.
void nvt_unpack_window_spec_sv(void* setup, const uint8_t* bytes,
                               const int64_t* starts, const int64_t* ends,
                               int32_t n_packets,
                               float* spec,     // [n_packets, C, n2max]
                               int32_t* meta,   // [n_packets, 8]
                               int32_t n_threads) {
  Setup* s = (Setup*)setup;
  int C = s->channels;
  int64_t n2max = s->n2max;

  auto work = [&](int k) {
    unpack_one_spec(*s, bytes + starts[k], ends[k] - starts[k],
                    spec + (int64_t)k * C * n2max, meta + (int64_t)k * 8,
                    n2max);
  };

  int hw = (int)std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : std::max(1, std::min(hw, 16));
  nt = std::min(nt, n_packets);
  if (nt <= 1) {
    for (int k = 0; k < n_packets; ++k) work(k);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int k = next.fetch_add(1);
        if (k >= n_packets) break;
        work(k);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Spectrum unpack with PER-PACKET output pointers and row strides: the
// host engine unpacks a mode-sorted chunk straight into per-bucket
// buffers whose rows are TIGHT (stride = the frame's own n2, not n2max)
// — the short-block bucket then feeds the DCT with no reshape copy
// (measured ~13 ms/round on the 5.1 workload).  out_ptrs[k] is the
// float* for packet k's [C, strides[k]] block, as int64.
void nvt_unpack_window_spec_ptr(void* setup, const uint8_t* bytes,
                                const int64_t* starts, const int64_t* ends,
                                int32_t n_packets,
                                const int64_t* out_ptrs,
                                const int64_t* strides,
                                int32_t* meta,   // [n_packets, 8]
                                int32_t n_threads) {
  Setup* s = (Setup*)setup;

  auto work = [&](int k) {
    unpack_one_spec(*s, bytes + starts[k], ends[k] - starts[k],
                    (float*)out_ptrs[k], meta + (int64_t)k * 8,
                    strides[k]);
  };

  int hw = (int)std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : std::max(1, std::min(hw, 16));
  nt = std::min(nt, n_packets);
  if (nt <= 1) {
    for (int k = 0; k < n_packets; ++k) work(k);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int k = next.fetch_add(1);
        if (k >= n_packets) break;
        work(k);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// has the spectrum-mode entry point (and the blob carried inv_db)?
int32_t nvt_has_spec(void* setup) {
  return ((Setup*)setup)->inv_db != nullptr ? 1 : 0;
}

// read-and-reset the NVT_CYCLES stage counters (see cycle-split
// diagnostics above): out[4] = floor_unpack, residue_decode, coupling,
// floor_apply rdtsc cycles accumulated since the last read.
void nvt_cycles_read(uint64_t* out) {
  for (int i = 0; i < 5; ++i) out[i] = g_cycles[i].exchange(0);
}

// Finish one mode bucket's IMDCT from its DCT-IV half: map the length-n/2
// DCT-IV output g to the length-n IMDCT by the transform symmetries
// (engine/host.py:imdct_rows — y[i] = g[i+n4] / -g[3n4-1-i] / -g[i-3n4]),
// fold the pocketfft 2x convention (*0.5, exact) and the window multiply,
// and scatter the rows into the flat row space at idx[j] — one pass where
// the numpy formulation took five (map, scale, reshape, window, scatter).
void nvt_imdct_finish(const float* g,        // [b, C, n/2] DCT-IV rows
                      int64_t b, int32_t C, int32_t n,
                      const int64_t* idx,    // [b] destination frame rows
                      const int32_t* widx,   // [b] window index per frame
                      const float* win_tab,  // [W, n]
                      float* rows_all,       // [rows, C, n_max]
                      int64_t n_max) {
  int n2 = n / 2, n4 = n / 4;
  for (int64_t j = 0; j < b; ++j) {
    const float* w = win_tab + (int64_t)widx[j] * n;
    for (int c = 0; c < C; ++c) {
      const float* gr = g + (j * C + c) * n2;
      float* dst = rows_all + (idx[j] * C + c) * n_max;
      for (int i = 0; i < n4; ++i)
        dst[i] = (gr[n4 + i] * 0.5f) * w[i];
      for (int i = n4; i < 3 * n4; ++i)
        dst[i] = (-gr[3 * n4 - 1 - i] * 0.5f) * w[i];
      for (int i = 3 * n4; i < n; ++i)
        dst[i] = (-gr[i - 3 * n4] * 0.5f) * w[i];
    }
  }
}

// Fused IMDCT-finish + overlap-add: the rows_all materialization
// (~67 MB per 4096-frame chunk, written once and read ~1.3x) is skipped
// entirely — every output sample is computed straight from its frame's
// DCT-IV bucket row with the exact nvt_imdct_finish op order
// ((sign*g)*0.5f)*w, so outputs are bit-identical to the two-pass lane.
// Segments arrive in build_segments coordinates; the frame index rides
// prim/sec's flat row (prim / n_max), and the previous chunk's final
// frame (frame id nF) reads from its materialized carry row instead of
// a bucket.  Inner loops are region-split (the IMDCT mapping's three
// ranges), branch-free per run.
void nvt_finish_ola(
    const float* const* gs, const int64_t* fbuck, const int64_t* frow,
    const int32_t* fns, const float* const* fwin, const float* carry_row,
    int64_t n_max, int32_t C,
    const int64_t* s, const int64_t* prim, const int64_t* sec,
    const int64_t* sl, const int64_t* lens, int64_t nseg,
    float* out, float* maxabs_io, float clip_limit) {
  FrameSrc fs{fbuck, frow, fns, gs, fwin, carry_row, n_max, C};
  float mx = maxabs_io ? *maxabs_io : 0.0f;
  const bool cl = clip_limit > 0.0f;
  auto fin = [&](float v) {
    float a = v < 0 ? -v : v;
    if (a > mx) mx = a;
    if (cl) {
      if (v > clip_limit) return clip_limit;
      if (v < -clip_limit) return -clip_limit;
    }
    return v;
  };
  const bool inter = C <= kMaxChI && !std::getenv("NVT_NO_OLAI");
  // Lapped-prefix strategy: the region-PRECUT single-store pair emit
  // (emit_pair_all) computes fin(sec + prim) in one pass with no
  // per-element region compares.  (History: a naive combined pass WITH
  // per-element compares lost an A/B 0.175 vs 0.156 s — the compares
  // cost more than the store+reload they saved; the precut form removes
  // both.)  NVT_OLA_PAIR=0 keeps the two-pass twin for A/B.
  const char* pair_env = std::getenv("NVT_OLA_PAIR");  // per call: ~100 ns,
  const bool pair_on = !(pair_env && pair_env[0] == '0' && !pair_env[1]);
  // and the in-process A/B harness (tools/ab_host.py) can flip it live
  // NT tiles default OFF: measured 8% SLOWER than plain stores on the
  // target host (156-173 vs 145-153 ms/rep, 3/3 adjacent pairs, 5.1
  // workload, bit-equal) — this core class elides read-for-ownership on
  // long sequential store runs already, so the L1 tile pass is pure
  // added work.  NVT_OLA_NT=1 keeps the lane measurable on other hosts.
  const char* nt_env = std::getenv("NVT_OLA_NT");
  const bool nt_on =
      kHaveNT && pair_on && nt_env && nt_env[0] == '1' && !nt_env[1];
  // L1-resident tile for the non-temporal path: computed through the
  // same emit loops (bit-identical values), then streamed to `out`
  constexpr int64_t kTileFloats = 4096;  // 16 KB
  alignas(64) thread_local float tile[kTileFloats];
  auto seg_loop = [&](auto ct) {
    constexpr int CT = decltype(ct)::value;
    for (int64_t k = 0; k < nseg; ++k) {
      int64_t L = lens[k];
      if (L <= 0) continue;
      float* o = out + s[k] * C;
      int64_t pf = prim[k] / n_max, poff = prim[k] % n_max;
      int64_t S = sl[k];
      if (nt_on) {
        const int64_t tile_t = kTileFloats / (CT > 0 ? CT : C);
        int64_t sf = 0, soff = 0;
        if (S > 0) { sf = sec[k] / n_max; soff = sec[k] % n_max; }
        for (int64_t t0 = 0; t0 < L; t0 += tile_t) {
          int64_t tl = std::min(tile_t, L - t0);
          int64_t lap = std::min(std::max(S - t0, (int64_t)0), tl);
          if (lap > 0)
            emit_pair_all<CT>(fs, pf, poff + t0, sf, soff + t0, lap,
                              tile, C, fin);
          if (tl > lap)
            emit_all<false, CT>(fs, pf, poff + t0 + lap, tl - lap,
                                tile + lap * C, C, 0, fin);
          nt_copy(o + t0 * C, tile, tl * C);
        }
        continue;
      }
      if (pair_on && S > 0) {
        int64_t sf = sec[k] / n_max, soff = sec[k] % n_max;
        emit_pair_all<CT>(fs, pf, poff, sf, soff, S, o, C, fin);
        if (L > S)
          emit_all<false, CT>(fs, pf, poff + S, L - S, o + S * C, C, 0,
                              fin);
        continue;
      }
      emit_all<false, CT>(fs, pf, poff, L, o, C, S, fin);
      if (S > 0) {
        int64_t sf = sec[k] / n_max, soff = sec[k] % n_max;
        emit_all<true, CT>(fs, sf, soff, S, o, C, 0, fin);
      }
    }
  };
  if (inter) {
    switch (C) {  // compile-time channel counts: the c-loops unroll
      case 1: seg_loop(std::integral_constant<int, 1>{}); break;
      case 2: seg_loop(std::integral_constant<int, 2>{}); break;
      case 4: seg_loop(std::integral_constant<int, 4>{}); break;
      case 6: seg_loop(std::integral_constant<int, 6>{}); break;
      case 8: seg_loop(std::integral_constant<int, 8>{}); break;
      default: seg_loop(std::integral_constant<int, -1>{}); break;
    }
  } else {
    for (int64_t k = 0; k < nseg; ++k) {
      int64_t L = lens[k];
      if (L <= 0) continue;
      float* o = out + s[k] * C;
      int64_t pf = prim[k] / n_max, poff = prim[k] % n_max;
      int64_t S = sl[k];
      for (int c = 0; c < C; ++c)
        emit_role<false>(fs, pf, c, poff, L, o, C, S, fin);
      if (S > 0) {
        int64_t sf = sec[k] / n_max, soff = sec[k] % n_max;
        for (int c = 0; c < C; ++c)
          emit_role<true>(fs, sf, c, soff, S, o, C, 0, fin);
      }
    }
  }
#ifdef __AVX512F__
  if (nt_on) _mm_sfence();  // streamed stores are weakly ordered
#endif
  if (maxabs_io) *maxabs_io = mx;
}

// Host overlap-add: write the chunk's lapped segments into the interleaved
// output (engine/plan.build_segments coordinates; the numpy twin is
// engine/host.py:_overlap_add, kept as the no-native testing lane).
void nvt_ola(const float* rows_all,  // [rows, C, n_max]
             int64_t n_max, int32_t C,
             const int64_t* s, const int64_t* prim, const int64_t* sec,
             const int64_t* sl, const int64_t* lens, int64_t nseg,
             float* out,              // [L, C] interleaved
             float* maxabs_io,        // running max |sample| (in/out) —
                                      // clip detection fused into the pass
                                      // that already touches every sample
                                      // (the callers' whole-output
                                      // np.abs scan was ~0.15 s/round)
             float clip_limit) {      // > 0: clamp final samples to
                                      // [-limit, limit] at store time
                                      // (same values as a post-hoc
                                      // np.clip over the output, which
                                      // cost another ~0.15 s/round on
                                      // clipping content); maxabs still
                                      // reports the PRE-clamp magnitude
                                      // so has_clipped semantics hold
  float mx = maxabs_io ? *maxabs_io : 0.0f;
  const bool cl = clip_limit > 0.0f;
  auto fin = [&](float v) {
    float a = v < 0 ? -v : v;
    if (a > mx) mx = a;
    if (cl) {
      if (v > clip_limit) return clip_limit;
      if (v < -clip_limit) return -clip_limit;
    }
    return v;
  };
  const bool two = (C == 2) && !std::getenv("NVT_NO_OLA2");
  for (int64_t k = 0; k < nseg; ++k) {
    int64_t L = lens[k];
    if (L <= 0) continue;
    float* o = out + s[k] * C;
    int64_t pr = prim[k], r = pr / n_max, off = pr % n_max;
    int64_t S = sl[k];
    if (two) {
      // stereo lane: both channels in one pass, contiguous interleaved
      // stores, instead of two strided passes over the output
      const float* p0 = rows_all + (r * 2) * n_max + off;
      const float* p1 = rows_all + (r * 2 + 1) * n_max + off;
      for (int64_t t = 0; t < S; ++t) {
        o[2 * t] = p0[t];
        o[2 * t + 1] = p1[t];
      }
      for (int64_t t = S; t < L; ++t) {
        o[2 * t] = fin(p0[t]);
        o[2 * t + 1] = fin(p1[t]);
      }
      if (S > 0) {
        int64_t sc = sec[k], r2 = sc / n_max, off2 = sc % n_max;
        const float* q0 = rows_all + (r2 * 2) * n_max + off2;
        const float* q1 = rows_all + (r2 * 2 + 1) * n_max + off2;
        for (int64_t t = 0; t < S; ++t) {
          o[2 * t] = fin(o[2 * t] + q0[t]);
          o[2 * t + 1] = fin(o[2 * t + 1] + q1[t]);
        }
      }
      continue;
    }
    if (C <= 8 && !std::getenv("NVT_NO_OLAG")) {
      // generic single-pass lane (surround): all channels per output
      // frame in one sweep — contiguous interleaved stores instead of C
      // strided passes over the output (the reads are <=8 sequential
      // streams, well within the prefetcher)
      const float* ps[8];
      for (int c = 0; c < C; ++c)
        ps[c] = rows_all + (r * C + c) * n_max + off;
      for (int64_t t = 0; t < S; ++t)
        for (int c = 0; c < C; ++c) o[t * C + c] = ps[c][t];
      for (int64_t t = S; t < L; ++t)
        for (int c = 0; c < C; ++c) o[t * C + c] = fin(ps[c][t]);
      if (S > 0) {
        int64_t sc = sec[k], r2 = sc / n_max, off2 = sc % n_max;
        for (int c = 0; c < C; ++c)
          ps[c] = rows_all + (r2 * C + c) * n_max + off2;
        for (int64_t t = 0; t < S; ++t)
          for (int c = 0; c < C; ++c)
            o[t * C + c] = fin(o[t * C + c] + ps[c][t]);
      }
      continue;
    }
    for (int c = 0; c < C; ++c) {
      const float* p = rows_all + (r * C + c) * n_max + off;
      // [0, S) is pre-overlap (final value lands in the add below);
      // [S, L) is final here
      for (int64_t t = 0; t < S; ++t) o[t * C + c] = p[t];
      for (int64_t t = S; t < L; ++t) o[t * C + c] = fin(p[t]);
    }
    if (S > 0) {
      int64_t sc = sec[k], r2 = sc / n_max, off2 = sc % n_max;
      for (int c = 0; c < C; ++c) {
        const float* p = rows_all + (r2 * C + c) * n_max + off2;
        for (int64_t t = 0; t < S; ++t)
          o[t * C + c] = fin(o[t * C + c] + p[t]);
      }
    }
  }
  if (maxabs_io) *maxabs_io = mx;
}

// Ogg CRC-32 (poly 0x04c11db7, non-reflected, init 0) — table-driven.
// Reference semantics: NVorbis/Ogg/Crc.cs:3-43.
uint32_t nvt_crc32(const uint8_t* data, int64_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i << 24;
      for (int k = 0; k < 8; ++k)
        c = (c & 0x80000000u) ? (c << 1) ^ 0x04c11db7u : (c << 1);
      table[i] = c;
    }
    init = true;
  }
  uint32_t crc = 0;
  for (int64_t i = 0; i < n; ++i)
    crc = (crc << 8) ^ table[data[i] ^ (crc >> 24)];
  return crc;
}

// Whole-container packetizer for one logical stream — the clean-path fast
// lane behind the batch/bulk decoders.  Walks the pages of `serial` in one
// pass (CRC-verified), stitches continued packets across pages (including
// pages of other serials interleaved between them), and emits a packed
// payload blob + per-packet tables.  The Python page/packet machinery
// (ogg/pages.py, ogg/packets.py — reference semantics incl. recovery,
// PacketProvider.cs:324-438) stays the source of truth: this function
// returns -1 on ANY anomaly (byte-level resync, CRC mismatch, sequence
// gap, version != 0, broken continuation, truncated page) and the caller
// falls back to the robust path.
//
// Semantics mirrored from ogg/packets.py for clean streams:
//   * zero-size packets are not packets (lacing 0 completes nothing);
//   * the page granule belongs to the last packet *completing* in the page;
//   * per-page overhead bytes (27 + nseg) attach to the packet *starting*
//     at the page's first slot — i.e. the carried packet for continuation
//     pages — and empty pages' overhead is not attributed;
//   * a final unterminated carry is dropped;
//   * the last emitted packet is flagged end-of-stream.
//
// out_flags bits: 1 = end-of-stream, 2 = granule valid.
// When out_data == nullptr the call only counts (n_packets via return,
// payload bytes via *count_bytes).  Returns n_packets, or -1 (anomaly) /
// -2 (capacity: out_cap or max_pkts too small).
int64_t nvt_packetize(const uint8_t* data, int64_t len, uint32_t serial,
                      uint8_t* out_data, int64_t out_cap,
                      int64_t* out_off, int64_t* out_gran,
                      int32_t* out_flags, int32_t* out_ovh,
                      int64_t max_pkts, int64_t* count_bytes) {
  const bool counting = (out_data == nullptr);
  int64_t n_pkts = 0;
  int64_t payload = 0;
  bool have_seq = false;
  uint32_t last_seq = 0;
  bool ended = false;

  // pending continued packet: list of (src offset, length) spans
  std::vector<std::pair<int64_t, int64_t>> carry;
  int64_t carry_bytes = 0;
  int32_t carry_ovh = 0;

  auto emit = [&](int64_t gran, int32_t flags, int32_t ovh) -> bool {
    if (!counting) {
      if (n_pkts >= max_pkts) return false;
      int64_t off = (n_pkts == 0) ? 0 : out_off[n_pkts];
      out_off[n_pkts] = off;
      int64_t pos = off;
      for (auto& sp : carry) {
        if (pos + sp.second > out_cap) return false;
        memcpy(out_data + pos, data + sp.first, (size_t)sp.second);
        pos += sp.second;
      }
      out_off[n_pkts + 1] = pos;
      out_gran[n_pkts] = gran;
      out_flags[n_pkts] = flags;
      out_ovh[n_pkts] = ovh;
    }
    payload += carry_bytes;
    ++n_pkts;
    carry.clear();
    carry_bytes = 0;
    carry_ovh = 0;
    return true;
  };

  int64_t pos = 0;
  while (!ended && pos < len) {
    if (pos + 27 > len) return -1;  // trailing garbage / truncated header
    if (memcmp(data + pos, "OggS", 4) != 0) return -1;  // resync needed
    if (data[pos + 4] != 0) return -1;                  // version
    const uint8_t flags = data[pos + 5];
    int64_t granule;
    memcpy(&granule, data + pos + 6, 8);
    uint32_t pserial, seq;
    memcpy(&pserial, data + pos + 14, 4);
    memcpy(&seq, data + pos + 18, 4);
    const int nseg = data[pos + 26];
    const int64_t hdr = 27 + nseg;
    if (pos + hdr > len) return -1;
    int64_t body = 0;
    for (int s = 0; s < nseg; ++s) body += data[pos + 27 + s];
    const int64_t page_len = hdr + body;
    if (pos + page_len > len) return -1;

    if (counting) {
      // CRC with the checksum field (bytes 22..25) zeroed, without copying
      static const uint8_t zeros[4] = {0, 0, 0, 0};
      uint32_t crc = 0;
      {
        // reuse nvt_crc32's table by streaming the three spans
        // (prefix, zeros, rest) through the same update loop
        static uint32_t table[256];
        static bool init = false;
        if (!init) {
          for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i << 24;
            for (int k = 0; k < 8; ++k)
              c = (c & 0x80000000u) ? (c << 1) ^ 0x04c11db7u : (c << 1);
            table[i] = c;
          }
          init = true;
        }
        auto upd = [&](const uint8_t* p, int64_t n) {
          for (int64_t i = 0; i < n; ++i)
            crc = (crc << 8) ^ table[p[i] ^ (crc >> 24)];
        };
        upd(data + pos, 22);
        upd(zeros, 4);
        upd(data + pos + 26, page_len - 26);
      }
      uint32_t stored;
      memcpy(&stored, data + pos + 22, 4);
      if (crc != stored) return -1;
    }

    if (pserial != serial) {  // other logical stream: skip its page
      pos += page_len;
      continue;
    }
    if (have_seq && seq != last_seq + 1) return -1;  // page gap
    have_seq = true;
    last_seq = seq;

    const bool continues = (flags & 0x01) != 0;
    if (continues != (carry_bytes > 0 || !carry.empty())) return -1;

    // walk the lacing, emitting completed packets
    int64_t doff = pos + hdr;
    int64_t cur = 0;
    int64_t cur_off = doff;
    int64_t last_completed = -1;  // index of last packet completing here
    bool first_slot_attributed = false;
    const int32_t page_ovh = (int32_t)hdr;
    if (!carry.empty() || carry_bytes > 0) {
      // the carried packet owns this page's overhead
      carry_ovh += page_ovh;
      first_slot_attributed = true;
    }
    for (int s = 0; s < nseg; ++s) {
      const int seg = data[pos + 27 + s];
      cur += seg;
      if (seg < 255) {
        if (cur > 0) {
          carry.push_back({cur_off, cur});
          carry_bytes += cur;
          int32_t ovh = carry_ovh;
          if (!first_slot_attributed) {
            ovh += page_ovh;
            first_slot_attributed = true;
          }
          int64_t g = -1;
          int32_t fl = 0;
          // provisional; granule fixed after the page's walk
          if (!emit(g, fl, ovh)) return -2;
          last_completed = n_pkts - 1;
        } else if (!first_slot_attributed && s == 0) {
          // a leading zero-length lacing value still "starts" slot 0 but
          // produces no packet; overhead stays unattributed (python parity)
        }
        cur_off += cur;
        cur = 0;
      }
    }
    if (cur > 0) {  // trailing partial: carry into the next page
      carry.push_back({cur_off, cur});
      carry_bytes += cur;
      if (!first_slot_attributed) {
        carry_ovh += page_ovh;
        first_slot_attributed = true;
      }
    }
    if (granule != -1 && last_completed >= 0 && !counting) {
      out_gran[last_completed] = granule;
      out_flags[last_completed] |= 2;
    }
    if (flags & 0x04) ended = true;  // end-of-stream page
    pos += page_len;
  }
  // a final unterminated carry is dropped (ogg/packets.py:111-115 parity)
  if (n_pkts > 0 && !counting) out_flags[n_pkts - 1] |= 1;  // eos
  if (counting && count_bytes) *count_bytes = payload;
  return n_pkts;
}

// Symbol-mode window unpack: residues come back as per-partition classes +
// canonically-laid-out codebook entry ids (see residue symbol emission
// above) instead of dense float spectra — an order-of-magnitude smaller
// host->device payload; the device reconstructs the spectrum with gathers.
// Single-submap setups only (the Python caller gates on that).
void nvt_unpack_window_sym(void* setup, const uint8_t* bytes,
                           const int64_t* offsets, int32_t n_packets,
                           uint8_t* classes,    // [n, CHR_max, n_part_max]
                           int16_t* ids,        // [n, max_ids]
                           int32_t* ys,         // [n, C, P]
                           uint8_t* used,       // [n, C, P]
                           uint8_t* has_floor,  // [n, C]
                           int32_t* meta,       // [n, 8]
                           int32_t n_part_max, int32_t chr_max,
                           int32_t max_ids, int32_t n_threads) {
  Setup* s = (Setup*)setup;
  int C = s->channels;
  int P = s->max_posts;

  auto work = [&](int k) {
    unpack_one_sym(*s, bytes + offsets[k], offsets[k + 1] - offsets[k],
                   classes + (int64_t)k * chr_max * n_part_max,
                   ids + (int64_t)k * max_ids, ys + (int64_t)k * C * P,
                   used + (int64_t)k * C * P, has_floor + (int64_t)k * C,
                   meta + (int64_t)k * 8, n_part_max, chr_max, max_ids);
  };

  int hw = (int)std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : std::max(1, std::min(hw, 16));
  nt = std::min(nt, n_packets);
  if (nt <= 1) {
    for (int k = 0; k < n_packets; ++k) work(k);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int k = next.fetch_add(1);
        if (k >= n_packets) break;
        work(k);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// One symbol bucket's flat VQ ids (parallel/batch.py
// BatchDecoder._stage_ids): row k's first counts[k] ids, read from
// src[k] (an int16* carried as int64: a row of an unpack's [n, max_ids]
// ids or a carried frame's compact ids), are copied to out at the row's
// exclusive-cumsum base, which bases[k] receives; out[pos, out_len) is
// filled with -1 (missing).  The layout of residue_sym.py's
// pad_ids([flatten_ids(rows, counts)]), with no full-width gather.
// Returns pos, the ids copied, or -1 (nothing written) when a count is
// negative or the ids and their trailing -1 overrun out_len.
int64_t nvt_stage_ids(int64_t n_rows, const int64_t* src,
                      const int32_t* counts, int16_t* out, int64_t out_len,
                      int32_t* bases) {
  int64_t pos = 0;
  for (int64_t k = 0; k < n_rows; ++k) {
    if (counts[k] < 0) return -1;
    pos += counts[k];
  }
  if (pos >= out_len || pos > INT32_MAX) return -1;
  pos = 0;
  for (int64_t k = 0; k < n_rows; ++k) {
    bases[k] = (int32_t)pos;
    std::memcpy(out + pos, (const int16_t*)(intptr_t)src[k],
                (size_t)counts[k] * sizeof(int16_t));
    pos += counts[k];
  }
  std::fill(out + pos, out + out_len, (int16_t)-1);
  return pos;
}

// Vectorized lapping planner for one all-good window — the exact int64
// math of engine/plan.plan_window (which documents the reference
// semantics: StreamDecoder.cs:358-363/428-451 granule pickup + end trim).
// The Python twin stays the semantic oracle and the fallback; this entry
// exists because ~20 small-array numpy ops cost ~70 us per chunk — a
// fixed cost that dominated small-file decodes (engine/host.py).
//
// state[11] (in/out; written back only on success):
//   0 emitted  1 stream_pos0  2 has_position  3 prev_set
//   4 prevA    5 prev_start   6 prev_valid    7 prev_total
//   8 prev_drained  9 first  10 eos_found
// meta: int32 [n, 8] unpack rows (col 0 ok, 1 mode, 2 widx).
// ov_tab: int64 [n_modes, w_max, 3]; blk_tab: int64 [n_modes].
// gran: int64 [n]; has_gran/eos/resync: uint8 [n].
// Outputs: pa int64 [n,5] (ok, A, start, valid, total), samples int64
// [n], last_plan int64 [5] (A, start, valid, total, samples).
// Returns 1 on success, 0 when a precondition fails (caller replays the
// window through the Python path, which owns every edge case).
int32_t nvt_plan_window(
    int64_t n, const int32_t* meta, int64_t n_modes, int64_t w_max,
    const int64_t* ov_tab, const int64_t* blk_tab, const int64_t* gran,
    const uint8_t* has_gran, const uint8_t* eos, const uint8_t* resync,
    int64_t* state, int64_t* pa, int64_t* samples, int64_t* last_plan) {
  if (n <= 0) return 0;
  // all-good, no-resync gate (plan_job_arr's entry condition)
  for (int64_t i = 0; i < n; ++i)
    if (meta[i * 8] != 1 || resync[i]) return 0;
  if (state[8] && state[3]) return 0;  // prev_drained with a live prev
  for (int64_t i = 0; i + 1 < n; ++i)
    if (eos[i]) return 0;

  // gather the overlap triple + block size per frame into pa columns
  for (int64_t i = 0; i < n; ++i) {
    int64_t m = meta[i * 8 + 1], w = meta[i * 8 + 2];
    if (m < 0 || m >= n_modes || w < 0 || w >= w_max) return 0;
    const int64_t* svt = ov_tab + (m * w_max + w) * 3;
    pa[i * 5 + 0] = 1;
    pa[i * 5 + 2] = svt[0];
    pa[i * 5 + 3] = svt[1];
    pa[i * 5 + 4] = svt[2];
  }

  const int64_t emitted = state[0];
  int64_t A0, samples0, p_valid0 = -1, p_total0 = -1;
  if (!state[3]) {
    A0 = -(pa[3] - pa[2]);
    samples0 = 0;
  } else {
    A0 = state[4] + (state[6] - state[5]);
    samples0 = pa[3] - pa[2];
    p_valid0 = state[6];
    p_total0 = state[7];
  }

  // previous-tail clamp must be a no-op mid-window (room_cap check)
  for (int64_t i = 0; i < n; ++i) {
    int64_t st = pa[i * 5 + 2], vs = pa[i * 5 + 3] - st;
    int64_t blk = blk_tab[meta[i * 8 + 1]];
    int64_t cap = std::min(blk - st, vs);
    if (cap < 0) cap = 0;
    if (i == 0) {
      if (p_total0 >= 0 && p_total0 > p_valid0 + cap) return 0;
    } else if (pa[(i - 1) * 5 + 4] > pa[(i - 1) * 5 + 3] + cap) {
      return 0;
    }
  }

  int64_t acc = A0;
  for (int64_t i = 0; i < n; ++i) {
    pa[i * 5 + 1] = acc;
    acc += pa[i * 5 + 3] - pa[i * 5 + 2];
    samples[i] = pa[i * 5 + 3] - pa[i * 5 + 2];
  }
  samples[0] = samples0;

  // granule-pickup index (first granule-bearing packet, position unknown)
  int64_t pk = -1, pk_buffered = 0;
  if (!state[2]) {
    for (int64_t i = 0; i < n; ++i)
      if (has_gran[i]) { pk = i; break; }
    if (pk >= 0) pk_buffered = pk ? pa[pk * 5 + 1] : emitted;
  }

  // end-trim at the final packet (granule + eos), pre-pickup position
  if (eos[n - 1] && has_gran[n - 1]) {
    int64_t pos0_eff;
    if (state[2] || pk == n - 1 || pk < 0)
      pos0_eff = state[1];
    else
      pos0_eff = gran[pk] - samples[pk] - pk_buffered;
    int64_t actual_end = pos0_eff + pa[(n - 1) * 5 + 1] + samples[n - 1];
    int64_t diff = gran[n - 1] - actual_end;
    if (diff < 0) {
      int64_t st_l = pa[(n - 1) * 5 + 2];
      int64_t trimmed_vs = (pa[(n - 1) * 5 + 3] - st_l) + diff;
      int64_t blk = blk_tab[meta[(n - 1) * 8 + 1]];
      int64_t room_t = std::min(blk - st_l, trimmed_vs);
      if (room_t < 0) room_t = 0;
      if (n > 1) {
        if (pa[(n - 2) * 5 + 4] > pa[(n - 2) * 5 + 3] + room_t)
          pa[(n - 2) * 5 + 4] = pa[(n - 2) * 5 + 3] + room_t;
      } else if (p_total0 >= 0 && p_total0 > p_valid0 + room_t) {
        return 0;  // previous-window boxed plan needs in-place mutation
      }
      samples[n - 1] += diff;
      pa[(n - 1) * 5 + 3] += diff;
    }
  }

  if (pk >= 0) {
    state[2] = 1;
    state[1] = gran[pk] - samples[pk] - pk_buffered;
  }
  state[3] = 1;
  state[4] = pa[(n - 1) * 5 + 1];
  state[5] = pa[(n - 1) * 5 + 2];
  state[6] = pa[(n - 1) * 5 + 3];
  state[7] = pa[(n - 1) * 5 + 4];
  state[8] = 0;
  state[9] = 0;
  state[10] |= eos[n - 1] ? 1 : 0;
  state[0] = state[4] + state[6] - state[5];
  last_plan[0] = state[4];
  last_plan[1] = state[5];
  last_plan[2] = state[6];
  last_plan[3] = state[7];
  last_plan[4] = samples[n - 1];
  return 1;
}

// Segment tiling for one chunk's overlap-add — the exact logic of
// engine/plan.build_segments (reference anchor there:
// StreamDecoder.cs:532-541 lapped emit + :352-356 bad-packet tail drain).
// The scalar walk is the general form (the numpy fast path is its all-ok
// vectorization); in C++ it is branch-cheap enough to be the only form.
//
// pa: int64 [nF,5] plan columns (ok, A, start, valid, total).
// rof: int64 [nF] packet row -> flat synthesis row, or nullptr for
// identity.  prev: int64[5] (pos_base, start, valid, total, carry_row)
// when has_prev, else ignored.  Outputs s/prim/sec/sl (each int64
// [nF+1] capacity); returns the segment count after zero-length clip.
int64_t nvt_build_segments(int64_t nF, const int64_t* pa,
                           const int64_t* rof, int64_t n_max,
                           int32_t has_prev, const int64_t* prev,
                           int64_t chunk_base, int64_t* s_out,
                           int64_t* prim_out, int64_t* sec_out,
                           int64_t* sl_out) {
  int64_t p_pos = 0, p_start = 0, p_valid = 0, p_total = 0, p_row = 0;
  bool drained = true;
  if (has_prev) {
    p_pos = prev[0]; p_start = prev[1]; p_valid = prev[2];
    p_total = prev[3]; p_row = prev[4];
    drained = false;
  }
  int64_t k = 0;
  auto emit = [&](int64_t s, int64_t length, int64_t pr, int64_t se,
                  int64_t sl) {
    if (s < 0) {  // clip lead-in (carry frame spans the chunk boundary)
      int64_t d = -s;
      s = 0; length -= d; pr += d; se += d;
      sl = sl - d < 0 ? 0 : sl - d;
    }
    if (sl > length) sl = length;  // defensive: OLA writes sl blindly
    if (length > 0) {
      s_out[k] = s; prim_out[k] = pr; sec_out[k] = se; sl_out[k] = sl;
      ++k;
    }
  };
  for (int64_t i = 0; i < nF; ++i) {
    const int64_t* p = pa + i * 5;
    if (!p[0]) {
      if (!drained) {  // bad packet: drain the previous tail once
        emit(p_pos + (p_valid - p_start) - chunk_base, p_total - p_valid,
             p_row * n_max + p_valid, 0, 0);
        drained = true;
      }
      continue;
    }
    int64_t row = rof ? rof[i] : i;
    int64_t sec_flat = 0, sec_len = 0;
    if (!drained) {
      sec_len = p_total - p_valid;
      sec_flat = p_row * n_max + p_valid;
    }
    emit(p[1] - chunk_base, p[3] - p[2], row * n_max + p[2], sec_flat,
         sec_len);
    p_pos = p[1]; p_start = p[2]; p_valid = p[3]; p_total = p[4];
    p_row = row;
    drained = false;
  }
  return k;
}

// Per-chunk synthesis-bucket bookkeeping for the fused finish+OLA lane
// (engine/host.py fused2): fills the per-frame source records
// (fbuck/frow/fns/fwidx/fwin) and the dense bucket table in one call —
// the numpy form (unique + per-mode flatnonzero + five fancy
// assignments) was ~60 us/chunk of fixed small-array dispatch.
//
// Preconditions (returns -1 to fall back to the Python loop): every
// frame ok (pa col 0), and the caller guarantees the residue rows are
// mode-sorted (either pre-sorted input or the sorted-unpack
// permutation) so each bucket is a contiguous row range.  Bucket order
// is ascending mode id — the same order as np.unique in the fallback.
//
// meta: int32 [nF,8] (col 1 mode, col 2 widx) in ORIGINAL frame order.
// blk: int64 [n_modes] block sizes; win_ptrs: int64 [n_modes] base
// pointers of each mode's window table (rows of length blk[m] floats).
// Outputs: fbuck/frow/fwin int64 [nF+1], fns/fwidx int32 [nF+1] (slot
// nF = carry sentinel), bucket_m/bucket_lo/bucket_cnt int64 [n_modes].
// Returns the bucket count.
int64_t nvt_bucket_prep(int64_t nF, const int64_t* pa, const int32_t* meta,
                        int64_t n_modes, const int64_t* blk,
                        const int64_t* win_ptrs, int64_t* fbuck,
                        int64_t* frow, int32_t* fns, int32_t* fwidx,
                        int64_t* fwin, int64_t* bucket_m,
                        int64_t* bucket_lo, int64_t* bucket_cnt) {
  if (n_modes > 256) return -1;
  int64_t cnt[256] = {0};
  for (int64_t i = 0; i < nF; ++i) {
    if (pa[i * 5] != 1) return -1;
    int64_t m = meta[i * 8 + 1];
    if (m < 0 || m >= n_modes) return -1;
    ++cnt[m];
  }
  int64_t nb = 0, lo = 0;
  int64_t bidx[256], run[256];
  for (int64_t m = 0; m < n_modes; ++m) {
    if (!cnt[m]) { bidx[m] = -1; continue; }
    bidx[m] = nb;
    bucket_m[nb] = m;
    bucket_lo[nb] = lo;
    bucket_cnt[nb] = cnt[m];
    lo += cnt[m];
    run[m] = 0;
    ++nb;
  }
  for (int64_t i = 0; i < nF; ++i) {
    int64_t m = meta[i * 8 + 1];
    int64_t w = meta[i * 8 + 2];
    int64_t n = blk[m];
    fbuck[i] = bidx[m];
    frow[i] = run[m]++;
    fns[i] = (int32_t)n;
    fwidx[i] = (int32_t)w;
    fwin[i] = win_ptrs[m] + w * n * 4;
  }
  fbuck[nF] = -1;  // carry sentinel
  frow[nF] = 0;
  fns[nF] = 0;
  fwidx[nF] = 0;
  fwin[nF] = 0;
  return nb;
}

}  // extern "C"
