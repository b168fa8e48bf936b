// Native AAC-LC bitstream parser: the host-side hot path of aacjax_torch.
//
// The port's own copy of native/aacparse.cc, which the JAX package keeps
// as it is.  Its outputs are the same bit for bit; it differs in how it
// gets them:
//  - aacparse_batch_spec also writes the block-scaled int16 spectra
//    (spec_i16, spec_scale), each stream's rows converted by the thread
//    that parsed them, so the compact transfer needs no pass of its own
//    after the parse;
//  - a band's gain 2^((i - 200) / 4) is read from a table built once, and
//    the spectral decode runs one loop per codebook kind that writes each
//    bin's inverse_quant(q) * gain straight into the f32 row, with no
//    quantised scratch and no second pass over the bins (the general
//    path, quantised values then finalize_spec, stays for channels with
//    pulse data, coupling channels and chunks that ship q/sf);
//  - it counts how often each path ran (parse_counts, ABI version 11).
//
// Parses raw_data_blocks (SCE/CPE/LFE/DSE/FIL elements) for a whole
// multi-stream chunk in one call and emits what the device consumes:
// final float32 spectra (Huffman + dequant + PNS + M/S + intensity fused),
// window metadata, and resolved TNS filters — exactly mirroring the
// Python reference path (aacjax/host/syntax.py + runtime/pack.py +
// float32 spectral finalization); equality is enforced by
// tests/test_native.py on random corpora.
//
// Semantics follow the reference JavaScript decoder (ics, cpe, tns,
// huffman, decoder)
// with the documented spec-correct divergences (SURVEY.md §7): pulse data
// is applied, TNS regions follow ISO/IEC 14496-3, PNS uses the intended
// LCG (state*1664525 + 1013904223).
//
// Concurrency: no global mutable state after init; the ctypes call
// releases the GIL.
//
// Build: make -C aacjax_torch/native   ->  aacjax_torch/native/libaacparse.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "gen/aac_tables.h"

namespace {

constexpr int kFrameLen = 1024;
constexpr int kTnsSlots = 8;
constexpr int kTnsOrder = 20;
constexpr int kMaxSections = 120;

// ---------------------------------------------------------------------
// Error handling
// ---------------------------------------------------------------------
struct ParseError {
  int code;
  char msg[160];
};

#define FAIL(err, c, ...)                                    \
  do {                                                       \
    (err)->code = (c);                                       \
    snprintf((err)->msg, sizeof((err)->msg), __VA_ARGS__);   \
    return false;                                            \
  } while (0)

enum ErrCode {
  OK = 0,
  ERR_BITSTREAM = 1,     // malformed stream
  ERR_UNSUPPORTED = 2,   // valid but unsupported feature (PCE, SSR...)
  ERR_FALLBACK = 3,      // capacity limit (CCE slots/entries): the caller
                         // must raise a knob; a python reparse hits the
                         // same wall
  ERR_BOUNDS = 4,
  ERR_DELEGATE = 5,      // legal content this fast path cannot order
                         // correctly (Main + intensity, prediction +
                         // coupling): the runtime transparently redoes
                         // the chunk on the python packer path
};

// ---------------------------------------------------------------------
// Bit reader (MSB first) — 64-bit cached refill (get_bits style).
// `cache` holds the next bits MSB-aligned; `ncached` of them are valid
// (bits below that are zero, so peeks past the end read as zero-padding).
// ---------------------------------------------------------------------
struct BitReader {
  const uint8_t* data;
  int64_t nbytes_;
  int64_t bytepos = 0;   // next byte to load into the cache
  uint64_t cache = 0;
  int ncached = 0;
  int64_t nbits;

  BitReader(const uint8_t* d, int64_t nbytes)
      : data(d), nbytes_(nbytes), nbits(nbytes * 8) {}

  int64_t bitpos() const { return bytepos * 8 - ncached; }
  bool can(int n) const { return bitpos() + n <= nbits; }

  inline void refill() {
    if (bytepos + 8 <= nbytes_) {
      if (ncached > 56) return;
      uint64_t w;
      memcpy(&w, data + bytepos, 8);
      w = __builtin_bswap64(w);
      int take = (64 - ncached) >> 3;        // whole bytes we can accept
      int sh = 64 - ncached - 8 * take;      // drop the partial-byte tail
      cache |= (w >> ncached) & (~0ULL << sh);
      bytepos += take;
      ncached += 8 * take;
    } else {
      while (ncached <= 56 && bytepos < nbytes_) {
        cache |= static_cast<uint64_t>(data[bytepos++]) << (56 - ncached);
        ncached += 8;
      }
    }
  }

  inline uint32_t read(int n, bool* ok) {  // n <= 32
    if (n > ncached) {
      refill();
      if (n > ncached) { *ok = false; return 0; }
    }
    uint32_t v = static_cast<uint32_t>(cache >> (64 - n));
    cache <<= n;
    ncached -= n;
    return v;
  }

  // peek up to 32 bits, zero-padded past the end
  inline uint32_t peek_padded(int n) {
    if (n > ncached) refill();
    return static_cast<uint32_t>(cache >> (64 - n));
  }

  // to bit `pos` (<= nbits) of the data
  void seek(int64_t pos) {
    bytepos = pos >> 3;
    cache = 0;
    ncached = 0;
    int rem = static_cast<int>(pos & 7);
    if (rem) {
      refill();
      cache <<= rem;
      ncached -= rem;
    }
  }

  bool advance(int64_t n) {
    if (bitpos() + n > nbits) return false;
    if (n <= ncached) {
      cache <<= n;
      ncached -= static_cast<int>(n);
    } else {
      n -= ncached;
      cache = 0;
      ncached = 0;
      bytepos += n >> 3;
      int rem = static_cast<int>(n & 7);
      if (rem) {
        refill();
        cache <<= rem;
        ncached -= rem;
      }
    }
    return true;
  }

  void align() {
    int rem = static_cast<int>(bitpos() & 7);
    if (rem) advance(8 - rem);
  }
};

// ---------------------------------------------------------------------
// Huffman: flat LUTs built at load time from the generated row tables
// ---------------------------------------------------------------------
struct HuffLut {
  // Two-level decode table: L1 covers the first min(maxlen, 10) bits and
  // stays cache-resident; the rare longer codewords (low-probability by
  // Huffman construction) escape to per-prefix L2 blocks.
  static constexpr int kL1Bits = 10;
  int maxlen = 0;
  int l1bits = 0;
  int extbits = 0;         // maxlen - l1bits
  int width = 0;           // values per row (4, 2, or 1)
  const int32_t* rows = nullptr;
  int stride = 0;          // row stride in int32s
  int n = 0;
  // L1 entry: >= 0 -> (len << 16) | row_idx ; == INT32_MIN -> invalid;
  // < 0 (other) -> ~l2_block_offset
  int32_t* l1 = nullptr;
  int32_t* l2 = nullptr;   // entries: (len << 16) | row_idx, or -1 invalid
  size_t l2n = 0;          // entries in l2

  void build(const BookDef& def) {
    rows = def.rows;
    n = def.n;
    stride = def.width;
    width = def.width - 2;
    maxlen = def.maxlen;
    l1bits = maxlen < kL1Bits ? maxlen : kL1Bits;
    extbits = maxlen - l1bits;
    size_t l1n = size_t{1} << l1bits;
    l1 = new int32_t[l1n];
    for (size_t i = 0; i < l1n; ++i) l1[i] = INT32_MIN;
    // pass 1: short codes fill L1 directly
    for (int i = 0; i < n; ++i) {
      int len = rows[i * stride + 0];
      uint32_t code = static_cast<uint32_t>(rows[i * stride + 1]);
      if (len <= l1bits) {
        int shift = l1bits - len;
        uint32_t base = code << shift;
        int32_t entry = (len << 16) | i;
        for (uint32_t j = 0; j < (1u << shift); ++j) l1[base + j] = entry;
      }
    }
    // pass 2: long codes allocate one L2 block per distinct L1 prefix
    if (extbits > 0) {
      size_t blk = size_t{1} << extbits;
      // count distinct prefixes
      int nblocks = 0;
      for (int i = 0; i < n; ++i) {
        int len = rows[i * stride + 0];
        if (len <= l1bits) continue;
        uint32_t prefix = static_cast<uint32_t>(rows[i * stride + 1])
                          >> (len - l1bits);
        if (l1[prefix] == INT32_MIN || l1[prefix] >= 0) {
          l1[prefix] = ~(nblocks * static_cast<int32_t>(blk));
          ++nblocks;
        }
      }
      l2n = static_cast<size_t>(nblocks) * blk;
      l2 = new int32_t[l2n];
      for (size_t i = 0; i < l2n; ++i) l2[i] = -1;
      for (int i = 0; i < n; ++i) {
        int len = rows[i * stride + 0];
        if (len <= l1bits) continue;
        uint32_t code = static_cast<uint32_t>(rows[i * stride + 1]);
        uint32_t prefix = code >> (len - l1bits);
        int32_t off = ~l1[prefix];
        int shift = maxlen - len;
        uint32_t base = (code << shift) & ((1u << extbits) - 1);
        int32_t entry = (len << 16) | i;
        for (uint32_t j = 0; j < (1u << shift); ++j)
          l2[off + base + j] = entry;
      }
    }
  }

  // returns row index, or -1 on invalid code / truncation
  inline int decode(BitReader* br) const {
    uint32_t w1 = br->peek_padded(l1bits);
    int32_t e = l1[w1];
    if (e >= 0) {
      if (!br->advance(e >> 16)) return -1;
      return e & 0xFFFF;
    }
    if (e == INT32_MIN) return -1;
    uint32_t wfull = br->peek_padded(maxlen);
    e = l2[~e + (wfull & ((1u << extbits) - 1))];
    if (e < 0) return -1;
    if (!br->advance(e >> 16)) return -1;
    return e & 0xFFFF;
  }

  const int32_t* values(int idx) const { return rows + idx * stride + 2; }
};

// A spectral codebook's table for the per-codebook loops: HuffLut's two
// levels, with one 8-byte entry a codeword that holds all the loop needs.
struct SpecEntry {
  int8_t v[4];    // the codeword's values (an unsigned book's magnitudes)
  uint8_t len;    // its bits; 0 = not a codeword of <= l1bits bits
  uint8_t nz;     // its nonzero values: the sign bits of an unsigned book
  uint16_t sub;   // with len 0: 0 = no codeword, else 1 + its L2 block
};

struct SpecLut {
  int l1bits = 0;
  int maxlen = 0;
  int extbits = 0;
  uint64_t extmask = 0;
  SpecEntry* l1 = nullptr;
  SpecEntry* l2 = nullptr;

  static SpecEntry entry(const HuffLut& h, int32_t e) {
    SpecEntry out{};
    const int32_t* v = h.values(e & 0xFFFF);
    for (int j = 0; j < h.width; ++j) {
      out.v[j] = static_cast<int8_t>(v[j]);
      out.nz += v[j] != 0;
    }
    out.len = static_cast<uint8_t>(e >> 16);
    return out;
  }

  void build(const HuffLut& h) {
    l1bits = h.l1bits;
    maxlen = h.maxlen;
    extbits = h.extbits;
    extmask = (uint64_t{1} << extbits) - 1;
    const size_t l1n = size_t{1} << l1bits;
    l1 = new SpecEntry[l1n]();
    for (size_t i = 0; i < l1n; ++i) {
      const int32_t e = h.l1[i];
      if (e >= 0)
        l1[i] = entry(h, e);
      else if (e != INT32_MIN)
        l1[i].sub = static_cast<uint16_t>(1 + (~e >> extbits));
    }
    l2 = new SpecEntry[h.l2n + 1]();
    for (size_t i = 0; i < h.l2n; ++i)
      if (h.l2[i] >= 0) l2[i] = entry(h, h.l2[i]);
  }
};

// Scale-factor gains 2^((i - 200) / 4) for every index a valid stream
// gives (100..355); an index outside the table (a corrupt stream's
// scalefactor below -100) calls pow as before and is counted.
constexpr int kGainTable = 512;

HuffLut g_books[12];
SpecLut g_spec[11];
float g_iq_lut[8192];
float g_gain_lut[kGainTable];

void init_tables() {
  for (int i = 0; i < 12; ++i) g_books[i].build(kBooks[i]);
  for (int i = 0; i < 11; ++i) g_spec[i].build(g_books[i]);
  for (int i = 0; i < 8192; ++i)
    g_iq_lut[i] = static_cast<float>(pow(static_cast<double>(i), 4.0 / 3.0));
  for (int i = 0; i < kGainTable; ++i)
    g_gain_lut[i] = static_cast<float>(pow(2.0, (i - 200) / 4.0));
}

void ensure_init() {
  static const bool done = (init_tables(), true);
  (void)done;
}

// band types
enum { ZERO_BT = 0, FIRST_PAIR_BT = 5, ESC_BT = 11, NOISE_BT = 13,
       INTENSITY_BT2 = 14, INTENSITY_BT = 15 };

// coupling points (cce.js:33-35)
enum { BEFORE_TNS = 0, AFTER_TNS = 1, AFTER_IMDCT = 2 };
constexpr double kCceScale[4] = {1.09050773266525765921,
                                 1.18920711500272106672,
                                 1.4142135623730950488016887, 2.0};
enum { ONLY_LONG = 0, LONG_START = 1, EIGHT_SHORT = 2, LONG_STOP = 3 };
enum { SCE_ELEM = 0, CPE_ELEM = 1, CCE_ELEM = 2, LFE_ELEM = 3,
       DSE_ELEM = 4, PCE_ELEM = 5, FIL_ELEM = 6, END_ELEM = 7 };

inline float sf_gain_index(int table_index, int* misses) {  // 2^((i-200)/4)
  if (static_cast<unsigned>(table_index) < kGainTable)
    return g_gain_lut[table_index];
  ++*misses;
  return static_cast<float>(pow(2.0, (table_index - 200) / 4.0));
}

// ---------------------------------------------------------------------
// Per-channel parse state
// ---------------------------------------------------------------------
struct ICSInfo {
  int window_sequence = ONLY_LONG;
  int window_shape = 0;
  int prev_window_shape = 0;
  int max_sfb = 0;
  int group_count = 1;
  int group_length[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  int window_count = 1;
  const int32_t* swb_offsets = nullptr;
  int swb_count = 0;
  int frame_len = kFrameLen;   // 1024 / 960 / 512 / 480
  int short_len = 128;         // frame_len / 8 (window stride)
  // Main-profile backward prediction side info (ISO/IEC 14496-3
  // §4.6.2.1; mirrors aacjax/host/syntax.py ICSInfo fields)
  bool pred_present = false;   // predictor_data_present bit
  int pred_reset_group = 0;    // 0 = no group reset this frame
  uint64_t pred_used = 0;      // bit per sfb, n = min(max_sfb, pred_sfb_max)
  // AAC-LTP (AOT 4) long-term prediction side info (§4.6.6 ltp_data)
  int ltp_lag = 0;             // 0 = no prediction this frame
  int ltp_coef = 0;
  uint64_t ltp_used = 0;       // bit per sfb, n = min(max_sfb, 40)
};

struct TnsSide {
  int n_filt[8] = {0};
  int length[8][4] = {{0}};
  int direction[8][4] = {{0}};
  int order[8][4] = {{0}};
  float coef[8][4][kTnsOrder] = {{{0}}};
};

// per-channel dense scratch of the general spectral path
struct ChannelScratch {
  int32_t quant[kFrameLen];
  float scale[kFrameLen];
  float noise[kFrameLen];
};

struct Channel {
  ICSInfo info;
  int global_gain = 0;
  int32_t band_types[kMaxSections] = {0};
  int32_t sect_end[kMaxSections] = {0};
  float sf_gain[kMaxSections] = {0};
  // raw scalefactor index per spectrum band (the integer whose gain is
  // 2^((sf-100)/4)) for the exact-i16 q/sf transfer; only valid where
  // band_types is a spectrum book
  int16_t sf_idx[kMaxSections] = {0};
  // dense outputs: the general path's scratch (quantised values, gains,
  // PNS noise, which finalize_spec combines), and the f32 row the fused
  // path writes when row is set and the channel has no pulse data
  int32_t* quant = nullptr;
  float* scale = nullptr;
  float* noise = nullptr;
  float* row = nullptr;
  bool fused = false;          // decode_spectral wrote row itself
  // bands decoded into row, bands on the general path (PNS, intensity,
  // every band of a general channel), gains that missed the table
  int n_fused_bands = 0;
  int n_general_bands = 0;
  int n_gain_misses = 0;
  TnsSide tns;
  bool tns_present = false;
  // pulse
  bool pulse_present = false;
  int pulse_count = 0;
  int pulse_offset[4] = {0};
  int pulse_amp[4] = {0};

  // before each decode (a coupling channel's Channel is reused)
  void attach(ChannelScratch* s, float* out_row) {
    quant = s->quant;
    scale = s->scale;
    noise = s->noise;
    row = out_row;
    n_fused_bands = n_general_bands = n_gain_misses = 0;
  }
};

struct StreamConfig {
  int sample_index;
  int chan_config;
  int profile = 2;             // 1/2/5/17 standard ICS order; 23 LD; 39 ELD
  int frame_len = kFrameLen;   // 1024 / 960 / 512 / 480
  int short_len = 128;         // frame_len / 8
  // SWB tables resolved by the caller per stream (frame-length aware);
  // swb_short is null for LD/ELD (no short windows in those profiles)
  const int32_t* swb_long = nullptr;
  int swb_long_count = 0;
  const int32_t* swb_short = nullptr;
  int swb_short_count = 0;
  int tns_max_long = 0;        // TNS band clamps (caller-resolved)
  int tns_max_short = 0;
  int pred_sfb_max = 0;        // Main (AOT 1): highest predicted sfb
                               // (ISO/IEC 14496-3 Table 4.128, caller-
                               // resolved = python tables.PRED_SFB_MAX)
};

bool decode_ics_info(BitReader* br, const StreamConfig& cfg, ICSInfo* info,
                     int prev_shape, ParseError* err) {
  bool ok = true;
  if (!br->advance(1)) FAIL(err, ERR_BITSTREAM, "ics_info: eof");
  info->window_sequence = br->read(2, &ok);
  info->prev_window_shape = prev_shape;
  info->window_shape = br->read(1, &ok);
  if (cfg.profile == 23 && info->window_sequence != ONLY_LONG)
    FAIL(err, ERR_BITSTREAM, "window_sequence %d in AAC-LD",
         info->window_sequence);
  info->group_count = 1;
  memset(info->group_length, 0, sizeof(info->group_length));
  info->group_length[0] = 1;
  info->frame_len = cfg.frame_len;
  info->short_len = cfg.short_len;
  if (info->window_sequence == EIGHT_SHORT) {
    info->max_sfb = br->read(4, &ok);
    for (int i = 0; i < 7; ++i) {
      if (br->read(1, &ok)) {
        info->group_length[info->group_count - 1]++;
      } else {
        info->group_count++;
        info->group_length[info->group_count - 1] = 1;
      }
    }
    info->window_count = 8;
    info->swb_offsets = cfg.swb_short;
    info->swb_count = cfg.swb_short_count;
    if (!cfg.swb_short)
      FAIL(err, ERR_BITSTREAM, "short windows without a short SWB table");
  } else {
    info->max_sfb = br->read(6, &ok);
    info->window_count = 1;
    info->swb_offsets = cfg.swb_long;
    info->swb_count = cfg.swb_long_count;
    if (br->read(1, &ok)) {  // predictor_data_present
      info->pred_present = true;
      if (cfg.profile == 1) {
        // Main-profile backward prediction (ISO/IEC 14496-3 §4.6.2.1;
        // mirrors syntax.py / libavcodec decode_prediction)
        if (br->read(1, &ok)) {  // predictor_reset
          info->pred_reset_group = static_cast<int>(br->read(5, &ok));
          if (info->pred_reset_group < 1 || info->pred_reset_group > 30)
            FAIL(err, ERR_BITSTREAM, "invalid predictor reset group");
        }
        const int n = info->max_sfb < cfg.pred_sfb_max ? info->max_sfb
                                                       : cfg.pred_sfb_max;
        for (int i = 0; i < n; ++i)
          if (br->read(1, &ok)) info->pred_used |= 1ull << i;
      } else if (cfg.profile == 4) {
        if (br->read(1, &ok)) {  // ltp_data_present
          info->ltp_lag = static_cast<int>(br->read(11, &ok));
          info->ltp_coef = static_cast<int>(br->read(3, &ok));
          const int n = info->max_sfb < 40 ? info->max_sfb : 40;
          for (int i = 0; i < n; ++i)
            if (br->read(1, &ok)) info->ltp_used |= 1ull << i;
        }
      } else if (cfg.profile == 23) {
        // LD LTP uses a different lag coding (§4.6.20.3); libavcodec
        // also rejects it (decode_ics_info)
        FAIL(err, ERR_UNSUPPORTED, "LTP in ER AAC-LD not supported");
      } else {
        FAIL(err, ERR_UNSUPPORTED,
             "prediction data in a non-predictive profile");
      }
    }
  }
  if (!ok) FAIL(err, ERR_BITSTREAM, "ics_info: eof");
  if (info->max_sfb > info->swb_count)
    FAIL(err, ERR_BITSTREAM, "max_sfb %d > swb_count %d", info->max_sfb,
         info->swb_count);
  return true;
}

// AAC-ELD ics_info (ISO/IEC 14496-3 §4.6.20.3): the low-delay filterbank
// has a single window, so the side info reduces to max_sfb (mirrors
// aacjax/host/syntax.py ICSInfo.decode_eld).
bool decode_ics_info_eld(BitReader* br, const StreamConfig& cfg,
                         ICSInfo* info, ParseError* err) {
  bool ok = true;
  info->window_sequence = ONLY_LONG;
  info->window_shape = 0;
  info->prev_window_shape = 0;
  info->group_count = 1;
  memset(info->group_length, 0, sizeof(info->group_length));
  info->group_length[0] = 1;
  info->window_count = 1;
  info->frame_len = cfg.frame_len;
  info->short_len = cfg.short_len;
  info->max_sfb = br->read(6, &ok);
  info->swb_offsets = cfg.swb_long;
  info->swb_count = cfg.swb_long_count;
  if (!ok) FAIL(err, ERR_BITSTREAM, "ics_info: eof");
  if (info->max_sfb > info->swb_count)
    FAIL(err, ERR_BITSTREAM, "max_sfb %d > swb_count %d", info->max_sfb,
         info->swb_count);
  return true;
}

bool decode_band_types(BitReader* br, Channel* ch, ParseError* err) {
  const ICSInfo& info = ch->info;
  bool ok = true;
  int bits = info.window_sequence == EIGHT_SHORT ? 3 : 5;
  uint32_t escape = (1u << bits) - 1;
  int idx = 0;
  for (int g = 0; g < info.group_count; ++g) {
    int k = 0;
    while (k < info.max_sfb) {
      int end = k;
      int band_type = br->read(4, &ok);
      if (band_type == 12) FAIL(err, ERR_BITSTREAM, "Invalid band type: 12");
      uint32_t incr;
      do {
        incr = br->read(bits, &ok);
        end += incr;
      } while (incr == escape && ok);
      if (!ok) FAIL(err, ERR_BITSTREAM, "section_data: eof");
      if (end > info.max_sfb)
        FAIL(err, ERR_BITSTREAM, "Too many bands (%d > %d)", end, info.max_sfb);
      for (; k < end; ++k) {
        ch->band_types[idx] = band_type;
        ch->sect_end[idx++] = end;
      }
    }
  }
  return true;
}

int decode_sf_symbol(BitReader* br) {  // returns delta (already -60) or INT32_MIN
  int idx = g_books[11].decode(br);
  if (idx < 0) return INT32_MIN;
  return g_books[11].values(idx)[0] - 60;
}

bool decode_scale_factors(BitReader* br, Channel* ch, ParseError* err) {
  const ICSInfo& info = ch->info;
  bool ok = true;
  int offset[3] = {ch->global_gain, ch->global_gain - 90, 0};
  bool noise_flag = true;
  int idx = 0;
  for (int g = 0; g < info.group_count; ++g) {
    int i = 0;
    while (i < info.max_sfb) {
      int run_end = ch->sect_end[idx];
      int bt = ch->band_types[idx];
      if (bt == ZERO_BT) {
        for (; i < run_end; ++i, ++idx) ch->sf_gain[idx] = 0.0f;
      } else if (bt == INTENSITY_BT || bt == INTENSITY_BT2) {
        for (; i < run_end; ++i, ++idx) {
          int d = decode_sf_symbol(br);
          if (d == INT32_MIN) FAIL(err, ERR_BITSTREAM, "bad sf codeword");
          offset[2] += d;
          int tmp = offset[2] < -155 ? -155 : (offset[2] > 100 ? 100 : offset[2]);
          ch->sf_gain[idx] = sf_gain_index(-tmp + 200, &ch->n_gain_misses);
        }
      } else if (bt == NOISE_BT) {
        for (; i < run_end; ++i, ++idx) {
          if (noise_flag) {
            offset[1] += static_cast<int>(br->read(9, &ok)) - 256;
            noise_flag = false;
          } else {
            int d = decode_sf_symbol(br);
            if (d == INT32_MIN) FAIL(err, ERR_BITSTREAM, "bad sf codeword");
            offset[1] += d;
          }
          int tmp = offset[1] < -100 ? -100 : (offset[1] > 155 ? 155 : offset[1]);
          ch->sf_gain[idx] = -sf_gain_index(tmp + 200, &ch->n_gain_misses);
        }
      } else {
        for (; i < run_end; ++i, ++idx) {
          int d = decode_sf_symbol(br);
          if (d == INT32_MIN) FAIL(err, ERR_BITSTREAM, "bad sf codeword");
          offset[0] += d;
          if (offset[0] > 255)
            FAIL(err, ERR_BITSTREAM, "Scalefactor out of range: %d", offset[0]);
          ch->sf_idx[idx] = static_cast<int16_t>(offset[0]);
          ch->sf_gain[idx] =
              sf_gain_index(offset[0] - 100 + 200, &ch->n_gain_misses);
        }
      }
      if (!ok) FAIL(err, ERR_BITSTREAM, "scale_factors: eof");
    }
  }
  return true;
}

bool decode_pulse(BitReader* br, Channel* ch, ParseError* err) {
  const ICSInfo& info = ch->info;
  bool ok = true;
  int count = br->read(2, &ok) + 1;
  int swb = br->read(6, &ok);
  if (!ok) FAIL(err, ERR_BITSTREAM, "pulse: eof");
  if (swb >= info.swb_count)
    FAIL(err, ERR_BITSTREAM, "Pulse SWB out of range: %d", swb);
  ch->pulse_count = count;
  ch->pulse_offset[0] = info.swb_offsets[swb] + br->read(5, &ok);
  ch->pulse_amp[0] = br->read(4, &ok);
  if (ch->pulse_offset[0] > 1023)
    FAIL(err, ERR_BITSTREAM, "Pulse offset out of range: %d", ch->pulse_offset[0]);
  for (int i = 1; i < count; ++i) {
    ch->pulse_offset[i] = br->read(5, &ok) + ch->pulse_offset[i - 1];
    if (ch->pulse_offset[i] > 1023)
      FAIL(err, ERR_BITSTREAM, "Pulse offset out of range: %d",
           ch->pulse_offset[i]);
    ch->pulse_amp[i] = br->read(4, &ok);
  }
  if (!ok) FAIL(err, ERR_BITSTREAM, "pulse: eof");
  return true;
}

bool decode_tns(BitReader* br, Channel* ch, ParseError* err) {
  const ICSInfo& info = ch->info;
  bool ok = true;
  bool is_short = info.window_sequence == EIGHT_SHORT;
  int nfilt_bits = is_short ? 1 : 2;
  int len_bits = is_short ? 4 : 6;
  int ord_bits = is_short ? 3 : 5;
  for (int w = 0; w < info.window_count; ++w) {
    ch->tns.n_filt[w] = br->read(nfilt_bits, &ok);
    if (!ch->tns.n_filt[w]) continue;
    int coef_res = br->read(1, &ok);
    for (int f = 0; f < ch->tns.n_filt[w]; ++f) {
      ch->tns.length[w][f] = br->read(len_bits, &ok);
      ch->tns.order[w][f] = br->read(ord_bits, &ok);
      if (ch->tns.order[w][f] > kTnsOrder)
        FAIL(err, ERR_BITSTREAM, "TNS filter out of range: %d",
             ch->tns.order[w][f]);
      if (ch->tns.order[w][f]) {
        ch->tns.direction[w][f] = br->read(1, &ok);
        int coef_compress = br->read(1, &ok);
        int coef_len = coef_res + 3 - coef_compress;
        const float* table = kTnsTables[2 * coef_compress + coef_res];
        for (int i = 0; i < ch->tns.order[w][f]; ++i)
          ch->tns.coef[w][f][i] = table[br->read(coef_len, &ok)];
      }
    }
  }
  if (!ok) FAIL(err, ERR_BITSTREAM, "tns: eof");
  return true;
}

// q's sign onto m (>= 0) by its bit: no branch on the data
inline float with_sign(float m, int32_t q) {
  uint32_t u;
  memcpy(&u, &m, 4);
  u ^= static_cast<uint32_t>(q) & 0x80000000u;
  memcpy(&m, &u, 4);
  return m;
}

// sign(q) * |q|^(4/3) in float32 (escape values beyond the LUT computed
// directly — SURVEY.md §7 quirk 5)
inline float inverse_quant(int32_t q) {
  uint32_t a = q < 0 ? static_cast<uint32_t>(-q) : static_cast<uint32_t>(q);
  float m = a < 8192 ? g_iq_lut[a]
                     : static_cast<float>(pow(static_cast<double>(a), 4.0 / 3.0));
  return with_sign(m, q);
}

// Where a band's values go.  FusedOut: inverse_quant(q) * gain + 0.0f, the
// value finalize_spec gives the bin (its noise term is +0 there, which
// turns a -0 product into +0), into the f32 row.  QuantOut: q into the
// general path's scratch.
struct FusedOut {
  float* p;
  float gain;
  // kEscape false: |q| <= 16, inside the LUT
  template <bool kEscape = true>
  inline void put(int at, const int32_t* q, int n) const {
    for (int j = 0; j < n; ++j) {
      float x;
      if (kEscape) {
        x = inverse_quant(q[j]);
      } else {
        x = with_sign(g_iq_lut[q[j] < 0 ? -q[j] : q[j]], q[j]);
      }
      p[at + j] = x * gain + 0.0f;
    }
  }
};
struct QuantOut {
  int32_t* p;
  template <bool kEscape = true>
  inline void put(int at, const int32_t* q, int n) const {
    for (int j = 0; j < n; ++j) p[at + j] = q[j];
  }
};

enum SpecKind { QUAD_SIGNED, QUAD_UNSIGNED, PAIR_SIGNED, PAIR_UNSIGNED,
                ESCAPE };

// 64 bits from bit `pos` of the frame, MSB first, zeros past its end
inline uint64_t bits_at(const uint8_t* data, int64_t nbytes, int64_t pos) {
  const int64_t byte = pos >> 3;
  uint64_t w;
  if (__builtin_expect(byte + 8 <= nbytes, 1)) {
    memcpy(&w, data + byte, 8);
    w = __builtin_bswap64(w);
  } else {
    w = 0;
    for (int64_t i = byte; i < nbytes && i < byte + 8; ++i)
      w |= static_cast<uint64_t>(data[i]) << (56 - 8 * (i - byte));
  }
  return w << (pos & 7);
}

// One band of one codebook kind (its windows `stride` bins apart), read
// from the bit position with no check inside: a codeword and its sign
// bits come from one 64-bit load, which reads zeros past the frame.
// Returns false on a bad codeword or an over-long escape, or when the band
// ran past the frame, leaving *br where it was; the caller then decodes
// the band again, checked.
template <int kKind, class Out>
bool spectral_band_fast(BitReader* br, const SpecLut& lut, int width,
                        int windows, int stride, const Out& out) {
  constexpr int kNum = kKind <= QUAD_UNSIGNED ? 4 : 2;
  constexpr bool kUnsigned = kKind == QUAD_UNSIGNED || kKind >= PAIR_UNSIGNED;
  const uint8_t* data = br->data;
  const int64_t nbytes = br->nbytes_;
  int64_t pos = br->bitpos();
  const SpecEntry* l1 = lut.l1;
  const int sh1 = 64 - lut.l1bits;
  for (int w = 0; w < windows; ++w) {
    for (int k = 0; k < width; k += kNum) {
      const uint64_t c = bits_at(data, nbytes, pos);
      SpecEntry e = l1[c >> sh1];
      if (__builtin_expect(!e.len, 0)) {
        if (!e.sub) return false;
        e = lut.l2[(static_cast<size_t>(e.sub - 1) << lut.extbits)
                   + ((c >> (64 - lut.maxlen)) & lut.extmask)];
        if (!e.len) return false;
      }
      int32_t q[kNum];
      for (int j = 0; j < kNum; ++j) q[j] = e.v[j];
      if (kUnsigned) {
        // the sign bits follow the codeword, MSB first, one for each
        // nonzero value in order
        const uint64_t signs = c << e.len;
        int before = 0;
        for (int j = 0; j < kNum; ++j) {
          const int nonzero = q[j] != 0;
          const int32_t neg = -static_cast<int32_t>(
              (signs >> (63 - before)) & static_cast<uint64_t>(nonzero));
          q[j] = (q[j] ^ neg) - neg;
          before += nonzero;
        }
        pos += e.len + e.nz;
      } else {
        pos += e.len;
      }
      if (kKind == ESCAPE && (e.v[0] == 16 || e.v[1] == 16)) {
        for (int j = 0; j < 2; ++j) {
          if (e.v[j] != 16) continue;
          uint64_t x = bits_at(data, nbytes, pos);
          const int ones = __builtin_clzll(~x | 1);
          if (ones > 20) return false;  // "escape too long", checked
          pos += ones + 1;
          const int n = 4 + ones;
          x = bits_at(data, nbytes, pos);
          const int32_t mag = static_cast<int32_t>(x >> (64 - n)) | (1 << n);
          pos += n;
          q[j] = q[j] < 0 ? -mag : mag;
        }
      }
      out.template put<kKind == ESCAPE>(w * stride + k, q, kNum);
    }
  }
  if (pos > br->nbits) return false;
  br->seek(pos);
  return true;
}

// The same band with every read checked: the reference's order of
// reads, errors and messages.
template <class Out>
bool spectral_band_checked(BitReader* br, int hcb, int width, int windows,
                           int stride, const Out& out, ParseError* err) {
  bool ok = true;
  const HuffLut& book = g_books[hcb - 1];
  const int num = hcb >= FIRST_PAIR_BT ? 2 : 4;
  const bool is_unsigned = (hcb == 3 || hcb == 4 || (hcb >= 7 && hcb <= 11));
  for (int w = 0; w < windows; ++w) {
    for (int k = 0; k < width; k += num) {
      int row = book.decode(br);
      if (row < 0) FAIL(err, ERR_BITSTREAM, "bad spectral codeword");
      const int32_t* v = book.values(row);
      int32_t buf[4];
      for (int j = 0; j < num; ++j) buf[j] = v[j];
      if (is_unsigned) {
        // one batched read for all sign bits (MSB-first order ==
        // the reference's sequential per-value reads)
        int nz = 0;
        for (int j = 0; j < num; ++j) nz += buf[j] != 0;
        if (nz) {
          uint32_t signs = br->read(nz, &ok);
          int bit = nz - 1;
          for (int j = 0; j < num; ++j) {
            if (buf[j]) {
              if ((signs >> bit) & 1) buf[j] = -buf[j];
              --bit;
            }
          }
        }
      }
      if (hcb == ESC_BT) {
        for (int j = 0; j < 2; ++j) {
          if (buf[j] == 16 || buf[j] == -16) {
            int n = 4;
            while (br->read(1, &ok)) {
              if (++n > 24) FAIL(err, ERR_BITSTREAM, "escape too long");
            }
            int32_t mag = static_cast<int32_t>(br->read(n, &ok)) | (1 << n);
            buf[j] = buf[j] < 0 ? -mag : mag;
          }
        }
      }
      out.put(w * stride + k, buf, num);
    }
  }
  if (!ok) FAIL(err, ERR_BITSTREAM, "spectral: eof");
  return true;
}

// One band of a spectrum codebook (1-11): the loop of its kind, and where
// that loop gives up, the band again from its first bit, checked.
template <class Out>
bool spectral_band(BitReader* br, int hcb, int width, int windows,
                   int stride, const Out& out, ParseError* err) {
  const SpecLut& lut = g_spec[hcb - 1];
  bool done;
  switch (hcb) {
    case 1: case 2:
      done = spectral_band_fast<QUAD_SIGNED>(br, lut, width, windows, stride,
                                             out);
      break;
    case 3: case 4:
      done = spectral_band_fast<QUAD_UNSIGNED>(br, lut, width, windows,
                                               stride, out);
      break;
    case 5: case 6:
      done = spectral_band_fast<PAIR_SIGNED>(br, lut, width, windows, stride,
                                             out);
      break;
    case ESC_BT:
      done = spectral_band_fast<ESCAPE>(br, lut, width, windows, stride, out);
      break;
    default:
      done = spectral_band_fast<PAIR_UNSIGNED>(br, lut, width, windows,
                                               stride, out);
      break;
  }
  if (done) return true;
  return spectral_band_checked(br, hcb, width, windows, stride, out, err);
}

// The channel's spectral data.  Fused (ch->row set, no pulse data): each
// band straight into the f32 row, PNS noise too, every other bin +0.
// General: quantised values, gains and noise into the scratch, pulse data
// applied, for finalize_spec (or emit_qsf) to read.
bool decode_spectral(BitReader* br, Channel* ch, ParseError* err) {
  const ICSInfo& info = ch->info;
  const int F = info.frame_len;
  ch->fused = ch->row != nullptr && !ch->pulse_present;
  if (ch->fused) {
    memset(ch->row, 0, sizeof(float) * F);
  } else {
    memset(ch->quant, 0, sizeof(int32_t) * F);
    memset(ch->scale, 0, sizeof(float) * F);
    memset(ch->noise, 0, sizeof(float) * F);
  }
  int32_t random_state = 0x1F2E3D4C;
  int group_off = 0;
  int idx = 0;
  for (int g = 0; g < info.group_count; ++g) {
    int group_len = info.group_length[g];
    for (int sfb = 0; sfb < info.max_sfb; ++sfb, ++idx) {
      int hcb = ch->band_types[idx];
      int off0 = group_off + info.swb_offsets[sfb];
      int width = info.swb_offsets[sfb + 1] - info.swb_offsets[sfb];
      if (hcb == ZERO_BT) continue;
      if (hcb == INTENSITY_BT || hcb == INTENSITY_BT2) {
        ++ch->n_general_bands;  // zero here; apply_stereo fills them
      } else if (hcb == NOISE_BT) {
        ++ch->n_general_bands;
        int off = off0;
        for (int grp = 0; grp < group_len; ++grp, off += info.short_len) {
          double energy = 0.0;
          float vals[512];  // >= max SWB width across all frame lengths
          for (int k = 0; k < width; ++k) {
            random_state = static_cast<int32_t>(
                static_cast<uint32_t>(random_state) * 1664525u + 1013904223u);
            vals[k] = static_cast<float>(random_state);
            energy += static_cast<double>(vals[k]) * vals[k];
          }
          double scale = static_cast<double>(ch->sf_gain[idx]) / sqrt(energy);
          float fs = static_cast<float>(scale);
          if (ch->fused) {  // + 0.0f: the +0 product finalize_spec adds
            for (int k = 0; k < width; ++k)
              ch->row[off + k] = vals[k] * fs + 0.0f;
          } else {
            for (int k = 0; k < width; ++k) ch->noise[off + k] = vals[k] * fs;
          }
        }
      } else if (ch->fused) {
        ++ch->n_fused_bands;
        if (!spectral_band(br, hcb, width, group_len, info.short_len,
                           FusedOut{ch->row + off0, ch->sf_gain[idx]}, err))
          return false;
      } else {
        ++ch->n_general_bands;
        if (!spectral_band(br, hcb, width, group_len, info.short_len,
                           QuantOut{ch->quant + off0}, err))
          return false;
        int off = off0;
        for (int grp = 0; grp < group_len; ++grp, off += info.short_len)
          for (int k = 0; k < width; ++k) ch->scale[off + k] = ch->sf_gain[idx];
      }
    }
    group_off += group_len * info.short_len;
  }
  // pulse application (spec-correct; SURVEY.md §7); a channel with pulse
  // data is always on the general path
  if (ch->pulse_present) {
    for (int i = 0; i < ch->pulse_count; ++i) {
      int32_t q = ch->quant[ch->pulse_offset[i]];
      ch->quant[ch->pulse_offset[i]] =
          q < 0 ? q - ch->pulse_amp[i] : q + ch->pulse_amp[i];
    }
  }
  return true;
}

// Levinson-style reflection -> direct-form LPC (tns.js:127-140 semantics)
void reflection_to_lpc(const float* refl, int order, float* out) {
  double lpc[kTnsOrder] = {0};
  double prev[kTnsOrder];
  for (int i = 0; i < order; ++i) {
    double r = -static_cast<double>(refl[i]);
    memcpy(prev, lpc, sizeof(lpc));
    lpc[i] = r;
    for (int j = 0; j < (i + 1) / 2; ++j) {
      double f = prev[j], b = prev[i - 1 - j];
      lpc[j] = f + r * b;
      lpc[i - 1 - j] = b + r * f;
    }
  }
  for (int i = 0; i < order; ++i) out[i] = static_cast<float>(lpc[i]);
}

// Resolve TNS side info to packed filter banks.
// tns_lpc layout: [2][kTnsSlots][kTnsOrder]; tns_range: [2][kTnsSlots][2].
// Bank 0 = forward; bank 1 = reversed with flipped coordinates
// (start' = 1024 - end), matching aacjax/runtime/pack.py.
bool resolve_tns(const Channel* ch, int max_bands, float* tns_lpc,
                 int32_t* tns_range, bool* any) {
  const ICSInfo& info = ch->info;
  int mmm = max_bands < info.max_sfb ? max_bands : info.max_sfb;
  int nf = 0, nr = 0;
  for (int w = 0; w < info.window_count; ++w) {
    int bottom = info.swb_count;
    for (int f = 0; f < ch->tns.n_filt[w]; ++f) {
      int top = bottom;
      int len = ch->tns.length[w][f];
      bottom = top - len > 0 ? top - len : 0;
      int order = ch->tns.order[w][f];
      if (!order) continue;
      int b = bottom < mmm ? bottom : mmm;
      int t = top < mmm ? top : mmm;
      int start = info.swb_offsets[b];
      int end = info.swb_offsets[t];
      if (end - start <= 0) continue;
      start += w * info.short_len;
      end += w * info.short_len;
      float lpc[kTnsOrder] = {0};
      reflection_to_lpc(ch->tns.coef[w][f], order, lpc);
      int bank, slot;
      int s, e;
      if (!ch->tns.direction[w][f]) {
        bank = 0; slot = nf++; s = start; e = end;
      } else {
        bank = 1; slot = nr++;
        s = info.frame_len - end; e = info.frame_len - start;
      }
      if (slot >= kTnsSlots) return false;  // cannot happen per spec limits
      memcpy(tns_lpc + (bank * kTnsSlots + slot) * kTnsOrder, lpc,
             sizeof(float) * kTnsOrder);
      tns_range[(bank * kTnsSlots + slot) * 2 + 0] = s;
      tns_range[(bank * kTnsSlots + slot) * 2 + 1] = e;
      *any = true;
    }
  }
  return true;
}

bool decode_ics(BitReader* br, const StreamConfig& cfg, Channel* ch,
                ICSInfo* common_info, int prev_shape, ParseError* err) {
  bool ok = true;
  ch->global_gain = br->read(8, &ok);
  if (!ok) FAIL(err, ERR_BITSTREAM, "ics: eof");
  const bool eld = cfg.profile == 39;
  if (common_info) {
    ch->info = *common_info;
    ch->info.prev_window_shape = prev_shape;
  } else if (eld) {
    if (!decode_ics_info_eld(br, cfg, &ch->info, err)) return false;
  } else {
    if (!decode_ics_info(br, cfg, &ch->info, prev_shape, err)) return false;
  }
  if (!decode_band_types(br, ch, err)) return false;
  if (!decode_scale_factors(br, ch, err)) return false;
  if (eld) {
    // ELD individual_channel_stream (§4.6.20.2): no pulse bit and no
    // gain-control bit; tns_data follows its flag directly
    ch->tns_present = br->read(1, &ok);
    if (!ok) FAIL(err, ERR_BITSTREAM, "ics: eof");
    if (ch->tns_present && !decode_tns(br, ch, err)) return false;
    return decode_spectral(br, ch, err);
  }
  const bool er = cfg.profile == 17 || cfg.profile == 23;
  ch->pulse_present = br->read(1, &ok);
  if (ch->pulse_present) {
    if (er)
      FAIL(err, ERR_BITSTREAM, "Pulse tool not allowed in ER AAC");
    if (ch->info.window_sequence == EIGHT_SHORT)
      FAIL(err, ERR_BITSTREAM, "Pulse tool not allowed in eight short sequence.");
    if (!decode_pulse(br, ch, err)) return false;
  }
  ch->tns_present = br->read(1, &ok);
  if (ch->tns_present && !er) {
    if (!decode_tns(br, ch, err)) return false;
  }
  if (br->read(1, &ok))
    FAIL(err, ERR_UNSUPPORTED, "gain control/SSR not supported");
  if (ch->tns_present && er) {
    // ER syntax: tns_data follows the gain-control bit
    if (!decode_tns(br, ch, err)) return false;
  }
  if (!ok) FAIL(err, ERR_BITSTREAM, "ics: eof");
  return decode_spectral(br, ch, err);
}

// ---------------------------------------------------------------------
// Coupling channel element (cce.js:45-119; mirrors
// aacjax/host/syntax.py decode_cce incl. the spec-correct divergences:
// the ind_sw value 3 normalizes to AFTER_IMDCT, and dependent coupling
// uses the ICS band bounds — cce.js:149 would crash on them).
// ---------------------------------------------------------------------
constexpr int kMaxCce = 16;
constexpr int kMaxCceGains = 17;  // 1 + 8 targets * (ch_select==3 ? 2 : 1)

struct CCE {
  Channel ch;                 // dense pointers dangle after decode; info/
                              // band layout stay valid for gain expansion
  float spec[kFrameLen];      // finalized raw coupling spectrum
  int coupling_point = BEFORE_TNS;
  int coupled_count = 0;
  int channel_pair[8] = {0};
  int id_select[8] = {0};
  int ch_select[8] = {0};
  int gain_count = 0;
  float gain[kMaxCceGains][kMaxSections];
  int id = 0;
  int slot = -1;              // assigned output slot, or -1 (none free)
};

bool decode_cce(BitReader* br, const StreamConfig& cfg, CCE* cce,
                ChannelScratch* scratch, ParseError* err) {
  bool ok = true;
  cce->coupling_point = 2 * static_cast<int>(br->read(1, &ok));
  cce->coupled_count = static_cast<int>(br->read(3, &ok));
  cce->gain_count = 0;
  for (int i = 0; i <= cce->coupled_count; ++i) {
    cce->gain_count++;
    cce->channel_pair[i] = static_cast<int>(br->read(1, &ok));
    cce->id_select[i] = static_cast<int>(br->read(4, &ok));
    if (cce->channel_pair[i]) {
      cce->ch_select[i] = static_cast<int>(br->read(2, &ok));
      if (cce->ch_select[i] == 3) cce->gain_count++;
    } else {
      cce->ch_select[i] = 2;
    }
  }
  cce->coupling_point += static_cast<int>(br->read(1, &ok));
  cce->coupling_point |= cce->coupling_point >> 1;
  if (cce->coupling_point == 3) cce->coupling_point = AFTER_IMDCT;
  if (!ok) FAIL(err, ERR_BITSTREAM, "cce: eof");

  int sign = static_cast<int>(br->read(1, &ok));
  double scale = kCceScale[br->read(2, &ok)];
  cce->ch.attach(scratch, nullptr);  // the general path, into cce->spec
  // coupling channels carry no cross-frame shape history (the reference
  // recreates the element per frame): prev_shape is always 0, matching
  // syntax.py decode_cce
  if (!decode_ics(br, cfg, &cce->ch, nullptr, 0, err)) return false;

  int group_count = cce->ch.info.group_count;
  int max_sfb = cce->ch.info.max_sfb;
  for (int i = 0; i < cce->gain_count; ++i) {
    int cge = 1;
    int gain = 0;
    double gain_cache = 1.0;
    if (i > 0) {
      cge = cce->coupling_point == AFTER_IMDCT
                ? 1 : static_cast<int>(br->read(1, &ok));
      if (cge) {
        int d = decode_sf_symbol(br);
        if (d == INT32_MIN) FAIL(err, ERR_BITSTREAM, "cce: bad gain codeword");
        gain = d;
      }
      gain_cache = pow(scale, -gain);
    }
    memset(cce->gain[i], 0, sizeof(cce->gain[i]));
    if (cce->coupling_point == AFTER_IMDCT) {
      cce->gain[i][0] = static_cast<float>(gain_cache);
    } else {
      int idx = 0;
      for (int g = 0; g < group_count; ++g) {
        for (int sfb = 0; sfb < max_sfb; ++sfb, ++idx) {
          if (cce->ch.band_types[idx] != ZERO_BT) {
            if (cge == 0) {
              int t = decode_sf_symbol(br);
              if (t == INT32_MIN)
                FAIL(err, ERR_BITSTREAM, "cce: bad gain codeword");
              if (t != 0) {
                int s = 1;
                gain += t;
                t = gain;
                if (!sign) {
                  s -= 2 * (t & 0x1);
                  t >>= 1;
                }
                gain_cache = pow(scale, -t) * s;
              }
            }
            cce->gain[i][idx] = static_cast<float>(gain_cache);
          }
        }
      }
    }
  }
  if (!ok) FAIL(err, ERR_BITSTREAM, "cce: eof");
  return true;
}

// Expand per-(group, sfb) gains to a per-bin [1024] vector over the
// grouped window layout (runtime/pack.py expand_per_bin).
void expand_gain(const ICSInfo& info, const float* g, float* out) {
  memset(out, 0, sizeof(float) * info.frame_len);
  int idx = 0, group_off = 0;
  for (int grp = 0; grp < info.group_count; ++grp) {
    int glen = info.group_length[grp];
    for (int sfb = 0; sfb < info.max_sfb; ++sfb, ++idx) {
      float v = g[idx];
      if (v != 0.0f) {
        int off = info.swb_offsets[sfb];
        int width = info.swb_offsets[sfb + 1] - off;
        for (int w = 0; w < glen; ++w) {
          float* p = out + group_off + w * info.short_len + off;
          for (int k = 0; k < width; ++k) p[k] = v;
        }
      }
    }
    group_off += glen * info.short_len;
  }
}

// One parsed element's identity for coupling-target resolution
struct ElemRef {
  bool is_pair;
  int id;
  int slot0;
  int slot1;       // == slot0 for SCE
  bool tns0;
  bool tns1;
};

// Replicates runtime/pack.py resolve_cce_targets (reference gain-index
// bookkeeping, decoder.js:406-433): chSelect 1 -> second channel of the
// pair, 2 -> first (and SCE), 0 -> both with one gain, 3 -> both with
// separate gains.
int resolve_cce_targets(const CCE& cce, const ElemRef* elems, int n_elems,
                        int* dst_slots, int* gain_idx, bool* dst_tns) {
  int n = 0;
  for (int e = 0; e < n_elems; ++e) {
    int index = 0;
    for (int c = 0; c <= cce.coupled_count; ++c) {
      int cs = cce.ch_select[c];
      if ((cce.channel_pair[c] != 0) == elems[e].is_pair
          && cce.id_select[c] == elems[e].id) {
        if (cs != 1) {
          dst_slots[n] = elems[e].slot0;
          dst_tns[n] = elems[e].tns0;
          gain_idx[n++] = index;
          if (cs) index++;
        }
        if (cs != 2) {
          dst_slots[n] = elems[e].slot1;
          dst_tns[n] = elems[e].tns1;
          gain_idx[n++] = index;
          index++;
        }
      } else {
        index += 1 + (cs == 3 ? 1 : 0);
      }
    }
  }
  return n;
}

}  // namespace

// ---------------------------------------------------------------------
// Fused spectral finalization (host-prep mode): dequant + PNS + M/S + IS
// collapse into one float32 spectrum per channel-frame, so the host->device
// transfer is 4KB/channel-frame instead of 16KB (quant+scale+noise+masks).
// The device then runs TNS + IMDCT + overlap-add only.
// ---------------------------------------------------------------------
// Exact-i16 spectral transfer (HE-AAC fast path): emit the RAW quantized
// coefficients (int16-exact after pulse application, |q| <= 32767) and
// the 8-bit scalefactor index per 4-bin group (every SWB offset and
// window stride is a multiple of 4 across all frame lengths, verified
// against aacjax.tables).  The device dequantizes: |q|^(4/3) * scale,
// via a gather into the SAME 8192-entry f64-pow->f32 LUT as
// inverse_quant — bit-exact vs the host-fused f32 path.
// Returns false when the channel cannot ride this representation —
// PNS bands (host-generated noise values), intensity bands (fused
// per-band gains), or quantized values past the LUT (|q| > 8191, only
// reachable through escape sequences) — the caller then ships the
// classic fused f32 row for the whole chunk.
bool emit_qsf(const Channel& ch, int16_t* qrow, uint8_t* sfrow) {
  const ICSInfo& info = ch.info;
  const int F = info.frame_len;
  memset(qrow, 0, sizeof(int16_t) * F);
  memset(sfrow, 0, static_cast<size_t>(F) / 4);
  int idx = 0, group_off = 0;
  for (int g = 0; g < info.group_count; ++g) {
    for (int sfb = 0; sfb < info.max_sfb; ++sfb, ++idx) {
      int bt = ch.band_types[idx];
      if (bt == NOISE_BT || bt == INTENSITY_BT || bt == INTENSITY_BT2)
        return false;
      if (bt == ZERO_BT) continue;
      if (ch.sf_idx[idx] < 0 || ch.sf_idx[idx] > 255) return false;
      const uint8_t sf = static_cast<uint8_t>(ch.sf_idx[idx]);
      const int off = info.swb_offsets[sfb];
      const int width = info.swb_offsets[sfb + 1] - off;
      int base = group_off + off;
      for (int w = 0; w < info.group_length[g];
           ++w, base += info.short_len) {
        for (int k = 0; k < width; ++k) {
          int32_t q = ch.quant[base + k];
          if (q > 8191 || q < -8191) return false;
          qrow[base + k] = static_cast<int16_t>(q);
        }
        memset(sfrow + (base >> 2), sf, static_cast<size_t>(width) >> 2);
      }
    }
    group_off += info.group_length[g] * info.short_len;
  }
  return true;
}

void finalize_spec(const Channel& ch, float* spec_row) {
  for (int i = 0; i < ch.info.frame_len; ++i)
    spec_row[i] = inverse_quant(ch.quant[i]) * ch.scale[i] + ch.noise[i];
}

// M/S then intensity, matching decoder.js:379-404 / 337-376 and the
// device-path masks in runtime/pack.py.
void apply_stereo(const Channel& left, const Channel& right,
                  const float* ms_used, bool mask_present,
                  float* ls, float* rs) {
  const ICSInfo& li = left.info;
  if (mask_present) {
    int idx = 0, group_off = 0;
    for (int g = 0; g < li.group_count; ++g) {
      int glen = li.group_length[g];
      for (int sfb = 0; sfb < li.max_sfb; ++sfb, ++idx) {
        if (ms_used[idx] == 0.0f) continue;
        if (left.band_types[idx] >= NOISE_BT
            || right.band_types[idx] >= NOISE_BT) continue;
        int off = li.swb_offsets[sfb];
        int width = li.swb_offsets[sfb + 1] - off;
        for (int w = 0; w < glen; ++w) {
          float* lp = ls + group_off + w * li.short_len + off;
          float* rp = rs + group_off + w * li.short_len + off;
          for (int k = 0; k < width; ++k) {
            float t = lp[k] - rp[k];
            lp[k] = lp[k] + rp[k];
            rp[k] = t;
          }
        }
      }
      group_off += glen * li.short_len;
    }
  }
  // intensity (uses the right channel's band structure)
  const ICSInfo& ri = right.info;
  int idx = 0, group_off = 0;
  for (int g = 0; g < ri.group_count; ++g) {
    int glen = ri.group_length[g];
    for (int sfb = 0; sfb < ri.max_sfb; ++sfb, ++idx) {
      int bt = right.band_types[idx];
      if (bt != INTENSITY_BT && bt != INTENSITY_BT2) continue;
      float c = bt == INTENSITY_BT ? 1.0f : -1.0f;
      if (mask_present && ms_used[idx] != 0.0f) c = -c;
      float scale = c * right.sf_gain[idx];
      int off = ri.swb_offsets[sfb];
      int width = ri.swb_offsets[sfb + 1] - off;
      for (int w = 0; w < glen; ++w) {
        const float* lp = ls + group_off + w * ri.short_len + off;
        float* rp = rs + group_off + w * ri.short_len + off;
        for (int k = 0; k < width; ++k) rp[k] = lp[k] * scale;
      }
    }
    group_off += glen * ri.short_len;
  }
}

// Compact-transfer conversion: f32 spectra -> block-scaled int16 fixed
// point.  Each 16-bin block of a row (channel-frame) is scaled so its max
// magnitude maps to 32767, giving 15 significant bits *per block* — the
// quantization floor tracks the spectral envelope, so a loud tonal bin
// cannot inflate the noise of quiet bands (decoded SNR stays ~>90 dB,
// below the codec's own quantization noise at any practical rate).  The
// device multiplies the int16 payload by the per-block f32 scales.
// Payload: 2 KB int16 + 256 B scales per channel-frame vs 4 KB f32 (~44%
// less H2D); the f32 path stays the bit-exact default.
constexpr int kI16Block = 16;

// One row of n_cols bins (n_cols % 16 == 0); aacjax_spec_to_i16 and the
// parse's threads both call it.  native/aacparse.cc's loop, bit for bit.
static inline void spec_row_to_i16(const float* row, int n_cols,
                                   int16_t* o, float* sc) {
  const int n_blocks = n_cols / kI16Block;  // 64 at 1024
  for (int b = 0; b < n_blocks; ++b) {
    const float* p = row + b * kI16Block;
    float m = 0.0f;
    for (int i = 0; i < kI16Block; ++i) {
      float a = fabsf(p[i]);
      if (a > m) m = a;
    }
    int16_t* q = o + b * kI16Block;
    if (m == 0.0f) {  // silent block (also covers concealed frames)
      sc[b] = 0.0f;
      memset(q, 0, sizeof(int16_t) * kI16Block);
      continue;
    }
    const float s = m / 32767.0f;
    const float inv = 32767.0f / m;
    sc[b] = s;
    for (int i = 0; i < kI16Block; ++i) {
      float v = p[i] * inv;
      v = v > 32767.0f ? 32767.0f : (v < -32767.0f ? -32767.0f : v);
      v = v == v ? v : 0.0f;  // a NaN bin gives 0, as lrintf's did on x86
      // nearbyintf rounds half to even as lrintf does in the default
      // rounding mode, and lets the loop vectorise (lrintf does not)
      q[i] = static_cast<int16_t>(static_cast<int32_t>(nearbyintf(v)));
    }
  }
}

// ---------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------
extern "C" {

// Parse and spectrally finalize a whole multi-stream chunk in one call.
//
// Per stream s, frames are blob[frame_offsets[i] .. frame_offsets[i+1])
// for i in [stream_frame_start[s], stream_frame_start[s+1]).  Outputs are
// final float32 spectra (dequant + PNS + M/S + intensity + dependent
// coupling applied) plus window meta, resolved TNS filters, and device-
// side coupling entries (AFTER_TNS coupling onto TNS'd targets, and
// AFTER_IMDCT time-domain coupling); the device runs TNS + coupling FMAs
// + IMDCT + OLA.
//
// stream_status[s]: 0 ok, ERR_FALLBACK = reparse this stream in Python
// (capacity overflow), other = first frame error; later frames of such a
// stream are still decoded, with the corrupt frame concealed as silence
// (the overlap-add chain stays correct: its spectrum is zeroed but the
// frame stays "present", so the previous frame's tail still plays out and
// a zero overlap carries forward).  Other streams are never affected.
//
// spec_i16 [total_slots, T, frame_len] and spec_scale [total_slots, T,
// frame_len / 16] (nullable, both or neither): what aacjax_spec_to_i16
// gives for every row of the stream's slots (all T rows, whatever the
// stream's status), written by the thread that parsed the stream right
// after its rows.  parse_counts (nullable) sums each thread's counts
// after the join.
int aacparse_batch_spec(
    const uint8_t* blob, const int64_t* frame_offsets,
    const int32_t* stream_frame_start,
    const int32_t* sample_index_arr, const int32_t* chan_config_arr,
    const int32_t* base_slot_arr, const int32_t* n_slots_arr,
    const int32_t* profile_arr,   // [n_streams] AOT (2/5/17/23/39)
    int frame_len,                // 1024 / 960 / 512 / 480 (chunk-global)
    const int32_t* swb_long_flat,   // [n_streams, 64] offsets (count+1 used)
    const int32_t* swb_long_count,  // [n_streams]
    const int32_t* swb_short_flat,  // [n_streams, 20]; count 0 = no shorts
    const int32_t* swb_short_count, // [n_streams]
    const int32_t* tns_max_arr,     // [n_streams, 2] = (long, short)
    const int32_t* pred_sfb_arr,    // [n_streams] Main pred_sfb_max
                                    // (nullable: 0 for non-Main streams)
    int n_streams, int total_slots, int T,
    int32_t* prev_shapes,
    float* spec,        // [total_slots, T, frame_len]
    int32_t* meta,      // [total_slots, T, 6]
    float* tns_lpc,     // [total_slots, T, 2, 8, 20]
    int32_t* tns_range, // [total_slots, T, 2, 8, 2]
    int32_t* cce_post_idx,   // [post_cap, 3] = (src_slot, dst_slot, t)
    float* cce_post_gain,    // [post_cap, 1024]
    int32_t post_cap,
    int32_t* cce_time_idx,   // [time_cap, 3] = (src_slot, dst_slot, t)
    float* cce_time_gain,    // [time_cap]
    int32_t time_cap,
    int32_t* cce_counts,     // [2] out: {n_post, n_time}
    int64_t* consumed_bits,  // [total frames] out (nullable): byte-aligned
                             // bits consumed per successful frame — lets a
                             // streaming caller hand in an oversized tail
                             // buffer and learn where the block ended
    int64_t* fil_sbr,        // [total frames, 4, 3] out (nullable): per
                             // frame, up to 4 SBR FIL extension records
                             // (payload bit offset AFTER the count field,
                             // preceding element's base slot, its channel
                             // count); 0-filled rows = none.  Lets the
                             // caller parse just the tiny HE-AAC SBR
                             // payloads in python while this parser does
                             // the core (the FIL bytes are still skipped
                             // here as always)
    int64_t* fil_drc,        // [total frames] out (nullable): bit offset
                             // of a dynamic_range_info FIL extension
                             // (before its 4-bit type), 0 = none.  The
                             // caller parses the ~10-byte payload in
                             // python and folds the gains into the
                             // already-dequantized spectra — DRC keeps
                             // the native fast path
    int32_t* stream_status,  // [n_streams]
    int32_t* has_tns_out,    // [1]
    int16_t* spec_q,         // [total_slots, T, frame_len] out (nullable):
                             // exact-i16 transfer — raw quantized
                             // coefficients; see emit_qsf
    uint8_t* spec_sf,        // [total_slots, T, frame_len/4] out: 8-bit
                             // scalefactor index per 4-bin group
    int32_t* qsf_ok,         // [n_streams] out: 1 = every frame of the
                             // stream rode the q/sf representation (no
                             // PNS/intensity/M-S/CCE/escape-past-i16);
                             // 0 = caller must ship the f32 spectra
    int32_t* pred_meta,      // [total_slots, T, 3] out (nullable): Main-
                             // profile predictor stage feed = (mode,
                             // reset_group, nbins); mode 0 none, 1
                             // predict+update (long), 2 reset-all
                             // (short) — mirrors runtime/pack.py
    uint8_t* pred_used_bin,  // [total_slots, T, 672] out: 1 per bin of a
                             // prediction_used sfb (device stage mask)
    int32_t* ltp_meta,       // [total_slots, T, 3] out (nullable): AAC-
                             // LTP side info = (lag, coef_idx, 0); lag 0
                             // = no prediction this channel-frame
    uint8_t* ltp_used_sfb,   // [total_slots, T, 40] out: used flag per
                             // sfb (host LTP fast path expands to bins)
    char* errbuf, int errbuf_len,
    int16_t* spec_i16,       // [total_slots, T, frame_len] out (nullable)
    float* spec_scale,       // [total_slots, T, frame_len / 16] out
    int64_t* parse_counts) { // [3] out (nullable): bands decoded straight
                             // into the f32 rows, bands on the general
                             // path (PNS, intensity, and every band of a
                             // channel with pulse data, of a coupling
                             // channel or of a q/sf stream), and scale-
                             // factor gains that missed the table
  ensure_init();
  (void)total_slots;
  if (errbuf_len > 0) errbuf[0] = '\0';

  // Streams write disjoint output regions (their own slots/frames), so
  // they parallelize across host cores; only the CCE side arrays append
  // through a counter, so each worker gets its own arena slice of the
  // caller's capacity (compacted to a contiguous prefix after the join).
  struct CceArena {
    int32_t* post_idx; float* post_gain; int post_cap; int post_count;
    int32_t* time_idx; float* time_gain; int time_cap; int time_count;
  };

  // counts: the thread's {fused bands, general bands, gain misses}
  auto parse_stream = [&](int s, CceArena* arena, bool* any_tns_out,
                          char* ebuf, int eblen, int64_t* counts) {
    static thread_local ChannelScratch scratch[2];
    static thread_local CCE cce_store[kMaxCce];
    bool any_tns = false;
    auto count = [counts](const Channel& ch) {
      counts[0] += ch.n_fused_bands;
      counts[1] += ch.n_general_bands;
      counts[2] += ch.n_gain_misses;
    };
    stream_status[s] = OK;
    StreamConfig cfg{sample_index_arr[s], chan_config_arr[s]};
    cfg.profile = profile_arr[s];
    cfg.frame_len = frame_len;
    cfg.short_len = frame_len / 8;
    cfg.swb_long = swb_long_flat + static_cast<size_t>(s) * 64;
    cfg.swb_long_count = swb_long_count[s];
    cfg.swb_short = swb_short_count[s]
                        ? swb_short_flat + static_cast<size_t>(s) * 20
                        : nullptr;
    cfg.swb_short_count = swb_short_count[s];
    cfg.tns_max_long = tns_max_arr[s * 2 + 0];
    cfg.tns_max_short = tns_max_arr[s * 2 + 1];
    cfg.pred_sfb_max = pred_sfb_arr ? pred_sfb_arr[s] : 0;
    int base = base_slot_arr[s];
    int n_slots = n_slots_arr[s];
    int f_lo = stream_frame_start[s];
    int f_hi = stream_frame_start[s + 1];
    int n_frames = f_hi - f_lo;
    if (n_frames > T) { stream_status[s] = ERR_BOUNDS; return; }

    const bool want_qsf = spec_q != nullptr && spec_sf != nullptr;
    bool qsf_stream = want_qsf;
    if (qsf_ok) qsf_ok[s] = 0;

    // zero this stream's meta + tns region (spec rows of valid frames are
    // fully overwritten; invalid frames carry valid=0 and are discarded)
    for (int sl = base; sl < base + n_slots; ++sl) {
      if (want_qsf) {
        memset(spec_q + static_cast<size_t>(sl) * T * frame_len, 0,
               sizeof(int16_t) * T * frame_len);
        memset(spec_sf + static_cast<size_t>(sl) * T * (frame_len / 4), 0,
               static_cast<size_t>(T) * (frame_len / 4));
      }
      memset(meta + static_cast<size_t>(sl) * T * 6, 0,
             sizeof(int32_t) * T * 6);
      memset(tns_lpc + static_cast<size_t>(sl) * T * 2 * kTnsSlots * kTnsOrder,
             0, sizeof(float) * T * 2 * kTnsSlots * kTnsOrder);
      memset(tns_range + static_cast<size_t>(sl) * T * 2 * kTnsSlots * 2, 0,
             sizeof(int32_t) * T * 2 * kTnsSlots * 2);
      if (pred_meta) {
        memset(pred_meta + static_cast<size_t>(sl) * T * 3, 0,
               sizeof(int32_t) * T * 3);
        memset(pred_used_bin + static_cast<size_t>(sl) * T * 672, 0,
               static_cast<size_t>(T) * 672);
      }
      if (ltp_meta) {
        memset(ltp_meta + static_cast<size_t>(sl) * T * 3, 0,
               sizeof(int32_t) * T * 3);
        memset(ltp_used_sfb + static_cast<size_t>(sl) * T * 40, 0,
               static_cast<size_t>(T) * 40);
      }
    }

    ParseError err{OK, ""};
    int first_err = OK;
    constexpr int kSnapMax = 64;
    int32_t shape_snap[kSnapMax];
    const int snap_n = n_slots < kSnapMax ? n_slots : kSnapMax;
    for (int t = 0; t < n_frames; ++t) {
      // snapshot rollback state so a corrupt frame never leaks partial
      // side effects (shapes, coupling entries, half-written rows)
      memcpy(shape_snap, prev_shapes + base, sizeof(int32_t) * snap_n);
      const int post_snap = arena->post_count;
      const int time_snap = arena->time_count;
      const uint8_t* fdata = blob + frame_offsets[f_lo + t];
      int64_t flen = frame_offsets[f_lo + t + 1] - frame_offsets[f_lo + t];
      BitReader br(fdata, flen);
      bool ok = true;
      if (cfg.profile < 17 && br.nbits >= 12 && br.peek_padded(12) == 0xFFF) {
        // interleaved ADTS header (non-ER transports only; ER payloads
        // arrive via LATM/raw and may legitimately start with 0xFFF bits)
        bool hok = br.advance(15);
        bool prot_absent = br.read(1, &ok);
        hok = hok && ok && br.advance(40);
        if (hok && !prot_absent) hok = br.advance(16);
        if (!hok) { err = {ERR_BITSTREAM, "adts: eof"}; goto sfail; }
      }
      {
        const int F = cfg.frame_len;
        int slot = base;
        const int slot_end = base + n_slots;
        ElemRef elems[16];
        int n_elems = 0;
        int n_cces = 0;

        auto emit_meta = [&](const Channel& ch, int sl, bool coupling) {
          int32_t* m = meta + (static_cast<size_t>(sl) * T + t) * 6;
          int seq = ch.info.window_sequence;
          int prev = coupling ? 0 : ch.info.prev_window_shape;
          m[0] = seq * 2 + prev;
          m[1] = seq * 2 + ch.info.window_shape;
          m[2] = ch.info.window_shape;
          m[3] = prev;
          m[4] = seq == EIGHT_SHORT ? 1 : 0;
          m[5] = 1;
        };
        auto has_intensity = [&](const Channel& ch) -> bool {
          const int n = ch.info.group_count * ch.info.max_sfb;
          for (int i = 0; i < n; ++i)
            if (ch.band_types[i] == INTENSITY_BT
                || ch.band_types[i] == INTENSITY_BT2)
              return true;
          return false;
        };
        auto emit_pred = [&](const Channel& ch, int sl) -> bool {
          // Main-profile predictor feed: EVERY valid frame of an AOT-1
          // stream carries a mode (the state updates even without
          // prediction_used) — mirrors runtime/pack.py add_channel_frame
          if (cfg.profile != 1) return true;
          if (!pred_meta) {
            err = {ERR_DELEGATE, "main: predictor planes not requested"};
            return false;
          }
          if (has_intensity(ch)) {
            // the spec path host-fuses intensity, but IS must read the
            // POST-prediction left channel (pipeline.apply_is) — the
            // rare Main+IS combination keeps the python packer path
            err = {ERR_DELEGATE, "main profile with intensity stereo"};
            return false;
          }
          int32_t* pm = pred_meta + (static_cast<size_t>(sl) * T + t) * 3;
          if (ch.info.window_sequence == EIGHT_SHORT) {
            pm[0] = 2;  // short frame: reset the whole predictor state
            return true;
          }
          pm[0] = 1;
          pm[1] = ch.info.pred_reset_group;
          const int top = cfg.pred_sfb_max < cfg.swb_long_count
                              ? cfg.pred_sfb_max : cfg.swb_long_count;
          int nbins = cfg.swb_long[top];
          pm[2] = nbins < 672 ? nbins : 672;
          if (ch.info.pred_present && ch.info.pred_used) {
            uint8_t* pu = pred_used_bin
                          + (static_cast<size_t>(sl) * T + t) * 672;
            const int n = ch.info.max_sfb < cfg.pred_sfb_max
                              ? ch.info.max_sfb : cfg.pred_sfb_max;
            for (int sfb = 0; sfb < n; ++sfb) {
              if (!(ch.info.pred_used >> sfb & 1)) continue;
              int lo = cfg.swb_long[sfb];
              int hi = cfg.swb_long[sfb + 1];
              if (hi > 672) hi = 672;
              for (int k = lo; k < hi; ++k) pu[k] = 1;
            }
          }
          return true;
        };
        auto emit_ltp = [&](const Channel& ch, int sl) -> bool {
          if (cfg.profile != 4) return true;
          if (!ltp_meta) {
            err = {ERR_DELEGATE, "ltp: side-info planes not requested"};
            return false;
          }
          if (ch.info.ltp_lag <= 0
              || ch.info.window_sequence == EIGHT_SHORT)
            return true;  // zero row = no prediction (refdec apply_ltp)
          int32_t* lm = ltp_meta + (static_cast<size_t>(sl) * T + t) * 3;
          lm[0] = ch.info.ltp_lag;
          lm[1] = ch.info.ltp_coef;
          uint8_t* lu = ltp_used_sfb
                        + (static_cast<size_t>(sl) * T + t) * 40;
          const int n = ch.info.max_sfb < 40 ? ch.info.max_sfb : 40;
          for (int sfb = 0; sfb < n; ++sfb)
            lu[sfb] = static_cast<uint8_t>(ch.info.ltp_used >> sfb & 1);
          return true;
        };
        auto emit_tns = [&](const Channel& ch, int sl) -> bool {
          if (!ch.tns_present) return true;
          bool any = false;
          int mb = ch.info.window_sequence == EIGHT_SHORT
                       ? cfg.tns_max_short : cfg.tns_max_long;
          size_t tb = (static_cast<size_t>(sl) * T + t);
          if (!resolve_tns(&ch, mb,
                           tns_lpc + tb * 2 * kTnsSlots * kTnsOrder,
                           tns_range + tb * 2 * kTnsSlots * 2, &any)) {
            err = {ERR_BITSTREAM, "tns slots exceeded"};
            return false;
          }
          any_tns |= any;
          return true;
        };
        auto do_sce = [&](int eid) -> bool {
          if (slot >= slot_end) {
            err = {ERR_BOUNDS, "too many channels"};
            return false;
          }
          Channel ch;
          float* row = spec + (static_cast<size_t>(slot) * T + t) * F;
          // a q/sf stream keeps the quantised values for emit_qsf
          ch.attach(&scratch[0], qsf_stream ? nullptr : row);
          const bool decoded =
              decode_ics(&br, cfg, &ch, nullptr, prev_shapes[slot], &err);
          count(ch);
          if (!decoded) return false;
          if (!ch.fused) finalize_spec(ch, row);
          if (qsf_stream)
            qsf_stream = emit_qsf(
                ch, spec_q + (static_cast<size_t>(slot) * T + t) * F,
                spec_sf + (static_cast<size_t>(slot) * T + t) * (F / 4));
          emit_meta(ch, slot, false);
          prev_shapes[slot] = ch.info.window_shape;
          if (!emit_tns(ch, slot)) return false;
          if (!emit_pred(ch, slot) || !emit_ltp(ch, slot)) return false;
          if (n_elems < 16)
            elems[n_elems++] = ElemRef{false, eid, slot, slot,
                                       ch.tns_present, ch.tns_present};
          slot += 1;
          return true;
        };
        // common_mode: -1 = read the common_window bit (standard/ER
        // syntax); 1 = implied true (ELD CPEs carry no bit)
        auto do_cpe = [&](int eid, int common_mode) -> bool {
          if (slot + 2 > slot_end) {
            err = {ERR_BOUNDS, "too many channels"};
            return false;
          }
          bool ok2 = true;
          bool common_window =
              common_mode == 1 ? true : (br.read(1, &ok2) != 0);
          ICSInfo shared;
          float ms_used[kMaxSections] = {0};
          bool mask_present = false;
          int r_ltp_lag = 0, r_ltp_coef = 0;
          uint64_t r_ltp_used = 0;
          if (common_window) {
            if (cfg.profile == 39) {
              if (!decode_ics_info_eld(&br, cfg, &shared, &err)) return false;
            } else if (!decode_ics_info(&br, cfg, &shared, prev_shapes[slot],
                                        &err)) {
              return false;
            }
            // AAC-LTP: the shared ics_info carries channel 0's ltp_data;
            // the second channel's ltp_data_present bit follows
            // immediately (syntax.py decode_cpe; libavcodec decode_cpe)
            if (shared.pred_present && cfg.profile == 4) {
              if (br.read(1, &ok2)) {
                r_ltp_lag = static_cast<int>(br.read(11, &ok2));
                r_ltp_coef = static_cast<int>(br.read(3, &ok2));
                const int n = shared.max_sfb < 40 ? shared.max_sfb : 40;
                for (int i = 0; i < n; ++i)
                  if (br.read(1, &ok2)) r_ltp_used |= 1ull << i;
              }
            }
            int mask = static_cast<int>(br.read(2, &ok2));
            mask_present = mask != 0;
            if (mask == 1) {
              int nmask = shared.group_count * shared.max_sfb;
              for (int i = 0; i < nmask; ++i)
                ms_used[i] = br.read(1, &ok2) ? 1.0f : 0.0f;
            } else if (mask == 2) {
              for (int i = 0; i < kMaxSections; ++i) ms_used[i] = 1.0f;
            } else if (mask == 3) {
              err = {ERR_BITSTREAM, "Reserved ms mask type: 3"};
              return false;
            }
          }
          if (!ok2) { err = {ERR_BITSTREAM, "cpe: eof"}; return false; }
          Channel left, right;
          float* lrow = spec + (static_cast<size_t>(slot) * T + t) * F;
          float* rrow = spec + (static_cast<size_t>(slot + 1) * T + t) * F;
          left.attach(&scratch[0], qsf_stream ? nullptr : lrow);
          right.attach(&scratch[1], qsf_stream ? nullptr : rrow);
          bool decoded = decode_ics(&br, cfg, &left,
                                    common_window ? &shared : nullptr,
                                    prev_shapes[slot], &err);
          count(left);
          if (!decoded) return false;
          decoded = decode_ics(&br, cfg, &right,
                               common_window ? &shared : nullptr,
                               prev_shapes[slot + 1], &err);
          count(right);
          if (!decoded) return false;
          if (common_window) {
            // the right channel shares the ICSInfo copy but carries ITS
            // OWN ltp_data (parsed above, may be absent)
            right.info.ltp_lag = r_ltp_lag;
            right.info.ltp_coef = r_ltp_coef;
            right.info.ltp_used = r_ltp_used;
          }
          if (!left.fused) finalize_spec(left, lrow);
          if (!right.fused) finalize_spec(right, rrow);
          apply_stereo(left, right, ms_used, mask_present, lrow, rrow);
          if (qsf_stream) {
            // M/S mixes dequantized values (not integers) and intensity
            // is caught per band inside emit_qsf
            if (mask_present) {
              qsf_stream = false;
            } else {
              qsf_stream =
                  emit_qsf(left,
                           spec_q + (static_cast<size_t>(slot) * T + t) * F,
                           spec_sf
                               + (static_cast<size_t>(slot) * T + t) * (F / 4))
                  && emit_qsf(
                      right,
                      spec_q + (static_cast<size_t>(slot + 1) * T + t) * F,
                      spec_sf
                          + (static_cast<size_t>(slot + 1) * T + t) * (F / 4));
            }
          }
          for (int which = 0; which < 2; ++which) {
            Channel* ch = which ? &right : &left;
            int sl = slot + which;
            emit_meta(*ch, sl, false);
            prev_shapes[sl] = ch->info.window_shape;
            if (!emit_tns(*ch, sl)) return false;
            if (!emit_pred(*ch, sl) || !emit_ltp(*ch, sl)) return false;
          }
          if (n_elems < 16)
            elems[n_elems++] = ElemRef{true, eid, slot, slot + 1,
                                       left.tns_present, right.tns_present};
          slot += 2;
          return true;
        };

        if (cfg.profile >= 17) {
          // ER raw_data_block: fixed Table-1.19 element layout with no
          // END element; AOT 17/23 prefix each element with a 4-bit
          // instance tag, ELD carries no tags at all (mirrors
          // aacjax/host/syntax.py decode_er_frame)
          static const uint8_t kErLayouts[8][6] = {
              {0, 0, 0, 0, 0, 0}, {1, 0, 0, 0, 0, 0}, {2, 0, 0, 0, 0, 0},
              {1, 2, 0, 0, 0, 0}, {1, 2, 1, 0, 0, 0}, {1, 2, 2, 0, 0, 0},
              {1, 2, 2, 3, 0, 0}, {1, 2, 2, 2, 3, 0}};
          if (cfg.chan_config < 1 || cfg.chan_config > 7) {
            err = {ERR_UNSUPPORTED, "ER channelConfiguration not supported"};
            goto sfail;
          }
          const bool eld = cfg.profile == 39;
          for (const uint8_t* k = kErLayouts[cfg.chan_config]; *k; ++k) {
            int eid = 0;
            if (!eld) {
              eid = static_cast<int>(br.read(4, &ok));
              if (!ok) { err = {ERR_BITSTREAM, "element: eof"}; goto sfail; }
            }
            bool good = *k == 2 ? do_cpe(eid, eld ? 1 : -1) : do_sce(eid);
            if (!good) goto sfail;
          }
        } else {
          for (;;) {
          int etype = static_cast<int>(br.read(3, &ok));
          if (!ok) { err = {ERR_BITSTREAM, "element: eof"}; goto sfail; }
          if (etype == END_ELEM) break;
          int eid = static_cast<int>(br.read(4, &ok));
          if (etype == SCE_ELEM || etype == LFE_ELEM) {
            if (!do_sce(eid)) goto sfail;
          } else if (etype == CPE_ELEM) {
            if (!do_cpe(eid, -1)) goto sfail;
          } else if (etype == CCE_ELEM) {
            if (cfg.profile == 1 || cfg.profile == 4) {
              // BEFORE_TNS coupling is host-fused into the spectra here,
              // but prediction must run first (it is a device/host stage
              // downstream) — predictive profiles + CCE keep the python
              // parser path
              err = {ERR_DELEGATE, "coupling in a predictive profile"};
              goto sfail;
            }
            if (n_cces >= kMaxCce) {
              err = {ERR_FALLBACK, "cce: too many coupling elements"};
              goto sfail;
            }
            CCE* cc = &cce_store[n_cces];
            const bool decoded = decode_cce(&br, cfg, cc, &scratch[0], &err);
            count(cc->ch);
            if (!decoded) goto sfail;
            qsf_stream = false;  // coupling writes fused f32 spectra
            finalize_spec(cc->ch, cc->spec);
            cc->id = eid;
            cc->slot = -1;
            ++n_cces;
          } else if (etype == DSE_ELEM) {
            int align = static_cast<int>(br.read(1, &ok));
            int count = static_cast<int>(br.read(8, &ok));
            if (count == 255) count += static_cast<int>(br.read(8, &ok));
            if (align) br.align();
            if (!br.advance(static_cast<int64_t>(count) * 8)) {
              err = {ERR_BITSTREAM, "dse: eof"}; goto sfail;
            }
          } else if (etype == PCE_ELEM) {
            err = {ERR_UNSUPPORTED, "PCE_ELEMENT not supported"}; goto sfail;
          } else if (etype == FIL_ELEM) {
            int cnt = eid;
            if (cnt == 15) cnt += static_cast<int>(br.read(8, &ok)) - 1;
            if (fil_sbr && cnt > 0 && n_elems > 0
                && (br.peek_padded(4) == 13 || br.peek_padded(4) == 14)) {
              int64_t* rec = fil_sbr + (static_cast<int64_t>(f_lo + t)) * 12;
              for (int k = 0; k < 4; ++k) {
                if (rec[k * 3] == 0) {
                  const ElemRef& pe = elems[n_elems - 1];
                  rec[k * 3 + 0] = br.bitpos();
                  rec[k * 3 + 1] = pe.slot0;
                  rec[k * 3 + 2] = pe.is_pair ? 2 : 1;
                  break;
                }
              }
            }
            if (fil_drc && cnt > 0 && br.peek_padded(4) == 11)
              fil_drc[f_lo + t] = br.bitpos();  // EXT_DYNAMIC_RANGE
            if (!br.advance(static_cast<int64_t>(cnt) * 8)) {
              err = {ERR_BITSTREAM, "fil: eof"}; goto sfail;
            }
          } else {
            err = {ERR_BITSTREAM, "Unknown element"}; goto sfail;
          }
          if (!ok) { err = {ERR_BITSTREAM, "element: eof"}; goto sfail; }
          }
        }

        // apply coupling (element order reproduced from the python packer:
        // coupling channels take slots after the frame's regular channels)
        for (int ci = 0; ci < n_cces; ++ci) {
          CCE* cc = &cce_store[ci];
          if (slot < slot_end) {
            // give the coupling channel a slot like the python packer so
            // both paths keep identical device state (its IMDCT output is
            // the source of time-domain coupling; otherwise discarded)
            cc->slot = slot++;
            float* row =
                spec + (static_cast<size_t>(cc->slot) * T + t) * F;
            memcpy(row, cc->spec, sizeof(float) * F);
            emit_meta(cc->ch, cc->slot, true);
          }
          int dsts[32], gidx[32];
          bool dtns[32];
          int nt = resolve_cce_targets(*cc, elems, n_elems, dsts, gidx, dtns);
          if (cc->coupling_point == AFTER_IMDCT) {
            if (cc->slot < 0) {
              err = {ERR_FALLBACK, "cce: no slot for independent coupling"};
              goto sfail;
            }
            for (int k = 0; k < nt; ++k) {
              if (arena->time_count >= arena->time_cap) {
                err = {ERR_FALLBACK, "cce: time entries overflow"};
                goto sfail;
              }
              int q = arena->time_count++;
              arena->time_idx[q * 3 + 0] = cc->slot;
              arena->time_idx[q * 3 + 1] = dsts[k];
              arena->time_idx[q * 3 + 2] = t;
              arena->time_gain[q] = cc->gain[gidx[k]][0];
            }
          } else {
            // AFTER_TNS onto a target that actually has TNS this frame
            // must run on device (after the device TNS pass); everywhere
            // else TNS is identity and the FMA fuses on host for free
            bool need_device = false;
            if (cc->coupling_point == AFTER_TNS)
              for (int k = 0; k < nt; ++k) need_device |= dtns[k];
            if (!need_device) {
              float gbin[kFrameLen];
              for (int k = 0; k < nt; ++k) {
                expand_gain(cc->ch.info, cc->gain[gidx[k]], gbin);
                float* dst =
                    spec + (static_cast<size_t>(dsts[k]) * T + t) * F;
                for (int i = 0; i < F; ++i)
                  dst[i] += gbin[i] * cc->spec[i];
              }
            } else {
              if (cc->slot < 0) {
                err = {ERR_FALLBACK, "cce: no slot for post-TNS coupling"};
                goto sfail;
              }
              for (int k = 0; k < nt; ++k) {
                if (arena->post_count >= arena->post_cap) {
                  err = {ERR_FALLBACK, "cce: post entries overflow"};
                  goto sfail;
                }
                int q = arena->post_count++;
                arena->post_idx[q * 3 + 0] = cc->slot;
                arena->post_idx[q * 3 + 1] = dsts[k];
                arena->post_idx[q * 3 + 2] = t;
                expand_gain(cc->ch.info, cc->gain[gidx[k]],
                            arena->post_gain + static_cast<size_t>(q) * F);
              }
            }
          }
        }
      }
      if (consumed_bits)  // align to the byte boundary like the python
        consumed_bits[f_lo + t] = (br.bitpos() + 7) & ~int64_t{7};
      continue;
    sfail:
      // roll back every partial side effect of the corrupt frame
      memcpy(prev_shapes + base, shape_snap, sizeof(int32_t) * snap_n);
      arena->post_count = post_snap;
      arena->time_count = time_snap;
      if (fil_sbr)
        memset(fil_sbr + (static_cast<int64_t>(f_lo + t)) * 12, 0,
               sizeof(int64_t) * 12);
      if (fil_drc) fil_drc[f_lo + t] = 0;
      for (int sl = base; sl < base + n_slots; ++sl) {
        memset(spec + (static_cast<size_t>(sl) * T + t) * cfg.frame_len, 0,
               sizeof(float) * cfg.frame_len);
        if (want_qsf) {
          memset(spec_q + (static_cast<size_t>(sl) * T + t) * cfg.frame_len,
                 0, sizeof(int16_t) * cfg.frame_len);
          memset(spec_sf
                     + (static_cast<size_t>(sl) * T + t) * (cfg.frame_len / 4),
                 0, static_cast<size_t>(cfg.frame_len) / 4);
        }
        memset(meta + (static_cast<size_t>(sl) * T + t) * 6, 0,
               sizeof(int32_t) * 6);
        memset(tns_lpc + (static_cast<size_t>(sl) * T + t)
                             * 2 * kTnsSlots * kTnsOrder,
               0, sizeof(float) * 2 * kTnsSlots * kTnsOrder);
        memset(tns_range + (static_cast<size_t>(sl) * T + t) * 2 * kTnsSlots * 2,
               0, sizeof(int32_t) * 2 * kTnsSlots * 2);
        if (pred_meta) {
          memset(pred_meta + (static_cast<size_t>(sl) * T + t) * 3, 0,
                 sizeof(int32_t) * 3);
          memset(pred_used_bin + (static_cast<size_t>(sl) * T + t) * 672,
                 0, 672);
        }
        if (ltp_meta) {
          memset(ltp_meta + (static_cast<size_t>(sl) * T + t) * 3, 0,
                 sizeof(int32_t) * 3);
          memset(ltp_used_sfb + (static_cast<size_t>(sl) * T + t) * 40,
                 0, 40);
        }
      }
      if (err.code == ERR_FALLBACK || err.code == ERR_DELEGATE) {
        stream_status[s] = err.code;
        snprintf(ebuf, eblen, "stream %d frame %d: %s", s, t, err.msg);
        break;
      }
      if (first_err == OK) {
        first_err = err.code;
        snprintf(ebuf, eblen, "stream %d frame %d: %s", s, t, err.msg);
      }
      // conceal: silent-but-present frame keeps the overlap-add chain
      // intact (zero spectrum; previous tail plays out; zero carry), then
      // keep decoding the stream's remaining frames
      for (int sl = base; sl < base + n_slots; ++sl)
        meta[(static_cast<size_t>(sl) * T + t) * 6 + 5] = 1;
    }
    if (stream_status[s] == OK && first_err != OK) stream_status[s] = first_err;
    if (qsf_ok) qsf_ok[s] = qsf_stream ? 1 : 0;
    *any_tns_out = *any_tns_out || any_tns;
  };

  // the stream's rows to block-scaled int16 while they are in the parsing
  // thread's cache
  auto compact_stream = [&](int s) {
    if (!spec_i16 || !spec_scale) return;
    const int64_t r0 = static_cast<int64_t>(base_slot_arr[s]) * T;
    const int64_t r1 = r0 + static_cast<int64_t>(n_slots_arr[s]) * T;
    const int n_blocks = frame_len / kI16Block;
    for (int64_t r = r0; r < r1; ++r)
      spec_row_to_i16(spec + r * frame_len, frame_len,
                      spec_i16 + r * frame_len, spec_scale + r * n_blocks);
  };

  int nthreads = 1;
  if (const char* env = getenv("AACJAX_PARSE_THREADS")) {
    nthreads = atoi(env);  // explicit: no auto heuristics (testing, tuning)
  } else {
    unsigned hw = std::thread::hardware_concurrency();
    nthreads = hw ? static_cast<int>(hw) : 1;
    if (nthreads > n_streams / 4) nthreads = n_streams / 4;  // amortize spawn
  }
  if (nthreads > 16) nthreads = 16;
  if (nthreads > n_streams) nthreads = n_streams;
  if (nthreads < 1) nthreads = 1;

  bool any_tns = false;
  std::vector<int64_t> counts(static_cast<size_t>(nthreads) * 3, 0);
  if (nthreads == 1) {
    CceArena arena{cce_post_idx, cce_post_gain, post_cap, 0,
                   cce_time_idx,  cce_time_gain, time_cap, 0};
    for (int s = 0; s < n_streams; ++s) {
      parse_stream(s, &arena, &any_tns, errbuf, errbuf_len, counts.data());
      compact_stream(s);
    }
    cce_counts[0] = arena.post_count;
    cce_counts[1] = arena.time_count;
  } else {
    std::vector<CceArena> arenas(nthreads);
    std::vector<char> ebufs(static_cast<size_t>(nthreads) * 256, 0);
    std::vector<uint8_t> tns_flags(nthreads, 0);
    for (int k = 0; k < nthreads; ++k) {
      const int64_t p_lo = static_cast<int64_t>(post_cap) * k / nthreads;
      const int64_t p_hi = static_cast<int64_t>(post_cap) * (k + 1) / nthreads;
      const int64_t t_lo = static_cast<int64_t>(time_cap) * k / nthreads;
      const int64_t t_hi = static_cast<int64_t>(time_cap) * (k + 1) / nthreads;
      arenas[k] = CceArena{
          cce_post_idx + 3 * p_lo,
          cce_post_gain + static_cast<int64_t>(frame_len) * p_lo,
          static_cast<int>(p_hi - p_lo), 0,
          cce_time_idx + 3 * t_lo,
          cce_time_gain + t_lo,
          static_cast<int>(t_hi - t_lo), 0};
    }
    std::vector<std::thread> workers;
    workers.reserve(nthreads);
    for (int k = 0; k < nthreads; ++k) {
      const int lo = static_cast<int>(
          static_cast<int64_t>(n_streams) * k / nthreads);
      const int hi = static_cast<int>(
          static_cast<int64_t>(n_streams) * (k + 1) / nthreads);
      workers.emplace_back([&, k, lo, hi]() {
        bool tns = false;
        int64_t own[3] = {0, 0, 0};
        for (int s = lo; s < hi; ++s) {
          parse_stream(s, &arenas[k], &tns, ebufs.data() + k * 256, 256, own);
          compact_stream(s);
        }
        for (int i = 0; i < 3; ++i) counts[static_cast<size_t>(k) * 3 + i] = own[i];
        tns_flags[k] = tns ? 1 : 0;
      });
    }
    for (auto& th : workers) th.join();
    // compact per-thread CCE arenas into a contiguous prefix (dest is
    // always at or left of src, and rows never overlap within a move)
    int np = 0, nt = 0;
    for (int k = 0; k < nthreads; ++k) {
      const CceArena& a = arenas[k];
      if (a.post_count && a.post_idx != cce_post_idx + 3 * np) {
        memmove(cce_post_idx + 3 * np, a.post_idx,
                sizeof(int32_t) * 3 * a.post_count);
        memmove(cce_post_gain + static_cast<size_t>(frame_len) * np,
                a.post_gain, sizeof(float) * frame_len * a.post_count);
      }
      np += a.post_count;
      if (a.time_count && a.time_idx != cce_time_idx + 3 * nt) {
        memmove(cce_time_idx + 3 * nt, a.time_idx,
                sizeof(int32_t) * 3 * a.time_count);
        memmove(cce_time_gain + nt, a.time_gain,
                sizeof(float) * a.time_count);
      }
      nt += a.time_count;
      any_tns = any_tns || tns_flags[k];
      if (ebufs[static_cast<size_t>(k) * 256] && errbuf_len > 0 && !errbuf[0])
        snprintf(errbuf, errbuf_len, "%s",
                 ebufs.data() + static_cast<size_t>(k) * 256);
    }
    cce_counts[0] = np;
    cce_counts[1] = nt;
  }
  has_tns_out[0] = any_tns ? 1 : 0;
  if (parse_counts) {
    for (int i = 0; i < 3; ++i) parse_counts[i] = 0;
    for (int k = 0; k < nthreads; ++k)
      for (int i = 0; i < 3; ++i)
        parse_counts[i] += counts[static_cast<size_t>(k) * 3 + i];
  }
  return OK;
}

void aacjax_spec_to_i16(const float* spec, int64_t n_rows, int n_cols,
                        int16_t* out, float* scales) {
  const int n_blocks = n_cols / kI16Block;
  for (int64_t r = 0; r < n_rows; ++r)
    spec_row_to_i16(spec + r * n_cols, n_cols, out + r * n_cols,
                    scales + r * n_blocks);
}

int aacparse_version() { return 11; }

}  // extern "C"
