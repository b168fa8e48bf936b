// The batched encoder's two scans: the psy spread and the rate-cost grid of
// the analysis program.
//
// Replaces the two lax.scans of aacjax/encode_batch.py _analysis_fn (XLA on
// the TPU; there is no Pallas kernel for either):
//
//   aacjax_enc_spread     `spread` (:176-188): per channel-frame (row), a
//       max-recurrence up the nb bands, m = max(e, carry * up), then one down
//       them with `down`, then the product with smr.  One thread a row and
//       one warp a block (32 rows), so ENC-512's 16384 rows make 512 blocks
//       that spread over every SM.  The rows pass through shared memory (an
//       odd pitch: no bank conflicts), so the loads and stores of [N, nb] are
//       coalesced (every load of a lane in flight at once); a thread walks
//       its own row in registers (indices fixed at compile time), so each
//       step of the dependent chain is one maximum (FMNMX) and one
//       __fmul_rn, with no shared-memory round trip between steps.  The
//       recurrence cannot be reassociated without changing roundings: the
//       parallelism is across rows only.  Bit-equal to spread_ref (the
//       inputs are finite and >= +0, where FMNMX and torch.maximum agree).
//   aacjax_enc_rate_cost  the grid (`est_at` over the offsets, :364-387): per
//       row and offset o, the scalefactor of each band s = min(max(base + o,
//       fit), 255), the bins quantized at it, a = min(floor(t34 * 2^((100 -
//       s) * 0.1875) + 0.4054), 8191), and the estimate: book 11's pair cost
//       over the pairs whose band is nonzero (s < zero_sf), a sign bit for
//       each a > 0, 2 floor(log2 a) - 3 escape bits for each a >= 16 and 6
//       side bits a nonzero band.  One warp a row, four rows a block.
//
// The grid's design.  Per bin and offset the arithmetic needs y = t34 * 2^..
// + 0.4054 (__fmul_rn, __fadd_rn: the plain version's roundings) and then
// only which class a = min(floor(y), 8191) falls in.  Three exact identities
// give that class without a conversion or leading-zero instruction (the
// H100 issues those 16 a clock per SM, against 128 for FP32 and 64 for
// integer work):
//   - p = floor(min(y, 16)), the pair symbol min(a, 16): __fadd_rd(min(y,
//     16), 1.5 * 2^23) is 1.5 * 2^23 + p exactly, p in its low mantissa bits;
//   - the exponent field E of min(y, 8191) as an integer (y >= 0.4054, so
//     E >= 125): a > 0 iff E >= 127, a >= 16 iff E >= 131, and then
//     floor(log2 a) = E - 127;
//   - so c = p + E - 125, one integer add of the two bit patterns, is a code
//     in [0, 31) that names a's class uniquely (0, 1: a = 0; 3..20: a = 1..15;
//     22..30: a >= 16, escapes by E).
// A pair's cost is one byte of a 2 x 31 x 31 table (enc_scans.pair_table,
// built once on the host): book 11's pair cost if the even bin's band is
// nonzero, plus both bins' sign and escape bits.  The band's nonzero flag
// rides in the magic constant itself (1.5 * 2^23, or + 31 for a zero band,
// which moves c0 into the table's second half), so the one shared-memory
// load of a band's {scale, magic} carries both.  Per bin and offset that is
// FMUL, FADD, FMNMX, FADD.RD, IMNMX and an add of the shifted exponent
// (LEA.HI); per pair an IMAD and an add for the index, one byte load and
// one add.
//   A lane owns the pairs p = lane + 32 i of its row: their t34 (8-byte
// loads, coalesced, read once a row for up to 16 offsets, one pair ahead)
// and band offsets sit in registers while the lane walks the 16 offsets of
// a pass unrolled.  Where every pair of a row type lies in one band (the
// encoder's layouts: band edges are multiples of 4), one {scale, magic}
// load serves both bins; the block checks its maps once.  The band table
// of a row, all 16 offsets x (nb + 1) bands, is built in one pass and one
// warp sync: lane j loads band j's base, fit and zero once and writes its
// 16 entries, adding 6 side bits to its partial sum of each offset at which
// the band is nonzero.  Its pitch of 17 entries a band keeps neighbouring
// bands on different banks.  The 16 partial sums leave in one butterfly
// reduce-scatter (15 shuffles halving the values, one more to finish),
// after which lanes 2k hold offset k's sum and store the row's est[16] in
// one 64-byte store.  K > 16 takes a second pass.
//
// Roundings: every summed term is a small integer, so the integer sums equal
// the plain version's f32 sums (exact below 2^24).  The power of two comes
// from a 256-entry table torch.exp2 made on the same device (s is an integer
// in [0, 255]); the table's index and the final float are exact magic adds
// too.  So the kernel's estimate is the plain version's, bit for bit.
//
// What bounds them on the H100.  The grid reads t34 once (36 MB at
// ENC-512's [16384, 544]) and does ~12 operations a bin and offset (1.7 G),
// so its bound is the operations' (~0.026 ms at the FP32 peak).  This design
// issues ~18 instructions a pair and offset (~284 for a pair's 16 offsets),
// about half of them on the integer pipe, and none of the first kernel's
// conversions or leading-zero counts.  scripts/enc_grid_variants.py times
// variants and ablations: what surrounds the pass over the pairs (the
// blocks' set-up, the band tables, the reduction) is about 30% of the time,
// the pair table's byte load 5%, the band loads nothing measurable; one
// band load for both bins of a pair and t34 a pair ahead save 3% and 6%.
// The rest is the pass's instruction stream.  The spread moves 4.7 MB; its
// time is a DRAM round trip, the 2 nb-step chain and the stores, one after
// the other in every block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPREAD_ROWS = 32;     // rows a block, one a thread
constexpr int RC_WARPS = 4;         // rows a block, one a warp
constexpr int KG = 16;              // offsets a pass over a row
constexpr int KG_PITCH = KG + 1;    // band table entries a band
constexpr int MAX_SLOTS = 64;       // nb bands and the padding band
constexpr int MAX_BINS = 1024;
constexpr int MAX_K = 32;
constexpr int CODES = 31;           // a bin's class code, see above
constexpr int PAIR_WORDS = (2 * CODES * CODES + 3) / 4;

constexpr float MAGIC = 12582912.0f;                // 1.5 * 2^23
constexpr float MAGIC_ZERO_BAND = 12582943.0f;      // MAGIC + CODES
constexpr uint32_t MAGIC_BITS = 0x4B400000u;
constexpr uint32_t BITS_8191 = 0x45FFF800u;         // 8191.0f
// c0 * CODES + c1 of two bins' raw codes (bits(r) + E) minus this is the
// pair table's index (unsigned arithmetic: mod 2^32)
constexpr uint32_t CODE_BIAS = (MAGIC_BITS + 125u) * (CODES + 1);

__global__ void __launch_bounds__(SPREAD_ROWS)
enc_spread_kernel(const float* __restrict__ e, float* __restrict__ out, int N,
                  int nb, unsigned div_nb, float up, float down, float smr) {
  __shared__ float tile[SPREAD_ROWS * (MAX_SLOTS - 1)];
  const int lane = threadIdx.x;
  const int pitch = nb | 1;
  const int row0 = blockIdx.x * SPREAD_ROWS;
  const int rows = min(SPREAD_ROWS, N - row0);
  const int count = rows * nb;             // <= 32 x 63: 63 elements a lane
  const size_t first = static_cast<size_t>(row0) * nb;
  // every load in flight at once, then into the tile: element i is row
  // i / nb (div_nb = 2^32 / nb rounded up: exact for i < 2^16)
  float v[MAX_SLOTS - 1];
#pragma unroll
  for (int t = 0; t < MAX_SLOTS - 1; ++t) {
    const int i = lane + 32 * t;
    if (i < count) v[t] = e[first + i];
  }
#pragma unroll
  for (int t = 0; t < MAX_SLOTS - 1; ++t) {
    const int i = lane + 32 * t;
    const int r = __umulhi(i, div_nb);
    if (i < count) tile[r * pitch + i - r * nb] = v[t];
  }
  __syncwarp();
  if (lane < rows) {
    float* mine = tile + lane * pitch;
    float x[MAX_SLOTS - 1];             // bands past nb hold 0
#pragma unroll
    for (int k = 0; k < MAX_SLOTS - 1; ++k)
      x[k] = k < nb ? mine[k] : 0.0f;
    // each step one maximum (FMNMX: the values are finite and >= +0) and
    // one product; the chain stops at nb going up ...
    float carry = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_SLOTS - 1; ++k) {
      if (k >= nb) break;
      x[k] = fmaxf(x[k], carry);
      carry = __fmul_rn(x[k], up);
    }
    // ... and runs down from 62 unconditionally, since the zero bands past
    // nb leave the carry at 0 (no predicate to hold the chain back)
    carry = 0.0f;
#pragma unroll
    for (int k = MAX_SLOTS - 2; k >= 0; --k) {
      const float m = fmaxf(x[k], carry);
      x[k] = __fmul_rn(m, smr);
      carry = __fmul_rn(m, down);
    }
#pragma unroll
    for (int k = 0; k < MAX_SLOTS - 1; ++k)
      if (k < nb) mine[k] = x[k];
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < MAX_SLOTS - 1; ++t) {
    const int i = lane + 32 * t;
    const int r = __umulhi(i, div_nb);
    if (i < count) out[first + i] = tile[r * pitch + i - r * nb];
  }
}

// A bin's raw class code at one offset: bits(1.5 * 2^23 + floor(min(y, 16)))
// (+ 31 when `magic` marks a zero band) plus the exponent field of min(y,
// 8191).  t is >= 0, so y >= 0.4054 and its bits order as its values.
__device__ __forceinline__ uint32_t bin_code(float t, float scale,
                                             float magic) {
  const float y = __fadd_rn(__fmul_rn(t, scale), 0.4054f);
  const float r = __fadd_rd(fminf(y, 16.0f), magic);
  return __float_as_uint(r) + (min(__float_as_uint(y), BITS_8191) >> 23);
}

// One pass of a row's pairs over 16 offsets: lane L takes the pairs L, L +
// 32, ..., its t34 loaded a pair ahead; SAME: every pair of the row type
// lies in one band, so the odd bin takes the even bin's scale.
template <bool SAME>
__device__ __forceinline__ void pair_pass(int (&acc)[KG],
                                          const float2* __restrict__ src,
                                          const uint32_t* map,
                                          const float2* tab,
                                          const uint8_t* pairs, int P,
                                          int lane) {
  float2 next = lane < P ? src[lane] : make_float2(0.0f, 0.0f);
  for (int p = lane; p < P; p += 32) {
    const float2 t = next;
    if (p + 32 < P) next = src[p + 32];
    const float t0 = fmaxf(t.x, 0.0f), t1 = fmaxf(t.y, 0.0f);
    const uint32_t m = map[p];
    const float2* e0 = tab + (m & 0xFFFFu);
    const float* e1 = reinterpret_cast<const float*>(tab + (m >> 16));
#pragma unroll
    for (int q = 0; q < KG; ++q) {
      const float2 band = e0[q];
      const uint32_t c0 = bin_code(t0, band.x, band.y);
      const uint32_t c1 = bin_code(t1, SAME ? band.x : e1[2 * q], MAGIC);
      acc[q] += pairs[c0 * CODES + c1 - CODE_BIAS];
    }
  }
}

__global__ void __launch_bounds__(RC_WARPS * 32)
enc_rate_cost_kernel(const float* __restrict__ t34,
                     const bool* __restrict__ is_short,
                     const long long* __restrict__ regions,
                     const float* __restrict__ base,
                     const float* __restrict__ fit,
                     const float* __restrict__ zero,
                     const uint32_t* __restrict__ pair_table,
                     const float* __restrict__ exp2_table,
                     const float* __restrict__ offsets,
                     float* __restrict__ est, int N, int Pe, int nb, int K) {
  __shared__ uint32_t pair_w[PAIR_WORDS];
  __shared__ float exp2_s[256];
  __shared__ float off_s[MAX_K];
  // per warp, the row's band table: (nb + 1) bands x KG_PITCH {scale, magic}
  // (band nb: the padding band); then per row type and pair the two bins'
  // band offsets into it, in entries
  extern __shared__ float2 tables[];
  const int P = Pe / 2;
  uint32_t* maps = reinterpret_cast<uint32_t*>(
      tables + RC_WARPS * (nb + 1) * KG_PITCH);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < PAIR_WORDS; i += blockDim.x)
    pair_w[i] = pair_table[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    exp2_s[i] = exp2_table[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) off_s[i] = offsets[i];
  int split_long = 0, split_short = 0;   // a pair across two bands
  for (int i = threadIdx.x; i < 2 * P; i += blockDim.x) {
    // regions [2][Pe]: entry 2i is row type i / P's pair i % P
    const long long g0 = min(max(regions[2 * i], 0LL), (long long)nb);
    const long long g1 = min(max(regions[2 * i + 1], 0LL), (long long)nb);
    maps[i] = static_cast<uint32_t>(g0 * KG_PITCH) |
              (static_cast<uint32_t>(g1 * KG_PITCH) << 16);
    if (g0 != g1) (i < P ? split_long : split_short) = 1;
  }
  const bool straddle_long = __syncthreads_or(split_long);
  const bool straddle_short = __syncthreads_or(split_short);
  const int row = blockIdx.x * RC_WARPS + warp;
  if (row >= N) return;

  const uint8_t* pairs = reinterpret_cast<const uint8_t*>(pair_w);
  float2* tab = tables + warp * (nb + 1) * KG_PITCH;
  const bool is_s = is_short[row];
  const uint32_t* map = maps + (is_s ? P : 0);
  const bool same = !(is_s ? straddle_short : straddle_long);
  const float2* src = reinterpret_cast<const float2*>(
      t34 + static_cast<size_t>(row) * Pe);
  const size_t b0 = static_cast<size_t>(row) * nb;
  for (int kg = 0; kg < K; kg += KG) {
    __syncwarp();                     // the last pass has read the table
    // lane j: band j's entries for the pass's 16 offsets (offsets past K
    // repeat the last; their sums are not stored), and 6 side bits an
    // offset at which the band is nonzero, into that offset's sum
    int acc[KG];
#pragma unroll
    for (int q = 0; q < KG; ++q) acc[q] = 0;
    for (int j = lane; j <= nb; j += 32) {
      float b = 255.0f, f = 255.0f, z = 0.0f;   // the padding band: zero
      if (j < nb) {
        b = base[b0 + j];
        f = fit[b0 + j];
        z = zero[b0 + j];
      }
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        const float o = off_s[min(kg + q, K - 1)];
        const float s = fminf(fmaxf(__fadd_rn(b, o), f), 255.0f);
        const bool nz = s < z;
        // s is an integer: the magic add puts it in the low mantissa bits
        const int si = min(max(static_cast<int>(__float_as_uint(
                                   __fadd_rn(s, MAGIC)) - MAGIC_BITS), 0),
                           255);
        tab[j * KG_PITCH + q] =
            make_float2(exp2_s[si], nz ? MAGIC : MAGIC_ZERO_BAND);
        acc[q] += nz ? 6 : 0;
      }
    }
    __syncwarp();
    if (same)
      pair_pass<true>(acc, src, map, tab, pairs, P, lane);
    else
      pair_pass<false>(acc, src, map, tab, pairs, P, lane);
    // reduce-scatter: at distance d the lanes with bit d keep the upper
    // half of their sums and send the lower, so after d = 16, 8, 4, 2 lane
    // L holds offset L >> 1's sum over the lanes that share its bits 1-4
#pragma unroll
    for (int w = KG / 2, d = 16; w >= 1; w >>= 1, d >>= 1) {
      const int hi = (lane & d) ? -1 : 0;
#pragma unroll
      for (int j = 0; j < w; ++j) {
        const int send = (acc[j] & hi) | (acc[j + w] & ~hi);
        const int keep = (acc[j + w] & hi) | (acc[j] & ~hi);
        acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, d);
      }
    }
    const int total = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
    const int kk = kg + (lane >> 1);
    if (!(lane & 1) && kk < K)          // 0 <= total < 2^22: exact
      est[static_cast<size_t>(row) * K + kk] =
          __fsub_rn(__uint_as_float(MAGIC_BITS + total), MAGIC);
  }
}

}  // namespace

// e and out f32 [N][nb], nb <= 63.  Returns the CUDA error of the launch, 0
// for none.
extern "C" int aacjax_enc_spread(const void* e, void* out, int N, int nb,
                                 float up, float down, float smr,
                                 void* stream) {
  if (N < 0 || nb < 1 || nb >= MAX_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  enc_spread_kernel<<<(N + SPREAD_ROWS - 1) / SPREAD_ROWS, SPREAD_ROWS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<float*>(out), N, nb,
      0xFFFFFFFFu / nb + 1u, up, down, smr);
  return static_cast<int>(cudaGetLastError());
}

// t34 f32 [N][Pe] (>= 0; Pe even, <= 1024; 8-byte aligned); is_short bool
// [N]; regions int64 [2][Pe] (long, short: each bin's band, nb for padding);
// base, fit, zero f32 [N][nb] holding integers, fit >= 0, nb <= 63;
// pair_table u8 [2][31][31] padded to 4-byte words (enc_scans.pair_table);
// exp2_table f32 [256]; offsets f32 [K], K <= 32; est f32 [N][K].  Returns
// the CUDA error of the launch, 0 for none.
extern "C" int aacjax_enc_rate_cost(const void* t34, const void* is_short,
                                    const void* regions, const void* base,
                                    const void* fit, const void* zero,
                                    const void* pair_table,
                                    const void* exp2_table,
                                    const void* offsets, void* est, int N,
                                    int Pe, int nb, int K, void* stream) {
  if (N < 0 || Pe < 2 || Pe % 2 || Pe > MAX_BINS || nb < 1 ||
      nb >= MAX_SLOTS || K < 1 || K > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const size_t smem = sizeof(float2) * RC_WARPS * (nb + 1) * KG_PITCH +
                      sizeof(uint32_t) * Pe;
  enc_rate_cost_kernel<<<(N + RC_WARPS - 1) / RC_WARPS, RC_WARPS * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t34), static_cast<const bool*>(is_short),
      static_cast<const long long*>(regions), static_cast<const float*>(base),
      static_cast<const float*>(fit), static_cast<const float*>(zero),
      static_cast<const uint32_t*>(pair_table),
      static_cast<const float*>(exp2_table),
      static_cast<const float*>(offsets), static_cast<float*>(est), N, Pe, nb,
      K);
  return static_cast<int>(cudaGetLastError());
}
