// The batched encoder's two scans: the psy spread and the rate-cost grid of
// the analysis program.
//
// Replaces the two lax.scans of aacjax/encode_batch.py _analysis_fn (XLA on
// the TPU; there is no Pallas kernel for either):
//
//   aacjax_enc_spread     `spread` (:176-188): per channel-frame (row), a
//       max-recurrence up the nb bands, m = max(e, carry * up), then one down
//       them with `down`, then the product with smr.  One thread a row, the
//       carry in a register.  The rows pass through shared memory, so the
//       loads and stores of [N, nb] are coalesced and a thread walks its own
//       row there (an odd pitch: no bank conflicts).  Each step is one
//       __fmul_rn and one compare-select (the inputs are finite and >= 0),
//       as torch.mul and torch.maximum compute them: bit-equal to spread_ref.
//   aacjax_enc_rate_cost  the grid (`est_at` over the offsets, :364-387): per
//       row and offset o, the scalefactor of each band s = min(max(base + o,
//       fit), 255), the bins quantized at it, a = min(floor(t34 * 2^((100 -
//       s) * 0.1875) + 0.4054), 8191), and the estimate: book 11's pair cost
//       over the pairs whose band is nonzero (s < zero_sf), a sign bit for
//       each a > 0, 2 floor(log2 a) - 3 escape bits for each a >= 16 and 6
//       side bits a nonzero band.  One warp a row: the row's t34 is staged
//       in shared memory once and read for all K offsets; per offset the
//       lanes first make the band table (s, its power of two, nonzero), then
//       walk the bin pairs, and one shuffle reduction sums the row.
//
// Roundings: every summed term is a small integer, so the integer sums equal
// the plain version's f32 sums (exact below 2^24).  The power of two comes
// from a 256-entry table torch.exp2 made on the same device (s is an integer
// in [0, 255]), t34 * E and + 0.4054 are __fmul_rn / __fadd_rn (never
// contracted into an FMA), floor(log2 a) of the integer a is 31 - clz(a).
// So the kernel's estimate is the plain version's, bit for bit.
//
// What bounds them on the H100: the grid reads t34 once (36 MB at ENC-512's
// [16384, 544]) and does ~12 operations a bin and offset (1.7 G), so its
// bound is the operations' (~0.026 ms at the FP32 peak); the spread moves
// 4.7 MB and is bound by its launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPREAD_ROWS = 128;    // rows a block, one a thread
constexpr int RC_WARPS = 8;         // rows a block, one a warp
constexpr int LUT11 = 17 * 17;      // book 11's pair costs
constexpr int MAX_SLOTS = 64;       // nb bands and the padding band
constexpr int MAX_BINS = 1024;
constexpr int MAX_K = 32;

// torch.maximum and torch.clamp(max=) on finite values
__device__ __forceinline__ float max_of(float a, float b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float min_of(float a, float b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(SPREAD_ROWS)
enc_spread_kernel(const float* __restrict__ e, float* __restrict__ out, int N,
                  int nb, float up, float down, float smr) {
  extern __shared__ float tile[];          // SPREAD_ROWS x pitch
  const int pitch = nb | 1;
  const int row0 = blockIdx.x * SPREAD_ROWS;
  const int count = min(SPREAD_ROWS, N - row0) * nb;
  const size_t first = static_cast<size_t>(row0) * nb;
  for (int i = threadIdx.x; i < count; i += SPREAD_ROWS) {
    const int r = i / nb;
    tile[r * pitch + i - r * nb] = e[first + i];
  }
  __syncthreads();
  if (threadIdx.x * nb < count) {
    float* x = tile + threadIdx.x * pitch;
    float carry = 0.0f;
    for (int k = 0; k < nb; ++k) {
      const float m = max_of(x[k], carry);
      x[k] = m;
      carry = __fmul_rn(m, up);
    }
    carry = 0.0f;
    for (int k = nb - 1; k >= 0; --k) {
      const float m = max_of(x[k], carry);
      x[k] = __fmul_rn(m, smr);
      carry = __fmul_rn(m, down);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += SPREAD_ROWS) {
    const int r = i / nb;
    out[first + i] = tile[r * pitch + i - r * nb];
  }
}

// a bin quantized at the scale 2^((100 - s) * 0.1875), as the plain version
__device__ __forceinline__ float quantized(float t34, float scale) {
  return min_of(floorf(__fadd_rn(__fmul_rn(t34, scale), 0.4054f)), 8191.0f);
}

// sign and escape bits of a quantized magnitude
__device__ __forceinline__ int sign_escape_bits(float a) {
  const int q = static_cast<int>(a);
  return (q > 0) + (q >= 16 ? 2 * (31 - __clz(q)) - 3 : 0);
}

__device__ __forceinline__ int pair_symbol(float a) {
  return static_cast<int>(min_of(a, 16.0f));
}

__global__ void __launch_bounds__(RC_WARPS * 32)
enc_rate_cost_kernel(const float* __restrict__ t34,
                     const bool* __restrict__ is_short,
                     const long long* __restrict__ regions,
                     const float* __restrict__ base,
                     const float* __restrict__ fit,
                     const float* __restrict__ zero,
                     const float* __restrict__ lut,
                     const float* __restrict__ exp2_table,
                     const float* __restrict__ offsets,
                     float* __restrict__ est, int N, int Pe, int nb, int K) {
  __shared__ int lut_s[LUT11];
  __shared__ float exp2_s[256];
  __shared__ float off_s[MAX_K];
  // per warp, the row's bands (slot nb: the padding band) and, per offset,
  // each band's power of two and whether it is nonzero
  __shared__ float band_base[RC_WARPS][MAX_SLOTS];
  __shared__ float band_fit[RC_WARPS][MAX_SLOTS];
  __shared__ float band_zero[RC_WARPS][MAX_SLOTS];
  __shared__ float band_scale[RC_WARPS][MAX_SLOTS];
  __shared__ uint8_t band_nz[RC_WARPS][MAX_SLOTS];
  extern __shared__ float4 dyn[];          // RC_WARPS rows of t34, 2 maps
  float* rows_s = reinterpret_cast<float*>(dyn);
  uint8_t* maps_s = reinterpret_cast<uint8_t*>(rows_s + RC_WARPS * Pe);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < LUT11; i += blockDim.x)
    lut_s[i] = static_cast<int>(lut[i]);
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    exp2_s[i] = exp2_table[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) off_s[i] = offsets[i];
  for (int i = threadIdx.x; i < 2 * Pe; i += blockDim.x)
    maps_s[i] = static_cast<uint8_t>(regions[i]);

  const int row = blockIdx.x * RC_WARPS + warp;
  float* x = rows_s + warp * Pe;
  if (row < N) {
    const float* src = t34 + static_cast<size_t>(row) * Pe;
    for (int i = lane; i < Pe; i += 32) x[i] = src[i];
    const size_t b0 = static_cast<size_t>(row) * nb;
    for (int j = lane; j <= nb; j += 32) {
      band_base[warp][j] = j < nb ? base[b0 + j] : 255.0f;
      band_fit[warp][j] = j < nb ? fit[b0 + j] : 255.0f;
      band_zero[warp][j] = j < nb ? zero[b0 + j] : 0.0f;
    }
  }
  __syncthreads();
  if (row >= N) return;

  const uint8_t* band = maps_s + (is_short[row] ? Pe : 0);
  const float2* pairs = reinterpret_cast<const float2*>(x);
  for (int k = 0; k < K; ++k) {
    int bits = 0;
    for (int j = lane; j <= nb; j += 32) {
      const float s = min_of(
          max_of(__fadd_rn(band_base[warp][j], off_s[k]), band_fit[warp][j]),
          255.0f);
      const bool nz = s < band_zero[warp][j];
      band_scale[warp][j] = exp2_s[min(max(static_cast<int>(s), 0), 255)];
      band_nz[warp][j] = nz;
      bits += (j < nb && nz) ? 6 : 0;     // side info of a nonzero band
    }
    __syncwarp();
    for (int p = lane; p < Pe / 2; p += 32) {
      const int g0 = band[2 * p], g1 = band[2 * p + 1];
      const float2 t = pairs[p];
      const float a0 = quantized(t.x, band_scale[warp][g0]);
      const float a1 = quantized(t.y, band_scale[warp][g1]);
      bits += sign_escape_bits(a0) + sign_escape_bits(a1);
      if (band_nz[warp][g0])
        bits += lut_s[pair_symbol(a0) * 17 + pair_symbol(a1)];
    }
    for (int d = 16; d > 0; d >>= 1)
      bits += __shfl_xor_sync(0xffffffffu, bits, d);
    if (lane == 0) est[static_cast<size_t>(row) * K + k] = static_cast<float>(bits);
    __syncwarp();                           // the next offset rewrites the table
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
  const size_t smem = sizeof(float) * SPREAD_ROWS * (nb | 1);
  enc_spread_kernel<<<(N + SPREAD_ROWS - 1) / SPREAD_ROWS, SPREAD_ROWS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<float*>(out), N, nb, up, down,
      smr);
  return static_cast<int>(cudaGetLastError());
}

// t34 f32 [N][Pe] (Pe even, <= 1024); is_short bool [N]; regions int64
// [2][Pe] (long, short: each bin's band, nb for padding); base, fit, zero f32
// [N][nb], nb <= 63; lut f32 [289]; exp2_table f32 [256]; offsets f32 [K],
// K <= 32; est f32 [N][K].  Returns the CUDA error of the launch, 0 for none.
extern "C" int aacjax_enc_rate_cost(const void* t34, const void* is_short,
                                    const void* regions, const void* base,
                                    const void* fit, const void* zero,
                                    const void* lut, const void* exp2_table,
                                    const void* offsets, void* est, int N,
                                    int Pe, int nb, int K, void* stream) {
  if (N < 0 || Pe < 2 || Pe % 2 || Pe > MAX_BINS || nb < 1 ||
      nb >= MAX_SLOTS || K < 1 || K > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const size_t smem = sizeof(float) * RC_WARPS * Pe + 2 * Pe;
  enc_rate_cost_kernel<<<(N + RC_WARPS - 1) / RC_WARPS, RC_WARPS * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t34), static_cast<const bool*>(is_short),
      static_cast<const long long*>(regions), static_cast<const float*>(base),
      static_cast<const float*>(fit), static_cast<const float*>(zero),
      static_cast<const float*>(lut), static_cast<const float*>(exp2_table),
      static_cast<const float*>(offsets), static_cast<float*>(est), N, Pe, nb,
      K);
  return static_cast<int>(cudaGetLastError());
}
