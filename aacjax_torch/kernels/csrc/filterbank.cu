// Synthesis filterbank and fused decode tail for AAC-LC frames of 1024 bins.
//
// Replaces two Pallas TPU kernels with one source and two entry points:
//   aacjax_tail  <- aacjax/kernels/pallas_tail.py  decode_tail (_make_kernel)
//   aacjax_synth <- aacjax/kernels/pallas_synth.py synthesis (_synthesis_kernel)
//
// What it computes, per channel-frame row: the long IMDCT as a row of
// spec[., 1024] @ M_long[1024, 2048]; window selection by row lookup in the
// F/S tables (f_idx, s_idx); for EIGHT_SHORT rows the eight 128-bin short
// IMDCTs, their windows and the intra-frame overlap-add.  The tail entry
// then forms pcm[t] = first[t] + second[t-1] (frame 0 reads the incoming
// overlap), conceals invalid frames, packs to int16 (round half to even,
// clip) or scales by 1/32768, and carries second[last_valid] as the new
// overlap.  The synth entry writes (first, second) and stops there.
//
// What bounds it on the H100: the long IMDCT is 4.2 MFLOP per row, i.e.
// 70 GFLOP for a 1024-channel x 16-frame chunk, against 4 (int16 in) or
// 8 (f32 in) bytes of spectrum and 2 bytes of PCM per output sample: the
// kernel is bound by FP32 FFMA throughput (67 TFLOP/s peak without tensor
// cores), not by HBM.
//
// Design: a shared-memory tiled SGEMM with the whole tail fused into its
// epilogue, so each spectrum is read from HBM once and each PCM sample
// written once.  Each thread keeps an 8-row x (4 + 4)-column tile of
// accumulators in registers and reads its operands from shared memory as
// float4, so shared-memory bandwidth stays below the FFMA rate; the next K
// tile is fetched into registers while the current one is multiplied
// (double-buffered shared memory, one barrier per tile).  Whether a chunk
// has EIGHT_SHORT frames is a template parameter: without the short path
// the kernel fits 128 registers, so two blocks share an SM and hide each
// other's latency (on an H100, 2.6 -> 2.1 ms for a 1024 x 16 chunk); with
// it, one block per SM keeps the short path out of spills.  Blocks run in no
// order on Hopper, so a block owns ALL T frames of its channels (BM rows =
// BM/T channels) for a slice of 64 output columns j; it computes IMDCT
// columns j (first half) and 1024 + j (second half), which is everything the
// cross-frame shift, the concealment and the carry need, without leaving
// the block.  The short path is evaluated only for EIGHT_SHORT rows and only
// for the 128-bin sub-blocks that overlap a column (segment algebra of
// pallas_tail.py:97-113).  Window selection is a gather: the one-hot matmuls
// of the TPU kernels give the same values.  Products run in FP32 FFMA (no
// TF32), like the reference's Precision.HIGHEST.  wgmma / 3xTF32 and TMA
// pipelining are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 1024;       // frame length
constexpr int S = 128;        // short window length
constexpr int MID = 448;      // (F - S) / 2: zeros around the short windows
constexpr int BN = 64;        // output columns per block (each half)
constexpr int KT = 16;        // depth of one K tile: one 16-bin int16 scale block
constexpr int TM = 8;         // rows per thread
constexpr int TN = 4;         // columns per thread (each half)
constexpr int TX = BN / TN;   // threads across the columns
constexpr int BM_TAIL = 128;  // rows per block of the tail (T <= 64)
constexpr int BM_SYNTH = 64;  // rows per block of the synth entry (small B)

enum Mode { kPcmI16 = 0, kPcmF32 = 1, kHalves = 2 };

struct Params {
  const void* spec;
  const float* scale;  // [rows, 64] per-16-bin scales (int16 input only)
  const int* f_idx;
  const int* s_idx;
  const int* shape_idx;
  const int* prev_idx;
  const int* is_short;
  const int* valid;       // tail only
  const int* last_valid;  // tail only, [C]
  const float* ov_in;     // tail only, [C, F]
  const float* m_long;    // [F, 2F]
  const float* m_short;   // [S, 2S]
  const float* f_tab;     // [8, F]
  const float* s_tab;     // [8, F]
  const float* rise;      // [2, S]
  const float* fall;      // [2, S]
  void* out0;             // tail: pcm [C, T, F]; synth: first [B, F]
  float* out1;            // tail: new overlap [C, F]; synth: second [B, F]
  int C;                  // channels (synth: rows)
  int T;                  // frames per channel (synth: 1)
  int cpb;                // channels per block = BM / T
};

template <bool kI16>
__device__ __forceinline__ float spec_at(const Params& p, long row, int k) {
  if (kI16) {
    const int16_t* q = static_cast<const int16_t*>(p.spec);
    return static_cast<float>(q[row * F + k]) * p.scale[row * (F / 16) + (k >> 4)];
  }
  return static_cast<const float*>(p.spec)[row * F + k];
}

// Four consecutive bins k..k+3 of a row (k a multiple of 4), decompressed.
template <bool kI16>
__device__ __forceinline__ float4 spec4_at(const Params& p, long row, int k) {
  if (kI16) {
    const short4 q = *reinterpret_cast<const short4*>(
        static_cast<const int16_t*>(p.spec) + row * F + k);
    const float sc = p.scale[row * (F / 16) + (k >> 4)];
    return make_float4(static_cast<float>(q.x) * sc, static_cast<float>(q.y) * sc,
                       static_cast<float>(q.z) * sc, static_cast<float>(q.w) * sc);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(p.spec) + row * F + k);
}

// One short-IMDCT output: sub-block `blk` of row `row`, column `col` of
// M_short (0..255).
template <bool kI16>
__device__ float short_dot(const Params& p, long row, int blk, int col) {
  float acc = 0.f;
  for (int k = 0; k < S; ++k)
    acc += spec_at<kI16>(p, row, blk * S + k) * p.m_short[k * 2 * S + col];
  return acc;
}

// Sample `pos` (0..2F-1) of the windowed, overlap-added EIGHT_SHORT frame:
// sub-window w covers [MID + S*w, MID + S*w + 2S), so segment s of S
// samples is rising-half[s] + falling-half[s-1].
template <bool kI16>
__device__ float short_sample(const Params& p, long row, int pos) {
  const int q = pos - MID;
  if (q < 0 || q >= 9 * S) return 0.f;
  const int seg = q / S, o = q % S;
  const int shape = p.shape_idx[row];
  float a = 0.f, b = 0.f;
  if (seg <= 7) {
    const int rshape = seg == 0 ? p.prev_idx[row] : shape;
    a = short_dot<kI16>(p, row, seg, o) * p.rise[rshape * S + o];
  }
  if (seg >= 1) b = short_dot<kI16>(p, row, seg - 1, S + o) * p.fall[shape * S + o];
  if (seg == 0) return a;
  if (seg == 8) return b;
  return a + b;
}

__device__ __forceinline__ float f4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <bool kI16, int kMode, bool kShort, int BM>
__global__ void __launch_bounds__((BM / TM) * TX, kShort ? 1 : 2)
    filterbank_kernel(Params p) {
  constexpr int NT = (BM / TM) * TX;            // threads
  constexpr int A_LD = BM * KT / 4 / NT;        // 4-bin loads of A per thread
  constexpr int B_LD = KT * 2 * BN / 4 / NT;    // float4 loads of B per thread
  static_assert(A_LD * NT * 4 == BM * KT && B_LD * NT * 4 == KT * 2 * BN, "tiling");
  __shared__ __align__(16) float As[2][KT][BM];      // spectra, K-major
  __shared__ __align__(16) float Bs[2][KT][2 * BN];  // M_long: j.. | F + j..
  __shared__ __align__(16) float Last[BM / TM][BN];  // second half of each
                                                     // thread's last row

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int j0 = blockIdx.x * BN;
  const int ch0 = blockIdx.y * p.cpb;
  const int nch = min(p.cpb, p.C - ch0);
  const int nrows = nch * p.T;
  const long row0 = static_cast<long>(ch0) * p.T;

  float4 ra[A_LD], rb[B_LD];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < A_LD; ++q) {
      const int e = tid + q * NT, r = e % BM, kq = e / BM;
      ra[q] = r < nrows ? spec4_at<kI16>(p, row0 + r, k0 + 4 * kq)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < B_LD; ++q) {
      const int e = tid + q * NT, kk = e / (2 * BN / 4), c = 4 * (e % (2 * BN / 4));
      const int col = c < BN ? j0 + c : F + j0 + (c - BN);
      rb[q] = *reinterpret_cast<const float4*>(p.m_long + static_cast<long>(k0 + kk) * 2 * F + col);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < A_LD; ++q) {
      const int e = tid + q * NT, r = e % BM, kq = e / BM;
      As[buf][4 * kq + 0][r] = ra[q].x;
      As[buf][4 * kq + 1][r] = ra[q].y;
      As[buf][4 * kq + 2][r] = ra[q].z;
      As[buf][4 * kq + 3][r] = ra[q].w;
    }
#pragma unroll
    for (int q = 0; q < B_LD; ++q) {
      const int e = tid + q * NT, kk = e / (2 * BN / 4), c = 4 * (e % (2 * BN / 4));
      *reinterpret_cast<float4*>(&Bs[buf][kk][c]) = rb[q];
    }
  };

  float acc_f[TM][TN] = {}, acc_s[TM][TN] = {};
  fetch(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < F / KT; ++t) {
    const int buf = t & 1;
    if (t + 1 < F / KT) fetch((t + 1) * KT);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * TM + 4]);
      const float4 bf = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * TN]);
      const float4 bs = *reinterpret_cast<const float4*>(&Bs[buf][kk][BN + tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u) {
          acc_f[i][u] += a[i] * f4(bf, u);
          acc_s[i][u] += a[i] * f4(bs, u);
        }
    }
    // buffer buf ^ 1 was last read before the previous barrier
    if (t + 1 < F / KT) stash(buf ^ 1);
    __syncthreads();
  }

  // windows (or the short path): first/second halves of each owned sample
  const int jt = j0 + tx * TN;  // this thread's first column
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= nrows) continue;
    const long g = row0 + r;
    const int fi = p.f_idx[g], si = p.s_idx[g];
    const bool short_row = kShort && p.is_short[g] != 0;
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      if (short_row) {
        acc_f[i][u] = short_sample<kI16>(p, g, jt + u);
        acc_s[i][u] = short_sample<kI16>(p, g, F + jt + u);
      } else {
        acc_f[i][u] *= p.f_tab[fi * F + jt + u];
        acc_s[i][u] *= p.s_tab[si * F + jt + u];
      }
    }
    if (kMode == kHalves) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out0) + g * F + jt) =
          make_float4(acc_f[i][0], acc_f[i][1], acc_f[i][2], acc_f[i][3]);
      *reinterpret_cast<float4*>(p.out1 + g * F + jt) =
          make_float4(acc_s[i][0], acc_s[i][1], acc_s[i][2], acc_s[i][3]);
    }
  }
  if (kMode == kHalves) return;
#pragma unroll
  for (int u = 0; u < TN; ++u) Last[ty][tx * TN + u] = acc_s[TM - 1][u];
  __syncthreads();

  // cross-frame overlap-add, concealment, pack and carry
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= nrows) continue;
    const long g = row0 + r;
    const int t = r % p.T, c = ch0 + r / p.T;
    const int lv = p.last_valid[c];
    const float keep = p.valid[g] != 0 ? 1.f : 0.f;
    const float* ov = p.ov_in + static_cast<long>(c) * F + jt;
    float pcm[TN];
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      // second[t - 1]: this thread's previous row, the previous thread
      // row's last row (i == 0, t > 0 implies ty > 0), or the overlap in
      const float prev = t == 0 ? ov[u] : i == 0 ? Last[ty - 1][tx * TN + u] : acc_s[i - 1][u];
      pcm[u] = (acc_f[i][u] + prev) * keep;
    }
    if (kMode == kPcmI16) {
      short4 v;
      v.x = static_cast<int16_t>(fminf(fmaxf(rintf(pcm[0]), -32768.f), 32767.f));
      v.y = static_cast<int16_t>(fminf(fmaxf(rintf(pcm[1]), -32768.f), 32767.f));
      v.z = static_cast<int16_t>(fminf(fmaxf(rintf(pcm[2]), -32768.f), 32767.f));
      v.w = static_cast<int16_t>(fminf(fmaxf(rintf(pcm[3]), -32768.f), 32767.f));
      *reinterpret_cast<short4*>(static_cast<int16_t*>(p.out0) + g * F + jt) = v;
    } else {
      const float sc = 1.0f / 32768.0f;
      *reinterpret_cast<float4*>(static_cast<float*>(p.out0) + g * F + jt) =
          make_float4(pcm[0] * sc, pcm[1] * sc, pcm[2] * sc, pcm[3] * sc);
    }
    // channel c's new overlap: second[last_valid]; a channel with no
    // frames (last_valid < 0) keeps its incoming overlap
    float4* carry = reinterpret_cast<float4*>(p.out1 + static_cast<long>(c) * F + jt);
    if (t == lv) *carry = make_float4(acc_s[i][0], acc_s[i][1], acc_s[i][2], acc_s[i][3]);
    else if (lv < 0 && t == 0) *carry = *reinterpret_cast<const float4*>(ov);
  }
}

template <bool kI16, int kMode, bool kShort, int BM>
void launch(Params p, cudaStream_t stream) {
  p.cpb = BM / p.T;
  const dim3 grid(F / BN, (p.C + p.cpb - 1) / p.cpb);
  filterbank_kernel<kI16, kMode, kShort, BM><<<grid, (BM / TM) * TX, 0, stream>>>(p);
}

template <bool kI16, int kMode>
void launch_tail(const Params& p, int has_short, cudaStream_t stream) {
  if (has_short) launch<kI16, kMode, true, BM_TAIL>(p, stream);
  else launch<kI16, kMode, false, BM_TAIL>(p, stream);
}

}  // namespace

extern "C" int aacjax_tail(const void* spec, const void* scale, int spec_i16,
                           const void* f_idx, const void* s_idx,
                           const void* shape_idx, const void* prev_idx,
                           const void* is_short, const void* valid,
                           const void* last_valid, const void* ov_in,
                           const void* m_long, const void* m_short,
                           const void* f_tab, const void* s_tab,
                           const void* rise, const void* fall, void* pcm,
                           void* ov_out, int out_i16, int has_short, int C,
                           int T, void* stream) {
  if (T < 1 || T > BM_TAIL / 2 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{spec, static_cast<const float*>(scale),
           static_cast<const int*>(f_idx), static_cast<const int*>(s_idx),
           static_cast<const int*>(shape_idx), static_cast<const int*>(prev_idx),
           static_cast<const int*>(is_short), static_cast<const int*>(valid),
           static_cast<const int*>(last_valid), static_cast<const float*>(ov_in),
           static_cast<const float*>(m_long), static_cast<const float*>(m_short),
           static_cast<const float*>(f_tab), static_cast<const float*>(s_tab),
           static_cast<const float*>(rise), static_cast<const float*>(fall),
           pcm, static_cast<float*>(ov_out), C, T, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (spec_i16) {
    if (out_i16) launch_tail<true, kPcmI16>(p, has_short, s);
    else launch_tail<true, kPcmF32>(p, has_short, s);
  } else {
    if (out_i16) launch_tail<false, kPcmI16>(p, has_short, s);
    else launch_tail<false, kPcmF32>(p, has_short, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aacjax_synth(const void* spec, const void* f_idx,
                            const void* s_idx, const void* shape_idx,
                            const void* prev_idx, const void* is_short,
                            const void* m_long, const void* m_short,
                            const void* f_tab, const void* s_tab,
                            const void* rise, const void* fall, void* first,
                            void* second, int B, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{spec, nullptr,
           static_cast<const int*>(f_idx), static_cast<const int*>(s_idx),
           static_cast<const int*>(shape_idx), static_cast<const int*>(prev_idx),
           static_cast<const int*>(is_short), nullptr, nullptr, nullptr,
           static_cast<const float*>(m_long), static_cast<const float*>(m_short),
           static_cast<const float*>(f_tab), static_cast<const float*>(s_tab),
           static_cast<const float*>(rise), static_cast<const float*>(fall),
           first, static_cast<float*>(second), B, 1, 0};
  launch<false, kHalves, true, BM_SYNTH>(p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
