// Synthesis filterbank and fused decode tail for AAC-LC frames of 1024 bins.
//
// Replaces two Pallas TPU kernels with one source and two entry points:
//   aacjax_tail  <- aacjax/kernels/pallas_tail.py  decode_tail (_make_kernel)
//   aacjax_synth <- aacjax/kernels/pallas_synth.py synthesis (_synthesis_kernel)
//
// What it computes, per channel-frame row: the long IMDCT (1024 bins ->
// 2048 samples) or, for EIGHT_SHORT rows, the eight 128-bin short IMDCTs
// with their windows and the intra-frame overlap-add; window selection by
// row lookup in the F/S tables (f_idx, s_idx).  The tail entry then forms
// pcm[t] = first[t] + second[t-1] (frame 0 reads the incoming overlap),
// conceals invalid frames, packs to int16 (round half to even, clip) or
// scales by 1/32768, and carries second[last_valid] as the new overlap.
// The synth entry writes (first, second) and stops there.
//
// The IMDCT is the fold of a DCT-IV, and the DCT-IV of N points one
// N/2-point complex FFT between a pre- and a post-twiddle (the
// factorisation, the twiddle table and a numpy model of these passes with
// the same index maps are in kernels/imdct.py): a long frame is one
// 512-point FFT, an EIGHT_SHORT frame eight 64-point FFTs.  About 26 kFLOP
// per frame against the 4.2 MFLOP of the dense product
// spec[., 1024] @ M_long[1024, 2048] that the TPU kernels run on the MXU.
//
// What bounds it on the H100: with the FFT, device memory.  Per frame it
// reads 2 KB of int16 spectrum and 256 B of scales (4 KB of f32 spectrum)
// and writes 2 KB of int16 PCM (4 KB of f32): a 1024-channel x 16-frame
// chunk moves ~80 MB, ~24 us at 3.35 TB/s, against ~7 us of FP32 work.
//
// Design: a unit of 64 threads transforms one frame.  Each thread holds 8
// complex points in registers; 512 = 8^3, so a long frame is three radix-8
// passes (the points are exchanged through shared memory between passes)
// and a short frame loads straight into the second pass's layout and runs
// the last two (eight 64-point FFTs over the same threads).  A thread loads
// the two bins of each of its points (x[2n], x[N-1-2n]); a warp's loads are
// contiguous.  The twiddle table is laid out in the order the threads read
// it.  The post-twiddled DCT-IV values D (1024 floats) land in shared
// memory, and the output stage reads the fold from D: each thread then
// owns 16 output samples as four runs of 4, so the PCM is written once, in
// 8- or 16-byte stores.  The cross-frame overlap-add needs second[t-1],
// and blocks run in no order: a tail block owns 4 consecutive frames (rows
// g0 .. g0+3) and has a fifth, lead unit that transforms frame g0-1 (its
// spectrum mostly from L2, where the block before read it).  After a block
// barrier each unit takes second[t-1] from its neighbour's D.  So the FFT
// work is 5/4 of the frames' (less where a block starts a channel), and
// every block stays independent of the others: small chunks (C = 8,
// T = 64) still spread over the SMs.  The synthesis block has no lead
// unit.  The units of a block synchronise their passes with named barriers
// of their own.  Products stay FP32 on the FFMA units (no TF32, no tensor
// cores), as the reference's Precision.HIGHEST.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 1024;       // frame length
constexpr int S = 128;        // short window length
constexpr int MID = 448;      // (F - S) / 2: zeros around the short windows
constexpr int NT = 64;        // threads of a unit (one frame)
constexpr int FPB = 4;        // output frames per block
constexpr int SP = 72;        // padded row of the exchange buffer (float2):
                              // conflict-free 8-byte accesses in every pass
// offsets of the twiddle table's parts, in complex entries (kernels/imdct.py);
// each part is laid out in the order the threads read it, so that a warp's
// reads are contiguous
constexpr int TW_PRE_L = 0;     // [512] long pre-twiddle of point n
constexpr int TW_PRE_S = 512;   // [64]  short pre-twiddle of point n
constexpr int TW_PASS1 = 576;   // [7][64] W512^(u k) at (k - 1, u)
constexpr int TW_PASS2 = 1024;  // [7][8]  W64^(m0 k_c) at (k_c - 1, m0)
constexpr int TW_POST_L = 1080; // [8][64] long post-twiddle (carries 1/1024)
                                //         of k = u / 8 + 8 (u % 8) + 64 k_d
                                //         at (k_d, u)
constexpr int TW_POST_S = 1592; // [64]  short post-twiddle (carries 1/128)

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
  const float2* tw;       // [1656] twiddles
  const float* f_tab;     // [8, F]
  const float* s_tab;     // [8, F]
  const float* rise;      // [2, S]
  const float* fall;      // [2, S]
  void* out0;             // tail: pcm [C, T, F]; synth: first [B, F]
  float* out1;            // tail: new overlap [C, F]; synth: second [B, F]
  int C;                  // channels (synth: rows)
  int T;                  // frames per channel (synth: 1)
  int has_short;          // 0: every row takes the long path
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul_mi(float2 a) {  // a * (-i)
  return make_float2(a.y, -a.x);
}

__device__ __forceinline__ void dft4(float2 b0, float2 b1, float2 b2, float2 b3,
                                     float2& y0, float2& y1, float2& y2, float2& y3) {
  const float2 s0 = cadd(b0, b2), s1 = csub(b0, b2), s2 = cadd(b1, b3);
  const float2 s3 = mul_mi(csub(b1, b3));
  y0 = cadd(s0, s2);
  y1 = cadd(s1, s3);
  y2 = csub(s0, s2);
  y3 = csub(s1, s3);
}

// 8-point forward DFT in place: one radix-2 stage, then two 4-point DFTs
// (even outputs from the sums, odd from the twiddled differences)
__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  constexpr float R = 0.70710678118654752f;
  const float2 u0 = cadd(a[0], a[4]), u1 = cadd(a[1], a[5]);
  const float2 u2 = cadd(a[2], a[6]), u3 = cadd(a[3], a[7]);
  const float2 d0 = csub(a[0], a[4]), d1 = csub(a[1], a[5]);
  const float2 d2 = csub(a[2], a[6]), d3 = csub(a[3], a[7]);
  const float2 w1 = make_float2((d1.x + d1.y) * R, (d1.y - d1.x) * R);    // * W8
  const float2 w2 = mul_mi(d2);                                            // * W8^2
  const float2 w3 = make_float2((d3.y - d3.x) * R, -(d3.x + d3.y) * R);   // * W8^3
  dft4(u0, u1, u2, u3, a[0], a[2], a[4], a[6]);
  dft4(d0, w1, w2, w3, a[1], a[3], a[5], a[7]);
}

// The 64 threads of unit `unit` meet here (barrier 0 is __syncthreads').
__device__ __forceinline__ void unit_sync(int unit) {
  asm volatile("bar.sync %0, %1;" ::"r"(unit + 1), "r"(NT) : "memory");
}

// Bins 2q and 2q + 1 of row `row`, decompressed.
template <bool kI16>
__device__ __forceinline__ float2 pair_at(const Params& p, long row, int q) {
  if (kI16) {
    const short2 v = reinterpret_cast<const short2*>(p.spec)[row * (F / 2) + q];
    const float sc = p.scale[row * (F / 16) + (q >> 3)];
    return make_float2(static_cast<float>(v.x) * sc, static_cast<float>(v.y) * sc);
  }
  return reinterpret_cast<const float2*>(p.spec)[row * (F / 2) + q];
}

// The scaled DCT-IV D of row `row` (long), or of each of its 128-bin
// sub-blocks (short, D[128 b + m]), into D[0..1024).  Thread u of the unit;
// X is the unit's exchange buffer.  Ends with D complete for the unit.
template <bool kI16>
__device__ __forceinline__ void transform(const Params& p, long row, bool is_short, int u,
                          int unit, float2* X, float* D) {
  const float2* tw = p.tw;
  float2 a[8];
  // load and pre-twiddle: v[n] = (x[2n] + i x[N-1-2n]) * pre[n] at
  // n = 64 r + u (long) or point u of sub-block r (short)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int pe = 64 * r + u;
    const int po = is_short ? 64 * r + 63 - u : 511 - pe;
    const float2 e = pair_at<kI16>(p, row, pe), o = pair_at<kI16>(p, row, po);
    a[r] = cmul(make_float2(e.x, o.y), tw[is_short ? TW_PRE_S + u : TW_PRE_L + pe]);
  }
  if (!is_short) {
    // pass 1: 8-point DFT over r -> k_a, twiddle W512^(u k_a)
    dft8(a);
#pragma unroll
    for (int k = 1; k < 8; ++k) a[k] = cmul(a[k], tw[TW_PASS1 + 64 * (k - 1) + u]);
  }
  // X[k_a][m] (long) or X[sub-block][m] (short), m = u
#pragma unroll
  for (int r = 0; r < 8; ++r) X[r * SP + u] = a[r];
  unit_sync(unit);
  // pass 2: thread (k_a, m0) = (u / 8, u % 8), DFT over m1 of X[k_a][8 m1 + m0]
  const int ka = u >> 3, lo = u & 7;
#pragma unroll
  for (int m1 = 0; m1 < 8; ++m1) a[m1] = X[ka * SP + 8 * m1 + lo];
  dft8(a);
#pragma unroll
  for (int kc = 1; kc < 8; ++kc) a[kc] = cmul(a[kc], tw[TW_PASS2 + 8 * (kc - 1) + lo]);
  unit_sync(unit);  // every read of X is done before it is overwritten
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) X[ka * SP + 9 * lo + kc] = a[kc];
  unit_sync(unit);
  // pass 3: thread (k_a, k_c) = (u / 8, u % 8), DFT over m0
#pragma unroll
  for (int m0 = 0; m0 < 8; ++m0) a[m0] = X[ka * SP + 9 * m0 + lo];
  dft8(a);
  // post-twiddle into D: D[2k] = Re y, D[N-1-2k] = -Im y
#pragma unroll
  for (int kd = 0; kd < 8; ++kd) {
    if (is_short) {
      const int k = lo + 8 * kd;
      const float2 y = cmul(a[kd], tw[TW_POST_S + k]);
      D[S * ka + 2 * k] = y.x;
      D[S * ka + S - 1 - 2 * k] = -y.y;
    } else {
      const int k = ka + 8 * lo + 64 * kd;
      const float2 y = cmul(a[kd], tw[TW_POST_L + 64 * kd + u]);
      D[2 * k] = y.x;
      D[F - 1 - 2 * k] = -y.y;
    }
  }
  unit_sync(unit);
}

// Sample `pos` (0..2F-1) of the windowed, overlap-added EIGHT_SHORT frame
// whose short D is in D: sub-window w covers [MID + S*w, MID + S*w + 2S),
// so segment s of S samples is rising-half[s] + falling-half[s-1].
__device__ float short_sample(const Params& p, const float* D, int pos,
                              int shape, int prev) {
  const int q = pos - MID;
  if (q < 0 || q >= 9 * S) return 0.f;
  const int seg = q >> 7, o = q & (S - 1);
  float v = 0.f;
  if (seg <= 7) {  // short IMDCT sample o of sub-block seg
    const float x = o < 64 ? D[S * seg + 64 + o] : -D[S * seg + 191 - o];
    v = x * p.rise[(seg == 0 ? prev : shape) * S + o];
  }
  if (seg >= 1) {  // sample S + o of sub-block seg - 1
    const int b = S * (seg - 1);
    const float x = o < 64 ? -D[b + 63 - o] : -D[b + o - 64];
    v += x * p.fall[shape * S + o];
  }
  return v;
}

__device__ __forceinline__ float4 f4load(const float* q) {
  return *reinterpret_cast<const float4*>(q);
}
__device__ __forceinline__ float4 f4mul(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// Samples j0..j0+3 (j0 % 4 == 0) of row `row`'s windowed first half:
// the long fold first[j] = D[512 + j] (j < 512), -D[1535 - j] (j >= 512).
__device__ float4 first_at(const Params& p, const float* D, long row,
                           bool is_short, int j0) {
  if (is_short) {
    const int sh = p.shape_idx[row], pv = p.prev_idx[row];
    return make_float4(short_sample(p, D, j0, sh, pv), short_sample(p, D, j0 + 1, sh, pv),
                       short_sample(p, D, j0 + 2, sh, pv), short_sample(p, D, j0 + 3, sh, pv));
  }
  float4 v;
  if (j0 < F / 2) {
    v = f4load(D + F / 2 + j0);
  } else {
    const float4 r = f4load(D + 1532 - j0);  // D[1535 - j0 - e] = r.w .. r.x
    v = make_float4(-r.w, -r.z, -r.y, -r.x);
  }
  return f4mul(v, f4load(p.f_tab + p.f_idx[row] * F + j0));
}

// ... and of its second half: -D[511 - j] (j < 512), -D[j - 512] (j >= 512).
__device__ float4 second_at(const Params& p, const float* D, long row,
                            bool is_short, int j0) {
  if (is_short) {
    const int sh = p.shape_idx[row], pv = p.prev_idx[row];
    return make_float4(short_sample(p, D, F + j0, sh, pv), short_sample(p, D, F + j0 + 1, sh, pv),
                       short_sample(p, D, F + j0 + 2, sh, pv), short_sample(p, D, F + j0 + 3, sh, pv));
  }
  float4 v;
  if (j0 < F / 2) {
    const float4 r = f4load(D + 508 - j0);   // D[511 - j0 - e] = r.w .. r.x
    v = make_float4(-r.w, -r.z, -r.y, -r.x);
  } else {
    const float4 r = f4load(D + j0 - F / 2);
    v = make_float4(-r.x, -r.y, -r.z, -r.w);
  }
  return f4mul(v, f4load(p.s_tab + p.s_idx[row] * F + j0));
}

__device__ __forceinline__ int16_t pack16(float x) {
  return static_cast<int16_t>(fminf(fmaxf(rintf(x), -32768.f), 32767.f));
}

template <bool kI16, int kMode>
__global__ void __launch_bounds__(NT * (FPB + 1)) filterbank_kernel(Params p) {
  // the tail's block has a lead unit for the frame before its first
  constexpr int kLead = kMode == kHalves ? 0 : 1;
  constexpr int kUnits = FPB + kLead;
  __shared__ __align__(16) float2 Xs[kUnits][8 * SP];
  __shared__ __align__(16) float Ds[kUnits][F];
  const int unit = threadIdx.x / NT, u = threadIdx.x % NT;
  const int rows = p.C * p.T;
  const int g0 = blockIdx.x * FPB;       // the block's first output frame
  const int g = g0 - kLead + unit;       // the frame this unit transforms
  // the lead unit's frame is second[t - 1] of frame g0, unless g0 starts
  // a channel (then the incoming overlap is)
  const bool needed = g < rows && (unit >= kLead || (g0 < rows && g0 % p.T != 0));
  const bool short_g = needed && p.has_short && p.is_short[g] != 0;
  if (needed) transform<kI16>(p, g, short_g, u, unit, Xs[unit], Ds[unit]);
  const float* D = Ds[unit];

  if (kMode == kHalves) {
    if (!needed) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j0 = 4 * u + 256 * i;
      *reinterpret_cast<float4*>(static_cast<float*>(p.out0) + static_cast<long>(g) * F + j0) =
          first_at(p, D, g, short_g, j0);
      *reinterpret_cast<float4*>(p.out1 + static_cast<long>(g) * F + j0) =
          second_at(p, D, g, short_g, j0);
    }
    return;
  }

  __syncthreads();  // every frame of the block is in Ds
  if (unit == 0 || !needed) return;
  const int t = g % p.T, c = g / p.T;
  const float* ov = p.ov_in + static_cast<long>(c) * F;
  // second[t - 1]: the incoming overlap for frame 0, else the previous
  // unit's frame
  float4 prev[4];
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) prev[i] = f4load(ov + 4 * u + 256 * i);
  } else {
    const bool short_p = p.has_short && p.is_short[g - 1] != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      prev[i] = second_at(p, Ds[unit - 1], g - 1, short_p, 4 * u + 256 * i);
  }
  const float keep = p.valid[g] != 0 ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j0 = 4 * u + 256 * i;
    const float4 f = first_at(p, D, g, short_g, j0);
    const float4 s = make_float4((f.x + prev[i].x) * keep, (f.y + prev[i].y) * keep,
                                 (f.z + prev[i].z) * keep, (f.w + prev[i].w) * keep);
    if (kMode == kPcmI16) {
      short4 v;
      v.x = pack16(s.x);
      v.y = pack16(s.y);
      v.z = pack16(s.z);
      v.w = pack16(s.w);
      *reinterpret_cast<short4*>(static_cast<int16_t*>(p.out0) + static_cast<long>(g) * F + j0) = v;
    } else {
      const float sc = 1.0f / 32768.0f;
      *reinterpret_cast<float4*>(static_cast<float*>(p.out0) + static_cast<long>(g) * F + j0) =
          make_float4(s.x * sc, s.y * sc, s.z * sc, s.w * sc);
    }
  }
  // channel c's new overlap: second[last_valid]; a channel with no frames
  // (last_valid < 0) keeps its incoming overlap
  const int lv = p.last_valid[c];
  if (t == lv) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j0 = 4 * u + 256 * i;
      *reinterpret_cast<float4*>(p.out1 + static_cast<long>(c) * F + j0) =
          second_at(p, D, g, short_g, j0);
    }
  } else if (lv < 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j0 = 4 * u + 256 * i;
      *reinterpret_cast<float4*>(p.out1 + static_cast<long>(c) * F + j0) = prev[i];
    }
  }
}

template <bool kI16, int kMode>
void launch(const Params& p, cudaStream_t stream) {
  const unsigned blocks = (p.C * p.T + FPB - 1) / FPB;
  const int units = kMode == kHalves ? FPB : FPB + 1;
  filterbank_kernel<kI16, kMode><<<blocks, NT * units, 0, stream>>>(p);
}

}  // namespace

extern "C" int aacjax_tail(const void* spec, const void* scale, int spec_i16,
                           const void* f_idx, const void* s_idx,
                           const void* shape_idx, const void* prev_idx,
                           const void* is_short, const void* valid,
                           const void* last_valid, const void* ov_in,
                           const void* twiddles, const void* f_tab,
                           const void* s_tab, const void* rise,
                           const void* fall, void* pcm, void* ov_out,
                           int out_i16, int has_short, int C, int T,
                           void* stream) {
  if (T < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{spec, static_cast<const float*>(scale),
                 static_cast<const int*>(f_idx), static_cast<const int*>(s_idx),
                 static_cast<const int*>(shape_idx), static_cast<const int*>(prev_idx),
                 static_cast<const int*>(is_short), static_cast<const int*>(valid),
                 static_cast<const int*>(last_valid), static_cast<const float*>(ov_in),
                 static_cast<const float2*>(twiddles),
                 static_cast<const float*>(f_tab), static_cast<const float*>(s_tab),
                 static_cast<const float*>(rise), static_cast<const float*>(fall),
                 pcm, static_cast<float*>(ov_out), C, T, has_short};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (spec_i16) {
    if (out_i16) launch<true, kPcmI16>(p, s);
    else launch<true, kPcmF32>(p, s);
  } else {
    if (out_i16) launch<false, kPcmI16>(p, s);
    else launch<false, kPcmF32>(p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aacjax_synth(const void* spec, const void* f_idx,
                            const void* s_idx, const void* shape_idx,
                            const void* prev_idx, const void* is_short,
                            const void* twiddles, const void* f_tab,
                            const void* s_tab, const void* rise,
                            const void* fall, void* first, void* second,
                            int B, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{spec, nullptr,
                 static_cast<const int*>(f_idx), static_cast<const int*>(s_idx),
                 static_cast<const int*>(shape_idx), static_cast<const int*>(prev_idx),
                 static_cast<const int*>(is_short), nullptr, nullptr, nullptr,
                 static_cast<const float2*>(twiddles),
                 static_cast<const float*>(f_tab), static_cast<const float*>(s_tab),
                 static_cast<const float*>(rise), static_cast<const float*>(fall),
                 first, static_cast<float*>(second), B, 1, 1};
  launch<false, kHalves>(p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
