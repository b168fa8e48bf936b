// Main-profile backward prediction: a second-order backward-adaptive lattice
// predictor per spectral bin (ISO/IEC 14496-3 4.6.2, libavcodec's numerics).
//
// Replaces aacjax/kernels/pipeline.py apply_prediction (an XLA lax.scan over
// the frame axis on the TPU; there is no Pallas kernel for it).  The bins are
// independent and the frames of one bin are a serial chain through six state
// values (r0, r1, cor0, cor1, var0, var1), each rounded to a 16-bit mantissa
// after every frame so that independent decoders stay bit-synchronised.
//
// One thread per (channel, bin), bin < 672, consecutive threads on
// consecutive bins: every load and store of a warp is one coalesced line.
// The six state values stay in registers over the T frames; mode, reset
// group and nbins of a (channel, frame) are the same address for the whole
// block.  The spectra are updated in place for bins < 672 (the bins above are
// never touched); the new state is written once, at the end.
//
// Roundings are the plain version's, step for step: every product, sum,
// difference and quotient is one f32 operation written with __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc never contracts into an FMA.
// The 16-bit roundings are integer arithmetic on the float's bits.  So the
// kernel and apply_prediction_ref agree bit for bit.
//
// What bounds it on the H100: bytes.  A (channel, bin, frame) step is about
// 30 FP32 operations and two divisions against 9 bytes moved (the spectrum
// read and written, one byte of `used`), plus the state once per chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BINS = 672;           // predicted bins of a long frame
constexpr int THREADS = 224;        // 3 blocks of 7 warps cover the 672 bins
constexpr int RESET_PERIOD = 30;    // reset group g covers bins k % 30 == g-1

__device__ __forceinline__ float flt16_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x8000u) & 0xFFFF0000u);
}

__device__ __forceinline__ float flt16_even(float x) {
  const uint32_t b = __float_as_uint(x);
  return __uint_as_float((b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u);
}

__device__ __forceinline__ float flt16_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

__global__ void __launch_bounds__(THREADS)
pred_kernel(float* __restrict__ spec, const int* __restrict__ mode,
            const int* __restrict__ reset, const int* __restrict__ nbins,
            const uint8_t* __restrict__ used, const float* __restrict__ state,
            float* __restrict__ state_out, int T, int F) {
  const int c = blockIdx.x;
  const int k = blockIdx.y * THREADS + threadIdx.x;   // < 672 by the grid
  const float A = 0.953125f;       // 61/64
  const float ALPHA = 0.90625f;    // 29/32

  const float2* st = reinterpret_cast<const float2*>(
      state + (static_cast<size_t>(c) * BINS + k) * 6);
  const float2 s01 = st[0], s23 = st[1], s45 = st[2];
  float r0 = s01.x, r1 = s01.y, cor0 = s23.x, cor1 = s23.y;
  float var0 = s45.x, var1 = s45.y;

  float* x = spec + static_cast<size_t>(c) * T * F + k;
  const uint8_t* u = used + static_cast<size_t>(c) * T * BINS + k;
  const int* m_row = mode + static_cast<size_t>(c) * T;
  const int* g_row = reset + static_cast<size_t>(c) * T;
  const int* n_row = nbins + static_cast<size_t>(c) * T;
  const int k_mod = k % RESET_PERIOD;

  for (int t = 0; t < T; ++t) {
    const int m = m_row[t];
    const float s = x[static_cast<size_t>(t) * F];
    const bool long_frame = m == 1;
    const float k1 = var0 > 1.0f
        ? __fmul_rn(cor0, flt16_even(__fdiv_rn(A, var0))) : 0.0f;
    const float k2 = var1 > 1.0f
        ? __fmul_rn(cor1, flt16_even(__fdiv_rn(A, var1))) : 0.0f;
    const float k1r0 = __fmul_rn(k1, r0);
    const float pv = flt16_round(__fadd_rn(k1r0, __fmul_rn(k2, r1)));
    const float on =
        (long_frame && u[static_cast<size_t>(t) * BINS] != 0) ? 1.0f : 0.0f;
    // pv * 0 keeps the plain version's bits (a zero's sign, a NaN from an
    // infinite pv)
    const float e0 = __fadd_rn(s, __fmul_rn(pv, on));
    x[static_cast<size_t>(t) * F] = e0;
    if (long_frame && k < n_row[t]) {
      const float e1 = __fsub_rn(e0, k1r0);
      const float n_cor1 = flt16_trunc(
          __fadd_rn(__fmul_rn(ALPHA, cor1), __fmul_rn(r1, e1)));
      const float n_var1 = flt16_trunc(__fadd_rn(
          __fmul_rn(ALPHA, var1),
          __fmul_rn(0.5f, __fadd_rn(__fmul_rn(r1, r1), __fmul_rn(e1, e1)))));
      const float n_cor0 = flt16_trunc(
          __fadd_rn(__fmul_rn(ALPHA, cor0), __fmul_rn(r0, e0)));
      const float n_var0 = flt16_trunc(__fadd_rn(
          __fmul_rn(ALPHA, var0),
          __fmul_rn(0.5f, __fadd_rn(__fmul_rn(r0, r0), __fmul_rn(e0, e0)))));
      const float n_r1 =
          flt16_trunc(__fmul_rn(A, __fsub_rn(r0, __fmul_rn(k1, e0))));
      const float n_r0 = flt16_trunc(__fmul_rn(A, e0));
      r0 = n_r0; r1 = n_r1; cor0 = n_cor0; cor1 = n_cor1;
      var0 = n_var0; var1 = n_var1;
    }
    // resets apply after the frame's update
    const int g = g_row[t];
    if (m == 2 || (long_frame && g > 0 && k_mod == g - 1)) {
      r0 = r1 = cor0 = cor1 = 0.0f;
      var0 = var1 = 1.0f;
    }
  }

  float2* so = reinterpret_cast<float2*>(
      state_out + (static_cast<size_t>(c) * BINS + k) * 6);
  so[0] = make_float2(r0, r1);
  so[1] = make_float2(cor0, cor1);
  so[2] = make_float2(var0, var1);
}

}  // namespace

// spec is f32 [C][T][F], F >= 672, updated in place for bins < 672; mode,
// reset, nbins int32 [C][T]; used uint8 [C][T][672]; state and state_out f32
// [C][672][6], two buffers.  Returns the CUDA error of the
// launch, 0 for none.
extern "C" int aacjax_pred(void* spec, const void* mode, const void* reset,
                           const void* nbins, const void* used,
                           const void* state, void* state_out, int C, int T,
                           int F, void* stream) {
  if (C < 1 || T < 1 || F < BINS)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(BINS % THREADS == 0, "the grid covers the bins exactly");
  pred_kernel<<<dim3(C, BINS / THREADS), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(spec), static_cast<const int*>(mode),
      static_cast<const int*>(reset), static_cast<const int*>(nbins),
      static_cast<const uint8_t*>(used), static_cast<const float*>(state),
      static_cast<float*>(state_out), T, F);
  return static_cast<int>(cudaGetLastError());
}
