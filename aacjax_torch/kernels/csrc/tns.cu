// TNS: the all-pole filter along the spectral bins, in compensated
// float-float arithmetic.
//
// Replaces aacjax/kernels/pipeline.py tns / _tns_directional_scan (an XLA
// lax.scan of 1024 steps on the TPU; there is no Pallas kernel for it).
// Per row and direction: y[n] = x[n] - sum_i lpc_n[i] * y[n-1-i], order
// <= 20, taps masked to the active filter's range, up to 8 filters per
// direction.  The reverse direction runs on the flipped spectrum with the
// host-transformed ranges.  Both directions read the INPUT spectrum; the
// forward filter's region takes the forward result, the reverse filter's
// region the reverse result (it wins where both claim a bin, as in the
// reference), and every other bin passes through.
//
// The recursion state is an unevaluated f32 hi + lo pair: products split
// exactly by mantissa masking (TwoProd), sums by Knuth TwoSum.  That keeps
// fp64-class accuracy on high-gain order-12..20 filters, where plain f32
// drifts by ~1e-3 full scale.  The arithmetic is written with
// __fmul_rn / __fadd_rn / __fsub_rn: nvcc would otherwise contract a*b+c
// into an FMA, which breaks TwoProd and TwoSum.
//
// What bounds it on the H100: a serial dependence chain of ~1024 x 19
// compensated additions per (row, direction) -- latency, not FLOPs or
// bytes (a row is 4 KB).  Design: one thread per (row, direction), the
// 20-deep history in registers (fully unrolled taps), the active filter's
// coefficients reloaded only when the active filter changes.  The two
// threads of a row write disjoint bins, so no synchronisation is needed.
// A warp-cooperative form is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 1024;
constexpr int SLOTS = 8;
constexpr int ORDER = 20;

__device__ __forceinline__ float split_hi(float a) {
  return __uint_as_float(__float_as_uint(a) & 0xFFFFF000u);
}

// a * b = p + e exactly
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  const float ah = split_hi(a), al = __fsub_rn(a, ah);
  const float bh = split_hi(b), bl = __fsub_rn(b, bh);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

// a + b = s + e exactly
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ unsigned active_mask(const int* st, const int* en, int n) {
  unsigned m = 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    if (st[s] <= n && n < en[s]) m |= 1u << s;
  return m;
}

__global__ void __launch_bounds__(128) tns_kernel(
    const float* __restrict__ x, const float* __restrict__ fwd_lpc,
    const int* __restrict__ fwd_start, const int* __restrict__ fwd_end,
    const float* __restrict__ rev_lpc, const int* __restrict__ rev_start,
    const int* __restrict__ rev_end, float* __restrict__ out, int rows) {
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= 2 * rows) return;
  const long row = id >> 1;
  const bool rev = id & 1;
  const float* lpc = (rev ? rev_lpc : fwd_lpc) + row * SLOTS * ORDER;
  int st[SLOTS], en[SLOTS], ost[SLOTS], oen[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    st[s] = (rev ? rev_start : fwd_start)[row * SLOTS + s];
    en[s] = (rev ? rev_end : fwd_end)[row * SLOTS + s];
    // the reverse filters' ranges, for the forward thread's ownership test
    ost[s] = rev_start[row * SLOTS + s];
    oen[s] = rev_end[row * SLOTS + s];
  }
  const float* xr = x + row * F;
  float* yr = out + row * F;

  float hh[ORDER], hl[ORDER], coef[ORDER];
#pragma unroll
  for (int i = 0; i < ORDER; ++i) hh[i] = hl[i] = coef[i] = 0.f;
  unsigned cur = 0;
  int start_n = 0;

  for (int n = 0; n < F; ++n) {
    const unsigned m = active_mask(st, en, n);
    if (m != cur) {  // the active filter changed: reload its taps
      cur = m;
      start_n = 0;
#pragma unroll
      for (int i = 0; i < ORDER; ++i) coef[i] = 0.f;
      for (int s = 0; s < SLOTS; ++s) {
        if (!((m >> s) & 1u)) continue;
        start_n += st[s];
#pragma unroll
        for (int i = 0; i < ORDER; ++i) coef[i] = __fadd_rn(coef[i], lpc[s * ORDER + i]);
      }
    }
    const int idx = rev ? F - 1 - n : n;
    const float xn = xr[idx];

    float p_hi[ORDER], p_lo[ORDER];
#pragma unroll
    for (int i = 0; i < ORDER; ++i) {
      const float c = (n - (i + 1)) >= start_n ? coef[i] : 0.f;
      two_prod(c, hh[i], p_hi[i], p_lo[i]);
      p_lo[i] = __fadd_rn(p_lo[i], __fmul_rn(c, hl[i]));
    }
    float s = -p_hi[0], e = -p_lo[0];
#pragma unroll
    for (int i = 1; i < ORDER; ++i) {
      float s2, e2;
      two_sum(s, -p_hi[i], s2, e2);
      s = s2;
      e = __fsub_rn(__fadd_rn(e, e2), p_lo[i]);
    }
    float y_hi, y_lo, e2, e3;
    two_sum(xn, s, y_hi, e2);
    y_lo = __fadd_rn(e, e2);
    two_sum(y_hi, y_lo, y_hi, e3);
    y_lo = e3;
#pragma unroll
    for (int i = ORDER - 1; i > 0; --i) {
      hh[i] = hh[i - 1];
      hl[i] = hl[i - 1];
    }
    hh[0] = y_hi;
    hl[0] = y_lo;

    if (rev) {
      if (m) yr[idx] = y_hi;
    } else if (!active_mask(ost, oen, F - 1 - n)) {
      yr[idx] = m ? y_hi : xn;
    }
  }
}

}  // namespace

extern "C" int aacjax_tns(const void* x, const void* fwd_lpc,
                          const void* fwd_start, const void* fwd_end,
                          const void* rev_lpc, const void* rev_start,
                          const void* rev_end, void* out, int rows,
                          void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (2 * rows + threads - 1) / threads;
  tns_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(fwd_lpc),
      static_cast<const int*>(fwd_start), static_cast<const int*>(fwd_end),
      static_cast<const float*>(rev_lpc), static_cast<const int*>(rev_start),
      static_cast<const int*>(rev_end), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
