// Parametric Stereo decorrelator recurrences: the transient detector and the
// 3-link allpass cascade, over the S = 32 T QMF slots of a chunk.
//
// Replaces the two sequential recurrences of aacjax/kernels/ps_batch.py
// _decorrelate (an XLA program on the TPU: lax.scan in its `seq` form,
// Hillis-Steele doubling and Toeplitz products in its default forms; there is
// no Pallas kernel for it).  Both carry their state across chunks.
//
//   transient   one thread per (row, parameter band): per slot
//               peak = max(0.76592833836465 peak, x)
//               psm  = psm + 0.25 (x - psm)
//               pdf  = pdf + 0.25 ((peak - x) - pdf)
//               g    = 1.5 pdf > psm ? psm / (1.5 pdf) : 1
//   allpass     one thread per (row, allpass band): link m = 0, 1, 2 (delay
//               3, 4, 5) reads register 2 - m of its 5-deep line,
//               n = (ld q_m) - a_m c (complex ld q_m, real a_m),
//               pushes c + a_m n and hands n to the next link; the output
//               is the last link's n
//
// Layouts are slot-major inside a row ([row][slot][band]), so at each slot
// the threads of one row read and write neighbouring words.  The state stays
// in registers across the S slots and is written once at the end.  The two
// roles run as the two rows of the grid (blockIdx.y), so one launch does both.
//
// Roundings are the plain version's (kernels/ps_decorr.py decorrelate_ref),
// step for step: every product, sum and difference is one f32 operation
// written with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts
// into an FMA, and the quotient is __fdiv_rn.  So the kernel and the plain
// version agree bit for bit.
//
// What bounds it on the H100: bytes (the power and the gains, the allpass
// input and output, once each), and at small batches the latency of S
// dependent steps per thread.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int LINKS = 3;
constexpr int DEPTH = 5;            // register line of a link (delays 3, 4, 5)

__global__ void __launch_bounds__(THREADS)
ps_decorr_kernel(const float* __restrict__ pw, const float* __restrict__ peak_in,
                 const float* __restrict__ psm_in, const float* __restrict__ pdf_in,
                 const float* __restrict__ xr, const float* __restrict__ xi,
                 const float* __restrict__ ap_r_in, const float* __restrict__ ap_i_in,
                 const float* __restrict__ qf_r, const float* __restrict__ qf_i,
                 const float* __restrict__ ag,
                 float* __restrict__ tg, float* __restrict__ peak_out,
                 float* __restrict__ psm_out, float* __restrict__ pdf_out,
                 float* __restrict__ yr, float* __restrict__ yi,
                 float* __restrict__ ap_r_out, float* __restrict__ ap_i_out,
                 int B, int S, int npar, int nap) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (blockIdx.y == 0) {
    // -- transient detector ------------------------------------------------
    if (i >= B * npar) return;
    const int b = i / npar, p = i - b * npar;
    const float C_PEAK = 0.76592833836465f;
    float peak = peak_in[i], psm = psm_in[i], pdf = pdf_in[i];
    const float* x = pw + static_cast<size_t>(b) * S * npar + p;
    float* g = tg + static_cast<size_t>(b) * S * npar + p;
    for (int s = 0; s < S; ++s) {
      const float v = x[static_cast<size_t>(s) * npar];
      peak = fmaxf(__fmul_rn(C_PEAK, peak), v);
      psm = __fadd_rn(psm, __fmul_rn(0.25f, __fsub_rn(v, psm)));
      pdf = __fadd_rn(pdf, __fmul_rn(0.25f,
                                     __fsub_rn(__fsub_rn(peak, v), pdf)));
      const float denom = __fmul_rn(1.5f, pdf);
      g[static_cast<size_t>(s) * npar] =
          denom > psm ? __fdiv_rn(psm, denom > 0.0f ? denom : 1.0f) : 1.0f;
    }
    peak_out[i] = peak;
    psm_out[i] = psm;
    pdf_out[i] = pdf;
    return;
  }
  // -- 3-link allpass cascade ------------------------------------------------
  if (i >= B * nap) return;
  const int b = i / nap, k = i - b * nap;
  float rr[LINKS][DEPTH], ri[LINKS][DEPTH];
  float q_r[LINKS], q_i[LINKS], a[LINKS];
  const size_t st = static_cast<size_t>(i) * LINKS * DEPTH;
#pragma unroll
  for (int m = 0; m < LINKS; ++m) {
    q_r[m] = qf_r[k * LINKS + m];
    q_i[m] = qf_i[k * LINKS + m];
    a[m] = ag[k * LINKS + m];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) {
      rr[m][j] = ap_r_in[st + m * DEPTH + j];
      ri[m][j] = ap_i_in[st + m * DEPTH + j];
    }
  }
  const size_t row = static_cast<size_t>(b) * S * nap + k;
  for (int s = 0; s < S; ++s) {
    const size_t at = row + static_cast<size_t>(s) * nap;
    float cr = xr[at], ci = xi[at];
#pragma unroll
    for (int m = 0; m < LINKS; ++m) {
      const float ld_r = rr[m][2 - m], ld_i = ri[m][2 - m];
      const float nr = __fsub_rn(
          __fsub_rn(__fmul_rn(ld_r, q_r[m]), __fmul_rn(ld_i, q_i[m])),
          __fmul_rn(a[m], cr));
      const float ni = __fsub_rn(
          __fadd_rn(__fmul_rn(ld_r, q_i[m]), __fmul_rn(ld_i, q_r[m])),
          __fmul_rn(a[m], ci));
#pragma unroll
      for (int j = 0; j < DEPTH - 1; ++j) {
        rr[m][j] = rr[m][j + 1];
        ri[m][j] = ri[m][j + 1];
      }
      rr[m][DEPTH - 1] = __fadd_rn(cr, __fmul_rn(a[m], nr));
      ri[m][DEPTH - 1] = __fadd_rn(ci, __fmul_rn(a[m], ni));
      cr = nr;
      ci = ni;
    }
    yr[at] = cr;
    yi[at] = ci;
  }
#pragma unroll
  for (int m = 0; m < LINKS; ++m) {
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) {
      ap_r_out[st + m * DEPTH + j] = rr[m][j];
      ap_i_out[st + m * DEPTH + j] = ri[m][j];
    }
  }
}

}  // namespace

// pw, tg f32 [B][S][npar]; peak, psmooth, pdiff (in and out) f32 [B][npar];
// xr, xi, yr, yi f32 [B][S][nap]; ap_r, ap_i (in and out) f32
// [B][nap][3][5]; qf_r, qf_i, ag f32 [nap][3].  Outputs are separate
// buffers from the inputs.  Returns the CUDA error of the launch, 0 for none.
extern "C" int aacjax_ps_decorr(
    const void* pw, const void* peak, const void* psm, const void* pdf,
    const void* xr, const void* xi, const void* ap_r, const void* ap_i,
    const void* qf_r, const void* qf_i, const void* ag, void* tg,
    void* peak_out, void* psm_out, void* pdf_out, void* yr, void* yi,
    void* ap_r_out, void* ap_i_out, int B, int S, int npar, int nap,
    void* stream) {
  if (B < 1 || S < 1 || npar < 1 || nap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = B * (npar > nap ? npar : nap);
  const dim3 grid((items + THREADS - 1) / THREADS, 2);
  ps_decorr_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pw), static_cast<const float*>(peak),
      static_cast<const float*>(psm), static_cast<const float*>(pdf),
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(ap_r), static_cast<const float*>(ap_i),
      static_cast<const float*>(qf_r), static_cast<const float*>(qf_i),
      static_cast<const float*>(ag), static_cast<float*>(tg),
      static_cast<float*>(peak_out), static_cast<float*>(psm_out),
      static_cast<float*>(pdf_out), static_cast<float*>(yr),
      static_cast<float*>(yi), static_cast<float*>(ap_r_out),
      static_cast<float*>(ap_i_out), B, S, npar, nap);
  return static_cast<int>(cudaGetLastError());
}
