// Parametric Stereo decorrelation of one chunk, fused: the power per
// parameter band, the transient detector, the delay lines, the 3-link allpass
// cascade and the gains, over the S = 32 T hybrid slots of each row.
//
// Replaces the whole of aacjax/kernels/ps_batch.py _decorrelate (an XLA
// program on the TPU: an indicator product for the powers, lax.scan in its
// `seq` form or Hillis-Steele doubling and Toeplitz products in its default
// forms for the recurrences, concatenations and one-hot products for the
// delay lines and the gains; there is no Pallas kernel for it).  Per row:
//
//   power       pw[s][p] = sum over the bands k of parameter band p, in
//               ascending k, of s_r^2 + s_i^2
//   transient   per band p over the slots:
//               peak = max(0.76592833836465 peak, x)
//               psm  = psm + 0.25 (x - psm)
//               pdf  = pdf + 0.25 ((peak - x) - pdf)
//               g    = 1.5 pdf > psm ? psm / (1.5 pdf) : 1
//   allpass     bands k < nap: the input is s two slots back rotated by
//               phi[k]; link m = 0, 1, 2 (delay 3, 4, 5) reads register
//               2 - m of its 5-deep line, n = (ld q_m) - a_m c (complex
//               ld q_m, real a_m), pushes c + a_m n and hands n on
//   delays      bands nap <= k < sdb: s 14 slots back; k >= sdb: 1 slot back
//   output      d[s][k] = source[s][k] * g[s][k_to_i[k]]
//
// What bounds it on the H100: bytes in principle.  The planes s_r, s_i are
// read once and d_r, d_i written once (16 bytes per (row, slot, band)),
// about 25 operations per (row, slot, band) against them.  In practice the
// latency of a tile's phases (the serial walks above all) over the few
// blocks an SM holds.
//
// Design: a block per row.  Warps by role: detector warps (a thread per
// parameter band), allpass warps (a thread per allpass band) and two spare
// warps, 4 warps in the 20-band mode and 6 in the 34-band one.  A tile is
// 32 slots (one QMF frame): one row's tile of one plane is 32 nb contiguous
// floats (a multiple of 16 bytes), so thread 0 moves it with one bulk async
// copy (cp.async.bulk, global -> shared, completing on an mbarrier) into a
// ring of STAGES = 3 stages.  Tiles 0 and 1 are in flight from the start;
// tile 0 finds the delay state written in slots 18..31 of the stage before
// it.  Per tile t:
//   1. the allpass warps walk the 32 slots, unrolled, their state in
//      registers (the register lines are renamed, not moved), into
//      y[k][slot]; meanwhile the other warps sum the powers into
//      pw[p][slot], a lane per slot over a warp's run of the power plan
//      (whole bands, members in order; lanes nb words apart, odd: no bank
//      conflicts), and then the detector threads walk their recurrences;
//   2. all warps: the gains, the quotients in parallel;
//   3. all warps: d for slots 0..15, then 16..31, a warp per slot row and
//      a lane per band, written over the stage of tile t - 1 (its rows
//      0..17 are never read in tile t, its rows 18..31 only for slots
//      0..13); each half leaves by bulk copies shared -> global, and once
//      they have read the stage it takes tile t + 2.
// Each phase loads what it needs before it stores (a store to shared memory
// holds back the loads behind it).  The new delay state is the last tile's
// slots 18..31, band-major.
//
// Roundings are the plain version's (kernels/ps_decorr.py
// decorrelate_chunk_ref), step for step: every product, sum and difference
// is one f32 operation written with __fmul_rn / __fadd_rn / __fsub_rn,
// which nvcc never contracts into an FMA, and the quotient is __fdiv_rn.  So
// the kernel and the plain version agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 192;   // 6 warps: the 34-band mode's roles
constexpr int SLOTS = 32;           // a tile: one QMF frame
constexpr int STAGES = 3;           // the ring of tiles in shared memory
constexpr int HIST = 14;            // the delay line's history
constexpr int LINKS = 3;
constexpr int DEPTH = 5;            // register line of a link (delays 3, 4, 5)
constexpr int HALF = SLOTS / 2;     // d leaves in two halves of rows
constexpr int CHUNK = 8;            // slots or plan entries loaded at once
constexpr int ROWS = 4;             // a warp's rows in half a tile (>= 4 warps)
constexpr int PAD = SLOTS + 1;      // row stride of the [band][slot] planes
constexpr int MAX_DEVICES = 64;     // devices whose shared-memory opt-in is kept
constexpr int SPARE_WARPS = 2;      // warps with no walk of their own
constexpr int MAX_NB = 96;          // bands a lane covers in 3 steps of 32
constexpr int BARRIER_BYTES = 128;  // the ring's mbarriers, ahead of the ring
// an entry of the power plan: band k, parameter band p, first / last member
constexpr int FIRST = 1 << 16, LAST = 1 << 17;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0: two bulk copies (the tile of s_r and of s_i) completing on `bar`.
__device__ __forceinline__ void load_tile(uint64_t* bar, float* dst,
                                          const float* src_r,
                                          const float* src_i, int plane) {
  const uint32_t bytes = static_cast<uint32_t>(plane) * 4u;
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(2u * bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src_r), "r"(bytes), "r"(b) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst + plane)), "l"(src_i), "r"(bytes), "r"(b)
      : "memory");
}

// Thread 0: `n` floats of d's tile in both planes (at src and src + plane)
// to dst_r and dst_i as two bulk copies, committed as one group.
__device__ __forceinline__ void store_rows(float* dst_r, float* dst_i,
                                           const float* src, int plane,
                                           int n) {
  const uint32_t bytes = static_cast<uint32_t>(n) * 4u;
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst_r), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst_i), "r"(smem_addr(src + plane)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Every thread: wait until the phase of `bar` with this parity completed.  A
// copy that never lands traps after ~2^32 cycles instead of hanging.
__device__ __forceinline__ void wait_tile(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// The warps of the power sums and the detector (all but the allpass warps).
__device__ __forceinline__ void sync_sums(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
ps_decorrelate_kernel(
    const float* __restrict__ s_r, const float* __restrict__ s_i,
    const float* __restrict__ delay_r, const float* __restrict__ delay_i,
    const float* __restrict__ ap_r, const float* __restrict__ ap_i,
    const float* __restrict__ peak_in, const float* __restrict__ psm_in,
    const float* __restrict__ pdf_in, const float* __restrict__ phi_r,
    const float* __restrict__ phi_i, const float* __restrict__ qf_r,
    const float* __restrict__ qf_i, const float* __restrict__ ag,
    const int* __restrict__ k_to_i, const int* __restrict__ members,
    float* __restrict__ d_r, float* __restrict__ d_i,
    float* __restrict__ delay_r_out, float* __restrict__ delay_i_out,
    float* __restrict__ ap_r_out, float* __restrict__ ap_i_out,
    float* __restrict__ peak_out, float* __restrict__ psm_out,
    float* __restrict__ pdf_out, int S, int nb, int npar, int nap, int sdb,
    int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const int plane = SLOTS * nb;            // floats of one plane's tile
  float* ring = reinterpret_cast<float*>(smem + BARRIER_BYTES);
  float* y_r = ring + STAGES * 2 * plane;   // [nap][PAD]
  float* y_i = y_r + nap * PAD;
  float* pw = y_i + nap * PAD;              // [npar][PAD], then the gains
  float* psm_s = pw + npar * PAD;           // the detector's psm and 1.5 pdf
  float* den_s = psm_s + npar * PAD;
  int* plan = reinterpret_cast<int*>(den_s + npar * PAD);   // [nb]
  int* count = plan + nb;                   // [npar] members, then starts
  int* range = count + npar;                // [warps + 1] of the plan

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int det_warps = (npar + 31) / 32, ap_warps = (nap + 31) / 32;
  const int sum_warps = n_warps - ap_warps; // power sums, then the detector
  const int ntiles = S / SLOTS;
  const size_t row = static_cast<size_t>(b) * S * nb;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   ::"r"(smem_addr(full + i)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < STAGES - 1 && t < ntiles; ++t)
      load_tile(full + t, ring + t * 2 * plane, s_r + row + t * plane,
                s_i + row + t * plane, plane);

  // the delay state as slots -14..-1 of the stage ahead of tile 0 (its
  // first copy is issued after tile 0)
  {
    float* pre = ring + (STAGES - 1) * 2 * plane;
    const size_t at = static_cast<size_t>(b) * nb * HIST;
    for (int i = tid; i < nb * HIST; i += blockDim.x) {
      const int k = i / HIST, j = i - k * HIST;
      pre[(SLOTS - HIST + j) * nb + k] = delay_r[at + i];
      pre[plane + (SLOTS - HIST + j) * nb + k] = delay_i[at + i];
    }
  }
  // the power plan: the members of p = 0, 1, ... in order, each entry
  // k | p << 8 | FIRST | LAST, cut into contiguous runs of whole bands, one
  // run a summing warp
  for (int i = tid; i < npar * M; i += blockDim.x) {
    const int j = i % M;
    if (members[i] < nb && (j + 1 == M || members[i + 1] >= nb))
      count[i / M] = j + 1;
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int p = 0; p < npar; ++p) total += count[p];
    const int target = (total + sum_warps - 1) / sum_warps;
    int w = 0, run = 0, at = 0;
    range[0] = 0;
    for (int p = 0; p < npar; ++p) {
      if (run > 0 && run + count[p] > target && w < sum_warps - 1) {
        range[++w] = at;
        run = 0;
      }
      run += count[p];
      const int n = count[p];
      count[p] = at;                          // now the band's first entry
      at += n;
    }
    while (w < sum_warps) range[++w] = at;
  }
  __syncthreads();
  for (int i = tid; i < npar * M; i += blockDim.x) {
    const int p = i / M, j = i - p * M, k = members[i];
    if (k < nb) {
      const bool last = j + 1 == M || members[i + 1] >= nb;
      plan[count[p] + j] = k | p << 8 | (j == 0 ? FIRST : 0) |
                           (last ? LAST : 0);
    }
  }

  // roles: detector threads p = 0..npar-1 (warps 0..det_warps-1), then
  // the allpass warps, then the spare warps; the summing warps are all but
  // the allpass ones
  const bool is_det = tid < npar;
  const int k_ap = tid - 32 * det_warps;
  const bool in_ap = warp >= det_warps && warp < det_warps + ap_warps;
  const bool is_ap = in_ap && k_ap < nap;
  const int sum_rank = warp < det_warps ? warp : warp - ap_warps;
  const float C_PEAK = 0.76592833836465f;
  float peak = 0.0f, psm = 0.0f, pdf = 0.0f;
  if (is_det) {
    const size_t at = static_cast<size_t>(b) * npar + tid;
    peak = peak_in[at];
    psm = psm_in[at];
    pdf = pdf_in[at];
  }
  float rr[LINKS][DEPTH], ri[LINKS][DEPTH];
  float q_r[LINKS], q_i[LINKS], a[LINKS], ph_r = 0.0f, ph_i = 0.0f;
  const size_t ap_at =
      (static_cast<size_t>(b) * nap + (is_ap ? k_ap : 0)) * LINKS * DEPTH;
#pragma unroll
  for (int m = 0; m < LINKS; ++m) {
    q_r[m] = q_i[m] = a[m] = 0.0f;
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) rr[m][j] = ri[m][j] = 0.0f;
  }
  if (is_ap) {
    ph_r = phi_r[k_ap];
    ph_i = phi_i[k_ap];
#pragma unroll
    for (int m = 0; m < LINKS; ++m) {
      q_r[m] = qf_r[k_ap * LINKS + m];
      q_i[m] = qf_i[k_ap * LINKS + m];
      a[m] = ag[k_ap * LINKS + m];
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        rr[m][j] = ap_r[ap_at + m * DEPTH + j];
        ri[m][j] = ap_i[ap_at + m * DEPTH + j];
      }
    }
  }
  // the epilogue's bands of this lane, k = lane + 32 r (the last band for
  // the lanes past it): their gain row and the lag of their source (0 for
  // the allpass output)
  int band[MAX_NB / 32], gain_at[MAX_NB / 32], lag[MAX_NB / 32];
#pragma unroll
  for (int r = 0; r < MAX_NB / 32; ++r) {
    band[r] = min(lane + 32 * r, nb - 1);
    gain_at[r] = k_to_i[band[r]] * PAD;
    lag[r] = band[r] < nap ? 0 : band[r] < sdb ? HIST : 1;
  }
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    float* cur = ring + (t % STAGES) * 2 * plane;
    float* prev = ring + ((t + STAGES - 1) % STAGES) * 2 * plane;
    wait_tile(full + t % STAGES, static_cast<uint32_t>(t / STAGES) & 1u);

    if (in_ap) {
      // 1a. the allpass walk over the 32 slots, unrolled: the input is s
      // two slots back rotated by phi; the register lines are renamed.
      // The inputs of 8 slots are loaded before the 8 slots ahead of them
      // are walked (a store to shared memory holds back the loads behind
      // it)
      if (is_ap) {
        float in_r[2][CHUNK], in_i[2][CHUNK];
        auto load_in = [&](int c) {
#pragma unroll
          for (int u = 0; u < CHUNK; ++u) {
            const int j = c * CHUNK + u;
            const float* src = j >= 2 ? cur + (j - 2) * nb
                                      : prev + (SLOTS - 2 + j) * nb;
            in_r[c & 1][u] = src[k_ap];
            in_i[c & 1][u] = src[plane + k_ap];
          }
        };
        load_in(0);
#pragma unroll
        for (int c = 0; c < SLOTS / CHUNK; ++c) {
          if (c + 1 < SLOTS / CHUNK) load_in(c + 1);
#pragma unroll
          for (int u = 0; u < CHUNK; ++u) {
            const float xr = in_r[c & 1][u], xi = in_i[c & 1][u];
            float cr = __fsub_rn(__fmul_rn(xr, ph_r), __fmul_rn(xi, ph_i));
            float ci = __fadd_rn(__fmul_rn(xr, ph_i), __fmul_rn(xi, ph_r));
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
              for (int v = 0; v < DEPTH - 1; ++v) {
                rr[m][v] = rr[m][v + 1];
                ri[m][v] = ri[m][v + 1];
              }
              rr[m][DEPTH - 1] = __fadd_rn(cr, __fmul_rn(a[m], nr));
              ri[m][DEPTH - 1] = __fadd_rn(ci, __fmul_rn(a[m], ni));
              cr = nr;
              ci = ni;
            }
            y_r[k_ap * PAD + c * CHUNK + u] = cr;
            y_i[k_ap * PAD + c * CHUNK + u] = ci;
          }
        }
      }
    } else {
      // 1b. the power per parameter band, a lane per slot (a stride of nb
      // words between lanes, odd: no bank conflicts), over this warp's run
      // of the plan, 8 entries loaded at a time; the first member starts
      // from 0 (0 + e = e exactly)
      const float* xr = cur + lane * nb;
      const float* xi = xr + plane;
      const int lo = range[sum_rank], hi = range[sum_rank + 1];
      float acc = 0.0f;
      for (int i0 = lo; i0 < hi; i0 += CHUNK) {
        int code[CHUNK];
        float er[CHUNK], ei[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) code[u] = plan[min(i0 + u, hi - 1)];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          er[u] = xr[code[u] & 0xff];
          ei[u] = xi[code[u] & 0xff];
        }
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          const bool valid = i0 + u < hi;
          const float e = __fadd_rn(__fmul_rn(er[u], er[u]),
                                    __fmul_rn(ei[u], ei[u]));
          const float sum = __fadd_rn(code[u] & FIRST ? 0.0f : acc, e);
          acc = valid ? sum : acc;
          if (valid && (code[u] & LAST))
            pw[((code[u] >> 8) & 0xff) * PAD + lane] = acc;
        }
      }
      sync_sums(32 * sum_warps);
      // 1c. the detector's recurrences over the 32 slots, unrolled, its
      // powers loaded first; the quotients come after, in parallel
      if (is_det) {
        float x[SLOTS];
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) x[j] = pw[tid * PAD + j];
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) {
          const float v = x[j];
          peak = fmaxf(__fmul_rn(C_PEAK, peak), v);
          psm = __fadd_rn(psm, __fmul_rn(0.25f, __fsub_rn(v, psm)));
          pdf = __fadd_rn(pdf, __fmul_rn(0.25f,
                                         __fsub_rn(__fsub_rn(peak, v), pdf)));
          psm_s[tid * PAD + j] = psm;
          den_s[tid * PAD + j] = __fmul_rn(1.5f, pdf);
        }
      }
    }
    __syncthreads();

    // 2. the gains g = 1.5 pdf > psm ? psm / (1.5 pdf) : 1, into the
    // power's rows, a lane per slot, 4 loaded at a time
    for (int i0 = tid; i0 < npar * SLOTS; i0 += 4 * blockDim.x) {
      float den[4], sm[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = min(i0 + u * static_cast<int>(blockDim.x),
                          npar * SLOTS - 1);
        den[u] = den_s[(i >> 5) * PAD + (i & 31)];
        sm[u] = psm_s[(i >> 5) * PAD + (i & 31)];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * static_cast<int>(blockDim.x);
        const float q = __fdiv_rn(sm[u], den[u] > 0.0f ? den[u] : 1.0f);
        if (i < npar * SLOTS)
          pw[(i >> 5) * PAD + (i & 31)] = den[u] > sm[u] ? q : 1.0f;
      }
    }
    __syncthreads();

    // 3. d for the tile, a warp per slot row and a lane per band, into
    // the stage of tile t - 1 (rows j of d over rows j of s): its rows
    // 0..17 are never read in tile t, its rows 18..31 only for d's slots
    // 0..13, so slots 0..15 go first.  A warp loads all of its rows of a
    // half before it stores any (a store to shared memory holds back the
    // loads behind it).
    auto d_rows = [&](int j0) {
      float vr[ROWS][MAX_NB / 32], vi[ROWS][MAX_NB / 32];
      float g[ROWS][MAX_NB / 32];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int j = min(j0 + warp + i * n_warps, j0 + HALF - 1);
#pragma unroll
        for (int r = 0; r < MAX_NB / 32; ++r) {
          const int at = j - lag[r];
          const float* src =
              lag[r] == 0 ? y_r + band[r] * PAD + j
                          : (at >= 0 ? cur + at * nb
                                     : prev + (SLOTS + at) * nb) + band[r];
          vr[i][r] = src[0];
          vi[i][r] = src[lag[r] == 0 ? nap * PAD : plane];
          g[i][r] = pw[gain_at[r] + j];
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int j = j0 + warp + i * n_warps;
#pragma unroll
        for (int r = 0; r < MAX_NB / 32; ++r) {
          if (j < j0 + HALF && lane + 32 * r < nb) {
            prev[j * nb + band[r]] = __fmul_rn(vr[i][r], g[i][r]);
            prev[plane + j * nb + band[r]] = __fmul_rn(vi[i][r], g[i][r]);
          }
        }
      }
    };
    d_rows(0);
    // generic accesses to the stages before the bulk copies that read and
    // write them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    // thread 0: d leaves as bulk copies, rows 0..15 now and rows 16..31
    // after them; once they have read the stage, it takes tile
    // t + STAGES - 1
    const size_t out = row + static_cast<size_t>(t) * plane;
    if (tid == 0)
      store_rows(d_r + out, d_i + out, prev, plane, HALF * nb);
    d_rows(HALF);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      store_rows(d_r + out + HALF * nb, d_i + out + HALF * nb,
                 prev + HALF * nb, plane, HALF * nb);
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      const int next = t + STAGES - 1;
      if (next < ntiles)
        load_tile(full + next % STAGES, prev, s_r + row + next * plane,
                  s_i + row + next * plane, plane);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

  // the new state
  {
    const float* last = ring + ((ntiles - 1) % STAGES) * 2 * plane;
    const size_t at = static_cast<size_t>(b) * nb * HIST;
    for (int i = tid; i < nb * HIST; i += blockDim.x) {
      const int k = i / HIST, j = i - k * HIST;
      delay_r_out[at + i] = last[(SLOTS - HIST + j) * nb + k];
      delay_i_out[at + i] = last[plane + (SLOTS - HIST + j) * nb + k];
    }
  }
  if (is_det) {
    const size_t at = static_cast<size_t>(b) * npar + tid;
    peak_out[at] = peak;
    psm_out[at] = psm;
    pdf_out[at] = pdf;
  }
  if (is_ap) {
#pragma unroll
    for (int m = 0; m < LINKS; ++m) {
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        ap_r_out[ap_at + m * DEPTH + j] = rr[m][j];
        ap_i_out[ap_at + m * DEPTH + j] = ri[m][j];
      }
    }
  }
}

int warps_for(int npar, int nap) {
  return (npar + 31) / 32 + (nap + 31) / 32 + SPARE_WARPS;
}

size_t smem_bytes(int nb, int npar, int nap) {
  return BARRIER_BYTES +
         sizeof(float) * (static_cast<size_t>(STAGES) * 2 * SLOTS * nb +
                          2 * static_cast<size_t>(nap) * PAD +
                          3 * static_cast<size_t>(npar) * PAD) +
         sizeof(int) * (static_cast<size_t>(nb) + npar + MAX_THREADS / 32 + 1);
}

}  // namespace

// s_r, s_i, d_r, d_i f32 [B][S][nb], 16-byte aligned, S a multiple of 32;
// delay_r, delay_i (in and out) f32 [B][nb][14]; ap_r, ap_i (in and out) f32
// [B][nap][3][5]; peak, psmooth, pdiff (in and out) f32 [B][npar]; phi_r,
// phi_i f32 [nap]; qf_r, qf_i, ag f32 [nap][3]; k_to_i int32 [nb]; members
// int32 [npar][M], each row the bands of a parameter band in ascending
// order, padded with nb.  Outputs are separate buffers from the inputs.
// Returns the CUDA error of the launch, 0 for none.
extern "C" int aacjax_ps_decorrelate(
    const void* s_r, const void* s_i, const void* delay_r,
    const void* delay_i, const void* ap_r, const void* ap_i,
    const void* peak, const void* psm, const void* pdf, const void* phi_r,
    const void* phi_i, const void* qf_r, const void* qf_i, const void* ag,
    const void* k_to_i, const void* members, void* d_r, void* d_i,
    void* delay_r_out, void* delay_i_out, void* ap_r_out, void* ap_i_out,
    void* peak_out, void* psm_out, void* pdf_out, int B, int S, int nb,
    int npar, int nap, int sdb, int M, void* stream) {
  if (B < 1 || S < SLOTS || S % SLOTS || nb < 1 || nb > MAX_NB || npar < 1 ||
      npar > 255 || nap < 1 || M < 1 || nap > sdb || sdb > nb ||
      32 * warps_for(npar, nap) > MAX_THREADS ||
      warps_for(npar, nap) * ROWS < HALF)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(nb, npar, nap);
  // the dynamic shared memory allowed, per device: the attribute belongs to
  // the current device's instance of the kernel
  static size_t opted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > opted[dev]) {
    err = cudaFuncSetAttribute(ps_decorrelate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = bytes;
  }
  ps_decorrelate_kernel<<<B, 32 * warps_for(npar, nap), bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s_r), static_cast<const float*>(s_i),
      static_cast<const float*>(delay_r), static_cast<const float*>(delay_i),
      static_cast<const float*>(ap_r), static_cast<const float*>(ap_i),
      static_cast<const float*>(peak), static_cast<const float*>(psm),
      static_cast<const float*>(pdf), static_cast<const float*>(phi_r),
      static_cast<const float*>(phi_i), static_cast<const float*>(qf_r),
      static_cast<const float*>(qf_i), static_cast<const float*>(ag),
      static_cast<const int*>(k_to_i), static_cast<const int*>(members),
      static_cast<float*>(d_r), static_cast<float*>(d_i),
      static_cast<float*>(delay_r_out), static_cast<float*>(delay_i_out),
      static_cast<float*>(ap_r_out), static_cast<float*>(ap_i_out),
      static_cast<float*>(peak_out), static_cast<float*>(psm_out),
      static_cast<float*>(pdf_out), S, nb, npar, nap, sdb, M);
  return static_cast<int>(cudaGetLastError());
}
