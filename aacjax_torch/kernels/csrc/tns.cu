// TNS: the all-pole filter along the spectral bins, in compensated
// float-float arithmetic.
//
// Replaces aacjax/kernels/pipeline.py tns / _tns_directional_scan (an XLA
// lax.scan of 1024 steps on the TPU; there is no Pallas kernel for it).
// Per filter: y[n] = x[n] - sum_i lpc[i] * y[n-1-i] over the filter's bins
// [start, end), order <= 20, taps that reach before `start` left out, up to
// 8 filters per row and direction.  A reverse filter runs on the flipped
// spectrum with the host-transformed range (start' = F - end; F bins a row,
// 1024, 960, 512 or 480).  Every
// filter reads the INPUT spectrum; a forward filter's bins take the forward
// result, a reverse filter's bins the reverse result (it wins where both
// claim a bin, as in the reference), every other bin passes through.  The
// filters of one direction are disjoint, as the parser writes them and the
// reference requires.  The kernels are compiled twice: with F = 1024 a
// constant (the serving path, whose times PERF.md keeps) and with F read at
// run time for the frame lengths 960, 512 and 480.
//
// The recursion state is an unevaluated f32 hi + lo pair, the sums Knuth's
// TwoSum in __fadd_rn / __fsub_rn (nvcc would otherwise contract a*b+c).
// The exact product a*b = p + e is p = __fmul_rn(a, b), e = __fmaf_rn(a, b,
// -p): the error of an f32 product is an f32 unless it underflows, and the
// reference's mask-split TwoProd computes that same error in 14 operations
// (tests/test_torch_tns.py holds the two forms equal on 10^6 pairs; they
// part only where the error term is denormal, below 2^-126 of anything the
// tolerance sees).  So the kernel rounds as the plain version rounds, step
// for step, and the two agree bit for bit up to the sign of a zero.
//
// What bounds it on the H100: FP32 operations issued, not bytes (a row is
// 4 KB).  One filter is a serial chain over its bins -- per bin the `order`
// dependent additions of the running sum, two of its error term per tap,
// and three closing TwoSums -- at 12 FP32 operations per tap, and one warp
// issues at most one operation a cycle.  With few rows the time is one
// warp's stream over its longest filter (about 0.85 operations a cycle,
// measured); with a serving chunk's 16384 rows it is the FP32 issue rate of
// the card (about 0.7 a cycle and scheduler, measured).  A thread walks its
// own row, so a warp's loads and stores are fully divergent (32 lines a
// request): one bin at a time they, and not the arithmetic, set the time of
// a bin, which is why x is read and y written 4 bins at a time.
//
// Design: do only the work the filters ask for.
//   tns_prepare_kernel  writes the pass-through for every bin (a 16-byte
//     vectorised copy, or the decompression of compact int16 spectra, the
//     same product as decompress_i16) and plans: one lane per (row,
//     direction, slot) finds the filters with start < end and a non-zero
//     tap, their order (last non-zero tap + 1), and appends each to one
//     of 32 work lists, by order class (<= 4, 8, 12, 20) and by length
//     (in steps of 128 bins), with one atomicAdd per warp and list.
//     No host synchronisation: the filter kernel reads the counts on the
//     device.
//   tns_filter_kernel  one thread per work item; a warp takes items of one
//     list, so its lanes run filters of like cost (a warp lasts as long as
//     its longest item), and run_item<K> keeps the K taps and the history
//     of K (hi, lo) pairs in registers.  The warps share out all the lists
//     in one launch (the heaviest list first), `lanes` items to a warp: as
//     many as it takes to give every scheduler of the card one warp, 32
//     when the lists are long.  An item
//     walks only the aligned groups of 4 bins that hold [start, end): one
//     16-byte load a group (the next group's issued before this group's
//     arithmetic), four unrolled steps with static history indices and one
//     shift, one 16-byte store where the item owns the whole group.  The
//     history starts at zero and bins before `start` enter as zero, which
//     is what leaving out the taps that reach before `start` computes.  A
//     forward item looks up the reverse ranges only where ownership can
//     change (at its start and at each boundary after it).
//   The filter kernel runs after the pass-through on the same stream and
//   overwrites the bins it owns, reading x from the input, so the order of
//   the work lists (which varies from run to run) never shows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_F = 1024;         // the frame length F is 1024, 960, 512 or 480
constexpr int SLOTS = 8;
constexpr int ORDER = 20;
constexpr int BLOCK_BINS = 16;      // bins per scale of the compact spectra
constexpr int GROUP = 4;            // bins between two shifts of the history
constexpr int PREP_ROWS = 2;        // rows per block of the prepare kernel
constexpr int PREP_THREADS = 128 * PREP_ROWS;
constexpr int LEN_BUCKETS = 8;      // work lists per order class, by length
constexpr int N_LISTS = 4 * LEN_BUCKETS;
constexpr int WARPS_PER_SM = 16;    // filter warps in flight per SM
constexpr int SCHEDULERS_PER_SM = 4;

// The filter planes as either wrapper has them: per direction a pointer to
// the taps [rows][8][20] and to start and end [rows][8], with the strides
// (in elements) that reach the next row and the next slot.
struct Planes {
  const float* lpc_f;
  const float* lpc_r;
  const int* start_f;
  const int* end_f;
  const int* start_r;
  const int* end_r;
  int lpc_row, rng_row, rng_slot;
  int frame;    // bins per row (F)
};

// a + b = s + e exactly
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// c * (h_hi + h_lo) = p + e, with p = fl(c * h_hi) and e as the reference
// rounds it: the exact error of p, plus the separately rounded c * h_lo
__device__ __forceinline__ void tap_prod(float c, float h_hi, float h_lo,
                                         float& p, float& e) {
  p = __fmul_rn(c, h_hi);
  e = __fadd_rn(__fmaf_rn(c, h_hi, -p), __fmul_rn(c, h_lo));
}

// The four bins of aligned group g of a row, decompressed where compact.
template <bool I16>
__device__ __forceinline__ float4 load_group(const void* x, const float* scale,
                                             int F, long row, int g) {
  if (I16) {
    const short4 q = __ldg(
        reinterpret_cast<const short4*>(static_cast<const int16_t*>(x) + row * F) + g);
    const float s = __ldg(scale + row * (F / BLOCK_BINS) + g / (BLOCK_BINS / GROUP));
    return make_float4(__fmul_rn(static_cast<float>(q.x), s),
                       __fmul_rn(static_cast<float>(q.y), s),
                       __fmul_rn(static_cast<float>(q.z), s),
                       __fmul_rn(static_cast<float>(q.w), s));
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(x) + row * F) + g);
}

// Whether forward bin n belongs to the forward filters (no reverse range
// covers it), and the next bin at which that can change.  Returns the next
// bin, complemented (negative) when bin n is not owned.  rs / re point at
// the row's reverse start / end, in flipped coordinates.
template <int FT>
__device__ __noinline__ int forward_ownership(const int* rs, const int* re,
                                              int slot_stride, int frame, int n) {
  const int F = FT ? FT : frame;
  bool own = true;
  int next = F;
  for (int s = 0; s < SLOTS; ++s) {
    const int lo = F - re[s * slot_stride], hi = F - rs[s * slot_stride];
    if (lo >= hi) continue;
    if (lo <= n && n < hi) own = false;
    if (lo > n && lo < next) next = lo;
    if (hi > n && hi < next) next = hi;
  }
  return own ? next : ~next;
}

// One work item: filter `slot` of direction `rev` of `row`, order <= K.
template <int K, int FT, bool I16>
__device__ __forceinline__ void run_item(const void* x, const float* scale,
                                         const Planes& pl, int item,
                                         float* out) {
  const int F = FT ? FT : pl.frame;
  const long row = item >> 4;
  const bool rev = (item >> 3) & 1;
  const int slot = item & 7;
  const long ro = row * pl.rng_row + slot * pl.rng_slot;
  const int start = max((rev ? pl.start_r : pl.start_f)[ro], 0);
  const int end = min((rev ? pl.end_r : pl.end_f)[ro], F);
  const float* lp = (rev ? pl.lpc_r : pl.lpc_f) + row * pl.lpc_row + slot * ORDER;
  float c[K], hh[K + GROUP], hl[K + GROUP];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    c[i] = __ldg(lp + i);
    hh[i] = hl[i] = 0.f;
  }
  const int* rs = pl.start_r + row * pl.rng_row;
  const int* re = pl.end_r + row * pl.rng_row;
  bool own = true;
  int next = F;               // the bin at which `own` is looked up again
  if (!rev) {
    const int r = forward_ownership<FT>(rs, re, pl.rng_slot, F, start);
    own = r >= 0;
    next = own ? r : ~r;
  }
  float* yr = out + row * F;

  // Bins n count along the walk (the flipped spectrum for a reverse item);
  // walk group G is memory group G, or F / 4 - 1 - G with its bins turned.
  const int g_last = (end - 1) / GROUP;
  float4 cur = load_group<I16>(x, scale, F, row,
                               rev ? F / GROUP - 1 - start / GROUP : start / GROUP);
  for (int G = start / GROUP; G <= g_last; ++G) {
    const int g = rev ? F / GROUP - 1 - G : G;
    const int g_next = G < g_last ? (rev ? g - 1 : g + 1) : g;
    const float4 ahead = load_group<I16>(x, scale, F, row, g_next);
    const int n0 = G * GROUP;
    const float xs[GROUP] = {rev ? cur.w : cur.x, rev ? cur.z : cur.y,
                             rev ? cur.y : cur.z, rev ? cur.x : cur.w};
    // hh[K - 1] is y[n0 - 1], hh[0] is y[n0 - K]; bin n0 + j writes hh[K + j]
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const float xn = n0 + j >= start ? xs[j] : 0.f;
      float p, pe;
      tap_prod(c[0], hh[K - 1 + j], hl[K - 1 + j], p, pe);
      float s = -p, e = -pe;
#pragma unroll
      for (int i = 1; i < K; ++i) {
        tap_prod(c[i], hh[K - 1 + j - i], hl[K - 1 + j - i], p, pe);
        float s2, e2;
        two_sum(s, -p, s2, e2);
        s = s2;
        e = __fsub_rn(__fadd_rn(e, e2), pe);
      }
      float y_hi, y_lo, e2;
      two_sum(xn, s, y_hi, e2);
      y_lo = __fadd_rn(e, e2);
      two_sum(y_hi, y_lo, hh[K + j], hl[K + j]);
    }
    if (n0 >= start && n0 + GROUP <= end && next >= n0 + GROUP) {
      if (own)
        reinterpret_cast<float4*>(yr)[g] =
            rev ? make_float4(hh[K + 3], hh[K + 2], hh[K + 1], hh[K])
                : make_float4(hh[K], hh[K + 1], hh[K + 2], hh[K + 3]);
    } else {
      // an edge of the filter, or a reverse boundary, inside the group
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const int n = n0 + j;
        if (n == next) {
          const int r = forward_ownership<FT>(rs, re, pl.rng_slot, F, n);
          own = r >= 0;
          next = own ? r : ~r;
        }
        if (own && n >= start && n < end) yr[rev ? F - 1 - n : n] = hh[K + j];
      }
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      hh[i] = hh[i + GROUP];
      hl[i] = hl[i + GROUP];
    }
    cur = ahead;
  }
}

// All the work lists in one launch.  A warp takes `lanes` consecutive
// items of one list at a time (the loads of the heaviest list first), warp
// after warp; `lanes` grows from 1 to 32 with the number of items so that
// `target_warps` warps have work before any takes a second load.
template <int FT, bool I16>
__global__ void __launch_bounds__(32) tns_filter_kernel(
    const void* __restrict__ x, const float* __restrict__ scale, Planes pl,
    const int* __restrict__ items, const int* __restrict__ counts, int cap,
    int target_warps, float* __restrict__ out) {
  __shared__ int count[N_LISTS];
  const int lane = threadIdx.x;
  for (int l = lane; l < N_LISTS; l += 32) count[l] = counts[l];
  __syncwarp();
  int total = 0;
  for (int l = 0; l < N_LISTS; ++l) total += count[l];
  const int lanes = min(32, max(1, (total + target_warps - 1) / target_warps));
  int all_loads = 0;
  for (int l = 0; l < N_LISTS; ++l) all_loads += (count[l] + lanes - 1) / lanes;
  for (int v = blockIdx.x; v < all_loads; v += gridDim.x) {
    int l = N_LISTS - 1, r = v;       // load r of list l, the heaviest first
    for (int loads; r >= (loads = (count[l] + lanes - 1) / lanes); --l) r -= loads;
    const int it = r * lanes + lane;
    if (lane >= lanes || it >= count[l]) continue;
    const int item = items[static_cast<long>(l) * cap + it];
    switch (l / LEN_BUCKETS) {
      case 0: run_item<4, FT, I16>(x, scale, pl, item, out); break;
      case 1: run_item<8, FT, I16>(x, scale, pl, item, out); break;
      case 2: run_item<12, FT, I16>(x, scale, pl, item, out); break;
      default: run_item<20, FT, I16>(x, scale, pl, item, out); break;
    }
  }
}

// The pass-through of every bin, and the work lists.  items holds N_LISTS
// lists of `cap` entries, (row << 4) | (direction << 3) | slot; list
// 8 * (order class) + (length - 1) / 128; counts [N_LISTS] starts at zero.
template <int FT, bool I16>
__global__ void __launch_bounds__(PREP_THREADS) tns_prepare_kernel(
    const void* __restrict__ x, const float* __restrict__ scale, Planes pl,
    float* __restrict__ out, int* __restrict__ items, int* __restrict__ counts,
    int rows, int cap) {
  const int F = FT ? FT : pl.frame;
  const int tid = threadIdx.x;
  const long row = static_cast<long>(blockIdx.x) * PREP_ROWS + tid / 128;
  const int t = tid % 128;
  if (row < rows) {
    float4* o = reinterpret_cast<float4*>(out + row * F);
    if (I16) {
      const short4* q = reinterpret_cast<const short4*>(
          static_cast<const int16_t*>(x) + row * F);
      const float* sc = scale + row * (F / BLOCK_BINS);
      for (int v = t; v < F / 4; v += 128) {  // bins 4 v .. 4 v + 3
        const short4 a = __ldg(q + v);
        const float s = __ldg(sc + v / (BLOCK_BINS / 4));
        o[v] = make_float4(__fmul_rn(static_cast<float>(a.x), s),
                           __fmul_rn(static_cast<float>(a.y), s),
                           __fmul_rn(static_cast<float>(a.z), s),
                           __fmul_rn(static_cast<float>(a.w), s));
      }
    } else {
      const float4* xi = reinterpret_cast<const float4*>(
          static_cast<const float*>(x) + row * F);
      for (int v = t; v < F / 4; v += 128) o[v] = __ldg(xi + v);
    }
  }
  if (tid >= 32) return;

  // the plan: warp 0, one lane per (row, direction, slot) of the block's rows
  const long prow = static_cast<long>(blockIdx.x) * PREP_ROWS + tid / 16;
  const bool rev = (tid >> 3) & 1;
  const int slot = tid & 7;
  int order = 0, length = 0;
  if (prow < rows) {
    const long ro = prow * pl.rng_row + slot * pl.rng_slot;
    const int start = max((rev ? pl.start_r : pl.start_f)[ro], 0);
    const int end = min((rev ? pl.end_r : pl.end_f)[ro], F);
    if (start < end) {
      length = end - start;
      const float* lp =
          (rev ? pl.lpc_r : pl.lpc_f) + prow * pl.lpc_row + slot * ORDER;
      for (int i = 0; i < ORDER; ++i)
        if (__ldg(lp + i) != 0.f) order = i + 1;
    }
  }
  const int cls = order <= 4 ? 0 : order <= 8 ? 1 : order <= 12 ? 2 : 3;
  const int list =
      order > 0 ? cls * LEN_BUCKETS + (length - 1) / (MAX_F / LEN_BUCKETS) : -1;
  // the lanes with the same list append together
  const unsigned m = __match_any_sync(0xffffffffu, list);
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (list >= 0 && tid == leader) base = atomicAdd(counts + list, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (list >= 0)
    items[static_cast<long>(list) * cap + base + __popc(m & ((1u << tid) - 1u))] =
        static_cast<int>(prow << 4) | (rev << 3) | slot;
}

template <int FT, bool I16>
int launch_all(const void* x, const float* scale, const Planes& pl, float* out,
               int* items, int* counts, int rows, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cap = rows * 2 * SLOTS;
  tns_prepare_kernel<FT, I16>
      <<<(rows + PREP_ROWS - 1) / PREP_ROWS, PREP_THREADS, 0, stream>>>(
          x, scale, pl, out, items, counts, rows, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough warps for long lists to keep every scheduler busy, never more
  // than there can be items
  const int blocks = cap < sms * WARPS_PER_SM ? cap : sms * WARPS_PER_SM;
  tns_filter_kernel<FT, I16><<<blocks, 32, 0, stream>>>(
      x, scale, pl, items, counts, cap, sms * SCHEDULERS_PER_SM, out);
  err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// x is f32 [rows][frame] (x_i16 = 0, scale unused) or int16 [rows][frame]
// with scale f32 [rows][frame / 16]; frame is a multiple of 16, at most 1024
// (the frame lengths 1024, 960, 512, 480).  items is int32 [32][16 * rows] scratch, counts int32
// [32] zeroed by the caller on the same stream.  Returns the first CUDA
// error of its launches, 0 for none.
extern "C" int aacjax_tns(const void* x, const void* scale, int x_i16,
                          const void* lpc_f, const void* lpc_r, int lpc_row,
                          const void* start_f, const void* end_f,
                          const void* start_r, const void* end_r, int rng_row,
                          int rng_slot, void* out, void* items, void* counts,
                          int rows, int frame, void* stream) {
  if (rows < 1 || rows > (1 << 26) || frame < BLOCK_BINS || frame > MAX_F ||
      frame % BLOCK_BINS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes pl = {static_cast<const float*>(lpc_f),
                     static_cast<const float*>(lpc_r),
                     static_cast<const int*>(start_f),
                     static_cast<const int*>(end_f),
                     static_cast<const int*>(start_r),
                     static_cast<const int*>(end_r),
                     lpc_row, rng_row, rng_slot, frame};
  const float* sc = static_cast<const float*>(scale);
  float* y = static_cast<float*>(out);
  int* list = static_cast<int*>(items);
  int* cnt = static_cast<int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 1024 bins a row, the serving path, is compiled with F a constant; the
  // other frame lengths share one version that reads F from `pl`
  if (frame == MAX_F)
    return x_i16 ? launch_all<MAX_F, true>(x, sc, pl, y, list, cnt, rows, st)
                 : launch_all<MAX_F, false>(x, sc, pl, y, list, cnt, rows, st);
  return x_i16 ? launch_all<0, true>(x, sc, pl, y, list, cnt, rows, st)
               : launch_all<0, false>(x, sc, pl, y, list, cnt, rows, st);
}
