// Per-tile front-to-back Gaussian alpha blend for Hopper (sm_90a): forward
// and backward, one CUDA launch each per call.
//
// Replaces the Pallas kernels of manigaussian_tpu/ops/pallas_blend.py:
//   * `_fwd_kernel` (pallas_call in `_blend_fwd`, pallas_blend.py:317): per
//     16×16 tile, blend the tile's depth-sorted splat list into color
//     [3, 256], features [F, 256] and the final log transmittance [1, 256];
//   * `_bwd_kernel` (pallas_call in `_blend_bwd`, pallas_blend.py:339): the
//     gradient of those outputs with respect to the packed per-splat
//     attributes [C, K].
// Inputs per tile t: counts[t] (live splats), the tile's pixel origin, attrs
// [T, C, K] fp32 packed channel-first (rows: xy 2, conic 3, opacity 1, rgb
// 3, features F = 3), livet [T, 1, K] (1 = live slot).
//
// Semantics (the TPU kernel's, after forward.cu:262-398 of the reference
// CUDA rasterizer): power from the tile-local monomials
// (1, px, py, px², px·py, py²) · coeff; skip where power > 0 or alpha <
// 1/255; alpha clamped at 0.99; the latch where T·(1-a) < 1e-4, the splat
// that trips it not contributing; slots walked up to n_end = count rounded
// up to `chunk` (at most K), live ones only. The backward uses the suffix-sum
// identity dL/da_i = T_i·g_i − (S_i + dL/dlogT)/(1−a_i), S_i = Σ_{j>i} w_j·g_j,
// gated like the JAX VJP: zero gradient at the 0.99 clamp, for skipped
// splats and for latched pixels. No float atomics: each [T, C, K] slot is
// written by one CTA, so both kernels are bitwise repeatable.
//
// What bounds it on this card. The work is elementwise fp32 per (splat,
// pixel) pair with contractions of depth 6, so the tensor cores are not its
// resource. An exact kernel evaluates only the pairs that lie inside a
// splat's pixel box (below) and come no later than the pixel's latch: ≈ 15
// fp32 instructions a pair in the forward and ≈ 33 in the backward, one exp
// a pair that is active (an exp and a reciprocal in the backward) on the
// special-function units, and a per-splat cost to load and box each live
// slot; the pairs outside a box cost nothing per pair. At the training frame
// (64 tiles, K 2048, 16.3 M live pairs up to n_end, 1.0 M of them active)
// that work takes less time than reading the inputs and writing the outputs
// once, so the bound is the bytes; what the kernels pay above it is latency:
// each pixel's running product along its list, and each CTA's prologue
// (loading and boxing its slots, the lists, the cluster barriers). A kernel
// with one CTA per tile fills 64 of the 132 SMs with 8 warps each and walks
// 1,096 slots a pixel serially; a full-precision exp and log1p a pair, a
// backward that replays the list twice and 65 shuffles a (splat, warp) for
// the per-splat sums are what the first port of the TPU kernel paid.
//
// Design:
//   * Segments (both kernels). A pixel's raw T only falls along its list, so
//     where it latches depends only on the product of (1 − a) before it: a
//     segment of the list can be walked exactly once its start T is known.
//     Each tile's n_end slots are cut into kSeg = 8 equal segments (length
//     ⌈n_end / 8⌉ rounded up to 32; `segment_bounds` in ops/blend.py), one
//     CTA each: 8·T CTAs (512 at batch 1).
//   * Forward: one thread-block cluster of 8 CTAs per tile. Sweep A: each
//     segment's per-pixel Π(1 − a), with no latch and no accumulators (not
//     for the last segment, whose product nothing reads; a warp stops once
//     all its pixels' products are under 1e-4: each latches inside this
//     segment whatever its start, and every later segment starts latched,
//     whatever the product's exact value). The 256 products are exchanged
//     through distributed shared memory behind a cluster barrier; each
//     segment takes the product of the ones before it, in segment order, as
//     its start T. Sweep B walks the segment from its start T under the
//     latch rule and accumulates its partial color, features and T. After a
//     second barrier each CTA combines the partials of 32 pixels in
//     segment order: the outputs, and the state the backward starts each
//     segment from ([T, 8, 7, 256]: start T, the color and feature sums
//     before the segment). log T is the log of the T where the pixel
//     stopped, taken once a pixel. A CTA whose pixels all start latched
//     skips sweep B.
//   * Backward, one sweep, no cluster: a pixel's total Σ w·g is
//     gcolor·color + glang·lang from the forward's outputs, and a segment's
//     prefix starts from gcolor·(color before it) + glang·(features before
//     it), so each segment walks once from the saved state; a CTA stops at
//     the first batch where all its pixels are latched.
//   * Fewer instructions a pair: log2 e folded into the six power
//     coefficients (g is one ex2.approx); T a running product, with one log a
//     pixel; a splat's coefficients, opacity, colors and features read as
//     four 16-byte broadcasts from shared memory; a thread takes kP = 2
//     pixels of one column (of 1, 2, 4 and 8, 2 was the fastest on the card
//     in both kernels: PERF.md), so the x part of the power (c0 + c1·px +
//     c3·px², c2 + c4·px) is computed once for its 2 pixels and each pixel
//     costs two FMAs; a warp evaluates 4 splats at once in both kernels,
//     their pairs independent, before the running products take them in
//     order.
//   * Dead pairs skipped exactly. A batch of slots (256 in the forward, 64 in
//     the backward, whose per-splat sums take shared memory) is loaded by
//     the slots' owner threads, which compute once per splat a conservative
//     box of tile pixels where alpha ≥ 1/255 can hold: the conic's half
//     extents √(τ·c / det) and √(τ·a / det), τ = 2·(ln(255·opacity) +
//     slack), slack bounding the rounding of the power at any pixel, times
//     1.001 plus one pixel of margin (`splat_box` in ops/blend.py mirrors
//     it). A conic that is not safely positive definite gets the whole tile;
//     a non-live slot, opacity under 1/255 or a box outside the tile gets
//     none. Each warp owns an 8×8 rectangle of the tile (`warp_rects`) and
//     lists, by ballot, the batch's slots whose box meets it; it walks only
//     that list, padded with a record whose alpha is 0, with no branch a
//     splat. A skipped pair has a = 0, so it leaves T, the latch and every
//     output bit for bit unchanged.
//   * Per-splat sums without 65 shuffles a warp (backward): each thread sums
//     its own 2 pixels (the six monomial sums from three: Σd, Σd·py, Σd·py²
//     and its px), then the 4 splats' 13 values each, padded to 16, go
//     through one transpose-reduce across the lanes: 64 values in 62
//     shuffles (32 + 16 + 8 + 4 + 2) over five dependent levels, lane l
//     ending with values 2l and 2l + 1 of splat l / 8, each summed over the
//     warp; the warps that touched a splat leave their sums in shared memory
//     and the slot's owner thread adds them in warp order and applies the
//     closed forms for d{x, y, conic}. The order is fixed throughout.
//   * Copies: the thread that owns a slot reads its 13 values straight from
//     device memory (coalesced along the slot row) and writes the packed
//     record; a TMA box or cp.async would land the raw rows in shared memory
//     only for the same thread to read them back and transform, and a
//     segment's ≤ 13 KB is read once per sweep, so neither buys anything.
// Roundings against the TPU kernel's log-space sums: T is a running product
// T·(1 − a) (fmaf(-a, T, T)), not exp of Σ log1p(−a); a segment starts from
// the product of the segments' products, so the T where a pixel latches may
// differ from one long product by a few ulps (a pixel whose T sits on 1e-4
// may flip, as between the TPU's chunked sums and any other order); g is
// ex2.approx (2 ulp) of the log2 e-scaled power; in the backward the suffix
// total − prefix at a pixel's last contributor is no longer exactly 0 but
// within an ulp of the total, and 1/(1 − a) is a fast reciprocal. The
// golden rules hold these (outputs atol 1e-4 / rtol 1e-3, ≤ 0.5 % outside;
// gradients atol 2e-4 / rtol 1e-3, ≤ 2 % outside).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kF = 3;                 // feature rows the kernels take
constexpr int kBatch = 256;           // slots the forward holds in shared memory at once
constexpr int kBatchBwd = 64;         // and the backward (its per-splat sums take room)
constexpr int kSeg = 8;               // segments a tile: the forward's cluster (the portable size)
constexpr int kP = 2;                 // pixels a thread takes (one column, kP rows)
constexpr int kThreads = kPix / kP;   // threads a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kState = 7;             // saved per segment: start T, 3 color, 3 feature sums
constexpr int kNV = 13;               // per-splat sums: 6 monomials, opacity, 3 rgb, 3 features
constexpr int kUnrollFwd = 4;         // splats a warp evaluates together
constexpr int kUnrollBwd = 4;         // (its per-splat sums reduced together)
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kTEps = 1e-4f;
constexpr float kLog2e = 1.4426950408889634f;
// below this opacity alpha = op·g ≤ op < 1/255 everywhere (g ≤ 1)
constexpr float kOpMin = kAlphaMin * (1.0f - 1.0f / (1 << 20));
constexpr uint32_t kNoBox = 0xffu;    // the box of a slot that is not walked

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A slot of the batch: power coefficients in log2 units (power·log2 e =
// c0 + c1·px + c2·py + c3·px² + c4·px·py + c5·py²), opacity, the box of
// tile pixels where alpha ≥ 1/255 can hold (x0, x1, y0, y1 a byte each, low
// byte first; x0 = 255 for a slot that is not walked), rgb, features.
struct __align__(16) Rec {
  float4 pw;    // c0, c1, c2, c3
  float4 pq;    // c4, c5, opacity, box (as bits)
  float4 col;   // r, g, b, f0
  float4 col2;  // f1, f2, 0, 0
};

struct Seg {
  int lo, hi;  // slots [lo, hi) of the tile's list
  float ox, oy;
};

// Segment s of kSeg of tile t (ops/blend.py `segment_bounds` mirrors it).
__device__ __forceinline__ Seg segment(const int* counts, const float* origins,
                                       int t, int s, int k_cap, int chunk) {
  const int count = min(max(counts[t], 0), k_cap);
  const int n_end = min(k_cap, (count + chunk - 1) / chunk * chunk);
  const int len = ((n_end + kSeg - 1) / kSeg + 31) / 32 * 32;
  Seg sg;
  sg.lo = min(n_end, s * len);
  sg.hi = min(n_end, sg.lo + len);
  sg.ox = origins[2 * t];
  sg.oy = origins[2 * t + 1];
  return sg;
}

// The box of tile pixels where alpha ≥ 1/255 can hold for a splat at
// tile-local (xm, ym) with conic (ca, cb, cc), opacity op and natural-unit
// power coefficients c[6]; kNoBox where it holds nowhere in the tile
// (ops/blend.py `splat_box` mirrors it).
__device__ __forceinline__ uint32_t splat_box(float xm, float ym, float ca,
                                              float cb, float cc, float op,
                                              const float (&c)[6]) {
  constexpr uint32_t kFull = (15u << 8) | (15u << 24);
  if (!(op >= kOpMin)) return kNoBox;
  const float det = fmaf(ca, cc, -cb * cb);
  if (!(ca > 0.f && cc > 0.f && det > 1e-3f * ca * cc)) return kFull;
  // a bound on the rounding of the power at any pixel of the tile
  const float m = 0.5f * ca * xm * xm + 0.5f * cc * ym * ym
                  + fabsf(cb * xm * ym) + 15.f * (fabsf(c[1]) + fabsf(c[2]))
                  + 225.f * (fabsf(c[3]) + fabsf(c[4]) + fabsf(c[5]));
  const float tau = fmaxf(2.f * (logf(255.f * op) + 1e-5f + 2e-6f * m), 0.f);
  const float ry = sqrtf(tau * ca / det) * 1.001f + 1.f;
  const float rx = sqrtf(tau * cc / det) * 1.001f + 1.f;
  const float x0 = fmaxf(ceilf(xm - rx), 0.f), x1 = fminf(floorf(xm + rx), 15.f);
  const float y0 = fmaxf(ceilf(ym - ry), 0.f), y1 = fminf(floorf(ym + ry), 15.f);
  if (!(x0 <= x1 && y0 <= y1)) return kNoBox;
  return static_cast<uint32_t>(x0) | (static_cast<uint32_t>(x1) << 8)
         | (static_cast<uint32_t>(y0) << 16) | (static_cast<uint32_t>(y1) << 24);
}

// Slots [b0, end) (end ≤ b0 + kB) into rec[0 .. end - b0): the thread that
// owns a slot reads its attributes and writes its record (only the box,
// kNoBox, for a slot past the end, not live, or whose alpha reaches 1/255
// nowhere in the tile). Begins and ends with a barrier.
template <int kB>
__device__ __forceinline__ void pack(Rec* rec, const float* attrs_t,
                                     const float* livet_t, int k_cap, int b0,
                                     int end, float ox, float oy, int tid) {
  __syncthreads();
  for (int i = tid; i < kB; i += kThreads) {
    const int k = b0 + i;
    float4 pq = make_float4(0.f, 0.f, 0.f, __uint_as_float(kNoBox));
    if (k < end && livet_t[k] > 0.5f) {
      float v[9 + kF];
#pragma unroll
      for (int r = 0; r < 9 + kF; ++r) v[r] = attrs_t[static_cast<size_t>(r) * k_cap + k];
      const float xm = v[0] - ox, ym = v[1] - oy;
      const float ca = v[2], cb = v[3], cc = v[4], op = v[5];
      // power = -0.5a(xm-px)² - 0.5c(ym-py)² - b(xm-px)(ym-py)
      // (pallas_blend._splat_coeffs)
      const float c[6] = {-0.5f * ca * xm * xm - 0.5f * cc * ym * ym - cb * xm * ym,
                          ca * xm + cb * ym, cc * ym + cb * xm, -0.5f * ca, -cb,
                          -0.5f * cc};
      const uint32_t box = splat_box(xm, ym, ca, cb, cc, op, c);
      if ((box & 0xffu) != kNoBox) {
        rec[i].pw = make_float4(c[0] * kLog2e, c[1] * kLog2e, c[2] * kLog2e,
                                c[3] * kLog2e);
        rec[i].col = make_float4(v[6], v[7], v[8], v[9]);
        rec[i].col2 = make_float4(v[10], v[11], 0.f, 0.f);
        pq = make_float4(c[4] * kLog2e, c[5] * kLog2e, op, __uint_as_float(box));
      }
    }
    rec[i].pq = pq;
  }
  __syncthreads();
}

// A warp's rectangle of the tile and a thread's pixels in it: warps of
// 8×8 pixels tiling the tile row by row; lane l takes column l % 8 and kP
// rows from (l / 8)·kP (ops/blend.py `warp_rects` mirrors it).
struct Layout {
  static constexpr int kW = 8;
  static constexpr int kH = 32 * kP / kW;
  int x0, y0, px, row0;
  __device__ __forceinline__ Layout(int warp, int lane)
      : x0((warp % (kTile / kW)) * kW), y0((warp / (kTile / kW)) * kH),
        px(x0 + lane % kW), row0(y0 + (lane / kW) * kP) {}
  __device__ __forceinline__ int index(int i) const { return (row0 + i) * kTile + px; }
  __device__ __forceinline__ bool meets(uint32_t box) const {
    return static_cast<int>(box & 0xffu) < x0 + kW
           && static_cast<int>((box >> 8) & 0xffu) >= x0
           && static_cast<int>((box >> 16) & 0xffu) < y0 + kH
           && static_cast<int>(box >> 24) >= y0;
  }
};

// The warp's list of the batch's slots whose box meets its rectangle, in
// slot order, padded to a multiple of U with index kB (a record whose alpha
// is 0 everywhere). Returns its padded length.
template <int U, int kB>
__device__ __forceinline__ int warp_list(const Rec* rec, uint16_t* list,
                                         const Layout& lay, int nslots,
                                         int lane) {
  int n = 0;
  for (int c = 0; c < nslots; c += 32) {
    const int i = c + lane;
    const bool in = i < nslots && lay.meets(__float_as_uint(rec[i].pq.w));
    const uint32_t bits = __ballot_sync(0xffffffffu, in);
    if (in) list[n + __popc(bits & ((1u << lane) - 1u))] = static_cast<uint16_t>(i);
    n += __popc(bits);
  }
  const int padded = (n + U - 1) / U * U;
  if (lane < padded - n) list[n + lane] = kB;
  __syncwarp();
  return padded;
}

// The part of a splat's power that depends on the column alone, for a
// thread's kP pixels of one column.
struct Splat {
  float base, slope, c5, op;
};

__device__ __forceinline__ Splat splat_at(const Rec& r, float px) {
  const float4 pw = r.pw, pq = r.pq;
  Splat s;
  s.base = fmaf(fmaf(pw.w, px, pw.y), px, pw.x);  // c0 + c1·px + c3·px²
  s.slope = fmaf(pq.x, px, pw.z);                  // c2 + c4·px
  s.c5 = pq.y;
  s.op = pq.z;
  return s;
}

// One splat at a pixel of row py: the power (log2 units), g, the unclamped
// alpha and the effective alpha a (0 when skipped).
struct Pair {
  float p, g, alpha_un, a;
};

__device__ __forceinline__ Pair eval_pair(const Splat& s, float py) {
  Pair q;
  q.p = fmaf(fmaf(s.c5, py, s.slope), py, s.base);
  q.g = ex2(q.p);
  q.alpha_un = s.op * q.g;
  const float alpha = fminf(q.alpha_un, kAlphaMax);
  q.a = (q.p <= 0.f && alpha >= kAlphaMin) ? alpha : 0.f;
  return q;
}

__device__ __forceinline__ bool warp_done(const bool (&latched)[kP]) {
  bool done = true;
#pragma unroll
  for (int i = 0; i < kP; ++i) done = done && latched[i];
  return __all_sync(0xffffffffu, done);
}

// ----------------------------------------------------------------- forward
__global__ void __launch_bounds__(kThreads)
    blend_fwd_kernel(const int* __restrict__ counts,
                     const float* __restrict__ origins,
                     const float* __restrict__ attrs,
                     const float* __restrict__ livet,
                     float* __restrict__ color, float* __restrict__ lang,
                     float* __restrict__ logtf, float* __restrict__ state,
                     int k_cap, int chunk) {
  constexpr int U = kUnrollFwd;
  constexpr int C = 9 + kF;
  __shared__ Rec rec[kBatch + 1];
  __shared__ uint16_t lists[kWarps][kBatch + U];
  __shared__ float prod_sm[kPix];             // sweep A: Π(1 − a) a pixel
  __shared__ float part_sm[8][kPix];          // sweep B: 6 sums, T, latched
  cg::cluster_group cluster = cg::this_cluster();
  const int s = static_cast<int>(cluster.block_rank());
  const int t = blockIdx.x / kSeg;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Layout lay(warp, lane);
  const float pxf = static_cast<float>(lay.px);
  const Seg sg = segment(counts, origins, t, s, k_cap, chunk);
  const float* attrs_t = attrs + static_cast<size_t>(t) * C * k_cap;
  const float* livet_t = livet + static_cast<size_t>(t) * k_cap;
  uint16_t* list = lists[warp];
  if (tid == 0) {
    rec[kBatch].pw = rec[kBatch].col = rec[kBatch].col2 = make_float4(0.f, 0.f, 0.f, 0.f);
    rec[kBatch].pq = make_float4(0.f, 0.f, 0.f, __uint_as_float(kNoBox));
  }
  int packed = -1, nl = 0;   // the batch in shared memory, the warp's list length

  // sweep A (not for the last segment, whose product nothing reads)
  bool low[kP];
  float prod[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) prod[i] = 1.f;
  for (int b0 = sg.lo; b0 < sg.hi && s < kSeg - 1; b0 += kBatch) {
    const int nslots = min(sg.hi - b0, kBatch);
    pack<kBatch>(rec, attrs_t, livet_t, k_cap, b0, b0 + nslots, sg.ox, sg.oy, tid);
    nl = warp_list<U, kBatch>(rec, list, lay, nslots, lane);
    packed = b0;
    for (int j = 0; j < nl; j += U) {
      if ((j & 15) == 0) {
#pragma unroll
        for (int i = 0; i < kP; ++i) low[i] = prod[i] < kTEps;
        if (warp_done(low)) break;
      }
      Splat sp[U];
#pragma unroll
      for (int u = 0; u < U; ++u) sp[u] = splat_at(rec[list[j + u]], pxf);
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const float py = static_cast<float>(lay.row0 + i);
        float a[U];
#pragma unroll
        for (int u = 0; u < U; ++u) a[u] = eval_pair(sp[u], py).a;
#pragma unroll
        for (int u = 0; u < U; ++u) prod[i] = fmaf(-a[u], prod[i], prod[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kP; ++i) prod_sm[lay.index(i)] = prod[i];
  cluster.sync();

  // start T: the product of the earlier segments' products, in order
  float T[kP], acc[kP][3 + kF];
  bool latched[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) T[i] = 1.f;
  for (int r = 0; r < s; ++r) {
    const float* rp = cluster.map_shared_rank(&prod_sm[0], r);
#pragma unroll
    for (int i = 0; i < kP; ++i) T[i] *= rp[lay.index(i)];
  }
  float* state_s = state + (static_cast<size_t>(t) * kSeg + s) * kState * kPix;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    state_s[lay.index(i)] = T[i];
    latched[i] = T[i] < kTEps;
#pragma unroll
    for (int c = 0; c < 3 + kF; ++c) acc[i][c] = 0.f;
  }

  // sweep B
  bool all_latched = true;
#pragma unroll
  for (int i = 0; i < kP; ++i) all_latched = all_latched && latched[i];
  if (!__syncthreads_and(all_latched)) {
    for (int b0 = sg.lo; b0 < sg.hi; b0 += kBatch) {
      if (packed != b0) {
        const int nslots = min(sg.hi - b0, kBatch);
        pack<kBatch>(rec, attrs_t, livet_t, k_cap, b0, b0 + nslots, sg.ox, sg.oy, tid);
        nl = warp_list<U, kBatch>(rec, list, lay, nslots, lane);
        packed = b0;
      }
      for (int j = 0; j < nl; j += U) {
        if ((j & 15) == 0 && warp_done(latched)) break;
        Splat sp[U];
        float v[U][3 + kF];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const Rec& r = rec[list[j + u]];
          sp[u] = splat_at(r, pxf);
          const float4 col = r.col, col2 = r.col2;
          v[u][0] = col.x; v[u][1] = col.y; v[u][2] = col.z;
          v[u][3] = col.w; v[u][4] = col2.x; v[u][5] = col2.y;
        }
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          const float py = static_cast<float>(lay.row0 + i);
          float a[U];
#pragma unroll
          for (int u = 0; u < U; ++u) a[u] = eval_pair(sp[u], py).a;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float tn = fmaf(-a[u], T[i], T[i]);
            const bool trip = tn < kTEps;
            const bool contrib = !latched[i] && !trip;
            latched[i] = latched[i] || trip;
            const float w = contrib ? a[u] * T[i] : 0.f;
#pragma unroll
            for (int c = 0; c < 3 + kF; ++c) acc[i][c] = fmaf(w, v[u][c], acc[i][c]);
            T[i] = contrib ? tn : T[i];
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int p = lay.index(i);
#pragma unroll
    for (int c = 0; c < 3 + kF; ++c) part_sm[c][p] = acc[i][c];
    part_sm[6][p] = T[i];
    part_sm[7][p] = latched[i] ? 1.f : 0.f;
  }
  cluster.sync();

  // ordered combine of 256 / kSeg pixels: the outputs and each segment's
  // start sums; T where the pixel stopped (the first segment that latched,
  // else the last)
  constexpr int per = kPix / kSeg;
  for (int p = s * per + tid; p < (s + 1) * per; p += kThreads) {
    float run[3 + kF];
#pragma unroll
    for (int c = 0; c < 3 + kF; ++c) run[c] = 0.f;
    float t_end = 1.f;
    bool found = false;
    for (int r = 0; r < kSeg; ++r) {
      const float* rp = cluster.map_shared_rank(&part_sm[0][0], r);
      float* st = state + (static_cast<size_t>(t) * kSeg + r) * kState * kPix;
#pragma unroll
      for (int c = 0; c < 3 + kF; ++c) {
        st[(1 + c) * kPix + p] = run[c];
        run[c] += rp[c * kPix + p];
      }
      if (!found) {
        t_end = rp[6 * kPix + p];
        found = rp[7 * kPix + p] > 0.5f;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) color[(static_cast<size_t>(t) * 3 + c) * kPix + p] = run[c];
#pragma unroll
    for (int f = 0; f < kF; ++f) lang[(static_cast<size_t>(t) * kF + f) * kPix + p] = run[3 + f];
    logtf[static_cast<size_t>(t) * kPix + p] = logf(t_end);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// ---------------------------------------------------------------- backward
// One halving exchange of a transpose-reduce: a lane keeps the half of its
// H·2 values that its bit O selects and adds its partner's copy of that half.
template <int O, int H, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Sum each of N = 32·R values over the warp's 32 lanes: five halving
// exchanges (N/2 + N/4 + ... + N/32 shuffles, a dependent chain of five
// however many values) leave lane l with values R·l .. R·l + R − 1 in
// v[0 .. R), each summed over all 32 lanes. Fixed order.
template <int N>
__device__ __forceinline__ void transpose_reduce(float (&v)[N], int lane) {
  halve<16, N / 2>(v, lane);
  halve<8, N / 4>(v, lane);
  halve<4, N / 8>(v, lane);
  halve<2, N / 16>(v, lane);
  halve<1, N / 32>(v, lane);
}

constexpr size_t bwd_smem_bytes() {
  return sizeof(Rec) * (kBatchBwd + 1) + sizeof(float) * kWarps * kBatchBwd * kNV
         + sizeof(uint16_t) * kWarps * (kBatchBwd + kUnrollBwd) + kWarps * kBatchBwd;
}

__global__ void __launch_bounds__(kThreads)
    blend_bwd_kernel(const int* __restrict__ counts,
                     const float* __restrict__ origins,
                     const float* __restrict__ attrs,
                     const float* __restrict__ livet,
                     const float* __restrict__ color,
                     const float* __restrict__ lang,
                     const float* __restrict__ state,
                     const float* __restrict__ gcolor,
                     const float* __restrict__ glang,
                     const float* __restrict__ glogtf,
                     float* __restrict__ dattrs, int k_cap, int chunk) {
  constexpr int U = kUnrollBwd;
  constexpr int C = 9 + kF;
  static_assert(U == 4, "the reduction below hands lane l values 2l, 2l + 1 of splat l / 8");
  extern __shared__ __align__(16) unsigned char smem[];
  Rec* rec = reinterpret_cast<Rec*>(smem);
  float* red = reinterpret_cast<float*>(rec + kBatchBwd + 1);     // [kWarps][kBatchBwd][kNV]
  uint16_t* lists = reinterpret_cast<uint16_t*>(red + kWarps * kBatchBwd * kNV);
  unsigned char* hit = reinterpret_cast<unsigned char*>(lists + kWarps * (kBatchBwd + U));
  const int t = blockIdx.x / kSeg, s = blockIdx.x % kSeg;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Seg sg = segment(counts, origins, t, s, k_cap, chunk);
  if (sg.lo >= sg.hi) return;
  const Layout lay(warp, lane);
  const float pxf = static_cast<float>(lay.px);
  const float* attrs_t = attrs + static_cast<size_t>(t) * C * k_cap;
  const float* livet_t = livet + static_cast<size_t>(t) * k_cap;
  float* dattrs_t = dattrs + static_cast<size_t>(t) * C * k_cap;
  const float* state_s = state + (static_cast<size_t>(t) * kSeg + s) * kState * kPix;
  uint16_t* list = lists + warp * (kBatchBwd + U);

  float gv[kP][3 + kF], glt[kP], T[kP], prefix[kP], total[kP];
  bool latched[kP];
  bool all_latched = true;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int p = lay.index(i);
    T[i] = state_s[p];
    latched[i] = T[i] < kTEps;
    all_latched = all_latched && latched[i];
    prefix[i] = total[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gv[i][c] = gcolor[(static_cast<size_t>(t) * 3 + c) * kPix + p];
      prefix[i] = fmaf(gv[i][c], state_s[(1 + c) * kPix + p], prefix[i]);
      total[i] = fmaf(gv[i][c], color[(static_cast<size_t>(t) * 3 + c) * kPix + p], total[i]);
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      gv[i][3 + f] = glang[(static_cast<size_t>(t) * kF + f) * kPix + p];
      prefix[i] = fmaf(gv[i][3 + f], state_s[(4 + f) * kPix + p], prefix[i]);
      total[i] = fmaf(gv[i][3 + f], lang[(static_cast<size_t>(t) * kF + f) * kPix + p], total[i]);
    }
    glt[i] = glogtf[static_cast<size_t>(t) * kPix + p];
  }
  if (__syncthreads_and(all_latched)) return;  // the segment starts latched
  if (tid == 0) {
    rec[kBatchBwd].pw = rec[kBatchBwd].col = rec[kBatchBwd].col2 = make_float4(0.f, 0.f, 0.f, 0.f);
    rec[kBatchBwd].pq = make_float4(0.f, 0.f, 0.f, __uint_as_float(kNoBox));
  }
  for (int j = tid; j < kWarps * kBatchBwd; j += kThreads) hit[j] = 0;

  for (int b0 = sg.lo; b0 < sg.hi; b0 += kBatchBwd) {
    all_latched = true;
#pragma unroll
    for (int i = 0; i < kP; ++i) all_latched = all_latched && latched[i];
    if (__syncthreads_and(all_latched)) break;
    const int nslots = min(sg.hi - b0, kBatchBwd);
    pack<kBatchBwd>(rec, attrs_t, livet_t, k_cap, b0, b0 + nslots, sg.ox,
                              sg.oy, tid);
    const int nl = warp_list<U, kBatchBwd>(rec, list, lay, nslots, lane);
    for (int j = 0; j < nl; j += U) {
      if ((j & 15) == 0 && warp_done(latched)) break;
      int idx[U];
      Splat sp[U];
      float v[U][3 + kF];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        idx[u] = list[j + u];
        const Rec& r = rec[idx[u]];
        sp[u] = splat_at(r, pxf);
        const float4 col = r.col, col2 = r.col2;
        v[u][0] = col.x; v[u][1] = col.y; v[u][2] = col.z;
        v[u][3] = col.w; v[u][4] = col2.x; v[u][5] = col2.y;
      }
      // this thread's sums over its pixels, per splat: Σd, Σd·py, Σd·py²
      // (d = dL/dpower), d(opacity), d(rgb), d(features)
      float sums[U][4 + 3 + kF];
      bool any[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        any[u] = false;
#pragma unroll
        for (int c = 0; c < 4 + 3 + kF; ++c) sums[u][c] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const float py = static_cast<float>(lay.row0 + i);
        Pair q[U];
        float gs[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          q[u] = eval_pair(sp[u], py);
          gs[u] = 0.f;   // the splat's cotangent at the pixel: gcolor·rgb + glang·feat
#pragma unroll
          for (int c = 0; c < 3 + kF; ++c) gs[u] = fmaf(gv[i][c], v[u][c], gs[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float tn = fmaf(-q[u].a, T[i], T[i]);
          const bool trip = tn < kTEps;
          const bool contrib = !latched[i] && !trip && q[u].a > 0.f;
          latched[i] = latched[i] || trip;
          const float w = q[u].a * T[i];
          const float pre = fmaf(w, gs[u], prefix[i]);       // inclusive prefix
          const float da = T[i] * gs[u]
                           - __fdividef(total[i] - pre + glt[i], 1.f - q[u].a);
          const float dao = (contrib && q[u].alpha_un < kAlphaMax) ? da : 0.f;
          const float wc = contrib ? w : 0.f;
          const float dpow = dao * q[u].alpha_un;  // dα/dpower = op·g
          sums[u][0] += dpow;
          sums[u][1] = fmaf(dpow, py, sums[u][1]);
          sums[u][2] = fmaf(dpow, py * py, sums[u][2]);
          sums[u][3] = fmaf(dao, q[u].g, sums[u][3]);
#pragma unroll
          for (int c = 0; c < 3 + kF; ++c) sums[u][4 + c] = fmaf(gv[i][c], wc, sums[u][4 + c]);
          prefix[i] = contrib ? pre : prefix[i];
          T[i] = contrib ? tn : T[i];
          any[u] = any[u] || contrib;
        }
      }
      // the U splats' 13 sums (padded to 16 each) over the warp's lanes at
      // once: lane l ends with values 2l and 2l + 1, of splat l / 8
      uint32_t hits = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) hits |= __any_sync(0xffffffffu, any[u]) ? 1u << u : 0u;
      if (hits) {
        float x[16 * U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float* sm = sums[u];
          const float vals[16] = {sm[0], sm[0] * pxf, sm[1], sm[0] * pxf * pxf,
                                  sm[1] * pxf, sm[2], sm[3], sm[4], sm[5], sm[6],
                                  sm[7], sm[8], sm[9], 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < 16; ++c) x[16 * u + c] = vals[c];
        }
        transpose_reduce<16 * U>(x, lane);
        const int u = lane / 8, v0 = (2 * lane) % 16;
        if ((hits >> u) & 1u) {
          float* dst = red + (warp * kBatchBwd + list[j + u]) * kNV;
          if (v0 < kNV) dst[v0] = x[0];
          if (v0 + 1 < kNV) dst[v0 + 1] = x[1];
        }
        if (lane < U && ((hits >> lane) & 1u)) hit[warp * kBatchBwd + list[j + lane]] = 1;
      }
    }
    __syncthreads();
    // one owner thread a slot: the warps' sums in warp order, then the
    // closed forms for d{x, y, conic}
    for (int i = tid; i < nslots; i += kThreads) {
      float sum[kNV];
#pragma unroll
      for (int v = 0; v < kNV; ++v) sum[v] = 0.f;
      bool touched = false;
      for (int w = 0; w < kWarps; ++w) {
        if (!hit[w * kBatchBwd + i]) continue;
        hit[w * kBatchBwd + i] = 0;   // clean for the next batch
        touched = true;
#pragma unroll
        for (int v = 0; v < kNV; ++v) sum[v] += red[(w * kBatchBwd + i) * kNV + v];
      }
      if (!touched) continue;   // dattrs was zeroed by the caller
      const int k = b0 + i;
      const float xm = attrs_t[k] - sg.ox, ym = attrs_t[k_cap + k] - sg.oy;
      const float ca = attrs_t[2 * k_cap + k], cb = attrs_t[3 * k_cap + k],
                  cc = attrs_t[4 * k_cap + k];
      const float d1 = sum[0], dpx = sum[1], dpy = sum[2];
      const float dpx2 = sum[3], dpxpy = sum[4], dpy2 = sum[5];
      float out[C];
      out[0] = d1 * (-ca * xm - cb * ym) + dpx * ca + dpy * cb;
      out[1] = d1 * (-cc * ym - cb * xm) + dpy * cc + dpx * cb;
      out[2] = d1 * (-0.5f * xm * xm) + dpx * xm - 0.5f * dpx2;
      out[3] = d1 * (-xm * ym) + dpx * ym + dpy * xm - dpxpy;
      out[4] = d1 * (-0.5f * ym * ym) + dpy * ym - 0.5f * dpy2;
      out[5] = sum[6];
#pragma unroll
      for (int c = 0; c < 3 + kF; ++c) out[6 + c] = sum[7 + c];
#pragma unroll
      for (int r = 0; r < C; ++r) dattrs_t[static_cast<size_t>(r) * k_cap + k] = out[r];
    }
  }
}

}  // namespace

// Plain C interface (bound with ctypes). Contiguous fp32 tensors on the
// device (counts int32): counts [T], origins [T, 2], attrs [T, 9+F, K],
// livet [T, K]; the forward writes color [T, 3, 256], lang [T, F, 256],
// logtf [T, 256] and the segments' start state [T, 8, 7, 256]; the backward
// reads those (but logtf) and writes dattrs [T, 9+F, K], which the caller
// zeroes first (slots no pair reaches keep a zero gradient). Returns the
// launch's CUDA error, or cudaErrorInvalidValue for F other than 3.
extern "C" int blend_fwd(const void* counts, const void* origins,
                         const void* attrs, const void* livet, void* color,
                         void* lang, void* logtf, void* state, int tiles,
                         int n_feat, int k_cap, int chunk, void* stream) {
  if (n_feat != kF) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * kSeg);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSeg;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, blend_fwd_kernel, static_cast<const int*>(counts),
      static_cast<const float*>(origins), static_cast<const float*>(attrs),
      static_cast<const float*>(livet), static_cast<float*>(color),
      static_cast<float*>(lang), static_cast<float*>(logtf),
      static_cast<float*>(state), k_cap, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int blend_bwd(const void* counts, const void* origins,
                         const void* attrs, const void* livet,
                         const void* color, const void* lang,
                         const void* state, const void* gcolor,
                         const void* glang, const void* glogtf, void* dattrs,
                         int tiles, int n_feat, int k_cap, int chunk,
                         void* stream) {
  if (n_feat != kF) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = bwd_smem_bytes();
  const cudaError_t set = cudaFuncSetAttribute(
      blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  blend_bwd_kernel<<<tiles * kSeg, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const float*>(origins),
      static_cast<const float*>(attrs), static_cast<const float*>(livet),
      static_cast<const float*>(color), static_cast<const float*>(lang),
      static_cast<const float*>(state), static_cast<const float*>(gcolor),
      static_cast<const float*>(glang), static_cast<const float*>(glogtf),
      static_cast<float*>(dattrs), k_cap, chunk);
  return static_cast<int>(cudaGetLastError());
}
