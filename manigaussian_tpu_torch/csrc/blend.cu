// Per-tile front-to-back Gaussian alpha blend for Hopper (sm_90a): forward
// and backward.
//
// Replaces the Pallas kernels of manigaussian_tpu/ops/pallas_blend.py:
//   * `_fwd_kernel` (pallas_call in `_blend_fwd`): per 16×16 tile, blend the
//     tile's depth-sorted splat list into color [3, 256], features [F, 256]
//     and the final log transmittance [1, 256];
//   * `_bwd_kernel` (pallas_call in `_blend_bwd`): the gradient of those
//     outputs with respect to the packed per-splat attributes [C, K].
// Inputs per tile t: counts[t] (live splats, bounds the loop), the tile's
// pixel origin, attrs [T, C, K] fp32 packed channel-first (rows: xy 2,
// conic 3, opacity 1, rgb 3, features F), livet [T, 1, K] (1 = live slot).
//
// Semantics kept from the TPU kernel (forward.cu:262-398 of the reference
// CUDA rasterizer): power from the tile-local monomials
// (1, px, py, px², px·py, py²) · coeff, skip where power > 0 or
// alpha < 1/255, alpha clamped at 0.99, log T accumulated as Σ log1p(-a),
// the latch where T·(1-a) < 1e-4 (the splat that trips it does not
// contribute), chunks past `count` skipped. The backward uses the TPU
// kernel's suffix-sum identity dL/da_i = T_i·g_i − (S_i + dL/dlogT)/(1−a_i),
// S_i = Σ_{j>i} w_j·g_j, gated like the JAX VJP: zero gradient at the 0.99
// clamp, for skipped splats and for latched pixels.
//
// Bound on an H100 at the training step's shapes (T = 64 tiles, K = 2048,
// F = 3): the work is per (splat, pixel) pair up to each tile's count, at
// most T·K·256 = 33.6 M pairs; each pair of the forward costs one exp and
// one log1p on the special-function units (16 a clock per SM, 132 SMs,
// ≈ 1.98 GHz: ≈ 4.2·10^12 a second) besides ≈ 20 fp32 operations, so the
// bound is operations (≈ 16 us at full capacity against ≈ 2 us for the
// 6.3 MB of attrs). The backward replays the forward twice.
// Design about it:
//   * one CTA per tile, one thread per pixel (256); every pixel walks the
//     tile's splats front to back and keeps its accumulators in registers;
//   * batches of 64 splats of the packed attributes are staged in shared
//     memory with cp.async, double buffered, and their 6 power coefficients
//     computed once per splat;
//   * the CTA leaves the loop when every pixel has latched
//     (__syncthreads_and) or past `count` (rounded up to `chunk`, as the TPU
//     kernel skips whole chunks);
//   * backward: pass 1 replays the forward for Σ w·g per pixel; pass 2 walks
//     the splats again with the running prefix and reduces each splat's
//     6 monomial sums of d(power), d(opacity), 3 drgb and F dfeat over the
//     tile's 256 pixels inside the CTA (warp shuffles, then shared memory
//     over a batch of splats): no atomics, and each [T, C, K] slot belongs to
//     one tile, so the output is deterministic; then one thread per splat
//     applies the closed forms for d{x, y, conic}.
// Known first limit: at batch 1 the 64 tiles give 64 CTAs on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 64;           // splats staged per step
constexpr float kAlphaMax = static_cast<float>(0.99);
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kTEps = static_cast<float>(1e-4);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int C>
struct Batches {
  float raw[2][C][kBatch];   // packed attributes of the staged splats
  float live[2][kBatch];
  float coef[6][kBatch];     // power coefficients, tile-local
};

// Stage splats k0..k0+kBatch of one tile (rows of C attributes + the live
// row) into buffer `buf`; slots at or past n_end are zero-filled (not live).
template <int C>
__device__ __forceinline__ void stage(Batches<C>& sm, int buf,
                                      const float* attrs_t,
                                      const float* livet_t, int k_cap, int k0,
                                      int n_end, int tid) {
  constexpr int kVec = kBatch / 4;
  for (int i = tid; i < (C + 1) * kVec; i += kPix) {
    const int row = i / kVec, j = (i % kVec) * 4;
    const bool ok = k0 + j < n_end;
    const float* src = (row < C ? attrs_t + static_cast<size_t>(row) * k_cap
                                : livet_t) + (ok ? k0 + j : 0);
    float* dst = row < C ? &sm.raw[buf][row][j] : &sm.live[buf][j];
    cp_async16(dst, src, ok);
  }
}

// power = -0.5a(xm-px)² - 0.5c(ym-py)² - b(xm-px)(ym-py) as
// (1, px, py, px², px·py, py²) · coeff (pallas_blend._splat_coeffs)
template <int C>
__device__ __forceinline__ void coefficients(Batches<C>& sm, int buf, float ox,
                                             float oy, int tid) {
  if (tid < kBatch) {
    const float xm = sm.raw[buf][0][tid] - ox, ym = sm.raw[buf][1][tid] - oy;
    const float ca = sm.raw[buf][2][tid], cb = sm.raw[buf][3][tid],
                cc = sm.raw[buf][4][tid];
    sm.coef[0][tid] = -0.5f * ca * xm * xm - 0.5f * cc * ym * ym - cb * xm * ym;
    sm.coef[1][tid] = ca * xm + cb * ym;
    sm.coef[2][tid] = cc * ym + cb * xm;
    sm.coef[3][tid] = -0.5f * ca;
    sm.coef[4][tid] = -cb;
    sm.coef[5][tid] = -0.5f * cc;
  }
}

// One splat at one pixel: power, the Gaussian g, the unclamped alpha, the
// effective alpha a (0 when skipped) and whether it is active.
struct Splat {
  float power, g, alpha_un, a;
  bool active;
};

template <int C>
__device__ __forceinline__ Splat eval_splat(const Batches<C>& sm, int buf,
                                            int j, float px, float py) {
  Splat s;
  s.power = sm.coef[0][j];
  s.power = fmaf(sm.coef[1][j], px, s.power);
  s.power = fmaf(sm.coef[2][j], py, s.power);
  s.power = fmaf(sm.coef[3][j], px * px, s.power);
  s.power = fmaf(sm.coef[4][j], px * py, s.power);
  s.power = fmaf(sm.coef[5][j], py * py, s.power);
  s.g = expf(fminf(s.power, 0.f));
  s.alpha_un = sm.raw[buf][5][j] * s.g;
  const float alpha = fminf(kAlphaMax, s.alpha_un);
  s.active = s.power <= 0.f && alpha >= kAlphaMin && sm.live[buf][j] > 0.5f;
  s.a = s.active ? alpha : 0.f;
  return s;
}

struct TileInfo {
  int n_end;  // splats walked: `count` rounded up to a chunk, at most K
  float ox, oy;
};

__device__ __forceinline__ TileInfo tile_info(const int* counts,
                                              const float* origins, int t,
                                              int k_cap, int chunk) {
  TileInfo ti;
  const int count = min(max(counts[t], 0), k_cap);
  ti.n_end = min(k_cap, (count + chunk - 1) / chunk * chunk);
  ti.ox = origins[2 * t];
  ti.oy = origins[2 * t + 1];
  return ti;
}

// ----------------------------------------------------------------- forward
template <int F>
__global__ void __launch_bounds__(kPix)
    blend_fwd_kernel(const int* __restrict__ counts,
                     const float* __restrict__ origins,
                     const float* __restrict__ attrs,
                     const float* __restrict__ livet,
                     float* __restrict__ color, float* __restrict__ lang,
                     float* __restrict__ logtf, int k_cap, int chunk) {
  constexpr int C = 9 + F;
  __shared__ __align__(16) Batches<C> sm;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = static_cast<float>(tid % kTile);
  const float py = static_cast<float>(tid / kTile);
  const TileInfo ti = tile_info(counts, origins, t, k_cap, chunk);
  const float* attrs_t = attrs + static_cast<size_t>(t) * C * k_cap;
  const float* livet_t = livet + static_cast<size_t>(t) * k_cap;

  float acc[3 + F];
#pragma unroll
  for (int c = 0; c < 3 + F; ++c) acc[c] = 0.f;
  float log_t_raw = 0.f, log_t_final = 0.f;
  bool latched = false;

  const int n_batches = (ti.n_end + kBatch - 1) / kBatch;
  if (n_batches > 0) {
    stage<C>(sm, 0, attrs_t, livet_t, k_cap, 0, ti.n_end, tid);
    cp_async_commit();
  }
  for (int b = 0; b < n_batches; ++b) {
    const int buf = b & 1;
    const int k0 = b * kBatch;
    if (b + 1 < n_batches) {
      stage<C>(sm, buf ^ 1, attrs_t, livet_t, k_cap, k0 + kBatch, ti.n_end, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    coefficients<C>(sm, buf, ti.ox, ti.oy, tid);
    __syncthreads();
    const int nb = min(kBatch, ti.n_end - k0);
    for (int j = 0; j < nb && !latched; ++j) {
      const Splat s = eval_splat<C>(sm, buf, j, px, py);
      const float log1m = log1pf(-s.a);
      const float t_before = expf(log_t_raw);
      if (t_before * (1.f - s.a) < kTEps) {
        latched = true;
      } else if (s.a > 0.f) {
        const float w = s.a * t_before;
#pragma unroll
        for (int c = 0; c < 3 + F; ++c) acc[c] = fmaf(w, sm.raw[buf][6 + c][j], acc[c]);
        log_t_final += log1m;
      }
      log_t_raw += log1m;
    }
    if (__syncthreads_and(latched)) break;
  }
  cp_async_wait<0>();

  float* ct = color + static_cast<size_t>(t) * 3 * kPix;
  float* lt = lang + static_cast<size_t>(t) * F * kPix;
#pragma unroll
  for (int c = 0; c < 3; ++c) ct[c * kPix + tid] = acc[c];
#pragma unroll
  for (int f = 0; f < F; ++f) lt[f * kPix + tid] = acc[3 + f];
  logtf[static_cast<size_t>(t) * kPix + tid] = log_t_final;
}

// ---------------------------------------------------------------- backward
template <int F>
__global__ void __launch_bounds__(kPix)
    blend_bwd_kernel(const int* __restrict__ counts,
                     const float* __restrict__ origins,
                     const float* __restrict__ attrs,
                     const float* __restrict__ livet,
                     const float* __restrict__ gcolor,
                     const float* __restrict__ glang,
                     const float* __restrict__ glogtf,
                     float* __restrict__ dattrs, int k_cap, int chunk) {
  constexpr int C = 9 + F;
  constexpr int NV = 7 + 3 + F;  // 6 monomial sums, d(opacity), drgb, dfeat
  __shared__ __align__(16) Batches<C> sm;
  __shared__ float red[kWarps][kBatch][NV];
  __shared__ unsigned char hit[kWarps][kBatch];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float px = static_cast<float>(tid % kTile);
  const float py = static_cast<float>(tid / kTile);
  const TileInfo ti = tile_info(counts, origins, t, k_cap, chunk);
  const float* attrs_t = attrs + static_cast<size_t>(t) * C * k_cap;
  const float* livet_t = livet + static_cast<size_t>(t) * k_cap;
  float* dattrs_t = dattrs + static_cast<size_t>(t) * C * k_cap;

  float gc[3], gl[F];
#pragma unroll
  for (int c = 0; c < 3; ++c) gc[c] = gcolor[(static_cast<size_t>(t) * 3 + c) * kPix + tid];
#pragma unroll
  for (int f = 0; f < F; ++f) gl[f] = glang[(static_cast<size_t>(t) * F + f) * kPix + tid];
  const float glt = glogtf[static_cast<size_t>(t) * kPix + tid];
  const int n_batches = (ti.n_end + kBatch - 1) / kBatch;

  // the splat's cotangent g at this pixel: gcolor·rgb + glang·feat
  auto gsplat = [&](int buf, int j) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) a = fmaf(gc[c], sm.raw[buf][6 + c][j], a);
#pragma unroll
    for (int f = 0; f < F; ++f) b = fmaf(gl[f], sm.raw[buf][9 + f][j], b);
    return a + b;
  };

  float total_wg = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    float log_t_raw = 0.f, prefix_wg = 0.f;
    bool latched = false;
    if (n_batches > 0) {
      stage<C>(sm, 0, attrs_t, livet_t, k_cap, 0, ti.n_end, tid);
      cp_async_commit();
    }
    for (int b = 0; b < n_batches; ++b) {
      const int buf = b & 1;
      const int k0 = b * kBatch;
      if (b + 1 < n_batches) {
        stage<C>(sm, buf ^ 1, attrs_t, livet_t, k_cap, k0 + kBatch, ti.n_end, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      coefficients<C>(sm, buf, ti.ox, ti.oy, tid);
      __syncthreads();
      const int nb = min(kBatch, ti.n_end - k0);
      for (int j = 0; j < nb; ++j) {
        float vals[NV];
        bool nonzero = false;
        if (!latched) {
          const Splat s = eval_splat<C>(sm, buf, j, px, py);
          const float log1m = log1pf(-s.a);
          const float t_before = expf(log_t_raw);
          if (t_before * (1.f - s.a) < kTEps) {
            latched = true;
          } else if (s.a > 0.f) {
            const float w = s.a * t_before;
            const float gs = gsplat(buf, j);
            if (pass == 0) {
              total_wg = fmaf(w, gs, total_wg);
            } else {
              prefix_wg = fmaf(w, gs, prefix_wg);      // inclusive prefix
              const float suffix = total_wg - prefix_wg;
              const float da = t_before * gs - (suffix + glt) / (1.f - s.a);
              const float da_open = s.alpha_un < kAlphaMax ? da : 0.f;
              const float dpow = da_open * s.alpha_un;  // dα/dpower = op·g
              vals[0] = dpow;
              vals[1] = dpow * px;
              vals[2] = dpow * py;
              vals[3] = dpow * px * px;
              vals[4] = dpow * px * py;
              vals[5] = dpow * py * py;
              vals[6] = da_open * s.g;
#pragma unroll
              for (int c = 0; c < 3; ++c) vals[7 + c] = gc[c] * w;
#pragma unroll
              for (int f = 0; f < F; ++f) vals[10 + f] = gl[f] * w;
              nonzero = true;
            }
          }
          log_t_raw += log1m;
        }
        if (pass == 1) {
          const bool any = __any_sync(0xffffffffu, nonzero);
          if (any) {
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              float x = nonzero ? vals[v] : 0.f;
#pragma unroll
              for (int off = 16; off > 0; off /= 2)
                x += __shfl_xor_sync(0xffffffffu, x, off);
              if (lane == 0) red[warp][j][v] = x;
            }
          }
          if (lane == 0) hit[warp][j] = any ? 1 : 0;
        }
      }
      if (pass == 1) {
        __syncthreads();
        // the tile's sums for splat j, then the closed forms for d{x,y,conic}
        if (tid < nb) {
          const int j = tid;
          float sum[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) sum[v] = 0.f;
          for (int w = 0; w < kWarps; ++w) {
            if (!hit[w][j]) continue;
#pragma unroll
            for (int v = 0; v < NV; ++v) sum[v] += red[w][j][v];
          }
          const float xm = sm.raw[buf][0][j] - ti.ox, ym = sm.raw[buf][1][j] - ti.oy;
          const float ca = sm.raw[buf][2][j], cb = sm.raw[buf][3][j],
                      cc = sm.raw[buf][4][j];
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
          for (int c = 0; c < 3 + F; ++c) out[6 + c] = sum[7 + c];
#pragma unroll
          for (int r = 0; r < C; ++r)
            dattrs_t[static_cast<size_t>(r) * k_cap + k0 + j] = out[r];
        }
      }
      if (__syncthreads_and(latched)) break;
    }
    cp_async_wait<0>();
    __syncthreads();
  }
}

}  // namespace

// Plain C interface (bound with ctypes). Contiguous fp32 tensors on the
// device (counts int32): counts [T], origins [T, 2], attrs [T, 9+F, K],
// livet [T, K]; forward outputs color [T, 3, 256], lang [T, F, 256],
// logtf [T, 256]; the backward writes dattrs [T, 9+F, K], which the caller
// zeroes first (slots the walk does not reach keep a zero gradient). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// feature count without an instantiation.
extern "C" int blend_fwd(const void* counts, const void* origins,
                         const void* attrs, const void* livet, void* color,
                         void* lang, void* logtf, int tiles, int n_feat,
                         int k_cap, int chunk, void* stream) {
  if (n_feat != 3) return static_cast<int>(cudaErrorInvalidValue);
  blend_fwd_kernel<3><<<tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const float*>(origins),
      static_cast<const float*>(attrs), static_cast<const float*>(livet),
      static_cast<float*>(color), static_cast<float*>(lang),
      static_cast<float*>(logtf), k_cap, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int blend_bwd(const void* counts, const void* origins,
                         const void* attrs, const void* livet,
                         const void* gcolor, const void* glang,
                         const void* glogtf, void* dattrs, int tiles,
                         int n_feat, int k_cap, int chunk, void* stream) {
  if (n_feat != 3) return static_cast<int>(cudaErrorInvalidValue);
  blend_bwd_kernel<3><<<tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const float*>(origins),
      static_cast<const float*>(attrs), static_cast<const float*>(livet),
      static_cast<const float*>(gcolor), static_cast<const float*>(glang),
      static_cast<const float*>(glogtf), static_cast<float*>(dattrs), k_cap,
      chunk);
  return static_cast<int>(cudaGetLastError());
}
