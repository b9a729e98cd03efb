// 3x3x3 stride-1 zero-SAME convolution of channels-last volumes for Hopper
// (sm_90a): the forward (which also computes dx) and two weight-gradient
// kernels.
//
// Replaces the Pallas kernels of manigaussian_tpu/ops/pallas_conv.py and the
// two variants in scripts/r4_pallas_dw_repro.py:
//   * `_fwd_kernel` (pallas_call in `_conv3d_raw`):
//       y[m, co] = sum_{tap, ci} x[m + off(tap), ci] * w[tap, ci, co]
//     over the voxels m of [B, D, H, W], zero outside the volume, fp32 out.
//     dx is the same kernel on dy with the taps flipped and Ci/Co swapped
//     (the wrapper prepares those weights);
//   * `_dw_kernel` (pallas_call in `_conv3d_dw`), workspace scheme:
//       dW[tap, ci, co] = sum_m x[m + off(tap), ci] * dy[m, co];
//   * `_dw_kernel_stacked` / `_dw_kernel_scratch` (pallas_calls in the repro
//     script's `run_case`): the same dW with the accumulator kept on chip
//     and written once, resident scheme.
// x [B, D, H, W, Ci], w [27, Ci, Co], dy [B, D, H, W, Co], all contiguous;
// bf16 inputs multiply on the tensor cores with fp32 accumulation; fp32
// inputs use plain FMA (full fp32, no TF32), for the parity paths.
//
// None of the TPU design is carried over. There W was padded to a multiple
// of 8, whole padded planes were multiplied and the x offset recovered by
// rolling accumulators, x was copied into a padded buffer in HBM, and the
// sequential grid served as the dW accumulator. Here:
//   * forward, an implicit GEMM: M = 256 output voxels of the unpadded
//     volume (a linear range; 100 divides by no tile, so rows are guarded),
//     N = 128 (or 64) output channels, K = 27 taps x Ci. The K loop takes one
//     (oz, oy) row of the stencil and 64 input channels at a time: the A tile
//     is the 258 voxels m0-1 .. m0+256 displaced in z and y, gathered row by
//     row straight from x with cp.async, and serves the row's three x taps
//     at row offsets 0, 1, 2 (x is fetched 9 times, not 27). A row whose
//     source lies outside the volume is zero-filled by a copy of source size
//     0, so no padded copy of x exists anywhere; where only the x neighbour
//     falls off its row, the thread zeroes those fragment rows in registers.
//     Two cp.async stages; 8 warps as 4 (M) x 2 (N), each 64 x 64 of the
//     tile, mma.sync m16n8k16 with fp32 accumulators. (Measured on the way:
//     a 128-voxel tile without the shared halo read 2.4 times the bytes from
//     L2 and was 10 to 15 % slower; the warp layout made no difference.)
//   * dW: CUDA blocks run in no order and float atomics would make the sum
//     depend on the schedule, so neither scheme uses them. A CTA owns a tile
//     of dW (a group of taps x 64 input channels x BN output channels) and a
//     range of voxels, walks that range in steps of 64 voxels (x^T dy on the
//     tensor cores, x^T read with ldmatrix.trans), and keeps the tile in
//     registers until the end.
//       - workspace scheme: tiles of 3 taps (one row of the stencil) x 64 x
//         128; the voxels are cut into S slabs, each (tile, slab) CTA writes
//         its partial to workspace[slab], and a second kernel adds the S
//         partials in slab order. Every x row is fetched 27 x Co/128 times,
//         but the CTAs of one slab run together and find it in L2.
//       - resident scheme: tiles of 1 tap x 64 x 64, one CTA per tile walks
//         every voxel and writes dW once: no workspace and no second pass,
//         but x and dy are read once per owner (27 x Ci/64 x Co/64 owners).
//     Both are deterministic: a fixed order of sums for a given shape.
//
// Bounds on an H100 at the policy's two 100^3 convolutions, bf16 (989
// TFLOP/s; each of forward, dx and dW is 2 x 10^6 x 27 x Ci x Co operations):
//   `final` 256 -> 128: 1.77 TFLOP = 1.79 ms (its 512 MB in, 512 MB fp32 out
//   take 0.31 ms at 3.35 TB/s); `up0` post-resize 128 -> 128: 0.88 TFLOP =
//   0.89 ms. All three are bound by operations. mma.sync reaches at most
//   about two thirds of that rate; wgmma with TMA-fed tiles (im2col
//   descriptors for the halo), thread block clusters for the dW reduction, a
//   fused bias/activation/cast epilogue and a bf16 output are left for later
//   changes. The measured times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

struct Volume {
  int nb, d, h, w;
  __device__ __forceinline__ int voxels() const { return nb * d * h * w; }
};

// One voxel's position; `sample` is the linear index of its sample's first
// voxel.
struct Pos {
  int z, y, x, sample;
  bool ok;
};

__device__ __forceinline__ Pos locate(const Volume& v, int m, int total) {
  Pos p;
  p.ok = m < total;
  const int mm = p.ok ? m : 0;
  p.x = mm % v.w;
  int t = mm / v.w;
  p.y = t % v.h;
  t /= v.h;
  p.z = t % v.d;
  p.sample = (t / v.d) * v.d * v.h * v.w;
  return p;
}

// Linear index of the voxel that tap (oz, oy, ox) of the stencil reads for
// the output voxel `p`, or -1 where it lies outside the volume.
__device__ __forceinline__ int tap_voxel(const Volume& v, const Pos& p,
                                         int tap) {
  const int z = p.z + tap / 9 - 1, y = p.y + (tap / 3) % 3 - 1,
            x = p.x + tap % 3 - 1;
  const bool in = p.ok && z >= 0 && z < v.d && y >= 0 && y < v.h && x >= 0 &&
                  x < v.w;
  return in ? p.sample + (z * v.h + y) * v.w + x : -1;
}

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a · b, a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment loaders from a row-major shared-memory tile with `stride` elements
// per row (the m16n8k16 layouts).
// A operand where A[m][k] = X[m][k]: X rows m0..m0+15, columns k0..k0+15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int stride, int m0, int k0, int lane) {
  ldmatrix_x4(a, s + (m0 + (lane % 16)) * stride + k0 + (lane / 16) * 8);
}
// A operand where A[m][k] = X[k][m]: X rows k0..k0+15, columns m0..m0+15.
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* s,
                                         int stride, int k0, int m0, int lane) {
  const int mat = lane / 8;
  ldmatrix_x4_trans(a, s + (k0 + (lane % 8) + (mat / 2) * 8) * stride + m0 +
                           (mat % 2) * 8);
}
// B operands of two n8 tiles where B[k][n] = Y[k][n]: Y rows k0..k0+15,
// columns n0..n0+15. b[0], b[1] feed n-tile n0/8, b[2], b[3] n-tile n0/8 + 1.
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* s,
                                         int stride, int k0, int n0, int lane) {
  const int mat = lane / 8;
  ldmatrix_x4_trans(b, s + (k0 + (lane % 8) + (mat % 2) * 8) * stride + n0 +
                           (mat / 2) * 8);
}

// ------------------------------------------------------- forward / dx, bf16
constexpr int kFwdBM = 256;     // output voxels per CTA
constexpr int kFwdBK = 64;      // input channels per stage
constexpr int kFwdStages = 2;
constexpr int kFwdHalo = kFwdBM + 2;     // rows of the A tile: voxels m0-1 .. m0+BM
constexpr int kFwdAStride = kFwdBK + 8;  // +16 B: ldmatrix rows in distinct banks
constexpr int kFwdWarpsM = 4, kFwdWarpsN = 2;     // the CTA's warps over its tile
constexpr int kFwdThreads = 32 * kFwdWarpsM * kFwdWarpsN;
constexpr int kFwdMT = kFwdBM / (kFwdWarpsM * 16);  // m16 tiles per warp
constexpr int kFwdAVecs = kFwdBK / 8;             // 16-byte vectors per A row
constexpr int kFwdARows = kFwdThreads / kFwdAVecs;  // A rows the CTA copies at once
constexpr int kFwdAPasses = (kFwdHalo + kFwdARows - 1) / kFwdARows;
static_assert(2 * kFwdMT <= 32, "one mask bit per row of a thread");

template <int BN>
constexpr int fwd_smem_bytes() {
  return kFwdStages * (kFwdHalo * kFwdAStride + 3 * kFwdBK * (BN + 8)) *
         static_cast<int>(sizeof(bf16));
}

// One row of the A tile: the voxel it holds (-1 outside the volume) and that
// voxel's z and y.
struct HaloRow {
  int voxel;
  short z, y;
};

// The K loop runs over the 9 (oz, oy) rows of the stencil x chunks of input
// channels. A stage holds the A rows of voxels m0-1 .. m0+BM displaced by
// (oz-1, oy-1) in z and y, and the weights of the row's three taps: tap ox of
// output voxel m reads A row (m - m0) + ox, so one copy of x serves all three
// (ldmatrix takes any row offset). Where m's x-neighbour lies outside its row
// of the volume, that A row holds the voxel of another row: the thread zeroes
// those fragment rows in registers (mask_lo for ox = 0, mask_hi for ox = 2).
template <int BN>
__global__ void __launch_bounds__(kFwdThreads)
    conv3d_fwd_bf16_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w, float* __restrict__ y,
                           Volume vol, int ci, int co) {
  constexpr int kBStride = BN + 8;
  constexpr int kBTile = kFwdBK * kBStride;      // one tap's weights
  constexpr int kWarpN = BN / kFwdWarpsN;  // output channels per warp
  constexpr int kNT = kWarpN / 8;  // n8 tiles per warp
  static_assert(kNT % 2 == 0, "two n8 tiles per ldmatrix");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ HaloRow rows[kFwdHalo];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + kFwdStages * kFwdHalo * kFwdAStride;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp % kFwdWarpsM, warp_n = warp / kFwdWarpsM;
  const int warp_row = warp_m * kFwdMT * 16;
  const int g = lane / 4, q = lane % 4;
  const int total = vol.voxels();
  const int m0 = blockIdx.x * kFwdBM;
  const int n0 = blockIdx.y * BN;

  for (int i = tid; i < kFwdHalo; i += kFwdThreads) {
    const int v = m0 - 1 + i;
    const Pos p = locate(vol, max(v, 0), total);
    rows[i].voxel = (v >= 0 && p.ok) ? v : -1;
    rows[i].z = static_cast<short>(p.z);
    rows[i].y = static_cast<short>(p.y);
  }
  // bit 2·mt + half: the thread's row (mt, half) is the first (mask_lo) or
  // the last (mask_hi) voxel of its row of the volume
  uint32_t mask_lo = 0, mask_hi = 0;
#pragma unroll
  for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xpos = (m0 + warp_row + mt * 16 + g + half * 8) % vol.w;
      mask_lo |= (xpos == 0 ? 1u : 0u) << (2 * mt + half);
      mask_hi |= (xpos == vol.w - 1 ? 1u : 0u) << (2 * mt + half);
    }
  __syncthreads();

  const int a_vec = (tid % kFwdAVecs) * 8, a_row = tid / kFwdAVecs;
  const int k_chunks = (ci + kFwdBK - 1) / kFwdBK;
  const int n_iter = 9 * k_chunks;

  auto load_stage = [&](int it, int stage) {
    const int zy = it / k_chunks, k0 = (it % k_chunks) * kFwdBK;
    const int dz = zy / 3 - 1, dy = zy % 3 - 1;
    bf16* a = sa + stage * kFwdHalo * kFwdAStride;
    bf16* b = sb + stage * 3 * kBTile;
#pragma unroll
    for (int p = 0; p < kFwdAPasses; ++p) {
      const int i = a_row + p * kFwdARows;
      if (i < kFwdHalo) {
        const HaloRow r = rows[i];
        const int z = r.z + dz, yy = r.y + dy;
        const bool ok = r.voxel >= 0 && z >= 0 && z < vol.d && yy >= 0 &&
                        yy < vol.h && k0 + a_vec < ci;
        const int src = r.voxel + (dz * vol.h + dy) * vol.w;
        cp_async16(&a[i * kFwdAStride + a_vec],
                   x + (ok ? static_cast<size_t>(src) * ci + k0 + a_vec : 0), ok);
      }
    }
    for (int i = tid; i < 3 * kFwdBK * (BN / 8); i += kFwdThreads) {
      const int ox = i / (kFwdBK * (BN / 8)), j = i % (kFwdBK * (BN / 8));
      const int r = j / (BN / 8), c = (j % (BN / 8)) * 8;
      const bool ok = k0 + r < ci && n0 + c < co;
      cp_async16(&b[ox * kBTile + r * kBStride + c],
                 w + (ok ? (static_cast<size_t>(zy * 3 + ox) * ci + k0 + r) * co +
                               n0 + c
                         : 0),
                 ok);
    }
  };

  float acc[kFwdMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < n_iter) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();
    // the stage refilled here was read in iteration it-1, which every thread
    // has left (the barrier above)
    const int nxt = it + kFwdStages - 1;
    if (nxt < n_iter) load_stage(nxt, nxt % kFwdStages);
    cp_async_commit();
    const bf16* a = sa + (it % kFwdStages) * kFwdHalo * kFwdAStride;
    const bf16* b = sb + (it % kFwdStages) * 3 * kBTile;
#pragma unroll
    for (int ox = 0; ox < 3; ++ox) {
      const uint32_t mask = ox == 0 ? mask_lo : ox == 2 ? mask_hi : 0u;
#pragma unroll
      for (int kk = 0; kk < kFwdBK; kk += 16) {
        uint32_t af[kFwdMT][4];
#pragma unroll
        for (int mt = 0; mt < kFwdMT; ++mt) {
          load_a(af[mt], a, kFwdAStride, warp_row + mt * 16 + ox, kk, lane);
          // fragment registers 0, 2 hold row g of the m16 tile, 1, 3 row g+8
          if (mask >> (2 * mt) & 1u) af[mt][0] = af[mt][2] = 0u;
          if (mask >> (2 * mt + 1) & 1u) af[mt][1] = af[mt][3] = 0u;
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bf[4];
          load_b_t(bf, b + ox * kBTile, kBStride, kk, warp_n * kWarpN + np * 16,
                   lane);
#pragma unroll
          for (int mt = 0; mt < kFwdMT; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp_row + mt * 16 + g + half * 8;
      if (row >= total) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + warp_n * kWarpN + nt * 8 + 2 * q;
        if (col < co)
          *reinterpret_cast<float2*>(&y[static_cast<size_t>(row) * co + col]) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

// ------------------------------------------------------- forward / dx, fp32
// One thread per output element; neighbouring threads take neighbouring
// output channels, so w is read coalesced and x as a broadcast.
__global__ void __launch_bounds__(kThreads)
    conv3d_fwd_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w, float* __restrict__ y,
                          Volume vol, int ci, int co) {
  const int total = vol.voxels();
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(total) * co) return;
  const int n = static_cast<int>(idx % co);
  const Pos p = locate(vol, static_cast<int>(idx / co), total);
  float acc = 0.f;
  for (int tap = 0; tap < 27; ++tap) {
    const int src = tap_voxel(vol, p, tap);
    if (src < 0) continue;
    const float* xs = x + static_cast<size_t>(src) * ci;
    const float* ws = w + static_cast<size_t>(tap) * ci * co + n;
    for (int k = 0; k < ci; ++k)
      acc = fmaf(xs[k], ws[static_cast<size_t>(k) * co], acc);
  }
  y[idx] = acc;
}

// ----------------------------------------------------------------- dW, bf16
constexpr int kDwVox = 64;  // voxels per stage (the GEMM's K step)
constexpr int kDwCi = 64;   // input channels per dW tile (the GEMM's M)
constexpr int kDwXStride = kDwCi + 8;
constexpr int kDwStages = 2;
static_assert(kDwVox == 2 * (kThreads / 8), "two x rows per thread and tap");

template <int TG, int BN>
constexpr int dw_smem_bytes() {
  return kDwStages * kDwVox * (TG * kDwXStride + BN + 8) *
         static_cast<int>(sizeof(bf16));
}

// A CTA accumulates, over the voxels of slab blockIdx.y, the dW tile
// blockIdx.x = (tap group, 64 input channels, BN output channels), and
// writes it to out + slab·27·Ci·Co. TG taps to a group: TG = 3 is one row of
// the stencil (the three x offsets), TG = 1 a single tap.
template <int TG, int BN>
__global__ void __launch_bounds__(kThreads)
    conv3d_dw_bf16_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ dy, float* __restrict__ out,
                          Volume vol, int ci, int co, int chunks_per_slab) {
  constexpr int kDyStride = BN + 8;
  constexpr int kWarpN = BN / 4;   // output channels per warp
  constexpr int kNT = kWarpN / 8;  // n8 tiles per warp
  static_assert(kNT % 2 == 0, "two n8 tiles per ldmatrix");
  constexpr int kStage = kDwVox * (TG * kDwXStride + kDyStride);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp % 2, warp_n = warp / 2;
  const int total = vol.voxels();
  const int co_tiles = (co + BN - 1) / BN;
  const int ci_tiles = (ci + kDwCi - 1) / kDwCi;
  const int n0 = (blockIdx.x % co_tiles) * BN;
  const int c0 = ((blockIdx.x / co_tiles) % ci_tiles) * kDwCi;
  const int tap0 = (blockIdx.x / (co_tiles * ci_tiles)) * TG;
  const int chunks = (total + kDwVox - 1) / kDwVox;
  const int chunk_lo = blockIdx.y * chunks_per_slab;
  const int chunk_hi = min(chunks, chunk_lo + chunks_per_slab);

  const int x_vec = (tid % 8) * 8;  // this thread's 16-byte column of x rows

  auto load_stage = [&](int chunk, int stage) {
    bf16* sx = smem + stage * kStage;
    bf16* sdy = sx + TG * kDwVox * kDwXStride;
    const int v0 = chunk * kDwVox;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tid / 8 + i * 32;
      const Pos p = locate(vol, v0 + r, total);
#pragma unroll
      for (int j = 0; j < TG; ++j) {
        const int src = tap_voxel(vol, p, tap0 + j);
        const bool ok = src >= 0 && c0 + x_vec < ci;
        cp_async16(&sx[(j * kDwVox + r) * kDwXStride + x_vec],
                   x + (ok ? static_cast<size_t>(src) * ci + c0 + x_vec : 0), ok);
      }
    }
    for (int i = tid; i < kDwVox * (BN / 8); i += kThreads) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = v0 + r < total && n0 + c < co;
      cp_async16(&sdy[r * kDyStride + c],
                 dy + (ok ? static_cast<size_t>(v0 + r) * co + n0 + c : 0), ok);
    }
  };

  float acc[TG][2][kNT][4];
#pragma unroll
  for (int j = 0; j < TG; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][mt][nt][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (chunk_lo + s < chunk_hi) load_stage(chunk_lo + s, s);
    cp_async_commit();
  }
  for (int chunk = chunk_lo; chunk < chunk_hi; ++chunk) {
    const int it = chunk - chunk_lo, stage = it % kDwStages;
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    // the stage refilled here was read in the iteration before, which every
    // thread has left (the barrier above)
    const int nxt = chunk + kDwStages - 1;
    if (nxt < chunk_hi) load_stage(nxt, (it + kDwStages - 1) % kDwStages);
    cp_async_commit();
    const bf16* sx = smem + stage * kStage;
    const bf16* sdy = sx + TG * kDwVox * kDwXStride;
#pragma unroll
    for (int kk = 0; kk < kDwVox; kk += 16) {
      uint32_t bf[kNT / 2][4];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        load_b_t(bf[np], sdy, kDyStride, kk, warp_n * kWarpN + np * 16, lane);
#pragma unroll
      for (int j = 0; j < TG; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t af[4];
          load_a_t(af, sx + j * kDwVox * kDwXStride, kDwXStride, kk,
                   warp_m * 32 + mt * 16, lane);
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            mma_bf16(acc[j][mt][2 * np], af, bf[np][0], bf[np][1]);
            mma_bf16(acc[j][mt][2 * np + 1], af, bf[np][2], bf[np][3]);
          }
        }
    }
  }
  cp_async_wait<0>();

  float* tile = out + static_cast<size_t>(blockIdx.y) * 27 * ci * co;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < TG; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = c0 + warp_m * 32 + mt * 16 + g + half * 8;
        if (row >= ci) continue;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int col = n0 + warp_n * kWarpN + nt * 8 + 2 * q;
          if (col < co)
            *reinterpret_cast<float2*>(
                &tile[(static_cast<size_t>(tap0 + j) * ci + row) * co + col]) =
                make_float2(acc[j][mt][nt][2 * half],
                            acc[j][mt][nt][2 * half + 1]);
        }
      }
}

// ----------------------------------------------------------------- dW, fp32
// One thread per dW element, walking the voxels of slab blockIdx.y in order;
// neighbouring threads take neighbouring output channels.
__global__ void __launch_bounds__(kThreads)
    conv3d_dw_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ dy, float* __restrict__ out,
                         Volume vol, int ci, int co, int voxels_per_slab) {
  const int n_el = 27 * ci * co;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_el) return;
  const int n = idx % co, k = (idx / co) % ci, tap = idx / (co * ci);
  const int total = vol.voxels();
  const int lo = blockIdx.y * voxels_per_slab;
  const int hi = min(total, lo + voxels_per_slab);
  float acc = 0.f;
  for (int m = lo; m < hi; ++m) {
    const int src = tap_voxel(vol, locate(vol, m, total), tap);
    if (src >= 0)
      acc = fmaf(x[static_cast<size_t>(src) * ci + k],
                 dy[static_cast<size_t>(m) * co + n], acc);
  }
  out[static_cast<size_t>(blockIdx.y) * n_el + idx] = acc;
}

// dw[i] = workspace[0][i] + workspace[1][i] + ... in slab order.
__global__ void __launch_bounds__(kThreads)
    conv3d_dw_reduce_kernel(const float* __restrict__ workspace,
                            float* __restrict__ dw, int n_el, int slabs) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_el) return;
  float acc = 0.f;
  for (int s = 0; s < slabs; ++s)
    acc += workspace[static_cast<size_t>(s) * n_el + idx];
  dw[idx] = acc;
}

template <int BN>
int launch_fwd_bf16(const void* x, const void* w, void* y, Volume vol, int ci,
                    int co, cudaStream_t st) {
  constexpr int kSmem = fwd_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_fwd_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = vol.nb * vol.d * vol.h * vol.w;
  dim3 grid((total + kFwdBM - 1) / kFwdBM, (co + BN - 1) / BN);
  conv3d_fwd_bf16_kernel<BN><<<grid, kFwdThreads, kSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<float*>(y), vol, ci, co);
  return static_cast<int>(cudaGetLastError());
}

template <int TG, int BN>
int launch_dw_bf16(const void* x, const void* dy, void* out, Volume vol, int ci,
                   int co, int slabs, cudaStream_t st) {
  constexpr int kSmem = dw_smem_bytes<TG, BN>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_dw_bf16_kernel<TG, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = vol.nb * vol.d * vol.h * vol.w;
  const int chunks = (total + kDwVox - 1) / kDwVox;
  const int tiles = (27 / TG) * ((ci + kDwCi - 1) / kDwCi) * ((co + BN - 1) / BN);
  dim3 grid(tiles, slabs);
  conv3d_dw_bf16_kernel<TG, BN><<<grid, kThreads, kSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<float*>(out), vol, ci, co, (chunks + slabs - 1) / slabs);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_f32(const void* x, const void* dy, void* out, Volume vol, int ci,
                  int co, int slabs, cudaStream_t st) {
  const int total = vol.nb * vol.d * vol.h * vol.w;
  dim3 grid((27 * ci * co + kThreads - 1) / kThreads, slabs);
  conv3d_dw_f32_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<float*>(out), vol, ci, co, (total + slabs - 1) / slabs);
  return static_cast<int>(cudaGetLastError());
}

int launch_reduce(const void* workspace, void* dw, int ci, int co, int slabs,
                  cudaStream_t st) {
  const int n_el = 27 * ci * co;
  conv3d_dw_reduce_kernel<<<(n_el + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(workspace), static_cast<float*>(dw), n_el,
      slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C interface: pointers are contiguous tensors on the device (x
// [B,D,H,W,Ci], w [27,Ci,Co], y and dy [B,D,H,W,Co] with y fp32, dw [27,Ci,Co]
// fp32, workspace [slabs,27,Ci,Co] fp32). B·D·H·W must stay below 2^31; the
// bf16 entry points need Ci and Co to be multiples of 8 (16-byte rows). Each
// returns cudaGetLastError() after its launches.
extern "C" int conv3d_fwd_bf16(const void* x, const void* w, void* y, int nb,
                               int d, int h, int wd, int ci, int co,
                               void* stream) {
  if (ci % 8 || co % 8) return static_cast<int>(cudaErrorInvalidValue);
  const Volume vol{nb, d, h, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return co > 64 ? launch_fwd_bf16<128>(x, w, y, vol, ci, co, st)
                 : launch_fwd_bf16<64>(x, w, y, vol, ci, co, st);
}

extern "C" int conv3d_fwd_f32(const void* x, const void* w, void* y, int nb,
                              int d, int h, int wd, int ci, int co,
                              void* stream) {
  const Volume vol{nb, d, h, wd};
  const size_t n = static_cast<size_t>(nb) * d * h * wd * co;
  conv3d_fwd_f32_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), vol, ci, co);
  return static_cast<int>(cudaGetLastError());
}

// The number of dW tiles of the workspace scheme (the wrapper sizes the
// number of slabs by it).
extern "C" int conv3d_dw_workspace_tiles(int ci, int co) {
  return 9 * ((ci + kDwCi - 1) / kDwCi) * ((co + 127) / 128);
}

extern "C" int conv3d_dw_workspace_bf16(const void* x, const void* dy,
                                        void* workspace, void* dw, int nb,
                                        int d, int h, int wd, int ci, int co,
                                        int slabs, void* stream) {
  if (ci % 8 || co % 8 || slabs < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_dw_bf16<3, 128>(x, dy, workspace, Volume{nb, d, h, wd},
                                         ci, co, slabs, st);
  return err ? err : launch_reduce(workspace, dw, ci, co, slabs, st);
}

extern "C" int conv3d_dw_resident_bf16(const void* x, const void* dy, void* dw,
                                       int nb, int d, int h, int wd, int ci,
                                       int co, void* stream) {
  if (ci % 8 || co % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw_bf16<1, 64>(x, dy, dw, Volume{nb, d, h, wd}, ci, co, 1,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int conv3d_dw_workspace_f32(const void* x, const void* dy,
                                       void* workspace, void* dw, int nb, int d,
                                       int h, int wd, int ci, int co, int slabs,
                                       void* stream) {
  if (slabs < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_dw_f32(x, dy, workspace, Volume{nb, d, h, wd}, ci, co,
                                slabs, st);
  return err ? err : launch_reduce(workspace, dw, ci, co, slabs, st);
}

extern "C" int conv3d_dw_resident_f32(const void* x, const void* dy, void* dw,
                                      int nb, int d, int h, int wd, int ci,
                                      int co, void* stream) {
  return launch_dw_f32(x, dy, dw, Volume{nb, d, h, wd}, ci, co, 1,
                       static_cast<cudaStream_t>(stream));
}
