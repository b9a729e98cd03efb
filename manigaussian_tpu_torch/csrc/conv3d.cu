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
// sequential grid served as the dW accumulator.
//
// What bounds the kernels on an H100 at the policy's two 100^3 convolutions,
// bf16 (989 TFLOP/s; each of forward, dx and dW is 2 x 10^6 x 27 x Ci x Co
// operations): `final` 256 -> 128 is 1.77 TFLOP = 1.79 ms (its 512 MB in and
// 512 MB fp32 out take 0.31 ms at 3.35 TB/s), `up0` post-resize 128 -> 128
// 0.88 TFLOP = 0.89 ms. All are bound by operations, so the bf16 forward and
// both dW schemes run on wgmma, fed by TMA through a ring of shared-memory
// stages with mbarrier full/empty pairs, a producer apart from the consumer
// warpgroups. With the loads and the fragment reads taken out, the wgmma
// loops alone come within 8 % (forward) and 18 % (dW) of the bound; what the
// complete kernels lose beyond that, they lose per SM (a grid on 18 SMs
// takes as long per step as one on 126) on the way from shared memory to
// the tensor cores: the ldmatrix of the A fragments and, in dW, the masks.
// The designs therefore keep that path short (the probes' and the rejected
// variants' times stand in PERF.md):
//   * one halo tile for the three x taps. A stage holds, for one (oz, oy) row
//     of the stencil, the voxels m0-1 .. m0+M displaced by the row's offset
//     in z and y: a linear range of the [voxels, C] matrix, hence one plain
//     TMA box (zero outside the array), and no padded copy of x anywhere.
//     Tap ox reads the tile at row offset ox. A swizzled wgmma descriptor
//     cannot start at an odd row, so the shifted operand (A in both kernels)
//     goes through ldmatrix into registers, and B, which no tap shifts,
//     through a descriptor. Weights and dy lie in memory with the N index
//     contiguous; wgmma takes them as they are (MN-major, transpose bit), so
//     the wrapper re-lays nothing;
//   * masks in registers instead of zero-filled copies. A displaced voxel
//     that wraps into another row, plane or sample brings another voxel's
//     values. In the forward the voxel is a row of A: a thread zeroes the
//     fragment rows of its four output voxels by their edge bits. In dW the
//     voxel is the K index, a column of A and half a register: the producer
//     writes an AND mask per voxel pair and tap beside the tile, laid out so
//     that a consumer thread reads its eight words of a stage in two loads;
//   * nothing but constants in the consumers' loop: tap, k16 step and
//     fragment buffer are unrolled (with them as run-time values, and a
//     division to find the stencil row, the forward took two thirds longer);
//   * forward: 256 voxels x 128 channels a CTA, K in steps of one stencil row
//     x 32 channels, five stages; two consumer warpgroups of 2 x m64n128
//     (128 accumulators a thread; setmaxnreg gives them the registers, ptxas
//     serializes the wgmma without), the A fragments double-buffered so that
//     ldmatrix runs under the wgmma group before, one group in flight across
//     stage boundaries. Four warpgroups of one m64 tile were slower;
//   * dW: CUDA blocks run in no order and float atomics would make the sum
//     depend on the schedule, so neither scheme uses them. Both walk a dW
//     tile the same way (`dw_walk`): a tile is 3 taps (one stencil row) x 64
//     x 128 of dW, one consumer warpgroup per x tap (m64n128 each, so an A
//     fragment feeds 128 columns, and one wgmma group per stage; two
//     warpgroups of 3 x m64n64 took a third longer; a 128-channel tile, 2 x
//     m64n128 a warpgroup, does not fit the 160 registers four warpgroups
//     leave, and ptxas serializes its wgmma), 36 tiles at 256 -> 128 and 18
//     at 128 -> 128. The schemes differ in their grid and their epilogue:
//   * workspace scheme (the training backward): each (tile, slab) CTA writes
//     its partial to workspace[slab] and a second kernel adds the partials
//     in slab order: bitwise repeatable. The wrapper cuts the voxels into as
//     many slabs as fill whole waves of SMs (11 or 22 at the policy's convs,
//     396 CTAs on 132 SMs); the workspace is 39 MB, written and read once;
//   * resident scheme: the accumulator stays on chip for the whole walk and
//     dW is written once, as in the TPU kernels. Each tile is one
//     thread-block cluster of S CTAs (S <= 16, 8 the portable limit); the
//     cluster's ranks split the tile's voxel walk, each CTA lays its three
//     m64n128 accumulators over its own ring (96 KB) when the walk is done,
//     and after a cluster barrier rank r adds its 1/S of the tile over
//     ranks 0 .. S-1 in rank order through distributed shared memory and
//     writes it. No workspace, no second pass, no atomics; the order of the
//     sum depends on S alone. The wrapper picks S from the shapes and the
//     clusters the card holds at once (cudaOccupancyMaxActiveClusters, 1
//     CTA an SM, clusters inside one GPC): the fewest waves x stages a CTA;
//   * fp32 inputs (the parity paths): one thread per output element.
// Not done: TMA multicast of the weights or of dy across a cluster (with all
// SMs busy a step takes 15 % longer than on a few, the share of L2), a
// persistent CTA whose stores overlap the next tile's loads, a fused
// bias/activation/bf16 epilogue. The measured times stand in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kThreads = 256;

struct Volume {
  int nb, d, h, w;
  __host__ __device__ __forceinline__ int voxels() const { return nb * d * h * w; }
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

__device__ __forceinline__ void ldmatrix_x4_addr(uint32_t (&r)[4],
                                                 uint32_t smem_addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans_addr(uint32_t (&r)[4],
                                                       uint32_t smem_addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr));
}

// ---------------------------------------------- forward / dx, bf16, wgmma
constexpr int kWgConsumers = 2;       // consumer warpgroups
constexpr int kWgMT = 2;              // m64 tiles of each
constexpr int kWgThreads = (kWgConsumers + 1) * 128;  // and a producer warpgroup
// The CTA starts with 168 registers a thread (65,536 / 384, in eights); what
// the producer gives up the consumers take: 2·232 + 40 = 3·168. ptxas
// allocates the consumers' branch up to that count, and serializes the wgmma
// for want of registers without.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
static_assert(kWgConsumers * kConsumerRegs + kProducerRegs <=
                  (kWgConsumers + 1) * (65536 / kWgThreads / 8 * 8),
              "setmaxnreg.inc would wait for registers that never come");
constexpr int kWgBM = kWgConsumers * kWgMT * 64;  // output voxels per CTA
constexpr int kWgBN = 128;            // output channels per CTA
constexpr int kWgBK = 32;             // input channels per stage
constexpr int kWgStages = 5;
constexpr int kWgHalo = kWgBM + 2;    // rows of the A tile: voxels m0-1 .. m0+BM
constexpr int kWgBTap = kWgBK * 128;        // bytes of one tap's [32 ci][64 co]
constexpr int kWgBHalf = 3 * kWgBTap;       // the three taps of one 64-wide half
constexpr int kWgBBytes = 2 * kWgBHalf;
constexpr int kWgARow = kWgBK * static_cast<int>(sizeof(bf16));  // 64-byte rows
constexpr int kWgABytes = kWgHalo * kWgARow;
constexpr int kWgStageBytes = (kWgBBytes + kWgABytes + 1023) / 1024 * 1024;
constexpr int kWgSmemBytes = kWgStages * kWgStageBytes + 1024;  // + alignment slack

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Four bits a set, one bit per row (mt, half) of a consumer thread: the row's
// voxel is the first / last of the volume along z, y, x.
struct EdgeBits {
  uint32_t z_lo, z_hi, y_lo, y_hi, x_lo, x_hi;
};

// The implicit GEMM of the forward on wgmma. The K loop runs over the 9
// (oz, oy) rows of the stencil x chunks of 32 input channels. A stage holds
//   * the A rows: x at the 258 voxels m0-1 .. m0+256 displaced by (oz-1,
//     oy-1) in z and y, a plain box of the [voxels, Ci] matrix, which TMA
//     copies (two boxes: a box has at most 256 rows) with the 64-byte
//     swizzle and zero-fills where it leaves the array. Tap ox of output
//     voxel m reads A row (m - m0) + ox, so one copy of x serves the three x
//     taps. The consumers take A through ldmatrix into registers (any row
//     offset is legal there, which a swizzled descriptor would not allow).
//     A row whose source lies inside the array but outside the volume (the
//     displaced voxel wraps into another row, plane or sample) holds another
//     voxel's values: the thread zeroes those fragment rows in registers, by
//     the edge bits of its own four rows;
//   * the three taps' weights [32 ci][128 co] as they lie in memory (co
//     contiguous: an MN-major B operand), two 3-D TMA boxes with the 128-byte
//     swizzle, read by wgmma through a descriptor.
// One lane of the last warpgroup produces: it waits for a stage's `empty`
// barrier and issues the stage's four copies, which land on its `full`
// barrier; kWgStages stages are in flight. The other warpgroups consume:
// each owns 128 of the 256 output voxels (two m64 tiles x n128, 128
// accumulators a thread), double-buffers its A fragments so that the next
// step's ldmatrix runs under the current step's wgmma, and releases the
// stage through `empty`.
__global__ void __launch_bounds__(kWgThreads, 1)
    conv3d_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_x_tail,
                            const __grid_constant__ CUtensorMap map_w,
                            float* __restrict__ y, Volume vol, int ci, int co) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kWgStages], empty[kWgStages];
  unsigned char* smem = align_1024(smem_raw);

  const int tid = threadIdx.x, wg = tid / 128;
  const int total = vol.voxels();
  const int m0 = blockIdx.x * kWgBM;
  const int n0 = blockIdx.y * kWgBN;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival with the byte count
      mbar_init(&empty[s], 4 * kWgConsumers);  // one lane of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int k_chunks = (ci + kWgBK - 1) / kWgBK;
  const int n_iter = 9 * k_chunks;

  if (wg == kWgConsumers) {
    // ------------------------------------------------------------ producer
    reg_dealloc<kProducerRegs>();
    if (tid == kWgConsumers * 128) {
      for (int it = 0; it < n_iter; ++it) {
        const int stage = it % kWgStages;
        mbar_wait(&empty[stage], ((it / kWgStages) & 1) ^ 1);
        unsigned char* sb = smem + stage * kWgStageBytes;
        unsigned char* sa = sb + kWgBBytes;
        const int zy = it / k_chunks, k0 = (it % k_chunks) * kWgBK;
        const int src = m0 - 1 + ((zy / 3 - 1) * vol.h + zy % 3 - 1) * vol.w;
        mbar_arrive_expect_tx(&full[stage], kWgBBytes + kWgABytes);
        tma_load_2d(sa, &map_x, &full[stage], k0, src);
        tma_load_2d(sa + kWgBM * kWgARow, &map_x_tail, &full[stage], k0, src + kWgBM);
        tma_load_3d(sb, &map_w, &full[stage], n0, k0, zy * 3);
        tma_load_3d(sb + kWgBHalf, &map_w, &full[stage], n0 + 64, k0, zy * 3);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<kConsumerRegs>();
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int g = lane / 4, q = lane % 4;
    const int row_base = wg * kWgMT * 64 + warp * 16;  // + mt·64: this warp's 16 rows
    EdgeBits edge = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int mt = 0; mt < kWgMT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const Pos p = locate(vol, m0 + row_base + mt * 64 + g + half * 8, total);
        const uint32_t bit = 1u << (2 * mt + half);
        if (p.z == 0) edge.z_lo |= bit;
        if (p.z == vol.d - 1) edge.z_hi |= bit;
        if (p.y == 0) edge.y_lo |= bit;
        if (p.y == vol.h - 1) edge.y_hi |= bit;
        if (p.x == 0) edge.x_lo |= bit;
        if (p.x == vol.w - 1) edge.x_hi |= bit;
      }

    float acc[kWgMT][64];
#pragma unroll
    for (int mt = 0; mt < kWgMT; ++mt)
#pragma unroll
      for (int c = 0; c < 64; ++c) acc[mt][c] = 0.f;

    // A step is one x tap of one stage: kK16 x kWgMT wgmma in one group,
    // their A fragments in one of two buffers. After step s is committed,
    // wait_group 1 says step s-1 is done: its buffer is free for step s+1
    // (which may lie in the next stage), and if s-1 ended a stage, so is that
    // stage. The three steps of a stage are unrolled, so that tap, k16 step
    // and buffer are constants in the code.
    constexpr int kK16 = kWgBK / 16;  // k16 steps of a stage
    uint32_t af[2][kK16][kWgMT][4];

    // the edge bits of the rows whose (oz, oy) neighbour leaves the volume
    auto zy_mask = [&](int zy) {
      return (zy / 3 == 0 ? edge.z_lo : zy / 3 == 2 ? edge.z_hi : 0u) |
             (zy % 3 == 0 ? edge.y_lo : zy % 3 == 2 ? edge.y_hi : 0u);
    };
    // the A fragments of x tap `ox` of iteration `it` into buffer `buf`
    auto load_frags = [&](int buf, int it, uint32_t mask_zy, int ox) {
      const uint32_t mask =
          mask_zy | (ox == 0 ? edge.x_lo : ox == 2 ? edge.x_hi : 0u);
      const uint32_t a_addr =
          smem_u32(smem + (it % kWgStages) * kWgStageBytes + kWgBBytes);
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
        for (int mt = 0; mt < kWgMT; ++mt) {
          const int row = row_base + mt * 64 + ox + lane % 16;
          ldmatrix_x4_addr(af[buf][kk][mt],
                           a_addr + sw64_offset(row, kk * 2 + lane / 16));
          // fragment registers 0, 2 hold row g of the m16 tile, 1, 3 row g+8
          if (mask >> (2 * mt) & 1u) af[buf][kk][mt][0] = af[buf][kk][mt][2] = 0u;
          if (mask >> (2 * mt + 1) & 1u) af[buf][kk][mt][1] = af[buf][kk][mt][3] = 0u;
        }
    };
    // iteration `it`, whose first step's fragments lie in buffer `first`
    auto iteration = [&](int first, int it, uint32_t mask_zy, uint32_t mask_next) {
      const uint32_t b_addr = smem_u32(smem + (it % kWgStages) * kWgStageBytes);
#pragma unroll
      for (int ox = 0; ox < 3; ++ox) {
        const int buf = (first + ox) & 1;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK16; ++kk) {
          const uint64_t desc = desc_mn_sw128(
              b_addr + ox * kWgBTap + kk * 16 * 128, kWgBHalf, 1024);
#pragma unroll
          for (int mt = 0; mt < kWgMT; ++mt)
            wgmma_m64n128k16_rs(acc[mt], af[buf][kk][mt], desc);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (ox == 0 && it > 0 && lane == 0)
          mbar_arrive(&empty[(it - 1) % kWgStages]);
        if (ox < 2) {
          load_frags(buf ^ 1, it, mask_zy, ox + 1);
        } else if (it + 1 < n_iter) {
          mbar_wait(&full[(it + 1) % kWgStages], ((it + 1) / kWgStages) & 1);
          load_frags(buf ^ 1, it + 1, mask_next, 0);
        }
      }
    };

    if (n_iter > 0) {
      mbar_wait(&full[0], 0);
      load_frags(0, 0, zy_mask(0), 0);
    }
    // iteration `it` is chunk `kc` of stencil row `zy`
    int zy = 0, kc = 0;
    uint32_t mask_zy = zy_mask(0);
    auto advance = [&]() {
      if (++kc == k_chunks) {
        kc = 0;
        ++zy;
      }
      return zy_mask(zy);
    };
    for (int it = 0; it < n_iter; it += 2) {
      uint32_t mask_next = advance();
      iteration(0, it, mask_zy, mask_next);
      mask_zy = mask_next;
      if (it + 1 < n_iter) {
        mask_next = advance();
        iteration(1, it + 1, mask_zy, mask_next);   // three steps: the buffers swap
        mask_zy = mask_next;
      }
    }
    wgmma_wait<0>();

#pragma unroll
    for (int mt = 0; mt < kWgMT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + row_base + mt * 64 + g + half * 8;
        if (row >= total) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + j * 8 + 2 * q;
          if (col < co)
            *reinterpret_cast<float2*>(&y[static_cast<size_t>(row) * co + col]) =
                make_float2(acc[mt][4 * j + 2 * half],
                            acc[mt][4 * j + 2 * half + 1]);
        }
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

// ---------------------------------------------------------- dW, bf16, wgmma
constexpr int kDwVox = 64;           // voxels per stage (the GEMM's K step)
constexpr int kDwCi = 64;            // input channels per dW tile (the GEMM's M)
constexpr int kDwThreads = 512;      // three consumer warpgroups and a producer
constexpr int kDwConsumers = 384;
// The CTA starts with 128 registers a thread; what the producer gives up the
// consumers take: 3·160 + 32 = 4·128.
constexpr int kDwConsumerRegs = 160;
constexpr int kDwProducerRegs = 32;
static_assert(3 * kDwConsumerRegs + kDwProducerRegs <= 4 * 128,
              "setmaxnreg.inc would wait for registers that never come");
constexpr int kDwTileCo = 128;       // output channels per dW tile (the GEMM's N)
constexpr int kDwHalo = kDwVox + 2;  // rows of the x tile: voxels v0-1 .. v0+64
constexpr int kDwDyHalf = kDwVox * 128;  // bytes of [64 voxels][64 co]
constexpr int kDwDyBytes = 2 * kDwDyHalf;
constexpr int kDwXBox = (kDwHalo * 128 + 1023) / 1024 * 1024;  // [66 voxels][64 ci]
constexpr int kDwKeepWords = kDwVox / 2;  // one 32-bit keep mask per voxel pair
static_assert(kDwKeepWords == 32, "one voxel pair per lane of a producer warp");

constexpr int kDwWgStageBytes =
    (kDwDyBytes + kDwXBox + 3 * kDwKeepWords * 4 + 1023) / 1024 * 1024;
constexpr int kDwWgStages = (227 * 1024 - 2048) / kDwWgStageBytes;
constexpr int kDwWgSmemBytes = kDwWgStages * kDwWgStageBytes + 1024;  // + alignment slack
// The resident scheme's partial tile, [3 x taps][64 ci][128 co] fp32, laid
// over the ring once the walk is done; kDwTileF4 float4 a tile.
constexpr int kDwTileF4 = 3 * kDwCi * kDwTileCo / 4;
static_assert(kDwTileF4 * 16 <= kDwWgStages * kDwWgStageBytes,
              "the partial tile must fit in the ring");
constexpr int kDwMaxCluster = 16;    // the non-portable limit; 8 is portable

// dW tile `tile` of a [27, ci, co] gradient: the three x taps of stencil row
// zy, input channels c0 .. c0+63, output channels n0 .. n0+127.
struct DwTile {
  int zy, c0, n0;
};

__device__ __forceinline__ DwTile dw_tile(int tile, int ci, int co) {
  const int co_tiles = (co + kDwTileCo - 1) / kDwTileCo;
  const int ci_tiles = (ci + kDwCi - 1) / kDwCi;
  return {tile / (co_tiles * ci_tiles), ((tile / co_tiles) % ci_tiles) * kDwCi,
          (tile % co_tiles) * kDwTileCo};
}

// The walk of both dW schemes: dW[tap] = x_tap^T · dy on wgmma for the three
// x taps of tile `t` (M = 64 input channels, N = 128 output channels), K =
// the voxels of stages chunk_lo .. chunk_lo + n_iter - 1, 64 voxels a stage.
// A stage holds
//   * dy [64 voxels][128 co] as it lies in memory (co contiguous: an MN-major
//     B operand), two TMA boxes of 64 channels with the 128-byte swizzle,
//     read by wgmma through a descriptor;
//   * one halo tile of x: the 66 voxels v0-1 .. v0+64 displaced by (oz-1,
//     oy-1), one TMA box of 64 channels of the [voxels, Ci] matrix with the
//     128-byte swizzle, zero where it leaves the array. Tap ox of voxel v
//     reads halo row (v - v0) + ox. x^T is the A operand; it comes from
//     registers through ldmatrix.trans, which takes any row offset;
//   * the keep masks: the voxel is the K index here, so a voxel whose
//     displaced neighbour lies outside the volume (and whose halo row holds
//     another voxel's values) is a column of the A fragment, half a
//     register. The producer writes one 32-bit AND mask per voxel pair and
//     x tap.
// The four warps of warpgroup 3 produce, taking the stages in turn: a warp
// waits for its stage's `empty` barrier, writes the keep masks (a lane per
// voxel pair), and one lane issues the copies, which land on the stage's
// `full` barrier. Warpgroups 0 to 2 consume, one x tap each: an m64n128
// accumulator (64 registers a thread), the A fragments double-buffered by
// k16 step. One A fragment so feeds a 128-wide wgmma: shared memory
// carries the B reads of wgmma, the ldmatrix reads and TMA's writes, and it,
// not the tensor cores, sets the pace when A fragments feed 64 columns.
// When the walk is done, the producer threads call `producer_tail()` and
// each consumer thread `consumer_tail(acc, ox)` with its tap's accumulator
// (thread (warp w, lane 4g + q) holds acc[4j + 2h + e] = dW[ox][16w + g +
// 8h][8j + 2q + e]); a CTA with no stage (n_iter 0) hands on zeros.
template <class ProducerTail, class ConsumerTail>
__device__ __forceinline__ void dw_walk(const CUtensorMap* map_x,
                                        const CUtensorMap* map_dy,
                                        unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, const Volume& vol,
                                        const DwTile& t, int chunk_lo,
                                        int n_iter, ProducerTail producer_tail,
                                        ConsumerTail consumer_tail) {
  constexpr int kStages = kDwWgStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int total = vol.voxels();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);    // the producer's arrival with the byte count
      mbar_init(&empty[s], 12);  // one lane of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 3) {
    // ------------------------------------------------------------ producer
    reg_dealloc<kDwProducerRegs>();
    const int dz = t.zy / 3 - 1, dyy = t.zy % 3 - 1;
    for (int it = warp; it < n_iter; it += 4) {
      const int stage = it % kStages;
      mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
      unsigned char* sdy = smem + stage * kDwWgStageBytes;
      uint32_t* keep = reinterpret_cast<uint32_t*>(sdy + kDwDyBytes + kDwXBox);
      const int v0 = (chunk_lo + it) * kDwVox;
      uint32_t k[3] = {0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const Pos p = locate(vol, v0 + 2 * lane + e, total);
        const int z = p.z + dz, yy = p.y + dyy;
        const bool in = p.ok && z >= 0 && z < vol.d && yy >= 0 && yy < vol.h;
        const uint32_t half = e ? 0xFFFF0000u : 0xFFFFu;
        if (in && p.x > 0) k[0] |= half;
        if (in) k[1] |= half;
        if (in && p.x < vol.w - 1) k[2] |= half;
      }
      // pair `lane` = 8·kk + 4·h + q goes to word 8·q + 2·kk + h: the eight
      // words of a consumer thread lie together
      const int word = (lane % 4) * 8 + (lane / 8) * 2 + (lane / 4) % 2;
#pragma unroll
      for (int ox = 0; ox < 3; ++ox) keep[ox * kDwKeepWords + word] = k[ox];
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], kDwDyBytes + kDwHalo * 128);
        tma_load_2d(sdy + kDwDyBytes, map_x, &full[stage], t.c0,
                    v0 - 1 + (dz * vol.h + dyy) * vol.w);
        tma_load_2d(sdy, map_dy, &full[stage], t.n0, v0);
        tma_load_2d(sdy + kDwDyHalf, map_dy, &full[stage], t.n0 + 64, v0);
      }
    }
    producer_tail();
  } else {
    // ----------------------------------------------- consumers: x tap `wg`
    reg_alloc<kDwConsumerRegs>();
    const int q = lane % 4;
    const int ox = wg;

    float acc[64];
#pragma unroll
    for (int c = 0; c < 64; ++c) acc[c] = 0.f;

    constexpr int kK16 = kDwVox / 16;  // k16 steps of a stage
    // A step is one stage: kK16 wgmma in one group, their A fragments in one
    // of two buffers. After step s is committed, wait_group 1 says
    // step s-1 is done: its stage and its buffer are free, and the buffer
    // takes the fragments of step s+1.
    uint32_t af0[kK16][4], af1[kK16][4];

    auto load_frags = [&](uint32_t (&af)[kK16][4], int it) {
      const unsigned char* sdy = smem + (it % kStages) * kDwWgStageBytes;
      const uint32_t x_addr = smem_u32(sdy + kDwDyBytes);
      // this thread's keep masks of the stage: word 2·kk + h for the voxel
      // pair (2q, 2q+1) + 8h of k16 step kk (fragment registers 2h, 2h+1)
      const uint4* keep = reinterpret_cast<const uint4*>(
          sdy + kDwDyBytes + kDwXBox) + (ox * kDwKeepWords + q * 8) / 4;
      const uint4 k01 = keep[0], k23 = keep[1];
      const uint32_t k[2 * kK16] = {k01.x, k01.y, k01.z, k01.w,
                                    k23.x, k23.y, k23.z, k23.w};
      // matrices 0, 1 of the x4: voxels kk·16 .. +7, channels 16·warp .. +7
      // and +8 .. +15; matrices 2, 3: voxels kk·16+8 .. +15
      const int mat = lane / 8;
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk) {
        const int row = kk * 16 + ox + lane % 8 + (mat / 2) * 8;
        ldmatrix_x4_trans_addr(af[kk],
                               x_addr + sw128_offset(row, 2 * warp + mat % 2));
        af[kk][0] &= k[2 * kk];
        af[kk][1] &= k[2 * kk];
        af[kk][2] &= k[2 * kk + 1];
        af[kk][3] &= k[2 * kk + 1];
      }
    };

    auto step = [&](uint32_t (&cur)[kK16][4], uint32_t (&nxt)[kK16][4], int it) {
      const uint32_t b_addr = smem_u32(smem + (it % kStages) * kDwWgStageBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk) {
        const uint64_t desc = desc_mn_sw128(b_addr + kk * 16 * 128, kDwDyHalf, 1024);
        wgmma_m64n128k16_rs(acc, cur[kk], desc);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      if (it + 1 < n_iter) {
        mbar_wait(&full[(it + 1) % kStages], ((it + 1) / kStages) & 1);
        load_frags(nxt, it + 1);
      }
    };

    if (n_iter > 0) {
      mbar_wait(&full[0], 0);
      load_frags(af0, 0);
    }
    for (int it = 0; it < n_iter; it += 2) {
      step(af0, af1, it);
      if (it + 1 < n_iter) step(af1, af0, it + 1);
    }
    wgmma_wait<0>();
    consumer_tail(acc, ox);
  }
}

// Workspace scheme: the tile blockIdx.x over the stages of slab blockIdx.y;
// the partial goes to out + slab·27·Ci·Co, and conv3d_dw_reduce_kernel adds
// the slabs' partials in order.
__global__ void __launch_bounds__(kDwThreads, 1)
    conv3d_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_dy,
                           float* __restrict__ out, Volume vol, int ci, int co,
                           int chunks_per_slab) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kDwWgStages], empty[kDwWgStages];
  const DwTile t = dw_tile(blockIdx.x, ci, co);
  const int chunks = (vol.voxels() + kDwVox - 1) / kDwVox;
  const int chunk_lo = min(chunks, static_cast<int>(blockIdx.y) * chunks_per_slab);
  const int n_iter = min(chunks, chunk_lo + chunks_per_slab) - chunk_lo;
  float* part = out + static_cast<size_t>(blockIdx.y) * 27 * ci * co;
  dw_walk(&map_x, &map_dy, align_1024(smem_raw), full, empty, vol, t, chunk_lo,
          n_iter, [] {}, [&](const float (&acc)[64], int ox) {
            const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
            const int g = lane / 4, q = lane % 4;
            float* tile = part + static_cast<size_t>(t.zy * 3 + ox) * ci * co;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = t.c0 + warp * 16 + g + half * 8;
              if (row >= ci) continue;
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                const int col = t.n0 + j * 8 + 2 * q;
                if (col < co)
                  *reinterpret_cast<float2*>(&tile[static_cast<size_t>(row) * co + col]) =
                      make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
              }
            }
          });
}

// Resident scheme: one thread-block cluster of `cluster` CTAs a tile
// (blockIdx.x / cluster); rank r walks stages r·per .. r·per + per - 1, per =
// ⌈stages / cluster⌉ (none where that starts past the end). Then each CTA
// lays its three taps' accumulators over its ring as [3][64][128] fp32,
// and after a cluster barrier rank r adds float4 r·share .. r·share +
// share - 1 of the tile (share = ⌈kDwTileF4 / cluster⌉) over ranks 0 ..
// cluster - 1 in rank order, through distributed shared memory, and writes
// that part of dW once. A second barrier keeps every CTA until the others
// have read its partial. No workspace, no second kernel, no atomics: the
// order of every sum is fixed by the shapes and the cluster size.
__global__ void __launch_bounds__(kDwThreads, 1)
    conv3d_dw_resident_kernel(const __grid_constant__ CUtensorMap map_x,
                              const __grid_constant__ CUtensorMap map_dy,
                              float* __restrict__ dw, Volume vol, int ci,
                              int co, int cluster_size) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kDwWgStages], empty[kDwWgStages];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const DwTile t = dw_tile(blockIdx.x / cluster_size, ci, co);
  const int chunks = (vol.voxels() + kDwVox - 1) / kDwVox;
  const int per = (chunks + cluster_size - 1) / cluster_size;
  const int chunk_lo = min(chunks, rank * per);
  const int n_iter = min(chunks, chunk_lo + per) - chunk_lo;
  unsigned char* smem = align_1024(smem_raw);
  float* part = reinterpret_cast<float*>(smem);
  dw_walk(&map_x, &map_dy, smem, full, empty, vol, t, chunk_lo, n_iter,
          [&] {
            cluster.sync();
            cluster.sync();
          },
          [&](const float (&acc)[64], int ox) {
            const int tid = threadIdx.x;  // < kDwConsumers
            const int lane = tid % 32, warp = (tid % 128) / 32;
            const int g = lane / 4, q = lane % 4;
            bar_sync(1, kDwConsumers);  // every consumer is done with the ring
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float* row = part + (ox * kDwCi + warp * 16 + g + half * 8) * kDwTileCo;
#pragma unroll
              for (int j = 0; j < 16; ++j)
                *reinterpret_cast<float2*>(&row[j * 8 + 2 * q]) =
                    make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
            }
            cluster.sync();
            const int share = (kDwTileF4 + cluster_size - 1) / cluster_size;
            const int lo = min(kDwTileF4, rank * share);
            const int hi = min(kDwTileF4, lo + share);
            for (int i = lo + tid; i < hi; i += kDwConsumers) {
              float4 s = reinterpret_cast<const float4*>(
                  cluster.map_shared_rank(part, 0))[i];
              for (int r = 1; r < cluster_size; ++r) {
                const float4 v = reinterpret_cast<const float4*>(
                    cluster.map_shared_rank(part, r))[i];
                s.x += v.x;
                s.y += v.y;
                s.z += v.z;
                s.w += v.w;
              }
              // float4 i is x tap i / 2048, input channel row, output channels col ..
              // col + 3 of the tile (Co is a multiple of 8: all in or all out)
              const int tap = t.zy * 3 + i / (kDwCi * kDwTileCo / 4);
              const int row = t.c0 + (i / (kDwTileCo / 4)) % kDwCi;
              const int col = t.n0 + (i % (kDwTileCo / 4)) * 4;
              if (row < ci && col < co)
                *reinterpret_cast<float4*>(
                    &dw[(static_cast<size_t>(tap) * ci + row) * co + col]) = s;
            }
            cluster.sync();  // no CTA leaves while another reads its partial
          });
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

int launch_fwd_wgmma(const void* x, const void* w, void* y, Volume vol, int ci,
                     int co, cudaStream_t st) {
  const int total = vol.nb * vol.d * vol.h * vol.w;
  CUtensorMap map_x, map_x_tail, map_w;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(ci),
                              static_cast<uint64_t>(total)};
  const uint64_t w_dims[3] = {static_cast<uint64_t>(co),
                              static_cast<uint64_t>(ci), 27};
  const uint32_t x_box[2] = {kWgBK, kWgBM}, tail_box[2] = {kWgBK, kWgHalo - kWgBM};
  const uint32_t w_box[3] = {64, kWgBK, 3};
  if (!make_map(&map_x, x, 2, x_dims, x_box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&map_x_tail, x, 2, x_dims, tail_box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&map_w, w, 3, w_dims, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((total + kWgBM - 1) / kWgBM, (co + kWgBN - 1) / kWgBN);
  conv3d_fwd_wgmma_kernel<<<grid, kWgThreads, kWgSmemBytes, st>>>(
      map_x, map_x_tail, map_w, static_cast<float*>(y), vol, ci, co);
  return static_cast<int>(cudaGetLastError());
}

// The dW kernels' tensor maps: x and dy as [voxels, C] matrices, x in the
// 66-voxel halo boxes, dy in [64 voxels][64 co] boxes.
bool make_dw_maps(CUtensorMap* map_x, CUtensorMap* map_dy, const void* x,
                  const void* dy, const Volume& vol, int ci, int co) {
  const uint64_t total = static_cast<uint64_t>(vol.nb) * vol.d * vol.h * vol.w;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(ci), total};
  const uint64_t dy_dims[2] = {static_cast<uint64_t>(co), total};
  const uint32_t x_box[2] = {kDwCi, kDwHalo}, dy_box[2] = {64, kDwVox};
  return make_map(map_x, x, 2, x_dims, x_box, CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_map(map_dy, dy, 2, dy_dims, dy_box, CU_TENSOR_MAP_SWIZZLE_128B);
}

int dw_tiles(int ci, int co) {
  return 9 * ((ci + kDwCi - 1) / kDwCi) * ((co + kDwTileCo - 1) / kDwTileCo);
}

int launch_dw_wgmma(const void* x, const void* dy, void* out, Volume vol, int ci,
                    int co, int slabs, cudaStream_t st) {
  CUtensorMap map_x, map_dy;
  if (!make_dw_maps(&map_x, &map_dy, x, dy, vol, ci, co))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDwWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (vol.voxels() + kDwVox - 1) / kDwVox;
  dim3 grid(dw_tiles(ci, co), slabs);
  conv3d_dw_wgmma_kernel<<<grid, kDwThreads, kDwWgSmemBytes, st>>>(
      map_x, map_dy, static_cast<float*>(out), vol, ci, co,
      (chunks + slabs - 1) / slabs);
  return static_cast<int>(cudaGetLastError());
}

// The resident kernel's attributes (its shared memory; above the portable 8
// a cluster, the non-portable size) and the launch of `tiles` clusters of
// `cluster` CTAs.
cudaError_t resident_config(int cluster, int tiles, cudaStream_t st,
                            cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (cluster < 1 || cluster > kDwMaxCluster) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_dw_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDwWgSmemBytes);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(conv3d_dw_resident_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = {};
  cfg->gridDim = dim3(tiles * cluster);
  cfg->blockDim = dim3(kDwThreads);
  cfg->dynamicSmemBytes = kDwWgSmemBytes;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

int launch_dw_resident(const void* x, const void* dy, void* dw, Volume vol,
                       int ci, int co, int cluster, cudaStream_t st) {
  CUtensorMap map_x, map_dy;
  if (!make_dw_maps(&map_x, &map_dy, x, dy, vol, ci, co))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = resident_config(cluster, dw_tiles(ci, co), st, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, conv3d_dw_resident_kernel, map_x, map_dy,
                             static_cast<float*>(dw), vol, ci, co, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  return launch_fwd_wgmma(x, w, y, vol, ci, co, st);
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

extern "C" int conv3d_dw_workspace_bf16(const void* x, const void* dy,
                                        void* workspace, void* dw, int nb,
                                        int d, int h, int wd, int ci, int co,
                                        int slabs, void* stream) {
  if (ci % 8 || co % 8 || slabs < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_dw_wgmma(x, dy, workspace, Volume{nb, d, h, wd}, ci,
                                  co, slabs, st);
  return err ? err : launch_reduce(workspace, dw, ci, co, slabs, st);
}

// `cluster` CTAs a dW tile (1 .. 16); a launch the card refuses (too many
// CTAs of this size for one GPC: cudaErrorClusterOutOfResources) returns
// its error and is not retried.
extern "C" int conv3d_dw_resident_bf16(const void* x, const void* dy, void* dw,
                                       int nb, int d, int h, int wd, int ci,
                                       int co, int cluster, void* stream) {
  if (ci % 8 || co % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw_resident(x, dy, dw, Volume{nb, d, h, wd}, ci, co, cluster,
                            static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` resident-dW CTAs the current device holds
// at once (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int conv3d_dw_resident_clusters(int cluster, int* active) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = resident_config(cluster, 1, nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(active, conv3d_dw_resident_kernel, &cfg);
  return static_cast<int>(err);
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
