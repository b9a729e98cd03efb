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
// the workspace dW run on wgmma, fed by TMA through a ring of shared-memory
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
//     depend on the schedule, so neither scheme uses them. Workspace scheme:
//     a CTA owns 3 taps (one stencil row) x 64 x 128 of dW over a slab of the
//     voxels, one consumer warpgroup per x tap (m64n128 each, so an A
//     fragment feeds 128 columns, and one wgmma group per stage; two
//     warpgroups of 3 x m64n64 took a third longer; a 128-channel tile, 2 x
//     m64n128 a warpgroup, does not fit the 160 registers four warpgroups
//     leave, and ptxas serializes its wgmma). Each (tile, slab) CTA writes
//     its partial to workspace[slab] and a second kernel adds the partials
//     in slab order: bitwise repeatable. The wrapper cuts the voxels into as
//     many slabs as fill whole waves of SMs (11 or 22 at the policy's convs,
//     396 CTAs on 132 SMs). A cluster reduction through distributed shared
//     memory was not built: the workspace is 39 MB, written and read once;
//   * resident scheme (off the training path): tiles of 1 tap x 64 x 64 on
//     mma.sync, one CTA per tile walks every voxel and writes dW once: no
//     workspace and no second pass, but x and dy are read once per owner (27
//     x Ci/64 x Co/64 owners);
//   * fp32 inputs (the parity paths): one thread per output element.
// Not done: TMA multicast of the weights or of dy across a cluster (with all
// SMs busy a step takes 15 % longer than on a few, the share of L2), a
// persistent CTA whose stores overlap the next tile's loads, a fused
// bias/activation/bf16 epilogue. The measured times stand in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

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

// ---------------------------------------------------------- dW, bf16, wgmma
constexpr int kDwThreads = 512;      // three consumer warpgroups and a producer
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

// dW[tap] = x_tap^T · dy on wgmma: M = 64 input channels, N = 128 output
// channels, K = the voxels of slab blockIdx.y in steps of 64, for the three x
// taps of stencil row blockIdx.x / (tiles of Ci x tiles of Co). The partial
// tile goes to out + slab·27·Ci·Co. A stage holds
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
__global__ void __launch_bounds__(kDwThreads, 1)
    conv3d_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_dy,
                           float* __restrict__ out, Volume vol, int ci, int co,
                           int chunks_per_slab) {
  constexpr int kStages = kDwWgStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  unsigned char* smem = align_1024(smem_raw);

  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int total = vol.voxels();
  const int co_tiles = (co + kDwTileCo - 1) / kDwTileCo;
  const int ci_tiles = (ci + kDwCi - 1) / kDwCi;
  const int n0 = (blockIdx.x % co_tiles) * kDwTileCo;
  const int c0 = ((blockIdx.x / co_tiles) % ci_tiles) * kDwCi;
  const int zy = blockIdx.x / (co_tiles * ci_tiles);
  const int chunks = (total + kDwVox - 1) / kDwVox;
  const int chunk_lo = min(chunks, static_cast<int>(blockIdx.y) * chunks_per_slab);
  const int n_iter = min(chunks, chunk_lo + chunks_per_slab) - chunk_lo;

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
    const int dz = zy / 3 - 1, dyy = zy % 3 - 1;
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
        tma_load_2d(sdy + kDwDyBytes, &map_x, &full[stage], c0,
                    v0 - 1 + (dz * vol.h + dyy) * vol.w);
        tma_load_2d(sdy, &map_dy, &full[stage], n0, v0);
        tma_load_2d(sdy + kDwDyHalf, &map_dy, &full[stage], n0 + 64, v0);
      }
    }
  } else {
    // ----------------------------------------------- consumers: x tap `wg`
    reg_alloc<kDwConsumerRegs>();
    const int g = lane / 4, q = lane % 4;
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

    float* tile = out + static_cast<size_t>(blockIdx.y) * 27 * ci * co +
                  static_cast<size_t>(zy * 3 + ox) * ci * co;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = c0 + warp * 16 + g + half * 8;
      if (row >= ci) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + j * 8 + 2 * q;
        if (col < co)
          *reinterpret_cast<float2*>(&tile[static_cast<size_t>(row) * co + col]) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
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

int launch_dw_wgmma(const void* x, const void* dy, void* out, Volume vol, int ci,
                    int co, int slabs, cudaStream_t st) {
  const int total = vol.nb * vol.d * vol.h * vol.w;
  CUtensorMap map_x, map_dy;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(ci),
                              static_cast<uint64_t>(total)};
  const uint64_t dy_dims[2] = {static_cast<uint64_t>(co),
                               static_cast<uint64_t>(total)};
  const uint32_t x_box[2] = {kDwCi, kDwHalo}, dy_box[2] = {64, kDwVox};
  if (!make_map(&map_x, x, 2, x_dims, x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&map_dy, dy, 2, dy_dims, dy_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDwWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (total + kDwVox - 1) / kDwVox;
  const int tiles = 9 * ((ci + kDwCi - 1) / kDwCi) *
                    ((co + kDwTileCo - 1) / kDwTileCo);
  dim3 grid(tiles, slabs);
  conv3d_dw_wgmma_kernel<<<grid, kDwThreads, kDwWgSmemBytes, st>>>(
      map_x, map_dy, static_cast<float*>(out), vol, ci, co,
      (chunks + slabs - 1) / slabs);
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
