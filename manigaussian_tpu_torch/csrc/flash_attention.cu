// Flash self-attention for Hopper (sm_90a): the forward (with dropout, the
// log-sum-exp it saves for the backward and, in training, the dropout mask
// as bits) and the backward.
//
// Replaces the Pallas kernels of manigaussian_tpu/ops/flash_attention.py:
//   * `_fwd_kernel` (pallas_call in `_flash_fwd_impl`):
//       out = dropout(softmax((q * d^-1/2) k^T)) v   per (batch*head);
//   * `_bwd_kernel` (pallas_call in `_flash_bwd_impl`): dq, dk, dv.
// q/k/v/out [BH, N, D]. Semantics kept from the TPU kernels: q*scale is
// rounded in q's dtype (the scale itself first rounded to that dtype), scores
// and softmax are fp32, the probabilities are rounded to v's dtype before the
// P·V product, which accumulates in fp32, and the output is written in q's
// dtype. The backward rounds P_dropped to dO's dtype for dV and dS (which
// carries the exact fp32 scale) to q's dtype for dQ and dK, as the TPU kernel.
//
// Dropout: the keep mask is the TPU kernel's murmur3 hash of
// (seed, bh·65536 + i, r, col), with i = row / block_q the index of the TPU's
// query block and r = row % block_q the row inside it, so the mask is the
// same bit for bit. The hash is murmur3's finaliser of row part ^
// col·0x85EBCA77, the row part (seed + (bh·65536 + i)·2654435761) ^
// r·0x9E3779B1: the kernels compute it once per row and the column part once
// per key (the forward's producer warp writes a tile's beside its copies), so
// no division sits in an inner loop (`Dropout` has the rest). `bh` is the
// global batch·head index: a call that holds the rows of one rank of a
// data-parallel batch passes its first global row × heads as `bh_offset`,
// which the row part adds to the kernel's own bh, so that each rank drops
// what the one-device call drops on the same rows. The row sum of the online softmax adds the unmasked
// probabilities; only the P·V product sees the mask, and 1/(1-rate) is
// applied with the final normalisation.
//
// Bounds on an H100 at the policy's shapes (BH=8, N=2048, D=64, bf16):
//   forward:  4·BH·N²·D = 8.6 GFLOP / 989 TFLOP/s ≈ 8.7 us (its 8.4 MB of
//             q, k, v, out take ≈ 2.5 us at 3.35 TB/s); with dropout the
//             mask's integer work, 7 operations a score in the factored form
//             below (`Dropout`), 14 us;
//   backward: 10·BH·N²·D = 21.5 GFLOP ≈ 21.7 us (≈ 21 MB with the keep
//             bits ≈ 6 us).
// Both are bound by the tensor cores (and the integer pipes), so the bf16
// kernels are FlashAttention-3's shape on wgmma, fed by TMA:
//   * a CTA of three warpgroups: two consumers that own 64 rows each and a
//     producer warp, one thread of which keeps TMA copies of the operand
//     tiles in flight through a ring of shared-memory stages with mbarrier
//     full/empty pairs (its other lanes write what the consumers read beside
//     the tiles: column parts of the hash, LSE, delta, mask words). setmaxnreg
//     gives the consumers 232 registers and the producer 40
//     (2·232 + 40 = 3·168, what 384 threads are launched with);
//   * every product is wgmma m64nNk16 with A in registers: the fragment of
//     mma.sync for each warp's 16 rows. The operand loaded once per CTA (q,
//     or k and v in the dK/dV pass) is read from memory straight into A
//     registers (q scaled there in bf16: TMA cannot round); a product's
//     probabilities are re-packed from its fp32 accumulators as the A operand
//     of the next product. B comes from the TMA tiles through descriptors:
//     K-major (k for S = q·k^T, dO for dP) or MN-major (v for P·V, dO for dV,
//     q for dK, k for dQ) as they lie in memory, with the swizzle of their
//     row's width (2·D bytes: 128, 64 or 32);
//   * the softmax in exp2: s·log2(e) is one FMA into ex2.approx (relative
//     error ≈ 2^-22 against expf's ≈ 2^-23, far below the bf16 rounding of P
//     that follows); the running max is kept in log2 units, the saved LSE in
//     natural units (m·ln 2 + ln l), which the backward scales by log2(e);
//   * ragged N: the TMA boxes are 3-D ([BH, N, D]), so rows past N arrive as
//     zeros; keys past N score -inf in the forward (in a copy of the softmax
//     for the last tile alone), carry LSE = +inf in the dK/dV pass and need
//     nothing in the dQ pass (their k rows are zeros); rows past N are not
//     stored.
//   * forward: one CTA per (bh, 128 query rows): 128 CTAs, one wave, at the
//     policy's shape; 128-key K and V tiles, four stages. S = q·k^T is
//     m64n128, O += P·V m64nD. The two consumer warpgroups alternate by named
//     barriers: one issues its P·V of tile t-1 and its S of tile t while the
//     other runs its softmax and dropout mask on the integer and special
//     function pipes (the mask of an element: five integer-pipe operations
//     and two multiplies for the hash and its compare, then two predicated
//     instructions; `Dropout`, `keep_or_drop`). With the LSE in training, the forward also writes the
//     keep mask as bits (`keep_bits`, [BH, N, W] uint32, W = ⌈N/128⌉·4, bit
//     c % 32 of word c / 32 for key c, 0 past N): 4 MB at the policy's shape;
//   * backward, deterministic, no atomics (the TPU kernel accumulates dK/dV
//     across its sequential grid; CUDA blocks run in no order), bitwise
//     repeatable:
//       (b) first, then (a): (b) writes delta_i = rowsum(dO ∘ O) in fp32
//           and qs = bf16(q·bf16(scale)) for (a) from its A fragments;
//       (a) one CTA per (bh, 128 keys), looping over 64-query stages (six in
//           the ring, as in (b)) of qs,
//           q and dO (TMA), with the stage's LSE, delta and mask words
//           written beside them by the producer warp: S^T = k·qs^T and
//           dP^T = v·dO^T (m64n64), then dV += P_d^T·dO and dK += dS^T·q
//           (m64nD), the accumulators in registers;
//       (b) one CTA per (bh, 128 queries), looping over 64-key stages of k
//           and v: S and dP (m64n64), dQ += dS·k (m64nD).
//     The consumer warpgroups of both passes alternate as in the forward:
//     one issues the products of stage t-1's dS (and P) and stage t's S
//     and dP while the other computes its dS.
//     With dropout both passes read the forward's keep bits (a load of a
//     stage's words, then an AND an element) and hash nothing: on an H100 at
//     the policy's shape that was faster than hashing the mask in both
//     passes.
//     delta is rowsum(dO ∘ O), equal to Σ_j P_ij·dP_ij (the TPU kernel's
//     form) up to the rounding of O to its dtype.
//   * fp32 (the parity paths, off the main path): plain FMA (full fp32, no
//     TF32), one thread per row.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBlockM = 64;   // fp32 forward: query rows per CTA
constexpr int kWarps = 4;     // fp32 delta pass: rows per CTA
constexpr int kThreads = kWarps * 32;

constexpr uint32_t kColMul = 0x85EBCA77u;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The keep test, fmix(row part ^ column part) >= thresh with fmix murmur3's
// finaliser (h ^= h >> 16; h *= 0x85EBCA6B; h ^= h >> 13; h *= 0xC2B2AE35;
// h ^= h >> 16), with its first step taken by each part alone, where it is computed once
// (it distributes over the XOR), and its last step folded into the compare:
// h ^ (h >> 16) >= T exactly when h ^ (T >> 16) >= T (the step leaves the
// high half alone, and where the high halves tie, the low half it makes is
// the one T >> 16 makes). An element costs five integer-pipe operations (the
// compare among them) and two multiplies, where the direct form takes eight
// and two.
struct Dropout {
  bool on;
  uint32_t seed;
  uint32_t thresh;
  uint32_t bh0;  // the global batch·head index of this call's head 0
  int block_q;
  float scale;  // 1 / (1 - rate)

  // the part of the hash that depends on the query row only, mixed
  __device__ __forceinline__ uint32_t row_mix(int bh, int row) const {
    const uint32_t i = static_cast<uint32_t>(row / block_q);
    const uint32_t r = static_cast<uint32_t>(row % block_q);
    const uint32_t h = (seed + ((static_cast<uint32_t>(bh) + bh0) * 65536u + i) * 2654435761u) ^
                       (r * 0x9E3779B1u);
    return h ^ (h >> 16);
  }
  // the key column's part, col·kColMul, mixed
  __device__ __forceinline__ static uint32_t col_mix(int col) {
    const uint32_t h = static_cast<uint32_t>(col) * kColMul;
    return h ^ (h >> 16);
  }
  // the hash of an element from its row's and its column's mixed parts, with
  // the last step folded in: the element is kept where it is >= thresh
  __device__ __forceinline__ uint32_t hashed(uint32_t row_mix, uint32_t col_mix) const {
    uint32_t h = (row_mix ^ col_mix) * 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (thresh >> 16);
  }
  // keep factor of element (query row, key col) of head bh: 0 or 1
  __device__ __forceinline__ float factor(int bh, int row, int col) const {
    if (!on) return 1.f;
    return hashed(row_mix(bh, row), col_mix(col)) >= thresh ? 1.f : 0.f;
  }
};

// The forward's mask of one element: where hashed >= thresh (kept) ORs `bit`
// into `bits`, elsewhere zeroes `p`: one compare and two predicated
// instructions, where C++ makes the compiler turn the predicate into a value
// and back.
__device__ __forceinline__ void keep_or_drop(float& p, uint32_t& bits,
                                             uint32_t hashed, uint32_t thresh,
                                             uint32_t bit) {
  asm("{\n"
      ".reg .pred k;\n"
      "setp.ge.u32 k, %2, %3;\n"
      "@!k mov.f32 %0, 0f00000000;\n"
      "@k or.b32 %1, %1, %4;\n"
      "}\n"
      : "+f"(p), "+r"(bits)
      : "r"(hashed), "r"(thresh), "r"(bit));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a bf16x2 register times a bf16 scale, rounded back to bf16 (the product of
// two bf16 values is exact in fp32, so this is the correctly rounded bf16
// product, as the TPU kernel's `q_blk * asarray(scale, dtype)`)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ------------------------------------------------- warp-specialized CTAs
constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kWsThreads = (kConsumers + 1) * 128;  // and a producer warpgroup
// The CTA starts with 168 registers a thread (65,536 / 384, in eights); what
// the producer gives up the consumers take.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
static_assert(kConsumers * kConsumerRegs + kProducerRegs <=
                  (kConsumers + 1) * (65536 / kWsThreads / 8 * 8),
              "setmaxnreg.inc would wait for registers that never come");
constexpr int kSchedBarrier = 1;  // named barriers 1, 2: the consumers' turns

constexpr int kFwdRows = 128;  // query rows per forward CTA, 64 per consumer
constexpr int kFwdKeys = 128;  // keys per forward stage
constexpr int kFwdStages = 4;
constexpr int kBwdRows = 128;  // keys (dK/dV) or queries (dQ) per CTA
constexpr int kBwdTile = 64;   // queries (dK/dV) or keys (dQ) per stage
constexpr int kBwdStages = 6;

// words of a row of the keep bits: a 128-key tile is one 16-byte vector
__host__ __device__ __forceinline__ int keep_words(int n) {
  return (n + 127) / 128 * 4;
}

template <int D>
struct Layout {
  static_assert(D == 16 || D == 32 || D == 64, "head dim");
  static constexpr int kRowBytes = 2 * D;  // a tile row; also its swizzle
  static constexpr uint32_t kGroup = 8 * kRowBytes;  // 8 rows: the SBO
  static constexpr int kFwdTile = kFwdKeys * kRowBytes;
  static constexpr int kFwdStage = 2 * kFwdTile;  // k, v
  // the stages, then each stage's mixed column parts of the dropout hash
  static constexpr int kFwdSmem = kFwdStages * (kFwdStage + kFwdKeys * 4) + 1024;
  static constexpr int kBwdTileBytes = kBwdTile * kRowBytes;
  // dK/dV stage: qs, q, dO, then the LSE·log2(e) and delta of the stage's 64
  // queries and their mask words [4][64]
  static constexpr int kKvStats = kBwdTile * 4 * (2 + 4);
  static constexpr int kKvStage =
      (3 * kBwdTileBytes + kKvStats + 1023) / 1024 * 1024;
  static constexpr int kKvSmem = kBwdStages * kKvStage + 1024;
  static constexpr int kQStage = 2 * kBwdTileBytes;  // dQ stage: k, v
  static constexpr int kQSmem = kBwdStages * kQStage + 1024;
  static_assert(kBwdTileBytes % 1024 == 0, "tiles stay 1024-byte aligned");
};

// The A fragments of rows r0 and r0 + 8 (the m16k16 fragment of mma.sync
// for a warp's 16 rows) of a [n, D] bf16 matrix, zero past row n, each
// value times `s` rounded to bf16 (s = 1: unchanged).
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4],
                                            const bf16* m, int r0, int n,
                                            int qd, float s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + (i & 1) * 8, c = kk * 16 + (i >> 1) * 8 + 2 * qd;
      const uint32_t x =
          r < n ? *reinterpret_cast<const uint32_t*>(m + static_cast<size_t>(r) * D + c)
                : 0u;
      a[kk][i] = s == 1.f ? x : scale_bf16x2(x, s);
    }
}

// The A fragments of k16 step kk from an accumulator of 16·K16 columns in
// the wgmma layout: columns 16kk .. 16kk + 15 of the thread's two rows.
template <int K16>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K16][4],
                                       const float (&acc)[K16 * 8]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// Stores rows r0 and r0 + 8 of a [64 x D] accumulator (wgmma layout) into a
// [n, D] bf16 matrix, rows past n skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* m, const float (&acc)[D / 2],
                                           int r0, int n, int qd, float s0,
                                           float s1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= n) continue;
    const float sc = h ? s1 : s0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(m + static_cast<size_t>(r) * D + j * 8 + 2 * qd) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * sc, acc[4 * j + 2 * h + 1] * sc);
  }
}

// ----------------------------------------------------------------- bf16 fwd
// A consumer thread (warp w, lane 4g + q of its warpgroup) owns rows
// r0 = row0 + 64·wg + 16w + g and r0 + 8 and, in a 128-key tile, the keys
// 8j + 2q + e (j < 16, e < 2): S element 4j + 2h + e is (r0 + 8h, key).
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const bf16* __restrict__ q, bf16* __restrict__ out,
                          float* __restrict__ lse,
                          uint32_t* __restrict__ keep_bits, int n, float scale,
                          Dropout drop) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kFwdStages], empty[kFwdStages];
  unsigned char* smem = align_1024(smem_raw);
  uint32_t* s_cols = reinterpret_cast<uint32_t*>(smem + kFwdStages * L::kFwdStage);

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y;
  const int n_tiles = (n + kFwdKeys - 1) / kFwdKeys;

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's arrival with the bytes
      mbar_init(&empty[s], 4 * kConsumers);  // one lane of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    reg_dealloc<kProducerRegs>();
    if (tid < kConsumers * 128 + 32) {  // one warp: the tiles' column parts
      const int lane = tid % 32;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kFwdStages;
        mbar_wait(&empty[s], ((t / kFwdStages) & 1) ^ 1);
        if (drop.on)
          for (int i = lane; i < kFwdKeys; i += 32)
            s_cols[s * kFwdKeys + i] = Dropout::col_mix(t * kFwdKeys + i);
        __syncwarp();
        if (lane == 0) {  // and one thread the copies
          unsigned char* sk = smem + s * L::kFwdStage;
          mbar_arrive_expect_tx(&full[s], L::kFwdStage);
          tma_load_3d(sk, &map_k, &full[s], 0, t * kFwdKeys, bh);
          tma_load_3d(sk + L::kFwdTile, &map_v, &full[s], 0, t * kFwdKeys, bh);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<kConsumerRegs>();
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int g = lane / 4, qd = lane % 4;
    const int r0 = blockIdx.x * kFwdRows + wg * 64 + warp * 16 + g;

    // Q, scaled in bf16 (the TPU kernel's `q_blk * asarray(scale, dtype)`)
    uint32_t qa[D / 16][4];
    load_a_rows<D>(qa, q + static_cast<size_t>(bh) * n * D, r0, n, qd,
                   __bfloat162float(__float2bfloat16(scale)));
    const uint32_t rm[2] = {drop.row_mix(bh, r0), drop.row_mix(bh, r0 + 8)};
    const int words = keep_words(n);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m2[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 units
    float l[2] = {0.f, 0.f};
    float s[64];
    uint32_t pa[kFwdKeys / 16][4];  // P of the tile before, as A fragments

    // P·V of tile t (its V in stage t % kFwdStages), P in pa
    auto issue_pv = [&](int t) {
      const uint32_t v_addr =
          smem_u32(smem + (t % kFwdStages) * L::kFwdStage + L::kFwdTile);
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk)
        wgmma_rs<D, 1>(o, pa[kk],
                       desc_mn_major<L::kRowBytes>(v_addr + kk * 16 * L::kRowBytes,
                                                   L::kFwdTile, L::kGroup),
                       1);
    };

    // The online softmax of tile t's S (in place: P, then the dropped P) and
    // the tile's keep bits; alpha, the rescale of O, out.
    auto softmax = [&](int t, int stage, float (&alpha)[2], auto ragged_tag) {
      constexpr bool kRagged = decltype(ragged_tag)::value;
      const int key0 = t * kFwdKeys;
      if constexpr (kRagged) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (key0 + 8 * j + 2 * qd + e >= n)
              s[4 * j + e] = s[4 * j + 2 + e] = -CUDART_INF_F;
      }
      // online softmax over this tile, in log2 units
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m2[h], mx[h] * kLog2e);
        alpha[h] = ex2(m2[h] - m_new);
        m2[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[4 * j + 2 * h + e], kLog2e, -m2[h]));
            s[4 * j + 2 * h + e] = p;
            rs[h] += p;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
      if (!drop.on) return;
      // the mask; the row sums above saw the unmasked probabilities. The
      // mixed column parts of keys 8j + 2q and 8j + 2q + 1:
      const uint2* cols = reinterpret_cast<const uint2*>(s_cols + stage * kFwdKeys) + qd;
      // this thread's part of word w = j / 4 of the tile's keep bits: bit
      // 8(j % 4) + e (+ 2q below) for key 8j + 2q + e, 0 past key n
      uint32_t xw[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint2 cm = cols[4 * j];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = !kRagged || key0 + 8 * j + 2 * qd + e < n;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            keep_or_drop(s[4 * j + 2 * h + e], xw[h][j / 4],
                         drop.hashed(rm[h], e ? cm.y : cm.x), drop.thresh,
                         in ? 1u << (8 * (j % 4) + e) : 0u);
        }
      }
      if (keep_bits == nullptr) return;
      // the quad's four parts of each word OR-ed together, lane q left with
      // word q: two exchanges (the half it keeps, then the word)
      const bool hi = qd & 2, odd = qd & 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t x[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) x[w] = xw[h][w] << (2 * qd);
        uint32_t a0 = hi ? x[2] : x[0], a1 = hi ? x[3] : x[1];
        a0 |= __shfl_xor_sync(0xffffffffu, hi ? x[0] : x[2], 2);
        a1 |= __shfl_xor_sync(0xffffffffu, hi ? x[1] : x[3], 2);
        uint32_t mine = odd ? a1 : a0;
        mine |= __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
        const int r = r0 + 8 * h;
        if (r < n)
          keep_bits[(static_cast<size_t>(bh) * n + r) * words + 4 * t + qd] = mine;
      }
    };

    // Tile t: this warpgroup's turn on the tensor cores (S of tile t, then
    // P·V of tile t-1, two commit groups), then the softmax of S while P·V
    // still runs and the other warpgroup takes its turn. O is rescaled once
    // P·V is done. Tile 0, which has no P·V before it, is peeled off
    // (`with_pv` a constant): a wgmma under a run-time condition makes
    // ptxas serialize them all (C7520).
    auto tile = [&](int t, auto with_pv) {
      constexpr bool kPv = decltype(with_pv)::value;
      const int stage = t % kFwdStages;
      mbar_wait(&full[stage], (t / kFwdStages) & 1);
      bar_sync(kSchedBarrier + wg, 256);
      const uint32_t k_addr = smem_u32(smem + stage * L::kFwdStage);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<kFwdKeys, 0>(s, qa[kk],
                              desc_k_major<L::kRowBytes>(k_addr + kk * 32, L::kGroup),
                              kk);
      wgmma_commit();
      if constexpr (kPv) {
        issue_pv(t - 1);
        wgmma_commit();
      }
      if (wg == 0 || t + 1 < n_tiles) bar_arrive(kSchedBarrier + (wg ^ 1), 256);
      wgmma_wait<kPv ? 1 : 0>();
      fence_regs(s);

      // the softmax and mask of a tile with keys past n (the last, when n is
      // no multiple of 128) in their own copy: checked per element in one,
      // they would cost every tile a select
      float alpha[2];
      if ((t + 1) * kFwdKeys > n)
        softmax(t, stage, alpha, std::true_type{});
      else
        softmax(t, stage, alpha, std::false_type{});
      // P·V of tile t-1 done: stage t-1 is free, O and pa may change
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (kPv && lane == 0) mbar_arrive(&empty[(t - 1) % kFwdStages]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * j + 2 * h] *= alpha[h];
          o[4 * j + 2 * h + 1] *= alpha[h];
        }
      pack_a<kFwdKeys / 16>(pa, s);
    };
    if (wg == 1) bar_arrive(kSchedBarrier, 256);  // warpgroup 0 goes first
    tile(0, std::false_type{});
    for (int t = 1; t < n_tiles; ++t) tile(t, std::true_type{});
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const float dscale = drop.on ? drop.scale : 1.f;
    store_rows<D>(out + static_cast<size_t>(bh) * n * D, o, r0, n, qd,
                  dscale / l[0], dscale / l[1]);
    if (lse != nullptr && qd == 0) {
      float* lh = lse + static_cast<size_t>(bh) * n;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < n) lh[r0 + 8 * h] = (m2[h] + log2f(l[h])) * kLn2;
    }
  }
}

// -------------------------------------------- fp32 bwd (0): delta = Σ dO·O
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_f32_kernel(const float* __restrict__ out,
                               const float* __restrict__ dout,
                               float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(dout[base + c], out[base + c], acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------ bf16 bwd (a): dK and dV
// A consumer thread owns keys kr0 = key0 + 64·wg + 16w + g and kr0 + 8 and,
// in a 64-query stage, the queries 8j + 2q + e (j < 8): S^T element
// 4j + 2h + e is (key kr0 + 8h, query). The producer warp writes the stage's
// LSE·log2(e) (+inf past n), delta and, with dropout, the forward's keep
// bits of the CTA's 128 keys beside the tiles before it starts their copies.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap map_qs,
                               const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_do,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const uint32_t* __restrict__ keep_bits,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int n, float scale, float dscale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kBwdStages], empty[kBwdStages];
  unsigned char* smem = align_1024(smem_raw);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int bh = blockIdx.y;
  const int n_tiles = (n + kBwdTile - 1) / kBwdTile;

  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    reg_dealloc<kProducerRegs>();
    if (tid < kConsumers * 128 + 32) {
      const int words = keep_words(n);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwdStages;
        mbar_wait(&empty[s], ((t / kBwdStages) & 1) ^ 1);
        unsigned char* st = smem + s * L::kKvStage;
        float* s_lse = reinterpret_cast<float*>(st + 3 * L::kBwdTileBytes);
        float* s_del = s_lse + kBwdTile;
        uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_del + kBwdTile);
        for (int i = lane; i < kBwdTile; i += 32) {
          const int row = t * kBwdTile + i;
          const bool ok = row < n;
          const size_t at = static_cast<size_t>(bh) * n + row;
          s_lse[i] = ok ? lse[at] * kLog2e : CUDART_INF_F;
          s_del[i] = ok ? delta[at] : 0.f;
          if constexpr (kDropout) {
            const uint4 w = ok ? *reinterpret_cast<const uint4*>(
                                     keep_bits + at * words + 4 * blockIdx.x)
                               : make_uint4(0, 0, 0, 0);
            s_mask[i] = w.x;
            s_mask[kBwdTile + i] = w.y;
            s_mask[2 * kBwdTile + i] = w.z;
            s_mask[3 * kBwdTile + i] = w.w;
          }
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 3 * L::kBwdTileBytes);
          tma_load_3d(st, &map_qs, &full[s], 0, t * kBwdTile, bh);
          tma_load_3d(st + L::kBwdTileBytes, &map_q, &full[s], 0, t * kBwdTile, bh);
          tma_load_3d(st + 2 * L::kBwdTileBytes, &map_do, &full[s], 0,
                      t * kBwdTile, bh);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<kConsumerRegs>();
    const int warp = (tid % 128) / 32, g = lane / 4, qd = lane % 4;
    const int kr0 = blockIdx.x * kBwdRows + wg * 64 + warp * 16 + g;
    const size_t head = static_cast<size_t>(bh) * n * D;
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_a_rows<D>(ka, k + head, kr0, n, qd, 1.f);
    load_a_rows<D>(va, v + head, kr0, n, qd, 1.f);
    // the warp's keys in the CTA's four mask words: word kw, bits kb0 + 8h
    const int kw = wg * 2 + warp / 2, kb0 = (warp % 2) * 16 + g;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    float st[32], dpt[32];
    uint32_t pa[kBwdTile / 16][4], da[kBwdTile / 16][4];

    // Tile t, as in the forward: this warpgroup's turn on the tensor cores
    // (S^T and dP^T of tile t, then dV and dK of tile t-1), then the
    // elementwise work of tile t while the other warpgroup takes its turn.
    auto issue_dvdk = [&](int t) {
      const uint32_t q_addr =
          smem_u32(smem + (t % kBwdStages) * L::kKvStage) + L::kBwdTileBytes;
      const uint32_t do_addr = q_addr + L::kBwdTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBwdTile / 16; ++kk)
        wgmma_rs<D, 1>(dva, pa[kk],
                       desc_mn_major<L::kRowBytes>(do_addr + kk * 16 * L::kRowBytes,
                                                   L::kBwdTileBytes, L::kGroup),
                       1);
#pragma unroll
      for (int kk = 0; kk < kBwdTile / 16; ++kk)
        wgmma_rs<D, 1>(dka, da[kk],
                       desc_mn_major<L::kRowBytes>(q_addr + kk * 16 * L::kRowBytes,
                                                   L::kBwdTileBytes, L::kGroup),
                       1);
    };
    auto tile = [&](int t, auto with_prev) {
      const int stage = t % kBwdStages;
      unsigned char* sb = smem + stage * L::kKvStage;
      const uint32_t qs_addr = smem_u32(sb);
      const uint32_t do_addr = qs_addr + 2 * L::kBwdTileBytes;
      const float* s_lse = reinterpret_cast<const float*>(sb + 3 * L::kBwdTileBytes);
      const float* s_del = s_lse + kBwdTile;
      const uint32_t* s_mask =
          reinterpret_cast<const uint32_t*>(s_del + kBwdTile) + kw * kBwdTile;
      constexpr bool kPrev = decltype(with_prev)::value;
      mbar_wait(&full[stage], (t / kBwdStages) & 1);
      bar_sync(kSchedBarrier + wg, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<kBwdTile, 0>(st, ka[kk],
                              desc_k_major<L::kRowBytes>(qs_addr + kk * 32, L::kGroup),
                              kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<kBwdTile, 0>(dpt, va[kk],
                              desc_k_major<L::kRowBytes>(do_addr + kk * 32, L::kGroup),
                              kk);
      wgmma_commit();
      if constexpr (kPrev) {
        issue_dvdk(t - 1);
        wgmma_commit();
      }
      if (wg == 0 || t + 1 < n_tiles) bar_arrive(kSchedBarrier + (wg ^ 1), 256);
      // all of this warpgroup's products done before its elementwise work:
      // pa and da are free while st and dpt are live (with them live too,
      // the pass overflows its 232 registers); the other warpgroup's
      // products keep the tensor cores busy meanwhile
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(pa);
      fence_regs(da);
      if (kPrev && lane == 0) mbar_arrive(&empty[(t - 1) % kBwdStages]);
      // P^T, dropped P^T (into st) and dS^T (into dpt)
#pragma unroll
      for (int j = 0; j < kBwdTile / 8; ++j) {
        const int c = 8 * j + 2 * qd;  // queries c, c + 1 of the stage
        const float2 lq = *reinterpret_cast<const float2*>(s_lse + c);
        const float2 dq = *reinterpret_cast<const float2*>(s_del + c);
        const uint2 mq = *reinterpret_cast<const uint2*>(s_mask + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lv = e ? lq.y : lq.x, dl = e ? dq.y : dq.x;
          const uint32_t mw = (e ? mq.y : mq.x) >> kb0;  // bit 8h: key kr0 + 8h
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const float p = ex2(fmaf(st[i], kLog2e, -lv));
            float kf = 1.f;
            if constexpr (kDropout) kf = (mw & (1u << (8 * h))) != 0u ? dscale : 0.f;
            st[i] = p * kf;
            dpt[i] = p * (dpt[i] * kf - dl) * scale;
          }
        }
      }
      pack_a<kBwdTile / 16>(pa, st);
      pack_a<kBwdTile / 16>(da, dpt);
    };
    if (wg == 1) bar_arrive(kSchedBarrier, 256);  // warpgroup 0 goes first
    tile(0, std::false_type{});
    for (int t = 1; t < n_tiles; ++t) tile(t, std::true_type{});
    wgmma_fence();
    issue_dvdk(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    store_rows<D>(dk + head, dka, kr0, n, qd, 1.f, 1.f);
    store_rows<D>(dv + head, dva, kr0, n, qd, 1.f, 1.f);
  }
}

// ------------------------------------------------------ bf16 bwd (b): dQ
// A consumer thread owns query rows r0 = row0 + 64·wg + 16w + g and r0 + 8
// and, in a 64-key stage, the keys 8j + 2q + e: S element 4j + 2h + e is
// (r0 + 8h, key). It runs first: before its loop it writes what the dK/dV
// pass reads, delta = rowsum(dO ∘ O) and qs = bf16(q · bf16(scale)), from
// the A fragments of its rows. Keys past n need no check: their rows of k
// and v arrive as zeros, so dP is 0 there, dS finite and dS·k 0.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const bf16* __restrict__ q,
                             const bf16* __restrict__ dout,
                             const bf16* __restrict__ out,
                             const float* __restrict__ lse,
                             float* __restrict__ delta, bf16* __restrict__ qs,
                             const uint32_t* __restrict__ keep_bits,
                             bf16* __restrict__ dq, int n, float scale,
                             float dscale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kBwdStages], empty[kBwdStages];
  unsigned char* smem = align_1024(smem_raw);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int bh = blockIdx.y;
  const int n_tiles = (n + kBwdTile - 1) / kBwdTile;

  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    reg_dealloc<kProducerRegs>();
    if (tid == kConsumers * 128) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwdStages;
        mbar_wait(&empty[s], ((t / kBwdStages) & 1) ^ 1);
        unsigned char* st = smem + s * L::kQStage;
        mbar_arrive_expect_tx(&full[s], L::kQStage);
        tma_load_3d(st, &map_k, &full[s], 0, t * kBwdTile, bh);
        tma_load_3d(st + L::kBwdTileBytes, &map_v, &full[s], 0, t * kBwdTile, bh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<kConsumerRegs>();
    const int warp = (tid % 128) / 32, g = lane / 4, qd = lane % 4;
    const int r0 = blockIdx.x * kBwdRows + wg * 64 + warp * 16 + g;
    const size_t head = static_cast<size_t>(bh) * n * D;
    uint32_t qa[D / 16][4], doa[D / 16][4];
    load_a_rows<D>(qa, q + head, r0, n, qd,
                   __bfloat162float(__float2bfloat16(scale)));
    load_a_rows<D>(doa, dout + head, r0, n, qd, 1.f);
    // delta of rows r0 and r0 + 8: the thread's D/4 columns of each (those of
    // its A fragments), then the quad's four sums; qs from the fragments
    float dl[2] = {0.f, 0.f};
    {
      uint32_t oa[D / 16][4];
      load_a_rows<D>(oa, out + head, r0, n, qd, 1.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 g2 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&doa[kk][i]));
          const float2 o2 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&oa[kk][i]));
          dl[i & 1] = fmaf(g2.x, o2.x, fmaf(g2.y, o2.y, dl[i & 1]));
          const int r = r0 + (i & 1) * 8, c = kk * 16 + (i >> 1) * 8 + 2 * qd;
          if (r < n) *reinterpret_cast<uint32_t*>(qs + head + static_cast<size_t>(r) * D + c) = qa[kk][i];
        }
    }
    float lv[2];
    const uint32_t* brow[2];
    const int words = keep_words(n);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 1);
      dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 2);
      const int r = r0 + 8 * h;
      const size_t at = static_cast<size_t>(bh) * n + (r < n ? r : 0);
      if (qd == 0 && r < n) delta[at] = dl[h];
      lv[h] = lse[at] * kLog2e;
      brow[h] = kDropout ? keep_bits + at * words : nullptr;
    }

    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    float s[32], dp[32];
    uint32_t da[kBwdTile / 16][4];
    // the keep bits of the next stage's 64 keys, loaded a tile ahead
    uint2 mw_next[2];
    if constexpr (kDropout) {
      mw_next[0] = *reinterpret_cast<const uint2*>(brow[0]);
      mw_next[1] = *reinterpret_cast<const uint2*>(brow[1]);
    }

    // Tile t: S and dP of tile t, then dQ of tile t-1 on the tensor cores in
    // this warpgroup's turn (two commit groups), then dS of tile t while dQ
    // still runs (as in the forward).
    auto issue_dq = [&](int t) {
      const uint32_t k_addr = smem_u32(smem + (t % kBwdStages) * L::kQStage);
#pragma unroll
      for (int kk = 0; kk < kBwdTile / 16; ++kk)
        wgmma_rs<D, 1>(dqa, da[kk],
                       desc_mn_major<L::kRowBytes>(k_addr + kk * 16 * L::kRowBytes,
                                                   L::kBwdTileBytes, L::kGroup),
                       1);
    };
    auto tile = [&](int t, auto with_prev) {
      const int stage = t % kBwdStages;
      const uint32_t k_addr = smem_u32(smem + stage * L::kQStage);
      const uint32_t v_addr = k_addr + L::kBwdTileBytes;
      uint2 mw[2];
      if constexpr (kDropout) {  // the keep bits of this stage's 64 keys
        mw[0] = mw_next[0];
        mw[1] = mw_next[1];
        if (t + 1 < n_tiles) {
          mw_next[0] = *reinterpret_cast<const uint2*>(brow[0] + 2 * (t + 1));
          mw_next[1] = *reinterpret_cast<const uint2*>(brow[1] + 2 * (t + 1));
        }
      }
      constexpr bool kPrev = decltype(with_prev)::value;
      mbar_wait(&full[stage], (t / kBwdStages) & 1);
      bar_sync(kSchedBarrier + wg, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<kBwdTile, 0>(s, qa[kk],
                              desc_k_major<L::kRowBytes>(k_addr + kk * 32, L::kGroup),
                              kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<kBwdTile, 0>(dp, doa[kk],
                              desc_k_major<L::kRowBytes>(v_addr + kk * 32, L::kGroup),
                              kk);
      wgmma_commit();
      if constexpr (kPrev) {
        issue_dq(t - 1);
        wgmma_commit();
      }
      if (wg == 0 || t + 1 < n_tiles) bar_arrive(kSchedBarrier + (wg ^ 1), 256);
      wgmma_wait<kPrev ? 1 : 0>();
      fence_regs(s);
      fence_regs(dp);
      // the thread's bits at 8(j % 4) + e of word j / 4: key 8j + 2q + e
      uint32_t mq[2][2];
      if constexpr (kDropout) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mq[h][0] = mw[h].x >> (2 * qd);
          mq[h][1] = mw[h].y >> (2 * qd);
        }
      }
#pragma unroll
      for (int j = 0; j < kBwdTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const float p = ex2(fmaf(s[i], kLog2e, -lv[h]));
            float kf = 1.f;
            if constexpr (kDropout)
              kf = (mq[h][j / 4] & (1u << (8 * (j % 4) + e))) != 0u ? dscale : 0.f;
            s[i] = p * (dp[i] * kf - dl[h]) * scale;
          }
      // dQ of tile t-1 done: stage t-1 is free, da may change
      wgmma_wait<0>();
      fence_regs(da);
      if (kPrev && lane == 0) mbar_arrive(&empty[(t - 1) % kBwdStages]);
      pack_a<kBwdTile / 16>(da, s);
    };
    if (wg == 1) bar_arrive(kSchedBarrier, 256);  // warpgroup 0 goes first
    tile(0, std::false_type{});
    for (int t = 1; t < n_tiles; ++t) tile(t, std::true_type{});
    wgmma_fence();
    issue_dq(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    store_rows<D>(dq + head, dqa, r0, n, qd, 1.f, 1.f);
  }
}

// ----------------------------------------------------------------- fp32 path
constexpr int kF32KeyTile = 32;
constexpr int kF32Rows = 32;  // rows (queries or keys) per CTA in the backward

template <int D>
__global__ void __launch_bounds__(kBlockM)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int n, float scale,
                         Dropout drop) {
  __shared__ __align__(16) float sk[kF32KeyTile][D];
  __shared__ __align__(16) float sv[kF32KeyTile][D];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockM + tid;
  const size_t head = static_cast<size_t>(bh) * n * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < n ? q[head + static_cast<size_t>(row) * D + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m_row = -CUDART_INF_F, l_row = 0.f;

  for (int key0 = 0; key0 < n; key0 += kF32KeyTile) {
    for (int i = tid; i < kF32KeyTile * D; i += kBlockM) {
      const int r = i / D, c = i % D;
      const bool ok = key0 + r < n;
      const size_t gi = head + static_cast<size_t>(key0 + r) * D + c;
      sk[r][c] = ok ? k[gi] : 0.f;
      sv[r][c] = ok ? v[gi] : 0.f;
    }
    __syncthreads();
    float s[kF32KeyTile];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kF32KeyTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], sk[j][d], dot);
      s[j] = key0 + j < n ? dot : -CUDART_INF_F;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m_row, mx);
    const float alpha = expf(m_row - m_new);
    m_row = m_new;
    l_row *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32KeyTile; ++j) {
      float p = expf(s[j] - m_new);
      l_row += p;
      if (drop.on && row < n && drop.factor(bh, row, key0 + j) == 0.f) p = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, sv[j][d], acc[d]);
    }
    __syncthreads();
  }
  if (row < n) {
    const float inv = (drop.on ? drop.scale : 1.f) / l_row;
#pragma unroll
    for (int d = 0; d < D; ++d)
      out[head + static_cast<size_t>(row) * D + d] = acc[d] * inv;
    if (lse != nullptr) lse[static_cast<size_t>(bh) * n + row] = m_row + logf(l_row);
  }
}

// fp32 backward (a): one thread per key row; query tiles staged in shared
// memory (rows padded by one float against bank conflicts).
template <int D>
__global__ void __launch_bounds__(kF32Rows)
    flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int n, float scale, Dropout drop) {
  __shared__ float sk[kF32Rows][D + 1];
  __shared__ float sv[kF32Rows][D + 1];
  __shared__ float sq[kF32Rows][D];
  __shared__ float sdo[kF32Rows][D];
  __shared__ float slse[kF32Rows], sdel[kF32Rows];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int key = blockIdx.x * kF32Rows + tid;
  const size_t head = static_cast<size_t>(bh) * n * D;
  for (int i = tid; i < kF32Rows * D; i += kF32Rows) {
    const int r = i / D, c = i % D;
    const bool ok = blockIdx.x * kF32Rows + r < n;
    const size_t gi = head + static_cast<size_t>(blockIdx.x * kF32Rows + r) * D + c;
    sk[r][c] = ok ? k[gi] : 0.f;
    sv[r][c] = ok ? v[gi] : 0.f;
  }
  float dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
  const float dscale = drop.on ? drop.scale : 1.f;

  for (int q0 = 0; q0 < n; q0 += kF32Rows) {
    __syncthreads();
    for (int i = tid; i < kF32Rows * D; i += kF32Rows) {
      const int r = i / D, c = i % D;
      const bool ok = q0 + r < n;
      const size_t gi = head + static_cast<size_t>(q0 + r) * D + c;
      sq[r][c] = ok ? q[gi] : 0.f;
      sdo[r][c] = ok ? dout[gi] : 0.f;
    }
    {
      const bool ok = q0 + tid < n;
      slse[tid] = ok ? lse[static_cast<size_t>(bh) * n + q0 + tid] : 0.f;
      sdel[tid] = ok ? delta[static_cast<size_t>(bh) * n + q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kF32Rows && q0 + j < n; ++j) {
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(sq[j][d] * scale, sk[tid][d], s);
        dpv = fmaf(sdo[j][d], sv[tid][d], dpv);
      }
      const float p = expf(s - slse[j]);
      const float keep = drop.on ? drop.factor(bh, q0 + j, key) * dscale : 1.f;
      const float pd = p * keep;
      const float ds = p * (dpv * keep - sdel[j]) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] = fmaf(pd, sdo[j][d], dva[d]);
        dka[d] = fmaf(ds, sq[j][d], dka[d]);
      }
    }
  }
  if (key < n) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[head + static_cast<size_t>(key) * D + d] = dka[d];
      dv[head + static_cast<size_t>(key) * D + d] = dva[d];
    }
  }
}

// fp32 backward (b): one thread per query row.
template <int D>
__global__ void __launch_bounds__(kF32Rows)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int n, float scale,
                            Dropout drop) {
  __shared__ float sk[kF32Rows][D];
  __shared__ float sv[kF32Rows][D];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kF32Rows + tid;
  const size_t head = static_cast<size_t>(bh) * n * D;
  const bool live = row < n;
  float qr[D], dor[D], dqa[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t gi = head + static_cast<size_t>(row) * D + d;
    qr[d] = live ? q[gi] * scale : 0.f;
    dor[d] = live ? dout[gi] : 0.f;
    dqa[d] = 0.f;
  }
  const float l = live ? lse[static_cast<size_t>(bh) * n + row] : 0.f;
  const float del = live ? delta[static_cast<size_t>(bh) * n + row] : 0.f;
  const float dscale = drop.on ? drop.scale : 1.f;
  for (int k0 = 0; k0 < n; k0 += kF32Rows) {
    __syncthreads();
    for (int i = tid; i < kF32Rows * D; i += kF32Rows) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < n;
      const size_t gi = head + static_cast<size_t>(k0 + r) * D + c;
      sk[r][c] = ok ? k[gi] : 0.f;
      sv[r][c] = ok ? v[gi] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kF32Rows && k0 + j < n; ++j) {
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], sk[j][d], s);
        dpv = fmaf(dor[d], sv[j][d], dpv);
      }
      const float p = expf(s - l);
      const float keep =
          drop.on && live ? drop.factor(bh, row, k0 + j) * dscale : 1.f;
      const float ds = p * (dpv * keep - del) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) dqa[d] = fmaf(ds, sk[j][d], dqa[d]);
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) dq[head + static_cast<size_t>(row) * D + d] = dqa[d];
  }
}

Dropout make_dropout(float rate, unsigned seed, unsigned thresh, int block_q,
                     int bh_offset) {
  Dropout drop;
  drop.on = rate > 0.f;
  drop.seed = seed;
  drop.thresh = thresh;
  drop.bh0 = static_cast<uint32_t>(bh_offset);
  drop.block_q = block_q > 0 ? block_q : 1;
  drop.scale = drop.on ? 1.f / (1.f - rate) : 1.f;
  return drop;
}

// The tensor map of a [bh, n, D] bf16 array in boxes of `rows` rows of one
// head (rows past n arrive as zeros), swizzled by the row's width.
template <int D>
bool head_map(CUtensorMap* map, const void* base, int bh, int n, int rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(n),
                            static_cast<uint64_t>(bh)};
  const uint32_t box[3] = {static_cast<uint32_t>(D), static_cast<uint32_t>(rows), 1};
  const CUtensorMapSwizzle swizzle = D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return make_map(map, base, 3, dims, box, swizzle);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int fwd_bf16(int bh, int n, cudaStream_t st, const void* q, const void* k,
             const void* v, void* out, void* lse, void* keep_bits, float scale,
             Dropout drop) {
  CUtensorMap map_k, map_v;
  if (!head_map<D>(&map_k, k, bh, n, kFwdKeys) ||
      !head_map<D>(&map_v, v, bh, n, kFwdKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = Layout<D>::kFwdSmem;
  if (int err = set_smem(flash_fwd_bf16_kernel<D>, kSmem)) return err;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, bh);
  flash_fwd_bf16_kernel<D><<<grid, kWsThreads, kSmem, st>>>(
      map_k, map_v, static_cast<const bf16*>(q), static_cast<bf16*>(out),
      static_cast<float*>(lse), static_cast<uint32_t*>(keep_bits), n, scale,
      drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
void fwd_f32(dim3 grid, cudaStream_t st, const void* q, const void* k,
             const void* v, void* out, void* lse, int n, float scale,
             Dropout drop) {
  flash_fwd_f32_kernel<D><<<grid, kBlockM, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), n, scale, drop);
}

template <int D, bool kDropout>
int bwd_bf16_passes(int bh, int n, cudaStream_t st, const void* q, const void* k,
                    const void* v, const void* out, const void* dout,
                    const void* lse, void* delta, void* qs, const void* keep_bits,
                    void* dq, void* dk, void* dv, float scale, float dscale) {
  using L = Layout<D>;
  CUtensorMap map_qs, map_q, map_do, map_k, map_v;
  if (!head_map<D>(&map_qs, qs, bh, n, kBwdTile) ||
      !head_map<D>(&map_q, q, bh, n, kBwdTile) ||
      !head_map<D>(&map_do, dout, bh, n, kBwdTile) ||
      !head_map<D>(&map_k, k, bh, n, kBwdTile) ||
      !head_map<D>(&map_v, v, bh, n, kBwdTile))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = set_smem(flash_bwd_dkdv_bf16_kernel<D, kDropout>, L::kKvSmem)) return err;
  if (int err = set_smem(flash_bwd_dq_bf16_kernel<D, kDropout>, L::kQSmem)) return err;
  const dim3 grid((n + kBwdRows - 1) / kBwdRows, bh);
  const auto* bits = static_cast<const uint32_t*>(keep_bits);
  // dQ first: it writes the delta and qs that the dK/dV pass reads
  flash_bwd_dq_bf16_kernel<D, kDropout><<<grid, kWsThreads, L::kQSmem, st>>>(
      map_k, map_v, static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(out), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(qs), bits,
      static_cast<bf16*>(dq), n, scale, dscale);
  flash_bwd_dkdv_bf16_kernel<D, kDropout><<<grid, kWsThreads, L::kKvSmem, st>>>(
      map_qs, map_q, map_do, static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(delta), bits, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, scale, dscale);
  return static_cast<int>(cudaGetLastError());
}

// with dropout the passes that read the forward's keep bits, without it
// the passes with no mask
template <int D>
int bwd_bf16(int bh, int n, cudaStream_t st, const void* q, const void* k,
             const void* v, const void* out, const void* dout, const void* lse,
             void* delta, void* qs, const void* keep_bits, void* dq, void* dk,
             void* dv, float scale, Dropout drop) {
  return drop.on
             ? bwd_bf16_passes<D, true>(bh, n, st, q, k, v, out, dout, lse, delta,
                                        qs, keep_bits, dq, dk, dv, scale, drop.scale)
             : bwd_bf16_passes<D, false>(bh, n, st, q, k, v, out, dout, lse, delta,
                                         qs, nullptr, dq, dk, dv, scale, 1.f);
}

template <int D>
void bwd_f32(int bh, cudaStream_t st, const void* q, const void* k,
             const void* v, const void* dout, const void* lse,
             const float* delta, void* dq, void* dk, void* dv, int n,
             float scale, Dropout drop) {
  dim3 grid((n + kF32Rows - 1) / kF32Rows, bh);
  flash_bwd_dkdv_f32_kernel<D><<<grid, kF32Rows, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), delta, static_cast<float*>(dk),
      static_cast<float*>(dv), n, scale, drop);
  flash_bwd_dq_f32_kernel<D><<<grid, kF32Rows, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), delta, static_cast<float*>(dq), n,
      scale, drop);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers to contiguous [bh, n, d]
// tensors on the device (lse, delta: [bh, n] fp32; lse may be null in the
// forward; keep_bits: [bh, n, ⌈n/128⌉·4] uint32, may be null); `thresh` =
// min(rate·2^32, 2^32-1) and `seed` as in the TPU kernel's mask; `bh_offset`
// is added to every head's index in the mask's hash (0 for a whole batch).
// The bf16 backward reads the forward's bits and hashes nothing. Each returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue for a head
// dim without an instantiation or a tensor map that cannot be made.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, void* keep_bits, int bh,
                              int n, int d, float scale, float rate,
                              unsigned seed, unsigned thresh, int block_q,
                              int bh_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(rate, seed, thresh, block_q, bh_offset);
  if (keep_bits != nullptr && (lse == nullptr || !drop.on))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return fwd_bf16<16>(bh, n, st, q, k, v, out, lse, keep_bits, scale, drop);
    case 32: return fwd_bf16<32>(bh, n, st, q, k, v, out, lse, keep_bits, scale, drop);
    case 64: return fwd_bf16<64>(bh, n, st, q, k, v, out, lse, keep_bits, scale, drop);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int n, int d,
                             float scale, float rate, unsigned seed,
                             unsigned thresh, int block_q, int bh_offset,
                             void* stream) {
  dim3 grid((n + kBlockM - 1) / kBlockM, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(rate, seed, thresh, block_q, bh_offset);
  switch (d) {
    case 8: fwd_f32<8>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    case 16: fwd_f32<16>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    case 32: fwd_f32<32>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    case 64: fwd_f32<64>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward: pass (b) for dq, which also writes delta = rowsum(dout ∘ out)
// and qs = q·scale, then pass (a) for dk/dv. `delta` is fp32 scratch of bh·n
// values, `qs` bf16 scratch of q's shape; `keep_bits`, the forward's, is
// required with dropout (rate > 0) and must be null without.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* delta, void* qs,
                              const void* keep_bits, void* dq, void* dk,
                              void* dv, int bh, int n, int d, float scale,
                              float rate, unsigned seed, unsigned thresh,
                              int block_q, int bh_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(rate, seed, thresh, block_q, bh_offset);
  if ((keep_bits != nullptr) != drop.on) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return bwd_bf16<16>(bh, n, st, q, k, v, out, dout, lse, delta, qs,
                                 keep_bits, dq, dk, dv, scale, drop);
    case 32: return bwd_bf16<32>(bh, n, st, q, k, v, out, dout, lse, delta, qs,
                                 keep_bits, dq, dk, dv, scale, drop);
    case 64: return bwd_bf16<64>(bh, n, st, q, k, v, out, dout, lse, delta, qs,
                                 keep_bits, dq, dk, dv, scale, drop);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq, void* dk,
                             void* dv, int bh, int n, int d, float scale,
                             float rate, unsigned seed, unsigned thresh,
                             int block_q, int bh_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(rate, seed, thresh, block_q, bh_offset);
  if (d != 8 && d != 16 && d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = bh * n;
  float* del = static_cast<float*>(delta);
  flash_bwd_delta_f32_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout), del, rows, d);
  switch (d) {
    case 8: bwd_f32<8>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
    case 16: bwd_f32<16>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
    case 32: bwd_f32<32>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
    default: bwd_f32<64>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
  }
  return static_cast<int>(cudaGetLastError());
}
