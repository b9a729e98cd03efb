// Flash self-attention for Hopper (sm_90a): the forward (with dropout and the
// log-sum-exp it saves for the backward) and the backward.
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
// same bit for bit. The row sum of the online softmax adds the unmasked
// probabilities; only the P·V product sees the mask, and 1/(1-rate) is
// applied with the final normalisation.
//
// Bounds on an H100 at the policy's shapes (BH=8, N=2048, D=64, bf16):
//   forward:  4·BH·N²·D = 8.6 GFLOP / 989 TFLOP/s ≈ 8.7 us (its 8.4 MB of
//             q, k, v, out take ≈ 2.5 us at 3.35 TB/s);
//   backward: 10·BH·N²·D = 21.5 GFLOP ≈ 21.7 us (≈ 17 MB ≈ 5 us).
// Both are bound by operations, and the design is the FlashAttention-2 one:
// scores and probabilities never leave the SM.
//   * forward: one CTA of 4 warps per (bh, 64-row query block); each warp owns
//     16 rows. K/V tiles of 64 keys are staged in shared memory with cp.async,
//     double buffered. Q·K^T and P·V on the tensor cores with mma.sync
//     m16n8k16 (fp32 accumulators in registers); the S accumulator fragment is
//     re-packed in registers as the A operand of P·V. Online softmax with a
//     running fp32 row max and row sum.
//   * backward, deterministic, no atomics (the TPU kernel accumulates dK/dV
//     across its sequential grid; CUDA blocks run in no order):
//       (0) delta_i = rowsum(dO ∘ O) in fp32, one warp per row;
//       (a) one CTA per (bh, 64-key tile): loop over query tiles, recompute
//           P^T from q, k and the forward's LSE, accumulate dK and dV in
//           registers;
//       (b) one CTA per (bh, 64-query tile): loop over key tiles, accumulate
//           dQ in registers.
//     delta is rowsum(dO ∘ O), equal to Σ_j P_ij·dP_ij (the TPU kernel's
//     form) up to the rounding of O to its dtype.
//   * fp32: the same tilings on plain FMA (full fp32, no TF32), one thread
//     per row.
// Ragged N is masked: keys past N score -inf, rows past N are not stored.
// wgmma, TMA and warp specialisation are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per CTA
constexpr int kBlockN = 64;   // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Dropout {
  bool on;
  uint32_t seed;
  uint32_t thresh;
  int block_q;
  float scale;  // 1 / (1 - rate)

  // keep factor of element (query row, key col) of head bh: 0 or 1/(1-rate)
  __device__ __forceinline__ float factor(int bh, int row, int col) const {
    if (!on) return 1.f;
    const uint32_t i = static_cast<uint32_t>(row / block_q);
    const uint32_t r = static_cast<uint32_t>(row % block_q);
    uint32_t h = seed + (static_cast<uint32_t>(bh) * 65536u + i) * 2654435761u;
    h ^= r * 0x9E3779B1u;
    h ^= static_cast<uint32_t>(col) * 0x85EBCA77u;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h >= thresh ? 1.f : 0.f;
  }
};

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

// Fragment loaders from a row-major shared-memory tile with `stride` elements
// per row (the m16n8k16 layouts; g = lane/4, q = lane%4).
// A operand, rows r0..r0+15, columns c0..c0+15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int stride,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, s + (r0 + (lane % 16)) * stride + c0 + (lane / 16) * 8);
}
// B operands of two n8 tiles where B[k][n] = X[n][k]: X rows n0..n0+15,
// columns k0..k0+15. b[0], b[1] feed n-tile n0/8, b[2], b[3] n-tile n0/8 + 1.
__device__ __forceinline__ void load_b_nt(uint32_t (&b)[4],
                                          const __nv_bfloat16* s, int stride,
                                          int n0, int k0, int lane) {
  const int mat = lane / 8;
  ldmatrix_x4(b, s + (n0 + (lane % 8) + (mat / 2) * 8) * stride + k0 +
                     (mat % 2) * 8);
}
// B operands of two n8 tiles where B[k][n] = Y[k][n]: Y rows k0..k0+15,
// columns n0..n0+15.
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4],
                                         const __nv_bfloat16* s, int stride,
                                         int k0, int n0, int lane) {
  const int mat = lane / 8;
  ldmatrix_x4_trans(b, s + (k0 + (lane % 8) + (mat % 2) * 8) * stride + n0 +
                           (mat / 2) * 8);
}

// Copy `rows` rows of D bf16 values starting at `row0` of a [n, D] matrix into
// a shared tile with `stride` elements per row; rows past n are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* s, int stride,
                                           const __nv_bfloat16* g, int row0,
                                           int n, int tid) {
  constexpr int kVecPerRow = D / 8;
  for (int i = tid; i < kBlockN * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    const bool ok = row0 + r < n;
    cp_async16(&s[r * stride + c],
               g + (ok ? static_cast<size_t>(row0 + r) * D + c : 0), ok);
  }
}

// ----------------------------------------------------------------- bf16 fwd
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int n, float scale,
                          Dropout drop) {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  // +8 elements (16 B) per row: ldmatrix row addresses fall in distinct banks
  constexpr int kStride = D + 8;
  constexpr int kVecPerRow = D / 8;  // 16-byte vectors per row
  __shared__ __align__(16) __nv_bfloat16 sq[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sk[2][kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 sv[2][kBlockN * kStride];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockM;
  const size_t head = static_cast<size_t>(bh) * n * D;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;

  const int num_tiles = (n + kBlockN - 1) / kBlockN;
  stage_rows<D>(sk[0], kStride, kh, 0, n, tid);
  stage_rows<D>(sv[0], kStride, vh, 0, n, tid);
  cp_async_commit();

  // Q block, scaled in bf16 (the TPU kernel's `q_blk * asarray(scale, dtype)`)
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  for (int i = tid; i < kBlockM * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      raw = *reinterpret_cast<const uint4*>(qh + static_cast<size_t>(row0 + r) * D + c);
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = scale_bf16x2(w[j], qscale);
    *reinterpret_cast<uint4*>(&sq[r * kStride + c]) = raw;
  }
  __syncthreads();

  // A fragments of this warp's 16 query rows, one per 16-wide k step
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qa[kk], sq, kStride, warp * 16, kk * 16, lane);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows g = lane/4 and g+8 of the warp's 16
  float m_row[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_row[2] = {0.f, 0.f};
  const int quad = lane % 4;
  const int g = lane / 4;
  const int ra = row0 + warp * 16 + g, rb = ra + 8;

  for (int t = 0; t < num_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < num_tiles) {
      stage_rows<D>(sk[buf ^ 1], kStride, kh, (t + 1) * kBlockN, n, tid);
      stage_rows<D>(sv[buf ^ 1], kStride, vh, (t + 1) * kBlockN, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of m16n8
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t b[4];
        load_b_nt(b, sk[buf], kStride, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    const int key0 = t * kBlockN;
    if (key0 + kBlockN > n) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + j * 8 + quad * 2 + (e & 1);
          if (key >= n) s[j][e] = -CUDART_INF_F;
        }
      }
    }

    // online softmax over this tile
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_row[h], mx[h]);
      alpha[h] = expf(m_row[h] - m_new);
      m_row[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = expf(s[j][0] - m_row[0]);
      s[j][1] = expf(s[j][1] - m_row[0]);
      s[j][2] = expf(s[j][2] - m_row[1]);
      s[j][3] = expf(s[j][3] - m_row[1]);
      rs[0] += s[j][0] + s[j][1];
      rs[1] += s[j][2] + s[j][3];
    }
    l_row[0] = l_row[0] * alpha[0] + rs[0];
    l_row[1] = l_row[1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    if (drop.on) {  // the row sums above saw the unmasked probabilities
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + j * 8 + quad * 2 + (e & 1);
          const int row = e < 2 ? ra : rb;
          if (drop.factor(bh, row, key) == 0.f) s[j][e] = 0.f;
        }
      }
    }

    // O += P V: P from the S fragments (two n8 tiles = one k16 A fragment)
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        load_b_t(b, sv[buf], kStride, kk * 16, dp * 16, lane);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 1);
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 2);
  }
  const float dscale = drop.on ? drop.scale : 1.f;
  const float inv0 = dscale / l_row[0], inv1 = dscale / l_row[1];
  __nv_bfloat16* oh = out + head;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + quad * 2;
    if (ra < n)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(ra) * D + c) =
          __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    if (rb < n)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(rb) * D + c) =
          __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
  }
  if (lse != nullptr && quad == 0) {
    float* lh = lse + static_cast<size_t>(bh) * n;
    if (ra < n) lh[ra] = m_row[0] + logf(l_row[0]);
    if (rb < n) lh[rb] = m_row[1] + logf(l_row[1]);
  }
}

// ----------------------------------------------------- bwd (0): delta = Σ dO·O
template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                           float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f(dout[base + c]), to_f(out[base + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------ bf16 bwd (a): dK and dV
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int n,
                               float scale, Dropout drop) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 sq[2][kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sdo[2][kBlockM * kStride];
  __shared__ float slse[2][kBlockM];
  __shared__ float sdelta[2][kBlockM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int g = lane / 4;
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kBlockN;
  const size_t head = static_cast<size_t>(bh) * n * D;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* doh = dout + head;
  const float* lh = lse + static_cast<size_t>(bh) * n;
  const float* dh = delta + static_cast<size_t>(bh) * n;
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  const float dscale = drop.on ? drop.scale : 1.f;

  auto stage_stats = [&](int q0, int buf) {
    if (tid < kBlockM) {
      const bool ok = q0 + tid < n;
      slse[buf][tid] = ok ? lh[q0 + tid] : 0.f;
      sdelta[buf][tid] = ok ? dh[q0 + tid] : 0.f;
    }
  };

  // K and V of this key tile go through the second buffers into registers
  stage_rows<D>(sq[1], kStride, k + head, key0, n, tid);
  stage_rows<D>(sdo[1], kStride, v + head, key0, n, tid);
  stage_rows<D>(sq[0], kStride, qh, 0, n, tid);
  stage_rows<D>(sdo[0], kStride, doh, 0, n, tid);
  cp_async_commit();
  stage_stats(0, 0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(ka[kk], sq[1], kStride, warp * 16, kk * 16, lane);
    load_a(va[kk], sdo[1], kStride, warp * 16, kk * 16, lane);
  }
  __syncthreads();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  // this thread's key rows (g and g+8 of the warp's 16)
  const int kra = key0 + warp * 16 + g, krb = kra + 8;

  const int num_tiles = (n + kBlockM - 1) / kBlockM;
  for (int t = 0; t < num_tiles; ++t) {
    const int buf = t & 1;
    const int q0 = t * kBlockM;
    if (t + 1 < num_tiles) {
      stage_rows<D>(sq[buf ^ 1], kStride, qh, q0 + kBlockM, n, tid);
      stage_rows<D>(sdo[buf ^ 1], kStride, doh, q0 + kBlockM, n, tid);
      cp_async_commit();
      stage_stats(q0 + kBlockM, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Qs^T and dP^T = V dO^T, 16 keys x 64 queries per warp
    float st[kBlockM / 8][4], dpt[kBlockM / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockM / 16; ++np) {
        uint32_t b[4];
        load_b_nt(b, sq[buf], kStride, np * 16, kk * 16, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = scale_bf16x2(b[e], qscale);
        mma_bf16(st[2 * np], ka[kk], b[0], b[1]);
        mma_bf16(st[2 * np + 1], ka[kk], b[2], b[3]);
        load_b_nt(b, sdo[buf], kStride, np * 16, kk * 16, lane);
        mma_bf16(dpt[2 * np], va[kk], b[0], b[1]);
        mma_bf16(dpt[2 * np + 1], va[kk], b[2], b[3]);
      }
    }
    // P^T, dropped P^T (kept in st) and dS^T (kept in dpt)
#pragma unroll
    for (int j = 0; j < kBlockM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + quad * 2 + (e & 1);  // query in the tile
        const int query = q0 + col;
        const int key = e < 2 ? kra : krb;
        const float p = query < n ? expf(st[j][e] - slse[buf][col]) : 0.f;
        const float keep = drop.on ? drop.factor(bh, query, key) * dscale : 1.f;
        st[j][e] = p * keep;
        dpt[j][e] = p * (dpt[j][e] * keep - sdelta[buf][col]) * scale;
      }
    }
    // dV += Pd^T dO and dK += dS^T Q (A operands re-packed from registers)
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      da[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      da[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      da[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      da[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        load_b_t(b, sdo[buf], kStride, kk * 16, dp * 16, lane);
        mma_bf16(dva[2 * dp], pa, b[0], b[1]);
        mma_bf16(dva[2 * dp + 1], pa, b[2], b[3]);
        load_b_t(b, sq[buf], kStride, kk * 16, dp * 16, lane);
        mma_bf16(dka[2 * dp], da, b[0], b[1]);
        mma_bf16(dka[2 * dp + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + quad * 2;
    if (kra < n) {
      const size_t o = head + static_cast<size_t>(kra) * D + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(dka[j][0], dka[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(dva[j][0], dva[j][1]);
    }
    if (krb < n) {
      const size_t o = head + static_cast<size_t>(krb) * D + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(dka[j][2], dka[j][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(dva[j][2], dva[j][3]);
    }
  }
}

// ------------------------------------------------------ bf16 bwd (b): dQ
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int n,
                             float scale, Dropout drop) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 sk[2][kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 sv[2][kBlockN * kStride];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int g = lane / 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockM;
  const size_t head = static_cast<size_t>(bh) * n * D;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  const float dscale = drop.on ? drop.scale : 1.f;

  // Q and dO of this query tile go through the second buffers into registers
  stage_rows<D>(sk[1], kStride, q + head, row0, n, tid);
  stage_rows<D>(sv[1], kStride, dout + head, row0, n, tid);
  stage_rows<D>(sk[0], kStride, kh, 0, n, tid);
  stage_rows<D>(sv[0], kStride, vh, 0, n, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4], doa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qa[kk], sk[1], kStride, warp * 16, kk * 16, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) qa[kk][e] = scale_bf16x2(qa[kk][e], qscale);
    load_a(doa[kk], sv[1], kStride, warp * 16, kk * 16, lane);
  }
  __syncthreads();

  const int ra = row0 + warp * 16 + g, rb = ra + 8;
  const float* lh = lse + static_cast<size_t>(bh) * n;
  const float* dh = delta + static_cast<size_t>(bh) * n;
  const float lse_r[2] = {ra < n ? lh[ra] : 0.f, rb < n ? lh[rb] : 0.f};
  const float del_r[2] = {ra < n ? dh[ra] : 0.f, rb < n ? dh[rb] : 0.f};

  float dqa[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

  const int num_tiles = (n + kBlockN - 1) / kBlockN;
  for (int t = 0; t < num_tiles; ++t) {
    const int buf = t & 1;
    const int key0 = t * kBlockN;
    if (t + 1 < num_tiles) {
      stage_rows<D>(sk[buf ^ 1], kStride, kh, key0 + kBlockN, n, tid);
      stage_rows<D>(sv[buf ^ 1], kStride, vh, key0 + kBlockN, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t b[4];
        load_b_nt(b, sk[buf], kStride, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
        load_b_nt(b, sv[buf], kStride, np * 16, kk * 16, lane);
        mma_bf16(dp[2 * np], doa[kk], b[0], b[1]);
        mma_bf16(dp[2 * np + 1], doa[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + quad * 2 + (e & 1);
        const int h = e / 2;
        const int row = h ? rb : ra;
        const float p = key < n ? expf(s[j][e] - lse_r[h]) : 0.f;
        const float keep = drop.on ? drop.factor(bh, row, key) * dscale : 1.f;
        s[j][e] = p * (dp[j][e] * keep - del_r[h]) * scale;
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        uint32_t b[4];
        load_b_t(b, sk[buf], kStride, kk * 16, dpi * 16, lane);
        mma_bf16(dqa[2 * dpi], da, b[0], b[1]);
        mma_bf16(dqa[2 * dpi + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + quad * 2;
    if (ra < n)
      *reinterpret_cast<__nv_bfloat162*>(dq + head + static_cast<size_t>(ra) * D + c) =
          __floats2bfloat162_rn(dqa[j][0], dqa[j][1]);
    if (rb < n)
      *reinterpret_cast<__nv_bfloat162*>(dq + head + static_cast<size_t>(rb) * D + c) =
          __floats2bfloat162_rn(dqa[j][2], dqa[j][3]);
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

Dropout make_dropout(float rate, unsigned seed, unsigned thresh, int block_q) {
  Dropout drop;
  drop.on = rate > 0.f;
  drop.seed = seed;
  drop.thresh = thresh;
  drop.block_q = block_q > 0 ? block_q : 1;
  drop.scale = drop.on ? 1.f / (1.f - rate) : 1.f;
  return drop;
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers to contiguous [bh, n, d]
// tensors on the device (lse, delta: [bh, n] fp32; lse may be null in the
// forward); `thresh` = min(rate·2^32, 2^32-1) and `seed` as in the TPU
// kernel's mask. Each returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for a head dim without an instantiation.
namespace {

template <int D>
void fwd_bf16(dim3 grid, cudaStream_t st, const void* q, const void* k,
              const void* v, void* out, void* lse, int n, float scale,
              Dropout drop) {
  flash_fwd_bf16_kernel<D><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), n, scale, drop);
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

template <int D>
void bwd_bf16(int bh, cudaStream_t st, const void* q, const void* k,
              const void* v, const void* dout, const void* lse,
              const float* delta, void* dq, void* dk, void* dv, int n,
              float scale, Dropout drop) {
  using T = __nv_bfloat16;
  dim3 grid_k((n + kBlockN - 1) / kBlockN, bh);
  dim3 grid_q((n + kBlockM - 1) / kBlockM, bh);
  flash_bwd_dkdv_bf16_kernel<D><<<grid_k, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), delta, static_cast<T*>(dk),
      static_cast<T*>(dv), n, scale, drop);
  flash_bwd_dq_bf16_kernel<D><<<grid_q, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), delta, static_cast<T*>(dq), n, scale,
      drop);
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

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int n, int d,
                              float scale, float rate, unsigned seed,
                              unsigned thresh, int block_q, void* stream) {
  dim3 grid((n + kBlockM - 1) / kBlockM, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(rate, seed, thresh, block_q);
  switch (d) {
    case 16: fwd_bf16<16>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    case 32: fwd_bf16<32>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    case 64: fwd_bf16<64>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int n, int d,
                             float scale, float rate, unsigned seed,
                             unsigned thresh, int block_q, void* stream) {
  dim3 grid((n + kBlockM - 1) / kBlockM, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(rate, seed, thresh, block_q);
  switch (d) {
    case 8: fwd_f32<8>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    case 16: fwd_f32<16>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    case 32: fwd_f32<32>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    case 64: fwd_f32<64>(grid, st, q, k, v, out, lse, n, scale, drop); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward: delta = rowsum(dout ∘ out), then pass (a) for dk/dv and pass
// (b) for dq. `delta` is fp32 scratch of bh·n values.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* delta, void* dq, void* dk,
                              void* dv, int bh, int n, int d, float scale,
                              float rate, unsigned seed, unsigned thresh,
                              int block_q, void* stream) {
  using T = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(rate, seed, thresh, block_q);
  if (d != 16 && d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = bh * n;
  float* del = static_cast<float*>(delta);
  flash_bwd_delta_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), del, rows, d);
  switch (d) {
    case 16: bwd_bf16<16>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
    case 32: bwd_bf16<32>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
    default: bwd_bf16<64>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq, void* dk,
                             void* dv, int bh, int n, int d, float scale,
                             float rate, unsigned seed, unsigned thresh,
                             int block_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(rate, seed, thresh, block_q);
  if (d != 8 && d != 16 && d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = bh * n;
  float* del = static_cast<float*>(delta);
  flash_bwd_delta_kernel<float><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout), del, rows, d);
  switch (d) {
    case 8: bwd_f32<8>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
    case 16: bwd_f32<16>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
    case 32: bwd_f32<32>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
    default: bwd_f32<64>(bh, st, q, k, v, dout, lse, del, dq, dk, dv, n, scale, drop); break;
  }
  return static_cast<int>(cudaGetLastError());
}
