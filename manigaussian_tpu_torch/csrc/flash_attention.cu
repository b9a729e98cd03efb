// Flash self-attention forward for Hopper (sm_90a), no dropout.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// manigaussian_tpu/ops/flash_attention.py (pallas_call in `_flash_fwd_impl`):
//   out = softmax((q * d^-1/2) k^T) v   per (batch*head), q/k/v [BH, N, D].
// Semantics kept from the TPU kernel: q*scale is rounded in q's dtype (the
// scale itself first rounded to that dtype), scores and softmax are fp32, the
// probabilities are rounded to v's dtype before the P·V product, which
// accumulates in fp32, and the output is written in q's dtype.
//
// Bound on an H100 at the policy's shapes (BH=8, N=2048, D=64, bf16):
// 4·BH·N²·D = 8.6 GFLOP against 989 TFLOP/s of bf16 tensor cores ≈ 8.7 us;
// the 8.4 MB of q, k, v and out take ≈ 2.5 us at 3.35 TB/s. So it is bound by
// operations, and its design is the FlashAttention-2 one: scores and
// probabilities never leave the SM.
//   * One CTA of 4 warps per (bh, 64-row query block); each warp owns 16 rows.
//   * K/V tiles of 64 keys are staged in shared memory with cp.async, double
//     buffered so the next tile loads while this one is multiplied.
//   * bf16: Q·K^T and P·V on the tensor cores with mma.sync m16n8k16 (fp32
//     accumulators in registers); the S accumulator fragment is re-packed in
//     registers as the A operand of P·V.
//   * Online (FA2) softmax: running fp32 row max and row sum, the output
//     accumulator rescaled when the max grows, one division at the end.
//   * fp32: the same tiling on plain FMA (full fp32, no TF32), one thread per
//     query row.
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

// ----------------------------------------------------------------- bf16 path
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, int n,
                          float scale) {
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
  const int row0 = blockIdx.x * kBlockM;
  const size_t head = static_cast<size_t>(blockIdx.y) * n * D;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;

  auto load_kv = [&](int tile, int buf) {
    const int key0 = tile * kBlockN;
    for (int i = tid; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
      const bool ok = key0 + r < n;
      const size_t g = ok ? static_cast<size_t>(key0 + r) * D + c : 0;
      cp_async16(&sk[buf][r * kStride + c], kh + g, ok);
      cp_async16(&sv[buf][r * kStride + c], vh + g, ok);
    }
  };

  const int num_tiles = (n + kBlockN - 1) / kBlockN;
  load_kv(0, 0);
  cp_async_commit();

  // Q block, scaled in bf16 (the TPU kernel's `q_blk * asarray(scale, dtype)`)
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  for (int i = tid; i < kBlockM * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      raw = *reinterpret_cast<const uint4*>(qh + static_cast<size_t>(row0 + r) * D + c);
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h2[j]);
      h2[j] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
    }
    *reinterpret_cast<uint4*>(&sq[r * kStride + c]) = raw;
  }
  __syncthreads();

  // A fragments of this warp's 16 query rows, one per 16-wide k step
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int r = warp * 16 + (lane % 16);
    const int c = kk * 16 + (lane / 16) * 8;
    ldmatrix_x4(qa[kk], &sq[r * kStride + c]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows g = lane/4 and g+8 of the warp's 16
  float m_row[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_row[2] = {0.f, 0.f};
  const int quad = lane % 4;

  for (int t = 0; t < num_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < num_tiles) {
      load_kv(t + 1, buf ^ 1);
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
        // matrices: (keys np*16+0..7, dims kk*16+0..7), (same keys, +8 dims),
        //           (keys +8..15, dims +0..7), (keys +8..15, dims +8..15)
        const int mat = lane / 8;
        const int r = np * 16 + (lane % 8) + (mat / 2) * 8;
        const int c = kk * 16 + (mat % 2) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, &sk[buf][r * kStride + c]);
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
        // matrices: (keys kk*16+0..7, dims dp*16+0..7), (keys +8..15, same
        // dims), (keys +0..7, dims +8..15), (keys +8..15, dims +8..15)
        const int mat = lane / 8;
        const int r = kk * 16 + (lane % 8) + (mat % 2) * 8;
        const int c = dp * 16 + (mat / 2) * 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, &sv[buf][r * kStride + c]);
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
  const float inv0 = 1.f / l_row[0], inv1 = 1.f / l_row[1];
  const int g = lane / 4;
  const int ra = row0 + warp * 16 + g, rb = ra + 8;
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
}

// ----------------------------------------------------------------- fp32 path
constexpr int kF32KeyTile = 32;

template <int D>
__global__ void __launch_bounds__(kBlockM)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         int n, float scale) {
  __shared__ __align__(16) float sk[kF32KeyTile][D];
  __shared__ __align__(16) float sv[kF32KeyTile][D];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBlockM + tid;
  const size_t head = static_cast<size_t>(blockIdx.y) * n * D;

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
      const size_t g = head + static_cast<size_t>(key0 + r) * D + c;
      sk[r][c] = ok ? k[g] : 0.f;
      sv[r][c] = ok ? v[g] : 0.f;
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
      const float p = expf(s[j] - m_new);
      l_row += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, sv[j][d], acc[d]);
    }
    __syncthreads();
  }
  if (row < n) {
    const float inv = 1.f / l_row;
#pragma unroll
    for (int d = 0; d < D; ++d)
      out[head + static_cast<size_t>(row) * D + d] = acc[d] * inv;
  }
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers to contiguous [bh, n, d]
// tensors on the device; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim without an instantiation.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, int bh, int n, int d, float scale,
                              void* stream) {
  dim3 grid((n + kBlockM - 1) / kBlockM, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (d) {
    case 16:
      flash_fwd_bf16_kernel<16><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n, scale);
      break;
    case 32:
      flash_fwd_bf16_kernel<32><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n, scale);
      break;
    case 64:
      flash_fwd_bf16_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* out, int bh, int n, int d, float scale,
                             void* stream) {
  dim3 grid((n + kBlockM - 1) / kBlockM, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(out);
  switch (d) {
    case 8:
      flash_fwd_f32_kernel<8><<<grid, kBlockM, 0, st>>>(qp, kp, vp, op, n, scale);
      break;
    case 16:
      flash_fwd_f32_kernel<16><<<grid, kBlockM, 0, st>>>(qp, kp, vp, op, n, scale);
      break;
    case 32:
      flash_fwd_f32_kernel<32><<<grid, kBlockM, 0, st>>>(qp, kp, vp, op, n, scale);
      break;
    case 64:
      flash_fwd_f32_kernel<64><<<grid, kBlockM, 0, st>>>(qp, kp, vp, op, n, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
