// Multi-tensor LAMB: one optimizer step over every parameter leaf in two
// launches (ops/fused_lamb.py is the wrapper).
//
// It replaces no TPU kernel. The JAX package's LAMB
// (manigaussian_tpu/utils/optimizers.py, `lamb_reference`) is plain jnp that
// XLA fuses under `jit`; run eagerly, the same update is a loop of about 25
// kernels a leaf (`ops/fused_lamb.lamb_step_reference`, which the port keeps
// for CPU tensors): 4,450 launches a step at GNFACTOR_BC's 178 leaves, each
// doing almost no work, all of them on the step's critical path.
//
// Bound: bytes. An element's update reads p, g, m, v and writes p, m, v:
// 28 B, so 1.12 GB a step at 40 M fp32 parameters, 0.33 ms at 3.35 TB/s.
// The trust ratio of a leaf needs ‖p‖ and ‖u‖ over the whole leaf before
// any of its p is written, and blocks do not wait for each other, so the
// step is two passes over a table of (leaf, chunk) work items, one CTA an
// item:
//   pass 1  reads p, g, m, v; writes m′ = b1·m + (1−b1)·g and
//           v′ = b2·v + ((1−b2)·g)·g; forms u = m′ / (√v′ + ε) + wd·p in
//           registers and writes the chunk's partial ‖p‖² and ‖u‖² to a
//           scratch row (no atomics);
//   pass 2  adds its leaf's partials in chunk order (the same fixed tree in
//           every CTA of the leaf, so every CTA gets the same, repeatable
//           sums), forms the trust ratio as the loop does (‖p‖ clamped to
//           [0, 10]; 1 when either norm is 0; else ‖p‖ / max(‖u‖, 1e-30)),
//           recomputes u from p, m′, v′ and writes p ← p + (−lr·trust)·u.
// It moves 40 B an element (pass 1: 16 in, 8 out; pass 2: 12 in, 4 out),
// 1.60 GB, 0.48 ms at the peak; keeping u in device memory between the
// passes would move as much. What brings it near that: 16-byte loads and
// stores (for a gradient that is not 16-byte aligned, as the data-parallel
// path's views of one flat buffer are, scalar loads of the same elements a
// thread, so p does not depend on where the gradient lies),
// chunks of 8,192 elements (ops/fused_lamb.py CHUNK), so that ~5,000 CTAs
// of 256 threads keep every SM's loads in flight, and a scratch of 8 B an
// item that pass 2 reads from L2. The pointer tables of p, m, v live on
// the device and are built once; the gradients' pointers, new every step,
// come by value in the launch's parameters (2 KB), a null one read as
// zeros.
//
// Rounding: eager PyTorch rounds every op, so each product, sum, quotient
// and root here is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction), in the loop's order and with the loop's
// float32 constants. m′ and v′ are then the loop's bit for bit; p differs
// from it only through the order in which the two norms are summed.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// gradient pointers a launch carries (ops/fused_lamb.py LEAVES_PER_LAUNCH)
constexpr int kMaxLeaves = 256;

struct Leaf {        // a row of the leaf table: int64 [5]
  long long p, m, v;   // device addresses
  long long first;     // its first work item
  long long count;     // its work items
};

struct Item {        // a row of the work table: int64 [3]
  long long leaf, start, len;
};

struct Grads {
  const float* g[kMaxLeaves];
};

struct Coeffs {
  float b1, c1, b2, c2, eps, wd, neg_lr;  // c1 = 1 − b1, c2 = 1 − b2
  int decay;                              // wd != 0: the loop adds wd·p
};

__device__ __forceinline__ float update_of(float p, float m, float v,
                                           const Coeffs& k) {
  float u = __fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), k.eps));
  if (k.decay) u = __fadd_rn(u, __fmul_rn(k.wd, p));
  return u;
}

// (a, b) summed over the block in a fixed tree; every thread gets the sums.
__device__ __forceinline__ float2 block_sum(float a, float b,
                                            float2 (&smem)[kWarps + 1]) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const float2 s = lane < kWarps ? smem[lane] : make_float2(0.f, 0.f);
    a = s.x;
    b = s.y;
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
    if (lane == 0) smem[kWarps] = make_float2(a, b);
  }
  __syncthreads();
  return smem[kWarps];
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15u) == 0;
}

__global__ void __launch_bounds__(kThreads)
    lamb_moments_kernel(const Leaf* __restrict__ leaves,
                        const Item* __restrict__ items, const Grads grads,
                        const Coeffs k, float2* __restrict__ partials) {
  __shared__ float2 red[kWarps + 1];
  const Item it = items[blockIdx.x];
  const Leaf lf = leaves[it.leaf];
  const float* __restrict__ p = reinterpret_cast<const float*>(lf.p) + it.start;
  float* __restrict__ m = reinterpret_cast<float*>(lf.m) + it.start;
  float* __restrict__ v = reinterpret_cast<float*>(lf.v) + it.start;
  const float* __restrict__ g = grads.g[it.leaf];
  if (g != nullptr) g += it.start;
  const int len = static_cast<int>(it.len);
  float pp = 0.f, uu = 0.f;
  auto one = [&](float pe, float ge, float& me, float& ve) {
    me = __fadd_rn(__fmul_rn(k.b1, me), __fmul_rn(k.c1, ge));
    ve = __fadd_rn(__fmul_rn(k.b2, ve), __fmul_rn(__fmul_rn(k.c2, ge), ge));
    const float u = update_of(pe, me, ve, k);
    pp = fmaf(pe, pe, pp);
    uu = fmaf(u, u, uu);
  };
  const int n4 = len >> 2;
  if (aligned16(p, m, v, g)) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 P = p4[i];
      const float4 G = g != nullptr ? g4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 M = m4[i], V = v4[i];
      one(P.x, G.x, M.x, V.x);
      one(P.y, G.y, M.y, V.y);
      one(P.z, G.z, M.z, V.z);
      one(P.w, G.w, M.w, V.w);
      m4[i] = M;
      v4[i] = V;
    }
  } else {
    // the same four elements a thread in the same order, so the partial
    // sums, and p, do not depend on where the gradient lies
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      for (int j = 4 * i; j < 4 * i + 4; ++j) {
        float me = m[j], ve = v[j];
        one(p[j], g != nullptr ? g[j] : 0.f, me, ve);
        m[j] = me;
        v[j] = ve;
      }
    }
  }
  for (int i = (n4 << 2) + threadIdx.x; i < len; i += kThreads) {
    float me = m[i], ve = v[i];
    one(p[i], g != nullptr ? g[i] : 0.f, me, ve);
    m[i] = me;
    v[i] = ve;
  }
  const float2 s = block_sum(pp, uu, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
    lamb_apply_kernel(const Leaf* __restrict__ leaves,
                      const Item* __restrict__ items,
                      const float2* __restrict__ partials, const Coeffs k) {
  __shared__ float2 red[kWarps + 1];
  const Item it = items[blockIdx.x];
  const Leaf lf = leaves[it.leaf];
  float pp = 0.f, uu = 0.f;
  for (long long j = threadIdx.x; j < lf.count; j += kThreads) {
    const float2 s = partials[lf.first + j];
    pp += s.x;
    uu += s.y;
  }
  const float2 s = block_sum(pp, uu, red);
  // torch.clamp(‖p‖, 0, 10) and torch.clamp(‖u‖, min=1e-30), NaN kept
  float w = __fsqrt_rn(s.x);
  w = w < 0.f ? 0.f : w;
  w = w > 10.f ? 10.f : w;
  float a = __fsqrt_rn(s.y);
  const bool either_zero = w == 0.f || a == 0.f;
  a = a < 1e-30f ? 1e-30f : a;
  const float trust = either_zero ? 1.f : __fdiv_rn(w, a);
  const float scale = __fmul_rn(k.neg_lr, trust);

  float* __restrict__ p = reinterpret_cast<float*>(lf.p) + it.start;
  const float* __restrict__ m = reinterpret_cast<const float*>(lf.m) + it.start;
  const float* __restrict__ v = reinterpret_cast<const float*>(lf.v) + it.start;
  const int len = static_cast<int>(it.len);
  auto one = [&](float pe, float me, float ve) {
    return __fadd_rn(pe, __fmul_rn(scale, update_of(pe, me, ve, k)));
  };
  int done = 0;
  if (aligned16(p, m, v, p)) {
    const int n4 = len >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 P = p4[i];
      const float4 M = m4[i], V = v4[i];
      P.x = one(P.x, M.x, V.x);
      P.y = one(P.y, M.y, V.y);
      P.z = one(P.z, M.z, V.z);
      P.w = one(P.w, M.w, V.w);
      p4[i] = P;
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    p[i] = one(p[i], m[i], v[i]);
  }
}

}  // namespace

// One LAMB step over a group of at most kMaxLeaves leaves: `leaves` and
// `items` the group's device tables, `grads` its gradients' addresses (host
// array; null for a leaf without one), `partials` float32 [n_items, 2]
// scratch. Launches pass 1 then pass 2 on `stream`; returns the launch's
// CUDA error, 0 when both were queued.
extern "C" int lamb_step(const void* leaves, const void* items, int n_items,
                         const void* const* grads, int n_leaves,
                         void* partials, float b1, float c1, float b2,
                         float c2, float eps, float wd, int decay,
                         float neg_lr, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_items < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Grads g;
  for (int i = 0; i < kMaxLeaves; ++i) {
    g.g[i] = i < n_leaves ? static_cast<const float*>(grads[i]) : nullptr;
  }
  const Coeffs k{b1, c1, b2, c2, eps, wd, neg_lr, decay};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Leaf* lt = static_cast<const Leaf*>(leaves);
  const Item* itab = static_cast<const Item*>(items);
  float2* part = static_cast<float2*>(partials);
  lamb_moments_kernel<<<n_items, kThreads, 0, s>>>(lt, itab, g, k, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lamb_apply_kernel<<<n_items, kThreads, 0, s>>>(lt, itab, part, k);
  return static_cast<int>(cudaGetLastError());
}
