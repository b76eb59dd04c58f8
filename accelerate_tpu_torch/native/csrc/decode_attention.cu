// Flash-decode attention over the slot KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` of
// accelerate_tpu/native/pallas/decode_attention.py (its pallas_call sits in
// `flash_decode`), and computes the same function: one query token per row,
// q (B, 1, H, h) against a cache k/v (B, T, K, h) in bf16 or fp32, or in
// int8 with per-(token, kv-head) bf16 scales (B, T, K) dequantized here as
// `k * scale`. Query head kk*group + g reads kv head kk (GQA). Logits,
// softmax and the P.V sum are fp32 at scale 1/sqrt(h); only the columns
// t < lengths[b] enter, and the output is acc / max(l, 1e-30) in q's dtype.
//
// Design. The TPU grid walks T in order and carries the running max m,
// normalizer l and accumulator acc in VMEM from one block to the next. On
// Hopper blocks run in parallel in no order, so T is split instead:
//   pass 1, grid (n_splits, K, B): a block takes one (b, kv-head) pair and
//     one chunk of T; its four warps take interleaved tokens, each warp
//     keeping its own (m, l, acc) for the `group` query heads in registers
//     (lane `l` holds head-dim elements e*32 + l, so each row load is one
//     coalesced 64/128-byte access per element). The warps merge through
//     shared memory and the block writes one fp32 partial (m, l, acc).
//   pass 2, grid (H, B): merges the n_splits partials of each query head.
// The kernel masks the ragged tail itself (it never reads t >= lengths[b],
// and a chunk wholly past the cursor writes an empty partial without
// touching the cache), so unlike the TPU version it takes any T.
//
// Bound. Decode reads each cached K/V byte once: sum_b lengths[b] * K * h *
// 2 * sizeof(kv) (+ the int8 scales), against ~4 * sum_b lengths[b] * H * h
// fp32 operations, so it is bound by memory: at 3.35 TB/s on an H100 SXM.
// The fp32 partials (B * H * n_splits * (h + 2) floats) are the price of
// the split; the wrapper picks n_splits to fill the card's SMs.
//
// This is the simple first version: no TMA, no wgmma, no cp.async
// pipelining. Launch errors are returned to the caller (cudaGetLastError
// after each launch); the wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;
constexpr float kNegInf = -1e30f;  // the TPU kernel's finite -inf

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Args {
  const void* q;          // (B, H, h)          q dtype
  const void* k;          // (B, T, K, h)       kv dtype
  const void* v;          // (B, T, K, h)
  const __nv_bfloat16* k_scale;  // (B, T, K) or null (int8 only)
  const __nv_bfloat16* v_scale;
  const int32_t* lengths; // (B,)
  float* part_m;          // (B, H, n_splits)
  float* part_l;          // (B, H, n_splits)
  float* part_acc;        // (B, H, n_splits, h)
  void* out;              // (B, H, h)          q dtype
  int T, K, group, chunk;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Pass 1: one (split, kv head, row) per block. E = head_dim / 32.
template <typename QT, typename KVT, int E>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(const Args a) {
  constexpr int h = 32 * E;
  const int split = blockIdx.x, kk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int H = a.K * a.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int len = min(max(a.lengths[b], 0), a.T);
  const int t0 = split * a.chunk;
  const int t1 = min(t0 + a.chunk, len);

  if (t0 >= t1) {  // wholly past the cursor: an empty partial, no cache reads
    for (int i = threadIdx.x; i < a.group * h; i += kThreads) {
      const int g = i / h, d = i % h;
      const size_t p = (size_t(b) * H + kk * a.group + g) * n_splits + split;
      a.part_acc[p * h + d] = 0.f;
      if (d == 0) {
        a.part_m[p] = kNegInf;
        a.part_l[p] = 0.f;
      }
    }
    return;
  }

  const QT* q = static_cast<const QT*>(a.q);
  const KVT* kc = static_cast<const KVT*>(a.k);
  const KVT* vc = static_cast<const KVT*>(a.v);

  float qr[kMaxGroup][E];
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][E];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < a.group
          ? to_f32(q[(size_t(b) * H + kk * a.group + g) * h + e * 32 + lane])
          : 0.f;
    }
  }

#pragma unroll 2
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const size_t row = (size_t(b) * a.T + t) * a.K + kk;  // (b, t, kk)
    const KVT* kp = kc + row * h;
    const KVT* vp = vc + row * h;
    float kr[E], vr[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kr[e] = to_f32(kp[e * 32 + lane]);
      vr[e] = to_f32(vp[e * 32 + lane]);
    }
    if (a.k_scale != nullptr) {
      const float ks = __bfloat162float(a.k_scale[row]);
      const float vs = __bfloat162float(a.v_scale[row]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[e] *= ks;
        vr[e] *= vs;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < a.group) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[g][e], kr[e], s);
        s = warp_sum(s) * a.scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vr[e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

  // Merge the four warps' online-softmax states, then write one partial.
  __shared__ float sm_m[kWarps][kMaxGroup];
  __shared__ float sm_l[kWarps][kMaxGroup];
  __shared__ float sm_acc[kWarps][kMaxGroup][h];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < a.group) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][g][e * 32 + lane] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.group * h; i += kThreads) {
    const int g = i / h, d = i % h;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      ls += sm_l[w][g] * c;
      as += sm_acc[w][g][d] * c;
    }
    const size_t p = (size_t(b) * H + kk * a.group + g) * n_splits + split;
    a.part_acc[p * h + d] = as;
    if (d == 0) {
      a.part_m[p] = mx;
      a.part_l[p] = ls;
    }
  }
}

// Pass 2: merge the n_splits partials of one (row, query head); one thread
// per head-dim element.
template <typename QT>
__global__ void decode_combine_kernel(const Args a, int n_splits, int h) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int H = gridDim.x;
  const size_t base = (size_t(b) * H + hq) * n_splits;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, a.part_m[base + s]);
  float ls = 0.f, as = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float c = expf(a.part_m[base + s] - mx);
    ls += a.part_l[base + s] * c;
    as += a.part_acc[(base + s) * h + d] * c;
  }
  from_f32(static_cast<QT*>(a.out) + (size_t(b) * H + hq) * h + d, as / fmaxf(ls, 1e-30f));
}

template <typename QT, typename KVT, int E>
cudaError_t launch(const Args& a, int B, int n_splits, cudaStream_t stream) {
  decode_partial_kernel<QT, KVT, E><<<dim3(n_splits, a.K, B), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<QT><<<dim3(a.K * a.group, B), 32 * E, 0, stream>>>(a, n_splits, 32 * E);
  return cudaGetLastError();
}

// head_dim 128 = 32 lanes x 4 elements: every preset (Llama-3 8B, 70B).
template <typename QT, typename KVT>
cudaError_t by_head_dim(const Args& a, int B, int head_dim, int n_splits, cudaStream_t stream) {
  if (head_dim != 128) return cudaErrorInvalidValue;
  return launch<QT, KVT, 4>(a, B, n_splits, stream);
}

}  // namespace

// C entry point (loaded with ctypes). dtype codes: 0 fp32, 1 bf16, 2 int8.
// Takes q/kv pairs (fp32, fp32), (bf16, bf16), (fp32 or bf16, int8 + bf16
// scales); head_dim 128; group <= 8. All arrays contiguous.
// Returns a cudaError_t (0 on success).
extern "C" int atx_flash_decode(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* part_m, void* part_l,
    void* part_acc, void* out, int B, int T, int K, int group, int head_dim,
    int n_splits, int chunk, float scale, int q_dtype, int kv_dtype, void* stream) {
  const bool both_scales = k_scale != nullptr && v_scale != nullptr;
  const bool any_scale = k_scale != nullptr || v_scale != nullptr;
  if (B < 1 || T < 1 || K < 1 || group < 1 || group > kMaxGroup || n_splits < 1 ||
      chunk < 1 || (long long)n_splits * chunk < T || K > 65535 || B > 65535 ||
      (kv_dtype == kI8 ? !both_scales : any_scale)) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  a.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.out = out;
  a.T = T;
  a.K = K;
  a.group = group;
  a.chunk = chunk;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32) return by_head_dim<float, float>(a, B, head_dim, n_splits, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(a, B, head_dim, n_splits, s);
  if (q_dtype == kF32 && kv_dtype == kI8) return by_head_dim<float, int8_t>(a, B, head_dim, n_splits, s);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return by_head_dim<__nv_bfloat16, int8_t>(a, B, head_dim, n_splits, s);
  return cudaErrorInvalidValue;
}
