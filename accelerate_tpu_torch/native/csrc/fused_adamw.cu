// One AdamW step for one leaf (or one layer slice of one), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_adamw_kernel` of
// accelerate_tpu/native/pallas/fused_adamw.py (its pallas_call sits in
// `fused_adamw_update`) and computes the same function, the body of
// `parallel/host_offload._adamw_slice` in either package. With M the
// moment dtype (fp32 or bf16; g and p fp32 or bf16):
//   g'  = M(g) [* M(grad_scale)]
//   mu' = b1 mu + (1 - b1) g'
//   nu' = b2 nu + (1 - b2) g'^2
//   u   = -lr * ((mu' / bc1) / (sqrt(nu' / bc2) + eps) + wd M(p))
// where bc1 = 1 - b1^c and bc2 = 1 - b2^c for the count c, computed once
// on the host, and grad_scale (the folded global-norm clip) is a device fp32
// scalar read here, so the caller never syncs. mu and nu are written in
// place, as the TPU kernel aliases them. u is either written out in M (the
// JAX contract, `update, new_mu, new_nu`) or added into p in place
// (`apply`, the train step's use): 28 bytes an fp32 element against the 40
// of update-then-apply.
//
// Numerics. Each operation is one IEEE-rounded fp32 operation
// (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`, `__fsqrt_rn`, so nvcc contracts
// nothing into an FMA), and with bf16 moments each result is rounded to
// bf16, as PyTorch rounds every bf16 tensor op; the constants arrive
// already rounded to M. So the kernel repeats the plain version's
// arithmetic operation for operation.
//
// Bound. About 18 fp32 operations against 28 bytes moved an element
// (g, mu, nu, p read; mu, nu, p written): far below the card's ~20
// operations a byte, so the update is bound by memory at 3.35 TB/s on an
// H100 SXM. The design only has to stream: a grid-stride loop in which each
// thread takes 4 consecutive elements per step with one 16-byte (fp32) or
// 8-byte (bf16) access per array when every pointer is aligned for it,
// and a scalar loop for the rest (or for a misaligned slice). The TPU
// kernel's (rows, block) view, its 1024-element minimum and its
// block-divisor rule are VMEM tiling rules and are dropped: every leaf
// launches, whatever its size. Launch errors are returned to the caller
// (cudaGetLastError after the launch); the wrapper raises on a non-zero
// code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* g;            // (n,) G
  void* mu;                 // (n,) M, in place
  void* nu;                 // (n,) M, in place
  void* p;                  // (n,) P, in place when apply
  void* u;                  // (n,) M, or null when apply
  const float* grad_scale;  // device scalar, or null
  int64_t n;
  // Constants, already rounded to M.
  float b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr;
  int apply, vec;
};

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, int64_t i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float x) { p[i] = __float2bfloat16_rn(x); }

// Elements 4i .. 4i+3 in one access.
__device__ __forceinline__ void ld4(const float* p, int64_t i, float v[4]) {
  const float4 x = reinterpret_cast<const float4*>(p)[i];
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, int64_t i, float v[4]) {
  const uint2 x = reinterpret_cast<const uint2*>(p)[i];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}
__device__ __forceinline__ void st4(float* p, int64_t i, const float v[4]) {
  reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, int64_t i, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<uint32_t*>(&lo);
  x.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[i] = x;
}

// One element: updates mu and nu, returns u. `scale` is M(grad_scale).
template <typename M>
__device__ __forceinline__ float adamw(const Args& a, float g, float scale, float& mu, float& nu, float p) {
  g = rnd<M>(g);
  if (a.grad_scale != nullptr) g = rnd<M>(__fmul_rn(g, scale));
  mu = rnd<M>(__fadd_rn(rnd<M>(__fmul_rn(a.b1, mu)), rnd<M>(__fmul_rn(a.omb1, g))));
  const float sq = rnd<M>(__fmul_rn(g, g));
  nu = rnd<M>(__fadd_rn(rnd<M>(__fmul_rn(a.b2, nu)), rnd<M>(__fmul_rn(a.omb2, sq))));
  const float mu_hat = rnd<M>(__fdiv_rn(mu, a.bc1));
  const float nu_hat = rnd<M>(__fdiv_rn(nu, a.bc2));
  const float den = rnd<M>(__fadd_rn(rnd<M>(__fsqrt_rn(nu_hat)), a.eps));
  const float decay = rnd<M>(__fmul_rn(a.wd, rnd<M>(p)));
  const float step = rnd<M>(__fadd_rn(rnd<M>(__fdiv_rn(mu_hat, den)), decay));
  return rnd<M>(__fmul_rn(a.neg_lr, step));
}

template <typename G, typename M, typename P>
__global__ void __launch_bounds__(kThreads) adamw_kernel(const Args a) {
  const G* g = static_cast<const G*>(a.g);
  M* mu = static_cast<M*>(a.mu);
  M* nu = static_cast<M*>(a.nu);
  P* p = static_cast<P*>(a.p);
  M* u = static_cast<M*>(a.u);
  const float scale = a.grad_scale != nullptr ? rnd<M>(*a.grad_scale) : 1.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t groups = a.vec ? a.n / 4 : 0;
  for (int64_t i = tid; i < groups; i += stride) {
    float gv[4], mv[4], nv[4], pv[4], out[4];
    ld4(g, i, gv);
    ld4(mu, i, mv);
    ld4(nu, i, nv);
    ld4(p, i, pv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float uj = adamw<M>(a, gv[j], scale, mv[j], nv[j], pv[j]);
      out[j] = a.apply ? __fadd_rn(pv[j], uj) : uj;
    }
    st4(mu, i, mv);
    st4(nu, i, nv);
    if (a.apply) {
      st4(p, i, out);
    } else {
      st4(u, i, out);
    }
  }
  for (int64_t i = 4 * groups + tid; i < a.n; i += stride) {
    float m = ld(mu, i), v = ld(nu, i);
    const float pi = ld(p, i);
    const float ui = adamw<M>(a, ld(g, i), scale, m, v, pi);
    st(mu, i, m);
    st(nu, i, v);
    if (a.apply) {
      st(p, i, __fadd_rn(pi, ui));
    } else {
      st(u, i, ui);
    }
  }
}

template <typename G, typename M, typename P>
int launch(const Args& a, int grid, cudaStream_t stream) {
  adamw_kernel<G, M, P><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, mu, nu, p: n elements each, contiguous; u: n elements of the moment
// dtype, or null with apply = 1. Dtype codes: 0 fp32, 1 bf16 (mu and nu
// share m_dtype). vec = 1 only when every pointer is aligned to 4 elements.
extern "C" int atx_fused_adamw(
    const void* g, void* mu, void* nu, void* p, void* u, const void* grad_scale,
    long long n, int g_dtype, int m_dtype, int p_dtype, float b1, float omb1,
    float b2, float omb2, float bc1, float bc2, float eps, float wd, float neg_lr,
    int apply, int vec, int grid, void* stream) {
  const bool codes_ok = g_dtype >= kF32 && g_dtype <= kBF16 && m_dtype >= kF32 &&
                        m_dtype <= kBF16 && p_dtype >= kF32 && p_dtype <= kBF16;
  if (n < 1 || grid < 1 || !codes_ok || (apply != 0) == (u != nullptr) ||
      g == nullptr || mu == nullptr || nu == nullptr || p == nullptr) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.g = g;
  a.mu = mu;
  a.nu = nu;
  a.p = p;
  a.u = u;
  a.grad_scale = static_cast<const float*>(grad_scale);
  a.n = n;
  a.b1 = b1;
  a.omb1 = omb1;
  a.b2 = b2;
  a.omb2 = omb2;
  a.bc1 = bc1;
  a.bc2 = bc2;
  a.eps = eps;
  a.wd = wd;
  a.neg_lr = neg_lr;
  a.apply = apply;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (g_dtype * 4 + m_dtype * 2 + p_dtype) {
    case 0: return launch<float, float, float>(a, grid, s);
    case 1: return launch<float, float, bf16>(a, grid, s);
    case 2: return launch<float, bf16, float>(a, grid, s);
    case 3: return launch<float, bf16, bf16>(a, grid, s);
    case 4: return launch<bf16, float, float>(a, grid, s);
    case 5: return launch<bf16, float, bf16>(a, grid, s);
    case 6: return launch<bf16, bf16, float>(a, grid, s);
    default: return launch<bf16, bf16, bf16>(a, grid, s);
  }
}
