// Flash attention forward and backward for Hopper (sm_90a): three kernels.
//
// They replace the six TPU kernels of accelerate_tpu/ops/flash_attention.py.
// The TPU split into "resident" and "blocked" kernels exists only for the
// TPU's VMEM budget (`_use_resident`); here one kernel per function serves
// every sequence length:
//   fwd  <- `_fwd_kernel_resident` (pallas_call in `_fwd_resident`) and
//           `_fwd_kernel` (in `_fwd`);
//   dq   <- `_dq_kernel_resident` (in `_bwd_resident`) and `_dq_kernel`
//           (in `dq_call`);
//   dkv  <- `_dkv_kernel_resident` (in `_bwd_resident`) and `_dkv_kernel`
//           (in `dkv_call`), plus the GQA fold `fold_gqa_groups`.
//
// Function (the TPU kernels'): q (B, S, H, hd), k/v (B, S, K, hd), query
// head hh reads kv head hh / (H / K). s = scale * q.k^T with fp32
// accumulation; masked entries take the finite -1e30 (with -inf a fully
// masked tile would give exp(-inf - -inf) = NaN); keep(row, col) is
// col <= row (causal) or col < valid (not causal), and row - col < window
// when a window is set; rows and columns >= S never enter. The forward
// keeps an online softmax (m, l, acc) in fp32, casts p to v's dtype for the
// P.V product and writes O in q's dtype and lse = m + log(max(l, 1e-30)) in
// fp32 (B, H, S). The backward takes delta = sum(dO * O) (B, H, S, fp32,
// computed by the caller as XLA does outside Pallas): p = exp(s - lse),
// dp = dO.v^T, ds = p * (dp - delta) cast to k's dtype, dq = scale * ds.k;
// dv = p^T.dO (p cast to dO's dtype), dk = scale * ds^T.q, summed over the
// query heads of each kv head in fp32 inside the kernel.
//
// Design (bf16, tensor cores via mma.sync m16n8k16, fp32 accumulate). The
// TPU grid walks the KV (or Q) axis in order and carries state in VMEM
// scratch; Hopper blocks run in parallel in no order, so that axis becomes a
// loop inside one block:
//   fwd, dq: one block per (q tile of 64 rows, query head, batch), four
//     warps of 16 rows each; the loop walks the live key tiles of 64 (tiles
//     above the diagonal and below the window band are skipped, as `hi` and
//     `lo` do at `:123-126`). fwd keeps Q fragments, the score tile and the
//     output accumulator in registers (p goes from the score accumulators
//     straight into the A operand of P.V); dq keeps Q and dO in shared
//     memory and dq in registers. Launched heaviest causal tile first.
//   dkv: one block per (key tile of 64 rows, kv head, batch) owns dk/dv of
//     its keys in registers and loops over the group's query heads and
//     their live query tiles of 32, so the GQA fold needs no atomics and no
//     (B, S, H, hd) per-head buffers.
// Shared memory: 51-68 KB per block at hd 128 (rows padded by 8 elements),
// set with cudaFuncSetAttribute; 164-240 registers a thread at hd 128 (dkv
// the most, no spills), so two or three blocks of 128 threads share an SM
// of the 132. Ragged S is masked in
// the kernel (tile rows past S are zero-filled and masked), so no padding.
// fp32 runs on CUDA cores (no TF32): one warp per query row (fwd, dq) or key
// row (dkv), lanes across the head dimension, a per-key online softmax.
//
// Bound at the training shape (B 2, H 32, K 8, S 2048, hd 128, bf16,
// causal; H100 SXM 989 TFLOP/s bf16, 3.35 TB/s): fwd 2*B*H*S^2*hd = 68.7
// GFLOP (two products over half the tiles) -> 0.069 ms; dq 3*B*H*S^2*hd ->
// 0.104 ms; dkv 4*B*H*S^2*hd -> 0.139 ms. Bytes (~25-90 MB) take under
// 0.03 ms, so all three are bound by operations. This is the simple first
// version: no TMA, no wgmma, no cp.async pipelining, plain shared-memory
// fragment loads.
//
// Launch errors are returned to the caller (cudaGetLastError after each
// launch); the wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the TPU kernels' finite -inf
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = 64;   // fwd / dq: query rows per block (16 per warp)
constexpr int kTileK = 64;   // fwd / dq: key rows per step; dkv: key rows per block
constexpr int kTileQ2 = 32;  // dkv: query rows per step
constexpr int kPad = 8;      // shared-memory row padding, in elements
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;        // (B, S, H, hd)
  const void* k;        // (B, S, K, hd)
  const void* v;        // (B, S, K, hd)
  const void* dout;     // (B, S, H, hd)   backward only
  const float* lse;     // (B, H, S)       backward only
  const float* delta;   // (B, H, S)       backward only
  void* out;            // fwd: O (B, S, H, hd); dq: dQ; dkv: dK (B, S, K, hd)
  void* out2;           // dkv: dV (B, S, K, hd)
  float* lse_out;       // fwd: (B, H, S)
  int S, H, K, group, valid, window, causal;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int row, int col) {
  if (row >= a.S || col >= a.S) return false;
  bool keep = a.causal ? (col <= row) : (col < a.valid);
  if (a.window > 0) keep = keep && (row - col < a.window);
  return keep;
}

// Live key tiles [lo, hi) for the query rows [q0, q0 + rows).
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int rows, int tile, int& lo, int& hi) {
  const int n = (a.S + tile - 1) / tile;
  hi = a.causal ? min((q0 + rows - 1) / tile + 1, n) : min((a.valid + tile - 1) / tile, n);
  lo = 0;
  if (a.window > 0) {
    const int first = q0 - a.window + 1;  // oldest column any row may see
    if (first > 0) lo = first / tile;
  }
}

// Live query tiles [lo, hi) for the key rows [k0, k0 + rows).
__device__ __forceinline__ void query_tiles(const Args& a, int k0, int rows, int tile, int& lo, int& hi) {
  const int n = (a.S + tile - 1) / tile;
  lo = 0;
  hi = n;
  if (!a.causal && k0 >= a.valid) {
    hi = 0;
    return;
  }
  if (a.causal) lo = k0 / tile;
  if (a.window > 0) hi = min(hi, (k0 + rows - 1 + a.window - 1) / tile + 1);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// ------------------------------------------------------------ bf16 helpers
// Rows [row0, row0 + rows) of one head (row stride `stride` elements) into a
// shared tile with row pitch HD + kPad; rows at or past S are zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int rows, int S,
                                          size_t stride) {
  constexpr int kVec = HD / 8;  // 16-byte vectors per row
  constexpr int LD = HD + kPad;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Two elements of one column from consecutive rows, lower row in the low half.
__device__ __forceinline__ uint32_t pack_rows(const bf16* p, int ld) {
  return uint32_t(__bfloat16_as_ushort(p[0])) | (uint32_t(__bfloat16_as_ushort(p[ld])) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 8+2t..),
//     a3 (g+8, 8+2t..);
//   B (16x8): b0 (k 2t..2t+1, n g), b1 (k 8+2t.., n g);
//   C (16x8, fp32): c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..).
// A from a row-major tile: rows r0.., columns (the k axis) c0...
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile, int ld, int r0, int c0, int g, int t) {
  a[0] = ld32(tile + (r0 + g) * ld + c0 + 2 * t);
  a[1] = ld32(tile + (r0 + g + 8) * ld + c0 + 2 * t);
  a[2] = ld32(tile + (r0 + g) * ld + c0 + 8 + 2 * t);
  a[3] = ld32(tile + (r0 + g + 8) * ld + c0 + 8 + 2 * t);
}

// B[k][n] = tile[n][k]: the tile's rows are the n axis (K or V rows in q.k^T).
__device__ __forceinline__ void load_b_nk(uint32_t b[2], const bf16* tile, int ld, int n0, int k0, int g, int t) {
  b[0] = ld32(tile + (n0 + g) * ld + k0 + 2 * t);
  b[1] = ld32(tile + (n0 + g) * ld + k0 + 8 + 2 * t);
}

// B[k][n] = tile[k][n]: the tile's rows are the k axis (V rows in P.V).
__device__ __forceinline__ void load_b_kn(uint32_t b[2], const bf16* tile, int ld, int k0, int n0, int g, int t) {
  b[0] = pack_rows(tile + (k0 + 2 * t) * ld + n0 + g, ld);
  b[1] = pack_rows(tile + (k0 + 8 + 2 * t) * ld + n0 + g, ld);
}

// The A operand (16 x 16) from two fp32 C tiles (16 x 8 each, columns
// 0-7 and 8-15), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// -------------------------------------------------------------- bf16 fwd
template <int HD>
__global__ void __launch_bounds__(kThreads) fwd_bf16_kernel(const Args a) {
  constexpr int LD = HD + kPad;
  constexpr int NT = kTileK / 8;  // score tiles of 8 keys
  constexpr int DT = HD / 8;      // output tiles of 8 dims
  constexpr int KS = HD / 16;     // k-steps over the head dim
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTileQ * LD;
  bf16* sV = sK + kTileK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int hh = blockIdx.y, b = blockIdx.z, kv = hh / a.group;
  const int q0 = qt * kTileQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t q_stride = (size_t)a.H * HD, kv_stride = (size_t)a.K * HD;
  const bf16* Q = static_cast<const bf16*>(a.q) + ((size_t)b * a.S * a.H + hh) * HD;
  const bf16* Kg = static_cast<const bf16*>(a.k) + ((size_t)b * a.S * a.K + kv) * HD;
  const bf16* Vg = static_cast<const bf16*>(a.v) + ((size_t)b * a.S * a.K + kv) * HD;

  load_rows<HD>(sQ, Q, q0, kTileQ, a.S, q_stride);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a(qf[ks], sQ, LD, warp * 16, ks * 16, g, t);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  int lo, hi;
  key_tiles(a, q0, kTileQ, kTileK, lo, hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kTileK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<HD>(sK, Kg, k0, kTileK, a.S, kv_stride);
    load_rows<HD>(sV, Vg, k0, kTileK, a.S, kv_stride);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bk[2];
        load_b_nk(bk, sK, LD, n * 8, ks * 16, g, t);
        mma(s[n], qf[ks], bk);
      }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * a.scale;
        if (!visible(a, row[r], col)) x = kNegInf;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + rs[r];  // this thread's share of the row sum
      m[r] = mx[r];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t bv[2];
        load_b_kn(bv, sV, LD, kk * 16, d * 8, g, t);
        mma(acc[d], pa, bv);
      }
    }
  }

  bf16* O = static_cast<bf16*>(a.out) + ((size_t)b * a.S * a.H + hh) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    if (row[r] >= a.S) continue;
    const float ls = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)row[r] * q_stride + d * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[d][2 * r] / ls, acc[d][2 * r + 1] / ls);
    }
    if (t == 0) a.lse_out[((size_t)b * a.H + hh) * a.S + row[r]] = m[r] + logf(ls);
  }
}

// --------------------------------------------------------------- bf16 dq
template <int HD>
__global__ void __launch_bounds__(kThreads) dq_bf16_kernel(const Args a) {
  constexpr int LD = HD + kPad;
  constexpr int NT = kTileK / 8;
  constexpr int DT = HD / 8;
  constexpr int KS = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sD = sQ + kTileQ * LD;
  bf16* sK = sD + kTileQ * LD;
  bf16* sV = sK + kTileK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, b = blockIdx.z, kv = hh / a.group;
  const int q0 = qt * kTileQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t q_stride = (size_t)a.H * HD, kv_stride = (size_t)a.K * HD;
  const size_t q_base = ((size_t)b * a.S * a.H + hh) * HD;
  const bf16* Kg = static_cast<const bf16*>(a.k) + ((size_t)b * a.S * a.K + kv) * HD;
  const bf16* Vg = static_cast<const bf16*>(a.v) + ((size_t)b * a.S * a.K + kv) * HD;

  load_rows<HD>(sQ, static_cast<const bf16*>(a.q) + q_base, q0, kTileQ, a.S, q_stride);
  load_rows<HD>(sD, static_cast<const bf16*>(a.dout) + q_base, q0, kTileQ, a.S, q_stride);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const size_t stat = ((size_t)b * a.H + hh) * a.S;
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = row[r] < a.S ? a.lse[stat + row[r]] : 0.f;
    dl[r] = row[r] < a.S ? a.delta[stat + row[r]] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;

  int lo, hi;
  key_tiles(a, q0, kTileQ, kTileK, lo, hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kTileK;
    __syncthreads();
    load_rows<HD>(sK, Kg, k0, kTileK, a.S, kv_stride);
    load_rows<HD>(sV, Vg, k0, kTileK, a.S, kv_stride);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], da[4];
      load_a(qa, sQ, LD, warp * 16, ks * 16, g, t);
      load_a(da, sD, LD, warp * 16, ks * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bk[2], bv[2];
        load_b_nk(bk, sK, LD, n * 8, ks * 16, g, t);
        load_b_nk(bv, sV, LD, n * 8, ks * 16, g, t);
        mma(s[n], qa, bk);
        mma(dp[n], da, bv);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * a.scale;
        if (!visible(a, row[r], col)) x = kNegInf;
        const float p = expf(x - lse[r]);
        s[n][e] = p * (dp[n][e] - dl[r]);  // ds
      }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t dsa[4];
      c_to_a(dsa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t bk[2];
        load_b_kn(bk, sK, LD, kk * 16, d * 8, g, t);
        mma(dq[d], dsa, bk);
      }
    }
  }

  bf16* dQ = static_cast<bf16*>(a.out) + q_base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.S) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dQ + (size_t)row[r] * q_stride + d * 8 + 2 * t) =
          __floats2bfloat162_rn(a.scale * dq[d][2 * r], a.scale * dq[d][2 * r + 1]);
    }
  }
}

// -------------------------------------------------------------- bf16 dkv
template <int HD>
__global__ void __launch_bounds__(kThreads) dkv_bf16_kernel(const Args a) {
  constexpr int LD = HD + kPad;
  constexpr int NQ = kTileQ2 / 8;  // score tiles of 8 queries
  constexpr int DT = HD / 8;
  constexpr int KS = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTileK * LD;
  bf16* sQ = sV + kTileK * LD;
  bf16* sD = sQ + kTileQ2 * LD;
  float* sL = reinterpret_cast<float*>(sD + kTileQ2 * LD);
  float* sDl = sL + kTileQ2;

  const int kt = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t q_stride = (size_t)a.H * HD, kv_stride = (size_t)a.K * HD;
  const size_t kv_base = ((size_t)b * a.S * a.K + kv) * HD;
  load_rows<HD>(sK, static_cast<const bf16*>(a.k) + kv_base, k0, kTileK, a.S, kv_stride);
  load_rows<HD>(sV, static_cast<const bf16*>(a.v) + kv_base, k0, kTileK, a.S, kv_stride);

  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  int lo, hi;
  query_tiles(a, k0, kTileK, kTileQ2, lo, hi);
  for (int gi = 0; gi < a.group; ++gi) {
    const int hh = kv * a.group + gi;
    const size_t q_base = ((size_t)b * a.S * a.H + hh) * HD;
    const size_t stat = ((size_t)b * a.H + hh) * a.S;
    for (int i = lo; i < hi; ++i) {
      const int q0 = i * kTileQ2;
      __syncthreads();
      load_rows<HD>(sQ, static_cast<const bf16*>(a.q) + q_base, q0, kTileQ2, a.S, q_stride);
      load_rows<HD>(sD, static_cast<const bf16*>(a.dout) + q_base, q0, kTileQ2, a.S, q_stride);
      if (threadIdx.x < kTileQ2) {
        const int r = q0 + threadIdx.x;
        sL[threadIdx.x] = r < a.S ? a.lse[stat + r] : 0.f;
        sDl[threadIdx.x] = r < a.S ? a.delta[stat + r] : 0.f;
      }
      __syncthreads();

      // Transposed scores: rows are this warp's 16 keys, columns the 32 queries.
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        load_a(ka, sK, LD, warp * 16, ks * 16, g, t);
        load_a(va, sV, LD, warp * 16, ks * 16, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t bq[2], bd[2];
          load_b_nk(bq, sQ, LD, n * 8, ks * 16, g, t);
          load_b_nk(bd, sD, LD, n * 8, ks * 16, g, t);
          mma(st[n], ka, bq);
          mma(dpt[n], va, bd);
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + 2 * t + (e & 1);
          float x = st[n][e] * a.scale;
          if (!visible(a, q0 + qi, key[e >> 1])) x = kNegInf;
          const float p = expf(x - sL[qi]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sDl[qi]);  // ds^T
        }
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        uint32_t pa[4], dsa[4];
        c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        c_to_a(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          uint32_t bd[2], bq[2];
          load_b_kn(bd, sD, LD, kk * 16, d * 8, g, t);
          load_b_kn(bq, sQ, LD, kk * 16, d * 8, g, t);
          mma(dv[d], pa, bd);
          mma(dk[d], dsa, bq);
        }
      }
    }
  }

  bf16* dK = static_cast<bf16*>(a.out) + kv_base;
  bf16* dV = static_cast<bf16*>(a.out2) + kv_base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.S) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const size_t off = (size_t)key[r] * kv_stride + d * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dK + off) =
          __floats2bfloat162_rn(a.scale * dk[d][2 * r], a.scale * dk[d][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dV + off) = __floats2bfloat162_rn(dv[d][2 * r], dv[d][2 * r + 1]);
    }
  }
}

// ------------------------------------------------ fp32 (CUDA cores, no TF32)
// Columns [lo, hi) that query row r sees.
__device__ __forceinline__ void col_range(const Args& a, int r, int& lo, int& hi) {
  lo = a.window > 0 ? max(0, r - a.window + 1) : 0;
  hi = min(a.causal ? r + 1 : a.valid, a.S);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) fwd_f32_kernel(const Args a) {
  constexpr int E = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp, hh = blockIdx.y, b = blockIdx.z, kv = hh / a.group;
  if (r >= a.S) return;
  const size_t kv_stride = (size_t)a.K * HD;
  const size_t qoff = (((size_t)b * a.S + r) * a.H + hh) * HD;
  const float* Kg = static_cast<const float*>(a.k) + ((size_t)b * a.S * a.K + kv) * HD;
  const float* Vg = static_cast<const float*>(a.v) + ((size_t)b * a.S * a.K + kv) * HD;
  float q[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    q[e] = static_cast<const float*>(a.q)[qoff + e * 32 + lane];
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  int lo, hi;
  col_range(a, r, lo, hi);
  for (int c = lo; c < hi; ++c) {
    const float* kp = Kg + (size_t)c * kv_stride;
    const float* vp = Vg + (size_t)c * kv_stride;
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s = fmaf(q[e], kp[e * 32 + lane], s);
    s = warp_sum(s) * a.scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vp[e * 32 + lane], acc[e] * alpha);
    m = m_new;
  }
  const float ls = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) static_cast<float*>(a.out)[qoff + e * 32 + lane] = acc[e] / ls;
  if (lane == 0) a.lse_out[((size_t)b * a.H + hh) * a.S + r] = m + logf(ls);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(const Args a) {
  constexpr int E = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp, hh = blockIdx.y, b = blockIdx.z, kv = hh / a.group;
  if (r >= a.S) return;
  const size_t kv_stride = (size_t)a.K * HD;
  const size_t qoff = (((size_t)b * a.S + r) * a.H + hh) * HD;
  const float* Kg = static_cast<const float*>(a.k) + ((size_t)b * a.S * a.K + kv) * HD;
  const float* Vg = static_cast<const float*>(a.v) + ((size_t)b * a.S * a.K + kv) * HD;
  const size_t stat = ((size_t)b * a.H + hh) * a.S + r;
  const float lse = a.lse[stat], dl = a.delta[stat];
  float q[E], dO[E], dq[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    q[e] = static_cast<const float*>(a.q)[qoff + e * 32 + lane];
    dO[e] = static_cast<const float*>(a.dout)[qoff + e * 32 + lane];
    dq[e] = 0.f;
  }
  int lo, hi;
  col_range(a, r, lo, hi);
  for (int c = lo; c < hi; ++c) {
    const float* kp = Kg + (size_t)c * kv_stride;
    const float* vp = Vg + (size_t)c * kv_stride;
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s = fmaf(q[e], kp[e * 32 + lane], s);
      dp = fmaf(dO[e], vp[e * 32 + lane], dp);
    }
    s = warp_sum(s) * a.scale;
    dp = warp_sum(dp);
    const float ds = expf(s - lse) * (dp - dl);
#pragma unroll
    for (int e = 0; e < E; ++e) dq[e] = fmaf(ds, kp[e * 32 + lane], dq[e]);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) static_cast<float*>(a.out)[qoff + e * 32 + lane] = a.scale * dq[e];
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dkv_f32_kernel(const Args a) {
  constexpr int E = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * kWarps + warp, kv = blockIdx.y, b = blockIdx.z;
  if (c >= a.S) return;
  const size_t q_stride = (size_t)a.H * HD;
  const size_t koff = (((size_t)b * a.S + c) * a.K + kv) * HD;
  float k[E], v[E], dk[E], dv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    k[e] = static_cast<const float*>(a.k)[koff + e * 32 + lane];
    v[e] = static_cast<const float*>(a.v)[koff + e * 32 + lane];
    dk[e] = dv[e] = 0.f;
  }
  // Rows that see column c.
  int lo = a.causal ? c : 0, hi = a.S;
  if (!a.causal && c >= a.valid) hi = 0;
  if (a.window > 0) hi = min(hi, c + a.window);
  for (int gi = 0; gi < a.group; ++gi) {
    const int hh = kv * a.group + gi;
    const float* Qg = static_cast<const float*>(a.q) + ((size_t)b * a.S * a.H + hh) * HD;
    const float* Dg = static_cast<const float*>(a.dout) + ((size_t)b * a.S * a.H + hh) * HD;
    const size_t stat = ((size_t)b * a.H + hh) * a.S;
    for (int r = lo; r < hi; ++r) {
      const float* qp = Qg + (size_t)r * q_stride;
      const float* dp_ = Dg + (size_t)r * q_stride;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        s = fmaf(qp[e * 32 + lane], k[e], s);
        dp = fmaf(dp_[e * 32 + lane], v[e], dp);
      }
      s = warp_sum(s) * a.scale;
      dp = warp_sum(dp);
      const float p = expf(s - a.lse[stat + r]);
      const float ds = p * (dp - a.delta[stat + r]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dv[e] = fmaf(p, dp_[e * 32 + lane], dv[e]);
        dk[e] = fmaf(ds, qp[e * 32 + lane], dk[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    static_cast<float*>(a.out)[koff + e * 32 + lane] = a.scale * dk[e];
    static_cast<float*>(a.out2)[koff + e * 32 + lane] = dv[e];
  }
}

// ----------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Args& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

constexpr size_t tile_bytes(int rows, int hd) { return (size_t)rows * (hd + kPad) * sizeof(bf16); }

enum Which { kFwd, kDq, kDkv };

template <int HD>
cudaError_t dispatch(Which which, const Args& a, int B, int dtype, cudaStream_t s) {
  const unsigned q_tiles = (a.S + kTileQ - 1) / kTileQ, k_tiles = (a.S + kTileK - 1) / kTileK;
  const unsigned rows4 = (a.S + kWarps - 1) / kWarps;
  if (dtype == kBF16) {
    switch (which) {
      case kFwd:
        return launch(fwd_bf16_kernel<HD>, dim3(q_tiles, a.H, B),
                      tile_bytes(kTileQ + 2 * kTileK, HD), a, s);
      case kDq:
        return launch(dq_bf16_kernel<HD>, dim3(q_tiles, a.H, B),
                      tile_bytes(2 * kTileQ + 2 * kTileK, HD), a, s);
      case kDkv:
        return launch(dkv_bf16_kernel<HD>, dim3(k_tiles, a.K, B),
                      tile_bytes(2 * kTileK + 2 * kTileQ2, HD) + 2 * kTileQ2 * sizeof(float), a, s);
    }
  }
  switch (which) {
    case kFwd: return launch(fwd_f32_kernel<HD>, dim3(rows4, a.H, B), 0, a, s);
    case kDq: return launch(dq_f32_kernel<HD>, dim3(rows4, a.H, B), 0, a, s);
    case kDkv: return launch(dkv_f32_kernel<HD>, dim3(rows4, a.K, B), 0, a, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t run(Which which, Args& a, int B, int S, int H, int K, int head_dim, float scale, int causal,
                int valid, int window, int dtype, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H < K || H % K != 0 || H > 65535 || B > 65535 ||
      valid < 0 || valid > S || (dtype != kF32 && dtype != kBF16)) {
    return cudaErrorInvalidValue;
  }
  a.S = S;
  a.H = H;
  a.K = K;
  a.group = H / K;
  a.valid = valid;
  a.window = window > 0 ? window : 0;
  a.causal = causal != 0;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return dispatch<128>(which, a, B, dtype, s);
  if (head_dim == 64) return dispatch<64>(which, a, B, dtype, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points (loaded with ctypes). Layouts: q, o, dout, dq (B, S, H, hd)
// and k, v, dk, dv (B, S, K, hd), contiguous, of one dtype (0 fp32, 1 bf16);
// lse and delta (B, H, S) fp32. head_dim 64 or 128; window <= 0 means none;
// valid <= S masks columns >= valid when not causal. Return a cudaError_t.
extern "C" int atx_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                       int B, int S, int H, int K, int head_dim, float scale, int causal,
                                       int valid, int window, int dtype, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = o;
  a.lse_out = static_cast<float*>(lse);
  return run(kFwd, a, B, S, H, K, head_dim, scale, causal, valid, window, dtype, stream);
}

extern "C" int atx_flash_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                                      const void* lse, const void* delta, void* dq, int B, int S, int H,
                                      int K, int head_dim, float scale, int causal, int valid, int window,
                                      int dtype, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  return run(kDq, a, B, S, H, K, head_dim, scale, causal, valid, window, dtype, stream);
}

extern "C" int atx_flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                                       const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                                       int H, int K, int head_dim, float scale, int causal, int valid,
                                       int window, int dtype, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dk;
  a.out2 = dv;
  return run(kDkv, a, B, S, H, K, head_dim, scale, causal, valid, window, dtype, stream);
}
