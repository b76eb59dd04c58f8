// Quantized matrix products for Hopper (sm_90a): the fp8 and int8 kernels.
//
// They replace the two TPU kernels of accelerate_tpu/native/pallas/quant_matmul.py,
// which share one tiling:
//   fp8_matmul   <- `_scaled_kernel` (pallas_call in `scaled_matmul`, :225):
//                   out[M, N] = (sum_C a * b in fp32) * scale, cast to bf16 or
//                   fp32; a and b are each e4m3 or e5m2, `scale` is an fp32
//                   scalar read from device memory inside the kernel (the
//                   product of the per-tensor scales, never a host value).
//   int8_matmul  <- `_int8_kernel` (pallas_call in `int8_matmul_fused`, :190):
//                   each row of x (bf16 / fp32, (M, C)) quantized with
//                   sx = max(amax, 1e-12) / 127, q = clip(rint(x / sx), +-127)
//                   (a true division, round half to even), an int8 x int8 ->
//                   int32 product with the int8 weight, and
//                   out = float(acc) * (sx[m] * ws[n]) in x's dtype, ws being
//                   one fp32 weight scale per output column (the wrapper
//                   expands the per-channel scale first).
//
// Orientation. Every matmul-shaped einsum of the model is one of four 2D
// products, reached by reshape (`_parse_matmul_eq`): an operand is "trail"
// when its contracted axes are its last ones, stored (rows, C) with C
// contiguous, or "lead", stored (C, rows) with rows contiguous. The tensor
// cores (mma.sync m16n8k32 with 8-bit operands) take both operands K-major,
// and ldmatrix .trans does not exist for 8-bit types, so a lead operand is
// transposed while it is staged into shared memory: each thread reads a
// 4 (k) x 4 (row) block of bytes with four 32-bit loads, transposes it in
// registers with __byte_perm and writes four 32-bit words, one per row. No
// separate transpose pass over device memory, no change of layout.
//
// Design (simple first version): a block computes a 128 x 128 output tile
// with 8 warps of 64 x 32 each; the C loop walks 64-byte k tiles, kept K-major
// in shared memory with rows padded to 80 bytes (conflict-free fragment
// loads); the next k tile is loaded into registers while the tensor cores
// work on the current one (register double buffering, one shared buffer).
// Ragged M, N and C are masked in the kernel: tile rows and k past the edge
// are zero-filled (an fp8 or int8 zero adds nothing), stores past the edge are
// skipped, so nothing is padded. An operand whose rows are not 16-byte (trail)
// or 4-byte (lead) aligned takes a byte-wise path through the same tiles.
//
// int8's row scale needs the whole row before any tile can be quantized. The
// port takes the pre-pass route: `row_quantize_kernel` (one block per row)
// writes int8 x and sx, then the GEMM reads int8 rows (trail) against the
// weight (lead). The other route, each block recomputing its rows' amax over
// all of C in a prologue, would repeat that read N / 128 times (32 times at
// N 4096); the pre-pass costs one read of x plus M x C bytes written and read
// (8 MB each way at M 2048, C 4096).
//
// Bound (H100 SXM: 1,979 TFLOP/s fp8 and int8 dense, 3.35 TB/s): at the
// shapes of the paths (M 2048-4096, C and N 1024-14336) both are bound by
// operations, 2 * M * N * C: the fp8 gate/up product (4096 x 4096 x 14336,
// 4.81e11 FLOP) takes at least 0.243 ms, its bytes 0.058 ms. mma.sync
// (not wgmma), synchronous shared-memory stores and no TMA keep this version
// well above that bound; `chip_smoke.py` measures by how much.
//
// Launch errors are returned to the caller (cudaGetLastError after each
// launch); the wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;          // output rows per block
constexpr int kBN = 128;          // output columns per block
constexpr int kBK = 64;           // contracted elements (= bytes) per k tile
constexpr int kLd = kBK + 16;     // shared row pitch in bytes
constexpr int kThreads = 256;     // 8 warps: 2 (rows) x 4 (columns) of 64 x 32
constexpr int kUnits = kBM * kBK / 16 / kThreads;  // 16-byte staging units a thread
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBM == kBN, "the staging maps assume square tiles");
static_assert(kUnits == 2, "the staging maps assume two units a thread");

enum Elem { kE4M3 = 0, kE5M2 = 1, kS8 = 2 };
enum OutType { kOutF32 = 0, kOutBF16 = 1 };

struct Operand {
  const uint8_t* ptr;
  int rows;   // M for a, N for b
  int lead;   // 1: stored (C, rows), rows contiguous; 0: stored (rows, C)
  int vec;    // aligned fast path: trail C % 16 == 0, lead rows % 4 == 0
};

struct GemmArgs {
  Operand a, b;
  int M, N, C;
  void* out;               // (M, N) row-major, kOutF32 or kOutBF16
  int out_type;
  const float* scale;      // fp8: one fp32 scalar
  const float* row_scale;  // int8: (M,)
  const float* col_scale;  // int8: (N,)
};

// ----------------------------------------------------------------- staging
// A k tile of one operand is rows x kBK bytes, K-major. Unit u of 512:
//   trail: row u / 4, bytes 16 * (u % 4) .. +15 of the row (one 16-byte load);
//   lead:  rows 4 * (u / 16) .. +3, k 4 * (u % 16) .. +3 (four 32-bit loads,
//          transposed in registers). A warp then covers 2 row quads x 16 k
//          quads, so its 32 stores of one word land in 32 distinct banks.
__device__ __forceinline__ uint4 transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
  // w_j holds rows r..r+3 of k row j; word i of the result holds k 0..3 of row i.
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  return make_uint4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                    __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
}

__device__ __forceinline__ void fetch(const Operand& op, int C, int row0, int k0, uint4 (&regs)[kUnits]) {
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = threadIdx.x + i * kThreads;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (!op.lead) {
      const int row = row0 + (u >> 2), k = k0 + ((u & 3) << 4);
      if (row < op.rows && k < C) {
        const uint8_t* src = op.ptr + (size_t)row * C + k;
        if (op.vec) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            if (k + b < C) w[b >> 2] |= uint32_t(src[b]) << (8 * (b & 3));
          }
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    } else {
      const int k = k0 + 4 * (u & 15), row = row0 + 4 * (u >> 4);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (row < op.rows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k + j >= C) continue;
          const uint8_t* src = op.ptr + (size_t)(k + j) * op.rows + row;
          if (op.vec) {
            w[j] = *reinterpret_cast<const uint32_t*>(src);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              if (row + b < op.rows) w[j] |= uint32_t(src[b]) << (8 * b);
            }
          }
        }
      }
      v = transpose4x4(w[0], w[1], w[2], w[3]);
    }
    regs[i] = v;
  }
}

__device__ __forceinline__ void stage(const Operand& op, uint8_t* tile, const uint4 (&regs)[kUnits]) {
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = threadIdx.x + i * kThreads;
    if (!op.lead) {
      *reinterpret_cast<uint4*>(tile + (u >> 2) * kLd + ((u & 3) << 4)) = regs[i];
    } else {
      uint8_t* dst = tile + 4 * (u >> 4) * kLd + 4 * (u & 15);
      *reinterpret_cast<uint32_t*>(dst) = regs[i].x;
      *reinterpret_cast<uint32_t*>(dst + kLd) = regs[i].y;
      *reinterpret_cast<uint32_t*>(dst + 2 * kLd) = regs[i].z;
      *reinterpret_cast<uint32_t*>(dst + 3 * kLd) = regs[i].w;
    }
  }
}

// --------------------------------------------------------------- mma.sync
// Fragments of mma.m16n8k32 with 8-bit operands (PTX ISA), lane = 4 * g + t:
//   A (16 x 32, row): a0 (row g, k 4t..4t+3), a1 (g+8, 4t..), a2 (g, 16+4t..),
//     a3 (g+8, 16+4t..), the lowest k in the lowest byte;
//   B (32 x 8, col):  b0 (k 4t..4t+3, column g), b1 (k 16+4t.., column g);
//   C (16 x 8):       c0 c1 (row g, columns 2t, 2t+1), c2 c3 (row g+8, ...).
template <int AT, int BT>
struct Mma;

#define ATX_FP8_MMA(AT, BT, NAME)                                                                 \
  template <>                                                                                     \
  struct Mma<AT, BT> {                                                                            \
    using Acc = float;                                                                            \
    static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], const uint32_t b[2]) { \
      asm volatile("mma.sync.aligned.m16n8k32.row.col.f32." NAME ".f32 "                          \
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"            \
                   : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                               \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));           \
    }                                                                                             \
  };
ATX_FP8_MMA(kE4M3, kE4M3, "e4m3.e4m3")
ATX_FP8_MMA(kE5M2, kE4M3, "e5m2.e4m3")
ATX_FP8_MMA(kE4M3, kE5M2, "e4m3.e5m2")
ATX_FP8_MMA(kE5M2, kE5M2, "e5m2.e5m2")
#undef ATX_FP8_MMA

template <>
struct Mma<kS8, kS8> {
  using Acc = int;
  static __device__ __forceinline__ void run(int c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Two neighbouring columns of one output row; the pair store needs N even
// (so the pair is aligned) and both columns inside.
__device__ __forceinline__ void store_pair(const GemmArgs& g, int row, int col, float v0, float v1) {
  const size_t at = (size_t)row * g.N + col;
  const bool pair = col + 1 < g.N && (g.N & 1) == 0;
  if (g.out_type == kOutBF16) {
    bf16* o = static_cast<bf16*>(g.out) + at;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      if (col < g.N) o[0] = __float2bfloat16_rn(v0);
      if (col + 1 < g.N) o[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* o = static_cast<float*>(g.out) + at;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      if (col < g.N) o[0] = v0;
      if (col + 1 < g.N) o[1] = v1;
    }
  }
}

template <int AT, int BT>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const GemmArgs g) {
  using Op = Mma<AT, BT>;
  using Acc = typename Op::Acc;
  constexpr bool kInt = std::is_same<Acc, int>::value;
  __shared__ __align__(16) uint8_t sa[kBM * kLd];
  __shared__ __align__(16) uint8_t sb[kBN * kLd];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);

  uint4 ra[kUnits], rb[kUnits];
  const int nk = (g.C + kBK - 1) / kBK;
  fetch(g.a, g.C, m0, 0, ra);
  fetch(g.b, g.C, n0, 0, rb);
  stage(g.a, sa, ra);
  stage(g.b, sb, rb);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {  // in flight while the tensor cores work on tile kt
      fetch(g.a, g.C, m0, (kt + 1) * kBK, ra);
      fetch(g.b, g.C, n0, (kt + 1) * kBK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* p = sa + (wm + mi * 16 + gq) * kLd + kk + 4 * tq;
        af[mi][0] = ld32(p);
        af[mi][1] = ld32(p + 8 * kLd);
        af[mi][2] = ld32(p + 16);
        af[mi][3] = ld32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = sb + (wn + ni * 8 + gq) * kLd + kk + 4 * tq;
        bfr[ni][0] = ld32(p);
        bfr[ni][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Op::run(acc[mi][ni], af[mi], bfr[ni]);
    }
    if (more) {
      __syncthreads();  // every warp is done reading tile kt
      stage(g.a, sa, ra);
      stage(g.b, sb, rb);
      __syncthreads();
    }
  }

  float s = 1.0f;
  if constexpr (!kInt) s = *g.scale;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + gq + 8 * half;
      if (row >= g.M) continue;
      float rs = 0.0f;
      if constexpr (kInt) rs = g.row_scale[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * tq;
        if (col >= g.N) continue;
        float v0, v1;
        if constexpr (kInt) {
          // float(acc) * (sx * ws), the reference's order of roundings.
          v0 = __int2float_rn(acc[mi][ni][2 * half]) * (rs * g.col_scale[col]);
          v1 = col + 1 < g.N ? __int2float_rn(acc[mi][ni][2 * half + 1]) * (rs * g.col_scale[col + 1]) : 0.0f;
        } else {
          v0 = acc[mi][ni][2 * half] * s;
          v1 = acc[mi][ni][2 * half + 1] * s;
        }
        store_pair(g, row, col, v0, v1);
      }
    }
  }
}

// ------------------------------------------------------------ row quantize
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// One block per row of x (M, C): sx = max(amax, 1e-12) / 127, then
// q = clip(rint(x / sx), -127, 127) with IEEE division (no fast math).
template <typename T>
__global__ void __launch_bounds__(kThreads) row_quantize_kernel(const T* x, int8_t* q, float* sx, int C) {
  __shared__ float part[kThreads / 32];
  const size_t base = (size_t)blockIdx.x * C;
  float amax = 0.0f;
  for (int c = threadIdx.x; c < C; c += kThreads) amax = fmaxf(amax, fabsf(to_float(x[base + c])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, part[w]);
  const float s = fmaxf(amax, 1e-12f) / 127.0f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float v = rintf(to_float(x[base + c]) / s);
    q[base + c] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

Operand make_operand(const void* ptr, int rows, int C, int lead) {
  Operand op;
  op.ptr = static_cast<const uint8_t*>(ptr);
  op.rows = rows;
  op.lead = lead != 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(ptr);
  op.vec = op.lead ? (rows % 4 == 0 && addr % 4 == 0) : (C % 16 == 0 && addr % 16 == 0);
  return op;
}

dim3 gemm_grid(int M, int N) { return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM); }

bool bad_shape(int M, int N, int C) {
  return M < 1 || N < 1 || C < 1 || (M + kBM - 1) / kBM > 65535;
}

}  // namespace

// C entry points (loaded with ctypes); each returns a cudaError_t.
//
// atx_fp8_matmul: a is (M, C) (a_lead 0) or (C, M) (a_lead 1), b is (N, C)
// (b_lead 0) or (C, N) (b_lead 1), contiguous; a_type / b_type 0 e4m3, 1
// e5m2; scale points at one fp32 on the device; out (M, N) contiguous,
// out_type 0 fp32, 1 bf16.
extern "C" int atx_fp8_matmul(const void* a, const void* b, const void* scale, void* out, int M, int N,
                              int C, int a_lead, int b_lead, int a_type, int b_type, int out_type,
                              void* stream) {
  if (bad_shape(M, N, C) || a_type < 0 || a_type > 1 || b_type < 0 || b_type > 1 ||
      (out_type != kOutF32 && out_type != kOutBF16)) {
    return cudaErrorInvalidValue;
  }
  GemmArgs g = {};
  g.a = make_operand(a, M, C, a_lead);
  g.b = make_operand(b, N, C, b_lead);
  g.M = M;
  g.N = N;
  g.C = C;
  g.out = out;
  g.out_type = out_type;
  g.scale = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = gemm_grid(M, N);
  switch (a_type * 2 + b_type) {
    case 0: gemm_kernel<kE4M3, kE4M3><<<grid, kThreads, 0, s>>>(g); break;
    case 1: gemm_kernel<kE4M3, kE5M2><<<grid, kThreads, 0, s>>>(g); break;
    case 2: gemm_kernel<kE5M2, kE4M3><<<grid, kThreads, 0, s>>>(g); break;
    default: gemm_kernel<kE5M2, kE5M2><<<grid, kThreads, 0, s>>>(g); break;
  }
  return cudaGetLastError();
}

// atx_int8_matmul: x (M, C) contiguous, x_type 0 fp32, 1 bf16 (the output's
// type too); wq int8 (N, C) (b_lead 0) or (C, N) (b_lead 1); ws fp32 (N,);
// qx (M, C) int8 and sx (M,) fp32 are the caller's scratch for the row
// quantize pre-pass; out (M, N) contiguous.
extern "C" int atx_int8_matmul(const void* x, const void* wq, const void* ws, void* qx, void* sx, void* out,
                               int M, int N, int C, int b_lead, int x_type, void* stream) {
  if (bad_shape(M, N, C) || (x_type != kOutF32 && x_type != kOutBF16)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(qx);
  float* scales = static_cast<float*>(sx);
  if (x_type == kOutBF16) {
    row_quantize_kernel<bf16><<<M, kThreads, 0, s>>>(static_cast<const bf16*>(x), q, scales, C);
  } else {
    row_quantize_kernel<float><<<M, kThreads, 0, s>>>(static_cast<const float*>(x), q, scales, C);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GemmArgs g = {};
  g.a = make_operand(qx, M, C, 0);
  g.b = make_operand(wq, N, C, b_lead);
  g.M = M;
  g.N = N;
  g.C = C;
  g.out = out;
  g.out_type = x_type;
  g.row_scale = scales;
  g.col_scale = static_cast<const float*>(ws);
  gemm_kernel<kS8, kS8><<<gemm_grid(M, N), kThreads, 0, s>>>(g);
  return cudaGetLastError();
}
