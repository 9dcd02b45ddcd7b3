// log_gemm.cu - log-domain (Mitchell / Log-our) GEMM for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/mitchell_gemm.py:
//   mitchell_matmul       (-> _kernel):       int8 x, w -> int32
//   mitchell_matmul_fused (-> _fused_kernel): f32/bf16 x, w -> f32, with
//     quantization on load and the (acc * sx) * sw epilogue.
// Both forms are one template, log_gemm_kernel<TX, TW, FUSED, COMP>.
//
// What it computes, per scalar pair (a, b), following _log_product of
// the reference line for line: x = |a|, y = |b|, k = leading-one
// position (k = 0 for 0), q = value - 2^k,
//   p = 2^(k1+k2) + q1*2^k2 + q2*2^k1                   (mitchell)
//   p = (2^(k1+k2) | comp) + q1*2^k2 + q2*2^k1          (log_our, COMP)
//       comp = q_small << (LoD(q_big) + round_up), 0 if q_big == 0,
//       round_up = (q_big << 1) >= 3 * 2^LoD(q_big)
// then a zero guard (x == 0 or y == 0 gives 0), then the sign, summed
// over K in 32 bits with two's-complement wrap (unsigned accumulation:
// at 16-bit operands the int32 sum can overflow, and the reference
// wraps).
//
// What bounds it on an H100: int32 ALU work.  Counted from log_product
// and the inner loop below, one product costs about 28 integer
// operations with compensation and 11 without (shifts, adds, min/max,
// clz, compares, selects, the sign multiply and the accumulate), at most
// 132 SMs x 64 int32 lanes a clock.  Bytes (x and w read once, the
// output written once, at 3.35 TB/s) bound only a GEMM with a handful of
// rows.
//
// Design: each operand's (q, k, sign, magnitude) is worked out once when
// it is staged in shared memory, so the inner loop does only the
// pairwise part.  One block owns a BM x BN output tile and loops over K
// in BK steps; ragged M/N/K edges are masked (out-of-range operands
// load as 0, whose sign 0 annihilates the product).  Quantization is
// round(v / scale) with IEEE division (__fdiv_rn) and round-half-to-even
// (rintf), clipped to +-qmax; build without fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 16;             // output rows per block
constexpr int BN = 64;             // output columns per block
constexpr int BK = 32;             // K per shared-memory step
constexpr int TY = 4;              // thread rows
constexpr int THREADS = BN * TY;   // 256 threads: one column, BM/TY rows each
constexpr int RPT = BM / TY;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int quantize(float v, float scale, int qmax) {
  float q = rintf(__fdiv_rn(v, scale));
  q = fminf(fmaxf(q, -static_cast<float>(qmax)), static_cast<float>(qmax));
  return static_cast<int>(q);
}

template <bool FUSED, typename T>
__device__ __forceinline__ int operand(T v, float scale, int qmax) {
  if constexpr (FUSED) {
    return quantize(widen(v), scale, qmax);
  } else {
    return static_cast<int>(v);
  }
}

// floor(log2(v)) capped at bits-1, 0 for v == 0 (the reference's
// leading_one loop over i in [1, bits))
__device__ __forceinline__ uint32_t lod(uint32_t v, int bits) {
  return v == 0u ? 0u
                 : min(31u - static_cast<uint32_t>(__clz(v)),
                       static_cast<uint32_t>(bits - 1));
}

// one operand as staged in shared memory: q = mag - 2^k, k, sign, mag
// (for a zero operand q = k = 0: the product is guarded to 0 anyway)
__device__ __forceinline__ int4 decompose(int v, int bits) {
  const int s = (v > 0) - (v < 0);
  const uint32_t mag = static_cast<uint32_t>(v < 0 ? -v : v);
  const uint32_t k = lod(mag, bits);
  const uint32_t q = mag == 0u ? 0u : mag - (1u << k);
  return make_int4(static_cast<int>(q), static_cast<int>(k), s,
                   static_cast<int>(mag));
}

// magnitude product of two decomposed operands (unsigned shifts: the
// reference's int32 values here are all nonnegative and below 2^31)
template <bool COMP>
__device__ __forceinline__ uint32_t log_product(int4 a, int4 b, int bits) {
  const uint32_t q1 = a.x, k1 = a.y, q2 = b.x, k2 = b.y;
  const uint32_t lead = 1u << (k1 + k2);
  const uint32_t cross = (q1 << k2) + (q2 << k1);
  uint32_t p;
  if constexpr (COMP) {
    const uint32_t q_big = max(q1, q2), q_small = min(q1, q2);
    const uint32_t m = lod(q_big, bits);
    const uint32_t round_up = (q_big << 1) >= (1u << m) * 3u ? 1u : 0u;
    const uint32_t comp = q_big > 0u ? q_small << (m + round_up) : 0u;
    p = (lead | comp) + cross;
  } else {
    p = lead + cross;
  }
  return (a.w == 0 || b.w == 0) ? 0u : p;  // zero guard, then the sign
}

template <typename TX, typename TW, bool FUSED, bool COMP>
__global__ void __launch_bounds__(THREADS)
log_gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                const float* __restrict__ sx_ptr,
                const float* __restrict__ sw,
                typename std::conditional<FUSED, float, int32_t>::type*
                    __restrict__ out,
                int M, int K, int N, int bits) {
  __shared__ int4 s_a[BM * BK];
  __shared__ int4 s_b[BK * BN];

  const int tid = threadIdx.x;
  const int tx = tid % BN, ty = tid / BN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int qmax = (1 << (bits - 1)) - 1;
  float sx = 0.f;
  if constexpr (FUSED) sx = *sx_ptr;
  const int col = n0 + tx;
  const int rows = min(BM, M - m0);

  uint32_t acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      int a = 0;
      if (gm < M && gk < K) {
        a = operand<FUSED>(x[static_cast<size_t>(gm) * K + gk], sx, qmax);
      }
      s_a[i] = decompose(a, bits);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gn = n0 + c;
      int b = 0;
      if (gk < K && gn < N) {
        float swn = 0.f;
        if constexpr (FUSED) swn = sw[gn];
        b = operand<FUSED>(w[static_cast<size_t>(gk) * N + gn], swn, qmax);
      }
      s_b[i] = decompose(b, bits);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const int4 bo = s_b[kk * BN + tx];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = ty + r * TY;  // uniform across a warp
        if (row < rows) {
          const int4 ao = s_a[row * BK + kk];
          const uint32_t p = log_product<COMP>(ao, bo, bits);
          acc[r] += static_cast<uint32_t>(ao.z * bo.z) * p;
        }
      }
    }
  }

  if (col < N) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = ty + r * TY;
      if (row < rows) {
        const size_t o = static_cast<size_t>(m0 + row) * N + col;
        if constexpr (FUSED) {
          // (acc * sx) * sw, in this order: never fold sx * sw first
          out[o] = (static_cast<float>(static_cast<int32_t>(acc[r])) * sx) *
                   sw[col];
        } else {
          out[o] = static_cast<int32_t>(acc[r]);
        }
      }
    }
  }
}

template <typename TX, typename TW, bool FUSED, bool COMP>
int launch(const void* x, const void* w, const void* sx, const void* sw,
           void* out, int M, int K, int N, int bits, void* stream) {
  using TO = typename std::conditional<FUSED, float, int32_t>::type;
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  log_gemm_kernel<TX, TW, FUSED, COMP>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<const float*>(sx), static_cast<const float*>(sw),
          static_cast<TO*>(out), M, K, N, bits);
  return static_cast<int>(cudaGetLastError());
}

template <bool COMP>
int fused(const void* x, int x_bf16, const void* w, int w_bf16,
          const void* sx, const void* sw, void* out, int M, int K, int N,
          int bits, void* stream) {
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, true, COMP>(
        x, w, sx, sw, out, M, K, N, bits, stream);
  if (x_bf16)
    return launch<__nv_bfloat16, float, true, COMP>(x, w, sx, sw, out, M, K,
                                                    N, bits, stream);
  if (w_bf16)
    return launch<float, __nv_bfloat16, true, COMP>(x, w, sx, sw, out, M, K,
                                                    N, bits, stream);
  return launch<float, float, true, COMP>(x, w, sx, sw, out, M, K, N, bits,
                                          stream);
}

}  // namespace

extern "C" {

// int8 (M,K) x int8 (K,N) -> int32 (M,N)
int log_gemm_int8(const void* x, const void* w, void* out, int M, int K,
                  int N, int bits, int compensated, void* stream) {
  if (compensated)
    return launch<int8_t, int8_t, false, true>(x, w, nullptr, nullptr, out,
                                               M, K, N, bits, stream);
  return launch<int8_t, int8_t, false, false>(x, w, nullptr, nullptr, out, M,
                                              K, N, bits, stream);
}

// f32 or bf16 (M,K) x f32 or bf16 (K,N) -> f32 (M,N); sx: one f32 on the
// device, sw: N f32 on the device
int log_gemm_fused(const void* x, int x_bf16, const void* w, int w_bf16,
                   const void* sx, const void* sw, void* out, int M, int K,
                   int N, int bits, int compensated, void* stream) {
  if (compensated)
    return fused<true>(x, x_bf16, w, w_bf16, sx, sw, out, M, K, N, bits,
                       stream);
  return fused<false>(x, x_bf16, w, w_bf16, sx, sw, out, M, K, N, bits,
                      stream);
}

}  // extern "C"
