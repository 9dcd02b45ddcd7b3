// lut_gemm.cu - full-LUT gather GEMM for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/approx_matmul.py:
//   lut_matmul       (-> _int_kernel):   int8 x (M,K), int8 w (K,N) -> int32
//   lut_matmul_fused (-> _fused_kernel): f32/bf16 x, w -> f32, with the
//     per-tensor / per-column quantization on load and the
//     (acc * sx) * sw epilogue inside the kernel.
// Both forms are one template, lut_gemm_kernel<TX, TW, FUSED>, with
// quantize-on-load and the epilogue as compile-time switches.
//
// What it computes: out[m,n] = sum_k LUT[(a+2^{b-1}) * 2^b + (b+2^{b-1})]
// with a = x[m,k], b = w[k,n] (quantized in the fused form), LUT the
// signed product table of core/luts.signed_product_lut.
//
// What bounds it on an H100: every scalar product is one gather from
// the table in shared memory, so the floor is the shared-memory gather
// rate, at most 132 SMs x 32 words a clock (M*K*N gathers).  Bytes
// (x and w read once, the output written once, at 3.35 TB/s) bound a
// GEMM only when M is a handful of rows: a decode round (M=4) reads the
// whole weight for very few gathers per byte.
//
// Design: at 8 bits the table has 65,536 entries, 256 KiB as int32,
// more than the 227 KB of shared memory one block may use.  The host
// narrows it to int16 after checking that every entry fits
// (kernels/ops.py), and each block copies the 128 KiB table into
// dynamic shared memory once, then accumulates in 32-bit registers
// (unsigned, so a sum wraps as the reference's int32 sum does).  One
// block owns a BM x BN output tile and loops over K in BK steps, staging
// the row offsets (a+half)<<b and column indices (b+half) of each step
// in shared memory.  Ragged M/N/K edges are masked, not padded:
// out-of-range operands load as 0, and every table maps (0, b) and
// (a, 0) to 0 (asserted when the table is built), so they add nothing.
// Quantization is round(v / scale) with IEEE division (__fdiv_rn) and
// round-half-to-even (rintf), clipped to +-qmax; build without
// fast-math.  This is the simple correct form: no tensor cores, no
// asynchronous copies, one table copy per block.

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

// round(v / scale), half to even, clipped to [-qmax, qmax]
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

template <typename TX, typename TW, bool FUSED>
__global__ void __launch_bounds__(THREADS)
lut_gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                const int16_t* __restrict__ lut,
                const float* __restrict__ sx_ptr,
                const float* __restrict__ sw,
                typename std::conditional<FUSED, float, int32_t>::type*
                    __restrict__ out,
                int M, int K, int N, int bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_lut = 1 << (2 * bits);
  int16_t* s_lut = reinterpret_cast<int16_t*>(smem);
  int* s_a = reinterpret_cast<int*>(smem + static_cast<size_t>(n_lut) * 2);
  int16_t* s_b = reinterpret_cast<int16_t*>(s_a + BM * BK);

  const int tid = threadIdx.x;
  {  // the table: 16-byte copies (the wrapper checks the alignment)
    const int4* src = reinterpret_cast<const int4*>(lut);
    int4* dst = reinterpret_cast<int4*>(s_lut);
    const int n16 = n_lut / 8;
    for (int i = tid; i < n16; i += THREADS) dst[i] = src[i];
    for (int i = n16 * 8 + tid; i < n_lut; i += THREADS) s_lut[i] = lut[i];
  }

  const int tx = tid % BN, ty = tid / BN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int half = 1 << (bits - 1);
  const int qmax = half - 1;
  float sx = 0.f;
  if constexpr (FUSED) sx = *sx_ptr;
  const int col = n0 + tx;
  const int rows = min(BM, M - m0);   // rows of this tile inside M

  uint32_t acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's operands are consumed
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      int a = 0;
      if (gm < M && gk < K) {
        a = operand<FUSED>(x[static_cast<size_t>(gm) * K + gk], sx, qmax);
      }
      s_a[i] = (a + half) << bits;
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
      s_b[i] = static_cast<int16_t>(b + half);
    }
    __syncthreads();  // table (first step) and operands are visible
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const int ib = s_b[kk * BN + tx];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = ty + r * TY;  // uniform across a warp
        if (row < rows) {
          acc[r] += static_cast<uint32_t>(
              static_cast<int32_t>(s_lut[s_a[row * BK + kk] + ib]));
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

template <typename TX, typename TW, bool FUSED>
int launch(const void* x, const void* w, const void* lut, const void* sx,
           const void* sw, void* out, int M, int K, int N, int bits,
           void* stream) {
  using TO = typename std::conditional<FUSED, float, int32_t>::type;
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  auto kern = lut_gemm_kernel<TX, TW, FUSED>;
  const size_t smem = (static_cast<size_t>(1) << (2 * bits)) * 2 +
                      BM * BK * sizeof(int) + BK * BN * sizeof(int16_t);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const int16_t*>(lut), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<TO*>(out), M, K, N, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int8 (M,K) x int8 (K,N) -> int32 (M,N); lut: 2^(2*bits) int16 entries
int lut_gemm_int8(const void* x, const void* w, const void* lut, void* out,
                  int M, int K, int N, int bits, void* stream) {
  return launch<int8_t, int8_t, false>(x, w, lut, nullptr, nullptr, out, M,
                                       K, N, bits, stream);
}

// f32 or bf16 (M,K) x f32 or bf16 (K,N) -> f32 (M,N); sx: one f32 on the
// device, sw: N f32 on the device
int lut_gemm_fused(const void* x, int x_bf16, const void* w, int w_bf16,
                   const void* lut, const void* sx, const void* sw,
                   void* out, int M, int K, int N, int bits, void* stream) {
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, true>(x, w, lut, sx, sw, out,
                                                      M, K, N, bits, stream);
  if (x_bf16)
    return launch<__nv_bfloat16, float, true>(x, w, lut, sx, sw, out, M, K,
                                              N, bits, stream);
  if (w_bf16)
    return launch<float, __nv_bfloat16, true>(x, w, lut, sx, sw, out, M, K,
                                              N, bits, stream);
  return launch<float, float, true>(x, w, lut, sx, sw, out, M, K, N, bits,
                                    stream);
}

}  // extern "C"
