// cim_gemm.cuh - the integer cores and the tiled GEMM template of the
// port's remaining template kernels, for NVIDIA Hopper (sm_90a): the log
// forms of 9..16-bit operands (int, fused, partial, conv) and
// cim_gemm_core with SQ.  Included by lut_gemm.cu, nibble_gemm.cu,
// log_gemm.cu, conv_gemm.cu and surrogate_gemm.cu (the split-K kernels of
// cluster_gemm.cuh and surrogate_cluster.cuh take its quantize() and
// epilogues, conv_tile.cuh and attn_cluster.cuh its LUT layout and its
// NibbleCore's staging and product).
//
// What it computes: out[m,n] = sum_k prod(a[m,k], b[k,n]), summed in 32
// bits with two's-complement wrap (unsigned accumulation, as the
// reference's int32 sums), where prod is one of the cores:
//   LutCore     the layout of the full signed product table, int16 in
//               shared memory: LUT[(a+2^{b-1}) * 2^b + (b+2^{b-1})] (the
//               cluster, conv tile and attention kernels gather it; no
//               template kernel runs it)
//   NibbleCore  four 2^{b/2} x 2^{b/2} int32 sub-tables [S_hh, S_hl, S_lh,
//               S_ll] on saturated magnitudes (|a| clipped to qmax), the
//               sign restored from the operands:
//               sign(a) sign(b) (S_hh[ah,bh] + S_hl[ah,bl] + S_lh[al,bh]
//               + S_ll[al,bl]) (the attention cluster and conv tile
//               kernels stage through it; no template kernel runs it)
//   LogCore     the Mitchell / Log-our log-domain product (LoD, shifts
//               and the paper's OR-merged compensation), no table
//   IntSqCore   the exact integer product a * b, with a^2 and b^2 staged
//               as f32 for the surrogate's second sum SQ = sum_k a^2 b^2,
//               accumulated in f32 with fmaf in K order (never TF32 or a
//               16-bit type: a^2 b^2 reaches 127^4 > 2^24): the oracle
//               cim_gemm_core with SQ
// An epilogue (Epi) says what arrives and what leaves: int operands and
// an int32 result (IntOut; CoreOut also writes SQ), or float operands
// quantized on load, round(v / scale) with IEEE division (__fdiv_rn) and
// round-half-to-even (rintf), clipped to +-qmax (build without
// fast-math), against a per-tensor sx and per-column sw read from device
// memory, flushed as (acc * sx) * sw in that order (ScaleOut) or left as
// the raw int32 sum (QuantIntOut: a shard's partial sum over its slice of
// K, scaled by the caller after the sum over the shards).  The split-K
// cluster kernel of cluster_gemm.cuh flushes through the same two.
//
// The A operand comes from a source: Dense (a row-major (M, K) matrix)
// or ConvSrc (the implicit-GEMM patch matrix of a (B, H, W, C) image:
// row m = (b, oy, ox) batch-major, column k = (tap, channel) tap-major,
// the image read at (oy*stride + ki - kh/2, ox*stride + kj - kw/2) by
// index arithmetic, out-of-image taps read as 0; the log core's 9..16-bit
// convs, fused and partial, alone take it).  B is always a
// row-major (K, N) matrix; a conv's (kh*kw, C, N) tap stack is one.
//
// Design: one block owns a BM x BN output tile and loops over K in BK
// steps inside the block (the TPU's sequential grid axis and its VMEM
// accumulator become this loop and registers), so no cross-block sum is
// needed and the result is deterministic.  The grid is one-dimensional
// with the N tiles fastest, so the blocks resident together share A rows
// (a (64, 2048) x (2048, 6144) LUT GEMM ran 15% slower with the M tiles
// fastest).  Each step stages its operands
// in shared memory in the core's form (a table offset, split nibbles, or
// the log decomposition), worked out once per operand, so the inner loop
// does only the pairwise part.  The core's table is copied into dynamic
// shared memory once per block.  Ragged M/N/K edges are masked, not
// padded: out-of-range operands stage as 0, which every core annihilates
// (the tables map (0, b) and (a, 0) to 0, asserted when they are built;
// sign 0 zeroes the nibble and log products, and 0 the integer product
// and its square).  No tensor cores, no asynchronous copies: a table or
// log product has no tensor-core form.  The exact int8 dots run on the
// tensor cores instead: cim_gemm_core without SQ and the exact-mode conv
// in int8_mma.cuh, the fused surrogate GEMM (D and SQ) in
// surrogate_cluster.cuh; the fused LUT, nibble and log GEMMs and their
// partial forms (up to 8 bits) run the split-K cluster kernel of
// cluster_gemm.cuh, the LUT, nibble and log convs and their partial forms
// (up to 8 bits) the spatial-tile kernel of conv_tile.cuh, and the int
// LUT, magnitude-table, nibble and log GEMMs (up to 8 bits) the split-K
// cluster kernel too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace cim {

constexpr int BM = 16;             // output rows per block
constexpr int BN = 64;             // output columns per block
constexpr int BK = 32;             // K per shared-memory step
constexpr int TY = 4;              // thread rows
constexpr int THREADS = BN * TY;   // 256 threads: one column, BM/TY rows each
constexpr int RPT = BM / TY;

__host__ __device__ inline size_t al16(size_t n) { return (n + 15) / 16 * 16; }

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

// floor(log2(v)) capped at bits-1, 0 for v == 0 (the reference's
// leading_one loop over i in [1, bits))
__device__ __forceinline__ uint32_t lod(uint32_t v, int bits) {
  return v == 0u ? 0u
                 : min(31u - static_cast<uint32_t>(__clz(v)),
                       static_cast<uint32_t>(bits - 1));
}

// --- the cores -------------------------------------------------------------
// Each core names the staged forms of an A and a B operand, how an
// integer operand is staged, the product of two staged operands as a
// uint32 summand, and the bytes of its table.

// the table's bytes and the column index b + half of an operand (row a
// sits at (a + half) << bits)
struct LutCore {
  __host__ __device__ static size_t table_bytes(int bits) {
    return (static_cast<size_t>(1) << (2 * bits)) * 2;
  }
  __device__ static int16_t stage_b(int v, int bits) {
    return static_cast<int16_t>(v + (1 << (bits - 1)));
  }
};

// Staged nibble operands are sub-table offsets chosen so that the four
// gathers are a.x+b.x (S_hh), a.x+b.y (S_hl), a.y+b.x (S_lh) and a.y+b.y
// (S_ll): A = (ah*hb, 2*sz + al*hb, sign), B = (bh, sz + bl, sign), with
// hb = 2^{bits/2}, sz = hb*hb.  Magnitudes saturate at qmax (|-2^{b-1}|
// -> qmax, as the signed table's sign-magnitude wrapper).
struct NibbleCore {
  using A = int4;
  using B = int4;
  __host__ __device__ static size_t table_bytes(int bits) {
    return 4 * (static_cast<size_t>(1) << bits) * 4;
  }
  __device__ static int4 split(int v, int bits, int hi_mul, int lo_mul,
                               int lo_off) {
    const int h = bits >> 1, hb = 1 << h;
    const int mag = min(abs(v), (1 << (bits - 1)) - 1);
    return make_int4((mag >> h) * hi_mul, lo_off + (mag & (hb - 1)) * lo_mul,
                     (v > 0) - (v < 0), 0);
  }
  __device__ static A stage_a(int v, int bits) {
    const int hb = 1 << (bits >> 1);
    return split(v, bits, hb, hb, 2 * hb * hb);
  }
  __device__ static B stage_b(int v, int bits) {
    const int hb = 1 << (bits >> 1);
    return split(v, bits, 1, 1, hb * hb);
  }
  __device__ static uint32_t product(A a, B b, const unsigned char* tab,
                                     int) {
    const int32_t* t = reinterpret_cast<const int32_t*>(tab);
    const int mag = t[a.x + b.x] + t[a.x + b.y] + t[a.y + b.x] + t[a.y + b.y];
    return static_cast<uint32_t>(a.z * b.z * mag);
  }
};

// one log-domain operand: q = mag - 2^k, k, sign, mag (for a zero
// operand q = k = 0: the product is guarded to 0 anyway)
__device__ __forceinline__ int4 decompose(int v, int bits) {
  const int s = (v > 0) - (v < 0);
  const uint32_t mag = static_cast<uint32_t>(v < 0 ? -v : v);
  const uint32_t k = lod(mag, bits);
  const uint32_t q = mag == 0u ? 0u : mag - (1u << k);
  return make_int4(static_cast<int>(q), static_cast<int>(k), s,
                   static_cast<int>(mag));
}

// magnitude product of two decomposed operands, _log_product of the
// reference line for line (unsigned shifts: its int32 values here are
// all nonnegative and below 2^31)
template <bool COMP>
__device__ __forceinline__ uint32_t log_mag(int4 a, int4 b, int bits) {
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

template <bool COMP>
struct LogCore {
  using A = int4;
  using B = int4;
  __host__ __device__ static size_t table_bytes(int) { return 0; }
  __device__ static A stage_a(int v, int bits) { return decompose(v, bits); }
  __device__ static B stage_b(int v, int bits) { return decompose(v, bits); }
  __device__ static uint32_t product(A a, B b, const unsigned char*,
                                     int bits) {
    return static_cast<uint32_t>(a.z * b.z) * log_mag<COMP>(a, b, bits);
  }
};

// the exact product, one IMAD (|a b| <= 2^14 at 8 bits, so the 32-bit
// sum is exact for K < 2^17, wrapping beyond as the reference's int32),
// with each operand's square staged beside it as f32 (exact: v^2 <=
// 2^14), so the SQ sum costs one FFMA a product
struct IntSqCore {
  using A = int2;      // (v, the bits of f32(v * v))
  using B = int2;
  __host__ __device__ static size_t table_bytes(int) { return 0; }
  __device__ static int2 stage(int v) {
    return make_int2(v, __float_as_int(static_cast<float>(v * v)));
  }
  __device__ static A stage_a(int v, int) { return stage(v); }
  __device__ static B stage_b(int v, int) { return stage(v); }
  __device__ static uint32_t product(A a, B b, const unsigned char*, int) {
    return static_cast<uint32_t>(a.x * b.x);
  }
  __device__ static float square(int2 v) { return __int_as_float(v.y); }
};

// --- epilogues -----------------------------------------------------------
// QUANT: the operands arrive as floats and are quantized on load; SQ: the
// block also sums a^2 b^2 (the core must be IntSqCore); store() writes
// one output element o = m * N + col from its sums.

// int operands in, the int32 sum out (the int forms)
struct IntOut {
  static constexpr bool QUANT = false;
  static constexpr bool SQ = false;
  using Out = int32_t;
  __device__ void store(Out* out, size_t o, int, uint32_t acc, float, float,
                        const float*) const {
    out[o] = static_cast<int32_t>(acc);
  }
};

// quantize on load, flush (acc * sx) * sw (the fused forms)
struct ScaleOut {
  static constexpr bool QUANT = true;
  static constexpr bool SQ = false;
  using Out = float;
  __device__ void store(Out* out, size_t o, int col, uint32_t acc, float,
                        float sx, const float* sw) const {
    // (acc * sx) * sw, in this order: never fold sx * sw first
    out[o] = (static_cast<float>(static_cast<int32_t>(acc)) * sx) * sw[col];
  }
};

// quantize on load, write the raw int32 sum (the shard-local partial
// forms of the mesh path: the caller sums the partials over the shards,
// exactly, and applies the (acc * sx) * sw epilogue after)
struct QuantIntOut {
  static constexpr bool QUANT = true;
  static constexpr bool SQ = false;
  using Out = int32_t;
  __device__ void store(Out* out, size_t o, int, uint32_t acc, float, float,
                        const float*) const {
    out[o] = static_cast<int32_t>(acc);
  }
};

// int operands in, D as int32 and SQ as f32 out (cim_gemm_core with SQ;
// without it the core runs on the tensor cores, int8_mma.cuh)
struct CoreOut {
  static constexpr bool QUANT = false;
  static constexpr bool SQ = true;
  using Out = int32_t;
  float* sq_out;
  __device__ void store(Out* out, size_t o, int, uint32_t acc, float sq,
                        float, const float*) const {
    out[o] = static_cast<int32_t>(acc);
    sq_out[o] = sq;
  }
};

// dynamic shared memory of one block: the table, the A and the B tile
// (kernels/conv_gemm.py's gemm_smem_bytes computes the same total)
template <class Core>
__host__ __device__ inline size_t smem_bytes(int bits) {
  return al16(Core::table_bytes(bits)) +
         al16(sizeof(typename Core::A) * BM * BK) +
         sizeof(typename Core::B) * BK * BN;
}

// --- sources of the A operand ----------------------------------------------

template <typename T>
struct Dense {
  using Elem = T;
  const T* x;
  int K;
  __device__ T load(int m, int k) const {
    return x[static_cast<size_t>(m) * K + k];
  }
};

template <typename T>
struct ConvSrc {
  using Elem = T;
  const T* x;
  int H, W, C, OH, OW, kw, stride, ph, pw;
  __device__ T load(int m, int k) const {
    const int ohw = OH * OW;
    const int b = m / ohw, r = m - b * ohw;
    const int oy = r / OW, ox = r - oy * OW;
    const int t = k / C, c = k - t * C;
    const int ki = t / kw, kj = t - ki * kw;
    const int iy = oy * stride + ki - ph, ix = ox * stride + kj - pw;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return static_cast<T>(0);
    return x[((static_cast<size_t>(b) * H + iy) * W + ix) * C + c];
  }
};

// --- the kernel --------------------------------------------------------------

// The least resident blocks per SM asked of the compiler, the second
// argument of __launch_bounds__.  Asking for 1 lets nvcc keep more of the
// inner loop in registers: measured on an H100 (launch/kernel_ab.py), it
// restores the dense LUT and log GEMMs to the times of their own kernels
// before this template and speeds up the nibble GEMM and the log convs.
constexpr int GEMM_MIN_BLOCKS = 1;

template <class Core, class Src, typename TW, class Epi>
__global__ void __launch_bounds__(THREADS, GEMM_MIN_BLOCKS)
gemm_kernel(Src src, const TW* __restrict__ w,
            const unsigned char* __restrict__ tab,
            const float* __restrict__ sx_ptr, const float* __restrict__ sw,
            typename Epi::Out* __restrict__ out, Epi epi, int M, int K,
            int N, int bits) {
  using A = typename Core::A;
  using B = typename Core::B;
  constexpr bool FUSED = Epi::QUANT;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tbytes = Core::table_bytes(bits);
  unsigned char* s_tab = smem;
  A* s_a = reinterpret_cast<A*>(smem + al16(tbytes));
  B* s_b = reinterpret_cast<B*>(smem + al16(tbytes) +
                                al16(sizeof(A) * BM * BK));

  const int tid = threadIdx.x;
  {  // the table: 16-byte copies (the wrappers check the alignment, and
     // every table is a multiple of 16 bytes)
    const int4* src4 = reinterpret_cast<const int4*>(tab);
    int4* dst = reinterpret_cast<int4*>(s_tab);
    const int n16 = static_cast<int>(tbytes / 16);
    for (int i = tid; i < n16; i += THREADS) dst[i] = src4[i];
  }

  const int tx = tid % BN, ty = tid / BN;
  // a 1-D grid, N tiles fastest: neighbouring blocks share their A rows
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int qmax = (1 << (bits - 1)) - 1;
  float sx = 0.f;
  if constexpr (FUSED) sx = *sx_ptr;
  const int col = n0 + tx;
  const int rows = min(BM, M - m0);   // rows of this tile inside M

  uint32_t acc[RPT];
  float sq[RPT];  // sum_k a^2 b^2, live only when Epi::SQ
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    acc[r] = 0u;
    sq[r] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's operands are consumed
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      int a = 0;
      if (gm < M && gk < K) a = operand<FUSED>(src.load(gm, gk), sx, qmax);
      s_a[i] = Core::stage_a(a, bits);
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
      s_b[i] = Core::stage_b(b, bits);
    }
    __syncthreads();  // table (first step) and operands are visible
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const B bo = s_b[kk * BN + tx];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = ty + r * TY;  // uniform across a warp
        if (row < rows) {
          const A ao = s_a[row * BK + kk];
          acc[r] += Core::product(ao, bo, s_tab, bits);
          if constexpr (Epi::SQ) {
            sq[r] = fmaf(Core::square(ao), Core::square(bo), sq[r]);
          }
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
        epi.store(out, o, col, acc[r], sq[r], sx, sw);
      }
    }
  }
}

// Launches one (M, K) x (K, N) product on `stream`; returns the CUDA
// error code (0 on success).  `expect_smem` >= 0 is the caller's
// shared-memory total, and a launch whose total differs is refused.
template <class Core, class Epi, class Src, typename TW>
int launch(Src src, const TW* w, const void* tab, const void* sx,
           const void* sw, void* out, Epi epi, int M, int K, int N, int bits,
           void* stream, int expect_smem = -1) {
  using TO = typename Epi::Out;
  const size_t smem = smem_bytes<Core>(bits);
  if (expect_smem >= 0 && static_cast<size_t>(expect_smem) != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  auto kern = gemm_kernel<Core, Src, TW, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = static_cast<int64_t>((M + BM - 1) / BM) *
                         ((N + BN - 1) / BN);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      src, w, static_cast<const unsigned char*>(tab),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<TO*>(out), epi, M, K, N, bits);
  return static_cast<int>(cudaGetLastError());
}

// int8 (M,K) x int8 (K,N) -> int32 (M,N)
template <class Core>
int dense_int8(const void* x, const void* w, const void* tab, void* out,
               int M, int K, int N, int bits, void* stream) {
  return launch<Core>(Dense<int8_t>{static_cast<const int8_t*>(x), K},
                      static_cast<const int8_t*>(w), tab, nullptr, nullptr,
                      out, IntOut{}, M, K, N, bits, stream);
}

// f32 or bf16 (M,K) x f32 or bf16 (K,N), quantized on load -> f32 (M,N)
// through the epilogue `epi`
template <class Core, class Epi>
int dense_quant(const void* x, int x_bf16, const void* w, int w_bf16,
                const void* tab, const void* sx, const void* sw, void* out,
                Epi epi, int M, int K, int N, int bits, void* stream) {
  using bf = __nv_bfloat16;
  const Dense<bf> xb{static_cast<const bf*>(x), K};
  const Dense<float> xf{static_cast<const float*>(x), K};
  const bf* wb = static_cast<const bf*>(w);
  const float* wf = static_cast<const float*>(w);
  if (x_bf16 && w_bf16)
    return launch<Core>(xb, wb, tab, sx, sw, out, epi, M, K, N, bits,
                        stream);
  if (x_bf16)
    return launch<Core>(xb, wf, tab, sx, sw, out, epi, M, K, N, bits,
                        stream);
  if (w_bf16)
    return launch<Core>(xf, wb, tab, sx, sw, out, epi, M, K, N, bits,
                        stream);
  return launch<Core>(xf, wf, tab, sx, sw, out, epi, M, K, N, bits, stream);
}

// f32 (B,H,W,C) image x f32 (kh*kw, C, N) tap stack, quantized on load,
// -> (B,OH,OW,N) through the epilogue `epi` (f32 for ScaleOut, the raw
// int32 sum for QuantIntOut) under kh//2, kw//2 zero padding (SAME at
// stride 1); conv_gemm.cu instantiates it for the log core alone (9..16
// bits)
template <class Core, class Epi>
int conv_quant(const void* x, const void* w, const void* tab, const void* sx,
               const void* sw, void* out, Epi epi, int B, int H, int W, int C,
               int N, int kh, int kw, int stride, int bits, int smem,
               void* stream) {
  if (kh % 2 != 1 || kw % 2 != 1 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ph = kh / 2, pw = kw / 2;
  const int OH = (H + 2 * ph - kh) / stride + 1;
  const int OW = (W + 2 * pw - kw) / stride + 1;
  const ConvSrc<float> src{static_cast<const float*>(x), H, W, C, OH, OW,
                           kw, stride, ph, pw};
  return launch<Core>(src, static_cast<const float*>(w), tab, sx, sw, out,
                      epi, B * OH * OW, kh * kw * C, N, bits, stream, smem);
}

}  // namespace cim
