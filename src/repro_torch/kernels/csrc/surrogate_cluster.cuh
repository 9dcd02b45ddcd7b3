// surrogate_cluster.cuh - the fused surrogate CiM GEMM for NVIDIA Hopper
// (sm_90a): a split-K cluster kernel whose products run on the int8
// tensor cores.  Included by surrogate_gemm.cu (cim_gemm_fused and its
// epilogue-off partial cim_gemm_partial).
//
// Replaces the TPU kernel src/repro/kernels/cim_gemm.py:141
// cim_gemm_fused -> pallas_call :173 -> _fused_kernel :111.
//
// What it computes, bit for bit kernels/cim_gemm.py cim_gemm_fused_plain:
// f32 or bf16 x (M,K) and w (K,N) quantized on load, qa = round(x / sx),
// qb = round(w / sw[n]) by __fdiv_rn and rintf, clipped to +-qmax (2..8
// bits; build without fast-math); D = sum_k qa qb (int32, wrapping) and,
// where noise is drawn with c1 > 0, SQ = sum_k qa^2 qb^2 exactly, rounded
// once to f32 (ref.square_dot); then the surrogate's flush (sg_flush,
// every f32 operation rounded on its own):
//   out = (f32(1 + mu) * f32(D)) * s  [ + sqrt(max(var, 0)) * eps ],
//   s = sx * sw,  var = f32(c0 * K) * s^2 [ + (c1 * SQ) * s^2 ].
// Three variants, each its own instantiation: served (no eps: nothing of
// the noise term is read or summed), noise with c1 == 0 (eps read, no
// SQ) and noise with SQ.  The mesh path's row-parallel layers run the
// same body with its flush off, `surrogate_partial_kernel` (with or
// without SQ's four sums of squared halves): the exact int32 sums out, so
// that a rank's sums add up over the weight's K shards to one device's
// and the flush runs once after (ref.sq_from_halves, then
// ref.surrogate_epilogue).
//
// What bounds it on an H100: at a decode round (M = 4) the weight's bytes
// (read once at 3.35 TB/s) and its quantization (an IEEE division an
// element, once a call); at M = 64 the tensor cores' int8 operations (2 M
// K N for D, 4 x 2 M K N more with SQ, at 1,979 TOP/s) stay far below the
// bytes, and the x tile's quantization, repeated for every column tile,
// costs as much as the weight's.
//
// Design, on the split-K frame of cluster_gemm.cuh (its operand ring, tile
// copies, launch, capacity query and plan checks):
//  * Fill the card: a block owns RB = 16 or 64 rows (one or four MMA m16
//    groups; M = 4 runs one group with masked rows) x CL_BN = 64 columns
//    and one slice of K; the K slices of a tile form one thread-block
//    cluster of at most 8 blocks, planned in kernels/approx_matmul.py
//    cluster_plan (row tiles kernels/cim_gemm.py FUSED_ROWS, by the
//    device's cluster capacity, sg_capacity).  Past 64 rows the tiles
//    repeat over M.
//  * Keep copies in flight: the raw bf16 / f32 tiles arrive through
//    cluster_gemm.cuh's CL_STAGES-deep cp.async ring (cl_load_stage: 64 k
//    a stage for bf16 operands, 32 where either is f32; rows that are not
//    16-byte multiples by elements into the same layout).
//  * Quantize each weight element once a call (once a 64-row tile past M
//    = 64): each stage is quantized from shared memory into int8 planes.
//    x: four k of a row a thread into a row-major A plane, read by
//    ldmatrix (ldsm_x4); w: four k of one column a thread (a thread keeps
//    its column and its sw) into a K-major B plane (pack4), so a B
//    fragment is one 32-bit load and needs no ldmatrix.trans.  A B row is
//    BK + 4 bytes, an odd number of words, so the quantizing stores meet
//    no bank conflict.
//  * D on the tensor cores: mma.sync m16n8k32 s8.s8 -> s32 (int8_mma.cuh
//    mma_s8), no .satfinite, so D wraps as the reference's int32 sum.
//    8 warps, one n8 column tile each, all of the block's m16 groups.
//  * SQ, exact, on the same tensor cores: |q| <= 127, so q^2 <= 16129 =
//    128 * 126 + 1 splits into two non-negative halves that are each a
//    valid s8, h = q^2 >> 7 <= 126 and l = q^2 & 127, staged as two more
//    planes of A and of B.  Four more MMAs a fragment give the int32 sums
//    HH, HL, LH and LL, each at most 127^2 K, below 2^31 for K <
//    SG_SQ_MAX_K.  After the cluster sum SQ = 2^14 HH + 2^7 (HL + LH) +
//    LL is formed in 64 bits and rounded once (__ll2float_rn): exactly
//    ref.square_dot, so the noisy output is bitwise the plain version's
//    given the same eps.  (An unsigned byte split, q^2 = 256 hi + lo,
//    needs u8 MMAs and holds only K < 33,025; the 7-bit split keeps the
//    one s8 instruction and four times the K.)
//  * Cluster sum and flush: each block leaves its int32 partials (D and,
//    with SQ, the four sums) in its shared memory (over the ring and the
//    planes, which are spent); after a cluster barrier every block sums a
//    share of the tile's rows inside M over the cluster in rank order
//    through distributed shared memory (wrapping int32 addition is
//    associative: exact and deterministic, no memset, no atomics) and
//    flushes the surrogate epilogue; eps is read only there.
// Ragged M, N and K edges: the ring holds zeros outside the matrix, which
// quantize to 0 (and rows past M are not quantized at all); columns past N
// are quantized against a scale of 1 and never stored.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "cim_gemm.cuh"
#include "cluster_gemm.cuh"
#include "int8_mma.cuh"

namespace cim {

constexpr int SG_THREADS = 256;            // 8 warps, one n8 tile each
constexpr int SG_A_PAD = 16;               // an A row: BK + 16 bytes
constexpr int SG_B_PAD = 4;                // a B row: BK + 4 bytes
constexpr int SG_PROW = CL_BN + 4;         // a row of a partial tile, words
// SQ's four int32 sums are each at most 127^2 K: K < 2^31 / 127^2
constexpr int SG_SQ_MAX_K = 133144;

// the variants, as the C entry and the capacity query take them
constexpr int SG_SERVED = 0;               // no eps
constexpr int SG_NOISE = 1;                // eps, c1 == 0: no SQ
constexpr int SG_NOISE_SQ = 2;             // eps and SQ

// the int8 planes (q; with SQ also q^2's halves h and l) of A and B
__host__ __device__ inline size_t sg_planes_bytes(int rb, int bk, bool sq) {
  return (sq ? 3 : 1) * (static_cast<size_t>(rb) * (bk + SG_A_PAD) +
                         static_cast<size_t>(CL_BN) * (bk + SG_B_PAD));
}

// dynamic shared memory of one block: the ring and the planes, which the
// partial tiles (D; with SQ also HH, HL, LH, LL) reuse after the K loop
__host__ __device__ inline size_t sg_smem_bytes(int rb, bool sq,
                                                int x_bytes, int w_bytes) {
  const int bk = cl_bk(x_bytes, w_bytes);
  const size_t loop = CL_STAGES * cl_slot(rb, bk, x_bytes, w_bytes) +
                      sg_planes_bytes(rb, bk, sq);
  const size_t part = (sq ? 5 : 1) * static_cast<size_t>(rb) * SG_PROW * 4;
  return loop > part ? loop : part;
}

__host__ __device__ constexpr int sg_min_blocks(int rb, bool sq) {
  return rb == 64 && sq ? 1 : 2;
}

struct SgArgs {
  ClArgs c;             // operands, scales, out, shape, plan (tab unused)
  const float* eps;     // (M, N) f32, read by the noisy variants only
  float one_mu;         // f32(1 + mu)
  float c0k;            // f32(c0 * K)
  float c1;             // f32(c1)
};

// The surrogate's flush of one output element o = m * N + col from its D
// and SQ, in the reference's order of roundings (__fmul_rn, __fadd_rn:
// nvcc contracts nothing into an FMA): STOCH reads eps and adds the noise
// term, NEED_SQ (only with STOCH) its c1 * SQ part.
template <bool NEED_SQ, bool STOCH>
__device__ __forceinline__ void sg_flush(const SgArgs& s, size_t o, int col,
                                         uint32_t acc, float sq, float sx) {
  static_assert(STOCH || !NEED_SQ, "SQ feeds only the noise term");
  const float scale = __fmul_rn(sx, s.c.sw[col]);
  const float d = static_cast<float>(static_cast<int32_t>(acc));
  float v = __fmul_rn(__fmul_rn(s.one_mu, d), scale);
  if constexpr (STOCH) {
    const float s2 = __fmul_rn(scale, scale);
    float var = __fmul_rn(s.c0k, s2);
    if constexpr (NEED_SQ) {
      var = __fadd_rn(var, __fmul_rn(__fmul_rn(s.c1, sq), s2));
    }
    v = __fadd_rn(v, __fmul_rn(sqrtf(fmaxf(var, 0.f)), s.eps[o]));
  }
  static_cast<float*>(s.c.out)[o] = v;
}

// four consecutive raw elements (2: bf16, 4: f32 bytes each) at element i
// of a tile in shared memory, widened to f32 (exact); i a multiple of 4
__device__ __forceinline__ void raw4(const unsigned char* base, int i,
                                     int bytes, float (&v)[4]) {
  if (bytes == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(base + 2 * i);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(base + 4 * i);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// four quantized operands into their word of plane 0 at `dst` and, with
// SQ, the words of their squares' halves (q^2 = 128 h + l) `plane` and
// 2 `plane` bytes further
template <bool SQ>
__device__ __forceinline__ void sg_put(unsigned char* dst, int plane,
                                       const int (&q)[4]) {
  *reinterpret_cast<uint32_t*>(dst) = pack4(q[0], q[1], q[2], q[3]);
  if constexpr (SQ) {
    int h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sq = q[e] * q[e];
      h[e] = sq >> 7;
      l[e] = sq & 127;
    }
    *reinterpret_cast<uint32_t*>(dst + plane) = pack4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint32_t*>(dst + 2 * plane) =
        pack4(l[0], l[1], l[2], l[3]);
  }
}

// The body of both kernels below, on a grid (m tiles x n tiles, 1, K
// slices) in clusters of (1, 1, gridDim.z): the K slices of one tile are
// one cluster.  RAW turns the flush off: the cluster's exact int32 sums
// (D, and with NEED_SQ the four sums of squared halves HH, HL, LH, LL)
// are written as they stand, plane p of an int32 (NS, M, N) output, for
// the mesh path's row-parallel layers (kernels/cim_gemm.py
// cim_gemm_partial), whose ranks add them over the weight's K shards
// before the one flush.
template <int RB, int BK, bool NEED_SQ, bool STOCH, bool RAW>
__device__ __forceinline__ void sg_body(const SgArgs& s) {
  static_assert(STOCH || !NEED_SQ || RAW, "SQ feeds only the noise term");
  static_assert(!(RAW && STOCH), "a partial reads no eps");
  static_assert(RB % 16 == 0 && BK % 32 == 0, "m16 row groups, k32 steps");
  constexpr int NP = NEED_SQ ? 3 : 1;        // int8 planes: q (h, l)
  constexpr int NS = NEED_SQ ? 5 : 1;        // int32 sums: D (HH HL LH LL)
  constexpr int MG = RB / 16;                // m16 row groups
  constexpr int AROW = BK + SG_A_PAD, BROW = BK + SG_B_PAD;
  constexpr int APL = RB * AROW, BPL = CL_BN * BROW;   // plane bytes
  constexpr int WPR = BK / 4;                // words a row of x
  constexpr int KG = SG_THREADS / CL_BN;     // k word groups of the w tile
  const ClArgs& a = s.c;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const size_t slot = cl_slot(RB, BK, a.x_bytes, a.w_bytes);
  unsigned char* ring = smem;
  unsigned char* sA = smem + CL_STAGES * slot;
  unsigned char* sB = sA + NP * APL;

  const int mt = blockIdx.x / a.n_tiles;
  const int m0 = mt * RB, n0 = (blockIdx.x - mt * a.n_tiles) * CL_BN;
  const int kbeg = blockIdx.z * a.k_split;
  const int kend = min(a.K, kbeg + a.k_split);
  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const int qmax = (1 << (a.bits - 1)) - 1;
  const float sx = *a.sx;
  const int rows = min(RB, a.M - m0);        // rows of this tile inside M
  const int tn = tid % CL_BN;                // this thread's w column
  const float swc = n0 + tn < a.N ? a.sw[n0 + tn] : 1.f;

#pragma unroll
  for (int st = 0; st < CL_STAGES - 1; ++st) {
    if (st < nk)
      cl_load_stage<RB, BK, SG_THREADS>(ring + st * slot, a, m0, n0,
                                        kbeg + st * BK, kend, tid);
    cp_async_commit();
  }

  // [sum][m16 group][fragment]: D, then HH, HL, LH, LL
  int acc[NS][MG][4];
#pragma unroll
  for (int p = 0; p < NS; ++p)
#pragma unroll
    for (int i = 0; i < MG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][i][e] = 0;

  // this warp's B fragment (w columns warp * 8 + gq, k 4 tg..) and the
  // ldmatrix row addresses of A (rows 0-7 / 8-15 at k bytes 0-15 / 16-31)
  const unsigned char* bfrag = sB + (warp * 8 + gq) * BROW + tg * 4;
  const int a_off = (lane & 15) * AROW + (lane >> 4) * 16;

#pragma unroll 1
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<CL_STAGES - 2>();
    __syncthreads();  // stage t has landed; step t-1's planes are consumed
    {
      const int tl = t + CL_STAGES - 1;
      if (tl < nk)
        cl_load_stage<RB, BK, SG_THREADS>(ring + (tl % CL_STAGES) * slot, a,
                                          m0, n0, kbeg + tl * BK, kend, tid);
      cp_async_commit();
    }
    const unsigned char* cur = ring + (t % CL_STAGES) * slot;
    // x: four k of a row a thread into the A planes (rows past M stay
    // 0); a fixed trip count, so the words' loads and divisions overlap
#pragma unroll
    for (int u = 0; u < (RB * WPR + SG_THREADS - 1) / SG_THREADS; ++u) {
      const int i = tid + u * SG_THREADS;
      if (RB * WPR % SG_THREADS != 0 && i >= RB * WPR) break;
      const int r = i / WPR, j = (i - r * WPR) * 4;
      int q[4] = {0, 0, 0, 0};
      if (r < rows) {
        float v[4];
        raw4(cur, r * BK + j, a.x_bytes, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) q[e] = quantize(v[e], sx, qmax);
      }
      sg_put<NEED_SQ>(sA + r * AROW + j, APL, q);
    }
    // w: four k of this thread's column into the K-major B planes
    const unsigned char* raw_w = cur + RB * BK * a.x_bytes;
#pragma unroll
    for (int u = 0; u < BK / (KG * 4); ++u) {
      const int j = (tid / CL_BN + u * KG) * 4;
      int q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        q[e] = quantize(raw_at(raw_w, (j + e) * CL_BN + tn, a.w_bytes), swc,
                        qmax);
      sg_put<NEED_SQ>(sB + tn * BROW + j, BPL, q);
    }
    __syncthreads();  // the planes are visible

#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t b[NP][2];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        b[p][0] = *reinterpret_cast<const uint32_t*>(bfrag + p * BPL +
                                                     ks * 32);
        b[p][1] = *reinterpret_cast<const uint32_t*>(bfrag + p * BPL +
                                                     ks * 32 + 16);
      }
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        if (MG > 1 && i * 16 >= rows) continue;   // uniform across the block
        uint32_t af[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          ldsm_x4(af[p], sA + p * APL + i * 16 * AROW + a_off + ks * 32);
        mma_s8(acc[0][i], af[0], b[0][0], b[0][1]);
        if constexpr (NEED_SQ) {
          mma_s8(acc[1][i], af[1], b[1][0], b[1][1]);   // h h
          mma_s8(acc[2][i], af[1], b[2][0], b[2][1]);   // h l
          mma_s8(acc[3][i], af[2], b[1][0], b[1][1]);   // l h
          mma_s8(acc[4][i], af[2], b[2][0], b[2][1]);   // l l
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring and the planes

  // this block's partial tiles into its shared memory: fragment (row g,
  // columns 2 tg, 2 tg + 1) and row g + 8
  int* part = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int p = 0; p < NS; ++p)
#pragma unroll
    for (int i = 0; i < MG; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(
            part + (p * RB + i * 16 + gq + 8 * h) * SG_PROW + warp * 8 +
            2 * tg) = make_int2(acc[p][i][2 * h], acc[p][i][2 * h + 1]);

  // the cluster's partials summed in rank order, four columns at a time,
  // each block a share of the tile's rows inside M, then the flush
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(gridDim.z);
  const int rank = static_cast<int>(cluster.block_rank());
  const int quads = rows * (CL_BN / 4);
  const int per = (quads + splits - 1) / splits;
  const int e1 = min(quads, (rank + 1) * per);
  const int* peer[CL_MAX_SPLITS];
#pragma unroll
  for (int q = 0; q < CL_MAX_SPLITS; ++q)
    peer[q] = cluster.map_shared_rank(part, q < splits ? q : 0);
  for (int e = rank * per + tid; e < e1; e += SG_THREADS) {
    const int lrow = e / (CL_BN / 4), c4 = (e - lrow * (CL_BN / 4)) * 4;
    uint32_t sum[NS][4];
#pragma unroll
    for (int p = 0; p < NS; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[p][c] = 0u;
#pragma unroll
    for (int q = 0; q < CL_MAX_SPLITS; ++q) {
      if (q < splits) {
#pragma unroll
        for (int p = 0; p < NS; ++p) {
          const int4 v = *reinterpret_cast<const int4*>(
              peer[q] + (p * RB + lrow) * SG_PROW + c4);
          sum[p][0] += static_cast<uint32_t>(v.x);
          sum[p][1] += static_cast<uint32_t>(v.y);
          sum[p][2] += static_cast<uint32_t>(v.z);
          sum[p][3] += static_cast<uint32_t>(v.w);
        }
      }
    }
    const size_t o = static_cast<size_t>(m0 + lrow) * a.N + n0 + c4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (n0 + c4 + c >= a.N) continue;
      if constexpr (RAW) {
        int* raw = static_cast<int*>(a.out);
        const size_t plane = static_cast<size_t>(a.M) * a.N;
#pragma unroll
        for (int p = 0; p < NS; ++p)
          raw[p * plane + o + c] = static_cast<int>(sum[p][c]);
      } else {
        float sq = 0.f;
        if constexpr (NEED_SQ) {
          // exact in 64 bits (each sum below 2^31), rounded once
          const long long v = (static_cast<long long>(sum[1][c]) << 14) +
                              ((static_cast<long long>(sum[2][c]) +
                                static_cast<long long>(sum[3][c])) << 7) +
                              static_cast<long long>(sum[4][c]);
          sq = __ll2float_rn(v);
        }
        sg_flush<NEED_SQ, STOCH>(s, o + c, n0 + c4 + c, sum[0][c], sq, sx);
      }
    }
  }
  cluster.sync();  // no block leaves while a peer reads its partials
}

// the fused surrogate GEMM (cim_gemm_fused): quantize, sum, flush
template <int RB, int BK, bool NEED_SQ, bool STOCH>
__global__ void __launch_bounds__(SG_THREADS, (sg_min_blocks(RB, NEED_SQ)))
surrogate_cluster_kernel(const SgArgs s) {
  sg_body<RB, BK, NEED_SQ, STOCH, false>(s);
}

// its epilogue-off partial (cim_gemm_partial): quantize against the
// caller's global scales, sum, write the int32 sums
template <int RB, int BK, bool NEED_SQ>
__global__ void __launch_bounds__(SG_THREADS, (sg_min_blocks(RB, NEED_SQ)))
surrogate_partial_kernel(const SgArgs s) {
  sg_body<RB, BK, NEED_SQ, false, true>(s);
}

using SgKernel = void (*)(SgArgs);

// the instantiation for `rb` rows, stages of `bk` k and the variant
template <bool NEED_SQ, bool STOCH>
inline SgKernel sg_kernel(int rb, int bk) {
  if (rb == 16)
    return bk == 64 ? surrogate_cluster_kernel<16, 64, NEED_SQ, STOCH>
                    : surrogate_cluster_kernel<16, 32, NEED_SQ, STOCH>;
  return bk == 64 ? surrogate_cluster_kernel<64, 64, NEED_SQ, STOCH>
                  : surrogate_cluster_kernel<64, 32, NEED_SQ, STOCH>;
}

// the partial's instantiation for `rb` rows, stages of `bk` k, with or
// without the four sums of squared halves
template <bool NEED_SQ>
inline SgKernel sg_partial_kernel(int rb, int bk) {
  if (rb == 16)
    return bk == 64 ? surrogate_partial_kernel<16, 64, NEED_SQ>
                    : surrogate_partial_kernel<16, 32, NEED_SQ>;
  return bk == 64 ? surrogate_partial_kernel<64, 64, NEED_SQ>
                  : surrogate_partial_kernel<64, 32, NEED_SQ>;
}

template <bool NEED_SQ, bool STOCH>
inline int sg_launch(const SgArgs& s, int rb, int tiles, int splits,
                     cudaStream_t stream) {
  const int xb = s.c.x_bytes, wb = s.c.w_bytes;
  return cl_launch_ex(sg_kernel<NEED_SQ, STOCH>(rb, cl_bk(xb, wb)), s,
                      sg_smem_bytes(rb, NEED_SQ, xb, wb), SG_THREADS, tiles,
                      splits, stream);
}

template <bool NEED_SQ>
inline int sg_partial_launch(const SgArgs& s, int rb, int tiles, int splits,
                             cudaStream_t stream) {
  const int xb = s.c.x_bytes, wb = s.c.w_bytes;
  return cl_launch_ex(sg_partial_kernel<NEED_SQ>(rb, cl_bk(xb, wb)), s,
                      sg_smem_bytes(rb, NEED_SQ, xb, wb), SG_THREADS, tiles,
                      splits, stream);
}

inline bool sg_plan_ok(int variant, int rb) {
  return (variant == SG_SERVED || variant == SG_NOISE ||
          variant == SG_NOISE_SQ) &&
         (rb == 16 || rb == 64);
}

// The clusters of `splits` blocks of the instantiation for `rb` rows, the
// variant and these operand types that the current device holds at once,
// into *out; returns the CUDA error code (the plan's waves)
inline int sg_capacity(int rb, int variant, int x_bf16, int w_bf16,
                       int splits, int* out) {
  if (!sg_plan_ok(variant, rb) || splits < 1 || splits > CL_MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int xb = x_bf16 ? 2 : 4, wb = w_bf16 ? 2 : 4;
  const int bk = cl_bk(xb, wb);
  const bool sq = variant == SG_NOISE_SQ;
  const SgKernel kern = variant == SG_SERVED ? sg_kernel<false, false>(rb, bk)
                        : sq                 ? sg_kernel<true, true>(rb, bk)
                                             : sg_kernel<false, true>(rb, bk);
  return cl_capacity_ex(reinterpret_cast<const void*>(kern),
                        sg_smem_bytes(rb, sq, xb, wb), SG_THREADS, splits,
                        out);
}

// f32 or bf16 x (M,K), w (K,N) -> f32 (M,N) through the surrogate; eps
// null for SG_SERVED, else (M,N) f32; the launch that
// kernels/approx_matmul.py cluster_plan chose: `rb` rows a block (16 or
// 64), K in `splits` slices (1..8) of `k_split` (a multiple of
// CL_SPLIT_K; the slices cover K, none empty).  Returns the CUDA error
// code; a plan or a variant the kernel does not take, and SQ at K >=
// SG_SQ_MAX_K, are refused (cudaErrorInvalidValue).
inline int surrogate_cluster(const void* x, int x_bf16, const void* w,
                             int w_bf16, const void* sx, const void* sw,
                             const void* eps, void* out, int M, int K, int N,
                             int bits, float one_mu, float c0k, float c1,
                             int variant, int rb, int splits, int k_split,
                             void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (M < 0 || K < 0 || N < 0 || bits < 2 || bits > CL_MAX_BITS) return bad;
  if (!sg_plan_ok(variant, rb) || !cl_split_ok(K, splits, k_split))
    return bad;
  if ((eps == nullptr) != (variant == SG_SERVED)) return bad;
  if (variant == SG_NOISE_SQ && K >= SG_SQ_MAX_K) return bad;
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  SgArgs s;
  int tiles = 0;
  if (!cl_make_args(s.c, x, x_bf16 ? 2 : 4, w, w_bf16 ? 2 : 4, nullptr, sx,
                    sw, out, M, K, N, bits, rb, k_split, &tiles))
    return bad;
  s.eps = static_cast<const float*>(eps);
  s.one_mu = one_mu;
  s.c0k = c0k;
  s.c1 = c1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == SG_SERVED)
    return sg_launch<false, false>(s, rb, tiles, splits, st);
  if (variant == SG_NOISE)
    return sg_launch<false, true>(s, rb, tiles, splits, st);
  return sg_launch<true, true>(s, rb, tiles, splits, st);
}

// The clusters of `splits` blocks of the partial's instantiation for `rb`
// rows, with or without SQ's sums, and these operand types that the
// current device holds at once, into *out
inline int sg_partial_capacity(int rb, int need_sq, int x_bf16, int w_bf16,
                               int splits, int* out) {
  if ((rb != 16 && rb != 64) || splits < 1 || splits > CL_MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int xb = x_bf16 ? 2 : 4, wb = w_bf16 ? 2 : 4;
  const int bk = cl_bk(xb, wb);
  const SgKernel kern = need_sq ? sg_partial_kernel<true>(rb, bk)
                                : sg_partial_kernel<false>(rb, bk);
  return cl_capacity_ex(reinterpret_cast<const void*>(kern),
                        sg_smem_bytes(rb, need_sq != 0, xb, wb), SG_THREADS,
                        splits, out);
}

// f32 or bf16 x (M,K), w (K,N) quantized against the caller's global sx
// (one f32) and sw (N f32) -> int32 (1, M, N) D, or with `need_sq` (5, M,
// N): D, then the sums of SQ's squared halves HH, HL, LH and LL, each
// exact (K < SG_SQ_MAX_K); the plan as surrogate_cluster's.  Returns the
// CUDA error code; a plan the kernel does not take, and SQ at K >=
// SG_SQ_MAX_K, are refused (cudaErrorInvalidValue).
inline int surrogate_partial(const void* x, int x_bf16, const void* w,
                             int w_bf16, const void* sx, const void* sw,
                             void* out, int M, int K, int N, int bits,
                             int need_sq, int rb, int splits, int k_split,
                             void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (M < 0 || K < 0 || N < 0 || bits < 2 || bits > CL_MAX_BITS) return bad;
  if ((rb != 16 && rb != 64) || !cl_split_ok(K, splits, k_split)) return bad;
  if (need_sq && K >= SG_SQ_MAX_K) return bad;
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  SgArgs s;
  int tiles = 0;
  if (!cl_make_args(s.c, x, x_bf16 ? 2 : 4, w, w_bf16 ? 2 : 4, nullptr, sx,
                    sw, out, M, K, N, bits, rb, k_split, &tiles))
    return bad;
  s.eps = nullptr;
  s.one_mu = s.c0k = s.c1 = 0.f;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return need_sq ? sg_partial_launch<true>(s, rb, tiles, splits, st)
                 : sg_partial_launch<false>(s, rb, tiles, splits, st);
}

}  // namespace cim
