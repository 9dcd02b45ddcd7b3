// int8_mma.cuh - the int8 tensor-core GEMM core of the port for NVIDIA
// Hopper (sm_90a), behind cim_gemm_core (need_sq=False, in
// surrogate_gemm.cu; the TPU's src/repro/kernels/cim_gemm.py:60 ->
// _kernel :33) and conv_mxu_fused (in conv_gemm.cu; conv_gemm.py:174 ->
// _mxu_kernel :148).
//
// What it computes: D[m,n] = sum_k a[m,k] b[k,n] over int8 operands,
// summed in 32 bits with two's-complement wrap, as the reference's int32
// sums.  It has one body (a 16 x 8 x 32 fragment walk) and two A sources:
//   dense   int8 (M, K) x int8 (K, N) -> int32 D (and SQ written as
//           zeros): cim_gemm_core without SQ;
//   conv    the implicit patch matrix of an f32 (B, H, W, C) image and an
//           f32 (kh*kw, C, N) tap stack, each quantized once into int8
//           shared memory, -> f32 (acc * sx) * sw: conv_mxu_fused.
//
// The instruction: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (SASS
// IMMA.16832), not wgmma (IGMMA).  Both kernels are bound by bytes, not
// by products: at the M = 64 surrogate shapes the tensor-core bound is
// 0.14-0.81 us a GEMM against 0.8-4.7 us of reading the weight, and the
// Table IV convs do about 1 GOP in all against 22 MB.  wgmma would buy no
// rate and would need 64-row tiles (a decode GEMM has 4 rows).  Without
// .satfinite the s32 accumulators wrap, as the reference's int32 sums do.
// Measured on an H100 (chip_smoke.py times each call with the L2 flushed
// and warm), neither kernel reaches that bound yet and a warm L2 barely
// helps: the time goes to a block's serial K steps and to the launch,
// not to the bytes.
//
// B must reach the tensor cores K-major (a .col B register is four
// consecutive k of one column), but w arrives as a row-major (K, N)
// matrix.  The transposition happens on chip, never as a pass over the
// weight in device memory (at M <= 64 reading the weight is the whole
// cost):
//   dense   the (K, N) tile is copied as it lies; ldmatrix.trans reads it
//           as 16-bit pairs of columns (two k of two adjacent columns a
//           register) and two byte permutes (prmt) a register pair make
//           four k of one column.  The even columns of a 16-column block
//           form one n8 MMA tile and the odd ones another, so a thread's
//           four accumulators of a row are four adjacent columns.
//   conv    the tap stack is quantized on load and stored transposed,
//           (N, K) K-major, one 32-bit word four channels of one tap.
//
// dense (int8_mma_dense_kernel): a block owns a 64 x 64 tile of D and one
// slice of K; 4 warps, each 32 x 32.  The operands stay int8 in shared
// memory, in a ring of 4 stages of 64 K bytes filled by cp.async (16 bytes
// a thread, zero-filled past the edges), so the copies of the next three
// steps are in flight while a step's MMAs run.  A tile of 64 x 64 at
// M <= 64 gives 16-96 blocks, too few to keep enough bytes in flight to
// stream the weight, so K is split across blocks (dense_int8_mma picks
// the count from the shape and the card's SM count: about two blocks per
// SM, at most 8, none less than one 64-byte step).
// The K slices of one tile form one thread-block cluster: each block
// leaves its int32 partial tile in its shared memory, and after a cluster
// barrier each sums a share of the tile's rows over the cluster's
// partials (distributed shared memory), in rank order, and stores D.
// Two's-complement int32 addition is associative and commutative, so D
// is bitwise the reference's in any order (an f32 split-K would not be);
// this order is also fixed, D needs no clearing, and no atomics go to
// device memory (measured on an H100 with atomicAdd into a cleared D,
// the memset and the atomics of 8 slices cost more at M = 64 than the
// weight read).  SQ is written as zeros.  Operands whose rows are not
// 16-byte multiples (K or N % 16 != 0) are staged by byte loads instead,
// into the same layout.  Rows of B in shared memory are permuted (k's
// bits 1 and 3 swapped) and every row is padded by 16 bytes, so no
// ldmatrix phase meets a bank conflict.
//
// conv (int8_mma_conv_kernel): a block owns a spatial tile of output
// pixels (IB images x TR rows x TC columns, at most 64) and all N,
// looping over 64-channel N tiles beyond that.  It quantizes its tile's
// input halo once, with the template's quantize() (IEEE division,
// round-half-to-even, clip; no fast-math), into int8 shared memory as
// (pixel, channel) with each chunk's channels padded to a multiple of 4
// (C = 3 -> 4: zeros annihilate), and forms the A fragments from the halo
// by index arithmetic (a table of each k word's offset inside the halo).
// The tap stack is the same for every block, and quantizing all of it in
// every block made the weights, not the pixels, the cost of the small
// late convs: so where the weight tile is more than 16 words a thread,
// blocks run in clusters of 8, each quantizes an eighth of it into the
// K-major (N, K) layout and writes it into the shared memory of all 8
// (distributed shared memory); smaller tiles are quantized by every
// block, in clusters of 1 (measured on an H100: a cluster's barriers cost
// more there than they save).  Each thread loads two words' floats
// before it quantizes either (a load whose word lies outside reads a
// valid address and is discarded), so the loads of a staging pass
// overlap.  D is an exact integer sum, so the K order and
// the padding are free.  The epilogue is (acc * sx) * sw[col] in that
// order, so the output equals conv_mxu_fused_plain bit for bit.  Channels
// are taken in chunks and taps in groups so that the block's shared
// memory is one fixed total for every geometry (CONV_SMEM,
// kernels/conv_gemm.py gemm_smem_bytes("mxu")), which the launch checks
// against the caller's.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "cim_gemm.cuh"

namespace cim {

namespace cgrp = cooperative_groups;

// --- PTX ---------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b over one 16 x 8 x 32 int8 fragment, s32 accumulators that
// wrap (no .satfinite)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four quantized operands -> one word, the first in the low byte
__device__ __forceinline__ uint32_t pack4(int q0, int q1, int q2, int q3) {
  return (static_cast<uint32_t>(q0) & 0xffu) |
         ((static_cast<uint32_t>(q1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(q2) & 0xffu) << 16) |
         (static_cast<uint32_t>(q3) << 24);
}

// --- dense: int8 (M, K) x int8 (K, N) -> int32 -------------------------------

constexpr int DM = 64;                 // rows of D a block
constexpr int DN = 64;                 // columns of D a block
constexpr int DK = 64;                 // K bytes a stage
constexpr int DSTAGES = 4;
constexpr int DTHREADS = 128;          // 4 warps, 2 x 2, each 32 x DN/2
constexpr int WJ = DN / 32;            // 16-column blocks a warp
constexpr int DA_ROW = DK + 16;        // padded rows: 5 16-byte units, so
constexpr int DB_ROW = DN + 16;        // 8 consecutive rows hit 8 bank quartets

// the shared-memory row of B's k inside a stage: bits 1 and 3 swapped, so
// the 8 rows one ldmatrix.trans phase reads ({0,1,4,5,8,9,12,13} or
// {2,3,6,7,10,11,14,15}) fall on 8 different rows mod 8
__device__ __forceinline__ int b_row(int k) {
  return (k & ~0xa) | ((k & 2) << 2) | ((k & 8) >> 2);
}

// one stage: A rows m0.., B rows k0.. of the slice ending at kend
template <bool ALIGNED>
__device__ __forceinline__ void dense_stage(unsigned char* sa,
                                            unsigned char* sb,
                                            const int8_t* x, const int8_t* w,
                                            int M, int K, int N, int m0,
                                            int n0, int k0, int kend,
                                            int tid) {
#pragma unroll
  for (int i = tid; i < DM * (DK / 16); i += DTHREADS) {
    const int r = i / (DK / 16), c = (i % (DK / 16)) * 16;
    const int gm = m0 + r, gk = k0 + c;
    unsigned char* dst = sa + r * DA_ROW + c;
    if constexpr (ALIGNED) {
      const bool ok = gm < M && gk < kend;
      cp_async16(dst, ok ? x + static_cast<size_t>(gm) * K + gk : x, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (gm < M && gk + j < kend)
          v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                           x[static_cast<size_t>(gm) * K + gk + j]))
                       << (8 * (j & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int i = tid; i < DK * (DN / 16); i += DTHREADS) {
    const int r = i / (DN / 16), c = (i % (DN / 16)) * 16;
    const int gk = k0 + r, gn = n0 + c;
    unsigned char* dst = sb + b_row(r) * DB_ROW + c;
    if constexpr (ALIGNED) {
      const bool ok = gk < kend && gn < N;
      cp_async16(dst, ok ? w + static_cast<size_t>(gk) * N + gn : w, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (gk < kend && gn + j < N)
          v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                           w[static_cast<size_t>(gk) * N + gn + j]))
                       << (8 * (j & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

constexpr int DRING = DSTAGES * (DM * DA_ROW + DK * DB_ROW);
constexpr int DP_ROW = DN + 4;         // a row of the int32 partial tile
constexpr int DMAX_SPLITS = 8;         // the portable cluster size
static_assert(DM * DP_ROW * 4 <= DRING, "the partial tile reuses the ring");

// grid (N tiles, M tiles, K slices of k_split bytes), launched as
// clusters of (1, 1, gridDim.z): the K slices of one tile are one
// cluster, and their partials are summed through distributed shared
// memory, each block summing its share of the tile's rows in rank order
template <bool ALIGNED>
__global__ void __launch_bounds__(DTHREADS)
int8_mma_dense_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w, int32_t* __restrict__ d,
                      float* __restrict__ sq, int M, int K, int N,
                      int k_split) {
  __shared__ __align__(128) unsigned char ring[DRING];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * DN, m0 = blockIdx.y * DM;
  const int kbeg = blockIdx.z * k_split;
  const int kend = min(K, kbeg + k_split);
  const int nk = (kend - kbeg + DK - 1) / DK;
  const int mrow = m0 + wm * 32;       // this warp's first row
  auto sa = [&](int s) { return ring + s * (DM * DA_ROW + DK * DB_ROW); };
  auto sb = [&](int s) { return sa(s) + DM * DA_ROW; };

  // [m16 tile][n16 block][even / odd columns][fragment]
  int acc[2][WJ][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WJ; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][p][e] = 0;

#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < nk)
      dense_stage<ALIGNED>(sa(s), sb(s), x, w, M, K, N, m0, n0,
                           kbeg + s * DK, kend, tid);
    cp_async_commit();
  }
  // ldmatrix row addresses: B's 4 matrices are k {0,1,4,5,8,9,12,13},
  // that + 2, + 16, + 18 (slot r of matrix q); A's are rows 0-7 / 8-15 at
  // k bytes 0-15 / 16-31
  const int q = lane >> 3, r = lane & 7;
  const int b_k = (q >> 1) * 16 + (r >> 1) * 4 + (q & 1) * 2 + (r & 1);
  const int a_off = (wm * 32 + (lane & 15)) * DA_ROW + (lane >> 4) * 16;

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<DSTAGES - 2>();
    __syncthreads();  // step t has landed; step t-1's slot is free
    {
      const int tn = t + DSTAGES - 1;
      if (tn < nk)
        dense_stage<ALIGNED>(sa(tn % DSTAGES), sb(tn % DSTAGES), x, w, M, K,
                             N, m0, n0, kbeg + tn * DK, kend, tid);
      cp_async_commit();
    }
    const unsigned char* as = sa(t % DSTAGES);
    const unsigned char* bs = sb(t % DSTAGES);
#pragma unroll
    for (int ks = 0; ks < DK / 32; ++ks) {
      uint32_t b[WJ][2][2];  // [n16 block][even / odd][b0, b1]
#pragma unroll
      for (int j = 0; j < WJ; ++j) {
        uint32_t v[4];
        ldsm_x4_trans(v, bs + b_row(ks * 32 + b_k) * DB_ROW +
                             wn * (DN / 2) + j * 16);
        // v[0]: (k 4t, 4t+1) x (columns 2g, 2g+1), v[1] the same at k + 2
        b[j][0][0] = __byte_perm(v[0], v[1], 0x6420);
        b[j][1][0] = __byte_perm(v[0], v[1], 0x7531);
        b[j][0][1] = __byte_perm(v[2], v[3], 0x6420);
        b[j][1][1] = __byte_perm(v[2], v[3], 0x7531);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (mrow + i * 16 >= M) continue;  // uniform across the warp
        uint32_t a[4];
        ldsm_x4(a, as + a_off + i * 16 * DA_ROW + ks * 32);
#pragma unroll
        for (int j = 0; j < WJ; ++j)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            mma_s8(acc[i][j][p], a, b[j][p][0], b[j][p][1]);
      }
    }
  }
  cp_async_wait<0>();

  // the even tile holds columns 4tg and 4tg + 2, the odd one 4tg + 1 and
  // 4tg + 3: a thread's four values of a row are four adjacent columns
  const int g = lane >> 2, tg = lane & 3;
  const int splits = gridDim.z;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mrow + i * 16 + g + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < WJ; ++j) {
          const int n = n0 + wn * (DN / 2) + j * 16 + 4 * tg;
          const int v[4] = {acc[i][j][0][2 * h], acc[i][j][1][2 * h],
                            acc[i][j][0][2 * h + 1],
                            acc[i][j][1][2 * h + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (n + e >= N) continue;
            const size_t o = static_cast<size_t>(row) * N + n + e;
            d[o] = v[e];
            sq[o] = 0.f;
          }
        }
      }
    return;
  }

  // several K slices: this block's partial tile into its shared memory
  // (the ring is consumed), then each block of the cluster sums its share
  // of the tile over the cluster's partials in rank order: int32 wraps,
  // so the sum is the reference's in any order, and this one is fixed
  __syncthreads();
  int* part = reinterpret_cast<int*>(ring);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lrow = wm * 32 + i * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < WJ; ++j)
        *reinterpret_cast<int4*>(part + lrow * DP_ROW + wn * (DN / 2) +
                                 j * 16 + 4 * tg) =
            make_int4(acc[i][j][0][2 * h], acc[i][j][1][2 * h],
                      acc[i][j][0][2 * h + 1], acc[i][j][1][2 * h + 1]);
    }
  cgrp::cluster_group cluster = cgrp::this_cluster();
  cluster.sync();
  // the tile's rows inside M, four columns at a time, dealt out to the
  // cluster's blocks in equal runs; each sum's remote loads issued together
  const int rank = static_cast<int>(cluster.block_rank());
  const int quads = min(DM, M - m0) * (DN / 4);
  const int per = (quads + splits - 1) / splits;
  const int e1 = min(quads, (rank + 1) * per);
  const int* peer[DMAX_SPLITS];
#pragma unroll
  for (int qq = 0; qq < DMAX_SPLITS; ++qq)
    peer[qq] = cluster.map_shared_rank(part, qq < splits ? qq : 0);
  for (int e = rank * per + tid; e < e1; e += DTHREADS) {
    const int lrow = e / (DN / 4), col = (e % (DN / 4)) * 4;
    uint32_t sum[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int qq = 0; qq < DMAX_SPLITS; ++qq) {
      if (qq < splits) {
        const int4 v =
            *reinterpret_cast<const int4*>(peer[qq] + lrow * DP_ROW + col);
        sum[0] += static_cast<uint32_t>(v.x);
        sum[1] += static_cast<uint32_t>(v.y);
        sum[2] += static_cast<uint32_t>(v.z);
        sum[3] += static_cast<uint32_t>(v.w);
      }
    }
    const size_t o = static_cast<size_t>(m0 + lrow) * N + n0 + col;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (n0 + col + c < N) {
        d[o + c] = static_cast<int32_t>(sum[c]);
        sq[o + c] = 0.f;
      }
    }
  }
  cluster.sync();  // no block leaves while a peer reads its partials
}

// int8 (M,K) x int8 (K,N) -> D int32 (M,N), SQ f32 zeros, with K split
// into slices enough that the grid holds about two blocks per SM of the
// current device, at most DMAX_SPLITS, none less than one 64-byte step
// and none empty; each tile's slices are one thread-block cluster
inline int dense_int8_mma(const void* x, const void* w, void* d, void* sq,
                          int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0) {  // the empty sum
    const size_t bytes = static_cast<size_t>(M) * N * 4;
    cudaError_t e = cudaMemsetAsync(d, 0, bytes, st);
    if (e == cudaSuccess) e = cudaMemsetAsync(sq, 0, bytes, st);
    return static_cast<int>(e);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t tiles = static_cast<int64_t>((M + DM - 1) / DM) *
                        ((N + DN - 1) / DN);
  const int steps = (K + DK - 1) / DK;
  const int64_t fill = (2 * static_cast<int64_t>(sms) + tiles - 1) / tiles;
  int want = min(steps, DMAX_SPLITS);
  if (fill < want) want = fill < 1 ? 1 : static_cast<int>(fill);
  const int per = (steps + want - 1) / want;
  const int splits = (steps + per - 1) / per;    // no empty slice
  if ((M + DM - 1) / DM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = K % 16 == 0 && N % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kern = aligned ? int8_mma_dense_kernel<true>
                      : int8_mma_dense_kernel<false>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + DN - 1) / DN, (M + DM - 1) / DM, splits);
  cfg.blockDim = dim3(DTHREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(d), static_cast<float*>(sq), M, K, N, per * DK);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// --- conv: the implicit patch matrix of an f32 image, quantized once ----------

constexpr int CTHREADS = 256;          // 8 warps: CM / 16 pixel rows of 16
constexpr int CM = 64;                 // output pixels a block, at most
constexpr int CWR = CM / 16;           // warp rows, each 16 pixels
constexpr int CNJ = 8 * CWR / (CTHREADS / 32);  // n8 tiles a warp
constexpr int CN = 64;                 // output channels an N tile
static_assert(CNJ >= 1 && CNJ * (CTHREADS / 32 / CWR) == CN / 8,
              "the warps cover the N tile");
constexpr int C_HALO = 16384;          // int8 halo bytes
constexpr int C_KCAP = 576;            // weight K bytes a group (9 x 64)
constexpr int C_WROW = C_KCAP + 16;    // a weight row (an output channel)
constexpr int CCLUSTER = 8;            // blocks that share the weights
constexpr int CU = 2;                  // words a thread loads, then quantizes
// the halo, the (N, K) weight tile and one int offset a k word
constexpr int CONV_SMEM = C_HALO + CN * C_WROW + C_KCAP;

// a launch's geometry and the block tile chosen for it
struct ConvGeom {
  int B, H, W, C, N, kh, kw, stride, ph, pw, OH, OW;
  int IB, TR, TC;   // a block's output tile: images, rows, columns
  int HR, HC;       // its halo: (TR-1) stride + kh rows, (TC-1) stride + kw
  int CC;           // channels a chunk, a multiple of 4
  int TG;           // taps a weight group: TG * CC <= C_KCAP
  int tiles_r, tiles_c;
  int blocks;       // output tiles (the grid adds idle blocks up to a
                    // whole number of clusters)
};

// Choose the tile: full-width rows (whole images where they are small),
// at most CM pixels, shrunk until a 4-channel chunk of the halo fits;
// then the largest channel chunk that fits the halo and the weight group.
// False where even one output pixel's halo does not fit (kh*kw > 4096).
inline bool plan_conv_tile(ConvGeom& g) {
  g.TC = min(g.OW, CM);
  g.TR = min(g.OH, CM / g.TC);
  g.IB = g.TR == g.OH ? min(g.B, CM / (g.TR * g.TC)) : 1;
  for (;;) {
    g.HR = (g.TR - 1) * g.stride + g.kh;
    g.HC = (g.TC - 1) * g.stride + g.kw;
    if (static_cast<int64_t>(g.IB) * g.HR * g.HC * 4 <= C_HALO) break;
    if (g.IB > 1) {
      g.IB /= 2;
    } else if (g.TR > 1) {
      g.TR /= 2;
    } else if (g.TC > 1) {
      g.TC /= 2;
    } else {
      return false;
    }
  }
  const int halo_px = g.IB * g.HR * g.HC;
  g.CC = min(min((g.C + 3) / 4 * 4, C_HALO / halo_px / 4 * 4), C_KCAP);
  g.TG = C_KCAP / g.CC;
  g.tiles_r = (g.OH + g.TR - 1) / g.TR;
  g.tiles_c = (g.OW + g.TC - 1) / g.TC;
  const int64_t blocks =
      static_cast<int64_t>((g.B + g.IB - 1) / g.IB) * g.tiles_r * g.tiles_c;
  if (blocks > INT32_MAX - CCLUSTER) return false;
  g.blocks = static_cast<int>(blocks);
  return true;
}

// Launched as clusters of CCLUSTER blocks along x, or of 1 for small
// weight tiles.  Each block quantizes its own halo; the weights of every
// (N tile, channel chunk, tap group) are quantized once a cluster, each
// block its share of the words, and written into every block's shared
// memory (distributed shared memory), a cluster barrier before and
// after.
__global__ void __launch_bounds__(CTHREADS, 3)
int8_mma_conv_kernel(const float* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ sx_ptr,
                     const float* __restrict__ sw, float* __restrict__ out,
                     const ConvGeom g, int qmax, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* halo = smem;
  unsigned char* wt = smem + C_HALO;
  int* koff = reinterpret_cast<int*>(smem + C_HALO + CN * C_WROW);
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int crank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int wrow = warp % CWR, whalf = warp / CWR;  // N part: n8 tiles
                                                    // whalf * CNJ, ..
  int blk = blockIdx.x;   // past g.blocks: an idle tile (b0 >= B)
  const int tc_i = blk % g.tiles_c;
  blk /= g.tiles_c;
  const int tr_i = blk % g.tiles_r;
  blk /= g.tiles_r;
  const int b0 = blk * g.IB, oy0 = tr_i * g.TR, ox0 = tc_i * g.TC;
  const int tile_px = g.TR * g.TC, P = g.IB * tile_px;
  const int halo_px = g.IB * g.HR * g.HC;
  const float sx = *sx_ptr;

  // this thread's two fragment rows: the halo byte of the pixel's first
  // tap, and its output pixel (-1: none)
  int base[2];
  int64_t om[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = wrow * 16 + gq + 8 * h;
    base[h] = 0;
    om[h] = -1;
    if (p < P) {
      const int ib = p / tile_px, rr = p - ib * tile_px;
      const int ty = rr / g.TC, tx = rr - ty * g.TC;
      base[h] = ((ib * g.HR + ty * g.stride) * g.HC + tx * g.stride) * g.CC;
      if (b0 + ib < g.B && oy0 + ty < g.OH && ox0 + tx < g.OW)
        om[h] = (static_cast<int64_t>(b0 + ib) * g.OH + oy0 + ty) * g.OW +
                ox0 + tx;
    }
  }
  const bool rows_here = wrow * 16 < P && b0 < g.B;  // uniform in a warp
  const int taps = g.kh * g.kw, cw = g.CC / 4;
  const bool one_chunk = g.CC >= g.C;

  for (int n0 = 0; n0 < g.N; n0 += CN) {
    const int nrows = min(CN, g.N - n0);
    const int n8 = (nrows + 7) / 8;      // the tile's n8 MMA tiles
    int acc[CNJ][4];
#pragma unroll
    for (int j = 0; j < CNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;

    for (int c0 = 0; c0 < g.C; c0 += g.CC) {
      for (int t0 = 0; t0 < taps; t0 += g.TG) {
        const int ntap = min(g.TG, taps - t0);
        const int words = (ntap * cw + 7) / 8 * 8;  // k32 steps x 8
        // every block of the cluster is done with the previous group's
        // weights (its peers write into them next)
        if (csize > 1) {
          cluster.sync();
        } else {
          __syncthreads();
        }
        if (t0 == 0 && (n0 == 0 || !one_chunk) && b0 < g.B) {
          // the halo of channels c0.., quantized once: CU words' loads
          // issued together (from a valid address where the word lies
          // outside), then quantized
          const int hw = halo_px * cw;
          for (int i0 = tid; i0 < hw; i0 += CTHREADS * CU) {
            float f[CU][4];
            int live[CU];
#pragma unroll
            for (int u = 0; u < CU; ++u) {
              const int i = i0 + u * CTHREADS;
              const int px = i / cw, c = c0 + (i - px * cw) * 4;
              const int ib = px / (g.HR * g.HC), rr = px - ib * g.HR * g.HC;
              const int hy = rr / g.HC, hx = rr - hy * g.HC;
              const int b = b0 + ib;
              const int iy = oy0 * g.stride - g.ph + hy;
              const int ix = ox0 * g.stride - g.pw + hx;
              const bool in = i < hw && c < g.C && b < g.B && iy >= 0 &&
                              iy < g.H && ix >= 0 && ix < g.W;
              const float* src =
                  in ? x + ((static_cast<size_t>(b) * g.H + iy) * g.W + ix) *
                                   g.C + c
                     : x;
              if (vec4) {  // C % 4 == 0: all four channels or none
                const float4 v = *reinterpret_cast<const float4*>(src);
                f[u][0] = v.x;
                f[u][1] = v.y;
                f[u][2] = v.z;
                f[u][3] = v.w;
                live[u] = in ? 0xf : 0;
              } else {
                live[u] = 0;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const bool ok = in && c + j < g.C;
                  f[u][j] = *(ok ? src + j : x);
                  live[u] |= ok ? 1 << j : 0;
                }
              }
            }
#pragma unroll
            for (int u = 0; u < CU; ++u) {
              const int i = i0 + u * CTHREADS;
              if (i >= hw) break;
              int q4[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                q4[j] = (live[u] >> j) & 1 ? quantize(f[u][j], sx, qmax) : 0;
              const int px = i / cw;
              *reinterpret_cast<uint32_t*>(halo + px * g.CC +
                                           (i - px * cw) * 4) =
                  pack4(q4[0], q4[1], q4[2], q4[3]);
            }
          }
        }
        // each k word's offset inside a pixel's halo window (padding
        // words point at the window's first word: their weights are 0)
        for (int i = tid; i < words; i += CTHREADS) {
          const int tl = i / cw;
          int o = 0;
          if (tl < ntap) {
            const int t = t0 + tl, ki = t / g.kw, kj = t - ki * g.kw;
            o = (ki * g.HC + kj) * g.CC + (i - tl * cw) * 4;
          }
          koff[i] = o;
        }
        // this block's share of the weights of taps t0.., channels c0..,
        // columns n0.., quantized and stored K-major (row n, word (tap, 4
        // channels)) into every block of the cluster
        const int rows8 = n8 * 8, total = rows8 * words;
        for (int i0 = crank * CTHREADS + tid; i0 < total;
             i0 += csize * CTHREADS * CU) {
          float f[CU][4], s[CU];
          int live[CU];
#pragma unroll
          for (int u = 0; u < CU; ++u) {
            const int i = i0 + u * csize * CTHREADS;
            const int wd = i / rows8, n = i - wd * rows8;
            const int tl = wd / cw, c = c0 + (wd - tl * cw) * 4;
            const bool in = i < total && n < nrows && tl < ntap;
            const float* src =
                in ? w + (static_cast<size_t>(t0 + tl) * g.C + c) * g.N + n0 +
                         n
                   : w;
            s[u] = sw[in ? n0 + n : 0];
            live[u] = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool ok = in && c + j < g.C;
              f[u][j] = *(ok ? src + static_cast<size_t>(j) * g.N : w);
              live[u] |= ok ? 1 << j : 0;
            }
          }
#pragma unroll
          for (int u = 0; u < CU; ++u) {
            const int i = i0 + u * csize * CTHREADS;
            if (i >= total) break;
            int q4[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              q4[j] = (live[u] >> j) & 1 ? quantize(f[u][j], s[u], qmax) : 0;
            const uint32_t v = pack4(q4[0], q4[1], q4[2], q4[3]);
            const int wd = i / rows8, n = i - wd * rows8;
            const int off = n * C_WROW + wd * 4;
            for (int q = 0; q < csize; ++q)
              *reinterpret_cast<uint32_t*>(
                  cluster.map_shared_rank(wt + off, q)) = v;
          }
        }
        // halo, offsets and every share of the weights are in place
        if (csize > 1) {
          cluster.sync();
        } else {
          __syncthreads();
        }
        if (!rows_here || whalf * CNJ >= n8) continue;
        for (int ks = 0; ks < words / 8; ++ks) {
          const int o0 = koff[ks * 8 + tg], o1 = koff[ks * 8 + tg + 4];
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(halo + base[0] + o0);
          a[1] = *reinterpret_cast<const uint32_t*>(halo + base[1] + o0);
          a[2] = *reinterpret_cast<const uint32_t*>(halo + base[0] + o1);
          a[3] = *reinterpret_cast<const uint32_t*>(halo + base[1] + o1);
#pragma unroll
          for (int j = 0; j < CNJ; ++j) {
            const int jt = whalf * CNJ + j;
            if (jt >= n8) break;
            const unsigned char* bp =
                wt + (jt * 8 + gq) * C_WROW + (ks * 8 + tg) * 4;
            mma_s8(acc[j], a, *reinterpret_cast<const uint32_t*>(bp),
                   *reinterpret_cast<const uint32_t*>(bp + 16));
          }
        }
      }
    }
    // (acc * sx) * sw, in this order: never fold sx * sw first
#pragma unroll
    for (int j = 0; j < CNJ; ++j) {
      const int jt = whalf * CNJ + j;
      if (jt >= n8) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (om[h] < 0) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + jt * 8 + 2 * tg + e;
          if (n < g.N)
            out[om[h] * g.N + n] =
                (static_cast<float>(acc[j][2 * h + e]) * sx) * sw[n];
        }
      }
    }
  }
}

// f32 (B,H,W,C) image x f32 (kh*kw, C, N) tap stack -> f32 (B,OH,OW,N),
// kh//2, kw//2 zero padding, quantized once on chip; `smem` the caller's
// shared-memory total, refused unless it is CONV_SMEM
inline int conv_int8_mma(const void* x, const void* w, const void* sx,
                         const void* sw, void* out, int B, int H, int W,
                         int C, int N, int kh, int kw, int stride, int bits,
                         int smem, void* stream) {
  if (smem != CONV_SMEM || kh % 2 != 1 || kw % 2 != 1 || stride < 1 ||
      bits < 2 || bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvGeom g{};
  g.B = B; g.H = H; g.W = W; g.C = C; g.N = N;
  g.kh = kh; g.kw = kw; g.stride = stride;
  g.ph = kh / 2; g.pw = kw / 2;
  g.OH = (H + 2 * g.ph - kh) / stride + 1;
  g.OW = (W + 2 * g.pw - kw) / stride + 1;
  if (B <= 0 || N <= 0 || g.OH <= 0 || g.OW <= 0)
    return static_cast<int>(cudaSuccess);
  if (C <= 0 || !plan_conv_tile(g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      int8_mma_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CONV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a cluster shares the weights where their tile is more than 16 words
  // a thread (below that its barriers cost more than they save)
  const int taps = kh * kw, tg = min(g.TG, taps), n8 = (min(N, CN) + 7) / 8;
  const int64_t wwords =
      static_cast<int64_t>(n8) * 8 * ((tg * (g.CC / 4) + 7) / 8 * 8);
  const int cl = wwords > 16 * CTHREADS ? min(CCLUSTER, g.blocks) : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.blocks + cl - 1) / cl * cl);
  cfg.blockDim = dim3(CTHREADS);
  cfg.dynamicSmemBytes = CONV_SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec4 =
      C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, int8_mma_conv_kernel,
                         static_cast<const float*>(x),
                         static_cast<const float*>(w),
                         static_cast<const float*>(sx),
                         static_cast<const float*>(sw),
                         static_cast<float*>(out), g, (1 << (bits - 1)) - 1,
                         vec4);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace cim
