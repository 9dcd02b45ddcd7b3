// conv_tile.cuh - the CiM convolutions of the Table IV CNN for NVIDIA
// Hopper (sm_90a): conv_lut_fused (the full product table, or the nibble
// sub-tables) and conv_log_fused (mitchell, log_our), and the mesh path's
// partial forms conv_lut_partial and conv_log_partial, operands of at
// most 8 bits.  Included by conv_gemm.cu, whose four entries launch it.
//
// Replaces, for operands of at most 8 bits, the TPU kernels
//   src/repro/kernels/conv_gemm.py:236 conv_lut_fused -> :131 ->
//     _lut_kernel :197 (nibble=False: the full table; True: sub-tables)
//   src/repro/kernels/conv_gemm.py:321 conv_log_fused -> :131 ->
//     _log_kernel :286 (mitchell, and log_our when compensated)
//   src/repro/kernels/conv_gemm.py:259 conv_lut_partial and :343
//     conv_log_partial -> :131, the same bodies with the epilogue off
// Log operands of 9..16 bits keep cim_gemm.cuh's template (the C entries
// conv_log_fused_wide, conv_log_partial_wide), by the gate
// kernels/conv_gemm.py conv_route.  One instantiation serves both
// epilogues: CtArgs::raw, uniform over the launch, picks cim_gemm.cuh's
// QuantIntOut (the raw int32 sum, the partials) or ScaleOut at the store.
//
// What it computes: the implicit GEMM of a (kh, kw, stride) convolution
// of an f32 image (B, H, W, C) with an f32 tap stack (kh*kw, C, N) under
// kh//2, kw//2 zero padding: acc = sum over (tap, channel) of
// prod(qa, qb) in 32 bits with two's-complement wrap, qa = quantize(x,
// sx), qb = quantize(w, sw[n]) (cim_gemm.cuh's quantize(): __fdiv_rn,
// rintf, clip; no fast-math), and out = (f32(acc) * sx) * sw[n] in that
// order, or (the partial forms) the int32 acc itself: bit for bit
// kernels/conv_gemm.py's conv_lut_fused_plain and conv_log_fused_plain
// (conv_*_partial_plain).  The products are those of cim_gemm.cuh's cores
// (LutCore, NibbleCore, LogCore), staged in compact 32-bit forms:
//   LUT      x: byte offset of its table row in the laid-out table (see
//            TabLayout); w: byte offset (b + h) * 2 in a row, as uint16;
//            a product is one int16 gather at table + x + w.
//   nibble   the core's split (stage_a, stage_b) as byte offsets into the
//            laid-out int32 sub-tables, packed: bits 0-12 the first,
//            13-25 the second, 30-31 the sign (two's complement, so an
//            arithmetic shift by 30 gives -1, 0, 1); a product is four
//            gathers, summed and signed.
//   mitchell cluster_gemm.cuh's signed byte pairs: two channels of a
//            pixel in one x word, two of a column in one w word, one
//            dp4a two products.
//   log_our  cluster_gemm.cuh's word with 2^c in place of c in its
//            compare half (comp_pow_word): x = log_x_bytes | compare; w
//            the same, split into its dot and compare halves by two masks
//            per use; a product is a dp4a, an unsigned min and max, one
//            IMAD for q_small * 2^c_big and one for the signed sum, the
//            sign one LOP3 of the two operands' replicated sign bits.
// Sums wrap, so any order of the (tap, channel) terms gives the same
// int32: the tiling below is free.
//
// What bounds it on an H100: its products (481 M per Table IV forward at
// batch 256): one shared-memory gather each for the full table, four for
// the nibble sub-tables (132 SMs x 32 words a clock), or the log product's
// instructions (chip_smoke.py reads them from this kernel's SASS); the
// image, the weights and the output are 22 MB a forward, a few us at
// 3.35 TB/s.
//
// Design (the template it replaces gave a block 16 pixels x 64 columns,
// one column a thread, so at the CNN's N of 16-64 most lanes computed
// masked columns; K was rounded up to 32; every patch element was loaded
// with four integer divisions and quantized again for each of the kh*kw
// taps that read it; each block quantized its weight tile again at every
// K step; each of 10,496 blocks copied its table):
//  * A block owns a spatial tile of output pixels (IB images x TR rows x
//    TC columns) and all of N, looping over N tiles of at most CT_NCAP
//    columns (as int8_mma.cuh's exact conv does).  Each thread owns a
//    register micro-tile of RP pixels x RN columns: its columns are RN
//    adjacent ones of the N tile (NG = NT / RN column groups), its pixels
//    RP of the tile's P <= PG * RP, PG = CT_THREADS / NG pixel groups
//    apart; so at the CNN's N (16, 32, 64) no lane holds a column past N,
//    and a staged operand read from shared memory feeds RN (x) or RP (w)
//    products.  A ragged last N tile idles the threads whose columns lie
//    wholly past it.
//  * The halo: the tile's input window (IB x HR x HC pixels) of a chunk
//    of CC channels is loaded once (16-byte loads where C % 4 == 0),
//    quantized once and stored in the staged form, one word a channel
//    (two for mitchell) at a pixel stride PS made odd so that the lanes
//    of a warp, on neighbouring pixels, read different banks.  The patch
//    matrix is read from it by index arithmetic: a pixel's base word plus
//    the tap's offset (ki HC + kj) PS plus the channel word; the taps are
//    walked by counters, so no integer division runs in the product loop.
//  * The tap stack: a group of TG taps x the chunk's channels x the N
//    tile is quantized once and stored in the staged form, k-word major,
//    the N tile's columns padded to NTP = NG * RN.  Where the whole stack
//    fits the weight region (one N tile, one chunk, one group: every
//    Table IV conv whose halo takes all its channels at once), a block
//    stages it once in its lifetime and keeps it over all its tiles.
//    Sharing it over a cluster (int8_mma.cuh's rule) was not taken: a
//    persistent block already stages it once, so a cluster would save at
//    most one staging a block, against a cluster barrier per group.
//    Larger stacks are staged per (tile, N tile, chunk, group).
//  * Staging is latency-bound where a block owns one or two tiles (the
//    small late convs): a thread issues the loads of several halo quads
//    (CT_HALO_BATCH) or weights (CT_W_BATCH) before it quantizes any.
//  * Channels are taken in chunks and taps in groups so that the shared
//    memory is one total per (form, bits) for every geometry
//    (ct_smem_bytes; kernels/conv_gemm.py gemm_smem_bytes, which the
//    launch checks): the laid-out table, an mbarrier, CT_HALO_WORDS halo
//    words and the form's weight region.
//  * A persistent grid: kernels/conv_gemm.py conv_plan launches
//    min(tiles, resident blocks) blocks (its capacity from
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor, conv_tile_capacity),
//    which loop over the tiles.  The table is copied once a block's
//    lifetime, by bulk asynchronous copies (cp.async.bulk, one a row
//    where rows are padded) that complete on an mbarrier, issued before
//    the first halo and weights are staged and waited for just before
//    the first products.  Its rows are padded so that they spread over
//    the banks (TabLayout): at 8 bits a LUT row is four whole bank lines,
//    so unpadded every gather of a column would hit one bank.
// Ragged pixel, channel and column edges stage as the operand 0, which
// every form annihilates (the tables map (0, b) and (a, 0) to 0; a zero
// sign zeroes the nibble product; a zero log word the log products).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cim_gemm.cuh"
#include "cluster_gemm.cuh"

namespace cim {

constexpr int CT_THREADS = 256;
constexpr int CT_NCAP = 64;              // columns an N tile, at most
constexpr int CT_HALO_WORDS = 8192;      // staged halo words
constexpr int CT_MAX_BITS = 8;
constexpr uint32_t CT_COPY_BYTES = 32768;  // bytes a bulk copy, at most
constexpr int CT_HALO_BATCH = 4;         // channel quads a thread loads,
constexpr int CT_W_BATCH = 8;            // weights, before it quantizes

// --- the table's layout in shared memory -----------------------------------------
// A table is rows of row_bytes (LUT: 2^bits int16 a row, the row the x
// operand; nibble: 4 x hb rows of hb int32, hb = 2^(bits/2)).  At 8 bits
// a LUT row is 512 bytes, a whole number of the 32 banks' 128-byte line,
// so a gather's bank would follow its column alone and the lanes of a
// warp on one column but other pixels would collide; each row is
// therefore stored `pad` = 16 bytes (4 banks) past the one before where
// its bytes allow a bulk copy of a row (a multiple of 16, at least 32),
// which spreads the rows over 8 bank offsets.

struct TabLayout {
  uint32_t row_bytes, rows, stride;   // stride: row_bytes + the pad
};

__host__ __device__ inline TabLayout tab_layout(uint32_t row_bytes,
                                                uint32_t rows) {
  const uint32_t pad = row_bytes % 16 == 0 && row_bytes >= 32 ? 16u : 0u;
  return TabLayout{row_bytes, rows, row_bytes + pad};
}

// --- the staged forms ----------------------------------------------------------
// KIND: 0 LUT, 1 nibble, 2 mitchell, 3 log_our; CPW: channels a staged
// word; W: a staged weight; W_ENTRIES: the weight region, in staged
// weights; MIN_BLOCKS: the residency asked of the compiler (the 8-bit
// table holds one block an SM; the others fit two).

struct TileLut {
  static constexpr int KIND = 0, CPW = 1, W_ENTRIES = 24576, MIN_BLOCKS = 1;
  using W = uint16_t;
  __host__ __device__ static TabLayout layout(int bits) {
    return tab_layout(2u << bits, 1u << bits);
  }
  // the x operand: its row's byte offset in the laid-out table
  __device__ static uint32_t x_word(int v, int, int bits) {
    return static_cast<uint32_t>(v + (1 << (bits - 1))) *
           layout(bits).stride;
  }
  // the w operand: its column's byte offset in a row (the core's stage_b)
  __device__ static W w_word(int v, int, int bits) {
    return static_cast<W>(LutCore::stage_b(v, bits) * 2);
  }
};

// The nibble split of NibbleCore (stage_a: (ah hb, 2 sz + al hb, sign),
// stage_b: (bh, sz + bl, sign), sz = hb hb, offsets into the four
// sub-tables) as byte offsets in the laid-out table: a row offset for
// the x side (row r at r stride), a column offset plus the second
// region's row offset for the w side; packed as bits 0-12 the first,
// 13-25 the second and 30-31 the sign (two's complement: an arithmetic
// shift by 30 gives -1, 0, 1)
__device__ __forceinline__ uint32_t nibble_pack(uint32_t first,
                                                uint32_t second, int sign) {
  return first | (second << 13) | (static_cast<uint32_t>(sign) << 30);
}

struct TileNibble {
  static constexpr int KIND = 1, CPW = 1, W_ENTRIES = 18432, MIN_BLOCKS = 2;
  using W = uint32_t;
  __host__ __device__ static TabLayout layout(int bits) {
    const uint32_t hb = 1u << (bits >> 1);
    return tab_layout(4u * hb, 4u * hb);
  }
  __device__ static uint32_t x_word(int v, int, int bits) {
    const int4 s = NibbleCore::stage_a(v, bits);
    const uint32_t hb = 1u << (bits >> 1), st = layout(bits).stride;
    // rows ah and 2 hb + al
    return nibble_pack(static_cast<uint32_t>(s.x) / hb * st,
                       static_cast<uint32_t>(s.y) / hb * st, s.z);
  }
  __device__ static W w_word(int v, int, int bits) {
    const int4 s = NibbleCore::stage_b(v, bits);
    const uint32_t hb = 1u << (bits >> 1), st = layout(bits).stride;
    // column bh; row hb (the second region) and column bl
    return nibble_pack(static_cast<uint32_t>(s.x) * 4u,
                       hb * st + (static_cast<uint32_t>(s.y) - hb * hb) * 4u,
                       s.z);
  }
};

// log_our's compare half: 2^c(q) in byte 3, q in byte 2, c(q) = LoD(q) +
// round_up (cluster_gemm.cuh's comp_word with the shift's power of two
// in place of the shift: both monotone in q, so the unsigned words still
// order like q, and q_small << c_big = q_small * 2^c_big, one IMAD)
__device__ __forceinline__ uint32_t comp_pow_word(int v, int bits) {
  const uint32_t w = comp_word(v, bits);
  return ((1u << (w >> 24)) << 24) | (w & 0x00ff0000u);
}

template <bool COMP>
struct TileLog {
  static constexpr int KIND = COMP ? 3 : 2, CPW = COMP ? 1 : 2;
  static constexpr int W_ENTRIES = 18432, MIN_BLOCKS = 2;
  using W = uint32_t;
  __host__ __device__ static TabLayout layout(int) {
    return TabLayout{0, 0, 0};
  }
  __device__ static uint32_t x_word(int v0, int v1, int bits) {
    if constexpr (COMP) return log_x_bytes(v0, bits) | comp_pow_word(v0, bits);
    return log_x_bytes(v0, bits) | (log_x_bytes(v1, bits) << 16);
  }
  __device__ static W w_word(int v0, int v1, int bits) {
    if constexpr (COMP) return log_w_bytes(v0, bits) | comp_pow_word(v0, bits);
    return log_w_bytes(v0, bits) | (log_w_bytes(v1, bits) << 16);
  }
};

// the laid-out table's bytes
template <class F>
__host__ __device__ inline size_t ct_table_bytes(int bits) {
  const TabLayout L = F::layout(bits);
  return static_cast<size_t>(L.rows) * L.stride;
}

// dynamic shared memory of one block: the laid-out table, an mbarrier
// (16 bytes), the halo and the weight region (kernels/conv_gemm.py
// tile_smem_bytes)
template <class F>
__host__ __device__ inline size_t ct_smem_bytes(int bits) {
  return al16(ct_table_bytes<F>(bits)) + 16 +
         static_cast<size_t>(CT_HALO_WORDS) * 4 +
         al16(static_cast<size_t>(F::W_ENTRIES) * sizeof(typename F::W));
}

// --- the bulk copy of the table ---------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16) global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// --- a launch ------------------------------------------------------------------------

struct CtArgs {
  const float* x;
  const float* w;
  const unsigned char* tab;
  const float* sx;
  const float* sw;
  void* out;            // f32 (ScaleOut) or, where raw, int32 (QuantIntOut)
  int B, H, W, C, N, kh, kw, stride, ph, pw, OH, OW, bits;
  int IB, TR, TC;       // a tile: images, output rows, output columns
  int HR, HC;           // its halo: (TR-1) stride + kh, (TC-1) stride + kw
  int CC, CCW, PS;      // channels a chunk, its staged words, the halo's
                        // pixel stride in words (odd)
  int TG;               // taps a weight group
  int NT, NG, PG, NTP;  // the N tile, column and pixel groups, NG * RN
  int tiles_c, tiles_r, tiles;
  int whole;            // the whole tap stack fits: staged once a block
  int vec4;             // C % 4 == 0 and x 16-byte aligned
  int raw;              // the epilogue: the raw int32 sum (the partials)
};

// the halo of channels c0.. of the tile at (b0, oy0, ox0): each channel
// quad of a halo pixel loaded (one float4 where vec4), quantized once and
// staged; outside the image or past C the operand 0.  A thread loads
// CT_HALO_BATCH quads before it quantizes any, so their loads overlap.
template <class F>
__device__ __forceinline__ void ct_stage_halo(uint32_t* halo,
                                              const CtArgs& a, int b0,
                                              int oy0, int ox0, int c0,
                                              float sx, int qmax, int tid) {
  constexpr int U = CT_HALO_BATCH;
  const int qpp = a.CC / 4, hrc = a.HR * a.HC;
  const int items = a.IB * hrc * qpp;
  for (int i0 = tid; i0 < items; i0 += CT_THREADS * U) {
    float f[U][4];
    int live[U], dst[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * CT_THREADS;
      const int px = i / qpp, qd = i - px * qpp;
      const int ib = px / hrc, rr = px - ib * hrc;
      const int hy = rr / a.HC, hx = rr - hy * a.HC;
      const int b = b0 + ib;
      const int iy = oy0 * a.stride - a.ph + hy;
      const int ix = ox0 * a.stride - a.pw + hx;
      const int c = c0 + qd * 4;
      const bool in = i < items && b < a.B && iy >= 0 && iy < a.H &&
                      ix >= 0 && ix < a.W && c < a.C;
      dst[u] = i < items ? px * a.PS + qd * (4 / F::CPW) : -1;
      live[u] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) f[u][j] = 0.f;
      if (in) {
        const float* src =
            a.x + ((static_cast<size_t>(b) * a.H + iy) * a.W + ix) * a.C + c;
        if (a.vec4) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          f[u][0] = v.x;
          f[u][1] = v.y;
          f[u][2] = v.z;
          f[u][3] = v.w;
          live[u] = 0xf;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c + j < a.C) {
              f[u][j] = src[j];
              live[u] |= 1 << j;
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (dst[u] < 0) continue;
      int q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = (live[u] >> j) & 1 ? quantize(f[u][j], sx, qmax) : 0;
      uint32_t* d = halo + dst[u];
      if constexpr (F::CPW == 2) {
        d[0] = F::x_word(q[0], q[1], a.bits);
        d[1] = F::x_word(q[2], q[3], a.bits);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] = F::x_word(q[j], 0, a.bits);
      }
    }
  }
}

// the weights of taps t0.. (ntap), channels c0.. and columns n0.. (the N
// tile), quantized once and staged k-word major: wt[(tap * CCW + word) *
// NTP + column]; past C, N or the tile the operand 0.  A thread loads
// CT_W_BATCH weights (and their scales) before it quantizes any.
template <class F>
__device__ __forceinline__ void ct_stage_w(typename F::W* wt,
                                           const CtArgs& a, int n0, int c0,
                                           int t0, int ntap, int qmax,
                                           int tid) {
  constexpr int U = CT_W_BATCH;
  const int nt = min(a.NT, a.N - n0);
  const int items = ntap * a.CCW * a.NTP;
  for (int i0 = tid; i0 < items; i0 += CT_THREADS * U) {
    float f[U][F::CPW], sc[U];
    int live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * CT_THREADS;
      const int kk = i / a.NTP, n = i - kk * a.NTP;
      const int tl = kk / a.CCW, cw = kk - tl * a.CCW;
      const int c = c0 + cw * F::CPW;
      live[u] = 0;
      sc[u] = 1.f;
#pragma unroll
      for (int k = 0; k < F::CPW; ++k) f[u][k] = 0.f;
      if (i < items && n < nt) {
        sc[u] = a.sw[n0 + n];
        const float* src =
            a.w + (static_cast<size_t>(t0 + tl) * a.C + c) * a.N + n0 + n;
#pragma unroll
        for (int k = 0; k < F::CPW; ++k) {
          if (c + k < a.C) {
            f[u][k] = src[static_cast<size_t>(k) * a.N];
            live[u] |= 1 << k;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * CT_THREADS;
      if (i >= items) break;
      int q[2] = {0, 0};
#pragma unroll
      for (int k = 0; k < F::CPW; ++k)
        if ((live[u] >> k) & 1) q[k] = quantize(f[u][k], sc[u], qmax);
      wt[i] = F::w_word(q[0], q[1], a.bits);
    }
  }
}

// RN adjacent staged weights (aligned to their size: NTP % RN == 0)
template <int RN, typename W>
__device__ __forceinline__ void ct_load_w(W (&b)[RN], const W* p) {
  constexpr int BYTES = RN * static_cast<int>(sizeof(W));
  if constexpr (BYTES == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      if constexpr (sizeof(W) == 4) {
        b[j] = u[j];
      } else {
        b[j] = static_cast<W>(u[j / 2] >> (16 * (j % 2)));
      }
    }
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const uint32_t u[2] = {v.x, v.y};
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      if constexpr (sizeof(W) == 4) {
        b[j] = u[j];
      } else {
        b[j] = static_cast<W>(u[j / 2] >> (16 * (j % 2)));
      }
    }
  } else if constexpr (BYTES == 4 && sizeof(W) == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    b[0] = static_cast<W>(u);
    b[1] = static_cast<W>(u >> 16);
  } else {
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = p[j];
  }
}

__device__ __forceinline__ int gather32(const unsigned char* tab,
                                        uint32_t off) {
  return *reinterpret_cast<const int32_t*>(tab + off);
}

// the products of taps t0.. (ntap) over the staged chunk: for each tap
// (ki, kj counted, not divided) and channel word, RP x words and RN w
// words from shared memory, RP x RN products into acc
template <class F, int RP, int RN>
__device__ __forceinline__ void ct_products(
    uint32_t (&acc)[RP][RN], const uint32_t* __restrict__ halo,
    const typename F::W* __restrict__ wt, const unsigned char* tab,
    const CtArgs& a, const int (&hb)[RP], int t0, int ntap, int cg) {
  using W = typename F::W;
  int ki = t0 / a.kw, kj = t0 - ki * a.kw;
  const W* wp = wt + cg * RN;
  for (int tl = 0; tl < ntap; ++tl) {
    const uint32_t* hp = halo + (ki * a.HC + kj) * a.PS;
#pragma unroll 2
    for (int cw = 0; cw < a.CCW; ++cw, wp += a.NTP) {
      uint32_t av[RP];
#pragma unroll
      for (int i = 0; i < RP; ++i) av[i] = hp[hb[i] + cw];
      W bv[RN];
      ct_load_w<RN>(bv, wp);
      if constexpr (F::KIND == 0) {
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            acc[i][j] += static_cast<uint32_t>(static_cast<int32_t>(
                *reinterpret_cast<const int16_t*>(tab + av[i] + bv[j])));
      } else if constexpr (F::KIND == 1) {
        uint32_t bx[RN], by[RN];
        int sb[RN];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          bx[j] = bv[j] & 0x1fffu;
          by[j] = (bv[j] >> 13) & 0x1fffu;
          sb[j] = static_cast<int32_t>(bv[j]) >> 30;
        }
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          const uint32_t ax = av[i] & 0x1fffu, ay = (av[i] >> 13) & 0x1fffu;
          const int sa = static_cast<int32_t>(av[i]) >> 30;
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int mag = gather32(tab, ax + bx[j]) +
                            gather32(tab, ax + by[j]) +
                            gather32(tab, ay + bx[j]) +
                            gather32(tab, ay + by[j]);
            acc[i][j] += static_cast<uint32_t>(sa * sb[j] * mag);
          }
        }
      } else if constexpr (F::KIND == 2) {
        // two channels: the signed bytes' dot product
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            acc[i][j] = static_cast<uint32_t>(
                __dp4a(static_cast<int>(av[i]), static_cast<int>(bv[j]),
                       static_cast<int>(acc[i][j])));
      } else {
        // the sign masks (the sign bit of each dot word's first byte,
        // replicated), the dot and compare halves of w
        uint32_t bd[RN], bc[RN], sb[RN], sa[RP];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          bd[j] = bv[j] & 0xffffu;        // (s 2^k, s q): the dp4a half
          bc[j] = bv[j] & 0xffff0000u;    // (2^c, q): the compare half
          sb[j] = prmt(bd[j], 0u, 0x8888u);
        }
#pragma unroll
        for (int i = 0; i < RP; ++i) sa[i] = prmt(av[i], 0u, 0x8888u);
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            // the mitchell part, signed
            const uint32_t s = static_cast<uint32_t>(
                __dp4a(static_cast<int>(av[i]), static_cast<int>(bd[j]),
                       static_cast<int>(acc[i][j])));
            // comp = q_small * 2^c_big, signed by sign(a) sign(b)
            const uint32_t mx = max(av[i], bc[j]), mn = min(av[i], bc[j]);
            const uint32_t comp = prmt(mn, 0u, 0x4442u) * (mx >> 24);
            acc[i][j] = s + comp * ((sa[i] ^ sb[j]) | 1u);
          }
      }
    }
    if (++kj == a.kw) {
      kj = 0;
      ++ki;
    }
  }
}

template <class F, int RP, int RN>
__global__ void __launch_bounds__(CT_THREADS, (F::MIN_BLOCKS))
conv_tile_kernel(const CtArgs a) {
  using W = typename F::W;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tbytes = al16(ct_table_bytes<F>(a.bits));
  unsigned char* s_tab = smem;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + tbytes);
  uint32_t* halo = reinterpret_cast<uint32_t*>(smem + tbytes + 16);
  W* wt = reinterpret_cast<W*>(smem + tbytes + 16 + CT_HALO_WORDS * 4);
  const int tid = threadIdx.x;
  const int qmax = (1 << (a.bits - 1)) - 1;
  const float sx = *a.sx;

  // the table: bulk copies completing on `bar` (one a row where rows are
  // padded, else the whole table in pieces), in flight while the first
  // halo and weights are staged
  bool tab_ready = F::KIND >= 2;
  if constexpr (F::KIND < 2) {
    const TabLayout L = F::layout(a.bits);
    if (tid == 0) {
      mbar_init(bar, 1);
      mbar_expect_tx(bar, L.rows * L.row_bytes);
    }
    __syncthreads();
    if (L.stride != L.row_bytes) {
      for (uint32_t r = tid; r < L.rows; r += CT_THREADS)
        bulk_copy(s_tab + r * L.stride, a.tab + r * L.row_bytes,
                  L.row_bytes, bar);
    } else if (tid == 0) {
      const uint32_t bytes = L.rows * L.row_bytes;
      for (uint32_t o = 0; o < bytes; o += CT_COPY_BYTES)
        bulk_copy(s_tab + o, a.tab + o, min(CT_COPY_BYTES, bytes - o), bar);
    }
  }

  const int cg = tid % a.NG, pg = tid / a.NG;
  const bool lane_live = pg < a.PG;
  const int taps = a.kh * a.kw, tile_px = a.TR * a.TC;
  const int P = a.IB * tile_px;
  bool w_staged = false;

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    int r = tile;
    const int tci = r % a.tiles_c;
    r /= a.tiles_c;
    const int tri = r % a.tiles_r;
    r /= a.tiles_r;
    const int b0 = r * a.IB, oy0 = tri * a.TR, ox0 = tci * a.TC;
    // this thread's pixels: the halo word of the first tap, and the
    // output pixel (-1: none)
    int hb[RP], om[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int p = pg + i * a.PG;
      hb[i] = 0;
      om[i] = -1;
      if (lane_live && p < P) {
        const int ib = p / tile_px, rr = p - ib * tile_px;
        const int ty = rr / a.TC, tx = rr - ty * a.TC;
        hb[i] = ((ib * a.HR + ty * a.stride) * a.HC + tx * a.stride) * a.PS;
        if (b0 + ib < a.B && oy0 + ty < a.OH && ox0 + tx < a.OW)
          om[i] = ((b0 + ib) * a.OH + oy0 + ty) * a.OW + ox0 + tx;
      }
    }
    for (int n0 = 0; n0 < a.N; n0 += a.NT) {
      const int nt = min(a.NT, a.N - n0);
      const bool cols_live = lane_live && cg * RN < nt;
      uint32_t acc[RP][RN];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0u;
      for (int c0 = 0; c0 < a.C; c0 += a.CC) {
        const bool new_halo = n0 == 0 || a.CC < a.C;
        for (int t0 = 0; t0 < taps; t0 += a.TG) {
          const int ntap = min(a.TG, taps - t0);
          const bool halo_now = t0 == 0 && new_halo;
          const bool w_now = !(a.whole && w_staged);
          if (halo_now || w_now) {
            __syncthreads();  // the products before are done with them
            if (halo_now)
              ct_stage_halo<F>(halo, a, b0, oy0, ox0, c0, sx, qmax, tid);
            if (w_now) ct_stage_w<F>(wt, a, n0, c0, t0, ntap, qmax, tid);
            w_staged = true;
            __syncthreads();  // staged operands are visible
          }
          if (!tab_ready) {
            mbar_wait(bar, 0);
            tab_ready = true;
          }
          if (cols_live)
            ct_products<F, RP, RN>(acc, halo, wt, s_tab, a, hb, t0, ntap,
                                   cg);
        }
      }
      if (cols_live) {
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          if (om[i] < 0) continue;
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int n = n0 + cg * RN + j;
            if (n >= a.N) continue;
            const size_t o = static_cast<size_t>(om[i]) * a.N + n;
            if (a.raw)
              QuantIntOut{}.store(static_cast<int32_t*>(a.out), o, n,
                                  acc[i][j], 0.f, sx, a.sw);
            else
              ScaleOut{}.store(static_cast<float*>(a.out), o, n, acc[i][j],
                               0.f, sx, a.sw);
          }
        }
      }
    }
  }
  if (!tab_ready) mbar_wait(bar, 0);  // no block leaves a copy in flight
}

// --- the plan, as kernels/conv_gemm.py conv_plan makes it ---------------------

// The arguments of a launch: the geometry and the plan's (rp, rn, ib, tr,
// tc, cc, tg), the rest derived here as conv_plan derives it; false for a
// plan the kernel does not take (its tile or chunk overflowing the halo,
// its group the weight region, or threads too few for the tile)
template <class F>
inline bool ct_make_args(CtArgs& a, int rp, int rn, int ib, int tr, int tc,
                         int cc, int tg) {
  if (a.B <= 0 || a.C <= 0 || a.N <= 0 || a.OH <= 0 || a.OW <= 0)
    return false;
  if (ib < 1 || tr < 1 || tc < 1 || ib > a.B || tr > a.OH || tc > a.OW)
    return false;
  a.NT = min(a.N, CT_NCAP);
  a.NG = (a.NT + rn - 1) / rn;
  a.PG = CT_THREADS / a.NG;
  a.NTP = a.NG * rn;
  if (a.PG < 1 || static_cast<int64_t>(ib) * tr * tc > a.PG * rp)
    return false;
  a.IB = ib;
  a.TR = tr;
  a.TC = tc;
  a.HR = (tr - 1) * a.stride + a.kh;
  a.HC = (tc - 1) * a.stride + a.kw;
  if (cc < 4 || cc % 4 != 0 || cc > (a.C + 3) / 4 * 4) return false;
  a.CC = cc;
  a.CCW = cc / F::CPW;
  a.PS = a.CCW % 2 == 0 ? a.CCW + 1 : a.CCW;
  if (static_cast<int64_t>(ib) * a.HR * a.HC * a.PS > CT_HALO_WORDS)
    return false;
  const int taps = a.kh * a.kw;
  if (tg < 1 || tg > taps ||
      static_cast<int64_t>(tg) * a.CCW * a.NTP > F::W_ENTRIES)
    return false;
  a.TG = tg;
  a.tiles_c = (a.OW + tc - 1) / tc;
  a.tiles_r = (a.OH + tr - 1) / tr;
  const int64_t tiles =
      static_cast<int64_t>((a.B + ib - 1) / ib) * a.tiles_r * a.tiles_c;
  if (tiles > INT32_MAX ||
      static_cast<int64_t>(a.B) * a.OH * a.OW > INT32_MAX)
    return false;
  a.tiles = static_cast<int>(tiles);
  a.whole = a.N <= a.NT && cc >= a.C && tg >= taps;
  a.vec4 = a.C % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  return true;
}

template <class F, int RP, int RN>
inline const void* ct_kernel() {
  return reinterpret_cast<const void*>(conv_tile_kernel<F, RP, RN>);
}

// the instantiated micro-tiles (RP, RN) (kernels/conv_gemm.py TILE_MICRO)
#define CT_MICRO(X) \
  X(4, 1) X(8, 1) X(4, 2) X(8, 2) X(2, 4) X(4, 4) X(8, 4)

template <class F>
inline const void* ct_pick(int rp, int rn) {
#define CT_CASE(P, N) \
  if (rp == P && rn == N) return ct_kernel<F, P, N>();
  CT_MICRO(CT_CASE)
#undef CT_CASE
  return nullptr;
}

// Launches the tile kernel of form F: f32 (B,H,W,C) x f32 (kh*kw, C, N)
// -> (B,OH,OW,N), f32 through ScaleOut or, where `raw`, the int32 sum
// (QuantIntOut), `grid` persistent blocks over the tiles of the plan (rp,
// rn, ib, tr, tc, cc, tg); `smem` is the caller's shared-memory total,
// refused unless it is ct_smem_bytes<F>(bits).  Returns the CUDA error
// code; a plan the kernel does not take is refused
// (cudaErrorInvalidValue).
template <class F>
int conv_tile(const void* x, const void* w, const void* tab, const void* sx,
              const void* sw, void* out, int raw, int B, int H, int W, int C,
              int N, int kh, int kw, int stride, int bits, int smem, int rp,
              int rn, int ib, int tr, int tc, int cc, int tg, int grid,
              void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (kh % 2 != 1 || kw % 2 != 1 || stride < 1 || bits < 2 ||
      bits > CT_MAX_BITS)
    return bad;
  if (static_cast<size_t>(smem) != ct_smem_bytes<F>(bits)) return bad;
  CtArgs a{};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.tab = static_cast<const unsigned char*>(tab);
  a.sx = static_cast<const float*>(sx);
  a.sw = static_cast<const float*>(sw);
  a.out = out;
  a.raw = raw != 0;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.N = N;
  a.kh = kh;
  a.kw = kw;
  a.stride = stride;
  a.ph = kh / 2;
  a.pw = kw / 2;
  a.OH = (H + 2 * a.ph - kh) / stride + 1;
  a.OW = (W + 2 * a.pw - kw) / stride + 1;
  a.bits = bits;
  if (B <= 0 || N <= 0 || a.OH <= 0 || a.OW <= 0)
    return static_cast<int>(cudaSuccess);
  if (!ct_make_args<F>(a, rp, rn, ib, tr, tc, cc, tg) || grid < 1 ||
      grid > a.tiles)
    return bad;
  if (F::KIND < 2 && reinterpret_cast<uintptr_t>(tab) % 16 != 0) return bad;
  const void* kern = ct_pick<F>(rp, rn);
  if (kern == nullptr) return bad;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(CT_THREADS), args,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The blocks of the tile kernel of form F, micro-tile (rp, rn), at `bits`
// resident on one SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// with its shared memory), into *out, for either epilogue (one
// instantiation); returns the CUDA error code.
template <class F>
int conv_tile_capacity(int bits, int rp, int rn, int* out) {
  if (bits < 2 || bits > CT_MAX_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = ct_pick<F>(rp, rn);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(ct_smem_bytes<F>(bits));
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kern, CT_THREADS, static_cast<size_t>(smem)));
}

}  // namespace cim
