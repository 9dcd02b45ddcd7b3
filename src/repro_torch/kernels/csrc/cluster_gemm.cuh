// cluster_gemm.cuh - the split-K CiM GEMM for NVIDIA Hopper (sm_90a):
// the LUT, magnitude-table, nibble sub-table and log-domain GEMMs.  Three
// epilogues: the fused forms (float operands quantized on load, (acc *
// sx) * sw flushed in the kernel), their partial forms (the same kernel,
// the raw int32 sum out) and the int forms (int8 operands in, the raw
// int32 sum out).  Included by lut_gemm.cu (lut_gemm_fused,
// lut_gemm_partial, lut_gemm_int8_cluster, lut_gemm_int8_mag_cluster),
// nibble_gemm.cu (nibble_gemm_fused, nibble_gemm_partial,
// nibble_gemm_int8_cluster) and log_gemm.cu (log_gemm_fused,
// log_gemm_partial, log_gemm_int8_cluster); its frame (the operand ring
// and tile copies, cl_launch_ex, cl_capacity_ex, the plan's checks) also
// carries surrogate_cluster.cuh's fused surrogate GEMM.
//
// Replaces, for operands of at most 8 bits, the TPU kernels
//   src/repro/kernels/approx_matmul.py:230 lut_matmul_fused -> :208 ->
//     _fused_kernel :171 (the full product table)
//   src/repro/kernels/approx_matmul.py:248 lut_matmul_partial -> :208
//     (_fused_kernel, epilogue off)
//   src/repro/kernels/approx_matmul.py:137 lut_matmul -> :155 ->
//     _int_kernel :118 (int8 in, the int16 signed table; and over the
//     table of magnitude products, the faulted table's form: the port's
//     lut_matmul_mag)
//   src/repro/kernels/approx_matmul.py:389 nibble_lut_matmul_fused -> :367
//     -> _nibble_fused_kernel :329 (_gather_nibble :83, the four
//     2^{b/2} x 2^{b/2} sub-tables of a half-word-decomposable multiplier)
//   src/repro/kernels/approx_matmul.py:402 nibble_lut_matmul_partial ->
//     :367 (_nibble_fused_kernel, epilogue off)
//   src/repro/kernels/approx_matmul.py:294 nibble_lut_matmul -> :313 ->
//     _nibble_int_kernel :269 (int8 in)
//   src/repro/kernels/mitchell_gemm.py:173 mitchell_matmul_fused -> :151
//     -> _fused_kernel :115 (_log_product :44, mitchell and log_our)
//   src/repro/kernels/mitchell_gemm.py:189 mitchell_matmul_partial ->
//     :151 (_fused_kernel, epilogue off)
//   src/repro/kernels/mitchell_gemm.py:88 mitchell_matmul -> :100 ->
//     _kernel :70 (int8 in)
// Log operands of 9..16 bits go to cim_gemm.cuh's tiled template, by the
// gate kernels/mitchell_gemm.py fused_route (a function of the bits,
// tested on the CPU), fused, partial and int alike.  Every nibble width is
// even and at most 8 bits: the nibble forms, int included, have no other
// route.
//
// What it computes: acc = sum_k prod(qa, qb) in 32 bits with
// two's-complement wrap, and out[m,n] = (f32(acc) * sx) * sw[n] (Epi =
// ScaleOut, the fused forms) or the raw int32 acc (Epi = QuantIntOut, the
// partial forms: the mesh path sums a shard's partials over the model
// axis before the epilogue; Epi = IntOut, the int forms).  The fused and
// partial forms quantize qa = round(x / sx), qb = round(w / sw[n]) by
// __fdiv_rn and rintf, clipped to +-qmax (build without fast-math); the
// int forms take qa, qb as the int8 they are, and sx, sw are not read:
// bit for bit the plain versions lut_matmul_fused_plain,
// nibble_lut_matmul_fused_plain, mitchell_matmul_fused_plain, their
// *_partial_plain, ref.lut_matmul_ref, lut_matmul_mag_plain,
// ref.nibble_matmul_ref and ref.mitchell_matmul_ref.
//
// What bounds it on an H100: at a decode round (M = 4) the weight: each
// element is read once (3.35 TB/s) and, in a fused form, quantized once
// (an IEEE division), for four products; at M = 64 the products: a
// shared-memory gather each (LUT, magnitude table; two for the nibble
// form; 132 SMs x 32 words a clock), or the log product's instructions
// (phase 2 of chip_smoke.py reads them from this kernel's SASS).
//
// Design (the template before it left a decode GEMM latency-bound: 16-96
// blocks of 16 rows for 132 SMs, synchronous loads, every weight element
// staged once per 16-row tile):
//  * Fill the card: a block owns up to RB = 4, 16 or 64 rows (every row
//    of a served GEMM, M <= 64; the nibble and magnitude kernels' tiles
//    stop at 16) and 64 columns, and one slice of K.  The
//    K slices of a tile are one thread-block cluster of at most 8 blocks.
//    kernels/approx_matmul.py cluster_plan chooses the split from the
//    shape and from how many clusters of each size the device holds at
//    once (cluster_capacity: a cluster's blocks share one GPC, so on an
//    H100 32 clusters of 4 single-SM blocks do not fit where 32 of 3 do),
//    minimizing waves x steps.  Each block leaves its uint32 partial tile
//    in its shared memory; after a cluster barrier every block sums a
//    share of the tile over the cluster's partials through distributed
//    shared memory, in rank order, and flushes it through Epi.  Wrapping
//    32-bit addition is associative, so the sum is the reference's
//    exactly, with no memset and no atomics.
//  * Keep copies in flight: the raw tiles of x and w arrive through a
//    ring of stages of BK k filled by cp.async (16 bytes a copy; operands
//    whose rows are not 16-byte multiples are loaded by elements into the
//    same layout), and each stage is staged from shared memory while the
//    next ones land.  Float operands: CL_STAGES stages of 64 k for bf16,
//    32 where either is f32.  int8 operands: CL_INT_STAGES (8) stages of
//    64 k, 16 k a copy: a stage holds half a bf16 stage's bytes, so twice
//    the stages keep as many bytes in flight; at 64 rows the LUT kernel's
//    ring (64 KiB), staged x (16 KiB) and 128 KiB table fit one block.
//  * Stage each weight element once a call (once an RB-row tile for M
//    > RB): a block is 64 columns x k groups of threads (4 for the log,
//    nibble and magnitude kernels, two blocks an SM; 8 for the LUT kernel,
//    whose table leaves room for one block an SM); a thread stages its
//    column's BK / k groups k of a stage (quantized, or as int8) straight
//    into registers and reuses each staged weight operand for every row of
//    the tile.  The x tile is staged once a stage into shared memory, by
//    the same functions from a quantized or an int8 operand, so the int
//    and the fused forms share every staged form.  The k groups' sums
//    meet in shared memory before the cluster sum.
//  * Compact staged forms, each a 32-bit word or less (plain-torch models
//    and exhaustive checks: tests/test_torch_cluster_gemm.py,
//    tests/test_torch_nibble_cluster.py, tests/test_torch_int_cluster.py):
//      LUT       a: byte offset of a's table row, ((a + h) << bits) * 2;
//                b: byte offset (b + h) * 2, h = 2^(bits-1); a product is
//                one int16 gather at table + a + b.
//      magnitude the uint16 table uf[|a|][|b|], |a|, |b| <= qmax (32 KiB at
//                8 bits).  a: the byte offset of row min(|a|, qmax),
//                min(|a|, qmax) << bits, and sign(a) in a second plane of
//                the staged x; b: two registers, the byte offset min(|b|,
//                qmax) * 2 and sign(b).  A product is sign(a) sign(b)
//                uf[...], one uint16 gather and an IMAD, summed in uint32:
//                -2^(b-1) saturates to qmax, as signed_from_magnitude builds
//                the signed table, and sign 0 annihilates a zero operand
//                and the ragged edges whatever a faulted row 0 holds.  Its
//                block: 4 k groups (256 threads), two blocks an SM, row
//                tiles 4 and 16 (approx_matmul.MAG_ROWS): two registers a
//                weight element leave 64 accumulators too little room.
//      nibble    the four sub-tables folded into two, signed by the x
//                operand: row v (v = -qmax..qmax) holds sign(v) times
//                (Q_h[|v|][0..hb), Q_l[|v|][0..hb)), with Q_h[am][bh] =
//                S_hh[am >> h][bh] + S_lh[am & (hb-1)][bh] and Q_l[am][bl]
//                = S_hl[am >> h][bl] + S_ll[am & (hb-1)][bl] (h = bits /
//                2, hb = 2^h): 2 hb int32 words a row, one bank line at 8
//                bits.  a: the byte offset of its row, (a + qmax) 8 hb;
//                b: three registers, the byte offsets 4 bh and 4 (hb +
//                bl) and sign(b).  A product is sign(b) (row[bh] +
//                row[bl]): two gathers, both in the row of a warp-uniform
//                a, so each is one wavefront.  These are the reference's
//                four terms regrouped (wrapping sums are associative);
//                the row of a = 0 is zero by its sign and sign(0) zeroes
//                b = 0, whatever the sub-tables hold.  An int8 operand
//                saturates as the reference's _nibble_int_kernel: x stages
//                the row of sign(a) min(|a|, qmax), w the columns of
//                min(|b|, qmax) (-128, and below 8 bits every magnitude
//                past qmax); a quantized operand never leaves +-qmax, so
//                the fused and partial forms skip the clamp.
//      mitchell  2^(k1+k2) + q1 2^k2 + q2 2^k1 = mag1 2^k2 + q2 2^k1, so
//                with A = (s1 mag1, s1 2^k1) and B = (s2 2^k2, s2 q2) as
//                signed bytes the signed product is A.B, a dot product of
//                two bytes: two k of a row pack into one word and one
//                dp4a (IDP.4A) makes two products.  |mag| <= 127, 2^k <=
//                64, q <= 63 for a quantized operand; an int8 operand
//                reaches -128 = -1 x 128 at 8 bits, and below 8 bits the
//                capped k leaves q <= 126: every byte fits.  A zero
//                operand is (0, 0): the product vanishes unguarded.
//      log_our   the OR in (2^(k1+k2) | comp) never meets a carry (comp <
//                2^(k1+k2)) while q < 2^k, i.e. |v| < 2^bits (every
//                quantized operand, every int8 at 8 bits; the int form's
//                wrapper refuses others below 8 bits), and comp =
//                min(q1, q2) << max(c1, c2) with
//                c(q) = LoD(q) + round_up(q) a function of one operand,
//                monotone in q.  A = (s1 mag1, s1 2^k1, q1, c1) bytes, one
//                word a k; B = (s2 2^k2, s2 q2, 0, 0) for the dp4a, (0, 0,
//                q2, c2) to compare, and the sign mask of b.  As unsigned
//                words (c, q) order like q, so min(A, B) holds q_small in
//                byte 2 and max(A, B) c_big in byte 3.
//  * The int16 table (LUT) and the uint16 magnitude table are copied into
//    each block's shared memory by cp.async with the first stage
//    (chip_smoke.py phase 3 times the LUT's cost a call: a K = 32 call
//    with the 8-bit table against a 4-bit one); the folded nibble table
//    (32,640 bytes at 8 bits) is built from the 4 KiB sub-tables in global
//    memory while the first stages land.
// Ragged M, N and K edges are masked: operands outside the matrix stage
// as 0, which every product form annihilates.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "cim_gemm.cuh"

namespace cim {

constexpr int CL_BN = 64;                    // output columns a block
constexpr int CL_STAGES = 4;                 // ring stages, float operands
constexpr int CL_INT_STAGES = 8;             // ... int8 operands
constexpr int CL_MAX_SPLITS = 8;             // the portable cluster size
constexpr int CL_SPLIT_K = 64;               // a K slice is a multiple
constexpr int CL_MAX_BITS = 8;

// K a stage: 64 for bf16 and int8 operands, 32 where either is f32 (so
// that the ring and the 8-bit table fit one block's shared memory at 64
// rows)
__host__ __device__ constexpr int cl_bk(int x_bytes, int w_bytes) {
  return x_bytes <= 2 && w_bytes <= 2 ? 64 : 32;
}

// ring stages: CL_INT_STAGES for int8 operands (the int forms), else
// CL_STAGES
__host__ __device__ constexpr int cl_stages(int x_bytes, int w_bytes) {
  return x_bytes == 1 && w_bytes == 1 ? CL_INT_STAGES : CL_STAGES;
}

// a ring slot: the raw x tile (RB x BK) and w tile (BK x CL_BN)
__host__ __device__ inline size_t cl_slot(int rb, int bk, int x_bytes,
                                          int w_bytes) {
  return static_cast<size_t>(rb) * bk * x_bytes +
         static_cast<size_t>(bk) * CL_BN * w_bytes;
}

// The product forms.  K_PER_WORD: k a staged x word holds; X_PLANES: the
// staged x's planes of words (the magnitude form keeps the signs in a
// second); THREADS: a block's, CL_BN columns x THREADS / CL_BN k groups
// (the LUT kernel holds one block an SM, its table filling the shared
// memory, so it runs 16 warps in one block where the log kernel runs two
// blocks of 8); MAX_ROWS: its largest row tile; table_bytes: the block's
// table in shared memory.
struct ClusterLutCore {
  static constexpr int KIND = 0;
  static constexpr int K_PER_WORD = 1;
  static constexpr int X_PLANES = 1;
  static constexpr int THREADS = 512;
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int MAX_ROWS = 64;
  __host__ __device__ static size_t table_bytes(int bits) {
    return LutCore::table_bytes(bits);
  }
};
template <bool COMP>
struct ClusterLogCore {
  static constexpr int KIND = COMP ? 2 : 1;
  static constexpr int K_PER_WORD = COMP ? 1 : 2;
  static constexpr int X_PLANES = 1;
  static constexpr int THREADS = 256;
  static constexpr int MIN_BLOCKS = COMP ? 1 : 2;
  static constexpr int MAX_ROWS = 64;
  __host__ __device__ static size_t table_bytes(int) { return 0; }
};
// the folded nibble table: 2 qmax + 1 signed rows of 2 hb int32 words.
// Two blocks of 8 warps an SM, rows in tiles of at most 16 (a prefill's
// 64 rows are four tiles): measured on an H100 against one block of 16
// warps and against 64-row tiles, whose 64 accumulators and three
// registers a weight element leave the product loop too little room
// (launch/cluster_sweep.py --only nibble, csrc/nibble_shapes.cu).
struct ClusterNibbleCore {
  static constexpr int KIND = 3;
  static constexpr int K_PER_WORD = 1;
  static constexpr int X_PLANES = 1;
  static constexpr int THREADS = 256;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int MAX_ROWS = 16;
  __host__ __device__ static size_t table_bytes(int bits) {
    return static_cast<size_t>((1 << bits) - 1) * (8u << (bits >> 1));
  }
};
// the uint16 magnitude table uf[|a|][|b|] (2^(b-1) x 2^(b-1) entries, 32
// KiB at 8 bits, padded to 16 bytes): two blocks of 8 warps an SM, rows in
// tiles of at most 16 (a staged weight element is two registers, its
// offset and its sign, which 64 accumulators would leave no room for)
struct ClusterMagLutCore {
  static constexpr int KIND = 4;
  static constexpr int K_PER_WORD = 1;
  static constexpr int X_PLANES = 2;
  static constexpr int THREADS = 256;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int MAX_ROWS = 16;
  __host__ __device__ static size_t table_bytes(int bits) {
    return al16((static_cast<size_t>(1) << (2 * (bits - 1))) * 2);
  }
};

// dynamic shared memory of one block: the table, the ring, the staged x
template <class Core>
__host__ __device__ inline size_t cl_smem_bytes(int rb, int bits,
                                                int x_bytes, int w_bytes) {
  const int bk = cl_bk(x_bytes, w_bytes);
  return al16(Core::table_bytes(bits)) +
         cl_stages(x_bytes, w_bytes) * cl_slot(rb, bk, x_bytes, w_bytes) +
         static_cast<size_t>(rb) * (bk / Core::K_PER_WORD) * 4 *
             Core::X_PLANES;
}

// The folded nibble table of the raveled sub-tables `subs` = [S_hh, S_hl,
// S_lh, S_ll] (global memory, 4 << bits int32) into `tab` (shared
// memory), row v = -qmax..qmax: sign(v) (Q_h[|v|][0..hb) | Q_l[|v|][0..hb))
// as uint32, the T threads of the block sharing the words
template <int T>
__device__ __forceinline__ void nibble_fold(uint32_t* tab,
                                            const unsigned char* subs,
                                            int bits, int tid) {
  const int h = bits >> 1, hb = 1 << h, sz = hb * hb;
  const int qmax = (1 << (bits - 1)) - 1;
  const int words = (2 * qmax + 1) << (h + 1);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(subs);
#pragma unroll 4
  for (int i = tid; i < words; i += T) {
    const int v = (i >> (h + 1)) - qmax;
    const int c = i & (2 * hb - 1);
    const int am = abs(v), col = c & (hb - 1);
    // Q_h: S_hh[am >> h] + S_lh[am & (hb-1)]; Q_l: S_hl[...] + S_ll[...]
    const int hi = (c < hb ? 0 : sz) + (am >> h) * hb + col;
    const int lo = (c < hb ? 2 * sz : 3 * sz) + (am & (hb - 1)) * hb + col;
    const uint32_t q = __ldg(s + hi) + __ldg(s + lo);
    tab[i] = static_cast<uint32_t>((v > 0) - (v < 0)) * q;
  }
}

struct ClArgs {
  const unsigned char* x;
  const unsigned char* w;
  const unsigned char* tab;
  const float* sx;
  const float* sw;
  void* out;            // Epi::Out: f32 (ScaleOut) or int32 (QuantIntOut,
                        // IntOut)
  int M, K, N, bits;
  int k_split;          // K a slice (blockIdx.z), a multiple of CL_SPLIT_K
  int n_tiles;          // column tiles; blockIdx.x = m tile * n_tiles + n
  int x_bytes, w_bytes; // 1: int8 (IntOut), 2: bf16, 4: f32
  int x_async, w_async; // rows start 16-byte aligned: cp.async
};

// --- staged forms --------------------------------------------------------------

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// (s mag, s 2^k) as two signed bytes, the first low: a log operand's
// x half of the dot product; (s 2^k, s q): its w half.  (0, 0) for 0.
__device__ __forceinline__ uint32_t log_x_bytes(int v, int bits) {
  const int4 d = decompose(v, bits);   // (q, k, sign, mag)
  return (static_cast<uint32_t>(d.z * d.w) & 0xffu) |
         ((static_cast<uint32_t>(d.z * (1 << d.y)) & 0xffu) << 8);
}
__device__ __forceinline__ uint32_t log_w_bytes(int v, int bits) {
  const int4 d = decompose(v, bits);
  return (static_cast<uint32_t>(d.z * (1 << d.y)) & 0xffu) |
         ((static_cast<uint32_t>(d.z * d.x) & 0xffu) << 8);
}

// log_our's compare word of an operand: c(q) in byte 3, q in byte 2, with
// c(q) = LoD(q) + round_up, round_up = 2q >= 3 * 2^LoD(q) (0 for q = 0)
__device__ __forceinline__ uint32_t comp_word(int v, int bits) {
  const uint32_t q = static_cast<uint32_t>(decompose(v, bits).x);
  uint32_t c = 0u;
  if (q != 0u) {
    const uint32_t m = lod(q, bits);
    c = m + ((q << 1) >= (3u << m) ? 1u : 0u);
  }
  return (c << 24) | (q << 16);
}

// raw element i of a tile in shared memory, widened to f32 (exact)
__device__ __forceinline__ float raw_at(const unsigned char* base, int i,
                                        int bytes) {
  if (bytes == 2)
    return __uint_as_float(
        static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(base)[i])
        << 16);
  return reinterpret_cast<const float*>(base)[i];
}

// operand i of a raw tile in shared memory as an integer: quantized
// against `scale` (QUANT: f32 or bf16 elements of `bytes`), or the int8 it
// is
template <bool QUANT>
__device__ __forceinline__ int cl_operand(const unsigned char* base, int i,
                                          int bytes, float scale, int qmax) {
  if constexpr (QUANT)
    return quantize(raw_at(base, i, bytes), scale, qmax);
  else
    return static_cast<int>(reinterpret_cast<const int8_t*>(base)[i]);
}

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// --- one ring stage ----------------------------------------------------------

// An R x C tile (C a power of two) of a row-major matrix (leading
// dimension ld, elements of `bytes`, 1, 2 or 4), rows r0.. below r_end and
// columns c0.. below c_end, into shared memory as R x C row-major;
// outside the matrix 0.  `async`: by cp.async 16 bytes at a time (rows
// 16-byte aligned), else by elements; `T` threads share the copy.
template <int R, int C, int T>
__device__ __forceinline__ void cl_copy_tile(unsigned char* dst,
                                             const unsigned char* src,
                                             int ld, int bytes, bool async,
                                             int r0, int r_end, int c0,
                                             int c_end, int tid) {
  if (async) {
    // log2 of the elements a chunk
    const int es = bytes == 1 ? 4 : bytes == 2 ? 3 : 2;
    const int rs = ilog2(C) - es;          // log2 of the chunks a row
    for (int i = tid; i < (R << rs); i += T) {
      const int r = i >> rs, c = (i & ((1 << rs) - 1)) << es;
      const int gr = r0 + r, gc = c0 + c;
      int n = 0;
      if (gr < r_end && gc < c_end) n = min(1 << es, c_end - gc) * bytes;
      const unsigned char* s =
          n ? src + (static_cast<size_t>(gr) * ld + gc) * bytes : src;
      cp_async16_n(dst + (r * C + c) * bytes, s, n);
    }
  } else {
    for (int i = tid; i < R * C; i += T) {
      const int r = i / C, c = i - r * C;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < r_end && gc < c_end;
      const size_t e = static_cast<size_t>(gr) * ld + gc;
      if (bytes == 1) {
        dst[i] = ok ? src[e] : static_cast<unsigned char>(0);
      } else if (bytes == 2) {
        reinterpret_cast<uint16_t*>(dst)[i] =
            ok ? reinterpret_cast<const uint16_t*>(src)[e] : uint16_t{0};
      } else {
        reinterpret_cast<uint32_t*>(dst)[i] =
            ok ? reinterpret_cast<const uint32_t*>(src)[e] : 0u;
      }
    }
  }
}

template <int RB, int BK, int T>
__device__ __forceinline__ void cl_load_stage(unsigned char* slot,
                                              const ClArgs& a, int m0,
                                              int n0, int k0, int kend,
                                              int tid) {
  cl_copy_tile<RB, BK, T>(slot, a.x, a.K, a.x_bytes, a.x_async != 0, m0,
                          a.M, k0, kend, tid);
  cl_copy_tile<BK, CL_BN, T>(slot + RB * BK * a.x_bytes, a.w, a.N,
                             a.w_bytes, a.w_async != 0, k0, kend, n0, a.N,
                             tid);
}

// the stage's x tile, quantized (QUANT) or int8, into its staged words
template <class Core, int RB, int BK, bool QUANT>
__device__ __forceinline__ void cl_stage_x(uint32_t* sA,
                                           const unsigned char* raw,
                                           const ClArgs& a, float sx,
                                           int qmax, int m0, int k0,
                                           int kend, int tid) {
  constexpr int WORDS = BK / Core::K_PER_WORD;   // a row
  auto q = [&](int r, int kk) {
    return (m0 + r < a.M && k0 + kk < kend)
               ? cl_operand<QUANT>(raw, r * BK + kk, a.x_bytes, sx, qmax)
               : 0;
  };
  for (int i = tid; i < RB * WORDS; i += Core::THREADS) {
    const int r = i / WORDS, j = i - r * WORDS;
    uint32_t word;
    if constexpr (Core::KIND == 0) {
      word = static_cast<uint32_t>((q(r, j) + (1 << (a.bits - 1)))
                                   << a.bits) * 2u;
    } else if constexpr (Core::KIND == 1) {
      word = log_x_bytes(q(r, 2 * j), a.bits) |
             (log_x_bytes(q(r, 2 * j + 1), a.bits) << 16);
    } else if constexpr (Core::KIND == 3) {
      // the byte offset of its signed row in the folded table; an int8
      // operand saturates to +-qmax (a quantized one is inside already)
      int v = q(r, j);
      if constexpr (!QUANT) v = max(-qmax, min(v, qmax));
      word = static_cast<uint32_t>(v + qmax) << ((a.bits >> 1) + 3);
    } else if constexpr (Core::KIND == 4) {
      // the byte offset of row min(|a|, qmax); sign(a) in the sign plane
      const int v = q(r, j);
      word = static_cast<uint32_t>(min(abs(v), qmax)) << a.bits;
      sA[RB * WORDS + i] = static_cast<uint32_t>((v > 0) - (v < 0));
    } else {
      const int v = q(r, j);
      word = log_x_bytes(v, a.bits) | comp_word(v, a.bits);
    }
    sA[i] = word;
  }
}

// --- the kernel ----------------------------------------------------------------

// grid (m tiles x n tiles, 1, K slices), clusters of (1, 1, gridDim.z):
// the K slices of one tile are one cluster; Epi (cim_gemm.cuh: ScaleOut
// or QuantIntOut for float operands, IntOut for int8) writes each summed
// element
template <class Core, int RB, int BK, class Epi>
__global__ void __launch_bounds__((Core::THREADS), (Core::MIN_BLOCKS))
cluster_gemm_kernel(const ClArgs a) {
  static_assert(!Epi::SQ, "one sum");
  static_assert(RB % 4 == 0, "rows come in groups of 4");
  static_assert(RB <= Core::MAX_ROWS, "a row tile of the core");
  constexpr bool QUANT = Epi::QUANT;
  constexpr int STAGES = QUANT ? CL_STAGES : CL_INT_STAGES;
  constexpr int KIND = Core::KIND;
  constexpr int T = Core::THREADS;
  constexpr int KG = T / CL_BN;                  // k groups
  constexpr int KPT = BK / KG;                   // k a thread a stage
  constexpr int WORDS = BK / Core::K_PER_WORD;   // staged x words a row
  constexpr int TW = KPT / Core::K_PER_WORD;     // ... of a thread
  static_assert(TW % 4 == 0, "a thread reads its x words as uint4");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tn = tid % CL_BN, tg = tid / CL_BN;
  const size_t tbytes = al16(Core::table_bytes(a.bits));
  const size_t slot = cl_slot(RB, BK, a.x_bytes, a.w_bytes);
  const unsigned char* s_tab = smem;
  unsigned char* ring = smem + tbytes;
  uint32_t* sA = reinterpret_cast<uint32_t*>(ring + STAGES * slot);

  const int mt = blockIdx.x / a.n_tiles;
  const int m0 = mt * RB, n0 = (blockIdx.x - mt * a.n_tiles) * CL_BN;
  const int kbeg = blockIdx.z * a.k_split;
  const int kend = min(a.K, kbeg + a.k_split);
  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const int qmax = (1 << (a.bits - 1)) - 1;
  const int col = n0 + tn;
  float sx = 0.f, swc = 1.f;  // the int forms read no scale
  if constexpr (QUANT) {
    sx = *a.sx;
    if (col < a.N) swc = a.sw[col];
  }
  const int rows = min(RB, a.M - m0);

  if constexpr (KIND == 0 || KIND == 4) {  // the table rides with stage 0
    const int n16 = static_cast<int>(tbytes / 16);
    for (int i = tid; i < n16; i += T)
      cp_async16(smem + 16 * i, a.tab + 16 * i, true);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      cl_load_stage<RB, BK, T>(ring + s * slot, a, m0, n0, kbeg + s * BK,
                               kend, tid);
    cp_async_commit();
  }
  // the folded nibble table, visible after the first stage's barrier
  if constexpr (KIND == 3)
    nibble_fold<T>(reinterpret_cast<uint32_t*>(smem), a.tab, a.bits, tid);

  uint32_t acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0u;

#pragma unroll 1
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t has landed; stage t-1 is consumed
    {
      const int tl = t + STAGES - 1;
      if (tl < nk)
        cl_load_stage<RB, BK, T>(ring + (tl % STAGES) * slot, a, m0, n0,
                                 kbeg + tl * BK, kend, tid);
      cp_async_commit();
    }
    const unsigned char* cur = ring + (t % STAGES) * slot;
    const int k0 = kbeg + t * BK;
    cl_stage_x<Core, RB, BK, QUANT>(sA, cur, a, sx, qmax, m0, k0, kend, tid);

    // this thread's column, k = tg * KPT + j, quantized (or int8) into
    // registers
    const unsigned char* raw_w = cur + RB * BK * a.x_bytes;
    int qb[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = tg * KPT + j;
      qb[j] = (k0 + kk < kend && col < a.N)
                  ? cl_operand<QUANT>(raw_w, kk * CL_BN + tn, a.w_bytes,
                                      swc, qmax)
                  : 0;
    }
    // ... staged in the product form's registers
    constexpr int TW3 = KIND >= 2 ? TW : 1;
    uint32_t b0[TW], b1[TW3], b2[TW3];
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      if constexpr (KIND == 0) {
        b0[j] = static_cast<uint32_t>(qb[j] + qmax + 1) * 2u;
      } else if constexpr (KIND == 1) {
        b0[j] = log_w_bytes(qb[2 * j], a.bits) |
                (log_w_bytes(qb[2 * j + 1], a.bits) << 16);
      } else if constexpr (KIND == 3) {
        // the byte offsets of columns bh and hb + bl, and sign(b); an
        // int8 magnitude saturates at qmax
        const int h = a.bits >> 1;
        int mag = abs(qb[j]);
        if constexpr (!QUANT) mag = min(mag, qmax);
        b0[j] = static_cast<uint32_t>(mag >> h) * 4u;
        b1[j] = static_cast<uint32_t>((1 << h) + (mag & ((1 << h) - 1))) *
                4u;
        b2[j] = static_cast<uint32_t>((qb[j] > 0) - (qb[j] < 0));
      } else if constexpr (KIND == 4) {
        // the byte offset of column min(|b|, qmax), and sign(b)
        b0[j] = static_cast<uint32_t>(min(abs(qb[j]), qmax)) * 2u;
        b1[j] = static_cast<uint32_t>((qb[j] > 0) - (qb[j] < 0));
      } else {
        b0[j] = log_w_bytes(qb[j], a.bits);
        b1[j] = comp_word(qb[j], a.bits);
        b2[j] = qb[j] < 0 ? ~0u : 0u;
      }
    }
    __syncthreads();  // the staged x is visible

#pragma unroll
    for (int r0 = 0; r0 < RB; r0 += 4) {
      if (RB == 4 || r0 < rows) {  // uniform across the block
#pragma unroll
        for (int r = r0; r < r0 + 4; ++r) {
          const uint4* ap =
              reinterpret_cast<const uint4*>(sA + r * WORDS + tg * TW);
          uint32_t aw[TW], sa[TW];
#pragma unroll
          for (int c = 0; c < TW / 4; ++c) {
            const uint4 u = ap[c];
            aw[4 * c] = u.x;
            aw[4 * c + 1] = u.y;
            aw[4 * c + 2] = u.z;
            aw[4 * c + 3] = u.w;
            if constexpr (Core::X_PLANES == 2) {  // a's signs
              const uint4 v = ap[RB * WORDS / 4 + c];
              sa[4 * c] = v.x;
              sa[4 * c + 1] = v.y;
              sa[4 * c + 2] = v.z;
              sa[4 * c + 3] = v.w;
            }
          }
          uint32_t s = acc[r];
#pragma unroll
          for (int j = 0; j < TW; ++j) {
            if constexpr (KIND == 0) {
              // one int16 gather at table + row offset + column offset
              s += static_cast<uint32_t>(static_cast<int32_t>(
                  *reinterpret_cast<const int16_t*>(s_tab + aw[j] + b0[j])));
            } else if constexpr (KIND == 1) {
              // two k: the signed bytes' dot product
              s = static_cast<uint32_t>(__dp4a(static_cast<int>(aw[j]),
                                               static_cast<int>(b0[j]),
                                               static_cast<int>(s)));
            } else if constexpr (KIND == 3) {
              // two gathers in a's signed row, signed by b
              const uint32_t g =
                  *reinterpret_cast<const uint32_t*>(s_tab + aw[j] + b0[j]) +
                  *reinterpret_cast<const uint32_t*>(s_tab + aw[j] + b1[j]);
              s += g * b2[j];
            } else if constexpr (KIND == 4) {
              // sign(a) sign(b) uf[row of |a| + column of |b|]
              const uint32_t mag = *reinterpret_cast<const uint16_t*>(
                  s_tab + aw[j] + b0[j]);
              s += mag * (sa[j] * b1[j]);
            } else {
              // the mitchell part, signed
              s = static_cast<uint32_t>(__dp4a(static_cast<int>(aw[j]),
                                               static_cast<int>(b0[j]),
                                               static_cast<int>(s)));
              // comp = q_small << c_big, signed by sign(a) sign(b)
              const uint32_t mx = max(aw[j], b1[j]), mn = min(aw[j], b1[j]);
              const uint32_t comp = prmt(mn, 0u, 0x4442u) << (mx >> 24);
              const uint32_t sg = (prmt(aw[j], 0u, 0x8888u) ^ b2[j]) | 1u;
              s += comp * sg;
            }
          }
          acc[r] = s;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring

  // the k groups' sums into one partial tile (RB x CL_BN, in the ring)
  uint32_t* part = reinterpret_cast<uint32_t*>(ring);
#pragma unroll 1
  for (int g = 0; g < KG; ++g) {
    if (tg == g) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        uint32_t* p = part + r * CL_BN + tn;
        *p = g == 0 ? acc[r] : *p + acc[r];
      }
    }
    __syncthreads();
  }

  // the cluster's partials summed in rank order, each block a share of
  // the tile's rows inside M, then the epilogue
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(gridDim.z);
  const int rank = static_cast<int>(cluster.block_rank());
  const int elems = rows * CL_BN;
  const int per = (elems + splits - 1) / splits;
  const int e1 = min(elems, (rank + 1) * per);
  const uint32_t* peer[CL_MAX_SPLITS];
#pragma unroll
  for (int q = 0; q < CL_MAX_SPLITS; ++q)
    peer[q] = cluster.map_shared_rank(part, q < splits ? q : 0);
  for (int e = rank * per + tid; e < e1; e += T) {
    uint32_t s = 0u;
#pragma unroll
    for (int q = 0; q < CL_MAX_SPLITS; ++q)
      if (q < splits) s += peer[q][e];
    const int r = e / CL_BN, c = n0 + (e - r * CL_BN);
    if (c < a.N)
      Epi{}.store(static_cast<typename Epi::Out*>(a.out),
                  static_cast<size_t>(m0 + r) * a.N + c, c, s, 0.f, sx,
                  a.sw);
  }
  cluster.sync();  // no block leaves while a peer reads its partials
}

// Launches `kern` over `tiles` x `splits` blocks of `threads`, the K
// slices of a tile one cluster of (1, 1, splits), with `smem` bytes of
// dynamic shared memory; returns the CUDA error code.  Shared by every
// split-K cluster kernel (this one and surrogate_cluster.cuh's).
template <typename Arg>
inline int cl_launch_ex(void (*kern)(Arg), const Arg& a, size_t smem,
                        int threads, int tiles, int splits,
                        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), 1,
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

template <class Core, class Epi, int RB, int BK>
inline int cl_launch(const ClArgs& a, int tiles, int splits,
                     cudaStream_t stream) {
  return cl_launch_ex(cluster_gemm_kernel<Core, RB, BK, Epi>, a,
                      cl_smem_bytes<Core>(RB, a.bits, a.x_bytes, a.w_bytes),
                      Core::THREADS, tiles, splits, stream);
}

template <class Core, class Epi, int BK>
inline int cl_launch_rows(const ClArgs& a, int rb, int tiles, int splits,
                          cudaStream_t stream) {
  switch (rb) {
    case 4:
      return cl_launch<Core, Epi, 4, BK>(a, tiles, splits, stream);
    case 16:
      return cl_launch<Core, Epi, 16, BK>(a, tiles, splits, stream);
    default:
      if constexpr (Core::MAX_ROWS >= 64)
        return cl_launch<Core, Epi, 64, BK>(a, tiles, splits, stream);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The clusters of `splits` blocks of `threads` and `smem` bytes of
// dynamic shared memory of the kernel `kern` that the current device holds
// at once (cudaOccupancyMaxActiveClusters: a cluster's blocks share one
// GPC, so this is not the SM count over the cluster size), into *out;
// returns the CUDA error code.
inline int cl_capacity_ex(const void* kern, size_t smem, int threads,
                          int splits, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, static_cast<unsigned>(splits));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kern, &cfg));
}

// The instantiation for `rb` rows (4, 16 or 64, at most Core::MAX_ROWS)
// and BK k a stage, or nullptr
template <class Core, class Epi, int BK>
inline const void* cl_kernel(int rb) {
  switch (rb) {
    case 4:
      return reinterpret_cast<const void*>(
          cluster_gemm_kernel<Core, 4, BK, Epi>);
    case 16:
      return reinterpret_cast<const void*>(
          cluster_gemm_kernel<Core, 16, BK, Epi>);
    case 64:
      if constexpr (Core::MAX_ROWS >= 64)
        return reinterpret_cast<const void*>(
            cluster_gemm_kernel<Core, 64, BK, Epi>);
      return nullptr;
    default:
      return nullptr;
  }
}

// The clusters of `splits` blocks of the instantiation for `rb` rows,
// operands of `xb` and `wb` bytes (1: int8, the int forms; 2: bf16; 4:
// f32) and the epilogue Epi that the current device holds at once, into
// *out; returns the CUDA error code.
template <class Core, class Epi>
int cl_capacity(int rb, int bits, int xb, int wb, int splits, int* out) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (bits < 2 || bits > CL_MAX_BITS || splits < 1 ||
      splits > CL_MAX_SPLITS || ((xb == 1) != (wb == 1)) ||
      ((xb == 1) == Epi::QUANT))
    return bad;
  const void* kern;
  if constexpr (Epi::QUANT)
    kern = cl_bk(xb, wb) == 64 ? cl_kernel<Core, Epi, 64>(rb)
                               : cl_kernel<Core, Epi, 32>(rb);
  else
    kern = cl_kernel<Core, Epi, 64>(rb);
  if (kern == nullptr) return bad;
  return cl_capacity_ex(kern, cl_smem_bytes<Core>(rb, bits, xb, wb),
                        Core::THREADS, splits, out);
}

// cl_capacity of a fused or partial form's instantiation (x_bf16, w_bf16:
// the operand types, bf16 or f32); cluster_plan reads it to count a
// launch's waves
template <class Core, class Epi>
int cluster_capacity(int rb, int bits, int x_bf16, int w_bf16, int splits,
                     int* out) {
  return cl_capacity<Core, Epi>(rb, bits, x_bf16 ? 2 : 4, w_bf16 ? 2 : 4,
                                splits, out);
}

// cl_capacity of an int form's instantiation (int8 operands, IntOut)
template <class Core>
int cluster_capacity_int8(int rb, int bits, int splits, int* out) {
  return cl_capacity<Core, IntOut>(rb, bits, 1, 1, splits, out);
}

// A launch plan's K split as every split-K cluster kernel takes it:
// `splits` (1..CL_MAX_SPLITS) slices of `k_split` (a multiple of
// CL_SPLIT_K) that cover K, none empty
inline bool cl_split_ok(int K, int splits, int k_split) {
  if (splits < 1 || splits > CL_MAX_SPLITS || k_split <= 0 ||
      k_split % CL_SPLIT_K != 0)
    return false;
  return static_cast<int64_t>(splits) * k_split >= K &&
         (splits == 1 || static_cast<int64_t>(splits - 1) * k_split < K);
}

// The arguments of a split-K cluster kernel over x (M,K) and w (K,N) of
// `x_bytes` and `w_bytes` an element (1: int8, 2: bf16, 4: f32): `rb`
// rows and CL_BN columns a tile, K slices of `k_split`; false where the
// tiles overflow the grid
inline bool cl_make_args(ClArgs& a, const void* x, int x_bytes,
                         const void* w, int w_bytes, const void* tab,
                         const void* sx, const void* sw, void* out, int M,
                         int K, int N, int bits, int rb, int k_split,
                         int* tiles) {
  const int64_t n_tiles = (N + CL_BN - 1) / CL_BN;
  const int64_t t = (M + static_cast<int64_t>(rb) - 1) / rb * n_tiles;
  if (t > INT32_MAX) return false;
  *tiles = static_cast<int>(t);
  a.x = static_cast<const unsigned char*>(x);
  a.w = static_cast<const unsigned char*>(w);
  a.tab = static_cast<const unsigned char*>(tab);
  a.sx = static_cast<const float*>(sx);
  a.sw = static_cast<const float*>(sw);
  a.out = out;
  a.M = M;
  a.K = K;
  a.N = N;
  a.bits = bits;
  a.k_split = k_split;
  a.n_tiles = static_cast<int>(n_tiles);
  a.x_bytes = x_bytes;
  a.w_bytes = w_bytes;
  a.x_async = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
              static_cast<int64_t>(K) * a.x_bytes % 16 == 0;
  a.w_async = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
              static_cast<int64_t>(N) * a.w_bytes % 16 == 0;
  return true;
}

// Whether the cluster kernels take the launch plan kernels/approx_matmul.py
// cluster_plan chose: `rb` rows a block (4, 16 or 64, at most
// Core::MAX_ROWS), K in `splits` slices (1..8) of `k_split` (a multiple of
// CL_SPLIT_K; the slices cover K and none is empty), for a shape and bits
// they take
template <class Core>
inline bool cl_plan_ok(int M, int K, int N, int bits, int rb, int splits,
                       int k_split) {
  return M >= 0 && K >= 0 && N >= 0 && bits >= 2 && bits <= CL_MAX_BITS &&
         (rb == 4 || rb == 16 || rb == 64) && rb <= Core::MAX_ROWS &&
         cl_split_ok(K, splits, k_split);
}

// f32 or bf16 (M,K) x f32 or bf16 (K,N) -> (M,N) through Epi (f32 for
// ScaleOut, the raw int32 sum for QuantIntOut), the launch plan `rb`,
// `splits`, `k_split` (cl_plan_ok).  Returns the CUDA error code; a plan
// the kernel does not take is refused (cudaErrorInvalidValue).
template <class Core, class Epi>
int cluster_gemm(const void* x, int x_bf16, const void* w, int w_bf16,
                 const void* tab, const void* sx, const void* sw, void* out,
                 int M, int K, int N, int bits, int rb, int splits,
                 int k_split, void* stream) {
  static_assert(Epi::QUANT, "float operands");
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (!cl_plan_ok<Core>(M, K, N, bits, rb, splits, k_split)) return bad;
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  ClArgs a;
  int t = 0;
  if (!cl_make_args(a, x, x_bf16 ? 2 : 4, w, w_bf16 ? 2 : 4, tab, sx, sw,
                    out, M, K, N, bits, rb, k_split, &t))
    return bad;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cl_bk(a.x_bytes, a.w_bytes) == 64)
    return cl_launch_rows<Core, Epi, 64>(a, rb, t, splits, st);
  return cl_launch_rows<Core, Epi, 32>(a, rb, t, splits, st);
}

// int8 (M,K) x int8 (K,N) -> the int32 (M,N) sum (IntOut: no scale is
// read), the launch plan `rb`, `splits`, `k_split` (cl_plan_ok); `tab`
// the core's table (nullptr for the log core).  Returns the CUDA error
// code; a plan the kernel does not take is refused.
template <class Core>
int cluster_gemm_int8(const void* x, const void* w, const void* tab,
                      void* out, int M, int K, int N, int bits, int rb,
                      int splits, int k_split, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (!cl_plan_ok<Core>(M, K, N, bits, rb, splits, k_split)) return bad;
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  ClArgs a;
  int t = 0;
  if (!cl_make_args(a, x, 1, w, 1, tab, nullptr, nullptr, out, M, K, N,
                    bits, rb, k_split, &t))
    return bad;
  return cl_launch_rows<Core, IntOut, 64>(a, rb, t, splits,
                                          static_cast<cudaStream_t>(stream));
}

}  // namespace cim
