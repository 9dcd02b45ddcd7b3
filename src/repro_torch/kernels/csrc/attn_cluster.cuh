// attn_cluster.cuh - attn_fused, the CiM flash attention, and the two
// stages of its materialized oracle, for NVIDIA Hopper (sm_90a): the GQA
// heads of one kv head in one block, the kv blocks of a query tile split
// over a thread-block cluster, the online softmax's combine run in kv
// order through distributed shared memory.  Included by attn_gemm.cu,
// whose attn_fused, attn_scores and attn_pv entries launch it (MODE
// AC_FUSED, AC_SCORES, AC_PV).
//
// Replaces, for operands of at most 8 bits, the TPU kernels
//   src/repro/kernels/attn_gemm.py:381 attn_fused -> :402 -> _attn_kernel
//     :245 (all four datapaths)
//   src/repro/kernels/attn_gemm.py:423 attn_materialized -> :447 ->
//     _scores_kernel :282 (AC_SCORES) and -> :461 -> _pv_kernel :294
//     (AC_PV)
// Log operands of 9..12 bits keep attn_gemm.cu's template (entries
// attn_fused_wide, attn_scores_wide, attn_pv_wide), by kernels/
// attn_gemm.py fused_route and materialized_route (functions of the bits,
// tested on the CPU); the template's oracle pair also stays callable at 8
// bits, forced, as this kernel's independent witness.
//
// What it computes is attn_gemm.cu's fused kernel bit for bit (the
// reference's _score_step / _online_step, attn_gemm.py:209-237): q/k/v
// quantized by __fdiv_rn + rintf and clipped to +-qmax; per kv block of
// bk keys s = f32(sum prod(qi, ki)) * ((sq_s * sk_s) * sm_scale), masked
// to NEG_INF; m' = max(m, max_j s), corr = exp(m - m'), p = mask ?
// exp(s - m') : 0, l' = l corr + sum_j p (lane-strided over j, then the
// xor butterfly), pq = rint(p qmax), acc' = acc corr + f32(sum prod(pq,
// vi)) (sv_s / qmax); out = acc / max(l, 1e-30).  Every float operation
// is an _rn intrinsic in that order; integer sums wrap at 32 bits.
//
// Why the split is exact: bk is part of the numerics (pq is taken against
// the running max at each kv block), so a flash-decoding merge of
// per-split softmaxes would move pq.  But only two things are serial:
// the running max and the float combine.  A block's scores depend on q
// and k alone; given the prefix maxima m(kb), its p, pq, sum p and integer
// PV depend on nothing else; only acc = acc corr + pvf and l = l corr +
// sum p must run in kv order, and they hold no products.  A kv block in
// which no (query, key) pair of the tile is admitted leaves every row's
// m, l and acc as they were (corr = 1, p = 0; acc is never -0), so it is
// skipped.  (tests/test_torch_attn_plan.py models this order in plain
// torch against attn_reference.)
//
// What bounds it on an H100: at prefill the integer products, 2 B H Sq
// Skv D over the admitted pairs (a shared-memory gather each on the LUT
// path, 132 SMs x 32 words a clock; the log product's instructions,
// which phase 2 of chip_smoke.py reads from this kernel's SASS); at
// decode K and V, read once (3.35 TB/s).  Each oracle mode takes one of
// the two dots; AC_SCORES also writes the whole score tensor (16.8 MB
// at qwen3's 4 x 256 prefill: about 5 us), AC_PV reads its admitted
// entries.
//
// Design (the template before it ran one block per (q tile, q head) with
// one-row tiles at decode, quantized K/V once per q head, left half its
// threads idle, stored K transposed with a 32-way bank conflict,
// decomposed both log operands in every product, loaded synchronously
// and computed the blocks the mask removes):
//  * A block owns one (batch, kv head, q tile): all `group` q heads of
//    that kv head over bq query rows, R = group bq rows (row i = g bq +
//    qi), each with its own scale.  So each K/V element is loaded and
//    quantized once per q tile.  bq is free (core/autotune.py).
//  * The kv blocks of a tile split in contiguous ranges of `per` blocks
//    over a cluster of `splits` <= 8 blocks; a range that does not fit
//    shared memory runs as chunks of splits x per blocks, rank r taking
//    blocks [chunk splits per + r per, + per).  Per chunk:
//      Phase A  each block quantizes its live blocks' K, takes the
//               integer QK^T of every row, keeps the masked f32 score
//               tiles and each row's max per kv block (NEG_INF for a
//               dead block);
//      barrier  then m(kb) = fmaxf in kv order from the running max:
//               the earlier ranks' row maxima read through distributed
//               shared memory;
//      Phase B  per live block: corr = exp(m(kb-1) - m(kb)), p, pq (staged
//               in the product form), sum p by one warp a row as above,
//               V quantized, the integer PV, pvf = f32(pv) (sv_s / qmax);
//      barrier  then Phase C, the in-order combine: D's columns are
//               shared out over the cluster, each block folding its
//               columns' acc over every rank's pvf in kv order (rank,
//               then block), and every block folding l for all rows.  A
//               relay (rank r taking acc from rank r-1) would chain the
//               ranks one after another; shared columns read the same
//               bytes with no chain.
//    After the last chunk each block writes its columns of the output;
//    a last cluster barrier keeps every block until its peers are done
//    reading it.
//  * Dead kv blocks are decided from the positions (kval, causal,
//    window) before their K/V are fetched, and skipped in all three
//    phases.
//  * A block is 512 threads (16 warps; registers cap it at one block an
//    SM), all of them in every product: a tile GEMM out[i][n] = sum_k
//    A[i][k] B[k][n] gives each thread one column n and AC_RT = 4 rows
//    over all of k (padded to 16 with zero operands): 16 B operands at a
//    time in registers in the product form, reused for the 4 rows, each
//    row's A words read by 16-byte loads that the warp's columns share
//    (one address, a broadcast), 4 independent 32-bit sums and no
//    shuffle; where the tiles are fewer than the threads (a decode
//    step), threads share a tile's k and meet by shared-memory atomics.
//    QK^T: A = q, B = K (a column a key); PV: A = pq, B = V^T
//    (a column a d).  K and V^T are staged once per kv block in the B
//    form, columns padded to an odd number of 16-byte units; K is
//    written a key row a warp, V^T from the raw tile a few columns x
//    several key words a warp, so neither store meets the template's
//    32-way conflict.  (A first form of 256 threads split k over lanes
//    and summed by xor shuffles: bitwise the same, latency-bound on the
//    shuffles with one 185-register block an SM, 1.1x the template's
//    time at the LUT prefill.)
//  * The product forms are cluster_gemm.cuh's staged forms, each operand
//    staged once (pq too: it lies in [0, qmax]): LUT byte offsets into
//    the int16 table (one gather a product; the B side as int8, its
//    offset taken in registers), mitchell as signed byte pairs (one
//    dp4a, two products), log_our's byte pair and compare word; mxu as
//    int8 (one dp4a, four products); nibble keeps the template's
//    sub-table product (cim_gemm.cuh NibbleCore).
//  * Copies in flight: K, then V, of the block's live kv blocks arrive in
//    `rk`-key tiles through a ring of AC_STAGES stages filled by
//    cp.async (rows of D f32; by elements where D % 4 != 0), each tile
//    quantized on arrival while the next ones land, across the cluster
//    barrier too.  The table rides with the first stage.  No TMA
//    multicast of the table: a cluster holds at most 8 of the 132 SMs'
//    copies, the table is 128 KiB read once a block from L2, and the
//    ring's cp.async copies would still need their own barriers.
//  * kernels/attn_gemm.py attn_cluster_plan picks bq, splits, per and rk
//    from the shape, from attn_cluster_smem (this file's ac_geometry) and
//    from the device's capacity for each size (attn_cluster_capacity,
//    cudaOccupancyMaxActiveClusters); the entry refuses a plan it does
//    not take and a shared-memory total not its own, and a refused
//    launch raises: nothing falls back.
//
// The oracle's stages are the same body in two other modes, so that the
// fused and the materialized forms differ only in the score tensor's
// round trip through device memory (the template's pair, one block a (q
// tile, q head), K/V quantized group times, products by scalar loads, no
// dead-block skip, took 50x the fused kernel's time a stage):
//  * AC_SCORES is Phase A with a store.  It combines nothing, so its kv
//    ranges are no cluster's ranks but lone blocks on the grid (up to
//    AC_MAX_SCORE_SPLITS a tile, to fill 132 SMs at decode); each block
//    stages q once, K arrives through the ring and is quantized once per
//    q tile, and each product sum is written straight to the (B, H, Sq,
//    skvp) score tensor (a warp's columns are adjacent keys).  A dead
//    block's scores are written NEG_INF with no K fetched and no product.
//  * AC_PV is the cluster kernel with Phase A replaced by a load: each
//    live block's score tile comes from device memory by cp.async into
//    its place (one copy group ahead of the ring, which carries V alone),
//    each row's max is taken from it by Phase A's warp reduction, and the
//    prefix maxima, Phase B and Phase C run as in AC_FUSED.  Its input is
//    AC_SCORES' output: a dead block's entries are all NEG_INF there, so
//    skipping it unread leaves the running max, l and acc as the
//    template's pass over it does.  The mask is recomputed from the
//    positions, never read from the scores.
//  Both compute the template's values in its float order, so AC_SCORES
//  is bitwise attn_scores_plain and AC_PV over its scores bitwise
//  AC_FUSED.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "cluster_gemm.cuh"

namespace attn {

using cim::al16;

constexpr int AC_THREADS = 512;
constexpr int AC_WARPS = AC_THREADS / 32;
constexpr int AC_STAGES = 4;                    // the K/V ring
constexpr int AC_MAX_SPLITS = cim::CL_MAX_SPLITS;
// AC_SCORES spreads a tile's kv blocks over the grid, not a cluster
constexpr int AC_MAX_SCORE_SPLITS = 64;
constexpr int AC_MAX_BITS = cim::CL_MAX_BITS;
constexpr float AC_NEG_INF = -1e30f;
constexpr float AC_EPS_L = 1e-30f;

// attn_gemm.cu's path ids
enum { AC_MXU = 0, AC_LUT = 1, AC_NIBBLE = 2, AC_LOG = 3 };
// what one launch computes: attn_fused; attn_scores (Phase A, the scores
// stored); attn_pv (Phase A a load of the stored scores, then B and C)
enum { AC_FUSED = 0, AC_SCORES = 1, AC_PV = 2 };

// operands a staged A word holds, by path (log: mitchell 2, log_our 1)
__host__ __device__ inline int ac_apw(int path, int comp) {
  if (path == AC_LUT) return 1;
  if (path == AC_LOG) return comp ? 1 : 2;
  return 4;
}

// operands a staged B word holds: int8 (lut, mxu, nibble), mitchell's
// signed byte pair, log_our's word (the byte pair and the compare bytes)
__host__ __device__ inline int ac_bpw(int path, int comp) {
  if (path == AC_LOG) return comp ? 1 : 2;
  return 4;
}

__host__ __device__ inline size_t ac_table_bytes(int path, int bits) {
  if (path == AC_LUT) return cim::LutCore::table_bytes(bits);
  if (path == AC_NIBBLE) return cim::NibbleCore::table_bytes(bits);
  return 0;
}

// The block's geometry and its dynamic shared memory (byte offsets) in
// `mode`: a region the mode does not use takes no bytes.
// kernels/attn_gemm.py attn_cluster_smem computes the same total.
struct AcGeom {
  int rows;        // R = group bq
  int kpq;         // D padded to 16: QK^T's contraction
  int bkp;         // bk padded to 16: PV's contraction, QK^T's columns
  int rsq, rsp;    // K and V^T columns (keys, d), 16-byte units (odd)
  int aqw, apw;    // words a staged q row, a staged pq row
  int sw;          // f32 a row of a kv block's scores, then of its pvf
  int drs;         // f32 a raw ring row
  size_t tab, ring, bt, a, s, acc, rmax, corr, sp, mprev, mnew, mrun, l,
      rscale, plive, live, lidx, kpos, kval, qpos, total;
};

__host__ __device__ inline AcGeom ac_geometry(int path, int comp, int bits,
                                              int group, int bq, int per,
                                              int bk, int d, int rk,
                                              int mode) {
  AcGeom g;
  const int apw = ac_apw(path, comp), bpw = ac_bpw(path, comp);
  const bool qk = mode != AC_PV, pv = mode != AC_SCORES;
  g.rows = group * bq;
  g.kpq = (d + 15) / 16 * 16;
  g.bkp = (bk + 15) / 16 * 16;
  g.rsq = (g.kpq / bpw / 4) | 1;
  g.rsp = (g.bkp / bpw / 4) | 1;
  g.aqw = g.kpq / apw;
  g.apw = g.bkp / apw;
  g.sw = g.bkp > d ? g.bkp : d;
  g.drs = (d + 3) / 4 * 4 + 4;
  const size_t R = g.rows, C = per, BKP = g.bkp;
  const size_t btq = qk ? static_cast<size_t>(g.bkp) * g.rsq * 16 : 0;
  const size_t btp = pv ? static_cast<size_t>(d) * g.rsp * 16 : 0;
  const size_t aq = qk ? g.aqw : 0, ap = pv ? g.apw : 0;
  const size_t cr = pv ? C * R * 4 : 0;   // a float per row per kv block
  size_t o = 0;
  g.tab = o;    o += al16(ac_table_bytes(path, bits));
  g.ring = o;   o += al16(static_cast<size_t>(AC_STAGES) * rk * g.drs * 4);
  g.bt = o;     o += al16(btq > btp ? btq : btp);
  // q rows (Phase A), then pq rows (Phase B): q is staged every chunk
  g.a = o;      o += al16(R * (aq > ap ? aq : ap) * 4);
  // a kv block's f32 scores (Phase A or loaded), then its pvf (from its PV
  // on); AC_SCORES: one block's stage for threads that share k
  g.s = o;      o += al16(pv ? C * R * g.sw * 4 : R * BKP * 4);
  g.acc = o;    o += al16(pv ? R * d * 4 : 0);
  g.rmax = o;   o += al16(cr);
  g.corr = o;   o += al16(cr);
  g.sp = o;     o += al16(cr);
  g.mprev = o;  o += al16(cr);
  g.mnew = o;   o += al16(cr);
  g.mrun = o;   o += al16(pv ? R * 4 : 0);
  g.l = o;      o += al16(pv ? R * 4 : 0);
  g.rscale = o; o += al16(qk ? R * 4 : 0);
  g.plive = o;  o += al16(pv ? C * 4 : 0);
  g.live = o;   o += al16(C * 4);
  g.lidx = o;   o += al16((C + 1) * 4);
  g.kpos = o;   o += al16(C * BKP * 4);
  g.kval = o;   o += al16(C * BKP * 4);
  g.qpos = o;   o += al16(static_cast<size_t>(bq) * 4);
  g.total = o;
  return g;
}

struct AcArgs {
  const float *q, *k, *v, *sq_s, *sk_s, *sv_s;
  const int *qpos, *kpos, *kval;
  const unsigned char* tab;
  float* out;     // (B, H, Sq, D): AC_FUSED, AC_PV
  float* scores;  // (B, H, Sq, skvp): AC_SCORES writes it, AC_PV reads it
  int B, H, KH, Sq, Skv, D, bk, bits, causal, window;
  int bq, splits, per, rk;  // the plan
  int n_qt;                 // q tiles a (batch, kv head)
  int skvp;                 // Skv rounded up to bk
  int kv_async;             // K/V rows 16-byte aligned: cp.async
  int sc_async;             // score rows 16-byte aligned: cp.async
};

__device__ __forceinline__ bool ac_valid(int qp, int kp, int kv, int causal,
                                         int window) {
  bool m = kv != 0;
  if (causal) m = m && kp <= qp;
  if (window > 0) m = m && kp > qp - window;
  return m;
}

// byte j (0..15) of 16 staged int8 operands, sign-extended
__device__ __forceinline__ int ac_sbyte(const uint4& r, int j) {
  const uint32_t w = j < 4 ? r.x : j < 8 ? r.y : j < 12 ? r.z : r.w;
  return static_cast<int>(static_cast<int8_t>((w >> (8 * (j & 3))) & 0xffu));
}

// --- the product forms ----------------------------------------------------
// APW / BPW: operands a staged A / B word holds; a_unit / b_unit: one
// operand's bits (32 / APW or 32 / BPW of them); B: 16 B operands in
// registers, load_b from their 16 / BPW staged words (16-byte aligned);
// dot: the 16 products of A words and B, added to s in 32 bits.

template <int PATH, bool COMP>
struct Form;

template <>
struct Form<AC_LUT, false> {
  static constexpr int APW = 1, BPW = 4, MIN_BLOCKS = 1;
  struct B { uint32_t b[16]; };
  __device__ static uint32_t a_unit(int v, int bits) {
    return static_cast<uint32_t>((v + (1 << (bits - 1))) << bits) * 2u;
  }
  __device__ static uint32_t b_unit(int v, int) {
    return static_cast<uint32_t>(static_cast<uint8_t>(v));
  }
  __device__ static void load_b(const uint4* p, int bits, B& o) {
    const uint4 r = p[0];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      o.b[j] = static_cast<uint32_t>(ac_sbyte(r, j) + (1 << (bits - 1))) * 2u;
  }
  __device__ static uint32_t dot(const uint32_t* aw, const B& o,
                                 const unsigned char* tab, int, uint32_t s) {
#pragma unroll
    for (int j = 0; j < 16; ++j)  // one int16 gather at table + row + column
      s += static_cast<uint32_t>(static_cast<int32_t>(
          *reinterpret_cast<const int16_t*>(tab + aw[j] + o.b[j])));
    return s;
  }
};

template <>
struct Form<AC_MXU, false> {
  static constexpr int APW = 4, BPW = 4, MIN_BLOCKS = 1;
  struct B { uint32_t b[4]; };
  __device__ static uint32_t a_unit(int v, int) {
    return static_cast<uint32_t>(static_cast<uint8_t>(v));
  }
  __device__ static uint32_t b_unit(int v, int) {
    return static_cast<uint32_t>(static_cast<uint8_t>(v));
  }
  __device__ static void load_b(const uint4* p, int, B& o) {
    const uint4 r = p[0];
    o.b[0] = r.x; o.b[1] = r.y; o.b[2] = r.z; o.b[3] = r.w;
  }
  __device__ static uint32_t dot(const uint32_t* aw, const B& o,
                                 const unsigned char*, int, uint32_t s) {
#pragma unroll
    for (int w = 0; w < 4; ++w)  // four exact products a dp4a
      s = static_cast<uint32_t>(__dp4a(static_cast<int>(aw[w]),
                                       static_cast<int>(o.b[w]),
                                       static_cast<int>(s)));
    return s;
  }
};

template <>
struct Form<AC_NIBBLE, false> {
  static constexpr int APW = 4, BPW = 4, MIN_BLOCKS = 1;
  struct B { int4 b[16]; };
  __device__ static uint32_t a_unit(int v, int) {
    return static_cast<uint32_t>(static_cast<uint8_t>(v));
  }
  __device__ static uint32_t b_unit(int v, int) {
    return static_cast<uint32_t>(static_cast<uint8_t>(v));
  }
  __device__ static void load_b(const uint4* p, int bits, B& o) {
    const uint4 r = p[0];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      o.b[j] = cim::NibbleCore::stage_b(ac_sbyte(r, j), bits);
  }
  __device__ static uint32_t dot(const uint32_t* aw, const B& o,
                                 const unsigned char* tab, int bits,
                                 uint32_t s) {
    const uint4 a = make_uint4(aw[0], aw[1], aw[2], aw[3]);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      s += cim::NibbleCore::product(
          cim::NibbleCore::stage_a(ac_sbyte(a, j), bits), o.b[j], tab, bits);
    return s;
  }
};

template <>
struct Form<AC_LOG, false> {  // mitchell: two products a dp4a
  static constexpr int APW = 2, BPW = 2, MIN_BLOCKS = 1;
  struct B { uint32_t b[8]; };
  __device__ static uint32_t a_unit(int v, int bits) {
    return cim::log_x_bytes(v, bits);
  }
  __device__ static uint32_t b_unit(int v, int bits) {
    return cim::log_w_bytes(v, bits);
  }
  __device__ static void load_b(const uint4* p, int, B& o) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint4 r = p[c];
      o.b[4 * c] = r.x; o.b[4 * c + 1] = r.y;
      o.b[4 * c + 2] = r.z; o.b[4 * c + 3] = r.w;
    }
  }
  __device__ static uint32_t dot(const uint32_t* aw, const B& o,
                                 const unsigned char*, int, uint32_t s) {
#pragma unroll
    for (int w = 0; w < 8; ++w)
      s = static_cast<uint32_t>(__dp4a(static_cast<int>(aw[w]),
                                       static_cast<int>(o.b[w]),
                                       static_cast<int>(s)));
    return s;
  }
};

template <>
struct Form<AC_LOG, true> {  // log_our: the dp4a, then the compare word
  static constexpr int APW = 1, BPW = 1, MIN_BLOCKS = 1;
  struct B { uint32_t b0[16], b1[16], b2[16]; };
  __device__ static uint32_t a_unit(int v, int bits) {
    return cim::log_x_bytes(v, bits) | cim::comp_word(v, bits);
  }
  // the byte pair low, the compare bytes high: cluster_gemm.cuh's b0 | b1
  __device__ static uint32_t b_unit(int v, int bits) {
    return cim::log_w_bytes(v, bits) | cim::comp_word(v, bits);
  }
  __device__ static void load_b(const uint4* p, int, B& o) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 r = p[c];
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        o.b0[4 * c + x] = w[x] & 0xffffu;
        o.b1[4 * c + x] = w[x] & 0xffff0000u;
        // b's sign: byte 0 is s 2^k (|2^k| <= 64), 0 for b = 0
        o.b2[4 * c + x] = cim::prmt(w[x], 0u, 0x8888u);
      }
    }
  }
  __device__ static uint32_t dot(const uint32_t* aw, const B& o,
                                 const unsigned char*, int, uint32_t s) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s = static_cast<uint32_t>(__dp4a(static_cast<int>(aw[j]),
                                       static_cast<int>(o.b0[j]),
                                       static_cast<int>(s)));
      const uint32_t mx = max(aw[j], o.b1[j]), mn = min(aw[j], o.b1[j]);
      const uint32_t comp = cim::prmt(mn, 0u, 0x4442u) << (mx >> 24);
      const uint32_t sg = (cim::prmt(aw[j], 0u, 0x8888u) ^ o.b2[j]) | 1u;
      s += comp * sg;
    }
    return s;
  }
};

// operand k of a staged row (`row` its first byte), as one unit of
// `per_word` a word
template <int PER_WORD>
__device__ __forceinline__ void ac_store_unit(unsigned char* row, int k,
                                              uint32_t unit) {
  unsigned char* p = row + (k / PER_WORD) * 4 + (k % PER_WORD) *
                                                   (4 / PER_WORD);
  if constexpr (PER_WORD == 1) {
    *reinterpret_cast<uint32_t*>(p) = unit;
  } else if constexpr (PER_WORD == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(unit);
  } else {
    *p = static_cast<unsigned char>(unit);
  }
}

constexpr int AC_RT = 4;  // rows a thread's register tile

// out[i][n] = sum_k A[i][k] B[k][n], i < R, n < ncols, k < kp (a multiple
// of 16): A rows of kp / APW staged words; B a column a thread, kp / BPW
// staged words a column in `b_units` 16-byte units.  A thread owns one
// column and AC_RT rows: 16 B operands at a time in registers for every
// row of its tile, each row's A words read by 16-byte loads that a
// warp's columns share (one address: a broadcast), AC_RT independent
// sums.  Where the tiles are fewer than the threads (a decode step's one
// or two rows), ks threads share a tile's k, 16 at a time in turn, and
// their sums meet by shared-memory atomics in `stage` (R rows of
// `stride` words; wrapping addition is associative).  write(i, n, sum).
template <class F, class W>
__device__ __forceinline__ void ac_gemm(const unsigned char* A, int R,
                                        const unsigned char* Bt, int b_units,
                                        int ncols, int kp,
                                        const unsigned char* tab, int bits,
                                        uint32_t* stage, int stride,
                                        W write) {
  constexpr int AW = 16 / F::APW, BW = 16 / F::BPW;  // words a 16 k
  const int a_row = kp / F::APW;
  const int nrb = (R + AC_RT - 1) / AC_RT;
  const int units = ncols * nrb, nkc = kp / 16;
  int ks = 1;
  while (2 * ks * units <= AC_THREADS && 2 * ks <= nkc) ks *= 2;
  if (ks > 1) {
    for (int e = threadIdx.x; e < R * ncols; e += AC_THREADS)
      stage[(e / ncols) * stride + e % ncols] = 0u;
    __syncthreads();
  }
#pragma unroll 1
  for (int u = threadIdx.x; u < units * ks; u += AC_THREADS) {
    const int kg = u / units, uu = u - kg * units;
    const int col = uu % ncols, r0 = (uu / ncols) * AC_RT;
    const uint4* bp = reinterpret_cast<const uint4*>(Bt) +
                      static_cast<size_t>(col) * b_units;
    const uint4* ap = reinterpret_cast<const uint4*>(A) +
                      static_cast<size_t>(r0) * (a_row / 4);
    uint32_t acc[AC_RT];
#pragma unroll
    for (int r = 0; r < AC_RT; ++r) acc[r] = 0u;
#pragma unroll 1
    for (int kc = kg; kc < nkc; kc += ks) {
      typename F::B bv;
      F::load_b(bp + kc * (BW / 4), bits, bv);
#pragma unroll
      for (int r = 0; r < AC_RT; ++r) {
        if (r0 + r < R) {
          const uint4* a = ap + r * (a_row / 4) + kc * (AW / 4);
          uint32_t aw[AW];
#pragma unroll
          for (int c = 0; c < AW / 4; ++c) {
            const uint4 x = a[c];
            aw[4 * c] = x.x;
            aw[4 * c + 1] = x.y;
            aw[4 * c + 2] = x.z;
            aw[4 * c + 3] = x.w;
          }
          acc[r] = F::dot(aw, bv, tab, bits, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < AC_RT; ++r) {
      if (r0 + r < R) {
        if (ks == 1)
          write(r0 + r, col, acc[r]);
        else
          atomicAdd(&stage[(r0 + r) * stride + col], acc[r]);
      }
    }
  }
  if (ks > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < R * ncols; e += AC_THREADS) {
      const int i = e / ncols, col = e - i * ncols;
      write(i, col, stage[i * stride + col]);
    }
  }
}

// rk rows (keys) of D f32 from `src` (row-major, D a row) into a ring
// slot of rows of drs f32; rows from `nvalid` on are zero.  `async`: by
// cp.async 16 bytes at a time (D % 4 == 0, rows 16-byte aligned), else by
// elements, with the row's tail up to a multiple of 4 zeroed.  `dummy` is
// any valid 16-byte aligned address (a zero-byte copy's source).
__device__ __forceinline__ void ac_fill(float* dst, const float* src,
                                        const float* dummy, int rk,
                                        int nvalid, int d, int drs,
                                        bool async) {
  if (async) {
    const int c4 = d >> 2;
    for (int e = threadIdx.x; e < rk * c4; e += AC_THREADS) {
      const int r = e / c4, c = (e - r * c4) * 4;
      const bool ok = r < nvalid;
      cim::cp_async16_n(dst + r * drs + c,
                        ok ? src + static_cast<size_t>(r) * d + c : dummy,
                        ok ? 16 : 0);
    }
  } else {
    const int d4 = (d + 3) / 4 * 4;
    for (int e = threadIdx.x; e < rk * d4; e += AC_THREADS) {
      const int r = e / d4, c = e - r * d4;
      dst[r * drs + c] =
          (r < nvalid && c < d) ? src[static_cast<size_t>(r) * d + c] : 0.f;
    }
  }
}

// each row's max over a kv block's bkp scores (`sc`, rows `sw` f32 apart)
// into out[i]: one warp a row, fmaxf from -inf lane-strided over the keys,
// then the xor butterfly (Phase A's, and AC_PV's over a loaded tile)
__device__ __forceinline__ void ac_row_max(const float* sc, int R, int sw,
                                           int bkp, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < R; i += AC_WARPS) {
    float mx = __int_as_float(static_cast<int>(0xff800000u));  // -inf
    for (int j = lane; j < bkp; j += 32)
      mx = fmaxf(mx, sc[static_cast<size_t>(i) * sw + j]);
    for (int o = 16; o; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) out[i] = mx;
  }
}

// grid (tiles, 1, splits): tile = (b KH + hk) n_qt + q tile.  AC_FUSED and
// AC_PV: clusters of (1, 1, splits), the cluster's ranks its kv ranges;
// AC_SCORES: no cluster, blockIdx.z the range (nothing is combined)
template <int PATH, bool COMP, int MODE>
__global__ void __launch_bounds__(AC_THREADS, (Form<PATH, COMP>::MIN_BLOCKS))
attn_cluster_kernel(const AcArgs a) {
  using F = Form<PATH, COMP>;
  namespace cgp = cooperative_groups;
  constexpr bool QK = MODE != AC_PV;      // quantizes K, takes QK^T
  constexpr bool PV = MODE != AC_SCORES;  // the softmax, PV, the combine
  extern __shared__ __align__(16) unsigned char sm[];
  const int group = a.H / a.KH;
  const AcGeom g = ac_geometry(PATH, COMP, a.bits, group, a.bq, a.per, a.bk,
                               a.D, a.rk, MODE);
  cgp::cluster_group cluster = cgp::this_cluster();
  const int tid = threadIdx.x;
  const int S = a.splits, C = a.per, R = g.rows, D = a.D, bk = a.bk;
  const int bkp = g.bkp, bq = a.bq;
  const int rank = MODE == AC_SCORES ? static_cast<int>(blockIdx.z)
                                     : static_cast<int>(cluster.block_rank());
  const int qt = static_cast<int>(blockIdx.x) % a.n_qt;
  const int bh = static_cast<int>(blockIdx.x) / a.n_qt;  // b KH + hk
  const int hk = bh % a.KH, b = bh / a.KH;
  const int q0 = qt * bq, rows_q = min(bq, a.Sq - q0);
  const int qmax = (1 << (a.bits - 1)) - 1;
  const float qmf = static_cast<float>(qmax);

  const unsigned char* tab = sm + g.tab;
  float* ring = reinterpret_cast<float*>(sm + g.ring);
  unsigned char* bt = sm + g.bt;
  uint32_t* btw = reinterpret_cast<uint32_t*>(bt);
  unsigned char* aq = sm + g.a;   // q rows, then pq rows (ap)
  unsigned char* ap = sm + g.a;
  // score tiles (Phase A's or loaded), then pvf; AC_SCORES: ac_gemm's stage
  float* s = reinterpret_cast<float*>(sm + g.s);
  float* pvf = s;
  float* acc = reinterpret_cast<float*>(sm + g.acc);
  float* rmax = reinterpret_cast<float*>(sm + g.rmax);
  float* corr = reinterpret_cast<float*>(sm + g.corr);
  float* sp = reinterpret_cast<float*>(sm + g.sp);
  float* mprev = reinterpret_cast<float*>(sm + g.mprev);
  float* mnew = reinterpret_cast<float*>(sm + g.mnew);
  float* mrun = reinterpret_cast<float*>(sm + g.mrun);
  float* lsum = reinterpret_cast<float*>(sm + g.l);
  float* rscale = reinterpret_cast<float*>(sm + g.rscale);
  int* plive = reinterpret_cast<int*>(sm + g.plive);
  int* live = reinterpret_cast<int*>(sm + g.live);
  int* lidx = reinterpret_cast<int*>(sm + g.lidx);
  int* kpos = reinterpret_cast<int*>(sm + g.kpos);
  int* kval = reinterpret_cast<int*>(sm + g.kval);
  int* qpos = reinterpret_cast<int*>(sm + g.qpos);

  {  // the table: asynchronous, committed with the first copies
    const int n16 = static_cast<int>(ac_table_bytes(PATH, a.bits) / 16);
    for (int i = tid; i < n16; i += AC_THREADS)
      cim::cp_async16(sm + g.tab + 16 * i, a.tab + 16 * i, true);
  }
  const float sk = QK ? a.sk_s[bh] : 0.f, sv = PV ? a.sv_s[bh] : 0.f;
  // (sq_s * sk_s) * sm_scale, sm_scale = 1/sqrt(D) rounded once to f32
  const float sm_scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const float vscale = __fdiv_rn(sv, qmf);
  for (int i = tid; i < R; i += AC_THREADS) {
    if constexpr (QK) {
      const int h = hk * group + i / bq;
      rscale[i] = __fmul_rn(__fmul_rn(a.sq_s[b * a.H + h], sk), sm_scale);
    }
    if constexpr (PV) {
      mrun[i] = AC_NEG_INF;
      lsum[i] = 0.f;
    }
  }
  for (int i = tid; i < bq; i += AC_THREADS)
    qpos[i] = i < rows_q ? a.qpos[static_cast<size_t>(b) * a.Sq + q0 + i] : 0;
  if constexpr (PV) {
    for (int e = tid; e < R * D; e += AC_THREADS) acc[e] = 0.f;
  }
  // the first score of tile row i (= g bq + qi: head hk group + g, query
  // q0 + qi) in the (B, H, Sq, skvp) score tensor
  auto srow = [&](int i) -> size_t {
    return ((static_cast<size_t>(b) * a.H + hk * group + i / bq) * a.Sq +
            q0 + i % bq) * a.skvp;
  };
  const int nk = (a.Skv + bk - 1) / bk;
  const int span = S * C;
  const int chunks = (nk + span - 1) / span;
  const int ipb = bkp / a.rk;                  // ring tiles a kv block
  const size_t kv0 = static_cast<size_t>(bh) * a.Skv;
  const size_t slot = static_cast<size_t>(a.rk) * g.drs;
  const size_t pos0 = static_cast<size_t>(b) * a.Skv;
  const int share = (D + S - 1) / S;           // Phase C's columns a rank
  const int c0 = min(D, rank * share), cw = min(D, c0 + share) - c0;

#pragma unroll 1
  for (int ch = 0; ch < chunks; ++ch) {
    const int base = ch * span + rank * C;     // this rank's first block
    const int cnt = max(0, min(C, nk - base));
    for (int e = tid; e < C * bkp; e += AC_THREADS) {
      const int c = e / bkp, j = e - c * bkp;
      const int key = (base + c) * bk + j;
      const bool ok = c < cnt && j < bk && key < a.Skv;
      kpos[e] = ok ? a.kpos[pos0 + key] : 0;
      kval[e] = ok ? a.kval[pos0 + key] : 0;
    }
    if constexpr (PV) {
      for (int e = tid; e < C * R; e += AC_THREADS) rmax[e] = AC_NEG_INF;
    }
    __syncthreads();
    // a kv block is live iff some (query, key) pair of the tile is
    // admitted: from the positions, before its K/V (or scores) are fetched
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      int any = 0;
      if (c < cnt) {
        for (int e = tid; e < rows_q * bk && !any; e += AC_THREADS) {
          const int qi = e / bk, j = e - qi * bk;
          any = ac_valid(qpos[qi], kpos[c * bkp + j], kval[c * bkp + j],
                         a.causal, a.window);
        }
      }
      any = __syncthreads_or(any);
      if (tid == 0) live[c] = any;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int c = 0; c < C; ++c)
        if (live[c]) lidx[n++] = c;
      lidx[C] = n;
    }
    __syncthreads();
    const int nlive = lidx[C];
    const int n_k = nlive * ipb;
    const int n_items = MODE == AC_FUSED ? 2 * n_k : n_k;

    if constexpr (MODE == AC_SCORES) {
      // a dead block's scores are all masked: NEG_INF, no products
#pragma unroll 1
      for (int c = 0; c < cnt; ++c) {
        if (live[c]) continue;
        const size_t col0 = static_cast<size_t>(base + c) * bk;
        for (int e = tid; e < group * rows_q * bk; e += AC_THREADS) {
          const int r = e / bk, j = e - r * bk;   // r = g rows_q + qi
          const int gi = r / rows_q;
          a.scores[srow(gi * bq + r - gi * rows_q) + col0 + j] = AC_NEG_INF;
        }
      }
    }
    if constexpr (MODE == AC_PV) {
      // the live blocks' score tiles into their places in `s`, one copy
      // group ahead of the V ring's: 16 bytes at a time where the rows
      // allow (sc_async), else by elements; keys past bk and the tile's
      // rows past Sq hold NEG_INF
      for (int li = 0; li < nlive; ++li) {
        const int c = lidx[li];
        float* sc = s + static_cast<size_t>(c) * R * g.sw;
        const size_t col0 = static_cast<size_t>(base + c) * bk;
        if (a.sc_async) {
          const int u4 = bkp / 4;
          for (int e = tid; e < R * u4; e += AC_THREADS) {
            const int i = e / u4, j = (e - i * u4) * 4;
            float* dst = sc + static_cast<size_t>(i) * g.sw + j;
            if (j < bk && i % bq < rows_q)
              cim::cp_async16(dst, a.scores + srow(i) + col0 + j, true);
            else
              *reinterpret_cast<float4*>(dst) = make_float4(
                  AC_NEG_INF, AC_NEG_INF, AC_NEG_INF, AC_NEG_INF);
          }
        } else {
          for (int e = tid; e < R * bkp; e += AC_THREADS) {
            const int i = e / bkp, j = e - i * bkp;
            sc[static_cast<size_t>(i) * g.sw + j] =
                j < bk && i % bq < rows_q ? a.scores[srow(i) + col0 + j]
                                          : AC_NEG_INF;
          }
        }
      }
      cim::cp_async_commit();
    }

    // the ring: K tiles of every live block, then V tiles (AC_SCORES: K
    // only; AC_PV: V only)
    auto issue = [&](int t) {
      if (t < n_items) {
        const bool isv = MODE == AC_PV || (MODE == AC_FUSED && t >= n_k);
        const int tt = MODE == AC_FUSED && isv ? t - n_k : t;
        const int li = tt / ipb, key0 = (tt - li * ipb) * a.rk;
        const int k0 = (base + lidx[li]) * bk;
        const float* src = isv ? a.v : a.k;
        const int nvalid = min(bk, a.Skv - k0) - key0;
        ac_fill(ring + (t % AC_STAGES) * slot,
                nvalid > 0 ? src + (kv0 + k0 + key0) * D : src, src, a.rk,
                nvalid, D, g.drs, a.kv_async != 0);
      }
      cim::cp_async_commit();
    };
    auto acquire = [&](int t) -> const float* {
      cim::cp_async_wait<AC_STAGES - 2>();
      __syncthreads();  // tile t has landed; tile t-1 is consumed
      issue(t + AC_STAGES - 1);
      return ring + (t % AC_STAGES) * slot;
    };
#pragma unroll
    for (int t = 0; t < AC_STAGES - 1; ++t) issue(t);
    // q, staged while the ring fills (each chunk in AC_FUSED, whose pq
    // takes its rows); a thread's loads of AC_QU elements issued together
    if (QK && (MODE == AC_FUSED || ch == 0)) {
      constexpr int AC_QU = 8;
      const int nq = R * g.kpq;
#pragma unroll 1
      for (int e0 = tid; e0 < nq; e0 += AC_QU * AC_THREADS) {
        float x[AC_QU], sc[AC_QU];
#pragma unroll
        for (int u = 0; u < AC_QU; ++u) {
          const int e = e0 + u * AC_THREADS;
          const int i = e / g.kpq, kk = e - i * g.kpq;
          const int gi = i / bq, qi = i - gi * bq, h = hk * group + gi;
          const bool ok = e < nq && qi < rows_q && kk < D;
          x[u] = ok ? a.q[((static_cast<size_t>(b) * a.H + h) * a.Sq + q0 +
                           qi) * D + kk]
                    : 0.f;
          sc[u] = ok ? a.sq_s[b * a.H + h] : 1.f;
        }
#pragma unroll
        for (int u = 0; u < AC_QU; ++u) {
          const int e = e0 + u * AC_THREADS;
          if (e < nq) {
            const int i = e / g.kpq, kk = e - i * g.kpq;
            ac_store_unit<F::APW>(
                aq + static_cast<size_t>(i) * g.aqw * 4, kk,
                F::a_unit(cim::quantize(x[u], sc[u], qmax), a.bits));
          }
        }
      }
    }
    int t = 0;

    // Phase A: scores (and row maxima) of the live blocks
    if constexpr (QK) {
#pragma unroll 1
      for (int li = 0; li < nlive; ++li) {
        const int c = lidx[li];
#pragma unroll 1
        for (int it = 0; it < ipb; ++it) {  // K tile -> B columns (key, d)
          const float* raw = acquire(t++);
          const int kw = g.kpq / F::BPW, key0 = it * a.rk;
          for (int e = tid; e < a.rk * kw; e += AC_THREADS) {
            const int r = e / kw, w = e - r * kw;
            uint32_t word = 0u;
#pragma unroll
            for (int x = 0; x < F::BPW; ++x) {
              const int dd = w * F::BPW + x;
              const int qv =
                  dd < D ? cim::quantize(raw[r * g.drs + dd], sk, qmax) : 0;
              word |= F::b_unit(qv, a.bits) << (x * (32 / F::BPW));
            }
            btw[static_cast<size_t>(key0 + r) * g.rsq * 4 + w] = word;
          }
        }
        __syncthreads();
        const int* kp = kpos + c * bkp;
        const int* kv = kval + c * bkp;
        auto score = [&](int i, int j, uint32_t sum) {
          return ac_valid(qpos[i % bq], kp[j], kv[j], a.causal, a.window)
                     ? __fmul_rn(static_cast<float>(static_cast<int32_t>(sum)),
                                 rscale[i])
                     : AC_NEG_INF;
        };
        if constexpr (MODE == AC_SCORES) {
          // straight to the score tensor (a warp's columns are adjacent
          // keys); `s` is only the stage of threads that share k
          const size_t col0 = static_cast<size_t>(base + c) * bk;
          ac_gemm<F>(aq, R, bt, g.rsq, bkp, g.kpq, tab, a.bits,
                     reinterpret_cast<uint32_t*>(s), bkp,
                     [&](int i, int j, uint32_t sum) {
                       if (j < bk && i % bq < rows_q)
                         a.scores[srow(i) + col0 + j] = score(i, j, sum);
                     });
        } else {
          float* sc = s + static_cast<size_t>(c) * R * g.sw;
          ac_gemm<F>(aq, R, bt, g.rsq, bkp, g.kpq, tab, a.bits,
                     reinterpret_cast<uint32_t*>(sc), g.sw,
                     [&](int i, int j, uint32_t sum) {
                       sc[static_cast<size_t>(i) * g.sw + j] =
                           score(i, j, sum);
                     });
          __syncthreads();
          ac_row_max(sc, R, g.sw, bkp, rmax + c * R);
        }
      }
    }
    if constexpr (MODE == AC_SCORES) {
      cim::cp_async_wait<0>();  // the ring's last (empty) groups
      __syncthreads();          // the next chunk rewrites the positions
    } else {
      if constexpr (MODE == AC_PV) {
        // the score tiles have landed (the V ring's AC_STAGES - 1 groups
        // are the only younger ones): each row's max of each live block
        cim::cp_async_wait<AC_STAGES - 1>();
        __syncthreads();
        for (int li = 0; li < nlive; ++li) {
          const int c = lidx[li];
          ac_row_max(s + static_cast<size_t>(c) * R * g.sw, R, g.sw, bkp,
                     rmax + c * R);
        }
      }
      cluster.sync();  // every rank's row maxima are visible

      // the prefix maxima in kv order: the running max, the earlier
      // ranks' blocks, this rank's (then the later ranks', for the next
      // chunk)
      for (int i = tid; i < R; i += AC_THREADS) {
        float m = mrun[i];
        for (int q = 0; q < rank; ++q) {
          const float* pr = cluster.map_shared_rank(rmax, q);
          for (int c = 0; c < C; ++c) m = fmaxf(m, pr[c * R + i]);
        }
        for (int c = 0; c < C; ++c) {
          mprev[c * R + i] = m;
          m = fmaxf(m, rmax[c * R + i]);
          mnew[c * R + i] = m;
        }
        for (int q = rank + 1; q < S; ++q) {
          const float* pr = cluster.map_shared_rank(rmax, q);
          for (int c = 0; c < C; ++c) m = fmaxf(m, pr[c * R + i]);
        }
        mrun[i] = m;
      }

      // Phase B: p, pq, sum p and the integer PV of the live blocks
      const int warp = tid >> 5, lane = tid & 31;
#pragma unroll 1
      for (int li = 0; li < nlive; ++li) {
        const int c = lidx[li];
#pragma unroll 1
        for (int it = 0; it < ipb; ++it) {  // V tile -> B columns (d, key)
          const float* raw = acquire(t++);
          const int kw = a.rk / F::BPW, key0 = it * a.rk;
          for (int e = tid; e < D * kw; e += AC_THREADS) {
            const int col = e / kw, j = e - col * kw;
            uint32_t word = 0u;
#pragma unroll
            for (int x = 0; x < F::BPW; ++x)
              word |= F::b_unit(cim::quantize(raw[(j * F::BPW + x) * g.drs +
                                                  col],
                                              sv, qmax),
                                a.bits)
                      << (x * (32 / F::BPW));
            btw[static_cast<size_t>(col) * g.rsp * 4 + key0 / F::BPW + j] =
                word;
          }
        }
        __syncthreads();  // (the prefix maxima too)
        const float* sc = s + static_cast<size_t>(c) * R * g.sw;
        const int* kp = kpos + c * bkp;
        const int* kv = kval + c * bkp;
        for (int i = warp; i < R; i += AC_WARPS) {  // one warp a row
          const float mn = mnew[c * R + i];
          const float cr = expf(__fsub_rn(mprev[c * R + i], mn));
          const int qp = qpos[i % bq];
          unsigned char* prow = ap + static_cast<size_t>(i) * g.apw * 4;
          float ps = 0.f;
          for (int j = lane; j < bkp; j += 32) {
            // the mask, not the score, decides: on a fully masked row s ==
            // m' == NEG_INF and exp(0) = 1 would be wrong
            const float p =
                ac_valid(qp, kp[j], kv[j], a.causal, a.window)
                    ? expf(__fsub_rn(sc[static_cast<size_t>(i) * g.sw + j],
                                     mn))
                    : 0.f;
            ps = __fadd_rn(ps, p);
            ac_store_unit<F::APW>(
                prow, j,
                F::a_unit(static_cast<int>(rintf(__fmul_rn(p, qmf))),
                          a.bits));
          }
          for (int o = 16; o; o >>= 1)
            ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, o));
          if (lane == 0) {
            corr[c * R + i] = cr;
            sp[c * R + i] = ps;
          }
        }
        __syncthreads();
        float* pc = pvf + static_cast<size_t>(c) * R * g.sw;
        ac_gemm<F>(ap, R, bt, g.rsp, D, bkp, tab, a.bits,
                   reinterpret_cast<uint32_t*>(pc), g.sw,
                   [&](int i, int col, uint32_t sum) {
                     pc[static_cast<size_t>(i) * g.sw + col] = __fmul_rn(
                         static_cast<float>(static_cast<int32_t>(sum)),
                         vscale);
                   });
      }
      for (int c = tid; c < C; c += AC_THREADS) plive[c] = live[c];
      cim::cp_async_wait<0>();
      cluster.sync();  // every rank's pvf, corr, sum p are visible

      // Phase C: the in-order combine, this rank's columns of every row
      for (int i = tid; i < R; i += AC_THREADS) {
        float lv = lsum[i];
        for (int q = 0; q < S; ++q) {
          const int* pl = cluster.map_shared_rank(plive, q);
          const float* pcr = cluster.map_shared_rank(corr, q);
          const float* psp = cluster.map_shared_rank(sp, q);
          for (int c = 0; c < C; ++c)
            if (pl[c])
              lv = __fadd_rn(__fmul_rn(lv, pcr[c * R + i]), psp[c * R + i]);
        }
        lsum[i] = lv;
      }
      for (int e = tid; e < R * cw; e += AC_THREADS) {
        const int i = e / cw, col = c0 + (e - i * cw);
        float av = acc[i * D + col];
        for (int q = 0; q < S; ++q) {
          const int* pl = cluster.map_shared_rank(plive, q);
          const float* pcr = cluster.map_shared_rank(corr, q);
          const float* ppv = cluster.map_shared_rank(pvf, q);
          for (int c = 0; c < C; ++c)
            if (pl[c])
              av = __fadd_rn(
                  __fmul_rn(av, pcr[c * R + i]),
                  ppv[(static_cast<size_t>(c) * R + i) * g.sw + col]);
        }
        acc[i * D + col] = av;
      }
      // the next chunk's scores overwrite this one's pvf, which the peers
      // read above
      if (chunks > 1) cluster.sync();
    }
  }
  if constexpr (PV) {
    __syncthreads();  // l of every row is visible
    for (int e = tid; e < R * cw; e += AC_THREADS) {
      const int i = e / cw, col = c0 + (e - i * cw);
      const int gi = i / bq, qi = i - gi * bq;
      if (qi < rows_q)
        a.out[((static_cast<size_t>(b) * a.H + hk * group + gi) * a.Sq + q0 +
               qi) * D + col] =
            __fdiv_rn(acc[i * D + col], fmaxf(lsum[i], AC_EPS_L));
    }
    cluster.sync();  // no block leaves while a peer reads its shared memory
  }
}

using AcKernel = void (*)(AcArgs);

template <int MODE>
inline AcKernel ac_kernel_of(int path, int comp) {
  switch (path) {
    case AC_MXU:
      return attn_cluster_kernel<AC_MXU, false, MODE>;
    case AC_LUT:
      return attn_cluster_kernel<AC_LUT, false, MODE>;
    case AC_NIBBLE:
      return attn_cluster_kernel<AC_NIBBLE, false, MODE>;
    case AC_LOG:
      return comp ? attn_cluster_kernel<AC_LOG, true, MODE>
                  : attn_cluster_kernel<AC_LOG, false, MODE>;
    default:
      return nullptr;
  }
}

inline AcKernel ac_kernel(int path, int comp, int mode) {
  switch (mode) {
    case AC_FUSED:
      return ac_kernel_of<AC_FUSED>(path, comp);
    case AC_SCORES:
      return ac_kernel_of<AC_SCORES>(path, comp);
    case AC_PV:
      return ac_kernel_of<AC_PV>(path, comp);
    default:
      return nullptr;
  }
}

// The clusters of `splits` blocks of the instantiation for `path`, `comp`
// and `mode` at `smem` bytes that the current device holds at once, into
// *out (AC_SCORES launches no cluster: its blocks, splits 1); returns the
// CUDA error code.
inline int ac_capacity(int path, int comp, int mode, int smem, int splits,
                       int* out) {
  const AcKernel kern = ac_kernel(path, comp, mode);
  const int most = mode == AC_SCORES ? 1 : AC_MAX_SPLITS;
  if (kern == nullptr || splits < 1 || splits > most || smem <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return cim::cl_capacity_ex(reinterpret_cast<const void*>(kern),
                             static_cast<size_t>(smem), AC_THREADS, splits,
                             out);
}

// One launch of the plan (bq, splits, per, rk) in `mode` with `smem` bytes,
// which must be ac_geometry's total; a plan the kernel does not take is
// refused (cudaErrorInvalidValue): bits 2..AC_MAX_BITS, splits 1..
// AC_MAX_SPLITS (AC_SCORES: 1..AC_MAX_SCORE_SPLITS) with no rank empty in
// the first chunk, rk in {4, 8, 16, 32, 64} dividing the padded kv block,
// a score tensor given iff the mode writes or reads one.
inline int ac_launch(AcArgs a, int path, int comp, int mode, int smem,
                     cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const AcKernel kern = ac_kernel(path, comp, mode);
  const int most = mode == AC_SCORES ? AC_MAX_SCORE_SPLITS : AC_MAX_SPLITS;
  if (kern == nullptr || a.B <= 0 || a.H <= 0 || a.KH <= 0 || a.Sq <= 0 ||
      a.Skv <= 0 || a.D <= 0 || a.H % a.KH != 0 || a.bk <= 0 ||
      a.bits < 2 || a.bits > AC_MAX_BITS || a.bq <= 0 || a.per <= 0 ||
      a.splits < 1 || a.splits > most)
    return bad;
  if ((mode == AC_FUSED) != (a.scores == nullptr)) return bad;
  if (a.rk != 4 && a.rk != 8 && a.rk != 16 && a.rk != 32 && a.rk != 64)
    return bad;
  const int64_t nk = (static_cast<int64_t>(a.Skv) + a.bk - 1) / a.bk;
  if (static_cast<int64_t>(a.splits - 1) * a.per >= nk) return bad;
  if (nk * a.bk > INT32_MAX) return bad;
  const AcGeom g = ac_geometry(path, comp, a.bits, a.H / a.KH, a.bq, a.per,
                               a.bk, a.D, a.rk, mode);
  if (g.bkp % a.rk != 0 || g.total != static_cast<size_t>(smem)) return bad;
  const int64_t n_qt = (static_cast<int64_t>(a.Sq) + a.bq - 1) / a.bq;
  const int64_t tiles = static_cast<int64_t>(a.B) * a.KH * n_qt;
  if (tiles > INT32_MAX) return bad;
  a.n_qt = static_cast<int>(n_qt);
  a.skvp = static_cast<int>(nk * a.bk);
  a.kv_async = a.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  a.sc_async = a.bk % 4 == 0 && g.sw % 4 == 0 &&
               reinterpret_cast<uintptr_t>(a.scores) % 16 == 0;
  if (mode != AC_SCORES)
    return cim::cl_launch_ex(kern, a, g.total, AC_THREADS,
                             static_cast<int>(tiles), a.splits, stream);
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(tiles), 1,
              static_cast<unsigned>(a.splits)),
         AC_THREADS, g.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
