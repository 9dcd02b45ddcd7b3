// attn_gemm.cu - flash attention through the approximate CiM datapath for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/attn_gemm.py:
//   attn_fused        (-> _attn_kernel):   one pass, all four datapaths;
//   attn_materialized (-> _scores_kernel, _pv_kernel): the two-kernel
//     oracle with the masked score tensor in device memory between them.
// Up to 8 bits all three run the cluster kernel of attn_cluster.cuh in its
// three modes (entries attn_fused, attn_scores, attn_pv); log operands of
// 9..12 bits run this file's template (entries attn_fused_wide,
// attn_scores_wide, attn_pv_wide), by kernels/attn_gemm.py fused_route and
// materialized_route.  The template's oracle pair also stays callable at 8
// bits when a caller forces it (kernels/attn_gemm.py
// _attn_materialized_forced(..., route="template")): it is separate code,
// so it is the cluster kernel's independent witness on the card.
// The template's three kernels are attn_kernel<PATH, COMP, QT, MODE>,
// whose stages are the same __device__ functions (score_tile,
// online_step, flush), so its fused form == materialized bit for bit on
// one card; attn_cluster.cuh computes the same values in the same float
// order, so each of its modes equals the template's bit for bit too.
//
// What it computes, per (batch b, head h), with hk = h / (H / KH):
//   qi = q(b,h) quantized at sq_s[b,h], ki/vi at sk_s/sv_s[b,hk]
//   per kv block of bk keys (the reference's bk: the online softmax is
//   tiled along kv, so bk is part of the numerics):
//     s  = float(sum_d prod(qi, ki)) * ((sq_s * sk_s) * sm_scale), masked
//          to NEG_INF where !(kval & causal & window)
//     m' = max(m, max_j s);  corr = exp(m - m');  p = mask ? exp(s - m') : 0
//     l' = l * corr + sum_j p;  pq = rint(p * qmax)
//     acc' = acc * corr + float(sum_j prod(pq, vi)) * (sv_s / qmax)
//   out = acc / max(l, 1e-30)
// prod is the path's integer product: mxu a*b; lut the int16 full table
// at ((a+half) << bits) + (b+half); nibble the four int32 half-word
// sub-tables with the signs restored; log the Mitchell / Log-our
// product of log_gemm.cu.  Integer sums wrap at 32 bits (uint32), as the
// reference's int32 sums.  Every float operation is written with the
// _rn intrinsics, so none is contracted into an FMA, and the order is
// that of the reference's _score_step / _online_step; only the order of
// the sum over p (a fixed warp butterfly here) differs from the plain
// version's.
//
// What bounds it on an H100: the integer products, 2*B*H*Sq*Skv*D of
// them: shared-memory gathers (lut: one, nibble: four a product) at most
// 132 SMs x 32 words a clock, or about 28 (log_our) / 11 (mitchell) int32
// operations a product at 132 x 64 lanes a clock.  Bytes (q/k/v read
// once, the output written once, at 3.35 TB/s) bound only the shortest
// sequences.
//
// The template's design (the wide log operands' three kernels, and the
// witness; attn_cluster.cuh says what the cluster kernel does instead): one
// block per (q block of bq rows, h, b) loops over the kv blocks; GQA
// reads k/v at hk with no repeat.  q/k/v are quantized on load
// (__fdiv_rn + rintf, clipped to +-qmax; build without fast-math)
// into int8 tiles (int16 on the log path, which admits 12-bit operands),
// k transposed so that neighbouring threads read neighbouring keys.  The
// f32 (bq, bk) score tile, the int16 probability tile, the f32 (bq, D)
// accumulator and the table live in dynamic shared memory: at bq 32, bk
// 128, D 128 the lut path takes 210,432 bytes of the 232,448 a block may
// use.  The planner (core/approx_gemm._attn_kernel_fits) sizes plans with
// kernels/attn_gemm.py's attn_smem_bytes; every launch passes that total
// in, and a total that differs from layout()'s refuses the launch.
// Ragged q and kv tails are masked, not padded.  No tensor cores, no
// asynchronous copies: the simple correct form.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_cluster.cuh"

namespace {

using cim::al16;
using cim::decompose;
using cim::log_mag;
using cim::lod;
using cim::quantize;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float EPS_L = 1e-30f;

enum { MXU = 0, LUT = 1, NIBBLE = 2, LOG = 3 };
enum { FUSED = 0, SCORES = 1, PV = 2 };

struct Args {
  const float *q, *k, *v, *sq_s, *sk_s, *sv_s;
  const int *qpos, *kpos, *kval;
  const void* tab;
  float* out;
  float* scores;
  int B, H, KH, Sq, Skv, D, bq, bk, bits, compensated, causal, window;
  int smem;  // the caller's shared-memory total, held against layout()
};

__host__ __device__ inline size_t table_bytes(int path, int bits) {
  if (path == LUT) return (static_cast<size_t>(1) << (2 * bits)) * 2;
  if (path == NIBBLE) return 4 * (static_cast<size_t>(1) << bits) * 4;
  return 0;
}

// byte offsets into dynamic shared memory (kernels/attn_gemm.py's
// attn_smem_bytes computes the same total; launch() checks that it does)
struct Layout {
  size_t tab, acc, s, m, l, corr, kpos, kval, qpos, pq, q, kT, v, total;
};

__host__ __device__ inline Layout layout(int path, int bits, int bq, int bk,
                                         int d) {
  const size_t qt = path == LOG ? 2 : 1;
  const size_t BQ = bq, BK = bk, D = d;
  Layout L;
  size_t o = 0;
  L.tab = o;  o += al16(table_bytes(path, bits));
  L.acc = o;  o += al16(4 * BQ * D);
  L.s = o;    o += al16(4 * BQ * BK);
  L.m = o;    o += al16(4 * BQ);
  L.l = o;    o += al16(4 * BQ);
  L.corr = o; o += al16(4 * BQ);
  L.kpos = o; o += al16(4 * BK);
  L.kval = o; o += al16(4 * BK);
  L.qpos = o; o += al16(4 * BQ);
  L.pq = o;   o += al16(2 * BQ * BK);
  L.q = o;    o += al16(qt * BQ * D);
  L.kT = o;   o += al16(qt * BK * D);
  L.v = o;    o += al16(qt * BK * D);
  L.total = o;
  return L;
}

__device__ __forceinline__ bool valid(int qp, int kp, int kv, int causal,
                                      int window) {
  bool m = kv != 0;
  if (causal) m = m && kp <= qp;
  if (window > 0) m = m && kp > qp - window;
  return m;
}

// --- the path's signed integer product, as a uint32 summand -------------

template <int PATH, bool COMP>
__device__ __forceinline__ uint32_t product(int a, int b, const void* tab,
                                            int bits) {
  if constexpr (PATH == MXU) {
    return static_cast<uint32_t>(a * b);
  } else if constexpr (PATH == LUT) {
    const int half = 1 << (bits - 1);
    const int16_t* t = static_cast<const int16_t*>(tab);
    return static_cast<uint32_t>(
        static_cast<int32_t>(t[((a + half) << bits) + (b + half)]));
  } else if constexpr (PATH == NIBBLE) {
    const int h = bits >> 1, hb = 1 << h, sz = hb * hb;
    const int qm = (1 << (bits - 1)) - 1;
    const int am = min(abs(a), qm), bm = min(abs(b), qm);
    const int ah = am >> h, al = am & (hb - 1);
    const int bh = bm >> h, bl = bm & (hb - 1);
    const int32_t* t = static_cast<const int32_t*>(tab);
    const int mag = t[ah * hb + bh] + t[sz + ah * hb + bl] +
                    t[2 * sz + al * hb + bh] + t[3 * sz + al * hb + bl];
    const int s = ((a > 0) - (a < 0)) * ((b > 0) - (b < 0));
    return static_cast<uint32_t>(s * mag);
  } else {
    const int4 x = decompose(a, bits), y = decompose(b, bits);
    return static_cast<uint32_t>(x.z * y.z) * log_mag<COMP>(x, y, bits);
  }
}

// --- the stages the three kernels share ---------------------------------

// s[i, j] for the block's rows against the staged kv block
template <int PATH, bool COMP, typename QT>
__device__ void score_tile(const Args& a, const Layout& L, unsigned char* sm,
                           int rows, float scale) {
  const QT* q = reinterpret_cast<const QT*>(sm + L.q);
  const QT* kT = reinterpret_cast<const QT*>(sm + L.kT);
  const int* kpos = reinterpret_cast<const int*>(sm + L.kpos);
  const int* kval = reinterpret_cast<const int*>(sm + L.kval);
  const int* qpos = reinterpret_cast<const int*>(sm + L.qpos);
  float* s = reinterpret_cast<float*>(sm + L.s);
  const void* tab = sm + L.tab;
  const int bk = a.bk, d = a.D;
  for (int e = threadIdx.x; e < rows * bk; e += THREADS) {
    const int i = e / bk, j = e - i * bk;
    uint32_t acc = 0u;
    for (int c = 0; c < d; ++c) {
      acc += product<PATH, COMP>(q[i * d + c], kT[c * bk + j], tab, a.bits);
    }
    const float sc =
        __fmul_rn(static_cast<float>(static_cast<int32_t>(acc)), scale);
    s[e] = valid(qpos[i], kpos[j], kval[j], a.causal, a.window) ? sc
                                                                 : NEG_INF;
  }
}

// the online-softmax update and PV against the staged score tile
template <int PATH, bool COMP, typename QT>
__device__ void online_step(const Args& a, const Layout& L, unsigned char* sm,
                            int rows, float vscale) {
  const float* s = reinterpret_cast<const float*>(sm + L.s);
  float* m = reinterpret_cast<float*>(sm + L.m);
  float* l = reinterpret_cast<float*>(sm + L.l);
  float* corr = reinterpret_cast<float*>(sm + L.corr);
  const int* kpos = reinterpret_cast<const int*>(sm + L.kpos);
  const int* kval = reinterpret_cast<const int*>(sm + L.kval);
  const int* qpos = reinterpret_cast<const int*>(sm + L.qpos);
  int16_t* pq = reinterpret_cast<int16_t*>(sm + L.pq);
  const QT* v = reinterpret_cast<const QT*>(sm + L.v);
  float* acc = reinterpret_cast<float*>(sm + L.acc);
  const void* tab = sm + L.tab;
  const int bk = a.bk, d = a.D;
  const float qmf = static_cast<float>((1 << (a.bits - 1)) - 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += WARPS) {   // one warp per row
    float mx = __int_as_float(static_cast<int>(0xff800000u));  // -inf: fmaxf's identity
    for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, s[i * bk + j]);
    for (int o = 16; o; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = m[i];
    const float m_new = fmaxf(m_prev, mx);
    const float cr = expf(__fsub_rn(m_prev, m_new));
    float ps = 0.f;
    for (int j = lane; j < bk; j += 32) {
      // the mask, not the score value, is authoritative: on a fully
      // masked row s == m_new == NEG_INF and exp(0) = 1 would be wrong
      const float p = valid(qpos[i], kpos[j], kval[j], a.causal, a.window)
                          ? expf(__fsub_rn(s[i * bk + j], m_new))
                          : 0.f;
      ps = __fadd_rn(ps, p);
      pq[i * bk + j] = static_cast<int16_t>(rintf(__fmul_rn(p, qmf)));
    }
    for (int o = 16; o; o >>= 1)
      ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, o));
    __syncwarp();
    if (lane == 0) {
      m[i] = m_new;
      l[i] = __fadd_rn(__fmul_rn(l[i], cr), ps);
      corr[i] = cr;
    }
  }
  __syncthreads();  // pq and corr are visible
  for (int e = threadIdx.x; e < rows * d; e += THREADS) {
    const int i = e / d, c = e - i * d;
    uint32_t pv = 0u;
    for (int j = 0; j < bk; ++j) {
      pv += product<PATH, COMP>(pq[i * bk + j], v[j * d + c], tab, a.bits);
    }
    acc[e] = __fadd_rn(
        __fmul_rn(acc[e], corr[i]),
        __fmul_rn(static_cast<float>(static_cast<int32_t>(pv)), vscale));
  }
}

template <int PATH, bool COMP, typename QT, int MODE>
__global__ void __launch_bounds__(THREADS) attn_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Layout L = layout(PATH, a.bits, a.bq, a.bk, a.D);
  const int q0 = blockIdx.x * a.bq, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.KH);
  const int rows = min(a.bq, a.Sq - q0);
  const int bk = a.bk, d = a.D, tid = threadIdx.x;
  const int qm = (1 << (a.bits - 1)) - 1;

  {  // the table: 16-byte copies (the wrapper checks the alignment)
    const int n16 = static_cast<int>(table_bytes(PATH, a.bits) / 16);
    const int4* src = reinterpret_cast<const int4*>(a.tab);
    int4* dst = reinterpret_cast<int4*>(sm + L.tab);
    for (int i = tid; i < n16; i += THREADS) dst[i] = src[i];
  }
  float* m = reinterpret_cast<float*>(sm + L.m);
  float* l = reinterpret_cast<float*>(sm + L.l);
  float* acc = reinterpret_cast<float*>(sm + L.acc);
  float* s = reinterpret_cast<float*>(sm + L.s);
  int* qpos = reinterpret_cast<int*>(sm + L.qpos);
  int* kpos = reinterpret_cast<int*>(sm + L.kpos);
  int* kval = reinterpret_cast<int*>(sm + L.kval);
  QT* qt = reinterpret_cast<QT*>(sm + L.q);
  QT* kT = reinterpret_cast<QT*>(sm + L.kT);
  QT* vt = reinterpret_cast<QT*>(sm + L.v);

  const float sq_s = a.sq_s[b * a.H + h];
  const float sk_s = a.sk_s[b * a.KH + hk];
  const float sv_s = a.sv_s[b * a.KH + hk];
  // (sq_s * sk_s) * sm_scale, sm_scale = 1/sqrt(D) rounded once to f32
  const float sm_scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const float scale = __fmul_rn(__fmul_rn(sq_s, sk_s), sm_scale);
  const float vscale = __fdiv_rn(sv_s, static_cast<float>(qm));

  for (int i = tid; i < rows; i += THREADS) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    qpos[i] = a.qpos[static_cast<size_t>(b) * a.Sq + q0 + i];
  }
  const size_t qrow0 = (static_cast<size_t>(b) * a.H + h) * a.Sq + q0;
  if constexpr (MODE != SCORES) {
    for (int e = tid; e < rows * d; e += THREADS) acc[e] = 0.f;
  }
  if constexpr (MODE != PV) {
    const float* qg = a.q + qrow0 * d;
    for (int e = tid; e < rows * d; e += THREADS)
      qt[e] = static_cast<QT>(quantize(qg[e], sq_s, qm));
  }

  const size_t kv0 = (static_cast<size_t>(b) * a.KH + hk) * a.Skv;
  const int nk = (a.Skv + bk - 1) / bk;
  const size_t skvp = static_cast<size_t>(nk) * bk;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * bk;
    const int nv = min(bk, a.Skv - k0);   // keys of this block inside Skv
    __syncthreads();  // the previous block's tiles are consumed
    for (int j = tid; j < bk; j += THREADS) {
      const size_t g = static_cast<size_t>(b) * a.Skv + k0 + j;
      kpos[j] = j < nv ? a.kpos[g] : 0;
      kval[j] = j < nv ? a.kval[g] : 0;
    }
    if constexpr (MODE != PV) {
      const float* kg = a.k + (kv0 + k0) * d;
      for (int e = tid; e < bk * d; e += THREADS) {
        const int j = e / d, c = e - j * d;
        kT[c * bk + j] =
            static_cast<QT>(j < nv ? quantize(kg[e], sk_s, qm) : 0);
      }
    }
    if constexpr (MODE != SCORES) {
      const float* vg = a.v + (kv0 + k0) * d;
      for (int e = tid; e < bk * d; e += THREADS) {
        const int j = e / d;
        vt[e] = static_cast<QT>(j < nv ? quantize(vg[e], sv_s, qm) : 0);
      }
    }
    if constexpr (MODE == PV) {
      for (int e = tid; e < rows * bk; e += THREADS) {
        const int i = e / bk, j = e - i * bk;
        s[e] = a.scores[(qrow0 + i) * skvp + k0 + j];
      }
    }
    __syncthreads();  // table (first block), tiles and positions visible
    if constexpr (MODE != PV) {
      score_tile<PATH, COMP, QT>(a, L, sm, rows, scale);
      __syncthreads();
    }
    if constexpr (MODE == SCORES) {
      for (int e = tid; e < rows * bk; e += THREADS) {
        const int i = e / bk, j = e - i * bk;
        a.scores[(qrow0 + i) * skvp + k0 + j] = s[e];
      }
    } else {
      online_step<PATH, COMP, QT>(a, L, sm, rows, vscale);
    }
  }
  if constexpr (MODE != SCORES) {
    __syncthreads();
    float* og = a.out + qrow0 * d;
    for (int e = tid; e < rows * d; e += THREADS) {
      og[e] = __fdiv_rn(acc[e], fmaxf(l[e / d], EPS_L));
    }
  }
}

template <int PATH, bool COMP, typename QT, int MODE>
int launch(const Args& a, cudaStream_t stream) {
  const Layout L = layout(PATH, a.bits, a.bq, a.bk, a.D);
  if (L.total != static_cast<size_t>(a.smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_kernel<PATH, COMP, QT, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Sq + a.bq - 1) / a.bq, a.H, a.B);
  kern<<<grid, THREADS, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(const Args& a, int path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Skv <= 0 || a.KH <= 0 ||
      a.H % a.KH != 0 || a.bq <= 0 || a.bk <= 0 || a.D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (path) {
    case MXU:
      return launch<MXU, false, int8_t, MODE>(a, st);
    case LUT:
      return launch<LUT, false, int8_t, MODE>(a, st);
    case NIBBLE:
      return launch<NIBBLE, false, int8_t, MODE>(a, st);
    case LOG:
      return a.compensated ? launch<LOG, true, int16_t, MODE>(a, st)
                           : launch<LOG, false, int16_t, MODE>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* sq_s,
               const void* sk_s, const void* sv_s, const void* qpos,
               const void* kpos, const void* kval, const void* tab,
               void* out, void* scores, int B, int H, int KH, int Sq,
               int Skv, int D, int bq, int bk, int bits, int compensated,
               int causal, int window, int smem) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.sq_s = static_cast<const float*>(sq_s);
  a.sk_s = static_cast<const float*>(sk_s);
  a.sv_s = static_cast<const float*>(sv_s);
  a.qpos = static_cast<const int*>(qpos);
  a.kpos = static_cast<const int*>(kpos);
  a.kval = static_cast<const int*>(kval);
  a.tab = tab;
  a.out = static_cast<float*>(out);
  a.scores = static_cast<float*>(scores);
  a.B = B; a.H = H; a.KH = KH; a.Sq = Sq; a.Skv = Skv; a.D = D;
  a.bq = bq; a.bk = bk; a.bits = bits; a.compensated = compensated;
  a.causal = causal; a.window = window; a.smem = smem;
  return a;
}

}  // namespace

// The template's three entry points take the same arguments: q
// (B,H,Sq,D), k/v (B,KH,Skv,D) f32; sq_s (B,H), sk_s/sv_s (B,KH) f32;
// qpos (B,Sq), kpos/kval (B,Skv) int32; tab (int16 full table, int32
// sub-tables, or null); out (B,H,Sq,D) f32; scores (B,H,Sq,Skvp) f32,
// Skvp = Skv rounded up to bk; path 0..3 = mxu, lut, nibble, log; window
// 0 = none; smem the caller's shared-memory total (cudaErrorInvalidValue
// if it is not this file's layout).
#define ATTN_ENTRY(NAME, MODE)                                               \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* sq_s, const void* sk_s, const void* sv_s,  \
                      const void* qpos, const void* kpos, const void* kval,  \
                      const void* tab, void* out, void* scores, int B,       \
                      int H, int KH, int Sq, int Skv, int D, int bq, int bk, \
                      int bits, int path, int compensated, int causal,       \
                      int window, int smem, void* stream) {                  \
    return dispatch<MODE>(                                                   \
        make_args(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, tab, out,     \
                  scores, B, H, KH, Sq, Skv, D, bq, bk, bits, compensated,   \
                  causal, window, smem),                                     \
        path, stream);                                                       \
  }

ATTN_ENTRY(attn_fused_wide, FUSED)
ATTN_ENTRY(attn_scores_wide, SCORES)
ATTN_ENTRY(attn_pv_wide, PV)

namespace {

// One launch of the cluster kernel (attn_cluster.cuh) in `mode`
int cluster_entry(int mode, const void* q, const void* k, const void* v,
                  const void* sq_s, const void* sk_s, const void* sv_s,
                  const void* qpos, const void* kpos, const void* kval,
                  const void* tab, void* out, void* scores, int B, int H,
                  int KH, int Sq, int Skv, int D, int bk, int bits, int path,
                  int compensated, int causal, int window, int bq,
                  int splits, int per, int rk, int smem, void* stream) {
  attn::AcArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.sq_s = static_cast<const float*>(sq_s);
  a.sk_s = static_cast<const float*>(sk_s);
  a.sv_s = static_cast<const float*>(sv_s);
  a.qpos = static_cast<const int*>(qpos);
  a.kpos = static_cast<const int*>(kpos);
  a.kval = static_cast<const int*>(kval);
  a.tab = static_cast<const unsigned char*>(tab);
  a.out = static_cast<float*>(out);
  a.scores = static_cast<float*>(scores);
  a.B = B; a.H = H; a.KH = KH; a.Sq = Sq; a.Skv = Skv; a.D = D; a.bk = bk;
  a.bits = bits; a.causal = causal; a.window = window;
  a.bq = bq; a.splits = splits; a.per = per; a.rk = rk;
  a.n_qt = 0; a.skvp = 0; a.kv_async = 0; a.sc_async = 0;
  return attn::ac_launch(a, path, compensated, mode, smem,
                         static_cast<cudaStream_t>(stream));
}

}  // namespace

// The cluster kernel (attn_cluster.cuh), operands of 2..8 bits: the
// template's tensors (each mode reads or writes only its own: attn_fused
// q, k, v to out; attn_scores q, k to scores; attn_pv scores, v to out;
// the others may be null), then the plan of kernels/attn_gemm.py
// attn_cluster_plan: bq query rows a tile, the kv blocks in `splits`
// ranges of `per` blocks, rk keys a ring tile, and smem its shared-memory
// total (cudaErrorInvalidValue for a plan or a total the kernel does not
// take).
#define CLUSTER_ENTRY(NAME, MODE)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* sq_s, const void* sk_s, const void* sv_s,  \
                      const void* qpos, const void* kpos, const void* kval,  \
                      const void* tab, void* out, void* scores, int B,       \
                      int H, int KH, int Sq, int Skv, int D, int bk,         \
                      int bits, int path, int compensated, int causal,       \
                      int window, int bq, int splits, int per, int rk,       \
                      int smem, void* stream) {                              \
    return cluster_entry(MODE, q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval,  \
                         tab, out, scores, B, H, KH, Sq, Skv, D, bk, bits,   \
                         path, compensated, causal, window, bq, splits, per, \
                         rk, smem, stream);                                  \
  }

CLUSTER_ENTRY(attn_fused, attn::AC_FUSED)
CLUSTER_ENTRY(attn_scores, attn::AC_SCORES)
CLUSTER_ENTRY(attn_pv, attn::AC_PV)

// The clusters of `splits` blocks of the cluster kernel for `path`,
// `compensated` and `mode` (0 attn_fused, 1 attn_scores: blocks, splits 1;
// 2 attn_pv) at `smem` bytes of shared memory that the current device
// holds at once, into *out (attn_cluster_plan's waves)
extern "C" int attn_cluster_capacity(int path, int compensated, int mode,
                                     int smem, int splits, int* out) {
  return attn::ac_capacity(path, compensated, mode, smem, splits, out);
}
