// log_gemm.cu - log-domain (Mitchell / Log-our) GEMM for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/mitchell_gemm.py:
//   mitchell_matmul       (-> _kernel):       int8 x, w -> int32
//   mitchell_matmul_fused (-> _fused_kernel): f32/bf16 x, w -> f32, with
//     quantization on load and the (acc * sx) * sw epilogue.
//   mitchell_matmul_partial (-> _fused_kernel, epilogue off): the mesh
//     path's shard-local form, global scales in, the raw int32 sum out
//     (QuantIntOut).
// The int, fused and partial forms of 2..8-bit operands
// (log_gemm_int8_cluster, log_gemm_fused, log_gemm_partial) are
// cluster_gemm.cuh's split-K cluster kernel with
// ClusterLogCore<compensated> (epilogues IntOut, ScaleOut, QuantIntOut),
// its operands staged as signed byte pairs whose dot product is the
// Mitchell product; those of 9..16-bit operands (log_gemm_int8_wide,
// log_gemm_fused_wide, log_gemm_partial_wide) are cim_gemm.cuh's
// gemm_kernel with LogCore<compensated>.  kernels/mitchell_gemm.py
// fused_route chooses between the two by the bits.
//
// What it computes, per scalar pair (a, b), following _log_product of
// the reference line for line: x = |a|, y = |b|, k = leading-one
// position (k = 0 for 0), q = value - 2^k,
//   p = 2^(k1+k2) + q1*2^k2 + q2*2^k1                   (mitchell)
//   p = (2^(k1+k2) | comp) + q1*2^k2 + q2*2^k1          (log_our)
//       comp = q_small << (LoD(q_big) + round_up), 0 if q_big == 0,
//       round_up = (q_big << 1) >= 3 * 2^LoD(q_big)
// then a zero guard (x == 0 or y == 0 gives 0), then the sign, summed
// over K in 32 bits with two's-complement wrap (unsigned accumulation:
// at 16-bit operands the int32 sum can overflow, and the reference
// wraps).
//
// What bounds it on an H100: int32 ALU work.  Counted from log_mag and
// the inner loop, one product costs about 28 integer operations with
// compensation and 11 without (shifts, adds, min/max, clz, compares,
// selects, the sign multiply and the accumulate), at most 132 SMs x 64
// int32 lanes a clock.  Bytes (x and w read once, the output written
// once, at 3.35 TB/s) bound only a GEMM with a handful of rows.
//
// Design: each operand's (q, k, sign, magnitude) is worked out once when
// it is staged, so the inner loop does only the pairwise part;
// cluster_gemm.cuh stages it in a byte pair (mitchell) or one word
// (log_our) and splits K over a cluster (the template, cim_gemm.cuh,
// stages it in shared memory as four ints).

#include "cim_gemm.cuh"
#include "cluster_gemm.cuh"

template <class Epi>
static int log_quant(const void* x, int x_bf16, const void* w, int w_bf16,
                     const void* sx, const void* sw, void* out, Epi epi,
                     int M, int K, int N, int bits, int compensated,
                     void* stream) {
  if (compensated)
    return cim::dense_quant<cim::LogCore<true>>(x, x_bf16, w, w_bf16,
                                                nullptr, sx, sw, out, epi, M,
                                                K, N, bits, stream);
  return cim::dense_quant<cim::LogCore<false>>(x, x_bf16, w, w_bf16, nullptr,
                                               sx, sw, out, epi, M, K, N,
                                               bits, stream);
}

// log_gemm_fused and log_gemm_partial: the cluster kernel through Epi
template <class Epi>
static int log_cluster(const void* x, int x_bf16, const void* w, int w_bf16,
                       const void* sx, const void* sw, void* out, int M,
                       int K, int N, int bits, int compensated, int rb,
                       int splits, int k_split, void* stream) {
  if (compensated)
    return cim::cluster_gemm<cim::ClusterLogCore<true>, Epi>(
        x, x_bf16, w, w_bf16, nullptr, sx, sw, out, M, K, N, bits, rb,
        splits, k_split, stream);
  return cim::cluster_gemm<cim::ClusterLogCore<false>, Epi>(
      x, x_bf16, w, w_bf16, nullptr, sx, sw, out, M, K, N, bits, rb, splits,
      k_split, stream);
}

template <class Epi>
static int log_capacity(int rb, int bits, int compensated, int x_bf16,
                        int w_bf16, int splits, int* out) {
  if (compensated)
    return cim::cluster_capacity<cim::ClusterLogCore<true>, Epi>(
        rb, bits, x_bf16, w_bf16, splits, out);
  return cim::cluster_capacity<cim::ClusterLogCore<false>, Epi>(
      rb, bits, x_bf16, w_bf16, splits, out);
}

extern "C" {

// int8 (M,K) x int8 (K,N) -> int32 (M,N), 2..8-bit operands (log_our's
// of magnitude below 2^bits, kernels/mitchell_gemm.py); rb, splits,
// k_split: the launch plan (kernels/approx_matmul.py cluster_plan)
int log_gemm_int8_cluster(const void* x, const void* w, void* out, int M,
                          int K, int N, int bits, int compensated, int rb,
                          int splits, int k_split, void* stream) {
  if (compensated)
    return cim::cluster_gemm_int8<cim::ClusterLogCore<true>>(
        x, w, nullptr, out, M, K, N, bits, rb, splits, k_split, stream);
  return cim::cluster_gemm_int8<cim::ClusterLogCore<false>>(
      x, w, nullptr, out, M, K, N, bits, rb, splits, k_split, stream);
}

// the clusters of `splits` blocks of log_gemm_int8_cluster's kernel for
// `rb` rows that the device holds at once, into *out (the plan's waves)
int log_gemm_int8_cluster_capacity(int rb, int bits, int compensated,
                                   int splits, int* out) {
  if (compensated)
    return cim::cluster_capacity_int8<cim::ClusterLogCore<true>>(
        rb, bits, splits, out);
  return cim::cluster_capacity_int8<cim::ClusterLogCore<false>>(
      rb, bits, splits, out);
}

// as log_gemm_int8_cluster for 2..16-bit operands on the tiled template
// (the int form of 9..16-bit operands)
int log_gemm_int8_wide(const void* x, const void* w, void* out, int M,
                       int K, int N, int bits, int compensated,
                       void* stream) {
  if (compensated)
    return cim::dense_int8<cim::LogCore<true>>(x, w, nullptr, out, M, K, N,
                                               bits, stream);
  return cim::dense_int8<cim::LogCore<false>>(x, w, nullptr, out, M, K, N,
                                              bits, stream);
}

// f32 or bf16 (M,K) x f32 or bf16 (K,N) -> f32 (M,N), 2..8-bit operands;
// sx: one f32 on the device, sw: N f32 on the device; rb, splits,
// k_split: the launch plan (kernels/approx_matmul.py cluster_plan)
int log_gemm_fused(const void* x, int x_bf16, const void* w, int w_bf16,
                   const void* sx, const void* sw, void* out, int M, int K,
                   int N, int bits, int compensated, int rb, int splits,
                   int k_split, void* stream) {
  return log_cluster<cim::ScaleOut>(x, x_bf16, w, w_bf16, sx, sw, out, M, K,
                                    N, bits, compensated, rb, splits,
                                    k_split, stream);
}

// the clusters of `splits` blocks of log_gemm_fused's kernel for `rb`
// rows that the device holds at once, into *out (the launch plan's waves)
int log_gemm_fused_capacity(int rb, int bits, int compensated, int x_bf16,
                            int w_bf16, int splits, int* out) {
  return log_capacity<cim::ScaleOut>(rb, bits, compensated, x_bf16, w_bf16,
                                     splits, out);
}

// as log_gemm_fused for 2..16-bit operands on the tiled template (the
// fused form of 9..16-bit operands)
int log_gemm_fused_wide(const void* x, int x_bf16, const void* w,
                        int w_bf16, const void* sx, const void* sw, void* out,
                        int M, int K, int N, int bits, int compensated,
                        void* stream) {
  return log_quant(x, x_bf16, w, w_bf16, sx, sw, out, cim::ScaleOut{}, M, K,
                   N, bits, compensated, stream);
}

// as log_gemm_fused, out: the raw int32 sum (M,N)
int log_gemm_partial(const void* x, int x_bf16, const void* w, int w_bf16,
                     const void* sx, const void* sw, void* out, int M, int K,
                     int N, int bits, int compensated, int rb, int splits,
                     int k_split, void* stream) {
  return log_cluster<cim::QuantIntOut>(x, x_bf16, w, w_bf16, sx, sw, out, M,
                                       K, N, bits, compensated, rb, splits,
                                       k_split, stream);
}

// as log_gemm_fused_capacity, of log_gemm_partial's kernel
int log_gemm_partial_capacity(int rb, int bits, int compensated, int x_bf16,
                              int w_bf16, int splits, int* out) {
  return log_capacity<cim::QuantIntOut>(rb, bits, compensated, x_bf16,
                                        w_bf16, splits, out);
}

// as log_gemm_partial for 2..16-bit operands on the tiled template (the
// partial form of 9..16-bit operands)
int log_gemm_partial_wide(const void* x, int x_bf16, const void* w,
                          int w_bf16, const void* sx, const void* sw,
                          void* out, int M, int K, int N, int bits,
                          int compensated, void* stream) {
  return log_quant(x, x_bf16, w, w_bf16, sx, sw, out, cim::QuantIntOut{}, M,
                   K, N, bits, compensated, stream);
}

}  // extern "C"
