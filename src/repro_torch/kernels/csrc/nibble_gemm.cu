// nibble_gemm.cu - nibble sub-LUT GEMM for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/approx_matmul.py:
//   nibble_lut_matmul       (-> _nibble_int_kernel):   int8 x, w -> int32
//   nibble_lut_matmul_fused (-> _nibble_fused_kernel): f32/bf16 x, w ->
//     f32, quantization on load and the (acc * sx) * sw epilogue.
//   nibble_lut_matmul_partial (-> _nibble_fused_kernel, epilogue off):
//     the mesh path's shard-local form, global scales in, the raw int32
//     sum out (QuantIntOut).
// For a multiplier whose table is half-word decomposable (core/luts.py
// nibble_sub_luts: the exact family always, appro42 when its approximate
// columns lie in the low half-word), every product is rebuilt from four
// 2^{b/2} x 2^{b/2} sub-tables on saturated magnitudes,
//   sign(a) sign(b) (S_hh[ah,bh] + S_hl[ah,bl] + S_lh[al,bh] + S_ll[al,bl]),
// the same products as attn_gemm.cu's nibble path.  Every form is
// cluster_gemm.cuh's split-K cluster kernel with the ClusterNibbleCore,
// which folds the four sub-tables into two signed ones once a block (two
// conflict-free gathers a product): the fused form with its epilogue on
// (ScaleOut), the partial form with it off (QuantIntOut), the int form on
// int8 operands (IntOut: an 8-stage ring of 64 k, no scale read), whose
// staging saturates |a| and |b| at qmax as the reference does (int8 -128,
// and below 8 bits every magnitude past qmax).  cim_gemm.cuh's NibbleCore
// stays for the attention and conv tile kernels, which stage through it.
//
// What bounds it on an H100: the two shared-memory gathers a product, at
// most 132 SMs x 32 words a clock (2*M*K*N gathers); bytes (x and w read
// once, the output written once, at 3.35 TB/s) only at a handful of rows.

#include "cim_gemm.cuh"
#include "cluster_gemm.cuh"

namespace {

// the cluster kernel takes even widths of 2..8 bits only
inline bool even_bits(int bits) { return bits % 2 == 0; }

}  // namespace

extern "C" {

// int8 (M,K) x int8 (K,N) -> int32 (M,N); subs: 4 * 2^bits int32 entries;
// rb, splits, k_split: the launch plan (kernels/approx_matmul.py
// cluster_plan), rows 4 or 16
int nibble_gemm_int8_cluster(const void* x, const void* w, const void* subs,
                             void* out, int M, int K, int N, int bits,
                             int rb, int splits, int k_split, void* stream) {
  if (!even_bits(bits)) return static_cast<int>(cudaErrorInvalidValue);
  return cim::cluster_gemm_int8<cim::ClusterNibbleCore>(
      x, w, subs, out, M, K, N, bits, rb, splits, k_split, stream);
}

// the clusters of `splits` blocks of nibble_gemm_int8_cluster's kernel for
// `rb` rows that the device holds at once, into *out (the plan's waves)
int nibble_gemm_int8_cluster_capacity(int rb, int bits, int splits,
                                      int* out) {
  if (!even_bits(bits)) return static_cast<int>(cudaErrorInvalidValue);
  return cim::cluster_capacity_int8<cim::ClusterNibbleCore>(rb, bits,
                                                            splits, out);
}

// f32 or bf16 (M,K) x f32 or bf16 (K,N) -> f32 (M,N); sx: one f32 on the
// device, sw: N f32 on the device; rb, splits, k_split: the launch plan
// (kernels/approx_matmul.py cluster_plan)
int nibble_gemm_fused(const void* x, int x_bf16, const void* w, int w_bf16,
                      const void* subs, const void* sx, const void* sw,
                      void* out, int M, int K, int N, int bits, int rb,
                      int splits, int k_split, void* stream) {
  if (!even_bits(bits)) return static_cast<int>(cudaErrorInvalidValue);
  return cim::cluster_gemm<cim::ClusterNibbleCore, cim::ScaleOut>(
      x, x_bf16, w, w_bf16, subs, sx, sw, out, M, K, N, bits, rb, splits,
      k_split, stream);
}

// the clusters of `splits` blocks of nibble_gemm_fused's kernel for `rb`
// rows that the device holds at once, into *out (the launch plan's waves)
int nibble_gemm_fused_capacity(int rb, int bits, int x_bf16, int w_bf16,
                               int splits, int* out) {
  if (!even_bits(bits)) return static_cast<int>(cudaErrorInvalidValue);
  return cim::cluster_capacity<cim::ClusterNibbleCore, cim::ScaleOut>(
      rb, bits, x_bf16, w_bf16, splits, out);
}

// as nibble_gemm_fused, out: the raw int32 sum (M,N)
int nibble_gemm_partial(const void* x, int x_bf16, const void* w,
                        int w_bf16, const void* subs, const void* sx,
                        const void* sw, void* out, int M, int K, int N,
                        int bits, int rb, int splits, int k_split,
                        void* stream) {
  if (!even_bits(bits)) return static_cast<int>(cudaErrorInvalidValue);
  return cim::cluster_gemm<cim::ClusterNibbleCore, cim::QuantIntOut>(
      x, x_bf16, w, w_bf16, subs, sx, sw, out, M, K, N, bits, rb, splits,
      k_split, stream);
}

// as nibble_gemm_fused_capacity, of nibble_gemm_partial's kernel
int nibble_gemm_partial_capacity(int rb, int bits, int x_bf16, int w_bf16,
                                 int splits, int* out) {
  if (!even_bits(bits)) return static_cast<int>(cudaErrorInvalidValue);
  return cim::cluster_capacity<cim::ClusterNibbleCore, cim::QuantIntOut>(
      rb, bits, x_bf16, w_bf16, splits, out);
}

}  // extern "C"
