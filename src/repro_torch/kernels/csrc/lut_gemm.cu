// lut_gemm.cu - full-LUT gather GEMM for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/approx_matmul.py:
//   lut_matmul       (-> _int_kernel):   int8 x (M,K), int8 w (K,N) -> int32
//   lut_matmul_fused (-> _fused_kernel): f32/bf16 x, w -> f32, with the
//     per-tensor / per-column quantization on load and the
//     (acc * sx) * sw epilogue inside the kernel.
//   lut_matmul_partial (-> _fused_kernel, epilogue off): the mesh path's
//     shard-local form over a slice of K: quantization on load against
//     the caller's global scales, the raw int32 sum out (QuantIntOut).
//   lut_matmul_mag (-> _int_kernel over the faulted table of
//     core/faults.py, the reference's _lut_for): the int form over the
//     table of magnitude products, uint16, the signs from the operands.
// Every form is cluster_gemm.cuh's split-K cluster kernel: the fused,
// partial and int forms with the ClusterLutCore, epilogue ScaleOut,
// QuantIntOut and IntOut (int8 operands in); the magnitude form with the
// ClusterMagLutCore (32 KiB of table at 8 bits), IntOut.  Each computes
// out[m,n] = sum_k LUT[(a+2^{b-1}) * 2^b + (b+2^{b-1})], LUT the signed
// product table of core/luts.signed_product_lut.
//
// What bounds it on an H100: every scalar product is one gather from
// the table in shared memory, so the floor is the shared-memory gather
// rate, at most 132 SMs x 32 words a clock (M*K*N gathers).  Bytes (x and
// w read once, the output written once, at 3.35 TB/s) bound a GEMM only
// when M is a handful of rows: a decode round (M=4) reads the whole
// weight for very few gathers per byte.
//
// Design: at 8 bits the table has 65,536 entries, 256 KiB as int32, more
// than the 227 KB of shared memory one block may use.  The host narrows
// it to int16 after checking that every entry fits (kernels/ops.py), and
// each block copies the 128 KiB table into dynamic shared memory once
// (one block per SM), then gathers row offset + column offset staged per
// K step; K is split over a cluster so that a decode GEMM (M = 4) fills
// the card (cluster_gemm.cuh).  A faulted table (stuck-at cells in its
// 2b-bit magnitude words) spans up to +-(2^16 - 1): it fits neither int16
// nor, as int32 (256 KiB), shared memory.  Its signed entries are
// sign(a) sign(b) uf[|a|, |b|] (core/faults.py, as luts.py builds the
// clean table), so the magnitude form holds uf's 2^{b-1} x 2^{b-1}
// used entries as uint16 (32 KiB at 8 bits, two blocks an SM) and
// restores the sign from the operands, bitwise the gather from the int32
// signed table; the sum stays in int32 (65,535 x K < 2^31 for K <
// 32,768, and wraps as the reference's beyond).

#include "cim_gemm.cuh"
#include "cluster_gemm.cuh"

extern "C" {

// int8 (M,K) x int8 (K,N) -> int32 (M,N); lut: 2^(2*bits) int16 entries;
// rb, splits, k_split: the launch plan (kernels/approx_matmul.py
// cluster_plan)
int lut_gemm_int8_cluster(const void* x, const void* w, const void* lut,
                          void* out, int M, int K, int N, int bits, int rb,
                          int splits, int k_split, void* stream) {
  return cim::cluster_gemm_int8<cim::ClusterLutCore>(
      x, w, lut, out, M, K, N, bits, rb, splits, k_split, stream);
}

// the clusters of `splits` blocks of lut_gemm_int8_cluster's kernel for
// `rb` rows that the device holds at once, into *out (the plan's waves)
int lut_gemm_int8_cluster_capacity(int rb, int bits, int splits, int* out) {
  return cim::cluster_capacity_int8<cim::ClusterLutCore>(rb, bits, splits,
                                                         out);
}

// int8 (M,K) x int8 (K,N) -> int32 (M,N); mag: the 2^(2*bits-2) uint16
// magnitude products (at least 8 entries: 16 bytes), signs restored from
// the operands (the faulted table's form, core/faults.py); the plan as
// lut_gemm_int8_cluster's, rows 4 or 16
int lut_gemm_int8_mag_cluster(const void* x, const void* w, const void* mag,
                              void* out, int M, int K, int N, int bits,
                              int rb, int splits, int k_split,
                              void* stream) {
  return cim::cluster_gemm_int8<cim::ClusterMagLutCore>(
      x, w, mag, out, M, K, N, bits, rb, splits, k_split, stream);
}

// as lut_gemm_int8_cluster_capacity, of lut_gemm_int8_mag_cluster's kernel
int lut_gemm_int8_mag_cluster_capacity(int rb, int bits, int splits,
                                       int* out) {
  return cim::cluster_capacity_int8<cim::ClusterMagLutCore>(rb, bits,
                                                            splits, out);
}

// f32 or bf16 (M,K) x f32 or bf16 (K,N) -> f32 (M,N); sx: one f32 on the
// device, sw: N f32 on the device; rb, splits, k_split: the launch plan
int lut_gemm_fused(const void* x, int x_bf16, const void* w, int w_bf16,
                   const void* lut, const void* sx, const void* sw,
                   void* out, int M, int K, int N, int bits, int rb,
                   int splits, int k_split, void* stream) {
  return cim::cluster_gemm<cim::ClusterLutCore, cim::ScaleOut>(
      x, x_bf16, w, w_bf16, lut, sx, sw, out, M, K, N, bits, rb, splits,
      k_split, stream);
}

// the clusters of `splits` blocks of lut_gemm_fused's kernel for `rb`
// rows that the device holds at once, into *out (the launch plan's waves)
int lut_gemm_fused_capacity(int rb, int bits, int x_bf16, int w_bf16,
                            int splits, int* out) {
  return cim::cluster_capacity<cim::ClusterLutCore, cim::ScaleOut>(
      rb, bits, x_bf16, w_bf16, splits, out);
}

// as lut_gemm_fused, out: the raw int32 sum (M,N)
int lut_gemm_partial(const void* x, int x_bf16, const void* w, int w_bf16,
                     const void* lut, const void* sx, const void* sw,
                     void* out, int M, int K, int N, int bits, int rb,
                     int splits, int k_split, void* stream) {
  return cim::cluster_gemm<cim::ClusterLutCore, cim::QuantIntOut>(
      x, x_bf16, w, w_bf16, lut, sx, sw, out, M, K, N, bits, rb, splits,
      k_split, stream);
}

// as lut_gemm_fused_capacity, of lut_gemm_partial's kernel
int lut_gemm_partial_capacity(int rb, int bits, int x_bf16, int w_bf16,
                              int splits, int* out) {
  return cim::cluster_capacity<cim::ClusterLutCore, cim::QuantIntOut>(
      rb, bits, x_bf16, w_bf16, splits, out);
}

}  // extern "C"
