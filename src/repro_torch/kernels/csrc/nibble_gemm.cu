// nibble_gemm.cu - nibble sub-LUT GEMM for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/approx_matmul.py:
//   nibble_lut_matmul       (-> _nibble_int_kernel):   int8 x, w -> int32
//   nibble_lut_matmul_fused (-> _nibble_fused_kernel): f32/bf16 x, w ->
//     f32, quantization on load and the (acc * sx) * sw epilogue.
//   nibble_lut_matmul_partial (-> _nibble_fused_kernel, epilogue off):
//     the mesh path's shard-local form, global scales in, the raw int32
//     sum out (QuantIntOut).
// Both are cim_gemm.cuh's gemm_kernel with the NibbleCore: for a
// multiplier whose table is half-word decomposable (core/luts.py
// nibble_sub_luts: the exact family always, appro42 when its approximate
// columns lie in the low half-word), every product is rebuilt from four
// 2^{b/2} x 2^{b/2} sub-tables on saturated magnitudes,
//   sign(a) sign(b) (S_hh[ah,bh] + S_hl[ah,bl] + S_lh[al,bh] + S_ll[al,bl]),
// the same products as attn_gemm.cu's nibble path.
//
// What bounds it on an H100: four shared-memory gathers a product, at
// most 132 SMs x 32 words a clock (4*M*K*N gathers); bytes (x and w read
// once, the output written once, at 3.35 TB/s) only at a handful of rows.
//
// Design: the four int32 sub-tables take 4 KiB at 8 bits (the full
// table's int16 form takes 128 KiB), so several blocks share an SM.  Each
// operand is split into its hi/lo nibble offsets and sign once, when it
// is staged in shared memory; the inner loop does the four gathers, the
// sum and the sign (cim_gemm.cuh).

#include "cim_gemm.cuh"

extern "C" {

// int8 (M,K) x int8 (K,N) -> int32 (M,N); subs: 4 * 2^bits int32 entries
int nibble_gemm_int8(const void* x, const void* w, const void* subs,
                     void* out, int M, int K, int N, int bits,
                     void* stream) {
  return cim::dense_int8<cim::NibbleCore>(x, w, subs, out, M, K, N, bits,
                                          stream);
}

// f32 or bf16 (M,K) x f32 or bf16 (K,N) -> f32 (M,N); sx: one f32 on the
// device, sw: N f32 on the device
int nibble_gemm_fused(const void* x, int x_bf16, const void* w, int w_bf16,
                      const void* subs, const void* sx, const void* sw,
                      void* out, int M, int K, int N, int bits,
                      void* stream) {
  return cim::dense_quant<cim::NibbleCore>(x, x_bf16, w, w_bf16, subs, sx,
                                           sw, out, cim::ScaleOut{}, M, K, N,
                                           bits, stream);
}

// as nibble_gemm_fused, out: the raw int32 sum (M,N)
int nibble_gemm_partial(const void* x, int x_bf16, const void* w, int w_bf16,
                        const void* subs, const void* sx, const void* sw,
                        void* out, int M, int K, int N, int bits,
                        void* stream) {
  return cim::dense_quant<cim::NibbleCore>(x, x_bf16, w, w_bf16, subs, sx,
                                           sw, out, cim::QuantIntOut{}, M, K,
                                           N, bits, stream);
}

}  // extern "C"
