// surrogate_gemm.cu - the fused surrogate CiM GEMM for NVIDIA Hopper
// (sm_90a): the compiler's default mode, `surrogate`.
//
// Replaces the TPU kernels of src/repro/kernels/cim_gemm.py:
//   cim_gemm_core  (:60 -> _kernel :33): int8 x (M,K), int8 w (K,N) ->
//     D = x @ w as int32 and SQ = x^2 @ w^2 as f32 (zeros without need_sq)
//   cim_gemm_fused (:141 -> :173 -> _fused_kernel :111): f32/bf16 x, w,
//     optional f32 eps (M,N) -> f32, with the per-tensor / per-column
//     quantization on load and the whole surrogate epilogue in the kernel:
//       out = (1+mu) D s + sqrt(max(c0 K s^2 + c1 SQ s^2, 0)) eps,
//       s = sx * sw (surrogate_cluster.cuh spells out the order of the
//       roundings);
//   and, for the mesh path's row-parallel layers, cim_gemm_partial: the
//     fused kernel with its flush off, the exact int32 sums out (D and,
//     with SQ, its four sums of squared halves) for the ranks to add over
//     the weight's K shards before the one flush.
//
// What bounds it on an H100: D is an int8 dot, 2 M K N operations the
// tensor cores do at 1,979 TOP/s (SQ, on the fused path, four times that
// again); the bytes (x and w read once, eps read and the output written
// once, at 3.35 TB/s) bound a GEMM of up to a few hundred rows: at M = 4
// and 64 reading the weight is the cost.
//
// Design.  cim_gemm_fused is surrogate_cluster.cuh's split-K cluster
// kernel: the launch plan of kernels/approx_matmul.py cluster_plan (K
// split over a cluster of at most 8 blocks by the clusters the device
// holds), cluster_gemm.cuh's cp.async operand ring, each weight element
// quantized once into int8 shared memory, D and SQ (an exact split of
// each square into two s8 halves, four more MMAs, combined in 64 bits
// and rounded once) on the int8 tensor cores, the int32 partials summed
// over the cluster through distributed shared memory and the surrogate
// epilogue after that sum; bitwise the plain version with and without
// noise.  Its three variants are separate instantiations, as the
// reference's compile-time flags were: without eps (the deterministic
// serving path) the kernel keeps no SQ sum and reads no eps; with eps and
// c1 == 0 it reads eps but sums no SQ.  mu, c0 and c1 are runtime
// arguments (compile-time constants in Pallas), folded on the host into
// f32(1+mu) and f32(c0 K) as the reference's weakly typed Python
// constants are.  cim_gemm_core without SQ runs on int8_mma.cuh's dense
// tensor-core kernel (K split across the blocks of a cluster, the int32
// partials summed through distributed shared memory) and writes SQ as
// zeros; with SQ it is cim_gemm.cuh's tiled template with IntSqCore (SQ
// summed with fmaf in K order on the CUDA cores), the oracle surface.

#include "cim_gemm.cuh"
#include "int8_mma.cuh"
#include "surrogate_cluster.cuh"

extern "C" {

// int8 (M,K) x int8 (K,N) -> D int32 (M,N), SQ f32 (M,N).  Without SQ
// the tensor-core form splits K into the blocks of one cluster a tile and
// sums their int32 partials through distributed shared memory in rank
// order, so it clears nothing and writes D once
int cim_gemm_core(const void* x, const void* w, void* d, void* sq, int M,
                  int K, int N, int need_sq, void* stream) {
  if (!need_sq) return cim::dense_int8_mma(x, w, d, sq, M, K, N, stream);
  const cim::Dense<int8_t> src{static_cast<const int8_t*>(x), K};
  return cim::launch<cim::IntSqCore>(
      src, static_cast<const int8_t*>(w), nullptr, nullptr, nullptr, d,
      cim::CoreOut{static_cast<float*>(sq)}, M, K, N, 8, stream);
}

// f32 or bf16 (M,K) x f32 or bf16 (K,N) -> f32 (M,N); sx: one f32 on the
// device, sw: N f32 on the device; eps: null (variant 0, no noise) or
// (M,N) f32 (variant 1: c1 == 0, no SQ; 2: with SQ); one_mu = f32(1 + mu),
// c0k = f32(c0 * K), c1 = f32(c1); rb, splits, k_split: the launch plan
// (kernels/approx_matmul.py cluster_plan)
int cim_gemm_fused(const void* x, int x_bf16, const void* w, int w_bf16,
                   const void* sx, const void* sw, const void* eps,
                   void* out, int M, int K, int N, int bits, float one_mu,
                   float c0k, float c1, int variant, int rb, int splits,
                   int k_split, void* stream) {
  return cim::surrogate_cluster(x, x_bf16, w, w_bf16, sx, sw, eps, out, M,
                                K, N, bits, one_mu, c0k, c1, variant, rb,
                                splits, k_split, stream);
}

// the clusters of `splits` blocks of cim_gemm_fused's kernel for `rb` rows
// and the variant that the device holds at once, into *out (the launch
// plan's waves)
int cim_gemm_fused_capacity(int rb, int variant, int x_bf16, int w_bf16,
                            int splits, int* out) {
  return cim::sg_capacity(rb, variant, x_bf16, w_bf16, splits, out);
}

// the mesh path's row-parallel partial of cim_gemm_fused: the same kernel
// with its flush off.  f32 or bf16 (M,K) x (K,N) quantized against the
// caller's global sx (one f32) and sw (N f32) -> int32 (1, M, N) D, or
// with need_sq (5, M, N): D, HH, HL, LH, LL (SQ = 2^14 HH + 2^7 (HL + LH)
// + LL once summed over the shards); rb, splits, k_split: the launch plan
int cim_gemm_partial(const void* x, int x_bf16, const void* w, int w_bf16,
                     const void* sx, const void* sw, void* out, int M, int K,
                     int N, int bits, int need_sq, int rb, int splits,
                     int k_split, void* stream) {
  return cim::surrogate_partial(x, x_bf16, w, w_bf16, sx, sw, out, M, K, N,
                                bits, need_sq, rb, splits, k_split, stream);
}

// the clusters of `splits` blocks of cim_gemm_partial's kernel for `rb`
// rows, with or without SQ's sums, that the device holds at once
int cim_gemm_partial_capacity(int rb, int need_sq, int x_bf16, int w_bf16,
                              int splits, int* out) {
  return cim::sg_partial_capacity(rb, need_sq, x_bf16, w_bf16, splits, out);
}

}  // extern "C"
