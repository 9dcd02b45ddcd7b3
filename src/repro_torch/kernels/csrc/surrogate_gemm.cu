// surrogate_gemm.cu - the fused surrogate CiM GEMM for NVIDIA Hopper
// (sm_90a): the compiler's default mode, `surrogate`.
//
// Replaces the TPU kernels of src/repro/kernels/cim_gemm.py:
//   cim_gemm_core  (:60 -> _kernel :33): int8 x (M,K), int8 w (K,N) ->
//     D = x @ w as int32 and SQ = x^2 @ w^2 as f32 (zeros without need_sq)
//   cim_gemm_fused (-> _fused_kernel): f32/bf16 x, w, optional f32 eps
//     (M,N) -> f32, with the per-tensor / per-column quantization on load
//     and the whole surrogate epilogue in the kernel:
//       out = (1+mu) D s + sqrt(max(c0 K s^2 + c1 SQ s^2, 0)) eps,
//       s = sx * sw (cim_gemm.cuh spells out the order of the roundings).
//
// What bounds it on an H100: D is an int8 dot, 2 M K N operations the
// tensor cores do at 1,979 TOP/s, and SQ M K N f32 FMAs at the CUDA
// cores' 132 SMs x 128 lanes a clock; the bytes (x and w read once, eps
// read and the output written once, at 3.35 TB/s) bound a GEMM of up to
// a few hundred rows: at M = 4 and 64 reading the weight is the cost.
//
// Design.  cim_gemm_core without SQ runs on the tensor cores
// (int8_mma.cuh's dense kernel: IMMA.16832 from int8 operands in a
// 4-stage cp.async ring, the weight transposed on chip by ldmatrix.trans
// and byte permutes, K split across the blocks of a cluster so that the
// grid fills the card, the int32 partials summed exactly through
// distributed shared memory), and writes SQ as zeros.  With SQ, and cim_gemm_fused, it is
// cim_gemm.cuh's gemm_kernel with the integer core: IntCore where no SQ
// is needed, IntSqCore (a^2 and b^2 staged as f32, SQ summed with fmaf in
// K order, the bound of its f32 FMAs) where it is; a 16 x 64 output block
// with the K loop inside the block, so D is exact and deterministic and
// SQ's sum order is fixed (K order, one rounding a step).  The variants
// are separate instantiations, as the reference's compile-time flags
// were: without eps (the deterministic serving path) the kernel keeps no
// SQ sum and reads no eps; with eps and c1 == 0 it reads eps but sums no
// SQ.  mu, c0 and c1 are runtime arguments (compile-time constants in
// Pallas), folded on the host into f32(1+mu) and f32(c0 K) as the
// reference's weakly typed Python constants are.

#include "cim_gemm.cuh"
#include "int8_mma.cuh"

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
// device, sw: N f32 on the device; eps: null (no noise) or (M,N) f32;
// one_mu = f32(1 + mu), c0k = f32(c0 * K), c1 = f32(c1)
int cim_gemm_fused(const void* x, int x_bf16, const void* w, int w_bf16,
                   const void* sx, const void* sw, const void* eps,
                   void* out, int M, int K, int N, int bits, float one_mu,
                   float c0k, float c1, void* stream) {
  const float* e = static_cast<const float*>(eps);
  if (e == nullptr)
    return cim::dense_quant<cim::IntCore>(
        x, x_bf16, w, w_bf16, nullptr, sx, sw, out,
        cim::SurrogateOut<false, false>{one_mu, c0k, c1, e}, M, K, N, bits,
        stream);
  if (c1 > 0.f)
    return cim::dense_quant<cim::IntSqCore>(
        x, x_bf16, w, w_bf16, nullptr, sx, sw, out,
        cim::SurrogateOut<true, true>{one_mu, c0k, c1, e}, M, K, N, bits,
        stream);
  return cim::dense_quant<cim::IntCore>(
      x, x_bf16, w, w_bf16, nullptr, sx, sw, out,
      cim::SurrogateOut<false, true>{one_mu, c0k, c1, e}, M, K, N, bits,
      stream);
}

}  // extern "C"
