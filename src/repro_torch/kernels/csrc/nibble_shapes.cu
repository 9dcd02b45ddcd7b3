// nibble_shapes.cu - the fused nibble GEMM of cluster_gemm.cuh
// (ClusterNibbleCore) at two block shapes, for the block-shape sweep of
// launch/cluster_sweep.py (--only nibble); no served path launches it.
//
//   shape 0: 512 threads (8 k groups), one block an SM;
//   shape 1: 256 threads (4 k groups), two blocks an SM: the shipped
//            core's shape;
// each with the frame's 64-row tile allowed beside 4 and 16, so the sweep
// can time a prefill (M = 64) in one 64-row tile and in four of 16, the
// shipped plan.  The arithmetic is the shipped kernel's: every shape is
// checked bitwise against nibble_lut_matmul_fused_plain by the sweep.

#include "cluster_gemm.cuh"

namespace cim {

struct NibbleShape512 : ClusterNibbleCore {
  static constexpr int THREADS = 512;
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int MAX_ROWS = 64;
};
struct NibbleShape256 : ClusterNibbleCore {
  static constexpr int THREADS = 256;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int MAX_ROWS = 64;
};

}  // namespace cim

extern "C" {

// nibble_gemm_fused's arguments after the block shape (0 or 1)
int nibble_shape_fused(int shape, const void* x, int x_bf16, const void* w,
                       int w_bf16, const void* subs, const void* sx,
                       const void* sw, void* out, int M, int K, int N,
                       int bits, int rb, int splits, int k_split,
                       void* stream) {
  if (bits % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (shape == 0)
    return cim::cluster_gemm<cim::NibbleShape512, cim::ScaleOut>(
        x, x_bf16, w, w_bf16, subs, sx, sw, out, M, K, N, bits, rb, splits,
        k_split, stream);
  return cim::cluster_gemm<cim::NibbleShape256, cim::ScaleOut>(
      x, x_bf16, w, w_bf16, subs, sx, sw, out, M, K, N, bits, rb, splits,
      k_split, stream);
}

// nibble_gemm_fused_capacity's arguments after the block shape
int nibble_shape_capacity(int shape, int rb, int bits, int x_bf16,
                          int w_bf16, int splits, int* out) {
  if (bits % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (shape == 0)
    return cim::cluster_capacity<cim::NibbleShape512, cim::ScaleOut>(
        rb, bits, x_bf16, w_bf16, splits, out);
  return cim::cluster_capacity<cim::NibbleShape256, cim::ScaleOut>(
      rb, bits, x_bf16, w_bf16, splits, out);
}

}  // extern "C"
