// conv_gemm.cu - implicit-GEMM CiM convolution for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/conv_gemm.py:
//   conv_lut_fused (-> _lut_kernel, nibble=False / True): the full signed
//     product table or the nibble sub-tables per product
//   conv_log_fused (-> _log_kernel): the Mitchell / Log-our product
//   conv_mxu_fused (:174 -> _mxu_kernel :148): the exact product (exact
//     mode), on the tensor cores
//   conv_lut_partial, conv_log_partial (-> _lut_kernel, _log_kernel with
//     the epilogue off): the mesh path's shard-local forms over a slice
//     of the input channels, quantized against the caller's global
//     scales, writing the raw int32 sum (B,OH,OW,N) (QuantIntOut); the
//     caller sums the shards' partials and applies (acc * sx) * sw.
//
// f32 x (B,H,W,C) and f32 w3 (kh*kw, C, N) -> f32 (B,OH,OW,N), SAME zero
// padding kh//2, kw//2 and a stride, quantization on load against a
// per-tensor sx and per-out-channel sw, and the (acc * sx) * sw epilogue:
// bit-identical integer core to im2col + the GEMM kernels.  The exact
// form differs from the reference's, which summed the dequantized
// products (a sx)(b sw) in f32 per tap: here the integer products are
// summed exactly in int32 and scaled once, so the two differ by f32
// rounding only (the reference's own test holds that route to a float
// conv at 1e-5), and the kernel equals its plain version bit for bit.
//
// What bounds it on an H100: the same products as the GEMM of
// M = B*OH*OW rows, K = kh*kw*C, N = C_out: M*K*N shared-memory gathers
// (lut; nibble four a product) at most 132 SMs x 32 words a clock, or
// about 11 (mitchell) / 28 (log_our) int32 operations a product at 132 x
// 64 lanes a clock.  The exact form's 2 M K N int8 operations run on the
// tensor cores at 1,979 TOP/s, far below the bytes (the image and the
// weights read once, the output written once, 3.35 TB/s), so at the
// CNN's geometries the exact form is bound by bytes and the others by
// their products.
//
// Design: not the TPU's.  The TPU kernel held a whole padded input plane
// in VMEM (gated at 8 MiB by the reference's plan_conv) and sliced each
// tap's shifted window out of it.  Here a block owns a spatial tile of
// output pixels and all N, quantizes its tile's input halo once into
// shared memory and forms the patch matrix from it by index arithmetic,
// its shared memory one fixed total whatever the geometry (channels in
// chunks, taps in groups):
//   conv_mxu_fused: int8_mma.cuh's conv kernel on the int8 tensor cores;
//   conv_lut_fused, conv_log_fused and their partial forms up to 8 bits:
//     conv_tile.cuh's kernel (a register micro-tile of pixels x columns
//     a thread, the tap stack staged once a block where it fits, a
//     persistent grid cut by kernels/conv_gemm.py conv_plan, the table
//     copied once a block by bulk asynchronous copies); a fused form and
//     its partial launch one instantiation, the store picked by a flag.
// Log operands of 9..16 bits (conv_log_fused_wide, conv_log_partial_wide,
// by kernels/conv_gemm.py conv_route) run cim_gemm.cuh's gemm_kernel with
// ConvSrc as its A operand: a block owns BM output pixels (rows of M,
// batch-major) x BN output channels and loops over K = (tap, channel) in
// BK steps, loading each element of the patch matrix from device memory
// by index arithmetic (out-of-image taps read as 0, which every core
// annihilates), so no plane and no im2col tensor is held anywhere and
// any plane size fits.  Every launch takes the caller's shared-memory
// total (kernels/conv_gemm.py gemm_smem_bytes, which the planner's gate
// reads) and refuses one that differs.  The K loop stays inside the
// block in every design, so the int32 result is deterministic.

#include "cim_gemm.cuh"
#include "conv_tile.cuh"
#include "int8_mma.cuh"

// 9..16-bit log operands on cim_gemm.cuh's template, through `epi`
template <class Epi>
static int conv_log(const void* x, const void* w, const void* sx,
                    const void* sw, void* out, Epi epi, int B, int H, int W,
                    int C, int N, int kh, int kw, int stride, int bits,
                    int compensated, int smem, void* stream) {
  if (compensated)
    return cim::conv_quant<cim::LogCore<true>>(x, w, nullptr, sx, sw, out,
                                               epi, B, H, W, C, N, kh, kw,
                                               stride, bits, smem, stream);
  return cim::conv_quant<cim::LogCore<false>>(x, w, nullptr, sx, sw, out,
                                              epi, B, H, W, C, N, kh, kw,
                                              stride, bits, smem, stream);
}

// a fused form (raw 0) or its partial (raw 1) on conv_tile.cuh's kernel
static int conv_lut(const void* x, const void* w, const void* tab,
                    const void* sx, const void* sw, void* out, int raw,
                    int B, int H, int W, int C, int N, int kh, int kw,
                    int stride, int bits, int nibble, int smem, int rp,
                    int rn, int ib, int tr, int tc, int cc, int tg, int grid,
                    void* stream) {
  if (nibble)
    return cim::conv_tile<cim::TileNibble>(x, w, tab, sx, sw, out, raw, B,
                                           H, W, C, N, kh, kw, stride, bits,
                                           smem, rp, rn, ib, tr, tc, cc, tg,
                                           grid, stream);
  return cim::conv_tile<cim::TileLut>(x, w, tab, sx, sw, out, raw, B, H, W,
                                      C, N, kh, kw, stride, bits, smem, rp,
                                      rn, ib, tr, tc, cc, tg, grid, stream);
}

static int conv_log_tile(const void* x, const void* w, const void* sx,
                         const void* sw, void* out, int raw, int B, int H,
                         int W, int C, int N, int kh, int kw, int stride,
                         int bits, int compensated, int smem, int rp, int rn,
                         int ib, int tr, int tc, int cc, int tg, int grid,
                         void* stream) {
  if (compensated)
    return cim::conv_tile<cim::TileLog<true>>(
        x, w, nullptr, sx, sw, out, raw, B, H, W, C, N, kh, kw, stride, bits,
        smem, rp, rn, ib, tr, tc, cc, tg, grid, stream);
  return cim::conv_tile<cim::TileLog<false>>(
      x, w, nullptr, sx, sw, out, raw, B, H, W, C, N, kh, kw, stride, bits,
      smem, rp, rn, ib, tr, tc, cc, tg, grid, stream);
}

extern "C" {

// tab: the int16 full table (nibble == 0) or the four int32 sub-tables;
// out: f32 (B,OH,OW,N); the launch plan (rp, rn, ib, tr, tc, cc, tg,
// grid) of kernels/conv_gemm.py conv_plan, on conv_tile.cuh's kernel
int conv_lut_fused(const void* x, const void* w, const void* tab,
                   const void* sx, const void* sw, void* out, int B, int H,
                   int W, int C, int N, int kh, int kw, int stride, int bits,
                   int nibble, int smem, int rp, int rn, int ib, int tr,
                   int tc, int cc, int tg, int grid, void* stream) {
  return conv_lut(x, w, tab, sx, sw, out, 0, B, H, W, C, N, kh, kw, stride,
                  bits, nibble, smem, rp, rn, ib, tr, tc, cc, tg, grid,
                  stream);
}

// as conv_lut_fused, out: the raw int32 sum (B,OH,OW,N)
int conv_lut_partial(const void* x, const void* w, const void* tab,
                     const void* sx, const void* sw, void* out, int B, int H,
                     int W, int C, int N, int kh, int kw, int stride,
                     int bits, int nibble, int smem, int rp, int rn, int ib,
                     int tr, int tc, int cc, int tg, int grid,
                     void* stream) {
  return conv_lut(x, w, tab, sx, sw, out, 1, B, H, W, C, N, kh, kw, stride,
                  bits, nibble, smem, rp, rn, ib, tr, tc, cc, tg, grid,
                  stream);
}

// the exact integer product (exact mode; no table) on the tensor cores
int conv_mxu_fused(const void* x, const void* w, const void* sx,
                   const void* sw, void* out, int B, int H, int W, int C,
                   int N, int kh, int kw, int stride, int bits, int smem,
                   void* stream) {
  return cim::conv_int8_mma(x, w, sx, sw, out, B, H, W, C, N, kh, kw,
                            stride, bits, smem, stream);
}

// up to 8 bits, on conv_tile.cuh's kernel with the plan of conv_plan
int conv_log_fused(const void* x, const void* w, const void* sx,
                   const void* sw, void* out, int B, int H, int W, int C,
                   int N, int kh, int kw, int stride, int bits,
                   int compensated, int smem, int rp, int rn, int ib, int tr,
                   int tc, int cc, int tg, int grid, void* stream) {
  return conv_log_tile(x, w, sx, sw, out, 0, B, H, W, C, N, kh, kw, stride,
                       bits, compensated, smem, rp, rn, ib, tr, tc, cc, tg,
                       grid, stream);
}

// as conv_log_fused, out: the raw int32 sum (B,OH,OW,N)
int conv_log_partial(const void* x, const void* w, const void* sx,
                     const void* sw, void* out, int B, int H, int W, int C,
                     int N, int kh, int kw, int stride, int bits,
                     int compensated, int smem, int rp, int rn, int ib,
                     int tr, int tc, int cc, int tg, int grid, void* stream) {
  return conv_log_tile(x, w, sx, sw, out, 1, B, H, W, C, N, kh, kw, stride,
                       bits, compensated, smem, rp, rn, ib, tr, tc, cc, tg,
                       grid, stream);
}

// 9..16-bit log operands (kernels/conv_gemm.py conv_route), on the
// template
int conv_log_fused_wide(const void* x, const void* w, const void* sx,
                        const void* sw, void* out, int B, int H, int W,
                        int C, int N, int kh, int kw, int stride, int bits,
                        int compensated, int smem, void* stream) {
  return conv_log(x, w, sx, sw, out, cim::ScaleOut{}, B, H, W, C, N, kh, kw,
                  stride, bits, compensated, smem, stream);
}

// as conv_log_fused_wide, out: the raw int32 sum (B,OH,OW,N)
int conv_log_partial_wide(const void* x, const void* w, const void* sx,
                          const void* sw, void* out, int B, int H, int W,
                          int C, int N, int kh, int kw, int stride, int bits,
                          int compensated, int smem, void* stream) {
  return conv_log(x, w, sx, sw, out, cim::QuantIntOut{}, B, H, W, C, N, kh,
                  kw, stride, bits, compensated, smem, stream);
}

// The blocks of the tile kernel of `kind` (0 LUT, 1 nibble, 2 mitchell,
// 3 log_our) and micro-tile (rp, rn) at `bits` resident on one SM at
// once, into *out (conv_plan's capacity; one instantiation serves the
// fused and the partial forms); returns the CUDA error code
int conv_tile_capacity(int kind, int bits, int rp, int rn, int* out) {
  switch (kind) {
    case 0:
      return cim::conv_tile_capacity<cim::TileLut>(bits, rp, rn, out);
    case 1:
      return cim::conv_tile_capacity<cim::TileNibble>(bits, rp, rn, out);
    case 2:
      return cim::conv_tile_capacity<cim::TileLog<false>>(bits, rp, rn, out);
    case 3:
      return cim::conv_tile_capacity<cim::TileLog<true>>(bits, rp, rn, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
