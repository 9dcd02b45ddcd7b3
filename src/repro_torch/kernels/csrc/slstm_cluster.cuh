// slstm_cluster.cuh - the fused sLSTM recurrence on a thread-block cluster
// (NVIDIA Hopper, sm_90a): each head's recurrent weights resident in the
// shared memory of one cluster for the whole scan, h exchanged between
// the cluster's blocks through distributed shared memory every step.
// Included by slstm_scan.cu, whose entry slstm_scan_f32 launches it for
// a cluster size cs >= 1 and the streamed kernel for cs = 0.
//
// Replaces, for heads whose weights fit a cluster, the TPU kernel
//   src/repro/kernels/slstm_scan.py:71 slstm_scan -> pallas_call :90 ->
//     _kernel :28
// and computes what slstm_scan.cu's streamed kernel computes: per step t
// and (batch row, head), pre = (u_t + h . r) + bias, then the gates of
// ref.slstm_gates in the same order (tanh, log_sigmoid as -(max(-x, 0) +
// log1p(exp(-|x|))), sigmoid, the stabilizer m, c, n, h = o c / max(n,
// 1e-6)), libm's expf/tanhf/log1pf, no fast-math.
//
// What bounds it: the serial dependency across T.  A step is one matvec
// over dh, the gates and an exchange of h; the work of the step is small
// (B 4 dh^2 FMAs a head: 590k at xlstm-125m), so the step's latency is
// what a scan pays T times.  The streamed kernel (one block a head and 4
// batch rows) read a head's r, dh x 4dh f32 = 576 KiB at dh = 192, from
// L2 every step into one SM: about 35 us a step, the L2 latency of four
// dependent loads a k.
//
// Design:
//  * Grid (nh ceil(B / ROWS), 1, cs), one cluster of (1, 1, cs) blocks
//    per (head, tile of ROWS batch rows), launched by cluster_gemm.cuh's
//    cl_launch_ex.  Block q of a cluster owns the hidden units [q u,
//    (q + 1) u), u = dh / cs, and their four gate columns g dh + j: cols
//    = 4u columns.
//  * Its slice of r (dh x cols f32) is copied once into shared memory by
//    cp.async (4 bytes a copy, a warp 8 k x 4 units: 16-byte runs of a
//    row, two lanes a bank) and stays there for all T steps.  The slice
//    is column-major, a column's k padded with zeros to kpad (a multiple
//    of 4 ks) and its stride to 16 mod 32 words, so the step's 16-byte
//    reads hit no bank twice.
//  * A step: thread (c, kg), c = tid / ks, kg = tid % ks, sums column c
//    for the tile's ROWS rows over k = (i ks + kg) 4 + e (e = 0..3, i =
//    0..kpad / 4ks - 1) with f32 FMAs, r and h read as float4 (h a
//    broadcast); the ks partials of a column are summed by a butterfly of
//    warp shuffles (xor ks/2 .. 1, every lane then holds the same sum);
//    the pre-activations meet in shared memory; one thread per (row,
//    unit) applies the gates, its c, n, m in registers, and stores its
//    new h into the next-step h buffer of every block of the cluster
//    (st.shared::cluster).  h is double buffered, so one cluster barrier
//    a step is enough: a buffer is written only after every peer has
//    passed the barrier that ended its reads.  Between the barrier's
//    arrive (release) and wait (acquire) the thread stores h_t to global
//    memory and starts the copy of its u for step t + SL_U_RING into a
//    ring in shared memory (cp.async), so neither is on the chain.
//  * The last step exchanges nothing and skips the barrier: no peer reads
//    h after it, and every remote store into a block came before a
//    barrier that block passed.
//  * The plan (kernels/slstm_scan.py cluster_plan) picks cs from the
//    clusters of each size the device holds at once (slstm_scan_capacity,
//    cl_capacity_ex of cluster_gemm.cuh; 0 where a size's block does not
//    fit): the fewest waves, then the largest size.  Heads whose slice
//    fits no cluster (dh > 384 or so) take the streamed kernel, chosen by
//    shape before the launch.
//
// Against the plain version the dot's order differs (the ks chunks and
// the butterfly against the einsum's), so the kernel is held within
// kernels/slstm_scan.py ATOL / STATE_RTOL, not bitwise; a plain model of
// this order is checked on the CPU (tests/test_torch_slstm_plan.py).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "cluster_gemm.cuh"  // cl_launch_ex, cl_capacity_ex

namespace slstm {

constexpr int SL_ROWS = 4;            // batch rows a cluster carries
constexpr int SL_MAX_CLUSTER = 16;    // the non-portable cluster limit
constexpr int SL_MAX_THREADS = 1024;
constexpr int SL_MIN_KS = 4;          // k groups a column: >= SL_ROWS
constexpr int SL_MAX_KS = 32;         // a column's k groups share a warp
constexpr int SL_U_RING = 2;          // u steps in flight ahead
constexpr size_t SL_SMEM_BYTES = 232448;

// One launch's cut: `cs` blocks a cluster, each `u` hidden units (`cols`
// = 4u gate columns) x `ks` k groups of threads; a column's k padded to
// `kpad` and strided `stride` floats in shared memory.
struct SlGeom {
  int cs, u, cols, ks, kpad, stride, threads;
  size_t smem;
};

// The geometry of cluster size `cs` at head dim `dh`; false where cs does
// not divide dh (or lies outside 1..SL_MAX_CLUSTER), or the block would
// need more than SL_MAX_THREADS threads or SL_SMEM_BYTES of shared
// memory.
inline bool sl_geometry(int dh, int cs, SlGeom* g) {
  if (dh < 1 || cs < 1 || cs > SL_MAX_CLUSTER || dh % cs != 0) return false;
  g->cs = cs;
  g->u = dh / cs;
  g->cols = 4 * g->u;
  const int dh4 = (dh + 3) / 4 * 4;
  int ks = SL_MIN_KS;
  while (ks < SL_MAX_KS && g->cols * ks * 2 <= SL_MAX_THREADS &&
         8 * ks <= dh4)
    ks *= 2;
  if (g->cols * ks > SL_MAX_THREADS) return false;
  g->ks = ks;
  g->kpad = (dh + 4 * ks - 1) / (4 * ks) * (4 * ks);
  g->stride = g->kpad + (g->kpad % 32 == 0 ? 16 : 0);
  g->threads = (g->cols * ks + 31) / 32 * 32;
  g->smem = sizeof(float) *
            (static_cast<size_t>(g->cols) * g->stride +
             2 * SL_ROWS * g->kpad + (1 + SL_U_RING) * SL_ROWS * g->cols);
  return g->smem <= SL_SMEM_BYTES;
}

struct SlArgs {
  const float *u, *r, *bias, *c0, *n0, *h0, *m0;
  float *hs, *cT, *nT, *hT, *mT;
  int B, T, nh, dh;
  int u_per, cols, ks, kpad, stride;
};

__device__ __forceinline__ float sl_log_sigmoid(float x) {
  return -(fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x))));
}

// 4 bytes global -> shared, asynchronously; `valid` false zero-fills
// (`src` must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   cim::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// the address of `local` (a shared-memory address of this block) in the
// shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(local), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__global__ void __launch_bounds__(SL_MAX_THREADS, 1)
    slstm_cluster_kernel(const SlArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int u = a.u_per, cols = a.cols, ks = a.ks, kpad = a.kpad;
  const int dh = a.dh, T = a.T, nh = a.nh;
  float* r_s = smem;                                      // [cols][stride]
  float* hbuf = r_s + static_cast<size_t>(cols) * a.stride;  // [2][ROWS][kpad]
  float* pre_s = hbuf + 2 * SL_ROWS * kpad;               // [ROWS][cols]
  float* ring = pre_s + SL_ROWS * cols;          // [U_RING][ROWS u][4]
  const int cs = static_cast<int>(gridDim.z);
  const int rank =
      static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int hd = static_cast<int>(blockIdx.x) % nh;
  const int b0 = static_cast<int>(blockIdx.x) / nh * SL_ROWS;
  const int nb = min(SL_ROWS, a.B - b0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int d = nh * dh;
  const size_t d4 = 4 * static_cast<size_t>(d);
  const float* rh = a.r + static_cast<size_t>(hd) * dh * 4 * dh;

  // this block's slice of r, resident for the whole scan: column g u + jl
  // is r[:, g dh + rank u + jl], k past dh zero
  {
    const int kb8 = kpad / 8, jb4 = (u + 3) / 4;
    const int n = 4 * kb8 * jb4 * 32;
    for (int e = tid; e < n; e += nthr) {
      const int lane = e & 31, w = e >> 5;
      const int k = (w % kb8) * 8 + (lane & 7);
      const int rest = w / kb8;
      const int jl = (rest % jb4) * 4 + (lane >> 3);
      const int g = rest / jb4;
      if (jl < u)
        cp_async4(r_s + (g * u + jl) * a.stride + k,
                  rh + static_cast<size_t>(k < dh ? k : 0) * 4 * dh +
                      g * dh + rank * u + jl,
                  k < dh);
    }
    cim::cp_async_commit();
  }

  // gate threads: one per (row gb, unit j) of the tile inside B
  const bool gate_t = tid < SL_ROWS * u;
  const int gb = gate_t ? tid / u : 0, gj = gate_t ? tid - gb * u : 0;
  const bool gate = gate_t && gb < nb;
  const int j = rank * u + gj;
  float c = 0.f, nn = 0.f, h = 0.f, m = 0.f;
  float bz = 0.f, bi = 0.f, bf = 0.f, bo = 0.f;
  const float* ub = a.u;
  float* slot0 = ring + tid * 4;
  const int slot_stride = SL_ROWS * u * 4;
  if (gate) {
    const float* bh = a.bias + static_cast<size_t>(hd) * 4 * dh + j;
    bz = bh[0];
    bi = bh[dh];
    bf = bh[2 * dh];
    bo = bh[3 * dh];
    const size_t s = (static_cast<size_t>(b0 + gb) * nh + hd) * dh + j;
    c = a.c0[s];
    nn = a.n0[s];
    h = a.h0[s];
    m = a.m0[s];
    ub = a.u + static_cast<size_t>(b0 + gb) * T * d4 +
         static_cast<size_t>(hd) * 4 * dh + j;
  }
  // u of step t (4 gate columns) into ring slot t % SL_U_RING
  auto fetch_u = [&](int t) {
    float* slot = slot0 + (t % SL_U_RING) * slot_stride;
    const bool in = t < T;
    const float* src = in ? ub + static_cast<size_t>(t) * d4 : ub;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      cp_async4(slot + g, src + (in ? g * dh : 0), in);
    cim::cp_async_commit();
  };
  if (gate) {
#pragma unroll
    for (int t = 0; t < SL_U_RING; ++t) fetch_u(t);
    cim::cp_async_wait<SL_U_RING>();  // r's group, not the ring's
  } else {
    cim::cp_async_wait<0>();
  }

  // h of step 0 (the initial state) for every unit, zeros elsewhere
  for (int e = tid; e < SL_ROWS * kpad; e += nthr) {
    const int q = e / kpad, k = e - q * kpad;
    hbuf[e] = q < nb && k < dh
                  ? a.h0[(static_cast<size_t>(b0 + q) * nh + hd) * dh + k]
                  : 0.f;
    hbuf[SL_ROWS * kpad + e] = 0.f;
  }
  // r and h in place in every block before any block reads or a peer
  // writes them
  cluster_arrive();
  cluster_wait();

  const int col = tid / ks, kg = tid - col * ks;
  const bool dot = col < cols;
  const float* rcol = r_s + static_cast<size_t>(dot ? col : 0) * a.stride;
  const int n4 = kpad / (4 * ks);
  const uint32_t hbuf_u32 = cim::smem_u32(hbuf);

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * SL_ROWS * kpad;
    float acc[SL_ROWS];
#pragma unroll
    for (int q = 0; q < SL_ROWS; ++q) acc[q] = 0.f;
    if (dot) {
      for (int i = 0; i < n4; ++i) {
        const int kk = (i * ks + kg) * 4;
        const float4 rv = *reinterpret_cast<const float4*>(rcol + kk);
#pragma unroll
        for (int q = 0; q < SL_ROWS; ++q) {
          const float4 hv =
              *reinterpret_cast<const float4*>(hcur + q * kpad + kk);
          acc[q] = fmaf(hv.x, rv.x, acc[q]);
          acc[q] = fmaf(hv.y, rv.y, acc[q]);
          acc[q] = fmaf(hv.z, rv.z, acc[q]);
          acc[q] = fmaf(hv.w, rv.w, acc[q]);
        }
      }
    }
    // the column's ks partials: a butterfly, the same sum in every lane
    for (int off = ks >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < SL_ROWS; ++q)
        acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
    }
    if (dot) {
#pragma unroll
      for (int q = 0; q < SL_ROWS; ++q)
        if (kg == q) pre_s[q * cols + col] = acc[q];
    }
    __syncthreads();

    const bool more = t + 1 < T;
    if (gate) {
      cim::cp_async_wait<SL_U_RING - 1>();  // step t's u has landed
      const float4 uv = *reinterpret_cast<const float4*>(
          slot0 + (t % SL_U_RING) * slot_stride);
      const float* pq = pre_s + gb * cols + gj;
      const float pz = (uv.x + pq[0]) + bz;
      const float pi = (uv.y + pq[u]) + bi;
      const float pf = (uv.z + pq[2 * u]) + bf;
      const float po = (uv.w + pq[3 * u]) + bo;
      const float z = tanhf(pz);
      const float lf = sl_log_sigmoid(pf);
      const float o = 1.0f / (1.0f + expf(-po));
      const float mn = fmaxf(lf + m, pi);
      const float iw = expf(pi - mn);
      const float fw = expf((lf + m) - mn);
      c = fw * c + iw * z;
      nn = fw * nn + iw;
      h = (o * c) / fmaxf(nn, 1e-6f);
      m = mn;
      if (more) {
        const uint32_t dst =
            hbuf_u32 + static_cast<uint32_t>(
                           (((t + 1) & 1) * SL_ROWS * kpad + gb * kpad + j) *
                           sizeof(float));
        for (int p = 0; p < cs; ++p) st_cluster(map_rank(dst, p), h);
      }
    }
    if (more) cluster_arrive();
    if (gate) {
      a.hs[(static_cast<size_t>(b0 + gb) * T + t) * d +
           static_cast<size_t>(hd) * dh + j] = h;
      fetch_u(t + SL_U_RING);  // the slot just read
    }
    if (more) cluster_wait();
  }

  if (!gate) return;
  cim::cp_async_wait<0>();  // the ring's zero-filled tail
  const size_t s = (static_cast<size_t>(b0 + gb) * nh + hd) * dh + j;
  a.cT[s] = c;
  a.nT[s] = nn;
  a.hT[s] = h;
  a.mT[s] = m;
}

// Clusters of more than 8 blocks are non-portable: allowed for the kernel
// before it is launched or its capacity asked.
inline cudaError_t sl_allow_large_clusters() {
  return cudaFuncSetAttribute(slstm_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

// Launches the cluster kernel over nh ceil(B / SL_ROWS) clusters of
// (1, 1, cs) blocks; returns the CUDA error code.
inline int sl_launch(const SlArgs& a, const SlGeom& g, cudaStream_t stream) {
  const long long tiles =
      static_cast<long long>(a.nh) * ((a.B + SL_ROWS - 1) / SL_ROWS);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = sl_allow_large_clusters();
  if (e != cudaSuccess) return static_cast<int>(e);
  return cim::cl_launch_ex(slstm_cluster_kernel, a, g.smem, g.threads,
                           static_cast<int>(tiles), g.cs, stream);
}

// The clusters of `cs` blocks of the kernel at head dim `dh` that the
// current device holds at once, into *out: 0 where cs does not divide dh
// or its block does not fit (sl_geometry); returns the CUDA error code.
inline int sl_capacity(int dh, int cs, int* out) {
  SlGeom g;
  if (!sl_geometry(dh, cs, &g)) {
    *out = 0;
    return static_cast<int>(cudaSuccess);
  }
  const cudaError_t e = sl_allow_large_clusters();
  if (e != cudaSuccess) return static_cast<int>(e);
  return cim::cl_capacity_ex(reinterpret_cast<const void*>(
                                 slstm_cluster_kernel),
                             g.smem, g.threads, cs, out);
}

}  // namespace slstm
