// slstm_scan.cu - the fused sLSTM recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/slstm_scan.py:
//   slstm_scan (-> _kernel): u (B, T, 4d) f32 input pre-activations,
//     r (nh, dh, 4dh) f32 recurrent weights, bias (nh, 4dh) f32 ->
//     h (B, T, nh, dh) f32, the states starting at zero.
// This entry also takes the initial state (c, n, h, m), each
// (B, nh, dh) f32, and writes the final one: a decode step is T = 1 from
// the cached state (models/xlstm.py).
//
// Two routes, chosen by shape before the launch (kernels/slstm_scan.py
// cluster_plan): the cluster kernel of slstm_cluster.cuh, each head's r
// resident in a thread-block cluster's shared memory (cs >= 1 blocks a
// head), wherever a head's slice fits; and, for heads too wide for any
// cluster (dh up to 1024), the streamed kernel below (cs = 0).
//
// What it computes, per time step t and (batch row, head), following the
// reference's _kernel and models/xlstm._slstm_cell:
//   pre = (u_t + h . r) + bias            (gate blocks [z | i | f | o])
//   z = tanh(pre_z), lf = log_sigmoid(pre_f), o = sigmoid(pre_o)
//   m' = max(lf + m, pre_i)
//   iw = exp(pre_i - m'), fw = exp(lf + m - m')
//   c' = fw c + iw z, n' = fw n + iw, h' = o c' / max(n', 1e-6)
// with log_sigmoid(x) = -(max(-x, 0) + log1p(exp(-|x|))) (JAX's
// -softplus(-x)) and sigmoid(x) = 1 / (1 + exp(-x)).
//
// What bounds it on an H100: the serial dependency across T.  The
// least time for the work alone is the larger of the f32 FMAs of the
// recurrent matvec, B*T*nh*dh*4dh over 132 SMs x 128 a clock, and the
// bytes of u, h, r and the states moved once over 3.35 TB/s; but step
// t + 1 needs every h of step t, so a step is a latency chain (one
// matvec over dh, the gates, one barrier) that no width hides.
//
// The streamed kernel: one block per (head, tile of ROWS batch rows), one
// thread per hidden unit j.  Thread j computes its four gate columns
// g*dh + j for the tile's rows: the dot runs over k with h in shared
// memory (double buffered, so one __syncthreads() a step) and
// r[k, g*dh + j] read through L2 (coalesced across j), each r element
// read once a step for all the tile's rows.  The states c, n, m stay in
// registers, the step's u is loaded before the dot so its latency hides
// behind it, h is written every step and the final (c, n, h, m) once.  A
// head's r (dh x 4dh f32) is streamed from L2 every step: about 35 us a
// step at dh = 192, which is why narrower heads take the cluster kernel.

#include <cuda_runtime.h>
#include <stddef.h>

#include "slstm_cluster.cuh"

namespace {

constexpr int ROWS = 4;          // batch rows a block carries
constexpr int MAX_DH = 1024;     // one thread per hidden unit

__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x))));
}

__global__ void slstm_kernel(const float* __restrict__ u,
                             const float* __restrict__ r,
                             const float* __restrict__ bias,
                             const float* __restrict__ c0,
                             const float* __restrict__ n0,
                             const float* __restrict__ h0,
                             const float* __restrict__ m0,
                             float* __restrict__ hs, float* __restrict__ cT,
                             float* __restrict__ nT, float* __restrict__ hT,
                             float* __restrict__ mT, int B, int T, int nh,
                             int dh) {
  extern __shared__ float hbuf[];          // [2][ROWS][dh]
  const int hd = blockIdx.x;
  const int b0 = blockIdx.y * ROWS;
  const int nb = min(ROWS, B - b0);
  const int j = threadIdx.x;
  const bool live = j < dh;
  const int d = nh * dh;
  const size_t d4 = 4 * (size_t)d;
  const float* rh = r + (size_t)hd * dh * 4 * dh;

  float c[ROWS], n[ROWS], m[ROWS], h[ROWS];
  float bz = 0.f, bi = 0.f, bf = 0.f, bo = 0.f;
  if (live) {
    const float* bh = bias + (size_t)hd * 4 * dh;
    bz = bh[j];
    bi = bh[dh + j];
    bf = bh[2 * dh + j];
    bo = bh[3 * dh + j];
  }
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    c[q] = n[q] = m[q] = h[q] = 0.f;
    if (live && q < nb) {
      const size_t s = ((size_t)(b0 + q) * nh + hd) * dh + j;
      c[q] = c0[s];
      n[q] = n0[s];
      h[q] = h0[s];
      m[q] = m0[s];
    }
    if (live) {                            // rows past nb stay 0
      hbuf[q * dh + j] = h[q];
      hbuf[(ROWS + q) * dh + j] = h[q];
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * ROWS * dh;
    float* hnext = hbuf + ((t & 1) ^ 1) * ROWS * dh;
    if (live) {
      float uz[ROWS], ui[ROWS], uf[ROWS], uo[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        uz[q] = ui[q] = uf[q] = uo[q] = 0.f;
        if (q < nb) {
          const float* ut = u + ((size_t)(b0 + q) * T + t) * d4 +
                            (size_t)hd * 4 * dh;
          uz[q] = ut[j];
          ui[q] = ut[dh + j];
          uf[q] = ut[2 * dh + j];
          uo[q] = ut[3 * dh + j];
        }
      }
      float az[ROWS], ai[ROWS], af[ROWS], ao[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) az[q] = ai[q] = af[q] = ao[q] = 0.f;
#pragma unroll 4
      for (int k = 0; k < dh; ++k) {
        const float* rk = rh + (size_t)k * 4 * dh + j;
        const float rz = __ldg(rk), ri = __ldg(rk + dh),
                    rf = __ldg(rk + 2 * dh), ro = __ldg(rk + 3 * dh);
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
          const float hk = hcur[q * dh + k];
          az[q] = fmaf(hk, rz, az[q]);
          ai[q] = fmaf(hk, ri, ai[q]);
          af[q] = fmaf(hk, rf, af[q]);
          ao[q] = fmaf(hk, ro, ao[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        if (q >= nb) continue;
        const float pz = (uz[q] + az[q]) + bz;
        const float pi = (ui[q] + ai[q]) + bi;
        const float pf = (uf[q] + af[q]) + bf;
        const float po = (uo[q] + ao[q]) + bo;
        const float z = tanhf(pz);
        const float lf = log_sigmoid(pf);
        const float o = 1.0f / (1.0f + expf(-po));
        const float mn = fmaxf(lf + m[q], pi);
        const float iw = expf(pi - mn);
        const float fw = expf((lf + m[q]) - mn);
        c[q] = fw * c[q] + iw * z;
        n[q] = fw * n[q] + iw;
        h[q] = (o * c[q]) / fmaxf(n[q], 1e-6f);
        m[q] = mn;
        hnext[q * dh + j] = h[q];
        hs[((size_t)(b0 + q) * T + t) * d + (size_t)hd * dh + j] = h[q];
      }
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    if (q >= nb) continue;
    const size_t s = ((size_t)(b0 + q) * nh + hd) * dh + j;
    cT[s] = c[q];
    nT[s] = n[q];
    hT[s] = h[q];
    mT[s] = m[q];
  }
}

}  // namespace

extern "C" {

// u (B,T,4*nh*dh), r (nh,dh,4dh), bias (nh,4dh), the initial state
// c0/n0/h0/m0 (B,nh,dh): all f32, contiguous, on the device.  Writes hs
// (B,T,nh,dh) and the final state cT/nT/hT/mT (B,nh,dh).  cs >= 1: the
// cluster kernel with clusters of cs blocks (kernels/slstm_scan.py
// cluster_plan; a cs that does not divide dh or whose slice does not fit
// a block is refused, cudaErrorInvalidValue); cs = 0: the streamed
// kernel.  Returns the CUDA error code.
int slstm_scan_f32(const void* u, const void* r, const void* bias,
                   const void* c0, const void* n0, const void* h0,
                   const void* m0, void* hs, void* cT, void* nT, void* hT,
                   void* mT, int B, int T, int nh, int dh, int cs,
                   void* stream) {
  if (B < 1 || T < 1 || nh < 1 || dh < 1 || dh > MAX_DH || cs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cs > 0) {
    slstm::SlGeom g;
    if (!slstm::sl_geometry(dh, cs, &g))
      return static_cast<int>(cudaErrorInvalidValue);
    slstm::SlArgs a;
    a.u = static_cast<const float*>(u);
    a.r = static_cast<const float*>(r);
    a.bias = static_cast<const float*>(bias);
    a.c0 = static_cast<const float*>(c0);
    a.n0 = static_cast<const float*>(n0);
    a.h0 = static_cast<const float*>(h0);
    a.m0 = static_cast<const float*>(m0);
    a.hs = static_cast<float*>(hs);
    a.cT = static_cast<float*>(cT);
    a.nT = static_cast<float*>(nT);
    a.hT = static_cast<float*>(hT);
    a.mT = static_cast<float*>(mT);
    a.B = B;
    a.T = T;
    a.nh = nh;
    a.dh = dh;
    a.u_per = g.u;
    a.cols = g.cols;
    a.ks = g.ks;
    a.kpad = g.kpad;
    a.stride = g.stride;
    return slstm::sl_launch(a, g, st);
  }
  const dim3 grid(nh, (B + ROWS - 1) / ROWS);
  const int threads = (dh + 31) / 32 * 32;
  const size_t smem = 2 * ROWS * (size_t)dh * sizeof(float);
  slstm_kernel<<<grid, threads, smem, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(r),
      static_cast<const float*>(bias), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(h0),
      static_cast<const float*>(m0), static_cast<float*>(hs),
      static_cast<float*>(cT), static_cast<float*>(nT),
      static_cast<float*>(hT), static_cast<float*>(mT), B, T, nh, dh);
  return static_cast<int>(cudaGetLastError());
}

// the clusters of cs blocks of the cluster kernel at head dim dh that the
// device holds at once, into *out (cluster_plan's waves); 0 where cs does
// not divide dh or its block does not fit
int slstm_scan_capacity(int dh, int cs, int* out) {
  return slstm::sl_capacity(dh, cs, out);
}

}  // extern "C"
