// The MLP actors' trunk, shared by the fused MLP PPO actor
// (mlp_ppo_actor.cu) and the fused MLP SAC actor (mlp_sac_actor.cu): a row
// on kLanes lanes, kRows rows a block of kThreads; the weights and the
// block's obs staged in shared memory by cp.async; then
//   h0 = relu(obs W0 + b0); h1 = relu(h0 W1 + b1)
// each lane NH / kLanes hidden units (the inputs in order, each unit its
// own chain, then the bias, then relu), the row's lanes exchanging them
// through shared memory (a warp barrier).  Every dot product in one fixed
// order; the including sources are built with -fmad=false.
// dense_relu_rows: a layer at run-time widths, for widths without an
// instance.
#pragma once

#include <cuda_pipeline.h>
#include <math.h>

namespace mlp {

constexpr int kThreads = 128;
constexpr int kLanes = 4;                  // lanes a row
constexpr int kRows = kThreads / kLanes;   // rows a block

// h[u] = relu(sum_k x[k] W[k][u] + b[u]) for this lane's U units (W's
// columns from u0), the terms in k order.
template <int N, int U>
__device__ __forceinline__ void dense_relu(const float* x, const float* W,
                                           int ldw, const float* b,
                                           float (&h)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) h[u] = x[0] * W[u];
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const float xk = x[k];
#pragma unroll
    for (int u = 0; u < U; ++u) h[u] = h[u] + xk * W[k * ldw + u];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) h[u] = fmaxf(h[u] + b[u], 0.0f);
}

// N floats into shared memory by cp.async, 4 bytes a copy (the parameter
// views need not be 16-byte aligned), all in flight together.
template <int N>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int t) {
  for (int i = t; i < N; i += kThreads)
    __pipeline_memcpy_async(dst + i, src + i, 4);
}

// The block's obs rows into xs (zeros past the last row), by cp.async.
template <int NIN>
__device__ __forceinline__ void stage_obs(float* xs,
                                          const float* __restrict__ obs,
                                          int r0, int nrow, int t) {
  const float* o = obs + (size_t)r0 * NIN;
  for (int i = t; i < kRows * NIN; i += kThreads) {
    if (i < nrow * NIN)
      __pipeline_memcpy_async(xs + i, o + i, 4);
    else
      xs[i] = 0.0f;
  }
}

// The two relu layers for thread t's row (lane j of t / kLanes), from the
// staged obs xs and weights; x receives the row's h1 on every lane.  hs:
// the block's exchange buffer, kRows rows of NH.
template <int NIN, int NH>
__device__ __forceinline__ void hidden(const float* xs, const float* W0,
                                       const float* B0, const float* W1,
                                       const float* B1, float (*hs)[NH],
                                       int t, float (&x)[NH]) {
  static_assert(NH % kLanes == 0, "whole hidden units a lane");
  constexpr int U = NH / kLanes;
  const int row = t / kLanes, u0 = (t % kLanes) * U;
  float h[U];
  dense_relu<NIN, U>(xs + row * NIN, W0 + u0, NH, B0 + u0, h);
#pragma unroll
  for (int u = 0; u < U; ++u) hs[row][u0 + u] = h[u];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NH; ++k) x[k] = hs[row][k];
  __syncwarp();
  dense_relu<NH, U>(x, W1 + u0, NH, B1 + u0, h);
#pragma unroll
  for (int u = 0; u < U; ++u) hs[row][u0 + u] = h[u];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NH; ++k) x[k] = hs[row][k];
}

// One relu layer at run-time widths for a block's R rows: h[i][u] =
// relu(sum_k x[i][k] W[k][u] + b[u]) for the rows i < nr (x row stride
// ldx; the rows past nr compute row nr - 1's, not stored) and u < nh;
// thread t takes runs of kRun units (t kRun, then kThreads kRun further
// on), R x kRun chains side by side, each W element loaded once for the R
// rows; each unit's terms in k order, as dense_relu.  W and b in global
// memory.
constexpr int kRun = 2;

template <int R>
__device__ __forceinline__ void dense_relu_rows(const float* x, int ldx,
                                                int nr, int n, int nh,
                                                const float* __restrict__ W,
                                                const float* __restrict__ b,
                                                float* h, int t) {
  const float* xr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) xr[i] = x + (i < nr ? i : nr - 1) * ldx;
  for (int u0 = t * kRun; u0 < nh; u0 += kThreads * kRun) {
    float s[R][kRun], w[kRun];
#pragma unroll
    for (int v = 0; v < kRun; ++v)
      w[v] = u0 + v < nh ? __ldg(W + u0 + v) : 0.0f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float x0 = xr[i][0];
#pragma unroll
      for (int v = 0; v < kRun; ++v) s[i][v] = x0 * w[v];
    }
#pragma unroll 4
    for (int k = 1; k < n; ++k) {
      const float* wk = W + (size_t)k * nh + u0;
#pragma unroll
      for (int v = 0; v < kRun; ++v) w[v] = u0 + v < nh ? __ldg(wk + v) : 0.0f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float xk = xr[i][k];
#pragma unroll
        for (int v = 0; v < kRun; ++v) s[i][v] = s[i][v] + xk * w[v];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int v = 0; v < kRun; ++v)
        if (i < nr && u0 + v < nh)
          h[i * nh + u0 + v] = fmaxf(s[i][v] + __ldg(b + u0 + v), 0.0f);
  }
}

}  // namespace mlp
