// K6: the fused flat optimizer step for Hopper (sm_90a): clip to the global
// norm, AdamW with bias correction and decoupled weight decay, the step, and
// Polyak averaging into the target network, over one network's flat
// parameter vector, in one launch.
//
// Replaces gym_rotor_tpu/algos/common.py:make_optimizer (optax
// clip_by_global_norm -> adamw(cosine_warm_restarts)) and flat_polyak, which
// XLA fused on the TPU.  Plain twin:
// gym_rotor_tpu_torch/kernels/flat_adamw.py:flat_adamw_plain.
//
// Bound on an H100: the bytes.  Per element it reads g, p, mu, nu (and the
// target when Polyak is on) and writes p, mu, nu (and the target): 28-36 B,
// so the largest network (agent 1's twin critic, 54.4k floats) is ~2 MB,
// ~0.6 us at 3.35 TB/s; the operations (~20 flops an element) are less.
// At these sizes one launch's own cost dominates.
//
// The chain, in optax's order of operations:
//   g   <- norm < max_norm ? g : (g / norm) * max_norm
//   mu  <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu
//   u   <- (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p;   p <- p + step * u
//   tgt <- tau p + (1 - tau) tgt
// with bc1, bc2 (bias corrections at count + 1) and step (-lr at the
// schedule's count) computed on the host.  Built with -fmad=false so the
// chain rounds like the plain twin; only the norm's summation order differs.
//
// Design (clipped): G clusters of C blocks of T threads (the plan,
// kernels/flat_adamw.py:flat_adamw_plan).  Thread q = rank T + t of a
// cluster owns the slots k of elements q + k C T.  Every cluster sums the
// squares of the WHOLE gradient in one fixed order (per thread over slots
// 0 .. G E - 1, a warp butterfly, the block's warps by the same butterfly,
// the cluster's blocks in rank order through distributed shared memory), so
// every block of every cluster gets the same norm bitwise with no second
// launch and no scratch; cluster c then updates its own slots
// [c E, c E + E).  On the learners' sizes E is 1: a thread loads its G
// gradient values and its own element's operands at once, before the
// reduction, so one memory round trip precedes it.  The unclipped step
// needs no norm: one thread an element.
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

namespace {

constexpr int kThreads = 256;       // the unclipped launch's block
constexpr int kMaxThreads = 1024;

struct Scalars {
  float max_norm;   // <= 0: no clipping
  float b1, c1, b2, c2, eps, wd;
  float bc1, bc2, step;
  float tau, c_tau;  // Polyak weights, used when tgt != nullptr
};

// One element's AdamW step: updates m, v; returns the new parameter.
__device__ __forceinline__ float adamw_element(float gi, float pi, float& m,
                                               float& v, const Scalars& s) {
  m = s.c1 * gi + s.b1 * m;
  v = s.c2 * (gi * gi) + s.b2 * v;
  float u = (m / s.bc1) / (sqrtf(v / s.bc2) + s.eps);
  u = u + s.wd * pi;
  return pi + s.step * u;
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
             float* __restrict__ mu, float* __restrict__ nu,
             float* __restrict__ tgt, int n, Scalars s) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float m = mu[i], v = nu[i];
  const float pn = adamw_element(g[i], p[i], m, v, s);
  mu[i] = m;
  nu[i] = v;
  p[i] = pn;
  if (tgt != nullptr) tgt[i] = s.tau * pn + s.c_tau * tgt[i];
}

// acc + sum of g[q + k S]^2 over slots k in [k0, k1), in order (zero past n).
__device__ __forceinline__ float sumsq(const float* __restrict__ g, int n,
                                       int q, int S, int k0, int k1,
                                       float acc) {
  for (int k = k0; k < k1; k += 4) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = q + (k + u) * S;
      x[u] = (k + u < k1 && i < n) ? __ldg(g + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += x[u] * x[u];
  }
  return acc;
}

// The cluster's sum of every thread's acc, in every thread of every block:
// a warp butterfly, the block's warps' sums by the same butterfly (in every
// warp), then the blocks' sums in rank order (the same butterfly) once
// warp 0 has pushed its block's into every block's shared memory; `bar`
// counts the bytes of the C pushes a block receives (cluster.cuh's
// protocol).
template <bool CLUSTER>
__device__ __forceinline__ float cluster_total(float acc, int C,
                                               unsigned long long* bar) {
  __shared__ float warp_part[32];
  __shared__ float slot[cluster::kMaxSize];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v[1] = {acc};
  cluster::warp_sums<1>(v);
  if (lane == 0) warp_part[warp] = v[0];
  __syncthreads();
  cluster::lanes_sums<1>(warp_part, 0, blockDim.x >> 5, v);
  if (!CLUSTER) return v[0];
  cluster::wait();                     // every block runs, bar initialised
  if (warp == 0 && lane < C)
    cluster::store_async(&slot[cluster::rank()], bar, lane, v[0]);
  cluster::mbar_wait(bar);
  cluster::lanes_sums<1>(slot, 0, C, v);
  return v[0];
}

__device__ __forceinline__ void step_element(float* __restrict__ p,
                                             float* __restrict__ mu,
                                             float* __restrict__ nu,
                                             float* __restrict__ tgt, int i,
                                             float gi, float pi, float m,
                                             float v, float ti, float norm,
                                             const Scalars& s) {
  if (!(norm < s.max_norm)) gi = (gi / norm) * s.max_norm;
  const float pn = adamw_element(gi, pi, m, v, s);
  mu[i] = m;
  nu[i] = v;
  p[i] = pn;
  if (tgt != nullptr) tgt[i] = s.tau * pn + s.c_tau * ti;
}

// The clipped step.  G clusters of C blocks of T threads; thread q of a
// cluster owns slots k (element q + k S, S = C T) in [c E, c E + E) of
// cluster c, and every cluster sums the squares of slots 0 .. G E - 1.
// K == 8 (E == 1, G <= 8; slots k >= G masked): the G gradient values and
// the owned element's operands are loaded into registers at once before
// the reduction; K == 0: the sum and the owned slots in loops.
template <int K, bool CLUSTER>
__global__ void __launch_bounds__(kMaxThreads)
adamw_clip_kernel(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ mu, float* __restrict__ nu,
                  float* __restrict__ tgt, int n, int C, int E, Scalars s) {
  __shared__ unsigned long long bar;
  if (CLUSTER) {
    if (threadIdx.x == 0) cluster::mbar_init(&bar, 4 * C);
    cluster::arrive_relaxed();
  }
  const int S = C * blockDim.x;
  const int q = (CLUSTER ? (int)cluster::rank() : 0) * blockDim.x
      + threadIdx.x;
  const int c = blockIdx.x / C, G = gridDim.x / C;
  const bool polyak = tgt != nullptr;
  float acc = 0.0f;
  float gi = 0.0f, pi = 0.0f, m = 0.0f, v = 0.0f, ti = 0.0f;
  const int i0 = q + c * S;
  if (K > 0) {
    if (i0 < n) {
      pi = p[i0];
      m = mu[i0];
      v = nu[i0];
      if (polyak) ti = tgt[i0];
    }
    float x[K > 0 ? K : 1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = q + k * S;
      x[k] = (k < G && i < n) ? __ldg(g + i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) acc += x[k] * x[k];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k == c) gi = x[k];
  } else {
    acc = sumsq(g, n, q, S, 0, G * E, acc);
  }
  const float norm = sqrtf(cluster_total<CLUSTER>(acc, C, &bar));
  if (K > 0) {
    if (i0 < n) step_element(p, mu, nu, tgt, i0, gi, pi, m, v, ti, norm, s);
    return;
  }
  for (int k = c * E; k < c * E + E; ++k) {
    const int i = q + k * S;
    if (i >= n) break;
    step_element(p, mu, nu, tgt, i, __ldg(g + i), p[i], mu[i], nu[i],
                 polyak ? tgt[i] : 0.0f, norm, s);
  }
}

template <int K>
cudaError_t launch_clip(float* p, const float* g, float* mu, float* nu,
                        float* tgt, int n, int G, int C, int T, int E,
                        const Scalars& s, cudaStream_t st) {
  if (C == 1) {
    adamw_clip_kernel<K, false><<<G, T, 0, st>>>(p, g, mu, nu, tgt, n, C, E,
                                                 s);
    return cudaGetLastError();
  }
  return cluster::launch<adamw_clip_kernel<K, true>>(G * C, T, C, 0, st, p,
                                                    g, mu, nu, tgt, n, C, E,
                                                    s);
}

// The card's floor for one launch: an empty kernel.
__global__ void empty_kernel(int) {}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The clipped step runs the plan (G clusters, C blocks a cluster, T threads
// a block, E slots a thread: G C T E >= n); max_norm <= 0 ignores it.
extern "C" int flat_adamw_launch(void* p, const void* g, void* mu, void* nu,
                                 void* tgt, int n, int G, int C, int T, int E,
                                 float max_norm, float b1, float c1, float b2,
                                 float c2, float eps, float wd, float bc1,
                                 float bc2, float step, float tau, float c_tau,
                                 void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scalars s{max_norm, b1, c1, b2, c2, eps, wd, bc1, bc2, step, tau, c_tau};
  float* pp = (float*)p;
  const float* gg = (const float*)g;
  float *m = (float*)mu, *v = (float*)nu, *t = (float*)tgt;
  if (!(max_norm > 0.0f)) {
    adamw_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        pp, gg, m, v, t, n, s);
    return (int)cudaGetLastError();
  }
  if (G < 1 || C < 1 || C > cluster::kMaxSize || (C & (C - 1)) != 0 ||
      T < 32 || T % 32 != 0 || T > kMaxThreads || E < 1 ||
      (long long)G * C * T * E < n)
    return (int)cudaErrorInvalidConfiguration;
  if (E == 1 && G <= 8) return (int)launch_clip<8>(pp, gg, m, v, t, n, G, C, T, E, s, st);
  return (int)launch_clip<0>(pp, gg, m, v, t, n, G, C, T, E, s, st);
}

// An empty kernel, launched plain (cluster_size 1) or in clusters: the
// card's floor for one launch.
extern "C" int empty_launch(int blocks, int threads, int cluster_size,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cluster_size <= 1) {
    empty_kernel<<<blocks, threads, 0, st>>>(0);
    return (int)cudaGetLastError();
  }
  return (int)cluster::launch<empty_kernel>(blocks, threads, cluster_size, 0,
                                           st, 0);
}
