// K13: PPO's clipped surrogate with its entropy bonus, forward and backward,
// for Hopper (sm_90a).
//
// Replaces gym_rotor_tpu/algos/ppo.py:247-258 (the surrogate of the actor
// loss over the first mb rows of the actor's [o; o_next; o + eps] forward)
// and its autodiff in jax.value_and_grad, which XLA fused into the actor
// update on the TPU.  Plain twins: gym_rotor_tpu_torch/kernels/ppo_loss.py:
// ppo_loss_plain and ppo_loss_backward_plain.
//
// Per row r of mb, with std = exp(ls) (ls = log_std, shared by every row):
//   lp_j  = -0.5 ((a_j - m_j) / std_j)^2 - ls_j - log(2 pi) / 2
//   ratio = exp(sum_j lp_j - sum_j lp_old_j)
//   s1 = ratio adv;  s2 = min(hi, max(lo, ratio)) adv   (lo, hi = 1 -+ eps)
//   term  = min(s1, s2) + coef sum_j (ls_j + log(2 pi e) / 2)
//   loss  = -mean_r(term)
// The backward is JAX's derivative, ties included: jnp.minimum and the two
// halves of jnp.clip (maximum, then minimum) give each side HALF the
// cotangent where the two are equal.  Inside the clip range s1 == s2
// exactly and the halves add up; at ratio == lo or hi they do not.
//   gt = -g / mb;  g_ratio = gt w1 adv + gt w2 adv c_hi c_lo  (w, c: 1, 1/2, 0)
//   g_S = g_ratio ratio;  g_m_j = g_S z_j / std_j
//   g_ls_j = sum_r (g_S z_j^2 - g_S + gt coef)     (z = (a - m) / std)
// log_std is broadcast over the rows, so its gradient is a sum over rows.
// coef (the decayed entropy coefficient) and the cotangent g are read from
// device memory: the host never waits for them.
//
// Bound on an H100: the bytes, and few.  Forward, per row of A <= 4
// actions: mean, a, lp_old (12 A bytes) and adv read; at the 4096-env
// configuration's 3723-row minibatch of 4 actions, ~0.19 MB, ~0.06 us; the
// backward adds g_mean's 4 A bytes a row.  ~15 flops an element.  The
// launch itself dominates at these sizes.
//
// Design: one launch a call.  Thread q of the launch takes rows q, q + S,
// ... (S its threads, R rows a thread: the plan,
// kernels/ppo_loss.py:ppo_loss_plan), the row's A elements unrolled (A a
// template parameter); each thread adds its rows' terms in row order, a
// warp butterfly and then the same butterfly over the block's warps sum the
// block, and past one block a thread-block cluster of C blocks adds the
// blocks' sums in rank order through distributed shared memory in block 0,
// which writes the loss (-sum / B) or g_log_std: a fixed order, so a run
// repeats its numbers, with no second launch and no scratch.  The backward
// recomputes the row's forward from its inputs.  Built with -fmad=false so
// the products and sums round as the plain twin's torch ops do.
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kHalfLog2PiE = 1.41893853320467274f;

// The sums of v[j] (j < W) over the block, then (CLUSTER) over the
// cluster's blocks in block 0: a warp butterfly, the block's warps' sums by
// the same butterfly (in every warp), then the blocks' in rank order (the
// same butterfly) once each block's warp 0 has pushed its sums into block
// 0, whose `bar` counts the bytes of the C pushes (cluster.cuh's
// protocol).  True in the threads that hold the sums in out (every thread
// of block 0); the other blocks may exit.
template <int W, bool CLUSTER>
__device__ __forceinline__ bool cluster_sums(float (&v)[W], float (&out)[W],
                                             unsigned long long* bar) {
  __shared__ float warp_part[W][32];
  __shared__ float slot[W][cluster::kMaxSize];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  cluster::warp_sums<W>(v);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < W; ++j) warp_part[j][warp] = v[j];
  }
  __syncthreads();
  cluster::lanes_sums<W>(&warp_part[0][0], 32, blockDim.x >> 5, out);
  if (!CLUSTER) return true;
  cluster::wait();                     // every block runs, bar initialised
  if (warp == 0 && lane == 0) {
    const unsigned rank = cluster::rank();
#pragma unroll
    for (int j = 0; j < W; ++j)
      cluster::store_async(&slot[j][rank], bar, 0u, out[j]);
  }
  if (blockIdx.x != 0) return false;
  cluster::mbar_wait(bar);
  cluster::lanes_sums<W>(&slot[0][0], cluster::kMaxSize, gridDim.x, out);
  return true;
}

// A row of A floats: with VEC one 16- or 8-byte access for A = 4 or 2
// (dispatch() sets VEC where every row is that aligned), else A scalar ones.
template <int A, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&x)[A]) {
  if constexpr (VEC && A == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (VEC && A == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < A; ++j) x[j] = __ldg(p + j);
  }
}

// g_mean's row: the wrapper allocates g_mean, so its rows are aligned.
template <int A>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&x)[A]) {
  if constexpr (A == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (A == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int j = 0; j < A; ++j) p[j] = x[j];
  }
}

// The row's forward: z_j, ratio, s1, s2 and the clip's inner maximum.
template <int A>
struct Row {
  float z[A], sd[A];
  float ratio, s1, s2, m1;
};

template <int A, bool VEC>
__device__ Row<A> row_forward(const float* mean, const float* ls,
                              const float* act, const float* lp_old,
                              float adv, float lo, float hi) {
  Row<A> w;
  float m[A], a[A], lo_[A];
  load_row<A, VEC>(mean, m);
  load_row<A, VEC>(act, a);
  load_row<A, VEC>(lp_old, lo_);
  float s = 0.0f, so = 0.0f;
#pragma unroll
  for (int j = 0; j < A; ++j) {
    w.sd[j] = expf(ls[j]);
    w.z[j] = (a[j] - m[j]) / w.sd[j];
    const float lp = -0.5f * (w.z[j] * w.z[j]) - ls[j] - kHalfLog2Pi;
    s += lp;
    so += lo_[j];
  }
  w.ratio = expf(s - so);
  w.s1 = w.ratio * adv;
  w.m1 = fmaxf(lo, w.ratio);
  w.s2 = fminf(hi, w.m1) * adv;
  return w;
}

template <int A, bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(kMaxThreads)
ppo_loss_fwd_kernel(const float* __restrict__ mean,
                    const float* __restrict__ log_std,
                    const float* __restrict__ act,
                    const float* __restrict__ lp_old,
                    const float* __restrict__ adv,
                    const float* __restrict__ coef, int B, int R, float lo,
                    float hi, float* __restrict__ loss) {
  __shared__ unsigned long long bar;
  if (CLUSTER) {
    if (threadIdx.x == 0) cluster::mbar_init(&bar, 4 * gridDim.x);
    cluster::arrive_relaxed();
  }
  float ls[A];
  float ent = 0.0f;
#pragma unroll
  for (int j = 0; j < A; ++j) {
    ls[j] = log_std[j];
    ent += ls[j] + kHalfLog2PiE;
  }
  const float cf = coef[0];
  const int S = gridDim.x * blockDim.x;
  float acc[1] = {0.0f};
  for (int k = 0, r = blockIdx.x * blockDim.x + threadIdx.x; k < R;
       ++k, r += S) {
    if (r < B) {
      const size_t o = (size_t)r * A;
      const Row<A> w = row_forward<A, VEC>(mean + o, ls, act + o,
                                           lp_old + o, adv[r], lo, hi);
      acc[0] += fminf(w.s1, w.s2) + cf * ent;
    }
  }
  float sum[1];
  if (cluster_sums<1, CLUSTER>(acc, sum, &bar) && threadIdx.x == 0)
    loss[0] = -(sum[0] / (float)B);
}

template <int A, bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(kMaxThreads)
ppo_loss_bwd_kernel(const float* __restrict__ mean,
                    const float* __restrict__ log_std,
                    const float* __restrict__ act,
                    const float* __restrict__ lp_old,
                    const float* __restrict__ adv,
                    const float* __restrict__ coef,
                    const float* __restrict__ g, int B, int R, float lo,
                    float hi, float* __restrict__ g_mean,
                    float* __restrict__ g_log_std) {
  __shared__ unsigned long long bar;
  if (CLUSTER) {
    if (threadIdx.x == 0) cluster::mbar_init(&bar, 4 * A * gridDim.x);
    cluster::arrive_relaxed();
  }
  float ls[A];
#pragma unroll
  for (int j = 0; j < A; ++j) ls[j] = log_std[j];
  const float gt = -g[0] / (float)B;
  const float g_ent = gt * coef[0];
  const int S = gridDim.x * blockDim.x;
  float acc[A];
#pragma unroll
  for (int j = 0; j < A; ++j) acc[j] = 0.0f;
  for (int k = 0, r = blockIdx.x * blockDim.x + threadIdx.x; k < R;
       ++k, r += S) {
    if (r < B) {
      const size_t o = (size_t)r * A;
      const float ad = adv[r];
      const Row<A> w = row_forward<A, VEC>(mean + o, ls, act + o,
                                           lp_old + o, ad, lo, hi);
      const float w1 = w.s1 < w.s2 ? 1.0f : (w.s1 == w.s2 ? 0.5f : 0.0f);
      const float w2 = w.s2 < w.s1 ? 1.0f : (w.s1 == w.s2 ? 0.5f : 0.0f);
      const float c_hi = w.m1 < hi ? 1.0f : (w.m1 == hi ? 0.5f : 0.0f);
      const float c_lo = w.ratio > lo ? 1.0f : (w.ratio == lo ? 0.5f : 0.0f);
      const float g_m1 = gt * w2 * ad * c_hi;
      const float g_ratio = gt * w1 * ad + g_m1 * c_lo;
      const float g_s = g_ratio * w.ratio;
      float gm[A];
#pragma unroll
      for (int j = 0; j < A; ++j) {
        // a zero numerator (a zero advantage, a clipped side) would send
        // the division down its slow path; a zero over sd > 0 is that zero
        gm[j] = g_s * w.z[j];
        if (gm[j] != 0.0f) gm[j] = gm[j] / w.sd[j];
        acc[j] += g_s * (w.z[j] * w.z[j] - 1.0f) + g_ent;
      }
      store_row<A>(g_mean + o, gm);
    }
  }
  float sum[A];
  if (cluster_sums<A, CLUSTER>(acc, sum, &bar) && threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < A; ++j) g_log_std[j] = sum[j];
  }
}

template <int A, bool VEC, bool CLUSTER>
cudaError_t launch_as(const float* mean, const float* log_std,
                      const float* act, const float* lp_old,
                      const float* adv, const float* coef, const float* g,
                      int B, int C, int T, int R, float lo, float hi,
                      float* out, float* g_mean, bool backward,
                      cudaStream_t st) {
  if (!CLUSTER) {
    if (backward)
      ppo_loss_bwd_kernel<A, VEC, false><<<1, T, 0, st>>>(
          mean, log_std, act, lp_old, adv, coef, g, B, R, lo, hi, g_mean,
          out);
    else
      ppo_loss_fwd_kernel<A, VEC, false><<<1, T, 0, st>>>(
          mean, log_std, act, lp_old, adv, coef, B, R, lo, hi, out);
    return cudaGetLastError();
  }
  if (backward)
    return cluster::launch<ppo_loss_bwd_kernel<A, VEC, true>>(
        C, T, C, 0, st, mean, log_std, act, lp_old, adv, coef, g, B, R, lo,
        hi, g_mean, out);
  return cluster::launch<ppo_loss_fwd_kernel<A, VEC, true>>(
      C, T, C, 0, st, mean, log_std, act, lp_old, adv, coef, B, R, lo, hi,
      out);
}

template <int A, bool VEC>
cudaError_t launch(const float* mean, const float* log_std, const float* act,
                   const float* lp_old, const float* adv, const float* coef,
                   const float* g, int B, int C, int T, int R, float lo,
                   float hi, float* out, float* g_mean, bool backward,
                   cudaStream_t st) {
  return C == 1
      ? launch_as<A, VEC, false>(mean, log_std, act, lp_old, adv, coef, g, B, C,
                            T, R, lo, hi, out, g_mean, backward, st)
      : launch_as<A, VEC, true>(mean, log_std, act, lp_old, adv, coef, g, B, C, T,
                           R, lo, hi, out, g_mean, backward, st);
}

int dispatch(const void* mean, const void* log_std, const void* act,
             const void* lp_old, const void* adv, const void* coef,
             const void* g, int B, int A, int C, int T, int R, float lo,
             float hi, void* out, void* g_mean, bool backward, void* stream) {
  if (B <= 0 || C < 1 || C > cluster::kMaxSize || (C & (C - 1)) != 0 ||
      T < 32 || T % 32 != 0 || T > kMaxThreads || R < 1 ||
      (long long)C * T * R < B)
    return (int)cudaErrorInvalidConfiguration;
  const float* m = (const float*)mean;
  const float* s = (const float*)log_std;
  const float* a = (const float*)act;
  const float* l = (const float*)lp_old;
  const float* d = (const float*)adv;
  const float* c = (const float*)coef;
  const float* gg = (const float*)g;
  float* y = (float*)out;
  float* gm = (float*)g_mean;
  cudaStream_t st = (cudaStream_t)stream;
  // rows load as one vector where all three row arrays start on 4 A bytes
  // (rows of A floats then stay so aligned); else a float at a time
  const bool vec =
      (((size_t)m | (size_t)a | (size_t)l) % (sizeof(float) * A)) == 0;
  switch (A) {
    case 1: return (int)launch<1, false>(m, s, a, l, d, c, gg, B, C, T, R, lo, hi, y, gm, backward, st);
    case 2: return vec ? (int)launch<2, true>(m, s, a, l, d, c, gg, B, C, T, R, lo, hi, y, gm, backward, st)
                       : (int)launch<2, false>(m, s, a, l, d, c, gg, B, C, T, R, lo, hi, y, gm, backward, st);
    case 3: return (int)launch<3, false>(m, s, a, l, d, c, gg, B, C, T, R, lo, hi, y, gm, backward, st);
    case 4: return vec ? (int)launch<4, true>(m, s, a, l, d, c, gg, B, C, T, R, lo, hi, y, gm, backward, st)
                       : (int)launch<4, false>(m, s, a, l, d, c, gg, B, C, T, R, lo, hi, y, gm, backward, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// mean, act, lp_old: (B, A); log_std: (A,); adv: (B,); coef: one float;
// loss: one float.  The plan: C blocks (one cluster when C > 1) of T
// threads, R rows a thread (C T R >= B).
extern "C" int ppo_loss_fwd_launch(const void* mean, const void* log_std,
                                   const void* act, const void* lp_old,
                                   const void* adv, const void* coef, int B,
                                   int A, int C, int T, int R, float lo,
                                   float hi, void* loss, void* stream) {
  return dispatch(mean, log_std, act, lp_old, adv, coef, nullptr, B, A, C, T,
                  R, lo, hi, loss, nullptr, false, stream);
}

// As the forward, plus g (one float, the loss's cotangent); g_mean: (B, A);
// g_log_std: (A,).
extern "C" int ppo_loss_bwd_launch(const void* mean, const void* log_std,
                                   const void* act, const void* lp_old,
                                   const void* adv, const void* coef,
                                   const void* g, int B, int A, int C, int T,
                                   int R, float lo, float hi, void* g_mean,
                                   void* g_log_std, void* stream) {
  return dispatch(mean, log_std, act, lp_old, adv, coef, g, B, A, C, T, R, lo,
                  hi, g_log_std, g_mean, true, stream);
}
