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
// launches dominate at these sizes.
//
// Design: one thread per row, the row's A elements unrolled (A a template
// parameter); the sums over rows (the loss, and g_ls per action) are
// per-block partials in a fixed tree order, added in block order by a
// one-block second launch, so a run repeats its numbers.  The backward
// recomputes the row's forward from its inputs.  Built with -fmad=false so
// the products and sums round as the plain twin's torch ops do.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kHalfLog2PiE = 1.41893853320467274f;

__device__ float block_sum(float v, float* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  const float total = buf[0];
  __syncthreads();
  return total;
}

// The row's forward: z_j, ratio, s1, s2 and the clip's inner maximum.
template <int A>
struct Row {
  float z[A], sd[A];
  float ratio, s1, s2, m1;
};

template <int A>
__device__ Row<A> row_forward(const float* mean, const float* ls,
                              const float* act, const float* lp_old,
                              float adv, float lo, float hi) {
  Row<A> w;
  float s = 0.0f, so = 0.0f;
#pragma unroll
  for (int j = 0; j < A; ++j) {
    w.sd[j] = expf(ls[j]);
    w.z[j] = (act[j] - mean[j]) / w.sd[j];
    const float lp = -0.5f * (w.z[j] * w.z[j]) - ls[j] - kHalfLog2Pi;
    s += lp;
    so += lp_old[j];
  }
  w.ratio = expf(s - so);
  w.s1 = w.ratio * adv;
  w.m1 = fmaxf(lo, w.ratio);
  w.s2 = fminf(hi, w.m1) * adv;
  return w;
}

template <int A>
__global__ void __launch_bounds__(kThreads)
ppo_loss_fwd_kernel(const float* __restrict__ mean,
                    const float* __restrict__ log_std,
                    const float* __restrict__ act,
                    const float* __restrict__ lp_old,
                    const float* __restrict__ adv,
                    const float* __restrict__ coef, int B, float lo, float hi,
                    float* __restrict__ partial) {
  __shared__ float buf[kThreads];
  float ls[A];
  float ent = 0.0f;
#pragma unroll
  for (int j = 0; j < A; ++j) {
    ls[j] = log_std[j];
    ent += ls[j] + kHalfLog2PiE;
  }
  const int r = blockIdx.x * kThreads + threadIdx.x;
  float term = 0.0f;
  if (r < B) {
    const size_t o = (size_t)r * A;
    const Row<A> w = row_forward<A>(mean + o, ls, act + o, lp_old + o,
                                    adv[r], lo, hi);
    term = fminf(w.s1, w.s2) + coef[0] * ent;
  }
  const float s = block_sum(term, buf);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

template <int A>
__global__ void __launch_bounds__(kThreads)
ppo_loss_bwd_kernel(const float* __restrict__ mean,
                    const float* __restrict__ log_std,
                    const float* __restrict__ act,
                    const float* __restrict__ lp_old,
                    const float* __restrict__ adv,
                    const float* __restrict__ coef,
                    const float* __restrict__ g, int B, float lo, float hi,
                    float* __restrict__ g_mean, float* __restrict__ partial) {
  __shared__ float buf[kThreads];
  float ls[A];
#pragma unroll
  for (int j = 0; j < A; ++j) ls[j] = log_std[j];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  float gls[A];
#pragma unroll
  for (int j = 0; j < A; ++j) gls[j] = 0.0f;
  if (r < B) {
    const size_t o = (size_t)r * A;
    const float ad = adv[r];
    const Row<A> w = row_forward<A>(mean + o, ls, act + o, lp_old + o, ad,
                                    lo, hi);
    const float gt = -g[0] / (float)B;
    const float w1 = w.s1 < w.s2 ? 1.0f : (w.s1 == w.s2 ? 0.5f : 0.0f);
    const float w2 = w.s2 < w.s1 ? 1.0f : (w.s1 == w.s2 ? 0.5f : 0.0f);
    const float c_hi = w.m1 < hi ? 1.0f : (w.m1 == hi ? 0.5f : 0.0f);
    const float c_lo = w.ratio > lo ? 1.0f : (w.ratio == lo ? 0.5f : 0.0f);
    const float g_m1 = gt * w2 * ad * c_hi;
    const float g_ratio = gt * w1 * ad + g_m1 * c_lo;
    const float g_s = g_ratio * w.ratio;
    const float g_ent = gt * coef[0];
#pragma unroll
    for (int j = 0; j < A; ++j) {
      g_mean[o + j] = g_s * w.z[j] / w.sd[j];
      gls[j] = g_s * (w.z[j] * w.z[j] - 1.0f) + g_ent;
    }
  }
#pragma unroll
  for (int j = 0; j < A; ++j) {
    const float s = block_sum(gls[j], buf);
    if (threadIdx.x == 0) partial[(size_t)blockIdx.x * A + j] = s;
  }
}

// One block: column j of the (n_blocks, width) partials summed in block
// order; loss != 0 turns the forward's sum into -sum / B.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int n_blocks, int width, int B,
                                    int loss, float* __restrict__ out) {
  const int j = threadIdx.x;
  if (j >= width) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * width + j];
  out[j] = loss ? -(s / (float)B) : s;
}

template <int A>
int launch(const float* mean, const float* log_std, const float* act,
           const float* lp_old, const float* adv, const float* coef,
           const float* g, int B, float lo, float hi, float* out,
           float* g_mean, float* partial, bool backward, cudaStream_t st) {
  const int blocks = (B + kThreads - 1) / kThreads;
  if (backward)
    ppo_loss_bwd_kernel<A><<<blocks, kThreads, 0, st>>>(
        mean, log_std, act, lp_old, adv, coef, g, B, lo, hi, g_mean, partial);
  else
    ppo_loss_fwd_kernel<A><<<blocks, kThreads, 0, st>>>(
        mean, log_std, act, lp_old, adv, coef, B, lo, hi, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<<<1, 32, 0, st>>>(partial, blocks, backward ? A : 1, B,
                                        backward ? 0 : 1, out);
  return (int)cudaGetLastError();
}

int dispatch(const void* mean, const void* log_std, const void* act,
             const void* lp_old, const void* adv, const void* coef,
             const void* g, int B, int A, float lo, float hi, void* out,
             void* g_mean, void* partial, bool backward, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const float* m = (const float*)mean;
  const float* s = (const float*)log_std;
  const float* a = (const float*)act;
  const float* l = (const float*)lp_old;
  const float* d = (const float*)adv;
  const float* c = (const float*)coef;
  const float* gg = (const float*)g;
  float* y = (float*)out;
  float* gm = (float*)g_mean;
  float* p = (float*)partial;
  cudaStream_t st = (cudaStream_t)stream;
  switch (A) {
    case 1: return launch<1>(m, s, a, l, d, c, gg, B, lo, hi, y, gm, p, backward, st);
    case 2: return launch<2>(m, s, a, l, d, c, gg, B, lo, hi, y, gm, p, backward, st);
    case 3: return launch<3>(m, s, a, l, d, c, gg, B, lo, hi, y, gm, p, backward, st);
    case 4: return launch<4>(m, s, a, l, d, c, gg, B, lo, hi, y, gm, p, backward, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int ppo_loss_rows_per_block() { return kThreads; }

// mean, act, lp_old: (B, A); log_std: (A,); adv: (B,); coef: one float;
// loss: one float; partial: ceil(B / rows_per_block) floats.
extern "C" int ppo_loss_fwd_launch(const void* mean, const void* log_std,
                                   const void* act, const void* lp_old,
                                   const void* adv, const void* coef, int B,
                                   int A, float lo, float hi, void* loss,
                                   void* partial, void* stream) {
  return dispatch(mean, log_std, act, lp_old, adv, coef, nullptr, B, A, lo,
                  hi, loss, nullptr, partial, false, stream);
}

// As the forward, plus g (one float, the loss's cotangent); g_mean: (B, A);
// g_log_std: (A,); partial: ceil(B / rows_per_block) * A floats.
extern "C" int ppo_loss_bwd_launch(const void* mean, const void* log_std,
                                   const void* act, const void* lp_old,
                                   const void* adv, const void* coef,
                                   const void* g, int B, int A, float lo,
                                   float hi, void* g_mean, void* g_log_std,
                                   void* partial, void* stream) {
  return dispatch(mean, log_std, act, lp_old, adv, coef, g, B, A, lo, hi,
                  g_log_std, g_mean, partial, true, stream);
}
