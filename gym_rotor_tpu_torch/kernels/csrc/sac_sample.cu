// K10: the squashed-Gaussian sample of SAC and its summed log-prob, forward
// and backward, for Hopper (sm_90a).
//
// Replaces gym_rotor_tpu/models/mlp.py:129 sac_sample_with_noise and its
// autodiff (jax.value_and_grad through the SAC actor loss), which XLA fused
// into the actor-loss program on the TPU.  Plain twins:
// gym_rotor_tpu_torch/kernels/sac_sample.py:sac_sample_plain and
// sac_sample_backward_plain.
//
// Bound on an H100: the bytes, and few.  Forward, per row of A <= 4 actions:
// reads mean, log_std and noise (12 A bytes), writes the action and the
// log-prob (4 A + 4 bytes); at the actor loss's 1024 rows of 4 actions that
// is ~66 KB, ~0.02 us at 3.35 TB/s; the ~20 flops and 4 transcendentals an
// element are less.  A launch of this size is dominated by the launch itself.
//
// Design: one thread per row, the row's A <= 4 elements unrolled (A is a
// template parameter), the log-prob's sum over the row in registers.  The
// expression is JAX's as written:
//   std = exp(ls); x = m + std n; a = tanh(x)
//   logp = sum(-0.5 ((x - m) / std)^2 - ls - log(2 pi) / 2 - log((1 - a^2) + EPS))
// The backward recomputes the forward from (m, ls, n) and differentiates that
// expression as written, through both paths of z = (x - m) / std (directly
// and through x), not an algebraically simplified one:
//   g_z = -g_logp z;  g_d = g_z / std;  g_std_z = -g_z (x - m) / std^2
//   g_x = g_a (1 - a^2) + g_logp 2 a (1 - a^2) / ((1 - a^2) + EPS) + g_d
//   g_m = g_x - g_d;  g_std = g_x n + g_std_z;  g_ls = std g_std - g_logp
// Built with -fmad=false so the products and sums round like the plain twin.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-6f;
constexpr float kHalfLog2Pi = 0.91893853320467274f;

template <int A>
__global__ void __launch_bounds__(kThreads)
sac_sample_fwd_kernel(const float* __restrict__ mean,
                      const float* __restrict__ log_std,
                      const float* __restrict__ noise, int B,
                      float* __restrict__ action, float* __restrict__ logp) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const size_t o = (size_t)row * A;
  float lp = 0.0f;
#pragma unroll
  for (int e = 0; e < A; ++e) {
    const float m = mean[o + e], ls = log_std[o + e];
    const float sd = expf(ls);
    const float x = m + sd * noise[o + e];
    const float a = tanhf(x);
    const float z = (x - m) / sd;
    float l = -0.5f * (z * z) - ls - kHalfLog2Pi;
    l = l - logf((1.0f - a * a) + kEps);
    lp += l;
    action[o + e] = a;
  }
  logp[row] = lp;
}

template <int A>
__global__ void __launch_bounds__(kThreads)
sac_sample_bwd_kernel(const float* __restrict__ g_action,
                      const float* __restrict__ g_logp,
                      const float* __restrict__ mean,
                      const float* __restrict__ log_std,
                      const float* __restrict__ noise, int B,
                      float* __restrict__ g_mean,
                      float* __restrict__ g_log_std) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const size_t o = (size_t)row * A;
  const float gl = g_logp[row];
#pragma unroll
  for (int e = 0; e < A; ++e) {
    const float m = mean[o + e], ls = log_std[o + e], n = noise[o + e];
    const float sd = expf(ls);
    const float x = m + sd * n;
    const float a = tanhf(x);
    const float d = x - m;
    const float z = d / sd;
    const float one_m = 1.0f - a * a;
    const float g_z = -gl * z;
    const float g_d = g_z / sd;
    const float g_std_z = (-g_z * d) / (sd * sd);
    float g_x = g_action[o + e] * one_m;
    g_x = g_x + gl * ((2.0f * a * one_m) / (one_m + kEps));
    g_x = g_x + g_d;
    g_mean[o + e] = g_x - g_d;
    const float g_std = g_x * n + g_std_z;
    g_log_std[o + e] = sd * g_std - gl;
  }
}

template <int A>
int launch(const float* g_action, const float* g_logp, const float* mean,
           const float* log_std, const float* noise, int B, float* out0,
           float* out1, bool backward, cudaStream_t st) {
  const int blocks = (B + kThreads - 1) / kThreads;
  if (backward)
    sac_sample_bwd_kernel<A><<<blocks, kThreads, 0, st>>>(
        g_action, g_logp, mean, log_std, noise, B, out0, out1);
  else
    sac_sample_fwd_kernel<A><<<blocks, kThreads, 0, st>>>(
        mean, log_std, noise, B, out0, out1);
  return (int)cudaGetLastError();
}

int dispatch(const void* g_action, const void* g_logp, const void* mean,
             const void* log_std, const void* noise, int B, int act,
             void* out0, void* out1, bool backward, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const float* ga = (const float*)g_action;
  const float* gl = (const float*)g_logp;
  const float* m = (const float*)mean;
  const float* s = (const float*)log_std;
  const float* n = (const float*)noise;
  float* y0 = (float*)out0;
  float* y1 = (float*)out1;
  cudaStream_t st = (cudaStream_t)stream;
  switch (act) {
    case 1: return launch<1>(ga, gl, m, s, n, B, y0, y1, backward, st);
    case 2: return launch<2>(ga, gl, m, s, n, B, y0, y1, backward, st);
    case 3: return launch<3>(ga, gl, m, s, n, B, y0, y1, backward, st);
    case 4: return launch<4>(ga, gl, m, s, n, B, y0, y1, backward, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// mean, log_std, noise, action: (B, act) row-major; logp: (B,).
extern "C" int sac_sample_fwd_launch(const void* mean, const void* log_std,
                                     const void* noise, int B, int act,
                                     void* action, void* logp, void* stream) {
  return dispatch(nullptr, nullptr, mean, log_std, noise, B, act, action,
                  logp, false, stream);
}

// g_action, mean, log_std, noise, g_mean, g_log_std: (B, act); g_logp: (B,).
extern "C" int sac_sample_bwd_launch(const void* g_action, const void* g_logp,
                                     const void* mean, const void* log_std,
                                     const void* noise, int B, int act,
                                     void* g_mean, void* g_log_std,
                                     void* stream) {
  return dispatch(g_action, g_logp, mean, log_std, noise, B, act, g_mean,
                  g_log_std, true, stream);
}
