// SAC's squashed-Gaussian head on one row, shared by the fused head kernel
// (sac_sample.cu, the training path) and the MLP SAC actor's acting kernel
// (mlp_sac_actor.cu).
//
// The two Dense heads on the trunk's last hidden activations h (H floats):
//   mean = h W_m + b_m;  log_std = clip(h W_ls + b_ls, LOG_SIG_MIN, LOG_SIG_MAX)
// each dot product in k order (s = h_0 w_0, then s = s + h_k w_k), then the
// bias: one fixed order, so a rerun repeats its bits.  clip keeps a NaN
// (torch.clamp's forward) and its gradient passes where LOG_SIG_MIN <= x <=
// LOG_SIG_MAX, the bounds included (torch.clamp's backward, the port's plain
// path).  Then the sample and its log-prob term (gym_rotor_tpu/models/mlp.py:
// 129-143 sac_sample_with_noise, the expression as JAX writes it):
//   std = exp(ls); x = m + std n; a = tanh(x)
//   logp += -0.5 ((x - m) / std)^2 - ls - log(2 pi) / 2 - log((1 - a^2) + EPS)
// and its derivative as written, through both paths of z = (x - m) / std
// (directly and through x), not an algebraically simplified one:
//   g_z = -g_logp z;  g_d = g_z / std;  g_std_z = -g_z (x - m) / std^2
//   g_x = g_a (1 - a^2) + g_logp 2 a (1 - a^2) / ((1 - a^2) + EPS) + g_d
//   g_m = g_x - g_d;  g_std = g_x n + g_std_z;  g_ls = std g_std - g_logp
// The sources that include this are built with -fmad=false, so each product
// and sum rounds once, as the plain twins' elementwise expressions do.
#pragma once

#include <math.h>

namespace sac {

constexpr float kEps = 1e-6f;
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kLogSigMin = -20.0f;
constexpr float kLogSigMax = 2.0f;

__host__ __device__ __forceinline__ float clip_log_std(float x) {
  return x < kLogSigMin ? kLogSigMin : (x > kLogSigMax ? kLogSigMax : x);
}

__host__ __device__ __forceinline__ bool in_clip(float x) {
  return x >= kLogSigMin && x <= kLogSigMax;
}

// Action a's two head dot products, the mean's (m) and the log-std's
// before its bias and clip (l), over the hidden floats k0 <= k < k1, added
// to (m, l) in k order; k0 = 0 starts them (m = h_0 W_m[0][a]).  hk: h_k0
// onwards (hk[k - k0] = h_k); W_m and W_ls element (k, a) at
// W[k * ld + a].  HT > 0: the whole row in one call (k0 = 0, k1 = HT),
// unrolled.
template <int HT>
__device__ __forceinline__ void head_dots(const float* hk, int k0, int k1,
                                          const float* Wm, const float* Wl,
                                          int ld, int a, float& m, float& l) {
  if (k0 == 0) {
    m = hk[0] * Wm[a];
    l = hk[0] * Wl[a];
  }
  if (HT > 0) {
#pragma unroll
    for (int k = 1; k < HT; ++k) {
      const float h = hk[k];
      m = m + h * Wm[k * ld + a];
      l = l + h * Wl[k * ld + a];
    }
  } else {
    for (int k = k0 > 1 ? k0 : 1; k < k1; ++k) {
      const float h = hk[k - k0];
      m = m + h * Wm[k * ld + a];
      l = l + h * Wl[k * ld + a];
    }
  }
}

// The draw of one action: std, x = m + std n and the action tanh(x).
struct Draw {
  float sd, x, a;
};

__device__ __forceinline__ Draw draw(float m, float ls, float n) {
  const float sd = expf(ls);
  const float x = m + sd * n;
  return Draw{sd, x, tanhf(x)};
}

// One action's term of the summed log-prob.
__device__ __forceinline__ float log_prob(float m, float ls, const Draw& d) {
  const float z = (d.x - m) / d.sd;
  const float l = -0.5f * (z * z) - ls - kHalfLog2Pi;
  return l - logf((1.0f - d.a * d.a) + kEps);
}

// (g_m, g_ls) of one action for the cotangents g_a (the action) and gl (the
// row's summed log-prob); g_ls before the clip's mask.
__device__ __forceinline__ void sample_backward(float g_a, float gl, float m,
                                                float ls, float n, float* g_m,
                                                float* g_ls) {
  const Draw dr = draw(m, ls, n);
  const float d = dr.x - m;
  const float z = d / dr.sd;
  const float one_m = 1.0f - dr.a * dr.a;
  const float g_z = -gl * z;
  const float g_d = g_z / dr.sd;
  const float g_std_z = (-g_z * d) / (dr.sd * dr.sd);
  float g_x = g_a * one_m;
  g_x = g_x + gl * ((2.0f * dr.a * one_m) / (one_m + kEps));
  g_x = g_x + g_d;
  *g_m = g_x - g_d;
  const float g_std = g_x * n + g_std_z;
  *g_ls = dr.sd * g_std - gl;
}

}  // namespace sac
