// PPO's acting head on one action of one row (gym_rotor_tpu/algos/ppo.py:
// 107-116 with models/mlp.py:173-178), shared by K11's epilogue
// (emlp_actor.cu) and the MLP PPO actor's kernel (mlp_ppo_actor.cu).
//
// mu = tanh(pre); with a draw n, a = clip(mu + exp(ls) n, +-max) and
// logp = -0.5 ((a - mu) / exp(ls))^2 - ls - log(2 pi) / 2 of the CLIPPED
// action; without one (eval), a = clip(mu, +-max) and logp = 0.  ls is the
// free log_std parameter, not clipped (the reference's).
#pragma once

#include <math.h>

namespace ppo {

constexpr float kHalfLog2Pi = 0.91893853320467274f;

__device__ __forceinline__ void head(float pre, float ls, const float* noise,
                                     float max_action, float* act_out,
                                     float* logp_out) {
  const float mu = tanhf(pre);
  float act = mu, lp = 0.0f;
  if (noise != nullptr) {
    const float sd = expf(ls);
    act = mu + sd * (*noise);
    act = fminf(fmaxf(act, -max_action), max_action);
    const float z = (act - mu) / sd;
    lp = -0.5f * (z * z) - ls - kHalfLog2Pi;
  } else {
    act = fminf(fmaxf(act, -max_action), max_action);
  }
  *act_out = act;
  *logp_out = lp;
}

}  // namespace ppo
