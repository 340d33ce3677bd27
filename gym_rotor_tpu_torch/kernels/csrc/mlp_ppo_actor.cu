// The MLP PPO actor's acting forward with K11's head as its epilogue, for
// Hopper (sm_90a), in one launch:
//   h0 = relu(obs W0 + b0); h1 = relu(h0 W1 + b1); pre = h1 Wm + bm;
//   then ppo_head.cuh's ppo::head on each action: mu = tanh(pre), the
//   clipped draw clip(mu + exp(log_std) noise, +-max) and its per-dimension
//   log-prob, or (clip(mu), 0) without a draw (eval).
//
// Replaces gym_rotor_tpu/models/mlp.py:146-171 ActorPPO under
// algos/ppo.py:107-116 choose_action_f (with mlp.py:173-178
// gaussian_logprob), which XLA ran as one program on the TPU.  Plain twin:
// gym_rotor_tpu_torch/kernels/mlp_ppo_actor.py:mlp_ppo_actor_plain
// (models/mlp.py:actor_ppo_pre, F.linear on cuBLAS, then
// kernels/emlp_actor.py:ppo_head_plain).
//
// Bound on an H100: tiny either way.  Per row 2 (nin nh + nh nh + nh nact)
// flops of the three layers (1120 for agent 0, 15 / 16 / 4) and ~12 an
// action of the head; per row the obs, the draw, the action and the
// log-prob (108 bytes for agent 0) plus the ~3 KB of weights once: ~0.13 us
// of bytes at 4096 rows, ~0.002 us at PPO A's 32.  What holds a launch is
// its own cost and one row's chain: a load of the weights, three dot
// products of 15-23, 16 and 16 terms, tanh and exp.
//
// Design (the trunk is mlp_trunk.cuh's, shared with mlp_sac_actor.cu):
// blocks of 128 threads, a row on 4 lanes (32 rows a block, so PPO
// A's 32 rows run on 4 warps and 4096 rows on 128 blocks); every block
// stages the weights (read from the bound parameter tensors each call:
// nothing cached) and its rows' obs in shared memory, every copy a cp.async
// in flight at once (one memory round trip); then each lane of a row
// computes NH / 4 hidden units (the inputs in order, each unit its own
// chain, then the bias, then relu), the row's lanes exchange them through
// shared memory (a warp barrier), the second layer the same, and lane a of
// the row computes action a's mean (for one action, lane 0), then the
// head, writing the action and the log-prob through their row strides (a
// column slice of the joint action, the horizon's log-prob rows).  Every
// dot product has one fixed order; built with -fmad=false, so each product
// and sum rounds once, as the plain twin's elementwise head does.
// Instantiated for the MODUL actors (15, 16, 4) and (3, 4, 1) and the MONO
// actor (23, 16, 4).
#include <cuda_runtime.h>
#include <math.h>

#include "mlp_trunk.cuh"
#include "ppo_head.cuh"

namespace {

using mlp::kLanes;
using mlp::kRows;
using mlp::kThreads;

struct Weights {
  const float* w0;   // (nin, nh), flax's Dense kernel
  const float* b0;
  const float* w1;   // (nh, nh)
  const float* b1;
  const float* wm;   // (nh, nact)
  const float* bm;
  const float* log_std;
};

template <int NIN, int NH, int NACT>
__global__ void __launch_bounds__(kThreads)
mlp_ppo_actor_kernel(const float* __restrict__ obs, int B, Weights w,
                     const float* __restrict__ noise, int ld_noise,
                     float* __restrict__ out, int ld_out,
                     float* __restrict__ logp, int ld_logp,
                     float max_action) {
  __shared__ float W0[NIN * NH], B0[NH], W1[NH * NH], B1[NH];
  __shared__ float WM[NH * NACT], BM[NACT], LS[NACT];
  __shared__ float xs[kRows * NIN];
  __shared__ __align__(16) float hs[kRows][NH];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRows, nrow = min(kRows, B - r0);
  mlp::stage<NIN * NH>(W0, w.w0, t);
  mlp::stage<NH>(B0, w.b0, t);
  mlp::stage<NH * NH>(W1, w.w1, t);
  mlp::stage<NH>(B1, w.b1, t);
  mlp::stage<NH * NACT>(WM, w.wm, t);
  mlp::stage<NACT>(BM, w.bm, t);
  mlp::stage<NACT>(LS, w.log_std, t);
  mlp::stage_obs<NIN>(xs, obs, r0, nrow, t);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int row = t / kLanes, j = t % kLanes;
  float x[NH];
  mlp::hidden<NIN, NH>(xs, W0, B0, W1, B1, hs, t, x);
  if (row >= nrow) return;
  const size_t r = (size_t)r0 + row;
  for (int a = j; a < NACT; a += kLanes) {
    float s = x[0] * WM[a];
#pragma unroll
    for (int k = 1; k < NH; ++k) s = s + x[k] * WM[k * NACT + a];
    ppo::head(s + BM[a], LS[a],
              noise == nullptr ? nullptr : noise + r * ld_noise + a,
              max_action, out + r * ld_out + a, logp + r * ld_logp + a);
  }
}

#define MLP_PPO_ACTOR_INSTANCES(X) X(15, 16, 4) X(3, 4, 1) X(23, 16, 4)

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// obs (B, nin) contiguous; w0 (nin, nh), b0, w1 (nh, nh), b1, wm (nh,
// nact), bm, log_std (nact) contiguous; noise (B, nact) with row stride
// ld_noise, or null (eval); out and logp (B, nact) with their own row
// strides.  Dims without an instance: cudaErrorInvalidValue.
extern "C" int mlp_ppo_actor_launch(const void* obs, int B, int nin, int nh,
                                    int nact, const void* w0, const void* b0,
                                    const void* w1, const void* b1,
                                    const void* wm, const void* bm,
                                    const void* log_std, const void* noise,
                                    int ld_noise, void* out, int ld_out,
                                    void* logp, int ld_logp, float max_action,
                                    void* stream) {
  if (B <= 0 || out == nullptr || logp == nullptr)
    return (int)cudaErrorInvalidValue;
  const Weights w{(const float*)w0, (const float*)b0, (const float*)w1,
                  (const float*)b1, (const float*)wm, (const float*)bm,
                  (const float*)log_std};
  const int blocks = (B + kRows - 1) / kRows;
  cudaStream_t st = (cudaStream_t)stream;
#define X(a, b, c)                                                        \
  if (nin == a && nh == b && nact == c) {                                 \
    mlp_ppo_actor_kernel<a, b, c><<<blocks, kThreads, 0, st>>>(           \
        (const float*)obs, B, w, (const float*)noise, ld_noise,           \
        (float*)out, ld_out, (float*)logp, ld_logp, max_action);          \
    return (int)cudaGetLastError();                                       \
  }
  MLP_PPO_ACTOR_INSTANCES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}
