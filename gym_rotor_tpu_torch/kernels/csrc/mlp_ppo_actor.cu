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
// actor (23, 16, 4); other widths (a config's actor_hidden_dim) run one
// kernel with run-time widths, the MLP SAC actor's design.
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

// Widths without an instance (run-time nin, nh, nact): the MLP SAC actor's
// run-time design (mlp_sac_actor.cu): a block takes R rows, and
// mlp::dense_relu_rows computes each layer for the R rows at once, each
// thread runs of units with the weights read from global memory once for
// the R rows, each unit's terms in k order (an instance's bits); the rows'
// layers in dynamic shared memory (2 R nh floats).  Then thread p takes
// (row p / nact, action p % nact): the mean in k order, as the instances,
// and ppo::head.  R = 8 where 8 rows' layers fit a block's shared memory
// (nh <= 3632), else 1 (nh <= 29056).
template <int R>
__global__ void __launch_bounds__(kThreads)
mlp_ppo_actor_any_kernel(const float* __restrict__ obs, int B, int nin,
                         int nh, int nact, Weights w,
                         const float* __restrict__ noise, int ld_noise,
                         float* __restrict__ out, int ld_out,
                         float* __restrict__ logp, int ld_logp,
                         float max_action) {
  extern __shared__ float hs[];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * R, nr = min(R, B - r0);
  float* h0 = hs;
  float* h1 = hs + R * nh;
  mlp::dense_relu_rows<R>(obs + (size_t)r0 * nin, nin, nr, nin, nh, w.w0,
                          w.b0, h0, t);
  __syncthreads();
  mlp::dense_relu_rows<R>(h0, nh, nr, nh, nh, w.w1, w.b1, h1, t);
  __syncthreads();
  for (int p = t; p < nr * nact; p += kThreads) {
    const int i = p / nact, a = p - i * nact;
    const size_t r = (size_t)r0 + i;
    const float* x = h1 + i * nh;
    float s = x[0] * w.wm[a];
    for (int k = 1; k < nh; ++k) s = s + x[k] * w.wm[k * nact + a];
    ppo::head(s + w.bm[a], w.log_std[a],
             noise == nullptr ? nullptr : noise + r * ld_noise + a,
             max_action, out + r * ld_out + a, logp + r * ld_logp + a);
  }
}

template <int R>
int launch_any(const float* obs, int B, int nin, int nh, int nact,
               const Weights& w, const float* noise, int ld_noise, float* out,
               int ld_out, float* logp, int ld_logp, float max_action,
               cudaStream_t st) {
  const size_t smem = sizeof(float) * 2 * R * nh;
  if (smem > 48 * 1024) {   // wide layers: the opt-in shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)mlp_ppo_actor_any_kernel<R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mlp_ppo_actor_any_kernel<R><<<(B + R - 1) / R, kThreads, smem, st>>>(
      obs, B, nin, nh, nact, w, noise, ld_noise, out, ld_out, logp, ld_logp,
      max_action);
  return (int)cudaGetLastError();
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

// The same operands, any widths: mlp_ppo_actor_any_kernel (8 rows a block
// up to nh 3632, else one).
extern "C" int mlp_ppo_actor_any_launch(
    const void* obs, int B, int nin, int nh, int nact, const void* w0,
    const void* b0, const void* w1, const void* b1, const void* wm,
    const void* bm, const void* log_std, const void* noise, int ld_noise,
    void* out, int ld_out, void* logp, int ld_logp, float max_action,
    void* stream) {
  if (B <= 0 || nin <= 0 || nh <= 0 || nact <= 0 || out == nullptr ||
      logp == nullptr || (size_t)2 * nh * 4 > 232448)
    return (int)cudaErrorInvalidValue;
  const Weights w{(const float*)w0, (const float*)b0, (const float*)w1,
                  (const float*)b1, (const float*)wm, (const float*)bm,
                  (const float*)log_std};
  const bool eight = (size_t)2 * 8 * nh * 4 <= 232448;
  return (eight ? launch_any<8> : launch_any<1>)(
      (const float*)obs, B, nin, nh, nact, w, (const float*)noise, ld_noise,
      (float*)out, ld_out, (float*)logp, ld_logp, max_action,
      (cudaStream_t)stream);
}
