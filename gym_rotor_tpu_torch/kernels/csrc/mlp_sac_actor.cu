// The MLP SAC actor's acting forward with SAC's head as its epilogue, for
// Hopper (sm_90a), in one launch:
//   h0 = relu(obs W0 + b0); h1 = relu(h0 W1 + b1);
//   then sac_head.cuh on each action: mean = h1 Wm + bm, log_std =
//   clip(h1 Wl + bl, LOG_SIG_MIN, LOG_SIG_MAX) and the squashed draw
//   tanh(mean + exp(log_std) noise), or tanh(mean) without a draw (eval).
//
// Replaces gym_rotor_tpu/models/mlp.py:107-119 ActorSAC with
// :129-143 sac_sample_with_noise under algos/sac.py:108-117
// choose_action_f, which XLA ran as one program on the TPU.  Plain twin:
// gym_rotor_tpu_torch/kernels/mlp_sac_actor.py:mlp_sac_actor_plain
// (models/mlp.py:actor_sac, F.linear on cuBLAS, then
// kernels/sac_sample.py:sac_sample_plain).
//
// Bound on an H100: tiny either way.  Per row 2 (nin nh + nh nh + 2 nh nact)
// flops of the layers and heads (1312 for agent 0, 15 / 16 / 4) and ~6 an
// action of the draw; per row the obs, the draw and the action (92 bytes for
// agent 0) plus the ~3.4 KB of weights once: ~0.11 us of bytes at 4096
// rows, ~0.002 us at 32.  What holds a launch is its own cost and one row's
// chain: a load of the weights, dot products of 15-23, 16 and 2 x 16 terms,
// exp and tanh.
//
// Design (the MLP PPO actor's, mlp_ppo_actor.cu; the trunk mlp_trunk.cuh):
// blocks of 128 threads, a row on 4 lanes (32 rows a block); every block
// stages the weights (read from the bound parameter tensors each call:
// nothing cached) and its rows' obs in shared memory, every copy a
// cp.async in flight at once; each lane of a row computes NH / 4 hidden
// units (the inputs in order, each unit its own chain, then the bias, then
// relu), the row's lanes exchange them through shared memory (a warp
// barrier), the second layer the same, and lane a of the row computes
// action a's two heads in k order and the draw
// (the same order as the training path's fused head, sac_sample.cu), writing
// the action through its row stride (a column slice of the joint action).
// Built with -fmad=false, so each product and sum rounds once, as the plain
// twin's elementwise sample does.  Instantiated for the MODUL actors
// (15, 16, 4) and (3, 4, 1) and the MONO actor (23, 16, 4); other widths
// (a config's actor_hidden_dim) run one kernel with run-time widths: a
// block 8 rows, each thread runs of 2 units of all its rows, the weights
// read from global memory once for the block's rows, the same order.
#include <cuda_runtime.h>
#include <math.h>

#include "mlp_trunk.cuh"
#include "sac_head.cuh"

namespace {

using mlp::kLanes;
using mlp::kRows;
using mlp::kThreads;

struct Weights {
  const float* w0;   // (nin, nh), flax's Dense kernel
  const float* b0;
  const float* w1;   // (nh, nh)
  const float* b1;
  const float* wm;   // (nh, nact), the mean head
  const float* bm;
  const float* wl;   // (nh, nact), the log-std head
  const float* bl;
};

// Action a of a row from its last hidden layer h (nh floats; NH = nh, or
// 0 for a run-time width), the heads (nh, nact): sac_head.cuh's dot
// products, the bias, the clip and the draw (noise at noise[no]), or
// tanh(mean) without noise (eval).
template <int NH>
__device__ __forceinline__ float act(const float* h, int nh, const float* Wm,
                                     const float* bm, const float* Wl,
                                     const float* bl, int nact, int a,
                                     const float* __restrict__ noise,
                                     size_t no) {
  float m, l;
  sac::head_dots<NH>(h, 0, nh, Wm, Wl, nact, a, m, l);
  m = m + bm[a];
  l = sac::clip_log_std(l + bl[a]);
  return noise == nullptr ? tanhf(m) : sac::draw(m, l, noise[no]).a;
}

template <int NIN, int NH, int NACT>
__global__ void __launch_bounds__(kThreads)
mlp_sac_actor_kernel(const float* __restrict__ obs, int B, Weights w,
                     const float* __restrict__ noise, int ld_noise,
                     float* __restrict__ out, int ld_out) {
  __shared__ float W0[NIN * NH], B0[NH], W1[NH * NH], B1[NH];
  __shared__ float WM[NH * NACT], BM[NACT], WL[NH * NACT], BL[NACT];
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
  mlp::stage<NH * NACT>(WL, w.wl, t);
  mlp::stage<NACT>(BL, w.bl, t);
  mlp::stage_obs<NIN>(xs, obs, r0, nrow, t);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int row = t / kLanes, j = t % kLanes;
  float x[NH];
  mlp::hidden<NIN, NH>(xs, W0, B0, W1, B1, hs, t, x);
  if (row >= nrow) return;
  const size_t r = (size_t)r0 + row;
  for (int a = j; a < NACT; a += kLanes)
    out[r * ld_out + a] = act<NH>(x, NH, WM, BM, WL, BL, NACT, a, noise,
                                  r * ld_noise + a);
}

// Widths without an instance (run-time nin, nh): a block takes R rows;
// mlp::dense_relu_rows computes each layer for the R rows at once, each
// thread runs of units with the weights read from global memory once for
// the R rows, each unit's terms in k order (an instance's bits); the rows'
// layers in dynamic shared memory (2 R nh floats).  Then thread p takes
// (row p / nact, action p % nact): the heads (sac_head.cuh) and the draw.
// R = 8: a block's loads of a weight serve 8 rows; under 8 rows the
// spare chains cost little, as the loads' latency holds a pass.
constexpr int R = 8;

__global__ void __launch_bounds__(kThreads)
mlp_sac_actor_any_kernel(const float* __restrict__ obs, int B, int nin,
                         int nh, int nact, Weights w,
                         const float* __restrict__ noise, int ld_noise,
                         float* __restrict__ out, int ld_out) {
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
    out[r * ld_out + a] = act<0>(h1 + i * nh, nh, w.wm, w.bm, w.wl, w.bl,
                                 nact, a, noise, r * ld_noise + a);
  }
}

#define MLP_SAC_ACTOR_INSTANCES(X) X(15, 16, 4) X(3, 4, 1) X(23, 16, 4)

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// obs (B, nin) contiguous; w0 (nin, nh), b0, w1 (nh, nh), b1, wm (nh,
// nact), bm, wl (nh, nact), bl contiguous; noise (B, nact) with row stride
// ld_noise, or null (eval); out (B, nact) with row stride ld_out.  Dims
// without an instance run mlp_sac_actor_any_kernel (nact <= 4, nh up to
// 3632: 8 rows' hidden layers in a block's shared memory).
extern "C" int mlp_sac_actor_launch(const void* obs, int B, int nin, int nh,
                                    int nact, const void* w0, const void* b0,
                                    const void* w1, const void* b1,
                                    const void* wm, const void* bm,
                                    const void* wl, const void* bl,
                                    const void* noise, int ld_noise,
                                    void* out, int ld_out, void* stream) {
  if (B <= 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  const Weights w{(const float*)w0, (const float*)b0, (const float*)w1,
                  (const float*)b1, (const float*)wm, (const float*)bm,
                  (const float*)wl, (const float*)bl};
  const int blocks = (B + kRows - 1) / kRows;
  cudaStream_t st = (cudaStream_t)stream;
#define X(a, b, c)                                                        \
  if (nin == a && nh == b && nact == c) {                                 \
    mlp_sac_actor_kernel<a, b, c><<<blocks, kThreads, 0, st>>>(           \
        (const float*)obs, B, w, (const float*)noise, ld_noise,           \
        (float*)out, ld_out);                                             \
    return (int)cudaGetLastError();                                       \
  }
  MLP_SAC_ACTOR_INSTANCES(X)
#undef X
  if (nin <= 0 || nh <= 0 || nact <= 0 || nact > 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * R * nh;
  if (smem > 48 * 1024) {   // wide layers: the opt-in shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)mlp_sac_actor_any_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mlp_sac_actor_any_kernel<<<(B + R - 1) / R, kThreads, smem, st>>>(
      (const float*)obs, B, nin, nh, nact, w, (const float*)noise, ld_noise,
      (float*)out, ld_out);
  return (int)cudaGetLastError();
}
