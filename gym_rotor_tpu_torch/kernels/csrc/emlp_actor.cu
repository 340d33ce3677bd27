// K3 (forward, actor widths): fused deterministic EMLP actor, K9: the
// fused SAC actor's acting sample, and K11: the fused PPO actor's acting
// draw and its log-prob, for Hopper (sm_90a).  One block body, three heads
// (a template parameter).  Beside them, K11's head alone (ppo_head_kernel)
// for PPO's MLP actor, whose mean is an F.linear chain: the same device
// function (ppo_head) as K11's epilogue, so the draw and the log-prob have
// one source.
//
// Replaces gym_rotor_tpu/models/emlp/nn.py:EMLPBlock (EquivLinear ->
// EquivBiLinear -> GatedNonlinearity) x2 inside EMLP, plus the tanh head of
// models/emlp/zoo.py:EMLPActorDet (K3), or the Gaussian head of
// models/emlp/zoo.py:EMLPActorSAC with the tanh-squashed sample of
// algos/sac.py:114 choose_action_f (K9), or the tanh mean and free log_std
// of models/emlp/zoo.py:EMLPActorPPO with the clipped draw and per-dim
// log-prob of algos/ppo.py:107-116 choose_action_f (K11), which XLA fused
// on the TPU.  Plain twins: gym_rotor_tpu_torch/kernels/emlp_actor.py:
// emlp_actor_plain, sac_actor_plain and ppo_actor_plain (structured), and
// ppo_head_plain for the head alone (models/mlp.py:173-178 with
// algos/ppo.py:107-116 on an MLP mean).
//
// K9's epilogue: mean = h2 Wh^T + bh; ls = clip(h2 Wl + bl, -20, 2);
// action = tanh(mean + exp(ls) noise), or tanh(mean) without noise (eval).
// The log-prob is not computed: the acting path discards it.
// K11's epilogue: mean = tanh(h2 Wh^T + bh); ls = the log_std parameter
// (not clipped, as the reference); a = clip(mean + exp(ls) noise, +-max);
// logp = -0.5 ((a - mean) / exp(ls))^2 - ls - log(2 pi) / 2 of the CLIPPED
// action, written per dimension with its own row stride (the horizon's
// log-prob columns); eval mode: clip(mean, +-max) and logp = 0.
//
// Bound on an H100: the operations.  Per row and block, 2*NG*NI flops of
// linear layer and 3 per nonzero of the bilinear quadratic form (288 for
// agent 0, NG = 18): ~13 MFLOP per launch at B = 4096, ~0.2 us at the
// 67 TFLOP/s fp32 peak; the obs/action bytes are ~0.1 us.  At this batch
// the launch has 32 blocks of 4 warps for 132 SMs, so each row's serial
// chain of shared-memory loads and FMAs is exposed: measured far above
// the bound (PERF.md), a later PR's work.  K9 adds the log_std head
// (2*NH*NACT flops a row), the noise read and exp: the same bound within a
// few percent.  K11 adds ~10 flops and the log-prob write per action.
// The head alone reads the pre-tanh mean and the noise and writes the
// action and the log-prob: 16 bytes and ~12 flops an element, bound by
// the bytes (~0.02 us at 4096 x 4), so the launch sets its time.
//
// Design: every weight the actor needs is folded once per parameter set on
// the host side (W_eff/b_eff from project_linear, the bilinear nonzeros
// from _bilinear_struct grouped by output coordinate, gate indices) into a
// float and an int buffer, which each block copies to shared memory (a few
// KB).  One thread per batch row keeps lin/pre/h in registers (the dense
// loops have compile-time trip counts and unroll).  The bilinear layer
// reads its two factors by runtime index, so each block's linear output is
// also written to a per-thread column of shared memory (stride blockDim.x,
// so a warp's accesses fall in distinct banks); the nonzeros themselves are
// the same address across a warp, i.e. shared-memory broadcasts.  Output is
// written with a row stride, straight into the joint action tensor.
// Instantiated for the two flagship MODUL actors and the MONO actor (23
// obs, 16 SO2eR3 channels, 4 actions), each with every head.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kHalfLog2Pi = 0.91893853320467274f;

template <int NI, int NG, int NH>
__device__ __forceinline__ void emlp_block(const float* x, const float* W,
                                           const float* b, const float* v,
                                           const int* rowptr, const int* ji,
                                           const int* g, float* col,
                                           float* h) {
  float lin[NG];
#pragma unroll
  for (int o = 0; o < NG; ++o) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NI; ++i) s += x[i] * W[o * NI + i];
    lin[o] = s + b[o];
    col[o * kThreads] = lin[o];
  }
  float pre[NG];
#pragma unroll
  for (int o = 0; o < NG; ++o) {
    float q = 0.0f;
    for (int e = rowptr[o]; e < rowptr[o + 1]; ++e) {
      const int p = ji[e];
      q += v[e] * col[(p >> 16) * kThreads] * col[(p & 0xffff) * kThreads];
    }
    pre[o] = 0.1f * q + lin[o];
  }
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    const int gk = g[k];
    float gv = 0.0f;
#pragma unroll
    for (int j = 0; j < NG; ++j) gv = (gk == j) ? pre[j] : gv;
    h[k] = pre[k] / (1.0f + expf(-gv));
  }
}

enum Head { kTanh = 0, kGauss = 1, kPPO = 2 };

// PPO's head on one action of one row (algos/ppo.py:107-116): mu =
// tanh(pre); with a draw n, a = clip(mu + exp(ls) n, +-max) and logp =
// -0.5 ((a - mu) / exp(ls))^2 - ls - log(2 pi) / 2 of the CLIPPED action;
// without one (eval), a = clip(mu, +-max) and logp = 0.  ls is the free
// log_std parameter, not clipped (the reference's).
__device__ __forceinline__ void ppo_head(float pre, float ls,
                                         const float* noise, float max_action,
                                         float* act_out, float* logp_out) {
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

// K11's head alone on an (B, nact) pre-tanh mean (PPO's MLP actor: the
// mean head's F.linear output), one thread per element; log_std (nact,).
__global__ void __launch_bounds__(128)
ppo_head_kernel(const float* __restrict__ pre, int B, int nact,
                const float* __restrict__ log_std,
                const float* __restrict__ noise, int ld_noise,
                float* __restrict__ out, int ld_out, float* __restrict__ logp,
                int ld_logp, float max_action) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)B * nact) return;
  const int row = (int)(k / nact), a = (int)(k % nact);
  ppo_head(pre[k], log_std[a],
           noise == nullptr ? nullptr : noise + (size_t)row * ld_noise + a,
           max_action, out + (size_t)row * ld_out + a,
           logp + (size_t)row * ld_logp + a);
}

// Buffer layout (see emlp_actor.py:fold_actor).  The Gaussian head adds the
// log_std Dense, transposed to (NACT, NH), and its bias after the mean head;
// the PPO head adds the log_std parameter (NACT).
template <int NIN, int NG, int NH, int NACT, int HEAD_KIND>
struct Dims {
  static constexpr int W0 = NG * NIN + NG;   // block 0 W_eff, b_eff
  static constexpr int W1 = NG * NH + NG;    // block 1 W_eff, b_eff
  static constexpr int HEAD =
      (HEAD_KIND == kGauss ? 2 : 1) * (NACT * NH + NACT) +
      (HEAD_KIND == kPPO ? NACT : 0);
  static constexpr int INTS = 2 * NH + 2 * (NG + 1);   // + nnz0 + nnz1
  __host__ __device__ static int n_params(int nnz0, int nnz1) {
    return W0 + nnz0 + W1 + nnz1 + HEAD;
  }
  __host__ __device__ static int n_ints(int nnz0, int nnz1) {
    return INTS + nnz0 + nnz1;
  }
  static size_t smem(int nnz0, int nnz1) {
    return (size_t)(n_params(nnz0, nnz1) + n_ints(nnz0, nnz1) + NG * kThreads) * 4;
  }
};

template <int NIN, int NG, int NH, int NACT, int HEAD_KIND>
__global__ void __launch_bounds__(kThreads)
emlp_actor_kernel(const float* __restrict__ obs, int B,
                  const float* __restrict__ params, const int* __restrict__ ints,
                  int nnz0, int nnz1, const float* __restrict__ noise,
                  int ld_noise, float* __restrict__ out, int ld_out,
                  float* __restrict__ logp, int ld_logp, float max_action) {
  using D = Dims<NIN, NG, NH, NACT, HEAD_KIND>;
  extern __shared__ float smem[];
  const int np = D::n_params(nnz0, nnz1), ni = D::n_ints(nnz0, nnz1);
  for (int k = threadIdx.x; k < np; k += blockDim.x) smem[k] = params[k];
  int* si = reinterpret_cast<int*>(smem + np);
  for (int k = threadIdx.x; k < ni; k += blockDim.x) si[k] = ints[k];
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;

  float x[NIN];
#pragma unroll
  for (int i = 0; i < NIN; ++i) x[i] = obs[(size_t)row * NIN + i];
  const float* p0 = smem;
  const float* p1 = p0 + D::W0 + nnz0;
  const float* ph = p1 + D::W1 + nnz1;
  const int* rp = si + 2 * NH;
  const int* ji0 = si + D::INTS;
  float* col = reinterpret_cast<float*>(si + ni) + threadIdx.x;
  float h1[NH], h2[NH];
  emlp_block<NIN, NG, NH>(x, p0, p0 + NG * NIN, p0 + D::W0, rp, ji0, si,
                          col, h1);
  emlp_block<NH, NG, NH>(h1, p1, p1 + NG * NH, p1 + D::W1, rp + NG + 1,
                         ji0 + nnz0, si + NH, col, h2);
  // the Gaussian head's log_std Dense, or the PPO head's log_std parameter
  const float* pl = ph + NACT * NH + NACT;
#pragma unroll
  for (int a = 0; a < NACT; ++a) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NH; ++k) s += h2[k] * ph[a * NH + k];
    const float mean = s + ph[NACT * NH + a];
    if (HEAD_KIND == kPPO) {
      ppo_head(mean, pl[a],
               noise == nullptr ? nullptr : noise + (size_t)row * ld_noise + a,
               max_action, out + (size_t)row * ld_out + a,
               logp + (size_t)row * ld_logp + a);
      continue;
    }
    float act = mean;
    if (HEAD_KIND == kGauss && noise != nullptr) {
      float l = 0.0f;
#pragma unroll
      for (int k = 0; k < NH; ++k) l += h2[k] * pl[a * NH + k];
      const float ls = fminf(fmaxf(l + pl[NACT * NH + a], -20.0f), 2.0f);
      act = mean + expf(ls) * noise[(size_t)row * ld_noise + a];
    }
    out[(size_t)row * ld_out + a] = tanhf(act);
  }
}

template <int NIN, int NG, int NH, int NACT, int HEAD_KIND>
int launch(const float* obs, int B, const float* params, int n_params,
           const int* ints, int n_ints, int nnz0, int nnz1,
           const float* noise, int ld_noise, float* out, int ld_out,
           float* logp, int ld_logp, float max_action, cudaStream_t stream) {
  using D = Dims<NIN, NG, NH, NACT, HEAD_KIND>;
  if (nnz0 < 0 || nnz1 < 0 || n_params != D::n_params(nnz0, nnz1) ||
      n_ints != D::n_ints(nnz0, nnz1) || D::smem(nnz0, nnz1) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  emlp_actor_kernel<NIN, NG, NH, NACT, HEAD_KIND>
      <<<blocks, kThreads, D::smem(nnz0, nnz1), stream>>>(
          obs, B, params, ints, nnz0, nnz1, noise, ld_noise, out, ld_out,
          logp, ld_logp, max_action);
  return (int)cudaGetLastError();
}

template <int HEAD_KIND>
int dispatch(const float* o, int B, const float* p, int n_params,
             const int* q, int n_ints, int nnz0, int nnz1, const float* nz,
             int ld_noise, float* y, int ld_out, float* lp, int ld_logp,
             float max_action, int nin, int ng, int nh, int nact,
             cudaStream_t s) {
  if (nin == 15 && ng == 18 && nh == 16 && nact == 4)
    return launch<15, 18, 16, 4, HEAD_KIND>(o, B, p, n_params, q, n_ints,
                                            nnz0, nnz1, nz, ld_noise, y,
                                            ld_out, lp, ld_logp, max_action,
                                            s);
  if (nin == 3 && ng == 7 && nh == 4 && nact == 1)
    return launch<3, 7, 4, 1, HEAD_KIND>(o, B, p, n_params, q, n_ints, nnz0,
                                         nnz1, nz, ld_noise, y, ld_out, lp,
                                         ld_logp, max_action, s);
  if (nin == 23 && ng == 18 && nh == 16 && nact == 4)
    return launch<23, 18, 16, 4, HEAD_KIND>(o, B, p, n_params, q, n_ints,
                                            nnz0, nnz1, nz, ld_noise, y,
                                            ld_out, lp, ld_logp, max_action,
                                            s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// head: 0 = the deterministic tanh head (K3), 1 = the Gaussian head (K9),
// 2 = the PPO head (K11); noise (B, nact) with row stride ld_noise, or null
// for the deterministic action; logp (B, nact) with row stride ld_logp and
// max_action are read by the PPO head only.
extern "C" int emlp_actor_launch(const void* obs, int B, const void* params,
                                 int n_params, const void* ints, int n_ints,
                                 int nnz0, int nnz1, const void* noise,
                                 int ld_noise, void* out, int ld_out,
                                 void* logp, int ld_logp, float max_action,
                                 int nin, int ng, int nh, int nact, int head,
                                 void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const float* o = (const float*)obs;
  const float* p = (const float*)params;
  const int* q = (const int*)ints;
  const float* nz = (const float*)noise;
  float* y = (float*)out;
  float* lp = (float*)logp;
  cudaStream_t s = (cudaStream_t)stream;
  if (head == kTanh)
    return dispatch<kTanh>(o, B, p, n_params, q, n_ints, nnz0, nnz1, nullptr,
                           0, y, ld_out, nullptr, 0, 1.0f, nin, ng, nh, nact,
                           s);
  if (head == kGauss)
    return dispatch<kGauss>(o, B, p, n_params, q, n_ints, nnz0, nnz1, nz,
                            ld_noise, y, ld_out, nullptr, 0, 1.0f, nin, ng,
                            nh, nact, s);
  if (head == kPPO) {
    if (lp == nullptr) return (int)cudaErrorInvalidValue;
    return dispatch<kPPO>(o, B, p, n_params, q, n_ints, nnz0, nnz1, nz,
                          ld_noise, y, ld_out, lp, ld_logp, max_action, nin,
                          ng, nh, nact, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K11's head alone: pre (B, nact) contiguous pre-tanh means, log_std
// (nact,), noise (B, nact) with row stride ld_noise or null (eval), out and
// logp (B, nact) with their own row strides.
extern "C" int ppo_head_launch(const void* pre, int B, int nact,
                               const void* log_std, const void* noise,
                               int ld_noise, void* out, int ld_out,
                               void* logp, int ld_logp, float max_action,
                               void* stream) {
  if (B <= 0 || nact <= 0 || out == nullptr || logp == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * nact;
  const int blocks = (int)((n + 127) / 128);
  ppo_head_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      (const float*)pre, B, nact, (const float*)log_std,
      (const float*)noise, ld_noise, (float*)out, ld_out, (float*)logp,
      ld_logp, max_action);
  return (int)cudaGetLastError();
}
