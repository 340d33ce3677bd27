// K3 (forward, training widths) and K4 (backward): one EMLP block for
// Hopper (sm_90a), lin = x W_eff^T + b_eff, pre = 0.1 Q(lin) + lin,
// h = pre[:nh] * sigmoid(pre[gate]).
//
// Replaces gym_rotor_tpu/models/emlp/nn.py:431 EMLPBlock (EquivLinear ->
// EquivBiLinear -> GatedNonlinearity) and its autodiff through
// fixed_gather's custom VJP (nn.py:39-81), which XLA fused on the TPU.  Plain
// twins: gym_rotor_tpu_torch/kernels/emlp_block.py:emlp_block_plain and
// emlp_block_backward_plain.
//
// Bound on an H100: the operations, and few.  Agent 1's critic block 1 (62
// in, 123 gated, 9394 nonzeros of Q) at B = 256 is ~2 (7.6k + 14k) flops a
// row, ~11 MFLOP, ~0.2 us at the fp32 peak; its weights and nonzeros are
// ~0.15 MB.  The PPO V critics also run the forward over a whole horizon
// (409 600 rows of [obs; next_obs] in the 4096-env configuration): ~18
// GFLOP for the hidden block, ~0.27 ms at the peak, against ~400 MB of
// saved lin and pre (~0.12 ms).  One thread per row
// runs a serial chain over every nonzero, so the kernel is latency-bound
// far above that (PERF.md); splitting a row across threads is left for
// later.
//
// Design: one thread per batch row, kThreads rows a block.  The block copies
// W_eff, b_eff, the nonzeros' values and their packed (j << 16 | i) indices,
// the row pointers (forward) or output indices (backward) and the gate
// indices into shared memory, up to ~144 KB for agent 1's critic (above 48
// KB, so the dynamic-memory limit is raised once per device and instance);
// each row keeps lin, pre and its gradients in a per-thread shared-memory
// column (stride kThreads, distinct banks across the warp) that the
// nonzeros index.  The forward saves lin and pre field-major, (ng, B).  The
// backward is two launches: the block pass (g_pre through the gate, whose
// two terms land on one coordinate where gate[k] == k; g_lin through the
// nonzeros; g_x = g_lin W; then, when parameter gradients are asked for,
// the block's partial sums over its rows of g_W, g_b and g_v, one parameter
// per thread in row order) and a reduction that adds the blocks' partials in
// block order.  No float atomics: a run repeats its numbers.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------- forward
template <int NI, int NG, int NH>
__global__ void __launch_bounds__(kThreads)
block_fwd_kernel(const float* __restrict__ x, int B,
                 const float* __restrict__ params,
                 const int* __restrict__ ints, int nnz, float* __restrict__ h,
                 float* __restrict__ lin_out, float* __restrict__ pre_out) {
  extern __shared__ float smem[];
  const int np = NG * NI + NG + nnz;
  const int ni = NH + (NG + 1) + nnz;
  for (int k = threadIdx.x; k < np; k += kThreads) smem[k] = params[k];
  int* si = reinterpret_cast<int*>(smem + np);
  for (int k = threadIdx.x; k < ni; k += kThreads) si[k] = ints[k];
  __syncthreads();
  const float* W = smem;
  const float* b = W + NG * NI;
  const float* v = b + NG;
  const int* g = si;
  const int* rowptr = g + NH;
  const int* ji = rowptr + NG + 1;
  float* lcol = reinterpret_cast<float*>(si + ni) + threadIdx.x;
  float* pcol = lcol + NG * kThreads;

  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= B) return;
  float xr[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) xr[k] = x[(size_t)r * NI + k];
#pragma unroll 1
  for (int o = 0; o < NG; ++o) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NI; ++k) s += xr[k] * W[o * NI + k];
    const float l = s + b[o];
    lcol[o * kThreads] = l;
    lin_out[(size_t)o * B + r] = l;
  }
#pragma unroll 1
  for (int o = 0; o < NG; ++o) {
    float q = 0.0f;
    for (int e = rowptr[o]; e < rowptr[o + 1]; ++e) {
      const int p = ji[e];
      q += v[e] * lcol[(p >> 16) * kThreads] * lcol[(p & 0xffff) * kThreads];
    }
    const float pr = 0.1f * q + lcol[o * kThreads];
    pcol[o * kThreads] = pr;
    pre_out[(size_t)o * B + r] = pr;
  }
#pragma unroll 1
  for (int k = 0; k < NH; ++k)
    h[(size_t)r * NH + k] =
        pcol[k * kThreads] / (1.0f + expf(-pcol[g[k] * kThreads]));
}

// --------------------------------------------------------------- backward
template <int NI, int NG, int NH>
__global__ void __launch_bounds__(kThreads)
block_bwd_kernel(const float* __restrict__ g_h, const float* __restrict__ x,
                 int B, const float* __restrict__ params,
                 const int* __restrict__ ints, int nnz,
                 const float* __restrict__ lin, const float* __restrict__ pre,
                 float* __restrict__ g_x, float* __restrict__ partial,
                 int need_params) {
  extern __shared__ float smem[];
  // floats: W (NG*NI), v (nnz); ints: gate (NH), o (nnz), ji (nnz);
  // columns: g_pre, g_lin, lin (NG * kThreads each)
  float* W = smem;
  float* v = W + NG * NI;
  for (int k = threadIdx.x; k < NG * NI; k += kThreads) W[k] = params[k];
  for (int k = threadIdx.x; k < nnz; k += kThreads)
    v[k] = params[NG * NI + NG + k];
  int* g = reinterpret_cast<int*>(v + nnz);
  int* oi = g + NH;
  int* ji = oi + nnz;
  const int* ints_ji = ints + NH + NG + 1;
  const int* ints_o = ints_ji + nnz;
  for (int k = threadIdx.x; k < NH; k += kThreads) g[k] = ints[k];
  for (int k = threadIdx.x; k < nnz; k += kThreads) {
    ji[k] = ints_ji[k];
    oi[k] = ints_o[k];
  }
  float* gpcol = reinterpret_cast<float*>(ji + nnz);
  float* glcol = gpcol + NG * kThreads;
  float* lncol = glcol + NG * kThreads;
  const int r0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, B - r0);
  const int t = threadIdx.x;
  const int r = r0 + t;
  if (t < rows)
    for (int o = 0; o < NG; ++o) lncol[o * kThreads + t] = lin[(size_t)o * B + r];
  __syncthreads();

  if (t < rows) {
    float* gp = gpcol + t;
    float* gl = glcol + t;
    const float* ln = lncol + t;
    for (int o = NH; o < NG; ++o) gp[o * kThreads] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < NH; ++k) {
      const float s = 1.0f / (1.0f + expf(-pre[(size_t)g[k] * B + r]));
      gp[k * kThreads] = g_h[(size_t)r * NH + k] * s;
    }
#pragma unroll 1
    for (int k = 0; k < NH; ++k) {
      const float s = 1.0f / (1.0f + expf(-pre[(size_t)g[k] * B + r]));
      gp[g[k] * kThreads] +=
          g_h[(size_t)r * NH + k] * pre[(size_t)k * B + r] * s * (1.0f - s);
    }
    for (int o = 0; o < NG; ++o) gl[o * kThreads] = gp[o * kThreads];
#pragma unroll 1
    for (int e = 0; e < nnz; ++e) {
      const int p = ji[e];
      const int j = p >> 16, i = p & 0xffff;
      const float tv = 0.1f * gp[oi[e] * kThreads] * v[e];
      const float li = ln[i * kThreads], lj = ln[j * kThreads];
      gl[j * kThreads] += tv * li;
      gl[i * kThreads] += tv * lj;
    }
#pragma unroll 1
    for (int k = 0; k < NI; ++k) {
      float s = 0.0f;
      for (int o = 0; o < NG; ++o) s += gl[o * kThreads] * W[o * NI + k];
      g_x[(size_t)r * NI + k] = s;
    }
  }
  if (!need_params) return;
  __syncthreads();
  const int n_par = NG * NI + NG + nnz;
  float* out = partial + (size_t)blockIdx.x * n_par;
  for (int q = t; q < n_par; q += kThreads) {
    float s = 0.0f;
    if (q < NG * NI) {
      const int o = q / NI, k = q % NI;
      for (int rr = 0; rr < rows; ++rr)
        s += glcol[o * kThreads + rr] * x[(size_t)(r0 + rr) * NI + k];
    } else if (q < NG * NI + NG) {
      const int o = q - NG * NI;
      for (int rr = 0; rr < rows; ++rr) s += glcol[o * kThreads + rr];
    } else {
      const int e = q - NG * NI - NG;
      const int p = ji[e];
      const float* gpo = gpcol + oi[e] * kThreads;
      const float* lj = lncol + (p >> 16) * kThreads;
      const float* li = lncol + (p & 0xffff) * kThreads;
      for (int rr = 0; rr < rows; ++rr) s += 0.1f * gpo[rr] * lj[rr] * li[rr];
    }
    out[q] = s;
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int n_blocks, int n_par,
                                    float* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_par) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * n_par + q];
  out[q] = s;
}

// ------------------------------------------------------------- launchers
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, size_t* done) {
  // per device and instance: raise the dynamic shared-memory limit when a
  // launch needs more than what was set on this device before
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || bytes <= done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) done[dev] = bytes;
  return e;
}

template <int NI, int NG, int NH>
int fwd(const float* x, int B, const float* params, const int* ints, int nnz,
        float* h, float* lin, float* pre, cudaStream_t st) {
  static size_t done[kMaxDevices] = {0};
  const size_t smem = (size_t)(NG * NI + NG + nnz) * 4 +
                      (size_t)(NH + NG + 1 + nnz) * 4 +
                      (size_t)2 * NG * kThreads * 4;
  cudaError_t e = set_smem(block_fwd_kernel<NI, NG, NH>, smem, done);
  if (e != cudaSuccess) return (int)e;
  block_fwd_kernel<NI, NG, NH><<<(B + kThreads - 1) / kThreads, kThreads,
                                 smem, st>>>(x, B, params, ints, nnz, h, lin,
                                             pre);
  return (int)cudaGetLastError();
}

template <int NI, int NG, int NH>
int bwd(const float* g_h, const float* x, int B, const float* params,
        const int* ints, int nnz, const float* lin, const float* pre,
        float* g_x, float* partial, float* g_par, int need_params,
        cudaStream_t st) {
  static size_t done[kMaxDevices] = {0};
  const size_t smem = (size_t)(NG * NI + nnz) * 4 +
                      (size_t)(NH + 2 * nnz) * 4 +
                      (size_t)3 * NG * kThreads * 4;
  cudaError_t e = set_smem(block_bwd_kernel<NI, NG, NH>, smem, done);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + kThreads - 1) / kThreads;
  block_bwd_kernel<NI, NG, NH><<<blocks, kThreads, smem, st>>>(
      g_h, x, B, params, ints, nnz, lin, pre, g_x, partial, need_params);
  e = cudaGetLastError();
  if (e != cudaSuccess || !need_params) return (int)e;
  const int n_par = NG * NI + NG + nnz;
  sum_partials_kernel<<<(n_par + 255) / 256, 256, 0, st>>>(partial, blocks,
                                                          n_par, g_par);
  return (int)cudaGetLastError();
}

// The blocks of the flagship MODUL networks: the twin Q critics' first
// blocks (obs + action in) and hidden blocks, the PPO V critics' first
// blocks (obs in), and both actors' blocks; the first blocks of the MONO
// twin Q critic and actor (their hidden blocks are MODUL agent 0's); and
// the first blocks of the CTDE critics over the joint input (Q: 18 obs + 5
// actions, V: 18 obs; agent 0's SO2eR3 tower, agent 1's Mirror tower),
// whose 23-wide SO2eR3 one is also the MONO V critic's.
#define EMLP_BLOCK_INSTANCES(X) \
  X(19, 71, 62) X(62, 71, 62) X(4, 123, 62) X(62, 123, 62) \
  X(15, 71, 62) X(3, 123, 62) \
  X(15, 18, 16) X(16, 18, 16) X(3, 7, 4) X(4, 7, 4) \
  X(27, 71, 62) X(23, 18, 16) \
  X(23, 71, 62) X(23, 123, 62) X(18, 71, 62) X(18, 123, 62)

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int emlp_block_rows_per_block() { return kThreads; }

extern "C" int emlp_block_fwd_launch(const void* x, int B, const void* params,
                                     const void* ints, int nnz, void* h,
                                     void* lin, void* pre, int nin, int ng,
                                     int nh, void* stream) {
  if (B <= 0 || nnz < 0) return (int)cudaErrorInvalidValue;
#define X(a, b, c)                                                          \
  if (nin == a && ng == b && nh == c)                                       \
    return fwd<a, b, c>((const float*)x, B, (const float*)params,           \
                        (const int*)ints, nnz, (float*)h, (float*)lin,      \
                        (float*)pre, (cudaStream_t)stream);
  EMLP_BLOCK_INSTANCES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" int emlp_block_bwd_launch(const void* g_h, const void* x, int B,
                                     const void* params, const void* ints,
                                     int nnz, const void* lin, const void* pre,
                                     void* g_x, void* partial, void* g_par,
                                     int need_params, int nin, int ng, int nh,
                                     void* stream) {
  if (B <= 0 || nnz < 0) return (int)cudaErrorInvalidValue;
#define X(a, b, c)                                                          \
  if (nin == a && ng == b && nh == c)                                       \
    return bwd<a, b, c>((const float*)g_h, (const float*)x, B,              \
                        (const float*)params, (const int*)ints, nnz,        \
                        (const float*)lin, (const float*)pre, (float*)g_x,  \
                        (float*)partial, (float*)g_par, need_params,        \
                        (cudaStream_t)stream);
  EMLP_BLOCK_INSTANCES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}
