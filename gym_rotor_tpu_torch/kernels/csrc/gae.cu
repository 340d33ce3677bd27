// K12: Generalized Advantage Estimation over one horizon, for Hopper
// (sm_90a): the reverse recursion per env column, the TD targets, and the
// advantages normalised over the whole horizon.
//
// Replaces gym_rotor_tpu/algos/ppo.py:119-146 gae (a reverse lax.scan over
// (T, B, 1), then the mean, the two-pass variance and the Bessel-corrected
// std over all T*B entries), which XLA fused into the update program on the
// TPU.  Plain twin: gym_rotor_tpu_torch/kernels/gae.py:gae_plain.
//
//   delta = r + gamma nv (1 - d) - v
//   adv_t = delta_t + gamma (1 - d_t) lambda adv_{t+1}    (adv_T = 0)
//   td    = adv + v
//   m = mean(adv); var = mean((adv - m)^2); std = sqrt(var n / max(n - 1, 1))
//   adv   = (adv - m) / (std + 1e-4)
// in JAX's order of operations.  Inputs and outputs are t-major (T, B)
// (row t*B + b), the flattened order the minibatch permutation indexes.
//
// Bound on an H100: the bytes.  Four float inputs read once and two outputs
// written once, 24 bytes an entry: 4.9 MB at the 4096-env horizon (T = 50,
// B = 4096), ~1.5 us at 3.35 TB/s; ~10 flops an entry are less.  The
// recursion is serial over T in each column: 218 steps at B = 32, 50 at
// B = 4096.
//
// Design: three launches, no float atomics, so a run repeats its numbers.
// (1) One thread per env column runs the recursion from t = T-1 down, writes
// the raw advantage and the TD target, and sums its column; each block adds
// its threads' sums in a fixed tree order into one partial.  (2) Each block
// recomputes the mean from the (1) partials in block order, then sums the
// squared deviations of a fixed grid-stride share of the entries into one
// partial.  (3) Each block recomputes the mean and the variance from the
// partials in block order and normalises its entries in place.  The
// advantages make one extra round trip through memory (8 bytes an entry),
// far under the launches at these sizes.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVarBlocks = 256;

// Fixed-order tree sum over the block; every thread returns the total.
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

__global__ void __launch_bounds__(kThreads)
gae_scan_kernel(const float* __restrict__ v, const float* __restrict__ nv,
                const float* __restrict__ r, const float* __restrict__ d,
                int T, int B, float gamma, float lam, float* __restrict__ adv,
                float* __restrict__ td, float* __restrict__ partial) {
  __shared__ float buf[kThreads];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  float col = 0.0f;
  if (b < B) {
    float carry = 0.0f;
    for (int t = T - 1; t >= 0; --t) {
      const size_t i = (size_t)t * B + b;
      const float nd = 1.0f - d[i];
      const float delta = r[i] + gamma * nv[i] * nd - v[i];
      carry = delta + gamma * nd * lam * carry;
      adv[i] = carry;
      td[i] = carry + v[i];
      col += carry;
    }
  }
  const float s = block_sum(col, buf);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__device__ float mean_of(const float* partial, int n_part, long long n) {
  float s = 0.0f;
  for (int k = 0; k < n_part; ++k) s += partial[k];
  return s / (float)n;
}

__global__ void __launch_bounds__(kThreads)
gae_var_kernel(const float* __restrict__ adv, long long n,
               const float* __restrict__ part1, int n1,
               float* __restrict__ part2) {
  __shared__ float buf[kThreads];
  __shared__ float m;
  if (threadIdx.x == 0) m = mean_of(part1, n1, n);
  __syncthreads();
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float c = adv[i] - m;
    acc += c * c;
  }
  const float s = block_sum(acc, buf);
  if (threadIdx.x == 0) part2[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
gae_norm_kernel(float* __restrict__ adv, long long n,
                const float* __restrict__ part1, int n1,
                const float* __restrict__ part2, int n2) {
  __shared__ float m, denom;
  if (threadIdx.x == 0) {
    m = mean_of(part1, n1, n);
    const float var = mean_of(part2, n2, n);
    const long long dof = n - 1 > 1 ? n - 1 : 1;
    denom = sqrtf(var * (float)n / (float)dof) + 1e-4f;
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) adv[i] = (adv[i] - m) / denom;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Floats of scratch the wrapper allocates for T*B = n entries over B
// columns: the scan's partials, then the variance pass's.
extern "C" int gae_scratch_floats(int B, long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (B + kThreads - 1) / kThreads +
         (int)(blocks < kMaxVarBlocks ? blocks : kMaxVarBlocks);
}

// v, nv, r, d, adv, td: (T, B) float32, contiguous, t-major.
extern "C" int gae_launch(const void* v, const void* nv, const void* r,
                          const void* d, int T, int B, float gamma, float lam,
                          void* adv, void* td, void* scratch, void* stream) {
  if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)T * B;
  const int n1 = (B + kThreads - 1) / kThreads;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int n2 = (int)(blocks < kMaxVarBlocks ? blocks : kMaxVarBlocks);
  float* part1 = (float*)scratch;
  float* part2 = part1 + n1;
  float* a = (float*)adv;
  gae_scan_kernel<<<n1, kThreads, 0, st>>>(
      (const float*)v, (const float*)nv, (const float*)r, (const float*)d, T,
      B, gamma, lam, a, (float*)td, part1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gae_var_kernel<<<n2, kThreads, 0, st>>>(a, n, part1, n1, part2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gae_norm_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(a, n, part1, n1,
                                                         part2, n2);
  return (int)cudaGetLastError();
}
