// K6: the fused flat optimizer step for Hopper (sm_90a): clip to the global
// norm, AdamW with bias correction and decoupled weight decay, the step, and
// Polyak averaging into the target network, over one network's flat
// parameter vector.
//
// Replaces gym_rotor_tpu/algos/common.py:make_optimizer (optax
// clip_by_global_norm -> adamw(cosine_warm_restarts)) and flat_polyak, which
// XLA fused on the TPU.  Plain twin:
// gym_rotor_tpu_torch/kernels/flat_adamw.py:flat_adamw_plain.
//
// Bound on an H100: the bytes.  Per element it reads g, p, mu, nu (and the
// target when Polyak is on) and writes p, mu, nu (and the target): 28-36 B,
// so the largest network (agent 1's twin critic, 54.4k floats) is ~2 MB,
// ~0.6 us at 3.35 TB/s; the operations (~20 flops an element) are less.
// At these sizes the two launches themselves dominate.
//
// Design: launch 1 writes one partial sum of squares per block (a fixed
// tree in shared memory); launch 2 has every block add the <= 64 partials in
// index order (so every run and every block gets the same norm), then does
// the whole elementwise chain in registers in optax's order of operations:
//   g   <- norm < max_norm ? g : (g / norm) * max_norm
//   mu  <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu
//   u   <- (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p;   p <- p + step * u
//   tgt <- tau p + (1 - tau) tgt
// with bc1, bc2 (bias corrections at count + 1) and step (-lr at the
// schedule's count) computed on the host.  Built with -fmad=false so the
// chain rounds like the plain twin; only the norm's summation order differs.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartials = 64;

__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const float* __restrict__ g, int n,
                     float* __restrict__ partial) {
  __shared__ float red[kThreads];
  float acc = 0.0f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    acc += g[i] * g[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

struct Scalars {
  float max_norm;   // <= 0: no clipping
  float b1, c1, b2, c2, eps, wd;
  float bc1, bc2, step;
  float tau, c_tau;  // Polyak weights, used when tgt != nullptr
};

__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
             float* __restrict__ mu, float* __restrict__ nu,
             float* __restrict__ tgt, int n, const float* __restrict__ partial,
             int n_partial, Scalars s) {
  __shared__ float norm_s;
  if (s.max_norm > 0.0f && threadIdx.x == 0) {
    float ss = 0.0f;
    for (int b = 0; b < n_partial; ++b) ss += partial[b];
    norm_s = sqrtf(ss);
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float gi = g[i];
  if (s.max_norm > 0.0f) {
    const float norm = norm_s;
    if (!(norm < s.max_norm)) gi = (gi / norm) * s.max_norm;
  }
  const float m = s.c1 * gi + s.b1 * mu[i];
  const float v = s.c2 * (gi * gi) + s.b2 * nu[i];
  mu[i] = m;
  nu[i] = v;
  const float pi = p[i];
  float u = (m / s.bc1) / (sqrtf(v / s.bc2) + s.eps);
  u = u + s.wd * pi;
  const float pn = pi + s.step * u;
  p[i] = pn;
  if (tgt != nullptr) tgt[i] = s.tau * pn + s.c_tau * tgt[i];
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// partial: scratch of at least flat_adamw_partials(n) floats.
extern "C" int flat_adamw_partials(int n) {
  const int want = (n + kThreads * 4 - 1) / (kThreads * 4);
  return want < 1 ? 1 : (want > kMaxPartials ? kMaxPartials : want);
}

extern "C" int flat_adamw_launch(void* p, const void* g, void* mu, void* nu,
                                 void* tgt, int n, void* partial,
                                 float max_norm, float b1, float c1, float b2,
                                 float c2, float eps, float wd, float bc1,
                                 float bc2, float step, float tau, float c_tau,
                                 void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_partial = flat_adamw_partials(n);
  if (max_norm > 0.0f) {
    sumsq_partial_kernel<<<n_partial, kThreads, 0, st>>>(
        (const float*)g, n, (float*)partial);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  Scalars s{max_norm, b1, c1, b2, c2, eps, wd, bc1, bc2, step, tau, c_tau};
  adamw_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (float*)p, (const float*)g, (float*)mu, (float*)nu, (float*)tgt, n,
      (const float*)partial, n_partial, s);
  return (int)cudaGetLastError();
}
