// K7: the batched power iteration of the spectral-norm regularizer for
// Hopper (sm_90a).
//
// Replaces gym_rotor_tpu/algos/regularizers.py:102: the 10-step chain of
// spectral_norm_regularization (x <- W^T (W x), x <- x / |x|, over the
// zero-padded stack of a network's weight matrices), which XLA unrolled into
// ~30 tiny batched ops on the TPU.  Plain twin:
// gym_rotor_tpu_torch/kernels/spectral.py:spectral_iterate_plain.  The
// iterate is stop_gradient-ed in JAX, so the kernel has no backward: sigma =
// |W v| and its gradient 2 (W v) v^T stay torch autograd.
//
// Bound on an H100: the operations, and few.  A twin critic's stack is 6
// matrices of at most 123 x 62: 10 steps x 2 matvecs x 2 flops x 6 x 7.6k
// ~ 1.8 MFLOP (~0.03 us at the fp32 peak) over ~0.2 MB of weights; the
// launch and the 30 dependent steps (two block barriers each) dominate.
//
// Design: one block per matrix.  The block copies its padded W (<= 30.5 KB)
// into shared memory, then runs the 10 steps there: one thread per row for
// y = W x, one thread per column for x = W^T y, a fixed-order tree for |x|,
// so a run repeats its numbers.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
spectral_kernel(const float* __restrict__ W, const float* __restrict__ x0,
                float* __restrict__ v, int mo, int mi, int iters) {
  extern __shared__ float smem[];
  float* sW = smem;               // mo * mi
  float* sx = sW + mo * mi;       // mi
  float* sy = sx + mi;            // mo
  float* red = sy + mo;           // kThreads
  const int k = blockIdx.x;
  const float* Wk = W + (size_t)k * mo * mi;
  for (int e = threadIdx.x; e < mo * mi; e += kThreads) sW[e] = Wk[e];
  for (int j = threadIdx.x; j < mi; j += kThreads) sx[j] = x0[(size_t)k * mi + j];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int r = threadIdx.x; r < mo; r += kThreads) {
      float s = 0.0f;
      for (int j = 0; j < mi; ++j) s += sW[r * mi + j] * sx[j];
      sy[r] = s;
    }
    __syncthreads();
    float sq = 0.0f;
    for (int j = threadIdx.x; j < mi; j += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < mo; ++r) s += sW[r * mi + j] * sy[r];
      sx[j] = s;
      sq += s * s;
    }
    red[threadIdx.x] = sq;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
      __syncthreads();
    }
    const float norm = sqrtf(red[0]);
    for (int j = threadIdx.x; j < mi; j += kThreads) sx[j] = sx[j] / norm;
    __syncthreads();
  }
  for (int j = threadIdx.x; j < mi; j += kThreads) v[(size_t)k * mi + j] = sx[j];
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int spectral_launch(const void* W, const void* x0, void* v, int K,
                               int mo, int mi, int iters, void* stream) {
  if (K <= 0 || mo <= 0 || mi <= 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(mo * mi + mi + mo + kThreads) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  spectral_kernel<<<K, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)W, (const float*)x0, (float*)v, mo, mi, iters);
  return (int)cudaGetLastError();
}
