// K2 + K8: the replay ring's write and read, and the episode statistics,
// for Hopper (sm_90a).
//
// Replaces gym_rotor_tpu/algos/replay.py:145 insert_tick (_pack + the
// modular scatter of insert) and :199 sample (the row gather and the empty
// ring's NaN poison), and the episode bookkeeping of
// gym_rotor_tpu/parallel/train_step.py:142-155 (roll_body: ep_ret, fin, cnt,
// rsum), which XLA fused into the rollout scan on the TPU.  Plain twins:
// gym_rotor_tpu_torch/kernels/replay.py:replay_insert_tick_plain and
// replay_sample_plain.
//
// Bound on an H100: the bytes.  One flagship tick writes 4096 rows of 45
// floats (737 KB) and reads about as much (the tick's obs, actions, rewards,
// terminal obs, flags and ep_ret): ~0.45 us at 3.35 TB/s.  A sample moves
// 256 rows of 45 floats twice (92 KB), far under the launch.
//
// Design: insert_kernel gives each block 128 envs.  Its threads first walk
// the block's rows x row_dim ring elements in order, so consecutive threads
// write consecutive floats of the ring (a row's source field and column come
// from a per-column map built on the host from the ring layout); each thread
// reads K1's output fields where they lie, field-major (B, w) blocks.  Then
// each thread does its env's statistics and the block reduces its partials
// (n_agents finished-return sums, the finished count, the reward sum) in a
// fixed tree; stats_kernel adds the blocks' partials in block order, so a
// run repeats its numbers.  sample_kernel is one thread per gathered float.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRow = 128;
constexpr int kMaxStats = 4;     // n_agents (<= 2) + count + reward sum

struct Fields {
  const float* src[6];   // obs_0, obs_1, joint act, rwd, next_obs_0, next_obs_1
  int width[6];
  const bool* done;      // (B, n_agents)
};

__global__ void __launch_bounds__(kThreads)
insert_kernel(float* __restrict__ ring, long long cap, int row_dim,
              long long ptr, int B, Fields f, const int* __restrict__ colmap,
              int n_agents, const bool* __restrict__ reset,
              float* __restrict__ ep_ret, float* __restrict__ partial) {
  __shared__ int cmap[kMaxRow];
  __shared__ float red[kMaxStats][kThreads];
  for (int c = threadIdx.x; c < row_dim; c += kThreads) cmap[c] = colmap[c];
  __syncthreads();
  const int r0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, B - r0);
  for (int e = threadIdx.x; e < rows * row_dim; e += kThreads) {
    const int r = r0 + e / row_dim, c = e % row_dim;
    const int field = cmap[c] >> 8, col = cmap[c] & 0xff;
    float val;
    if (field < 6)
      val = f.src[field][(size_t)r * f.width[field] + col];
    else
      val = f.done[(size_t)r * n_agents + col] ? 1.0f : 0.0f;
    const long long slot = (ptr + r) % cap;
    ring[slot * row_dim + c] = val;
  }
  if (ep_ret == nullptr) return;
  const int r = r0 + threadIdx.x;
  float q[kMaxStats] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (r < B) {
    const bool rs = reset[r];
    float rsum = 0.0f;
    for (int a = 0; a < n_agents; ++a) {
      const float rw = f.src[3][(size_t)r * n_agents + a];
      const float ep = ep_ret[(size_t)r * n_agents + a] + rw;
      q[a] = rs ? ep : 0.0f;
      ep_ret[(size_t)r * n_agents + a] = rs ? 0.0f : ep;
      rsum += rw;
    }
    q[n_agents] = rs ? 1.0f : 0.0f;
    q[n_agents + 1] = rsum;
  }
  const int nq = n_agents + 2;
  for (int k = 0; k < nq; ++k) red[k][threadIdx.x] = q[k];
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h)
      for (int k = 0; k < nq; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x < nq) partial[blockIdx.x * nq + threadIdx.x] = red[threadIdx.x][0];
}

__global__ void stats_kernel(const float* __restrict__ partial, int n_blocks,
                             int nq, float* __restrict__ stats) {
  const int k = threadIdx.x;
  if (k >= nq) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partial[b * nq + k];
  stats[k] += s;
}

__global__ void sample_kernel(const float* __restrict__ ring, int row_dim,
                              const int64_t* __restrict__ idx, int batch,
                              float poison, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= batch * row_dim) return;
  const int b = e / row_dim, c = e % row_dim;
  out[e] = poison * ring[idx[b] * row_dim + c];
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int replay_insert_blocks(int B) {
  return (B + kThreads - 1) / kThreads;
}

// reset/ep_ret/partial/stats null: ring write only (insert_tick without the
// episode statistics).
extern "C" int replay_insert_launch(
    void* ring, long long cap, int row_dim, long long ptr, int B,
    const void* obs0, int w_obs0, const void* obs1, int w_obs1,
    const void* act, int w_act, const void* rwd, const void* nobs0,
    const void* nobs1, const void* done, int n_agents, const void* colmap,
    const void* reset, void* ep_ret, void* partial, void* stats,
    void* stream) {
  if (B <= 0 || cap <= 0 || row_dim > kMaxRow || n_agents < 1 ||
      n_agents > 2 || (long long)B > cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Fields f;
  f.src[0] = (const float*)obs0;  f.width[0] = w_obs0;
  f.src[1] = (const float*)obs1;  f.width[1] = w_obs1;
  f.src[2] = (const float*)act;   f.width[2] = w_act;
  f.src[3] = (const float*)rwd;   f.width[3] = n_agents;
  f.src[4] = (const float*)nobs0; f.width[4] = w_obs0;
  f.src[5] = (const float*)nobs1; f.width[5] = w_obs1;
  f.done = (const bool*)done;
  const int blocks = replay_insert_blocks(B);
  insert_kernel<<<blocks, kThreads, 0, st>>>(
      (float*)ring, cap, row_dim, ptr, B, f, (const int*)colmap, n_agents,
      (const bool*)reset, (float*)ep_ret, (float*)partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ep_ret == nullptr) return (int)e;
  stats_kernel<<<1, 32, 0, st>>>((const float*)partial, blocks, n_agents + 2,
                                 (float*)stats);
  return (int)cudaGetLastError();
}

extern "C" int replay_sample_launch(const void* ring, int row_dim,
                                    const void* idx, int batch, float poison,
                                    void* out, void* stream) {
  if (batch <= 0 || row_dim <= 0) return (int)cudaErrorInvalidValue;
  const int n = batch * row_dim;
  sample_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)ring, row_dim, (const int64_t*)idx, batch, poison,
      (float*)out);
  return (int)cudaGetLastError();
}
