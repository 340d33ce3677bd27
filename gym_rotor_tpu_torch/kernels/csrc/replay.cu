// K2 + K8: the replay ring's write and read, and the episode statistics,
// for Hopper (sm_90a).
//
// Replaces gym_rotor_tpu/algos/replay.py:145 insert_tick (_pack + the
// modular scatter of insert) and :199 sample (the row gather and the empty
// ring's NaN poison, with the copies the learners made of the sampled
// fields: concat(obs, act), the CTDE joint fields and the CAPS stacks,
// gym_rotor_tpu/algos/td3.py:209-224, :284, sac.py:153-171, :242), and the
// episode bookkeeping of
// gym_rotor_tpu/parallel/train_step.py:142-155 (roll_body: ep_ret, fin, cnt,
// rsum), which XLA fused into the rollout scan on the TPU.  Plain twins:
// gym_rotor_tpu_torch/kernels/replay.py:replay_insert_tick_plain and
// replay_sample_plain.
//
// Bound on an H100: the bytes.  One flagship tick writes 4096 rows of 45
// floats (737 KB) and reads about as much (the tick's obs, actions, rewards,
// terminal obs, flags and ep_ret): ~0.45 us at 3.35 TB/s.  At PPO A's 32
// rows the floor is the launch.  A sample reads 256 ring rows (46 KB) and
// writes the learners' operands (~80-120 KB): ~0.05 us, far under the
// launch.
//
// Design (one launch per call, with or without the statistics):
// insert_kernel gives each block a tile of 32 rows (128 blocks at 4096
// rows) and 256 threads.  Thread t writes the tile's ring elements t,
// t + 256, ... in order, so consecutive threads write consecutive floats of
// the ring: the tile's rows are one contiguous run of the ring, or two where
// it wraps (the run's start is computed once per tile, and an element after
// the wrap row moves back by cap rows; no per-element 64-bit %).  A thread
// steps its (row, column) by fixed increments (one division per thread),
// reads each element's source through a per-column table in shared memory
// (the field's base pointer plus its column, and the field's row width,
// found from the field widths the launch passes), issues all its loads,
// then all its stores.  K8: warp 0 takes the tile's rows on its lanes
// (ep_ret carried, the finished returns, count and reward sum) and sums
// them by a fixed butterfly of shuffles; with one tile it adds them into
// stats itself.  With more, warp 0 writes the tile's sums, fences and takes
// a ticket (atomicAdd on a per-device counter the wrapper owns); the block
// that takes the last ticket adds the tiles' sums, warp k sum k: lane l the
// tiles [l c, (l + 1) c) in order (c = ceil(tiles / 32)), then the lanes by
// the same butterfly, and re-arms the counter.  So a rerun repeats its
// numbers bitwise.  The order differs from the one-thread-per-env tree of
// blocks of 128 envs this replaced, so the sums agree with it to float32
// rounding, not bitwise (tests/test_torch_replay_kernel.py emulates it);
// the ring and ep_ret are copies and the same expression, bitwise.
// gather_kernel (the sample) writes the learners' operands, one buffer of
// regions: region r is a contiguous (B, w_r) matrix of the buffer whose
// column c is ring column src of the sampled rows (a row block of an
// operand: [obs_i | act_i], a CAPS stack's obs or next_obs block, rwd_i,
// ...).  The host lists the gathered columns of a sampled row once per
// layout (kernels/replay.py GatherLayout): per column j, one 64-bit word
// of four 16-bit fields, its ring column, its region's place in the buffer
// (in units of B), the region's width and the column's place in it.
// Thread e takes element (b, j) = (e / W, e % W) of the B x W gathered
// elements: consecutive threads read consecutive columns of one ring row
// and write runs of a region's row.  Its loads of the column's word and of
// idx[b] do not depend on each other, then the ring element (one element a
// thread: the fastest of 1, 2, 4 and 8 at 256 rows).  A value is poison *
// ring element (poison 1, or NaN for the empty ring): a copy, bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;        // rows per block: warp 0's lanes for K8
constexpr int kMaxRow = 128;
constexpr int kMaxStats = 4;     // n_agents (<= 2) + count + reward sum

struct Fields {
  const void* src[7];  // obs_0, obs_1, joint act, rwd, next_obs_0,
                       // next_obs_1 (float), done (bool)
  int width[7];        // per-row width of each (B, w) block
};

// PER: ring elements a thread, rows * row_dim / kThreads rounded up to a
// power of two (8 for a whole tile of rows of up to 64 floats, 16 up to
// kMaxRow; fewer for a launch of fewer rows than a tile).
template <int PER>
__global__ void __launch_bounds__(kThreads)
insert_kernel(float* __restrict__ ring, long long cap, int row_dim,
              long long ptr, int B, Fields f, int n_agents,
              const bool* __restrict__ reset, float* __restrict__ ep_ret,
              float* __restrict__ partial, float* __restrict__ stats,
              unsigned* __restrict__ ticket) {
  __shared__ const char* col_src[kMaxRow];
  __shared__ int col_w[kMaxRow];   // row width; negative: a bool field
  __shared__ bool last;
  const int tid = threadIdx.x;
  if (tid < row_dim) {
    // the column's field: fields 0-6 in ring order (algos/replay.py _pack)
    int start = 0;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const int w = f.width[j];
      if (tid >= start && tid < start + w) {
        col_src[tid] = (const char*)f.src[j] + (tid - start) * (j == 6 ? 1 : 4);
        col_w[tid] = j == 6 ? -w : w;
      }
      start += w;
    }
  }
  const int r0 = blockIdx.x * kTile;
  const int rows = min(kTile, B - r0);

  // K8's inputs first, so their loads overlap the ring's: warp 0 one row a
  // lane, and stats[k] for the thread that adds sum k (lane k of warp 0
  // with one tile, lane 0 of warp k in the last block)
  const bool stats_on = ep_ret != nullptr;
  const int nq = n_agents + 2;
  const int lr = r0 + tid, warp = tid >> 5, lane = tid & 31;
  bool rs = false;
  float rw[2] = {0.0f, 0.0f}, ep[2] = {0.0f, 0.0f}, st = 0.0f;
  if (stats_on) {
    if (tid < rows) {
      rs = reset[lr];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        if (a < n_agents) {
          rw[a] = ((const float*)f.src[3])[(size_t)lr * n_agents + a];
          ep[a] = ep_ret[(size_t)lr * n_agents + a];
        }
    }
    if (tid < nq || (lane == 0 && warp < nq)) st = stats[tid < nq ? tid : warp];
  }
  __syncthreads();

  // the ring's loads: this tile's rows * row_dim elements, strided by
  // kThreads
  const int dq = kThreads / row_dim, dc = kThreads - dq * row_dim;
  const int r_first = tid / row_dim, c_first = tid - r_first * row_dim;
  float v[PER];
  {
    int r = r_first, c = c_first;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (r < rows) {
        const char* p = col_src[c];
        const int w = col_w[c];
        const size_t row = (size_t)(r0 + r);
        v[k] = w > 0 ? ((const float*)p)[row * w]
                     : (((const unsigned char*)p)[row * -w] ? 1.0f : 0.0f);
      }
      c += dc;
      r += dq;
      if (c >= row_dim) { c -= row_dim; ++r; }
    }
  }

  // K8, before warp 0's ring stores so its fence waits on its sums alone:
  // the tile's sums by a fixed butterfly over warp 0's lanes, then stats
  // (one tile) or the tile's sums and a ticket
  if (stats_on && tid < kTile) {
    float q[kMaxStats] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (tid < rows) {
      float rsum = 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a)
        if (a < n_agents) {
          const float e = ep[a] + rw[a];
          q[a] = rs ? e : 0.0f;
          ep_ret[(size_t)lr * n_agents + a] = rs ? 0.0f : e;
          rsum += rw[a];
        }
      const float cnt = rs ? 1.0f : 0.0f;
      if (n_agents == 1) {
        q[1] = cnt;
        q[2] = rsum;
      } else {
        q[2] = cnt;
        q[3] = rsum;
      }
    }
    float mine = 0.0f;             // lane k < nq: the tile's sum k
#pragma unroll
    for (int k = 0; k < kMaxStats; ++k) {
#pragma unroll
      for (int h = kTile / 2; h > 0; h >>= 1)
        q[k] += __shfl_xor_sync(0xffffffffu, q[k], h);
      if (tid == k) mine = q[k];
    }
    if (gridDim.x == 1) {
      if (tid < nq) stats[tid] = st + mine;
    } else {
      if (tid < nq) partial[blockIdx.x * nq + tid] = mine;
      __threadfence();
      __syncwarp();
      if (tid == 0) {
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
        __threadfence();
      }
    }
  }

  // the ring's stores: the tile's rows are one run of the ring from slot
  // first, or two where they wrap (those from row wrap_r back by cap rows)
  {
    const long long start = ptr + r0;            // < cap + B <= 2 cap
    const long long first = start < cap ? start : start - cap;
    const long long wrap_r = cap - first;
    float* base = ring + first * row_dim;
    const long long back = cap * row_dim;
    int r = r_first, c = c_first;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (r < rows) {
        const long long e = (long long)r * row_dim + c;
        base[r >= wrap_r ? e - back : e] = v[k];
      }
      c += dc;
      r += dq;
      if (c >= row_dim) { c -= row_dim; ++r; }
    }
  }
  if (!stats_on || gridDim.x == 1) return;
  __syncthreads();
  if (!last) return;

  // the last block: warp k adds sum k over the tiles, lane l the tiles
  // [l c, (l + 1) c) in order, then the lanes by the same butterfly
  if (warp >= nq) return;
  const int nb = gridDim.x, chunk = (nb + 31) / 32;
  const int b0 = lane * chunk, b1 = min(nb, b0 + chunk);
  float s = 0.0f;
  for (int b = b0; b < b1; b += 4) {
    float t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      t[u] = b + u < b1 ? __ldcg(partial + (b + u) * nq + warp) : 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (b + u < b1) s = b + u == b0 ? t[u] : s + t[u];
  }
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) s += __shfl_xor_sync(0xffffffffu, s, h);
  if (lane == 0) stats[warp] = st + s;
  if (tid == 0) *ticket = 0u;
}

// table: per gathered column j < W, the word src | dst << 16 | wid << 32 |
// col << 48 (ring column, region offset in units of batch, region width,
// column in the region).
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ ring, int row_dim,
              const int64_t* __restrict__ idx, int batch, float poison,
              const unsigned long long* __restrict__ table, int W,
              float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= batch * W) return;
  const int b = e / W, j = e - b * W;
  const unsigned long long word = __ldg(table + j);
  const long long row = __ldg((const long long*)idx + b);
  const int src = (int)(word & 0xFFFF), dst = (int)((word >> 16) & 0xFFFF);
  const int w = (int)((word >> 32) & 0xFFFF), c = (int)(word >> 48);
  out[dst * batch + b * w + c] = poison * __ldg(ring + row * row_dim + src);
}

struct Launch {
  float* ring;
  long long cap;
  int row_dim;
  long long ptr;
  int B;
  Fields f;
  int n_agents;
  const bool* reset;
  float* ep_ret;
  float* partial;
  float* stats;
  unsigned* ticket;
  int blocks;
  cudaStream_t stream;
};

template <int PER>
int insert(const Launch& l) {
  insert_kernel<PER><<<l.blocks, kThreads, 0, l.stream>>>(
      l.ring, l.cap, l.row_dim, l.ptr, l.B, l.f, l.n_agents, l.reset,
      l.ep_ret, l.partial, l.stats, l.ticket);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int replay_insert_blocks(int B) {
  return (B + kTile - 1) / kTile;
}

// reset/ep_ret/partial/stats/ticket null: ring write only (insert_tick
// without the episode statistics).  ticket: a zeroed unsigned counter that
// the launch leaves zeroed; launches that share it run one after another.
extern "C" int replay_insert_launch(
    void* ring, long long cap, int row_dim, long long ptr, int B,
    const void* obs0, int w_obs0, const void* obs1, int w_obs1,
    const void* act, int w_act, const void* rwd, const void* nobs0,
    const void* nobs1, const void* done, int n_agents, const void* reset,
    void* ep_ret, void* partial, void* stats, void* ticket, void* stream) {
  if (B <= 0 || cap <= 0 || row_dim <= 0 || row_dim > kMaxRow ||
      n_agents < 1 || n_agents > 2 || (long long)B > cap || ptr < 0 ||
      ptr >= cap)
    return (int)cudaErrorInvalidValue;
  Fields f;
  const void* src[7] = {obs0, obs1, act, rwd, nobs0, nobs1, done};
  const int width[7] = {w_obs0, w_obs1, w_act, n_agents, w_obs0, w_obs1,
                        n_agents};
  for (int j = 0; j < 7; ++j) {
    f.src[j] = src[j];
    f.width[j] = width[j];
  }
  // the fewest slots a thread that cover a tile (a power of two)
  const int need = ((B < kTile ? B : kTile) * row_dim + kThreads - 1) / kThreads;
  const int per = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8 : 16;
  const Launch l{(float*)ring, cap, row_dim, ptr, B, f, n_agents,
                 (const bool*)reset, (float*)ep_ret, (float*)partial,
                 (float*)stats, (unsigned*)ticket, replay_insert_blocks(B),
                 (cudaStream_t)stream};
  switch (per) {
    case 1: return insert<1>(l);
    case 2: return insert<2>(l);
    case 4: return insert<4>(l);
    case 8: return insert<8>(l);
    default: return insert<16>(l);
  }
}

// table: the gathered columns' words (gather_kernel), W columns; out: the
// buffer.
extern "C" int replay_sample_launch(const void* ring, int row_dim,
                                    const void* idx, int batch, float poison,
                                    const void* table, int W, void* out,
                                    void* stream) {
  if (batch <= 0 || row_dim <= 0 || W <= 0 ||
      (long long)batch * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int blocks = (batch * W + kThreads - 1) / kThreads;
  gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ring, row_dim, (const int64_t*)idx, batch, poison,
      (const unsigned long long*)table, W, (float*)out);
  return (int)cudaGetLastError();
}
