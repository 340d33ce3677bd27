// K12: Generalized Advantage Estimation over one horizon, for Hopper
// (sm_90a): the reverse recursion per env column, the TD targets, and the
// advantages normalised over the whole horizon, in one launch.
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
// in JAX's order of operations, built with -fmad=false, so td is bitwise
// the earlier three-launch kernel's.  Inputs and outputs are t-major (T, B)
// (row t*B + b), the flattened order the minibatch permutation indexes.
//
// Bound on an H100: the bytes.  Four float inputs read once and two outputs
// written once, 24 bytes an entry: 4.9 MB at the 4096-env horizon (T = 50,
// B = 4096), ~1.5 us at 3.35 TB/s; 0.17 MB at PPO A's (218, 32), ~0.05 us,
// where the serial recursion (218 dependent multiply-adds) and the launch
// are what remain.
//
// Design.  The host plans the launch (kernels/gae.py:gae_plan): CTAs of
// `cols` env columns each, thread c of a CTA scanning column b0 + c.  A CTA
// copies its (T x cols) tile of the four inputs into shared memory with
// cp.async (16 bytes a copy where B and cols are multiples of 4 and the
// inputs 16-byte aligned, else 4): the whole tile at once when it fits
// (resident, one chunk: the raw advantages then stay in shared memory for
// the normalisation), else in chunks of `rows` rows, the last rows first,
// through `stages` chunk buffers (streaming: the raw advantages go to the
// adv output and are read back from there).  Per chunk, once it has landed:
// every thread computes delta and the carry's coefficient gamma (1 - d)
// lambda of its share of the entries (a column, rows a constant stride
// apart: loops without branches, unrolled) in place of r and d (the
// parent's expressions); the column threads run the recursion, kGroup rows
// at a time (the group's loads, its chain, a multiply and an add a row,
// then its raw advantages stored over its deltas);
// every thread adds its share of the mean (streaming: and writes its share
// of td = adv + v and of the raw advantages).  Then the mean and the
// variance over the whole horizon, each a sum across the CTAs, each handed
// to the other CTAs before it is waited for (a resident tile writes td in
// between):
//   solo    one CTA, no exchange (a horizon of one or two columns or of
//           fewer than 1024 entries);
//   cluster one thread-block cluster of up to 16 CTAs (B <= 256: CTAs of
//           two columns or more, so the tile's copies and the passes spread
//           over up to 16 SMs): each CTA pushes its sum into every peer's
//           shared memory with one st.async that completes on the peer's
//           mbarrier (cluster.cuh's protocol);
//   grid    co-resident CTAs (B > 256: CTAs of 64 columns; a cooperative
//           launch, the host checks the occupancy): each CTA stores its sum
//           and a tag in one 64-bit word of scratch, and every CTA reads
//           the words until each carries this launch's tag (no fence: the
//           flag is the data).  The tags come from an epoch word that CTA 0
//           moves on once every CTA has read it, so no memset launch and no
//           reset.
// Fixed order of every sum (reruns bitwise; tests/test_torch_gae_head_
// kernel.py emulates it): thread i of a CTA of nc columns takes column
// i mod nc of rows i / nc, i / nc + R, i / nc + 2 R, ... (R = threads / nc;
// threads from R nc on take none) of each chunk, the chunks in their order
// (a resident tile is one chunk: rows in increasing order); its term of the
// mean is those raw advantages added in that order, its term of the
// variance the (adv - m)^2 of its rows of the whole horizon in increasing
// order.  A CTA adds its
// threads' terms by a warp butterfly (v += v[lane ^ h], h = 16 .. 1), then
// its warps' sums by the same butterfly (zero past the warps); the CTAs'
// sums meet in rank order: cluster, lane l holds CTA l's sum (zero past the
// cluster) and the butterfly; grid, lane l adds the sums of CTAs l, l + 32,
// l + 64, ... in that order, then the butterfly.
//
// The sharded route (a horizon split over the ranks of a process group:
// the mean and the variance are averaged over the ranks between the
// rounds, ppo.py:136-145 under an axis_name), three launches a call, each
// sum in K12's order, so at world 1 the route is bitwise the one launch:
//   A (stage kMean) the copies, the scan, td and the raw advantages into
//     adv, the mean's terms summed as above, the rank's mean into *mean;
//   B (stage kVar) the variance's terms of adv around *mean (the global
//     mean after the host's all-reduce), summed as above, the rank's
//     variance into *var;
//   C (gae_norm_kernel) adv = (adv - *mean) / (sqrt(*var N / max(N - 1,
//     1)) + 1e-4), N the entries of every rank, elementwise.
// A and B are gae_kernel with its stage argument; the grid mode moves its
// epoch on at the end of each.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

// GAE_MARK(k): phase boundary k (0 start, 1 the first chunk landed, 2 it
// scanned, 3 all scanned, 4 the mean known, 5 the variance's terms, 6 the
// variance known, 7 the end); nothing here (scripts/gae_phase_probe.py
// builds the kernel with marks that record the clock).
#ifndef GAE_MARK
#define GAE_MARK(k)
#endif

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxStages = 2;              // chunk buffers of a streamed tile
constexpr int kMaxGrid = 256;              // CTAs the scratch has room for
constexpr int kSmemBytes = 232448 - 2048;  // dynamic: 227 KB less the static
constexpr int kSolo = 0, kCluster = 1, kGrid = 2;
constexpr int kWhole = 0, kMean = 1, kVar = 2;   // the launch's stage
constexpr int kGroup = 8;                  // rows of the scan's register group
constexpr int kBatch = 4;                  // rows of a pass's register batch

struct Args {
  const float* v;
  const float* nv;
  const float* r;
  const float* d;
  float* adv;
  float* td;
  int T, B;
  float gamma, lam;
  int cols, rows, stages, chunks;
  int resident, vec;
  // grid: [0] the epoch, then 2 kMaxGrid words of (tag << 32 | sum bits)
  unsigned long long* scratch;
  int stage;     // kWhole, or the sharded route's kMean / kVar
  float* mean;   // kMean writes the rank's mean here, kVar reads the mean
  float* var;    // kVar writes the rank's variance here
};

// Chunk k: rows [lo, hi), hi = T - k rows, the last rows first.
__device__ __forceinline__ int chunk_hi(const Args& a, int k) {
  return a.T - k * a.rows;
}

// The chunk's buffer and the distance between its fields: resident, the
// whole tile [field][t][c] (chunk k its rows); streaming, buffer k % stages
// of [field][row][c].
__device__ __forceinline__ float* chunk_buf(const Args& a, float* sm, int k,
                                           int lo, int& fs) {
  if (a.resident) {
    fs = a.T * a.cols;
    return sm + (size_t)lo * a.cols;
  }
  fs = a.rows * a.cols;
  return sm + (size_t)(k % a.stages) * 4 * fs;
}

__device__ __forceinline__ const float* field_src(const Args& a, int f) {
  return f == 0 ? a.v : f == 1 ? a.nv : f == 2 ? a.r : a.d;
}

// Issue the cp.async copies of chunk k's nc columns from column b0 (the
// caller commits the group): thread i copies the 4 (vec) or 1 columns from
// (i mod q) w of rows i / q, i / q + threads / q, ... of each field.
__device__ __forceinline__ void issue_chunk(const Args& a, float* sm, int k,
                                            int b0, int nc) {
  const int hi = chunk_hi(a, k), lo = max(0, hi - a.rows), n = hi - lo;
  int fs;
  float* buf = chunk_buf(a, sm, k, lo, fs);
  const int w = a.vec ? 4 : 1, q = nc / w, pass = blockDim.x / q;
  const int t0 = threadIdx.x / q, c = (threadIdx.x - t0 * q) * w;
  if (t0 >= pass) return;
  for (int t = t0; t < n; t += pass) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      float* dst = buf + (size_t)f * fs + (size_t)t * a.cols + c;
      const float* src = field_src(a, f) + (size_t)(lo + t) * a.B + b0 + c;
      if (a.vec)
        __pipeline_memcpy_async(dst, src, 16);
      else
        __pipeline_memcpy_async(dst, src, 4);
    }
  }
}

// Wait until at most `pending` (0 or 1) groups are in flight (a constant to
// the instruction).
__device__ __forceinline__ void wait_pending(int pending) {
  if (pending == 0)
    __pipeline_wait_prior(0);
  else
    __pipeline_wait_prior(1);
}

// A thread's share of a CTA's entries (t, c), c < nc: column c = i mod nc
// of rows t0 = i / nc, t0 + R, t0 + 2 R, ... (R = threads / nc, i the
// thread); threads from R nc on take none.  A constant stride, so the
// passes' loops unroll into independent loads.
struct Share {
  int c, t0, R;
  bool on;
  __device__ __forceinline__ explicit Share(int nc) {
    R = blockDim.x / nc;
    t0 = threadIdx.x / nc;
    c = threadIdx.x - t0 * nc;
    on = t0 < R;
  }
};

// For the rows t = t0, t0 + R, ... < n in that order: store(t, load(t)),
// kBatch rows at a time with every load of the batch issued before its
// first store (the stores may alias the next rows' loads as far as the
// compiler knows, so this order is written out), then the rows left.
template <class Load, class Store>
__device__ __forceinline__ void rows(int t, int R, int n, Load load,
                                     Store store) {
  using V = decltype(load(0));
  for (; t + (kBatch - 1) * R < n; t += kBatch * R) {
    V x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) x[j] = load(t + j * R);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) store(t + j * R, x[j]);
  }
  for (; t < n; t += R) store(t, load(t));
}

// The CTA's sum of every thread's v, in every thread: a warp butterfly,
// then the warps' sums by the same butterfly.
__device__ __forceinline__ float block_total(float v, float* warp_part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float x[1] = {v};
  cluster::warp_sums<1>(x);
  if (lane == 0) warp_part[warp] = x[0];
  __syncthreads();
  cluster::lanes_sums<1>(warp_part, 0, blockDim.x >> 5, x);
  __syncthreads();
  return x[0];
}

__device__ __forceinline__ void put_word(unsigned long long* p,
                                         unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long get_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

// The horizon's sums of every thread's terms (round 0 the mean's, 1 the
// variance's), in every thread of every CTA, in two halves so that work
// can go between: publish() adds the CTA's terms and hands its sum to the
// others, collect() waits for theirs and adds them in rank order.
template <int MODE>
struct Exchange {
  const Args& a;
  unsigned tag;         // grid: the tag of round 0 this launch
  float* warp_part;
  float* sums;
  float (*slot)[cluster::kMaxSize];
  unsigned long long* bar;
  float own;            // solo: the CTA's sum
  int first;            // the launch's first round

  __device__ __forceinline__ void publish(float v, int round) {
    const float s = block_total(v, warp_part);
    if (MODE == kSolo) {
      own = s;
    } else if (MODE == kCluster) {
      if (round == first) cluster::wait();   // every CTA runs, bars set
      if ((int)threadIdx.x < (int)gridDim.x)
        cluster::store_async(&slot[round][cluster::rank()], &bar[round],
                             threadIdx.x, s);
    } else if (threadIdx.x == 0) {
      put_word(a.scratch + 1 + (size_t)round * kMaxGrid + blockIdx.x,
               (unsigned long long)(tag + round) << 32 | __float_as_uint(s));
    }
  }

  __device__ __forceinline__ float collect(int round) {
    if (MODE == kSolo) return own;
    float x[1];
    if (MODE == kCluster) {
      cluster::mbar_wait(&bar[round]);
      cluster::lanes_sums<1>(slot[round], 0, gridDim.x, x);
      return x[0];
    }
    const int G = gridDim.x;
    const unsigned long long* words = a.scratch + 1 + (size_t)round * kMaxGrid;
    const unsigned long long want = (unsigned long long)(tag + round) << 32;
    // a thread a word, all in flight at once; a short sleep between polls
    // eases the contention on the words' lines
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      unsigned long long w;
      while (((w = get_word(words + j)) & 0xffffffff00000000ull) != want)
        __nanosleep(64);
      sums[j] = __uint_as_float((unsigned)w);
    }
    __syncthreads();
    x[0] = 0.0f;
    for (int j = threadIdx.x & 31; j < G; j += 32) x[0] += sums[j];
    cluster::warp_sums<1>(x);
    return x[0];   // (the next round's block_total syncs before sums[])
  }
};

// The variance's terms of the raw advantages `raw` (this thread's column,
// row stride ld), its sum, and the normalisation into adv.
template <int MODE>
__device__ __forceinline__ void finish(const Args& a, const float* raw,
                                       int ld, const Share& sh, int b0,
                                       float m, long long n,
                                       Exchange<MODE>& X, unsigned epoch) {
  const int T = sh.on ? a.T : 0;
  float acc = 0.0f;
  rows(sh.t0, sh.R, T, [&](int t) { return raw[(size_t)t * ld]; },
       [&](int, float x) {
         const float c = x - m;
         acc += c * c;
       });
  GAE_MARK(5);
  X.publish(acc, 1);
  const float var = X.collect(1) / (float)n;
  GAE_MARK(6);
  // every CTA has read the epoch (it tagged its round-0 word after): CTA 0
  // moves it on for the next launch
  if (MODE == kGrid && blockIdx.x == 0 && threadIdx.x == 0)
    put_word(a.scratch, epoch + 1);
  const long long dof = n - 1 > 1 ? n - 1 : 1;
  const float denom = sqrtf(var * (float)n / (float)dof) + 1e-4f;
  float* out = a.adv + b0 + sh.c;
  rows(sh.t0, sh.R, T, [&](int t) { return raw[(size_t)t * ld]; },
       [&](int t, float x) { out[(size_t)t * a.B] = (x - m) / denom; });
  GAE_MARK(7);
}

// The sharded route's stage A, after the mean's round: the rank's mean
// out, and (grid) the epoch moved on, every CTA having read it.
template <int MODE>
__device__ __forceinline__ void mean_out(const Args& a, float m,
                                         unsigned epoch) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.mean = m;
    if (MODE == kGrid) put_word(a.scratch, epoch + 1);
  }
}

// The sharded route's stage B: the variance's terms of the raw advantages
// in adv around *mean, in finish()'s order, their sum across the CTAs as
// round 1, the rank's variance out.
template <int MODE>
__device__ __forceinline__ void var_stage(const Args& a,
                                          Exchange<MODE>& X,
                                          unsigned epoch) {
  const int b0 = blockIdx.x * a.cols, nc = min(a.cols, a.B - b0);
  const Share sh(nc);
  const float m = *a.mean;
  const float* raw = a.adv + b0 + sh.c;
  const int T = sh.on ? a.T : 0;
  float acc = 0.0f;
  rows(sh.t0, sh.R, T, [&](int t) { return raw[(size_t)t * a.B]; },
       [&](int, float x) {
         const float c = x - m;
         acc += c * c;
       });
  X.publish(acc, 1);
  const float var = X.collect(1) / (float)((long long)a.T * a.B);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.var = var;
    if (MODE == kGrid) put_word(a.scratch, epoch + 1);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kMaxThreads) gae_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ float warp_part[32];
  __shared__ float sums[MODE == kGrid ? kMaxGrid : 1];
  __shared__ float slot[2][cluster::kMaxSize];
  __shared__ unsigned long long bar[2];
  __shared__ unsigned epoch;
  if (MODE == kCluster) {
    if (threadIdx.x == 0) {
      cluster::mbar_init(&bar[0], 4 * gridDim.x);
      cluster::mbar_init(&bar[1], 4 * gridDim.x);
    }
    cluster::arrive_relaxed();
  }
  if (MODE == kGrid && threadIdx.x == 0) epoch = (unsigned)get_word(a.scratch);
  if (a.stage == kVar) {
    if (MODE == kGrid) __syncthreads();   // the epoch read
    Exchange<MODE> X{a, MODE == kGrid ? 2 * epoch + 1 : 0, warp_part, sums,
                     slot, bar, 0.0f, 1};
    var_stage<MODE>(a, X, epoch);
    return;
  }
  GAE_MARK(0);
  const int b0 = blockIdx.x * a.cols, nc = min(a.cols, a.B - b0);
  for (int s = 0; s < a.stages; ++s) {
    if (s < a.chunks) issue_chunk(a, sm, s, b0, nc);
    __pipeline_commit();
  }
  const Share sh(nc);
  float carry = 0.0f, acc = 0.0f;
  for (int k = 0; k < a.chunks; ++k) {
    const int hi = chunk_hi(a, k), lo = max(0, hi - a.rows), n = hi - lo;
    int fs;
    float* buf = chunk_buf(a, sm, k, lo, fs);
    wait_pending(a.stages - 1);
    __syncthreads();
    if (k == 0) GAE_MARK(1);
    // delta over r, the coefficient over d
    float* col = buf + sh.c;
    if (sh.on)
      rows(sh.t0, sh.R, n,
           [&](int t) {
             const float* p = col + (size_t)t * a.cols;
             return float4{p[0], p[fs], p[2 * (size_t)fs], p[3 * (size_t)fs]};
           },
           [&](int t, float4 q) {   // q: v, nv, r, d
             float* p = col + (size_t)t * a.cols;
             const float nd = 1.0f - q.w;
             p[2 * (size_t)fs] = q.z + a.gamma * q.y * nd - q.x;
             p[3 * (size_t)fs] = a.gamma * nd * a.lam;
           });
    __syncthreads();
    if ((int)threadIdx.x < nc) {
      // rows from n - 1 down, kGroup at a time: the group's loads, then its
      // chain, then its stores; then the rows left one at a time
      const int ld = a.cols;
      float* dl = buf + 2 * (size_t)fs + threadIdx.x + (size_t)(n - 1) * ld;
      int t = n;
      for (; t >= kGroup; t -= kGroup) {
        float x[kGroup], y[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          x[j] = dl[-j * ld];
          y[j] = dl[fs - j * ld];
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          carry = x[j] + y[j] * carry;
          x[j] = carry;
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) dl[-j * ld] = x[j];
        dl -= kGroup * ld;
      }
      for (; t > 0; --t) {
        carry = dl[0] + dl[fs] * carry;
        dl[0] = carry;
        dl -= ld;
      }
    }
    if (k == 0) GAE_MARK(2);
    __syncthreads();
    // the mean's terms; streaming, td = adv + v and the raw advantages to
    // adv (a resident tile writes td while the mean's sums travel)
    if (sh.on && a.resident)
      rows(sh.t0, sh.R, n,
           [&](int t) { return col[2 * (size_t)fs + (size_t)t * a.cols]; },
           [&](int, float x) { acc += x; });
    else if (sh.on)
      rows(sh.t0, sh.R, n,
           [&](int t) {
             const float* p = col + (size_t)t * a.cols;
             return float2{p[2 * (size_t)fs], p[0]};
           },
           [&](int t, float2 q) {   // q: raw advantage, v
             const size_t g = (size_t)(lo + t) * a.B + b0 + sh.c;
             a.td[g] = q.x + q.y;
             a.adv[g] = q.x;
             acc += q.x;
           });
    __syncthreads();
    if (k + a.stages < a.chunks) issue_chunk(a, sm, k + a.stages, b0, nc);
    __pipeline_commit();
  }

  GAE_MARK(3);
  Exchange<MODE> X{a, MODE == kGrid ? 2 * epoch + 1 : 0, warp_part, sums,
                   slot, bar, 0.0f, 0};
  X.publish(acc, 0);
  const long long n = (long long)a.T * a.B;
  // the raw advantages: the tile's r field (resident) or adv; one path
  // each, so the compiler knows which memory each load reads
  if (a.resident) {
    const float* raw = sm + 2 * (size_t)a.T * a.cols + sh.c;
    // td = adv + v while the mean's sums travel
    if (sh.on)
      rows(sh.t0, sh.R, a.T,
           [&](int t) {
             const size_t i = (size_t)t * a.cols;
             return float2{raw[i], sm[i + sh.c]};
           },
           [&](int t, float2 q) {
             const size_t g = (size_t)t * a.B + b0 + sh.c;
             a.td[g] = q.x + q.y;
             if (a.stage == kMean) a.adv[g] = q.x;
           });
    const float m = X.collect(0) / (float)n;
    GAE_MARK(4);
    if (a.stage == kMean) return mean_out<MODE>(a, m, epoch);
    finish<MODE>(a, raw, a.cols, sh, b0, m, n, X, epoch);
  } else {
    const float m = X.collect(0) / (float)n;
    GAE_MARK(4);
    if (a.stage == kMean) return mean_out<MODE>(a, m, epoch);
    finish<MODE>(a, a.adv + b0 + sh.c, a.B, sh, b0, m, n, X, epoch);
  }
}

// The sharded route's stage C: adv = (adv - m) / (std + 1e-4) over the
// rank's n entries, std Bessel-corrected over every rank's N, from the
// global mean and variance in device memory (finish()'s expressions).
__global__ void gae_norm_kernel(float* adv, long long n, const float* mean,
                                const float* var, long long N) {
  const float m = *mean;
  const long long dof = N - 1 > 1 ? N - 1 : 1;
  const float denom = sqrtf(*var * (float)N / (float)dof) + 1e-4f;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += step)
    adv[i] = (adv[i] - m) / denom;
}

// One launch of MODE with ctas CTAs of `threads` and `smem` bytes of
// dynamic shared memory; the kernel's attributes are set once per device.
// A launch the card refuses is reported, never replaced.
template <int MODE>
cudaError_t launch(const Args& a, int ctas, int threads, int smem,
                   cudaStream_t st) {
  static unsigned configured = 0;   // one bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!((configured >> dev) & 1u)) {
    e = cudaFuncSetAttribute(gae_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return e;
    if (MODE == kCluster) {
      e = cudaFuncSetAttribute(
          gae_kernel<MODE>, cudaFuncAttributeNonPortableClusterSizeAllowed,
          1);
      if (e != cudaSuccess) return e;
    }
    configured |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (MODE == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  } else if (MODE == kGrid) {
    // the CTAs spin on each other: every one must be resident at once
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gae_kernel<MODE>, threads, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if ((long long)per_sm * sms < ctas) return cudaErrorCooperativeLaunchTooLarge;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, gae_kernel<MODE>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Bytes of dynamic shared memory a launch of the plan takes (0: the plan
// does not fit the kernel's limits).
static long long gae_smem(int T, int cols, int rows, int stages) {
  if (T < 1 || cols < 1 || rows < 1 || stages < 1 || stages > kMaxStages)
    return 0;
  const long long chunks = (T + (long long)rows - 1) / rows;
  const long long bytes = chunks <= stages ? 16LL * T * cols
                                           : 16LL * rows * cols * stages;
  return bytes <= kSmemBytes ? bytes : 0;
}

// One launch of a plan at a stage (kWhole: the whole of K12).
static int plan_launch(const void* v, const void* nv, const void* r,
                       const void* d, int T, int B, float gamma, float lam,
                       void* adv, void* td, int mode, int ctas, int cols,
                       int threads, int rows, int stages, void* sync,
                       int stage, void* mean, void* var, void* stream) {
  if (T <= 0 || B <= 0 || ctas < 1 || cols < 1 || cols > threads ||
      threads % 32 != 0 || threads > kMaxThreads ||
      (long long)(ctas - 1) * cols >= B || (long long)ctas * cols < B)
    return (int)cudaErrorInvalidValue;
  const long long smem = gae_smem(T, cols, rows, stages);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.v = (const float*)v;
  a.nv = (const float*)nv;
  a.r = (const float*)r;
  a.d = (const float*)d;
  a.adv = (float*)adv;
  a.td = (float*)td;
  a.T = T;
  a.B = B;
  a.gamma = gamma;
  a.lam = lam;
  a.cols = cols;
  a.rows = rows;
  a.chunks = (T + rows - 1) / rows;
  a.resident = a.chunks <= stages;
  a.stages = a.resident ? a.chunks : stages;
  const unsigned long long align = (unsigned long long)v |
      (unsigned long long)nv | (unsigned long long)r | (unsigned long long)d;
  a.vec = B % 4 == 0 && cols % 4 == 0 && (align & 15) == 0;
  a.scratch = (unsigned long long*)sync;
  a.stage = stage;
  a.mean = (float*)mean;
  a.var = (float*)var;
  if (stage != kWhole && (mean == nullptr || (stage == kVar && var == nullptr)))
    return (int)cudaErrorInvalidValue;
  // stage B reads adv from global memory: no tile
  const int bytes = stage == kVar ? 0 : (int)smem;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == kSolo && ctas == 1)
    return (int)launch<kSolo>(a, ctas, threads, bytes, st);
  if (mode == kCluster && ctas <= cluster::kMaxSize)
    return (int)launch<kCluster>(a, ctas, threads, bytes, st);
  if (mode == kGrid && sync != nullptr && ctas <= kMaxGrid)
    return (int)launch<kGrid>(a, ctas, threads, bytes, st);
  return (int)cudaErrorInvalidValue;
}

// v, nv, r, d, adv, td: (T, B) float32, contiguous, t-major.  The plan
// (kernels/gae.py:gae_plan): mode 0 solo, 1 cluster, 2 grid; ctas CTAs of
// `threads` threads, `cols` columns a CTA; chunks of `rows` rows through
// `stages` buffers (resident when every chunk has one).  sync: the grid
// mode's scratch, 1 + 2 kMaxGrid 64-bit words, zeroed once, left ready for
// the next launch.
extern "C" int gae_launch(const void* v, const void* nv, const void* r,
                          const void* d, int T, int B, float gamma, float lam,
                          void* adv, void* td, int mode, int ctas, int cols,
                          int threads, int rows, int stages, void* sync,
                          void* stream) {
  return plan_launch(v, nv, r, d, T, B, gamma, lam, adv, td, mode, ctas, cols,
                     threads, rows, stages, sync, kWhole, nullptr, nullptr,
                     stream);
}

// The sharded route's stages A (1: td, the raw advantages into adv, the
// rank's mean into *mean) and B (2: the rank's variance of adv around
// *mean into *var), with gae_launch's arguments and plan.
extern "C" int gae_stage_launch(const void* v, const void* nv, const void* r,
                                const void* d, int T, int B, float gamma,
                                float lam, void* adv, void* td, int mode,
                                int ctas, int cols, int threads, int rows,
                                int stages, void* sync, int stage, void* mean,
                                void* var, void* stream) {
  if (stage != kMean && stage != kVar) return (int)cudaErrorInvalidValue;
  return plan_launch(v, nv, r, d, T, B, gamma, lam, adv, td, mode, ctas, cols,
                     threads, rows, stages, sync, stage, mean, var, stream);
}

// The sharded route's stage C over adv's n entries: N the entries of every
// rank, mean and var the global statistics (device scalars).
extern "C" int gae_norm_launch(void* adv, long long n, const void* mean,
                               const void* var, long long N, void* stream) {
  if (n <= 0 || N < n || mean == nullptr || var == nullptr)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  gae_norm_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), threads, 0,
                    (cudaStream_t)stream>>>((float*)adv, n,
                                            (const float*)mean,
                                            (const float*)var, N);
  return (int)cudaGetLastError();
}
