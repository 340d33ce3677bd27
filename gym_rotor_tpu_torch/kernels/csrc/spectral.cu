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
// Bound on an H100: by the count, the operations, and few.  A twin
// critic's stack is 6 matrices of at most 123 x 62: 10 steps x 2 matvecs x
// 2 flops x 6 x 7.6k ~ 1.8 MFLOP (~0.03 us at the fp32 peak) over ~0.2 MB
// of weights.  What holds it is the chain of 20 dependent matvecs a matrix,
// each ending in a cross-thread exchange, and the launch: on an H100 a
// shuffle level costs ~70 cycles and a barrier ~40, so the design keeps
// both few.
//
// Design: one block per matrix; the form iterated is the two matvecs (not
// M = W^T W, whose forming costs mi^2 mo FMAs, ~0.5 M for 123 x 62, and
// whose rounding the iteration would keep).  All NS threads stage W in
// shared memory (every load in flight, then the stores at pitch MI + 4);
// the first NT = MO CA threads then keep two pieces of it in registers for
// the whole chain, the rest leave:
//   row pass, y = W x: thread t holds row t / CA, its lane c = t % CA the
//     columns 4 c + 4 CA g + q (float4 groups, x read as conflict-free
//     float4 broadcasts); its products summed over the groups with one
//     accumulator per q, then (a0 + a1) + (a2 + a3), written to shared
//     memory as its share of the row (no shuffle); beside it its share of
//     |x|^2 the same way (a row's lanes together hold all of x, so the
//     norm needs no exchange between warps);
//   column pass, x = W^T y / |x|: thread t holds column t / RB, its lane
//     k = t % RB the rows 4 k + 4 RB g + q; y is the rows' shares added in
//     lane order; the same sums, then a butterfly (__shfl_xor) over the
//     column's RB lanes; |x| from the row lanes' shares of it (a butterfly
//     over CA lanes, none at the critics' instance); the next iterate goes
//     to the other of two buffers.
// A pass ends in a barrier of the NT threads (two an iteration); the last
// iterate is divided by its norm.  A butterfly gives every lane the same
// bits (a + b == b + a), so every sum has one fixed order and a rerun
// repeats its numbers.  Padding (zero) groups are summed too: a test that
// skips them keeps the compiler from issuing the groups' loads together.
// Instances by the padded shape: <= 32 x 32 (the actors' stacks, 64
// threads iterating), <= 128 x 64 (the critics', 128 threads, one lane a
// row), <= 128 x 128 (512).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

namespace {

constexpr int kMaxDevices = 64;

// butterfly sum over the lane bits LO .. HI / 2 (powers of two)
template <int LO, int HI>
__device__ __forceinline__ float lane_sum(float s) {
#pragma unroll
  for (int m = LO; m < HI; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// The geometry of an instance: matrices of at most MO x MI; CA lanes a row
// in the row pass, RB lanes a column in the column pass, NT threads in
// both; NS >= NT threads stage W, and those past NT leave after it.
template <int MO, int MI, int CA, int RB, int NS>
struct Geo {
  static constexpr int NT = MO * CA;
  static constexpr int GA = MI / (4 * CA);   // float4 groups a row lane
  static constexpr int GB = MO / (4 * RB);   // float4 groups a column lane
  // the staged matrix's pitch: rows 16-byte aligned for the row pass's
  // float4 loads; at the critics' instance neither pass's register loads
  // share a bank
  static constexpr int P = MI + 4;
  static_assert(NT == MI * RB && NT % 32 == 0 && NS % NT == 0 && NS <= 1024,
                "threads");
  static_assert(32 % CA == 0 && 32 % RB == 0, "a row's, a column's lanes");
  static_assert(GA >= 1 && GB >= 1, "lanes");
  // shared memory: x (2 MI), the row lanes' shares of y (CA MO), W
  // (mo x P)
  static size_t smem(int mo) {
    return (size_t)(2 * MI + CA * MO + mo * P) * 4;
  }
};

// the compute threads' barrier: the block's, or a named one of the first NT
// threads when the staging threads past them have left
template <int NT, int NS>
__device__ __forceinline__ void sync_compute() {
  if (NT == NS)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
}

// A row lane's sums over its columns of x (float4 groups, conflict-free
// broadcasts): its share of y = W x and of |x|^2, each over the groups in
// order with one accumulator per q, then (a0 + a1) + (a2 + a3).  Every
// group, padding too (zeros): a test that skips groups keeps the compiler
// from issuing the groups' loads together.
template <int GA, int CA>
__device__ __forceinline__ void row_sums(const float (&wa)[GA][4],
                                         const float* x, int ca, float& y,
                                         float& sq) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int g = 0; g < GA; ++g) {
    const float4 xv = reinterpret_cast<const float4*>(x)[ca + CA * g];
    const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = fmaf(wa[g][q], xq[q], a[q]);
      s[q] = fmaf(xq[q], xq[q], s[q]);
    }
  }
  y = (a[0] + a[1]) + (a[2] + a[3]);
  sq = (s[0] + s[1]) + (s[2] + s[3]);
}

template <int MO, int MI, int CA, int RB, int NS>
__global__ void __launch_bounds__(NS)
spectral_kernel(const float* __restrict__ W, const float* __restrict__ x0,
                float* __restrict__ v, int mo, int mi, int iters) {
  using G = Geo<MO, MI, CA, RB, NS>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // the iterate, unnormalised, two buffers
  float* yp = xs + 2 * MI;     // the row lanes' shares of W x, [ca][row]
  float* sW = yp + CA * MO;
  const int t = threadIdx.x;
  const size_t k = blockIdx.x;
  const float* Wk = W + k * mo * mi;
  {
    // stage W: the start vector's and the flat matrix's coalesced loads all
    // in flight, then stores at pitch P: row r = e / mi, taken as
    // floor((e + 0.5) / mi) in float (off an integer by >= 0.5 / mi, far
    // more than the rounding for e < 2^14), at r P + e - r mi
    constexpr int PER = (MO * MI + NS - 1) / NS;
    const int n = mo * mi;
    const float xv = t < mi ? x0[k * mi + t] : 0.0f;
    const float rmi = 1.0f / (float)mi;
    float st[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = t + NS * i;
      st[i] = e < n ? Wk[e] : 0.0f;
    }
    if (t < MI) xs[t] = xv;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = t + NS * i;
      const int r = __float2int_rd(((float)e + 0.5f) * rmi);
      if (e < n) sW[e + r * (G::P - mi)] = st[i];
    }
  }
  __syncthreads();
  if (t >= G::NT) return;
  if (iters == 0) {
    if (t < mi) v[k * mi + t] = xs[t];
    return;
  }
  const int ra = t / CA, ca = t % CA;     // row pass: row, lane
  const int jb = t / RB, kb = t % RB;     // column pass: column, lane
  float wa[G::GA][4], wb[G::GB][4];
#pragma unroll
  for (int g = 0; g < G::GA; ++g) {
    // a row's float4 groups (zero beyond mi, as the start vector's padding)
    const float4 w = ra < mo ? reinterpret_cast<const float4*>(
                                   sW + ra * G::P)[ca + CA * g]
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int c = 4 * (ca + CA * g);
    wa[g][0] = c < mi ? w.x : 0.0f;
    wa[g][1] = c + 1 < mi ? w.y : 0.0f;
    wa[g][2] = c + 2 < mi ? w.z : 0.0f;
    wa[g][3] = c + 3 < mi ? w.w : 0.0f;
  }
#pragma unroll
  for (int g = 0; g < G::GB; ++g)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * kb + 4 * RB * g + q;
      wb[g][q] = (r < mo && jb < mi) ? sW[r * G::P + jb] : 0.0f;
    }
  for (int it = 0; it < iters; ++it) {
    const float* xc = xs + (it & 1) * MI;     // this step's iterate
    // the row lane's share of y = W x, to shared memory as it is; its share
    // of |x|^2 (a row's lanes hold all of x) stays in a register
    float y, sq;
    row_sums<G::GA, CA>(wa, xc, ca, y, sq);
    yp[ca * MO + ra] = y;
    sync_compute<G::NT, NS>();
    // x = W^T y / |x| (y: the row lanes' shares added in order; |x|: the
    // row lanes' shares added by a butterfly), the next iterate into the
    // other buffer
    const float inv = rsqrtf(lane_sum<1, CA>(sq));
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int g = 0; g < G::GB; ++g) {
      float4 yv = reinterpret_cast<const float4*>(yp)[kb + RB * g];
#pragma unroll
      for (int c = 1; c < CA; ++c) {
        const float4 u =
            reinterpret_cast<const float4*>(yp + c * MO)[kb + RB * g];
        yv.x += u.x;
        yv.y += u.y;
        yv.z += u.z;
        yv.w += u.w;
      }
      a0 = fmaf(wb[g][0], yv.x, a0);
      a1 = fmaf(wb[g][1], yv.y, a1);
      a2 = fmaf(wb[g][2], yv.z, a2);
      a3 = fmaf(wb[g][3], yv.w, a3);
    }
    const float x = lane_sum<1, RB>((a0 + a1) + (a2 + a3)) * inv;
    if (kb == 0) xs[((it + 1) & 1) * MI + jb] = x;
    sync_compute<G::NT, NS>();
  }
  const float* xf = xs + (iters & 1) * MI;
  float y, sq;
  row_sums<G::GA, CA>(wa, xf, ca, y, sq);
  const float norm = sqrtf(lane_sum<1, CA>(sq));
  if (t < mi) v[k * mi + t] = xf[t] / norm;
}


// Run-time widths: stacks past the instances' 128 x 128 (the critics from
// critic_hidden_dim ~ 64 up, whose matrices outgrow a block's shared
// memory at ~ 256 x 220) run spectral_any_kernel: a thread-block cluster of
// C blocks (16 or 8, the host's choice by what the card co-schedules:
// spectral.py any_plan) per matrix, block `rank` owning the band of rows
// [rank band, (rank + 1) band).  The iteration is the instances' (the
// iterate scaled by 1 / |x| each step, the last divided by its norm).
//   staging: each block copies its band of W into its shared memory once
//     (cp.async, 16 bytes a copy where the rows allow), so W is read from
//     device memory once a call; a band past what a block holds (past
//     ~3.4 MB a matrix at C = 16) is read from global memory on each pass
//     instead (STAGED false), the same sums in the same order;
//   row pass, y = W_band x: a warp a row, four rows at once, lane l the
//     columns l + 32 m with one accumulator per m % 4, then (a0 + a1) +
//     (a2 + a3) and a butterfly over the lanes;
//   column pass: thread j's partial of (W_band^T y_band)[j], the band's
//     rows in order with one accumulator per row % 4, then (a0 + a1) + (a2 +
//     a3), into slot it % 2 of the block's two partial slots;
//   combine: after one cluster barrier, every block reads the C blocks'
//     partials of its columns through distributed shared memory and adds
//     them in rank order, times 1 / |x| (|x|^2 summed by every warp of
//     every block alike, lane sums then a butterfly).  Every block then
//     holds the same next x, bit for bit.  The double slot makes one
//     cluster barrier an iteration enough: a block writes slot s again
//     two iterations on, after the barrier that every peer reaches only
//     once it has read slot s.
// Every sum has one fixed order (by the band, not by the threads or the
// timing), so a rerun repeats its numbers.  Bound on an H100: the bytes
// of W once (3.1 MB at (6, 511, 256): ~0.9 us); what holds it is the chain
// of 10 iterations, each two block barriers, one cluster barrier and the
// partials' reads from the peers.
constexpr int kAnyMaxThreads = 512;

__host__ __device__ inline int any_pitch(int mi) { return (mi + 3) & ~3; }

// dynamic shared memory of a launch: x, the two partial slots, y for the
// band (rounded to 4), and the staged band at pitch any_pitch(mi)
__host__ __device__ inline size_t any_smem(int mi, int band, bool staged) {
  const size_t p = any_pitch(mi);
  return (3 * p + ((band + 3) & ~3) + (staged ? (size_t)band * p : 0)) * 4;
}

// |x|^2 over x[0:n] in every lane of the warp: lane l's terms l + 32 m with
// one accumulator per m % 4, (s0 + s1) + (s2 + s3), then the butterfly
__device__ __forceinline__ float any_sq(const float* x, int n, int lane) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int c = lane;
  for (; c + 96 < n; c += 128) {
    a0 = fmaf(x[c], x[c], a0);
    a1 = fmaf(x[c + 32], x[c + 32], a1);
    a2 = fmaf(x[c + 64], x[c + 64], a2);
    a3 = fmaf(x[c + 96], x[c + 96], a3);
  }
  if (c < n) a0 = fmaf(x[c], x[c], a0);
  if (c + 32 < n) a1 = fmaf(x[c + 32], x[c + 32], a1);
  if (c + 64 < n) a2 = fmaf(x[c + 64], x[c + 64], a2);
  float s[1] = {(a0 + a1) + (a2 + a3)};
  cluster::warp_sums<1>(s);
  return s[0];
}

template <bool STAGED>
__global__ void __launch_bounds__(kAnyMaxThreads)
spectral_any_kernel(const float* __restrict__ W, const float* __restrict__ x0,
                    float* __restrict__ v, int mo, int mi, int iters,
                    int band) {
  extern __shared__ __align__(16) float sm[];
  const int C = (int)cluster::size(), rank = (int)cluster::rank();
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const size_t k = blockIdx.x / C;
  const int pitch = any_pitch(mi);
  const int r0 = rank * band, nr = max(0, min(band, mo - r0));
  float* xs = sm;                      // the iterate
  float* part = xs + pitch;            // two slots of the band's partial
  float* ys = part + 2 * pitch;        // y of the band's rows
  float* wb = ys + ((band + 3) & ~3);  // the band, [row][pitch]
  const float* Wk = W + k * (size_t)mo * mi + (size_t)r0 * mi;
  for (int j = t; j < mi; j += nt) xs[j] = x0[k * mi + j];
  if (STAGED) {
    if ((mi & 3) == 0 && ((size_t)Wk & 15) == 0) {
      for (int q = t; q < nr * mi / 4; q += nt)
        __pipeline_memcpy_async(wb + 4 * q, Wk + 4 * q, 16);
    } else {
      for (int q = t; q < nr * mi; q += nt) {
        const int r = q / mi;
        __pipeline_memcpy_async(wb + r * pitch + (q - r * mi), Wk + q, 4);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  if (iters == 0) {
    if (rank == 0)
      for (int j = t; j < mi; j += nt) v[k * mi + j] = xs[j];
    return;
  }
  const float* wr = STAGED ? wb : Wk;
  const int ld = STAGED ? pitch : mi;
  for (int it = 0; it < iters; ++it) {
    float* slot = part + (it & 1) * pitch;
    const float inv = rsqrtf(any_sq(xs, mi, lane));
    // row pass: rows warp + nw (4 g + u), four at once
    for (int q0 = warp; q0 < nr; q0 += 4 * nw) {
      float y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * nw;
        const float* w = wr + (size_t)(q < nr ? q : q0) * ld;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        if (q < nr) {
          int c = lane;
          for (; c + 96 < mi; c += 128) {
            a0 = fmaf(w[c], xs[c], a0);
            a1 = fmaf(w[c + 32], xs[c + 32], a1);
            a2 = fmaf(w[c + 64], xs[c + 64], a2);
            a3 = fmaf(w[c + 96], xs[c + 96], a3);
          }
          if (c < mi) a0 = fmaf(w[c], xs[c], a0);
          if (c + 32 < mi) a1 = fmaf(w[c + 32], xs[c + 32], a1);
          if (c + 64 < mi) a2 = fmaf(w[c + 64], xs[c + 64], a2);
        }
        y[u] = (a0 + a1) + (a2 + a3);
      }
      cluster::warp_sums<4>(y);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (q0 + u * nw < nr) ys[q0 + u * nw] = y[u];
      }
    }
    __syncthreads();
    // column pass: this block's partial of W^T y, into this iteration's slot
    for (int j = t; j < mi; j += nt) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      int q = 0;
      for (; q + 3 < nr; q += 4) {
        a0 = fmaf(wr[(size_t)q * ld + j], ys[q], a0);
        a1 = fmaf(wr[(size_t)(q + 1) * ld + j], ys[q + 1], a1);
        a2 = fmaf(wr[(size_t)(q + 2) * ld + j], ys[q + 2], a2);
        a3 = fmaf(wr[(size_t)(q + 3) * ld + j], ys[q + 3], a3);
      }
      if (q < nr) a0 = fmaf(wr[(size_t)q * ld + j], ys[q], a0);
      if (q + 1 < nr) a1 = fmaf(wr[(size_t)(q + 1) * ld + j], ys[q + 1], a1);
      if (q + 2 < nr) a2 = fmaf(wr[(size_t)(q + 2) * ld + j], ys[q + 2], a2);
      slot[j] = (a0 + a1) + (a2 + a3);
    }
    // every block's partial written and visible to the cluster
    cluster::arrive();
    cluster::wait();
    // combine: the C partials of each column in rank order
    for (int j = t; j < mi; j += nt) {
      float p[cluster::kMaxSize];
#pragma unroll
      for (int r = 0; r < cluster::kMaxSize; ++r)
        if (r < C) p[r] = cluster::load_peer(slot + j, r);
      float s = p[0];
#pragma unroll
      for (int r = 1; r < cluster::kMaxSize; ++r)
        if (r < C) s += p[r];
      xs[j] = s * inv;
    }
    __syncthreads();
  }
  // every peer's reads of this block's slots done before it exits
  cluster::arrive();
  cluster::wait();
  if (rank == 0) {
    const float norm = sqrtf(any_sq(xs, mi, lane));
    for (int j = t; j < mi; j += nt) v[k * mi + j] = xs[j] / norm;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, size_t* done) {
  // per device and kernel: raise the dynamic shared-memory limit when a
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

template <int MO, int MI, int CA, int RB, int NS>
int launch(const float* W, const float* x0, float* v, int K, int mo, int mi,
           int iters, cudaStream_t stream) {
  static size_t done[kMaxDevices] = {0};
  using G = Geo<MO, MI, CA, RB, NS>;
  auto kernel = spectral_kernel<MO, MI, CA, RB, NS>;
  const size_t smem = G::smem(mo);
  cudaError_t e = set_smem(kernel, smem, done);
  if (e != cudaSuccess) return (int)e;
  kernel<<<K, NS, smem, stream>>>(W, x0, v, mo, mi, iters);
  return (int)cudaGetLastError();
}

// The instances, smallest first: (MO, MI, CA, RB, NS).
#define SPECTRAL_INSTANCES(X) \
  X(32, 32, 2, 2, 256) X(128, 64, 1, 2, 256) X(128, 128, 4, 4, 512)

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The instance a (mo, mi) stack runs on: geo = (MO, MI, CA, RB, NS) and
// the launch's dynamic shared memory (bytes); 0 if none fits.
extern "C" long long spectral_geometry(int mo, int mi, int* geo) {
#define X(a, b, c, d, e)                                           \
  if (mo >= 1 && mi >= 1 && mo <= a && mi <= b) {                  \
    geo[0] = a; geo[1] = b; geo[2] = c; geo[3] = d; geo[4] = e;    \
    return (long long)Geo<a, b, c, d, e>::smem(mo);                \
  }
  SPECTRAL_INSTANCES(X)
#undef X
  return 0;
}

extern "C" int spectral_launch(const void* W, const void* x0, void* v, int K,
                               int mo, int mi, int iters, void* stream) {
  if (K <= 0 || mo <= 0 || mi <= 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
#define X(a, b, c, d, e)                                                  \
  if (mo <= a && mi <= b)                                                 \
    return launch<a, b, c, d, e>((const float*)W, (const float*)x0,       \
                                 (float*)v, K, mo, mi, iters,             \
                                 (cudaStream_t)stream);
  SPECTRAL_INSTANCES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// Any (mo, mi): spectral_any_kernel in clusters of `cluster` blocks, block
// rank r the rows [r band, (r + 1) band), `threads` threads a block, the
// band staged in shared memory or read from global memory
// (spectral.py: any_plan).
extern "C" int spectral_any_launch(const void* W, const void* x0, void* v,
                                   int K, int mo, int mi, int iters,
                                   int cluster, int band, int threads,
                                   int staged, void* stream) {
  if (K <= 0 || mo <= 0 || mi <= 0 || iters < 0 || cluster < 1 ||
      cluster > cluster::kMaxSize || band < 1 ||
      (long long)band * cluster < mo || threads < 32 ||
      threads > kAnyMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = any_smem(mi, band, staged != 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (staged)
    return (int)cluster::launch<spectral_any_kernel<true>>(
        K * cluster, threads, cluster, smem, st, (const float*)W,
        (const float*)x0, (float*)v, mo, mi, iters, band);
  return (int)cluster::launch<spectral_any_kernel<false>>(
      K * cluster, threads, cluster, smem, st, (const float*)W,
      (const float*)x0, (float*)v, mo, mi, iters, band);
}

// The clusters of a launch's shape the card runs at once, or -(error).
extern "C" int spectral_any_active(int mi, int cluster, int band,
                                   int threads, int staged) {
  const size_t smem = any_smem(mi, band, staged != 0);
  return staged ? cluster::max_active<spectral_any_kernel<true>>(
                      threads, cluster, smem)
                : cluster::max_active<spectral_any_kernel<false>>(
                      threads, cluster, smem);
}

// The kernel's shared memory (bytes) for a plan, as the launch sizes it.
extern "C" long long spectral_any_smem(int mi, int band, int staged) {
  return (long long)any_smem(mi, band, staged != 0);
}
