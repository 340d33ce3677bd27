// K3 (forward, actor widths): fused deterministic EMLP actor, K9: the
// fused SAC actor's acting sample, and K11: the fused PPO actor's acting
// draw and its log-prob, for Hopper (sm_90a).  One block body, three heads
// (a template parameter).  K11's epilogue is ppo_head.cuh's ppo::head,
// which the MLP PPO actor's kernel (mlp_ppo_actor.cu) shares, so the draw
// and the log-prob have one source.
//
// Replaces gym_rotor_tpu/models/emlp/nn.py:EMLPBlock (EquivLinear ->
// EquivBiLinear -> GatedNonlinearity) x2 inside EMLP, plus the tanh head of
// models/emlp/zoo.py:EMLPActorDet (K3), or the Gaussian head of
// models/emlp/zoo.py:EMLPActorSAC with the tanh-squashed sample of
// algos/sac.py:114 choose_action_f (K9), or the tanh mean and free log_std
// of models/emlp/zoo.py:EMLPActorPPO with the clipped draw and per-dim
// log-prob of algos/ppo.py:107-116 choose_action_f (K11), which XLA fused
// on the TPU.  Plain twins: gym_rotor_tpu_torch/kernels/emlp_actor.py:
// emlp_actor_plain, sac_actor_plain and ppo_actor_plain (structured).
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
// Bound on an H100: the operations, and few.  Per row and block, 2*NG*NI
// flops of linear layer and 3 per nonzero of the bilinear quadratic form
// (288 for agent 0, NG = 18): ~13 MFLOP per launch at B = 4096, ~0.2 us at
// the 67 TFLOP/s fp32 peak; the obs/action bytes are ~0.1 us.  The paths
// launch it at 4096 rows (training), 32 (PPO A), 10 (eval) and 1 (the Gym
// API), so what holds it is one row's chain of dependent steps: two
// blocks of a linear layer, a bilinear form and a gate, then the head.
//
// Design: a tile of kTile = 32 rows, lane t of every warp on row t, and one
// row's work split over the block's warps, as K3's training-width forward
// (emlp_block.cu).  The tile's per-row vectors (obs, lin, pre, h) sit in
// shared memory field-major, [c][row] at pitch kPitch, so a warp's loads of
// one coordinate are conflict-free.  The weights come folded once per
// parameter set (emlp_actor.py: fold_actor) as one image of 32-bit words
// that each block copies to shared memory verbatim (cp.async, 16 bytes a
// copy, in flight together with the first tile's obs); the host passes the
// image's section offsets (meta).  Per block of the network:
//   lin: each warp 4 outputs (a float4 of W_eff transposed, broadcast),
//        the inputs in order, then the bias;
//   pre: each warp a list of outputs (the host's plan: outputs longest
//        first to the least-loaded warp, a warp's own in coordinate order),
//        each output's nonzeros in their order, as broadcasts of (the two
//        factors' tile offsets, v), then 0.1 q + lin;
//   h:   every thread the same number of (coordinate, row) pairs,
//        pre / (1 + exp(-gate)).
// A barrier closes each step; h1 stays in shared memory for the second
// block; the head takes a warp an action.  Every sum has one fixed order
// (no atomics, no cross-warp sums), so a rerun repeats its numbers, and
// the arithmetic of each output is the one-thread-a-row kernel's of earlier
// commits.  The grid is the tiles, at most as many blocks as fit on the SMs
// at once (by occupancy), each looping over its tiles with the next tile's
// obs copied while one is computed.  Output is written with a row stride,
// straight into the joint action tensor.  Instantiated for the two flagship
// MODUL actors and the MONO actor (23 obs, 16 SO2eR3 channels, 4 actions),
// each with every head.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "cluster.cuh"
#include "ppo_head.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kPitch = kTile + 1;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// warps a block: the 18-gated actors' 5 float4 groups of linear outputs and
// 288 nonzeros, the 7-gated one's 2 groups and 27 nonzeros
__host__ __device__ constexpr int warps_of(int ng) { return ng > 8 ? 8 : 4; }

enum Head { kTanh = 0, kGauss = 1, kPPO = 2 };

// The image's section offsets in 32-bit words (emlp_actor.py: META), per
// network block b at 7 b: W_eff transposed (NI x round4(NG)), b_eff
// (round4(NG)), the gate's tile offsets (NH), the plan's warp ranges (warps
// + 1), its outputs (NG) and their entry ranges (NG + 1), the entries
// (int2: j * kPitch << 16 | i * kPitch, v's bits); then the head: its
// weights (NACT x NH) and bias, the Gaussian head's log_std Dense (NACT x
// NH, transposed) and bias, the PPO head's log_std (NACT); the image's
// length (a multiple of 4) and the warps a block the plan is for.
enum Meta { kWt, kB, kGate, kWptr, kTask, kTptr, kEnt, kBlock = 7,
            kWh = 14, kBh, kWl, kBl, kLogStd, kWords, kWarps, kMeta };

struct Img {
  int m[kMeta];
};

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 16);
}

// wait for this thread's copies (a barrier follows)
__device__ __forceinline__ void cp_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// rows [r0, r0 + rows) of the row-major (B, NIN) obs into a field-major tile
template <int NIN, int NT>
__device__ __forceinline__ void stage_obs(float* xs, const float* obs, int r0,
                                          int rows) {
  for (int q = threadIdx.x; q < rows * NIN; q += NT) {
    const int r = q / NIN;
    cp4(xs + (q - r * NIN) * kPitch + r, obs + (size_t)r0 * NIN + q);
  }
}

// lin = x W_eff^T + b_eff for the tile: each warp 4 outputs, each lane its
// row; the inputs in order, then the bias
template <int NI, int NG, int NW>
__device__ __forceinline__ void linear(const float* xt, const float* Wt,
                                       const float* b, float* ls, int warp,
                                       int lane) {
  constexpr int NGP = round4(NG);
  for (int q4 = warp; q4 < NGP / 4; q4 += NW) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const float xv = xt[k * kPitch + lane];
      const float4 w = reinterpret_cast<const float4*>(Wt + k * NGP)[q4];
      a0 = fmaf(xv, w.x, a0);
      a1 = fmaf(xv, w.y, a1);
      a2 = fmaf(xv, w.z, a2);
      a3 = fmaf(xv, w.w, a3);
    }
    const float4 bb = reinterpret_cast<const float4*>(b)[q4];
    const int o = 4 * q4;
    ls[o * kPitch + lane] = a0 + bb.x;
    if (o + 1 < NG) ls[(o + 1) * kPitch + lane] = a1 + bb.y;
    if (o + 2 < NG) ls[(o + 2) * kPitch + lane] = a2 + bb.z;
    if (o + 3 < NG) ls[(o + 3) * kPitch + lane] = a3 + bb.w;
  }
}

// pre = 0.1 Q(lin) + lin for the outputs the plan gives this warp
__device__ __forceinline__ void bilinear(const float* ls, float* ps,
                                         const int* img, const Img& im,
                                         int blk, int warp, int lane) {
  const int* wptr = img + im.m[kWptr + kBlock * blk];
  const int* task = img + im.m[kTask + kBlock * blk];
  const int* tptr = img + im.m[kTptr + kBlock * blk];
  const int2* ent =
      reinterpret_cast<const int2*>(img + im.m[kEnt + kBlock * blk]);
  const float* lr = ls + lane;
  const int m1 = wptr[warp + 1];
  for (int m = wptr[warp]; m < m1; ++m) {
    const int o = task[m], e1 = tptr[m + 1];
    float q = 0.0f;
#pragma unroll 4
    for (int e = tptr[m]; e < e1; ++e) {
      const int2 en = ent[e];
      q = fmaf(__int_as_float(en.y) * lr[(unsigned)en.x >> 16],
               lr[en.x & 0xffff], q);
    }
    ps[o * kPitch + lane] = 0.1f * q + lr[o * kPitch];
  }
}

// h = pre[:NH] * sigmoid(pre[gate]) for the tile, (coordinate, row) pairs;
// a compile-time count a thread, so that its pairs run side by side
template <int NH, int NT>
__device__ __forceinline__ void gate(const float* ps, const int* g, float* hs,
                                     int t) {
  static_assert(NH * kTile % NT == 0, "whole pairs a thread");
#pragma unroll
  for (int u = 0; u < NH * kTile / NT; ++u) {
    const int q = t + u * NT, k = q >> 5, r = q & 31;
    hs[k * kPitch + r] = ps[k * kPitch + r] / (1.0f + expf(-ps[g[k] + r]));
  }
}

// The actor's head on the tile's h2: a warp an action, a lane a row.
template <int NH, int NACT, int HEAD_KIND, int NW>
__device__ __forceinline__ void head(const float* hs, const float* f,
                                     const Img& im, int r0, int rows,
                                     int warp, int lane,
                                     const float* __restrict__ noise,
                                     int ld_noise, float* __restrict__ out,
                                     int ld_out, float* __restrict__ logp,
                                     int ld_logp, float max_action) {
  if (lane >= rows) return;
  const float* h = hs + lane;
  const size_t row = (size_t)r0 + lane;
  for (int a = warp; a < NACT; a += NW) {
    const float* wh = f + im.m[kWh] + a * NH;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NH; ++k) s = fmaf(h[k * kPitch], wh[k], s);
    const float mean = s + f[im.m[kBh] + a];
    if (HEAD_KIND == kPPO) {
      ppo::head(mean, f[im.m[kLogStd] + a],
               noise == nullptr ? nullptr : noise + row * ld_noise + a,
               max_action, out + row * ld_out + a, logp + row * ld_logp + a);
      continue;
    }
    float act = mean;
    if (HEAD_KIND == kGauss && noise != nullptr) {
      const float* wl = f + im.m[kWl] + a * NH;
      float l = 0.0f;
#pragma unroll
      for (int k = 0; k < NH; ++k) l = fmaf(h[k * kPitch], wl[k], l);
      const float ls = fminf(fmaxf(l + f[im.m[kBl] + a], -20.0f), 2.0f);
      act = mean + expf(ls) * noise[row * ld_noise + a];
    }
    out[row * ld_out + a] = tanhf(act);
  }
}

template <int NIN, int NG, int NH>
size_t smem_of(const int* meta) {
  return (size_t)meta[kWords] * 4 + (size_t)(NIN + 2 * NG + NH) * kPitch * 4;
}

template <int NIN, int NG, int NH, int NACT, int HEAD_KIND>
__global__ void __launch_bounds__((NG > 8 ? 8 : 4) * 32)
emlp_actor_kernel(const float* __restrict__ obs, int B,
                  const int* __restrict__ image, Img im,
                  const float* __restrict__ noise, int ld_noise,
                  float* __restrict__ out, int ld_out,
                  float* __restrict__ logp, int ld_logp, float max_action) {
  constexpr int NW = warps_of(NG), NT = NW * 32;
  extern __shared__ __align__(16) int smem[];
  const int words = im.m[kWords];
  const float* f = reinterpret_cast<const float*>(smem);
  float* xs = reinterpret_cast<float*>(smem + words);   // [k][row]
  float* ls = xs + NIN * kPitch;                        // lin [o][row]
  float* ps = ls + NG * kPitch;                         // pre
  float* hs = ps + NG * kPitch;                         // h1, then h2
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_tiles = (B + kTile - 1) / kTile;
  int tile = blockIdx.x;
  // the image and the first tile's obs, all in flight at once
  for (int q = t; q < words / 4; q += NT) cp16(smem + 4 * q, image + 4 * q);
  stage_obs<NIN, NT>(xs, obs, tile * kTile, min(kTile, B - tile * kTile));
  for (; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kTile, rows = min(kTile, B - r0);
    cp_wait();
    __syncthreads();
    linear<NIN, NG, NW>(xs, f + im.m[kWt], f + im.m[kB], ls, warp, lane);
    __syncthreads();
    // the next tile's obs, copied while this one is computed (xs is read)
    const int next = tile + gridDim.x;
    if (next < n_tiles)
      stage_obs<NIN, NT>(xs, obs, next * kTile, min(kTile, B - next * kTile));
    bilinear(ls, ps, smem, im, 0, warp, lane);
    __syncthreads();
    gate<NH, NT>(ps, smem + im.m[kGate], hs, t);
    __syncthreads();
    linear<NH, NG, NW>(hs, f + im.m[kBlock + kWt], f + im.m[kBlock + kB], ls,
                       warp, lane);
    __syncthreads();
    bilinear(ls, ps, smem, im, 1, warp, lane);
    __syncthreads();
    gate<NH, NT>(ps, smem + im.m[kBlock + kGate], hs, t);
    __syncthreads();
    // the next tile's first writes of ls, ps and hs follow the barrier at
    // the top of the loop, which every read of this tile precedes
    head<NH, NACT, HEAD_KIND, NW>(hs, f, im, r0, rows, warp, lane, noise,
                                  ld_noise, out, ld_out, logp, ld_logp,
                                  max_action);
  }
}

// Per device: the SM count, and per instance the blocks an SM fits at the
// last shared-memory size asked (the launch path stays free of queries).
int sm_count(int dev) {
  static int sms[kMaxDevices] = {0};
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <int NIN, int NG, int NH, int NACT, int HEAD_KIND>
int launch(const float* obs, int B, const int* image, const int* meta,
           const float* noise, int ld_noise, float* out, int ld_out,
           float* logp, int ld_logp, float max_action, cudaStream_t stream) {
  static size_t smem_set[kMaxDevices] = {0}, smem_fit[kMaxDevices] = {0};
  static int per_sm[kMaxDevices] = {0};
  constexpr int NT = warps_of(NG) * 32;
  if (meta[kWarps] != warps_of(NG) || meta[kWords] <= 0 ||
      (meta[kWords] & 3) != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = emlp_actor_kernel<NIN, NG, NH, NACT, HEAD_KIND>;
  const size_t smem = smem_of<NIN, NG, NH>(meta);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = smem;
  }
  if (smem != smem_fit[dev]) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kernel,
                                                      NT, smem);
    if (e != cudaSuccess) return (int)e;
    smem_fit[dev] = smem;
  }
  if (per_sm[dev] < 1 || sm_count(dev) < 1)
    return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (B + kTile - 1) / kTile;
  const int slots = per_sm[dev] * sm_count(dev);
  Img im;
  memcpy(im.m, meta, sizeof im.m);
  kernel<<<n_tiles < slots ? n_tiles : slots, NT, smem, stream>>>(
      obs, B, image, im, noise, ld_noise, out, ld_out, logp, ld_logp,
      max_action);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------ run-time widths
// Actors without an instance (any (nin, ng, nh, nact); hidden_num 2) run
// emlp_actor_any_kernel.  Bound on an H100: the operations, ~0.19 GFLOP at
// (15, 73, 64, 4) and 4096 rows (~2.9 us at the 67 TFLOP/s fp32 peak);
// what holds it is one tile's work on one SM (4096 rows are 128 tiles):
// each nonzero a warp sums is ~11 instructions (its entry, a broadcast;
// the tile's two lin values and their addresses; two float ops), issue-
// bound at ~2 x 5949 x 11 / 4 cycles a 32-row tile at agent 0, and at few
// rows each warp's chain of dependent loads.  The design:
//   - A block takes 32-row tiles (lane = row) with NW warps (4-32, one a
//     segment up to 32: emlp_actor.py rt_warps), so a tile's chains are
//     short at 10 rows too; the grid is at most as many blocks as fit the
//     SMs at once, each looping over its tiles.
//   - The bilinear form by index-fixed segments: each output's nonzeros
//     cut into runs of at most RT_SEG (256) entries at fixed positions,
//     dealt to the warps by the host's plan (longest first to the
//     least-loaded warp: emlp_actor.py rt_plan).  A warp sums a segment's
//     nonzeros in order, q += v lin_j lin_i (the instances' expression),
//     each batch of 8 entries issuing its loads (the entries, then both
//     factors) before its sums, and stores q to the segment's slot in
//     shared memory ([slot][row]).
//   - The gate step adds an output's slots in slot order (its only slot:
//     q as it is), pre = 0.1 q + lin, and h = pre / (1 + exp(-pre[gate]))
//     straight from the slots (pre is not stored).
//   - At few rows (the tiles' clusters fit the SMs at once) and where a
//     network block has 1024 nonzeros or more, a cluster of 8 blocks
//     shares each tile: every block runs the dense steps, its warps a
//     share of the segments, and the gate reads each slot from the block
//     that owns it through distributed shared memory (emlp_actor.py
//     _launch_any picks the cluster size).
//   - The image (fold_actor's words) is copied to shared memory where it
//     fits beside the tile, the first network block's sections in one
//     cp.async group and the rest in a second, so the second block's
//     weights land while the first is computed; else it is read from
//     global memory.  The plan (the segments) and the tile's vectors
//     (obs, lin, h, the slots) sit in shared memory, or past what a block
//     holds the plan is read from global memory and the tile from a region
//     of a global scratch per block; past ng = 1986 the entries hold
//     coordinates (mul).
// Every sum has one fixed order (by the index and RT_SEG, not by the warps
// or the placement), so a rerun, and the image or the tile in global
// memory, repeat the bits.  Each lin output's terms in input order then
// the bias, each nonzero's term, the gate and the head are the instances'
// expressions; where an output's nonzeros span two segments their sums
// are added in another order than the instances' (within 1e-5 of them),
// else the result is the instance's bit for bit.
constexpr int kRtMaxWarps = 32;
constexpr int kRtBatch = 8;      // entries whose loads go first

// The segment plan of the two network blocks (emlp_actor.py: rt_plan):
// offsets into the plan ints (each a multiple of 4) of, per block, cseg
// (ng + 1: each output's first slot), wptr (warps + 1: each warp's first
// list position, over the cluster's C NW warps), wlist (each warp's slots
// in order), seg (2 a slot: its entries [e0, e1) in the ent section) and
// owner (each slot's block in the cluster).
struct RtPlan {
  int cseg[2], wptr[2], wlist[2], seg[2], owner[2];
};

__device__ __forceinline__ void linear_any(const float* xt, int ni, int ng,
                                           const float* Wt, const float* b,
                                           float* ls, int warp, int lane,
                                           int nw) {
  const int ngp = round4(ng);
  for (int q4 = warp; q4 < ngp / 4; q4 += nw) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < ni; ++k) {
      const float xv = xt[k * kPitch + lane];
      const float4 w = reinterpret_cast<const float4*>(Wt + k * ngp)[q4];
      a0 = fmaf(xv, w.x, a0);
      a1 = fmaf(xv, w.y, a1);
      a2 = fmaf(xv, w.z, a2);
      a3 = fmaf(xv, w.w, a3);
    }
    const float4 bb = reinterpret_cast<const float4*>(b)[q4];
    const int o = 4 * q4;
    ls[o * kPitch + lane] = a0 + bb.x;
    if (o + 1 < ng) ls[(o + 1) * kPitch + lane] = a1 + bb.y;
    if (o + 2 < ng) ls[(o + 2) * kPitch + lane] = a2 + bb.z;
    if (o + 3 < ng) ls[(o + 3) * kPitch + lane] = a3 + bb.w;
  }
}

// Warp vw's segments (of the cluster's C NW warps) of block blk's bilinear
// form: each segment's q, its nonzeros v lin_j lin_i in order (the
// instances' expression), to its slot sp[slot][row]; each batch of kRtBatch
// entries issues its loads (the entries, then both factors) before its
// sums.  MUL: the entries' coordinate scale (1: tile offsets), else mul.
template <int MUL>
__device__ __forceinline__ void bilinear_rt(const float* ls, float* sp,
                                            const int2* ent, const int* pl,
                                            const RtPlan& rp, int blk, int vw,
                                            int lane, int mul) {
  const int m = MUL ? MUL : mul;
  const int* wptr = pl + rp.wptr[blk];
  const int* wlist = pl + rp.wlist[blk];
  const int* seg = pl + rp.seg[blk];
  const float* lr = ls + lane;
  const int w1 = wptr[vw + 1];
  for (int w = wptr[vw]; w < w1; ++w) {
    const int s = wlist[w];
    int e = seg[2 * s];
    const int e1 = seg[2 * s + 1];
    float q = 0.0f;
    for (; e + kRtBatch <= e1; e += kRtBatch) {
      int2 en[kRtBatch];
      float a[kRtBatch], b[kRtBatch];
#pragma unroll
      for (int u = 0; u < kRtBatch; ++u) en[u] = ent[e + u];
#pragma unroll
      for (int u = 0; u < kRtBatch; ++u) {
        a[u] = lr[((unsigned)en[u].x >> 16) * m];
        b[u] = lr[(en[u].x & 0xffff) * m];
      }
#pragma unroll
      for (int u = 0; u < kRtBatch; ++u)
        q = fmaf(__int_as_float(en[u].y) * a[u], b[u], q);
    }
    for (; e < e1; ++e) {
      const int2 en = ent[e];
      q = fmaf(__int_as_float(en.y) * lr[((unsigned)en.x >> 16) * m],
               lr[(en.x & 0xffff) * m], q);
    }
    sp[s * kPitch + lane] = q;
  }
}

// slot s at row r: this block's, or its owner's in the cluster (C > 1)
__device__ __forceinline__ float rt_slot(const float* sp, const int* owner,
                                         int s, int r, int C) {
  return C == 1 ? sp[s * kPitch + r]
                : cluster::load_peer(sp + s * kPitch + r, owner[s]);
}

// pre of coordinate c at row r: its slots in order, then 0.1 q + lin
__device__ __forceinline__ float rt_pre(const float* ls, const float* sp,
                                        const int* cseg, const int* owner,
                                        int c, int r, int C) {
  const int s0 = cseg[c], s1 = cseg[c + 1];
  float q = 0.0f;
  if (s0 < s1) {
    q = rt_slot(sp, owner, s0, r, C);
    for (int s = s0 + 1; s < s1; ++s) q += rt_slot(sp, owner, s, r, C);
  }
  return 0.1f * q + ls[c * kPitch + r];
}

// h = pre[:nh] * sigmoid(pre[gate]) for the tile, (coordinate, row) pairs
__device__ __forceinline__ void gate_rt(const float* ls, const float* sp,
                                        const int* cseg, const int* owner,
                                        const int* g, float* hs, int nh,
                                        int t, int nt, int C) {
  for (int q = t; q < nh * kTile; q += nt) {
    const int k = q >> 5, r = q & 31;
    const float pk = rt_pre(ls, sp, cseg, owner, k, r, C);
    const float pg = rt_pre(ls, sp, cseg, owner, g[k] / kPitch, r, C);
    hs[k * kPitch + r] = pk / (1.0f + expf(-pg));
  }
}

template <int HEAD_KIND>
__device__ __forceinline__ void head_any(
    const float* hs, const float* f, const Img& im, int nh, int nact, int r0,
    int rows, int warp, int lane, int nw, const float* __restrict__ noise,
    int ld_noise, float* __restrict__ out, int ld_out,
    float* __restrict__ logp, int ld_logp, float max_action) {
  if (lane >= rows) return;
  const float* h = hs + lane;
  const size_t row = (size_t)r0 + lane;
  for (int a = warp; a < nact; a += nw) {
    const float* wh = f + im.m[kWh] + a * nh;
    float s = 0.0f;
#pragma unroll 4
    for (int k = 0; k < nh; ++k) s = fmaf(h[k * kPitch], wh[k], s);
    const float mean = s + f[im.m[kBh] + a];
    if (HEAD_KIND == kPPO) {
      ppo::head(mean, f[im.m[kLogStd] + a],
               noise == nullptr ? nullptr : noise + row * ld_noise + a,
               max_action, out + row * ld_out + a, logp + row * ld_logp + a);
      continue;
    }
    float act = mean;
    if (HEAD_KIND == kGauss && noise != nullptr) {
      const float* wl = f + im.m[kWl] + a * nh;
      float l = 0.0f;
#pragma unroll 4
      for (int k = 0; k < nh; ++k) l = fmaf(h[k * kPitch], wl[k], l);
      const float ls = fminf(fmaxf(l + f[im.m[kBl] + a], -20.0f), 2.0f);
      act = mean + expf(ls) * noise[row * ld_noise + a];
    }
    out[row * ld_out + a] = tanhf(act);
  }
}

// floats of one tile's obs, lin, h and two sets (a network block each) of
// `slots` segment slots
__host__ __device__ inline size_t tile_floats(int nin, int ng, int nh,
                                              int slots) {
  return (size_t)(nin + ng + nh + 2 * slots) * kPitch;
}

// STAGED: the image, the plan and the tile in shared memory (the pointers
// known to be shared) and the entries holding tile offsets; else the image
// may be in global memory, the plan and the tile too, and the entries may
// hold coordinates (generic pointers, mul).  A cluster of C blocks shares
// each tile: every block stages the image and the tile, computes the
// linear layers, the gates and (rank 0) the head, and sums its warps'
// segments (the plan's warps w C + rank, so that the longest segments,
// dealt first, spread over the blocks); the gate reads
// a slot from its owner through distributed shared memory after a cluster
// barrier.  Each network block has its own slots, so a block rewrites a set
// only after the next barrier, which its peers pass once they have read it.
template <int HEAD_KIND, bool STAGED>
__global__ void __launch_bounds__(kRtMaxWarps * 32)
emlp_actor_any_kernel(const float* __restrict__ obs, int B, int nin, int ng,
                      int nh, int nact, const int* __restrict__ image,
                      Img im, int mul, int stage_image,
                      const int* __restrict__ plan, int plan_words,
                      RtPlan rp, int slots, float* __restrict__ scratch,
                      const float* __restrict__ noise, int ld_noise,
                      float* __restrict__ out, int ld_out,
                      float* __restrict__ logp, int ld_logp,
                      float max_action) {
  extern __shared__ __align__(16) int smem[];
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5;
  const int nw = nt >> 5;
  const int C = (int)cluster::size(), rank = (int)cluster::rank();
  const int words = im.m[kWords];
  const bool staged = STAGED || stage_image;
  const bool local = STAGED || scratch == nullptr;   // plan and tile
  const int* img = staged ? smem : image;
  const float* f = reinterpret_cast<const float*>(img);
  int* spl = smem + (staged ? words : 0);
  const int* pl = local ? spl : plan;
  float* xs = local ? reinterpret_cast<float*>(spl + plan_words)
                    : scratch + blockIdx.x * tile_floats(nin, ng, nh, slots);
  float* ls = xs + nin * kPitch;   // lin [o][row]
  float* hs = ls + ng * kPitch;    // h1, then h2
  float* sp0 = hs + nh * kPitch;   // the segments' q [slot][row], block 0
  const int n_tiles = (B + kTile - 1) / kTile;
  // the first network block's sections and the plan, then the rest: two
  // groups of copies
  const int split = im.m[kBlock + kWt];
  if (staged)
    for (int q = t; q < split / 4; q += nt) cp16(smem + 4 * q, image + 4 * q);
  if (local)
    for (int q = t; q < plan_words / 4; q += nt)
      cp16(spl + 4 * q, plan + 4 * q);
  __pipeline_commit();
  if (staged)
    for (int q = split / 4 + t; q < words / 4; q += nt)
      cp16(smem + 4 * q, image + 4 * q);
  __pipeline_commit();
  for (int tile = blockIdx.x / C; tile < n_tiles; tile += gridDim.x / C) {
    const int r0 = tile * kTile, rows = min(kTile, B - r0);
    // every read of the last tile's xs and hs precedes this barrier
    __syncthreads();
    for (int q = t; q < rows * nin; q += nt) {
      const int r = q / nin;
      xs[(q - r * nin) * kPitch + r] = obs[(size_t)r0 * nin + q];
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    for (int blk = 0; blk < 2; ++blk) {
      const int* m = im.m + kBlock * blk;
      float* sp = sp0 + blk * slots * kPitch;
      linear_any(blk == 0 ? xs : hs, blk == 0 ? nin : nh, ng, f + m[kWt],
                 f + m[kB], ls, warp, lane, nw);
      __syncthreads();
      bilinear_rt<STAGED ? 1 : 0>(
          ls, sp, reinterpret_cast<const int2*>(img + m[kEnt]), pl, rp, blk,
          warp * C + rank, lane, mul);
      // every slot of the cluster written and visible
      if (C > 1) {
        cluster::arrive();
        cluster::wait();
      } else {
        __syncthreads();
      }
      gate_rt(ls, sp, pl + rp.cseg[blk], pl + rp.owner[blk], img + m[kGate],
              hs, nh, t, nt, C);
      // the second block's image sections (the first tile), the gate's h
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    if (rank == 0)
      head_any<HEAD_KIND>(hs, f, im, nh, nact, r0, rows, warp, lane, nw,
                          noise, ld_noise, out, ld_out, logp, ld_logp,
                          max_action);
  }
  // every peer's reads of this block's slots done before it exits
  if (C > 1) {
    cluster::arrive();
    cluster::wait();
  }
}

// Every launch goes through cudaLaunchKernelEx with a cluster shape (1 block
// a tile included), so one kernel is never launched both with and without
// a cluster dimension.
template <int HEAD_KIND, bool STAGED>
int launch_rt(const float* obs, int B, const int* image, const int* meta,
              const float* noise, int ld_noise, float* out, int ld_out,
              float* logp, int ld_logp, float max_action, int nin, int ng,
              int nh, int nact, int mul, int stage_image, const int* plan,
              int plan_words, const RtPlan& rp, int slots, int warps,
              int csize, float* scratch, int scratch_blocks,
              cudaStream_t stream) {
  constexpr auto kernel = emlp_actor_any_kernel<HEAD_KIND, STAGED>;
  const int nt = warps * 32;
  const size_t smem =
      (stage_image ? (size_t)meta[kWords] * 4 : 0) +
      (scratch != nullptr
           ? 0
           : (tile_floats(nin, ng, nh, slots) + (size_t)plan_words) * 4);
  const int n_tiles = (B + kTile - 1) / kTile;
  int grid = n_tiles;
  if (csize == 1) {
    // as many blocks as fit the SMs at once, each looping over its tiles
    cudaError_t e = cluster::allow<kernel>(1, smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1 || sm_count(dev) < 1)
      return (int)cudaErrorInvalidConfiguration;
    grid = per_sm * sm_count(dev);
    if (scratch != nullptr && grid > scratch_blocks) grid = scratch_blocks;
    if (grid > n_tiles) grid = n_tiles;
  }
  Img im;
  memcpy(im.m, meta, sizeof im.m);
  // csize > 1: a cluster of csize blocks a tile, one wave (the host asks for
  // it only where the tiles' clusters fit the SMs at once)
  return (int)cluster::launch<kernel>(
      grid * csize, nt, csize, smem, stream, obs, B, nin, ng, nh, nact, image,
      im, mul, stage_image, plan, plan_words, rp, slots, scratch, noise,
      ld_noise, out, ld_out, logp, ld_logp, max_action);
}

template <int HEAD_KIND>
int launch_any(const float* obs, int B, const int* image, const int* meta,
               const float* noise, int ld_noise, float* out, int ld_out,
               float* logp, int ld_logp, float max_action, int nin, int ng,
               int nh, int nact, int mul, int stage_image, const int* plan,
               int plan_words, const int* plan_meta, int slots, int warps,
               int csize, float* scratch, int scratch_blocks,
               cudaStream_t stream) {
  if (meta[kWords] <= 0 || (meta[kWords] & 3) != 0 ||
      (mul != 1 && mul != kPitch) || plan == nullptr || plan_words <= 0 ||
      (plan_words & 3) != 0 || slots < 0 || warps < 1 ||
      warps > kRtMaxWarps || csize < 1 || csize > 8 ||
      (csize > 1 && scratch != nullptr) ||
      (scratch != nullptr && scratch_blocks < 1))
    return (int)cudaErrorInvalidValue;
  RtPlan rp;
  memcpy(&rp, plan_meta, sizeof rp);
  if (stage_image && scratch == nullptr && mul == 1)
    return launch_rt<HEAD_KIND, true>(
        obs, B, image, meta, noise, ld_noise, out, ld_out, logp, ld_logp,
        max_action, nin, ng, nh, nact, mul, stage_image, plan, plan_words, rp,
        slots, warps, csize, scratch, scratch_blocks, stream);
  return launch_rt<HEAD_KIND, false>(
      obs, B, image, meta, noise, ld_noise, out, ld_out, logp, ld_logp,
      max_action, nin, ng, nh, nact, mul, stage_image, plan, plan_words, rp,
      slots, warps, csize, scratch, scratch_blocks, stream);
}

// The built instances (nin, ng, nh, nact): the flagship MODUL actors
// (agents 0 and 1) and the MONO actor.
#define EMLP_ACTOR_INSTANCES(X) X(15, 18, 16, 4) X(3, 7, 4, 1) X(23, 18, 16, 4)

template <int HEAD_KIND>
int dispatch(const float* o, int B, const int* img, const int* meta,
             const float* nz, int ld_noise, float* y, int ld_out, float* lp,
             int ld_logp, float max_action, int nin, int ng, int nh, int nact,
             cudaStream_t s) {
#define X(a, b, c, d)                                                    \
  if (nin == a && ng == b && nh == c && nact == d)                       \
    return launch<a, b, c, d, HEAD_KIND>(o, B, img, meta, nz, ld_noise, y, \
                                         ld_out, lp, ld_logp, max_action, s);
  EMLP_ACTOR_INSTANCES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The geometry the host folds for: 0 rows a tile, 1 the tiles' pitch, 2 the
// meta's length (a launch checks the meta's warps against its instance's).
extern "C" int emlp_actor_geometry(int which) {
  return which == 0 ? kTile : which == 1 ? kPitch : kMeta;
}

// Dynamic shared memory of a launch (bytes) with the image meta describes;
// 0 for dims without an instance.
extern "C" long long emlp_actor_smem(int nin, int ng, int nh, int nact,
                                     const int* meta) {
#define X(a, b, c, d)                       \
  if (nin == a && ng == b && nh == c && nact == d) \
    return (long long)smem_of<a, b, c>(meta);
  EMLP_ACTOR_INSTANCES(X)
#undef X
  return 0;
}

// head: 0 = the deterministic tanh head (K3), 1 = the Gaussian head (K9),
// 2 = the PPO head (K11); image: fold_actor's words on the device, meta
// (host, kMeta ints) its section offsets; noise (B, nact) with row stride
// ld_noise, or null for the deterministic action; logp (B, nact) with row
// stride ld_logp and max_action are read by the PPO head only.
extern "C" int emlp_actor_launch(const void* obs, int B, const void* image,
                                 const int* meta, const void* noise,
                                 int ld_noise, void* out, int ld_out,
                                 void* logp, int ld_logp, float max_action,
                                 int nin, int ng, int nh, int nact, int head,
                                 void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const float* o = (const float*)obs;
  const int* img = (const int*)image;
  const float* nz = (const float*)noise;
  float* y = (float*)out;
  float* lp = (float*)logp;
  cudaStream_t s = (cudaStream_t)stream;
  if (head == kTanh)
    return dispatch<kTanh>(o, B, img, meta, nullptr, 0, y, ld_out, nullptr, 0,
                           1.0f, nin, ng, nh, nact, s);
  if (head == kGauss)
    return dispatch<kGauss>(o, B, img, meta, nz, ld_noise, y, ld_out, nullptr,
                            0, 1.0f, nin, ng, nh, nact, s);
  if (head == kPPO) {
    if (lp == nullptr) return (int)cudaErrorInvalidValue;
    return dispatch<kPPO>(o, B, img, meta, nz, ld_noise, y, ld_out, lp,
                          ld_logp, max_action, nin, ng, nh, nact, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Run-time widths (any dims): as emlp_actor_launch, plus mul (1: the image's
// nonzeros hold tile offsets; 33: coordinates), stage_image (1: copy the
// image to shared memory), the segment plan (plan: its plan_words ints on
// the device, staged with the tile; plan_meta: the 10 offsets of RtPlan,
// host; slots: the larger block's segment count), warps a block, the
// blocks a cluster shares a tile with (1-8; the plan dealt over their
// warps; one wave of clusters), and scratch (null: the plan and the tile
// in shared memory; else, with a cluster of 1, scratch_blocks regions of
// (nin + ng + nh + 2 slots) x 33 floats in global memory, one a block, the
// plan read where it is).
extern "C" int emlp_actor_any_launch(const void* obs, int B,
                                     const void* image, const int* meta,
                                     const void* noise, int ld_noise,
                                     void* out, int ld_out, void* logp,
                                     int ld_logp, float max_action, int nin,
                                     int ng, int nh, int nact, int head,
                                     int mul, int stage_image,
                                     const void* plan, int plan_words,
                                     const int* plan_meta, int slots,
                                     int warps, int cluster_size,
                                     void* scratch, int scratch_blocks,
                                     void* stream) {
  if (B <= 0 || nin <= 0 || ng <= 0 || nh <= 0 || nact <= 0)
    return (int)cudaErrorInvalidValue;
  const float* o = (const float*)obs;
  const int* img = (const int*)image;
  const int* pl = (const int*)plan;
  const float* nz = (const float*)noise;
  float* y = (float*)out;
  float* lp = (float*)logp;
  float* sc = (float*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  if (head == kTanh)
    return launch_any<kTanh>(o, B, img, meta, nullptr, 0, y, ld_out, nullptr,
                             0, 1.0f, nin, ng, nh, nact, mul, stage_image, pl,
                             plan_words, plan_meta, slots, warps,
                             cluster_size, sc, scratch_blocks, s);
  if (head == kGauss)
    return launch_any<kGauss>(o, B, img, meta, nz, ld_noise, y, ld_out,
                              nullptr, 0, 1.0f, nin, ng, nh, nact, mul,
                              stage_image, pl, plan_words, plan_meta, slots,
                              warps, cluster_size, sc, scratch_blocks, s);
  if (head == kPPO) {
    if (lp == nullptr) return (int)cudaErrorInvalidValue;
    return launch_any<kPPO>(o, B, img, meta, nz, ld_noise, y, ld_out, lp,
                            ld_logp, max_action, nin, ng, nh, nact, mul,
                            stage_image, pl, plan_words, plan_meta, slots,
                            warps, cluster_size, sc, scratch_blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
