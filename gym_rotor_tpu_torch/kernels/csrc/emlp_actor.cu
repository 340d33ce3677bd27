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
// emlp_actor_any_kernel: the instances' steps and arithmetic with the
// sizes as arguments (so each output's sums keep their order and an
// actor's bits match the instance's where one exists), and three places
// for what an instance keeps in shared memory, chosen by the host
// (emlp_actor.py: any_plan) from what fits a block:
//   the image: copied to shared memory as the instances copy it, or read
//     from global memory where it does not fit (the same words, the
//     layout image_layout states: W_eff transposed and b_eff as float4s,
//     the plan and its nonzeros as int2 (offsets, v), the head);
//   the tile's obs, lin, pre and h: in shared memory, or where even they
//     do not fit (nin + 2 ng + nh > 1761 coordinates), a region of a
//     global scratch per block, the same field-major [c][row] layout;
//   the nonzeros' tile offsets: packed j * 33 << 16 | i * 33 as the
//     instances read them, or past ng = 1986 (where that overflows 16
//     bits) the coordinates j << 16 | i, which the kernel scales (mul).
// The obs of a tile are loaded by plain loads at its start (no copy in
// flight across tiles); every step ends in a barrier as the instances'.
template <int NW_MAX>
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

__device__ __forceinline__ void bilinear_any(const float* ls, float* ps,
                                             const int* img, const Img& im,
                                             int blk, int warp, int lane,
                                             int mul) {
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
      q = fmaf(__int_as_float(en.y) * lr[((unsigned)en.x >> 16) * mul],
               lr[(en.x & 0xffff) * mul], q);
    }
    ps[o * kPitch + lane] = 0.1f * q + lr[o * kPitch];
  }
}

__device__ __forceinline__ void gate_any(const float* ps, const int* g,
                                         float* hs, int nh, int t, int nt) {
  for (int q = t; q < nh * kTile; q += nt) {
    const int k = q >> 5, r = q & 31;
    hs[k * kPitch + r] = ps[k * kPitch + r] / (1.0f + expf(-ps[g[k] + r]));
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

// floats of one tile's obs, lin, pre and h
__host__ __device__ inline size_t tile_floats(int nin, int ng, int nh) {
  return (size_t)(nin + 2 * ng + nh) * kPitch;
}

template <int HEAD_KIND>
__global__ void __launch_bounds__(256)
emlp_actor_any_kernel(const float* __restrict__ obs, int B, int nin, int ng,
                      int nh, int nact, const int* __restrict__ image,
                      Img im, int mul, int stage_image,
                      float* __restrict__ scratch,
                      const float* __restrict__ noise, int ld_noise,
                      float* __restrict__ out, int ld_out,
                      float* __restrict__ logp, int ld_logp,
                      float max_action) {
  extern __shared__ __align__(16) int smem[];
  const int nw = im.m[kWarps], nt = nw * 32;
  const int words = im.m[kWords];
  const int* img = stage_image ? smem : image;
  const float* f = reinterpret_cast<const float*>(img);
  float* xs = scratch != nullptr
                  ? scratch + blockIdx.x * tile_floats(nin, ng, nh)
                  : reinterpret_cast<float*>(smem + (stage_image ? words : 0));
  float* ls = xs + nin * kPitch;   // lin [o][row]
  float* ps = ls + ng * kPitch;    // pre
  float* hs = ps + ng * kPitch;    // h1, then h2
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_tiles = (B + kTile - 1) / kTile;
  if (stage_image) {
    for (int q = t; q < words / 4; q += nt) cp16(smem + 4 * q, image + 4 * q);
    cp_wait();
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kTile, rows = min(kTile, B - r0);
    // every read of the last tile's xs and hs precedes this barrier
    __syncthreads();
    for (int q = t; q < rows * nin; q += nt) {
      const int r = q / nin;
      xs[(q - r * nin) * kPitch + r] = obs[(size_t)r0 * nin + q];
    }
    __syncthreads();
    linear_any<8>(xs, nin, ng, f + im.m[kWt], f + im.m[kB], ls, warp, lane,
                  nw);
    __syncthreads();
    bilinear_any(ls, ps, img, im, 0, warp, lane, mul);
    __syncthreads();
    gate_any(ps, img + im.m[kGate], hs, nh, t, nt);
    __syncthreads();
    linear_any<8>(hs, nh, ng, f + im.m[kBlock + kWt], f + im.m[kBlock + kB],
                  ls, warp, lane, nw);
    __syncthreads();
    bilinear_any(ls, ps, img, im, 1, warp, lane, mul);
    __syncthreads();
    gate_any(ps, img + im.m[kBlock + kGate], hs, nh, t, nt);
    __syncthreads();
    head_any<HEAD_KIND>(hs, f, im, nh, nact, r0, rows, warp, lane, nw, noise,
                        ld_noise, out, ld_out, logp, ld_logp, max_action);
  }
}

template <int HEAD_KIND>
int launch_any(const float* obs, int B, const int* image, const int* meta,
               const float* noise, int ld_noise, float* out, int ld_out,
               float* logp, int ld_logp, float max_action, int nin, int ng,
               int nh, int nact, int mul, int stage_image, float* scratch,
               int scratch_blocks, cudaStream_t stream) {
  static size_t smem_set[kMaxDevices] = {0};
  if ((meta[kWarps] != 4 && meta[kWarps] != 8) || meta[kWords] <= 0 ||
      (meta[kWords] & 3) != 0 || (mul != 1 && mul != kPitch) ||
      (scratch != nullptr && scratch_blocks < 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = emlp_actor_any_kernel<HEAD_KIND>;
  const int nt = meta[kWarps] * 32;
  const size_t smem =
      (stage_image ? (size_t)meta[kWords] * 4 : 0) +
      (scratch != nullptr ? 0 : tile_floats(nin, ng, nh) * 4);
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
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1 || sm_count(dev) < 1)
    return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (B + kTile - 1) / kTile;
  int grid = per_sm * sm_count(dev);
  if (scratch != nullptr && grid > scratch_blocks) grid = scratch_blocks;
  if (grid > n_tiles) grid = n_tiles;
  Img im;
  memcpy(im.m, meta, sizeof im.m);
  kernel<<<grid, nt, smem, stream>>>(obs, B, nin, ng, nh, nact, image, im,
                                     mul, stage_image, scratch, noise,
                                     ld_noise, out, ld_out, logp, ld_logp,
                                     max_action);
  return (int)cudaGetLastError();
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
// image to shared memory) and scratch (null: the tile in shared memory;
// else scratch_blocks regions of (nin + 2 ng + nh) x 33 floats in global
// memory, one a block).
extern "C" int emlp_actor_any_launch(const void* obs, int B,
                                     const void* image, const int* meta,
                                     const void* noise, int ld_noise,
                                     void* out, int ld_out, void* logp,
                                     int ld_logp, float max_action, int nin,
                                     int ng, int nh, int nact, int head,
                                     int mul, int stage_image, void* scratch,
                                     int scratch_blocks, void* stream) {
  if (B <= 0 || nin <= 0 || ng <= 0 || nh <= 0 || nact <= 0)
    return (int)cudaErrorInvalidValue;
  const float* o = (const float*)obs;
  const int* img = (const int*)image;
  const float* nz = (const float*)noise;
  float* y = (float*)out;
  float* lp = (float*)logp;
  float* sc = (float*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  if (head == kTanh)
    return launch_any<kTanh>(o, B, img, meta, nullptr, 0, y, ld_out, nullptr,
                             0, 1.0f, nin, ng, nh, nact, mul, stage_image, sc,
                             scratch_blocks, s);
  if (head == kGauss)
    return launch_any<kGauss>(o, B, img, meta, nz, ld_noise, y, ld_out,
                              nullptr, 0, 1.0f, nin, ng, nh, nact, mul,
                              stage_image, sc, scratch_blocks, s);
  if (head == kPPO) {
    if (lp == nullptr) return (int)cudaErrorInvalidValue;
    return launch_any<kPPO>(o, B, img, meta, nz, ld_noise, y, ld_out, lp,
                            ld_logp, max_action, nin, ng, nh, nact, mul,
                            stage_image, sc, scratch_blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
