// K10 fused with its producer: SAC's actor head on the trunk's last hidden
// activations, the squashed-Gaussian sample and its summed log-prob, forward
// and backward, for Hopper (sm_90a), one launch each.
//
// Replaces gym_rotor_tpu/models/mlp.py:129 sac_sample_with_noise with the
// heads before it (gym_rotor_tpu/models/emlp/zoo.py:169-190 EMLPActorSAC's
// network_head and clipped log_std_linear; models/mlp.py:107-119 ActorSAC's
// mean and clipped log_std Dense) and their autodiff in the SAC actor loss,
// which XLA fused into the actor-loss program on the TPU.  Plain twins:
// gym_rotor_tpu_torch/kernels/sac_sample.py:sac_head_plain (the torch chain:
// the two heads, the clamp, sac_sample_with_noise) and
// sac_head_backward_plain.
//
// Bound on an H100: the bytes, and few.  Forward, per row of H hidden floats
// and A <= 4 actions: reads h and the noise (4 (H + A) bytes), writes the
// action and the log-prob (4 A + 4), and the heads' 2 A (H + 1) weights once;
// at the actor loss's 1024 rows of H = 16, A = 4: ~115 KB, ~0.03 us at
// 3.35 TB/s; the 4 A H flops of the heads and ~20 flops an action of the
// sample are less.  Backward: h, the noise and both cotangents in, g_h
// and the heads' weight gradients out: ~168 KB, ~0.05 us.  A launch of
// this size is held by the launch itself and, in the backward, by the
// cross-block sum's fence and ticket.
//
// Design: a row on A lanes, one action a lane (3 actions on 4 lanes, one
// idle), so a row's lanes are an aligned group of a warp; 128 threads a
// block (32 rows at 4 actions, 128 at 1).  Each thread loads its noise (and
// in the backward its cotangents) first, then the block stages both heads'
// weights (through their strides: the EMLP mean head's folded W_eff is (A,
// H), a flax Dense kernel (H, A); neither is transposed per call) and its
// rows' tile of [h | 1] (pitch H + 1, or H + 2 to keep it odd) in shared
// memory, every copy a cp.async in flight at once.  Lane a computes action
// a's two dot products in k order (sac_head.cuh), the clip and the draw;
// the row's log-prob is the lanes' terms added in action order through
// shuffles (the order of the earlier one-thread-a-row kernel).  The backward recomputes the forward, then the
// sample's derivative, masks g_log_std where the clip held, keeps G =
// [g_mean | g_log_std] in shared memory (and writes it out only for
// checks, when given a pointer for it) and shares the row's
// (g_mean, g_log_std) over its lanes by shuffles.  The heads' weight and
// bias gradients, M = [h | 1]^T G ((H + 1) x 2 A; the tile's column H is
// the 1), are summed in the same launch: each block its rows (an entry
// of M on C lanes, each lane a run of rows in row order, the runs' sums
// added in lane order); with more than one block, each writes its partial
// M, fences and takes a ticket (an atomic counter per device that the
// wrapper owns, kernels/sac_sample.py _ticket) and, while it travels,
// writes g_h = g_mean W_m^T + g_log_std W_ls^T at each lane's share of the
// columns (each sum in a order, then the two added); the block that takes
// the last ticket adds the partials in block order (32 loads in flight a
// thread) and re-arms the counter.  So a rerun repeats its bits.
// H is a template parameter for the train paths' heads (16 hidden floats
// and 4 actions, 4 and 1), a run-time loop bound for others (other actor
// widths).  A head wider than 64 stages its tile in chunks of 65 columns of
// [h | 1]: the dot products carry their sums from chunk to chunk (the same
// k order), and the backward stages the chunks again for M, the last one
// first; past 48 KB of shared memory a launch opts in to more (up to the
// card's 227 KB: H up to ~7000 at 4 actions, ~24000 at 1).
// Built with -fmad=false so the products and sums round like the plain twin.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sac_head.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 65;       // columns of [h | 1] a staged tile
constexpr unsigned kFull = 0xffffffffu;

// lanes a row: one an action, 3 actions on 4
template <int A>
struct Lanes {
  static constexpr int L = A == 3 ? 4 : A;
  static constexpr int kRows = kThreads / L;   // rows a block
};

struct Head {
  const float* wm;   // mean head, element (k, a) at wm[k * wm_k + a * wm_a]
  int wm_k, wm_a;
  const float* bm;
  const float* wl;   // log-std head, element (k, a) at wl[k * wl_k + a * wl_a]
  int wl_k, wl_a;
  const float* bl;
};

// The block's rows of [h | 1] (H + 1 columns, the last the ones) pass
// through shared memory in chunks of KT columns (the last may be
// narrower): one chunk up to H = 64, so the train paths' heads stage their
// tile once.  P: the tile's pitch, odd.
struct Tile {
  int KT, P, chunks;
};

__host__ __device__ constexpr Tile tile_of(int H) {
  const int kt = H + 1 < kMaxK ? H + 1 : kMaxK;
  return Tile{kt, kt | 1, (H + kt) / kt};
}

// Shared memory: Wm [k][a], Wl [k][a], bm, bl, then the tile, then (the
// backward) the rows' [g_mean | g_log_std].
__host__ __device__ inline int smem_floats(int H, int A) {
  const int rows = kThreads / (A == 3 ? 4 : A);
  return 2 * H * A + 2 * A + rows * tile_of(H).P + rows * 2 * A;
}

// lanes an entry of M takes in the backward's block sum: the most, up to
// 32, that keep every entry in one pass of the block's threads
__host__ __device__ constexpr int lanes_an_entry(int entries) {
  int c = 1;
  while (c < 32 && 2 * c * entries <= kThreads) c *= 2;
  return c;
}

__host__ __device__ inline int head_blocks(int R, int A) {
  const int rows = kThreads / (A == 3 ? 4 : A);
  return (R + rows - 1) / rows;
}

// Both heads into shared memory by cp.async, waited for with the first
// chunk of the tile.
template <int A>
__device__ __forceinline__ void stage_heads(float* sm, int H, const Head& w) {
  float* Wm = sm;
  float* Wl = Wm + H * A;
  float* bm = Wl + H * A;
  float* bl = bm + A;
  const int t = threadIdx.x;
  for (int i = t; i < H * A; i += kThreads) {
    const int k = i / A, a = i - k * A;
    __pipeline_memcpy_async(Wm + i, w.wm + k * w.wm_k + a * w.wm_a, 4);
    __pipeline_memcpy_async(Wl + i, w.wl + k * w.wl_k + a * w.wl_a, 4);
  }
  if (t < A) {
    __pipeline_memcpy_async(bm + t, w.bm + t, 4);
    __pipeline_memcpy_async(bl + t, w.bl + t, 4);
  }
}

// Chunk c of the block's [h | 1] tile into hs (column j of the chunk is
// column c KT + j of [h | 1]), by cp.async, every copy in flight at once;
// then the wait and a block barrier.  Returns the chunk's columns.
__device__ __forceinline__ int stage_tile(float* hs,
                                          const float* __restrict__ h, int H,
                                          int r0, int nrow, const Tile& tl,
                                          int c) {
  const int k0 = c * tl.KT, nk = min(tl.KT, H + 1 - k0);
  const int t = threadIdx.x;
  if (tl.chunks == 1) {   // the whole rows, then the ones column
    const float* src = h + (size_t)r0 * H;
    for (int i = t; i < nrow * H; i += kThreads) {
      const int r = i / H;
      __pipeline_memcpy_async(hs + r * tl.P + (i - r * H), src + i, 4);
    }
    for (int r = t; r < nrow; r += kThreads) hs[r * tl.P + H] = 1.0f;
  } else {
    for (int i = t; i < nrow * nk; i += kThreads) {
      const int r = i / nk, j = i - r * nk, k = k0 + j;
      if (k < H)
        __pipeline_memcpy_async(hs + r * tl.P + j,
                                h + (size_t)(r0 + r) * H + k, 4);
      else
        hs[r * tl.P + j] = 1.0f;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  return nk;
}

// Action a's mean and pre-clip log-std (the live lanes), the tile's chunks
// staged one after another (one for the train paths' heads); the last one
// stays staged.
template <int HT, int A>
__device__ __forceinline__ void heads(float* sm, float* hs,
                                     const float* __restrict__ h, int H,
                                     int r0, int nrow, int row, int a,
                                     bool live, float& m, float& pre) {
  const Tile tl = tile_of(H);
  const float* Wm = sm;
  const float* Wl = Wm + H * A;
  for (int c = 0; c < tl.chunks; ++c) {
    if (c > 0) __syncthreads();   // the last chunk read
    const int nk = stage_tile(hs, h, H, r0, nrow, tl, c);
    const int k0 = c * tl.KT;
    if (live)
      sac::head_dots<HT>(hs + row * tl.P, k0, min(k0 + nk, H), Wm, Wl, A, a,
                         m, pre);
  }
  if (live) {
    m = m + Wl[H * A + a];          // b_m
    pre = pre + Wl[H * A + A + a];  // b_ls
  }
}

template <int HT, int A>
__global__ void __launch_bounds__(kThreads)
sac_head_fwd_kernel(const float* __restrict__ h, int R, int Hrt, Head w,
                    const float* __restrict__ noise,
                    float* __restrict__ action, float* __restrict__ logp) {
  constexpr int L = Lanes<A>::L, RB = Lanes<A>::kRows;
  const int H = HT > 0 ? HT : Hrt;
  extern __shared__ float sm[];
  const int t = threadIdx.x, row = t / L, a = t - row * L;
  const int r0 = blockIdx.x * RB, nrow = min(RB, R - r0);
  const bool live = row < nrow && a < A;
  const size_t o = (size_t)(r0 + row) * A + a;
  const float n = live ? __ldg(noise + o) : 0.0f;
  stage_heads<A>(sm, H, w);
  float m = 0.0f, pre = 0.0f, lt = 0.0f;
  heads<HT, A>(sm, sm + 2 * H * A + 2 * A, h, H, r0, nrow, row, a, live, m,
               pre);
  if (live) {
    const float l = sac::clip_log_std(pre);
    const sac::Draw d = sac::draw(m, l, n);
    lt = sac::log_prob(m, l, d);
    action[o] = d.a;
  }
  // the row's log-prob: its lanes' terms added in action order
  const int base = (t & 31) & ~(L - 1);
  float lp = 0.0f;
#pragma unroll
  for (int b = 0; b < A; ++b) lp += __shfl_sync(kFull, lt, base + b);
  if (a == 0 && row < nrow) logp[r0 + row] = lp;
}

template <int HT, int A>
__global__ void __launch_bounds__(kThreads)
sac_head_bwd_kernel(const float* __restrict__ g_action,
                    const float* __restrict__ g_logp,
                    const float* __restrict__ h, int R, int Hrt, Head w,
                    const float* __restrict__ noise,
                    float* __restrict__ g_h, float* __restrict__ G,
                    float* __restrict__ partial, float* __restrict__ M,
                    unsigned* __restrict__ ticket) {
  constexpr int L = Lanes<A>::L, RB = Lanes<A>::kRows, A2 = 2 * A;
  const int H = HT > 0 ? HT : Hrt;
  const Tile tl = tile_of(H);
  extern __shared__ float sm[];
  __shared__ bool last;
  const int t = threadIdx.x, row = t / L, a = t - row * L;
  const int r0 = blockIdx.x * RB, nrow = min(RB, R - r0);
  const bool in_row = row < nrow, live = in_row && a < A;
  const size_t o = (size_t)(r0 + row) * A + a;
  const float n = live ? __ldg(noise + o) : 0.0f;
  const float ga = live ? __ldg(g_action + o) : 0.0f;
  const float glp = in_row ? __ldg(g_logp + r0 + row) : 0.0f;
  stage_heads<A>(sm, H, w);
  float* hs = sm + 2 * H * A + 2 * A;
  float* Gs = hs + RB * tl.P;
  float m = 0.0f, pre = 0.0f;
  heads<HT, A>(sm, hs, h, H, r0, nrow, row, a, live, m, pre);

  float gm = 0.0f, gl = 0.0f;
  if (live) {
    sac::sample_backward(ga, glp, m, sac::clip_log_std(pre), n, &gm, &gl);
    gl = sac::in_clip(pre) ? gl : 0.0f;
    if (G != nullptr) {   // [g_mean | g_log_std], for checks
      float* go = G + (size_t)(r0 + row) * A2;
      go[a] = gm;
      go[A + a] = gl;
    }
    Gs[row * A2 + a] = gm;
    Gs[row * A2 + A + a] = gl;
  }
  // the row's (g_mean, g_log_std) on each of its lanes
  const int base = (t & 31) & ~(L - 1);
  float gmv[A], glv[A];
#pragma unroll
  for (int b = 0; b < A; ++b) {
    gmv[b] = __shfl_sync(kFull, gm, base + b);
    glv[b] = __shfl_sync(kFull, gl, base + b);
  }
  __syncthreads();   // Gs complete

  // the block's M = [h | 1]^T G over its rows, chunk by chunk of the tile
  // (the staged last one first): entry q on C consecutive lanes, lane c
  // its share of the rows in row order, then the C sums in lane order (C,
  // known at compile time, the most lanes an entry that the block's
  // threads allow; 1 for a run-time H)
  constexpr int C = HT > 0 ? lanes_an_entry((HT + 1) * A2) : 1;
  const int NQ = (H + 1) * A2;
  const bool solo = gridDim.x == 1;
  float* dst = solo ? M : partial + (size_t)blockIdx.x * NQ;
  for (int ch = tl.chunks - 1; ch >= 0; --ch) {
    if (ch < tl.chunks - 1) {
      __syncthreads();   // the last chunk read
      stage_tile(hs, h, H, r0, nrow, tl, ch);
    }
    const int NQc = min(tl.KT, H + 1 - ch * tl.KT) * A2;
    float* dc = dst + ch * tl.KT * A2;
    for (int q0 = 0; q0 < NQc * C; q0 += kThreads) {
      const int slot = q0 + t, q = slot / C, c = slot - q * C;
      float s = 0.0f;
      if (q < NQc) {
        const int k = q / A2, j = q - k * A2;
        const int ra = c * nrow / C, rb = (c + 1) * nrow / C;
        if (ra < rb) s = hs[ra * tl.P + k] * Gs[ra * A2 + j];
#pragma unroll 8
        for (int r = ra + 1; r < rb; ++r)
          s = s + hs[r * tl.P + k] * Gs[r * A2 + j];
      }
      if (C > 1) {
        const int lead = (t & 31) & ~(C - 1);
        float tot = __shfl_sync(kFull, s, lead);
#pragma unroll
        for (int b = 1; b < C; ++b)
          tot = tot + __shfl_sync(kFull, s, lead + b);
        s = tot;
      }
      if (q < NQc && c == 0) dc[q] = s;
    }
  }
  if (!solo) {
    __threadfence();
    __syncthreads();
    if (t == 0) {
      last = atomicAdd(ticket, 1u) == gridDim.x - 1;
      __threadfence();
    }
  }

  // g_h, while the ticket travels
  if (in_row) {
    const float* Wm = sm;
    const float* Wl = Wm + H * A;
    float* gr = g_h + (size_t)(r0 + row) * H;
    auto column = [&](int k) {
      float s = gmv[0] * Wm[k * A], u = glv[0] * Wl[k * A];
#pragma unroll
      for (int b = 1; b < A; ++b) {
        s = s + gmv[b] * Wm[k * A + b];
        u = u + glv[b] * Wl[k * A + b];
      }
      gr[k] = s + u;
    };
    if (HT > 0) {
#pragma unroll
      for (int k0 = 0; k0 < HT; k0 += L)
        if (k0 + a < HT) column(k0 + a);
    } else {
      for (int k = a; k < H; k += L) column(k);
    }
  }
  if (solo) return;
  __syncthreads();
  if (!last) return;

  // the last block: M the partials' sum in block order, 32 loads in flight
  const int nb = gridDim.x;
  for (int q = t; q < NQ; q += kThreads) {
    float s = 0.0f;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      float v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        v[u] = b0 + u < nb ? __ldcg(partial + (size_t)(b0 + u) * NQ + q)
                           : 0.0f;
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (b0 + u < nb) s = b0 + u == 0 ? v[u] : s + v[u];
    }
    M[q] = s;
  }
  if (t == 0) *ticket = 0u;
}

// The launch's arguments: the forward reads h, noise and writes out0
// (action), out1 (logp); the backward reads g_action, g_logp too and
// writes out0 (g_h), out1 (G), out2 (M), with partial and ticket.
struct Args {
  const float *g_action, *g_logp, *h, *noise;
  int R, H;
  Head w;
  float *out0, *out1, *out2, *partial;
  unsigned* ticket;
  cudaStream_t st;
};

template <int HT, int A>
int launch(const Args& x, bool backward) {
  const int blocks = head_blocks(x.R, A);
  const size_t smem = sizeof(float) * smem_floats(x.H, A);
  if (smem > 48 * 1024) {   // wide heads: the opt-in shared memory
    const void* k = backward ? (const void*)sac_head_bwd_kernel<HT, A>
                             : (const void*)sac_head_fwd_kernel<HT, A>;
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (backward)
    sac_head_bwd_kernel<HT, A><<<blocks, kThreads, smem, x.st>>>(
        x.g_action, x.g_logp, x.h, x.R, x.H, x.w, x.noise, x.out0, x.out1,
        x.partial, x.out2, x.ticket);
  else
    sac_head_fwd_kernel<HT, A><<<blocks, kThreads, smem, x.st>>>(
        x.h, x.R, x.H, x.w, x.noise, x.out0, x.out1);
  return (int)cudaGetLastError();
}

int dispatch(const Args& x, int A, bool backward) {
  if (x.R <= 0 || x.H <= 0) return (int)cudaErrorInvalidValue;
  // the train paths' heads, H a template parameter
  if (x.H == 16 && A == 4) return launch<16, 4>(x, backward);
  if (x.H == 4 && A == 1) return launch<4, 1>(x, backward);
  switch (A) {
    case 1: return launch<0, 1>(x, backward);
    case 2: return launch<0, 2>(x, backward);
    case 3: return launch<0, 3>(x, backward);
    case 4: return launch<0, 4>(x, backward);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Blocks of a launch at R rows of A actions: the backward's partials are
// that many (H + 1) x 2 A blocks of floats (none with one block).
extern "C" int sac_head_blocks(int R, int A) {
  return A < 1 || A > 4 ? 0 : head_blocks(R, A);
}

// h (R, H), noise and action (R, A) row-major; logp (R,).  wm_k, wm_a: the
// mean head's strides over k and a, in floats; wl_k, wl_a the log-std
// head's.
extern "C" int sac_head_fwd_launch(const void* h, int R, int H, int A,
                                   const void* wm, int wm_k, int wm_a,
                                   const void* bm, const void* wl, int wl_k,
                                   int wl_a, const void* bl,
                                   const void* noise, void* action,
                                   void* logp, void* stream) {
  const Args x{nullptr, nullptr, (const float*)h, (const float*)noise, R, H,
               Head{(const float*)wm, wm_k, wm_a, (const float*)bm,
                    (const float*)wl, wl_k, wl_a, (const float*)bl},
               (float*)action, (float*)logp, nullptr, nullptr, nullptr,
               (cudaStream_t)stream};
  return dispatch(x, A, false);
}

// g_action (R, A), g_logp (R,), then the forward's inputs; writes g_h
// (R, H), G = [g_mean | g_log_std] (R, 2 A), g_log_std zero where the clip
// held (unless G is null: the training path reads only g_h and M), and
// M = [h | 1]^T G ((H + 1) x 2 A).  partial: sac_head_blocks(R,
// A) x (H + 1) x 2 A floats (unused with one block); ticket: a zeroed
// unsigned counter that the launch leaves zeroed, launches that share it
// run one after another.
extern "C" int sac_head_bwd_launch(const void* g_action, const void* g_logp,
                                   const void* h, int R, int H, int A,
                                   const void* wm, int wm_k, int wm_a,
                                   const void* bm, const void* wl, int wl_k,
                                   int wl_a, const void* bl,
                                   const void* noise, void* g_h, void* G,
                                   void* M, void* partial, void* ticket,
                                   void* stream) {
  const Args x{(const float*)g_action, (const float*)g_logp, (const float*)h,
               (const float*)noise, R, H,
               Head{(const float*)wm, wm_k, wm_a, (const float*)bm,
                    (const float*)wl, wl_k, wl_a, (const float*)bl},
               (float*)g_h, (float*)G, (float*)M, (float*)partial,
               (unsigned*)ticket, (cudaStream_t)stream};
  return dispatch(x, A, true);
}
