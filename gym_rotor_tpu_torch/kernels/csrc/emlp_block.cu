// K3 (forward, training widths) and K4 (backward): one EMLP block for
// Hopper (sm_90a), lin = x W_eff^T + b_eff, pre = 0.1 Q(lin) + lin,
// h = pre[:nh] * sigmoid(pre[gate]).
//
// Replaces gym_rotor_tpu/models/emlp/nn.py:431 EMLPBlock (EquivLinear ->
// EquivBiLinear -> GatedNonlinearity) and its autodiff through
// fixed_gather's custom VJP (nn.py:39-81), which XLA fused on the TPU.  Plain
// twins: gym_rotor_tpu_torch/kernels/emlp_block.py:emlp_block_plain and
// emlp_block_backward_plain.
//
// Bound on an H100: the operations, and few.  Agent 1's critic block 1 (62
// in, 123 gated, 9394 nonzeros of Q) at B = 256 is ~2 (7.6k + 14k) flops a
// row, ~11 MFLOP, ~0.2 us at the fp32 peak; its weights and nonzeros are
// ~0.15 MB.  The PPO V critics also run the forward over a whole horizon
// (409 600 rows of [obs; next_obs] in the 4096-env configuration): ~18
// GFLOP for the hidden block, ~0.27 ms at the peak; without autograd it
// reads x and writes h only.  What holds the kernels far above that is the
// sparse form's gathers: each nonzero costs a tile of 32 rows three
// shared-memory loads (the entry and two of the tile's vectors, an SM's
// cycle each) and about nine instructions, so the design spreads the
// nonzeros of a tile over many warps and, at small batches, many SMs.
//
// Layout: a tile of kTile = 32 rows, lane t of every warp on row t; each
// per-row vector of the tile sits in shared memory field-major, [c][row]
// with an odd pitch, so a warp's 32 loads of one coordinate are
// conflict-free, and every warp walks an index whose entries all its lanes
// read at once (a broadcast).  Global memory reaches shared memory through
// asynchronous copies (cp.async), a thread's all in flight at once.  Float32
// FFMA only, no atomics: every sum is taken in a fixed order, so a rerun
// repeats its numbers bit for bit.
//
// Both kernels run a grid of row tiles x groups of coordinates; the host
// plans the groups (emlp_block.py: forward_plan, backward_plan) so that a
// small batch spreads over the SMs (the backward over about two blocks an
// SM), and the forward of a large one loops over its tiles in a persistent
// grid of as many blocks as fit on the SMs at its shared memory.
//
// Forward (one launch).  A group is a run of the gated nonlinearity's atoms
// (output coordinates with their gate coordinates).  A block loads W_eff
// (transposed), b_eff and its group's nonzeros (v with the (j, i) tile
// offsets) once, then per tile: lin for every coordinate with each warp on
// 4 (a float4 of W_eff a step), Q(lin) for its group's outputs with each
// warp on one output's nonzeros (longest first), the gate.  The next tile's x is copied while one is computed.
// lin and pre are written field-major, (ng, B), only when a backward will
// read them (template flag SAVE; null pointers from the wrapper).
//
// Backward (two launches, one for a single group without parameter
// gradients).  A group is a run of coordinates.  Each block
// loads its tile's lin, pre and g_h, forms g_pre for every coordinate (the
// gate's inverse turns the scatter of the gate terms into a gather; where
// gate[k] == k both terms land on k), then g_lin for its coordinates from
// the coordinate-major lists: each coordinate's nonzeros with the output o
// and the partner coordinate, g_lin[c] = g_pre[c] + 0.1 sum v g_pre[o]
// lin[partner] (a nonzero with j == i sits twice in its list).  The lists
// are cut into segments of about equal length, dealt to the warps longest
// first; a warp sums its segments into slots, and one pass adds each
// coordinate's slots in order.  The block writes its group's share of g_x
// (its coordinates' rows of W_eff) and, with parameter gradients, its
// tile's partial sums of g_W and g_b (its coordinates) and g_v (the
// nonzeros whose output is in the group), one parameter per thread in row
// order.  The finishing kernel adds the groups' shares of g_x in group order
// and the tiles' partials in a fixed order.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;
constexpr int kPitch = kTile + 1;
constexpr int kFwdWarps = 16;
constexpr int kBwdWarps = 16;
constexpr int kSumThreads = 256;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The block's static index (BlockSpec.ints), in this order.  "Offsets"
// are a coordinate's place in a field-major tile, c * kPitch, two packed
// as hi << 16 | lo.
struct Ints {
  const int* gate;      // NH: gate source of each output coordinate
  const int* rowptr;    // NG + 1: nonzeros of output o, sorted by o
  const int* ji;        // nnz: j << 16 | i
  const int* o;         // nnz
  const int* ji_off;    // nnz: the offsets of (j, i)
  const int* cl_ptr;    // NG + 1: coordinate-major lists
  const int* cl_off;    // 2 nnz: the offsets of (o, partner)
  const int* cl_e;      // 2 nnz: the nonzero
  const int* ginv_ptr;  // NG + 1: the gate's inverse
  const int* ginv_k;    // NH
};

Ints ints_of(const int* p, int ng, int nh, int nnz) {
  Ints s;
  s.gate = p;
  s.rowptr = s.gate + nh;
  s.ji = s.rowptr + ng + 1;
  s.o = s.ji + nnz;
  s.ji_off = s.o + nnz;
  s.cl_ptr = s.ji_off + nnz;
  s.cl_off = s.cl_ptr + ng + 1;
  s.cl_e = s.cl_off + 2 * nnz;
  s.ginv_ptr = s.cl_e + 2 * nnz;
  s.ginv_k = s.ginv_ptr + ng + 1;
  return s;
}

// A plan (BlockSpec.plan_args): one int tensor on the device and a host
// array of sizes, meta.  Forward: hdr (G x kFwdHdr), then the groups'
// outputs, longest first (NG).  Backward: hdr (G x kBwdHdr), the warps'
// segment ranges (G kBwdWarps + 1), the segments (3 each: slot, first and
// end list entry) and the coordinates' slot ranges (NG + 1).
enum FwdHdr { kK0, kK1, kQ0, kQ1, kF0, kF1, kEH0, kEH1, kEQ0, kEQ1, kFwdHdr };
enum BwdHdr { kC0, kC1, kE0, kE1, kS0, kS1, kSeg0, kSeg1, kV0, kV1, kBwdHdr };
enum FwdMeta { kFG, kFMaxEnt, kFWarps, kFwdMeta };
enum BwdMeta { kG, kNSeg, kMaxEnt, kMaxSlots, kMaxCoords, kMaxSegs, kMaxNv,
               kWarps, kBwdMeta };

struct FwdPlan {
  const int* hdr;
  const int* fo;
};

struct BwdPlan {
  const int* hdr;
  const int* wb;
  const int* seg;
  const int* cs;
};

FwdPlan fwd_plan_of(const int* p, const int* meta) {
  return {p, p + meta[kFG] * kFwdHdr};
}

BwdPlan bwd_plan_of(const int* p, const int* meta) {
  BwdPlan s;
  s.hdr = p;
  s.wb = s.hdr + meta[kG] * kBwdHdr;
  s.seg = s.wb + meta[kG] * kBwdWarps + 1;
  s.cs = s.seg + 3 * meta[kNSeg];
  return s;
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

// wait for this thread's copies (a barrier follows)
__device__ __forceinline__ void cp_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

template <int NT>
__device__ __forceinline__ void copy_ints(int* dst, const int* src, int n) {
  for (int q = threadIdx.x; q < n; q += NT) cp4(dst + q, src + q);
}

// rows [r0, r0 + rows) of a row-major (B, N) array into a field-major tile
template <int N, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int rows) {
  for (int q = threadIdx.x; q < rows * N; q += NT) {
    const int r = q / N;
    cp4(dst + (q - r * N) * kPitch + r, src + (size_t)r0 * N + q);
  }
}

// columns [r0, r0 + rows) of a field-major (C, B) array into a tile
template <int C, int NT>
__device__ __forceinline__ void stage_cols(float* dst, const float* src,
                                           int B, int r0, int rows) {
  for (int q = threadIdx.x; q < C * kTile; q += NT) {
    const int c = q / kTile, r = q - c * kTile;
    if (r < rows) cp4(dst + c * kPitch + r, src + (size_t)c * B + r0 + r);
  }
}

// ---------------------------------------------------------------- forward
template <int NI, int NG, int NH>
size_t fwd_smem(const int* meta) {
  return (size_t)NI * round4(NG) * 4 + (size_t)meta[kFMaxEnt] * 8 +
         round4(NG) * 4 + (size_t)(NG + 1 + NH + NG) * 4 +
         (size_t)(2 * NI + 2 * NG) * kPitch * 4;
}

template <int NI, int NG, int NH, bool SAVE>
__global__ void __launch_bounds__(kFwdWarps * 32)
block_fwd_kernel(const float* __restrict__ x, int B,
                 const float* __restrict__ W, const float* __restrict__ bias,
                 const float* __restrict__ v, Ints ix, FwdPlan pl,
                 int max_ent, float* __restrict__ h,
                 float* __restrict__ lin_out, float* __restrict__ pre_out) {
  constexpr int NGP = round4(NG);
  constexpr int NT = kFwdWarps * 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ int hd[kFwdHdr];
  float* Wt = smem;                                     // [k][o]
  int2* ent = reinterpret_cast<int2*>(Wt + NI * NGP);   // (j, i), v
  float* b = reinterpret_cast<float*>(ent + max_ent);
  int* rowptr = reinterpret_cast<int*>(b + NGP);
  int* gate = rowptr + NG + 1;
  int* order = gate + NH;
  float* xbuf = reinterpret_cast<float*>(order + NG);   // 2 x [k][row]
  float* ls = xbuf + 2 * NI * kPitch;                   // [o][row]
  float* ps = ls + NG * kPitch;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < kFwdHdr) hd[t] = pl.hdr[blockIdx.y * kFwdHdr + t];
  __syncthreads();
  const int k0 = hd[kK0], k1 = hd[kK1], q0 = hd[kQ0], q1 = hd[kQ1];
  const int n_out = hd[kF1] - hd[kF0];
  const int eh0 = hd[kEH0], nh_e = hd[kEH1] - eh0;
  const int eq0 = hd[kEQ0], nq_e = hd[kEQ1] - eq0;
  for (int q = t; q < NG * NI; q += NT) {
    const int o = q / NI;
    cp4(Wt + (q - o * NI) * NGP + o, W + q);
  }
  for (int q = t; q < NI * (NGP - NG); q += NT)
    Wt[(q / (NGP - NG)) * NGP + NG + q % (NGP - NG)] = 0.0f;
  // the group's nonzeros: its outputs' [eh0, eh1), then its gates'
  // [eq0, eq1)
  for (int q = t; q < nh_e + nq_e; q += NT) {
    const int e = q < nh_e ? eh0 + q : eq0 + q - nh_e;
    cp4(&ent[q].x, ix.ji_off + e);
    cp4(&ent[q].y, v + e);
  }
  for (int o = t; o < NGP; o += NT) {
    if (o < NG) cp4(b + o, bias + o);
    else b[o] = 0.0f;
  }
  copy_ints<NT>(rowptr, ix.rowptr, NG + 1);
  copy_ints<NT>(gate, ix.gate, NH);
  copy_ints<NT>(order, pl.fo + hd[kF0], n_out);

  const float* lr = ls + lane;
  const int n_tiles = (B + kTile - 1) / kTile;
  int tile = blockIdx.x;
  stage_rows<NI, NT>(xbuf, x, tile * kTile, min(kTile, B - tile * kTile));
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int r0 = tile * kTile, rows = min(kTile, B - r0);
    const float* xs = xbuf + (it & 1) * NI * kPitch;
    cp_wait();
    __syncthreads();
    const int next = tile + gridDim.x;
    if (next < n_tiles)
      stage_rows<NI, NT>(xbuf + ((it + 1) & 1) * NI * kPitch, x,
                         next * kTile, min(kTile, B - next * kTile));
    __pipeline_commit();
    // lin: each warp 4 outputs, each lane its row; k in order, then b
    for (int q4 = warp; q4 < NGP / 4; q4 += kFwdWarps) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < NI; ++k) {
        const float xv = xs[k * kPitch + lane];
        const float4 w = reinterpret_cast<const float4*>(Wt + k * NGP)[q4];
        a[0] = fmaf(xv, w.x, a[0]);
        a[1] = fmaf(xv, w.y, a[1]);
        a[2] = fmaf(xv, w.z, a[2]);
        a[3] = fmaf(xv, w.w, a[3]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int o = 4 * q4 + m;
        if (o < NG) {
          const float l = a[m] + b[o];
          ls[o * kPitch + lane] = l;
          const bool mine = (o >= k0 && o < k1) || (o >= q0 && o < q1);
          if (SAVE && mine && lane < rows)
            lin_out[(size_t)o * B + r0 + lane] = l;
        }
      }
    }
    __syncthreads();
    // pre: each warp one output's nonzeros, broadcast to every lane
    for (int m = warp; m < n_out; m += kFwdWarps) {
      const int o = order[m];
      const int2* eo = ent + (o < NH ? -eh0 : nh_e - eq0);
      const int e1 = rowptr[o + 1];
      float q = 0.0f;
#pragma unroll 8
      for (int e = rowptr[o]; e < e1; ++e) {
        const int2 en = eo[e];
        q = fmaf(__int_as_float(en.y) * lr[(unsigned)en.x >> 16],
                 lr[en.x & 0xffff], q);
      }
      const float pr = 0.1f * q + lr[o * kPitch];
      ps[o * kPitch + lane] = pr;
      if (SAVE && lane < rows) pre_out[(size_t)o * B + r0 + lane] = pr;
    }
    __syncthreads();
    // h for the group's outputs, written row-major; the next tile's writes
    // to the x buffers, ls and ps all come after a barrier that every read
    // of this tile precedes
    const int nk = k1 - k0;
    for (int q = t; q < rows * nk; q += NT) {
      const int r = q / nk, k = k0 + q - r * nk;
      h[(size_t)(r0 + r) * NH + k] =
          ps[k * kPitch + r] / (1.0f + expf(-ps[gate[k] * kPitch + r]));
    }
  }
}

// --------------------------------------------------------------- backward
template <int NI, int NG, int NH>
size_t bwd_smem(const int* meta) {
  return (size_t)meta[kMaxEnt] * 8 + (size_t)meta[kMaxNv] * 8 +
         (size_t)(3 * NG + NH + NI + meta[kMaxSlots] + meta[kMaxCoords]) *
             kPitch * 4 +
         (size_t)meta[kMaxCoords] * round4(NI) * 4 +
         (size_t)(3 * meta[kMaxSegs] + kBwdWarps + 1 + meta[kMaxCoords] + 1 +
                  NH + NG + 1 + NH) *
             4;
}

template <int NI, int NG, int NH>
__global__ void __launch_bounds__(kBwdWarps * 32)
block_bwd_kernel(const float* __restrict__ g_h, const float* __restrict__ x,
                 int B, const float* __restrict__ W,
                 const float* __restrict__ v, Ints ix, BwdPlan pl,
                 int max_ent, int max_nv, int max_slots, int max_coords,
                 int max_segs, const float* __restrict__ lin,
                 const float* __restrict__ pre, float* __restrict__ gx_part,
                 float* __restrict__ partial, int n_par, int need_params) {
  constexpr int NT = kBwdWarps * 32;
  constexpr int NIP = round4(NI);
  extern __shared__ __align__(16) float smem[];
  __shared__ int hd[kBwdHdr];
  float* Wg = smem;                                  // the group's W rows
  int2* ent = reinterpret_cast<int2*>(Wg + max_coords * NIP);  // (o, p), v
  int2* gv_ix = ent + max_ent;                       // o, (j, i) offsets
  float* ls = reinterpret_cast<float*>(gv_ix + max_nv);
  float* ps = ls + NG * kPitch;
  float* gps = ps + NG * kPitch;
  float* gs = gps + NG * kPitch;
  float* xs = gs + NH * kPitch;
  float* segp = xs + NI * kPitch;
  float* gl = segp + max_slots * kPitch;
  int* seg = reinterpret_cast<int*>(gl + max_coords * kPitch);
  int* wb = seg + 3 * max_segs;
  int* cs = wb + kBwdWarps + 1;
  int* gate = cs + max_coords + 1;
  int* ginv_ptr = gate + NH;
  int* ginv_k = ginv_ptr + NG + 1;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = blockIdx.y;
  if (t < kBwdHdr) hd[t] = pl.hdr[g * kBwdHdr + t];
  __syncthreads();
  const int c0 = hd[kC0], nc = hd[kC1] - c0;
  const int e0 = hd[kE0], s0 = hd[kS0], seg0 = hd[kSeg0];
  const int v0 = hd[kV0], nv = hd[kV1] - v0;
  const int r0 = blockIdx.x * kTile, rows = min(kTile, B - r0);

#pragma unroll 4
  for (int q = t; q < hd[kE1] - e0; q += NT) {
    cp4(&ent[q].x, ix.cl_off + e0 + q);
    cp4(&ent[q].y, v + ix.cl_e[e0 + q]);
  }
  for (int q = t; q < nv; q += NT) {
    cp4(&gv_ix[q].x, ix.o + v0 + q);
    cp4(&gv_ix[q].y, ix.ji_off + v0 + q);
  }
  copy_ints<NT>(seg, pl.seg + 3 * seg0, 3 * (hd[kSeg1] - seg0));
  copy_ints<NT>(wb, pl.wb + g * kBwdWarps, kBwdWarps + 1);
  copy_ints<NT>(cs, pl.cs + c0, nc + 1);
  copy_ints<NT>(gate, ix.gate, NH);
  copy_ints<NT>(ginv_ptr, ix.ginv_ptr, NG + 1);
  copy_ints<NT>(ginv_k, ix.ginv_k, NH);
  for (int q = t; q < nc * NIP; q += NT) {
    const int cl = q / NIP, k = q - cl * NIP;
    if (k < NI) cp4(Wg + q, W + (c0 + cl) * NI + k);
    else Wg[q] = 0.0f;
  }
  stage_cols<NG, NT>(ls, lin, B, r0, rows);
  stage_cols<NG, NT>(ps, pre, B, r0, rows);
  stage_rows<NH, NT>(gs, g_h, r0, rows);
  if (need_params) stage_rows<NI, NT>(xs, x, r0, rows);
  cp_wait();
  __syncthreads();

  // g_pre for every coordinate: the gate's first term, then the terms of
  // the outputs gated by c, in k order (as the twin's index_add_)
  for (int c = warp; c < NG; c += kBwdWarps) {
    float gp = 0.0f;
    if (c < NH)
      gp = gs[c * kPitch + lane] *
           (1.0f / (1.0f + expf(-ps[gate[c] * kPitch + lane])));
    const int k1 = ginv_ptr[c + 1];
    if (ginv_ptr[c] < k1) {
      const float s = 1.0f / (1.0f + expf(-ps[c * kPitch + lane]));
      for (int kk = ginv_ptr[c]; kk < k1; ++kk) {
        const int k = ginv_k[kk];
        gp += gs[k * kPitch + lane] * ps[k * kPitch + lane] * s * (1.0f - s);
      }
    }
    gps[c * kPitch + lane] = gp;
  }
  __syncthreads();

  // g_lin's list sums, one segment at a time per warp
  const float* gr = gps + lane;
  const float* lr = ls + lane;
  for (int s = wb[warp] - seg0; s < wb[warp + 1] - seg0; ++s) {
    const int hi = seg[3 * s + 2] - e0;
    float acc = 0.0f;
#pragma unroll 8
    for (int e = seg[3 * s + 1] - e0; e < hi; ++e) {
      const int2 en = ent[e];
      acc = fmaf(__int_as_float(en.y) * gr[(unsigned)en.x >> 16],
                 lr[en.x & 0xffff], acc);
    }
    segp[(seg[3 * s] - s0) * kPitch + lane] = 0.1f * acc;
  }
  __syncthreads();

  // g_lin = g_pre + each coordinate's slots in order
  for (int cl = warp; cl < nc; cl += kBwdWarps) {
    float acc = gps[(c0 + cl) * kPitch + lane];
    for (int s = cs[cl]; s < cs[cl + 1]; ++s)
      acc += segp[(s - s0) * kPitch + lane];
    gl[cl * kPitch + lane] = acc;
  }
  __syncthreads();

  // the group's share of g_x = g_lin W_eff, coordinates in order, each
  // thread on a row and 4 inputs (a float4 of W_eff a step)
  for (int q = t; q < rows * (NIP / 4); q += NT) {
    const int r = q / (NIP / 4), k4 = q - r * (NIP / 4);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int cl = 0; cl < nc; ++cl) {
      const float gv = gl[cl * kPitch + r];
      const float4 w = reinterpret_cast<const float4*>(Wg + cl * NIP)[k4];
      a[0] = fmaf(gv, w.x, a[0]);
      a[1] = fmaf(gv, w.y, a[1]);
      a[2] = fmaf(gv, w.z, a[2]);
      a[3] = fmaf(gv, w.w, a[3]);
    }
    float* out = gx_part + ((size_t)g * B + r0 + r) * NI + 4 * k4;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * k4 + m < NI) out[m] = a[m];
  }
  if (!need_params) return;

  // this tile's partial sums of the group's parameters, rows in order
  const int nw = nc * NI;
  float* out = partial + (size_t)blockIdx.x * n_par;
  for (int q = t; q < nw + nc + nv; q += NT) {
    float s = 0.0f;
    if (q < nw) {
      const int cl = q / NI, k = q - cl * NI;
      const float* a = gl + cl * kPitch;
      const float* xx = xs + k * kPitch;
      for (int r = 0; r < rows; ++r) s = fmaf(a[r], xx[r], s);
      out[c0 * NI + q] = s;
    } else if (q < nw + nc) {
      const float* a = gl + (q - nw) * kPitch;
      for (int r = 0; r < rows; ++r) s += a[r];
      out[NG * NI + c0 + q - nw] = s;
    } else {
      const int2 en = gv_ix[q - nw - nc];
      const float* go = gps + en.x * kPitch;
      const float* lj = ls + ((unsigned)en.y >> 16);
      const float* li = ls + (en.y & 0xffff);
      for (int r = 0; r < rows; ++r) s += 0.1f * go[r] * lj[r] * li[r];
      out[NG * NI + NG + v0 + q - nw - nc] = s;
    }
  }
}

// g_x as the groups' shares added in group order, one output a thread
// (blocks [0, gx_blocks)); then the parameter gradients as the tiles'
// partials added in a fixed order, 32 parameters a block: warp w adds
// tiles w, w + 8, ... in order, then the 8 warps' sums in warp order
__global__ void __launch_bounds__(kSumThreads)
block_bwd_finish_kernel(const float* __restrict__ gx_part, int groups,
                        int n_gx, int gx_blocks, float* __restrict__ g_x,
                        const float* __restrict__ partial, int n_tiles,
                        int n_par, float* __restrict__ g_par) {
  constexpr int kWarps = kSumThreads / 32;
  __shared__ float sums[kWarps][32];
  const int t = threadIdx.x;
  if ((int)blockIdx.x < gx_blocks) {
    const int q = blockIdx.x * kSumThreads + t;
    if (q >= n_gx) return;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < groups; ++k) s += gx_part[(size_t)k * n_gx + q];
    g_x[q] = s;
    return;
  }
  const int lane = t & 31, warp = t >> 5;
  const int q = ((int)blockIdx.x - gx_blocks) * 32 + lane;
  float s = 0.0f;
  if (q < n_par) {
#pragma unroll 4
    for (int k = warp; k < n_tiles; k += kWarps)
      s += partial[(size_t)k * n_par + q];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && q < n_par) {
    float tot = sums[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tot += sums[w][lane];
    g_par[q] = tot;
  }
}

// ------------------------------------------------------------- launchers
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

template <int NI, int NG, int NH, bool SAVE>
int fwd_save(const float* x, int B, const float* W, const float* b,
             const float* v, const int* ints, int nnz, const int* plan,
             const int* meta, float* h, float* lin, float* pre,
             cudaStream_t st) {
  static size_t done[kMaxDevices] = {0};
  auto kernel = block_fwd_kernel<NI, NG, NH, SAVE>;
  const size_t smem = fwd_smem<NI, NG, NH>(meta);
  cudaError_t e = set_smem(kernel, smem, done);
  if (e != cudaSuccess) return (int)e;
  // a persistent grid: as many blocks over all groups as fit on the SMs at
  // this shared memory (one wave, so each block loads the constant side
  // once), at most one block a tile
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kFwdWarps * 32, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (B + kTile - 1) / kTile;
  int slots = (per_sm * sms + meta[kFG] - 1) / meta[kFG];
  if (slots > n_tiles) slots = n_tiles;
  kernel<<<dim3(slots, meta[kFG]), kFwdWarps * 32, smem, st>>>(
      x, B, W, b, v, ints_of(ints, NG, NH, nnz), fwd_plan_of(plan, meta),
      meta[kFMaxEnt], h, lin, pre);
  return (int)cudaGetLastError();
}

template <int NI, int NG, int NH>
int fwd(const float* x, int B, const float* W, const float* b, const float* v,
        const int* ints, int nnz, const int* plan, const int* meta,
        float* h, float* lin, float* pre, cudaStream_t st) {
  if ((lin == nullptr) != (pre == nullptr) || meta[kFWarps] != kFwdWarps ||
      meta[kFG] < 1)
    return (int)cudaErrorInvalidValue;
  return lin ? fwd_save<NI, NG, NH, true>(x, B, W, b, v, ints, nnz, plan,
                                          meta, h, lin, pre, st)
             : fwd_save<NI, NG, NH, false>(x, B, W, b, v, ints, nnz, plan,
                                           meta, h, nullptr, nullptr, st);
}

template <int NI, int NG, int NH>
int bwd(const float* g_h, const float* x, int B, const float* W,
        const float* v, const int* ints, int nnz, const float* lin,
        const float* pre, const int* plan, const int* meta, float* gx_part,
        float* g_x, float* partial, float* g_par, int need_params,
        cudaStream_t st) {
  static size_t done[kMaxDevices] = {0};
  if (meta[kWarps] != kBwdWarps || meta[kG] < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem<NI, NG, NH>(meta);
  cudaError_t e = set_smem(block_bwd_kernel<NI, NG, NH>, smem, done);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (B + kTile - 1) / kTile;
  const int n_par = NG * NI + NG + nnz;
  // one group: its share is g_x, and the finishing kernel only adds the
  // parameter partials (if any)
  const bool one = meta[kG] == 1;
  block_bwd_kernel<NI, NG, NH>
      <<<dim3(n_tiles, meta[kG]), kBwdWarps * 32, smem, st>>>(
          g_h, x, B, W, v, ints_of(ints, NG, NH, nnz),
          bwd_plan_of(plan, meta), meta[kMaxEnt], meta[kMaxNv],
          meta[kMaxSlots], meta[kMaxCoords], meta[kMaxSegs], lin, pre,
          one ? g_x : gx_part, partial, n_par, need_params);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int gx_blocks = one ? 0 : (B * NI + kSumThreads - 1) / kSumThreads;
  const int par_blocks = need_params ? (n_par + 31) / 32 : 0;
  if (gx_blocks + par_blocks == 0) return cudaSuccess;
  block_bwd_finish_kernel<<<gx_blocks + par_blocks, kSumThreads, 0, st>>>(
      gx_part, meta[kG], B * NI, gx_blocks, g_x, partial, n_tiles,
      need_params ? n_par : 0, g_par);
  return (int)cudaGetLastError();
}

// The blocks of the flagship MODUL networks: the twin Q critics' first
// blocks (obs + action in) and hidden blocks, the PPO V critics' first
// blocks (obs in), and both actors' blocks; the first blocks of the MONO
// twin Q critic and actor (their hidden blocks are MODUL agent 0's); and
// the first blocks of the CTDE critics over the joint input (Q: 18 obs + 5
// actions, V: 18 obs; agent 0's SO2eR3 tower, agent 1's Mirror tower),
// whose 23-wide SO2eR3 one is also the MONO V critic's.
#define EMLP_BLOCK_INSTANCES(X) \
  X(19, 71, 62) X(62, 71, 62) X(4, 123, 62) X(62, 123, 62) \
  X(15, 71, 62) X(3, 123, 62) \
  X(15, 18, 16) X(16, 18, 16) X(3, 7, 4) X(4, 7, 4) \
  X(27, 71, 62) X(23, 18, 16) \
  X(23, 71, 62) X(23, 123, 62) X(18, 71, 62) X(18, 123, 62)


// ------------------------------------------------------ run-time widths
// Blocks without an instance (any (nin, ng, nh)) run the kernels below,
// whose sizes are arguments and whose shared memory does not grow with a
// block's weights or nonzeros, so no width exceeds a block's limit.  Each
// step is its own launch over a grid of 32-row tiles, lane t on row t, the
// vectors between launches field-major (ng, B) in global memory:
//   forward: rt_lin_kernel (lin = x W_eff^T + b_eff; 32 rows x 32 outputs
//     a block, x and W_eff streamed through shared memory in chunks of 32
//     inputs, each output's terms in input order, then the bias: the
//     instances' expression), then rt_gate_kernel (pre and h: a block
//     column a run of the gated nonlinearity's atoms, a warp a coordinate,
//     each output's nonzeros in their order, then after a barrier the
//     gate);
//   backward: rt_gpre_kernel (g_pre, the instances' expression), then
//     rt_glin_kernel (g_lin: a warp a coordinate, its whole list in order,
//     g_pre + 0.1 acc), rt_gx_kernel (g_x = g_lin W_eff, 32 rows x 32
//     inputs a block, the coordinates streamed in chunks, in order) and,
//     with parameter gradients, rt_param_kernel (a thread a parameter: per
//     32-row tile the instances' partial sum, then the tiles added as the
//     instances' finishing kernel adds them: the instances' order over
//     rows; g_v is an instance's bit for bit, g_W and g_b where its g_lin
//     is, which sums each coordinate's list in segments).
// The gate and list steps read the tile's lin (and g_pre) from shared
// memory where the ng x 32 floats fit (the host's `stage`), else from
// global memory.  Every sum has one fixed order and there are no atomics,
// so a rerun repeats its numbers bit for bit.
constexpr int kRtThreads = 256;
constexpr int kRtWarps = kRtThreads / 32;
constexpr int kRtChunk = 32;     // inputs (forward) or coordinates (g_x)
constexpr int kRtWPitch = 36;    // a staged W chunk's row, float4 aligned

// The static index of the run-time path (BlockSpec.rt_ints), in this order.
struct RtInts {
  const int* gate;      // NH
  const int* rowptr;    // NG + 1
  const int* ej;        // nnz: j of each nonzero
  const int* ei;        // nnz: i
  const int* eo;        // nnz: o
  const int* cl_ptr;    // NG + 1: coordinate-major lists
  const int* cl_o;      // 2 nnz: the output
  const int* cl_p;      // 2 nnz: the partner coordinate
  const int* cl_e;      // 2 nnz: the nonzero
  const int* ginv_ptr;  // NG + 1
  const int* ginv_k;    // NH
  const int* atoms;     // 3 n_atoms: k0, k1, gate coordinate or -1
};

RtInts rt_ints_of(const int* p, int ng, int nh, int nnz) {
  RtInts s;
  s.gate = p;
  s.rowptr = s.gate + nh;
  s.ej = s.rowptr + ng + 1;
  s.ei = s.ej + nnz;
  s.eo = s.ei + nnz;
  s.cl_ptr = s.eo + nnz;
  s.cl_o = s.cl_ptr + ng + 1;
  s.cl_p = s.cl_o + 2 * nnz;
  s.cl_e = s.cl_p + 2 * nnz;
  s.ginv_ptr = s.cl_e + 2 * nnz;
  s.ginv_k = s.ginv_ptr + ng + 1;
  s.atoms = s.ginv_k + nh;
  return s;
}

// A tile's field-major vector: coordinate c of this lane's row at
// base[c * ld] (shared memory, ld = kTile, or global, ld = B).
struct TileRef {
  const float* base;
  size_t ld;
  __device__ __forceinline__ float operator[](int c) const {
    return base[(size_t)c * ld];
  }
};

// ng x kTile floats of a field-major (ng, B) array into shared memory
// (zeros past the last row); returns this lane's view, or the global one
__device__ __forceinline__ TileRef stage_tile(float* dst, const float* src,
                                              int ng, int B, int r0,
                                              int rows, int stage, int lane) {
  if (!stage) return {src + r0 + min(lane, rows - 1), (size_t)B};
  for (int q = threadIdx.x; q < ng * kTile; q += kRtThreads) {
    const int c = q >> 5, r = q & 31;
    dst[q] = r < rows ? src[(size_t)c * B + r0 + r] : 0.0f;
  }
  return {dst + lane, (size_t)kTile};
}

__global__ void __launch_bounds__(kRtThreads)
rt_lin_kernel(const float* __restrict__ x, int B, int nin, int ng,
              const float* __restrict__ W, const float* __restrict__ bias,
              float* __restrict__ lin) {
  __shared__ float xs[kRtChunk * kPitch];                    // [k][row]
  __shared__ __align__(16) float ws[kRtChunk * kRtWPitch];   // [k][o]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * kTile, rows = min(kTile, B - r0);
  const int o0 = blockIdx.y * (4 * kRtWarps);
  const int no = min(4 * kRtWarps, ng - o0);
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < nin; k0 += kRtChunk) {
    const int kc = min(kRtChunk, nin - k0);
    __syncthreads();
    for (int q = t; q < rows * kc; q += kRtThreads) {
      const int r = q / kc, k = q - r * kc;
      xs[k * kPitch + r] = x[(size_t)(r0 + r) * nin + k0 + k];
    }
    for (int q = t; q < no * kc; q += kRtThreads) {
      const int o = q / kc, k = q - o * kc;
      ws[k * kRtWPitch + o] = W[(size_t)(o0 + o) * nin + k0 + k];
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float xv = xs[k * kPitch + lane];
      const float4 w = reinterpret_cast<const float4*>(ws + k * kRtWPitch)[warp];
      a[0] = fmaf(xv, w.x, a[0]);
      a[1] = fmaf(xv, w.y, a[1]);
      a[2] = fmaf(xv, w.z, a[2]);
      a[3] = fmaf(xv, w.w, a[3]);
    }
  }
  if (lane >= rows) return;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int o = o0 + 4 * warp + m;
    if (o < ng) lin[(size_t)o * B + r0 + lane] = a[m] + bias[o];
  }
}

// pre of output o for this lane's row: its nonzeros in order, then 0.1 q +
// lin (the instances' expression)
__device__ __forceinline__ float rt_pre(const TileRef& l,
                                        const float* __restrict__ v,
                                        const RtInts& ix, int o) {
  const int e1 = ix.rowptr[o + 1];
  float q = 0.0f;
#pragma unroll 4
  for (int e = ix.rowptr[o]; e < e1; ++e)
    q = fmaf(v[e] * l[ix.ej[e]], l[ix.ei[e]], q);
  return 0.1f * q + l[o];
}

// pre of a block column's coordinates (the outputs K0:K1 of its atoms and
// their gate coordinates Q0:Q1, host ranges), a warp a coordinate, written
// field-major to pre; then h for its outputs, a thread a (row, output)
__global__ void __launch_bounds__(kRtThreads)
rt_gate_kernel(const float* __restrict__ lin, int B, int ng, int nh,
               const float* __restrict__ v, RtInts ix,
               const int* __restrict__ ranges, int stage,
               float* __restrict__ h, float* __restrict__ pre) {
  extern __shared__ __align__(16) float lt[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * kTile, rows = min(kTile, B - r0);
  const int* rg = ranges + 4 * blockIdx.y;
  const int k0 = rg[0], nk = rg[1] - k0, q0 = rg[2], nq = rg[3] - q0;
  const TileRef l = stage_tile(lt, lin, ng, B, r0, rows, stage, lane);
  if (stage) __syncthreads();
  for (int task = warp; task < nk + nq; task += kRtWarps) {
    const int c = task < nk ? k0 + task : q0 + task - nk;
    const float p = rt_pre(l, v, ix, c);
    if (lane < rows) pre[(size_t)c * B + r0 + lane] = p;
  }
  // every pre this block reads below it wrote above
  __syncthreads();
  for (int q = t; q < rows * nk; q += kRtThreads) {
    const int r = q / nk, k = k0 + q - r * nk;
    const size_t row = (size_t)r0 + r;
    h[row * nh + k] = pre[(size_t)k * B + row] /
                      (1.0f + expf(-pre[(size_t)ix.gate[k] * B + row]));
  }
}

// g_pre, a warp a coordinate, a lane a row (the instances' expression)
__global__ void __launch_bounds__(kRtThreads)
rt_gpre_kernel(const float* __restrict__ g_h, const float* __restrict__ pre,
               int B, int ng, int nh, RtInts ix, float* __restrict__ gpre) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * kRtWarps + warp;
  const int r = blockIdx.x * kTile + lane;
  if (c >= ng || r >= B) return;
  float gp = 0.0f;
  if (c < nh)
    gp = g_h[(size_t)r * nh + c] *
         (1.0f / (1.0f + expf(-pre[(size_t)ix.gate[c] * B + r])));
  const int k1 = ix.ginv_ptr[c + 1];
  if (ix.ginv_ptr[c] < k1) {
    const float s = 1.0f / (1.0f + expf(-pre[(size_t)c * B + r]));
    for (int kk = ix.ginv_ptr[c]; kk < k1; ++kk) {
      const int k = ix.ginv_k[kk];
      gp += g_h[(size_t)r * nh + k] * pre[(size_t)k * B + r] * s * (1.0f - s);
    }
  }
  gpre[(size_t)c * B + r] = gp;
}

// g_lin = g_pre + 0.1 (each coordinate's list in order), per_block
// coordinates a block, a warp a coordinate
__global__ void __launch_bounds__(kRtThreads)
rt_glin_kernel(const float* __restrict__ gpre, const float* __restrict__ lin,
               int B, int ng, const float* __restrict__ v, RtInts ix,
               int per_block, int stage, float* __restrict__ glin) {
  extern __shared__ __align__(16) float tiles[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kTile, rows = min(kTile, B - r0);
  const TileRef gp = stage_tile(tiles, gpre, ng, B, r0, rows, stage, lane);
  const TileRef l =
      stage_tile(tiles + ng * kTile, lin, ng, B, r0, rows, stage, lane);
  if (stage) __syncthreads();
  if (lane >= rows) return;
  const int c1 = min(ng, (int)(blockIdx.y + 1) * per_block);
  for (int c = blockIdx.y * per_block + warp; c < c1; c += kRtWarps) {
    const int e1 = ix.cl_ptr[c + 1];
    float acc = 0.0f;
#pragma unroll 4
    for (int e = ix.cl_ptr[c]; e < e1; ++e)
      acc = fmaf(v[ix.cl_e[e]] * gp[ix.cl_o[e]], l[ix.cl_p[e]], acc);
    glin[(size_t)c * B + r0 + lane] = __fadd_rn(gp[c], __fmul_rn(0.1f, acc));
  }
}

// g_x = g_lin W_eff: 32 rows x 32 inputs a block, thread (row t / 8,
// inputs 4 (t % 8) ..), the coordinates in order
__global__ void __launch_bounds__(kRtThreads)
rt_gx_kernel(const float* __restrict__ glin, const float* __restrict__ W,
             int B, int ng, int nin, float* __restrict__ g_x) {
  __shared__ float gs[kRtChunk * kTile];                     // [c][row]
  __shared__ __align__(16) float ws[kRtChunk * kTile];       // [c][k]
  const int t = threadIdx.x, r = t >> 3, kq = t & 7;
  const int r0 = blockIdx.x * kTile, rows = min(kTile, B - r0);
  const int k0 = blockIdx.y * kTile, nk = min(kTile, nin - k0);
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < ng; c0 += kRtChunk) {
    const int cc = min(kRtChunk, ng - c0);
    __syncthreads();
    for (int q = t; q < cc * kTile; q += kRtThreads) {
      const int c = q >> 5, i = q & 31;
      gs[q] = i < rows ? glin[(size_t)(c0 + c) * B + r0 + i] : 0.0f;
      ws[q] = i < nk ? W[(size_t)(c0 + c) * nin + k0 + i] : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      const float gv = gs[c * kTile + r];
      const float4 w = reinterpret_cast<const float4*>(ws + c * kTile)[kq];
      a[0] = fmaf(gv, w.x, a[0]);
      a[1] = fmaf(gv, w.y, a[1]);
      a[2] = fmaf(gv, w.z, a[2]);
      a[3] = fmaf(gv, w.w, a[3]);
    }
  }
  if (r >= rows) return;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (4 * kq + m < nk)
      g_x[(size_t)(r0 + r) * nin + k0 + 4 * kq + m] = a[m];
}

// The parameter gradients, a thread a parameter (g_W (ng, nin), g_b, g_v):
// per 32-row tile the instances' partial (rows in order), the tiles added
// as block_bwd_finish_kernel adds them (tile k into sum k % 8, then the 8
// sums in order)
__global__ void __launch_bounds__(kRtThreads)
rt_param_kernel(const float* __restrict__ glin,
                const float* __restrict__ gpre,
                const float* __restrict__ lin, const float* __restrict__ x,
                int B, int ng, int nin, int nnz, RtInts ix,
                float* __restrict__ g_par) {
  constexpr int kWarps = kSumThreads / 32;
  const int nw = ng * nin;
  const int q = blockIdx.x * kRtThreads + threadIdx.x;
  if (q >= nw + ng + nnz) return;
  const float *a = nullptr, *b = nullptr, *c = nullptr;
  int kind = 0;
  size_t ldb = 0;
  if (q < nw) {                        // g_W: g_lin[c] . x[:, k]
    const int cl = q / nin;
    a = glin + (size_t)cl * B;
    b = x + (q - cl * nin);
    ldb = nin;
  } else if (q < nw + ng) {            // g_b: g_lin[c]
    a = glin + (size_t)(q - nw) * B;
    kind = 1;
  } else {                             // g_v: 0.1 g_pre[o] lin[j] lin[i]
    const int e = q - nw - ng;
    a = gpre + (size_t)ix.eo[e] * B;
    b = lin + (size_t)ix.ej[e] * B;
    c = lin + (size_t)ix.ei[e] * B;
    kind = 2;
  }
  const int n_tiles = (B + kTile - 1) / kTile;
  float sums[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sums[w] = 0.0f;
  for (int k8 = 0; k8 < n_tiles; k8 += kWarps) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int tile = k8 + w;
      const int r0 = tile * kTile, rows = max(0, min(kTile, B - r0));
      float s = 0.0f;
      if (kind == 0) {
#pragma unroll 8
        for (int r = 0; r < rows; ++r)
          s = fmaf(a[r0 + r], b[(size_t)(r0 + r) * ldb], s);
      } else if (kind == 1) {
#pragma unroll 8
        for (int r = 0; r < rows; ++r) s += a[r0 + r];
      } else {
#pragma unroll 8
        for (int r = 0; r < rows; ++r)
          s += 0.1f * a[r0 + r] * b[r0 + r] * c[r0 + r];
      }
      sums[w] += s;
    }
  }
  float tot = sums[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) tot += sums[w];
  g_par[q] = tot;
}

}  // namespace

// The run-time path's geometry and shared memory: 0 threads a block, 1 the
// forward's outputs a block (rt_lin_kernel), 2 the staged-tile bytes a
// coordinate (rt_gate_kernel: one tile; rt_glin_kernel: two), 3 the static
// shared memory of rt_lin_kernel, 4 of rt_gx_kernel (bytes).
extern "C" int emlp_block_rt_geometry(int which) {
  return which == 0   ? kRtThreads
         : which == 1 ? 4 * kRtWarps
         : which == 2 ? kTile * 4
         : which == 3 ? (int)(kRtChunk * (kPitch + kRtWPitch) * 4)
                      : (int)(2 * kRtChunk * kTile * 4);
}

namespace {

// per kernel (the two have different types): its dynamic shared memory
template <typename K>
cudaError_t rt_smem(K kernel, size_t bytes) {
  static size_t done[kMaxDevices] = {0};
  return set_smem(kernel, bytes, done);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The geometry the host plans for: rows a tile, the tiles' pitch, and the
// warps of a forward and of a backward block.
extern "C" int emlp_block_geometry(int which) {
  return which == 0   ? kTile
         : which == 1 ? kPitch
         : which == 2 ? kFwdWarps
                      : kBwdWarps;
}

// Dynamic shared memory of one launch (bytes): the forward's (which 0) or
// the backward's main kernel's (1) under a plan's meta; 0 for a shape
// without an instance.
extern "C" long long emlp_block_smem(int nin, int ng, int nh,
                                     const int* meta, int which) {
#define X(a, b, c)                                         \
  if (nin == a && ng == b && nh == c)                      \
    return which == 0 ? (long long)fwd_smem<a, b, c>(meta) \
                      : (long long)bwd_smem<a, b, c>(meta);
  EMLP_BLOCK_INSTANCES(X)
#undef X
  return 0;
}

// lin and pre both null: the forward saves nothing (no backward follows).
// plan / meta: BlockSpec.plan_args of the forward's group count.
extern "C" int emlp_block_fwd_launch(const void* x, int B, const void* W,
                                     const void* b, const void* v,
                                     const void* ints, int nnz,
                                     const void* plan, const int* meta,
                                     void* h, void* lin, void* pre, int nin,
                                     int ng, int nh, void* stream) {
  if (B <= 0 || nnz < 0) return (int)cudaErrorInvalidValue;
#define X(a, b_, c)                                                         \
  if (nin == a && ng == b_ && nh == c)                                      \
    return fwd<a, b_, c>((const float*)x, B, (const float*)W,               \
                         (const float*)b, (const float*)v, (const int*)ints, \
                         nnz, (const int*)plan, meta, (float*)h,            \
                         (float*)lin, (float*)pre, (cudaStream_t)stream);
  EMLP_BLOCK_INSTANCES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// plan / meta: BlockSpec.plan_args of the backward's group count; gx_part
// (G, B, nin) scratch when G > 1, partial (tiles, n_par) scratch when
// need_params.
extern "C" int emlp_block_bwd_launch(const void* g_h, const void* x, int B,
                                     const void* W, const void* v,
                                     const void* ints, int nnz,
                                     const void* lin, const void* pre,
                                     const void* plan, const int* meta,
                                     void* gx_part, void* g_x, void* partial,
                                     void* g_par, int need_params, int nin,
                                     int ng, int nh, void* stream) {
  if (B <= 0 || nnz < 0) return (int)cudaErrorInvalidValue;
#define X(a, b, c)                                                          \
  if (nin == a && ng == b && nh == c)                                       \
    return bwd<a, b, c>((const float*)g_h, (const float*)x, B,              \
                        (const float*)W, (const float*)v, (const int*)ints, \
                        nnz, (const float*)lin, (const float*)pre,          \
                        (const int*)plan, meta, (float*)gx_part,            \
                        (float*)g_x, (float*)partial, (float*)g_par,        \
                        need_params, (cudaStream_t)stream);
  EMLP_BLOCK_INSTANCES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// Run-time widths (any (nin, ng, nh)): rt_ints the BlockSpec.rt_ints of the
// block; ranges (n_cols x 4: k0, k1, q0, q1, BlockSpec.rt_ranges) the
// coordinates of each block column of rt_gate_kernel; stage 1: the tile's
// lin in shared memory (ng x 128 bytes), 0: read from global memory.  lin
// and pre (ng, B) are always written (the gate step reads both).
extern "C" int emlp_block_rt_fwd_launch(const void* x, int B, const void* W,
                                        const void* b, const void* v,
                                        const void* rt_ints, int nnz,
                                        const void* ranges, int n_cols,
                                        int stage, void* h, void* lin,
                                        void* pre, int nin, int ng, int nh,
                                        void* stream) {
  if (B <= 0 || nnz < 0 || nin <= 0 || ng <= 0 || nh <= 0 || nh > ng ||
      n_cols <= 0 || lin == nullptr || pre == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (B + kTile - 1) / kTile;
  const RtInts ix = rt_ints_of((const int*)rt_ints, ng, nh, nnz);
  rt_lin_kernel<<<dim3(n_tiles, (ng + 4 * kRtWarps - 1) / (4 * kRtWarps)),
                  kRtThreads, 0, st>>>((const float*)x, B, nin, ng,
                                       (const float*)W, (const float*)b,
                                       (float*)lin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = stage ? (size_t)ng * kTile * 4 : 0;
  e = rt_smem(rt_gate_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  rt_gate_kernel<<<dim3(n_tiles, n_cols), kRtThreads, smem, st>>>(
      (const float*)lin, B, ng, nh, (const float*)v, ix, (const int*)ranges,
      stage, (float*)h, (float*)pre);
  return (int)cudaGetLastError();
}

// Run-time widths: gpre and glin (ng, B) scratch; per_block coordinates a
// block column of rt_glin_kernel; stage 1: the tile's g_pre and lin in
// shared memory (ng x 256 bytes); g_par (ng nin + ng + nnz) written when
// need_params.
extern "C" int emlp_block_rt_bwd_launch(const void* g_h, const void* x,
                                        int B, const void* W, const void* v,
                                        const void* rt_ints, int nnz,
                                        const void* lin, const void* pre,
                                        int per_block, int stage, void* gpre,
                                        void* glin, void* g_x, void* g_par,
                                        int need_params, int nin, int ng,
                                        int nh, void* stream) {
  if (B <= 0 || nnz < 0 || nin <= 0 || ng <= 0 || nh <= 0 || nh > ng ||
      per_block <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (B + kTile - 1) / kTile;
  const RtInts ix = rt_ints_of((const int*)rt_ints, ng, nh, nnz);
  rt_gpre_kernel<<<dim3(n_tiles, (ng + kRtWarps - 1) / kRtWarps), kRtThreads,
                   0, st>>>((const float*)g_h, (const float*)pre, B, ng, nh,
                            ix, (float*)gpre);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = stage ? (size_t)2 * ng * kTile * 4 : 0;
  e = rt_smem(rt_glin_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  rt_glin_kernel<<<dim3(n_tiles, (ng + per_block - 1) / per_block),
                   kRtThreads, smem, st>>>(
      (const float*)gpre, (const float*)lin, B, ng, (const float*)v, ix,
      per_block, stage, (float*)glin);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rt_gx_kernel<<<dim3(n_tiles, (nin + kTile - 1) / kTile), kRtThreads, 0,
                 st>>>((const float*)glin, (const float*)W, B, ng, nin,
                       (float*)g_x);
  e = cudaGetLastError();
  if (e != cudaSuccess || !need_params) return (int)e;
  const long long n_par = (long long)ng * nin + ng + nnz;
  rt_param_kernel<<<(unsigned)((n_par + kRtThreads - 1) / kRtThreads),
                    kRtThreads, 0, st>>>((const float*)glin,
                                         (const float*)gpre,
                                         (const float*)lin, (const float*)x,
                                         B, ng, nin, nnz, ix, (float*)g_par);
  return (int)cudaGetLastError();
}
