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
// whose sizes are arguments.  The vectors between launches are field-major
// (ng, B) in global memory.
//   forward (2 launches): rt_lin_kernel, then rt_gate_kernel;
//   backward (3 launches, 5 with the parameter sums): rt_gpre_kernel,
//     rt_list_kernel, rt_gx_kernel, then rt_gw_kernel and
//     rt_finish_kernel.
// Replaces, at any width, what the instances replace (nn.py:431 EMLPBlock
// and its autodiff through fixed_gather's VJP, nn.py:39-81) and the general
// engine's GeneralEMLPBlock (general_nn.py:205-240).
// Bound on an H100: the operations.  The SO(3) general block (384 in, 432
// gated, 461 520 nonzeros) at 4096 rows is 5.7-7.0 GFLOP forward (0.085-
// 0.105 ms at the fp32 peak) and ~20 GFLOP backward with the parameter
// sums (0.28-0.32 ms).  What holds the kernels above it is the sparse
// steps' shared memory: each nonzero a warp sums reads two 32 R-row
// vectors of the staged tile, 256 R bytes at 128 bytes a cycle an SM (at
// SO(3) ~0.5 ms for the forward's, ~1 ms for the list step's).  What the
// design does:
//   - The sparse steps (rt_gate_kernel's Q(lin), rt_list_kernel's g_lin)
//     stage the tile's vectors in shared memory field-major, [c][row] at
//     the odd pitch 32 R + 1, and give each lane R rows (1 or 2, the
//     host's choice: 2 from 512 rows where the tile fits): one nonzero's
//     (j, i, v), read once by a warp as a broadcast, serves 32 R rows.
//   - The index reaches shared memory as a stream: each warp walks a
//     contiguous run of entries, copied with cp.async into its ring of
//     kRingBufs buffers of 32 (word, value) entries, three in flight while
//     one is summed, so the gather loops read no global memory; each
//     batch of kBatch entries issues its loads before its sums.  The words
//     are the (j, i) or (o, partner) offsets in the staged tile, packed two
//     to an int by the host (BlockSpec.rt_words).
//   - A few coordinates' lists are 5-6x the mean, so the list step cuts
//     each list into segments of at most 256 entries (fixed by the index:
//     BlockSpec.rt_segments) and deals them to the warps in runs of equal
//     work; each segment's 0.1 sum goes to shared memory and g_lin adds
//     them to g_pre in order after a barrier.
//   - The parameter sums run where their operands are staged.  The list
//     step's block owns slots of the parameters' partial sums: 32-row tile
//     k goes into slot k % 8 (the instances' block_bwd_finish_kernel
//     order), so a block of the list step walks the row tiles t, t + 8 / R,
//     ... and adds each tile's g_v partial (rows in order, from shared
//     memory) to its slot; rt_gw_kernel does the same for g_W and g_b as a
//     register-tiled product over each slot's tiles; rt_finish_kernel adds
//     the 8 slots in order.  Scratch: 8 n_par floats (20 MB at SO(3)).
//   - Enough blocks at few rows: the host spreads the coordinates over
//     block columns (one wave of the blocks the SMs hold), and the list
//     step's grid is the 8 / R slot groups in use times its columns.
//   - The dense steps (lin, g_x, g_W) are register-tiled products of 16 x
//     16 threads, 4 x 4 outputs a thread (64 x 64 a block; 16 rows where
//     64-row blocks would leave SMs idle), the operands staged by cp.async
//     through two buffers, float32 FFMA (no TF32).
// Every sum has one fixed order, with no atomics, so a rerun repeats its
// bits: each lin output's terms in input order, then the bias (the
// instances' forward, bit for bit); each pre's nonzeros in order; each
// g_lin segment's entries in order, then g_pre plus the segments' shares
// in order (one segment: g_pre + 0.1 sum, as before the segments); g_x
// over the coordinates in order; the parameters' tile partials rows in
// order, tile k into slot k % 8, the slots in order (g_v an instance's bit
// for bit).  A tile that does not fit a block's shared memory is read from
// global memory (STAGED false, R = 1), the same sums in the same order.
constexpr int kRtWarps = 16;                // sparse steps: warps a block
constexpr int kRtThreads = kRtWarps * 32;
constexpr int kRing = 32;                   // entries a ring buffer
constexpr int kRingBufs = 4;                // a warp's ring: 3 in flight
constexpr int kBatch = 8;                   // entries whose loads go first
constexpr int kRingFloats = kRtWarps * kRingBufs * kRing * 2;
constexpr int kRtSlots = 8;                 // the parameter sums' slots
constexpr int kGemmThreads = 256;           // dense steps: 16 x 16 threads
constexpr int kGemmTile = 64;               // a block's outputs a side
constexpr int kGemmK = 32;                  // reduction chunk
constexpr int kGemmPitch = kGemmTile + 1;
constexpr int kGpreThreads = 256;
constexpr int kGpreWarps = kGpreThreads / 32;
constexpr int kFwdPlanInts = 4 + 4 * kRtWarps;  // k0 k1 q0 q1, 2 runs a warp
constexpr int kBwdPlanInts = 6 + 2 * kRtWarps;  // v0 v1 c0 c1 g0 g1, a run
                                                // of segments a warp

// The static index of the run-time path (BlockSpec.rt_ints), in this order.
struct RtInts {
  const int* gate;      // NH
  const int* rowptr;    // NG + 1
  const int* ej;        // nnz: j of each nonzero
  const int* ei;        // nnz: i
  const int* eo;        // nnz: o
  const int* cl_e;      // 2 nnz: each list entry's nonzero
  const int* ginv_ptr;  // NG + 1
  const int* ginv_k;    // NH
};

RtInts rt_ints_of(const int* p, int ng, int nh, int nnz) {
  RtInts s;
  s.gate = p;
  s.rowptr = s.gate + nh;
  s.ej = s.rowptr + ng + 1;
  s.ei = s.ej + nnz;
  s.eo = s.ei + nnz;
  s.cl_e = s.eo + nnz;
  s.ginv_ptr = s.cl_e + 2 * nnz;
  s.ginv_k = s.ginv_ptr + ng + 1;
  return s;
}

// A tile's field-major vector as this lane's rows see it: staged, a word's
// half is an offset c (32 R + 1) into shared memory; from global memory it
// is the coordinate c (a row past the batch reads the last row)
template <int R, bool STAGED>
struct RtView {
  const float* base;
  int ld;
  __device__ __forceinline__ RtView(const float* src, int B, int r0,
                                    int rows, int lane) {
    if (STAGED) {
      base = src + lane;
      ld = 32 * R + 1;
    } else {
      base = src + r0 + min(lane, rows - 1);
      ld = B;
    }
  }
  // by a packed word's half (an offset staged, a coordinate otherwise)
  __device__ __forceinline__ float at(unsigned half, int h) const {
    return STAGED ? base[half + 32 * h] : base[(size_t)half * ld];
  }
  // by coordinate
  __device__ __forceinline__ float coord(int c, int h) const {
    return STAGED ? base[c * ld + 32 * h] : base[(size_t)c * ld];
  }
};

// rows [r0, r0 + rows) of a field-major (ng, B) array into a staged tile
// [c][row] at pitch 32 R + 1, zeros past the batch
template <int R>
__device__ __forceinline__ void rt_stage(float* dst, const float* src,
                                         int ng, int B, int r0, int rows) {
  constexpr int kRows = 32 * R;
  for (int q = threadIdx.x; q < ng * kRows; q += blockDim.x) {
    const int c = q / kRows, r = q - c * kRows;
    if (r < rows) cp4(dst + c * (kRows + 1) + r, src + (size_t)c * B + r0 + r);
    else dst[c * (kRows + 1) + r] = 0.0f;
  }
}

// A warp's entries [s0, s1) of (word[e], val[e]) through its ring of
// kRingBufs buffers of kRing entries in shared memory: each lane copies one
// entry of a buffer with cp.async, kRingBufs - 1 buffers in flight ahead of
// the one being read.  Entries [s0, avail) are readable; next() makes the
// next buffer readable and starts the copy of the one after the last in
// flight (into the buffer just read).
struct RtRing {
  int2* buf;
  const int* word;
  const float* val;
  int s0, s1, lane, chunk, avail;

  __device__ __forceinline__ void fill(int c) {
    const int e = s0 + c * kRing + lane;
    if (e < s1) {
      int2* d = buf + (c % kRingBufs) * kRing + lane;
      cp4(&d->x, word + e);
      cp4(&d->y, val + e);
    }
    __pipeline_commit();
  }
  __device__ __forceinline__ void start() {
    // every lane's reads of the ring's last stream are done
    __syncwarp();
    chunk = 0;
    avail = s0;
    for (int c = 0; c < kRingBufs - 1; ++c) fill(c);
  }
  __device__ __forceinline__ void next() {
    // every lane's reads of the buffer refilled below are done
    __syncwarp();
    fill(chunk + kRingBufs - 1);
    __pipeline_wait_prior(kRingBufs - 1);
    // this buffer's copies, each lane's, visible to the warp
    __syncwarp();
    avail = min(s1, s0 + (chunk + 1) * kRing);
    ++chunk;
  }
  __device__ __forceinline__ int2 at(int e) const {
    return buf[(e - s0) & (kRingBufs * kRing - 1)];
  }
};

// N entries e .. e + N - 1 of a warp's ring into its sums, in order: acc[k]
// = fma(v * a[hi][row k], b[lo][row k], acc[k]) (a pre's or a g_lin's term),
// every load of the N entries issued before the first sum
template <int R, int N = kBatch, bool STAGED>
__device__ __forceinline__ void rt_batch(const RtRing& rg,
                                         const RtView<R, STAGED>& a,
                                         const RtView<R, STAGED>& b, int e,
                                         float* acc) {
  int2 en[N];
  float va[N][R], vb[N][R];
#pragma unroll
  for (int u = 0; u < N; ++u) en[u] = rg.at(e + u);
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      va[u][k] = a.at((unsigned)en[u].x >> 16, k);
      vb[u][k] = b.at((unsigned)en[u].x & 0xffff, k);
    }
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int k = 0; k < R; ++k)
      acc[k] = fmaf(__int_as_float(en[u].y) * va[u][k], vb[u][k], acc[k]);
}

// lin = x W_eff^T + b_eff, field-major: a block TR rows (64, or 16 where
// 64-row blocks would leave SMs idle) x 64 outputs, thread (rows rx + 16 m,
// outputs oy + 16 n), x and W_eff in chunks of 32 inputs staged by cp.async
// through two buffers; each output's terms in input order, then the bias
// (the instances' expression)
template <int TR>
__global__ void __launch_bounds__(kGemmThreads)
rt_lin_kernel(const float* __restrict__ x, int B, int nin, int ng,
              const float* __restrict__ W, const float* __restrict__ bias,
              float* __restrict__ lin) {
  constexpr int M = TR / 16;
  __shared__ float xs[2][kGemmK * kGemmPitch];     // [k][row]
  __shared__ float ws[2][kGemmK * kGemmPitch];     // [k][o]
  const int t = threadIdx.x, rx = t & 15, oy = t >> 4;
  const int r0 = blockIdx.x * TR, rows = min(TR, B - r0);
  const int o0 = blockIdx.y * kGemmTile, no = min(kGemmTile, ng - o0);
  auto stage = [&](int buf, int k0) {
    const int kc = min(kGemmK, nin - k0);
    for (int q = t; q < TR * kGemmK; q += kGemmThreads) {
      const int r = q >> 5, k = q & 31;
      if (k < kc && r < rows)
        cp4(&xs[buf][k * kGemmPitch + r], x + (size_t)(r0 + r) * nin + k0 + k);
    }
    for (int q = t; q < kGemmTile * kGemmK; q += kGemmThreads) {
      const int o = q >> 5, k = q & 31;
      if (k < kc && o < no)
        cp4(&ws[buf][k * kGemmPitch + o], W + (size_t)(o0 + o) * nin + k0 + k);
    }
    __pipeline_commit();
  };
  float a[M][4] = {};
  stage(0, 0);
  for (int k0 = 0, it = 0; k0 < nin; k0 += kGemmK, ++it) {
    if (k0 + kGemmK < nin) stage((it + 1) & 1, k0 + kGemmK);
    else __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* xb = xs[it & 1];
    const float* wb = ws[it & 1];
    const int kc = min(kGemmK, nin - k0);
    for (int k = 0; k < kc; ++k) {
      float xv[M], wv[4];
#pragma unroll
      for (int m = 0; m < M; ++m) xv[m] = xb[k * kGemmPitch + rx + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) wv[n] = wb[k * kGemmPitch + oy + 16 * n];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) a[m][n] = fmaf(xv[m], wv[n], a[m][n]);
    }
    // every read of this buffer before the copy into it two chunks on
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int o = oy + 16 * n;
    if (o >= no) continue;
    const float bo = bias[o0 + o];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int r = rx + 16 * m;
      if (r < rows) lin[(size_t)(o0 + o) * B + r0 + r] = a[m][n] + bo;
    }
  }
}

// pre for a block column's coordinates and h for its outputs.  Block
// (tile of 32 R rows, column); plan per column: k0 k1 q0 q1 (its atoms'
// outputs and gate coordinates), then per warp two runs of coordinates
// (contiguous, so their nonzeros are contiguous in the index); a warp sums
// each coordinate's nonzeros in order (pre = 0.1 q + lin, the instances'
// expression), R rows a lane, then after a barrier h = pre / (1 +
// exp(-pre[gate])) for the column's outputs, a thread a (row, output)
template <int R, bool STAGED>
__global__ void __launch_bounds__(kRtThreads)
rt_gate_kernel(const float* __restrict__ lin, int B, int ng, int nh,
               const float* __restrict__ v, const int* __restrict__ word,
               const int* __restrict__ rowptr, const int* __restrict__ gate,
               const int* __restrict__ plan, float* __restrict__ h,
               float* __restrict__ pre) {
  static_assert(STAGED || R == 1, "a tile in global memory is 32 rows");
  constexpr int kRows = 32 * R;
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int2* ring = reinterpret_cast<int2*>(sm) + warp * kRingBufs * kRing;
  float* lt = sm + kRingFloats;
  const int r0 = blockIdx.x * kRows, rows = min(kRows, B - r0);
  const int* col = plan + blockIdx.y * kFwdPlanInts;
  if (STAGED) {
    rt_stage<R>(lt, lin, ng, B, r0, rows);
    cp_wait();
    __syncthreads();
  }
  const RtView<R, STAGED> l(STAGED ? lt : lin, B, r0, rows, lane);
  for (int part = 0; part < 2; ++part) {
    const int a = col[4 + 4 * warp + 2 * part];
    const int b = col[5 + 4 * warp + 2 * part];
    if (a >= b) continue;
    RtRing rg{ring, word, v, rowptr[a], rowptr[b], lane, 0, 0};
    rg.start();
    int e = rg.s0;
    for (int c = a; c < b; ++c) {
      const int e1 = rowptr[c + 1];
      float q[R];
#pragma unroll
      for (int k = 0; k < R; ++k) q[k] = 0.0f;
      while (e < e1) {
        if (e == rg.avail) rg.next();
        const int m = min(e1, rg.avail);
        for (; e + kBatch <= m; e += kBatch) rt_batch<R>(rg, l, l, e, q);
        for (; e < m; ++e) rt_batch<R, 1>(rg, l, l, e, q);
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float p = 0.1f * q[k] + l.coord(c, k);
        if (lane + 32 * k < rows) pre[(size_t)c * B + r0 + lane + 32 * k] = p;
      }
    }
  }
  // every pre this block reads below it wrote above
  __syncthreads();
  const int k0 = col[0], nk = col[1] - k0;
  for (int q = t; q < rows * nk; q += kRtThreads) {
    const int r = q / nk, k = k0 + q - r * nk;
    const size_t row = (size_t)r0 + r;
    h[row * nh + k] = pre[(size_t)k * B + row] /
                      (1.0f + expf(-pre[(size_t)gate[k] * B + row]));
  }
}

// g_pre, a warp a coordinate, a lane a row (the instances' expression),
// blockIdx.z 0; blockIdx.z 1: the list entries' values in list order, vl[e]
// = v[cl_e[e]] (2 nnz), which the list step streams beside its words
__global__ void __launch_bounds__(kGpreThreads)
rt_gpre_kernel(const float* __restrict__ g_h, const float* __restrict__ pre,
               int B, int ng, int nh, const float* __restrict__ v, int nnz,
               RtInts ix, float* __restrict__ gpre, float* __restrict__ vl) {
  if (blockIdx.z == 1) {
    const int stride = gridDim.x * gridDim.y * kGpreThreads;
    for (int q = (blockIdx.y * gridDim.x + blockIdx.x) * kGpreThreads +
                 threadIdx.x;
         q < 2 * nnz; q += stride)
      vl[q] = v[ix.cl_e[q]];
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * kGpreWarps + warp;
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

// The list step.  Block (slot group u, column): the row tiles of 32 R rows
// t = u, u + 8 / R, ... in order (32-row tiles t R .. t R + R - 1, so the
// block owns slots u R .. u R + R - 1).  A coordinate's list is cut into
// segments of at most RT_SEG entries (the host's BlockSpec.rt_segments:
// seg, each segment's first entry, and cseg, each coordinate's first
// segment), which the plan deals to the column's warps in runs of about
// equal entries, so a long list spreads over several warps.  Plan per
// column: v0 v1 (the nonzeros whose g_v it sums), c0 c1 (its coordinates),
// g0 g1 (their segments), then each warp's run of segments.  Per tile: the
// tile's g_pre and lin staged; each warp streams its segments' entries (the
// words and vl, the values in list order, through its ring) and stores
// 0.1 (the segment's sum, in order) in shared memory; after a barrier,
// g_lin = g_pre + each segment's share in segment order (the instances'
// finishing expression; one segment: the first design's g_pre + 0.1 sum).
// With the parameter sums, g_v's partial of the nonzeros v0:v1 (a thread a
// nonzero, each 32-row tile's rows in order: the instances' expression)
// is added to the tile's slot, 8 n_par scratch (slots, stride n_par) that
// only this block writes.
template <int R, bool STAGED>
__global__ void __launch_bounds__(kRtThreads)
rt_list_kernel(const float* __restrict__ gpre, const float* __restrict__ lin,
               int B, int ng, const float* __restrict__ vl, RtInts ix,
               const int* __restrict__ word, const int* __restrict__ seg,
               const int* __restrict__ cseg, const int* __restrict__ plan,
               int need_params, float* __restrict__ glin,
               float* __restrict__ gv_slots, int n_par) {
  static_assert(STAGED || R == 1, "a tile in global memory is 32 rows");
  constexpr int kRows = 32 * R, kP = kRows + 1;
  constexpr int kGroups = kRtSlots / R;
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int2* ring = reinterpret_cast<int2*>(sm) + warp * kRingBufs * kRing;
  float* gt = sm + kRingFloats;
  float* lt = gt + ng * kP;
  float* segp = STAGED ? lt + ng * kP : gt;           // [segment][row]
  const int* col = plan + blockIdx.y * kBwdPlanInts;
  const int v0 = col[0], v1 = col[1], c0 = col[2], c1 = col[3], g0 = col[4];
  const int sa = col[6 + 2 * warp], sb = col[7 + 2 * warp];
  const int n_tiles = (B + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += kGroups) {
    const int r0 = tile * kRows, rows = min(kRows, B - r0);
    // the last tile's reads (its tiles, its segments' shares) before this
    // one's writes
    __syncthreads();
    if (STAGED) {
      rt_stage<R>(gt, gpre, ng, B, r0, rows);
      rt_stage<R>(lt, lin, ng, B, r0, rows);
      cp_wait();
      __syncthreads();
    }
    const RtView<R, STAGED> gp(STAGED ? gt : gpre, B, r0, rows, lane);
    const RtView<R, STAGED> l(STAGED ? lt : lin, B, r0, rows, lane);
    if (sa < sb) {
      RtRing rg{ring, word, vl, seg[sa], seg[sb], lane, 0, 0};
      rg.start();
      int e = rg.s0;
      for (int s = sa; s < sb; ++s) {
        const int e1 = seg[s + 1];
        float acc[R];
#pragma unroll
        for (int k = 0; k < R; ++k) acc[k] = 0.0f;
        while (e < e1) {
          if (e == rg.avail) rg.next();
          const int m = min(e1, rg.avail);
          for (; e + kBatch <= m; e += kBatch) rt_batch<R>(rg, gp, l, e, acc);
          for (; e < m; ++e) rt_batch<R, 1>(rg, gp, l, e, acc);
        }
#pragma unroll
        for (int k = 0; k < R; ++k)
          segp[(s - g0) * kRows + lane + 32 * k] = __fmul_rn(0.1f, acc[k]);
      }
    }
    // every segment's share written
    __syncthreads();
    for (int q = t; q < (c1 - c0) * kRows; q += kRtThreads) {
      const int cl = q / kRows, r = q - cl * kRows, c = c0 + cl;
      if (r >= rows) continue;
      float g = STAGED ? gt[c * kP + r] : gpre[(size_t)c * B + r0 + r];
      for (int s = cseg[c]; s < cseg[c + 1]; ++s)
        g = __fadd_rn(g, segp[(s - g0) * kRows + r]);
      glin[(size_t)c * B + r0 + r] = g;
    }
    if (!need_params) continue;
    for (int e = v0 + t; e < v1; e += kRtThreads) {
      const int o = ix.eo[e], j = ix.ej[e], i = ix.ei[e];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int nr = min(32, rows - 32 * k);
        if (nr <= 0) break;
        const float *go, *lj, *li;
        if (STAGED) {
          go = gt + o * kP + 32 * k;
          lj = lt + j * kP + 32 * k;
          li = lt + i * kP + 32 * k;
        } else {
          go = gpre + (size_t)o * B + r0;
          lj = lin + (size_t)j * B + r0;
          li = lin + (size_t)i * B + r0;
        }
        float s = 0.0f;
        for (int r = 0; r < nr; ++r) s += 0.1f * go[r] * lj[r] * li[r];
        const int k32 = tile * R + k;
        float* out = gv_slots + (size_t)(k32 % kRtSlots) * n_par + e;
        *out = (k32 < kRtSlots ? 0.0f : *out) + s;
      }
    }
  }
}

// g_x = g_lin W_eff: a block TR rows (64 or 16, as rt_lin_kernel) x 64
// inputs, thread (rows ry + 16 m, inputs kx + 16 n), g_lin and W_eff in
// chunks of 32 coordinates staged by cp.async through two buffers, the
// coordinates in order
template <int TR>
__global__ void __launch_bounds__(kGemmThreads)
rt_gx_kernel(const float* __restrict__ glin, const float* __restrict__ W,
             int B, int ng, int nin, float* __restrict__ g_x) {
  constexpr int M = TR / 16;
  __shared__ float gs[2][kGemmK * kGemmPitch];     // [c][row]
  __shared__ float ws[2][kGemmK * kGemmPitch];     // [c][k]
  const int t = threadIdx.x, kx = t & 15, ry = t >> 4;
  const int r0 = blockIdx.x * TR, rows = min(TR, B - r0);
  const int k0 = blockIdx.y * kGemmTile, nk = min(kGemmTile, nin - k0);
  auto stage = [&](int buf, int c0) {
    const int cc = min(kGemmK, ng - c0);
    for (int q = t; q < kGemmK * TR; q += kGemmThreads) {
      const int c = q / TR, i = q - c * TR;
      if (c < cc && i < rows)
        cp4(&gs[buf][c * kGemmPitch + i], glin + (size_t)(c0 + c) * B + r0 + i);
    }
    for (int q = t; q < kGemmK * kGemmTile; q += kGemmThreads) {
      const int c = q >> 6, i = q & 63;
      if (c < cc && i < nk)
        cp4(&ws[buf][c * kGemmPitch + i], W + (size_t)(c0 + c) * nin + k0 + i);
    }
    __pipeline_commit();
  };
  float a[M][4] = {};
  stage(0, 0);
  for (int c0 = 0, it = 0; c0 < ng; c0 += kGemmK, ++it) {
    if (c0 + kGemmK < ng) stage((it + 1) & 1, c0 + kGemmK);
    else __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* gb = gs[it & 1];
    const float* wb = ws[it & 1];
    const int cc = min(kGemmK, ng - c0);
    for (int c = 0; c < cc; ++c) {
      float gv[M], wv[4];
#pragma unroll
      for (int m = 0; m < M; ++m) gv[m] = gb[c * kGemmPitch + ry + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) wv[n] = wb[c * kGemmPitch + kx + 16 * n];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) a[m][n] = fmaf(gv[m], wv[n], a[m][n]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r = ry + 16 * m;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int k = kx + 16 * n;
      if (k < nk) g_x[(size_t)(r0 + r) * nin + k0 + k] = a[m][n];
    }
  }
}

// g_W (ng, nin) and g_b (ng, as an input column of ones) into slot s: a
// block 64 coordinates x 64 inputs (of nin + 1) and slot s = blockIdx.z,
// thread (coordinates cy + 16 m, inputs kx + 16 n); the 32-row tiles s, s +
// 8, ... in order, each tile's partial rows in order from zero, added to
// the slot's sum (the instances' order), the tiles staged by cp.async
// through two buffers
__global__ void __launch_bounds__(kGemmThreads)
rt_gw_kernel(const float* __restrict__ glin, const float* __restrict__ x,
             int B, int ng, int nin, float* __restrict__ slots, int n_par) {
  __shared__ float gs[2][kGemmTile * (kTile + 1)];   // [c][row]
  __shared__ float xs[2][kTile * kGemmPitch];        // [row][k]
  const int t = threadIdx.x, kx = t & 15, cy = t >> 4;
  const int k0 = blockIdx.x * kGemmTile, c0 = blockIdx.y * kGemmTile;
  const int slot = blockIdx.z, n_tiles = (B + kTile - 1) / kTile;
  const int nc = min(kGemmTile, ng - c0);
  auto stage = [&](int buf, int tile) {
    const int r0 = tile * kTile, rows = min(kTile, B - r0);
    for (int q = t; q < kGemmTile * kTile; q += kGemmThreads) {
      const int c = q >> 5, r = q & 31;
      if (c < nc && r < rows)
        cp4(&gs[buf][c * (kTile + 1) + r], glin + (size_t)(c0 + c) * B + r0 + r);
    }
    for (int q = t; q < kTile * kGemmTile; q += kGemmThreads) {
      const int r = q >> 6, k = q & 63, kk = k0 + k;
      if (r < rows) {
        if (kk < nin)
          cp4(&xs[buf][r * kGemmPitch + k], x + (size_t)(r0 + r) * nin + kk);
        else
          xs[buf][r * kGemmPitch + k] = kk == nin ? 1.0f : 0.0f;
      }
    }
    __pipeline_commit();
  };
  float s[4][4] = {};
  stage(0, slot);
  for (int tile = slot, it = 0; tile < n_tiles; tile += kRtSlots, ++it) {
    if (tile + kRtSlots < n_tiles) stage((it + 1) & 1, tile + kRtSlots);
    else __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* gb = gs[it & 1];
    const float* xb = xs[it & 1];
    const int rows = min(kTile, B - tile * kTile);
    float p[4][4] = {};
    for (int r = 0; r < rows; ++r) {
      float gv[4], xv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) gv[m] = gb[(cy + 16 * m) * (kTile + 1) + r];
#pragma unroll
      for (int n = 0; n < 4; ++n) xv[n] = xb[r * kGemmPitch + kx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) p[m][n] = fmaf(gv[m], xv[n], p[m][n]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) s[m][n] += p[m][n];
    __syncthreads();
  }
  float* out = slots + (size_t)slot * n_par;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c = cy + 16 * m;
    if (c >= nc) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int k = k0 + kx + 16 * n;
      if (k < nin) out[(size_t)(c0 + c) * nin + k] = s[m][n];
      else if (k == nin) out[(size_t)ng * nin + c0 + c] = s[m][n];
    }
  }
}

// the parameter gradients: the slots added in order (block_bwd_finish_kernel's
// sums[0] + sums[1] + ... , an empty slot adding zero)
__global__ void __launch_bounds__(kGemmThreads)
rt_finish_kernel(const float* __restrict__ slots, int n_slots, int n_par,
                 float* __restrict__ g_par) {
  const int q = blockIdx.x * kGemmThreads + threadIdx.x;
  if (q >= n_par) return;
  float tot = slots[q];
#pragma unroll
  for (int s = 1; s < kRtSlots; ++s)
    tot += s < n_slots ? slots[(size_t)s * n_par + q] : 0.0f;
  g_par[q] = tot;
}

}  // namespace

// The run-time path's geometry: 0 threads of a sparse step's block, 1
// entries a ring buffer, 2 the parameter sums' slots, 3 a dense step's
// tile side, 4 the shared-memory floats of a sparse block's rings.
extern "C" int emlp_block_rt_geometry(int which) {
  return which == 0   ? kRtThreads
         : which == 1 ? kRing
         : which == 2 ? kRtSlots
         : which == 3 ? kGemmTile
                      : kRingFloats;
}

namespace {

// rows a block of the dense steps: 64, or 16 where 64-row blocks would not
// give every SM one (the device's SM count, read once a device)
int rt_gemm_rows(int B, int col_blocks) {
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return kGemmTile;
  if (!sms[dev] && cudaDeviceGetAttribute(
                       &sms[dev], cudaDevAttrMultiProcessorCount, dev) !=
                       cudaSuccess)
    return kGemmTile;
  return (B + kGemmTile - 1) / kGemmTile * col_blocks >= sms[dev] ? kGemmTile
                                                                  : 16;
}

template <int R, bool STAGED>
int rt_gate_launch(dim3 grid, size_t smem, cudaStream_t st, const float* lin,
                   int B, int ng, int nh, const float* v, const int* word,
                   const RtInts& ix, const int* plan, float* h, float* pre) {
  // per instance (the instances share a type): its dynamic shared memory
  static size_t done[kMaxDevices] = {0};
  cudaError_t e = set_smem(rt_gate_kernel<R, STAGED>, smem, done);
  if (e != cudaSuccess) return (int)e;
  rt_gate_kernel<R, STAGED><<<grid, kRtThreads, smem, st>>>(
      lin, B, ng, nh, v, word, ix.rowptr, ix.gate, plan, h, pre);
  return (int)cudaGetLastError();
}

template <int R, bool STAGED>
int rt_list_launch(dim3 grid, size_t smem, cudaStream_t st, const float* gpre,
                   const float* lin, int B, int ng, const float* vl,
                   const RtInts& ix, const int* word, const int* seg,
                   const int* cseg, const int* plan, int need_params,
                   float* glin, float* gv_slots, int n_par) {
  static size_t done[kMaxDevices] = {0};
  cudaError_t e = set_smem(rt_list_kernel<R, STAGED>, smem, done);
  if (e != cudaSuccess) return (int)e;
  rt_list_kernel<R, STAGED><<<grid, kRtThreads, smem, st>>>(
      gpre, lin, B, ng, vl, ix, word, seg, cseg, plan, need_params, glin,
      gv_slots, n_par);
  return (int)cudaGetLastError();
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

// Run-time widths (any (nin, ng, nh)): rt_ints the block's BlockSpec.rt_ints,
// words its rt_words (the forward's nnz (j, i) words; BlockSpec.rt_layout
// picks rows_a_lane R, 1 or 2, and staged), plan its rt_plan("forward")
// (n_cols columns of kFwdPlanInts ints).  lin and pre (ng, B) are always
// written (the gate step reads both).  Two launches: rt_lin_kernel, then
// rt_gate_kernel over (tiles of 32 R rows) x n_cols.
extern "C" int emlp_block_rt_fwd_launch(const void* x, int B, const void* W,
                                        const void* b, const void* v,
                                        const void* rt_ints, int nnz,
                                        const void* words, const void* plan,
                                        int n_cols, int rows_a_lane,
                                        int staged, void* h, void* lin,
                                        void* pre, int nin, int ng, int nh,
                                        void* stream) {
  if (B <= 0 || nnz < 0 || nin <= 0 || ng <= 0 || nh <= 0 || nh > ng ||
      n_cols <= 0 || lin == nullptr || pre == nullptr ||
      !(rows_a_lane == 1 || (rows_a_lane == 2 && staged)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const RtInts ix = rt_ints_of((const int*)rt_ints, ng, nh, nnz);
  const int o_blocks = (ng + kGemmTile - 1) / kGemmTile;
  if (rt_gemm_rows(B, o_blocks) == kGemmTile)
    rt_lin_kernel<kGemmTile><<<dim3((B + kGemmTile - 1) / kGemmTile,
                                    o_blocks), kGemmThreads, 0, st>>>(
        (const float*)x, B, nin, ng, (const float*)W, (const float*)b,
        (float*)lin);
  else
    rt_lin_kernel<16><<<dim3((B + 15) / 16, o_blocks), kGemmThreads, 0,
                         st>>>((const float*)x, B, nin, ng, (const float*)W,
                               (const float*)b, (float*)lin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = 32 * rows_a_lane;
  const dim3 grid((B + rows - 1) / rows, n_cols);
  const size_t smem =
      kRingFloats * 4 + (staged ? (size_t)ng * (rows + 1) * 4 : 0);
  const float* l = (const float*)lin;
  const float* vv = (const float*)v;
  const int* w = (const int*)words;
  const int* p = (const int*)plan;
  if (!staged)
    return rt_gate_launch<1, false>(grid, smem, st, l, B, ng, nh, vv, w, ix,
                                    p, (float*)h, (float*)pre);
  if (rows_a_lane == 2)
    return rt_gate_launch<2, true>(grid, smem, st, l, B, ng, nh, vv, w, ix,
                                   p, (float*)h, (float*)pre);
  return rt_gate_launch<1, true>(grid, smem, st, l, B, ng, nh, vv, w, ix, p,
                                 (float*)h, (float*)pre);
}

// Run-time widths: words the block's list words (2 nnz (o, partner) words),
// segs its rt_segments (n_seg + 1 segment starts, then ng + 1 first
// segments), plan its rt_plan("backward") (n_cols columns of kBwdPlanInts
// ints, a column at most max_segs segments), R and staged as the
// forward's; gpre and glin (ng, B) and vl (2 nnz) scratch; with
// need_params slots (8, n_par) scratch and g_par (ng nin + ng + nnz)
// written.  Three launches (rt_gpre_kernel, which also gathers vl;
// rt_list_kernel over (8 / R slot groups) x n_cols; rt_gx_kernel), five
// with the parameter sums (rt_gw_kernel over its tiles x the slots in use,
// rt_finish_kernel).
extern "C" int emlp_block_rt_bwd_launch(
    const void* g_h, const void* x, int B, const void* W, const void* v,
    const void* rt_ints, int nnz, const void* words, const void* segs,
    int n_seg, const void* lin, const void* pre, const void* plan,
    int n_cols, int max_segs, int rows_a_lane, int staged, void* gpre,
    void* glin, void* vl, void* g_x, void* slots, void* g_par,
    int need_params, int nin, int ng, int nh, void* stream) {
  if (B <= 0 || nnz < 0 || nin <= 0 || ng <= 0 || nh <= 0 || nh > ng ||
      n_cols <= 0 || n_seg < 0 || max_segs < 0 ||
      !(rows_a_lane == 1 || (rows_a_lane == 2 && staged)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const RtInts ix = rt_ints_of((const int*)rt_ints, ng, nh, nnz);
  rt_gpre_kernel<<<dim3((B + kTile - 1) / kTile,
                        (ng + kGpreWarps - 1) / kGpreWarps, 2),
                   kGpreThreads, 0, st>>>((const float*)g_h,
                                          (const float*)pre, B, ng, nh,
                                          (const float*)v, nnz, ix,
                                          (float*)gpre, (float*)vl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_par = (long long)ng * nin + ng + nnz;
  const int rows = 32 * rows_a_lane, tiles = (B + rows - 1) / rows;
  const dim3 grid(min(kRtSlots / rows_a_lane, tiles), n_cols);
  const size_t smem = kRingFloats * 4 +
                      (staged ? (size_t)2 * ng * (rows + 1) * 4 : 0) +
                      (size_t)max_segs * rows * 4;
  const int* sg = (const int*)segs;
  const int* cs = sg + n_seg + 1;
  float* gv = (float*)slots + (size_t)ng * nin + ng;
  const float* gp = (const float*)gpre;
  const float* l = (const float*)lin;
  const float* vv = (const float*)vl;
  const int* w = (const int*)words;
  const int* p = (const int*)plan;
  int err;
  if (!staged)
    err = rt_list_launch<1, false>(grid, smem, st, gp, l, B, ng, vv, ix, w,
                                   sg, cs, p, need_params, (float*)glin, gv,
                                   (int)n_par);
  else if (rows_a_lane == 2)
    err = rt_list_launch<2, true>(grid, smem, st, gp, l, B, ng, vv, ix, w,
                                  sg, cs, p, need_params, (float*)glin, gv,
                                  (int)n_par);
  else
    err = rt_list_launch<1, true>(grid, smem, st, gp, l, B, ng, vv, ix, w,
                                  sg, cs, p, need_params, (float*)glin, gv,
                                  (int)n_par);
  if (err != cudaSuccess) return err;
  const int k_blocks = (nin + kGemmTile - 1) / kGemmTile;
  if (rt_gemm_rows(B, k_blocks) == kGemmTile)
    rt_gx_kernel<kGemmTile><<<dim3((B + kGemmTile - 1) / kGemmTile,
                                   k_blocks), kGemmThreads, 0, st>>>(
        (const float*)glin, (const float*)W, B, ng, nin, (float*)g_x);
  else
    rt_gx_kernel<16><<<dim3((B + 15) / 16, k_blocks), kGemmThreads, 0,
                        st>>>((const float*)glin, (const float*)W, B, ng,
                              nin, (float*)g_x);
  e = cudaGetLastError();
  if (e != cudaSuccess || !need_params) return (int)e;
  const int n_tiles = (B + kTile - 1) / kTile;
  const int n_slots = n_tiles < kRtSlots ? n_tiles : kRtSlots;
  rt_gw_kernel<<<dim3((nin + kGemmTile) / kGemmTile,
                      (ng + kGemmTile - 1) / kGemmTile, n_slots),
                 kGemmThreads, 0, st>>>((const float*)glin, (const float*)x,
                                        B, ng, nin, (float*)slots,
                                        (int)n_par);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rt_finish_kernel<<<(unsigned)((n_par + kGemmThreads - 1) / kGemmThreads),
                     kGemmThreads, 0, st>>>((const float*)slots, n_slots,
                                            (int)n_par, (float*)g_par);
  return (int)cudaGetLastError();
}
