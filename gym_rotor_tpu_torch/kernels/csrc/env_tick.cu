// K1: fused lockstep env tick for Hopper (sm_90a).
//
// Replaces gym_rotor_tpu/envs/batch.py:batched_step (trajectory.get_desired
// -> quad.step -> dynamics.{euler,rk4,dop853}_step -> so3.polar_fast or
// ensure_so3_exact -> norm_error_state/build_obs -> reward/done ->
// cap/solved override -> dense fresh episode + select), which XLA fused into
// one program on the TPU, for the MODUL (decoupled) and the MONO (coupled,
// quad.py:91-93, 178-184, 206-216, 247-255) tasks; and the Gym API's
// single-env step, gym_rotor_tpu/envs/gym_api.py:74 jit(quad.step(cfg, s, a,
// task)), for those two and the base quad task (quad.py:68-80, 234-284,
// 304-354).  Plain twins: gym_rotor_tpu_torch/envs/batch.py:batched_step_plain
// and batched_reset_plain, and kernels/env_tick.py:env_step_plain.
//
// Bound on an H100: ~0.5 KB of state read and written per env and a few
// thousand flops, i.e. ~5 MB / ~30 MFLOP per tick at B = 4096, ~1.5 us of
// HBM time.  What a launch takes is one env's dependent chain and the
// memory instructions around it.  A clock64 trace of the one-thread-per-env
// design this replaced (PERF.md, scripts/env_tick_phase_probe.py) found its
// loads and stores strided by each field's width (lane i at F*B + i*w + c,
// up to 32 lines an instruction: half a warp's time in the stores), the
// fresh episode run after the tick in every warp with an ended env, and
// DOP853's 12 evaluations of the equations of motion a third of the warp.
//
// Design, tick entry (env_tile_kernel): a block takes a tile of
// kTile = 32 envs.  Every buffer moves between global memory and shared
// memory in whole runs: field F of width w of the tile's envs is one
// contiguous run of 32 w scalars, copied coalesced into an image in the
// same order (in by the four tick warps, out by all five), so the per-env
// code indexes the image as it indexes the buffers (FIDX with B = kTile);
// the fields are shared among the warps by a plan made on the host
// (kernels/env_tick.py copy_plan), each lane's loads all issued before its
// stores.  Warps 0-3 tick the tile,
// four lanes an env: each lane computes the whole tick (the four agree bit
// for bit) except the integrator, where lane k holds axis k of (x, v, R, W)
// and evaluates row k of the equations of motion, taking W from its group
// by three shuffles an evaluation.  The tick writes its outputs and its
// stepped state over the image in place.  Warp 4 computes the fresh
// episode of every env of the tile, one lane an env, from the launch's
// start, beside the copy in and the tick (JAX's dense fresh + select: the
// fresh chain reads only the draws and the config, not the stepped state).
// After one barrier the copy out takes, per env, the fresh state and obs
// where the episode is over, else the ticked ones.
// DOP853 evaluates the equations of motion 12 times (RK4: 4) and keeps
// 12 stages of the lane's 6 floats live (chip_smoke.py phase 1 prints each
// instance's registers).  The step and reset entries (env_thread_kernel)
// keep one thread an env and one chain: the Gym API steps one env a
// launch, where only the launch is left, and a reset runs once a run.
//
// Every expression is the one-thread design's, in its order, on whichever
// lane computes it, so every output is bitwise that design's (checked by
// scripts/tick_replay_vs_parent.py).  Random draws are injected as a
// (B, N_DRAWS) tensor of U[0,1) base draws (layout: envs/draws.py) and
// mapped the way jax.random.uniform maps them; in-kernel Philox is a later
// optimization.
//
// Entries (a runtime argument): the tick; the reset (fresh episodes only);
// the step alone (JAX's quad.step on B envs in lockstep, in place: the goal
// read from the state's env.goal, no trajectory, no cap/solved override, no
// fresh episode; only the fields quad.step changes are written).
//
// Numerics: built with -fmad=false and without fast math, so every
// expression rounds where the plain twin rounds; the association order of
// every sum follows the JAX code (mm3/mv3/dot3 fixed order).  Constants JAX
// folds in Python float64 are folded in double here and rounded once.
// DOP853's coefficients are scipy's, emitted as exact hex literals into the
// generated header and rounded once to float, as dt * float(a) in the twin.
//
// Instances: Task<TASK> (decoupled, coupled) x integrator (euler, rk4,
// dop853) x EXACT (the exact_so3 repair on every read of R, the stored R
// left drifted; else one 2-iteration polar step a tick): 12; and the quad
// task x integrator with EXACT only (the Gym API forces exact_so3,
// gym_api.py:56), which has the step entry only: 15.  The trajectory mode
// is a runtime argument, uniform over the grid, so its switch does not
// diverge.  What differs between the tasks (action map, obs, reward/done,
// whether the step updates the integrals, the output slots) sits in
// Task<TASK>; the dynamics, the trajectory machine, the errors and
// integrals, the cap/solved override and the fresh episode are one code
// path.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "env_tick_layout.h"

namespace {

constexpr double PI_D = 3.14159265358979323846;
constexpr float PI_F = (float)PI_D;
constexpr float G_STD = (float)9.81;
constexpr float DT = (float)(1.0 / 200);
constexpr float X_LIM = 1.0f;
constexpr float V_LIM = 4.0f;
constexpr float W_LIM = (float)(2.0 * PI_D);
constexpr float EIX_LIM = 3.0f;
constexpr float EIB1_LIM = 3.0f;
constexpr float SAT = 1.0f;
constexpr float EULER_LIM_DEG = 85.0f;
// 180 / pi as quad.done_quad folds it in Python float64, rounded once
constexpr float R2D = (float)(180.0 / PI_D);
constexpr float MIN_FORCE = 0.5f;
constexpr float IDLE_LO = (float)(-25.0 * PI_D / 180.0);
constexpr float IDLE_HI = (float)(25.0 * PI_D / 180.0);

// trajectory constants (trajectory.py:30-50, 156-357), folded in double as
// Python folds them, rounded once
constexpr float HOVER_T_LO = 2.0f, HOVER_T_HI = 5.0f;
constexpr float HOVER_W_LO = (float)(-0.15 * PI_D);
constexpr float HOVER_W_HI = (float)(0.15 * PI_D);
// -jnp.log(0.001): the float64 value rounded once equals logf(0.001f)
constexpr float NEG_LOG_0001 = (float)NEG_LOG_0001_D;
constexpr float TAKEOFF_END_HEIGHT = -0.5f;
constexpr float TAKEOFF_VELOCITY = (float)-0.05;
constexpr float LANDING_VELOCITY = 1.0f;
constexpr float LANDING_CUTOFF_HEIGHT = -0.25f;
constexpr double CIRCLE_RADIUS_D = 0.7, CIRCLE_LINEAR_V_D = 0.4, CIRCLE_W_D = 0.4;
constexpr float CIRCLE_RADIUS = (float)CIRCLE_RADIUS_D;
constexpr float CIRCLE_LINEAR_V = (float)CIRCLE_LINEAR_V_D;
constexpr float CIRCLE_W = (float)CIRCLE_W_D;
constexpr float CIRCLE_LEAD_T = (float)(CIRCLE_RADIUS_D / CIRCLE_LINEAR_V_D);
constexpr float CIRCLE_T_TRAJ =
    (float)(CIRCLE_RADIUS_D / CIRCLE_LINEAR_V_D + 2 * 2.0 * PI_D / CIRCLE_W_D);
constexpr float CIRCLE_RW = (float)(CIRCLE_RADIUS_D * CIRCLE_W_D);
constexpr float NEG_CIRCLE_RW = (float)(-CIRCLE_RADIUS_D * CIRCLE_W_D);
constexpr float NEG_CIRCLE_W = (float)(-CIRCLE_W_D);
constexpr double EIGHT_T_D = 9.0;
constexpr float EIGHT_T_TRAJ = (float)(3 * EIGHT_T_D);
constexpr float EIGHT_A1 = 1.5f;
constexpr float EIGHT_A2 = 1.0f;
constexpr float EIGHT_W1 = (float)(2.0 * PI_D / EIGHT_T_D);
constexpr float EIGHT_W2 = (float)(4.0 * PI_D / EIGHT_T_D);
constexpr float EIGHT_W_B1D = (float)0.349066;
// -math.log(0.01) / 9.0 in double (log is not constexpr in C++: the value
// is generated into the header as a hex literal, as NEG_LOG_0001_D)
constexpr float EIGHT_EXP_XY = (float)EIGHT_EXP_XY_D;
constexpr float NEG_EIGHT_EXP_XY = (float)(-EIGHT_EXP_XY_D);
constexpr float EIGHT_ALT_D = (float)-0.6;
// is_rotation's bounds (so3.py:110-121): tol + tol * I and 1e-8 + tol
constexpr float SO3_TOL = (float)1e-5;
constexpr float SO3_DET_TOL = (float)(1e-8 + 1e-5 * 1.0);

struct Coefs {
  float Cx, CIx, Cv, Cw12, Cb1, CIb1, CW3, alpha, beta, udm_u, udm_u_half,
      rmin1, slope1, rmin2, slope2, rmin, slope;
};

struct Args {
  const float* sf;
  const int* si;
  const bool* sb;
  float* of;
  int* oi;
  bool* ob;
  const float* act;
  const float* draws;
  float* outf;
  bool* outb;
  int B, env_type, max_steps, use_udm, mode;
  Coefs c;
};

// ---------------------------------------------------------------- 3x3 math
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ __forceinline__ void hat(const float* w, float* H) {
  H[0] = 0.0f;  H[1] = -w[2]; H[2] = w[1];
  H[3] = w[2];  H[4] = 0.0f;  H[5] = -w[0];
  H[6] = -w[1]; H[7] = w[0];  H[8] = 0.0f;
}

__device__ __forceinline__ void mm3(const float* A, const float* Bm, float* C) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      C[r * 3 + c] = (A[r * 3 + 0] * Bm[c] + A[r * 3 + 1] * Bm[3 + c]) +
                     A[r * 3 + 2] * Bm[6 + c];
}

__device__ __forceinline__ void mv3(const float* A, const float* b, float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = (A[r * 3 + 0] * b[0] + A[r * 3 + 1] * b[1]) + A[r * 3 + 2] * b[2];
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void inv3(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2];
  const float d = M[3], e = M[4], f = M[5];
  const float g = M[6], h = M[7], i = M[8];
  const float A = e * i - f * h;
  const float Bc = -(d * i - f * g);
  const float C = d * h - e * g;
  const float det = (a * A + b * Bc) + c * C;
  const float inv_det = 1.0f / det;
  const float adj[9] = {A,  -(b * i - c * h), b * f - c * e,
                        Bc, a * i - c * g,    -(a * f - c * d),
                        C,  -(a * h - b * g), a * e - b * d};
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = adj[k] * inv_det;
}

template <int ITERS>
__device__ __forceinline__ void polar_fast(float* R) {
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    float Ri[9];
    inv3(R, Ri);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) R[r * 3 + c] = 0.5f * (R[r * 3 + c] + Ri[c * 3 + r]);
  }
}

// so3.is_rotation: R^T R as fixed-order mm3, det as inv3's cofactor row.
__device__ __forceinline__ bool is_rotation(const float* R) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rtr = (R[r] * R[c] + R[3 + r] * R[3 + c]) + R[6 + r] * R[6 + c];
      const float eye = r == c ? 1.0f : 0.0f;
      ok = ok && fabsf(rtr - eye) <= SO3_TOL + SO3_TOL * eye;
    }
  const float a = R[0], b = R[1], c = R[2];
  const float d = R[3], e = R[4], f = R[5];
  const float g = R[6], h = R[7], i = R[8];
  const float det = (a * (e * i - f * h) + b * (-(d * i - f * g))) + c * (d * h - e * g);
  return ok && fabsf(det - 1.0f) <= SO3_DET_TOL;
}

// so3.ensure_so3_exact: R where it passes is_rotation, else 6 Newton steps.
__device__ __forceinline__ void ensure_so3_exact(const float* R, float* out) {
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = R[k];
  if (!is_rotation(R)) polar_fast<6>(out);
}

__device__ __forceinline__ void rot_x(float t, float* O) {
  const float c = cosf(t), s = sinf(t);
  O[0] = 1.0f; O[1] = 0.0f; O[2] = 0.0f;
  O[3] = 0.0f; O[4] = c;    O[5] = -s;
  O[6] = 0.0f; O[7] = s;    O[8] = c;
}

__device__ __forceinline__ void rot_y(float t, float* O) {
  const float c = cosf(t), s = sinf(t);
  O[0] = c;    O[1] = 0.0f; O[2] = s;
  O[3] = 0.0f; O[4] = 1.0f; O[5] = 0.0f;
  O[6] = -s;   O[7] = 0.0f; O[8] = c;
}

__device__ __forceinline__ void rot_z(float t, float* O) {
  const float c = cosf(t), s = sinf(t);
  O[0] = c;    O[1] = -s;   O[2] = 0.0f;
  O[3] = s;    O[4] = c;    O[5] = 0.0f;
  O[6] = 0.0f; O[7] = 0.0f; O[8] = 1.0f;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// jax.random.uniform's map of a base draw u in [0, 1) into [lo, hi).
__device__ __forceinline__ float uniform_in(float u, float lo, float hi) {
  return fmaxf(lo, u * (hi - lo) + lo);
}

// --------------------------------------------------------------- dynamics
// y = (x[3], v[3], R[9], W[3]).
__device__ __forceinline__ void eom(const float* y, float f, const float* M,
                                    float m, const float* J, float* dy) {
  const float* v = y + 3;
  const float* R = y + 6;
  const float* W = y + 15;
#pragma unroll
  for (int k = 0; k < 3; ++k) dy[k] = v[k];
  const float ge3[3] = {0.0f, 0.0f, G_STD};
#pragma unroll
  for (int k = 0; k < 3; ++k) dy[3 + k] = ge3[k] - (f * R[k * 3 + 2]) / m;
  float H[9];
  hat(W, H);
  mm3(R, H, dy + 6);
  const float Jm[9] = {J[0], 0.0f, 0.0f, 0.0f, J[1], 0.0f, 0.0f, 0.0f, J[2]};
  float nH[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) nH[k] = -H[k];
  float t1[9], t2[3];
  mm3(nH, Jm, t1);
  mv3(t1, W, t2);
#pragma unroll
  for (int k = 0; k < 3; ++k) dy[15 + k] = (t2[k] + M[k]) * (1.0f / J[k]);
}

template <int INTEG>
__device__ __forceinline__ void integrate(float* y, float f, const float* M,
                                          float m, const float* J) {
  const float dt = DT;
  if constexpr (INTEG == INTEGRATOR_EULER) {
    float k[18];
    eom(y, f, M, m, J, k);
#pragma unroll
    for (int j = 0; j < 18; ++j) y[j] = y[j] + dt * k[j];
  } else if constexpr (INTEG == INTEGRATOR_RK4) {
    const float half = dt * 0.5f;
    const float sixth = dt / 6.0f;
    const float third = dt / 3.0f;
    float k[18], yi[18], acc[18];
    eom(y, f, M, m, J, k);
#pragma unroll
    for (int j = 0; j < 18; ++j) { acc[j] = y[j] + sixth * k[j]; yi[j] = y[j] + half * k[j]; }
    eom(yi, f, M, m, J, k);
#pragma unroll
    for (int j = 0; j < 18; ++j) { acc[j] = acc[j] + third * k[j]; yi[j] = y[j] + half * k[j]; }
    eom(yi, f, M, m, J, k);
#pragma unroll
    for (int j = 0; j < 18; ++j) { acc[j] = acc[j] + third * k[j]; yi[j] = y[j] + dt * k[j]; }
    eom(yi, f, M, m, J, k);
#pragma unroll
    for (int j = 0; j < 18; ++j) y[j] = acc[j] + sixth * k[j];
  } else {
    static_assert(INTEG == INTEGRATOR_DOP853, "unknown integrator");
    // dynamics.dop853_step: stage i starts from y and adds (dt * a_ij) k_j
    // for each nonzero a_ij in j order; then y += (dt * b_i) k_i for each
    // nonzero b_i.  The stage list is generated (DOP853_STAGES).
    float K[12][18], yi[18];
#define DOP_BEGIN(I)                                    \
  _Pragma("unroll") for (int q = 0; q < 18; ++q) yi[q] = y[q];
#define DOP_AXPY(I, J, A)                               \
  {                                                     \
    const float c_ = dt * (float)(A);                   \
    _Pragma("unroll") for (int q = 0; q < 18; ++q) yi[q] = yi[q] + c_ * K[J][q]; \
  }
#define DOP_EVAL(I) eom(yi, f, M, m, J, K[I]);
#define DOP_SUM(I, Bc)                                  \
  {                                                     \
    const float c_ = dt * (float)(Bc);                  \
    _Pragma("unroll") for (int q = 0; q < 18; ++q) y[q] = y[q] + c_ * K[I][q]; \
  }
    DOP853_STAGES(DOP_BEGIN, DOP_AXPY, DOP_EVAL)
    DOP853_SUM(DOP_SUM)
#undef DOP_BEGIN
#undef DOP_AXPY
#undef DOP_EVAL
#undef DOP_SUM
  }
}

// The integrator split over the lanes of an env's group: lane k (< 3; the
// fourth repeats axis 2) holds axis k of y, z = (x_k, v_k, R row k, W_k),
// and evaluates row k of every expression of eom, the same expression in
// the same order as eom's row k, so each value is bitwise eom's.  eom needs
// all of W (hat(W) and the gyroscopic term): three shuffles within the
// group's four lanes.  Called by all 32 lanes of a warp together.
__device__ __forceinline__ void eom_row(const float* z, float f, const float* M,
                                        float m, const float* J, int k, float* dz) {
  const float W0 = __shfl_sync(0xffffffffu, z[5], 0, 4);
  const float W1 = __shfl_sync(0xffffffffu, z[5], 1, 4);
  const float W2 = __shfl_sync(0xffffffffu, z[5], 2, 4);
  const float W[3] = {W0, W1, W2};
  float H[9];
  hat(W, H);
  // row k of hat(W), and M, J and g e3 at k
  const float hk[3] = {k == 0 ? H[0] : k == 1 ? H[3] : H[6],
                       k == 0 ? H[1] : k == 1 ? H[4] : H[7],
                       k == 0 ? H[2] : k == 1 ? H[5] : H[8]};
  const float Jm[9] = {J[0], 0.0f, 0.0f, 0.0f, J[1], 0.0f, 0.0f, 0.0f, J[2]};
  const float Mk = k == 0 ? M[0] : k == 1 ? M[1] : M[2];
  const float Jk = k == 0 ? J[0] : k == 1 ? J[1] : J[2];
  const float gk = k == 2 ? G_STD : 0.0f;
  dz[0] = z[1];
  dz[1] = gk - (f * z[4]) / m;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    dz[2 + c] = (z[2] * H[c] + z[3] * H[3 + c]) + z[4] * H[6 + c];
  const float nh[3] = {-hk[0], -hk[1], -hk[2]};
  float t1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    t1[c] = (nh[0] * Jm[c] + nh[1] * Jm[3 + c]) + nh[2] * Jm[6 + c];
  const float t2 = (t1[0] * W[0] + t1[1] * W[1]) + t1[2] * W[2];
  dz[5] = (t2 + Mk) * (1.0f / Jk);
}

template <int INTEG>
__device__ __forceinline__ void integrate_split(float* y, float f, const float* M,
                                                float m, const float* J, int lk) {
  const float dt = DT;
  const int k = lk < 3 ? lk : 2;
  float z[6] = {k == 0 ? y[0] : k == 1 ? y[1] : y[2],
                k == 0 ? y[3] : k == 1 ? y[4] : y[5],
                k == 0 ? y[6] : k == 1 ? y[9] : y[12],
                k == 0 ? y[7] : k == 1 ? y[10] : y[13],
                k == 0 ? y[8] : k == 1 ? y[11] : y[14],
                k == 0 ? y[15] : k == 1 ? y[16] : y[17]};
  if constexpr (INTEG == INTEGRATOR_EULER) {
    float kk[6];
    eom_row(z, f, M, m, J, k, kk);
#pragma unroll
    for (int j = 0; j < 6; ++j) z[j] = z[j] + dt * kk[j];
  } else if constexpr (INTEG == INTEGRATOR_RK4) {
    const float half = dt * 0.5f;
    const float sixth = dt / 6.0f;
    const float third = dt / 3.0f;
    float kk[6], zi[6], acc[6];
    eom_row(z, f, M, m, J, k, kk);
#pragma unroll
    for (int j = 0; j < 6; ++j) { acc[j] = z[j] + sixth * kk[j]; zi[j] = z[j] + half * kk[j]; }
    eom_row(zi, f, M, m, J, k, kk);
#pragma unroll
    for (int j = 0; j < 6; ++j) { acc[j] = acc[j] + third * kk[j]; zi[j] = z[j] + half * kk[j]; }
    eom_row(zi, f, M, m, J, k, kk);
#pragma unroll
    for (int j = 0; j < 6; ++j) { acc[j] = acc[j] + third * kk[j]; zi[j] = z[j] + dt * kk[j]; }
    eom_row(zi, f, M, m, J, k, kk);
#pragma unroll
    for (int j = 0; j < 6; ++j) z[j] = acc[j] + sixth * kk[j];
  } else {
    static_assert(INTEG == INTEGRATOR_DOP853, "unknown integrator");
    float K[12][6], zi[6];
#define DOP_BEGIN(I)                                    \
  _Pragma("unroll") for (int q = 0; q < 6; ++q) zi[q] = z[q];
#define DOP_AXPY(I, J_, A)                              \
  {                                                     \
    const float c_ = dt * (float)(A);                   \
    _Pragma("unroll") for (int q = 0; q < 6; ++q) zi[q] = zi[q] + c_ * K[J_][q]; \
  }
#define DOP_EVAL(I) eom_row(zi, f, M, m, J, k, K[I]);
#define DOP_SUM(I, Bc)                                  \
  {                                                     \
    const float c_ = dt * (float)(Bc);                  \
    _Pragma("unroll") for (int q = 0; q < 6; ++q) z[q] = z[q] + c_ * K[I][q]; \
  }
    DOP853_STAGES(DOP_BEGIN, DOP_AXPY, DOP_EVAL)
    DOP853_SUM(DOP_SUM)
#undef DOP_BEGIN
#undef DOP_AXPY
#undef DOP_EVAL
#undef DOP_SUM
  }
  // every lane of the group takes the whole stepped y
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    y[a] = __shfl_sync(0xffffffffu, z[0], a, 4);
    y[3 + a] = __shfl_sync(0xffffffffu, z[1], a, 4);
#pragma unroll
    for (int c = 0; c < 3; ++c) y[6 + 3 * a + c] = __shfl_sync(0xffffffffu, z[2 + c], a, 4);
    y[15 + a] = __shfl_sync(0xffffffffu, z[5], a, 4);
  }
}

// ------------------------------------------------- errors, obs, reward, done
struct NormOut {
  float ex[3], eIx_norm[3], ev[3], eW[3], eW3, eb1_norm, eIb1_norm;
  float eIx_err[3], eIx_cur[3], eIb1_err, eIb1_cur;
};

// quad.norm_error_state; goal = (xd, vd, b1d, Wd).
__device__ __forceinline__ void norm_error(const Coefs& c, const float* x,
                                           const float* v, const float* R,
                                           const float* W, const float* xd,
                                           const float* vd, const float* b1d,
                                           const float* Wd, const float* eIx,
                                           const float* eIx_int, float eIb1,
                                           float eIb1_int, NormOut& o) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.ex[k] = x[k] / X_LIM - xd[k] / X_LIM;
    o.ev[k] = v[k] / V_LIM - vd[k] / V_LIM;
    o.eW[k] = W[k] / W_LIM - Wd[k] / W_LIM;
  }
  o.eW3 = W[2] / W_LIM - Wd[2] / W_LIM;
  const float b1[3] = {R[0], R[3], R[6]};
  const float b2[3] = {R[1], R[4], R[7]};
  const float b3[3] = {R[2], R[5], R[8]};
  const float db = dot3(b1d, b3);
  float b1c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) b1c[k] = b1d[k] - db * b3[k];
  const float eb1 = atan2f(-dot3(b1c, b2), dot3(b1c, b1));
  o.eb1_norm = eb1 / PI_F;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.eIx_cur[k] = -c.alpha * eIx[k] + o.ex[k] * X_LIM;
    o.eIx_err[k] = eIx[k] + ((eIx_int[k] + o.eIx_cur[k]) * DT) / 2.0f;
    o.eIx_norm[k] = clampf(o.eIx_err[k] / EIX_LIM, -SAT, SAT);
  }
  o.eIb1_cur = -c.beta * eIb1 + o.eb1_norm * PI_F;
  o.eIb1_err = eIb1 + ((eIb1_int + o.eIb1_cur) * DT) / 2.0f;
  o.eIb1_norm = clampf(o.eIb1_err / EIB1_LIM, -SAT, SAT);
}

__device__ __forceinline__ float sqnorm(const float* x) {
  const float n = sqrtf(dot3(x, x));
  return n * n;
}

__device__ __forceinline__ float interp01(float r, float rmin, float slope) {
  return clampf(slope * (r - rmin) + 0.0f, 0.0f, 1.0f);
}

// ------------------------------------------------------------------ tasks
// What quad.step reads of an env besides (x, v, R, W): the parameters
// (forces_to_fM: this env's row-major 4x4 in the state buffer) and the goal.
struct Params {
  float m, J[3], scale, avrg, minf, maxf;
  const float* f2fM;
};

struct GoalRef {
  const float *xd, *vd, *b1d, *Wd;
};

// quad._f_total: the thrust channel of both wrappers.
__device__ __forceinline__ float f_total(const Params& P, float a0) {
  return clampf(4.0f * (P.scale * a0 + P.avrg), 4.0f * P.minf, 4.0f * P.maxf);
}

// Per task: agents, action width, the obs (all agents' obs concatenated,
// NOBS floats), the output slots (generated from kernels/env_tick.py OUT),
// whether the batched tick exists (BATCHED) and whether the step updates the
// integrals (INTEGRALS); action() maps the action to (f, M) and observe()
// makes the obs, reward, done and info from the stepped state.
template <int TASK>
struct Task;

// The wrappers' obs, reward and done from the normalized errors, and their
// info (the de-normalized position and yaw errors of the float32 obs).
template <int TASK>
__device__ __forceinline__ void observe_wrapper(const Coefs& c, const NormOut& n,
                                                const float* Rr, float* obs,
                                                float* rew, bool* d, float* ex,
                                                float& eb1) {
  using T = Task<TASK>;
  T::build_obs(n, Rr, obs);
  T::reward_done(c, obs, rew, d);
#pragma unroll
  for (int k = 0; k < 3; ++k) ex[k] = obs[k] * X_LIM;
  eb1 = obs[T::EB1_OBS] * PI_F;
}

template <>
struct Task<TASK_DECOUPLED> {
  static constexpr bool BATCHED = true, INTEGRALS = true;
  static constexpr int NA = 2, NACT = 5, NOBS = 18, EB1_OBS = 15;
  static constexpr int NOUT_F = NF_OUT_DECOUPLED, NOUT_B = NB_OUT_DECOUPLED;
  static constexpr int W1 = WOF_DECOUPLED_OBS1, W2 = WOF_DECOUPLED_OBS2;
  static constexpr int OBS1 = OF_DECOUPLED_OBS1, OBS2 = OF_DECOUPLED_OBS2;
  static constexpr int TERM1 = OF_DECOUPLED_TERM_OBS1, TERM2 = OF_DECOUPLED_TERM_OBS2;
  static constexpr int REWARD = OF_DECOUPLED_REWARD, EX = OF_DECOUPLED_EX, EB1 = OF_DECOUPLED_EB1;
  static constexpr int DONE = OB_DECOUPLED_DONE, RESET = OB_DECOUPLED_RESET,
                       CRASHED = OB_DECOUPLED_CRASHED;
  static_assert(W1 + W2 == NOBS && WOF_DECOUPLED_REWARD == NA &&
                    WOB_DECOUPLED_DONE == NA && WOB_DECOUPLED_CRASHED == NA,
                "decoupled output layout");

  // action_decoupled and the virtual moments (quad.py:309-316)
  __device__ static void action(const Params& P, const float* act, const float* R,
                                const float* W, float& f, float* M) {
    const float b1[3] = {R[0], R[3], R[6]};
    const float b2[3] = {R[1], R[4], R[7]};
    f = f_total(P, act[0]);
    M[0] = dot3(b1, act + 1) + P.J[2] * W[2] * W[1];
    M[1] = dot3(b2, act + 1) - P.J[2] * W[2] * W[0];
    M[2] = act[4];
  }

  __device__ static void observe(const Coefs& c, const float*, const float* Rr,
                                 const GoalRef&, const NormOut& n, float* obs,
                                 float* rew, bool* d, float* ex, float& eb1) {
    observe_wrapper<TASK_DECOUPLED>(c, n, Rr, obs, rew, d, ex, eb1);
  }

  // build_obs, MODUL: obs1 (15) then obs2 (3)
  __device__ static void build_obs(const NormOut& n, const float* R, float* obs) {
    const float b1[3] = {R[0], R[3], R[6]};
    const float b2[3] = {R[1], R[4], R[7]};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      obs[k] = n.ex[k];
      obs[3 + k] = n.eIx_norm[k];
      obs[6 + k] = n.ev[k];
      obs[9 + k] = R[3 * k + 2];
      obs[12 + k] = n.eW[0] * b1[k] + n.eW[1] * b2[k];
    }
    obs[15] = n.eb1_norm;
    obs[16] = n.eIb1_norm;
    obs[17] = n.eW3;
  }

  // reward_decoupled / done_decoupled / _interp01 / crash override
  __device__ static void reward_done(const Coefs& c, const float* o1, float* rew,
                                     bool* d) {
    const float* o2 = o1 + 15;
    float r1 = -c.Cx * sqnorm(o1);
    r1 = r1 + -c.CIx * sqnorm(o1 + 3);
    r1 = r1 + -c.Cv * sqnorm(o1 + 6);
    r1 = r1 + -c.Cw12 * sqnorm(o1 + 12);
    const float aI = fabsf(o2[1]), aW = fabsf(o2[2]);
    float r2 = -c.Cb1 * fabsf(o2[0]);
    r2 = r2 + -c.CIb1 * (aI * aI);
    r2 = r2 + -c.CW3 * (aW * aW);
    bool d1 = false;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d1 = d1 || fabsf(o1[k]) >= 1.0f || fabsf(o1[6 + k]) >= 1.0f || fabsf(o1[12 + k]) >= 1.0f;
    const bool d2 = fabsf(o2[2]) >= 1.0f;
    d[0] = d1;
    d[1] = d2;
    rew[0] = d1 ? -1.0f : interp01(r1, c.rmin1, c.slope1);
    rew[1] = d2 ? -1.0f : interp01(r2, c.rmin2, c.slope2);
  }
};

template <>
struct Task<TASK_COUPLED> {
  static constexpr bool BATCHED = true, INTEGRALS = true;
  static constexpr int NA = 1, NACT = 4, NOBS = 23, EB1_OBS = 18;
  static constexpr int NOUT_F = NF_OUT_COUPLED, NOUT_B = NB_OUT_COUPLED;
  static constexpr int W1 = WOF_COUPLED_OBS1, W2 = 0;
  static constexpr int OBS1 = OF_COUPLED_OBS1, OBS2 = 0;
  static constexpr int TERM1 = OF_COUPLED_TERM_OBS1, TERM2 = 0;
  static constexpr int REWARD = OF_COUPLED_REWARD, EX = OF_COUPLED_EX, EB1 = OF_COUPLED_EB1;
  static constexpr int DONE = OB_COUPLED_DONE, RESET = OB_COUPLED_RESET,
                       CRASHED = OB_COUPLED_CRASHED;
  static_assert(W1 + W2 == NOBS && WOF_COUPLED_REWARD == NA &&
                    WOB_COUPLED_DONE == NA && WOB_COUPLED_CRASHED == NA,
                "coupled output layout");

  // action_coupled: the moments are the action (quad.py:91-93)
  __device__ static void action(const Params& P, const float* act, const float*,
                                const float*, float& f, float* M) {
    f = f_total(P, act[0]);
    M[0] = act[1];
    M[1] = act[2];
    M[2] = act[3];
  }

  __device__ static void observe(const Coefs& c, const float*, const float* Rr,
                                 const GoalRef&, const NormOut& n, float* obs,
                                 float* rew, bool* d, float* ex, float& eb1) {
    observe_wrapper<TASK_COUPLED>(c, n, Rr, obs, rew, d, ex, eb1);
  }

  // build_obs, MONO: ex, eIx, ev, R column-major, eb1, eIb1, eW
  __device__ static void build_obs(const NormOut& n, const float* R, float* obs) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      obs[k] = n.ex[k];
      obs[3 + k] = n.eIx_norm[k];
      obs[6 + k] = n.ev[k];
      obs[20 + k] = n.eW[k];
    }
#pragma unroll
    for (int col = 0; col < 3; ++col)
#pragma unroll
      for (int row = 0; row < 3; ++row) obs[9 + 3 * col + row] = R[3 * row + col];
    obs[18] = n.eb1_norm;
    obs[19] = n.eIb1_norm;
  }

  // reward_coupled / done_coupled / _interp01(reward_min) / crash override
  __device__ static void reward_done(const Coefs& c, const float* o, float* rew,
                                     bool* d) {
    float r = -c.Cx * sqnorm(o);
    r = r + -c.CIx * sqnorm(o + 3);
    r = r + -c.Cv * sqnorm(o + 6);
    r = r + -c.Cb1 * fabsf(o[18]);
    const float aI = fabsf(o[19]);
    r = r + -c.CIb1 * (aI * aI);
    r = r + -c.Cw12 * sqnorm(o + 20);
    bool dd = false;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dd = dd || fabsf(o[k]) >= 1.0f || fabsf(o[6 + k]) >= 1.0f || fabsf(o[20 + k]) >= 1.0f;
    d[0] = dd;
    rew[0] = dd ? -1.0f : interp01(r, c.rmin, c.slope);
  }
};

// so3.heading_b1's angle: the body x-axis's heading.
__device__ __forceinline__ float heading_angle(const float* R) {
  return atan2f(R[3], R[0]);
}

__device__ __forceinline__ void heading_of(const float* R, float* h) {
  const float th = heading_angle(R);
  h[0] = cosf(th);
  h[1] = sinf(th);
  h[2] = 0.0f;
}

// so3.norm_ang_btw_two_vectors: the signed angle over pi; the norms as
// sqrt of the fixed-order dot; sign 0 keeps the angle positive.
__device__ __forceinline__ float norm_ang(const float* desired, const float* current) {
  const float nd = sqrtf(dot3(desired, desired));
  const float nc = sqrtf(dot3(current, current));
  const float du[3] = {desired[0] / nd, desired[1] / nd, desired[2] / nd};
  const float cu[3] = {current[0] / nc, current[1] / nc, current[2] / nc};
  float ang = acosf(clampf(dot3(du, cu), -1.0f, 1.0f));
  if (du[0] * cu[1] - du[1] * cu[0] < 0.0f) ang = -ang;
  return ang / PI_F;
}

// quad.done_quad: the limits on x, v, W, and roll or pitch (so3.rot_to_euler,
// the singular branch as a select) at EULER_LIM_DEG or more.
__device__ __forceinline__ bool done_quad(const float* y, const float* R) {
  bool dd = false;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dd = dd || fabsf(y[k]) >= X_LIM || fabsf(y[3 + k]) >= V_LIM ||
         fabsf(y[15 + k]) >= W_LIM;
  const float sy = sqrtf(R[0] * R[0] + R[3] * R[3]);
  const bool singular = sy < (float)1e-6;
  const float roll = singular ? atan2f(-R[5], R[4]) : atan2f(R[7], R[8]);
  const float pitch = atan2f(-R[6], sy);
  return dd || fabsf(roll * R2D) >= EULER_LIM_DEG || fabsf(pitch * R2D) >= EULER_LIM_DEG;
}

// The base env (quad.py:68-80, 234-245, 270-284, 341-354): per-motor thrusts;
// the obs is the stepped state as stored, reward and done come from the raw
// errors with R as read; the integrals are left alone.  Step entry only.
template <>
struct Task<TASK_QUAD> {
  static constexpr bool BATCHED = false, INTEGRALS = false;
  static constexpr int NA = 1, NACT = 4, NOBS = 18;
  static constexpr int NOUT_F = NF_OUT_QUAD, NOUT_B = NB_OUT_QUAD;
  static constexpr int W1 = WOF_QUAD_OBS1, W2 = 0;
  static constexpr int OBS1 = OF_QUAD_OBS1, OBS2 = 0;
  static constexpr int REWARD = OF_QUAD_REWARD, EX = OF_QUAD_EX, EB1 = OF_QUAD_EB1;
  static constexpr int DONE = OB_QUAD_DONE;
  static_assert(W1 == NOBS && WOF_QUAD_REWARD == NA && WOB_QUAD_DONE == NA,
                "quad output layout");

  // action_quad: forces clipped per motor, then forces_to_fM as the
  // fixed-order (F0 f0 + F1 f1) + (F2 f2 + F3 f3)
  __device__ static void action(const Params& P, const float* act, const float*,
                                const float*, float& f, float* M) {
    float fr[4], fM[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) fr[k] = clampf(P.scale * act[k] + P.avrg, P.minf, P.maxf);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* F = P.f2fM + 4 * r;
      fM[r] = (F[0] * fr[0] + F[1] * fr[1]) + (F[2] * fr[2] + F[3] * fr[3]);
    }
    f = fM[0];
    M[0] = fM[1];
    M[1] = fM[2];
    M[2] = fM[3];
  }

  // pack_state of the stored state (R column-major); reward_quad, done_quad,
  // _interp01(reward_min) and the crash override; info ex = x - xd, eb1 = 0
  __device__ static void observe(const Coefs& c, const float* y, const float* Rr,
                                 const GoalRef& g, const NormOut&, float* obs,
                                 float* rew, bool* d, float* ex, float& eb1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      obs[k] = y[k];
      obs[3 + k] = y[3 + k];
      obs[15 + k] = y[15 + k];
    }
#pragma unroll
    for (int col = 0; col < 3; ++col)
#pragma unroll
      for (int row = 0; row < 3; ++row) obs[6 + 3 * col + row] = y[6 + 3 * row + col];
    float eV[3], h[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ex[k] = y[k] - g.xd[k];
      eV[k] = y[3 + k] - g.vd[k];
    }
    heading_of(Rr, h);
    const float eb1q = norm_ang(g.b1d, h);
    float r = -c.Cx * sqnorm(ex);
    r = r + -c.Cb1 * fabsf(eb1q);
    r = r + -c.Cv * sqnorm(eV);
    r = r + -c.Cw12 * sqnorm(y + 15);
    d[0] = done_quad(y, Rr);
    rew[0] = d[0] ? -1.0f : interp01(r, c.rmin, c.slope);
    eb1 = 0.0f;
  }
};

// All agents' obs (NOBS floats) into the slots' (B, W1) and (B, W2) blocks.
template <int TASK>
__device__ __forceinline__ void write_obs(float* __restrict__ outf, int B, int i,
                                          int slot1, int slot2, const float* obs) {
  using T = Task<TASK>;
#pragma unroll
  for (int k = 0; k < T::W1; ++k) outf[(size_t)slot1 * B + (size_t)i * T::W1 + k] = obs[k];
#pragma unroll
  for (int k = 0; k < T::W2; ++k)
    outf[(size_t)slot2 * B + (size_t)i * T::W2 + k] = obs[T::W1 + k];
}

// ----------------------------------------------------------- trajectory
// _with_wd: z-component of the commanded angular velocity.
__device__ __forceinline__ float omega_c3(const float* R, const float* W,
                                          const float* b1d, const float* b1d_dot) {
  const float b3[3] = {R[2], R[5], R[8]};
  float H[9], RH[9];
  hat(W, H);
  mm3(R, H, RH);
  const float b3_dot[3] = {RH[2], RH[5], RH[8]};
  const float d_b1d_b3 = dot3(b1d, b3);
  const float d_dot_b3 = dot3(b1d_dot, b3);
  const float d_b1d_b3dot = dot3(b1d, b3_dot);
  float b1c[3], b1c_dot[3], om[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b1c[k] = b1d[k] - d_b1d_b3 * b3[k];
    b1c_dot[k] = b1d_dot[k] - ((d_dot_b3 * b3[k] + d_b1d_b3dot * b3[k]) +
                               d_b1d_b3 * b3_dot[k]);
  }
  cross(b1c, b1c_dot, om);
  return dot3(b3, om);
}

// The trajectory machine (trajectory.TrajState minus its key).
struct Traj {
  int mode;
  float t, t_traj, theta_init, smooth_term, w_b1d;
  bool started, complete, manual_mode, manual_init, is_landed, init_b1d;
  float x_init[3], x_goal[3], center[3], xd[3], vd[3], b1d[3], b1d_dot[3], Wd[3];
};

// One machine's draws for a tick: mode-0 heading, mode-1 settle time and
// yaw rate (envs/draws.py TrajDraws).
struct TrajU {
  float theta, hover_t, hover_w;
};

__device__ __forceinline__ void set3(float* d, const float* s) {
  d[0] = s[0]; d[1] = s[1]; d[2] = s[2];
}

__device__ __forceinline__ void zero3(float* d) { d[0] = d[1] = d[2] = 0.0f; }

// TrajState.create then mark_traj_start (trajectory.py:82-108).
__device__ __forceinline__ void traj_start(Traj& s, const float* x, const float* R) {
  s.mode = 0;
  s.t = s.t_traj = 0.0f;
  s.started = s.complete = s.manual_mode = s.manual_init = s.is_landed = false;
  s.init_b1d = true;
  set3(s.x_init, x);
  s.theta_init = heading_angle(R);
  zero3(s.x_goal);
  s.smooth_term = s.w_b1d = 0.0f;
  zero3(s.center);
  zero3(s.xd);
  zero3(s.vd);
  s.b1d[0] = 1.0f; s.b1d[1] = 0.0f; s.b1d[2] = 0.0f;
  zero3(s.b1d_dot);
  zero3(s.Wd);
}

// mode 0 (trajectory.py:134-153)
__device__ __forceinline__ void mode_idle(Traj& s, const float* R, float u) {
  if (s.init_b1d) {
    const float theta = uniform_in(u, IDLE_LO, IDLE_HI);
    float h[3], Rz[9];
    heading_of(R, h);
    rot_z(theta, Rz);
    mv3(Rz, h, s.b1d);
    zero3(s.xd);
    zero3(s.vd);
    zero3(s.Wd);
  }
  s.init_b1d = false;
}

// mode 1 (trajectory.py:156-184)
__device__ __forceinline__ void mode_hover(Traj& s, const float* x, const TrajU& u) {
  const float t_traj_new = uniform_in(u.hover_t, HOVER_T_LO, HOVER_T_HI);
  const float w_new = uniform_in(u.hover_w, HOVER_W_LO, HOVER_W_HI);
  if (!s.started) {
    set3(s.x_init, x);
    s.t_traj = t_traj_new;
    s.smooth_term = NEG_LOG_0001 / t_traj_new;
    s.w_b1d = w_new;
  }
  zero3(s.x_goal);
  const float t = s.t + DT;
  const float e = expf(-s.smooth_term * t);
  const float se = s.smooth_term * e;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dx = s.x_init[k] - 0.0f;
    s.xd[k] = dx * e + 0.0f;
    s.vd[k] = -dx * se;
  }
  const float phase = s.w_b1d * t + s.theta_init;
  const float cp = cosf(phase), sp = sinf(phase);
  s.b1d[0] = cp; s.b1d[1] = sp; s.b1d[2] = 0.0f;
  s.b1d_dot[0] = -s.w_b1d * sp; s.b1d_dot[1] = s.w_b1d * cp; s.b1d_dot[2] = 0.0f;
  s.t = t;
  s.started = true;
}

// mode 2 (trajectory.py:187-215)
__device__ __forceinline__ void mode_takeoff(Traj& s, const float* x, const float* R) {
  const float xd2_entry = s.xd[2];
  if (!s.started) {
    s.xd[0] = x[0]; s.xd[1] = x[1]; s.xd[2] = 0.0f;
    zero3(s.vd);
    heading_of(R, s.b1d);
    set3(s.x_init, x);
    s.t_traj = (TAKEOFF_END_HEIGHT - x[2]) / TAKEOFF_VELOCITY;
  }
  const float t = s.t + DT;
  const bool climbing = t < s.t_traj;
  float xd2 = climbing ? s.x_init[2] + TAKEOFF_VELOCITY * t : xd2_entry;
  float dl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) dl[k] = s.xd[k] - x[k];
  const bool reached = sqrtf(dot3(dl, dl)) < (float)0.04;
  const bool hold = !climbing && reached;
  if (hold) {
    xd2 = TAKEOFF_END_HEIGHT;
    s.vd[2] = 0.0f;
  }
  s.xd[2] = xd2;
  s.t = t;
  s.started = true;
  s.complete = s.complete || hold;
  s.manual_mode = s.manual_mode || hold;
}

// mode 3 (trajectory.py:218-242)
__device__ __forceinline__ void mode_land(Traj& s, const float* x, const float* v,
                                          const float* R) {
  if (!s.started) {
    set3(s.xd, x);
    set3(s.vd, v);
    heading_of(R, s.b1d);
    set3(s.x_init, x);
    s.t_traj = (LANDING_CUTOFF_HEIGHT - x[2]) / LANDING_VELOCITY;
  }
  const float t = s.t + DT;
  const bool descending = t < s.t_traj;
  const bool above = x[2] > LANDING_CUTOFF_HEIGHT;
  s.xd[2] = descending ? s.x_init[2] + LANDING_VELOCITY * t : LANDING_CUTOFF_HEIGHT;
  if (!descending) s.vd[2] = above ? 0.0f : LANDING_VELOCITY;
  const bool landed = !descending && above;
  s.t = t;
  s.started = true;
  s.complete = s.complete || landed;
  s.is_landed = s.is_landed || landed;
}

// mode 4 (trajectory.py:245-256): t does not advance
__device__ __forceinline__ void mode_stay(Traj& s, const float* x, const float* v,
                                          const float* R) {
  if (!s.started) {
    set3(s.xd, x);
    set3(s.vd, v);
    heading_of(R, s.b1d);
  }
  s.started = s.complete = s.manual_mode = true;
}

// mode 5 (trajectory.py:259-307)
__device__ __forceinline__ void mode_circle(Traj& s, const float* x, const float* v,
                                            const float* R) {
  if (!s.started) {
    set3(s.center, x);
    s.t_traj = CIRCLE_T_TRAJ;
    set3(s.xd, x);
    set3(s.vd, v);
    heading_of(R, s.b1d);
  }
  const float t = s.t + DT;
  const bool in_lead = t < CIRCLE_LEAD_T;
  const bool in_circle = !in_lead && t < s.t_traj;
  const float tc = t - CIRCLE_LEAD_T;
  if (in_lead) {
    s.xd[0] = s.center[0] + CIRCLE_LINEAR_V * t;
    s.vd[0] = CIRCLE_LINEAR_V;
  } else if (in_circle) {
    const float th = CIRCLE_W * tc;
    const float c = cosf(th), sn = sinf(th);
    s.xd[0] = CIRCLE_RADIUS * c + s.center[0];
    s.vd[0] = NEG_CIRCLE_RW * sn;
    s.xd[1] = CIRCLE_RADIUS * sn + s.center[1];
    s.vd[1] = CIRCLE_RW * c;
    const float thb = CIRCLE_W * tc + PI_F;
    const float cb = cosf(thb), sb = sinf(thb);
    s.b1d[0] = cb; s.b1d[1] = sb; s.b1d[2] = 0.0f;
    s.b1d_dot[0] = NEG_CIRCLE_W * sb; s.b1d_dot[1] = CIRCLE_W * cb; s.b1d_dot[2] = 0.0f;
  }
  const bool ended = !in_lead && !in_circle;
  s.t = t;
  s.started = true;
  s.complete = s.complete || ended;
  s.manual_mode = s.manual_mode || ended;
}

// mode 6 and above (trajectory.py:310-357)
__device__ __forceinline__ void mode_eight(Traj& s, const float* x, const float* v,
                                           const float* R) {
  if (!s.started) {
    set3(s.center, x);
    s.t_traj = EIGHT_T_TRAJ;
    s.w_b1d = EIGHT_W_B1D;
    set3(s.xd, x);
    set3(s.vd, v);
    heading_of(R, s.b1d);
  }
  const float t = s.t + DT;
  const bool active = t < s.t_traj;
  if (active) {
    const float ex = expf(NEG_EIGHT_EXP_XY * t);
    const float exp_term = 1.0f - ex;
    const float d_exp = EIGHT_EXP_XY * ex;
    const float s2 = sinf(EIGHT_W2 * t), c2 = cosf(EIGHT_W2 * t);
    const float s1 = sinf(EIGHT_W1 * t), c1 = cosf(EIGHT_W1 * t);
    s.xd[0] = EIGHT_A2 * (s2 * exp_term) + s.center[0];
    s.vd[0] = EIGHT_A2 * ((EIGHT_W2 * c2) * exp_term + s2 * d_exp);
    s.xd[1] = EIGHT_A1 * (c1 - 1.0f) * exp_term + s.center[1];
    s.vd[1] = EIGHT_A1 * ((EIGHT_W1 * -s1) * exp_term + (c1 - 1.0f) * d_exp);
    const float z_amp = (s.center[2] - EIGHT_ALT_D) / 2.0f;
    s.xd[2] = z_amp * (1.0f - c1) + s.center[2];
    s.vd[2] = z_amp * EIGHT_W1 * s1;
    const float phase = s.w_b1d * t * exp_term + s.theta_init;
    const float d_phase = s.w_b1d * (exp_term + t * d_exp);
    const float cp = cosf(phase), sp = sinf(phase);
    s.b1d[0] = cp; s.b1d[1] = sp; s.b1d[2] = 0.0f;
    s.b1d_dot[0] = -sp * d_phase; s.b1d_dot[1] = cp * d_phase; s.b1d_dot[2] = 0.0f;
  }
  s.t = t;
  s.started = true;
  s.complete = s.complete || !active;
  s.manual_mode = s.manual_mode || !active;
}

// manual hold (trajectory.py:360-376): t does not advance
__device__ __forceinline__ void mode_manual(Traj& s, const float* x, const float* R) {
  if (!s.manual_init) {
    s.theta_init = heading_angle(R);
    set3(s.xd, x);
  }
  zero3(s.vd);
  s.b1d[0] = cosf(s.theta_init); s.b1d[1] = sinf(s.theta_init); s.b1d[2] = 0.0f;
  s.manual_init = true;
}

// get_desired's static branch (trajectory.py:392-408) and _with_wd: the
// branch min(max(mode, 0), 6), replaced for mode >= 2 by the manual hold in
// a machine already in manual mode at entry, whose Wd then stays frozen.
__device__ __forceinline__ void get_desired(Traj& s, const float* x, const float* v,
                                            const float* R, const float* W,
                                            int mode, const TrajU& u) {
  s.mode = mode;
  const bool use_man = mode >= 2 && s.manual_mode;
  if (use_man) {
    mode_manual(s, x, R);
    return;
  }
  switch (mode < 0 ? 0 : (mode > 6 ? 6 : mode)) {
    case 0: mode_idle(s, R, u.theta); break;
    case 1: mode_hover(s, x, u); break;
    case 2: mode_takeoff(s, x, R); break;
    case 3: mode_land(s, x, v, R); break;
    case 4: mode_stay(s, x, v, R); break;
    case 5: mode_circle(s, x, v, R); break;
    default: mode_eight(s, x, v, R); break;
  }
  s.Wd[0] = 0.0f;
  s.Wd[1] = 0.0f;
  s.Wd[2] = omega_c3(R, W, s.b1d, s.b1d_dot);
}

// -------------------------------------------------------------- buffers
#define FIDX(NAME, c) ((size_t)F_##NAME * B + (size_t)i * WF_##NAME + (c))
#define IIDX(NAME) ((size_t)I_##NAME * B + (size_t)i)
#define BIDX(NAME) ((size_t)B_##NAME * B + (size_t)i)
#define LOADF(dst, NAME)                                         \
  _Pragma("unroll") for (int c_ = 0; c_ < WF_##NAME; ++c_)       \
      (dst)[c_] = sf[FIDX(NAME, c_)]
#define STOREF(NAME, src)                                        \
  _Pragma("unroll") for (int c_ = 0; c_ < WF_##NAME; ++c_)       \
      of[FIDX(NAME, c_)] = (src)[c_]
#define STORE1(NAME, val) of[FIDX(NAME, 0)] = (val)
#define COPYF(NAME)                                              \
  _Pragma("unroll") for (int c_ = 0; c_ < WF_##NAME; ++c_)       \
      of[FIDX(NAME, c_)] = sf[FIDX(NAME, c_)]
#define ZEROF(NAME)                                              \
  _Pragma("unroll") for (int c_ = 0; c_ < WF_##NAME; ++c_)       \
      of[FIDX(NAME, c_)] = 0.0f

__device__ __forceinline__ void load_traj(const Args& a, int i, Traj& s) {
  const int B = a.B;
  const float* sf = a.sf;
  s.mode = a.si[IIDX(TRAJ_MODE)];
  s.t = sf[FIDX(TRAJ_T, 0)];
  s.t_traj = sf[FIDX(TRAJ_T_TRAJ, 0)];
  s.started = a.sb[BIDX(TRAJ_STARTED)];
  s.complete = a.sb[BIDX(TRAJ_COMPLETE)];
  s.manual_mode = a.sb[BIDX(TRAJ_MANUAL_MODE)];
  s.manual_init = a.sb[BIDX(TRAJ_MANUAL_INIT)];
  s.is_landed = a.sb[BIDX(TRAJ_IS_LANDED)];
  s.init_b1d = a.sb[BIDX(TRAJ_INIT_B1D)];
  LOADF(s.x_init, TRAJ_X_INIT);
  s.theta_init = sf[FIDX(TRAJ_THETA_INIT, 0)];
  LOADF(s.x_goal, TRAJ_X_GOAL);
  s.smooth_term = sf[FIDX(TRAJ_SMOOTH_TERM, 0)];
  s.w_b1d = sf[FIDX(TRAJ_W_B1D, 0)];
  LOADF(s.center, TRAJ_CENTER);
  LOADF(s.xd, TRAJ_XD);
  LOADF(s.vd, TRAJ_VD);
  LOADF(s.b1d, TRAJ_B1D);
  LOADF(s.b1d_dot, TRAJ_B1D_DOT);
  LOADF(s.Wd, TRAJ_WD);
}

// The machine into the output state, and its goal into env.goal.
__device__ __forceinline__ void store_traj(const Args& a, int i, const Traj& s) {
  const int B = a.B;
  float* of = a.of;
  a.oi[IIDX(TRAJ_MODE)] = s.mode;
  STORE1(TRAJ_T, s.t);
  STORE1(TRAJ_T_TRAJ, s.t_traj);
  a.ob[BIDX(TRAJ_STARTED)] = s.started;
  a.ob[BIDX(TRAJ_COMPLETE)] = s.complete;
  a.ob[BIDX(TRAJ_MANUAL_MODE)] = s.manual_mode;
  a.ob[BIDX(TRAJ_MANUAL_INIT)] = s.manual_init;
  a.ob[BIDX(TRAJ_IS_LANDED)] = s.is_landed;
  a.ob[BIDX(TRAJ_INIT_B1D)] = s.init_b1d;
  STOREF(TRAJ_X_INIT, s.x_init);
  STORE1(TRAJ_THETA_INIT, s.theta_init);
  STOREF(TRAJ_X_GOAL, s.x_goal);
  STORE1(TRAJ_SMOOTH_TERM, s.smooth_term);
  STORE1(TRAJ_W_B1D, s.w_b1d);
  STOREF(TRAJ_CENTER, s.center);
  STOREF(TRAJ_XD, s.xd);
  STOREF(TRAJ_VD, s.vd);
  STOREF(TRAJ_B1D, s.b1d);
  STOREF(TRAJ_B1D_DOT, s.b1d_dot);
  STOREF(TRAJ_WD, s.Wd);
  STOREF(ENV_GOAL_XD, s.xd);
  STOREF(ENV_GOAL_VD, s.vd);
  STOREF(ENV_GOAL_B1D, s.b1d);
  STOREF(ENV_GOAL_B1D_DOT, s.b1d_dot);
  STOREF(ENV_GOAL_WD, s.Wd);
}

// R as a read sees it (quad._ensure_R): repaired on the fly under EXACT.
template <bool EXACT>
__device__ __forceinline__ void read_R(const float* R, float* out) {
  if constexpr (EXACT) {
    ensure_so3_exact(R, out);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = R[k];
  }
}

// Fresh episode (batch.py fresh(): reset_state -> TrajState.create ->
// mark_traj_start -> get_desired -> initial_obs), written to the output
// state and the obs slots.
template <int TASK, bool EXACT>
__device__ void fresh_episode(const Args& a, int i, const float* u) {
  const int B = a.B;
  float* __restrict__ of = a.of;
  const Coefs& c = a.c;
  // params: randomize or nominal (m, d, J1, J3, c_tf, c_tw), then _derive
  const float NOM[6] = {(float)2.15, (float)0.23, (float)0.022,
                        (float)0.035, (float)0.0135, (float)2.2};
  float p[6];
  if (a.use_udm && a.env_type == ENV_TRAIN) {
    const float frac[6] = {c.udm_u, c.udm_u, c.udm_u, c.udm_u, c.udm_u, c.udm_u_half};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float z = uniform_in(u[D_UDM + k], -1.0f, 1.0f);
      p[k] = NOM[k] + NOM[k] * frac[k] * z;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) p[k] = NOM[k];
  }
  const float m = p[0], d = p[1], c_tf = p[4], c_tw = p[5];
  const float J[3] = {p[2], p[2], p[3]};
  const float hover = m * G_STD / 4.0f;
  const float max_force = c_tw * hover;
  const float avrg = (MIN_FORCE + max_force) / 2.0f;
  const float scale = max_force - avrg;
  const float q = 0.25f * 1.0f;
  const float hd = 1.0f / (2.0f * d);
  const float qc = 1.0f / (4.0f * c_tf);
  const float f2fM[16] = {1.0f, 1.0f, 1.0f, 1.0f,  0.0f, -d, 0.0f, d,
                          d, 0.0f, -d, 0.0f,       -c_tf, c_tf, -c_tf, c_tf};
  const float fM2f[16] = {q, 0.0f, hd, -qc,  q, -hd, 0.0f, qc,
                          q, 0.0f, -hd, -qc, q, hd, 0.0f, qc};
  STORE1(ENV_PARAMS_M, m);
  STORE1(ENV_PARAMS_D, d);
  STOREF(ENV_PARAMS_J, J);
  STORE1(ENV_PARAMS_C_TF, c_tf);
  STORE1(ENV_PARAMS_C_TW, c_tw);
  STORE1(ENV_PARAMS_HOVER_FORCE, hover);
  STORE1(ENV_PARAMS_MIN_FORCE, MIN_FORCE);
  STORE1(ENV_PARAMS_MAX_FORCE, max_force);
  STORE1(ENV_PARAMS_AVRG_ACT, avrg);
  STORE1(ENV_PARAMS_SCALE_ACT, scale);
  STOREF(ENV_PARAMS_FORCES_TO_FM, f2fM);
  STOREF(ENV_PARAMS_FM_TO_FORCES, fM2f);

  // _init_ranges + the 12 reset uniforms
  float ix = (float)0.4, iv = 0.0f, iR = 0.0f, iW = 0.0f;
  if (a.env_type == ENV_TRAIN) {
    const bool at_origin = u[D_AT_ORIGIN] < (float)0.2;
    ix = at_origin ? 0.0f : (float)0.6;
    iv = at_origin ? 0.0f : (float)(V_LIM * 0.5);
    iR = at_origin ? 0.0f : (float)(50.0 * (PI_D / 180.0));
    iW = at_origin ? 0.0f : (float)(2.0 * PI_D * 0.5);
  }
  float r[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = uniform_in(u[D_RESET + k], -1.0f, 1.0f);
  float y[18];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    y[k] = r[k] * ix;
    y[3 + k] = r[3 + k] * iv;
    y[15 + k] = r[6 + k] * iW;
  }
  float Rx[9], Ry[9], Rz[9], Ryx[9], R0[9];
  rot_x(r[9] * iR, Rx);
  rot_y(r[10] * iR, Ry);
  rot_z(r[11] * PI_F, Rz);
  mm3(Ry, Rx, Ryx);
  mm3(Rz, Ryx, R0);
  read_R<EXACT>(R0, y + 6);            // reset_state's ensure (quad.py:439-440)
  const float* R = y + 6;
  const float* W = y + 15;

  // trajectory machine: create -> mark_traj_start -> get_desired
  Traj s;
  traj_start(s, y, R);
  get_desired(s, y, y + 3, R, W, a.mode,
              TrajU{u[D_FRESH_THETA], u[D_FRESH_HOVER_T], u[D_FRESH_HOVER_W]});

  // initial_obs: one integral update against the new goal, R as read
  float Rr[9];
  read_R<EXACT>(R, Rr);
  const float zero3v[3] = {0.0f, 0.0f, 0.0f};
  NormOut n;
  norm_error(c, y, y + 3, Rr, W, s.xd, s.vd, s.b1d, s.Wd, zero3v, zero3v, 0.0f,
             0.0f, n);

  STOREF(ENV_X, y);
  STOREF(ENV_V, y + 3);
  STOREF(ENV_R, y + 6);
  STOREF(ENV_W, y + 15);
  STOREF(ENV_EIX, n.eIx_err);
  STOREF(ENV_EIX_INTEGRAND, n.eIx_cur);
  STORE1(ENV_EIB1, n.eIb1_err);
  STORE1(ENV_EIB1_INTEGRAND, n.eIb1_cur);
  STORE1(ENV_F_TOTAL, m * G_STD);
  ZEROF(ENV_M);
  a.oi[IIDX(ENV_T)] = 0;
  store_traj(a, i, s);

  float obs[Task<TASK>::NOBS];
  Task<TASK>::build_obs(n, Rr, obs);
  write_obs<TASK>(a.outf, B, i, Task<TASK>::OBS1, Task<TASK>::OBS2, obs);
}

// The parameters quad.step reads.  No __restrict__ from here to
// store_stepped: the step entry reads and writes one buffer set in place.
__device__ __forceinline__ void load_params(const Args& a, int i, Params& P) {
  const int B = a.B;
  const float* sf = a.sf;
  P.m = sf[FIDX(ENV_PARAMS_M, 0)];
  LOADF(P.J, ENV_PARAMS_J);
  P.scale = sf[FIDX(ENV_PARAMS_SCALE_ACT, 0)];
  P.avrg = sf[FIDX(ENV_PARAMS_AVRG_ACT, 0)];
  P.minf = sf[FIDX(ENV_PARAMS_MIN_FORCE, 0)];
  P.maxf = sf[FIDX(ENV_PARAMS_MAX_FORCE, 0)];
  P.f2fM = sf + FIDX(ENV_PARAMS_FORCES_TO_FM, 0);
}

// What one quad.step produces for an env besides the stepped (x, v, R, W).
template <int TASK>
struct StepOut {
  float f, M[3];
  NormOut n;  // the errors and the updated integrals (Task<TASK>::INTEGRALS)
  float obs[Task<TASK>::NOBS], rew[Task<TASK>::NA], ex[3], eb1;
  bool d[Task<TASK>::NA];
};

// quad.step on env i with goal g: R as read, the action map, the dynamics
// and the attitude step, then the errors (and integrals), obs, reward, done
// and info.  y = (x, v, R, W) as stored on entry, stepped on return.
// SPLIT: the integrator split over the env's four lanes (lane lk).
template <int TASK, int INTEG, bool EXACT, bool SPLIT = false>
__device__ __forceinline__ void step_env(const Args& a, int i, float* y,
                                         const GoalRef& g, StepOut<TASK>& o,
                                         int lk = 0) {
  using T = Task<TASK>;
  const int B = a.B;
  const float* sf = a.sf;
  {
    float Rs[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rs[k] = y[6 + k];
    read_R<EXACT>(Rs, y + 6);
  }
  float act[T::NACT];
#pragma unroll
  for (int k = 0; k < T::NACT; ++k) act[k] = a.act[(size_t)i * T::NACT + k];
  Params P;
  load_params(a, i, P);
  T::action(P, act, y + 6, y + 15, o.f, o.M);
  if constexpr (SPLIT)
    integrate_split<INTEG>(y, o.f, o.M, P.m, P.J, lk);
  else
    integrate<INTEG>(y, o.f, o.M, P.m, P.J);
  // the stored R: one polar step, or left drifted under EXACT
  if constexpr (!EXACT) polar_fast<2>(y + 6);
  float Rr[9];
  read_R<EXACT>(y + 6, Rr);
  if constexpr (T::INTEGRALS) {
    float eIx[3], eIx_int[3];
    LOADF(eIx, ENV_EIX);
    LOADF(eIx_int, ENV_EIX_INTEGRAND);
    norm_error(a.c, y, y + 3, Rr, y + 15, g.xd, g.vd, g.b1d, g.Wd, eIx, eIx_int,
               sf[FIDX(ENV_EIB1, 0)], sf[FIDX(ENV_EIB1_INTEGRAND, 0)], o.n);
  }
  T::observe(a.c, y, Rr, g, o.n, o.obs, o.rew, o.d, o.ex, o.eb1);
}

// What quad.step changes: the stepped (x, v, R, W), the integrals (where
// the task updates them), the wrench and t (t_new, the stored t + 1).
template <int TASK>
__device__ __forceinline__ void store_stepped(const Args& a, int i, const float* y,
                                              const StepOut<TASK>& o, int t_new) {
  const int B = a.B;
  float* of = a.of;
  STOREF(ENV_X, y);
  STOREF(ENV_V, y + 3);
  STOREF(ENV_R, y + 6);
  STOREF(ENV_W, y + 15);
  if constexpr (Task<TASK>::INTEGRALS) {
    STOREF(ENV_EIX, o.n.eIx_err);
    STOREF(ENV_EIX_INTEGRAND, o.n.eIx_cur);
    STORE1(ENV_EIB1, o.n.eIb1_err);
    STORE1(ENV_EIB1_INTEGRAND, o.n.eIb1_cur);
  }
  STORE1(ENV_F_TOTAL, o.f);
  STOREF(ENV_M, o.M);
  a.oi[IIDX(ENV_T)] = t_new;
}

// The step entry, in place (of == sf, oi == si; the bool buffers unused):
// quad.step against the stored goal, writing only what it changes; obs,
// reward, done and info into the output slots.  Reads and writes the env
// fields only, so the buffers may hold just them (env_tick.py pack_env).
template <int TASK, int INTEG, bool EXACT>
__device__ void step_only(const Args& a, int i) {
  using T = Task<TASK>;
  const int B = a.B;
  const float* sf = a.sf;
  float* __restrict__ outf = a.outf;
  float y[18], xd[3], vd[3], b1d[3], Wd[3];
  LOADF(y, ENV_X);
  LOADF(y + 3, ENV_V);
  LOADF(y + 6, ENV_R);
  LOADF(y + 15, ENV_W);
  LOADF(xd, ENV_GOAL_XD);
  LOADF(vd, ENV_GOAL_VD);
  LOADF(b1d, ENV_GOAL_B1D);
  LOADF(Wd, ENV_GOAL_WD);
  StepOut<TASK> o;
  step_env<TASK, INTEG, EXACT>(a, i, y, GoalRef{xd, vd, b1d, Wd}, o);
#pragma unroll
  for (int k = 0; k < T::NA; ++k) {
    outf[(size_t)T::REWARD * B + (size_t)i * T::NA + k] = o.rew[k];
    a.outb[(size_t)T::DONE * B + (size_t)i * T::NA + k] = o.d[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) outf[(size_t)T::EX * B + (size_t)i * 3 + k] = o.ex[k];
  outf[(size_t)T::EB1 * B + i] = o.eb1;
  write_obs<TASK>(outf, B, i, T::OBS1, T::OBS2, o.obs);
  store_stepped<TASK>(a, i, y, o, a.si[IIDX(ENV_T)] + 1);
}

// The tick of env i in a tile (a: the tile's shared-memory images, B =
// kTile), on one of the env's four lanes (lk): get_desired, quad.step (the
// integrator split over the lanes), the cap/solved override.  Writes the
// tick's outputs, the episode-over flag, and the stepped state over the
// tile's state image in place (parameters left as read); the copy out takes
// the fresh episode instead where the episode is over.  The four lanes
// compute the same values and store the same bits.
template <int TASK, int INTEG, bool EXACT>
__device__ void tick_lane(const Args& a, int i, int lk, bool* over_out) {
  using T = Task<TASK>;
  const int B = a.B;
  const float* sf = a.sf;
  const float* u = a.draws + (size_t)i * N_DRAWS;

  // ---- trajectory.get_desired on the stored state
  float y[18];
  LOADF(y, ENV_X);
  LOADF(y + 3, ENV_V);
  LOADF(y + 6, ENV_R);
  LOADF(y + 15, ENV_W);
  Traj s;
  load_traj(a, i, s);
  get_desired(s, y, y + 3, y + 6, y + 15, a.mode,
              TrajU{u[D_THETA], u[D_HOVER_T], u[D_HOVER_W]});

  // ---- quad.step against the machine's goal
  StepOut<TASK> o;
  step_env<TASK, INTEG, EXACT, true>(a, i, y, GoalRef{s.xd, s.vd, s.b1d, s.Wd},
                                     o, lk);

  // ---- batch: cap/solved override (MODUL: position for agent 0, yaw for
  // agent 1; MONO: position only)
  const int t_new = a.si[IIDX(ENV_T)] + 1;
  const bool at_cap = t_new >= a.max_steps;
  const float tol = (float)0.03;
  const bool solved_pos = fabsf(o.ex[0]) <= tol && fabsf(o.ex[1]) <= tol &&
                          fabsf(o.ex[2]) <= tol;
  const bool solved_yaw = fabsf(o.eb1) <= tol;
  bool over = at_cap;
#pragma unroll
  for (int k = 0; k < T::NA; ++k) over = over || o.d[k];

  float* outf = a.outf;
  bool* outb = a.outb;
#pragma unroll
  for (int k = 0; k < T::NA; ++k) {
    const bool solved = (k == 0 ? solved_pos : solved_yaw) && (o.rew[k] != -1.0f);
    outf[(size_t)T::REWARD * B + (size_t)i * T::NA + k] = o.rew[k];
    outb[(size_t)T::DONE * B + (size_t)i * T::NA + k] = at_cap ? solved : o.d[k];
    outb[(size_t)T::CRASHED * B + (size_t)i * T::NA + k] = o.d[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) outf[(size_t)T::EX * B + (size_t)i * 3 + k] = o.ex[k];
  outf[(size_t)T::EB1 * B + i] = o.eb1;
  write_obs<TASK>(outf, B, i, T::TERM1, T::TERM2, o.obs);
  write_obs<TASK>(outf, B, i, T::OBS1, T::OBS2, o.obs);
  outb[(size_t)T::RESET * B + i] = over;
  *over_out = over;

  // ---- the stepped state over the read one, once every lane of the warp
  // has read what it needs
  __syncwarp();
  store_stepped<TASK>(a, i, y, o, t_new);
  store_traj(a, i, s);
}

// ------------------------------------------------------- the tile kernel
// The tick entry: a block takes a tile of kTile envs.  Warps
// 0-3 run the tick, four lanes an env; warp 4 runs the fresh episode of
// every env of the tile, one lane an env, beside the tick (JAX's dense
// fresh + select; the fresh chain reads only the draws and the config, so
// it starts at once, its draws read where they lie).  The buffers go
// through shared memory, copied whole and coalesced: each field of width w
// of the tile is one contiguous run of kTile * w scalars in the global
// buffers, kept in the same order in the image, so the per-env code
// indexes the images as it indexes the buffers (FIDX with B = kTile).  The
// tick warps copy in and meet at their own barrier; after the block's
// barrier all five copy out, per env the fresh state and obs where the
// episode is over, else the ticked ones.  One block a tile: at 4096 envs
// 128 blocks for 132 SMs; a block's 43-45 KB of shared memory lets five
// share an SM past that.
constexpr int kTile = 32;
constexpr int kLanes = 4;
constexpr int kTickThreads = kTile * kLanes;
constexpr int kThreads = kTickThreads + kTile;

template <int TASK>
struct TileSmem {
  float sf[NF_STATE * kTile];             // state in; ticked state out
  float ff[NF_STATE * kTile];             // fresh state
  float outf[Task<TASK>::NOUT_F * kTile]; // the tick's float outputs
  float fobs[Task<TASK>::NOBS * kTile];   // fresh obs (the obs slots lead)
  float draws[N_DRAWS * kTile];
  float act[Task<TASK>::NACT * kTile];
  int si[NI_STATE * kTile], fi[NI_STATE * kTile];
  bool sb[NB_STATE * kTile], fb[NB_STATE * kTile];
  bool outb[Task<TASK>::NOUT_B * kTile];
  bool over[kTile];
};

// A column of a field-major buffer: its field's first column, the field's
// width w and m = ceil(2^16 / w): the env of scalar j of a tile's run
// (j < kTile w) is (j m) >> 16.
struct Col {
  int off, w, m;
};

__device__ __forceinline__ Col col_of(int packed) {
  return Col{packed & 0xff, (packed >> 8) & 0x1f, packed >> 13};
}

// cols (packed off | w << 8 | m << 13) of a buffer of width-1 fields (the
// int and bool state), and of one field of width W (the draws, the
// actions)
__device__ __forceinline__ int scalar_col(int s) {
  return s | 1 << 8 | (1 << 16) << 13;
}

template <int W>
__device__ __forceinline__ int block_col(int) {
  return 0 | W << 8 | ((1 << 16) + W - 1) / W << 13;
}

// A copy of a small field-major buffer of N columns (cols(s): column s
// packed) between global memory (B envs) and a tile's image (kTile envs),
// by the NT threads from thread 0, split in two passes over the thread's
// slots q = tid + k NT: gather (the global index, the env and the value of
// each) and scatter, so a thread's loads are in flight together before its
// first store.  Into the image (IN) every slot is filled, a slot past the
// tile's last env (ne) from that env; out of it, the tile's envs.
template <int N, typename V, int NT>
struct Batch {
  static constexpr int K = (N * kTile + NT - 1) / NT;
  V v[K];
  int g[K];
  bool on[K];
};

template <bool IN, int N, typename V, int NT, typename Cols, typename Load>
__device__ __forceinline__ void gather(Batch<N, V, NT>& b, Cols cols, int B,
                                       int i0, int ne, Load load) {
#pragma unroll
  for (int k = 0; k < Batch<N, V, NT>::K; ++k) {
    const int q = threadIdx.x + k * NT;
    b.on[k] = false;
    if (q < N * kTile) {
      const Col c = col_of(cols(q >> 5));
      const int j = q - c.off * kTile;
      const int e = (j * c.m) >> 16;
      if (e < (IN ? kTile : ne)) {
        const int ge = IN ? min(e, ne - 1) : e;
        b.g[k] = c.off * B + (i0 + ge) * c.w + (j - e * c.w);
        b.v[k] = load(q, b.g[k], e);
        b.on[k] = true;
      }
    }
  }
}

template <int N, typename V, int NT, typename Store>
__device__ __forceinline__ void scatter(const Batch<N, V, NT>& b, Store store) {
#pragma unroll
  for (int k = 0; k < Batch<N, V, NT>::K; ++k)
    if (b.on[k]) store(threadIdx.x + k * NT, b.g[k], b.v[k]);
}

// The tick warps' barrier (barrier 1, the fresh warp not waiting on it).
__device__ __forceinline__ void tick_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kTickThreads) : "memory");
}

// The float state's and the outputs' copies by the plans the header
// carries (kernels/env_tick.py copy_plan): each field goes whole to one
// warp, lane l moving scalars l + 32 i (i < W) of its run; X(OFF, W,
// BASE): the field's first column, width and first register slot.  In:
// the four tick warps (plan K1_SFI); out: all five.
#define K1_WARPS4(PLAN, X)                                                     \
  switch (warp) {                                                              \
    case 0: PLAN##_W0(X) break;                                                \
    case 1: PLAN##_W1(X) break;                                                \
    case 2: PLAN##_W2(X) break;                                                \
    default: PLAN##_W3(X) break;                                               \
  }
#define K1_WARPS5(PLAN, X)                                                     \
  switch (warp) {                                                              \
    case 0: PLAN##_W0(X) break;                                                \
    case 1: PLAN##_W1(X) break;                                                \
    case 2: PLAN##_W2(X) break;                                                \
    case 3: PLAN##_W3(X) break;                                                \
    default: PLAN##_W4(X) break;                                               \
  }
#define K1_SF_IN_LOAD(OFF, W, BASE)                                            \
  _Pragma("unroll") for (int i_ = 0; i_ < (W); ++i_) {                         \
    const int j_ = lane + 32 * i_, e_ = j_ / (W);                              \
    rs[(BASE) + i_] = a.sf[(size_t)(OFF) * B +                                 \
                           (size_t)(i0 + min(e_, ne - 1)) * (W) + (j_ - e_ * (W))]; \
  }
#define K1_SF_IN_STORE(OFF, W, BASE)                                           \
  _Pragma("unroll") for (int i_ = 0; i_ < (W); ++i_)                           \
      sm.sf[(OFF) * kTile + lane + 32 * i_] = rs[(BASE) + i_];
#define K1_SF_OUT_LOAD(OFF, W, BASE)                                           \
  _Pragma("unroll") for (int i_ = 0; i_ < (W); ++i_) {                         \
    const int j_ = lane + 32 * i_, q_ = (OFF) * kTile + j_;                    \
    const float f_ = sm.ff[q_], t_ = sm.sf[q_];                                \
    rs[(BASE) + i_] = sm.over[j_ / (W)] ? f_ : t_;                             \
  }
#define K1_SF_OUT_STORE(OFF, W, BASE)                                          \
  _Pragma("unroll") for (int i_ = 0; i_ < (W); ++i_) {                         \
    const int j_ = lane + 32 * i_;                                             \
    if (j_ / (W) < ne)                                                         \
      a.of[(size_t)(OFF) * B + (size_t)i0 * (W) + j_] = rs[(BASE) + i_];       \
  }
// the float outputs: the obs slots (OFF < NOBS) take the fresh obs where
// the episode is over
#define K1_OF_OUT_LOAD(OFF, W, BASE)                                           \
  _Pragma("unroll") for (int i_ = 0; i_ < (W); ++i_) {                         \
    const int j_ = lane + 32 * i_, q_ = (OFF) * kTile + j_;                    \
    const float f_ = (OFF) < T::NOBS ? sm.fobs[q_] : 0.0f, t_ = sm.outf[q_];   \
    ro[(BASE) + i_] = (OFF) < T::NOBS && sm.over[j_ / (W)] ? f_ : t_;          \
  }
#define K1_OF_OUT_STORE(OFF, W, BASE)                                          \
  _Pragma("unroll") for (int i_ = 0; i_ < (W); ++i_) {                         \
    const int j_ = lane + 32 * i_;                                             \
    if (j_ / (W) < ne)                                                         \
      a.outf[(size_t)(OFF) * B + (size_t)i0 * (W) + j_] = ro[(BASE) + i_];     \
  }
#define K1_OB_OUT_LOAD(OFF, W, BASE)                                           \
  _Pragma("unroll") for (int i_ = 0; i_ < (W); ++i_)                           \
      rb[(BASE) + i_] = sm.outb[(OFF) * kTile + lane + 32 * i_];
#define K1_OB_OUT_STORE(OFF, W, BASE)                                          \
  _Pragma("unroll") for (int i_ = 0; i_ < (W); ++i_) {                         \
    const int j_ = lane + 32 * i_;                                             \
    if (j_ / (W) < ne)                                                         \
      a.outb[(size_t)(OFF) * B + (size_t)i0 * (W) + j_] = rb[(BASE) + i_];     \
  }
// the copy out of a task's tile: every load, then every store
#define K1_OUT(TK)                                                             \
  {                                                                            \
    Batch<NI_STATE, int, kThreads> n;                                          \
    Batch<NB_STATE, bool, kThreads> bo;                                        \
    float rs[K1_SF_NMAX + 1], ro[K1_OF_##TK##_NMAX + 1];                        \
    bool rb[K1_OB_##TK##_NMAX + 1];                                            \
    gather<false>(n, scalars, B, i0, ne, [&](int q, int, int e) {              \
      const int f_ = sm.fi[q], t_ = sm.si[q];                                  \
      return sm.over[e] ? f_ : t_;                                             \
    });                                                                        \
    gather<false>(bo, scalars, B, i0, ne, [&](int q, int, int e) {             \
      const bool f_ = sm.fb[q], t_ = sm.sb[q];                                 \
      return sm.over[e] ? f_ : t_;                                             \
    });                                                                        \
    K1_WARPS5(K1_SF, K1_SF_OUT_LOAD)                                           \
    K1_WARPS5(K1_OF_##TK, K1_OF_OUT_LOAD)                                      \
    K1_WARPS5(K1_OB_##TK, K1_OB_OUT_LOAD)                                      \
    K1_WARPS5(K1_SF, K1_SF_OUT_STORE)                                          \
    K1_WARPS5(K1_OF_##TK, K1_OF_OUT_STORE)                                     \
    K1_WARPS5(K1_OB_##TK, K1_OB_OUT_STORE)                                     \
    scatter(n, [&](int, int g, int v) { a.oi[g] = v; });                       \
    scatter(bo, [&](int, int g, bool v) { a.ob[g] = v; });                     \
  }

template <int TASK, int INTEG, bool EXACT>
__global__ void __launch_bounds__(kThreads) env_tile_kernel(Args a) {
  using T = Task<TASK>;
  static_assert(kTile == 32, "runs are indexed by q >> 5");
  static_assert(kThreads / 32 == K1_COPY_WARPS, "copy plans are per warp");
  __shared__ TileSmem<TASK> sm;
  const int B = a.B, i0 = blockIdx.x * kTile, ne = min(kTile, B - i0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const auto scalars = [](int s) { return scalar_col(s); };
  const auto draw_cols = [](int s) { return block_col<N_DRAWS>(s); };
  const auto act_cols = [](int s) { return block_col<T::NACT>(s); };

  Args t = a;
  t.B = kTile;
  if (tid < kTickThreads) {
    {
      // ---- in, by the tick warps: the state, actions and draws (rows
      // past the tile's last env repeat it), every load issued before the
      // stores; then their own barrier (the fresh warp does not wait)
      {
        Batch<N_DRAWS, float, kTickThreads> du;   // one field of N_DRAWS
        Batch<NI_STATE, int, kTickThreads> n;
        Batch<NB_STATE, bool, kTickThreads> bo;
        Batch<T::NACT, float, kTickThreads> ac;
        float rs[K1_SFI_NMAX + 1];
        gather<true>(du, draw_cols, B, i0, ne,
                     [&](int, int g, int) { return a.draws[g]; });
        gather<true>(n, scalars, B, i0, ne, [&](int, int g, int) { return a.si[g]; });
        gather<true>(bo, scalars, B, i0, ne, [&](int, int g, int) { return a.sb[g]; });
        gather<true>(ac, act_cols, B, i0, ne,
                     [&](int, int g, int) { return a.act[g]; });
        K1_WARPS4(K1_SFI, K1_SF_IN_LOAD)
        K1_WARPS4(K1_SFI, K1_SF_IN_STORE)
        scatter(n, [&](int q, int, int v) { sm.si[q] = v; });
        scatter(bo, [&](int q, int, bool v) { sm.sb[q] = v; });
        scatter(ac, [&](int q, int, float v) { sm.act[q] = v; });
        scatter(du, [&](int q, int, float v) { sm.draws[q] = v; });
      }
      tick_barrier();
      // ---- the tick, four lanes an env; the lanes past the tile's last
      // env tick their copy of it (the group's shuffles need all 32 lanes)
      const int i = tid / kLanes;
      t.sf = t.of = sm.sf;
      t.si = t.oi = sm.si;
      t.sb = t.ob = sm.sb;
      t.act = sm.act;
      t.draws = sm.draws;
      t.outf = sm.outf;
      t.outb = sm.outb;
      tick_lane<TASK, INTEG, EXACT>(t, i, tid % kLanes, &sm.over[i]);
    }
  } else if (tid - kTickThreads < ne) {
    // ---- the fresh episode of every env of the tile, from the start: its
    // draws read where they lie
    const int i = tid - kTickThreads;
    t.of = sm.ff;
    t.oi = sm.fi;
    t.ob = sm.fb;
    t.outf = sm.fobs;
    fresh_episode<TASK, EXACT>(t, i, a.draws + (size_t)(i0 + i) * N_DRAWS);
  }
  __syncthreads();

  // ---- out: per env the fresh episode where it is over, else the tick's
  // (the obs slots lead the float outputs)
  if constexpr (TASK == TASK_DECOUPLED)
    K1_OUT(DECOUPLED)
  else
    K1_OUT(COUPLED)
}

// The step and reset entries: one thread an env, one chain each.  The step
// reads and writes the env's fields in place; the reset writes the fresh
// episode straight to the output buffers.
template <int TASK, int INTEG, bool EXACT>
__global__ void __launch_bounds__(128) env_thread_kernel(Args a, int entry) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  if (entry == ENTRY_STEP) {
    step_only<TASK, INTEG, EXACT>(a, i);
    return;
  }
  if constexpr (Task<TASK>::BATCHED)
    fresh_episode<TASK, EXACT>(a, i, a.draws + (size_t)i * N_DRAWS);
}

template <int TASK, int INTEG, bool EXACT>
cudaError_t launch(const Args& a, int entry, cudaStream_t stream) {
  if (entry != ENTRY_TICK) {
    env_thread_kernel<TASK, INTEG, EXACT><<<(a.B + 127) / 128, 128, 0, stream>>>(
        a, entry);
  } else if constexpr (Task<TASK>::BATCHED) {
    env_tile_kernel<TASK, INTEG, EXACT>
        <<<(a.B + kTile - 1) / kTile, kThreads, 0, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The instances: every (integrator, exact) of a batched task; a task with
// the step entry only (quad) has its EXACT instances only.
template <int TASK, int INTEG>
cudaError_t launch_integ(const Args& a, int entry, int exact, cudaStream_t stream) {
  if (exact) return launch<TASK, INTEG, true>(a, entry, stream);
  if constexpr (Task<TASK>::BATCHED) {
    return launch<TASK, INTEG, false>(a, entry, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int TASK>
cudaError_t launch_task(const Args& a, int entry, int integrator, int exact,
                        cudaStream_t stream) {
  if (!Task<TASK>::BATCHED && entry != ENTRY_STEP) return cudaErrorInvalidValue;
  switch (integrator) {
    case INTEGRATOR_EULER: return launch_integ<TASK, INTEGRATOR_EULER>(a, entry, exact, stream);
    case INTEGRATOR_RK4: return launch_integ<TASK, INTEGRATOR_RK4>(a, entry, exact, stream);
    case INTEGRATOR_DOP853: return launch_integ<TASK, INTEGRATOR_DOP853>(a, entry, exact, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int env_tick_launch(const void* sf, const void* si, const void* sb,
                               void* of, void* oi, void* ob, const void* act,
                               const void* draws, void* outf, void* outb, int B,
                               int entry, int task, int integrator,
                               int exact_so3, int mode, int env_type,
                               int max_steps, int use_udm, const float* coefs,
                               void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.sf = (const float*)sf;
  a.si = (const int*)si;
  a.sb = (const bool*)sb;
  a.of = (float*)of;
  a.oi = (int*)oi;
  a.ob = (bool*)ob;
  a.act = (const float*)act;
  a.draws = (const float*)draws;
  a.outf = (float*)outf;
  a.outb = (bool*)outb;
  a.B = B;
  a.env_type = env_type;
  a.max_steps = max_steps;
  a.use_udm = use_udm;
  a.mode = mode;
  a.c = Coefs{coefs[0],  coefs[1],  coefs[2],  coefs[3],  coefs[4],  coefs[5],
              coefs[6],  coefs[7],  coefs[8],  coefs[9],  coefs[10], coefs[11],
              coefs[12], coefs[13], coefs[14], coefs[15], coefs[16]};
  cudaStream_t st = (cudaStream_t)stream;
  if (task == TASK_DECOUPLED)
    return (int)launch_task<TASK_DECOUPLED>(a, entry, integrator, exact_so3, st);
  if (task == TASK_COUPLED)
    return (int)launch_task<TASK_COUPLED>(a, entry, integrator, exact_so3, st);
  if (task == TASK_QUAD)
    return (int)launch_task<TASK_QUAD>(a, entry, integrator, exact_so3, st);
  return (int)cudaErrorInvalidValue;
}
