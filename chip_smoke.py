"""Drive the PyTorch port's acting and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero and prints no
result line):
  1. build      nvcc all ten kernel sources in parallel; print build time
                and the registers/spills ``-Xptxas -v`` reports; per K3/K4
                instance the registers and spills of each kernel and the
                dynamic shared memory of its launches; the same for the
                acting kernel per instance and head (its shared memory from
                each fold's image) and for K7 per instance (its shared
                memory at every stack the learners launch); K1's tile and
                thread kernels per instance and K2 + K8's kernels: registers,
                spills, stack and static shared memory
  2. env_tick   K1 kernel (the MODUL task) vs its plain twin at B = 4096
                float32 train envs:
                batched reset, 50 plain ticks, ~10% of envs one tick from
                the cap, then one kernel tick and one plain tick on the same
                state, actions and draws (and the reset entry vs plain);
                the same at the eval path's 10 eval envs
  3. emlp_actor K3 kernel vs the structured plain actor, both agents,
                at 1, 10, 31, 32, 33 and 4096 rows (``actor_rows``: the Gym
                API's, the eval path's, a tile's edges, PPO A's, training),
                seeded weights, each launch run twice and compared bitwise
  4. rollout    4096 train envs x 1000 ticks, both actors through K3 and the
                tick through K1; launch counts read from the wrappers;
                SO(3) and reward-range invariants; env-steps/s by CUDA events
  5. eval       ``evaluate``: 10 eval envs x 1000 ticks; launch counts
                read from the wrappers (one reset, then K1 once and K3
                twice per tick)
  6. replay     K2 + K8 vs plain on a 1e6-row ring: one 4096-row tick
                written across the wrap with the episode statistics, a
                256-row sample, and the empty ring's NaN poison
  7. emlp_block K3 (training widths) and K4 vs plain for the eight block
                shapes of the four networks, at the update's batches
                (256; 768 for TD3's actor loss, 1024 for SAC's) and at
                EDGE_ROWS (1, 31, 33, 255 and 3723: not multiples of the
                32-row tile), forward saving lin and pre and without them
                (under no_grad, h against the twin's), all four gradients
                and g_x alone, each K4 call run twice and compared bitwise
                (``_block_vs_plain``); every instance has coordinates with
                gate[k] == k; and the kernel autograd path vs the structured
                network's torch autograd for both twin critics
  8. flat_adamw K6 vs plain for the four networks' flat vectors at a
                count > 0, with the clip triggered and not, with Polyak,
                and at FLAT_EDGE_SIZES (1, a block's edges, the edge
                between solo blocks and clusters, past one pass of the
                launch plan); every call rerun and compared bitwise, a
                clipped call exactly one CUDA kernel in a profiler trace
  9. spectral   K7 vs plain on the critics' and actors' weight stacks and
                on every stack the learners launch (TD3, SAC and PPO on
                MODUL, MONO and CTDE), each launch run twice and compared
                bitwise
 10. sac_actor  K9 vs its plain twin, both SAC actors, at ``actor_rows``,
                train and eval modes, the log_std head as initialised and
                pushed past both clip bounds, reruns bitwise; then SAC's
                actor-loss sample (K3/K4 trunk, the fused head K10) under
                autograd vs the structured network and the plain sample
 11. sac_sample K10 fused with SAC's heads, forward and backward, vs the
                plain sample on the kernel's own heads at 256, 1024 and
                1280 rows, at every head shape of the train paths (EMLP
                W_eff (act, H) and MLP Dense (H, act), agents of Mod and
                Mono): moderate rows, every log-std past each clip bound,
                log-stds exactly at both bounds, saturated rows; reruns
                bitwise; one CUDA kernel a call forward and backward
 12. train      ``train``: 4096 envs, 1 warm then TRAIN_STEPS train
                supersteps (one update each); exact launch counts of every
                kernel per superstep, and of K3/K4 per (shape, rows) (the
                delayed actor step every third),
                the fold cache refolding after each actor update, finite
                losses, changed parameters; env-steps/s, updates/s and ms
                per superstep by CUDA events
 13. sac_train  ``train(Config(rl_algo="SAC"))`` the same way, 1 warm then
                SAC_STEPS train supersteps: exact launch counts, one fold
                per actor and superstep, the actor and critic moving on
                every update and the critic target only on gated ones;
                then 3 supersteps with ``automatic_entropy_tuning`` moving
                ``log_alpha`` on each
 14. ppo_actor  K11 vs its plain twin, both PPO actors, at ``actor_rows``
                (4096 and 32 the two PPO configurations' envs), train and
                eval modes, log_std as initialised and pushed to +-3,
                reruns bitwise
 15. gae        K12 vs its plain twin at (T, B) = (218, 32), (50, 4096) and
                (1, 7), dones inside the horizon; the TD targets (the scan)
                and the normalisation checked apart; then at the launch
                plan's edges, T in (1, 50, 218, 7000) x B in (1, 31, 32,
                33, 256, 257, 4096, 4097) (one CTA, the grid, tiles in
                shared memory and streamed), and PPO B's horizon in one
                cluster; every call rerun and compared bitwise, and at the
                first three horizons one CUDA kernel a call (profiler
                trace)
 16. ppo_loss   K13 forward and backward vs its plain twin at K13_ROWS (1,
                127, 128, 129, 3723, 20 000) rows of 4 and 1 actions: ratios
                inside and outside the clip range on both sides with both
                signs of the advantage, zero advantages, and (1 action)
                ratios exactly at 1 +- clip_rate; every call rerun and
                compared bitwise, at 128 and 3723 rows a forward and a
                backward call exactly one CUDA kernel each (profiler trace)
                and, on 4-action rows one float past an aligned base,
                outputs bitwise the aligned call's;
                then the actor loss's surrogate path (K3/K4 trunk, K13)
                under autograd vs the structured network and the plain loss
 17. v_blocks   K3/K4 vs plain for both blocks of both PPO V critics (the
                two new first-block shapes): forward at the GAE pass's
                2 T B rows (13 952, 409 600; every row, plain in chunks),
                saving lin and pre and without them; ``_block_vs_plain`` at
                the minibatches' 128 and 3723 rows and at EDGE_ROWS; then
                the V critic's kernel path under autograd vs its structured
                net
 18. ppo_train  ``train(Config(rl_algo="PPO"))`` in configuration A (32 envs,
                T_horizon 7000, minibatch 128) for 3 supersteps of
                K_epochs 2, and B (4096 envs, T_horizon 204 800, minibatch
                3723) for 2 supersteps of K_epochs 1: exact launch counts of
                every kernel and of K3/K4 per (shape, rows) per superstep,
                one fold per actor per superstep, finite losses, actor,
                critic and entropy_coef moving; env-steps/s, minibatch
                steps/s and ms per superstep (those after the first) by
                CUDA events
 19. kernels    per kernel: launches on the train paths (K9 and K10 on the
                SAC path's, K11-K13 and the PPO path's K3/K4 on PPO's),
                device time per launch, plain twin's time, the H100 bound
                (K1 and K2 + K8 at 4096 rows and at PPO A's 32 besides),
                and a PyTorch yardstick call where one computes the same
                function; K3/K4 per (shape, rows) instance as the path
                launched it: K3 saving lin and pre or not (under autograd
                or not), K4 with or without the parameter sums; and K5
                (``project_linear``, plain torch) per call at every layer
                shape the TD3 and SAC paths project, with its calls per
                superstep; the acting kernels at every row count the paths
                launch them with (K3-actor and K9 at 4096, K11 at 32 and
                4096, each in eval mode at the eval path's 10) and K7 at
                the TD3 and PPO stacks, each logged with its bound; and
                the card's floor for one launch (an empty kernel back to
                back, plain and in a cluster of 16)
 20. MONO and the MLP networks under TD3 (``phase_mono``):
                env_tick (task coupled) K1's coupled instance vs its plain
                twin at B = 4096 train envs and the eval path's 10 eval
                envs, reset entry and MONO_TICKS ticks from a shared state
                with ~10% of envs at the cap each tick (resets and caps
                crossed); emlp_actor the MONO instance (23, 18, 16, 4);
                emlp_block the MONO blocks (27, 71, 62) and (23, 18, 16)
                with the hidden ones; flat_adamw and spectral on the MONO
                networks; train_mono_emlp, train_mono_mlp, train_mod_mlp:
                ``train`` at full width, 1 warm + MONO_STEPS train
                supersteps each, checked as phase 12 (MLP networks launch
                only K1, K2 and K6); eval_mono_emlp, eval_mono_mlp:
                ``evaluate`` with the trained actors (success column
                position only); mlp_nets: the fused MLP SAC actor (a kernel)
                vs its twin at every MLP SAC agent shape, 1, 10, 32 and
                4096 rows, train and eval, log_std past its clip bounds,
                into column slices, reruns bitwise, one CUDA kernel a call,
                and its times; the MLP networks' ``F.linear`` chains (plain
                torch, not kernels) acting at 4096 rows and in one update;
                kernels: records of K1's coupled instance and
                the MONO K3-actor and K3/K4 instances, with their launches
                on the Mono paths
 21. the rest of the learner matrix (``phase_families``): family_blocks
                K3/K4 vs plain for the new first blocks (the CTDE twin Q
                critics' (23, 71, 62) and (23, 123, 62), the CTDE V
                critics' (18, 71, 62) and (18, 123, 62), the MONO V
                critic's (23, 71, 62)) at 128, 256, 768, 1024 rows and
                EDGE_ROWS through ``_block_vs_plain``, the V forwards at
                13 952 and 409 600 rows saving lin and pre and without them
                (every row, plain in 32 768-row chunks), and each
                network's kernel path under autograd vs its structured
                network; family_actors K9 and K11 at the MONO actor, at
                4096, 32 and 10 rows, train and eval modes, log_std past its
                clip bounds, and the fused MLP PPO actor (forward and K11's
                head in one launch) at every MLP PPO agent shape, at 1, 10,
                32 and 4096 rows, into column slices, one CUDA kernel a
                call (profiler trace);
                train_<config> / ppo_train: ``train`` for the thirteen
                configurations of ``FAMILY_CONFIGS`` (MATD3, CTDE SAC and
                PPO with EMLP and MLP networks; SAC and PPO on Mod-MLP,
                Mono-EMLP and Mono-MLP; SAC on a wider Mod-MLP actor), TD3/SAC 1 warm + FAMILY_STEPS
                train supersteps at 4096 envs, PPO configuration B for
                FAMILY_PPO_STEPS supersteps (the second timed), checked as
                phases 12, 13 and 18 (exact launch
                counts, K3/K4 per shape and rows); eval_<config>:
                ``evaluate`` with the trained actors of the five README
                rows; kernels: one record per new instance
 22. K1's Euler, DOP853, trajectory-mode and exact_so3 instances
                (``phase_tick_modes``): env_tick_modes the registers and
                spills ``-Xptxas -v`` reports per instance (twelve: task x
                euler/rk4/dop853 x exact_so3), then each instance vs its
                plain twin in modes 0-7 (7 the clamp to the eight) at
                B = 4096 train and 10 eval envs: a reset, MODES_PLAIN_TICKS
                plain ticks, then one kernel and one plain tick on the same
                state with ~10% at the cap, ~30% of machines half a tick
                before their planned end in modes 2, 3, 5-7 (the hold or
                the landing begins) and, under exact_so3, ~20% of attitudes
                drifted (the reads repair them; the kernel's read mask,
                seen in its obs, vs the twin's ``is_rotation``);
                rollout_<instance>: ``rollout`` through each instance,
                4096 envs x MODES_TICKS ticks with both EMLP actors, exact
                launch counts per instance, SO(3) on R as read, rewards in
                range, env-steps/s; train_dop853_mode5 (Mod-EMLP) and
                train_euler_mode1_exact (Mono-EMLP): ``train`` at full
                width, 1 warm + MODES_TRAIN_STEPS supersteps, checked as
                phase 12; eval_modes: ``evaluate`` with the first run's
                actors in mode 6; kernels: one record per instance, with
                its launches over those runs
 23. the Gym API and the reference eval stream (``phase_gym_api``):
                gym_step the quad instances' registers and spills and
                env_tick's build time, then K1's step entry vs its plain
                twin ``env_step_plain`` for the quad instances (euler, rk4,
                dop853 under exact_so3) and the coupled and decoupled
                exact_so3 instances, at B = 4096 and B = 1, from states with
                x and v past their limits, roll and pitch tilts past 85
                degrees, the singular branch of ``rot_to_euler`` and ~20%
                of attitudes drifted (discrete mismatches only within a few
                ulp of a limit, the goal and parameters untouched), with
                each instance's times at both sizes; gym_api ``make`` of
                Quad-v0 (dop853, euler, rk4), Coupled-v0 and Decoupled-v0
                (dop853, euler) on the card: set_seed, reset,
                get_norm_error_state, set_goal_state, GYM_STEPS near-hover
                steps, exactly one step-entry launch a step, the same run
                on the CPU through the plain path compared until the first
                done, then every later step from the card's state, wall ms
                per step and device us per launch;
                eval_reference ``evaluate(eval_stream="reference",
                save_log=True)`` with the flagship's seeded actors (and the
                lift alone, plain torch: device and wall ms, its bound from
                the bytes it moves): the
                lifted state is the replayed inits rounded once, K1 once
                and K3 twice a tick, no reset launch, finite rows of 5 + 35;
                kernels: one record per quad instance and one for the step
                entry of the coupled and decoupled instances, at B = 1 (the
                Gym API's) with their B = 4096 times beside
 24. K1 and K2 + K8 around their 32-row tiles (``phase_tiles``):
                tick_rows each of K1's fifteen instances at TILE_ROWS (1,
                31, 32, 33, 4096) envs: the reset entry, a tick from a state
                with ~25% of envs at the cap (under exact_so3 ~30% of
                attitudes drifted) and the step entry on
                ``_step_states``, each vs its plain twin, each kernel run
                twice and compared bitwise, the tick's fresh-episode select
                taken both ways over the sizes; replay_rows K2 + K8 with
                the MODUL (45-float) and MONO (52-float) rows at 1, 32, 33
                and 4096 rows, the cursor three rows from the ring's end,
                with the statistics and without: ring and ``ep_ret`` bitwise
                the twin's, the sums within 1e-5 max(1, max |sum|), a rerun
                bitwise
 25. the training driver (``phase_driver``): ``gym_rotor_tpu_torch.train.main``
                for the flagship at B = 4096 envs (2 warm + 6 train
                supersteps, an eval every 2 supersteps' env-steps, a
                checkpoint with the ring every 4) in a temporary directory:
                evals and checkpoints at the timesteps the JAX driver's
                rules give, exact launch counts per superstep and per eval,
                K1, K2 write + K8, K2 sample, K3-actor, K3/K4, K6 and K7
                launched; each agent's actor saved and reloaded bitwise;
                ``--test_model`` (and a learner that folded its seeded
                actors before the load) giving the in-memory eval's answer
                bitwise; the last checkpoint in a fresh learner bitwise;
                ``--resume`` one more superstep; ``docs/artifacts``' actors
                under the reference eval stream on the card vs the CPU's
                plain path (rewards 1e-5 relative, success equal, last
                errors 1e-5); the phase's wall time, each eval's and the
                host time per superstep
 26. any actor and critic width (``phase_widths``): each run-time-width
                path against its twin, every rerun bitwise: K3/K4
                (``emlp_block_any``, ``emlp_block_backward_any``) for every
                block of the TD3 critics, the actors and the PPO V critics
                at (actor, critic) (8, 4) / 8, (32, 8) / 128 and (64, 16) /
                256 and critic 512's hidden blocks at WIDTH_ROWS (1, 31,
                32, 33, 256, 3723, 4096), the CUDA kernels one call
                launches (ANY_KERNELS_A_CALL: 2, 3, 5 with the parameter
                sums), the tiles read from global memory and two rows a
                lane bitwise the staged one-row read; the acting kernel
                (``emlp_actor_any``, ``sac_actor_any``, ``ppo_actor_any``)
                for each head at those widths and (128, 32), train and eval,
                the image and the tile in global memory bitwise the staged
                launch; K7 (``spectral_iterate_any``) on every learner's
                stack at those widths and critic 512's; the MLP PPO actor
                (``mlp_ppo_actor_any``) at 15/64/4, 3/16/1, 15/256/4 and
                15/900/4; each also at default shapes held to the
                instance's result; PPO B's V forward over 409 600 rows at
                critic 256 (plain in chunks); then ``train`` with exact
                launch counts per superstep: TD3 and SAC (1 warm +
                WIDTH_STEPS), PPO B and Mod-MLP PPO B (WIDTH_PPO_STEPS) at
                (64, 16) / 256, TD3 at (32, 8) / 128 and (8, 4) / 8
                (WIDTH_SMALL_STEPS); ``main(argv)`` of ``python -m
                gym_rotor_tpu_torch.train --actor_hidden_dim 64 16
                --critic_hidden_dim 256`` (1 warm + 3 train supersteps, 3
                evals); one record per run-time wrapper (its launches over
                those runs, times at the slice's shapes)
 27. data-parallel training over a process group (``phase_multi``),
                each group in child processes (``--multi-child``): K12's
                sharded route (``gae_sharded``, launches A, B, C) bitwise
                the one launch at world 1 and within 1e-5 max(1, max abs)
                of its twin at PPO A's and B's horizons at 2 ranks, (218,
                16) and (50, 2048), and at the launch plan's modes, and
                on each of the two ``gloo`` ranks below, at those shapes
                over the group, within the same tolerance of its twin
                reduced on the host; an
                ``nccl`` group of one rank: the flagship TD3 (1 warm + 6)
                and PPO B (2) bitwise the one-device path, the
                all-reduces a 2-rank TD3 superstep makes timed on it; two
                ``gloo`` ranks on the one card: TD3 (2048 envs a rank),
                SAC with the temperature tuned (1 warm + 3) and PPO B (2),
                each rank's exact launches (a one-device run at half the
                envs, PPO's K12 through the sharded route) and
                all-reduces (one a flat gradient, one for the metrics)
                per superstep, every replicated tensor bitwise equal
                across the ranks after each superstep, SAC's
                ``log_alpha`` per rank; ``python -m torch.distributed.run
                --nproc_per_node 1 -m gym_rotor_tpu_torch.train`` training,
                evaluating and checkpointing; one record per sharded K12
                launch
 28. the general EMLP engine (``phase_general``): ``GeneralEMLP(V -> V)``
                at its defaults (``ch`` 384, 3 layers) over SO(3) and S(4),
                each built on the host (its basis build time and blocks'
                ``(nin, ng, nh, nnz)`` printed); every distinct block
                through the run-time K3/K4 (``emlp_block_any``,
                ``emlp_block_backward_any``) against the twins at 4096
                rows and phase 26's row counts, reruns bitwise, the CUDA
                kernels a call as phase 26's; each
                network's forward and backward at 4096 rows with the
                counts zeroed just before: exactly 3 run-time K3 and 3 K4
                launches and none of the instances, the output and every
                gradient at 256 rows within 1e-4 of the CPU network, the
                equivariance error under 1e-4; 20 Adam steps of
                ``GeneralEMLP(V -> V0)`` on |x|^2 with the loss falling
                (60 K3 and 60 K4); ``Interface`` (three SO(3) vectors, a
                scoped EMLP of 62 channels through ``emlp_apply``) against
                the CPU module; one record per run-time wrapper on this
                path (``emlp_block_any:general``,
                ``emlp_block_backward_any:general``)
Then the card's name and power limit, one JSON line of kernel records, and
last the ``{"ok": true, "device": ...}`` line.

Imports nothing of JAX or of the JAX package.
"""
import contextlib
import ctypes
import functools
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from collections import Counter

import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
B = 4096
PPO_A_ENVS = 32          # PPO configuration A's envs: K1 and K2 + K8 rows
TICKS = 1000
TRAIN_STEPS = 300
SAC_STEPS = 200
SEED = 0
F32_EPS = 2.0 ** -23
CARD = ""            # nvidia-smi name and power limit, set in main()


T0 = time.perf_counter()


def log(phase, **kv):
    kv["t_s"] = round(time.perf_counter() - T0, 1)
    if phase in ("rollout", "eval", "train", "sac_train", "ppo_train",
                 "kernels", "mlp_nets", "driver") or phase.startswith(
                     ("train_", "eval_", "multi")):
        kv["card"] = CARD
    print(f"[{phase}] " + json.dumps(kv, sort_keys=False), flush=True)


def gpu_name_power():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------
_CYCLES_PER_MS = None


def _cycles_per_ms():
    global _CYCLES_PER_MS
    if _CYCLES_PER_MS is None:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        torch.cuda._sleep(20_000_000)
        e.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS = 20_000_000 / s.elapsed_time(e)
    return _CYCLES_PER_MS


def device_ms(fn, n, rounds=5):
    """Device time per call, back to back: the stream is kept busy by a spin
    kernel while the host enqueues ``n`` calls, then CUDA events bracket the
    calls; median over ``rounds``.  Also returns the host wall time per call
    (launch overhead included, synchronised)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    dev = []
    for _ in range(rounds):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(_cycles_per_ms() * wall * 1e3 * n * 2.0) + 100_000)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        dev.append(s.elapsed_time(e) / n)
    return statistics.median(dev), wall * 1e3


def kernel_ms(fn, n):
    """Device time per call as the sum of the CUDA kernels and copies
    ``torch.profiler`` records over ``n`` calls: for a function whose host
    enqueue is slower than its device work (an autograd backward of small
    ops), where ``device_ms`` reads the host's pace.  Also the host wall
    time per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us += getattr(ev, "device_time_total", None) or \
                getattr(ev, "cuda_time_total", 0)
    return us / 1e3 / n, wall * 1e3


def launches_per_call(fn, n=20):
    """CUDA kernels one call of ``fn`` launches, from a ``torch.profiler``
    trace of ``n`` calls after ``n`` in the profiler's warm-up window: the
    kernel-launch calls a call made to the CUDA runtime or driver
    (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``; a
    float: a count that is not the same every call shows), or where the
    trace holds none, the kernels a call (copies and fills not counted).
    The trace's device records of a short window can miss a kernel; its
    launch calls are recorded on the host as they are made."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    kernels, launch_calls = 0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not ev.key.startswith(("Memcpy", "Memset")):
                kernels += ev.count
        elif ev.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launch_calls += ev.count
    return (launch_calls or kernels) / n


def bound_ms(nbytes, flops):
    tb = nbytes / H100_BYTES_PER_S * 1e3
    tf = flops / H100_FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# Floating-point operations of the plain twins, counted from the code
# ---------------------------------------------------------------------------
_FLOP_FUNCS = {"add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1, "sqrt": 1,
               "sin": 1, "cos": 1, "atan2": 1, "abs": 1, "maximum": 1,
               "minimum": 1, "clamp": 2, "sigmoid": 3, "tanh": 1, "exp": 1,
               "__add__": 1, "__radd__": 1, "__sub__": 1, "__rsub__": 1,
               "__mul__": 1, "__rmul__": 1, "__truediv__": 1,
               "__rtruediv__": 1, "__rdiv__": 1, "__neg__": 1, "__abs__": 1}


def count_flops(fn, *args):
    """Elementwise floating-point operations ``fn`` performs, counted per
    output element (a transcendental counts as one), on the CPU."""
    from torch.overrides import TorchFunctionMode

    class Counter(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            w = _FLOP_FUNCS.get(getattr(func, "__name__", ""), 0)
            if w and isinstance(out, torch.Tensor) and out.is_floating_point():
                Counter.n += w * out.numel()
            return out

    with Counter():
        fn(*args)
    return Counter.n


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def _kernel_modules():
    from gym_rotor_tpu_torch.kernels import (emlp_actor, emlp_block,
                                             env_tick, flat_adamw, gae,
                                             mlp_ppo_actor, mlp_sac_actor,
                                             ppo_loss, replay, sac_sample,
                                             spectral)
    return [env_tick, emlp_actor, replay, emlp_block, flat_adamw, spectral,
            sac_sample, gae, ppo_loss, mlp_ppo_actor, mlp_sac_actor]


def _wrappers():
    """Every kernel wrapper by name (each carries its ``launches`` count)."""
    return {name: getattr(m, name) for m in _kernel_modules()
            for name in m.WRAPPERS}


def block_specs(dev):
    """The 16 K3/K4 instances' specs, from the learners' networks at full
    width: TD3's actor and twin Q critic and PPO's V critic of every agent
    of MODUL DTDE, MONO and MODUL CTDE."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    from gym_rotor_tpu_torch.utils.config import Config
    specs = {}
    for kw in ({}, {"framework": "MONO"}, {"module_training": "CTDE"}):
        cfg = Config(**kw)
        for i in range(cfg.n_agents):
            td3 = TD3Agent(cfg, i, dev)
            ppo = PPOAgent(cfg.replace(rl_algo="PPO"), i, dev)
            for net, prefix in ((td3.actor_net.network, "network."),
                                (td3.critic_net.network1, "network1."),
                                (ppo.critic_net.network, "network.")):
                for _, blk in net.named_blocks(prefix):
                    spec = K.block_spec(blk, dev)
                    specs[spec.dims] = spec
    if set(specs) != K.INSTANCES:
        raise AssertionError(f"K3/K4 instances {sorted(specs)}")
    return specs


def block_resources(dev):
    """Per K3/K4 instance: registers, spill stores and loads of each kernel
    (``-Xptxas -v``), and the dynamic shared memory of the forward under
    the plans of 256 and 409 600 rows and of the backward's main kernel
    under those of 256 and 3723 rows, each read from the library and held
    to the wrapper's layout arithmetic."""
    import re
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    regs, cur = {}, None
    for ln in K.KERNEL.ptxas.splitlines():
        m = re.search(r"(block_fwd_kernel|block_bwd_kernel)ILi(\d+)ELi"
                      r"(\d+)ELi\d+E(?:Lb([01])E)?", ln)
        if "Compiling entry function" in ln and m:
            cur = (m.group(1) + ("_nosave" if m.group(4) == "0" else ""),
                   int(m.group(2)), int(m.group(3)))
            regs.setdefault(cur[1:], {})[cur[0]] = {}
        elif cur and "spill stores" in ln:
            n = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            regs[cur[1:]][cur[0]].update(spill_stores=n[1], spill_loads=n[2])
        elif cur and "registers" in ln:
            regs[cur[1:]][cur[0]]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    lib, bad = K._lib(), []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dims, spec in sorted(block_specs(dev).items()):
        smem = {}
        for kind, which, mirror, rows in (
                ("forward", 0, K.forward_smem, (256, 409600)),
                ("backward", 1, K.backward_smem, (256, 3723))):
            for nb in rows:
                G = spec.groups(kind, nb, sms)
                _, meta = spec.plan_args(kind, G)
                got = lib.emlp_block_smem(*dims, meta, which)
                smem[f"{kind}_{nb}_rows_{G}_groups"] = got
                if got != mirror(dims, tuple(meta)):
                    bad.append((dims, kind, nb, got))
        log("build", kernel="emlp_block", dims=list(dims), nnz=spec.nnz,
            self_gated=int((spec.gidx == torch.arange(
                spec.nh, device=spec.gidx.device)).sum()),
            ptxas=regs.get(dims[:2], {}), smem_bytes=smem)
        if not regs.get(dims[:2]):
            bad.append((dims, "no ptxas entry"))
    if bad:
        raise AssertionError(f"K3/K4 resources: {bad}")


def _ptxas_entries(ptxas, pattern):
    """Registers and spill bytes per entry of ``-Xptxas -v`` output whose
    mangled name matches ``pattern`` (its groups, as ints, the key)."""
    import re
    out, cur = {}, None
    for ln in ptxas.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(pattern, ln)
            cur = tuple(int(g) for g in m.groups()) if m else None
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in ln:
            n = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[cur].update(spill_stores=n[1], spill_loads=n[2])
        elif cur and "registers" in ln:
            out[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return out


def actor_instances(dev):
    """One seeded actor per instance and head of the acting kernel:
    ``{(dims, head name): actor}`` (MODUL agents 0 and 1, MONO agent 0;
    the PPO actor's ``log_std`` at 0.3)."""
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.models.emlp import zoo as Z
    from gym_rotor_tpu_torch.utils.config import Config
    out = {}
    for fw, agent in (("MODUL", 0), ("MODUL", 1), ("MONO", 0)):
        cfg = Config(framework=fw)
        reps = Z.actor_reps(cfg, fw, agent)
        act = cfg.action_dim_n[agent]
        gen = torch.Generator().manual_seed(SEED + agent)
        for head, make in (
                ("tanh", lambda: Z.EMLPActorDet(*reps, device="cpu",
                                                generator=gen)),
                ("gauss", lambda: Z.EMLPActorSAC(*reps, act, device="cpu",
                                                 generator=gen)),
                ("ppo", lambda: Z.EMLPActorPPO(*reps, act, device="cpu",
                                               generator=gen))):
            actor = make().to(dev)
            if head == "ppo":
                with torch.no_grad():
                    actor.log_std.fill_(0.3)
                actor.bump_version()
            out[(KA.actor_dims(actor), head)] = actor
    return out


def actor_spectral_resources(dev):
    """The redesigned kernels' resources: per acting-kernel instance and
    head, and per K7 instance, the registers and spills ``-Xptxas -v``
    reports; the acting launch's dynamic shared memory read from the
    library for each instance's fold, and K7's instance and shared memory
    for every stack the learners launch, each held to the wrapper's
    arithmetic (``actor_smem``, ``spectral.instance``/``smem_bytes``)."""
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.kernels import spectral as KS
    heads = {"tanh": KA.HEAD_TANH, "gauss": KA.HEAD_GAUSS, "ppo": KA.HEAD_PPO}
    regs = _ptxas_entries(KA.KERNEL.ptxas, r"emlp_actor_kernelILi(\d+)ELi"
                          r"(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E")
    lib, bad = KA._lib(), []
    for (dims, head), actor in sorted(actor_instances(dev).items()):
        f = KA.fold_actor(actor)
        got = lib.emlp_actor_smem(*dims, f["meta"])
        want = KA.actor_smem(dims, f["layout"])
        ptx = regs.get(dims + (heads[head],), {})
        log("build", kernel="emlp_actor", dims=list(dims), head=head,
            nnz=list(f["nnz"]), image_words=f["layout"]["words"],
            warps=f["layout"]["warps"], ptxas=ptx, smem_bytes=got)
        if got != want or not ptx:
            bad.append(("emlp_actor", dims, head, got, want, ptx))
    regs = _ptxas_entries(KS.KERNEL.ptxas, r"spectral_kernelILi(\d+)ELi"
                          r"(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E")
    lib = KS._lib()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    shapes = sorted({tuple(Ws.shape)
                     for *_, Ws, _ in learner_stacks(dev, gen)})
    for geo in KS.INSTANCES:
        mine = [list(sh) for sh in shapes if KS.instance(*sh[1:]) == geo]
        smem = {}
        for K, mo, mi in mine:
            out = (ctypes.c_int * 5)()
            got = lib.spectral_geometry(mo, mi, out)
            smem[f"{mo}x{mi}"] = got
            if tuple(out) != geo or got != KS.smem_bytes(mo, mi):
                bad.append(("spectral", (mo, mi), tuple(out), got))
        ptx = regs.get(geo, {})
        log("build", kernel="spectral_iterate", instance=list(geo),
            threads=geo[0] * geo[2], staging_threads=geo[4], stacks=mine,
            ptxas=ptx, smem_bytes=smem)
        if not ptx:
            bad.append(("spectral", geo, "no ptxas entry"))
    if bad:
        raise AssertionError(f"actor / K7 resources: {bad}")


def phase_build(dev):
    from gym_rotor_tpu_torch.kernels import build
    srcs = [m.KERNEL for m in _kernel_modules()]
    t0 = time.perf_counter()
    build.build_all(srcs)
    wall = time.perf_counter() - t0
    for s in srcs:
        log("build", kernel=s.name, nvcc_s=s.build_seconds,
            ptxas=s.resources())
    log("build", parallel_wall_s=wall)
    block_resources(dev)
    actor_spectral_resources(dev)
    widths_resources(dev)
    from gym_rotor_tpu_torch.kernels import env_tick as KT
    k1 = env_tick_resources(KT)
    k2 = replay_resources()
    log("build", kernel="env_tick", per_instance=k1)
    log("build", kernel="replay", per_kernel=k2)
    want = {f"{t}_{i}" + ("_exact" if e else "")
            for t in KT.TASKS for i in KT.INTEGRATORS for e in (False, True)
            if t in KT.BATCHED_TASKS or e}
    kinds = {k: ({"tile", "thread"} if k.split("_")[0] in KT.BATCHED_TASKS
                 else {"thread"}) for k in want}
    if {k: set(v) for k, v in k1.items()} != kinds \
            or set(k2) != {"insert_kernel", "gather_kernel"}:
        raise AssertionError(f"env_tick / replay resources: {k1} {k2}")


def _field_errors(named_k, named_p, skip):
    """Per field max abs / rel difference over envs not in ``skip``;
    continuous fields must satisfy |k - p| <= 1e-6 + 1e-5 |p|."""
    errs, bad, worst = {}, [], 0.0
    keep = ~skip
    for path, p in named_p.items():
        k = named_k[path]
        kk, pp = k[keep], p[keep]
        if p.is_floating_point():
            d = (kk.double() - pp.double()).abs()
            rel = d / pp.double().abs().clamp_min(1e-30)
            a, r = float(d.max()) if d.numel() else 0.0, float(rel.max()) if d.numel() else 0.0
            errs[path] = [a, r]
            worst = max(worst, a)
            if d.numel() and bool((d > 1e-6 + 1e-5 * pp.double().abs()).any()):
                bad.append(path)
        else:
            n = int((kk != pp).sum())
            errs[path] = n
            if n:
                bad.append(path)
    return errs, bad, worst


def _near_threshold(out):
    """Envs whose deciding value lies within 1e-5 of a threshold: crash
    limits |obs| >= 1 (MODUL: ex, ev, ew12 and eW3; MONO: ex, ev, eW) and
    the solved tolerances |ex|, |eb1| <= 0.03."""
    if len(out.info["terminal_obs"]) == 2:
        o1, o2 = out.info["terminal_obs"]
        crash = torch.cat([o1[:, 0:3], o1[:, 6:9], o1[:, 12:15], o2[:, 2:3]],
                          1)
    else:
        (o,) = out.info["terminal_obs"]
        crash = torch.cat([o[:, 0:3], o[:, 6:9], o[:, 20:23]], 1)
    near = ((crash.abs() - 1.0).abs() < 1e-5).any(1)
    near |= ((out.info["ex"].abs() - 0.03).abs() < 1e-5).any(1)
    near |= (out.info["eb1"].abs() - 0.03).abs() < 1e-5
    return near


def _named(state, out=None):
    from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
    d = {f"state.{p}": t for p, t in tree_named_leaves(state)}
    if out is not None:
        d.update({"reward": out.reward, "done": out.done,
                  "reset_happened": out.reset_happened,
                  "info.ex": out.info["ex"], "info.eb1": out.info["eb1"],
                  "info.crashed": out.info["crashed"]})
        for a, (o, t) in enumerate(zip(out.obs, out.info["terminal_obs"])):
            d[f"obs{a + 1}"] = o
            d[f"info.terminal_obs{a + 1}"] = t
    return d


def _tick_inputs(cfg, dev, n, gen):
    """Makers of ``n`` envs' actions for ``cfg.framework``'s task (MODUL:
    (f, tau, M3); MONO: (f, M), the moments taken as they are) and of one
    tick's base draws."""
    from gym_rotor_tpu_torch.envs import draws as D
    n_act = sum(cfg.action_dim_n)
    spread = 0.35 if cfg.framework == "MODUL" else 0.2

    def actions():
        a = spread * torch.randn(n, n_act, generator=gen, device=dev)
        a[:, 0] = torch.rand(n, generator=gen, device=dev) * 0.5 - 0.4
        return a

    def uniforms():
        return D.draw_uniforms(n, gen, torch.float32, dev)
    return actions, uniforms


def _reset_vs_plain(cfg, draws, env_type, dev):
    """K1's reset entry vs ``batched_reset_plain`` on ``draws``: returns the
    plain state, the per-field errors, the fields out of tolerance and the
    worst error."""
    from gym_rotor_tpu_torch.envs.batch import batched_reset_plain
    from gym_rotor_tpu_torch.kernels import env_tick as K
    st_k, obs_k = K.env_reset(cfg, draws, env_type)
    st_p, obs_p = batched_reset_plain(cfg, draws, env_type)
    nk, np_ = _named(st_k), _named(st_p)
    for a in range(cfg.n_agents):
        nk[f"obs{a + 1}"], np_[f"obs{a + 1}"] = obs_k[a], obs_p[a]
    n = draws.shape[0]
    errs, bad, worst = _field_errors(
        nk, np_, torch.zeros(n, dtype=torch.bool, device=dev))
    return st_p, errs, bad, worst


def _tick_vs_plain(cfg, st, a, dr, env_type, dev):
    """One K1 tick and one plain tick on the same state, actions and draws:
    the discrete fields equal except in envs near a threshold, the rest
    within K1's tolerance over the envs whose discrete fields agree."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    n = a.shape[0]
    st_k, out_k = K.env_tick(cfg, st, a, dr, env_type)
    st_p, out_p = K.env_tick_plain(cfg, st, a, dr, env_type)
    nk, np_ = _named(st_k, out_k), _named(st_p, out_p)
    near = _near_threshold(out_p) | _near_threshold(out_k)
    mismatch = torch.zeros(n, dtype=torch.bool, device=dev)
    for path, p in np_.items():
        if not p.is_floating_point():
            mismatch |= (nk[path] != p).reshape(n, -1).any(1)
    errs, bad, err = _field_errors(nk, np_, mismatch)
    return dict(st_k=st_k, out_k=out_k, st_p=st_p, out_p=out_p, near=near,
                mismatch=mismatch, unexplained=int((mismatch & ~near).sum()),
                errs=errs, bad=bad, err=err)


def phase_env_tick(cfg, dev, n, env_type, ticks=1):
    """K1 (reset entry and tick) vs the plain twin on ``n`` envs of
    ``cfg.framework``'s task: the reset entry; then after 50 plain ticks,
    ``ticks`` ticks each run by the kernel and by the plain twin from the
    same state, actions and draws with ~10% of envs set one tick from the
    cap, the plain result carried to the next."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    gen = torch.Generator(device=dev).manual_seed(SEED)
    actions, uniforms = _tick_inputs(cfg, dev, n, gen)
    st, errs, bad, worst_reset = _reset_vs_plain(cfg, uniforms(), env_type,
                                                 dev)
    log("env_tick", check="reset kernel vs plain", task=K.task_of(cfg),
        envs=n, env_type=env_type, max_abs_err=worst_reset, fields=errs)
    if bad:
        raise AssertionError(f"env reset kernel disagrees with plain: {bad}")

    for _ in range(50):
        st, _ = K.env_tick_plain(cfg, st, actions(), uniforms(), env_type)
    worst, n_reset, crashes = 0.0, 0, 0
    for k in range(ticks):
        idx = torch.randperm(n, generator=gen, device=dev)[: max(1, n // 10)]
        st.env.t[idx] = cfg.max_steps - 1
        a, dr = actions(), uniforms()
        c = _tick_vs_plain(cfg, st, a, dr, env_type, dev)
        worst = max(worst, c["err"])
        resets = int(c["out_p"].reset_happened.sum())
        crashed = int(c["out_p"].info["crashed"].any(-1).sum())
        n_reset += resets
        crashes += crashed
        log("env_tick", check="tick kernel vs plain", task=K.task_of(cfg),
            tick=k, envs=n, env_type=env_type, resets=resets,
            crash_resets=crashed, caps_set=int(idx.numel()),
            near_threshold_envs=int(c["near"].sum()),
            discrete_mismatch_envs=int(c["mismatch"].sum()),
            unexplained_mismatch_envs=c["unexplained"], max_abs_err=c["err"],
            fields=c["errs"])
        if c["unexplained"] or c["bad"]:
            raise AssertionError(f"env_tick kernel disagrees with plain: "
                                 f"{c['unexplained']} envs, fields {c['bad']}")
        if k + 1 < ticks:
            st = c["st_p"]
    if n_reset <= crashes:
        raise AssertionError("env_tick compare crossed no cap")
    return dict(state=st, actions=a, draws=dr,
                max_abs_err=max(worst, worst_reset))


def actor_rows(n_full):
    """The acting kernel's row counts to check: the Gym API's 1, the eval
    path's 10, PPO A's 32 envs, a tile's edges 31 and 33, and the training
    envs ``n_full``."""
    return (1, 10, 31, 32, 33, n_full)


def _twice(fn):
    """``fn()``'s result and whether a second call repeats it bit for bit
    (every tensor of it)."""
    a, b = fn(), fn()
    a_t, b_t = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return a, all(torch.equal(x, y) for x, y in zip(a_t, b_t))


def phase_emlp(cfg, dev, obs):
    """K3-actor vs its plain twin for every agent of ``cfg`` at
    ``actor_rows`` (seeded weights), each launch run twice and compared
    bitwise; tolerance 1e-5 (tanh outputs)."""
    from gym_rotor_tpu_torch.kernels import emlp_actor as K
    from gym_rotor_tpu_torch.models.emlp.zoo import make_actors
    actors = make_actors(cfg, device=dev, seed=SEED)
    worst = 0.0
    for i, (actor, o_full) in enumerate(zip(actors, obs)):
        for nb in actor_rows(int(o_full.shape[0])):
            o = o_full[:nb]
            with torch.no_grad():
                yk, same = _twice(lambda: K.emlp_actor(actor, o))
                yp = K.emlp_actor_plain(actor, o)
            err = float((yk - yp).abs().max())
            worst = max(worst, err)
            log("emlp_actor", agent=i, batch=nb, dims=K.actor_dims(actor),
                max_abs_err=err, rerun_bitwise=same,
                finite=bool(torch.isfinite(yk).all()))
            if not (err <= 1e-5 and same and torch.isfinite(yk).all()):
                raise AssertionError(f"emlp_actor agent {i} at {nb} rows: "
                                     f"max abs err {err}, rerun equal {same}")
    return actors, worst


def phase_rollout(cfg, dev, actors):
    from gym_rotor_tpu_torch.envs.batch import batched_reset, rollout
    from gym_rotor_tpu_torch.evaluate import joint_policy
    from gym_rotor_tpu_torch.kernels.emlp_actor import emlp_actor
    from gym_rotor_tpu_torch.kernels.env_tick import env_tick
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bs, obs = batched_reset(cfg, gen, device=dev)
    policy = joint_policy(actors)
    torch.cuda.synchronize()
    env_tick.launches = 0
    emlp_actor.launches = 0
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    bs, obs, trs, outs = rollout(cfg, bs, obs, policy, TICKS, gen)
    e.record()
    torch.cuda.synchronize()
    launches = {"env_tick": env_tick.launches, "emlp_actor": emlp_actor.launches}
    ms = s.elapsed_time(e)
    R = bs.env.R
    ortho = float((R.transpose(-1, -2) @ R - torch.eye(3, device=dev)).abs().max())
    r = outs.reward
    r_ok = bool((((r >= 0) & (r <= 1)) | (r == -1)).all())
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (r, outs.obs[0], outs.obs[1], bs.env.x, bs.env.R))
    log("rollout", envs=B, ticks=TICKS, launches=launches,
        env_steps_per_s=B * TICKS / (ms / 1e3), rollout_ms=ms,
        max_RtR_minus_I=ortho, rewards_in_range=r_ok, finite=finite,
        episodes_ended=int(outs.reset_happened.sum()),
        mean_reward=[float(x) for x in r.clamp_min(0).mean((0, 1))])
    if launches != {"env_tick": TICKS, "emlp_actor": 2 * TICKS}:
        raise AssertionError(f"launch counts {launches}")
    if not (ortho < 1e-5 and r_ok and finite):
        raise AssertionError("rollout invariants failed")


def eval_kernel(cfg):
    """The kernel an actor of ``cfg`` launches per agent and eval tick:
    the deterministic head of K3 (TD3), K9 (SAC) or K11 (PPO) for EMLP;
    the fused MLP PPO or SAC actor for PPO's and SAC's MLP actors; none for
    TD3's MLP actor (``tanh`` of the ``F.linear`` chain)."""
    if cfg.use_equiv:
        return {"TD3": "emlp_actor", "SAC": "sac_actor",
                "PPO": "ppo_actor"}[cfg.rl_algo]
    return {"PPO": "mlp_ppo_actor", "SAC": "mlp_sac_actor"}.get(cfg.rl_algo)


def phase_eval(cfg, dev, actors, name="eval"):
    """``evaluate`` with ``actors`` (EMLP: one launch of K3's, K9's or
    K11's deterministic head per agent and tick; MLP: one launch of the
    fused MLP PPO or SAC actor, TD3's torch ops) on ``cfg.framework``'s
    task: launch counts, the success column per agent (MONO: position
    only), finite rewards."""
    from gym_rotor_tpu_torch.envs.quad import DT
    from gym_rotor_tpu_torch.evaluate import evaluate
    ticks = int(round(cfg.eval_max_steps / DT))
    wr = _wrappers()
    torch.cuda.synchronize()
    for w in wr.values():
        w.launches = 0
    t0 = time.perf_counter()
    ep, bench, succ, ex, eb1, _ = evaluate(cfg, actors, device=dev)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wr.items() if w.launches}
    n = cfg.n_agents
    vals = [float(x) for x in ep] + [float(bench)]
    log(name, framework=cfg.framework, module_training=cfg.module_training,
        rl_algo=cfg.rl_algo, use_equiv=cfg.use_equiv,
        envs=cfg.num_eval, ticks=ticks, launches=launches,
        mean_episode_reward=vals[:n], benchmark_reward=vals[n],
        success=[int(x) for x in succ.sum(0)], wall_s=time.perf_counter() - t0)
    # one reset launch, then one K1 and the actor's kernel per agent a tick
    want = {"env_tick": 1 + ticks}
    if eval_kernel(cfg):
        want[eval_kernel(cfg)] = n * ticks
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches}, want {want}")
    if tuple(succ.shape) != (cfg.num_eval, n) or len(ep) != n:
        raise AssertionError(f"{name}: success {tuple(succ.shape)}")
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"{name} produced non-finite rewards")


def _err(k, p, rel=2e-5):
    """(max |k - p|, tolerance ``rel * max(1, max |p|)``, finite)."""
    if p.numel() == 0:
        return 0.0, rel, True
    d = float((k.double() - p.double()).abs().max())
    return d, rel * max(1.0, float(p.abs().max())), bool(torch.isfinite(k).all())


def sample_layouts():
    """The gather layouts the train paths sample into, by name: (ctde,
    stack) for TD3 and SAC, DTDE and CTDE, and a sample with no learner's
    stack."""
    from gym_rotor_tpu_torch.algos import replay as R
    from gym_rotor_tpu_torch.algos import sac, td3
    return {"plain": (False, R.PLAIN_STACK), "td3": (False, td3.CAPS_STACK),
            "td3_ctde": (True, td3.CAPS_STACK),
            "sac": (False, sac.caps_stack(False)),
            "sac_ctde": (True, sac.caps_stack(True))}


def _gather_vs_plain(ring, idx, dims, ctde, stack):
    """K2 sample vs its twin into one layout: the written regions bitwise,
    a rerun bitwise, and the ``Batch``'s fields and operands bitwise the
    ring rows' columns and their concatenations (the fields the sample
    returned before it wrote operands, and what the learners built from
    them).  Returns the log record's checks."""
    from gym_rotor_tpu_torch.algos import replay as R
    from gym_rotor_tpu_torch.kernels import replay as K
    lay = R.gather_layout(dims, ctde, stack)
    nb = idx.shape[0]
    bk, bk2 = K.replay_sample(ring, idx, False, lay), \
        K.replay_sample(ring, idx, False, lay)
    bp = K.replay_sample_plain(ring, idx, False, lay)
    wk, wp = lay.written(bk, nb), lay.written(bp, nb)
    mismatch = sum(int((a != b).sum()) for a, b in zip(wk, wp))
    rerun = _bitwise(wk, lay.written(bk2, nb))
    rs = R.ReplayState(data=ring, ptr=0, filled=ring.shape[0], dims=dims)
    batch = R.sample(rs, nb, idx=idx, ctde=ctde, stack=stack)
    old = R._split(ring[idx], dims)
    fields = _bitwise([t for f in batch[:5] for t in f],
                      [t for f in old for t in f])
    n = len(dims[0])
    ops = []
    for i in range(n):
        sa, t_obs, stk = R.learner_operands(batch, i, ctde, stack)
        hand = R.learner_operands(R.Batch(*old), i, ctde, stack)
        ops.append(_bitwise([sa] + ([t_obs] if ctde else []),
                            [hand[0]] + ([hand[1]] if ctde else [])))
        keep = [q for q, f in enumerate(stack) if f != "eps"]
        ops.append(_bitwise([stk[q * nb:(q + 1) * nb] for q in keep],
                            [hand[2][q * nb:(q + 1) * nb] for q in keep]))
    return dict(regions=len(lay.regions), floats_per_row=lay.gathered,
                mismatch=mismatch, rerun_bitwise=rerun,
                fields_bitwise=fields, operands_bitwise=all(ops))


def phase_replay(cfg, dev, out):
    """K2 + K8 kernel vs plain on the same inputs: the compare-phase tick's
    K1 outputs (field-major views, ~10% of envs reset) written into a
    1e6-row ring across its wrap, with ``ep_ret`` and the stats; then K2
    sample: 256 rows gathered into the learners' operands of every layout
    the train paths use (``sample_layouts``: TD3 and SAC, DTDE and CTDE, on
    MODUL's ring and DTDE on a MONO ring), bitwise the twin's, reruns
    bitwise, the ``Batch``'s fields and operands bitwise the ring rows'
    columns and their concatenations; and the empty ring's poison in every
    layout."""
    from gym_rotor_tpu_torch.algos import replay as R
    from gym_rotor_tpu_torch.kernels import replay as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    dims = (tuple(cfg.obs_dim_n), tuple(cfg.action_dim_n))
    cap = cfg.replay_buffer_size
    ring_k = torch.rand(cap, R.row_dim(*dims), generator=gen, device=dev)
    ring_p = ring_k.clone()
    ptr = cap - B // 3                    # the tick's rows wrap the end
    actions = torch.rand(B, sum(dims[1]), generator=gen, device=dev) * 2 - 1
    ep_k = torch.randn(B, cfg.n_agents, generator=gen, device=dev)
    ep_p = ep_k.clone()
    st_k = torch.zeros(cfg.n_agents + 2, device=dev)
    st_p = st_k.clone()
    args = (out.obs, actions, out.reward, out.info["terminal_obs"], out.done)
    K.replay_insert_tick(ring_k, ptr, dims, *args, reset=out.reset_happened,
                         ep_ret=ep_k, stats=st_k)
    K.replay_insert_tick_plain(ring_p, ptr, dims, *args, out.reset_happened,
                               ep_p, st_p)
    ring_diff = int((ring_k != ring_p).sum())
    ep_diff = int((ep_k != ep_p).sum())
    # fixed-order block partials vs torch's sum over 4096 envs
    d_stats, tol_stats, _ = _err(st_k, st_p, 1e-5)
    log("replay", ring_rows=cap, ptr=ptr, rows=B,
        resets=int(out.reset_happened.sum()), ring_mismatch=ring_diff,
        ep_ret_mismatch=ep_diff, stats_max_abs_err=d_stats,
        stats=[float(x) for x in st_k])
    bad = ring_diff or ep_diff or not d_stats <= tol_stats
    idx = torch.randint(0, cap, (cfg.batch_size,), generator=gen, device=dev)
    mono = ((23,), (4,))
    ring_mono = torch.rand(B, R.row_dim(*mono), generator=gen, device=dev)
    idx_mono = torch.randint(0, B, (cfg.batch_size,), generator=gen,
                             device=dev)
    for name, (ctde, stack) in sample_layouts().items():
        for fw, ring, d, ix in (("MODUL", ring_k, dims, idx),
                                ("MONO", ring_mono, mono, idx_mono)):
            if fw == "MONO" and ctde:
                continue
            rec = _gather_vs_plain(ring, ix, d, ctde, stack)
            empty = R.create(cap, *d, device=dev)
            poisoned = R.sample(empty, 8, idx=ix[:8] * 0, ctde=ctde,
                                stack=stack)
            ops = poisoned.ops
            rec["empty_ring_poisoned"] = all(
                bool(torch.isnan(t).all()) for t in
                [t for f in poisoned[:5] for t in f] + list(ops.sa)
                + ([ops.t_obs] if ctde else []))
            log("replay", sample=name, framework=fw, rows=cfg.batch_size,
                stack=list(stack), ctde=ctde, **rec)
            bad = bad or rec["mismatch"] or not (
                rec["rerun_bitwise"] and rec["fields_bitwise"]
                and rec["operands_bitwise"] and rec["empty_ring_poisoned"])
    if bad:
        raise AssertionError("replay kernels disagree with plain")
    return dict(ring=ring_k, ptr=ptr, args=args, actions=actions,
                reset=out.reset_happened, idx=idx, max_abs_err=d_stats)


# row counts not a multiple of the kernels' 32-row tile, and PPO B's
# minibatch, at which every block's kernels are held to their twins
EDGE_ROWS = (1, 31, 33, 255, 3723)


def _block_vs_plain(spec, x, W, b, v, g_h):
    """One block's K3/K4 vs the twins on the same inputs: the forward
    saving lin and pre; the forward without them under ``no_grad`` (h vs
    the twin's, nothing returned besides); the backward with and without
    the parameter sums against the twin on the kernel's lin and pre, each
    run twice (the rerun must be bitwise equal).  Tolerance 2e-5 max(1, max
    |plain|).  Returns ({name: max abs err, "rerun_bitwise": bool},
    failures, the twin's h)."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    fk = K.emlp_block(spec, x, W, b, v)
    fp = K.emlp_block_plain(spec, x, W, b, v)
    with torch.no_grad():
        hk, lin_n, pre_n = K.emlp_block(spec, x, W, b, v, save=False)
    runs = [K.emlp_block_backward(spec, g_h, x, W, v, fk[1], fk[2], need)
            for need in (True, True, False, False)]
    bp = K.emlp_block_backward_plain(spec, g_h, x, W, v, fk[1], fk[2], True)
    errs, bad = {}, []
    for nm, kk, pp in zip(("h", "lin", "pre", "h_unsaved", "g_x", "g_W",
                           "g_b", "g_v", "g_x_only"),
                          fk + (hk,) + runs[0] + (runs[2][0],),
                          fp + (fp[0],) + bp + (bp[0],)):
        d, tol, fin = _err(kk, pp)
        errs[nm] = d
        if not (d <= tol and fin):
            bad.append((nm, d, tol))
    if lin_n is not None or pre_n is not None:
        bad.append(("the unsaved forward returned lin or pre",))
    errs["rerun_bitwise"] = all(
        torch.equal(a, c) for r1, r2 in (runs[:2], runs[2:])
        for a, c in zip(r1, r2) if a is not None)
    if not errs["rerun_bitwise"]:
        bad.append(("a K4 rerun differs",))
    return errs, bad, fp[0]


def _worst(worst, errs):
    """Fold a ``_block_vs_plain`` result into (forward, backward) maxima."""
    f = max(errs[k] for k in ("h", "lin", "pre", "h_unsaved"))
    g = max(errs[k] for k in ("g_x", "g_W", "g_b", "g_v", "g_x_only"))
    return max(worst[0], f), max(worst[1], g)


def _plain_apply(module, views, *args):
    """``module``'s structured (plain) forward with ``views`` as its
    parameters, under torch autograd."""
    from torch.func import functional_call
    return functional_call(module, views, args)


def _block_inputs(agent, st, i, obs, act):
    """Per network of agent ``i``: (name, EMLP module, parameter views,
    prefix, input, batches on the update path and the edge cases)."""
    o = obs[i]
    return [("actor", agent.actor_net.network, agent.actor_layout.views(st.actor),
             "network.", o, (256, 768, 1024) + EDGE_ROWS),
            ("critic1", agent.critic_net.network1,
             agent.critic_layout.views(st.critic), "network1.",
             torch.cat([o, act], -1), (256,) + EDGE_ROWS),
            ("critic2", agent.critic_net.network2,
             agent.critic_layout.views(st.critic), "network2.",
             torch.cat([o, act], -1), (256,))]


def phase_emlp_block(cfg, dev, agents, states, obs, n_shapes=8):
    """K3/K4 vs plain per block (``_block_vs_plain``: forward saving and
    not, backward with and without the parameter sums, each backward rerun
    bitwise) at the update's batches and at ``EDGE_ROWS``; then the
    critics' and actors' whole kernel path under autograd vs their
    structured networks.  Tolerance 2e-5 max(1, max |plain|): float32 sums
    over up to 123 channels, 9394 nonzeros or 3723 rows, taken in another
    order."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    from gym_rotor_tpu_torch.models.emlp.nn import bilinear_sparse, project_linear
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = (0.0, 0.0)
    bad, shapes = [], set()
    for i, (agent, st) in enumerate(zip(agents, states)):
        act = torch.rand(obs[i].shape[0], cfg.action_dim_n[i], generator=gen,
                         device=dev) * 2 - 1
        for name, net, views, prefix, x0, batches in _block_inputs(
                agent, st, i, obs, act):
            for nb in batches:
                x = x0[:nb].contiguous()
                for k, blk in enumerate(net.blocks()):
                    pre = f"{prefix}block{k}."
                    with torch.no_grad():
                        W, b = project_linear(blk.linear.rep_in, blk.linear.rep_out,
                                              views[pre + "linear.kernel"],
                                              views[pre + "linear.bias"])
                        spec = K.block_spec(blk, dev)
                        bi = views.get(pre + "bilinear.bi_params")
                        v = (bilinear_sparse(blk.bilinear.rep, bi)[3]
                             if bi is not None else W.new_zeros(spec.nnz))
                    W, b, v = W.contiguous(), b.contiguous(), v.contiguous()
                    g_h = torch.randn(nb, spec.nh, generator=gen, device=dev)
                    errs, failed, h = _block_vs_plain(spec, x, W, b, v, g_h)
                    worst = _worst(worst, errs)
                    bad += [(i, name, k, nb) + f for f in failed]
                    shapes.add(spec.dims)
                    log("emlp_block", agent=i, net=name, block=k,
                        dims=list(spec.dims), nnz=spec.nnz, batch=nb,
                        max_abs_err=errs)
                    x = h
        # the whole kernel path under autograd vs the structured networks
        o, a = obs[i][:256], act[:256]
        for name, fk_fn, module, layout, flat, args in (
                ("critic", lambda vw: sum(q.sum() for q in agent.critic_apply(vw, o, a)),
                 agent.critic_net, agent.critic_layout, st.critic, (o, a)),
                ("actor", lambda vw: agent.actor_apply(vw, obs[i][:768]).sum(),
                 agent.actor_net.network, agent.actor_layout, st.actor,
                 (obs[i][:768],))):
            leaf_k = flat.detach().clone().requires_grad_(True)
            yk = fk_fn(layout.views(leaf_k))
            (gk,) = torch.autograd.grad(yk, leaf_k)
            leaf_p = flat.detach().clone().requires_grad_(True)
            vp = layout.views(leaf_p)
            if name == "actor":
                vp = {n[len("network."):]: t for n, t in vp.items()}
                yp = torch.tanh(_plain_apply(module, vp, *args)).sum()
            else:
                yp = sum(q.sum() for q in _plain_apply(module, vp, *args))
            (gp,) = torch.autograd.grad(yp, leaf_p)
            dv, tolv, finv = _err(yk.detach(), yp.detach())
            dg, tolg, fing = _err(gk, gp)
            log("emlp_block", agent=i, check=f"{name} autograd vs structured",
                value_err=dv, grad_max_abs_err=dg, grad_scale=float(gp.abs().max()))
            if not (dv <= tolv and dg <= tolg and finv and fing):
                bad.append((i, name, "autograd", dv, dg))
    if len(shapes) != n_shapes:
        raise AssertionError(f"expected {n_shapes} block shapes, saw "
                             f"{sorted(shapes)}")
    if bad:
        raise AssertionError(f"emlp_block kernels disagree with plain: {bad}")
    return worst


FLAT_EDGE_SIZES = (1, 255, 256, 257, 2048, 2049, 262145)


def phase_flat_adamw(cfg, dev, agents, edges=False):
    """K6 vs plain on the four networks' flat vectors at count 7, with the
    gradient's norm below (10) and above (1000) the clip of 100, with the
    Polyak target; with ``edges`` also at ``FLAT_EDGE_SIZES`` (one element,
    a block's edges, the last size of blocks of their own and the first of
    clusters, and a size past one pass of the launch plan).  Built with
    -fmad=false: the chain rounds as the plain twin; only the norm's
    summation order differs.  Every call is run twice and compared bitwise,
    and a clipped call must launch exactly one CUDA kernel (the profiler's
    trace)."""
    from gym_rotor_tpu_torch.algos.common import FlatAdamW, OptState
    from gym_rotor_tpu_torch.kernels import flat_adamw as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst, bad = 0.0, []
    cases = [(i, net, n, lr) for i, agent in enumerate(agents)
             for net, n, lr in (("actor", agent.actor_layout.size,
                                 cfg.lr_a[i]),
                                ("critic", agent.critic_layout.size,
                                 cfg.lr_c[i]))]
    if edges:
        cases += [(None, "edge", n, cfg.lr_c[0]) for n in FLAT_EDGE_SIZES]
    for i, net, n, lr in cases:
        tx = FlatAdamW(cfg, lr)
        for norm in (10.0, 1000.0):
            def rnd(scale=1.0):
                return scale * torch.randn(n, generator=gen, device=dev)
            g = rnd()
            g *= norm / g.norm()
            p, tgt = rnd(), rnd()
            mu, nu = rnd(1e-2), rnd(1e-3).abs()
            s = tx.scalars(OptState(7, mu, nu, 7), cfg.tau)
            kk = [t.clone() for t in (p, mu, nu, tgt)]
            again = [t.clone() for t in (p, mu, nu, tgt)]
            pp = [t.clone() for t in (p, mu, nu, tgt)]
            K.flat_adamw(kk[0], g, kk[1], kk[2], s, kk[3])
            K.flat_adamw(again[0], g, again[1], again[2], s, again[3])
            K.flat_adamw_plain(pp[0], g, pp[1], pp[2], s, pp[3])
            torch.cuda.synchronize()
            errs = [_err(a, b, 1e-6) for a, b in zip(kk, pp)]
            worst = max([worst] + [e[0] for e in errs])
            rerun = _bitwise(kk, again)
            clipped = norm >= cfg.grad_max_norm
            rec = dict(agent=i, net=net, n=n, plan=list(K.flat_adamw_plan(n)),
                       grad_norm=norm, clipped=clipped,
                       max_abs_err=dict(zip(("p", "mu", "nu", "target"),
                                            [e[0] for e in errs])),
                       rerun_bitwise=rerun)
            ok = rerun and all(d <= tol and fin for d, tol, fin in errs)
            if clipped:
                bufs = [t.clone() for t in (p, mu, nu, tgt)]
                rec["kernels_a_call"] = launches_per_call(
                    lambda: K.flat_adamw(bufs[0], g, bufs[1], bufs[2], s,
                                         bufs[3]))
                ok = ok and rec["kernels_a_call"] == 1
            log("flat_adamw", **rec)
            if not ok:
                bad.append((i, net, n, norm))
    if bad:
        raise AssertionError(f"flat_adamw kernel disagrees with plain, reruns "
                             f"differ or a call is not one launch: {bad}")
    return worst


def _spectral_stacks(agents, states, dev, gen):
    from gym_rotor_tpu_torch.algos.regularizers import stack_padded
    from gym_rotor_tpu_torch.models.emlp.nn import spectral_weights
    out = []
    for i, (agent, st) in enumerate(zip(agents, states)):
        for net, layout, flat, widths in (
                ("critic", agent.critic_layout, st.critic, agent.critic_widths),
                ("actor", agent.actor_layout, st.actor, agent.actor_widths)):
            ws, _ = spectral_weights(layout.views(flat))
            starts = [torch.randn(w, generator=gen, device=dev) for w in widths]
            Ws, x = stack_padded(ws, starts)
            out.append((i, net, ws, Ws.detach().contiguous(), x))
    return out


# the learners whose networks K7 regularizes: (algorithm, framework label,
# Config keywords)
SPECTRAL_LEARNERS = tuple(
    (algo, fw, dict(rl_algo=algo, **kw)) for algo in ("TD3", "SAC", "PPO")
    for fw, kw in (("modul", {}), ("mono", dict(framework="MONO")),
                   ("ctde", dict(module_training="CTDE"))))


def learner_stacks(dev, gen):
    """Every padded weight stack the learners hand K7, at full width with
    seeded weights and N(0, 1) start vectors from ``gen``: each agent's
    critic (twin Q, or PPO's V) and actor of TD3, SAC and PPO on MODUL
    DTDE, MONO and MODUL CTDE, as ``(learner, agent, net, Ws, x)``."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.algos.sac import SACAgent
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.utils.config import Config
    classes = {"TD3": TD3Agent, "SAC": SACAgent, "PPO": PPOAgent}
    init = torch.Generator().manual_seed(SEED)
    out = []
    for algo, fw, kw in SPECTRAL_LEARNERS:
        cfg = Config(**kw)
        agents = [classes[algo](cfg, i, dev) for i in range(cfg.n_agents)]
        states = [a.init(init) for a in agents]
        out += [(f"{algo.lower()}_{fw}", i, net, Ws, x) for i, net, _, Ws, x
                in _spectral_stacks(agents, states, dev, gen)]
    return out


def phase_spectral(cfg, dev, agents, states, every_learner=False):
    """K7 vs plain: the 10-step iterate from the same start vectors on each
    network's padded weight stack and, with ``every_learner``, on every
    stack the learners launch (``learner_stacks``); each launch run twice
    and compared bitwise (unit vectors, tolerance 1e-5)."""
    from gym_rotor_tpu_torch.kernels import spectral as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    stacks = [(cfg.framework.lower(), i, net, Ws, x) for i, net, _, Ws, x
              in _spectral_stacks(agents, states, dev, gen)]
    if every_learner:
        stacks += learner_stacks(dev, gen)
    worst = 0.0
    for learner, i, net, Ws, x in stacks:
        vk, same = _twice(lambda: K.spectral_iterate(Ws, x))
        d, tol, fin = _err(vk, K.spectral_iterate_plain(Ws, x), 1e-5)
        worst = max(worst, d)
        log("spectral", learner=learner, agent=i, net=net,
            stack=list(Ws.shape), max_abs_err=d, rerun_bitwise=same)
        if not (d <= tol and fin and same):
            raise AssertionError(f"spectral kernel disagrees: {learner} agent "
                                 f"{i} {net}: {d}, rerun equal {same}")
    return worst


class _Dist(torch.nn.Module):
    """An ``EMLPActorSAC``'s structured ``dist`` as a module's forward, for
    ``functional_call`` with a leaf's views as its parameters."""

    def __init__(self, actor):
        super().__init__()
        self.actor = actor

    def forward(self, obs):
        return self.actor.dist(obs)


def phase_sac_actor(cfg, dev, obs):
    """K9 vs its plain twin (``EMLPActorSAC.dist`` and the squashed sample) on
    both SAC actors, at ``actor_rows`` (B = 4096, the eval path's 10, 1, 31,
    32, 33), in train mode (N(0, 1) noise) and eval mode (``tanh(mean)``), with
    the log_std head's bias as initialised and shifted by +-25 (every row at a
    clip bound), each launch run twice and compared bitwise. Tolerance 1e-5
    (tanh outputs). Then the actor loss's sample path at its 1024 rows, K3/K4
    trunk and K10 under autograd, vs the structured network and the plain
    sample under torch autograd: values and the flat gradient within 2e-5
    max(1, max |plain|)."""
    from torch.func import functional_call
    from gym_rotor_tpu_torch.algos.sac import SACAgent
    from gym_rotor_tpu_torch.kernels import emlp_actor as K
    from gym_rotor_tpu_torch.kernels.sac_sample import sac_sample_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    init = torch.Generator().manual_seed(SEED)
    scfg = cfg.replace(rl_algo="SAC")
    agents = [SACAgent(scfg, i, dev) for i in range(cfg.n_agents)]
    states = [a.init(init) for a in agents]
    worst, bad = 0.0, []
    for i, (agent, o_full) in enumerate(zip(agents, obs)):
        actor = agent.actor_net
        bias = actor.log_std_linear.bias
        saved = bias.detach().clone()
        for shift in (0.0, 25.0, -25.0):
            with torch.no_grad():
                bias.copy_(saved + shift)
            actor.bump_version()
            for nb in actor_rows(int(o_full.shape[0])):
                o = o_full[:nb]
                noise = torch.randn(nb, agent.action_dim, generator=gen,
                                    device=dev)
                with torch.no_grad():
                    ls = actor.dist(o)[1]
                at_clip = float(((ls == -20.0) | (ls == 2.0)).float().mean())
                for mode, nz in (("train", noise), ("eval", None)):
                    with torch.no_grad():
                        yk, same = _twice(lambda: K.sac_actor(actor, o, nz))
                        yp = K.sac_actor_plain(actor, o, nz)
                    err = float((yk - yp).abs().max())
                    worst = max(worst, err)
                    log("sac_actor", agent=i, batch=nb, mode=mode,
                        log_std_shift=shift, log_std_at_clip=at_clip,
                        dims=K.actor_dims(actor), max_abs_err=err,
                        rerun_bitwise=same)
                    if not (err <= 1e-5 and same
                            and torch.isfinite(yk).all()):
                        bad.append((i, nb, mode, shift, err, same))
        with torch.no_grad():
            bias.copy_(saved)
        actor.bump_version()

        o = obs[i][:4 * cfg.batch_size].contiguous()
        nb = int(o.shape[0])
        noise = torch.randn(nb, agent.action_dim, generator=gen, device=dev)
        g_a = torch.randn(nb, agent.action_dim, generator=gen, device=dev)
        g_l = torch.randn(nb, 1, generator=gen, device=dev)
        st = states[i]
        leaf_k = st.actor.detach().clone().requires_grad_(True)
        a_k, lp_k = agent.sample_f(agent.actor_layout.views(leaf_k), o, noise)
        yk = (a_k * g_a).sum() + (lp_k * g_l).sum()
        (gk,) = torch.autograd.grad(yk, leaf_k)
        leaf_p = st.actor.detach().clone().requires_grad_(True)
        views = {"actor." + n: t
                 for n, t in agent.actor_layout.views(leaf_p).items()}
        mean, log_std = functional_call(_Dist(actor), views, (o,))
        a_p, lp_p = sac_sample_plain(mean, log_std, noise)
        yp = (a_p * g_a).sum() + (lp_p * g_l).sum()
        (gp,) = torch.autograd.grad(yp, leaf_p)
        checks = {"action": _err(a_k.detach(), a_p.detach()),
                  "log_prob": _err(lp_k.detach(), lp_p.detach()),
                  "grad": _err(gk, gp)}
        log("sac_actor", agent=i, check="actor-loss sample under autograd vs "
            "structured", batch=nb, grad_scale=float(gp.abs().max()),
            max_abs_err={k: v[0] for k, v in checks.items()})
        bad += [(i, k, d) for k, (d, tol, fin) in checks.items()
                if not (d <= tol and fin)]
    if bad:
        raise AssertionError(f"sac_actor kernel disagrees with plain: {bad}")
    return agents, states, worst


def sac_head_shapes():
    """(label, H, act, dense) of every SAC head the train paths launch the
    fused head kernel on: the EMLP heads (their K5-folded ``W_eff`` (act,
    H)) of Mod-EMLP's agents 0 and 1 and Mono-EMLP, and the MLP heads
    (Dense kernels (H, act)) of Mod-MLP's agents and Mono-MLP; CTDE's
    actors are DTDE's."""
    from gym_rotor_tpu_torch.algos.sac import SACAgent
    from gym_rotor_tpu_torch.utils.config import Config
    out = []
    for fam, kw in (("mod_emlp", {}), ("mono_emlp", dict(framework="MONO")),
                    ("mod_mlp", dict(use_equiv=False)),
                    ("mono_mlp", dict(framework="MONO", use_equiv=False))):
        cfg = Config(rl_algo="SAC", **kw)
        for i in range(cfg.n_agents):
            lay = SACAgent(cfg, i, "cpu").actor_layout
            shapes = dict(zip(lay.names, lay.shapes))
            H, act = shapes["log_std_linear.kernel" if cfg.use_equiv
                            else "log_std.kernel"]
            out.append((f"{fam}_{i}", H, act, not cfg.use_equiv))
    return out


SAC_HEAD_CASES = ("moderate", "upper", "lower", "tie", "saturated")
# heads no train path launches at the default widths, for the kernel's
# run-time-H instances (other actor widths): (label, H, act, dense)
# and wider ones that stage h in chunks of 65 columns of [h | 1] (H 129: two
# chunks; 130: a third of the ones column alone; 256: four; 3000: 47, past
# 48 KB of shared memory)
SAC_HEAD_OTHER = (("other_8_3", 8, 3, False), ("other_40_2", 40, 2, True),
                  ("other_64_2", 64, 2, False), ("other_129_3", 129, 3, True),
                  ("other_130_1", 130, 1, True),
                  ("other_256_4", 256, 4, False),
                  ("other_3000_1", 3000, 1, True))


def sac_head_inputs(n, H, act, dense, case, gen, dev):
    """The fused head's inputs at ``n`` rows: h, the heads (W_m (H, act) if
    ``dense`` else (act, H)), the noise and the cotangents.  ``case``:
    moderate; ``upper`` / ``lower``: every log-std past its clip bound (the
    clamp's gradient 0); ``tie``: log-std column 0 exactly at the upper
    bound and column 1 at the lower (zero weights, the bound as the bias;
    the gradient passes); ``saturated``: the first quarter of the rows h =
    60 e_0 with the mean head's k = 0 weights +-1/2 and the log-std head's
    0 (|mean| >= 29, |action| 1)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    h = 0.8 * randn(n, H)
    wm = randn(*((H, act) if dense else (act, H))) / math.sqrt(H)
    bm = 0.1 * randn(act)
    wl = 0.5 * randn(H, act) / math.sqrt(H)
    bl = 0.3 * randn(act) - 1.0
    if case == "upper":
        bl = bl + 25.0
    elif case == "lower":
        bl = bl - 25.0
    elif case == "tie":
        wl[:, 0] = 0.0
        bl[0] = 2.0
        if act > 1:
            wl[:, 1] = 0.0
            bl[1] = -20.0
    elif case == "saturated":
        h[:n // 4] = 0.0
        h[:n // 4, 0] = 60.0
        w0 = torch.where(torch.rand(act, generator=gen, device=dev) < 0.5,
                         -0.5, 0.5)
        if dense:
            wm[0] = w0
        else:
            wm[:, 0] = w0
        wl[0] = 0.0
    noise = randn(n, act).clamp(-1.2, 1.2)
    return h, wm, bm, wl, bl, noise, randn(n, act), randn(n, 1)


def _k10_check(k, p, allowance):
    """(max |k - p|, worst ratio to the tolerance ``1e-5 max(1, max |p|)
    + allowance`` per element, finite)."""
    d = (k.double() - p.double()).abs()
    tol = 1e-5 * max(1.0, float(p.abs().max())) + allowance.double()
    return float(d.max()), float((d / tol).max()), bool(torch.isfinite(k).all())


def sac_head_check(h, wm, bm, wl, bl, noise, g_a, g_l, dense):
    """The fused head's forward and backward launches vs the plain sample
    on the kernel's own heads (``head_in_order``: the kernel's order of the
    dot products, so the sample's inputs are the same bits), each launch
    run twice and compared bitwise.  Tolerance per element (K10's):
    1e-5 max(1, max |plain|), plus, where the expression is ill-conditioned,
    8 ulp of its sensitivity: for the log-prob ``sum 1 / ((1 - a^2) +
    EPS)``, for ``g_mean`` and ``g_log_std`` the terms ``rounding_scales``
    names, carried into ``g_h`` through |W| (plus 4 ulp of the products'
    sizes for the order of its sums) and into the weight gradients ``M =
    [h | 1]^T G`` through ``|[h | 1]|`` (plus R ulp of the terms' sizes for
    the order of the sum over the rows).  ``G`` is written out for the
    check only; the launch without it (the training path's) must give
    the same ``g_h`` and ``M`` bits.  The twin's cuBLAS heads
    (the training path's plain chain) are held to the kernel's order within
    ``2 H`` ulp of the products' sizes (``head_scales``).  Returns (checks
    {name: (max abs err, worst tolerance ratio, finite)}, reruns bitwise,
    fraction of log-stds at a clip bound)."""
    from gym_rotor_tpu_torch.kernels import sac_sample as K
    from gym_rotor_tpu_torch.models.mlp import EPS, LOG_SIG_MAX, LOG_SIG_MIN
    args = (h, wm, bm, wl, bl, noise, dense)
    ak, lk = K.sac_head(*args)
    ak2, lk2 = K.sac_head(*args)
    ghk, Gk, M_k = K.sac_head_backward(g_a, g_l, *args, with_G=True)
    gh2, G2, M2 = K.sac_head_backward(g_a, g_l, *args, with_G=True)
    gh3, G3, M3 = K.sac_head_backward(g_a, g_l, *args)
    A, H = noise.shape[1], h.shape[1]
    m_o, pre_o = K.head_in_order(h, wm, bm, wl, bl, dense)
    ls_o = torch.clamp(pre_o, LOG_SIG_MIN, LOG_SIG_MAX)
    mask = ((pre_o >= LOG_SIG_MIN) & (pre_o <= LOG_SIG_MAX)).float()
    ap, lp = K.sac_sample_plain(m_o, ls_o, noise)
    gm_p, gs_p = K.sac_sample_backward_plain(g_a, g_l, m_o, ls_o, noise)
    gs_p = gs_p * mask
    sm, ss = K.rounding_scales(g_a, g_l, m_o, ls_o, noise)
    am, al = 8 * F32_EPS * sm, 8 * F32_EPS * ss * mask
    w_m = wm.t() if dense else wm                       # (act, H)
    gh_p = gm_p @ w_m + gs_p @ wl.t()
    a_gh = ((am @ w_m.abs() + al @ wl.abs().t())
            + 4 * F32_EPS * (gm_p.abs() @ w_m.abs() + gs_p.abs() @ wl.abs().t()))
    xa = torch.cat([h, torch.ones_like(h[:, :1])], dim=1).double()
    G_p = torch.cat([gm_p, gs_p], dim=1).double()
    M_p = xa.t() @ G_p
    a_M = (xa.abs().t() @ torch.cat([am, al], dim=1).double()
           + h.shape[0] * F32_EPS * (xa.abs().t() @ G_p.abs()))
    cond = (1.0 / ((1.0 - ap * ap) + EPS)).sum(-1, keepdim=True)
    twin_m, twin_pre = K.head_pre(h, wm, bm, wl, bl, dense)
    sc_m, sc_l = K.head_scales(h, wm, bm, wl, bl, dense)
    checks = {"action": _k10_check(ak, ap, 0 * ap),
              "log_prob": _k10_check(lk, lp, 8 * F32_EPS * cond),
              "g_mean": _k10_check(Gk[:, :A], gm_p, am),
              "g_log_std": _k10_check(Gk[:, A:], gs_p, al),
              "g_h": _k10_check(ghk, gh_p, a_gh),
              "g_weights": _k10_check(M_k, M_p, a_M),
              "twin_heads": _k10_check(
                  torch.cat([twin_m, twin_pre], 1), torch.cat([m_o, pre_o], 1),
                  2 * H * F32_EPS * torch.cat([sc_m, sc_l], 1))}
    same = (_bitwise([ak, lk, ghk, Gk, M_k], [ak2, lk2, gh2, G2, M2])
            and G3 is None and _bitwise([ghk, M_k], [gh3, M3]))
    at_clip = float(((ls_o == LOG_SIG_MIN) | (ls_o == LOG_SIG_MAX))
                    .float().mean())
    return checks, same, at_clip


def phase_sac_sample(dev):
    """K10 fused with SAC's heads (``kernels/sac_sample.py``), forward and
    backward, vs plain at the SAC update's 256 (target sample) and 1024
    (actor loss) rows and CTDE's 1280, at every head shape of the train
    paths (``sac_head_shapes``) and at ``SAC_HEAD_OTHER``'s (the
    run-time-H instances), in each of ``SAC_HEAD_CASES``
    (``sac_head_check``); saturated rows must give ``|a| = 1`` exactly.
    Then one CUDA kernel a call (profiler trace) forward and backward, and
    the kernels of SAC's actor-loss sample's backward under autograd
    (logged)."""
    from gym_rotor_tpu_torch.kernels import sac_sample as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst, bad = {"forward": 0.0, "backward": 0.0}, []
    for label, H, act, dense in sac_head_shapes() + list(SAC_HEAD_OTHER):
        for n in (256, 1024, 1280):
            for case in SAC_HEAD_CASES:
                inp = sac_head_inputs(n, H, act, dense, case, gen, dev)
                checks, same, at_clip = sac_head_check(*inp[:6], inp[6],
                                                       inp[7], dense)
                ak = K.sac_head(*inp[:6], dense)[0]
                saturated = case != "saturated" or bool(
                    (ak[:n // 4].abs() == 1.0).all())
                log("sac_sample", head=label, H=H, act=act, dense=dense,
                    rows=n, case=case, log_std_at_clip=at_clip,
                    saturated_rows_at_1=saturated, rerun_bitwise=same,
                    max_abs_err={k: v[0] for k, v in checks.items()},
                    worst_tolerance_ratio={k: v[1] for k, v in checks.items()})
                for k, (d, ratio, fin) in checks.items():
                    side = ("forward" if k in ("action", "log_prob",
                                               "twin_heads") else "backward")
                    worst[side] = max(worst[side], d)
                    if not (ratio <= 1.0 and fin):
                        bad.append((label, n, case, k, d, ratio))
                if not (saturated and same):
                    bad.append((label, n, case, "saturated/rerun", saturated,
                                same))
        h, wm, bm, wl, bl, noise, g_a, g_l = sac_head_inputs(
            1024, H, act, dense, "moderate", gen, dev)
        leaves = [t.clone().requires_grad_(True) for t in (h, wm, bm, wl, bl)]
        per_call = dict(
            forward=launches_per_call(
                lambda: K.sac_head(h, wm, bm, wl, bl, noise, dense)),
            backward=launches_per_call(
                lambda: K.sac_head_backward(g_a, g_l, h, wm, bm, wl, bl,
                                            noise, dense)))
        a, lp = K.sac_head_sample(*leaves, noise, dense)
        per_call["autograd_backward"] = launches_per_call(
            lambda: torch.autograd.grad((a, lp), leaves, (g_a, g_l),
                                        retain_graph=True))
        log("sac_sample", head=label, rows=1024, kernels_a_call=per_call)
        if per_call["forward"] != 1 or per_call["backward"] != 1:
            bad.append((label, "kernels a call", per_call))
    if bad:
        raise AssertionError(f"sac_sample kernel disagrees with plain: "
                             f"{bad[:8]}")
    return worst


def expected_launches(cfg, warm: bool, gated: bool):
    """Kernel launches of one TD3 superstep (rollout_len 1, one update).
    MLP networks launch no kernel of their own (``F.linear``) and carry no
    spectral penalty: K1, K2 and K6 only."""
    if warm:
        return {"env_tick": 1, "replay_insert_tick": 1}
    n = cfg.n_agents
    want = {"env_tick": 1, "replay_insert_tick": 1, "replay_sample": 1,
            "flat_adamw": n * (2 if gated else 1)}
    if not cfg.use_equiv:
        return want
    # per agent: target actor (2 blocks) + target twin critic (4) + critic
    # loss (4) forward, its backward (4); the actor loss adds the actor at
    # B = 768 (2) and critic net1 (2) forward and both backward (2 + 2).
    # Under CTDE (MATD3) every agent's target actor runs in the target (2 n
    # blocks) and the other agents' current actors in the actor loss
    # (2 (n - 1)).
    others = n - 1 if cfg.is_ctde else 0
    fwd = 10 + 2 * others + (4 + 2 * others if gated else 0)
    want.update({"emlp_actor": n, "emlp_block": n * fwd,
                 "emlp_block_backward": n * (8 if gated else 4),
                 "spectral_iterate": n * (2 if gated else 1)})
    return want


def _dims(net, dev):
    """The (nin, ng, nh) of ``net``'s blocks (an EMLP or an actor)."""
    from gym_rotor_tpu_torch.kernels.emlp_block import block_spec
    return [block_spec(b, dev).dims for _, b in net.named_blocks()]


def expected_td3_shapes(cfg, agents, dev, gated: bool):
    """K3's launches per (block dims, rows, saves lin/pre) and K4's per
    (block dims, rows, parameter sums) of one TD3 train superstep of EMLP
    agents, as ``expected_launches`` counts them; K3 saves lin and pre
    only where autograd records the call (not in the target)."""
    nb = cfg.batch_size
    fwd, bwd = Counter(), Counter()
    actors = [_dims(a.actor_net.network, dev) for a in agents]
    for i, a in enumerate(agents):
        net1 = _dims(a.critic_net.network1, dev)
        net2 = _dims(a.critic_net.network2, dev)
        others = [j for j in range(len(agents)) if j != i] \
            if cfg.is_ctde else []
        for j in [i] + others:
            for d in actors[j]:
                fwd[(d, nb, False)] += 1       # target actors on next_obs
        if gated:
            for d in actors[i]:
                fwd[(d, 3 * nb, True)] += 1    # actor loss, [obs; next; obs+eps]
                bwd[(d, 3 * nb, True)] += 1
            for j in others:                   # current actors of the others
                for d in actors[j]:
                    fwd[(d, nb, False)] += 1
        for d in net1 + net2:
            fwd[(d, nb, False)] += 1           # target twin
            fwd[(d, nb, True)] += 1            # critic loss
            bwd[(d, nb, True)] += 1
        if gated:
            for d in net1:                     # q1 in the actor loss
                fwd[(d, nb, True)] += 1
                bwd[(d, nb, False)] += 1
    return fwd, bwd


def _stack_dims(layout):
    """``(K, mo, mi)`` of the padded weight stack K7 iterates for a
    network's flat layout."""
    from gym_rotor_tpu_torch.models.emlp.nn import spectral_weights
    ws, _ = spectral_weights({n: torch.empty(s, device="meta") for n, s
                              in zip(layout.names, layout.shapes)})
    return (len(ws), max(int(w.shape[0]) for w in ws),
            max(int(w.shape[1]) for w in ws))


# the instances' wrappers and the run-time-width wrappers that take the
# shapes without an instance
ANY_WRAPPERS = {"emlp_block": "emlp_block_any",
                "emlp_block_backward": "emlp_block_backward_any",
                "emlp_actor": "emlp_actor_any", "sac_actor": "sac_actor_any",
                "ppo_actor": "ppo_actor_any",
                "spectral_iterate": "spectral_iterate_any",
                "mlp_ppo_actor": "mlp_ppo_actor_any"}


def route_widths(want, agents, dev, fwd=(), bwd=(), k7=(0, 0)):
    """``want`` (one superstep's launches by wrapper, as the instances'
    wrappers would count them at any width) with the launches of shapes
    without an instance moved to the run-time-width wrappers: K3/K4 by the
    dims of ``fwd``/``bwd`` (per (dims, rows, flag)); the acting kernels
    and the MLP PPO actor per agent by its actor's dims (``want``'s count
    an equal share per agent); K7 per agent by its networks' padded stacks,
    ``k7`` = (the critic's, the actor's launches an agent).  At the default
    widths nothing moves."""
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.kernels import emlp_block as KB
    from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as KM
    from gym_rotor_tpu_torch.kernels import spectral as KS
    out = dict(want)

    def move(name, n):
        if n:
            out[name] -= n
            out[ANY_WRAPPERS[name]] = out.get(ANY_WRAPPERS[name], 0) + n
            if not out[name]:
                del out[name]

    move("emlp_block", sum(c for (d, *_), c in Counter(fwd).items()
                           if d not in KB.INSTANCES))
    move("emlp_block_backward", sum(c for (d, *_), c in Counter(bwd).items()
                                    if d not in KB.INSTANCES))
    heads = {"emlp_actor": KA.HEAD_TANH, "sac_actor": KA.HEAD_GAUSS,
             "ppo_actor": KA.HEAD_PPO}
    for name in ("emlp_actor", "sac_actor", "ppo_actor", "mlp_ppo_actor"):
        if name not in want:
            continue
        share = want[name] // len(agents)
        for a in agents:
            inst = (KM.actor_dims(a.actor_net) in KM.INSTANCES
                    if name == "mlp_ppo_actor" else
                    KA.actor_dims(a.actor_net) in KA.INSTANCES[heads[name]])
            if not inst:
                move(name, share)
    if "spectral_iterate" in want:
        for a in agents:
            for layout, n in zip((a.critic_layout, a.actor_layout), k7):
                if KS.instance(*_stack_dims(layout)[1:]) is None:
                    move("spectral_iterate", n)
    return out


def block_shape_counts(widths: bool = False):
    """K3's and K4's launches so far per (dims, rows, flag): the
    instances' (what the default widths must take), with ``widths`` the
    run-time path's added."""
    from gym_rotor_tpu_torch.kernels import emlp_block as KB
    fwd, bwd = (Counter(KB.emlp_block.by_shape),
                Counter(KB.emlp_block_backward.by_shape))
    if widths:
        fwd += Counter(KB.emlp_block_any.by_shape)
        bwd += Counter(KB.emlp_block_backward_any.by_shape)
    return fwd, bwd


def check_no_any(launches, name):
    """A default-width run launched no run-time-width wrapper: the fixed
    instances took every shape."""
    ran = {w: launches[w] for w in ANY_WRAPPERS.values() if launches.get(w)}
    if ran:
        raise AssertionError(f"{name}: the run-time-width path ran at the "
                             f"default widths: {ran}")


def clear_block_shape_counts():
    from gym_rotor_tpu_torch.kernels import emlp_block as KB
    for w in (KB.emlp_block, KB.emlp_block_any, KB.emlp_block_backward,
              KB.emlp_block_backward_any):
        w.by_shape.clear()


def expected_launches_sac(cfg, warm: bool):
    """Kernel launches of one SAC superstep (rollout_len 1, one update):
    the same on every train superstep, since the actor steps on every
    update and the critic target's Polyak rides in the critic's K6."""
    if warm:
        return {"env_tick": 1, "replay_insert_tick": 1}
    n = cfg.n_agents
    others = n - 1 if cfg.is_ctde else 0
    # per agent: the target sample (actor 2 blocks, the fused head K10) and
    # the twin target critic (4); the critic loss (4) and its backward (4);
    # the actor loss over 4 x 256 rows (2 blocks, K10), q1 and q2 on its
    # action (4), backward through both critics without the parameter sums
    # (4), K10's backward and the actor's blocks (2).  Under CTDE the
    # agent's own samples fuse along the batch (2 x 256 rows in the target,
    # 5 x 256 in the actor loss) and every other agent's actor samples on
    # its own obs in both (2 blocks and K10 each).  MLP networks: K10 only,
    # and the fused MLP SAC actor acting, no blocks and no K7.
    want = {"env_tick": 1, "replay_insert_tick": 1, "replay_sample": 1,
            "sac_head": 2 * n * (1 + others), "sac_head_backward": n,
            "flat_adamw": 2 * n}
    if not cfg.use_equiv:
        want["mlp_sac_actor"] = n              # acting: one fused launch
        return want
    want.update({"sac_actor": n, "emlp_block": n * (16 + 4 * others),
                 "emlp_block_backward": 10 * n, "spectral_iterate": 2 * n})
    return want


def expected_sac_shapes(cfg, agents, dev):
    """K3's launches per (block dims, rows, saves lin/pre) and K4's per
    (block dims, rows, parameter sums) of one SAC train superstep of EMLP
    agents."""
    nb = cfg.batch_size
    fwd, bwd = Counter(), Counter()
    ctde = cfg.is_ctde
    actors = [_dims(a.actor_net, dev) for a in agents]
    for i, a in enumerate(agents):
        for d in actors[i]:
            fwd[(d, 2 * nb if ctde else nb, False)] += 1  # target sample(s)
            fwd[(d, (5 if ctde else 4) * nb, True)] += 1  # actor loss
            bwd[(d, (5 if ctde else 4) * nb, True)] += 1
        for j in range(len(agents)) if ctde else []:
            if j != i:
                for d in actors[j]:
                    fwd[(d, nb, False)] += 2          # target and actor loss
        for net in (a.critic_net.network1, a.critic_net.network2):
            for d in _dims(net, dev):
                fwd[(d, nb, False)] += 1          # target twin
                fwd[(d, nb, True)] += 2    # critic loss, actor loss
                bwd[(d, nb, True)] += 1
                bwd[(d, nb, False)] += 1
    return fwd, bwd


class K5Calls:
    """Counts the calls of K5 (``project_linear``, plain torch: a handful
    of small torch ops each) by layer reps while installed, in both modules
    that call it."""

    def __init__(self):
        from gym_rotor_tpu_torch.kernels import emlp_block
        from gym_rotor_tpu_torch.models.emlp import nn
        self.mods, self.orig = (nn, emlp_block), nn.project_linear
        self.calls, self.reps = Counter(), {}

    def __enter__(self):
        def counted(rep_in, rep_out, kernel, bias):
            key = (hash(rep_in), hash(rep_out))
            self.calls[key] += 1
            self.reps[key] = (rep_in, rep_out)
            return self.orig(rep_in, rep_out, kernel, bias)
        for m in self.mods:
            m.project_linear = counted
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.project_linear = self.orig


def phase_train_sac(dev, steps, auto, k5=None, cfg=None, name="sac_train",
                    widths=False):
    """The SAC training entry point at full width (``cfg``: Mod-EMLP DTDE
    by default): 1 warm superstep, then ``steps`` train supersteps, each
    checked as it ends: exact launch counts (EMLP: of K3/K4 per shape and
    rows too), one fold per EMLP actor (its K6 step makes the next act
    refold), finite losses, the actor and critic moving on every update,
    the critic target only on gated ones, ``log_alpha`` only with
    ``auto``.  ``widths`` (phase 26 only): shapes without an instance are
    expected on the run-time-width wrappers (``route_widths``); otherwise
    none may run there.  Returns the launch counts, K3/K4's counts per
    shape over the run and the run."""
    from gym_rotor_tpu_torch.kernels.emlp_actor import fold_actor
    from gym_rotor_tpu_torch.train import train
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = (cfg or Config(num_envs=B, start_timesteps=B, rl_algo="SAC")
           ).replace(automatic_entropy_tuning=auto)
    equiv = cfg.use_equiv
    wr = _wrappers()
    probe = dict(last={}, folds=0, bad=[], prev=None, first=None, events=[],
                 losses=[], alpha=[], t_host=None, fwd=Counter(),
                 bwd=Counter())

    def snap(run):
        return [(st.actor.clone(), st.critic.clone(),
                 st.critic_target.clone(), st.log_alpha.clone())
                for st in run["states"]]

    def on_superstep(i, warm, metrics, run):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        probe["events"].append(ev)
        now = {k: w.launches for k, w in wr.items()}
        delta = {k: v - probe["last"].get(k, 0) for k, v in now.items()}
        probe["last"] = now
        wfwd, wbwd = (expected_sac_shapes(cfg, run["agents"], dev)
                      if equiv and not warm else (Counter(), Counter()))
        want = expected_launches_sac(cfg, warm)
        if widths:
            want = route_widths(want, run["agents"], dev, wfwd, wbwd, (1, 1))
        if i == 0:
            want["env_tick"] += 1           # train()'s batched reset
        got = {k: v for k, v in delta.items() if v}
        if got != want:
            probe["bad"].append((i, "launches", got, want))
        fwd, bwd = block_shape_counts(widths)
        gfwd, gbwd = fwd - probe["fwd"], bwd - probe["bwd"]
        probe["fwd"], probe["bwd"] = fwd, bwd
        if gfwd != wfwd or gbwd != wbwd:
            probe["bad"].append((i, "shapes", dict(gfwd), dict(wfwd)))
        folds = fold_actor.folds - probe["folds"]
        probe["folds"] = fold_actor.folds
        stale = [a.actor_net._folded[0] != a.actor_net.param_version
                 for a in run["agents"]] if not warm and equiv else []
        if folds != (0 if warm or not equiv else cfg.n_agents) \
                or not all(stale):
            probe["bad"].append((i, "folds", folds, stale))
        cur = snap(run)
        if warm:
            probe["first"] = cur
            probe["t_host"] = time.perf_counter()
        else:
            gated = i % cfg.policy_update_freq == 0
            for j, (p, c) in enumerate(zip(probe["prev"], cur)):
                moved = [not torch.equal(x, y) for x, y in zip(p, c)]
                if moved != [True, True, gated, auto]:
                    probe["bad"].append((i, "moved", j, moved))
            losses = [float(v) for k, v in metrics.items() if "loss" in k]
            probe["losses"].append(losses)
            probe["alpha"].append([float(metrics[f"agent{j}/alpha"])
                                   for j in range(cfg.n_agents)])
            if not all(math.isfinite(x) for x in losses) or \
                    not math.isfinite(float(metrics["mean_reward"])):
                probe["bad"].append((i, "non-finite", losses))
        probe["prev"] = cur

    torch.cuda.synchronize()
    for w in wr.values():
        w.launches = 0
    probe["folds"] = fold_actor.folds
    clear_block_shape_counts()
    with (k5 or contextlib.nullcontext()):
        run = train(cfg, 1 + steps, device=dev, on_superstep=on_superstep,
                    log=None)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wr.items()}
    shapes = block_shape_counts(widths)
    host_s = time.perf_counter() - probe["t_host"]
    dev_ms = probe["events"][0].elapsed_time(probe["events"][-1])
    agents, states, rs = run["agents"], run["states"], run["replay"]
    changed = []
    twins = ("network1.", "network2.") if equiv else ("q1_", "q2_")
    for a, st, (a0, c0, t0, _) in zip(agents, states, probe["first"]):
        now, was = (a.critic_layout.views(st.critic),
                    a.critic_layout.views(c0))
        nets = [bool((st.actor != a0).any())]
        nets += [any(bool((now[n] != was[n]).any()) for n in now
                     if n.startswith(pre)) for pre in twins]
        nets.append(bool((st.critic_target != t0).any()))
        changed.append(nets)
    total_it = [st.total_it for st in states]
    log(name, framework=cfg.framework, module_training=cfg.module_training,
        use_equiv=equiv, envs=B, supersteps=1 + steps, warm_supersteps=1,
        automatic_entropy_tuning=auto, launches=launches, total_it=total_it,
        changed_actor_net1_net2_target=changed, train_ms=dev_ms,
        env_steps_per_s=B * steps / (dev_ms / 1e3),
        updates_per_s=steps / (dev_ms / 1e3), ms_per_superstep=dev_ms / steps,
        host_s=host_s, losses_first=probe["losses"][0],
        losses_last=probe["losses"][-1], alpha_first=probe["alpha"][0],
        alpha_last=probe["alpha"][-1], fill=rs.filled,
        episodes_logged=len(run["episodes"]), mismatches=probe["bad"][:5])
    if not widths:
        check_no_any(launches, name)
    if probe["bad"]:
        raise AssertionError(f"{name} path: {probe['bad'][:5]}")
    if total_it != [steps] * cfg.n_agents or not all(map(all, changed)):
        raise AssertionError(f"{name} path did not update: {total_it} "
                             f"{changed}")
    return launches, shapes, run


def phase_train(dev, cfg=None, steps=TRAIN_STEPS, k5=None, name="train",
                widths=False):
    """The TD3 training entry point at full width (``cfg``: the flagship
    Mod-EMLP by default): 1 warm superstep, then ``steps`` train
    supersteps, each checked as it ends: exact launch counts of every
    kernel and (EMLP) of K3/K4 per (shape, rows), the actors' folds (EMLP),
    finite losses; at the end, every network moved.  ``widths`` as
    ``phase_train_sac``'s.  Returns the launch counts, K3/K4's counts per
    shape over the run and the run."""
    from gym_rotor_tpu_torch.kernels.emlp_actor import fold_actor
    from gym_rotor_tpu_torch.train import train
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = cfg or Config(num_envs=B, start_timesteps=B)
    equiv = cfg.use_equiv
    wr = _wrappers()
    probe = dict(last={}, folds=0, bad=[], before=None, events=[],
                 losses=[], t_host=None, fwd=Counter(), bwd=Counter())

    def on_superstep(i, warm, metrics, run):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        probe["events"].append(ev)
        now = {k: w.launches for k, w in wr.items()}
        delta = {k: v - probe["last"].get(k, 0) for k, v in now.items()}
        probe["last"] = now
        n_train = i               # train supersteps so far (one warm first)
        gated = not warm and n_train % cfg.policy_update_freq == 0
        wfwd, wbwd = (expected_td3_shapes(cfg, run["agents"], dev, gated)
                      if equiv and not warm else (Counter(), Counter()))
        want = expected_launches(cfg, warm, gated)
        if widths:
            want = route_widths(want, run["agents"], dev, wfwd, wbwd,
                                (1, 1 if gated else 0))
        if i == 0:
            want["env_tick"] += 1           # train()'s batched reset
        got = {k: v for k, v in delta.items() if v}
        if got != want:
            probe["bad"].append((i, "launches", got, want))
        fwd, bwd = block_shape_counts(widths)
        gfwd, gbwd = fwd - probe["fwd"], bwd - probe["bwd"]
        probe["fwd"], probe["bwd"] = fwd, bwd
        if gfwd != wfwd or gbwd != wbwd:
            probe["bad"].append((i, "shapes", dict(gfwd), dict(wfwd)))
        folds = fold_actor.folds - probe["folds"]
        probe["folds"] = fold_actor.folds
        # the EMLP actors fold on the first train superstep and after each
        # actor update (K6 bumps the version; the next act refolds)
        want_folds = 0 if warm or not equiv else (
            cfg.n_agents if n_train == 1 or
            (n_train - 1) % cfg.policy_update_freq == 0 else 0)
        fresh = [getattr(a.actor_net, "_folded", (None,))[0]
                 == a.actor_net.param_version
                 for a in run["agents"]] if not warm and equiv else []
        if folds != want_folds or any(f == gated for f in fresh):
            probe["bad"].append((i, "folds", folds, want_folds, fresh))
        if warm:
            probe["before"] = [(st.actor.clone(), st.critic.clone())
                               for st in run["states"]]
            probe["t_host"] = time.perf_counter()
        else:
            losses = [float(v) for k, v in metrics.items() if "loss" in k]
            probe["losses"].append(losses)
            if not all(math.isfinite(x) for x in losses) or \
                    not math.isfinite(float(metrics["mean_reward"])):
                probe["bad"].append((i, "non-finite", losses))

    torch.cuda.synchronize()
    for w in wr.values():
        w.launches = 0
    probe["folds"] = fold_actor.folds
    clear_block_shape_counts()
    with (k5 or contextlib.nullcontext()):
        run = train(cfg, 1 + steps, device=dev,
                    on_superstep=on_superstep, log=None)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wr.items()}
    shapes = block_shape_counts(widths)
    host_s = time.perf_counter() - probe["t_host"]
    dev_ms = probe["events"][0].elapsed_time(probe["events"][-1])
    changed = [(bool((st.actor != a0).any()), bool((st.critic != c0).any()))
               for st, (a0, c0) in zip(run["states"], probe["before"])]
    total_it = [st.total_it for st in run["states"]]
    first, last = probe["losses"][0], probe["losses"][-1]
    log(name, framework=cfg.framework, module_training=cfg.module_training,
        use_equiv=equiv, envs=B, supersteps=1 + steps, warm_supersteps=1,
        launches={k: v for k, v in launches.items() if v}, total_it=total_it,
        params_changed=changed, ring_row=int(run["replay"].data.shape[1]),
        train_ms=dev_ms, env_steps_per_s=B * steps / (dev_ms / 1e3),
        updates_per_s=steps / (dev_ms / 1e3),
        ms_per_superstep=dev_ms / steps, host_s=host_s,
        losses_first=first, losses_last=last,
        fill=run["replay"].filled, episodes_logged=len(run["episodes"]),
        mismatches=probe["bad"][:5])
    if not widths:
        check_no_any(launches, name)
    if probe["bad"]:
        raise AssertionError(f"{name} path: {probe['bad'][:5]}")
    if total_it != [steps] * cfg.n_agents or not all(a and c for a, c in changed):
        raise AssertionError(f"{name} path did not update: {total_it} {changed}")
    return launches, shapes, run


def tick_timing(cfg, dev, tick, kernel="env_tick"):
    """K1 at the envs of ``tick``'s state, actions and draws (a compare
    phase's last tick, ~10% of envs reset, or a rollout's last state) for
    ``cfg``'s instance: device time per launch, the plain twin's, and the
    bound: the state read and written once, actions, draws and outputs;
    the flops of the plain twin's step per env plus its fresh episode per
    reset env (counted on the CPU), less, under exact_so3, the 6-step polar
    repair of every read that passes ``is_rotation`` (the kernel runs it
    only where a read fails)."""
    from gym_rotor_tpu_torch.envs import batch as batch_lib
    from gym_rotor_tpu_torch.envs import draws as D
    from gym_rotor_tpu_torch.kernels import env_tick as KT
    from gym_rotor_tpu_torch.ops import so3
    st, a, dr = tick["state"], tick["actions"], tick["draws"]
    task, n = KT.task_of(cfg), a.shape[0]
    in_bufs, out_bufs = KT.pack_state(st), KT.empty_bufs(n, dev)
    k_ms, k_wall = device_ms(
        lambda: KT.env_tick_bufs(cfg, in_bufs, a, dr, "train", out_bufs), 50)
    p_ms, p_wall = device_ms(lambda: KT.env_tick_plain(cfg, st, a, dr), 5, 3)
    st_p, out_p = KT.env_tick_plain(cfg, st, a, dr)
    n_reset = int(out_p.reset_happened.sum())
    nbytes = sum(t.numel() * t.element_size() for t in in_bufs) * 2
    nbytes += a.numel() * 4 + dr.numel() * 4
    nbytes += n * (KT.out_width(task, "F") * 4 + KT.out_width(task, "B"))
    cpu_cfg = cfg.replace(num_envs=1)
    st1, _ = batch_lib.batched_reset_plain(cpu_cfg, torch.rand(1, D.N_DRAWS))
    a1, d1 = torch.zeros(1, a.shape[1]), torch.rand(1, D.N_DRAWS)
    dense = count_flops(batch_lib.batched_step_plain, cpu_cfg, st1, a1, d1)
    fresh = count_flops(batch_lib._fresh, cpu_cfg, d1, "train")
    flops = n * (dense - fresh) + n_reset * fresh
    passed = 0
    if cfg.exact_so3:
        # reads: the stored R (the work attitude) and the stepped R of every
        # env (a reset env's stepped R counted as passing); the reset pose
        # twice per fresh episode (always a rotation)
        polar6 = count_flops(so3.polar_fast, torch.eye(3)[None], 6)
        R_n = torch.where(out_p.reset_happened[:, None, None],
                          torch.eye(3, device=dev), st_p.env.R)
        passed = (int(so3.is_rotation(st.env.R).sum())
                  + int(so3.is_rotation(R_n).sum()) + 2 * n_reset)
        flops -= passed * polar6
    bms, by = bound_ms(nbytes, flops)
    log("kernels", kernel=kernel, task=task, mode=cfg.train_traj_mode,
        batch=n, resets_in_timed_tick=n_reset, reads_passed=passed, ms=k_ms,
        wall_ms_per_call=k_wall, plain_ms=p_ms, plain_wall_ms=p_wall,
        bytes=nbytes, flops_step_per_env=dense - fresh,
        flops_fresh_per_env=fresh, flops=flops, bound_ms=bms, bound_by=by,
        library_ms=None)
    return k_ms, p_ms, bms, by


def actor_work(folded, nb, kind, train):
    """(bytes, flops) of one acting launch at ``nb`` rows: per row each
    block's linear layer (multiply-add + bias), three flops per nonzero of
    its quadratic form, 0.1 q + lin, the gate (negate, exp, add, divide);
    then the head: the mean Dense and tanh; K9's log_std Dense, clip, exp,
    the sample (train); K11's draw, clip, z and log-prob (train) or clip
    (eval).  Bytes: obs, the draws, the outputs and the folded image, each
    once."""
    nin, ng, nh, nact = folded["dims"]
    per_row = sum(2 * ng * ni + ng + 3 * nnz + 2 * ng + 4 * nh
                  for ni, nnz in zip((nin, nh), folded["nnz"]))
    per_row += 2 * nh * nact + 2 * nact
    reads, outs = (1 if train else 0), 1
    if kind == "gauss" and train:
        per_row += 2 * nh * nact + 6 * nact
    elif kind == "ppo":
        per_row += 11 * nact if train else 2 * nact
        outs = 2
    elif kind == "tanh":
        reads = 0
    nbytes = (nb * nin + (reads + outs) * nb * nact
              + folded["image"].numel()) * 4
    return nbytes, nb * per_row


ACTOR_KERNELS = {"tanh": "emlp_actor", "gauss": "sac_actor",
                 "ppo": "ppo_actor"}


def actor_timing(actor, o, agent, kind="tanh", noise=None, path=None):
    """The acting kernel with ``kind``'s head (K3-actor, K9, K11) at
    ``o``'s rows, with the draws ``noise`` (train) or without (eval):
    device time per launch, the plain twin's, and the bound; logged with
    the instance (``scripts/actor_spectral_vs_parent.py`` reads it)."""
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    name = ACTOR_KERNELS[kind]
    fn, plain = getattr(KA, name), getattr(KA, f"{name}_plain")
    args = (actor, o) if kind == "tanh" else (actor, o, noise)
    with torch.no_grad():
        k_ms, k_wall = device_ms(lambda: fn(*args), 100)
        p_ms, p_wall = device_ms(lambda: plain(*args), 10, 3)
    folded = KA.fold_actor(actor)
    nb = int(o.shape[0])
    nbytes, flops = actor_work(folded, nb, kind, noise is not None)
    bms, by = bound_ms(nbytes, flops)
    log("kernels", kernel=name, path=path, agent=agent,
        dims=list(folded["dims"]), head=kind,
        mode=None if kind == "tanh" else "eval" if noise is None else "train",
        bilinear_nonzeros=list(folded["nnz"]), batch=nb, ms=k_ms,
        wall_ms_per_call=k_wall, plain_ms=p_ms, plain_wall_ms=p_wall,
        bytes=nbytes, flops=flops, bound_ms=bms, bound_by=by,
        library_ms=None)
    return k_ms, p_ms, bms, by


def phase_kernels(cfg, dev, tick, actors, obs, launches, emlp_err):
    from gym_rotor_tpu_torch.utils.tree import tree_map
    records = []
    # K1 at B = 4096 on the compare-phase state (~10% of envs reset), and
    # at PPO A's 32 envs on its first 32
    k_ms, p_ms, bms, by = tick_timing(cfg, dev, tick)
    n = PPO_A_ENVS
    small = dict(state=tree_map(lambda t: t[:n].clone(), tick["state"]),
                 actions=tick["actions"][:n].clone(),
                 draws=tick["draws"][:n].clone())
    k32, p32, b32, by32 = tick_timing(cfg.replace(num_envs=n), dev, small)
    records.append(dict(
        name="env_tick", route="cuda",
        source="gym_rotor_tpu_torch/kernels/csrc/env_tick.cu",
        replaces="gym_rotor_tpu/envs/batch.py:75", launches=launches["env_tick"],
        max_abs_err=tick["max_abs_err"], ms=k_ms, plain_ms=p_ms, bound_ms=bms,
        bound_by=by, library_ms=None, ms_32=k32, plain_ms_32=p32,
        bound_ms_32=b32, bound_by_32=by32))

    # K3 at B = 4096, both agents (each launched once per tick); at the eval
    # path's 10 rows too (logged, not in the record)
    per = [actor_timing(actor, o, i, path="td3")
           for i, (actor, o) in enumerate(zip(actors, obs))]
    for i, (actor, o) in enumerate(zip(actors, obs)):
        actor_timing(actor, o[:cfg.num_eval], i, path="eval")
    # one record per kernel: the two instances are launched equally often,
    # so per-launch times are their mean
    records.append(dict(
        name="emlp_actor", route="cuda",
        source="gym_rotor_tpu_torch/kernels/csrc/emlp_actor.cu",
        replaces="gym_rotor_tpu/models/emlp/nn.py:431",
        launches=launches["emlp_actor"], max_abs_err=emlp_err,
        ms=statistics.mean(p[0] for p in per),
        plain_ms=statistics.mean(p[1] for p in per),
        bound_ms=statistics.mean(p[2] for p in per),
        bound_by="operations" if all(p[3] == "operations" for p in per) else per[0][3],
        library_ms=None))
    return records


def _record(name, source, replaces, launches, err, inst):
    """One kernel record from its instances ``(weight, ms, plain_ms,
    bound_ms, bound_by, library_ms)``, weighted by launches on the train
    path."""
    tot = sum(r[0] for r in inst)

    def mean(j):
        return sum(r[0] * r[j] for r in inst) / tot
    lib = None if inst[0][5] is None else mean(5)
    # what bounds the instances that carry most of the bound
    by = max(("bytes", "operations"),
             key=lambda b: sum(r[0] * r[3] for r in inst if r[4] == b))
    return dict(name=name, route="cuda",
                source=f"gym_rotor_tpu_torch/kernels/csrc/{source}",
                replaces=replaces, launches=launches, max_abs_err=err,
                ms=mean(1), plain_ms=mean(2), bound_ms=mean(3), bound_by=by,
                library_ms=lib)


def block_instances(dev, shapes, gen, path="td3"):
    """K3 and K4 at every instance of a path's run (``shapes``: K3's
    launches per (block, rows, saves lin/pre) and K4's per (block, rows,
    parameter sums), as the wrappers counted them): per instance the
    launches, device time, plain time (in chunks of 32 768 rows past
    that), bound and what bounds it.  K3 is timed as the path launched it:
    a forward that saved no lin and pre (autograd recorded nothing) without
    them, and its bound then leaves their bytes out."""
    from gym_rotor_tpu_torch.kernels import emlp_block as KB
    specs = {s.dims: s for s in KB._SPECS.values() if s.ints.device == dev}
    fwd, bwd = [], []
    for key, count in sorted(shapes[0].items()):
        (nin, ng, nh), nb, save = key
        spec = specs[(nin, ng, nh)]
        x = torch.randn(nb, nin, generator=gen, device=dev)
        W = 0.3 * torch.randn(ng, nin, generator=gen, device=dev)
        b = 0.1 * torch.randn(ng, generator=gen, device=dev)
        v = 0.3 * torch.randn(spec.nnz, generator=gen, device=dev)
        big = nb > 32768       # a horizon's V forward: plain in chunks
        k_ms, _ = device_ms(lambda: KB.emlp_block(spec, x, W, b, v, save),
                            3 if big else 50, 3 if big else 5)
        chunks = torch.split(x, 32768)
        p_ms, _ = device_ms(lambda: [KB.emlp_block_plain(spec, c, W, b, v)
                                     for c in chunks],
                            2 if big else 10, 2 if big else 3)
        flops = nb * (2 * ng * nin + ng + 3 * spec.nnz + 2 * ng + 4 * nh)
        nbytes = 4 * (nb * nin + ng * nin + ng + spec.nnz + nb * nh
                      + (2 * ng * nb if save else 0) + nh + ng + 1
                      + spec.nnz)
        bms, by = bound_ms(nbytes, flops)
        fwd.append((count, k_ms, p_ms, bms, by, None))
        log("kernels", kernel="emlp_block", path=path, dims=[nin, ng, nh],
            batch=nb, saves_lin_pre=save, nnz=spec.nnz, launches=count,
            ms=k_ms, plain_ms=p_ms, flops=flops,
            bytes=nbytes, bound_ms=bms, bound_by=by, library_ms=None)
    for key, count in sorted(shapes[1].items()):
        (nin, ng, nh), nb, need = key
        spec = specs[(nin, ng, nh)]
        x = torch.randn(nb, nin, generator=gen, device=dev)
        W = 0.3 * torch.randn(ng, nin, generator=gen, device=dev)
        b = 0.1 * torch.randn(ng, generator=gen, device=dev)
        v = 0.3 * torch.randn(spec.nnz, generator=gen, device=dev)
        _, lin, pre = KB.emlp_block(spec, x, W, b, v)
        g_h = torch.randn(nb, nh, generator=gen, device=dev)
        k_ms, _ = device_ms(lambda: KB.emlp_block_backward(
            spec, g_h, x, W, v, lin, pre, need), 50, 5)
        p_ms, _ = device_ms(lambda: KB.emlp_block_backward_plain(
            spec, g_h, x, W, v, lin, pre, need), 10, 3)
        n_par = ng * nin + ng + spec.nnz
        # gate 8 nh, 6 per nonzero for g_lin, 2 ng nin for g_x per row; the
        # parameter sums add 2 ng nin + ng + 4 nnz per row
        flops = nb * (8 * nh + 6 * spec.nnz + 2 * ng * nin)
        nbytes = 4 * (nb * nh + 2 * nb * nin + 2 * ng * nb + ng * nin
                      + nh + 3 * spec.nnz)
        if need:
            flops += nb * (2 * ng * nin + ng + 4 * spec.nnz)
            nbytes += 4 * n_par
        bms, by = bound_ms(nbytes, flops)
        bwd.append((count, k_ms, p_ms, bms, by, None))
        log("kernels", kernel="emlp_block_backward", path=path,
            dims=[nin, ng, nh], batch=nb, param_grads=need, nnz=spec.nnz,
            launches=count, ms=k_ms, plain_ms=p_ms,
            flops=flops, bytes=nbytes, bound_ms=bms, bound_by=by,
            library_ms=None)
    return fwd, bwd


def phase_train_kernels(cfg, dev, rep, agents, states, launches, shapes,
                        errs):
    """Device time per launch, plain time, bound and yardstick of the
    training slice's kernels at the train path's shapes."""
    import itertools
    from gym_rotor_tpu_torch.algos.common import FlatAdamW, OptState
    from gym_rotor_tpu_torch.kernels import flat_adamw as KF
    from gym_rotor_tpu_torch.kernels import replay as KR
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    records, n = [], cfg.n_agents
    dims = (tuple(cfg.obs_dim_n), tuple(cfg.action_dim_n))

    # K2 + K8: one tick's write with the statistics, B = 4096 and PPO A's
    # 32 rows (the tick's first 32)
    ring, ptr, args, reset = rep["ring"], rep["ptr"], rep["args"], rep["reset"]
    by_rows = {}
    for rows in (B, PPO_A_ENVS):
        r_args = tuple(tuple(t[:rows].clone() for t in a) if isinstance(a, tuple)
                       else a[:rows].clone() for a in args)
        r_reset = reset[:rows].clone()
        ep, st = torch.zeros(rows, n, device=dev), torch.zeros(n + 2, device=dev)
        k_ms, k_wall = device_ms(lambda: KR.replay_insert_tick(
            ring, ptr, dims, *r_args, reset=r_reset, ep_ret=ep, stats=st), 100)
        p_ms, _ = device_ms(lambda: KR.replay_insert_tick_plain(
            ring, ptr, dims, *r_args, r_reset, ep, st), 10, 3)
        leaves = (list(r_args[0]) + [r_args[1], r_args[2]] + list(r_args[3])
                  + [r_args[4]])
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        nbytes += r_reset.numel() + 2 * ep.numel() * 4 + rows * ring.shape[1] * 4
        bms, by = bound_ms(nbytes, rows * (3 * n + 2))
        log("kernels", kernel="replay_insert_tick", rows=rows, ms=k_ms,
            wall_ms_per_call=k_wall, plain_ms=p_ms, bytes=nbytes,
            bound_ms=bms, bound_by=by, library_ms=None)
        by_rows[rows] = (1, k_ms, p_ms, bms, by, None)
    rec = _record("replay_insert_tick", "replay.cu",
                  "gym_rotor_tpu/algos/replay.py:145",
                  launches["replay_insert_tick"], errs["replay_insert_tick"],
                  [by_rows[B]])
    _, k32, p32, b32, by32, _ = by_rows[PPO_A_ENVS]
    rec.update(ms_32=k32, plain_ms_32=p32, bound_ms_32=b32, bound_by_32=by32)
    records.append(rec)

    # K2 sample: 256 random rows of the 1e6-row ring, fresh rows each call,
    # into the flagship TD3 update's operands (and SAC's, logged); the
    # yardstick the row gather alone (``index_select``)
    from gym_rotor_tpu_torch.algos import replay as R
    idxs = itertools.cycle([torch.randint(0, ring.shape[0], (cfg.batch_size,),
                                          generator=gen, device=dev)
                            for _ in range(64)])
    l_ms, _ = device_ms(lambda: ring.index_select(0, next(idxs)), 100)
    for name in ("td3", "sac"):
        lay = R.gather_layout(dims, *sample_layouts()[name])
        k_ms, k_wall = device_ms(
            lambda: KR.replay_sample(ring, next(idxs), False, lay), 100)
        p_ms, _ = device_ms(
            lambda: KR.replay_sample_plain(ring, next(idxs), False, lay), 100)
        # the sampled ring rows and indices read once, the operands written
        nbytes = cfg.batch_size * (ring.shape[1] * 4 + 8 + lay.gathered * 4)
        bms, by = bound_ms(nbytes, cfg.batch_size * lay.gathered)
        log("kernels", kernel="replay_sample", layout=name,
            rows=cfg.batch_size, floats_per_row=lay.gathered, ms=k_ms,
            wall_ms_per_call=k_wall, plain_ms=p_ms, bytes=nbytes,
            bound_ms=bms, bound_by=by, library_ms=l_ms)
        if name == "td3":
            inst = [(1, k_ms, p_ms, bms, by, l_ms)]
    records.append(_record("replay_sample", "replay.cu",
                           "gym_rotor_tpu/algos/replay.py:199",
                           launches["replay_sample"], 0.0, inst))

    # K3 / K4 at every (block, batch) instance the train path launched
    fwd, bwd = block_instances(dev, shapes, gen)
    records.append(_record("emlp_block", "emlp_block.cu",
                           "gym_rotor_tpu/models/emlp/nn.py:431",
                           launches["emlp_block"], errs["emlp_block"], fwd))
    records.append(_record("emlp_block_backward", "emlp_block.cu",
                           "gym_rotor_tpu/models/emlp/nn.py:39",
                           launches["emlp_block_backward"],
                           errs["emlp_block_backward"], bwd))

    # the card's floor for one launch, beside K6's and K13's one launch a
    # call: an empty kernel back to back, plain and in clusters of 16
    floor = {f"{blocks}x{threads}_cluster{cl}": device_ms(
        lambda: KF.empty_launch(blocks, threads, cl, device=dev), 200)[0]
        for blocks, threads, cl in ((1, 32, 1), (16, 256, 16))}
    log("kernels", kernel="launch_floor", what="an empty kernel, back to "
        "back", ms=floor)

    # K6: per update each critic steps (with Polyak one update in three),
    # each actor one update in three (with Polyak)
    inst = []
    freq = cfg.policy_update_freq
    for i, agent in enumerate(agents):
        for net, size, lr, uses in (
                ("critic", agent.critic_layout.size, cfg.lr_c[i],
                 ((False, freq - 1), (True, 1))),
                ("actor", agent.actor_layout.size, cfg.lr_a[i], ((True, 1),))):
            tx = FlatAdamW(cfg, lr)
            p = torch.randn(size, generator=gen, device=dev)
            g = torch.randn(size, generator=gen, device=dev)
            mu = 1e-2 * torch.randn(size, generator=gen, device=dev)
            nu = 1e-3 * torch.rand(size, generator=gen, device=dev)
            tgt = p.clone()
            s = tx.scalars(OptState(7, mu, nu, 7), cfg.tau)
            pl = p.clone().requires_grad_(True)
            pl.grad = g.clone()
            opt = torch.optim.AdamW([pl], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=1e-2, fused=True)

            def lib_step():
                torch.nn.utils.clip_grad_norm_([pl], cfg.grad_max_norm)
                opt.step()
            l_ms, _ = device_ms(lib_step, 50)
            for polyak, weight in uses:
                t = tgt if polyak else None
                k_ms, _ = device_ms(lambda: KF.flat_adamw(p, g, mu, nu, s, t), 100)
                p_ms, _ = device_ms(lambda: KF.flat_adamw_plain(p, g, mu, nu, s, t), 20, 3)
                nbytes = 4 * size * (7 + (2 if polyak else 0))
                bms, by = bound_ms(nbytes, size * (24 if polyak else 21))
                inst.append((weight, k_ms, p_ms, bms, by, l_ms))
                log("kernels", kernel="flat_adamw", agent=i, net=net, n=size,
                    polyak=polyak, ms=k_ms, plain_ms=p_ms, bytes=nbytes,
                    bound_ms=bms, bound_by=by, library_ms=l_ms,
                    library="clip_grad_norm_ + AdamW(fused=True).step")
    records.append(_record("flat_adamw", "flat_adamw.cu",
                           "gym_rotor_tpu/algos/common.py:38",
                           launches["flat_adamw"], errs["flat_adamw"], inst))

    # K7: the critics' stacks every update, the actors' one in three
    inst = []
    for i, net, ws, Ws, x in _spectral_stacks(agents, states, dev, gen):
        inst.append((freq if net == "critic" else 1,
                     *spectral_timing(ws, Ws, x, i, net, "td3"), None))
    records.append(_record("spectral_iterate", "spectral.cu",
                           "gym_rotor_tpu/algos/regularizers.py:102",
                           launches["spectral_iterate"], errs["spectral"], inst))
    return records


def spectral_timing(ws, Ws, x, agent, net, path):
    """K7 on the padded stack ``Ws`` of the matrices ``ws`` from ``x``:
    device time per launch, the plain twin's and the bound: the matrices'
    bytes at their true shapes, the start vectors and the iterate; 10 steps
    of two matvecs (2 flops an entry), the norm (3 flops a coordinate).
    Logged with the stack (``scripts/actor_spectral_vs_parent.py`` reads
    it)."""
    from gym_rotor_tpu_torch.kernels import spectral as KS
    k_ms, k_wall = device_ms(lambda: KS.spectral_iterate(Ws, x), 100)
    p_ms, _ = device_ms(lambda: KS.spectral_iterate_plain(Ws, x), 10, 3)
    true = sum(int(W.numel()) for W in ws)
    nbytes = 4 * (true + 2 * sum(int(W.shape[1]) for W in ws))
    bms, by = bound_ms(nbytes, KS.ITERS * (4 * true + 3 * x.numel()))
    log("kernels", kernel="spectral_iterate", path=path, agent=agent,
        net=net, stack=list(Ws.shape), ms=k_ms, wall_ms_per_call=k_wall,
        plain_ms=p_ms, bytes=nbytes, bound_ms=bms, bound_by=by,
        library_ms=None)
    return k_ms, p_ms, bms, by


def phase_sac_kernels(cfg, dev, sac_agents, obs, launches, errs):
    """Records of K9 and K10 (fused with SAC's heads): device time per
    launch at the SAC path's shapes, plain twin's time and bound; no one
    PyTorch call computes either function."""
    from gym_rotor_tpu_torch.kernels import sac_sample as KS
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    records = []

    # K9 at B = 4096 in train mode, both agents (each once per tick); in
    # eval mode at the eval path's 10 rows (logged)
    inst = []
    for i, (agent, o) in enumerate(zip(sac_agents, obs)):
        actor = agent.actor_net
        noise = torch.randn(B, agent.action_dim, generator=gen, device=dev)
        inst.append((1, *actor_timing(actor, o, i, "gauss", noise,
                                      path="sac"), None))
        actor_timing(actor, o[:cfg.num_eval], i, "gauss", path="eval")
    records.append(_record("sac_actor", "emlp_actor.cu",
                           "gym_rotor_tpu/algos/sac.py:114",
                           launches["sac_actor"], errs["sac_actor"], inst))

    # K10 (fused with the heads) per agent: forward at 256 (target) and
    # 1024 (actor loss) rows, backward at 1024
    fwd, bwd = [], []
    for agent in sac_agents:
        act = agent.action_dim
        H = agent.actor_net.log_std_linear.kernel.shape[0]
        for n in (cfg.batch_size, 4 * cfg.batch_size):
            h, wm, bm, wl, bl, z, g_a, g_l = sac_head_inputs(
                n, H, act, False, "moderate", gen, dev)
            k_ms, _ = device_ms(
                lambda: KS.sac_head(h, wm, bm, wl, bl, z, False), 100)
            p_ms, _ = device_ms(
                lambda: KS.sac_head_plain(h, wm, bm, wl, bl, z, False), 50)
            bms, by = bound_ms(*sac_head_work(n, H, act, False))
            fwd.append((1, k_ms, p_ms, bms, by, None))
            log("kernels", kernel="sac_head", rows=n, H=H, act=act, ms=k_ms,
                plain_ms=p_ms, bound_ms=bms, bound_by=by, library_ms=None)
            if n == cfg.batch_size:
                continue
            k_ms, _ = device_ms(lambda: KS.sac_head_backward(
                g_a, g_l, h, wm, bm, wl, bl, z, False), 100)
            p_ms, _ = device_ms(lambda: KS.sac_head_backward_plain(
                g_a, g_l, h, wm, bm, wl, bl, z, False), 50)
            bms, by = bound_ms(*sac_head_work(n, H, act, True))
            bwd.append((1, k_ms, p_ms, bms, by, None))
            log("kernels", kernel="sac_head_backward", rows=n, H=H, act=act,
                ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by,
                library_ms=None)
    records.append(_record("sac_head", "sac_sample.cu",
                           "gym_rotor_tpu/models/mlp.py:129",
                           launches["sac_head"], errs["sac_sample"]["forward"],
                           fwd))
    records.append(_record("sac_head_backward", "sac_sample.cu",
                           "gym_rotor_tpu/models/mlp.py:129",
                           launches["sac_head_backward"],
                           errs["sac_sample"]["backward"], bwd))
    return records


def sac_head_work(n, H, A, backward):
    """(bytes, flops) of the fused head at ``n`` rows: forward, h and the
    noise read, the action and the log-prob written, both heads' weights
    read once; per row the heads' 4 A H products and sums, and ~20 flops an
    action of the clip and the sample.  Backward: the cotangents, h and
    the noise read, both heads' weights read once, g_h and the weight
    gradients M ((H + 1) x 2 A) written (G = [g_mean | g_log_std] stays in
    the launch); per row the heads again, g_h's 4 A H, M's 4 A (H + 1),
    and ~30 flops an action."""
    weights = 2 * A * (H + 1)
    if not backward:
        return 4 * (n * (H + 2 * A + 1) + weights), n * (4 * A * H + 20 * A)
    return (4 * (n * (A + 1 + H + A) + 2 * weights + n * H),
            n * (12 * A * H + 34 * A))


def phase_k5(dev, k5_td3, k5_sac):
    """K5 (``project_linear``, plain torch) at every layer shape the two
    train paths projected: device time per call, the bound (the bytes of
    ``Qw``, ``Qb``, the masks, ``W`` and ``b`` read once and ``W_eff``,
    ``b_eff`` written once), and the ``Qw (Qwᵀ w)`` matmul pair alone as
    the library call; calls per train superstep of each path."""
    from gym_rotor_tpu_torch.models.emlp.nn import (_projector_tensors,
                                                    project_linear)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    inst = []
    for key in sorted(set(k5_td3.calls) | set(k5_sac.calls)):
        rin, rout = (k5_td3.reps.get(key) or k5_sac.reps[key])
        nout, nin = rout.size, rin.size
        W = torch.randn(nout, nin, generator=gen, device=dev)
        b = torch.randn(nout, generator=gen, device=dev)
        Qw, Qb, _, _ = _projector_tensors(rin, rout, dev, torch.float32)
        w = W.reshape(-1)
        k_ms, k_wall = device_ms(lambda: project_linear(rin, rout, W, b), 100)
        l_ms, _ = device_ms(lambda: Qw @ (Qw.T @ w), 100)
        nbytes = 4 * (Qw.numel() + Qb.numel() + 3 * W.numel() + 3 * nout)
        bms, by = bound_ms(nbytes, 4 * (Qw.numel() + Qb.numel())
                           + 2 * (W.numel() + nout))
        per = (k5_td3.calls[key] / TRAIN_STEPS, k5_sac.calls[key] / SAC_STEPS)
        inst.append((per, k_ms, bms, l_ms))
        log("kernels", kernel="project_linear (K5, plain torch)", nin=nin,
            nout=nout, qw_cols=int(Qw.shape[1]), qb_cols=int(Qb.shape[1]),
            calls_per_superstep={"td3": per[0], "sac": per[1]}, ms=k_ms,
            wall_ms_per_call=k_wall, bytes=nbytes, bound_ms=bms, bound_by=by,
            library_ms=l_ms, library="Qw @ (Qw.T @ w)")
    for j, path in enumerate(("td3", "sac")):
        calls = sum(r[0][j] for r in inst)

        def mean(k):
            return sum(r[0][j] * r[k] for r in inst) / calls
        log("kernels", kernel="project_linear (K5, plain torch)", path=path,
            calls_per_superstep=calls, ms_per_call=mean(1),
            bound_ms_per_call=mean(2), library_ms_per_call=mean(3),
            ms_per_superstep=calls * mean(1))


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------
# configurations A and B (utils/config.py PPO_CONFIGS) and the supersteps
# the train phase runs of each
PPO_SUPERSTEPS = (("A", 3), ("B", 2))


def _ppo_dims(cfg):
    """(ticks, rows, actor minibatches and rows, critic minibatches and
    rows) of one PPO superstep (train.py:369-375, ppo.py:218-223)."""
    rl = max(cfg.T_horizon // cfg.num_envs, 1)
    T = rl * cfg.num_envs
    return (rl, T, max(T // cfg.actor_batch_size, 1),
            min(cfg.actor_batch_size, T), max(T // cfg.critic_batch_size, 1),
            min(cfg.critic_batch_size, T))


def _err_rel(k, p, rel):
    """(max |k - p|, tolerance ``rel * max |p|``, finite)."""
    d = float((k.double() - p.double()).abs().max())
    return d, rel * float(p.double().abs().max()), bool(torch.isfinite(k).all())


def phase_ppo_actor(cfg, dev, obs):
    """K11 vs its plain twin (``EMLPActorPPO.dist``, the clipped draw and the
    log-prob of the clipped action) on both PPO actors at ``actor_rows``
    (B = 4096 and 32, the two configurations' envs, the eval path's 10, 1,
    31, 33), in train and eval modes, with ``log_std`` as initialised (0)
    and shifted by +-3 (std 20: most actions clip; std 0.05), each launch
    run twice and compared bitwise.  Tolerance: 1e-5 on actions,
    2e-5 max(1, max |plain|) on log-probs (the log-density divides the
    action's rounding by std)."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.kernels import emlp_actor as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    init = torch.Generator().manual_seed(SEED)
    pcfg = cfg.replace(rl_algo="PPO")
    agents = [PPOAgent(pcfg, i, dev) for i in range(cfg.n_agents)]
    states = [a.init(init) for a in agents]
    worst, bad = 0.0, []
    for i, (agent, o_full) in enumerate(zip(agents, obs)):
        actor = agent.actor_net
        saved = actor.log_std.detach().clone()
        for shift in (0.0, 3.0, -3.0):
            with torch.no_grad():
                actor.log_std.copy_(saved + shift)
            actor.bump_version()
            for nb in actor_rows(int(o_full.shape[0])):
                o = o_full[:nb]
                noise = torch.randn(nb, agent.action_dim, generator=gen,
                                    device=dev)
                for mode, nz in (("train", noise), ("eval", None)):
                    with torch.no_grad():
                        (ak, lk), same = _twice(
                            lambda: K.ppo_actor(actor, o, nz))
                        ap, lp = K.ppo_actor_plain(actor, o, nz)
                    da = float((ak - ap).abs().max())
                    dl, tol, fin = _err(lk, lp)
                    worst = max(worst, da, dl)
                    log("ppo_actor", agent=i, batch=nb, mode=mode,
                        log_std_shift=shift,
                        clipped=float((ap.abs() == 1.0).float().mean()),
                        dims=K.actor_dims(actor), max_abs_err=[da, dl],
                        rerun_bitwise=same)
                    if not (da <= 1e-5 and dl <= tol and fin and same
                            and torch.isfinite(ak).all()):
                        bad.append((i, nb, mode, shift, da, dl, same))
        with torch.no_grad():
            actor.log_std.copy_(saved)
        actor.bump_version()
    if bad:
        raise AssertionError(f"ppo_actor kernel disagrees with plain: {bad}")
    return agents, states, worst


GAE_PLAN_T = (1, 50, 218, 7000)
GAE_PLAN_B = (1, 31, 32, 33, 256, 257, 4096, 4097)


def _gae_inputs(T, nb, gen, dev):
    v, nv, r = (torch.randn(T, nb, 1, generator=gen, device=dev)
                for _ in range(3))
    d = (torch.rand(T, nb, 1, generator=gen, device=dev) < 0.05).float()
    return v, nv, r, d


def phase_gae(cfg, dev):
    """K12 vs its plain twin on horizons of (T, B) = (218, 32) and (50,
    4096) (the two configurations) and (1, 7), with ~5% dones (the chain
    cut inside the horizon).  The scan alone through the TD targets
    (``adv + v`` before the normalisation), the normalisation alone by
    normalising the kernel's own raw advantages (``td - v``) in float64,
    then the whole; one CUDA kernel a call in a profiler trace.  Then the
    launch plan's edges (``GAE_PLAN_T`` x ``GAE_PLAN_B``: one CTA and the
    grid, tiles resident in shared memory and streamed through two chunk
    buffers) and PPO B's horizon in one cluster of 16 CTAs.  Every call is
    rerun: ``td`` and the advantages bitwise the first run's.  Tolerance
    1e-5 max(1, max |plain|): float32 sums over up to 28.7 M entries in
    another order."""
    from gym_rotor_tpu_torch.kernels import gae as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    worst, bad = 0.0, []
    g, lam = cfg.discount, cfg.GAE_lambda
    cases = [(T, nb, None) for T, nb in ((218, 32), (50, B), (1, 7))]
    cases += [(T, nb, None) for T in GAE_PLAN_T for nb in GAE_PLAN_B]
    cases.append((50, B, "cluster"))
    for k, (T, nb, mode) in enumerate(cases):
        v, nv, r, d = _gae_inputs(T, nb, gen, dev)
        plan = K.gae_plan(T, nb, mode=mode)
        if mode is None:
            run = lambda: K.gae(v, nv, r, d, g, lam)      # noqa: E731
        else:
            def run():
                adv, td = torch.empty_like(v), torch.empty_like(v)
                K.gae_launch(v, nv, r, d, g, lam, adv, td, plan)
                return adv, td
        ak, tk = run()
        ak2, tk2 = run()
        ap, tp = K.gae_plain(v, nv, r, d, g, lam)
        checks = {"scan (td targets)": _err(tk, tp, 1e-5),
                  "normalisation": _err(ak, K.normalize_plain(
                      (tk - v).double()), 1e-5),
                  "advantages": _err(ak, ap, 1e-5)}
        same = _bitwise([ak, tk], [ak2, tk2])
        per_call = launches_per_call(run) if k < 3 else None
        worst = max([worst] + [c[0] for c in checks.values()])
        log("gae", T=T, envs=nb, plan=list(plan), dones=int(d.sum()),
            max_abs_err={k: c[0] for k, c in checks.items()},
            rerun_bitwise=same, kernels_a_call=per_call,
            adv_mean=float(ak.mean()),
            adv_std=float(ak.std()) if ak.numel() > 1 else 0.0)
        bad += [(T, nb, mode, k, c[0]) for k, c in checks.items()
                if not (c[0] <= c[1] and c[2])]
        if not same or per_call not in (None, 1):
            bad.append((T, nb, mode, "rerun or kernels a call", same,
                        per_call))
    if bad:
        raise AssertionError(f"gae kernel disagrees with plain: {bad}")
    return worst


def _k13_inputs(n, act, clip, gen, dev):
    """K13's inputs: ratios exp(U(-0.6, 0.6)) (inside and outside the clip
    range on both sides) with N(0, 1) advantages of both signs; n/16 rows
    with a zero advantage; for one action n/16 rows exactly at 1 + clip and
    n/16 at 1 - clip (``a = m + 0.1``, ``lp_old`` moved by float32 ulps
    until the plain twin's ratio is the bound; the kernel computes it with
    the same rounding).  Returns the inputs and the tie rows' count per
    bound."""
    from gym_rotor_tpu_torch.kernels import ppo_loss as K
    from gym_rotor_tpu_torch.models.mlp import gaussian_logprob

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    m = 0.4 * randn(n, act)
    ls = 0.3 * randn(act) if act > 1 else torch.zeros(act, device=dev)
    a = m + 0.5 * randn(n, act)
    q = n // 16
    hits = {}
    if act == 1:
        a[n - 2 * q:] = m[n - 2 * q:] + 0.1
    lp = gaussian_logprob(m, ls.expand_as(m), a)
    shift = torch.rand(n, act, generator=gen, device=dev) * 1.2 - 0.6
    lp_old = lp - shift / act
    adv = randn(n, 1)
    adv[n - 3 * q:n - 2 * q] = 0.0
    if act == 1:
        for j, bound in enumerate((1.0 + clip, 1.0 - clip)):
            rows = slice(n - (2 - j) * q, n - (1 - j) * q)
            target = torch.tensor(bound, dtype=torch.float32, device=dev)
            x0 = lp[rows] - torch.log(target)
            steps = torch.arange(-8, 9, device=dev, dtype=torch.int32)
            cand = (x0.view(torch.int32) + steps).view(torch.float32)
            k = cand.shape[1]
            ratio = K._ratio(m[rows].repeat_interleave(k, 0), ls,
                             a[rows].repeat_interleave(k, 0),
                             cand.reshape(-1, 1))[0].view(-1, k)
            at = ratio == target
            first = torch.where(at.any(1), at.float().argmax(1), 8)
            lp_old[rows] = cand.gather(1, first[:, None])
            hits[bound] = int(at.any(1).sum())
    return m, ls, a, lp_old, adv, hits


K13_ROWS = (1, 127, 128, 129, 3723, 20000)


def phase_ppo_loss(cfg, dev, agents, states, obs):
    """K13 forward and backward vs its plain twin at ``K13_ROWS`` (the two
    configurations' minibatches, 128 and 3723 rows, one row, a block's
    edges and a count past one pass of the launch plan) of 4 and 1 actions
    on ``_k13_inputs``' rows.  Tolerance 2e-5 of the largest plain entry
    (-fmad=false: the per-row arithmetic rounds as the twin's; the sums
    over rows go in another order); every bound must hold tie rows (from
    16 rows on).  Each call is run twice and compared bitwise, and at the
    minibatches' rows a forward and a backward call must each launch
    exactly one CUDA kernel (the profiler's trace), and there 4-action rows
    one float past an aligned base (loaded a float at a time) must give
    the aligned call's outputs bitwise.  Then
    the actor loss's surrogate path at 128 rows (the actor over 3 x 128
    rows through K3/K4, K13 on the first 128) under autograd vs the
    structured network and the plain loss under torch autograd: value and
    flat gradient within 2e-5 max(1, max |plain|)."""
    from torch.func import functional_call
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.kernels import ppo_loss as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    clip = cfg.clip_rate
    coef = torch.tensor(cfg.entropy_coef, device=dev)
    g = torch.tensor(1.0, device=dev)
    worst, bad = {"forward": 0.0, "backward": 0.0}, []
    for n in K13_ROWS:
        for act in (4, 1):
            m, ls, a, lpo, adv, hits = _k13_inputs(n, act, clip, gen, dev)
            args = (m, ls, a, lpo, adv, coef, clip)
            lk = K.ppo_loss(*args)
            lp = K.ppo_loss_plain(*args)
            gmk, gsk = K.ppo_loss_backward(g, *args)
            gmp, gsp = K.ppo_loss_backward_plain(g, *args)
            again = [K.ppo_loss(*args), *K.ppo_loss_backward(g, *args)]
            torch.cuda.synchronize()
            rerun = _bitwise([lk, gmk, gsk], again)
            ratio = K._ratio(m, ls, a, lpo)[0]
            checks = {"loss": _err_rel(lk, lp, 2e-5),
                      "g_mean": _err_rel(gmk, gmp, 2e-5),
                      "g_log_std": _err_rel(gsk, gsp, 2e-5)}
            rec = dict(rows=n, act=act, plan=list(K.ppo_loss_plan(n)),
                       loss=float(lp),
                       ratio_below=int((ratio < 1 - clip).sum()),
                       ratio_inside=int(((ratio > 1 - clip)
                                         & (ratio < 1 + clip)).sum()),
                       ratio_above=int((ratio > 1 + clip).sum()),
                       rows_at_bound={str(k): v for k, v in hits.items()},
                       max_abs_err={k: c[0] for k, c in checks.items()},
                       rerun_bitwise=rerun)
            if n in (128, B * 50 // 55):
                rec["kernels_a_call"] = [
                    launches_per_call(lambda: K.ppo_loss(*args)),
                    launches_per_call(lambda: K.ppo_loss_backward(g, *args))]
                if rec["kernels_a_call"] != [1, 1]:
                    bad.append((n, act, "kernels a call",
                                rec["kernels_a_call"]))
            log("ppo_loss", **rec)
            for k, (d, tol, fin) in checks.items():
                side = "forward" if k == "loss" else "backward"
                worst[side] = max(worst[side], d)
                if not (d <= tol and fin):
                    bad.append((n, act, k, d, tol))
            if not rerun:
                bad.append((n, act, "rerun differs"))
            if act == 1 and n >= 16 and not all(hits.values()):
                bad.append((n, act, "no rows at a clip bound", hits))
            if n in (128, 3723) and act == 4:
                # the same rows one float past an aligned base: the row
                # loads go a float at a time, the numbers stay the same
                def shifted(t):
                    buf = torch.empty(t.numel() + 1, device=dev)
                    buf[1:].copy_(t.reshape(-1))
                    return buf[1:].view(t.shape)
                sargs = (shifted(m), ls, shifted(a), shifted(lpo), adv, coef,
                         clip)
                same = _bitwise([lk, gmk, gsk],
                                [K.ppo_loss(*sargs),
                                 *K.ppo_loss_backward(g, *sargs)])
                log("ppo_loss", rows=n, act=act, rows_misaligned=True,
                    bitwise_aligned=same)
                if not same:
                    bad.append((n, act, "misaligned rows differ"))

    for i, (agent, st) in enumerate(zip(agents, states)):
        mb = 128
        o, no = obs[i][:mb], obs[i][mb:2 * mb]
        eps = 0.05 * torch.randn(1, agent.obs_dim, generator=gen, device=dev)
        o3 = torch.cat([o, no, o + eps])
        noise = torch.randn(mb, agent.action_dim, generator=gen, device=dev)
        with torch.no_grad():
            a, lpo = KA.ppo_actor_plain(agent.actor_net, o, noise)
        lpo = lpo + 0.2 * torch.randn(mb, agent.action_dim, generator=gen,
                                      device=dev)
        adv = torch.randn(mb, 1, generator=gen, device=dev)
        w3 = torch.randn(3 * mb, agent.action_dim, generator=gen, device=dev)

        def loss_of(mean3, log_std, surrogate):
            return surrogate(mean3[:mb], log_std, a, lpo, adv, coef, clip) \
                + 0.1 * (mean3 * w3).sum() / mb
        leaf_k = st.actor.detach().clone().requires_grad_(True)
        vk = agent.actor_layout.views(leaf_k)
        yk = loss_of(agent.actor_mean(vk, o3), vk["log_std"], K.ppo_surrogate)
        (gk,) = torch.autograd.grad(yk, leaf_k)
        leaf_p = st.actor.detach().clone().requires_grad_(True)
        vp = agent.actor_layout.views(leaf_p)
        net = {n[len("network."):]: t for n, t in vp.items()
               if n.startswith("network.")}
        mean3 = torch.tanh(functional_call(agent.actor_net.network, net,
                                           (o3,)))
        yp = loss_of(mean3, vp["log_std"], K.ppo_loss_plain)
        (gp,) = torch.autograd.grad(yp, leaf_p)
        dv, tolv, finv = _err(yk.detach(), yp.detach())
        dg, tolg, fing = _err(gk, gp)
        log("ppo_loss", agent=i, check="actor-loss surrogate path under "
            "autograd vs structured", rows=3 * mb, value_err=dv,
            grad_max_abs_err=dg, grad_scale=float(gp.abs().max()))
        if not (dv <= tolv and dg <= tolg and finv and fing):
            bad.append((i, "autograd", dv, dg))
    if bad:
        raise AssertionError(f"ppo_loss kernel disagrees with plain: {bad}")
    return worst


def _big_forward(spec, x, W, b, v):
    """K3 over a horizon's rows (saving lin and pre, and without them under
    ``no_grad``) vs the twin in chunks of 32 768 rows: ({name: max abs
    err}, failures, kernel h)."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    fk = K.emlp_block(spec, x, W, b, v)
    with torch.no_grad():
        hk = K.emlp_block(spec, x, W, b, v, save=False)[0]
    parts = [K.emlp_block_plain(spec, c, W, b, v)
             for c in torch.split(x, 32768)]
    fp = (torch.cat([p[0] for p in parts]),
          torch.cat([p[1] for p in parts], 1),
          torch.cat([p[2] for p in parts], 1))
    del parts
    errs, bad = {}, []
    for nm, kk, pp in zip(("h", "lin", "pre", "h_unsaved"), fk + (hk,),
                          fp + (fp[0],)):
        d, tol, fin = _err(kk, pp)
        errs[nm] = d
        if not (d <= tol and fin):
            bad.append((nm, d, tol))
    return errs, bad, fk[0]


def phase_v_blocks(cfg, dev, agents, states, obs):
    """K3/K4 vs plain for both blocks of both PPO V critics (first blocks
    (15, 71, 62) and (3, 123, 62)): forward at the GAE pass's 2 T B rows of
    the two configurations (13 952 and 409 600; every row, the plain twin
    in chunks of 32 768 rows), saving lin and pre and without them;
    ``_block_vs_plain`` at the minibatches' 128 and 3723 rows and at
    ``EDGE_ROWS``; then the V critic's kernel path under autograd vs its
    structured network at 3723 rows.  Tolerance 2e-5 max(1, max |plain|),
    as for the Q critics' blocks."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    from gym_rotor_tpu_torch.models.emlp.nn import (bilinear_sparse,
                                                    project_linear)
    from gym_rotor_tpu_torch.utils.config import PPO_CONFIGS, Config
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    worst = (0.0, 0.0)
    bad, shapes = [], set()
    cfgs = [Config(**PPO_CONFIGS[name]) for name, _ in PPO_SUPERSTEPS]
    fwd_rows = [2 * _ppo_dims(c)[1] for c in cfgs]
    bwd_rows = [_ppo_dims(c)[5] for c in cfgs]
    for i, (agent, st) in enumerate(zip(agents, states)):
        net = agent.critic_net.network
        views = agent.critic_layout.views(st.critic)
        reps = -(-max(fwd_rows) // obs[i].shape[0])
        x_all = obs[i].repeat(reps, 1)[:max(fwd_rows)]
        x_all = (x_all + 0.05 * torch.randn(x_all.shape, generator=gen,
                                            device=dev)).contiguous()
        params = []
        for k, blk in enumerate(net.blocks()):
            pre = f"network.block{k}."
            with torch.no_grad():
                W, b = project_linear(blk.linear.rep_in, blk.linear.rep_out,
                                      views[pre + "linear.kernel"],
                                      views[pre + "linear.bias"])
                v = bilinear_sparse(blk.bilinear.rep,
                                    views[pre + "bilinear.bi_params"])[3]
            params.append((K.block_spec(blk, dev), W.contiguous(),
                           b.contiguous(), v.contiguous()))
        for nb in fwd_rows:
            x = x_all[:nb]
            for k, (spec, W, b, v) in enumerate(params):
                errs, failed, x = _big_forward(spec, x, W, b, v)
                worst = (max([worst[0]] + list(errs.values())), worst[1])
                bad += [(i, k, nb) + f for f in failed]
                shapes.add(spec.dims)
                log("v_blocks", agent=i, block=k, dims=list(spec.dims),
                    nnz=spec.nnz, batch=nb, max_abs_err=errs)
        for nb in tuple(bwd_rows) + EDGE_ROWS:
            x = x_all[:nb].contiguous()
            for k, (spec, W, b, v) in enumerate(params):
                g_h = torch.randn(nb, spec.nh, generator=gen, device=dev)
                errs, failed, x = _block_vs_plain(spec, x, W, b, v, g_h)
                worst = _worst(worst, errs)
                bad += [(i, k, nb) + f for f in failed]
                log("v_blocks", agent=i, block=k, dims=list(spec.dims),
                    batch=nb, backward=True, max_abs_err=errs)
        o = x_all[:bwd_rows[-1]]
        leaf_k = st.critic.detach().clone().requires_grad_(True)
        yk = agent.critic_apply(agent.critic_layout.views(leaf_k), o).sum()
        (gk,) = torch.autograd.grad(yk, leaf_k)
        leaf_p = st.critic.detach().clone().requires_grad_(True)
        yp = _plain_apply(agent.critic_net,
                          agent.critic_layout.views(leaf_p), o).sum()
        (gp,) = torch.autograd.grad(yp, leaf_p)
        dv, tolv, finv = _err(yk.detach(), yp.detach())
        dg, tolg, fing = _err(gk, gp)
        log("v_blocks", agent=i, check="V critic autograd vs structured",
            rows=int(o.shape[0]), value_err=dv, grad_max_abs_err=dg,
            grad_scale=float(gp.abs().max()))
        if not (dv <= tolv and dg <= tolg and finv and fing):
            bad.append((i, "autograd", dv, dg))
    if not {(15, 71, 62), (3, 123, 62)} <= shapes:
        raise AssertionError(f"V critic first blocks missing: {shapes}")
    if bad:
        raise AssertionError(f"V critic blocks disagree with plain: {bad}")
    return worst


def expected_launches_ppo(cfg, agents, dev, first, widths=False):
    """Kernel launches of one PPO superstep, and K3/K4's per (shape, rows):
    per tick K1, K11 per agent and the horizon's K2 write; per agent the V
    critic over the 2 T B rows (2 blocks) and K12; per epoch and actor
    minibatch the actor over 3 mb rows (2 blocks forward, 2 backward with
    the parameter sums), K13 forward and backward, K7 and K6; per critic
    minibatch the V critic (2 + 2), K7 and K6.  MLP networks launch no
    block and no K7, and act through the fused MLP PPO actor, one launch
    per agent and tick.  ``widths``: through ``route_widths``."""
    from gym_rotor_tpu_torch.kernels.emlp_block import block_spec
    rl, T, na, mba, nc, mbc = _ppo_dims(cfg)
    n, K = cfg.n_agents, cfg.K_epochs
    want = {"env_tick": rl + (1 if first else 0), "replay_insert_tick": rl,
            "gae": n, "ppo_loss": n * K * na, "ppo_loss_backward": n * K * na,
            "flat_adamw": n * K * (na + nc)}
    fwd, bwd = Counter(), Counter()
    if not cfg.use_equiv:
        # MLP networks: F.linear chains, the fused actor for acting, no K7
        want["mlp_ppo_actor"] = n * rl
        return (route_widths(want, agents, dev) if widths else want), fwd, bwd
    want.update({"ppo_actor": n * rl,
                 "emlp_block": n * (2 + 2 * K * (na + nc)),
                 "emlp_block_backward": n * 2 * K * (na + nc),
                 "spectral_iterate": n * K * (na + nc)})
    for a in agents:
        for blk in a.critic_net.network.blocks():
            d = block_spec(blk, dev).dims
            fwd[(d, 2 * T, False)] += 1        # GAE's values, no_grad
            fwd[(d, mbc, True)] += K * nc
            bwd[(d, mbc, True)] += K * nc
        for blk in a.actor_net.network.blocks():
            d = block_spec(blk, dev).dims
            fwd[(d, 3 * mba, True)] += K * na
            bwd[(d, 3 * mba, True)] += K * na
    if widths:
        want = route_widths(want, agents, dev, fwd, bwd, (K * nc, K * na))
    return want, fwd, bwd


def phase_train_ppo(dev, name, kw, supersteps, widths=False):
    """The PPO training entry point at full width in configuration
    ``name`` (``kw``), ``supersteps`` supersteps, each checked as it ends:
    exact launch counts of every kernel and of K3/K4 per (shape, rows), one
    fold per actor (the acting after each update refolds), finite losses,
    and actor, critic and ``entropy_coef`` moving on every superstep.
    Times the supersteps after the first by CUDA events.  ``widths`` as
    ``phase_train_sac``'s."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.kernels.emlp_actor import fold_actor
    from gym_rotor_tpu_torch.train import train
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config(**kw)
    equiv = cfg.use_equiv
    rl, T, na, mba, nc, mbc = _ppo_dims(cfg)
    wr = _wrappers()
    init = torch.Generator().manual_seed(cfg.seed)   # train()'s init draws
    start = [(s.actor, s.critic, s.entropy_coef) for s in
             [PPOAgent(cfg, i, dev).init(init) for i in range(cfg.n_agents)]]
    probe = dict(last={}, fwd=Counter(), bwd=Counter(), folds=0, bad=[],
                 prev=start, events=[], losses=[], t_host=None, shapes=None)

    def on_superstep(i, warm, metrics, run):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        probe["events"].append(ev)
        now = {k: w.launches for k, w in wr.items()}
        delta = {k: v - probe["last"].get(k, 0) for k, v in now.items()}
        probe["last"] = now
        want, wfwd, wbwd = expected_launches_ppo(cfg, run["agents"], dev,
                                                 i == 0, widths)
        got = {k: v for k, v in delta.items() if v}
        if got != want:
            probe["bad"].append((i, "launches", got, want))
        fwd, bwd = block_shape_counts(widths)
        gfwd, gbwd = fwd - probe["fwd"], bwd - probe["bwd"]
        probe["fwd"], probe["bwd"] = fwd, bwd
        probe["shapes"] = (gfwd, gbwd)
        if gfwd != wfwd or gbwd != wbwd:
            probe["bad"].append((i, "shapes", dict(gfwd), dict(wfwd)))
        folds = fold_actor.folds - probe["folds"]
        probe["folds"] = fold_actor.folds
        stale = [a.actor_net._folded[0] != a.actor_net.param_version
                 for a in run["agents"]] if equiv else []
        if folds != (cfg.n_agents if equiv else 0) or not all(stale):
            probe["bad"].append((i, "folds", folds, stale))
        cur = [(s.actor.clone(), s.critic.clone(), s.entropy_coef.clone())
               for s in run["states"]]
        for j, (p, c) in enumerate(zip(probe["prev"], cur)):
            moved = [not torch.equal(x, y) for x, y in zip(p, c)]
            if moved != [True, True, True]:
                probe["bad"].append((i, "moved", j, moved))
        probe["prev"] = cur
        losses = [float(v) for k, v in metrics.items() if "loss" in k]
        probe["losses"].append(losses)
        if not all(math.isfinite(x) for x in losses) or \
                not math.isfinite(float(metrics["mean_reward"])):
            probe["bad"].append((i, "non-finite", losses))
        if i == 0:
            probe["t_host"] = time.perf_counter()

    torch.cuda.synchronize()
    for w in wr.values():
        w.launches = 0
    clear_block_shape_counts()
    probe["folds"] = fold_actor.folds
    run = train(cfg, supersteps, device=dev, on_superstep=on_superstep,
                log=None)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wr.items() if w.launches}
    timed = supersteps - 1
    host_s = time.perf_counter() - probe["t_host"]
    dev_ms = probe["events"][0].elapsed_time(probe["events"][-1]) / timed
    steps = cfg.n_agents * cfg.K_epochs * (na + nc)
    total_it = [st.total_it for st in run["states"]]
    log("ppo_train", config=name, framework=cfg.framework,
        module_training=cfg.module_training, use_equiv=equiv,
        envs=cfg.num_envs, ticks=rl, rows=T,
        K_epochs=cfg.K_epochs, minibatch=[mba, mbc],
        minibatches_per_epoch=[na, nc], supersteps=supersteps,
        launches=launches, total_it=total_it,
        entropy_coef=[float(s.entropy_coef) for s in run["states"]],
        ms_per_superstep=dev_ms, env_steps_per_s=T / (dev_ms / 1e3),
        minibatch_steps_per_s=steps / (dev_ms / 1e3),
        host_s_per_superstep=host_s / timed,
        losses_first=probe["losses"][0], losses_last=probe["losses"][-1],
        episodes_logged=len(run["episodes"]), mismatches=probe["bad"][:3])
    if not widths:
        check_no_any(launches, name)
    if probe["bad"]:
        raise AssertionError(f"PPO train path {name}: {probe['bad'][:3]}")
    if total_it != [supersteps] * cfg.n_agents:
        raise AssertionError(f"PPO train path {name} did not update: "
                             f"{total_it}")
    return cfg, launches, probe["shapes"], run


def phase_ppo_kernels(dev, agents, states, obs, runs, errs):
    """Records of K11, K7, K12, K13 and the PPO path's K3/K4: device time per
    launch at each configuration's shapes, weighted by its launches in the
    train phase; the plain twin's time and the bound.  No one PyTorch call
    computes any of the three new functions.  ``runs``: per configuration
    ``(cfg, launches, (K3 shapes, K4 shapes) of one superstep, run)``."""
    from gym_rotor_tpu_torch.kernels import gae as KG
    from gym_rotor_tpu_torch.kernels import ppo_loss as KL
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    total = Counter()
    for _, launches, *_ in runs:
        total.update(launches)
    records = []

    # K11 per agent at each configuration's envs (train mode); in eval mode
    # at the eval path's 10 rows (logged)
    inst = []
    for (cfg, launches, *_), (name, _) in zip(runs, PPO_SUPERSTEPS):
        nb = cfg.num_envs
        for i, agent in enumerate(agents):
            actor, o = agent.actor_net, obs[i][:nb]
            noise = torch.randn(nb, agent.action_dim, generator=gen,
                                device=dev)
            inst.append((launches["ppo_actor"] / len(agents),
                         *actor_timing(actor, o, i, "ppo", noise,
                                       path=f"ppo_{name}"), None))
    for i, agent in enumerate(agents):
        actor_timing(agent.actor_net, obs[i][:runs[0][0].num_eval], i, "ppo",
                     path="eval")
    records.append(_record("ppo_actor", "emlp_actor.cu",
                           "gym_rotor_tpu/algos/ppo.py:107",
                           total["ppo_actor"], errs["ppo_actor"], inst))

    # K7 on the PPO path: a minibatch step regularizes the actor or the V
    # critic, so each stack weighs its network's minibatches in one
    # superstep of each configuration
    per_step = Counter()
    for cfg, *_ in runs:
        _, _, na, _, nc, _ = _ppo_dims(cfg)
        per_step.update(critic=cfg.K_epochs * nc, actor=cfg.K_epochs * na)
    inst = [(per_step[net], *spectral_timing(ws, Ws, x, i, net, "ppo"), None)
            for i, net, ws, Ws, x in _spectral_stacks(agents, states, dev,
                                                      gen)]
    records.append(_record("spectral_iterate_ppo", "spectral.cu",
                           "gym_rotor_tpu/algos/regularizers.py:102",
                           total["spectral_iterate"], errs["spectral"], inst))

    # K12 at each configuration's horizon
    inst = []
    for cfg, launches, *_ in runs:
        rl, T = _ppo_dims(cfg)[:2]
        nb = cfg.num_envs
        v, nv, r = (torch.randn(rl, nb, 1, generator=gen, device=dev)
                    for _ in range(3))
        d = (torch.rand(rl, nb, 1, generator=gen, device=dev) < 0.05).float()
        k_ms, k_wall = device_ms(lambda: KG.gae(v, nv, r, d, cfg.discount,
                                                cfg.GAE_lambda), 100)
        p_ms, _ = device_ms(lambda: KG.gae_plain(v, nv, r, d, cfg.discount,
                                                 cfg.GAE_lambda), 3, 3)
        # 4 inputs read and 2 outputs written; ~16 flops an entry (delta 5,
        # the recursion 4, td 1, the two sums 3, the normalisation 2)
        bms, by = bound_ms(24 * T, 16 * T)
        inst.append((launches["gae"], k_ms, p_ms, bms, by, None))
        log("kernels", kernel="gae", T=rl, envs=nb, ms=k_ms,
            wall_ms_per_call=k_wall, plain_ms=p_ms, bytes=24 * T,
            flops=16 * T, bound_ms=bms, bound_by=by, library_ms=None)
    records.append(_record("gae", "gae.cu", "gym_rotor_tpu/algos/ppo.py:119",
                           total["gae"], errs["gae"], inst))

    # K13 forward and backward per agent at each configuration's minibatch
    fwd, bwd = [], []
    coef = torch.tensor(0.01, device=dev)
    g = torch.tensor(1.0, device=dev)
    for cfg, launches, *_ in runs:
        n = _ppo_dims(cfg)[3]
        for agent in agents:
            A = agent.action_dim
            m, ls, a, lpo, adv, _ = _k13_inputs(n, A, cfg.clip_rate, gen, dev)
            args = (m, ls, a, lpo, adv, coef, cfg.clip_rate)
            weight = launches["ppo_loss"] / len(agents)
            k_ms, _ = device_ms(lambda: KL.ppo_loss(*args), 100)
            p_ms, _ = device_ms(lambda: KL.ppo_loss_plain(*args), 30, 3)
            nbytes = 4 * (3 * n * A + n + A + 2)
            bms, by = bound_ms(nbytes, n * (9 * A + 8))
            fwd.append((weight, k_ms, p_ms, bms, by, None))
            log("kernels", kernel="ppo_loss", rows=n, act=A, ms=k_ms,
                plain_ms=p_ms, bytes=nbytes, bound_ms=bms, bound_by=by,
                library_ms=None)
            k_ms, _ = device_ms(lambda: KL.ppo_loss_backward(g, *args), 100)
            p_ms, _ = device_ms(lambda: KL.ppo_loss_backward_plain(g, *args),
                                30, 3)
            nbytes = 4 * (4 * n * A + n + 2 * A + 2)
            bms, by = bound_ms(nbytes, n * (17 * A + 14))
            bwd.append((weight, k_ms, p_ms, bms, by, None))
            log("kernels", kernel="ppo_loss_backward", rows=n, act=A,
                ms=k_ms, plain_ms=p_ms, bytes=nbytes, bound_ms=bms,
                bound_by=by, library_ms=None)
    records.append(_record("ppo_loss", "ppo_loss.cu",
                           "gym_rotor_tpu/algos/ppo.py:247",
                           total["ppo_loss"], errs["ppo_loss"]["forward"],
                           fwd))
    records.append(_record("ppo_loss_backward", "ppo_loss.cu",
                           "gym_rotor_tpu/algos/ppo.py:247",
                           total["ppo_loss_backward"],
                           errs["ppo_loss"]["backward"], bwd))

    # K3 / K4 at every (block, rows) instance of the PPO path, weighted by
    # one superstep's launches of each configuration; the plain forward in
    # chunks of 32768 rows past that (as JAX chunks the V critic over time)
    kf, kb = [], []
    for _, _, shapes, _ in runs:
        f, b = block_instances(dev, shapes, gen, path="ppo")
        kf += f
        kb += b
    records.append(_record("emlp_block_ppo", "emlp_block.cu",
                           "gym_rotor_tpu/models/emlp/nn.py:431",
                           total["emlp_block"], errs["v_blocks"][0], kf))
    records.append(_record("emlp_block_backward_ppo", "emlp_block.cu",
                           "gym_rotor_tpu/models/emlp/nn.py:39",
                           total["emlp_block_backward"],
                           errs["v_blocks"][1], kb))
    return records


# ---------------------------------------------------------------------------
# MONO and the MLP networks under TD3
# ---------------------------------------------------------------------------
# the three configurations of the reference's four-way comparison beside
# the flagship Mod-EMLP (README: Mod-EMLP > Mono-EMLP > Mod-MLP > Mono-MLP),
# at the flagship's full width, and the train supersteps run of each
MONO_STEPS = 100
TD3_CONFIGS = (("mono_emlp", dict(framework="MONO")),
               ("mono_mlp", dict(framework="MONO", use_equiv=False)),
               ("mod_mlp", dict(use_equiv=False)))
MONO_TICKS = 10      # K1-coupled compare ticks, each with ~10% at the cap


def _mlp_flops(net_params, rows):
    """Forward flops of a Dense chain over ``rows`` rows: a multiply-add
    per weight, a bias add and an activation per output."""
    return 2 * rows * sum(t.numel() for t in net_params)


MLP_SAC_ACTOR = {}   # mlp_sac_actor_checks' worst error and times


def mlp_sac_actor_checks(dev):
    """The fused MLP SAC actor (``kernels/mlp_sac_actor.py``) vs its twin
    (``ActorSAC.dist``'s ``F.linear`` chain and the plain sample) at every
    MLP SAC agent shape (Mod-MLP agents 0 and 1, Mono-MLP: 15 / 16 / 4,
    3 / 4 / 1, 23 / 16 / 4) and at the wider Mod-MLP actors of
    ``actor_hidden_dim`` (256, 50) (15 / 256 / 4, past 48 KB of shared
    memory, and 3 / 50 / 1: the run-time-width kernel) on reset obs, at 1,
    10, 32 and 4096 rows, train
    and eval modes, with the log_std bias as initialised and shifted by
    +-25 (every row at a clip bound); each launch run twice and compared
    bitwise, written into column slices of wider tensors whose other
    columns must stay as they were, one CUDA kernel a call (profiler
    trace).  Tolerance 1e-5 (tanh outputs).  Then device time at 4096 rows,
    the twin's and the bound, kept for the kernel's record."""
    from gym_rotor_tpu_torch.algos.sac import SACAgent
    from gym_rotor_tpu_torch.envs.batch import batched_reset
    from gym_rotor_tpu_torch.kernels import mlp_sac_actor as KM
    from gym_rotor_tpu_torch.utils.config import Config
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    init = torch.Generator().manual_seed(SEED)
    worst, bad, inst = 0.0, [], {}
    for fam, kw in (("mod_mlp", {}), ("mono_mlp", dict(framework="MONO")),
                    ("wide_mlp", dict(actor_hidden_dim=(256, 50)))):
        cfg = Config(num_envs=B, rl_algo="SAC", use_equiv=False, **kw)
        obs = [o.contiguous() for o in batched_reset(cfg, gen, device=dev)[1]]
        for i in range(cfg.n_agents):
            agent = SACAgent(cfg, i, dev)
            actor = agent.bound_actor(agent.init(init))
            A = agent.action_dim
            bias = actor.log_std.bias
            saved = bias.detach().clone()
            for shift in (0.0, 25.0, -25.0):
                with torch.no_grad():
                    bias.copy_(saved + shift)
                for nb in (1, 10, 32, B):
                    o = obs[i][:nb]
                    noise = torch.randn(nb, A, generator=gen, device=dev)
                    for mode, nz in (("train", noise), ("eval", None)):
                        def fused():
                            out = torch.full((nb, A + 2), 7.0, device=dev)
                            with torch.no_grad():
                                actor(o, nz, out[:, 1:1 + A])
                            return out
                        out, same = _twice(fused)
                        with torch.no_grad():
                            ap = KM.mlp_sac_actor_plain(actor, o, nz)
                        da = float((out[:, 1:1 + A] - ap).abs().max())
                        kept = bool((out[:, [0, -1]] == 7).all())
                        per_call = None
                        if shift == 0.0 and nb in (32, B):
                            with torch.no_grad():
                                per_call = launches_per_call(
                                    lambda: actor(o, nz, out[:, 1:1 + A]))
                        worst = max(worst, da)
                        log("mlp_nets", kernel="mlp_sac_actor", config=fam,
                            agent=i, dims=KM.actor_dims(actor), batch=nb,
                            mode=mode, log_std_shift=shift,
                            saturated=float((ap.abs() == 1.0).float().mean()),
                            max_abs_err=da, other_columns_kept=kept,
                            rerun_bitwise=same, kernels_a_call=per_call)
                        if not (da <= 1e-5 and kept and same
                                and per_call in (None, 1)
                                and bool(torch.isfinite(out).all())):
                            bad.append((fam, i, nb, mode, shift, da, kept,
                                        same, per_call))
            with torch.no_grad():
                bias.copy_(saved)
            nin, nh, _ = KM.actor_dims(actor)
            o = obs[i]
            noise = torch.randn(B, A, generator=gen, device=dev)
            with torch.no_grad():
                k_ms, k_wall = device_ms(lambda: actor(o, noise), 100)
                p_ms, _ = device_ms(
                    lambda: KM.mlp_sac_actor_plain(actor, o, noise), 50)
            # obs and the draw read, the action written, the weights read
            # once; per row the layers' and heads' products and sums, the
            # biases and relus, and ~10 flops an action of the clip and draw
            nbytes = 4 * (B * (nin + 2 * A) + nin * nh + nh * nh
                          + 2 * nh * A + 2 * nh + 2 * A)
            flops = B * (2 * (nin * nh + nh * nh + 2 * nh * A) + 4 * nh
                         + 10 * A)
            bms, by = bound_ms(nbytes, flops)
            inst[(fam, i)] = (k_ms, p_ms, bms, by)
            log("mlp_nets", kernel="mlp_sac_actor", config=fam, agent=i,
                dims=[nin, nh, A], rows=B, ms=k_ms, wall_ms_per_call=k_wall,
                plain_ms=p_ms, bytes=nbytes, flops=flops, bound_ms=bms,
                bound_by=by, library_ms=None)
    if bad:
        raise AssertionError(f"mlp_sac_actor disagrees: {bad[:5]}")
    MLP_SAC_ACTOR.update(err=worst, inst=inst)


def phase_mlp_nets(dev, runs):
    """The MLP networks (plain torch: ``F.linear`` on cuBLAS, not a kernel
    of the port) at the train paths' shapes, for every agent of the
    Mono-MLP and Mod-MLP runs: the acting actor at 4096 rows, and the
    network work of one gated TD3 update (target actor at 256 rows, target
    and current twin critic at 256, the critic's backward, the actor at 768
    and q1 at 256 with the actor loss's backward).  Device time per call
    (the acting actor by CUDA events; the update, whose autograd backward
    keeps the host from running ahead of the card, as the profiler's
    kernel-time sum); the bound from the weights and activations read and
    written once and the flops (3x the forward's for a forward with its
    backward).  Then the fused MLP SAC actor, a kernel, against its twin
    (``mlp_sac_actor_checks``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    mlp_sac_actor_checks(dev)
    for name, run in runs.items():
        cfg = run["cfg"]
        for i, (agent, st) in enumerate(zip(run["agents"], run["states"])):
            nb = cfg.batch_size
            o4k = torch.randn(B, agent.obs_dim, generator=gen, device=dev)
            o = o4k[:nb]
            o3 = o4k[:3 * nb]
            a = torch.rand(nb, agent.action_dim, generator=gen, device=dev)
            actor = agent.bound_actor(st)
            with torch.no_grad():
                k_ms, wall = device_ms(lambda: actor(o4k), 100)
            ap = list(actor.parameters())
            cp = list(agent.critic_net.parameters())
            flops = _mlp_flops(ap, B)
            nbytes = 4 * (sum(t.numel() for t in ap) + o4k.numel()
                          + B * agent.action_dim)
            bms, by = bound_ms(nbytes, flops)
            log("mlp_nets", config=name, agent=i, what="acting actor",
                rows=B, ms=k_ms, wall_ms_per_call=wall, flops=flops,
                bytes=nbytes, bound_ms=bms, bound_by=by,
                library="torch.nn.functional.linear x3")

            av, cv = (agent.actor_layout.views(st.actor_target),
                      agent.critic_layout.views(st.critic_target))

            def update_nets():
                with torch.no_grad():
                    a_next = agent.actor_apply(av, o)
                    agent.critic_apply(cv, o, a_next)
                leaf = st.critic.detach().requires_grad_(True)
                q1, q2 = agent.critic_apply(agent.critic_layout.views(leaf),
                                            o, a)
                torch.autograd.grad(q1.sum() + q2.sum(), leaf)
                leaf = st.actor.detach().requires_grad_(True)
                a3 = agent.actor_apply(agent.actor_layout.views(leaf), o3)
                q = agent.critic_q1(agent.critic_layout.views(st.critic),
                                    o, a3[:nb])
                torch.autograd.grad(q.sum(), leaf)
            k_ms, wall = kernel_ms(update_nets, 20)
            # target actor; target and current twin; the current twin's
            # backward (2x its forward); the actor at 3 nb and q1 (half the
            # twin) at nb, forward and backward
            flops = (_mlp_flops(ap, nb) + 4 * _mlp_flops(cp, nb)
                     + 3 * _mlp_flops(ap, 3 * nb)
                     + 3 * _mlp_flops(cp, nb) // 2)
            nbytes = 4 * (3 * sum(t.numel() for t in ap + cp)
                          + 6 * nb * agent.obs_dim)
            bms, by = bound_ms(nbytes, flops)
            log("mlp_nets", config=name, agent=i,
                what="networks of one gated update (fwd + bwd)",
                timing="torch.profiler kernel-time sum", ms=k_ms,
                wall_ms_per_call=wall, flops=flops, bytes=nbytes,
                bound_ms=bms, bound_by=by,
                library="torch.nn.functional.linear + autograd")


def phase_mono_kernels(dev, mono_cfg, tick, runs, errs):
    """Records of the slice's new kernel instances: K1's coupled instance,
    the MONO K3-actor instance and K3/K4 on the Mono-EMLP path (its first
    blocks the new instances), each with its launches on the Mono paths."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    records = []
    k_ms, p_ms, bms, by = tick_timing(mono_cfg, dev, tick)
    launches = sum(runs[n]["launches"]["env_tick"]
                   for n in ("mono_emlp", "mono_mlp"))
    records.append(dict(
        name="env_tick_coupled", route="cuda",
        source="gym_rotor_tpu_torch/kernels/csrc/env_tick.cu",
        replaces="gym_rotor_tpu/envs/batch.py:75", launches=launches,
        max_abs_err=tick["max_abs_err"], ms=k_ms, plain_ms=p_ms, bound_ms=bms,
        bound_by=by, library_ms=None))

    run = runs["mono_emlp"]
    agent, st = run["agents"][0], run["states"][0]
    obs = run["obs"][0].contiguous()        # the run's last obs, 4096 rows
    actor = agent.bound_actor(st)
    k_ms, p_ms, bms, by = actor_timing(actor, obs, 0, path="mono")
    actor_timing(actor, obs[:mono_cfg.num_eval], 0, path="eval")
    records.append(dict(
        name="emlp_actor_mono", route="cuda",
        source="gym_rotor_tpu_torch/kernels/csrc/emlp_actor.cu",
        replaces="gym_rotor_tpu/models/emlp/nn.py:431",
        launches=run["launches"]["emlp_actor"], max_abs_err=errs["actor"],
        ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by, library_ms=None))

    fwd, bwd = block_instances(dev, run["shapes"], gen, path="mono_emlp")
    records.append(_record("emlp_block_mono", "emlp_block.cu",
                           "gym_rotor_tpu/models/emlp/nn.py:431",
                           run["launches"]["emlp_block"], errs["blocks"][0],
                           fwd))
    records.append(_record("emlp_block_backward_mono", "emlp_block.cu",
                           "gym_rotor_tpu/models/emlp/nn.py:39",
                           run["launches"]["emlp_block_backward"],
                           errs["blocks"][1], bwd))
    return records


def phase_mono(dev):
    """The MONO framework and the MLP networks under TD3: K1-coupled vs its
    plain twin over MONO_TICKS ticks at B = 4096 (train) and the eval
    path's 10 envs (eval); the MONO K3-actor instance and the MONO K3/K4
    instances vs their twins at the train path's rows; K6 and K7 on the
    MONO networks; then 1 warm + MONO_STEPS train supersteps of each of
    Mono-EMLP, Mono-MLP and Mod-MLP (exact launch counts per superstep,
    K3/K4 per shape and rows, finite losses, moved parameters), and
    ``evaluate`` with the trained Mono-EMLP and Mono-MLP actors."""
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.kernels import env_tick as KT
    from gym_rotor_tpu_torch.utils.config import Config
    mono = Config(num_envs=B, framework="MONO")
    tick = phase_env_tick(mono, dev, B, "train", MONO_TICKS)
    small = phase_env_tick(mono.replace(num_envs=mono.num_eval), dev,
                           mono.num_eval, "eval", MONO_TICKS)
    tick["max_abs_err"] = max(tick["max_abs_err"], small["max_abs_err"])
    _, out = KT.env_tick(mono, tick["state"], tick["actions"], tick["draws"])
    obs = tuple(o.contiguous() for o in out.obs)
    errs = {}
    _, errs["actor"] = phase_emlp(mono, dev, obs)
    gen = torch.Generator().manual_seed(SEED)
    agents = [TD3Agent(mono, 0, dev)]
    states = [agents[0].init(gen)]
    errs["blocks"] = phase_emlp_block(mono, dev, agents, states, obs,
                                      n_shapes=4)
    phase_flat_adamw(mono, dev, agents)
    phase_spectral(mono, dev, agents, states)
    runs = {}
    for name, kw in TD3_CONFIGS:
        cfg = Config(num_envs=B, start_timesteps=B, **kw)
        launches, shapes, run = phase_train(dev, cfg, MONO_STEPS,
                                            name=f"train_{name}")
        run.update(cfg=cfg, launches=launches, shapes=shapes)
        runs[name] = run
    for name in ("mono_emlp", "mono_mlp"):
        run = runs[name]
        actors = [a.bound_actor(st)
                  for a, st in zip(run["agents"], run["states"])]
        phase_eval(run["cfg"], dev, actors, name=f"eval_{name}")
    phase_mlp_nets(dev, {n: runs[n] for n in ("mono_mlp", "mod_mlp")})
    return phase_mono_kernels(dev, mono, tick, runs, errs)


# ---------------------------------------------------------------------------
# The rest of the learner matrix: CTDE, and SAC and PPO on MONO and MLP
# ---------------------------------------------------------------------------
# the configurations the JAX package trains beyond the flagship
# learners and phase 20's, at full width: TD3/SAC at 4096 envs, 1 warm +
# FAMILY_STEPS train supersteps; PPO in configuration B (4096 envs x 50
# ticks, minibatch 3723), FAMILY_PPO_STEPS supersteps of K_epochs 1
FAMILY_STEPS = 20
FAMILY_PPO_STEPS = 2    # the second is timed, as phase 18's
CTDE_KW = dict(module_training="CTDE")
FAMILY_CONFIGS = (
    ("td3_ctde_emlp", dict(CTDE_KW)),
    ("td3_ctde_mlp", dict(CTDE_KW, use_equiv=False)),
    ("sac_ctde_emlp", dict(CTDE_KW, rl_algo="SAC")),
    ("sac_ctde_mlp", dict(CTDE_KW, rl_algo="SAC", use_equiv=False)),
    ("sac_mod_mlp", dict(rl_algo="SAC", use_equiv=False)),
    ("sac_mono_emlp", dict(rl_algo="SAC", framework="MONO")),
    ("sac_mono_mlp", dict(rl_algo="SAC", framework="MONO", use_equiv=False)),
    # a wider MLP SAC actor: the head and acting kernels at run-time widths
    ("sac_mod_mlp_wide", dict(rl_algo="SAC", use_equiv=False,
                              actor_hidden_dim=(256, 50))),
    ("ppo_ctde_emlp", dict(CTDE_KW, rl_algo="PPO")),
    ("ppo_ctde_mlp", dict(CTDE_KW, rl_algo="PPO", use_equiv=False)),
    ("ppo_mod_mlp", dict(rl_algo="PPO", use_equiv=False)),
    ("ppo_mono_emlp", dict(rl_algo="PPO", framework="MONO")),
    ("ppo_mono_mlp", dict(rl_algo="PPO", framework="MONO", use_equiv=False)))
# the five rows of README's "Learning results" this slice makes trainable
RESULTS_ROWS = ("td3_ctde_emlp", "ppo_mono_emlp", "sac_mono_emlp",
                "sac_mono_mlp", "ppo_mono_mlp")
NEW_BLOCKS = ((23, 71, 62), (23, 123, 62), (18, 71, 62), (18, 123, 62))


def _first_block(net, views, prefix, dev):
    """``(spec, W_eff, b_eff, v)`` of ``net``'s first block on ``views``."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    from gym_rotor_tpu_torch.models.emlp.nn import (bilinear_sparse,
                                                    project_linear)
    blk = net.blocks()[0]
    pre = f"{prefix}block0."
    with torch.no_grad():
        W, b = project_linear(blk.linear.rep_in, blk.linear.rep_out,
                              views[pre + "linear.kernel"],
                              views[pre + "linear.bias"])
        v = bilinear_sparse(blk.bilinear.rep,
                            views[pre + "bilinear.bi_params"])[3]
    return K.block_spec(blk, dev), W.contiguous(), b.contiguous(), \
        v.contiguous()


def phase_family_blocks(dev, obs_mod, obs_mono):
    """K3/K4 vs plain for the new first blocks: the CTDE twin Q critics'
    (23, 71, 62) and (23, 123, 62) on both agents' obs and actions, the
    CTDE V critics' (18, 71, 62) and (18, 123, 62) and the MONO V critic's
    (23, 71, 62): forward and all four gradients (and g_x alone) at the
    update's rows (128 and 3723 in PPO's minibatches, 256 in TD3's and
    SAC's critic losses, 768 and 1024 the actor losses' batches), and the
    V critics' forward at the GAE pass's 2 T B rows of configurations A and
    B (13 952, 409 600; every row, the plain twin in chunks of 32 768
    rows; saving lin and pre and without them), each through
    ``_block_vs_plain`` / ``_big_forward`` and at ``EDGE_ROWS`` too; then
    each network's kernel path under autograd vs its structured network at
    256 rows.  Tolerance 2e-5 max(1, max |plain|), as phases 7 and 17."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.utils.config import PPO_CONFIGS, Config
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    init = torch.Generator().manual_seed(SEED)
    ctde = Config(**CTDE_KW)
    gae_rows = [2 * _ppo_dims(Config(**c))[1] for c in PPO_CONFIGS.values()]
    joint = torch.cat(obs_mod, -1)
    act = torch.rand(B, sum(ctde.action_dim_n), generator=gen,
                     device=dev) * 2 - 1
    nets = []
    for i in range(ctde.n_agents):
        q = TD3Agent(ctde, i, dev)
        nets.append((f"ctde_q{i}", q, q.init(init),
                     torch.cat([joint, act], -1)))
        v = PPOAgent(ctde.replace(rl_algo="PPO"), i, dev)
        nets.append((f"ctde_v{i}", v, v.init(init), joint))
    v = PPOAgent(Config(framework="MONO", rl_algo="PPO"), 0, dev)
    nets.append(("mono_v", v, v.init(init), obs_mono[0]))
    worst = {d: [0.0, 0.0] for d in NEW_BLOCKS}
    bad = []
    for name, agent, st, x_all in nets:
        views = agent.critic_layout.views(st.critic)
        is_q = name.startswith("ctde_q")
        net, prefix = ((agent.critic_net.network1, "network1.") if is_q
                       else (agent.critic_net.network, "network."))
        spec, W, b, v = _first_block(net, views, prefix, dev)
        if spec.dims not in NEW_BLOCKS:
            raise AssertionError(f"{name}: first block {spec.dims}")
        for nb in (128, 256, 768, 1024) + EDGE_ROWS:
            x = x_all[:nb].contiguous()
            nb = int(x.shape[0])
            g_h = torch.randn(nb, spec.nh, generator=gen, device=dev)
            errs, failed, _ = _block_vs_plain(spec, x, W, b, v, g_h)
            worst[spec.dims] = list(_worst(worst[spec.dims], errs))
            bad += [(name, nb) + f for f in failed]
            log("family_blocks", net=name, dims=list(spec.dims),
                nnz=spec.nnz, batch=nb, max_abs_err=errs)
        if not is_q:
            for nb in gae_rows:
                reps = -(-nb // x_all.shape[0])
                x = x_all.repeat(reps, 1)[:nb]
                x = (x + 0.05 * torch.randn(x.shape, generator=gen,
                                            device=dev)).contiguous()
                errs, failed, _ = _big_forward(spec, x, W, b, v)
                worst[spec.dims][0] = max([worst[spec.dims][0]]
                                          + list(errs.values()))
                bad += [(name, nb) + f for f in failed]
                log("family_blocks", net=name, dims=list(spec.dims),
                    batch=nb, max_abs_err=errs)
                del x
        # the whole kernel path under autograd vs the structured network
        xs = (x_all[:256, :sum(ctde.obs_dim_n)].contiguous(),
              x_all[:256, sum(ctde.obs_dim_n):].contiguous()) if is_q \
            else (x_all[:256].contiguous(),)
        leaf_k = st.critic.detach().clone().requires_grad_(True)
        yk = agent.critic_apply(agent.critic_layout.views(leaf_k), *xs)
        yk = sum(q.sum() for q in yk) if is_q else yk.sum()
        (gk,) = torch.autograd.grad(yk, leaf_k)
        leaf_p = st.critic.detach().clone().requires_grad_(True)
        yp = _plain_apply(agent.critic_net, agent.critic_layout.views(leaf_p),
                          *xs)
        yp = sum(q.sum() for q in yp) if is_q else yp.sum()
        (gp,) = torch.autograd.grad(yp, leaf_p)
        dv, tolv, finv = _err(yk.detach(), yp.detach())
        dg, tolg, fing = _err(gk, gp)
        log("family_blocks", net=name, check="autograd vs structured",
            rows=256, value_err=dv, grad_max_abs_err=dg,
            grad_scale=float(gp.abs().max()))
        if not (dv <= tolv and dg <= tolg and finv and fing):
            bad.append((name, "autograd", dv, dg))
    if bad:
        raise AssertionError(f"new block instances disagree: {bad[:5]}")
    return worst


def phase_family_actors(dev, obs_mod, obs_mono):
    """K9 and K11 at the MONO actor (23, 18, 16, 4) vs their plain twins, at
    4096, 32 and 10 rows (train envs, PPO A's envs, eval envs) and at 1, 31
    and 33, and the fused MLP PPO actor (Mod-MLP agents 0 and 1, Mono-MLP)
    vs its twin (``actor_ppo_pre`` + ``ppo_head_plain``) at 1, 10, 32 and
    4096 rows; each launch run twice and compared bitwise, in train and
    eval modes, with SAC's log_std bias shifted by +-25 (every row at a clip
    bound) and PPO's log_std by +-3; the fused actor writes into column
    slices of wider tensors, whose other columns must stay as they were,
    and launches one CUDA kernel a call (profiler trace). Tolerance 1e-5 on
    actions, 2e-5 max(1, max |plain|) on log-probs."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.algos.sac import SACAgent
    from gym_rotor_tpu_torch.kernels import emlp_actor as K
    from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as KM
    from gym_rotor_tpu_torch.utils.config import Config
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    init = torch.Generator().manual_seed(SEED)
    worst = {"sac_actor_mono": 0.0, "ppo_actor_mono": 0.0,
             "mlp_ppo_actor": 0.0}
    bad = []
    sac = SACAgent(Config(framework="MONO", rl_algo="SAC"), 0, dev)
    ppo = PPOAgent(Config(framework="MONO", rl_algo="PPO"), 0, dev)
    sac.init(init)
    ppo.init(init)
    for kind, agent, param, shifts in (
            ("sac_actor_mono", sac, sac.actor_net.log_std_linear.bias,
             (0.0, 25.0, -25.0)),
            ("ppo_actor_mono", ppo, ppo.actor_net.log_std, (0.0, 3.0, -3.0))):
        actor = agent.actor_net
        if K.actor_dims(actor) != (23, 18, 16, 4):
            raise AssertionError(f"{kind}: {K.actor_dims(actor)}")
        saved = param.detach().clone()
        for shift in shifts:
            with torch.no_grad():
                param.copy_(saved + shift)
            actor.bump_version()
            for nb in actor_rows(B):
                o = obs_mono[0][:nb]
                noise = torch.randn(nb, 4, generator=gen, device=dev)
                for mode, nz in (("train", noise), ("eval", None)):
                    with torch.no_grad():
                        if kind == "sac_actor_mono":
                            ak, same = _twice(
                                lambda: K.sac_actor(actor, o, nz))
                            ap = K.sac_actor_plain(actor, o, nz)
                            dl, tol, fin = 0.0, 1.0, True
                        else:
                            (ak, lk), same = _twice(
                                lambda: K.ppo_actor(actor, o, nz))
                            ap, lp = K.ppo_actor_plain(actor, o, nz)
                            dl, tol, fin = _err(lk, lp)
                    da = float((ak - ap).abs().max())
                    worst[kind] = max(worst[kind], da, dl)
                    log("family_actors", kernel=kind, batch=nb, mode=mode,
                        log_std_shift=shift, max_abs_err=[da, dl],
                        rerun_bitwise=same)
                    if not (da <= 1e-5 and dl <= tol and fin and same
                            and torch.isfinite(ak).all()):
                        bad.append((kind, nb, mode, shift, da, dl, same))
        with torch.no_grad():
            param.copy_(saved)
        actor.bump_version()

    # the fused MLP PPO actors, bound to a learner's flat vector as they act
    for fam, kw, obs in (("mod_mlp", {}, obs_mod),
                         ("mono_mlp", dict(framework="MONO"), obs_mono)):
        cfg = Config(rl_algo="PPO", use_equiv=False, **kw)
        for i in range(cfg.n_agents):
            agent = PPOAgent(cfg, i, dev)
            actor = agent.bound_actor(agent.init(init))
            A = agent.action_dim
            saved = actor.log_std.detach().clone()
            for shift in (0.0, 3.0, -3.0):
                with torch.no_grad():
                    actor.log_std.copy_(saved + shift)
                for nb in (1, 10, 32, B):
                    o = obs[i][:nb]
                    noise = torch.randn(nb, A, generator=gen, device=dev)
                    for mode, nz in (("train", noise), ("eval", None)):
                        def fused():
                            out = torch.full((nb, A + 2), 7.0, device=dev)
                            lpo = torch.full((nb, A + 2), 7.0, device=dev)
                            with torch.no_grad():
                                actor(o, nz, out[:, 1:1 + A], lpo[:, 1:1 + A])
                            return out, lpo
                        (out, lpo), same = _twice(fused)
                        with torch.no_grad():
                            ap, lp = KM.mlp_ppo_actor_plain(actor, o, nz)
                        da = float((out[:, 1:1 + A] - ap).abs().max())
                        dl, tol, fin = _err(lpo[:, 1:1 + A], lp)
                        kept = bool((out[:, [0, -1]] == 7).all()
                                    and (lpo[:, [0, -1]] == 7).all())
                        per_call = None
                        if shift == 0.0 and nb in (32, B):
                            with torch.no_grad():
                                per_call = launches_per_call(
                                    lambda: actor(o, nz, out[:, 1:1 + A],
                                                  lpo[:, 1:1 + A]))
                        worst["mlp_ppo_actor"] = max(worst["mlp_ppo_actor"],
                                                     da, dl)
                        log("family_actors", kernel="mlp_ppo_actor",
                            config=fam, agent=i, dims=KM.actor_dims(actor),
                            batch=nb, mode=mode, log_std_shift=shift,
                            clipped=float((ap.abs() == 1.0).float().mean()),
                            max_abs_err=[da, dl], other_columns_kept=kept,
                            rerun_bitwise=same, kernels_a_call=per_call)
                        if not (da <= 1e-5 and dl <= tol and fin and kept
                                and same and per_call in (None, 1)):
                            bad.append(("mlp_ppo_actor", fam, i, nb, mode,
                                        shift, da, dl, kept, same, per_call))
            with torch.no_grad():
                actor.log_std.copy_(saved)
    if bad:
        raise AssertionError(f"new actor kernels disagree: {bad[:5]}")
    return worst


def phase_family_kernels(dev, runs, block_errs, actor_errs, obs_mod,
                         obs_mono):
    """One record per new instance: K3 and K4 at each new first block
    (weighted over its (rows) instances on the thirteen runs), K9 and K11 at
    the MONO actor, and the fused MLP PPO actor; each with its launches on
    those runs,
    device time per launch, the plain twin's time and the bound."""
    from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as KM
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    fwd, bwd = Counter(), Counter()
    run_fwd, run_bwd = Counter(), Counter()
    total = Counter()
    for run in runs.values():
        fwd.update(run["shapes"][0])
        bwd.update(run["shapes"][1])
        run_fwd.update(run["shape_totals"][0])
        run_bwd.update(run["shape_totals"][1])
        total.update(run["launches"])
    records = []
    for dims in NEW_BLOCKS:
        # timed at one superstep's instances of each run; launches: the
        # runs' whole count at this block
        f = Counter({k: c for k, c in fwd.items() if k[0] == dims})
        b = Counter({k: c for k, c in bwd.items() if k[0] == dims})
        kf, kb = block_instances(dev, (f, b), gen, path="families")
        tag = "_".join(map(str, dims))
        records.append(_record(
            f"emlp_block_{tag}", "emlp_block.cu",
            "gym_rotor_tpu/models/emlp/nn.py:431",
            sum(c for k, c in run_fwd.items() if k[0] == dims),
            block_errs[dims][0], kf))
        records.append(_record(
            f"emlp_block_backward_{tag}", "emlp_block.cu",
            "gym_rotor_tpu/models/emlp/nn.py:39",
            sum(c for k, c in run_bwd.items() if k[0] == dims),
            block_errs[dims][1], kb))

    # K9 and K11 at the MONO actor, 4096 rows in train mode; in eval mode
    # at the eval path's 10 rows (logged)
    for name, kind, replaces in (
            ("sac_mono_emlp", "gauss", "gym_rotor_tpu/algos/sac.py:114"),
            ("ppo_mono_emlp", "ppo", "gym_rotor_tpu/algos/ppo.py:107")):
        run = runs[name]
        actor = run["agents"][0].bound_actor(run["states"][0])
        o = obs_mono[0]
        noise = torch.randn(B, 4, generator=gen, device=dev)
        timing = actor_timing(actor, o, 0, kind, noise, path=name)
        actor_timing(actor, o[:10], 0, kind, path="eval")
        kname = f"{ACTOR_KERNELS[kind]}_mono"
        records.append(_record(kname, "emlp_actor.cu", replaces,
                               run["launches"].get(ACTOR_KERNELS[kind], 0),
                               actor_errs[kname],
                               [(1, *timing, None)]))

    # the fused MLP PPO actor at 4096 rows on each MLP PPO agent of the
    # runs (their envs); at PPO A's 32, the eval's 10 and 1 row logged
    inst = []
    for name in ("ppo_ctde_mlp", "ppo_mod_mlp", "ppo_mono_mlp"):
        run = runs[name]
        obs = obs_mono if "mono" in name else obs_mod
        for i, (agent, st) in enumerate(zip(run["agents"], run["states"])):
            actor = agent.bound_actor(st)
            nin, nh, A = KM.actor_dims(actor)
            for nb in (B, 32, 10, 1):
                o = obs[i][:nb]
                noise = torch.randn(nb, A, generator=gen, device=dev)
                with torch.no_grad():
                    k_ms, k_wall = device_ms(lambda: actor(o, noise), 100)
                    p_ms, _ = device_ms(
                        lambda: KM.mlp_ppo_actor_plain(actor, o, noise), 50)
                # obs and the draw read, action and log-prob written, the
                # weights read once; per row the three layers' products and
                # sums, biases and relus, and ~12 flops an action of the head
                nbytes = 4 * (nb * (nin + 3 * A)
                              + nin * nh + nh * nh + nh * A + 2 * nh + 2 * A)
                flops = nb * (2 * (nin * nh + nh * nh + nh * A) + 4 * nh
                              + 13 * A)
                bms, by = bound_ms(nbytes, flops)
                if nb == B:
                    inst.append((run["launches"].get("mlp_ppo_actor", 0)
                                 / len(run["agents"]), k_ms, p_ms, bms, by,
                                 None))
                log("kernels", kernel="mlp_ppo_actor", config=name, agent=i,
                    dims=[nin, nh, A], rows=nb, ms=k_ms,
                    wall_ms_per_call=k_wall, plain_ms=p_ms, bytes=nbytes,
                    flops=flops, bound_ms=bms, bound_by=by, library_ms=None)
    records.append(_record("mlp_ppo_actor", "mlp_ppo_actor.cu",
                           "gym_rotor_tpu/algos/ppo.py:107",
                           total.get("mlp_ppo_actor", 0),
                           actor_errs["mlp_ppo_actor"], inst))

    # the fused MLP SAC actor, timed at 4096 rows in phase 20
    # (mlp_sac_actor_checks), weighted by its launches per agent on the MLP
    # SAC runs
    per_agent = {
        ("mod_mlp", 0): 0, ("mod_mlp", 1): 0, ("mono_mlp", 0): 0}
    for name, fam in (("sac_ctde_mlp", "mod_mlp"), ("sac_mod_mlp", "mod_mlp"),
                      ("sac_mono_mlp", "mono_mlp")):
        run = runs[name]
        for i in range(len(run["agents"])):
            per_agent[(fam, i)] += (run["launches"].get("mlp_sac_actor", 0)
                                    / len(run["agents"]))
    inst = [(per_agent[k], *MLP_SAC_ACTOR["inst"][k], None)
            for k in per_agent]
    records.append(_record("mlp_sac_actor", "mlp_sac_actor.cu",
                           "gym_rotor_tpu/algos/sac.py:114",
                           total.get("mlp_sac_actor", 0),
                           MLP_SAC_ACTOR["err"], inst))
    return records


def phase_families(dev):
    """The rest of the learner matrix (phase 21): the new K3/K4, K9, K11
    instances and the fused MLP PPO actor vs their twins; ``train`` at full
    width for
    each of the thirteen configurations of ``FAMILY_CONFIGS`` (exact launch
    counts per superstep, K3/K4 per shape and rows, finite losses, moved
    parameters); ``evaluate`` with the trained actors of the five README
    rows; and the new instances' kernel records."""
    from gym_rotor_tpu_torch.envs.batch import batched_reset
    from gym_rotor_tpu_torch.kernels.emlp_block import (emlp_block,
                                                        emlp_block_backward)
    from gym_rotor_tpu_torch.utils.config import PPO_CONFIGS, Config
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    obs_mod = [o.contiguous() for o in batched_reset(Config(num_envs=B), gen,
                                                     device=dev)[1]]
    obs_mono = [o.contiguous() for o in batched_reset(
        Config(num_envs=B, framework="MONO"), gen, device=dev)[1]]
    block_errs = phase_family_blocks(dev, obs_mod, obs_mono)
    actor_errs = phase_family_actors(dev, obs_mod, obs_mono)
    runs = {}
    for name, kw in FAMILY_CONFIGS:
        algo = kw.get("rl_algo", "TD3")
        if algo == "PPO":
            cfg, launches, shapes, run = phase_train_ppo(
                dev, name, dict(PPO_CONFIGS["B"], **kw), FAMILY_PPO_STEPS)
        else:
            cfg = Config(num_envs=B, start_timesteps=B, **kw)
            train_fn = phase_train if algo == "TD3" else (
                lambda d, c, n, name: phase_train_sac(d, n, False, cfg=c,
                                                      name=name))
            launches, shapes, run = train_fn(dev, cfg, FAMILY_STEPS,
                                             name=f"train_{name}")
        # the train phases clear K3/K4's per-shape counts as they start:
        # what they hold now is this run's
        run.update(cfg=cfg, launches=launches, shapes=shapes,
                   shape_totals=(Counter(emlp_block.by_shape),
                                 Counter(emlp_block_backward.by_shape)))
        runs[name] = run
    for name in RESULTS_ROWS:
        run = runs[name]
        actors = [a.bound_actor(st)
                  for a, st in zip(run["agents"], run["states"])]
        phase_eval(run["cfg"].replace(num_envs=B), dev, actors,
                   name=f"eval_{name}")
    return phase_family_kernels(dev, runs, block_errs, actor_errs, obs_mod,
                                obs_mono)


# ---------------------------------------------------------------------------
# K1's remaining train-path instances: Euler and DOP853, trajectory modes
# 1-6 (7 the clamp), exact_so3
# ---------------------------------------------------------------------------
# the twelve K1 instances (task x integrator x exact_so3) and the
# trajectory mode each one's rollout runs: every mode 1-7 on some instance
TICK_INSTANCES = tuple((fw, integ, exact) for fw in ("MODUL", "MONO")
                       for integ in ("euler", "rk4", "dop853")
                       for exact in (False, True))
ROLLOUT_MODES = dict(zip(TICK_INSTANCES, (1, 2, 3, 4, 5, 6,
                                          7, 1, 6, 5, 2, 4)))
MODES = tuple(range(8))
MODES_PLAIN_TICKS = 3       # plain ticks from the reset to each compare
MODES_TICKS = 200           # ticks of each instance's rollout
MODES_TRAIN_STEPS = 20
MODES_TRAIN = (
    ("train_dop853_mode5", dict(integrator="dop853", train_traj_mode=5)),
    ("train_euler_mode1_exact", dict(framework="MONO", integrator="euler",
                                     train_traj_mode=1, exact_so3=True)))
DRIFT = 1e-4                # attitude drift set on a share of exact envs


def _instance_cfg(fw, integ, exact, mode, n=None):
    from gym_rotor_tpu_torch.utils.config import Config
    return Config(num_envs=n or B, framework=fw, integrator=integ,
                  exact_so3=exact, train_traj_mode=mode)


def _read_masks(cfg, st, out):
    """Per env: whether the tick's read of R passed ``is_rotation`` (the
    obs carries R as read: MONO all of it, MODUL its third column; equal to
    the stored R iff no repair), over the envs whose episode went on."""
    R = st.env.R
    if cfg.framework == "MONO":
        seen = out.info["terminal_obs"][0][:, 9:18]
        stored = R.transpose(1, 2).reshape(-1, 9)
    else:
        seen = out.info["terminal_obs"][0][:, 9:12]
        stored = R[:, :, 2]
    return (seen == stored).all(1), ~out.reset_happened


def _mode_compare(cfg, dev, n, env_type, gen):
    """One K1 instance and mode: the reset entry vs plain, then after
    MODES_PLAIN_TICKS plain ticks one kernel tick and one plain tick on the
    same state, actions and draws, with ~10% of envs at the cap, in modes 2,
    3, 5, 6 (and 7) ~30% of machines half a tick before their planned end
    (the tick crosses into the hold or the landing), and under exact_so3
    ~20% of attitudes drifted by DRIFT (the tick's reads repair them).
    Returns the worst error, the discrete mismatches near a threshold, the
    exact_so3 mask disagreements on the read of the stepped attitude (the
    kernel's mask inferred from its obs; the work attitude's read shows in
    the stepped state, held to the tolerance), the repaired reads (both),
    the resets and the machines in manual mode after the tick."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    from gym_rotor_tpu_torch.ops import so3
    actions, uniforms = _tick_inputs(cfg, dev, n, gen)
    what = f"{K.instance(cfg)} mode {cfg.train_traj_mode} {env_type}"
    st, _, bad, worst = _reset_vs_plain(cfg, uniforms(), env_type, dev)
    if bad:
        raise AssertionError(f"{what}: reset disagrees: {bad}")
    for _ in range(MODES_PLAIN_TICKS):
        st, _ = K.env_tick_plain(cfg, st, actions(), uniforms(), env_type)
    if cfg.train_traj_mode in (2, 3, 5, 6, 7):
        late = torch.rand(n, generator=gen, device=dev) < 0.3
        st.traj.started[late] = True
        st.traj.t[late] = st.traj.t_traj[late] - 0.5 * (1.0 / 200)
    if cfg.exact_so3:
        drift = torch.rand(n, generator=gen, device=dev) < 0.2
        st.env.R[drift] += DRIFT * torch.randn(int(drift.sum()), 3, 3,
                                               generator=gen, device=dev)
    idx = torch.randperm(n, generator=gen, device=dev)[: max(1, n // 10)]
    st.env.t[idx] = cfg.max_steps - 1
    # the tick's first read of R (the work attitude) repairs these envs
    work_repairs = int((~so3.is_rotation(st.env.R)).sum()) \
        if cfg.exact_so3 else 0
    c = _tick_vs_plain(cfg, st, actions(), uniforms(), env_type, dev)
    if c["unexplained"] or c["bad"]:
        raise AssertionError(
            f"{what}: {c['unexplained']} envs, fields {c['bad']}: "
            f"{ {b: c['errs'][b] for b in c['bad']} }")
    mask_diff = repaired = 0
    if cfg.exact_so3:
        # the kernel's read masks, inferred from its obs, against the
        # plain twin's is_rotation on the same stored attitudes
        seen_k, kept = _read_masks(cfg, c["st_k"], c["out_k"])
        mask_p = so3.is_rotation(c["st_p"].env.R)
        seen_p, _ = _read_masks(cfg, c["st_p"], c["out_p"])
        keep = kept & ~c["mismatch"]
        mask_diff = int(((seen_k != mask_p) & keep).sum())
        repaired = work_repairs + int((~mask_p & keep).sum())
        if mask_diff or bool(((seen_p != mask_p) & keep).any()):
            raise AssertionError(f"{what}: exact_so3 mask differs in "
                                 f"{mask_diff} envs")
    return (max(worst, c["err"]), int(c["mismatch"].sum()),
            int(c["near"].sum()), mask_diff, repaired,
            int(c["out_p"].reset_happened.sum()),
            int(c["st_p"].traj.manual_mode.sum()))


def phase_tick_modes_compare(dev):
    """K1 vs its plain twin for the twelve instances in modes 0-7, at
    B = 4096 train envs and the eval path's 10 eval envs.  Returns the
    worst error per instance."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    worst = {}
    for fw, integ, exact in TICK_INSTANCES:
        name = K.instance(_instance_cfg(fw, integ, exact, 0))
        rows = []
        for mode in MODES:
            t0 = time.perf_counter()
            big = _mode_compare(_instance_cfg(fw, integ, exact, mode), dev, B,
                                "train", gen)
            small = _mode_compare(_instance_cfg(fw, integ, exact, mode, 10),
                                  dev, 10, "eval", gen)
            worst[name] = max(worst.get(name, 0.0), big[0], small[0])
            rows.append([mode, max(big[0], small[0]), big[1] + small[1],
                         big[2] + small[2], big[3] + small[3],
                         big[4] + small[4], big[5], big[6],
                         round(time.perf_counter() - t0, 3)])
        log("env_tick_modes", instance=name, envs=[B, 10],
            tolerance="1e-6 + 1e-5 |plain|, discrete identical",
            max_abs_err=worst[name],
            columns=["mode", "max_abs_err", "discrete_mismatch_near_threshold",
                     "near_threshold_envs", "mask_mismatch_envs",
                     "repaired_reads", "resets", "manual_after", "s"],
            modes=rows)
    return worst


def phase_tick_rollouts(dev):
    """``rollout`` through each of the twelve instances: 4096 train envs x
    MODES_TICKS ticks, both EMLP actors through K3, in the instance's
    ROLLOUT_MODES mode; exact launch counts per instance, the SO(3) check
    on R as read (under exact_so3 the stored R drifts and the read repairs
    it), rewards in range, env-steps/s.  Returns per instance its launches,
    a state, actions and draws for the timing."""
    from gym_rotor_tpu_torch.envs import draws as D
    from gym_rotor_tpu_torch.envs.batch import batched_reset, rollout
    from gym_rotor_tpu_torch.evaluate import joint_policy
    from gym_rotor_tpu_torch.kernels.emlp_actor import emlp_actor
    from gym_rotor_tpu_torch.kernels import env_tick as K
    from gym_rotor_tpu_torch.models.emlp.zoo import make_actors
    from gym_rotor_tpu_torch.ops import so3
    out = {}
    for inst in TICK_INSTANCES:
        cfg = _instance_cfg(*inst, ROLLOUT_MODES[inst])
        name = K.instance(cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED + 23)
        actors = make_actors(cfg, device=dev, seed=SEED)
        bs, obs = batched_reset(cfg, gen, device=dev)
        policy = joint_policy(actors)
        torch.cuda.synchronize()
        K.env_tick.launches = 0
        K.env_tick.by_instance.clear()
        emlp_actor.launches = 0
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        bs, obs, trs, outs = rollout(cfg, bs, obs, policy, MODES_TICKS, gen)
        e.record()
        torch.cuda.synchronize()
        launches = {"env_tick": K.env_tick.launches,
                    "emlp_actor": emlp_actor.launches}
        by_inst = dict(K.env_tick.by_instance)
        ms = s.elapsed_time(e)
        R = so3.ensure_so3_exact(bs.env.R) if cfg.exact_so3 else bs.env.R
        eye = torch.eye(3, device=dev)
        ortho = float((so3.mm3(R.transpose(-1, -2), R) - eye).abs().max())
        drift = float((so3.mm3(bs.env.R.transpose(-1, -2), bs.env.R)
                       - eye).abs().max())
        r = outs.reward
        r_ok = bool((((r >= 0) & (r <= 1)) | (r == -1)).all())
        finite = all(bool(torch.isfinite(t).all()) for t in
                     (r, *outs.obs, bs.env.x, bs.env.R))
        log(f"rollout_{name}", mode=cfg.train_traj_mode, envs=B,
            ticks=MODES_TICKS, launches=launches, by_instance=by_inst,
            env_steps_per_s=B * MODES_TICKS / (ms / 1e3), rollout_ms=ms,
            max_RtR_minus_I_read=ortho, max_RtR_minus_I_stored=drift,
            rewards_in_range=r_ok, finite=finite,
            episodes_ended=int(outs.reset_happened.sum()),
            manual_mode_envs=int(bs.traj.manual_mode.sum()), card=CARD)
        want = {"env_tick": MODES_TICKS,
                "emlp_actor": cfg.n_agents * MODES_TICKS}
        if launches != want or by_inst != {name: MODES_TICKS}:
            raise AssertionError(f"rollout_{name} launch counts {launches} "
                                 f"{by_inst}")
        # is_rotation's tolerance bounds a read that passed unrepaired
        if not (ortho < 2e-5 and r_ok and finite):
            raise AssertionError(f"rollout_{name} invariants failed")
        a = policy(obs)
        out[name] = dict(cfg=cfg, launches=MODES_TICKS, state=bs, actions=a,
                         draws=D.draw_uniforms(B, gen, torch.float32, dev))
    return out


def env_tick_resources(K):
    """Per K1 instance, from ``-Xptxas -v``'s output of the env_tick build:
    registers, spill stores / loads, stack bytes and static shared memory
    of its tile kernel (the tick entry; the batched tasks) and of its
    thread kernel (the step and reset entries)."""
    import re
    names = {v: k for k, v in K.TASKS.items()}
    integs = {v: k for k, v in K.INTEGRATORS.items()}
    out, cur = {}, None
    for ln in K.KERNEL.ptxas.splitlines():
        m = re.search(r"env_(tile|thread)_kernelILi(\d+)ELi(\d+)ELb([01])E", ln)
        if "Compiling entry function" in ln and m:
            inst = (f"{names[int(m.group(2))]}_{integs[int(m.group(3))]}"
                    + ("_exact" if m.group(4) == "1" else ""))
            cur = out.setdefault(inst, {}).setdefault(m.group(1), {})
        elif cur is not None and "spill stores" in ln:
            n = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            cur.update(stack=n[0], spill_stores=n[1], spill_loads=n[2])
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def replay_resources():
    """Registers, spills and static shared memory of K2 + K8's kernels
    (``-Xptxas -v``), per kernel."""
    import re
    from gym_rotor_tpu_torch.kernels import replay as KR
    out, cur = {}, None
    for ln in KR.KERNEL.ptxas.splitlines():
        m = re.search(r"(insert_kernel|gather_kernel)", ln)
        if "Compiling entry function" in ln and m:
            cur = out.setdefault(m.group(1), {})
        elif cur is not None and "spill stores" in ln:
            n = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            cur.update(spill_stores=n[1], spill_loads=n[2])
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def phase_tick_modes(dev):
    """Phase 22: K1's Euler, DOP853, modes 1-7 and exact_so3 instances.
    The registers and spills ``-Xptxas -v`` reported per instance; every
    instance vs its plain twin in modes 0-7 (``env_tick_modes``); a
    rollout through each instance (``rollout_<instance>``); ``train`` at
    full width with DOP853 in mode 5 (Mod-EMLP) and with Euler, mode 1 and
    exact_so3 (Mono-EMLP), 1 warm + MODES_TRAIN_STEPS supersteps each,
    checked as phase 12; ``evaluate`` with the first run's actors in mode 6
    (``eval_modes``); one kernel record per instance."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    from gym_rotor_tpu_torch.utils.config import Config
    log("env_tick_modes", ptxas=env_tick_resources(K))
    worst = phase_tick_modes_compare(dev)
    rolls = phase_tick_rollouts(dev)
    launches = Counter({name: r["launches"] for name, r in rolls.items()})
    runs = {}
    for name, kw in MODES_TRAIN:
        cfg = Config(num_envs=B, start_timesteps=B, **kw)
        K.env_tick.by_instance.clear()
        run_launches, _, run = phase_train(dev, cfg, MODES_TRAIN_STEPS,
                                           name=name)
        by_inst = dict(K.env_tick.by_instance)
        if by_inst != {K.instance(cfg): run_launches["env_tick"]}:
            raise AssertionError(f"{name}: K1 instances {by_inst}")
        launches.update(by_inst)
        runs[name] = (cfg, run)
    cfg, run = runs["train_dop853_mode5"]
    actors = [a.bound_actor(st) for a, st in zip(run["agents"], run["states"])]
    eval_cfg = cfg.replace(train_traj_mode=6)
    K.env_tick.by_instance.clear()
    phase_eval(eval_cfg, dev, actors, name="eval_modes")
    launches.update(K.env_tick.by_instance)
    records = []
    for name, r in rolls.items():
        k_ms, p_ms, bms, by = tick_timing(r["cfg"], dev, r,
                                          kernel=f"env_tick_{name}")
        records.append(dict(
            name=f"env_tick_{name}", route="cuda",
            source="gym_rotor_tpu_torch/kernels/csrc/env_tick.cu",
            replaces="gym_rotor_tpu/envs/batch.py:75",
            launches=launches[name], max_abs_err=worst[name], ms=k_ms,
            plain_ms=p_ms, bound_ms=bms, bound_by=by, library_ms=None))
    return records


# ---------------------------------------------------------------------------
# The Gym API and the reference eval stream: K1's quad task and step entry
# ---------------------------------------------------------------------------
STEP_TASKS = {"quad": "MONO", "coupled": "MONO", "decoupled": "MODUL"}
STEP_INSTANCES = tuple((task, integ) for task in STEP_TASKS
                       for integ in ("euler", "rk4", "dop853"))
GYM_STEPS = 1000
# every Gym env with the reference's default DOP853 and one Euler config;
# Quad-v0 also with RK4, so that each quad instance runs on this path
GYM_RUNS = (("Quad-v0", "dop853"), ("Quad-v0", "euler"), ("Quad-v0", "rk4"),
            ("Coupled-v0", "dop853"), ("Coupled-v0", "euler"),
            ("Decoupled-v0", "dop853"), ("Decoupled-v0", "euler"))
GYM_GOAL = ([0.1, -0.1, -0.05], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0], [0.0, 0.0, 0.0])


def _step_cfg(task, integ, n):
    from gym_rotor_tpu_torch.utils.config import Config
    return Config(num_envs=n, framework=STEP_TASKS[task], integrator=integ,
                  exact_so3=True)


def _step_states(cfg, n, gen, dev):
    """``n`` float32 envs for the step entry: random train resets with a
    goal each, then (n > 1) shares of ~10% with x past its limit, ~10% v
    past its, ~10% a roll and ~10% a pitch of 85.5-89 degrees, ~5% the
    singular branch of ``rot_to_euler`` (pitch 90 degrees), and ~20% of the
    rest with the attitude drifted by DRIFT (the exact repair runs)."""
    from gym_rotor_tpu_torch.envs import draws as D
    from gym_rotor_tpu_torch.envs.batch import batched_reset_plain
    from gym_rotor_tpu_torch.ops import so3
    st, _ = batched_reset_plain(cfg, D.draw_uniforms(n, gen, torch.float32,
                                                     dev), "train")
    e = st.env
    th = torch.rand(n, generator=gen, device=dev) * 2 * math.pi
    e.goal.xd.copy_(0.2 * torch.randn(n, 3, generator=gen, device=dev))
    e.goal.vd.copy_(0.05 * torch.randn(n, 3, generator=gen, device=dev))
    e.goal.b1d.copy_(torch.stack([th.cos(), th.sin(), 0 * th], -1))
    drift = torch.rand(n, generator=gen, device=dev) < 0.2
    if n > 1:
        idx = torch.randperm(n, generator=gen, device=dev)
        k = n // 10
        crash_x, crash_v = idx[:k], idx[k:2 * k]
        e.x[crash_x, 0] = 1.0 + 0.05 * torch.rand(k, generator=gen, device=dev)
        e.v[crash_v, 1] = -4.0 - 0.1 * torch.rand(k, generator=gen, device=dev)
        e.goal.xd[crash_x] = 0.0
        e.goal.vd[crash_v] = 0.0
        deg = (85.5 + 3.5 * torch.rand(k, generator=gen, device=dev)) \
            * (math.pi / 180)
        z = torch.zeros(k, device=dev)
        e.R[idx[2 * k:3 * k]] = so3.euler_to_rot(torch.stack([deg, z, th[:k]], -1))
        e.R[idx[3 * k:4 * k]] = so3.euler_to_rot(torch.stack([z, -deg, th[:k]], -1))
        h = k // 2
        e.R[idx[4 * k:4 * k + h]] = so3.euler_to_rot(torch.stack(
            [z[:h], torch.full((h,), math.pi / 2, device=dev), th[:h]], -1))
        drift[idx[:4 * k + h]] = False
    e.R[drift] += DRIFT * torch.randn(int(drift.sum()), 3, 3, generator=gen,
                                      device=dev)
    return st


def _step_near(task, e, out):
    """Envs whose done decides within a few ulp of a limit, from the
    stepped batched env ``e`` and the step's output: the quad task's |x|,
    |v|, |W| and the roll / pitch of R as read (85 degrees, 1e-4 degree),
    the wrappers' |obs| >= 1 columns (1e-5)."""
    from gym_rotor_tpu_torch.ops import so3
    if task == "quad":
        lim = [(e.x, 1.0), (e.v, 4.0), (e.W, 2 * math.pi)]
        near = torch.zeros(e.x.shape[0], dtype=torch.bool, device=e.x.device)
        for v, l in lim:
            near |= ((v.abs() - l).abs() <= 8 * l * F32_EPS).any(1)
        eul = so3.rot_to_euler(so3.ensure_so3_exact(e.R))[:, :2] * (180 / math.pi)
        return near | ((eul.abs() - 85.0).abs() < 1e-4).any(1)
    if task == "decoupled":
        o1, o2 = out.obs
        crash = torch.cat([o1[:, 0:3], o1[:, 6:9], o1[:, 12:15], o2[:, 2:3]], 1)
    else:
        (o,) = out.obs
        crash = torch.cat([o[:, 0:3], o[:, 6:9], o[:, 20:23]], 1)
    return ((crash.abs() - 1.0).abs() < 1e-5).any(1)


def _step_vs_plain(cfg, task, st, a, dev):
    """One launch of K1's step entry and one plain step on the same env
    and actions: discrete fields equal except in envs near a limit, the
    rest within K1's tolerance over the envs whose discrete fields agree;
    the goal and the parameters, which the entry must not write, bit for
    bit."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    n = a.shape[0]
    st_k, out_k = K.env_step(cfg, st.env, a, task)
    st_p, out_p = K.env_step_plain(cfg, st.env, a, task)
    named = []
    for s, o in ((st_k, out_k), (st_p, out_p)):
        d = _named(s)
        d.update({"reward": o.reward, "done": o.done, "info.ex": o.info["ex"],
                  "info.eb1": o.info["eb1"]})
        for j, ob in enumerate(o.obs):
            d[f"obs{j + 1}"] = ob
        named.append(d)
    nk, np_ = named
    near = _step_near(task, st_p, out_p) | _step_near(task, st_k, out_k)
    mismatch = torch.zeros(n, dtype=torch.bool, device=dev)
    for path, p in np_.items():
        if not p.is_floating_point():
            mismatch |= (nk[path] != p).reshape(n, -1).any(1)
    errs, bad, err = _field_errors(nk, np_, mismatch)
    copied = [p for p in nk if p.startswith(("state.goal.", "state.params."))
              and not torch.equal(nk[p], np_[p])]
    return dict(err=err, errs=errs, bad=bad + copied, near=int(near.sum()),
                mismatch=int(mismatch.sum()),
                unexplained=int((mismatch & ~near).sum()),
                done=int(out_p.done.any(-1).sum()))


# What K1's step entry reads and writes of an env (env_tick.cu step_only):
# the state, the goal but b1d_dot, the parameters quad.step uses (the quad
# task's forces_to_fM besides), the integrals where the task updates them.
STEP_READS = ("x", "v", "R", "W", "goal.xd", "goal.vd", "goal.b1d", "goal.Wd",
              "params.m", "params.J", "params.scale_act", "params.avrg_act",
              "params.min_force", "params.max_force", "t")
STEP_WRITES = ("x", "v", "R", "W", "f_total", "M", "t")
STEP_INTEGRALS = ("eIx", "eIx_integrand", "eIb1", "eIb1_integrand")


def step_bytes(task, n):
    """The bytes K1's step entry must move for ``n`` envs of ``task``: each
    env field it reads once and each it writes once (``STEP_READS``,
    ``STEP_WRITES``), the actions and its output slots."""
    from gym_rotor_tpu_torch.kernels import env_tick as KT
    width = {path: (w, dt.itemsize) for dt, fields in KT.layout().items()
             for path, _, w, _ in fields}
    reads, writes = list(STEP_READS), list(STEP_WRITES)
    if task == "quad":
        reads.append("params.forces_to_fM")
    else:
        reads += STEP_INTEGRALS
        writes += STEP_INTEGRALS
    per_env = sum(width["env." + p][0] * width["env." + p][1]
                  for p in reads + writes)
    per_env += KT.ACT_DIM[task] * 4 + KT.out_width(task, "F", True) * 4 \
        + KT.out_width(task, "B", True)
    return n * per_env


def _fresh_calls(bufs, n, rounds=5):
    """``device_ms(fn, n, rounds)``'s calls of the in-place step entry, each
    on its own copy of ``bufs``, so that every timed launch steps the same
    env as the bound counts (and the copies are not L2-resident at 4096)."""
    copies = iter([tuple(b.clone() for b in bufs)
                   for _ in range(1 + n * (1 + rounds))])
    return lambda: next(copies)


def step_timing(cfg, task, dev, st, a):
    """K1's step entry on ``st``'s env: device time per launch (each on a
    fresh copy: the entry runs in place), the plain twin's, and the bound:
    ``step_bytes``; the plain step's flops per env (counted on the CPU)
    less the 6-step polar repair of every read of R that passes
    ``is_rotation`` (the kernel runs it only where a read fails; two reads
    a step)."""
    from gym_rotor_tpu_torch.envs import draws as D
    from gym_rotor_tpu_torch.envs.batch import batched_reset_plain
    from gym_rotor_tpu_torch.kernels import env_tick as KT
    from gym_rotor_tpu_torch.ops import so3
    n = a.shape[0]
    fresh = _fresh_calls(KT.pack_env(st.env), 100)
    k_ms, k_wall = device_ms(
        lambda: KT.env_step_bufs(cfg, fresh(), a, task), 100)
    p_ms, p_wall = device_ms(
        lambda: KT.env_step_plain(cfg, st.env, a, task), 5, 3)
    env_p, _ = KT.env_step_plain(cfg, st.env, a, task)
    nbytes = step_bytes(task, n)
    cpu_cfg = cfg.replace(num_envs=1)
    st1, _ = batched_reset_plain(cpu_cfg, torch.rand(1, D.N_DRAWS))
    per_env = count_flops(KT.env_step_plain, cpu_cfg, st1.env,
                          torch.zeros(1, a.shape[1]), task)
    polar6 = count_flops(so3.polar_fast, torch.eye(3)[None], 6)
    passed = (int(so3.is_rotation(st.env.R).sum())
              + int(so3.is_rotation(env_p.R).sum()))
    flops = n * per_env - passed * polar6
    bms, by = bound_ms(nbytes, flops)
    return dict(batch=n, ms=k_ms, wall_ms_per_call=k_wall, plain_ms=p_ms,
                plain_wall_ms=p_wall, bytes=nbytes, flops_per_env=per_env,
                reads_passed=passed, flops=flops, bound_ms=bms, bound_by=by)


def phase_step_compare(dev):
    """(a) and (b): each K1 step instance (quad x integrator, exact_so3;
    coupled and decoupled exact_so3) vs its plain twin at B = 4096 and
    B = 1 on ``_step_states``; then its timings at both sizes.  Returns
    per instance the worst error and the timings."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    out = {}
    for task, integ in STEP_INSTANCES:
        name = K.instance(_step_cfg(task, integ, 1), task)
        worst, timing = 0.0, {}
        for n in (B, 1):
            cfg = _step_cfg(task, integ, n)
            st = _step_states(cfg, n, gen, dev)
            a = 0.3 * torch.randn(n, K.ACT_DIM[task], generator=gen,
                                  device=dev)
            c = _step_vs_plain(cfg, task, st, a, dev)
            worst = max(worst, c["err"])
            log("gym_step", instance=name, envs=n, done_envs=c["done"],
                near_limit_envs=c["near"],
                discrete_mismatch_envs=c["mismatch"],
                unexplained_mismatch_envs=c["unexplained"],
                max_abs_err=c["err"], fields=c["errs"],
                tolerance="1e-6 + 1e-5 |plain|, discrete identical "
                          "outside a few ulp of a limit, goal and parameters "
                          "untouched")
            if c["unexplained"] or c["bad"]:
                raise AssertionError(f"step entry {name} at B = {n}: "
                                     f"{c['unexplained']} envs, {c['bad']}")
            timing[n] = step_timing(cfg, task, dev, st, a)
        log("kernels", kernel=f"env_step_{name}", at_1=timing[1],
            at_4096=timing[B])
        out[name] = dict(err=worst, timing=timing)
    return out


def _hover_actions(env, n, rng):
    """Near-hover actions with small noise (the thrust channel at hover;
    per motor for Quad-v0)."""
    import numpy as np
    a = rng.uniform(-0.05, 0.05, (n, env._action_dim()))
    hover = (env.hover_force - env.avrg_act) / env.scale_act
    if env.task == "quad":
        a += hover
    else:
        a[:, 0] += hover
    return a


def _flat(step_out):
    """A Gym ``step``'s obs, reward and done as flat float64 arrays."""
    import numpy as np
    obs, rew, done = step_out[:3]
    obs = np.concatenate([np.ravel(o) for o in
                          (obs if isinstance(obs, list) else [obs])])
    return obs.astype(np.float64), np.ravel(rew).astype(np.float64), \
        np.ravel(done)


def _gym_start(e):
    """set_seed, reset, get_norm_error_state and set_goal_state; returns
    the reset state and the first obs."""
    from gym_rotor_tpu_torch.utils.seeding import set_seed
    set_seed(e, SEED + 31)
    s0 = e.reset()
    o0 = e.get_norm_error_state()
    e.set_goal_state(*GYM_GOAL)
    return s0, o0


def _gym_compare(env, cpu, acts, outs):
    """The card's run (``outs``) against the CPU's plain path, on a second
    card run from the same reset whose outputs must equal ``outs`` bit for
    bit: the CPU's Gym env runs free alongside until the first done; every
    later step (the Gym API does not auto-reset, so a crashed env keeps
    integrating) is held to one batched plain step from the card's state
    before it.  obs and reward within K1's tolerance and finite, done
    identical except within a few ulp of a limit (``_step_near``).  Returns
    the worst error, the steps compared free and from the card's state, the
    first done and the faults."""
    import numpy as np
    from gym_rotor_tpu_torch.kernels import env_tick as K
    from gym_rotor_tpu_torch.utils.tree import tree_map
    firsts = [_gym_start(e) for e in (env, cpu)]
    worst = max(float(np.abs(firsts[0][0] - firsts[1][0]).max()),
                max(float(np.abs(a - b).max()) for a, b in
                    zip(firsts[0][1], firsts[1][1])))
    first_done, before, cards, bad = None, [], [], []

    def check(k, g, c, near):
        nonlocal worst
        for j, what in enumerate(("obs", "reward")):
            d = np.abs(g[j] - c[j])
            worst = max(worst, float(d.max()))
            if np.any(d > 1e-6 + 1e-5 * np.abs(c[j])) \
                    or not np.isfinite(g[j]).all():
                bad.append((k, what, float(d.max())))
        if not np.array_equal(g[2], c[2]) and not near:
            bad.append((k, "done", g[2].tolist(), c[2].tolist()))

    for k, a in enumerate(acts):
        if first_done is not None:
            before.append(tree_map(lambda t: t[None].clone(), env._env))
        g = _flat(env.step(a))
        if not all(np.array_equal(x, y) for x, y in zip(g, _flat(outs[k]))):
            bad.append((k, "card rerun differs"))
        if first_done is not None:
            cards.append(g)
            continue
        check(k, g, _flat(cpu.step(a)), False)
        if g[2].any():
            first_done = k
    if first_done is None:
        return worst, len(acts), 0, None, bad
    # the steps after the first done: one plain step over all their states
    n = len(cards)
    st = tree_map(lambda *ts: torch.cat(ts).cpu(), *before)
    a = torch.as_tensor(np.asarray(acts[first_done + 1:], np.float64),
                        dtype=torch.float32)
    st_p, out_p = K.env_step_plain(env.cfg, st, a, env.task)
    near = _step_near(env.task, st_p, out_p)
    obs = torch.cat(out_p.obs, 1).double().numpy()
    rew = out_p.reward.double().numpy()
    done = out_p.done.numpy()
    for j in range(n):
        check(first_done + 1 + j, cards[j], (obs[j], rew[j], done[j]),
              bool(near[j]))
    return worst, first_done + 1, n, first_done, bad


def phase_gym(dev):
    """(c): each Gym env from ``make`` on the card (GYM_RUNS): set_seed,
    reset, get_norm_error_state, set_goal_state, GYM_STEPS near-hover
    steps; exactly one launch of K1's step entry per step and no other K1
    launch; wall ms per step and device us per launch (B = 1); every step
    held to the CPU's plain path in float32 (``_gym_compare``).  Returns
    the launches per instance."""
    import numpy as np
    from gym_rotor_tpu_torch import make
    from gym_rotor_tpu_torch.kernels import env_tick as K
    from gym_rotor_tpu_torch.utils.config import Config
    launches = Counter()
    for env_id, integ in GYM_RUNS:
        cfg = Config(framework="MONO", integrator=integ)
        env, cpu = make(env_id, cfg=cfg), make(env_id, cfg=cfg, device="cpu")
        _gym_start(env)
        acts = _hover_actions(env, GYM_STEPS, np.random.default_rng(SEED))
        torch.cuda.synchronize()
        K.env_step.launches = K.env_tick.launches = 0
        K.env_step.by_instance.clear()
        t0 = time.perf_counter()
        outs = [env.step(a) for a in acts]
        wall = (time.perf_counter() - t0) / GYM_STEPS * 1e3
        n_launch, by_inst = K.env_step.launches, dict(K.env_step.by_instance)
        inst = K.instance(env.cfg, env.task)
        if (n_launch, K.env_tick.launches, by_inst) != \
                (GYM_STEPS, 0, {inst: GYM_STEPS}):
            raise AssertionError(f"{env_id} {integ}: launches {n_launch}, "
                                 f"{by_inst}, K1 tick {K.env_tick.launches}")
        launches.update(by_inst)
        a1 = torch.as_tensor(acts[-1], dtype=torch.float32,
                             device=dev)[None].contiguous()
        fresh = _fresh_calls(env._bufs, 200)
        d_ms, d_wall = device_ms(
            lambda: K.env_step_bufs(env.cfg, fresh(), a1, env.task), 200)
        worst, free, forced, first_done, bad = _gym_compare(env, cpu, acts,
                                                            outs)
        log("gym_api", env=env_id, integrator=integ, instance=inst,
            steps=GYM_STEPS, launches=n_launch, compared_free=free,
            compared_from_card_state=forced, first_done_step=first_done,
            max_abs_err=worst, tolerance="1e-6 + 1e-5 |cpu|, finite, done "
            "identical outside a few ulp of a limit, card rerun bitwise",
            wall_ms_per_step=wall, device_us_per_launch=d_ms * 1e3,
            launch_wall_us=d_wall * 1e3, card=CARD)
        if bad:
            raise AssertionError(f"{env_id} {integ}: card vs CPU {bad[:5]}")
        env.close()
    return launches


def lift_timing(cfg, n, dev):
    """The reference eval's lift alone (``batched_reset_reference``, plain
    torch by design): device ms per call (the profiler's kernel and copy
    time) and host wall ms, beside its bound: the bytes it must move, the
    replayed x, v, R, W and b1d copied up once and the state and obs
    written once."""
    from gym_rotor_tpu_torch.envs.ref_stream import batched_reset_reference
    from gym_rotor_tpu_torch.evaluate import EVAL_SEED
    from gym_rotor_tpu_torch.utils.tree import tree_named_leaves

    def lift():
        return batched_reset_reference(cfg.replace(num_envs=n), EVAL_SEED,
                                       device=dev)
    ms, wall = kernel_ms(lift, 20)
    st, obs = lift()
    out = [t for _, t in tree_named_leaves(st)] + list(obs)
    nbytes = 4 * n * (3 + 3 + 9 + 3 + 3) + sum(
        t.numel() * t.element_size() for t in out
        if isinstance(t, torch.Tensor))
    bms, by = bound_ms(nbytes, 0)
    log("kernels", kernel="reference_lift", envs=n, ms=ms,
        wall_ms_per_call=wall, bytes=nbytes, bound_ms=bms, bound_by=by,
        library_ms=None)


def phase_ref_eval(dev):
    """(d): ``evaluate(eval_stream="reference", save_log=True)`` with the
    flagship's seeded EMLP actors: the replayed inits equal the lifted
    state before the float32 cast, K1's tick once and K3 twice a tick and
    no reset launch, rows (ticks, 5 + 35) all finite."""
    import numpy as np
    from gym_rotor_tpu_torch.envs.quad import DT
    from gym_rotor_tpu_torch.envs.ref_stream import (batched_reset_reference,
                                                     reference_eval_inits)
    from gym_rotor_tpu_torch.evaluate import EVAL_SEED, evaluate
    from gym_rotor_tpu_torch.kernels import env_tick as K
    from gym_rotor_tpu_torch.models.emlp.zoo import make_actors
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config(num_envs=B, eval_stream="reference", save_log=True)
    actors = make_actors(cfg, device=dev, seed=SEED)
    n, ticks = cfg.num_eval, int(round(cfg.eval_max_steps / DT))
    inits = reference_eval_inits(n, EVAL_SEED)
    bs, _ = batched_reset_reference(cfg.replace(num_envs=n), EVAL_SEED,
                                    device=dev)
    lift_timing(cfg, n, dev)
    for k, t in (("x", bs.env.x), ("v", bs.env.v), ("R", bs.env.R),
                 ("W", bs.env.W), ("b1d", bs.traj.b1d)):
        want = torch.as_tensor(inits[k], dtype=torch.float32).to(dev)
        if not torch.equal(t, want):
            raise AssertionError(f"reference lift: {k} is not the replayed "
                                 "init rounded once")
    wr = _wrappers()
    torch.cuda.synchronize()
    for w in wr.values():
        w.launches = 0
    K.env_tick.by_instance.clear()
    t0 = time.perf_counter()
    ep, bench, succ, ex, eb1, rows = evaluate(cfg, actors, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: w.launches for k, w in wr.items() if w.launches}
    log("eval_reference", envs=n, ticks=ticks, launches=launches,
        by_instance=dict(K.env_tick.by_instance),
        mean_episode_reward=[float(x) for x in ep],
        benchmark_reward=float(bench), success=[int(x) for x in succ.sum(0)],
        rows=list(rows.shape), rows_finite=bool(torch.isfinite(rows).all()),
        eval_ms=ms, card=CARD)
    want = {"env_tick": ticks, "emlp_actor": 2 * ticks}
    if launches != want or dict(K.env_tick.by_instance) != {K.instance(cfg): ticks}:
        raise AssertionError(f"eval_reference launch counts {launches}")
    if tuple(rows.shape) != (ticks, 5 + 35) or not torch.isfinite(rows).all():
        raise AssertionError(f"eval_reference rows {tuple(rows.shape)}")
    if not np.isfinite([float(x) for x in ep] + [float(bench)]).all():
        raise AssertionError("eval_reference produced non-finite rewards")
    return ticks


def phase_gym_api(dev):
    """Phase 23: the Gym API and the reference eval stream.  The quad
    instances' registers and spills and env_tick's build time; (a)/(b) the
    step instances vs their twin (``phase_step_compare``); (c) the three
    Gym envs on the card vs the CPU (``phase_gym``); (d) the reference eval
    (``phase_ref_eval``); (e) one kernel record per quad instance and one
    for the step entry of the coupled and decoupled exact_so3 instances,
    launch-weighted, with their times at B = 1 (the Gym API's) and 4096."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    res = env_tick_resources(K)
    log("gym_step", env_tick_nvcc_s=K.KERNEL.build_seconds,
        ptxas={k: v for k, v in res.items() if k.endswith("_exact")})
    cmp = phase_step_compare(dev)
    launches = phase_gym(dev)
    phase_ref_eval(dev)
    src = "env_tick.cu"
    replaces = "gym_rotor_tpu/envs/gym_api.py:74"

    def inst(name, n, w):
        t = cmp[name]["timing"][n]
        return (w, t["ms"], t["plain_ms"], t["bound_ms"], t["bound_by"], None)
    records = []
    for task, integ in STEP_INSTANCES:
        name = K.instance(_step_cfg(task, integ, 1), task)
        if task != "quad":
            continue
        if not launches[name]:
            raise AssertionError(f"{name} was not launched on the Gym path")
        rec = _record(f"env_step_{name}", src, replaces, launches[name],
                      cmp[name]["err"], [inst(name, 1, 1)])
        big = cmp[name]["timing"][B]
        rec.update(ms_4096=big["ms"], plain_ms_4096=big["plain_ms"],
                   bound_ms_4096=big["bound_ms"], bound_by_4096=big["bound_by"])
        records.append(rec)
    wrap = [K.instance(_step_cfg(t, i, 1), t) for t, i in STEP_INSTANCES
            if t != "quad"]
    rec = _record("env_step", src, replaces,
                  sum(launches[w] for w in wrap),
                  max(cmp[w]["err"] for w in wrap),
                  [inst(w, 1, launches[w]) for w in wrap])
    big = _record("env_step", src, replaces, 0, 0.0,
                  [inst(w, B, launches[w]) for w in wrap])
    rec.update(ms_4096=big["ms"], plain_ms_4096=big["plain_ms"],
               bound_ms_4096=big["bound_ms"], bound_by_4096=big["bound_by"])
    records.append(rec)
    return records


# ---------------------------------------------------------------------------
# K1 and K2 + K8 at the row counts around their tiles (32 envs a tile)
# ---------------------------------------------------------------------------
TILE_ROWS = (1, 31, 32, 33, B)


def _bitwise(xs, ys):
    """Every tensor of ``xs`` equal to ``ys``'s bit for bit."""
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
        for x, y in zip(xs, ys))


def _k1_rows_instance(kw, task, n, dev, gen):
    """One K1 instance at ``n`` envs: its reset entry vs plain, a tick vs
    plain from a state three plain ticks on with ~25% of envs at the cap
    (under exact_so3 ~30% of attitudes drifted), its rerun bit for bit, and
    its step entry vs plain on ``_step_states`` with a rerun.  Returns the
    worst error and the tick's over / continuing envs."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config(num_envs=n, train_traj_mode=3 if kw["exact_so3"] else 0, **kw)
    name = K.instance(cfg, task)
    worst, rec = 0.0, dict(instance=name, envs=n, mode=cfg.train_traj_mode)
    if task != "quad":
        actions, uniforms = _tick_inputs(cfg, dev, n, gen)
        st, _, bad, worst = _reset_vs_plain(cfg, uniforms(), "train", dev)
        if bad:
            raise AssertionError(f"{name} reset at {n} envs: {bad}")
        for _ in range(3):
            st, _ = K.env_tick_plain(cfg, st, actions(), uniforms(), "train")
        idx = torch.randperm(n, generator=gen, device=dev)[: max(1, n // 4)]
        st.env.t[idx] = cfg.max_steps - 1
        if cfg.exact_so3:
            drift = torch.rand(n, generator=gen, device=dev) < 0.3
            st.env.R[drift] += DRIFT * torch.randn(int(drift.sum()), 3, 3,
                                                   generator=gen, device=dev)
        a, dr = actions(), uniforms()
        c = _tick_vs_plain(cfg, st, a, dr, "train", dev)
        if c["unexplained"] or c["bad"]:
            raise AssertionError(f"{name} tick at {n} envs: "
                                 f"{c['unexplained']} envs, {c['bad']}")
        st2, out2 = K.env_tick(cfg, st, a, dr)
        first = list(_named(c["st_k"], c["out_k"]).values())
        rerun = _bitwise(first, list(_named(st2, out2).values()))
        over = int(c["out_k"].reset_happened.sum())
        worst = max(worst, c["err"])
        rec.update(tick_max_abs_err=c["err"], over_envs=over,
                   continuing_envs=n - over,
                   discrete_mismatch_near_threshold=int(c["mismatch"].sum()),
                   tick_rerun_bitwise=rerun)
        if not rerun:
            raise AssertionError(f"{name} tick at {n} envs: rerun differs")
    else:
        over = 0
    st_s = _step_states(cfg, n, gen, dev)
    t = K.task_of(cfg, task)
    a = 0.3 * torch.randn(n, K.ACT_DIM[t], generator=gen, device=dev)
    c = _step_vs_plain(cfg, t, st_s, a, dev)
    if c["unexplained"] or c["bad"]:
        raise AssertionError(f"{name} step at {n} envs: "
                             f"{c['unexplained']} envs, {c['bad']}")
    e1, o1 = K.env_step(cfg, st_s.env, a, task)
    e2, o2 = K.env_step(cfg, st_s.env, a, task)
    def flat(e, o):
        return [*_named(e).values(), *o.obs, o.reward, o.done]
    rerun = _bitwise(flat(e1, o1), flat(e2, o2))
    if not rerun:
        raise AssertionError(f"{name} step at {n} envs: rerun differs")
    rec.update(step_max_abs_err=c["err"], step_rerun_bitwise=rerun)
    return max(worst, c["err"]), over, rec


def phase_tick_rows(dev):
    """K1's fifteen instances, each entry, vs the plain twins at TILE_ROWS
    envs (``_k1_rows_instance``); the tick's fresh-episode select must go
    both ways over the sizes of each batched instance."""
    from gym_rotor_tpu_torch.kernels import env_tick as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    insts = [(dict(framework=fw, integrator=i, exact_so3=e), None)
             for fw, i, e in TICK_INSTANCES]
    insts += [(dict(framework="MONO", integrator=i, exact_so3=True), "quad")
              for i in K.INTEGRATORS]
    worst = 0.0
    for kw, task in insts:
        overs, rows = [], []
        for n in TILE_ROWS:
            err, over, rec = _k1_rows_instance(kw, task, n, dev, gen)
            worst = max(worst, err)
            overs.append((over, n - over))
            rows.append(rec)
        log("tick_rows", instance=rows[0]["instance"],
            tolerance="1e-6 + 1e-5 |plain|, discrete identical outside "
                      "thresholds, reruns bitwise", rows=rows)
        if task != "quad" and not (any(o for o, _ in overs)
                                   and any(c for _, c in overs)):
            raise AssertionError(f"{rows[0]['instance']}: the select went "
                                 f"one way only: {overs}")
    return worst


def phase_replay_rows(dev):
    """K2 + K8 vs plain at 1, 32, 33 and B rows of the MODUL (45-float) and
    MONO (52-float) rows, into a ring whose cursor is three rows from its
    end, with the statistics and without: the ring and ``ep_ret`` bit for
    bit, the sums within 1e-5 max(1, max |sum|), a rerun bit for bit."""
    from gym_rotor_tpu_torch.algos import replay as R
    from gym_rotor_tpu_torch.kernels import replay as K
    from gym_rotor_tpu_torch.utils.config import Config
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    worst = 0.0
    for fw in ("MODUL", "MONO"):
        cfg = Config(framework=fw)
        dims = (tuple(cfg.obs_dim_n), tuple(cfg.action_dim_n))
        na = cfg.n_agents
        for rows in (1, 32, 33, B):
            cap = rows + 61
            ptr = cap - 3
            obs = tuple(torch.randn(rows, d, generator=gen, device=dev)
                        for d in dims[0])
            nobs = tuple(torch.randn(rows, d, generator=gen, device=dev)
                         for d in dims[0])
            args = (obs, torch.rand(rows, sum(dims[1]), generator=gen,
                                    device=dev) * 2 - 1,
                    torch.rand(rows, na, generator=gen, device=dev), nobs,
                    torch.rand(rows, na, generator=gen, device=dev) < 0.2)
            reset = torch.rand(rows, generator=gen, device=dev) < 0.2
            ring0 = torch.rand(cap, R.row_dim(*dims), generator=gen,
                               device=dev)
            ep0 = torch.randn(rows, na, generator=gen, device=dev)
            st0 = torch.randn(na + 2, generator=gen, device=dev)
            for stats in (True, False):
                got = []
                for fn in (K.replay_insert_tick, K.replay_insert_tick,
                           K.replay_insert_tick_plain):
                    ring, ep, st = ring0.clone(), ep0.clone(), st0.clone()
                    if stats:
                        fn(ring, ptr, dims, *args, reset=reset, ep_ret=ep,
                           stats=st)
                    else:
                        fn(ring, ptr, dims, *args)
                    got.append((ring, ep, st))
                (k, k2, p) = got
                d, tol, _ = _err(k[2], p[2], 1e-5)
                ok = (_bitwise(k[:2], p[:2]) and _bitwise(k, k2)
                      and d <= tol)
                worst = max(worst, d)
                log("replay_rows", framework=fw, row_dim=R.row_dim(*dims),
                    rows=rows, cap=cap, ptr=ptr, stats=stats,
                    resets=int(reset.sum()),
                    ring_ep_ret_bitwise=_bitwise(k[:2], p[:2]),
                    rerun_bitwise=_bitwise(k, k2), stats_max_abs_err=d,
                    stats_tol=tol)
                if not ok:
                    raise AssertionError(f"replay {fw} at {rows} rows "
                                         f"(stats {stats}) disagrees")
    return worst


def phase_tiles(dev):
    """Phase 24: K1 and K2 + K8 around their 32-row tiles."""
    return phase_tick_rows(dev), phase_replay_rows(dev)


# ---------------------------------------------------------------------------
# The training driver (``python -m gym_rotor_tpu_torch.train``) end to end
# ---------------------------------------------------------------------------
DRIVER_KERNELS = ("env_tick", "replay_insert_tick", "replay_sample",
                  "emlp_actor", "emlp_block", "emlp_block_backward",
                  "flat_adamw", "spectral_iterate")
ARTIFACT_PAIRS = (("TD3_MODUL_300.0k_steps_agent_0_1992.msgpack",
                   "TD3_MODUL_300.0k_steps_agent_1_1992.msgpack"),
                  ("TD3_MODUL_100.0k_steps_agent_0_1992.msgpack",
                   "TD3_MODUL_450.016k_steps_agent_1_solved_1992.msgpack"),
                  ("TD3_MODUL_300.0k_steps_agent_0_1992.msgpack",
                   "TD3_MODUL_500.0k_steps_agent_1_1992.msgpack"))


def driver_argv(ckpt_path, supersteps=8, resume=False):
    """The flagship's defaults at B envs, cut in depth: 2 warm supersteps,
    then ``supersteps - 2`` train ones; an eval every 2 supersteps' env-steps
    and a train-state checkpoint (with the ring) every 4."""
    return ["--num_envs", str(B), "--start_timesteps", str(2 * B),
            "--max_timesteps", str(supersteps * B), "--eval_freq", str(2 * B),
            "--checkpoint_freq", str(4 * B), "--checkpoint_replay", "True",
            "--checkpoint_path", ckpt_path] + (
                ["--resume", "True"] if resume else [])


def driver_schedule(supersteps, resumed_at=None):
    """The eval and checkpoint timesteps ``driver_argv`` asks the JAX
    driver's rules for (``train.py:382-452``): an eval before training,
    then at the first train superstep at or past each multiple of
    ``eval_freq``; a checkpoint every ``checkpoint_freq`` from the start."""
    start, freq, ck = 2 * B, 2 * B, 4 * B
    t = resumed_at or 0
    evals, ckpts = [t], []
    next_eval, next_ck = freq, t + ck
    while t < supersteps * B:
        warm = t < start
        t += B
        if t >= next_eval and not warm:
            evals.append(t)
            while next_eval <= t:
                next_eval += freq
        if t >= next_ck:
            ckpts.append(t)
            next_ck += ck
    return evals, ckpts


def _states_bitwise(a, b):
    import dataclasses

    def leaves(x):
        if dataclasses.is_dataclass(x):
            return [v for f in dataclasses.fields(x)
                    for v in leaves(getattr(x, f.name))]
        return [x]
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        (torch.equal(x, y) and x.dtype == y.dtype)
        if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def _eval_bitwise(r1, r2):
    return (r1[0].tobytes() == r2[0].tobytes() and r1[1] == r2[1]
            and bool((r1[2] == r2[2]).all()))


def expected_eval_launches(cfg):
    """An eval's launches on the flagship: one reset, then K1 once and
    K3-actor once per agent a tick."""
    from gym_rotor_tpu_torch.envs.quad import DT
    ticks = int(round(cfg.eval_max_steps / DT))
    return {"env_tick": 1 + ticks, "emlp_actor": cfg.n_agents * ticks}


def phase_driver(dev, supersteps=8):
    """Phase 25: ``gym_rotor_tpu_torch.train.main(argv)``, the flagship at
    B envs for ``supersteps`` supersteps (``driver_argv``) in a temporary
    directory: the evals and checkpoints at ``driver_schedule``'s
    timesteps, exact launch counts per superstep (``expected_launches``) and
    per eval (one reset, then K1 once and K3-actor per agent a tick), every
    kernel of the path launched; each agent's actor saved and reloaded
    bitwise (the bytes and the tree); ``--test_model`` on them, and a
    learner that folded its seeded actors before loading them, giving the
    in-memory eval's answer bitwise (a stale fold cache would not); the
    last checkpoint loaded into a fresh learner bitwise (states, ring,
    generators); ``--resume`` running one more superstep; and
    ``docs/artifacts``' actors under the reference eval stream on the card
    vs the CPU's plain path.  Prints the phase's wall time, each eval's and
    the host time per superstep."""
    import os
    import tempfile

    from gym_rotor_tpu_torch import train as T
    from gym_rotor_tpu_torch.utils import checkpoint as ckpt
    from gym_rotor_tpu_torch.utils import msgpack as mp
    t_phase = time.perf_counter()
    wr = _wrappers()
    rec = dict(evals=[], ckpts=[], steps=[], eval_s=[], bad=[])
    orig = (T.Learner.eval_policy, T.Learner.save_checkpoint,
            T.Learner.superstep)

    def counts():
        return {k: w.launches for k, w in wr.items()}

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()
                if v != before[k]}

    def eval_policy(self):
        before = counts()
        t0 = time.perf_counter()
        out = orig[0](self)
        rec["eval_s"].append(time.perf_counter() - t0)
        rec["evals"].append(self.total_timesteps)
        want = expected_eval_launches(self.cfg)
        got = delta(before)
        if got != want:
            rec["bad"].append(("eval", self.total_timesteps, got, want))
        return out

    def save_checkpoint(self, path=None):
        rec["ckpts"].append(self.total_timesteps)
        return orig[1](self, path)

    def superstep(self):
        before = counts()
        t0 = time.perf_counter()
        warm, metrics, ret = orig[2](self)
        rec["steps"].append((warm, time.perf_counter() - t0))
        gated = not warm and \
            self.states[0].total_it % self.cfg.policy_update_freq == 0
        want = expected_launches(self.cfg, warm, gated)
        got = delta(before)
        if got != want:
            rec["bad"].append(("superstep", self.total_timesteps, got, want))
        return warm, metrics, ret

    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="driver_")
    ck = os.path.join(tmp, "ck", "train_state.msgpack")
    torch.cuda.synchronize()
    for w in wr.values():
        w.launches = 0
    T.Learner.eval_policy, T.Learner.save_checkpoint, T.Learner.superstep = \
        eval_policy, save_checkpoint, superstep
    try:
        os.chdir(tmp)
        learner = T.main(driver_argv(ck, supersteps), device=dev)
        torch.cuda.synchronize()
        run_launches = counts()
        run = {k: list(v) for k, v in rec.items()}
        cfg = learner.cfg
        # each agent's actor saved (the 0.85 bar is rarely cleared by a
        # short run from random weights) and reloaded bitwise
        driver_saved = sorted(os.listdir("models")) \
            if os.path.isdir("models") else []
        paths = [learner.save_actor(i) for i in range(cfg.n_agents)]
        reload_ok = []
        for i, p in enumerate(paths):
            tree = learner.actor_tree(i)
            loaded = ckpt.load_actor(p, tree)
            reload_ok.append(
                open(p, "rb").read() == mp.packb(tree) == mp.packb(loaded))
        in_memory = learner.eval_policy()
        tm = T.main(driver_argv(ck, supersteps) + ["--test_model", "True"],
                    device=dev)
        test_model = tm.eval_policy()
        tm_actors = [torch.equal(a.actor, b.actor)
                     for a, b in zip(tm.states, learner.states)]
        folded = T.Learner(cfg, device=dev)
        folded.eval_policy()                    # folds the seeded actors
        folded.load_best_actors()
        after_fold = folded.eval_policy()
        # the last checkpoint (the run's end) in a fresh learner
        fresh = T.Learner(cfg, device=dev).load_checkpoint(ck)
        ckpt_ok = dict(
            states=all(_states_bitwise(a, b) for a, b in
                       zip(fresh.states, learner.states)),
            ring=bool(torch.equal(fresh.replay.data, learner.replay.data))
            and (fresh.replay.ptr, fresh.replay.filled)
            == (learner.replay.ptr, learner.replay.filled),
            generators=bool(torch.equal(fresh.gen.get_state(),
                                        learner.gen.get_state())),
            counters=(fresh.total_timesteps, fresh.explor_noise_std)
            == (learner.total_timesteps, learner.explor_noise_std))
        ck_bytes = os.path.getsize(ck)
        rec.update(evals=[], ckpts=[], steps=[])
        resumed = T.main(driver_argv(ck, supersteps + 1, resume=True),
                         device=dev)
        resume = dict(evals=list(rec["evals"]), ckpts=list(rec["ckpts"]),
                      total=resumed.total_timesteps,
                      total_it=[s.total_it for s in resumed.states])
    finally:
        os.chdir(cwd)
        T.Learner.eval_policy, T.Learner.save_checkpoint, \
            T.Learner.superstep = orig
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    artifacts = driver_artifacts(dev)
    want_evals, want_ckpts = driver_schedule(supersteps)
    want_resume = driver_schedule(supersteps + 1, supersteps * B)
    train_ms = [1e3 * s for w, s in run["steps"] if not w]
    warm_ms = [1e3 * s for w, s in run["steps"] if w]
    log("driver", framework=cfg.framework, rl_algo=cfg.rl_algo, envs=B,
        supersteps=len(run["steps"]), evals=run["evals"],
        checkpoints=run["ckpts"], want_evals=want_evals,
        want_checkpoints=want_ckpts,
        launches={k: v for k, v in run_launches.items() if v},
        driver_saved_actors=driver_saved, actor_reload_bitwise=reload_ok,
        test_model_bitwise=_eval_bitwise(test_model, in_memory),
        test_model_actors_bitwise=tm_actors,
        load_after_fold_bitwise=_eval_bitwise(after_fold, in_memory),
        eval_reward=[float(x) for x in in_memory[0]],
        benchmark_reward=in_memory[1], checkpoint=ckpt_ok,
        checkpoint_bytes=ck_bytes, resume=resume,
        want_resume=dict(evals=want_resume[0], ckpts=want_resume[1]),
        train_superstep_host_ms=train_ms, warm_superstep_host_ms=warm_ms,
        train_superstep_host_ms_median=statistics.median(train_ms),
        eval_wall_s=run["eval_s"], artifacts=artifacts,
        phase_wall_s=time.perf_counter() - t_phase,
        mismatches=rec["bad"][:5])
    missing = [k for k in DRIVER_KERNELS if not run_launches.get(k)]
    if rec["bad"] or missing:
        raise AssertionError(f"driver launches: {rec['bad'][:5]}, not "
                             f"launched: {missing}")
    if (run["evals"], run["ckpts"]) != (want_evals, want_ckpts):
        raise AssertionError(f"driver schedule {run['evals']} "
                             f"{run['ckpts']}, want {want_evals} "
                             f"{want_ckpts}")
    if not (all(reload_ok) and all(tm_actors)
            and _eval_bitwise(test_model, in_memory)
            and _eval_bitwise(after_fold, in_memory)):
        raise AssertionError("saved actors do not answer as in memory")
    if not all(ckpt_ok.values()):
        raise AssertionError(f"train state round trip: {ckpt_ok}")
    if (resume["evals"], resume["ckpts"]) != want_resume or \
            resume["total"] != (supersteps + 1) * B or \
            resume["total_it"] != [s.total_it + 1 for s in learner.states]:
        raise AssertionError(f"resume: {resume}, want {want_resume}")
    if not all(a["ok"] for a in artifacts):
        raise AssertionError(f"docs/artifacts actors: {artifacts}")


def driver_artifacts(dev):
    """``docs/artifacts``' trained actors (all five files, as three pairs)
    loaded by ``Learner.load_actor`` and evaluated under the reference eval
    stream (the reference's ten seeded episodes, lifted in plain torch) on
    the card and on the CPU's plain path: the rewards within 1e-5 relative,
    success equal, the last errors within 1e-5, the closed-loop tolerance
    the CPU tests hold the port to JAX with."""
    import os

    from gym_rotor_tpu_torch import train as T
    from gym_rotor_tpu_torch.evaluate import evaluate
    from gym_rotor_tpu_torch.utils.config import Config
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config(eval_stream="reference", num_envs=32, replay_buffer_size=64)
    out = []
    for names in ARTIFACT_PAIRS:
        res = []
        for d in (dev, torch.device("cpu")):
            learner = T.Learner(cfg, device=d)
            for i, n in enumerate(names):
                learner.load_actor(i, os.path.join(here, "docs", "artifacts",
                                                   n))
            t0 = time.perf_counter()
            r = evaluate(cfg, learner.actors(), device=d)
            res.append(([x.cpu() for x in r[:5]],
                        time.perf_counter() - t0))
        (k, k_s), (p, p_s) = res
        ep = float(((k[0] - p[0]).abs() / p[0].abs()).max())
        bench = abs(float(k[1]) - float(p[1])) / abs(float(p[1]))
        last = max(float((k[3] - p[3]).abs().max()),
                   float((k[4] - p[4]).abs().max()))
        ok = (ep <= 1e-5 and bench <= 1e-5 and torch.equal(k[2], p[2])
              and last <= 1e-5)
        out.append(dict(actors=list(names), benchmark_reward=float(k[1]),
                        cpu_benchmark_reward=float(p[1]),
                        eval_reward_rel_err=ep, benchmark_rel_err=bench,
                        last_err=last, success=int(k[2].sum()),
                        card_eval_s=k_s, cpu_eval_s=p_s, ok=ok))
    return out


# ---------------------------------------------------------------------------
# Phase 26: any actor and critic width (the run-time-width kernels)
# ---------------------------------------------------------------------------
# (actor_hidden_dim, critic_hidden_dim): the CPU tests' training width, the
# width ROADMAP names, and the slice's full width, four times the defaults
WIDTHS = (((8, 4), 8), ((32, 8), 128), ((64, 16), 256))
SLICE_WIDTH = dict(actor_hidden_dim=(64, 16), critic_hidden_dim=256)
WIDTH_ROWS = (1, 31, 32, 33, 256, 3723, 4096)
WIDE_ACTOR, WIDE_CRITIC = (128, 32), 512      # kernel-only widths
MLP_PPO_WIDTHS = ((15, 64, 4), (3, 16, 1), (15, 256, 4), (15, 900, 4))
WIDTH_STEPS = 20             # TD3 / SAC train supersteps at the slice width
WIDTH_SMALL_STEPS = 6        # TD3 at (32, 8) / 128 and (8, 4) / 8
WIDTH_PPO_STEPS = 2          # PPO B supersteps (the second timed)
V_ROWS = 2 * 4096 * 50       # PPO B's GAE pass over [obs; next_obs]
ANY_SOURCES = {"emlp_block_any": "emlp_block.cu",
               "emlp_block_backward_any": "emlp_block.cu",
               "emlp_actor_any": "emlp_actor.cu", "sac_actor_any":
               "emlp_actor.cu", "ppo_actor_any": "emlp_actor.cu",
               "spectral_iterate_any": "spectral.cu",
               "mlp_ppo_actor_any": "mlp_ppo_actor.cu"}
ANY_REPLACES = {
    "emlp_block_any": "gym_rotor_tpu/models/emlp/nn.py:431",
    "emlp_block_backward_any": "gym_rotor_tpu/models/emlp/nn.py:39",
    "emlp_actor_any": "gym_rotor_tpu/models/emlp/zoo.py:101",
    "sac_actor_any": "gym_rotor_tpu/algos/sac.py:97",
    "ppo_actor_any": "gym_rotor_tpu/algos/ppo.py:107",
    "spectral_iterate_any": "gym_rotor_tpu/algos/regularizers.py:102",
    "mlp_ppo_actor_any": "gym_rotor_tpu/models/mlp.py:146"}


def _rand(shape, gen, dev, scale=1.0):
    return torch.randn(*shape, generator=gen, device=dev) * scale


def _block_operands(spec, B, gen, dev):
    """Seeded operands of a block at ``B`` rows: x, W_eff, b_eff, v (each
    output's quadratic form scaled by its nonzero count, so pre stays of
    order one) and g_h."""
    nin, ng, nh = spec.dims
    per = max(1.0, spec.nnz / ng)
    return (_rand((B, nin), gen, dev), _rand((ng, nin), gen, dev,
                                            nin ** -0.5),
            _rand((ng,), gen, dev, 0.1), _rand((spec.nnz,), gen, dev,
                                               0.5 / per ** 0.5),
            _rand((B, nh), gen, dev))


def _plain_block_chunked(spec, x, W, b, v, g_h, lin, pre):
    """The K3/K4 twins over ``x``'s rows in chunks of at most 2^27 / nnz
    rows (the twins' (rows, nnz) temporaries ~0.5 GB): the forward's (h,
    lin, pre) and the backward's (g_x, g_W, g_b, g_v) on the kernel's lin
    and pre, the parameter sums added over the chunks."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    n = max(1, (1 << 27) // max(spec.nnz, 4 * spec.ng))
    fw, bw = [], []
    for r0 in range(0, x.shape[0], n):
        sl = slice(r0, r0 + n)
        fw.append(K.emlp_block_plain(spec, x[sl], W, b, v))
        bw.append(K.emlp_block_backward_plain(
            spec, g_h[sl], x[sl], W, v, lin[:, sl].contiguous(),
            pre[:, sl].contiguous(), True))
    fp = (torch.cat([f[0] for f in fw]), torch.cat([f[1] for f in fw], 1),
          torch.cat([f[2] for f in fw], 1))
    bp = (torch.cat([g[0] for g in bw]),) + tuple(
        functools.reduce(torch.add, [g[k] for g in bw]) for k in (1, 2, 3))
    return fp, bp


@contextlib.contextmanager
def _forced(mod, **layout):
    """The run-time path of kernel module ``mod`` in a forced layout (its
    ``_FORCE`` hook) for the calls inside."""
    mod._FORCE.update(layout)
    try:
        yield
    finally:
        for k in layout:
            mod._FORCE.pop(k, None)


def _any_block_vs_plain(spec, ops):
    """The run-time K3/K4 path vs the twins on the same operands: the
    forward saving lin and pre (run twice), without them; the backward with
    and without the parameter sums (each twice).  Tolerance 2e-5 max(1,
    max |plain|); every rerun, the unsaved h and the g_x of both backward
    kinds bitwise.  Returns ({name: max abs err},
    failures, the outputs)."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    x, W, b, v, g_h = ops
    fk = K.emlp_block_any(spec, x, W, b, v, True)
    fk2 = K.emlp_block_any(spec, x, W, b, v, True)
    hn, ln, pn = K.emlp_block_any(spec, x, W, b, v, False)
    runs = [K.emlp_block_backward_any(spec, g_h, x, W, v, fk[1], fk[2], need)
            for need in (True, True, False, False)]
    fp, bp = _plain_block_chunked(spec, x, W, b, v, g_h, fk[1], fk[2])
    errs, bad = {}, []
    for nm, kk, pp in zip(("h", "lin", "pre", "g_x", "g_W", "g_b", "g_v"),
                          fk + runs[0], fp + bp):
        d, tol, fin = _err(kk, pp)
        errs[nm] = d
        if not (d <= tol and fin):
            bad.append((nm, d, tol))
    same = [torch.equal(a, c) for a, c in zip(fk, fk2)] + [
        torch.equal(hn, fk[0]), ln is None and pn is None] + [
        torch.equal(a, c) for r1, r2 in (runs[:2], runs[2:])
        for a, c in zip(r1, r2) if a is not None] + [
        torch.equal(runs[0][0], runs[2][0])]
    errs["rerun_bitwise"] = all(same)
    if not all(same):
        bad.append(("a rerun or the unsaved forward differs", same))
    return errs, bad, (fk, runs[0])


# CUDA kernels one run-time call launches: K3 the linear and the gate
# steps; K4 g_pre, the list step and g_x, with the parameter sums the slot
# product (g_W, g_b) and the slots' sum
ANY_KERNELS_A_CALL = {"forward": 2, "backward": 3, "backward_params": 5}


def _rt_plan_log(spec, nb, sms):
    """The run-time steps' plans at ``nb`` rows, for a log line: per step
    its block columns, a lane's rows, whether the tile is staged and the
    list step's segments a column."""
    return {k: list(spec.rt_plan(k, nb, sms)[1:])
            for k in ("forward", "backward")}


def _any_kernels_a_call(spec, ops):
    """The CUDA kernels one run-time K3 call and one K4 call (without and
    with the parameter sums) launch (``launches_per_call``), and the
    mismatches with ``ANY_KERNELS_A_CALL``."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    x, W, b, v, g_h = ops
    _, lin, pre = K.emlp_block_any(spec, x, W, b, v)
    got = {"forward": launches_per_call(
        lambda: K.emlp_block_any(spec, x, W, b, v, True)),
        "backward": launches_per_call(lambda: K.emlp_block_backward_any(
            spec, g_h, x, W, v, lin, pre, False)),
        "backward_params": launches_per_call(
            lambda: K.emlp_block_backward_any(spec, g_h, x, W, v, lin, pre,
                                              True))}
    return got, [(k, n) for k, n in got.items()
                 if n != ANY_KERNELS_A_CALL[k]]


def width_block_specs(dev):
    """``{dims: BlockSpec}`` of every block phase 26 checks on the run-time
    path: the TD3 twin critics', the actors' and the PPO V critics' at each
    of ``WIDTHS``, and critic 512's hidden blocks (kernel-only)."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    from gym_rotor_tpu_torch.models.emlp import zoo as Z
    from gym_rotor_tpu_torch.models.emlp.nn import gated
    from gym_rotor_tpu_torch.utils.config import Config
    specs = {}
    for ah, ch in WIDTHS:
        cfg = Config(actor_hidden_dim=ah, critic_hidden_dim=ch)
        for i in range(cfg.n_agents):
            td3 = TD3Agent(cfg, i, dev)
            ppo = PPOAgent(cfg.replace(rl_algo="PPO"), i, dev)
            for net in (td3.critic_net.network1, td3.actor_net.network,
                        ppo.critic_net.network):
                for blk in net.blocks():
                    spec = K.block_spec(blk, dev)
                    specs[spec.dims] = spec
    cfg = Config(critic_hidden_dim=WIDE_CRITIC)
    for i in range(cfg.n_agents):
        hid = Z.critic_reps(cfg, "MODUL", i, "DTDE")[1]
        spec = K.BlockSpec(hid, hid, gated(hid), dev)
        specs[spec.dims] = spec
    return specs


def width_block_checks(dev, specs, gen):
    """Every run-time K3/K4 shape at ``WIDTH_ROWS`` (``_any_block_vs_plain``)
    and its CUDA kernels a call (``ANY_KERNELS_A_CALL``, exactly); the tile
    read from global memory (staging forced off) and two rows a lane
    (forced where the tiles fit) bitwise the staged one-row read at the
    slice's hidden blocks; and at the instances' shapes of the
    flagship (a few default shapes) the run-time path held to the
    instance's result (bitwise where the sums' orders agree: the forward
    and g_v; g_lin, and so g_x, g_W and g_b, where the instance's lists
    are one segment a coordinate).  Returns the worst (forward, backward)
    errors."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    worst, bad = (0.0, 0.0), []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dims, spec in sorted(specs.items()):
        for nb in WIDTH_ROWS:
            ops = _block_operands(spec, nb, gen, dev)
            errs, b, _ = _any_block_vs_plain(spec, ops)
            worst = (max(worst[0], *(errs[k] for k in ("h", "lin", "pre"))),
                     max(worst[1], *(errs[k] for k in ("g_x", "g_W", "g_b",
                                                       "g_v"))))
            log("widths", check="emlp_block_any", dims=list(dims), nnz=spec.nnz,
                batch=nb, plan=_rt_plan_log(spec, nb, sms), **errs)
            bad += [(dims, nb) + x for x in b]
        got, wrong = _any_kernels_a_call(
            spec, _block_operands(spec, 256, gen, dev))
        log("widths", check="emlp_block_any_kernels_a_call", dims=list(dims),
            batch=256, kernels=got, expected=ANY_KERNELS_A_CALL)
        bad += [(dims, "kernels a call") + w for w in wrong]
    # the steps that two rows a lane must reach at 256 rows on the H100:
    # the forward at both widths, the list step where its segments' shares
    # fit beside two rows' tiles (288, not 511)
    two_expected = {(256, 288, 256): ["backward_rows", "forward_rows"],
                    (256, 511, 256): ["forward_rows"]}
    for dims in ((256, 288, 256), (256, 511, 256)):
        spec = specs[dims]
        ops = _block_operands(spec, 256, gen, dev)
        with _forced(K, forward=True, backward=True):
            on = _any_block_vs_plain(spec, ops)[2]
        with _forced(K, forward=False, backward=False):
            off = _any_block_vs_plain(spec, ops)[2]
        # two rows a lane (the layout from RT_TWO_ROWS_MIN rows) in each
        # step whose plan fits them, at these 256 rows
        two = {}
        for k in ("forward", "backward"):
            with _forced(K, **{f"{k}_rows": 2}):
                try:
                    if spec.rt_plan(k, 256, sms).rows == 2:
                        two[f"{k}_rows"] = 2
                except ValueError:
                    pass
        with _forced(K, **two):
            rows2 = _any_block_vs_plain(spec, ops)[2]
        same = all(torch.equal(a, c) for r1, r2 in zip(on, off)
                   for a, c in zip(r1, r2))
        same2 = all(torch.equal(a, c) for r1, r2 in zip(on, rows2)
                    for a, c in zip(r1, r2))
        log("widths", check="emlp_block_any_global_tiles", dims=list(dims),
            batch=256, bitwise_vs_staged=same, two_rows=sorted(two),
            two_rows_bitwise=same2)
        if not same:
            bad.append((dims, "global tiles differ from staged"))
        if not same2:
            bad.append((dims, "two rows a lane differ from one"))
        if sorted(two) != two_expected[dims]:
            bad.append((dims, f"two rows a lane forced {sorted(two)}, "
                              f"expected {two_expected[dims]}"))
    for dims, spec in sorted(block_specs(dev).items())[:6]:
        for nb in (33, 256, 3723):
            x, W, b, v, g_h = _block_operands(spec, nb, gen, dev)
            fi = K.emlp_block(spec, x, W, b, v)
            bi = K.emlp_block_backward(spec, g_h, x, W, v, fi[1], fi[2], True)
            fa = K.emlp_block_any(spec, x, W, b, v)
            ba = K.emlp_block_backward_any(spec, g_h, x, W, v, fi[1], fi[2],
                                           True)
            names = ("h", "lin", "pre", "g_x", "g_W", "g_b", "g_v")
            eq = {n: bool(torch.equal(a, c)) for n, a, c in
                  zip(names, fi + bi, fa + ba)}
            errs = {n: _err(a, c) for n, a, c in zip(names, fa + ba,
                                                    fi + bi)}
            log("widths", check="emlp_block_any_vs_instance",
                dims=list(dims), batch=nb, bitwise=eq,
                backward_groups=spec.groups("backward", nb, sms),
                **{n: e[0] for n, e in errs.items()})
            bad += [(dims, nb, n, e[0], e[1]) for n, e in errs.items()
                    if not (e[0] <= e[1] and e[2])]
    if bad:
        raise AssertionError(f"run-time K3/K4: {bad[:5]}")
    return worst


def width_v_forward(dev, gen):
    """The PPO B GAE pass at the slice width: both V critics' blocks over
    ``V_ROWS`` rows through the run-time K3 (saving lin and pre, and
    without), every row vs the twin in chunks; the reruns bitwise."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config(rl_algo="PPO", **SLICE_WIDTH)
    worst, bad = 0.0, []
    for i in range(cfg.n_agents):
        for blk in PPOAgent(cfg, i, dev).critic_net.network.blocks():
            spec = K.block_spec(blk, dev)
            x, W, b, v, _ = _block_operands(spec, 1, gen, dev)
            x = _rand((V_ROWS, spec.nin), gen, dev)
            with torch.no_grad():
                hk = K.emlp_block_any(spec, x, W, b, v, save=False)[0]
                hk2 = K.emlp_block_any(spec, x, W, b, v, save=False)[0]
            fk = K.emlp_block_any(spec, x, W, b, v)
            n = max(1, (1 << 27) // spec.nnz)
            errs = dict(h=0.0, lin=0.0, pre=0.0)
            for r0 in range(0, V_ROWS, n):
                sl = slice(r0, r0 + n)
                fp = K.emlp_block_plain(spec, x[sl], W, b, v)
                for nm, kk, pp in zip(("h", "lin", "pre"),
                                      (fk[0][sl], fk[1][:, sl], fk[2][:, sl]),
                                      fp):
                    d, tol, fin = _err(kk, pp)
                    errs[nm] = max(errs[nm], d)
                    if not (d <= tol and fin):
                        bad.append((spec.dims, nm, r0, d, tol))
            same = torch.equal(hk, hk2) and torch.equal(hk, fk[0])
            worst = max(worst, *errs.values())
            log("widths", check="v_forward_any", agent=i,
                dims=list(spec.dims), rows=V_ROWS, rerun_bitwise=same, **errs)
            if not same:
                bad.append((spec.dims, "rerun"))
            del fk, hk, hk2, x
    if bad:
        raise AssertionError(f"V forward at {V_ROWS} rows: {bad[:5]}")
    return worst


def width_actors(dev):
    """Every acting actor phase 26 checks: each head's actor (TD3's
    ``EMLPActorDet``, ``EMLPActorSAC``, ``EMLPActorPPO``) of both agents at
    each of ``WIDTHS`` and at ``WIDE_ACTOR``, seeded weights (the PPO
    actor's ``log_std`` at 0.3)."""
    from gym_rotor_tpu_torch.models.emlp import zoo as Z
    from gym_rotor_tpu_torch.utils.config import Config
    out = []
    for ah in [w[0] for w in WIDTHS] + [WIDE_ACTOR]:
        cfg = Config(actor_hidden_dim=ah)
        for i in range(cfg.n_agents):
            reps = Z.actor_reps(cfg, "MODUL", i)
            act = cfg.action_dim_n[i]
            gen = torch.Generator().manual_seed(SEED + i)
            for head, make in (
                    ("tanh", lambda: Z.EMLPActorDet(*reps, device="cpu",
                                                    generator=gen)),
                    ("gauss", lambda: Z.EMLPActorSAC(*reps, act, device="cpu",
                                                     generator=gen)),
                    ("ppo", lambda: Z.EMLPActorPPO(*reps, act, device="cpu",
                                                   generator=gen))):
                actor = make().to(dev)
                if head == "ppo":
                    with torch.no_grad():
                        actor.log_std.fill_(0.3)
                    actor.bump_version()
                out.append((ah, i, head, actor))
    return out


ANY_ACTOR = {"tanh": "emlp_actor_any", "gauss": "sac_actor_any",
             "ppo": "ppo_actor_any"}


def _actor_call(KA, name, actor, o, noise, plan=None):
    """``KA.<name>`` on ``o`` (and ``noise`` but for the tanh head), in the
    run-time layout ``plan`` (``(stage_image, tile_in_smem)``) where one is
    given; its outputs as a tuple."""
    fn = getattr(KA, name)
    with torch.no_grad(), (contextlib.nullcontext() if plan is None
                           else _forced(KA, plan=plan)):
        out = fn(actor, o) if name.startswith("emlp_actor") else \
            fn(actor, o, noise)
    return out if isinstance(out, tuple) else (out,)


def width_actor_checks(dev, gen):
    """The run-time acting kernel vs the twins for every head, both agents
    and ``width_actors``' widths at ``WIDTH_ROWS`` and the eval's 10, train
    (the draws) and eval (none): actions 1e-5, log-probs 2e-5 max(1, max
    |plain|); reruns bitwise, and the image read from global memory, the
    tile in a global scratch (forced ``plan``s) and the tile shared by a
    cluster of ``RT_CLUSTER`` blocks or by one (forced ``cluster``) bitwise
    the launch the wrapper picks; the image's coordinate encoding
    (``ent_scale`` 1, what past 1986 gated channels takes) forced on the
    (32, 8) actors, bitwise; outputs cut into segments of 8 nonzeros
    (forced ``seg``, what outputs past ``RT_SEG`` take) on the (32, 8)
    and (64, 16) actors, held to the twins; then at the instances' actors
    (the default widths) held to the instance's result within 1e-5.
    Returns the worst error."""
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    worst, bad = 0.0, []
    for ah, i, head, actor in width_actors(dev):
        name = ANY_ACTOR[head]
        dims = KA.actor_dims(actor)
        for nb in WIDTH_ROWS + (10,):
            o = _rand((nb, dims[0]), gen, dev)
            nz = _rand((nb, dims[3]), gen, dev)
            for train in ((False,) if head == "tanh" else (True, False)):
                noise = nz if train else None
                k = _actor_call(KA, name, actor, o, noise)
                same = [all(torch.equal(a, c) for a, c in zip(k, _actor_call(
                    KA, name, actor, o, noise, plan)))
                    for plan in (None, (False, True), (False, False))]
                # a tile shared by a cluster of blocks and by one block
                for csize in (1, KA.RT_CLUSTER):
                    with _forced(KA, cluster=csize):
                        same.append(all(torch.equal(a, c) for a, c in zip(
                            k, _actor_call(KA, name, actor, o, noise))))
                with torch.no_grad():
                    p = getattr(KA, name.replace("_any", "_plain"))(
                        *((actor, o) if head == "tanh" else
                          (actor, o, noise)))
                p = p if isinstance(p, tuple) else (p,)
                ea = float((k[0] - p[0]).abs().max())
                el = _err(k[1], p[1])[0] if head == "ppo" else 0.0
                worst = max(worst, ea, el)
                ok = ea <= 1e-5 and (head != "ppo" or _err(k[1], p[1])[0]
                                     <= _err(k[1], p[1])[1]) and all(same) \
                    and all(bool(torch.isfinite(t).all()) for t in k)
                if nb in (1, 33, 4096) or not ok:
                    f = KA.fold_actor(actor)
                    log("widths", check=name, width=list(ah), agent=i,
                        dims=list(dims), batch=nb, train=train,
                        max_abs_err=ea, logp_err=el,
                        bitwise_rerun_and_modes=same,
                        plan=list(KA.any_plan(dims, f["layout"], f["slots"],
                                              KA.plan_words(f))),
                        warps=f["warps"])
                if not ok:
                    bad.append((name, dims, nb, train, ea, el, same))
    # the image's coordinate encoding (what past 1986 gated channels
    # takes), forced on fresh folds of the (32, 8) actors: bitwise the
    # offsets' launch
    for ah, i, head, actor in width_actors(dev):
        if ah != (32, 8):
            continue
        name = ANY_ACTOR[head]
        o = _rand((33, KA.actor_dims(actor)[0]), gen, dev)
        nz = None if head == "tanh" else _rand((33, KA.actor_dims(actor)[3]),
                                               gen, dev)
        ref = _actor_call(KA, name, actor, o, nz)
        with _forced(KA, ent_scale=1):
            actor.bump_version()
            got = _actor_call(KA, name, actor, o, nz)
            mul = KA.fold_actor(actor)["mul"]
        actor.bump_version()
        same = all(torch.equal(a, c) for a, c in zip(ref, got))
        log("widths", check=f"{name}_coordinates", agent=i, mul=mul,
            bitwise_vs_offsets=same)
        if not same or mul != KA.PITCH:
            bad.append((name, i, "coordinate encoding", mul, same))
    # outputs cut into several segments (forced short segments): their
    # partial sums added in order, held to the twins
    for ah, i, head, actor in width_actors(dev):
        if ah not in ((32, 8), (64, 16)):
            continue
        name = ANY_ACTOR[head]
        dims = KA.actor_dims(actor)
        o = _rand((33, dims[0]), gen, dev)
        nz = None if head == "tanh" else _rand((33, dims[3]), gen, dev)
        with _forced(KA, seg=8):
            actor.bump_version()
            got = _actor_call(KA, name, actor, o, nz)
            slots = KA.fold_actor(actor)["slots"]
        actor.bump_version()
        with torch.no_grad():
            p = getattr(KA, name.replace("_any", "_plain"))(
                *((actor, o) if head == "tanh" else (actor, o, nz)))
        p = p if isinstance(p, tuple) else (p,)
        ea = float((got[0] - p[0]).abs().max())
        el = _err(got[1], p[1]) if head == "ppo" else (0.0, 1.0, True)
        log("widths", check=f"{name}_segments", width=list(ah), agent=i,
            slots=slots, max_abs_err=ea, logp_err=el[0])
        if not (ea <= 1e-5 and el[0] <= el[1] and slots > dims[1]):
            bad.append((name, i, "segments", ea, el[0], slots))
    for (dims, head), actor in sorted(actor_instances(dev).items()):
        inst, name = ACTOR_KERNELS[head], ANY_ACTOR[head]
        for nb in (1, 33, 4096):
            o = _rand((nb, dims[0]), gen, dev)
            nz = _rand((nb, dims[3]), gen, dev)
            noise = None if head == "tanh" else nz
            ki = _actor_call(KA, inst, actor, o, noise)
            ka = _actor_call(KA, name, actor, o, noise)
            eq = [bool(torch.equal(a, c)) for a, c in zip(ki, ka)]
            err = max(float((a - c).abs().max()) for a, c in zip(ki, ka))
            log("widths", check=f"{name}_vs_instance", dims=list(dims),
                head=head, batch=nb, bitwise=eq, max_abs_err=err)
            if err > 1e-5:
                bad.append((name, dims, nb, "vs instance", err))
    if bad:
        raise AssertionError(f"run-time acting kernel: {bad[:5]}")
    return worst


def width_spectral_checks(dev, gen):
    """The run-time K7 vs its twin on every stack of the TD3, SAC and PPO
    learners (critic and actor, both agents) at ``WIDTHS``, and on critic
    512's stacks (6, 568 | 1023, 512) (kernel-only, seeded), reruns
    bitwise, 1e-5, also at the other cluster size (forced ``cluster``);
    the band read from global memory (forced ``staged``) bitwise the
    staged launch; then at the flagship's stacks held to the instance's
    iterate.  Returns the worst error and the run-time stacks of the
    slice's width and critic 512's."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.algos.sac import SACAgent
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.kernels import spectral as KS
    from gym_rotor_tpu_torch.utils.config import Config
    init = torch.Generator().manual_seed(SEED)
    stacks = []
    for ah, ch in WIDTHS:
        for algo, cls in (("TD3", TD3Agent), ("SAC", SACAgent),
                          ("PPO", PPOAgent)):
            cfg = Config(rl_algo=algo, actor_hidden_dim=ah,
                         critic_hidden_dim=ch)
            agents = [cls(cfg, i, dev) for i in range(cfg.n_agents)]
            states = [a.init(init) for a in agents]
            stacks += [(f"{algo.lower()}_{ch}", i, net, ws, Ws, x)
                       for i, net, ws, Ws, x in
                       _spectral_stacks(agents, states, dev, gen)]
    for mo in (568, 1023):
        ws = [_rand((mo, WIDE_CRITIC), gen, dev, 0.05) for _ in range(6)]
        stacks.append((f"critic_{WIDE_CRITIC}", None, "critic", ws,
                       torch.stack(ws), _rand((6, WIDE_CRITIC), gen, dev)))
    worst, bad = 0.0, []
    for learner, i, net, ws, Ws, x in stacks:
        vk, same = _twice(lambda: KS.spectral_iterate_any(Ws, x))
        vp = KS.spectral_iterate_plain(Ws, x)
        err = float((vk - vp).abs().max())
        # the band read from global memory (forced), the same sums: bitwise;
        # the other cluster size (other bands): held to the twin
        with _forced(KS, staged=False):
            streamed = bool(torch.equal(KS.spectral_iterate_any(Ws, x), vk))
        plan = KS.any_plan(*Ws.shape, KS._active(dev, Ws.shape[2])
                           if Ws.is_cuda else None)
        other = [c for c in KS.CLUSTER_SIZES if c != plan.cluster][0]
        with _forced(KS, cluster=other):
            err = max(err, float((KS.spectral_iterate_any(Ws, x)
                                  - vp).abs().max()))
        worst = max(worst, err)
        log("widths", check="spectral_iterate_any", learner=learner,
            agent=i, net=net, stack=list(Ws.shape), max_abs_err=err,
            rerun_bitwise=same, streamed_bitwise=streamed,
            plan=plan._asdict(), instance=KS.instance(*Ws.shape[1:]))
        if not (err <= 1e-5 and same and streamed
                and torch.isfinite(vk).all()):
            bad.append((learner, i, net, tuple(Ws.shape), err, same,
                        streamed))
    from gym_rotor_tpu_torch.utils.config import Config as C
    agents = [TD3Agent(C(), i, dev) for i in range(2)]
    states = [a.init(init) for a in agents]
    for i, net, ws, Ws, x in _spectral_stacks(agents, states, dev, gen):
        vi, va = KS.spectral_iterate(Ws, x), KS.spectral_iterate_any(Ws, x)
        err = float((vi - va).abs().max())
        log("widths", check="spectral_iterate_any_vs_instance", agent=i,
            net=net, stack=list(Ws.shape), max_abs_err=err,
            bitwise=bool(torch.equal(vi, va)))
        if err > 1e-5:
            bad.append(("vs instance", i, net, err))
    if bad:
        raise AssertionError(f"run-time K7: {bad[:5]}")
    return worst, [s for s in stacks
                   if s[0] in ("td3_256", f"critic_{WIDE_CRITIC}")]


def width_mlp_ppo_checks(dev, gen):
    """The run-time MLP PPO actor vs its twin at ``MLP_PPO_WIDTHS`` and
    ``WIDTH_ROWS``, train and eval, log_std off zero: actions 1e-5,
    log-probs 2e-5 max(1, max |plain|), reruns bitwise; at the instances'
    widths held to the instance's result.  Returns the worst error."""
    from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as KM
    from gym_rotor_tpu_torch.models.mlp import ActorPPO
    worst, bad = 0.0, []
    for nin, nh, nact in MLP_PPO_WIDTHS + ((15, 16, 4), (3, 4, 1),
                                          (23, 16, 4)):
        actor = ActorPPO(nin, nh, nact, device="cpu", generator=torch.Generator(
        ).manual_seed(SEED + nh)).to(dev)
        with torch.no_grad():
            actor.log_std.copy_(torch.linspace(-0.6, 0.5, nact))
        inst = (nin, nh, nact) in KM.INSTANCES
        for nb in WIDTH_ROWS:
            o = _rand((nb, nin), gen, dev)
            nz = _rand((nb, nact), gen, dev)
            for noise in (nz, None):
                with torch.no_grad():
                    k = KM.mlp_ppo_actor_any(actor, o, noise)
                    k2 = KM.mlp_ppo_actor_any(actor, o, noise)
                    p = (KM.mlp_ppo_actor(actor, o, noise) if inst else
                         KM.mlp_ppo_actor_plain(actor, o, noise))
                ea = float((k[0] - p[0]).abs().max())
                el, tl, _ = _err(k[1], p[1])
                same = all(torch.equal(a, c) for a, c in zip(k, k2))
                worst = max(worst, ea, el)
                if nb in (1, 4096) or ea > 1e-5 or el > tl or not same:
                    log("widths", check="mlp_ppo_actor_any", dims=[nin, nh,
                                                                  nact],
                        batch=nb, train=noise is not None,
                        vs="instance" if inst else "plain", max_abs_err=ea,
                        logp_err=el, rerun_bitwise=same,
                        bitwise=[bool(torch.equal(a, c))
                                 for a, c in zip(k, p)])
                if ea > 1e-5 or el > tl or not same:
                    bad.append(((nin, nh, nact), nb, ea, el, same))
    if bad:
        raise AssertionError(f"run-time MLP PPO actor: {bad[:5]}")
    return worst


def width_cli(dev):
    """``python -m gym_rotor_tpu_torch.train``'s entry point (``main(argv)``)
    at the slice width in a temporary directory: 1 warm and 3 train TD3
    supersteps at B envs with an eval before training and every 2
    supersteps' env-steps; exact launch counts per superstep and per eval,
    the run-time kernels among them.  Returns the run's launches."""
    import os
    import shutil
    import tempfile

    from gym_rotor_tpu_torch import train as T
    wr = _wrappers()
    rec = dict(evals=[], bad=[], steps=0)
    orig = (T.Learner.eval_policy, T.Learner.superstep)

    def counts():
        return {k: w.launches for k, w in wr.items()}

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()
                if v != before[k]}

    def eval_policy(self):
        before = counts()
        out = orig[0](self)
        rec["evals"].append(self.total_timesteps)
        want = route_widths(expected_eval_launches(self.cfg), self.agents,
                            dev)
        if delta(before) != want:
            rec["bad"].append(("eval", delta(before), want))
        return out

    def superstep(self):
        before = counts()
        warm, metrics, ret = orig[1](self)
        rec["steps"] += 1
        gated = not warm and \
            self.states[0].total_it % self.cfg.policy_update_freq == 0
        fwd, bwd = (expected_td3_shapes(self.cfg, self.agents, dev, gated)
                    if not warm else (Counter(), Counter()))
        want = route_widths(expected_launches(self.cfg, warm, gated),
                            self.agents, dev, fwd, bwd,
                            (1, 1 if gated else 0))
        if delta(before) != want:
            rec["bad"].append(("superstep", rec["steps"], delta(before),
                               want))
        return warm, metrics, ret

    argv = ["--num_envs", str(B), "--start_timesteps", str(B),
            "--max_timesteps", str(4 * B), "--eval_freq", str(2 * B),
            "--actor_hidden_dim", "64", "16", "--critic_hidden_dim", "256"]
    cwd, tmp = os.getcwd(), tempfile.mkdtemp(prefix="widths_cli_")
    torch.cuda.synchronize()
    for w in wr.values():
        w.launches = 0
    T.Learner.eval_policy, T.Learner.superstep = eval_policy, superstep
    t0 = time.perf_counter()
    try:
        os.chdir(tmp)
        learner = T.main(argv, device=dev)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        T.Learner.eval_policy, T.Learner.superstep = orig
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: v for k, v in counts().items() if v}
    log("widths", check="cli", argv=argv, supersteps=rec["steps"],
        evals=rec["evals"], launches=launches,
        cfg=[list(learner.cfg.actor_hidden_dim),
             learner.cfg.critic_hidden_dim],
        wall_s=time.perf_counter() - t0, mismatches=rec["bad"][:3])
    if rec["bad"] or rec["evals"] != [0, 2 * B, 4 * B] \
            or rec["steps"] != 4:
        raise AssertionError(f"widths CLI run: {rec['bad'][:3]}, evals "
                             f"{rec['evals']}, supersteps {rec['steps']}")
    return launches


def _specs_of(agents, dev):
    """``{dims: BlockSpec}`` of the TD3 agents' actor and critic blocks."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    nets = [n for a in agents for n in (a.actor_net.network,
                                        a.critic_net.network1,
                                        a.critic_net.network2)]
    specs = [K.block_spec(blk, dev) for n in nets for blk in n.blocks()]
    return {s.dims: s for s in specs}


def any_block_work(spec, nb, kind, flag):
    """(bytes, operations) of one run-time K3 (``kind``
    "emlp_block_any", ``flag`` save) or K4 (``flag`` the parameter sums)
    call at ``nb`` rows, as ``width_block_timing`` counts them.  The index
    words each step reads: the forward its gate, rowptr and each nonzero's
    packed ``(j, i)``; the backward the list entries' nonzeros (``cl_e``),
    the gate and its inverse, each list entry's packed word and the
    segments, and with the sums each nonzero's ``o``, ``j`` and ``i``
    (the list values ``vl`` are the backward's own scratch, not counted)."""
    nin, ng, nh = spec.dims
    if kind == "emlp_block_any":
        ints = nh + (ng + 1) + spec.nnz
        flops = nb * (2 * ng * nin + 3 * ng + 3 * spec.nnz + 4 * nh)
        nbytes = 4 * (nb * nin + ng * nin + ng + spec.nnz + ints
                      + nb * nh + (2 * ng * nb if flag else 0))
        return nbytes, flops
    ints = 2 * spec.nnz + nh + (ng + 1 + nh) + 2 * spec.nnz \
        + spec.rt_segments()[0].numel() + (3 * spec.nnz if flag else 0)
    flops = nb * (8 * ng + 6 * spec.nnz + ng + 2 * ng * nin)
    n_par = ng * nin + ng + spec.nnz
    if flag:
        flops += nb * (2 * ng * nin + ng + 4 * spec.nnz)
    nbytes = 4 * (nb * nh + nb * nin + ng * nin + spec.nnz + 2 * ng * nb
                  + ints + nb * nin + (n_par if flag else 0))
    return nbytes, flops


def width_block_timing(shapes, specs, gen, dev):
    """Run-time K3 and K4 per (dims, rows, flag) the slice's runs launched
    (``shapes``: their ``by_shape`` counts), weighted by launches: device
    time, the twin's and the bound.  Forward: per row 2 ng nin + ng of the
    linear step, 3 a nonzero, 2 ng of 0.1 q + lin and 4 nh of the gate;
    bytes x, W_eff, b_eff, v, the index, h (and lin, pre saved).
    Backward: per row ~8 ng of g_pre, 3 per list entry (2 nnz entries) and
    ng of the add, 2 ng nin of g_x; with the parameter sums 2 ng nin + ng +
    4 nnz more; bytes g_h, x, W_eff, v, lin, pre, the index, g_x (and the
    parameters' gradients)."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    out = {"emlp_block_any": [], "emlp_block_backward_any": []}
    for kind, counter in zip(("emlp_block_any", "emlp_block_backward_any"),
                             shapes):
        for (dims, nb, flag), n in sorted(counter.items()):
            if dims in K.INSTANCES:
                continue
            spec = specs[dims]
            x, W, b, v, g_h = _block_operands(spec, nb, gen, dev)
            if kind == "emlp_block_any":
                fn = lambda: K.emlp_block_any(spec, x, W, b, v, flag)
                plain = lambda: K.emlp_block_plain(spec, x, W, b, v, flag)
            else:
                _, lin, pre = K.emlp_block_any(spec, x, W, b, v)
                fn = lambda: K.emlp_block_backward_any(spec, g_h, x, W, v,
                                                       lin, pre, flag)
                plain = lambda: K.emlp_block_backward_plain(
                    spec, g_h, x, W, v, lin, pre, flag)
            nbytes, flops = any_block_work(spec, nb, kind, flag)
            k_ms, k_wall = device_ms(fn, 20)
            p_ms, _ = device_ms(plain, 3, 3)
            bms, by = bound_ms(nbytes, flops)
            log("kernels", kernel=kind, path="widths", dims=list(dims),
                batch=nb, flag=flag, launches=n, ms=k_ms,
                wall_ms_per_call=k_wall, plain_ms=p_ms, bytes=nbytes,
                flops=flops, bound_ms=bms, bound_by=by, library_ms=None)
            out[kind].append((n, k_ms, p_ms, bms, by, None))
    return out


def width_records(dev, runs, errs, shapes, specs, actors, stacks, gen):
    """One kernel record per run-time-width wrapper: launches over the
    slice's runs (``runs``: each run's launch counts), the worst error of
    its checks, and times at the slice's shapes weighted by launches."""
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as KM
    from gym_rotor_tpu_torch.kernels import spectral as KS
    total = Counter()
    for r in runs:
        total.update(r)
    missing = [k for k in ANY_SOURCES if not total.get(k)]
    if missing:
        raise AssertionError(f"the slice's runs launched no {missing}")
    inst = width_block_timing(shapes, specs, gen, dev)
    for kind, agents in actors.items():
        name = ANY_ACTOR[kind]
        inst[name] = []
        for i, actor in enumerate(agents):
            f = KA.fold_actor(actor)
            # the training paths' rows and an eval's (the tanh head acts in
            # both; the others' evals draw nothing)
            for nb, train in ((B, kind != "tanh"), (10, False)):
                o = _rand((nb, f["dims"][0]), gen, dev)
                noise = _rand((nb, f["dims"][3]), gen, dev) if train \
                    else None
                args = (actor, o) if kind == "tanh" else (actor, o, noise)
                fn = lambda: getattr(KA, name)(*args)
                with torch.no_grad():
                    k_ms, k_wall = device_ms(fn, 50)
                    p_ms, _ = device_ms(lambda: getattr(
                        KA, name.replace("_any", "_plain"))(*args), 5, 3)
                    kernels = launches_per_call(fn)
                nbytes, flops = actor_work(f, nb, kind, train)
                bms, by = bound_ms(nbytes, flops)
                log("kernels", kernel=name, path="widths", agent=i,
                    dims=list(f["dims"]), batch=nb, train=train, ms=k_ms,
                    wall_ms_per_call=k_wall, plain_ms=p_ms, bytes=nbytes,
                    flops=flops, bound_ms=bms, bound_by=by, library_ms=None,
                    kernels_a_call=kernels, warps=f["warps"])
                if kernels != 1:
                    raise AssertionError(f"{name}: {kernels} kernels a call")
                if nb == B:
                    inst[name].append((1, k_ms, p_ms, bms, by, None))
    inst["spectral_iterate_any"] = []
    timed = set()
    for learner, i, net, ws, Ws, x in stacks:
        if KS.instance(*Ws.shape[1:]) is not None or \
                (learner, tuple(Ws.shape)) in timed:
            continue
        timed.add((learner, tuple(Ws.shape)))
        fn = lambda: KS.spectral_iterate_any(Ws, x)
        k_ms, k_wall = device_ms(fn, 20)
        p_ms, _ = device_ms(lambda: KS.spectral_iterate_plain(Ws, x), 5, 3)
        kernels = launches_per_call(fn)
        true = sum(int(W.numel()) for W in ws)
        nbytes = 4 * (true + 2 * sum(int(W.shape[1]) for W in ws))
        bms, by = bound_ms(nbytes, KS.ITERS * (4 * true + 3 * x.numel()))
        log("kernels", kernel="spectral_iterate_any", path="widths",
            learner=learner, agent=i, net=net, stack=list(Ws.shape), ms=k_ms,
            wall_ms_per_call=k_wall, plain_ms=p_ms, bytes=nbytes,
            bound_ms=bms, bound_by=by, library_ms=None,
            kernels_a_call=kernels, plan=KS.any_plan(
                *Ws.shape, KS._active(dev, Ws.shape[2]))._asdict())
        if kernels != 1:
            raise AssertionError(f"K7: {kernels} kernels a call")
        if learner == "td3_256":
            inst["spectral_iterate_any"].append((1, k_ms, p_ms, bms, by,
                                                 None))
    from gym_rotor_tpu_torch.models.mlp import ActorPPO
    inst["mlp_ppo_actor_any"] = []
    for nin, nh, nact in MLP_PPO_WIDTHS[:2]:
        actor = ActorPPO(nin, nh, nact, device="cpu", generator=torch.Generator(
        ).manual_seed(SEED)).to(dev)
        o, nz = _rand((B, nin), gen, dev), _rand((B, nact), gen, dev)
        with torch.no_grad():
            k_ms, k_wall = device_ms(lambda: KM.mlp_ppo_actor_any(
                actor, o, nz), 50)
            p_ms, _ = device_ms(lambda: KM.mlp_ppo_actor_plain(
                actor, o, nz), 5, 3)
        flops = B * (2 * (nin * nh + nh * nh + nh * nact) + 2 * nh + 13 * nact)
        nbytes = 4 * (B * (nin + 3 * nact) + nin * nh + nh * nh + nh * nact
                      + 2 * nh + 2 * nact)
        bms, by = bound_ms(nbytes, flops)
        log("kernels", kernel="mlp_ppo_actor_any", path="widths",
            dims=[nin, nh, nact], batch=B, ms=k_ms, wall_ms_per_call=k_wall,
            plain_ms=p_ms, bytes=nbytes, flops=flops, bound_ms=bms,
            bound_by=by, library_ms=None)
        inst["mlp_ppo_actor_any"].append((1, k_ms, p_ms, bms, by, None))
    return [_record(name, ANY_SOURCES[name], ANY_REPLACES[name],
                    total[name], errs[name], inst[name])
            for name in ANY_SOURCES]


def width_projectors(dev):
    """K5's projection bases (``models/emlp/nn.py::linear_projector``) for
    every equivariant layer of the slice width's TD3, SAC and PPO networks,
    built and moved to the card before the runs (host work a first
    superstep at a new width pays once per process), with their build time
    and bytes; K5's device time a call at the widest."""
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.algos.sac import SACAgent
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.models.emlp import nn as N
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config(**SLICE_WIDTH)
    layers = {}
    for algo, cls in (("TD3", TD3Agent), ("SAC", SACAgent),
                      ("PPO", PPOAgent)):
        for i in range(cfg.n_agents):
            a = cls(cfg.replace(rl_algo=algo), i, dev)
            for net in (a.actor_net, a.critic_net):
                for m in net.modules():
                    if isinstance(m, N.EquivLinear):
                        layers[(hash(m.rep_in), hash(m.rep_out))] = m
    t = time.perf_counter()
    sizes = {}
    for m in layers.values():
        Qw = N._projector_tensors(m.rep_in, m.rep_out, dev, torch.float32)[0]
        sizes[f"{m.rep_in.size}->{m.rep_out.size}"] = int(Qw.numel()) * 4
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    big = max(layers.values(), key=lambda m: N._projector_tensors(
        m.rep_in, m.rep_out, dev, torch.float32)[0].numel())
    k, b = big.kernel.detach(), big.bias.detach()
    k5_ms, _ = device_ms(lambda: N.project_linear(big.rep_in, big.rep_out,
                                                  k, b), 10, 3)
    log("widths", check="projectors", layers=len(layers), build_s=build_s,
        qw_bytes=sizes, k5_widest=f"{big.rep_in.size}->{big.rep_out.size}",
        k5_ms=k5_ms)


def phase_widths(dev):
    """Phase 26: any actor and critic width on the card.  Each run-time
    path against its twin at every shape of ``WIDTHS`` (and the kernel-only
    critic 512 and actor (128, 32)), rows ``WIDTH_ROWS``, reruns bitwise,
    and at default shapes against the instances; PPO B's V forward over
    ``V_ROWS`` rows; the slice's runs through ``train.train`` with exact
    launch counts per superstep (TD3, SAC, PPO B and Mod-MLP PPO B at
    (64, 16) / 256; TD3 at (32, 8) / 128 and (8, 4) / 8) and the CLI run;
    then one record per run-time wrapper."""
    from gym_rotor_tpu_torch.utils.config import PPO_CONFIGS, Config
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    errs = {}
    specs = width_block_specs(dev)
    errs["emlp_block_any"], errs["emlp_block_backward_any"] = \
        width_block_checks(dev, specs, gen)
    errs["emlp_block_any"] = max(errs["emlp_block_any"],
                                 width_v_forward(dev, gen))
    err = width_actor_checks(dev, gen)
    errs.update({n: err for n in ANY_ACTOR.values()})
    errs["spectral_iterate_any"], stacks = width_spectral_checks(dev, gen)
    errs["mlp_ppo_actor_any"] = width_mlp_ppo_checks(dev, gen)
    log("widths", check="kernels_done", t_phase_s=time.perf_counter() - t0)
    width_projectors(dev)
    runs = []
    td3_cfg = Config(num_envs=B, start_timesteps=B, **SLICE_WIDTH)
    launches, shapes, td3_run = phase_train(dev, td3_cfg, WIDTH_STEPS,
                                            name="widths_td3", widths=True)
    runs.append(launches)
    sac_launches, _, sac_run = phase_train_sac(
        dev, WIDTH_STEPS, False, cfg=td3_cfg.replace(rl_algo="SAC"),
        name="widths_sac", widths=True)
    runs.append(sac_launches)
    ppo_kw = dict(PPO_CONFIGS["B"], **SLICE_WIDTH)
    _, ppo_launches, _, ppo_run = phase_train_ppo(
        dev, "B_widths", ppo_kw, WIDTH_PPO_STEPS, widths=True)
    runs.append(ppo_launches)
    runs.append(phase_train_ppo(dev, "B_widths_mlp",
                                dict(ppo_kw, use_equiv=False),
                                WIDTH_PPO_STEPS, widths=True)[1])
    for ah, ch in WIDTHS[:2]:
        runs.append(phase_train(dev, Config(
            num_envs=B, start_timesteps=B, actor_hidden_dim=ah,
            critic_hidden_dim=ch), WIDTH_SMALL_STEPS,
            name=f"widths_td3_{ch}", widths=True)[0])
    runs.append(width_cli(dev))
    actors = {"tanh": [a.actor_net for a in td3_run["agents"]],
              "gauss": [a.actor_net for a in sac_run["agents"]],
              "ppo": [a.actor_net for a in ppo_run["agents"]]}
    records = width_records(dev, runs, errs, shapes,
                            _specs_of(td3_run["agents"], dev), actors,
                            stacks, gen)
    log("widths", check="done", t_phase_s=time.perf_counter() - t0,
        records=[r["name"] for r in records])
    return records


def widths_resources(dev):
    """The run-time-width kernels' registers and spills (``-Xptxas -v``)
    and their launches' shared memory at phase 26's shapes, each held to
    the wrappers' arithmetic: K3/K4's staged steps (``rt_smem``; the static
    ones from the library's geometry), the acting kernel's ``any_plan``,
    K7's ``any_plan`` (its shared memory the library's ``any_smem``, the
    clusters the card runs at once)."""
    import re
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.kernels import emlp_block as KB
    from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as KM
    from gym_rotor_tpu_torch.kernels import spectral as KS
    pat = re.compile(r"(rt_\w+?_kernel(?:ILi\dELb\d)?|"
                     r"emlp_actor_any_kernelILi\dELb\d|"
                     r"spectral_any_kernelILb\d|"
                     r"mlp_ppo_actor_any_kernelILi\d+)")
    regs, bad = {}, []
    for src in (KB.KERNEL, KA.KERNEL, KS.KERNEL, KM.KERNEL):
        cur = None
        for ln in src.ptxas.splitlines():
            m = pat.search(ln)
            if "Compiling entry function" in ln:
                cur = m.group(1) if m else None
                if cur:
                    regs[cur] = {}
            elif cur and "spill stores" in ln:
                n = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
                regs[cur].update(spill_stores=n[1], spill_loads=n[2])
            elif cur and "registers" in ln:
                regs[cur]["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
    want = {"rt_lin_kernel", "rt_gpre_kernel", "rt_gx_kernel",
            "rt_gw_kernel", "rt_finish_kernel", "spectral_any_kernelILb0",
            "spectral_any_kernelILb1"} | {
        f"rt_{k}_kernelILi{r}ELb{g}" for k in ("gate", "list")
        for r, g in ((1, 0), (1, 1), (2, 1))} | {
        f"emlp_actor_any_kernelILi{h}ELb{g}"
        for h in range(3) for g in (0, 1)} | {
        "mlp_ppo_actor_any_kernelILi8", "mlp_ppo_actor_any_kernelILi1"}
    if set(regs) != want or not all(regs.values()):
        bad.append(("ptxas entries", sorted(regs)))
    lib = KB._lib()
    static = [lib.emlp_block_rt_geometry(k) for k in range(5)]
    if static != [KB.RT_WARPS * 32, KB.RT_RING, KB.RT_SLOTS,
                  KB.RT_GEMM_TILE, KB.RT_RING_BYTES // 4]:
        bad.append(("run-time geometry", static))
    smem = {}
    for dims, spec in sorted(width_block_specs(dev).items()):
        for nb in (256, 4096):
            lay = [spec.rt_layout(k, nb) for k in ("forward", "backward")]
            smem[f"{dims} {nb}"] = [
                [r, st, KB.rt_smem(dims, k, r if st else 0)]
                for k, (r, st) in zip(("forward", "backward"), lay)]
            if max(b for _, _, b in smem[f"{dims} {nb}"]) > KB.SMEM_LIMIT:
                bad.append(("K3/K4", dims, nb, smem[f"{dims} {nb}"]))
    log("build", kernel="run-time widths", ptxas=regs, geometry=static,
        block_layout_rows_staged_smem=smem)
    for ah, i, head, actor in width_actors(dev):
        f = KA.fold_actor(actor)
        plan = KA.any_plan(f["dims"], f["layout"], f["slots"],
                           KA.plan_words(f))
        log("build", kernel="emlp_actor_any", width=list(ah), agent=i,
            head=head, dims=list(f["dims"]), image_words=f["layout"]["words"],
            stage_image=plan[0], tile_in_smem=plan[1], smem_bytes=plan[2],
            warps=f["warps"], slots=f["slots"], plan_words=KA.plan_words(f))
        if plan[2] > KA.SMEM_LIMIT:
            bad.append(("acting", f["dims"], plan))
    lib = KS._lib()
    for K, mo, mi in ((6, 255, 128), (6, 288, 256), (6, 511, 256),
                      (6, 568, 512), (6, 1023, 512)):
        p = KS.any_plan(K, mo, mi, KS._active(dev, mi))
        log("build", kernel="spectral_iterate_any", stack=[K, mo, mi],
            plan=p._asdict(), clusters_at_once=KS._active(dev, mi)(p))
        if KS.instance(mo, mi) is not None or not p.staged \
                or p.smem != lib.spectral_any_smem(mi, p.band, 1) \
                or p.smem > KS.SMEM_LIMIT:
            bad.append(("K7", mo, mi, p))
    if bad:
        raise AssertionError(f"run-time widths' resources: {bad}")


# ---------------------------------------------------------------------------
# Phase 27: data-parallel training over a process group
# ---------------------------------------------------------------------------
GAE_SHARDED_SHAPES = ((218, 16), (50, B // 2))   # PPO A and B at 2 ranks
GAE_SHARDED_EDGES = ((1, 7), (218, 32), (50, B), (7000, 32), (7000, 257),
                     (50, 257))
MULTI_TD3 = (1, 6)           # warm, train supersteps of the flagship
MULTI_SAC = (1, 3)
MULTI_PPO = 2                # PPO B supersteps
MULTI_TIMEOUT = 900          # seconds a child group may take


def gae_sharded_checks(dev):
    """Phase 27 (c): K12's sharded route (``gae_sharded``, three launches)
    at world 1 on the card: at ``GAE_SHARDED_SHAPES`` (PPO A's and B's
    horizons at 2 ranks) and ``GAE_SHARDED_EDGES`` (one CTA, a cluster, the
    grid, tiles streamed) bitwise the one-launch K12 (its sums run in
    K12's order), a rerun bitwise, and within 1e-5 max(1, max |plain|) of
    the plain twin ``gae_sharded_plain`` on the CPU.  Returns the worst
    error."""
    from gym_rotor_tpu_torch.kernels import gae as K
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config()
    g, lam = cfg.discount, cfg.GAE_lambda
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    worst, bad = 0.0, []
    for T, nb in GAE_SHARDED_SHAPES + GAE_SHARDED_EDGES:
        x = _gae_inputs(T, nb, gen, dev)
        one = K.gae(*x, g, lam)
        sh = K.gae_sharded(*x, g, lam)
        sh2 = K.gae_sharded(*x, g, lam)
        plain = K.gae_sharded_plain(*(t.cpu() for t in x), g, lam)
        errs = {"advantages": _err(sh[0].cpu(), plain[0], 1e-5),
                "td": _err(sh[1].cpu(), plain[1], 1e-5)}
        same = _bitwise(list(one), list(sh))
        rerun = _bitwise(list(sh), list(sh2))
        worst = max([worst] + [e[0] for e in errs.values()])
        log("multi_gae", T=T, envs=nb, plan=list(K.gae_plan(T, nb)),
            bitwise_one_launch=same, rerun_bitwise=rerun,
            max_abs_err={k: e[0] for k, e in errs.items()})
        bad += [(T, nb, k, e[0]) for k, e in errs.items()
                if not (e[0] <= e[1] and e[2])]
        if not (same and rerun):
            bad.append((T, nb, "bitwise", same, rerun))
    if bad:
        raise AssertionError(f"gae_sharded disagrees: {bad}")
    return worst


def gae_sharded_records(dev, err, launches):
    """One record per launch of the sharded route (A ``mean``, B ``var``,
    C ``norm``) at PPO B's horizon at 2 ranks, the one the gloo run
    launched (``launches`` by stage), its times logged at PPO A's too:
    device time, the plain torch's time of the same step, the bound
    (bytes: A reads 4 and writes 2 floats an entry, B reads 1, C reads
    and writes 1)."""
    from gym_rotor_tpu_torch.kernels import gae as K
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config()
    g, lam = cfg.discount, cfg.GAE_lambda
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    work = {"mean": (24, 14), "var": (4, 3), "norm": (8, 2)}
    inst = {s: [] for s in K.SHARDED_STAGES}
    for T, nb in GAE_SHARDED_SHAPES:
        x = _gae_inputs(T, nb, gen, dev)
        adv, td = torch.empty_like(x[0]), torch.empty_like(x[0])
        mean, var = (torch.empty(1, device=dev) for _ in range(2))
        plan = K.gae_plan(T, nb)
        N = 2 * T * nb
        raw = K._scan_plain(*x, g, lam)
        m, v2 = raw.mean(), torch.mean((raw - raw.mean()) ** 2)
        plain = {
            "mean": lambda: K._scan_plain(*x, g, lam).mean(),
            "var": lambda: torch.mean((raw - m) ** 2),
            "norm": lambda: (raw - m) / (torch.sqrt(v2 * N / (N - 1))
                                         + 1e-4)}
        for stage in K.SHARDED_STAGES:
            def run(stage=stage):
                K.sharded_launch(stage, *x, g, lam, adv, td, mean, var, plan,
                                 2)
            if stage == "norm":
                K.sharded_launch("mean", *x, g, lam, adv, td, mean, var,
                                 plan, 2)
                K.sharded_launch("var", *x, g, lam, adv, td, mean, var,
                                 plan, 2)
            k_ms, k_wall = device_ms(run, 100)
            p_ms, _ = device_ms(plain[stage], 3 if stage == "mean" else 50,
                                3)
            by_bytes, flops = work[stage]
            bms, by = bound_ms(by_bytes * T * nb, flops * T * nb)
            if nb == B // 2:
                inst[stage].append((1, k_ms, p_ms, bms, by, None))
            log("kernels", kernel=f"gae_sharded_{stage}", T=T, envs=nb,
                plan=list(plan), ms=k_ms, wall_ms_per_call=k_wall,
                plain_ms=p_ms, bytes=by_bytes * T * nb, bound_ms=bms,
                bound_by=by, library_ms=None)
    return [_record(f"gae_sharded_{s}", "gae.cu",
                    "gym_rotor_tpu/algos/ppo.py:136", launches.get(s, 0),
                    err, inst[s]) for s in K.SHARDED_STAGES]


def _local_cfg(cfg, world):
    """``cfg`` as one rank of ``world`` sees its sizes: a one-device run
    at ``num_envs / world`` envs (PPO: the same ticks a horizon), its
    ring and batch split likewise."""
    kw = dict(num_envs=cfg.num_envs // world,
              batch_size=max(cfg.batch_size // world, 1),
              replay_buffer_size=cfg.replay_buffer_size // world)
    if cfg.rl_algo == "PPO":
        kw["T_horizon"] = cfg.T_horizon // world
    return cfg.replace(**kw)


def _multi_expected(cfg, local, agents, dev, i, warm, mesh):
    """One rank's launches, K3/K4 shapes and all-reduces in superstep
    ``i`` (0 the first): a one-device superstep at ``local``'s sizes; PPO's
    K12 through the sharded route over a sharded ``mesh``."""
    n = cfg.n_agents
    if cfg.rl_algo == "PPO":
        want, fwd, bwd = expected_launches_ppo(local, agents, dev, i == 0)
        rl, T, na, mba, nc, mbc = _ppo_dims(local)
        ars = n * (cfg.K_epochs * (na + nc) + 2) + 1
        if mesh.sharded:
            del want["gae"]
            want["gae_sharded"] = 3 * n
        return want, fwd, bwd, ars
    if cfg.rl_algo == "SAC":
        want = expected_launches_sac(local, warm)
        fwd, bwd = ((Counter(), Counter()) if warm else
                    expected_sac_shapes(local, agents, dev))
        ars = 1 if warm else 2 * n + 1
    else:
        gated = not warm and i % cfg.policy_update_freq == 0
        want = expected_launches(local, warm, gated)
        fwd, bwd = ((Counter(), Counter()) if warm else
                    expected_td3_shapes(local, agents, dev, gated))
        ars = 1 if warm else n * (2 if gated else 1) + 1
    if i == 0:
        want["env_tick"] += 1          # the learner's batched reset
    return want, fwd, bwd, ars


class _AllReduces:
    """Counts ``torch.distributed.all_reduce`` calls and their wall time
    (synchronised before and after each) while active."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.orig = dist, dist.all_reduce
        self.calls, self.seconds = 0, 0.0

    def __enter__(self):
        def counted(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(*a, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig


MULTI_RUNS = (("td3", {}, MULTI_TD3),
              ("sac", dict(rl_algo="SAC", automatic_entropy_tuning=True),
               MULTI_SAC),
              ("ppo_b", None, (0, MULTI_PPO)))


def _multi_cfg(kw):
    from gym_rotor_tpu_torch.utils.config import PPO_CONFIGS, Config
    if kw is None:
        return Config(**PPO_CONFIGS["B"])
    return Config(num_envs=B, start_timesteps=B, **kw)


def _learner_leaves(L, rank_local=True):
    """A learner's tensors by name: its agents' states (without the per
    rank temperature unless ``rank_local``), the ring or the horizon, the
    env state, the observations and ``ep_ret``."""
    from gym_rotor_tpu_torch.utils.checkpoint import RANK_FIELDS
    from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
    out = {}
    for j, st in enumerate(L.states):
        for k, v in tree_named_leaves(st):
            if rank_local or k.split(".")[0] not in RANK_FIELDS:
                out[f"agent{j}.{k}"] = v
    if L.off_policy:
        out["ring"] = L.replay.data
    else:
        out["horizon"] = L.horizon.ring.data
    for k, v in tree_named_leaves(L.loop.state):
        out[f"env.{k}"] = v
    for j, o in enumerate(L.obs):
        out[f"obs{j}"] = o
    out["ep_ret"] = L.ep_ret
    return out


def multi_train(dev, mesh, name, kw, steps, check_ranks):
    """One learner over ``mesh`` for ``steps`` (warm, train) supersteps:
    per superstep this rank's exact launches and K3/K4 shapes (a
    one-device run at its share of the sizes), its all-reduces, finite
    losses and, when ``check_ranks``, every replicated tensor bitwise
    equal on every rank (gathered).  Returns the run's summary and the
    learner."""
    from gym_rotor_tpu_torch.kernels import gae as KG
    from gym_rotor_tpu_torch.train import Learner
    cfg = _multi_cfg(kw)
    local = _local_cfg(cfg, mesh.world)
    wr = _wrappers()
    torch.cuda.synchronize()
    for w in wr.values():
        w.launches = 0
    KG.gae_sharded.by_stage.update({s: 0 for s in KG.SHARDED_STAGES})
    clear_block_shape_counts()
    last, pfwd, pbwd = {}, Counter(), Counter()
    bad, ars, ar_s, metrics_seen = [], [], [], []
    L = Learner(cfg, device=dev, mesh=mesh)
    for i in range(sum(steps)):
        with _AllReduces() as ar:
            warm, metrics, _ = L.superstep()
            torch.cuda.synchronize()
        now = {k: w.launches for k, w in wr.items()}
        got = {k: v - last.get(k, 0) for k, v in now.items()
               if v - last.get(k, 0)}
        last = now
        want, wfwd, wbwd, want_ar = _multi_expected(cfg, local, L.agents,
                                                    dev, i, warm, mesh)
        if not cfg.use_equiv or warm:
            wfwd, wbwd = Counter(), Counter()
        fwd, bwd = block_shape_counts()
        gfwd, gbwd = fwd - pfwd, bwd - pbwd
        pfwd, pbwd = fwd, bwd
        if got != want:
            bad.append((i, "launches", got, want))
        if gfwd != wfwd or gbwd != wbwd:
            bad.append((i, "shapes", dict(gfwd), dict(wfwd)))
        if mesh.sharded and ar.calls != want_ar:
            bad.append((i, "all_reduces", ar.calls, want_ar))
        ars.append(ar.calls)
        ar_s.append(ar.seconds)
        vals = {k: v.detach().double().cpu().reshape(-1).tolist()
                for k, v in metrics.items()}
        metrics_seen.append(vals)
        if not all(math.isfinite(x) for v in vals.values() for x in v):
            bad.append((i, "non-finite", vals))
        if check_ranks:
            diff = [k for k, v in _learner_leaves(L, False).items()
                    if k.startswith("agent") and isinstance(v, torch.Tensor)
                    and not _ranks_equal(v, mesh)]
            if diff:
                bad.append((i, "ranks differ", diff[:4]))
    launches = {k: w.launches for k, w in wr.items() if w.launches}
    alpha = ([float(st.log_alpha) for st in L.states]
             if hasattr(L.states[0], "log_alpha") else None)
    return dict(name=name, launches=launches,
                mismatches=[repr(b)[:600] for b in bad[:4]],
                allreduces=ars, allreduce_ms=[1e3 * s for s in ar_s],
                metrics=metrics_seen, log_alpha=alpha,
                gae_sharded=dict(KG.gae_sharded.by_stage)), L


def _ranks_equal(t, mesh):
    """``t`` the same bit for bit on every rank (gathered)."""
    from gym_rotor_tpu_torch.parallel import mesh as M
    x = t.detach().reshape(1, -1)
    if x.dtype.is_floating_point:
        x = x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)
    rows = M.gather_rows(x, mesh)
    return all(torch.equal(rows[0], r) for r in rows[1:])


def multi_world1(dev, mesh):
    """Phase 27 (a) in a child holding an ``nccl`` group of one rank: the
    flagship TD3 (1 warm + 6) and PPO B (2 supersteps) over the group and
    on a mesh without one (the one-device path), from the same seed:
    launches, metrics, parameters, optimizer states, ring or horizon, env
    state bitwise; then the all-reduces a world of 2 would make in a
    superstep, timed on the group (CUDA events)."""
    import torch.distributed as dist
    from gym_rotor_tpu_torch.parallel import mesh as M
    out, bad = {}, []
    for name, kw, steps in (MULTI_RUNS[0], MULTI_RUNS[2]):
        a, La = multi_train(dev, mesh, name, kw, steps, False)
        b, Lb = multi_train(dev, M.Mesh(0, 1, dev), name, kw, steps, False)
        la, lb = _learner_leaves(La), _learner_leaves(Lb)
        diff = [k for k in la if not (
            _bitwise([la[k]], [lb[k]]) if isinstance(la[k], torch.Tensor)
            else la[k] == lb[k])]
        same = (not diff and a["metrics"] == b["metrics"]
                and a["launches"] == b["launches"])
        out[name] = dict(bitwise=same, differ=diff[:5],
                         launches=a["launches"], mismatches=a["mismatches"]
                         + b["mismatches"], allreduces=a["allreduces"])
        if not same or a["mismatches"] or b["mismatches"] or \
                any(a["allreduces"]):
            bad.append((name, diff[:5], a["mismatches"], b["mismatches"],
                        a["allreduces"]))
        if name == "td3":
            n = La.cfg.n_agents
            sizes = {"critic": La.agents[0].critic_layout.size,
                     "actor": La.agents[0].actor_layout.size}
            metrics = 3 + n + 2 * n            # mean, fin_sum, cnt, losses
            for gated in (False, True):
                bufs = [torch.zeros(sizes["critic"], device=dev)
                        for _ in range(n)]
                if gated:
                    bufs += [torch.zeros(sizes["actor"], device=dev)
                             for _ in range(n)]
                bufs.append(torch.zeros(metrics, device=dev))

                def call(bufs=bufs):
                    for t in bufs:
                        dist.all_reduce(t, group=mesh.group)
                ms, wall = device_ms(call, 50)
                out[f"allreduce_{'gated' if gated else 'ungated'}"] = dict(
                    calls=len(bufs), floats=sum(t.numel() for t in bufs),
                    device_ms=ms, wall_ms=wall)
        del La, Lb
        torch.cuda.empty_cache()
    out["bad"] = bad
    return out


def multi_gae_world2(dev, mesh):
    """Phase 27 (c) at world 2, on each rank: K12's sharded route over
    ``mesh`` (its mean and variance all-reduced, the std Bessel-corrected
    over both ranks' entries) at ``GAE_SHARDED_SHAPES`` (the rank's share
    of PPO A's and B's horizons) against the plain twin
    ``gae_sharded_plain`` on CPU copies, which ``gloo`` reduces on the
    host, within 1e-5 max(1, max |plain|).  Each rank draws its own
    inputs and shifts its rewards by its rank, so that the global mean is
    neither rank's: the result must also move past the tolerance from
    this rank's horizon normalised alone.  On the card each call must make
    its three launches.  Returns ``(worst error, mismatches)``."""
    from gym_rotor_tpu_torch.kernels import gae as K
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config()
    g, lam = cfg.discount, cfg.GAE_lambda
    gen = torch.Generator(device=dev).manual_seed(SEED + 29 + mesh.rank)
    worst, bad = 0.0, []
    for T, nb in GAE_SHARDED_SHAPES:
        v, nv, r, d = _gae_inputs(T, nb, gen, dev)
        x = (v, nv, r + mesh.rank, d)
        before = K.gae_sharded.launches
        sh = K.gae_sharded(*x, g, lam, mesh)
        launched = K.gae_sharded.launches - before
        plain = K.gae_sharded_plain(*(t.cpu() for t in x), g, lam, mesh)
        alone = K.gae_sharded_plain(*(t.cpu() for t in x), g, lam)
        errs = {"advantages": _err(sh[0].cpu(), plain[0], 1e-5),
                "td": _err(sh[1].cpu(), plain[1], 1e-5)}
        moved = _err(alone[0], plain[0], 1e-5)
        worst = max([worst] + [e[0] for e in errs.values()])
        log("multi_gae_world2", rank=mesh.rank, T=T, envs=nb,
            launches=launched, max_abs_err={k: e[0] for k, e in errs.items()},
            global_vs_local=moved[0])
        bad += [("gae_sharded", T, nb, k, e[0]) for k, e in errs.items()
                if not (e[0] <= e[1] and e[2])]
        if moved[0] <= moved[1]:
            bad.append(("gae_sharded", T, nb, "not global", moved[0]))
        if dev.type == "cuda" and launched != 3:
            bad.append(("gae_sharded", T, nb, "launches", launched))
    return worst, bad


def multi_world2(dev, mesh):
    """Phase 27 (b) in each of two children holding one ``gloo`` group on
    the one card: the flagship TD3 (1 warm + 6, 2048 envs a rank), SAC
    with the temperature tuned (1 warm + 3) and PPO B (2), each checked by
    ``multi_train`` with every replicated tensor compared across the
    ranks after every superstep; then (c) K12's sharded route at world 2
    (``multi_gae_world2``)."""
    out, bad = {}, []
    for name, kw, steps in MULTI_RUNS:
        r, L = multi_train(dev, mesh, name, kw, steps, True)
        out[name] = r
        if r["mismatches"]:
            bad.append((name, r["mismatches"]))
        del L
        torch.cuda.empty_cache()
    out["gae_err"], gae_bad = multi_gae_world2(dev, mesh)
    bad += gae_bad
    out["bad"] = bad
    return out


def multi_child(argv):
    """A phase 27 child: ``--multi-child JOB RANK WORLD BACKEND STORE OUT``
    opens the group through a ``FileStore`` at STORE on ``cuda:0``, runs
    ``multi_world1`` (JOB ``world1``) or ``multi_world2`` and writes its
    result as JSON to OUT."""
    import torch.distributed as dist
    from gym_rotor_tpu_torch.parallel import mesh as M
    job, rank, world, backend, store_path, out_path = argv
    rank, world = int(rank), int(world)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    global CARD
    CARD = gpu_name_power()
    store = dist.FileStore(store_path, world)
    if world > 1:
        M.initialize_distributed(rank=rank, world_size=world, device=dev,
                                 backend=backend, store=store)
    else:
        dist.init_process_group(backend, rank=0, world_size=1, store=store)
    try:
        mesh = M.make_mesh(dev)
        res = (multi_world1 if job == "world1" else multi_world2)(dev, mesh)
        res.update(rank=rank, world=mesh.world, backend=mesh.backend)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def _children(job, world, backend, tmp):
    """Run ``world`` phase 27 children for ``job`` and return their
    results in rank order; any child failing fails the phase."""
    import os
    store = os.path.join(tmp, f"{job}.store")
    outs = [os.path.join(tmp, f"{job}.{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multi-child", job,
         str(r), str(world), backend, store, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs_, codes = [], []
    try:
        for p in procs:
            logs_.append(p.communicate(timeout=MULTI_TIMEOUT)[0])
            codes.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (code, text) in enumerate(zip(codes, logs_)):
        if text.strip():
            print("\n".join(f"  [{job} rank {r}] {ln}"
                            for ln in text.strip().splitlines()[-40:]),
                  flush=True)
        if code != 0:
            raise AssertionError(f"phase 27 {job}: rank {r} exited {code}")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def multi_torchrun(tmp):
    """Phase 27 (a): ``python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m gym_rotor_tpu_torch.train`` with the flagship at
    B envs for 4 supersteps (2 warm; ``driver_argv``): it trains, evaluates
    and checkpoints; returns its wall seconds."""
    import os
    import shutil
    root = os.path.dirname(os.path.abspath(__file__))
    cwd = os.path.join(tmp, "torchrun")
    os.makedirs(cwd)
    ckpt = os.path.join(cwd, "ckpt", "ts.msgpack")
    env = dict(os.environ,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "gym_rotor_tpu_torch.train"]
        + driver_argv(ckpt, supersteps=4), cwd=cwd, env=env,
        capture_output=True, text=True, timeout=MULTI_TIMEOUT)
    wall = time.perf_counter() - t0
    out = p.stdout + p.stderr
    evals = out.count("eval_reward")
    logs_ = sorted(os.listdir(os.path.join(cwd, "results"))) \
        if os.path.isdir(os.path.join(cwd, "results")) else []
    ok = (p.returncode == 0 and "training over 1 device(s)" in out
          and os.path.exists(ckpt) and evals == 3 and logs_)
    log("multi_torchrun", returncode=p.returncode, wall_s=wall, evals=evals,
        checkpoint=os.path.exists(ckpt), results=logs_)
    if not ok:
        print(out[-4000:], flush=True)
        raise AssertionError("phase 27: the torchrun entry point failed")
    shutil.rmtree(cwd, ignore_errors=True)
    return wall


def phase_multi(dev):
    """Phase 27: data-parallel training over a process group, each group
    in child processes (this process never holds one).  (c) K12's sharded
    route on the card at world 1; (a) an ``nccl`` group of one rank
    bitwise the one-device path, its all-reduces timed, and the
    ``torchrun`` entry point; (b) two ``gloo`` ranks on the one card:
    exact launches and all-reduces per rank and superstep, replicated
    state bitwise across the ranks, then (c) at world 2 on each rank.
    Returns the sharded K12's records (their error the worst of (c))."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    err = gae_sharded_checks(dev)
    tmp = tempfile.mkdtemp(prefix="multi_")
    try:
        w1 = _children("world1", 1, "nccl", tmp)[0]
        log("multi_nccl1", td3=w1["td3"], ppo_b=w1["ppo_b"],
            allreduce_ms_per_superstep={
                k: w1[f"allreduce_{k}"] for k in ("ungated", "gated")})
        w2 = _children("world2", 2, "gloo", tmp)
        for r, res in enumerate(w2):
            for name, *_ in MULTI_RUNS:
                x = res[name]
                log(f"multi_gloo2_{name}", rank=r, launches=x["launches"],
                    allreduces=x["allreduces"],
                    allreduce_ms=x["allreduce_ms"], log_alpha=x["log_alpha"],
                    gae_sharded=x["gae_sharded"],
                    mismatches=x["mismatches"])
        torchrun_s = multi_torchrun(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = w1["bad"] + [b for res in w2 for b in res["bad"]]
    m0, m1 = (res["ppo_b"]["metrics"] for res in w2)
    if m0 != m1 or w2[0]["td3"]["metrics"] != w2[1]["td3"]["metrics"]:
        bad.append("reduced metrics differ across the ranks")
    alphas = [res["sac"]["log_alpha"] for res in w2]
    err = max([err] + [res["gae_err"] for res in w2])
    log("multi", wall_s=time.perf_counter() - t0, torchrun_s=torchrun_s,
        sac_log_alpha_per_rank=alphas, gae_sharded_max_abs_err=err,
        mismatches=bad[:4])
    if bad:
        raise AssertionError(f"phase 27: {bad[:4]}")
    launches = w2[0]["ppo_b"]["gae_sharded"]
    return gae_sharded_records(dev, err, launches)


# ---------------------------------------------------------------------------
# Phase 28: the general EMLP engine
# ---------------------------------------------------------------------------
GENERAL_CONFIGS = (("so3", "SO", 3), ("s4", "S", 4))
GENERAL_CH, GENERAL_LAYERS = 384, 3      # GeneralEMLP's own defaults
GENERAL_ROWS = (B,) + tuple(r for r in WIDTH_ROWS if r != B)
GENERAL_COMPARE_ROWS = 256   # network rows held to the CPU twins
GENERAL_EQUIV_TOL = 1e-4     # the JAX package's end-to-end bound
GENERAL_NET_TOL = 1e-4       # card vs CPU network, of max |CPU|
GENERAL_ADAM_STEPS = 20
GENERAL_IO_CH = 62           # the Interface's inner scoped EMLP (8 vectors)
GENERAL_REPLACES = {
    "emlp_block_any": "gym_rotor_tpu/models/emlp/general_nn.py:228",
    "emlp_block_backward_any": "gym_rotor_tpu/models/emlp/general_nn.py:205"}


def general_models(dev):
    """Both configurations' ``GeneralEMLP(V -> V)`` at ``ch`` 384 and 3
    layers (seeded, built on the host, moved to the card) with their
    blocks' specs on the card: ``{name: (group, net)}``.  Logs each one's
    host build time (bases, bilinear layouts, block indices) and its
    blocks' ``(nin, ng, nh, nnz)``."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    from gym_rotor_tpu_torch.models.emlp import general_nn as GN
    from gym_rotor_tpu_torch.models.emlp import groups as GG
    from gym_rotor_tpu_torch.models.emlp.rep_algebra import V
    out = {}
    for name, grp, n in GENERAL_CONFIGS:
        G = getattr(GG, grp)(n)
        t0 = time.perf_counter()
        net = GN.GeneralEMLP(V, V, G, ch=GENERAL_CH,
                             num_layers=GENERAL_LAYERS, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
        t_net = time.perf_counter() - t0
        specs = [K.general_block_spec(blk, dev) for blk in net.blocks()]
        t_build = time.perf_counter() - t0
        log("general", config=name, group=repr(G), ch=GENERAL_CH,
            layers=GENERAL_LAYERS, basis_build_s=t_build, modules_s=t_net,
            blocks=[list(sp.dims) + [sp.nnz] for sp in specs],
            relabelled=[sp.rows is not None for sp in specs], card=CARD)
        out[name] = (G, net.to(dev))
    return out


def general_block_checks(dev, models, gen):
    """Every distinct general block spec through the run-time K3/K4 against
    the twins at ``GENERAL_ROWS`` (``_any_block_vs_plain``: phase 26's
    tolerance, reruns bitwise), and its CUDA kernels a call at ``B`` rows
    (``ANY_KERNELS_A_CALL``, exactly).  Returns the worst (forward, backward)
    errors and the specs by (config, block)."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    worst, bad, specs = (0.0, 0.0), [], {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (G, net) in models.items():
        seen = set()
        for i, blk in enumerate(net.blocks()):
            spec = K.general_block_spec(blk, dev)
            specs[(name, i)] = spec
            if id(spec) in seen:
                continue
            seen.add(id(spec))
            for nb in GENERAL_ROWS:
                errs, b, _ = _any_block_vs_plain(
                    spec, _block_operands(spec, nb, gen, dev))
                worst = (max(worst[0], *(errs[k] for k in ("h", "lin",
                                                          "pre"))),
                         max(worst[1], *(errs[k] for k in ("g_x", "g_W",
                                                          "g_b", "g_v"))))
                log("general", check="emlp_block_any", config=name, block=i,
                    dims=list(spec.dims), nnz=spec.nnz, batch=nb,
                    plan=_rt_plan_log(spec, nb, sms), **errs)
                bad += [(name, i, nb) + x for x in b]
            got, wrong = _any_kernels_a_call(
                spec, _block_operands(spec, B, gen, dev))
            log("general", check="emlp_block_any_kernels_a_call",
                config=name, block=i, batch=B, kernels=got,
                expected=ANY_KERNELS_A_CALL)
            bad += [(name, i, "kernels a call") + w for w in wrong]
    if bad:
        raise AssertionError(f"general K3/K4: {bad[:5]}")
    return worst, specs


def _general_counts():
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    return {k: getattr(K, k).launches for k in (
        "emlp_block", "emlp_block_backward", "emlp_block_any",
        "emlp_block_backward_any")}


def _zero_general_counts():
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    for k in ("emlp_block", "emlp_block_backward", "emlp_block_any",
              "emlp_block_backward_any"):
        getattr(K, k).launches = 0


def general_network(dev, name, G, net, gen):
    """One configuration's network on the card: a forward and backward at
    ``B`` rows with the counts zeroed just before and read just after
    (exactly one run-time K3 and K4 a block, no instance launch); the
    output and every parameter's gradient at ``GENERAL_COMPARE_ROWS`` rows
    against the same network on the CPU (the twins); the equivariance
    error of the card's output under a sampled element.  Returns the
    counts of the counted run."""
    import copy

    import numpy as np
    n_blk = len(net.blocks())
    d = G.d
    x = _rand((B, d), gen, dev)
    net.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    _zero_general_counts()
    t0 = time.perf_counter()
    y = net(x)
    (y * y).mean().backward()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    counts = _general_counts()
    want = {"emlp_block": 0, "emlp_block_backward": 0,
            "emlp_block_any": n_blk, "emlp_block_backward_any": n_blk}
    if counts != want or not torch.isfinite(y).all():
        raise AssertionError(f"general {name}: launches {counts} (want "
                             f"{want}), finite {bool(torch.isfinite(y).all())}")
    xs = x[:GENERAL_COMPARE_ROWS]
    net.zero_grad(set_to_none=True)
    yk = net(xs)
    (yk * yk).sum().backward()
    cpu = copy.deepcopy(net).cpu()
    cpu.zero_grad(set_to_none=True)
    yp = cpu(xs.cpu())
    (yp * yp).sum().backward()
    errs = {"y": float((yk.detach().cpu() - yp.detach()).abs().max()
                       / yp.detach().abs().max())}
    for (k, pk), (_, pp) in zip(net.named_parameters(),
                                cpu.named_parameters()):
        if pk.grad is None and pp.grad is None:
            continue
        errs[k] = float((pk.grad.cpu() - pp.grad).abs().max()
                        / max(float(pp.grad.abs().max()), 1e-30))
    rng = np.random.default_rng(SEED)
    g = G.samples(1, rng)[0]
    rin = torch.as_tensor(net.rep_in.rho(g), dtype=torch.float32,
                          device=dev)
    rout = torch.as_tensor(net.rep_out.rho(g), dtype=torch.float32,
                           device=dev)
    with torch.no_grad():
        y0 = net(x)
        yg = net(x @ rin.T)
    equiv = float((yg - y0 @ rout.T).abs().max() / (y0.abs().max() + 1e-8))
    log("general", check="network", config=name, batch=B,
        launches=counts, fwd_bwd_wall_ms=step_ms,
        compare_rows=GENERAL_COMPARE_ROWS, max_rel_err=max(errs.values()),
        worst=max(errs, key=errs.get), equivariance_err=equiv, card=CARD)
    if max(errs.values()) > GENERAL_NET_TOL or not equiv < GENERAL_EQUIV_TOL:
        raise AssertionError(f"general {name}: card vs CPU {errs}, "
                             f"equivariance {equiv}")
    return counts


def general_regression(dev, gen):
    """``GeneralEMLP(V -> V0)`` over SO(3) at the full width (its blocks'
    bases are the V -> V network's) fitted by ``GENERAL_ADAM_STEPS`` Adam
    steps to the invariant target |x|^2 at ``B`` rows: the loss falls, and
    every step is one run-time K3 and K4 a block."""
    from gym_rotor_tpu_torch.models.emlp import general_nn as GN
    from gym_rotor_tpu_torch.models.emlp import groups as GG
    from gym_rotor_tpu_torch.models.emlp.rep_algebra import V, Scalar
    net = GN.GeneralEMLP(V, Scalar, GG.SO(3), ch=GENERAL_CH,
                         num_layers=GENERAL_LAYERS, device="cpu",
                         generator=torch.Generator().manual_seed(SEED)).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=3e-3)
    x = _rand((B, 3), gen, dev)
    target = (x * x).sum(-1, keepdim=True)
    _zero_general_counts()
    losses = []
    for _ in range(GENERAL_ADAM_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = ((net(x) - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    counts = _general_counts()
    n = GENERAL_ADAM_STEPS * len(net.blocks())
    log("general", check="regression", steps=GENERAL_ADAM_STEPS,
        loss_first=losses[0], loss_last=losses[-1], launches=counts)
    if not (math.isfinite(losses[-1]) and losses[-1] < losses[0]) \
            or counts["emlp_block_any"] != n \
            or counts["emlp_block_backward_any"] != n:
        raise AssertionError(f"general regression: losses {losses}, "
                             f"launches {counts}")


def general_interface(dev, gen, net):
    """``Interface`` on the card over three SO(3) vectors (a frame's
    worth: one vector alone gives rank-one frames), wrapping the SO(3)
    network applied to each vector, with a scoped ``EMLP`` of
    ``GENERAL_IO_CH`` channels for its frames: the inner EMLP through K3
    (``emlp_apply``), the output finite and within ``GENERAL_NET_TOL`` of
    the CPU module's on the same rows and noise."""
    import copy

    from gym_rotor_tpu_torch.models.emlp import groups as GG
    from gym_rotor_tpu_torch.models.emlp.interface import Interface
    from gym_rotor_tpu_torch.models.emlp.reps import Vector
    G = GG.SO(3)

    def per_vector(f):
        return lambda u: f(u.reshape(-1, 3)).reshape(u.shape[0], -1)
    io = Interface(per_vector(net), Vector(G) * 3, Vector(G) * 3, G,
                   io_ch=GENERAL_IO_CH, device="cpu",
                   generator=torch.Generator().manual_seed(SEED)).to(dev)
    x = _rand((GENERAL_COMPARE_ROWS, 9), gen, dev)
    z = _rand((9,), gen, dev)
    _zero_general_counts()
    with torch.no_grad():
        y = io(x, z)
        torch.cuda.synchronize()
        counts = _general_counts()
        cpu = copy.deepcopy(io).cpu()
        cpu.model = per_vector(copy.deepcopy(net).cpu())
        yp = cpu(x.cpu(), z.cpu())
    err = float((y.cpu() - yp).abs().max() / yp.abs().max())
    log("general", check="interface", batch=GENERAL_COMPARE_ROWS,
        io_ch=GENERAL_IO_CH, launches=counts, max_rel_err=err)
    if not (torch.isfinite(y).all() and err <= GENERAL_NET_TOL) \
            or counts["emlp_block"] + counts["emlp_block_any"] < 1:
        raise AssertionError(f"general interface: err {err}, launches "
                             f"{counts}")


def general_records(dev, specs, launches, errs, gen):
    """One record per run-time wrapper on the general path: its launches in
    the two networks' counted runs, the worst block error, and times at
    ``B`` rows (the forward saving lin and pre, the backward with the
    parameter sums) of each distinct block, weighted by the blocks that
    share it, each against the chunked twins."""
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    inst = {"emlp_block_any": [], "emlp_block_backward_any": []}
    weight = Counter(id(sp) for sp in specs.values())
    timed = set()
    for (name, i), spec in sorted(specs.items()):
        if id(spec) in timed:
            continue
        timed.add(id(spec))
        x, W, b, v, g_h = _block_operands(spec, B, gen, dev)
        _, lin, pre = K.emlp_block_any(spec, x, W, b, v)
        n = max(1, (1 << 27) // max(spec.nnz, 4 * spec.ng))

        def plain_fwd():
            for r0 in range(0, B, n):
                K.emlp_block_plain(spec, x[r0:r0 + n], W, b, v)

        def plain_bwd():
            for r0 in range(0, B, n):
                K.emlp_block_backward_plain(
                    spec, g_h[r0:r0 + n], x[r0:r0 + n], W, v,
                    lin[:, r0:r0 + n].contiguous(),
                    pre[:, r0:r0 + n].contiguous(), True)
        for kind, fn, plain in (
                ("emlp_block_any",
                 lambda: K.emlp_block_any(spec, x, W, b, v, True), plain_fwd),
                ("emlp_block_backward_any",
                 lambda: K.emlp_block_backward_any(spec, g_h, x, W, v, lin,
                                                   pre, True), plain_bwd)):
            k_ms, k_wall = device_ms(fn, 10)
            p_ms, _ = device_ms(plain, 1, 3)
            nbytes, flops = any_block_work(spec, B, kind, True)
            bms, by = bound_ms(nbytes, flops)
            log("kernels", kernel=kind, path="general", config=name,
                block=i, blocks=weight[id(spec)], dims=list(spec.dims),
                nnz=spec.nnz, batch=B, ms=k_ms, wall_ms_per_call=k_wall,
                plain_ms=p_ms, bytes=nbytes, flops=flops, bound_ms=bms,
                bound_by=by, library_ms=None)
            inst[kind].append((weight[id(spec)], k_ms, p_ms, bms, by, None))
    return [dict(_record(k, "emlp_block.cu", GENERAL_REPLACES[k],
                         launches[k], errs[k], inst[k]),
                 name=f"{k}:general") for k in inst]


def phase_general(dev):
    """Phase 28: the general EMLP engine on the card.  Both full-width
    configurations' blocks against the twins at ``GENERAL_ROWS``; each
    network's forward and backward with exact run-time K3/K4 launches,
    held to the CPU network and to equivariance; the invariant regression;
    ``Interface``; then one record per run-time wrapper on this path."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    models = general_models(dev)
    (fe, be), specs = general_block_checks(dev, models, gen)
    launches = Counter()
    for name, (G, net) in models.items():
        launches.update(general_network(dev, name, G, net, gen))
    general_regression(dev, gen)
    general_interface(dev, gen, models["so3"][1])
    records = general_records(
        dev, specs, launches,
        {"emlp_block_any": fe, "emlp_block_backward_any": be}, gen)
    log("general", check="done", t_phase_s=time.perf_counter() - t0,
        card=CARD)
    return records


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2
    try:
        from gym_rotor_tpu_torch.utils.config import PPO_CONFIGS, Config
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    global CARD
    card = CARD = gpu_name_power()
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
        torch=torch.__version__, cuda=torch.version.cuda)
    cfg = Config(num_envs=B)        # flagship: MODUL, TD3, EMLP, rk4, 4096 envs

    phase_build(dev)
    tick = phase_env_tick(cfg, dev, B, "train")
    # the eval path's shape: one partial block, nominal params
    small = phase_env_tick(cfg.replace(num_envs=cfg.num_eval), dev,
                           cfg.num_eval, "eval")
    tick["max_abs_err"] = max(tick["max_abs_err"], small["max_abs_err"])
    from gym_rotor_tpu_torch.kernels import env_tick as KT
    # realistic actor inputs: the obs of the compare-phase tick
    _, out = KT.env_tick(cfg, tick["state"], tick["actions"], tick["draws"])
    obs = tuple(o.contiguous() for o in out.obs)
    actors, emlp_err = phase_emlp(cfg, dev, obs)
    phase_rollout(cfg, dev, actors)
    phase_eval(cfg, dev, actors)
    errs = {}
    rep = phase_replay(cfg, dev, out)
    errs["replay_insert_tick"] = rep["max_abs_err"]
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    gen = torch.Generator().manual_seed(SEED)
    agents = [TD3Agent(cfg, i, dev) for i in range(cfg.n_agents)]
    states = [a.init(gen) for a in agents]
    errs["emlp_block"], errs["emlp_block_backward"] = phase_emlp_block(
        cfg, dev, agents, states, obs)
    errs["flat_adamw"] = phase_flat_adamw(cfg, dev, agents, edges=True)
    errs["spectral"] = phase_spectral(cfg, dev, agents, states,
                                      every_learner=True)
    sac_agents, _, errs["sac_actor"] = phase_sac_actor(cfg, dev, obs)
    errs["sac_sample"] = phase_sac_sample(dev)
    k5_td3, k5_sac = K5Calls(), K5Calls()
    launches, shapes, _ = phase_train(dev, k5=k5_td3)
    sac_launches = phase_train_sac(dev, SAC_STEPS, False, k5_sac)[0]
    phase_train_sac(dev, 3, True)
    ppo_agents, ppo_states, errs["ppo_actor"] = phase_ppo_actor(cfg, dev, obs)
    errs["gae"] = phase_gae(cfg, dev)
    errs["ppo_loss"] = phase_ppo_loss(cfg, dev, ppo_agents, ppo_states, obs)
    errs["v_blocks"] = phase_v_blocks(cfg, dev, ppo_agents, ppo_states, obs)
    ppo_runs = [phase_train_ppo(dev, name, PPO_CONFIGS[name], n)
                for name, n in PPO_SUPERSTEPS]
    records = phase_kernels(cfg, dev, tick, actors, obs, launches, emlp_err)
    records += phase_train_kernels(cfg, dev, rep, agents, states, launches,
                                   shapes, errs)
    records += phase_sac_kernels(cfg, dev, sac_agents, obs, sac_launches, errs)
    records += phase_ppo_kernels(dev, ppo_agents, ppo_states, obs, ppo_runs,
                                 errs)
    phase_k5(dev, k5_td3, k5_sac)
    records += phase_mono(dev)
    records += phase_families(dev)
    records += phase_tick_modes(dev)
    records += phase_gym_api(dev)
    k1_err, k2_err = phase_tiles(dev)
    phase_driver(dev)
    records += phase_widths(dev)
    records += phase_multi(dev)
    records += phase_general(dev)
    for rec in records:
        if rec["name"] == "env_tick":
            rec["max_abs_err"] = max(rec["max_abs_err"], k1_err)
        elif rec["name"] == "replay_insert_tick":
            rec["max_abs_err"] = max(rec["max_abs_err"], k2_err)
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--multi-child"]:
            code = multi_child(sys.argv[2:])
        else:
            code = main()
    except Exception:           # any phase failure: report and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
