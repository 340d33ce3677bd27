"""Single explicit configuration object (own copy of
``gym_rotor_tpu/utils/config.py``'s ``Config``, defaults unchanged).

Defaults replicate the reference's args_parse.py:6-78 exactly.  The port
reads the same fields: every ``integrator`` (euler, rk4, dop853), any
``train_traj_mode``, ``exact_so3`` and both ``eval_stream`` values run on
the card, and ``save_log``/``render`` make ``evaluate`` return the
flight-log rows; the checkpoint, TensorBoard and profiling fields wait for
the port of ``train.py``'s ``Learner`` and are ignored.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # -- run control
    seed: int = 1992
    save_model: bool = True
    save_tensorboard: bool = False
    test_model: bool = False
    save_log: bool = False
    render: bool = False

    # -- environment
    framework: str = "MODUL"          # "MONO" | "MODUL"
    module_training: str = "DTDE"     # "DTDE" | "CTDE"
    max_steps: int = 4000
    max_timesteps: int = 2_000_000
    num_eval: int = 10
    eval_freq: int = 2000
    eval_max_steps: int = 5           # [sec]

    # -- reward coefficients
    Cx: float = 6.0
    CIx: float = 0.1
    Cv: float = 0.4
    Cw12: float = 0.6
    alpha: float = 0.01
    Cb1: float = 6.0
    CIb1: float = 0.1
    CW3: float = 0.1
    beta: float = 0.05

    # -- domain randomization
    use_UDM: bool = True
    UDM_percentage: float = 10.0

    # -- agent
    rl_algo: str = "TD3"              # "TD3" | "SAC" | "PPO"
    use_equiv: bool = True
    equiv_fold: bool = False
    actor_hidden_dim: Tuple[int, ...] = (16, 4)
    critic_hidden_dim: int = 62
    lr_a: Tuple[float, ...] = (3e-4, 3e-4)
    lr_c: Tuple[float, ...] = (2e-4, 2e-4)
    discount: float = 0.99
    max_action: float = 1.0
    use_clip_grad_norm: bool = True
    grad_max_norm: float = 100.0

    # -- off-policy
    start_timesteps: int = 500_000
    batch_size: int = 256
    replay_buffer_size: int = 1_000_000
    tau: float = 0.005

    # -- TD3
    use_explor_noise_decay: bool = True
    explor_noise_std_init: float = 0.3
    explor_noise_std_min: float = 0.05
    target_noise: float = 0.2
    noise_clip: float = 0.5
    policy_update_freq: int = 3

    # -- SAC
    sac_alpha: float = 0.05
    automatic_entropy_tuning: bool = False

    # -- PPO
    T_horizon: int = 7000
    GAE_lambda: float = 0.9
    clip_rate: float = 0.2
    K_epochs: int = 20
    l2_reg: float = 1e-4
    entropy_coef: float = 1e-2
    entropy_coef_decay: float = 0.99
    actor_batch_size: int = 128
    critic_batch_size: int = 128

    # -- CAPS smoothness
    lam_T: float = 0.4
    lam_S: float = 0.3
    lam_M: float = 0.6

    # -- batched-framework knobs (no reference counterpart)
    num_envs: int = 4096              # batched lockstep envs per device
    integrator: str = "rk4"           # "euler" | "rk4" | "dop853"
    exact_so3: bool = False
    train_traj_mode: int = 0
    updates_per_step: float = 1.0
    mesh_axis: str = "env"
    rollout_len: int = 1
    checkpoint_freq: int = 0
    checkpoint_path: str = "./models/train_state.msgpack"
    resume: bool = False
    checkpoint_replay: bool = False
    profile_dir: str = ""
    eval_stream: str = "parallel"     # "parallel" | "reference"

    # -- derived quantities (reference quad.py:71-88)
    @property
    def reward_min(self) -> float:
        return -math.ceil(self.Cx + self.CIx + self.Cv + self.Cb1 + self.CIb1 + self.Cw12)

    @property
    def reward_min_1(self) -> float:
        return -math.ceil(self.Cx + self.CIx + self.Cv + self.Cw12)

    @property
    def reward_min_2(self) -> float:
        return -math.ceil(self.Cb1 + self.CW3 + self.CIb1)

    @property
    def n_agents(self) -> int:
        return 2 if self.framework == "MODUL" else 1

    @property
    def obs_dim_n(self) -> Tuple[int, ...]:
        return (15, 3) if self.framework == "MODUL" else (23,)

    @property
    def action_dim_n(self) -> Tuple[int, ...]:
        return (4, 1) if self.framework == "MODUL" else (4,)

    @property
    def is_ctde(self) -> bool:
        """MODUL's centralised critics (MATD3 and the CTDE branches of SAC
        and PPO): each critic sees every agent's obs (and actions)."""
        return self.framework == "MODUL" and self.module_training == "CTDE"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _add_bool(parser, name, default, help=""):
    parser.add_argument(
        name, default=default,
        type=lambda x: str(x).lower() in ("true", "1", "yes"), help=help)


def create_parser() -> argparse.ArgumentParser:
    """The CLI: ``--<field>`` for every ``Config`` field; booleans read
    ``true``/``1``/``yes`` (any case) as True and anything else as False,
    tuples take one or more values."""
    p = argparse.ArgumentParser(
        description="Modular RL for quadrotor UAV control (PyTorch/CUDA)")
    defaults = Config()
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        d = getattr(defaults, f.name)
        if isinstance(d, bool):
            _add_bool(p, name, d)
        elif isinstance(d, tuple):
            p.add_argument(name, default=list(d), nargs="+",
                           type=type(d[0]) if d else float)
        else:
            p.add_argument(name, default=d, type=type(d))
    return p


def config_from_args(argv: Optional[list] = None) -> Config:
    args = create_parser().parse_args(argv)
    kw = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name)
        if isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return Config(**kw)


# PPO's two configurations at full width (actors 16 / 4, V critics 62), cut
# in depth only (K_epochs 20 -> 2 and 1), as chip_smoke.py and
# scripts/torch_train_profile.py run them.  A: the validated learning run
# (scripts/run_modul_families.sh:18-19: 32 envs, T_horizon 7000, so 218
# ticks and minibatch 128); B: the JAX throughput configuration
# (bench_train.py:84-89 --algo ppo: 4096 envs x 50 ticks, minibatch
# 204800 // 55 = 3723).
PPO_CONFIGS = {
    "A": dict(rl_algo="PPO", num_envs=32, T_horizon=7000, K_epochs=2),
    "B": dict(rl_algo="PPO", num_envs=4096, T_horizon=4096 * 50,
              actor_batch_size=4096 * 50 // 55,
              critic_batch_size=4096 * 50 // 55, K_epochs=1),
}
