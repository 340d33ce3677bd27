"""Classful Gym API over the functional core (port of
``gym_rotor_tpu/envs/gym_api.py``): ``QuadEnv`` (Quad-v0, per-motor thrusts,
the 18-float state as obs), ``CoupledWrapper`` (MONO) and
``DecoupledWrapper`` (MODUL), with the JAX package's public attributes and
methods.

One env per instance.  ``reset`` draws from NumPy's global RNG (and Python's
``random``) through the port's oracle, in the reference's order, so
``utils.seeding.set_seed`` + ``reset`` reproduces the reference's episodes.
On the card the env lives packed (``kernels/env_tick.py::pack_env``) and
each ``step`` is one launch of K1's step entry (``env_step_bufs``, float32),
which updates it in place, then a copy of obs, reward and done to the host;
``reset``,
``set_goal_state`` and ``get_norm_error_state`` run once per episode in
plain torch on the device.  ``dtype=torch.float64`` runs on the CPU only
(the plain twins; the parity tests).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels import env_tick as K1
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.tree import tree_map
from . import oracle as onp
from . import quad as fquad
from . import state_from_oracle
from .quad import DT, EIB1_LIM, EIX_LIM, V_LIM, W_LIM, X_LIM
from .state import pack_state

try:
    import gymnasium as gym
    from gymnasium import spaces

    _BASE = gym.Env
except ImportError:
    gym = None
    spaces = None
    _BASE = object


class QuadEnv(_BASE):
    """Quad-v0: per-motor thrust actions, 18-float state observation."""

    metadata = {"render_modes": ["human"]}

    task = "quad"

    def __init__(self, cfg: Optional[Config] = None, render_mode=None,
                 max_episode_steps: int = 10000, dtype=torch.float32,
                 device=None):
        if cfg is None:
            # the reference's adaptive DOP853 for the base env and the
            # wrappers alike; integrator='euler' is the parity configuration
            cfg = Config(framework="MONO", integrator="dop853")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or float64, got "
                             f"{dtype}")
        if dtype == torch.float64 and torch.device(
                "cuda" if device is None else device).type == "cuda":
            raise ValueError(
                "the env steps on the card through K1 (kernels/env_tick.py), "
                "which is float32; torch.float64 runs on the CPU only "
                "(device='cpu')")
        self.device = resolve_device(device)
        self.cfg = cfg.replace(exact_so3=True)
        self.dtype = dtype
        self.max_episode_steps = max_episode_steps
        self.render_mode = render_mode
        self._renderer = None

        # the reference's public constants
        self.freq = 200
        self.dt = DT
        self.x_lim, self.v_lim, self.W_lim = X_LIM, V_LIM, float(W_LIM)
        self.eIx_lim, self.eIb1_lim = EIX_LIM, EIB1_LIM
        self.e1 = np.array([1.0, 0.0, 0.0])
        self.e2 = np.array([0.0, 1.0, 0.0])
        self.e3 = np.array([0.0, 0.0, 1.0])
        self.g = 9.81

        self._oracle = onp.OracleEnv(self.cfg, self.task)
        self._sync_params()
        self._envb = self._bufs = None      # the env, batched; or packed
        self._t = 0

        if spaces is not None:
            low = np.concatenate([
                -self.x_lim * np.ones(3), -self.v_lim * np.ones(3),
                -np.ones(9), -self.W_lim * np.ones(3)]).astype(np.float32)
            self.observation_space = spaces.Box(low=low, high=-low,
                                                dtype=np.float32)
            self.action_space = spaces.Box(
                low=-1.0, high=1.0, shape=(self._action_dim(),),
                dtype=np.float32)

    def _action_dim(self):
        return {"quad": 4, "coupled": 4, "decoupled": 5}[self.task]

    def _sync_params(self):
        p = self._oracle.p
        self.m, self.d, self.J = p.m, p.d, np.diag(p.J)
        self.c_tf, self.c_tw = p.c_tf, p.c_tw
        self.hover_force = p.hover_force
        self.min_force, self.max_force = p.min_force, p.max_force
        self.avrg_act, self.scale_act = p.avrg_act, p.scale_act
        self.forces_to_fM = p.forces_to_fM
        self.fM_to_forces = p.fM_to_forces

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=self.dtype).to(self.device)

    @property
    def _env(self):
        """The env's state, unbatched (on the card: views of its buffers)."""
        envb = self._envb if self._bufs is None else K1.unpack_env(self._bufs, 1)
        return tree_map(lambda t: t[0], envb)

    def _set_env(self, env):
        envb = tree_map(lambda t: t[None], env)
        if self.device.type == "cuda":
            self._bufs = K1.pack_env(envb)
        else:
            self._envb = envb

    # ------------------------------------------------------------------
    def reset(self, env_type: str = "train", seed: Optional[int] = None,
              options=None):
        if seed is not None and gym is not None:
            super().reset(seed=seed)
        self._oracle.reset(env_type)
        self._sync_params()
        self._set_env(state_from_oracle(self.cfg, self._oracle, self.dtype,
                                        self.device))
        self._t = 0
        return np.asarray(self.state, dtype=np.float32)

    @property
    def state(self):
        e = self._env
        return pack_state(e.x, e.v, e.R, e.W).cpu().numpy().astype(np.float64)

    def get_current_state(self):
        return self.state

    def set_goal_state(self, xd, vd, b1d, b1d_dot, Wd):
        self._set_env(fquad.set_goal(
            self._env, self._tensor(xd), self._tensor(vd), self._tensor(b1d),
            self._tensor(b1d_dot), self._tensor(Wd)))

    def get_norm_error_state(self, framework=None):
        """The normalized error observation with its integral update
        (``quad.initial_obs``), once per episode after ``reset`` as the
        reference's driver calls it (the wrappers' steps do it
        themselves)."""
        cfg = self.cfg.replace(framework=framework or self.cfg.framework)
        env, obs = fquad.initial_obs(cfg, self._env)
        self._set_env(env)
        return [o.cpu().numpy() for o in obs]

    def step(self, action):
        a = self._tensor(action)[None]
        if self._bufs is None:
            self._envb, out = K1.env_step_plain(self.cfg, self._envb, a,
                                                self.task)
        else:
            out = K1.env_step_bufs(self.cfg, self._bufs, a, self.task)
        self._t += 1
        if self.task == "quad":
            obs = np.asarray(out.obs[0][0].cpu().numpy(), np.float32)
        else:
            obs = [o[0].cpu().numpy() for o in out.obs]
        reward = list(out.reward[0].cpu().numpy().astype(np.float64))
        done = list(out.done[0].cpu().numpy())
        truncated = self._t >= self.max_episode_steps
        if self.task == "quad":
            return obs, reward[0], bool(done[0]), truncated, {}
        return obs, reward, done, truncated, {}

    def render(self, mode="human"):
        from ..render.renderer import Renderer

        if self._renderer is None:
            self._renderer = Renderer()
        e = self._env
        self._renderer.draw(*(t.cpu().numpy() for t in
                              (e.x, e.R, e.goal.xd, e.goal.b1d)))
        return True

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None


class CoupledWrapper(QuadEnv):
    """MONO task: (f_total, M) actions, 23-float obs."""

    task = "coupled"

    def __init__(self, cfg: Optional[Config] = None, **kw):
        cfg = (cfg or Config(integrator="dop853")).replace(framework="MONO")
        super().__init__(cfg, **kw)
        self.alpha, self.beta = self.cfg.alpha, self.cfg.beta


class DecoupledWrapper(QuadEnv):
    """MODUL two-agent task: (f_total, tau, M3) actions, obs (15, 3)."""

    task = "decoupled"

    def __init__(self, cfg: Optional[Config] = None, **kw):
        cfg = (cfg or Config(integrator="dop853")).replace(framework="MODUL")
        super().__init__(cfg, **kw)
        self.alpha, self.beta = self.cfg.alpha, self.cfg.beta
