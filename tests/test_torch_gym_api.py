"""PyTorch port vs the JAX package: the Gym API (``envs/gym_api.py``:
``QuadEnv``, ``CoupledWrapper``, ``DecoupledWrapper``), ``registry.make``,
``utils/seeding.py`` and the renderer, on the CPU (``device="cpu"``; on the
card each ``step`` is one launch of K1's step entry, held to its plain twin
by chip_smoke.py).

Tolerances: the reset state, the goal and the first observation bit for
bit (the same oracle draws, the same float64 arithmetic; the heading obs
slots within one float32 ulp, ``atan2``); over the steps the ``state``
property within 1e-12 and obs and rewards within 1e-6 (JAX jits the step,
and XLA contracts multiply-adds in float64), dones and truncation
identical.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gym_rotor_tpu import make as jmake
from gym_rotor_tpu.utils import seeding as jseed
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch import make as tmake
from gym_rotor_tpu_torch.convert import env_from_numpy
from gym_rotor_tpu_torch.envs import gym_api as tgym
from gym_rotor_tpu_torch.utils import seeding as tseed
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
from test_torch_td3 import _np_tree

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
IDS = {"Quad-v0": tgym.QuadEnv, "Coupled-v0": tgym.CoupledWrapper,
       "Decoupled-v0": tgym.DecoupledWrapper}
F32 = float(np.spacing(np.float32(1)))


def test_make_builds_the_three_envs():
    for env_id, cls in IDS.items():
        env = tmake(env_id, device="cpu")
        assert type(env) is cls and env.max_episode_steps == 10000
        assert env.cfg.exact_so3 and env.cfg.integrator == "dop853"
        assert env.dtype == torch.float32 and env.device.type == "cpu"
        assert env.action_space.shape == (env._action_dim(),)
        assert env.observation_space.shape == (18,)
    assert tmake("Decoupled-v0", device="cpu").cfg.framework == "MODUL"
    assert tmake("Quad-v0", device="cpu", max_episode_steps=7) \
        .max_episode_steps == 7
    with pytest.raises(KeyError, match="Nope-v0"):
        tmake("Nope-v0")


def _hover(env, rng, n):
    """Near-hover actions: the thrust channel at hover (per motor for the
    quad task) plus noise, small moments."""
    dim = env._action_dim()
    a = rng.uniform(-0.05, 0.05, (n, dim))
    hover = (env.hover_force - env.avrg_act) / env.scale_act
    if env.task == "quad":
        a += hover
    else:
        a[:, 0] += hover
    return a


def _same_env(tenv, jenv, what):
    """The port env's whole state (parameters, goal, integrals, wrench,
    step count) is JAX's, bit for bit (``convert.env_from_numpy``)."""
    ref = env_from_numpy(_np_tree(jenv._state), device="cpu")
    got = dict(tree_named_leaves(tenv._env))
    for path, leaf in tree_named_leaves(ref):
        assert torch.equal(got[path], leaf), (what, path)


def _check_obs(got, ref, task, exact):
    if task == "Quad-v0":
        np.testing.assert_allclose(got, ref, rtol=0, atol=exact)
        return
    heading = {"Decoupled-v0": (np.s_[:], np.s_[0:2]),
               "Coupled-v0": (np.s_[18:20],)}[task]
    for g, r, h in zip(got, ref, heading):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_allclose(g[h], r[h], rtol=0, atol=max(F32, exact))
        rest = np.ones(r.shape, bool)
        rest[h] = False
        np.testing.assert_allclose(g[rest], r[rest], rtol=0, atol=exact)


@pytest.mark.parametrize("integrator", ["euler", "dop853"])
@pytest.mark.parametrize("env_id", list(IDS))
def test_gym_api_matches_jax(env_id, integrator):
    """``set_seed`` -> ``reset`` -> ``get_norm_error_state`` ->
    ``set_goal_state`` -> 120 ``step``s (truncated at 100) on the port in
    float64 on the CPU and on JAX's Gym API, both seeded the same."""
    kw = dict(integrator=integrator, seed=3)
    jenv = jmake(env_id, cfg=JConfig(framework="MONO", **kw),
                 max_episode_steps=100)
    tenv = tmake(env_id, cfg=TConfig(framework="MONO", **kw),
                 max_episode_steps=100, dtype=torch.float64, device="cpu")
    outs = []
    for env, seed in ((jenv, jseed), (tenv, tseed)):
        seed.set_seed(env, 5)
        s0 = env.reset()
        obs0 = env.get_norm_error_state()
        outs.append((s0, env.state, obs0, env.m, env.J))
    (js0, jst, jobs0, jm, jJ), (ts0, tst, tobs0, tm, tJ) = outs
    np.testing.assert_array_equal(ts0, js0)
    np.testing.assert_array_equal(tst, jst)
    _same_env(tenv, jenv, "reset + get_norm_error_state")
    assert ts0.dtype == np.float32 and tst.dtype == np.float64
    assert tm == jm and (tJ == jJ).all()
    assert len(tobs0) == len(jobs0)
    _check_obs(tobs0, jobs0, env_id if env_id != "Quad-v0" else
               "Coupled-v0", 0.0)
    goal = ([0.1, 0.0, -0.1], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    for env in (jenv, tenv):
        env.set_goal_state(*goal)
    _same_env(tenv, jenv, "set_goal_state")
    rng = np.random.default_rng(9)
    done_at = None
    for k, a in enumerate(_hover(tenv, rng, 120)):
        jo, jr, jd, jt, _ = jenv.step(a)
        to, tr, td, tt, info = tenv.step(a)
        assert info == {} and tt == jt == (k + 1 >= 100)
        if done_at is None:
            np.testing.assert_allclose(tenv.state, jenv.state, rtol=0,
                                       atol=1e-12)
            _check_obs(to, jo, env_id, 1e-6)
            np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-6)
            assert np.array_equal(td, jd)
            if np.any(td):
                done_at = k
        if env_id == "Quad-v0":
            assert isinstance(tr, float) and isinstance(td, bool)
            assert to.dtype == np.float32 and to.shape == (18,)
        else:
            assert len(tr) == len(td) == tenv.cfg.n_agents
    assert done_at is None or done_at > 20


def test_error_state_helpers_match_jax():
    """``get_error_state`` for both frameworks and
    ``benchmark_reward_func``, bit for bit on random observations."""
    rng = np.random.default_rng(1)
    for fw, obs in (("MODUL", [rng.normal(size=15).astype(np.float32),
                               rng.normal(size=3).astype(np.float32)]),
                    ("MONO", [rng.normal(size=23).astype(np.float32)])):
        args = (1.0, 4.0, 3.0, 3.0, fw)
        for got, ref in zip(tseed.get_error_state(obs, *args),
                            jseed.get_error_state(obs, *args)):
            np.testing.assert_array_equal(got, ref)
    for _ in range(20):
        ex, eb1 = rng.normal(size=3), rng.normal()
        assert tseed.benchmark_reward_func(ex, eb1) == \
            jseed.benchmark_reward_func(ex, eb1)


def test_device_and_dtype():
    """Without ``device`` the env asks for the card; float64 on a CUDA
    device raises (K1 is float32), whether or not a card is present."""
    with pytest.raises(ValueError, match="float32"):
        tmake("Quad-v0", dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        tmake("Coupled-v0", dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        tmake("Coupled-v0", dtype=torch.float16, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmake("Decoupled-v0")


def test_imports_without_gymnasium_and_matplotlib():
    """With ``gymnasium`` and ``matplotlib`` unimportable the package
    imports, ``make`` builds the envs on ``object`` (no spaces) and they
    step; only ``render`` needs matplotlib."""
    code = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("gymnasium", "matplotlib"):
                    raise ImportError(name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        import gym_rotor_tpu_torch
        from gym_rotor_tpu_torch.envs import gym_api
        assert gym_api.QuadEnv.__mro__[1] is object
        env = gym_rotor_tpu_torch.make("Quad-v0", device="cpu")
        assert not hasattr(env, "action_space")
        env.reset()
        obs, r, d, t, _ = env.step(np.zeros(4))
        assert obs.shape == (18,)
        try:
            env.render()
        except ImportError:
            print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr


def test_render_offscreen(tmp_path):
    """``render`` draws the env offscreen (matplotlib's Agg backend) and
    ``close`` releases the figure."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    env = tmake("Decoupled-v0", device="cpu")
    tseed.set_seed(env, 2)
    env.reset()
    env.set_goal_state([0.1, 0, 0], [0, 0, 0], [1, 0, 0], [0, 0, 0],
                       [0, 0, 0])
    assert env.render() is True
    env.step(np.zeros(5))
    assert env.render() is True
    assert len(env._renderer.trail) == 2
    path = env._renderer.save(str(tmp_path / "frame.png"))
    assert Path(path).stat().st_size > 0
    env.close()
    assert env._renderer is None
