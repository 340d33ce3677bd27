"""PyTorch port vs the JAX package: the base ``quad`` task (``envs/quad.py``:
``action_quad``, ``reward_quad``, ``done_quad``, the packed-state obs),
``quad.step``'s task argument for all three tasks, the port's own NumPy
oracle, K1's step entry through its plain twin (``kernels/env_tick.py::
env_step_plain``; the CUDA instances are held to it by chip_smoke.py on the
card) and the integral helpers (``envs/integrals.py``).

Tolerances: float64 against JAX run op by op (``eager_jit``) and against
the oracle: x, v, R, W, the wrench and the ``quad`` obs bit for bit (no
transcendental reaches them); the wrappers' heading obs slots within one
float32 ulp and ``eIb1`` within 1e-13 (``atan2``'s last bit); rewards
within 1e-6 as ``tests/test_parity.py`` holds JAX to the oracle
(``arccos``).  Float32 against ``jax.jit`` without x64: K1's tolerance,
|port - JAX| <= 1e-6 + 1e-5 |JAX| (XLA contracts and fuses; libm), dones
identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.envs import integrals as jint
from gym_rotor_tpu.envs import oracle as jonp
from gym_rotor_tpu.envs import quad as jquad
from gym_rotor_tpu.envs import state_from_oracle as jstate_from_oracle
from gym_rotor_tpu.envs.state import Goal as JGoal
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.convert import env_state_from_numpy
from gym_rotor_tpu_torch.envs import integrals as tint
from gym_rotor_tpu_torch.envs import oracle as tonp
from gym_rotor_tpu_torch.envs import quad as tquad
from gym_rotor_tpu_torch.envs import state_from_oracle as tstate_from_oracle
from gym_rotor_tpu_torch.kernels import env_tick as ktick
from gym_rotor_tpu_torch.ops import so3 as tso3
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
from test_torch_integrators import eager_jit
from test_torch_td3 import _np_tree

torch.set_num_threads(1)
TASKS = {"quad": "MONO", "coupled": "MONO", "decoupled": "MODUL"}
GOAL = dict(xd=[0.1, -0.2, 0.05], vd=[0.0, 0.02, 0.0],
            b1d=[np.cos(0.3), np.sin(0.3), 0.0], b1d_dot=[0.0, 0.0, 0.0],
            Wd=[0.0, 0.0, 0.01])


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().cpu().numpy()


def _parity_cfg(task):
    kw = dict(framework=TASKS[task], integrator="euler", exact_so3=True,
              use_UDM=True)
    return JConfig(**kw), TConfig(**kw)


def _actions(task, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.2, 0.2, (n, 5 if task == "decoupled" else 4))


# ---------------------------------------------------------------------------
# the oracle copy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("env_type", ["train", "eval"])
@pytest.mark.parametrize("task", list(TASKS))
def test_oracle_copy_matches_jax_oracle(task, env_type):
    """The port's ``envs/oracle.py`` is the JAX package's, bit for bit: the
    reset from the same seeds (NumPy's and Python's global RNGs), the
    parameters, then 60 steps with the goal set."""
    jcfg, tcfg = _parity_cfg(task)
    pair = []
    for onp_, cfg in ((jonp, jcfg), (tonp, tcfg)):
        onp_.seed_all(11)
        o = onp_.OracleEnv(cfg, task)
        pair.append((o, o.reset(env_type)))
    (jo, js18), (to, ts18) = pair
    np.testing.assert_array_equal(ts18, js18)
    for name in ("m", "d", "J", "c_tf", "c_tw", "forces_to_fM",
                 "fM_to_forces"):
        np.testing.assert_array_equal(getattr(to.p, name),
                                      getattr(jo.p, name), name)
    for o in (jo, to):
        o.set_goal(**GOAL)
    for i, a in enumerate(_actions(task, 60)):
        jr, tr = jo.step(a), to.step(a)
        for x, y in zip(jax.tree.leaves(tr), jax.tree.leaves(jr)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), i)
        for name in ("x", "v", "R", "W", "eIx", "eIb1"):
            np.testing.assert_array_equal(getattr(to, name),
                                          getattr(jo, name), (i, name))


# ---------------------------------------------------------------------------
# quad.step, float64, every task
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("task", list(TASKS))
def test_step_f64_matches_jax_and_oracle(task):
    """60 steps of the port's plain ``quad.step(task=...)`` in float64 from
    the oracle's reset (Euler, exact_so3, UDM; the goal set), against JAX's
    ``quad.step`` op by op and against the port's oracle, until the first
    done."""
    jcfg, tcfg = _parity_cfg(task)
    tonp.seed_all(1992)
    o = tonp.OracleEnv(tcfg, task)
    o.reset("train")
    o.set_goal(**GOAL)
    js = jstate_from_oracle(jcfg, o, jnp.float64)
    ts = tstate_from_oracle(tcfg, o, torch.float64, "cpu")
    goal = {k: np.asarray(v, np.float64) for k, v in GOAL.items()}
    js = jquad.set_goal(js, *(jnp.asarray(goal[k]) for k in GOAL))
    ts = tquad.set_goal(ts, *(_t(goal[k]) for k in GOAL))
    acts = _actions(task, 60, seed=1)
    jstep = eager_jit(lambda s, a: jquad.step(jcfg, s, a, task), js,
                      jnp.asarray(acts[0]))
    steps = 0
    for i, a in enumerate(acts):
        obs_o, r_o, d_o = o.step(a)
        js, jout = jstep(js, jnp.asarray(a))
        ts, tout = tquad.step(tcfg, ts, _t(a), task)
        for name in ("x", "v", "R", "W", "f_total", "M"):
            got = _np(getattr(ts, name))
            np.testing.assert_array_equal(got, np.asarray(getattr(js, name)),
                                          f"{name} step {i}")
        for name, ref in (("x", o.x), ("v", o.v), ("R", o.R), ("W", o.W)):
            np.testing.assert_array_equal(_np(getattr(ts, name)), ref,
                                          f"oracle {name} step {i}")
        assert ts.t.item() == int(js.t) == i + 1
        if task == "quad":
            assert len(tout.obs) == 1 and tout.obs[0].shape == (18,)
            np.testing.assert_array_equal(_np(tout.obs[0]),
                                          np.asarray(jout.obs))
            np.testing.assert_array_equal(_np(tout.obs[0]), obs_o)
            for name in ("eIx", "eIx_integrand", "eIb1", "eIb1_integrand"):
                np.testing.assert_array_equal(_np(getattr(ts, name)),
                                              np.asarray(getattr(js, name)))
            np.testing.assert_array_equal(_np(tout.info["ex"]),
                                          np.asarray(jout.info["ex"]))
            assert float(tout.info["eb1"]) == 0.0
        else:
            np.testing.assert_array_equal(_np(ts.eIx), np.asarray(js.eIx))
            np.testing.assert_allclose(_np(ts.eIb1), np.asarray(js.eIb1),
                                       rtol=0, atol=1e-13)
            f32 = np.spacing(np.float32(1))
            jobs = jout.obs if task == "decoupled" else (jout.obs,)
            oobs = obs_o if task == "decoupled" else (obs_o,)
            heading = {"decoupled": (np.s_[:], np.s_[0:2]),
                       "coupled": (np.s_[18:20],)}[task]
            for got, ref, ora, h in zip(tout.obs, jobs, oobs, heading):
                for other in (np.asarray(ref), ora):
                    np.testing.assert_allclose(_np(got)[h], other[h], rtol=0,
                                               atol=f32)
                    rest = np.ones(other.shape, bool)
                    rest[h] = False
                    np.testing.assert_array_equal(_np(got)[rest], other[rest])
        np.testing.assert_allclose(_np(tout.reward), np.asarray(jout.reward),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(tout.reward), r_o, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(_np(tout.done), np.asarray(jout.done))
        np.testing.assert_array_equal(_np(tout.done), d_o)
        steps += 1
        if d_o.any():
            break
    assert steps >= 20


def test_done_quad_tilt_and_singular_branch_f64():
    """``done_quad`` against JAX on attitudes away from the 85 degree limit
    on either side, in roll and in pitch, on the singular branch (pitch 90
    degrees, ``sy < 1e-6``), and x / v / W at and past their limits."""
    deg = np.pi / 180.0
    eul = np.array([[84.0, 0, 10], [86.0, 0, 10], [-86.0, 0, 0],
                    [0, 84.0, 0], [0, -86.0, 5], [0, 90.0, 30],
                    [10.0, -90.0, 0], [0, 0, 170.0]]) * deg
    R = _np(tso3.euler_to_rot(_t(eul)))
    n = len(R)
    x = np.zeros((n, 3))
    v = np.zeros((n, 3))
    W = np.zeros((n, 3))
    x[7, 0], v[0, 1], W[3, 2] = 1.0, -4.0 + 1e-9, 2.0 * np.pi
    got = _np(tquad.done_quad(*(_t(a) for a in (x, v, R, W))))[:, 0]
    ref = np.asarray(jquad.done_quad(*(jnp.asarray(a) for a in (x, v, R, W))))
    np.testing.assert_array_equal(got, ref[:, 0])
    np.testing.assert_array_equal(got, [False, True, True, True, True, True,
                                        True, True])


# ---------------------------------------------------------------------------
# K1's step entry, float32, through its plain twin
# ---------------------------------------------------------------------------
def _crash_states(jcfg, n, seed):
    """JAX float32 reset states with, per env: 0 x past its limit, 1 a tilt
    of 86 degrees in roll, 2 in pitch (the quad task's tilt crash), 3 the
    singular branch, 4-5 drifted attitudes (the exact repair runs), every
    env a goal of its own."""
    rng = np.random.default_rng(seed)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(seed), "train",
                                  jnp.float32)
    e = jbs.env
    x, R = np.array(e.x), np.array(e.R)
    x[0, 0] = 1.05
    eul = np.array([[86.0, 0, 0.3], [0, -86.0, 1.0], [0, 90.0, 0.5]])
    R[1:4] = _np(tso3.euler_to_rot(_t(eul * [[np.pi / 180] * 2 + [1]])))
    R[4:6] += 1e-4 * rng.normal(size=(2, 3, 3))
    th = rng.uniform(-np.pi, np.pi, n)
    xd = 0.2 * rng.normal(size=(n, 3))
    xd[0] = 0.0                   # env 0's x error past the limit too
    goal = JGoal(
        xd=jnp.asarray(xd, jnp.float32),
        vd=jnp.asarray(0.05 * rng.normal(size=(n, 3)), jnp.float32),
        b1d=jnp.asarray(np.stack([np.cos(th), np.sin(th), 0 * th], -1),
                        jnp.float32),
        b1d_dot=jnp.zeros((n, 3), jnp.float32),
        Wd=jnp.asarray(0.1 * rng.normal(size=(n, 3)), jnp.float32))
    env = e.replace(x=jnp.asarray(x), R=jnp.asarray(R, jnp.float32),
                    goal=goal)
    return jbs.replace(env=env)


def _k1(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.all(np.abs(got - ref) <= 1e-6 + 1e-5 * np.abs(ref))


@pytest.mark.parametrize("integrator", ["euler", "rk4", "dop853"])
@pytest.mark.parametrize("task", list(TASKS))
def test_env_step_plain_f32_matches_jax(task, integrator):
    """``env_step_plain`` (the step entry's twin) on 16 float32 envs with
    crashes against ``jax.jit(vmap(quad.step))`` without x64: the stepped
    state, obs, reward, done and info within K1's tolerance; the goal and
    the parameters untouched."""
    n = 16
    kw = dict(num_envs=n, framework=TASKS[task], integrator=integrator,
              exact_so3=True)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    a = _actions(task, n, seed=2).astype(np.float32)
    with jax.enable_x64(False):
        jbs = _crash_states(jcfg, n, 3)
        step = jax.jit(jax.vmap(lambda s, u: jquad.step(jcfg, s, u, task)))
        jenv, jout = step(jbs.env, jnp.asarray(a))
        assert jenv.x.dtype == jnp.float32
    tbs = env_state_from_numpy(_np_tree(jbs), device="cpu")
    tenv, tout = ktick.env_step_plain(tcfg, tbs.env, _t(a), task)
    for name in ("x", "v", "R", "W", "eIx", "eIx_integrand", "eIb1",
                 "eIb1_integrand", "f_total", "M"):
        assert _k1(_np(getattr(tenv, name)), getattr(jenv, name)), name
    np.testing.assert_array_equal(_np(tenv.t), np.asarray(jenv.t))
    jobs = jout.obs if isinstance(jout.obs, tuple) else (jout.obs,)
    assert len(tout.obs) == len(jobs) == ktick.N_AGENTS[task]
    for got, ref in zip(tout.obs, jobs):
        assert _k1(_np(got), ref)
    assert _k1(_np(tout.reward), jout.reward)
    assert _k1(_np(tout.info["ex"]), jout.info["ex"])
    assert _k1(_np(tout.info["eb1"]), jout.info["eb1"])
    done = _np(tout.done)
    np.testing.assert_array_equal(done, np.asarray(jout.done))
    assert done[0].any()                         # the x crash
    if task == "quad":
        assert done[1:4].all()                   # the tilts, singular pitch
    for part in ("goal", "params"):
        assert getattr(tbs.env, part) is getattr(tenv, part), part


def test_step_entry_contract():
    """The step entry's instances, output slots and wrapper on the CPU: the
    quad task has the step entry only and exact_so3 instances only; the
    step writes a prefix of each output buffer; ``env_step`` on CPU tensors
    is its plain twin and launches nothing; the env's fields are a prefix
    of the packed state, which ``pack_env``/``unpack_env`` round-trip."""
    cfg = TConfig(framework="MONO", integrator="dop853", exact_so3=True)
    assert ktick.instance(cfg, "quad") == "quad_dop853_exact"
    assert ktick.instance(cfg) == "coupled_dop853_exact"
    with pytest.raises(NotImplementedError, match="quad"):
        ktick.task_of(cfg.replace(exact_so3=False), "quad")
    with pytest.raises(NotImplementedError):
        ktick.task_of(cfg, "hover")
    widths = {t: (ktick.out_width(t, "F", True), ktick.out_width(t, "B", True))
              for t in TASKS}
    assert widths == {"quad": (18 + 1 + 3 + 1, 1), "coupled": (23 + 1 + 3 + 1, 1),
                      "decoupled": (15 + 3 + 2 + 3 + 1, 2)}
    assert ktick.out_width("quad", "F") == 23
    n = 8
    jcfg = JConfig(num_envs=n, framework="MONO", integrator="dop853",
                   exact_so3=True)
    with jax.enable_x64(False):
        jbs = _crash_states(jcfg, n, 5)
    tbs = env_state_from_numpy(_np_tree(jbs), device="cpu")
    a = _t(_actions("quad", n, 6).astype(np.float32))
    before = (ktick.env_step.launches, ktick.env_tick.launches)
    s1, o1 = ktick.env_step(cfg, tbs.env, a, "quad")
    s2, o2 = ktick.env_step_plain(cfg, tbs.env, a, "quad")
    assert (ktick.env_step.launches, ktick.env_tick.launches) == before
    for x, y in zip(jax.tree.leaves(o1), jax.tree.leaves(o2)):
        assert torch.equal(x, y)
    assert torch.equal(s1.x, s2.x)
    env_bufs, bufs = ktick.pack_env(tbs.env), ktick.pack_state(tbs)
    assert len(env_bufs) == 2
    for e, b in zip(env_bufs, bufs):
        assert torch.equal(e, b[:e.numel()])
    for (p, x), (q, y) in zip(
            tree_named_leaves(ktick.unpack_env(env_bufs, n)),
            tree_named_leaves(tbs.env)):
        assert p == q and torch.equal(x, y), p


# ---------------------------------------------------------------------------
# envs/integrals.py
# ---------------------------------------------------------------------------
def test_integrals_match_jax():
    """The trapezoid and the backward difference, scalars and 3-vectors,
    30 updates in float64: bit for bit."""
    rng = np.random.default_rng(7)
    dt = 1.0 / 200
    for shape in ((), (3,)):
        ji = jint.IntegralState.zero(shape, jnp.float64)
        ti = tint.IntegralState.zero(shape, torch.float64)
        jd = jint.DerivativeState.zero(shape, jnp.float64)
        td = tint.DerivativeState.zero(shape, torch.float64)
        for _ in range(30):
            y = rng.normal(size=shape)
            ji = jint.integrate(ji, jnp.asarray(y), dt)
            ti = tint.integrate(ti, _t(y), dt)
            jd = jint.derivative(jd, jnp.asarray(y), dt)
            td = tint.derivative(td, _t(y), dt)
            for got, ref in zip(tuple(ti) + tuple(td), tuple(ji) + tuple(jd)):
                np.testing.assert_array_equal(_np(got), np.asarray(ref))
    assert tint.IntegralState.zero().error.dtype == torch.float32
