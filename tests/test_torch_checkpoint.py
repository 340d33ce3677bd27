"""The port's checkpoints vs the JAX package's: the msgpack codec against
``msgpack`` and flax's serialization, actor files both ways (the same
bytes for the same parameters, the same file names, ``docs/artifacts``'
actors evaluated by both packages), and the port's versioned train state
(bitwise round trips, the fold cache after a load, foreign files refused).
"""
import copy
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from gym_rotor_tpu.algos import ppo as jppo
from gym_rotor_tpu.algos import sac as jsac
from gym_rotor_tpu.algos import td3 as jtd3
from gym_rotor_tpu.models import ppo_models, sac_models, td3_models
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu.utils import checkpoint as jckpt
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch import evaluate as tevaluate
from gym_rotor_tpu_torch.algos.ppo import PPOAgent
from gym_rotor_tpu_torch.algos.sac import SACAgent
from gym_rotor_tpu_torch.algos.td3 import TD3Agent
from gym_rotor_tpu_torch.train import Learner
from gym_rotor_tpu_torch.utils import checkpoint as tckpt
from gym_rotor_tpu_torch.utils import msgpack as tmsgpack
from gym_rotor_tpu_torch.utils.config import Config as TConfig

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
ARTIFACTS = ROOT / "docs" / "artifacts"

# -- the codec -------------------------------------------------------------
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
        -2 ** 31 - 1, -2 ** 63]
SCALARS = INTS + [0.0, -0.0, 1.5, -2.25e-300, float("inf"), True, False,
                  None, "", "a" * 31, "a" * 32, "a" * 255, "a" * 256,
                  "a" * 65536, "dé", b"", b"x" * 255, b"x" * 256,
                  b"y" * 65536]
CONTAINERS = [list(range(15)), list(range(16)), list(range(65536)),
              {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
              {str(i): None for i in range(65536)},
              {"b": {"a": [1, {"c": "d"}]}, "a": []}]


@pytest.mark.parametrize("obj", SCALARS + CONTAINERS,
                         ids=lambda o: f"{type(o).__name__}:{repr(o)[:24]}")
def test_codec_matches_msgpack(obj):
    """Every format msgpack writes for these values, byte for byte, and
    read back to the value."""
    data = msgpack.packb(obj, use_bin_type=True)
    assert tmsgpack.packb(obj) == data
    assert tmsgpack.unpackb(data) == obj


def _array_trees():
    rng = np.random.default_rng(0)
    return {
        "zero_d": {"x": np.array(3.5, np.float32), "n": np.array(7, np.int32)},
        "empty": {"e": np.zeros((0,), np.float32),
                  "e2": np.zeros((3, 0), np.float64)},
        "dtypes": {k: rng.integers(-100, 100, 6).astype(k) for k in
                   ("int8", "int16", "int32", "int64", "uint8", "uint16",
                    "uint32", "uint64", "float16", "float32", "float64",
                    "bool")},
        "nested": {"params": {"b": {"k": rng.normal(size=(4, 3))},
                              "a": {"k": rng.normal(size=(2, 2, 2))
                                    .astype(np.float32)}},
                   "count": 5, "lr": 0.25, "tag": "x",
                   "big": rng.normal(size=(70000,)).astype(np.float32)},
    }


@pytest.mark.parametrize("name", list(_array_trees()))
def test_codec_matches_flax_on_array_trees(name):
    """ndarrays as ext type 1 (shape, dtype name, C bytes), keys in
    insertion order: ``flax.serialization.to_bytes``'s bytes, and its
    bytes decoded to the same tree."""
    tree = _array_trees()[name]
    data = serialization.to_bytes(tree)
    assert tmsgpack.packb(tree) == data
    back = tmsgpack.unpackb(data)
    ref = serialization.msgpack_restore(data)
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_r]
    for (_, x), (_, y) in zip(flat_b, flat_r):
        assert type(x) is type(y)
        if isinstance(x, (np.ndarray, np.generic)):
            assert x.dtype == y.dtype and np.shape(x) == np.shape(y)
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        else:
            assert x == y


def test_codec_refuses_chunks_and_trailing_bytes(monkeypatch):
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="chunk"):
        tmsgpack.packb({"a": np.zeros(17, np.float32)})
    chunked = serialization.msgpack_serialize({"a": np.zeros(17, np.float32)})
    with pytest.raises(ValueError, match="chunked"):
        tmsgpack.unpackb(chunked)
    with pytest.raises(ValueError, match="after"):
        tmsgpack.unpackb(msgpack.packb(1) + b"\x00")
    # flax's numpy-scalar ext type: refused both ways, not guessed
    with pytest.raises(TypeError):
        tmsgpack.packb({"s": np.float32(1.25)})
    with pytest.raises(ValueError, match="ext type 3"):
        tmsgpack.unpackb(serialization.to_bytes({"s": np.float32(1.25)}))


# -- actor files -------------------------------------------------------------
FAMILIES = [(algo, fw, eq, i) for algo in ("TD3", "SAC", "PPO")
            for fw, eq in (("MODUL", True), ("MODUL", False),
                           ("MONO", True), ("MONO", False))
            for i in range(2 if fw == "MODUL" else 1)]
J_AGENTS = {"TD3": (jtd3.TD3Agent, td3_models), "SAC": (jsac.SACAgent,
                                                         sac_models),
            "PPO": (jppo.PPOAgent, ppo_models)}
T_AGENTS = {"TD3": TD3Agent, "SAC": SACAgent, "PPO": PPOAgent}


def _cfgs(fw, eq):
    kw = dict(framework=fw, use_equiv=eq, critic_hidden_dim=8)
    return JConfig(**kw), TConfig(**kw)


@pytest.mark.parametrize("algo,fw,eq,i", FAMILIES,
                         ids=lambda v: str(v))
def test_actor_files_match_flax_both_ways(algo, fw, eq, i, tmp_path):
    """A JAX agent's actor, carried into the port: the port's file has the
    JAX file's name and bytes, loads back bitwise in both packages, and the
    JAX file loads in the port to the same flat vector."""
    jcfg, tcfg = _cfgs(fw, eq)
    jcls, models = J_AGENTS[algo]
    jstate = jcls(jcfg, i, models(jcfg, i)).init(jax.random.PRNGKey(3 + i))
    jactor = jax.tree.map(np.asarray, jstate.actor)
    agent = T_AGENTS[algo](tcfg, i, "cpu")
    st = agent.init(torch.Generator().manual_seed(0))
    flat = convert.flat_from_jax(jactor, agent.actor_layout, "cpu")
    tree = convert.flat_to_jax(flat, agent.actor_layout)
    assert tmsgpack.packb(tree) == serialization.to_bytes(jstate.actor)
    args = (algo, fw, 450016, i, 1992)
    tpath = tckpt.save_actor(str(tmp_path / "t"), tree, *args)
    jpath = jckpt.save_actor(str(tmp_path / "j"), jstate.actor, *args)
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert Path(tpath).read_bytes() == Path(jpath).read_bytes()
    back = jckpt.load_actor(tpath, jstate.actor)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jstate.actor)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    template = convert.flat_to_jax(st.actor, agent.actor_layout)
    loaded = tckpt.load_actor(jpath, template)
    got = convert.flat_from_jax(loaded, agent.actor_layout, "cpu")
    assert got.numpy().tobytes() == flat.numpy().tobytes()
    # the state_dict converters agree with the flat one
    to_jax = {"TD3": convert.actor_params_to_jax,
              "SAC": convert.sac_actor_params_to_jax,
              "PPO": convert.ppo_actor_params_to_jax}[algo]
    sd = agent.actor_layout.views(flat)
    assert tmsgpack.packb(to_jax(sd, tcfg, i)) == tmsgpack.packb(tree)


@pytest.mark.parametrize("steps", [0, 1, 96, 2000, 300000, 450016, 1999999,
                                   123456789])
@pytest.mark.parametrize("solved", [False, True])
def test_actor_file_names_match_jax(steps, solved):
    args = ("models", "TD3", "MODUL", steps, 1, 1992, solved)
    assert tckpt._actor_path(*args) == jckpt._actor_path(*args)


def test_load_actor_checks_the_template(tmp_path):
    tcfg = TConfig()
    agent = TD3Agent(tcfg, 1, "cpu")
    st = agent.init(torch.Generator().manual_seed(0))
    template = convert.flat_to_jax(st.actor, agent.actor_layout)
    path = ARTIFACTS / "TD3_MODUL_300.0k_steps_agent_0_1992.msgpack"
    with pytest.raises(ValueError, match="expected float32"):
        tckpt.load_actor(str(path), template)


def _artifact_tree(name):
    return tmsgpack.unpackb((ARTIFACTS / name).read_bytes())


ARTIFACT_PAIRS = [
    ("TD3_MODUL_300.0k_steps_agent_0_1992.msgpack",
     "TD3_MODUL_300.0k_steps_agent_1_1992.msgpack"),
    ("TD3_MODUL_100.0k_steps_agent_0_1992.msgpack",
     "TD3_MODUL_450.016k_steps_agent_1_solved_1992.msgpack"),
    ("TD3_MODUL_300.0k_steps_agent_0_1992.msgpack",
     "TD3_MODUL_500.0k_steps_agent_1_1992.msgpack"),
]


def test_artifacts_reload_bitwise():
    """The five saved actors decode in the port and re-encode to their
    files' bytes."""
    names = sorted(p.name for p in ARTIFACTS.glob("*.msgpack"))
    assert len(names) == 5
    for name in names:
        data = (ARTIFACTS / name).read_bytes()
        assert tmsgpack.packb(tmsgpack.unpackb(data)) == data


def test_artifacts_evaluate_as_in_jax():
    """Each pair of ``docs/artifacts`` actors (all five files), loaded by
    the port's ``load_actor`` into a port learner, under
    ``eval_stream="reference"`` (the reference's ten seeded episodes, 5 s
    each, the driver's default): ``evaluate`` vs JAX ``build_eval_rollout``
    on the flax actors.
    Float32 closed loop, ``test_torch_slice.py``'s tolerance: rewards to
    1e-5 relative, success equal, last errors to 1e-5."""
    import train as train_mod
    jcfg = JConfig(eval_stream="reference")
    tcfg = TConfig(eval_stream="reference", num_envs=4,
                   replay_buffer_size=8, critic_hidden_dim=8)
    mods = [jzoo.EMLPActorDet(*jzoo.actor_reps(jcfg, "MODUL", i))
            for i in range(2)]

    def act_eval(params, obs):
        return jnp.concatenate([m.apply(p, o) for m, p, o in
                                zip(mods, params, obs)], axis=-1)
    rollout = train_mod.build_eval_rollout(jcfg, act_eval)
    learner = Learner(tcfg, device="cpu")
    for names in ARTIFACT_PAIRS:
        params = [jax.tree.map(jnp.asarray, _artifact_tree(n)) for n in names]
        ep_j, bench_j, succ_j, ex_j, eb1_j, _ = rollout(params, None)
        for i, n in enumerate(names):
            learner.load_actor(i, str(ARTIFACTS / n))
        ep_t, bench_t, succ_t, ex_t, eb1_t, _ = tevaluate.evaluate(
            tcfg, learner.actors(), device="cpu")
        assert float(bench_j) > 100.0           # the trained pairs fly
        np.testing.assert_allclose(ep_t.numpy(), np.asarray(ep_j), rtol=1e-5)
        np.testing.assert_allclose(float(bench_t), float(bench_j), rtol=1e-5)
        np.testing.assert_array_equal(succ_t.numpy(), np.asarray(succ_j))
        np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(eb1_t), float(eb1_j), rtol=0,
                                   atol=1e-5)


# -- train state -----------------------------------------------------------
def _tiny(algo, **kw):
    base = dict(rl_algo=algo, num_envs=4, max_steps=8, start_timesteps=8,
                batch_size=8, replay_buffer_size=24, critic_hidden_dim=8,
                actor_hidden_dim=(8, 4), num_eval=2, eval_max_steps=1,
                seed=5)
    if algo == "PPO":
        base.update(T_horizon=8, K_epochs=1, actor_batch_size=4,
                    critic_batch_size=4)
    base.update(kw)
    return TConfig(**base)


def _tensors(x, path=""):
    """Every tensor and host number of a state, by path."""
    import dataclasses
    if dataclasses.is_dataclass(x):
        out = {}
        for f in dataclasses.fields(x):
            out.update(_tensors(getattr(x, f.name), f"{path}.{f.name}"))
        return out
    return {path: x}


def _same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert list(ta) == list(tb)
    for k in ta:
        x, y = ta[k], tb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.numpy().tobytes() == y.numpy().tobytes(), k
        else:
            assert type(x) is type(y) and x == y, k


@pytest.mark.parametrize("algo,ring", [("TD3", True), ("TD3", False),
                                       ("SAC", True), ("SAC", False),
                                       ("PPO", False)])
def test_train_state_round_trips_bitwise(algo, ring, tmp_path):
    """Save after a few supersteps, load into a fresh learner: every state
    tensor, counter and optimizer moment bitwise, the generators where
    they were, the ring (when saved); the networks' ``param_version``
    moved and the actors act as before the save; the next superstep's
    results equal the original learner's."""
    extra = dict(automatic_entropy_tuning=True) if algo == "SAC" else {}
    cfg = _tiny(algo, checkpoint_replay=ring, **extra)
    a = Learner(cfg, device="cpu")
    for _ in range(3):
        a.superstep()
    path = a.save_checkpoint(str(tmp_path / "ts.msgpack"))
    obs = tuple(o.clone() for o in a.obs)
    acts = tevaluate.joint_policy(a.actors())(obs)
    b = Learner(cfg, device="cpu")
    versions = [ag.actor_net.param_version for ag in b.agents]
    b.load_checkpoint(path)
    assert [ag.actor_net.param_version for ag in b.agents] != versions
    for sa, sb in zip(a.states, b.states):
        _same(sa, sb)
    assert b.total_timesteps == a.total_timesteps
    assert b.explor_noise_std == a.explor_noise_std
    assert torch.equal(b.gen.get_state(), a.gen.get_state())
    assert torch.equal(b.init_gen.get_state(), a.init_gen.get_state())
    if algo != "PPO":
        if ring:
            assert (b.replay.ptr, b.replay.filled) == (a.replay.ptr,
                                                       a.replay.filled)
            assert torch.equal(b.replay.data, a.replay.data)
        else:
            assert b.replay.filled == 0
    assert torch.equal(tevaluate.joint_policy(b.actors())(obs), acts)
    if algo != "PPO" and ring:
        # the same env state and ring: the next superstep agrees bitwise
        b.loop, b.obs, b.ep_ret = (copy.deepcopy(a.loop), obs,
                                   a.ep_ret.clone())
        a.superstep()
        b.superstep()
        for sa, sb in zip(a.states, b.states):
            _same(sa, sb)


def test_train_state_refuses_foreign_files(tmp_path):
    """A JAX train state (no ``format``), another version and another
    configuration each raise, naming what they found."""
    cfg = _tiny("TD3")
    learner = Learner(cfg, device="cpu")
    jpath = tmp_path / "jax.msgpack"
    jckpt.save_train_state(str(jpath), {
        "states": [{"total_it": np.zeros((), np.int32)}],
        "key": np.zeros(2, np.uint32), "total_timesteps": 0,
        "explor_noise_std": 0.3})
    with pytest.raises(ValueError, match="explor_noise_std.*key.*states"):
        learner.load_checkpoint(str(jpath))
    path = learner.save_checkpoint(str(tmp_path / "ts.msgpack"))
    tree = tmsgpack.unpackb(Path(path).read_bytes())
    assert list(tree)[:2] == ["format", "version"]
    tree["version"] = 99
    Path(path).write_bytes(tmsgpack.packb(tree))
    with pytest.raises(ValueError, match="version 99"):
        learner.load_checkpoint(path)
    path = learner.save_checkpoint(str(tmp_path / "ts.msgpack"))
    other = Learner(_tiny("TD3", framework="MONO"), device="cpu")
    with pytest.raises(ValueError, match="saved for"):
        other.load_checkpoint(path)
