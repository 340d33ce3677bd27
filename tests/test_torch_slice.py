"""The port's acting slice end to end on the CPU, and guards on the port
package: the eval rollout vs ``train.build_eval_rollout`` with the repo's
trained actors, the rollout's invariants, no JAX imports, no silent CPU
fallback, and a wrapper plus plain twin for every CUDA source."""
import ast
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu.utils.checkpoint import load_actor
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch import convert, evaluate as tevaluate
from gym_rotor_tpu_torch.envs import batch as tbatch
from gym_rotor_tpu_torch.kernels import emlp_actor as kemlp
from gym_rotor_tpu_torch.kernels import env_tick as ktick
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
PORT = ROOT / "gym_rotor_tpu_torch"


def _trained_pair():
    """Flax params of the repo's trained TD3 MODUL actors (300k steps)."""
    out = []
    for i in range(2):
        rin, hid, rout = jzoo.actor_reps(JConfig(), "MODUL", i)
        mod = jzoo.EMLPActorDet(rin, hid, rout)
        tmpl = mod.init(jax.random.PRNGKey(0), jnp.zeros((1, rin.size)))
        path = ROOT / "docs" / "artifacts" / \
            f"TD3_MODUL_300.0k_steps_agent_{i}_1992.msgpack"
        out.append((mod, load_actor(str(path), tmpl)))
    return out


def test_evaluate_matches_build_eval_rollout():
    """10 eval envs x 200 ticks under the trained actors, from the same
    initial states (converted from the JAX reset).  Float32 closed loop:
    XLA's jit and torch round the tick differently by an ulp here and
    there, which the controller keeps from growing."""
    import train as train_mod
    jcfg = JConfig(eval_max_steps=1)
    tcfg = TConfig(eval_max_steps=1)
    pair = _trained_pair()

    def act_eval(states, obs):
        return jnp.concatenate([m.apply(p, o) for (m, p), o in zip(pair, obs)],
                               axis=-1)
    key = jax.random.PRNGKey(1992)
    ep_j, bench_j, succ_j, ex_j, eb1_j, _ = train_mod.build_eval_rollout(
        jcfg, act_eval)(None, key)

    jbs, jobs = jbatch.batched_reset(jcfg.replace(num_envs=jcfg.num_eval), key,
                                     "eval")
    tbs = convert.env_state_from_numpy(
        jax.tree.map(np.asarray, serialization.to_state_dict(jbs)), device="cpu")
    tobs = tuple(torch.from_numpy(np.array(o)) for o in jobs)
    actors = []
    for i, (mod, params) in enumerate(pair):
        rin, hid, rout = tzoo.actor_reps(tcfg, "MODUL", i)
        a = tzoo.EMLPActorDet(rin, hid, rout, device="cpu")
        a.load_state_dict(convert.actor_params_from_jax(
            jax.tree.map(np.asarray, params), tcfg, i))
        actors.append(a)
    ep_t, bench_t, succ_t, ex_t, eb1_t, _ = tevaluate.evaluate(
        tcfg, actors, generator=torch.Generator().manual_seed(0),
        device="cpu", init=(tbs, tobs))
    assert float(bench_j) > 150.0          # the trained pair flies
    np.testing.assert_allclose(ep_t.numpy(), np.asarray(ep_j), rtol=1e-5)
    np.testing.assert_allclose(float(bench_t), float(bench_j), rtol=1e-5)
    np.testing.assert_array_equal(succ_t.numpy(), np.asarray(succ_j))
    np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(eb1_t), float(eb1_j), rtol=0, atol=1e-5)


def test_rollout_invariants_cpu():
    """Port rollout with seeded actors: attitude stays on SO(3), rewards in
    [0, 1] or -1, resets happen, and the CPU path launches no kernel."""
    cfg = TConfig(num_envs=32, max_steps=40)
    gen = torch.Generator().manual_seed(0)
    bs, obs = tbatch.batched_reset(cfg, gen, device="cpu")
    actors = tzoo.make_actors(cfg, device="cpu", seed=1)
    before = (ktick.env_tick.launches, kemlp.emlp_actor.launches)
    bs, obs, trs, outs = tbatch.rollout(
        cfg, bs, obs, tevaluate.joint_policy(actors), 60, gen)
    assert (ktick.env_tick.launches, kemlp.emlp_actor.launches) == before
    R = bs.env.R
    assert float((R.transpose(-1, -2) @ R - torch.eye(3)).abs().max()) < 1e-5
    r = outs.reward
    assert bool(((r >= 0) & (r <= 1) | (r == -1)).all())
    assert int(outs.reset_happened.sum()) >= cfg.num_envs
    assert trs.action.shape == (60, 32, 5)
    assert outs.obs[0].shape == (60, 32, 15) and outs.obs[1].shape == (60, 32, 3)


def test_packed_state_round_trip():
    """``pack_state``/``unpack_state`` (the buffers the kernel path carries
    between ticks) keep every field, and the rollout's tick loop on the CPU
    is the plain tick repeated."""
    from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
    cfg = TConfig(num_envs=6, max_steps=5)
    gen = torch.Generator().manual_seed(3)
    bs, _ = tbatch.batched_reset(cfg, gen, device="cpu")
    bufs = ktick.pack_state(bs)
    assert [b.dtype for b in bufs] == [torch.float32, torch.int32, torch.bool]
    back = dict(tree_named_leaves(ktick.unpack_state(bufs, 6)))
    for path, leaf in tree_named_leaves(bs):
        assert torch.equal(back[path], leaf), path
    loop = ktick.TickLoop(cfg, bs)
    st = bs
    for _ in range(8):
        a = torch.rand(6, 5, generator=gen) - 0.5
        d = torch.rand(6, tbatch.D.N_DRAWS, generator=gen)
        out = loop.step(a, d)
        st, ref = ktick.env_tick_plain(cfg, st, a, d)
        assert torch.equal(out.reward, ref.reward)
    for (path, x), (_, y) in zip(tree_named_leaves(loop.state),
                                 tree_named_leaves(st)):
        assert torch.equal(x, y), path


def _port_modules():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_modules(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    banned = ("jax", "jaxlib", "flax", "optax", "gym_rotor_tpu")
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in banned, f"{path}: imports {name}"


def test_entry_points_need_a_device(monkeypatch):
    """Without ``device=`` the port asks for the card and raises when there
    is none; it never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig(num_envs=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.batched_reset(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tzoo.make_actors(cfg)
    actors = tzoo.make_actors(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tevaluate.evaluate(cfg, actors)
    bs, _ = tbatch.batched_reset(cfg, device="cpu")
    tree = {"env": {k: v.numpy() if isinstance(v, torch.Tensor) else
                    {kk: vv.numpy() for kk, vv in v.__dict__.items()}
                    for k, v in bs.env.__dict__.items()},
            "traj": {k: v.numpy() for k, v in bs.traj.__dict__.items()}}
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.env_state_from_numpy(tree)
    assert convert.env_state_from_numpy(tree, device="cpu").env.x.shape == (4, 3)


def test_no_jax_scan_covers_the_training_slice():
    """The import scan above walks every module of the package, the
    training slice's included."""
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"algos/replay.py", "algos/td3.py", "algos/common.py",
            "algos/regularizers.py", "parallel/train_step.py", "train.py",
            "kernels/replay.py", "kernels/emlp_block.py",
            "kernels/flat_adamw.py", "kernels/spectral.py",
            "algos/ppo.py", "kernels/gae.py", "kernels/ppo_loss.py"} <= names


def test_training_entry_points_need_a_device(monkeypatch):
    from gym_rotor_tpu_torch.algos import replay as treplay
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.parallel.train_step import make_td3_superstep
    from gym_rotor_tpu_torch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig(num_envs=4, critic_hidden_dim=8, actor_hidden_dim=(8, 4))
    for fn in (lambda: treplay.create(8, (15, 3), (4, 1)),
               lambda: TD3Agent(cfg, 0), lambda: train(cfg, 1),
               lambda: make_td3_superstep(cfg, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def test_fold_cache_refolds_after_optimizer_step():
    """The acting kernel's fold cache sees the flat optimizer's in-place
    write.  K6 writes the parameters through a raw pointer, which torch's
    ``_version`` does not see (shown here with a write through ``.data``);
    the optimizer wrapper bumps the actor's ``param_version`` after every
    step, and the next fold is of the new parameters."""
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.models.emlp.nn import project_linear
    cfg = TConfig(critic_hidden_dim=8, actor_hidden_dim=(8, 4))
    agent = TD3Agent(cfg, 0, "cpu")
    st = agent.init(torch.Generator().manual_seed(0))
    actor = agent.actor_net
    kernel = actor.network.block0.linear.kernel
    lo = st.actor.data_ptr()
    assert lo <= kernel.data_ptr() < lo + st.actor.numel() * 4
    f1 = kemlp.fold_actor(actor)
    assert kemlp.fold_actor(actor) is f1
    seen = kernel._version
    st.actor.data.mul_(1.5)                    # as a raw-pointer write
    assert kernel._version == seen
    assert kemlp.fold_actor(actor) is f1       # nobody said so: still cached
    grad = torch.randn(st.actor.shape, generator=torch.Generator().manual_seed(1))
    folds = kemlp.fold_actor.folds
    st.actor_opt = agent.actor_tx.update(st.actor, grad, st.actor_opt,
                                         target=st.actor_target, tau=cfg.tau,
                                         owner=actor)
    f2 = kemlp.fold_actor(actor)
    assert f2 is not f1 and kemlp.fold_actor.folds == folds + 1
    blk = actor.network.block0
    W, b = project_linear(blk.linear.rep_in, blk.linear.rep_out, kernel,
                          blk.linear.bias)
    torch.testing.assert_close(f2["blocks"][0][0], W.detach(), rtol=0, atol=0)
    assert not torch.equal(f1["blocks"][0][0], f2["blocks"][0][0])


def test_train_loop_cpu():
    """``train`` on the CPU at a tiny size: the warm gate on
    ``start_timesteps``, one update per train superstep, the exploration
    noise decay, the episode log, and no kernel launch."""
    from gym_rotor_tpu_torch.train import train
    cfg = TConfig(num_envs=6, max_steps=4, start_timesteps=12, batch_size=8,
                  replay_buffer_size=40, critic_hidden_dim=8,
                  actor_hidden_dim=(8, 4), max_timesteps=600)
    seen = []
    wrappers = [kemlp.emlp_actor, ktick.env_tick]
    before = [w.launches for w in wrappers]
    run = train(cfg, 6, device="cpu", log=None,
                on_superstep=lambda i, warm, m, r: seen.append((warm, set(m))))
    assert [w for w, _ in seen] == [True, True, False, False, False, False]
    assert "agent1/critic_loss" in seen[-1][1] and "agent0/actor_loss" in seen[-1][1]
    assert [s.total_it for s in run["states"]] == [4, 4]
    assert run["total_timesteps"] == 36 and run["replay"].filled == 36
    decay = (cfg.explor_noise_std_init - cfg.explor_noise_std_min) / 600 * 6
    assert run["noise_std"] == pytest.approx(
        max(cfg.explor_noise_std_init - 6 * decay, cfg.explor_noise_std_min))
    assert run["episodes"] and all(len(r) == 2 for _, r in run["episodes"])
    assert [w.launches for w in wrappers] == before


def test_every_cuda_source_has_wrapper_and_plain_twin():
    """Each ``csrc/<name>.cu`` is built by ``kernels/<name>.py``, whose
    ``WRAPPERS`` name every launching wrapper (with its launch count) and
    its plain twin; the source names the JAX code it replaces and its
    bound."""
    import importlib
    sources = sorted((PORT / "kernels" / "csrc").glob("*.cu"))
    assert {p.stem for p in sources} == {"env_tick", "emlp_actor", "replay",
                                         "emlp_block", "flat_adamw",
                                         "spectral", "sac_sample", "gae",
                                         "ppo_loss", "mlp_ppo_actor",
                                         "mlp_sac_actor"}
    for src in sources:
        mod = importlib.import_module(f"gym_rotor_tpu_torch.kernels.{src.stem}")
        assert mod.KERNEL.source == src
        assert mod.WRAPPERS
        for wrapper_name, plain_name in mod.WRAPPERS.items():
            wrapper = getattr(mod, wrapper_name)
            assert callable(wrapper) and isinstance(wrapper.launches, int)
            assert callable(getattr(mod, plain_name))
        text = src.read_text()
        assert "Replaces gym_rotor_tpu/" in text and "Bound on an H100" in text


def test_env_tick_source_uses_only_generated_fields():
    """Every state field, output slot and constant the kernel names is
    defined by the generated layout header (checked here because the
    compiler only runs on the card)."""
    header = ktick.layout_header()["env_tick_layout.h"]
    defined = set(re.findall(r"#define (\w+)", header))
    text = (PORT / "kernels" / "csrc" / "env_tick.cu").read_text()
    used = set()
    for m in re.finditer(r"\bLOADF\([^,]+,\s*([A-Z][A-Z0-9_]+)\)", text):
        used.add(f"F_{m.group(1)}")
    for m in re.finditer(r"\b(?:STOREF|STORE1|COPYF|ZEROF)\(([A-Z][A-Z0-9_]+)",
                         text):
        used.add(f"F_{m.group(1)}")
    for m in re.finditer(r"\bFIDX\(([A-Z][A-Z0-9_]+)", text):
        used.add(f"F_{m.group(1)}")
    for m in re.finditer(r"\b(IIDX|BIDX)\(([A-Z][A-Z0-9_]+)\)", text):
        used.add(f"{m.group(1)[0]}_{m.group(2)}")
    used |= set(re.findall(r"\b((?:OF|OB|D|TASK|INTEGRATOR)_[A-Z0-9_]+|"
                           r"ENV_(?:TRAIN|EVAL))\b", text))
    used -= {"F_NAME", "I_NAME", "B_NAME"}   # the macros' own parameter
    missing = sorted(u for u in used if u not in defined)
    assert not missing, missing
    assert len(used) > 60
