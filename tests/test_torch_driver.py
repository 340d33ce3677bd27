"""The port's training driver (``gym_rotor_tpu_torch.train``: ``Learner``,
``main``) vs the JAX driver (``train.py``), both through ``main(argv)`` on
the CPU at tiny sizes: the CLI, the eval and checkpoint schedule, the actor
files saved from a scripted sequence of eval results, the log lines,
``--resume``, ``--test_model``, the flight log, TensorBoard and the
profiler hook.  Random draws cannot match (threefry against Philox), so no
reward is compared across the packages."""
import os
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_rotor_tpu.utils import config as jconfig
from gym_rotor_tpu_torch import evaluate as tevaluate
from gym_rotor_tpu_torch import train as ttrain
from gym_rotor_tpu_torch.utils import config as tconfig
from gym_rotor_tpu_torch.utils import logging as tlogs

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import train as jtrain  # noqa: E402


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parsers_have_the_same_flags_and_defaults():
    """Every flag of the JAX CLI, with its default, its type (checked on
    sample strings) and its arity; and the same Config from the same argv."""
    j, t = _actions(jconfig.create_parser()), _actions(tconfig.create_parser())
    assert list(j) == list(t)
    for name in j:
        a, b = j[name], t[name]
        assert a.option_strings == b.option_strings, name
        assert a.default == b.default, name
        assert a.nargs == b.nargs, name
        for s in ("1", "0", "true", "False", "yes", "2.5", "x"):
            try:
                want = a.type(s)
            except ValueError:
                with pytest.raises(ValueError):
                    b.type(s)
                continue
            assert b.type(s) == want and type(b.type(s)) is type(want), name
    argv = ["--framework", "MONO", "--lr_a", "1e-3", "2e-3", "--use_equiv",
            "false", "--num_envs", "64", "--eval_stream", "reference",
            "--checkpoint_replay", "1", "--actor_hidden_dim", "8", "2"]
    jc, tc = jconfig.config_from_args(argv), tconfig.config_from_args(argv)
    import dataclasses
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(tconfig.config_from_args([])) == \
        dataclasses.asdict(tconfig.Config())


BASE = ["--num_envs", "8", "--max_steps", "16", "--eval_max_steps", "1",
        "--num_eval", "4", "--seed", "7", "--replay_buffer_size", "128",
        "--batch_size", "16", "--critic_hidden_dim", "8",
        "--actor_hidden_dim", "8", "4", "--framework", "MONO",
        "--use_equiv", "False", "--checkpoint_path", "ck/ts.msgpack"]

# (eval reward per agent, all episodes succeed) per eval after the first;
# the best-so-far bar starts at 0.85 * 1 s / DT = 170
SCRIPT = [([171.0], True), ([170.5], False), ([180.0], False),
          ([150.0], True), ([185.5], True)]


def _scripted(calls, n_eval):
    """An ``eval_policy`` that records its timestep and returns the
    scripted results in turn (the eval before training gets a low one)."""
    def eval_policy(self):
        k = len(calls)
        calls.append(self.total_timesteps)
        rew, ok = ([0.0], False) if k == 0 else SCRIPT[(k - 1) % len(SCRIPT)]
        return (np.asarray(rew * self.cfg.n_agents, np.float32),
                float(100 + k),
                np.full((n_eval, self.cfg.n_agents), ok))
    return eval_policy


def _recording(saves, original):
    def save_checkpoint(self, path=None):
        saves.append(self.total_timesteps)
        return original(self, path)
    return save_checkpoint


def _actor_saves(monkeypatch, module, order):
    """Record the order in which a package writes actor files."""
    save = module.save_actor

    def rec(model_dir, params, *args, **kw):
        path = save(model_dir, params, *args, **kw)
        order.append(os.path.basename(path))
        return path
    monkeypatch.setattr(module, "save_actor", rec)


@pytest.mark.parametrize("extra", [
    ["--max_timesteps", "96", "--start_timesteps", "32", "--eval_freq",
     "20", "--checkpoint_freq", "24"],
    # eval_freq under a superstep's 8 env-steps: an eval every superstep
    ["--max_timesteps", "64", "--start_timesteps", "40", "--eval_freq", "3",
     "--checkpoint_freq", "16", "--framework", "MODUL"],
], ids=["mono", "modul_eval_every_superstep"])
def test_driver_schedule_matches_jax(extra, tmp_path, monkeypatch, capsys):
    """Both drivers, fed the same scripted eval results: evals and
    checkpoints at the same timesteps, the same actor files written in the
    same order, the same eval log, step-log lines that parse the same way,
    and the same notes printed."""
    from gym_rotor_tpu.utils import checkpoint as jckpt
    from gym_rotor_tpu_torch.utils import checkpoint as tckpt
    argv = BASE + extra
    runs = {}
    for name, mod, ck, kw in (("jax", jtrain, jckpt, {}),
                              ("port", ttrain, tckpt, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        calls, saves, order = [], [], []
        monkeypatch.setattr(mod.Learner, "eval_policy",
                            _scripted(calls, 4))
        monkeypatch.setattr(mod.Learner, "save_checkpoint",
                            _recording(saves, mod.Learner.save_checkpoint))
        _actor_saves(monkeypatch, ck, order)
        capsys.readouterr()
        learner = mod.main(argv, **kw)
        out = capsys.readouterr().out
        runs[name] = dict(
            calls=calls, saves=saves, order=order,
            files=sorted(os.listdir(d / "models")),
            eval_log=(d / "results" / "log_eval_seed_7.txt").read_text(),
            step_log=(d / "results" / "log_step_seed_7.txt").read_text(),
            notes=[ln for ln in out.splitlines() if ln.startswith("note:")],
            total=learner.total_timesteps, ckpt=(d / "ck" / "ts.msgpack"))
    j, t = runs["jax"], runs["port"]
    assert t["calls"] == j["calls"] and len(t["calls"]) > 3
    assert t["saves"] == j["saves"] and t["saves"]
    assert t["order"] == j["order"] and any("_solved" in n for n in t["order"])
    assert t["files"] == j["files"]
    assert t["eval_log"] == j["eval_log"]
    assert t["notes"] == j["notes"]
    assert t["total"] == j["total"]
    assert t["ckpt"].exists() and j["ckpt"].exists()
    line = re.compile(r"^(\d+)\t (\[[^\]]*\])$")
    for name in ("jax", "port"):
        for ln in runs[name]["step_log"].splitlines():
            m = line.match(ln)
            assert m, (name, ln)
            vals = eval(m.group(2))
            n = 2 if "MODUL" in extra else 1
            assert len(vals) == n and all(isinstance(v, float) for v in vals)
            assert int(m.group(1)) > int(extra[extra.index(
                "--start_timesteps") + 1])


def test_resume_continues_from_checkpoint(tmp_path, monkeypatch):
    """``--resume`` picks up ``total_timesteps``, the parameters and the
    ring from the checkpoint (as ``tests/test_train.py``'s JAX test), and
    trains on to the new ``max_timesteps``."""
    monkeypatch.chdir(tmp_path)
    args = BASE + ["--start_timesteps", "32", "--eval_freq", "64",
                   "--replay_buffer_size", "512"]
    first = ttrain.main(args + ["--max_timesteps", "128",
                                "--checkpoint_freq", "64",
                                "--checkpoint_replay", "True"],
                        device="cpu")
    seen = {}
    load = ttrain.Learner.load_checkpoint

    def spy(self, path=None):
        out = load(self, path)
        seen.update(total=self.total_timesteps,
                    actor=self.states[0].actor.clone(),
                    filled=self.replay.filled)
        return out
    monkeypatch.setattr(ttrain.Learner, "load_checkpoint", spy)
    resumed = ttrain.main(args + ["--max_timesteps", "192", "--resume",
                                  "True"], device="cpu")
    assert seen["total"] == first.total_timesteps == 128
    assert torch.equal(seen["actor"], first.states[0].actor)
    assert seen["filled"] == first.replay.filled > 0
    assert resumed.total_timesteps == 192
    assert resumed.replay.filled == 192
    assert resumed.states[0].total_it == first.states[0].total_it + 8


def test_test_model_answers_as_the_saved_actors(tmp_path, monkeypatch):
    """``--test_model`` loads each agent's newest actor file (by mtime) and
    evaluates it: the loaded actors equal the trained ones bitwise, and the
    eval gives the in-memory eval's answer bitwise."""
    monkeypatch.chdir(tmp_path)
    args = BASE + ["--framework", "MODUL", "--use_equiv", "True"]
    learner = ttrain.main(args + ["--max_timesteps", "48",
                                  "--start_timesteps", "32",
                                  "--eval_freq", "1000"], device="cpu")
    paths = []
    for i in range(2):
        os.makedirs("models", exist_ok=True)
        old = learner.save_actor(i)           # an older file first
        os.utime(old, (1, 1))
        learner.total_timesteps += 8
        paths.append(learner.save_actor(i))
    want = learner.eval_policy()
    tm = ttrain.main(args + ["--test_model", "True"], device="cpu")
    fresh = ttrain.Learner(tm.cfg, device="cpu")
    for i in range(2):
        assert torch.equal(tm.states[i].actor, learner.states[i].actor)
        assert (tm.agents[i].actor_net.param_version
                == fresh.agents[i].actor_net.param_version + 1)
    got = tm.eval_policy()
    assert got[0].tobytes() == want[0].tobytes() and got[1] == want[1]
    assert np.array_equal(got[2], want[2])


def test_load_best_actors_raises_without_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="no actor checkpoint"):
        ttrain.main(BASE + ["--test_model", "True"], device="cpu")


def test_flight_log_tensorboard_and_profile(tmp_path, monkeypatch, capsys):
    """``--save_log`` writes the eval's ``.dat`` flight log (rows of the
    action and the 35 state and command columns), ``--save_tensorboard``
    writes scalars (TensorBoard is present on this host), ``--profile_dir``
    a Chrome trace; the rate print is the JAX driver's; ``render_rows``
    draws the logged flight."""
    monkeypatch.chdir(tmp_path)
    clock = iter(np.arange(0.0, 1e6, 6.0))
    monkeypatch.setattr(ttrain, "time",
                        types.SimpleNamespace(perf_counter=clock.__next__))
    learner = ttrain.main(BASE + [
        "--max_timesteps", "48", "--start_timesteps", "32", "--eval_freq",
        "40", "--save_log", "True", "--save_tensorboard", "True",
        "--profile_dir", "prof"], device="cpu")
    out = capsys.readouterr().out
    res = tmp_path / "results"
    dats = sorted(res.glob("MONO_log_*.dat"))
    assert dats
    rows = np.loadtxt(dats[0])
    assert rows.shape == (200, 4 + 35)
    assert list((res / "tensorboard").iterdir())
    assert list((tmp_path / "prof").glob("trace_*.json"))
    assert re.search(r"^t=\d+  env-steps/s=[\d,]+  updates/s=[\d,.]+  "
                     r"noise=\d\.\d{3}$", out, re.M)
    assert learner.total_timesteps == 48
    # --render's drawing of env 0's flight, headless: a PNG and a GIF
    learner.render_rows(rows, max_frames=4)
    assert list(res.glob("render_*.png")) and list(res.glob("render_*.gif"))


def test_tensorboard_off_without_its_package(monkeypatch, capsys, tmp_path):
    """Where ``torch.utils.tensorboard`` cannot load (the card's machine has
    no tensorboard package) the writer is off and says so once."""
    import builtins
    real = builtins.__import__

    def no_tb(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ModuleNotFoundError("No module named 'tensorboard'")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_tb)
    tb = tlogs.TensorBoard(True, str(tmp_path), "tag")
    assert tb.writer is None
    tb.scalar("x", 1.0, 1)
    assert capsys.readouterr().out.count("TensorBoard is off") == 1
    assert tlogs.TensorBoard(False, str(tmp_path), "tag").writer is None
    assert capsys.readouterr().out == ""


def test_main_needs_a_device(monkeypatch):
    """``main`` runs on the card by default and raises where there is
    none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(BASE)
    with pytest.raises(ValueError, match="eval_stream"):
        ttrain.main(BASE + ["--eval_stream", "bogus"], device="cpu")


@pytest.mark.parametrize("algo", ["SAC", "PPO"])
def test_driver_runs_sac_and_ppo(algo, tmp_path, monkeypatch):
    """The driver's other learners at tiny sizes: evals logged once warm,
    every update counted, a checkpoint that loads back."""
    monkeypatch.chdir(tmp_path)
    extra = (["--T_horizon", "16", "--K_epochs", "2", "--actor_batch_size",
              "8", "--critic_batch_size", "8"] if algo == "PPO" else
             ["--start_timesteps", "16"])
    learner = ttrain.main(BASE + extra + [
        "--rl_algo", algo, "--max_timesteps", "48", "--eval_freq", "16",
        "--checkpoint_freq", "32"], device="cpu")
    evals = (tmp_path / "results" / "log_eval_seed_7.txt").read_text()
    assert len(evals.splitlines()) >= 2
    assert learner.states[0].total_it == (3 if algo == "PPO" else 4)
    again = ttrain.Learner(learner.cfg, device="cpu").load_checkpoint()
    assert again.total_timesteps == 32
    assert tevaluate.joint_policy(again.actors())(learner.obs).shape == (8, 4)
