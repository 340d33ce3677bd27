"""The port's offline analysis (``gym_rotor_tpu_torch.analysis``) vs the JAX
package's: the learning-curve parser on every ``docs/learning_curve_*.txt``
and the flight-log tools on logs the port's driver wrote."""
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_rotor_tpu.analysis import draw_plot as jdraw
from gym_rotor_tpu.analysis import learning_curves as jcurves
from gym_rotor_tpu_torch.analysis import draw_plot as tdraw
from gym_rotor_tpu_torch.analysis import learning_curves as tcurves
from gym_rotor_tpu_torch.train import main as tmain

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CURVES = sorted((ROOT / "docs").glob("learning_curve_*.txt"))


@pytest.mark.parametrize("path", CURVES, ids=lambda p: p.name)
def test_parse_eval_log_matches_jax(path):
    ts, tb = tcurves.parse_eval_log(str(path))
    js, jb = jcurves.parse_eval_log(str(path))
    assert len(ts) > 0
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tb, jb)
    assert ts.dtype == js.dtype and tb.dtype == jb.dtype


def test_parse_eval_log_reads_the_drivers_log(tmp_path, monkeypatch):
    """The eval log the port's driver writes parses to its eval steps."""
    monkeypatch.chdir(tmp_path)
    tmain(["--num_envs", "8", "--max_steps", "16", "--eval_max_steps",
           "1", "--num_eval", "2", "--seed", "3", "--replay_buffer_size",
           "64", "--batch_size", "8", "--critic_hidden_dim", "8",
           "--actor_hidden_dim", "8", "4", "--framework", "MONO",
           "--use_equiv", "False", "--max_timesteps", "40",
           "--start_timesteps", "16", "--eval_freq", "8"], device="cpu")
    path = tmp_path / "results" / "log_eval_seed_3.txt"
    for mod in (tcurves, jcurves):
        steps, bench = mod.parse_eval_log(str(path))
        assert steps.tolist() == [24, 32, 40]
        assert np.isfinite(bench).all()


@pytest.fixture(scope="module")
def flight_logs(tmp_path_factory):
    """A ``.dat`` flight log from the port's driver (``--save_log``, the
    eval before training) for each framework, seeded EMLP actors."""
    import os
    out = {}
    for fw in ("MODUL", "MONO"):
        d = tmp_path_factory.mktemp(fw)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            tmain(["--framework", fw, "--num_envs", "4", "--num_eval", "2",
                   "--eval_max_steps", "1", "--max_timesteps", "1",
                   "--replay_buffer_size", "64",
                   "--critic_hidden_dim", "8", "--save_log", "True"],
                  device="cpu")
        finally:
            os.chdir(cwd)
        (dat,) = (d / "results").glob(f"{fw}_log_*.dat")
        out[fw] = dat
    return out


@pytest.mark.parametrize("fw", ["MODUL", "MONO"])
def test_flight_log_tools_match_jax(fw, flight_logs):
    """``parse_log`` (framework from the file name), ``reconstruct_wrench``
    and ``rmse_report`` equal the JAX package's on the same file."""
    path = str(flight_logs[fw])
    tl, jl = tdraw.parse_log(path), jdraw.parse_log(path)
    assert tl.framework == jl.framework == fw
    assert tl.act.shape == (200, 5 if fw == "MODUL" else 4)
    for name in ("act", "state", "eIx", "eb1", "eIb1", "xd", "vd", "b1c",
                 "Wd"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name))
    tl, jl = tdraw.reconstruct_wrench(tl), jdraw.reconstruct_wrench(jl)
    for name in ("f_total", "M", "forces"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name))
    tr, jr = tdraw.rmse_report(tl), jdraw.rmse_report(jl)
    assert tr == jr and len(tr) == 8
    assert all(np.isfinite(v) for v in tr.values())


def test_plots_and_mains(flight_logs, tmp_path, capsys):
    """The plotting functions and both ``main``s write their files
    (matplotlib, imported only inside them, on the Agg backend)."""
    report = tdraw.main([str(flight_logs["MODUL"]), "--out_dir",
                         str(tmp_path)])
    assert report == jdraw.rmse_report(jdraw.reconstruct_wrench(
        jdraw.parse_log(str(flight_logs["MODUL"]))))
    assert len(list(tmp_path.glob("fig*.png"))) == 6
    out = tmp_path / "curves.png"
    tcurves.main([f"td3={CURVES[0]}", str(CURVES[1]), "--out", str(out)])
    assert out.stat().st_size > 0
    assert "RMSE summary" in capsys.readouterr().out


def test_analysis_imports_no_matplotlib():
    """Importing the analysis modules loads no matplotlib (the card's
    machine has none)."""
    import subprocess
    import sys
    code = ("import sys, gym_rotor_tpu_torch.analysis; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True)
    assert out.stdout.strip() == "False"
