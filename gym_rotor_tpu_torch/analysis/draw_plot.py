"""Offline flight-log analysis (port of
``gym_rotor_tpu/analysis/draw_plot.py``; reference draw_plot.py:1-402).

    python -m gym_rotor_tpu_torch.analysis.draw_plot results/MODUL_log_*.dat

Parses a ``.dat`` flight log written by the eval loop (columns
[action | state18 + eIx + eb1 + eIb1 | xd, vd, b1c, Wd]; layouts
draw_plot.py:24-33), reconstructs the applied wrench and per-motor thrusts
(including the MODUL virtual-moment reconstruction, draw_plot.py:54-64),
renders the five standard figures and prints the RMSE summary
(draw_plot.py:325-347).
"""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np

from ..envs.oracle import OracleParams, dot3

R2D = 180.0 / np.pi
DT = 1.0 / 200.0


@dataclass
class FlightLog:
    framework: str
    act: np.ndarray      # (T, 4|5)
    state: np.ndarray    # (T, 18)
    eIx: np.ndarray      # (T, 3)
    eb1: np.ndarray      # (T,)
    eIb1: np.ndarray     # (T,)
    xd: np.ndarray       # (T, 3)
    vd: np.ndarray
    b1c: np.ndarray
    Wd: np.ndarray
    # reconstructed:
    f_total: np.ndarray = None
    M: np.ndarray = None
    forces: np.ndarray = None   # (T, 4) per-motor thrusts


def parse_log(path: str, framework: str = None) -> FlightLog:
    """Column layout per framework (draw_plot.py:24-33)."""
    data = np.loadtxt(path)
    if framework is None:
        framework = "MODUL" if os.path.basename(path).startswith("MODUL") \
            else "MONO"
    na = 5 if framework == "MODUL" else 4
    act = data[:, 0:na]
    obs = data[:, na:na + 23]
    cmd = data[:, na + 23:]
    return FlightLog(
        framework=framework, act=act,
        state=obs[:, 0:18], eIx=obs[:, 18:21], eb1=obs[:, 21],
        eIb1=obs[:, 22],
        xd=cmd[:, 0:3], vd=cmd[:, 3:6], b1c=cmd[:, 6:9], Wd=cmd[:, 9:12],
    )


def reconstruct_wrench(log: FlightLog, params: OracleParams = None
                       ) -> FlightLog:
    """Rebuild f, M and per-motor thrusts from logged actions
    (draw_plot.py:52-64)."""
    p = params or OracleParams.nominal()
    T = log.act.shape[0]
    f = np.clip(4.0 * (p.scale_act * log.act[:, 0] + p.avrg_act),
                4.0 * p.min_force, 4.0 * p.max_force)
    M = np.zeros((T, 3))
    if log.framework == "MONO":
        M[:] = log.act[:, 1:4]
    else:
        tau, M3 = log.act[:, 1:4], log.act[:, 4]
        for t in range(T):
            R = log.state[t, 6:15].reshape(3, 3, order="F")
            W = log.state[t, 15:18]
            b1, b2 = R[:, 0], R[:, 1]
            M[t, 0] = dot3(b1, tau[t]) + p.J[2] * W[2] * W[1]
            M[t, 1] = dot3(b2, tau[t]) - p.J[2] * W[2] * W[0]
            M[t, 2] = M3[t]
    fM = np.concatenate([f[:, None], M], axis=1)
    forces = fM @ p.fM_to_forces.T
    log.f_total, log.M, log.forces = f, M, forces
    return log


def rmse_report(log: FlightLog) -> dict:
    """RMSE summary (draw_plot.py:325-347): ex [cm], ev [cm/s], eW [deg/s],
    yaw [deg]; rmse/max of f and M3."""
    x, v, W = log.state[:, 0:3], log.state[:, 3:6], log.state[:, 15:18]
    ex = x - log.xd
    ev = v - log.vd
    eW = W - log.Wd

    def rmse(e):
        return float(np.sqrt(np.mean(np.sum(e * e, axis=-1))))

    yaw = np.array([
        np.arctan2(log.state[t, 7], log.state[t, 6]) for t in range(len(x))
    ])
    yaw_d = np.arctan2(log.b1c[:, 1], log.b1c[:, 0])
    e_yaw = np.arctan2(np.sin(yaw - yaw_d), np.cos(yaw - yaw_d))

    report = {
        "rmse_ex_cm": rmse(ex) * 100.0,
        "rmse_ev_cm_s": rmse(ev) * 100.0,
        "rmse_eW_deg_s": rmse(eW) * R2D,
        "rmse_yaw_deg": float(np.sqrt(np.mean(e_yaw**2))) * R2D,
    }
    if log.f_total is not None:
        report.update({
            "rmse_f": float(np.sqrt(np.mean((log.f_total
                                             - np.mean(log.f_total))**2))),
            "max_f": float(np.max(log.f_total)),
            "rmse_M3": float(np.sqrt(np.mean(log.M[:, 2]**2))),
            "max_M3": float(np.max(np.abs(log.M[:, 2]))),
        })
    return report


def plot_all(log: FlightLog, out_dir: str = ".", show: bool = False):
    """The five standard figures (position, velocity, attitude/yaw, angular
    velocity, wrench + motor thrusts)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    t = np.arange(log.state.shape[0]) * DT
    paths = []

    def fig3(name, ylabels, actual, desired=None):
        fig, axes = plt.subplots(3, 1, figsize=(8, 7), sharex=True)
        for i, ax in enumerate(axes):
            ax.plot(t, actual[:, i], "b", lw=1, label="actual")
            if desired is not None:
                ax.plot(t, desired[:, i], "r--", lw=1, label="desired")
            ax.set_ylabel(ylabels[i])
            ax.grid(alpha=0.3)
        axes[0].legend(loc="upper right")
        axes[-1].set_xlabel("t [s]")
        p = os.path.join(out_dir, f"{name}.png")
        fig.savefig(p, dpi=110)
        paths.append(p)
        plt.close(fig)

    x, v, W = log.state[:, 0:3], log.state[:, 3:6], log.state[:, 15:18]
    fig3("fig1_position", ["x1 [m]", "x2 [m]", "x3 [m]"], x, log.xd)
    fig3("fig2_velocity", ["v1 [m/s]", "v2 [m/s]", "v3 [m/s]"], v, log.vd)

    yaw = np.arctan2(log.state[:, 7], log.state[:, 6]) * R2D
    yaw_d = np.arctan2(log.b1c[:, 1], log.b1c[:, 0]) * R2D
    fig, ax = plt.subplots(figsize=(8, 3.2))
    ax.plot(t, yaw, "b", lw=1, label="yaw")
    ax.plot(t, yaw_d, "r--", lw=1, label="yaw cmd")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("yaw [deg]")
    ax.legend()
    ax.grid(alpha=0.3)
    p = os.path.join(out_dir, "fig3_yaw.png")
    fig.savefig(p, dpi=110)
    paths.append(p)
    plt.close(fig)

    fig3("fig4_angular_velocity",
         ["W1 [rad/s]", "W2 [rad/s]", "W3 [rad/s]"], W, log.Wd)

    # integral errors + heading error (reference's eIx_eIb1 figure)
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for i in range(3):
        axes[0].plot(t, log.eIx[:, i], lw=1, label=f"eIx{i+1}")
    axes[0].set_ylabel("eIx [m s]")
    axes[0].legend(ncol=3)
    axes[0].grid(alpha=0.3)
    axes[1].plot(t, log.eb1, lw=1, label="eb1")
    axes[1].plot(t, log.eIb1, lw=1, label="eIb1")
    axes[1].set_ylabel("heading err")
    axes[1].set_xlabel("t [s]")
    axes[1].legend()
    axes[1].grid(alpha=0.3)
    p = os.path.join(out_dir, "fig6_eIx_eIb1.png")
    fig.savefig(p, dpi=110)
    paths.append(p)
    plt.close(fig)

    if log.forces is not None:
        fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        axes[0].plot(t, log.f_total, "k", lw=1, label="f_total")
        for i in range(4):
            axes[0].plot(t, log.forces[:, i], lw=0.8, label=f"T{i+1}")
        axes[0].set_ylabel("thrust [N]")
        axes[0].legend(ncol=5, fontsize=8)
        axes[0].grid(alpha=0.3)
        for i in range(3):
            axes[1].plot(t, log.M[:, i], lw=1, label=f"M{i+1}")
        axes[1].set_ylabel("moment [Nm]")
        axes[1].set_xlabel("t [s]")
        axes[1].legend(ncol=3)
        axes[1].grid(alpha=0.3)
        p = os.path.join(out_dir, "fig5_wrench.png")
        fig.savefig(p, dpi=110)
        paths.append(p)
        plt.close(fig)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description="Flight-log analysis")
    ap.add_argument("log_path")
    ap.add_argument("--framework", default=None)
    ap.add_argument("--out_dir", default=".")
    args = ap.parse_args(argv)
    log = parse_log(args.log_path, args.framework)
    log = reconstruct_wrench(log)
    paths = plot_all(log, args.out_dir)
    report = rmse_report(log)
    print("RMSE summary:")
    for k, v in report.items():
        print(f"  {k}: {v:.4f}")
    print("figures:", *paths, sep="\n  ")
    return report


if __name__ == "__main__":
    main()
