"""Render learning curves from eval logs (port of
``gym_rotor_tpu/analysis/learning_curves.py``; the reference publishes
docs/learning_curves.png comparing Mod-EMLP / Mono-EMLP / Mod-MLP /
Mono-MLP, README.md:130-137).

    python -m gym_rotor_tpu_torch.analysis.learning_curves \
        td3=results/log_eval_seed_1992.txt --out curves.png

Input files: either ``log_eval_seed_*.txt`` written by the driver or the
``docs/learning_curve_*.txt`` evidence files (same format:
``steps\\tbenchmark\\t[eval rewards]``).
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np


def parse_eval_log(path: str):
    steps, bench = [], []
    num = r"([0-9]+\.?[0-9]*(?:[eE][+-]?[0-9]+)?)"
    with open(path) as f:
        for line in f:
            m = re.match(r"\s*(\d+)\s", line)
            if not m:
                continue
            step = int(m.group(1))
            mb = re.search(r"benchmark_reward:\s*" + num, line)
            if mb:
                val = float(mb.group(1))
            else:
                m2 = re.match(r"\s*\d+\s+" + num, line)
                if not m2:
                    continue
                val = float(m2.group(1))
            steps.append(step)
            bench.append(val)
    return np.asarray(steps), np.asarray(bench)


def plot(curves, out_path: str, title="Benchmark reward vs env steps"):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for label, (steps, bench) in curves.items():
        ax.plot(steps / 1e3, bench, lw=1.8, marker="o", ms=3, label=label)
    ax.set_xlabel("env steps (thousands)")
    ax.set_ylabel("benchmark reward (of 1000)")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("logs", nargs="+",
                    help="label=path pairs or bare paths")
    ap.add_argument("--out", default="learning_curves.png")
    args = ap.parse_args(argv)
    curves = {}
    for item in args.logs:
        if "=" in item:
            label, path = item.split("=", 1)
        else:
            label, path = os.path.basename(item), item
        curves[label] = parse_eval_log(path)
    out = plot(curves, args.out)
    print(out)


if __name__ == "__main__":
    main()
