#!/usr/bin/env bash
# The two paths that run the run-time-width K3/K4, on an earlier commit's
# tree and on this one in turns (earlier, this, this, earlier), each run a
# process of its own from its tree's root with that tree's chip_smoke.py:
#   - phase 26's PPO B at actor (64, 16) / critic 256: WIDTH_PPO_STEPS
#     supersteps through train.train, the second timed by CUDA events
#     ([ppo_train] ms_per_superstep);
#   - phase 28's GeneralEMLP(V -> V) at ch 384, 3 layers, over SO(3) and
#     S(4): a forward and backward at 4096 rows, twice ([general] network
#     step_ms; the first call also builds the plans).
# One log a run under OUT_DIR (run_1.log .. run_4.log).
#
#   bash scripts/rt_paths_vs_parent.sh PARENT_DIR OUT_DIR [ppo]
#
# With a third argument `ppo`, only the PPO B path runs.
#
# PARENT_DIR is a checkout of the earlier commit (git archive into a
# git-ignored directory of the repo) holding its gym_rotor_tpu_torch and
# chip_smoke.py.
set -euo pipefail
parent=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
general=$([ "${3:-}" = ppo ] && echo False || echo True)
i=0
for tree in "$parent" "$here" "$here" "$parent"; do
  i=$((i + 1))
  (cd "$tree" && python3 -c "
import torch, chip_smoke as cs
from gym_rotor_tpu_torch.utils.config import PPO_CONFIGS
dev = torch.device('cuda', 0)
cs.CARD = cs.gpu_name_power()
cs.log('paths', tree='$tree', run=$i, card=cs.CARD)
cs.width_projectors(dev)
cs.phase_train_ppo(dev, 'B_widths', dict(PPO_CONFIGS['B'], **cs.SLICE_WIDTH),
                   cs.WIDTH_PPO_STEPS, widths=True)
gen = torch.Generator(device=dev).manual_seed(cs.SEED + 28)
for name, (G, net) in (cs.general_models(dev).items() if $general else ()):
    for _ in range(2):
        cs.general_network(dev, name, G, net, gen)
") > "$out/run_$i.log" 2>&1
done
