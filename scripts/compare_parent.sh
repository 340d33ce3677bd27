#!/bin/bash
# An earlier commit against this tree on one CUDA device, in one process
# tree: chip_smoke.py on this tree, then K1 and K2 write + K8 of both on
# every instance and entry (tick_replay_vs_parent.py: bitwise outputs,
# times in turns), then K6 and K13 of both (optim_loss_vs_parent.py
# --sweep: bitwise where the order of summation cannot show, one launch a
# call, times in turns, other launch plans), then K12 and the MLP PPO
# actor's acting of both (gae_head_vs_parent.py --sweep: td bitwise, one
# kernel a call, times in turns, K12's other launch plans), then the
# superstep profiles of the TD3 flagship, of PPO A with EMLP and with MLP
# networks (Mod-MLP) and of PPO B (torch_train_profile.py, PPO A over 2
# supersteps a window) and the 4096-env acting rollout's
# (torch_rollout_profile.py), each side's process in turn over ROUNDS
# rounds (parent, this tree; this tree, parent; ...).
#
#   scripts/compare_parent.sh PARENT_DIR OUT_DIR [ROUNDS]
#
# PARENT_DIR: a checkout of the earlier commit (git archive into a
# git-ignored directory of the repo).  Writes smoke.log, vs_parent.log,
# vs_parent_optim_loss.log, vs_parent_gae_head.log and
# prof_<td3|ppoa|ppoa_mlp|ppob|act>_<parent|change>_<round>.log under
# OUT_DIR; prints each step's exit code.  Exits non-zero if any step
# failed.
set -u
HERE=$(cd "$(dirname "$0")/.." && pwd)
PARENT=$(cd "$1" && pwd)
mkdir -p "$2"
OUT=$(cd "$2" && pwd)
ROUNDS=${3:-3}
fail=0
t0=$(date +%s)
step() {  # step NAME DIR COMMAND...: run COMMAND in DIR into OUT/NAME.log
  local name=$1 dir=$2
  shift 2
  (cd "$dir" && "$@" > "$OUT/$name.log" 2>&1)
  local rc=$?
  echo "$name rc=$rc $(( $(date +%s) - t0 ))s"
  [ $rc -eq 0 ] || fail=1
}
step smoke "$HERE" python3 chip_smoke.py
step vs_parent "$HERE" python3 scripts/tick_replay_vs_parent.py \
  --parent "$PARENT"
step vs_parent_optim_loss "$HERE" python3 scripts/optim_loss_vs_parent.py \
  --parent "$PARENT" --sweep
step vs_parent_gae_head "$HERE" python3 scripts/gae_head_vs_parent.py \
  --parent "$PARENT" --sweep
for r in $(seq 1 "$ROUNDS"); do
  if [ $((r % 2)) -eq 1 ]; then order="parent change"; else order="change parent"; fi
  for side in $order; do
    dir=$HERE
    [ "$side" = parent ] && dir=$PARENT
    step "prof_td3_${side}_$r" "$dir" python3 scripts/torch_train_profile.py
    step "prof_ppoa_${side}_$r" "$dir" python3 scripts/torch_train_profile.py \
      --algo ppo --config A --steps 2
    step "prof_ppoa_mlp_${side}_$r" "$dir" \
      python3 scripts/torch_train_profile.py --algo ppo --config A \
      --use_equiv 0 --steps 2
    step "prof_ppob_${side}_$r" "$dir" python3 scripts/torch_train_profile.py \
      --algo ppo --config B
    step "prof_act_${side}_$r" "$dir" python3 scripts/torch_rollout_profile.py
  done
done
exit $fail
