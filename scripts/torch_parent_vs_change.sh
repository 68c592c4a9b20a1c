#!/bin/sh
# Parent commit against the working tree on one card, in one call, in the
# order parent, change, change, parent (a card's clocks and a shared host
# drift between calls, so two trees are compared only within one).
#
#   git archive <parent-commit> | tar -x -C <dir>     # <dir> listed in .gitignore
#   sh scripts/torch_parent_vs_change.sh <dir> <out-dir> [extra profile arguments]
#
# Both trees are profiled by this tree's scripts/torch_main_path_profile.py
# (copied into <dir>, so that both count the same things; it reads each
# tree's configurations from that tree's chip_smoke.py, which must define
# MAIN_CFG, HD_CFG, KNN_GOOD_CFG, vo_config and write_corridor), two warm runs
# each; then the kernels phase of each tree's own chip_smoke.py. Writes
# profile_{parent,change}_{a,b}.json and smoke_{parent,change}.txt to
# <out-dir>. Needs a CUDA device and nvcc.
set -u
parent=$1
out=$(mkdir -p "$2" && cd "$2" && pwd)
shift 2
here=$(cd "$(dirname "$0")/.." && pwd)
cp "$here/scripts/torch_main_path_profile.py" "$parent/scripts/torch_main_path_profile.py"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run_profile() {  # tree, name, extra arguments
    tree=$1
    name=$2
    shift 2
    (cd "$tree" && python3 scripts/torch_main_path_profile.py --repeat 2 "$@" \
        --out "$out/profile_$name.json" > /dev/null) || echo "profile_$name FAILED"
}
run_profile "$parent" parent_a "$@"
run_profile "$here" change_a "$@"
run_profile "$here" change_b "$@"
run_profile "$parent" parent_b "$@"
(cd "$parent" && python3 chip_smoke.py --skip-main > "$out/smoke_parent.txt" 2>&1) || echo "smoke_parent FAILED"
(cd "$here" && python3 chip_smoke.py --skip-main > "$out/smoke_change.txt" 2>&1) || echo "smoke_change FAILED"
