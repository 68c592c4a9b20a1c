#!/bin/sh
# The port's accuracy sweeps on the card, as PERF.md records them: the
# strict-parity configuration on the corridor at 600 frames, RANSAC seeds
# 0-7, then both configurations (parity, tuned) on each scene family
# (corridor, photo, stopgo) at 118 frames, seeds 0-3. Error files and summaries go
# under OUT (default artifacts/torch): OUT/parity for the first,
# OUT/families/<config>/<family> for the others. Run from the repo root:
#
#     sh scripts/torch_accuracy_sweeps.sh [OUT]
#
# It goes on after a failed cell and exits non-zero if any failed.
OUT=${1:-artifacts/torch}
rc=0
PARITY_CONFIG=parity PARITY_SEEDS=0,1,2,3,4,5,6,7 PARITY_OUT="$OUT/parity" \
    python3 -m pmv_tpu_torch.parity_sweep || rc=1
for config in parity tuned; do
    for family in corridor photo stopgo; do
        PARITY_CONFIG=$config PARITY_FAMILY=$family PARITY_FRAMES=118 \
            PARITY_OUT="$OUT/families/$config/$family" python3 -m pmv_tpu_torch.parity_sweep || rc=1
    done
done
exit $rc
