#!/bin/sh
# python3 -m pmv_tpu_torch.bench at the defaults in a parent tree and in this
# one, in the order parent, change, change, parent, with each record's
# bootstrap and PnP frame counts added (the child of the benchmark is run in
# process, so that its record can be extended the same way in both trees).
# The parent is a commit unpacked by `git archive` into a git-ignored
# directory. Run from the repo root, on the card:
#
#     sh scripts/torch_bench_pair.sh <parent-tree> [OUT]
#
# OUT (default _scratch/bench_pair, which git ignores) gets <tag>.jsonl, one record a line.
PARENT=$1
OUT=${2:-_scratch/bench_pair}
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
CODE='
import pmv_tpu_torch.bench as b
record = b.record
def counted(fps, result, pipe, *rest):
    r = record(fps, result, pipe, *rest)
    r["detail"]["bootstrap_frames"] = sum(1 for s in pipe.frame_stats if not s["used_pnp"])
    r["detail"]["pnp_frames"] = sum(1 for s in pipe.frame_stats if s["used_pnp"])
    return r
b.record = counted
b.main()
'
rc=0
for tag in parent change change2 parent2; do
    case $tag in parent*) dir=$PARENT ;; *) dir=. ;; esac
    (cd "$dir" && python3 -c "$CODE") > "$OUT/$tag.jsonl" || rc=1
done
exit $rc
