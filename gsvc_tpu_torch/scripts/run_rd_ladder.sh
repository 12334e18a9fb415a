#!/usr/bin/env bash
# The RD ladder on the card: 4 rate points (10k/20k/30k/50k splats), 10
# frames, 20k represent iters + 6k compress iters, on the synthetic 1080p
# clip, each point decode-verified from its bitstream
# (gsvc_tpu_torch/scripts/run_rd_point.py). Each point is its own process,
# run one after another in one workdir (the clip and K_frames.txt are made
# by the first and read by the rest).
#
#   bash gsvc_tpu_torch/scripts/run_rd_ladder.sh [WORKDIR [NUM_POINTS ...]]
#
# WORKDIR defaults to rd_run; NUM_POINTS to the four points, so
# `run_rd_ladder.sh rd_run 50000` runs one point alone. Exits 1 if any
# point failed, after running the rest.
set -uo pipefail
cd "$(dirname "$0")/../.."
WD="${1:-rd_run}"
shift $(( $# > 0 ? 1 : 0 ))
POINTS=("$@")
[ ${#POINTS[@]} -eq 0 ] && POINTS=(10000 20000 30000 50000)
failed=0
for np in "${POINTS[@]}"; do
    echo "=== RD point num_points=$np $(date) ==="
    python -m gsvc_tpu_torch.scripts.run_rd_point \
        --frames 10 --num-points "$np" \
        --iterations 20000 --comp-iterations 6000 \
        --workdir "$WD"
    rc=$?
    echo "=== point $np done rc=$rc $(date) ==="
    [ $rc -eq 0 ] || failed=1
done
exit $failed
