#!/usr/bin/env bash
# Run every cell of BENCHMARK.json once, one process a cell, and print each
# cell's last line (the port's twin of scripts/run_bench_sweep.sh).
#
#   bash benchmark/sweep.sh [SEED] [SECONDS] [TRACE]
#
# From the root of a checkout on a machine with the card(s). SEED defaults
# to 1, SECONDS to BENCHMARK.json's run_seconds, TRACE to 0.
set -uo pipefail
cd "$(dirname "$0")/.."
seed="${1:-1}"
seconds="${2:-$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')}"
trace="${3:-0}"
status=0
for cell in $(python3 -c 'import json; print(" ".join(w["name"] for w in json.load(open("BENCHMARK.json"))["workloads"]))'); do
  line="$(python3 benchmark/run.py --workload "$cell" --seed "$seed" --seconds "$seconds" --trace "$trace" | tail -n 1)"
  rc=$?
  [ "$rc" -eq 0 ] || status=1
  echo "$cell rc=$rc $line"
done
exit "$status"
