#!/usr/bin/env bash
# chip_smoke.py phases of two checkouts in turns on one card: parent,
# change, change, parent, so that both see the same card and its drift.
#
# Usage (from the root of the change's checkout, on a machine with a card):
#   bash norma_tpu_torch/tools/chip_smoke_ab.sh PARENT_DIR PHASES
# PARENT_DIR holds the parent commit (e.g. `git archive <commit> | tar -x
# -C build/ab/parent`); PHASES is chip_smoke.py's --phases list (e.g.
# serving).  Each run's output goes to build/ab_runs/<n>_<who>.out; the
# lines the PERF.md comparisons read are echoed.
set -u
parent="$1"
phases="$2"
cd "$(dirname "$0")/../.."
out=build/ab_runs
mkdir -p "$out"
i=0
for who in parent change change parent; do
    i=$((i + 1))
    if [ "$who" = parent ]; then dir="$parent"; else dir=.; fi
    echo "=== run $i: $who ($dir)"
    (cd "$dir" && timeout 900 python3 chip_smoke.py --phases "$phases") > "$out/${i}_${who}.out" 2>&1
    echo "exit $?"
    grep -E "phase 9 serving|B=8 rounds|idle share|graph vs per-step|warm B=|window graphs" \
        "$out/${i}_${who}.out" | cut -c1-600
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
