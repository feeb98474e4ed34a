#!/bin/bash
# Whole chip_smoke.py runs of several checkouts on one host, one after
# another in the order given (to compare a parent and a change, give both
# twice: parent, change, change, parent):
#
#     bash chip_compare.sh parent=runs/cmp/parent change=. change2=. parent2=runs/cmp/parent
#
# Each run's output goes to chiprun_out/compare_LABEL.txt; then each run's
# exit code, the sum of its phases' seconds and its last line are printed.
# A directory that holds chip_smoke.py alone checks that the script fails
# outside a checkout.
set -u
mkdir -p chiprun_out
out=$(cd chiprun_out && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for arg in "$@"; do
  label=${arg%%=*}; dir=${arg#*=}
  (cd "$dir" && timeout 1250 python3 chip_smoke.py > "$out/compare_$label.txt" 2>&1
   echo "$label exit $?")
done
for arg in "$@"; do
  label=${arg%%=*}
  echo "== $label phases $(grep -h '] ok in' "$out/compare_$label.txt" | awk '{s+=$4} END {print s}') s"
  tail -1 "$out/compare_$label.txt" | cut -c1-300
done
