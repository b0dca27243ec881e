#!/bin/sh
# Runs chip_smoke.py's phases from two checkouts in turns on one card (A, B,
# B, A), so that their numbers can be compared within one machine.
#
# usage: tools/chip_ab.sh A_DIR B_DIR OUT_DIR PHASES
#   OUT_DIR gets abN_a / abN_b, each with its chip_smoke.json; PHASES is
#   chip_smoke.py's --only list, e.g. segment_build,q7c,q5,kernels
set -eu
a=$(cd "$1" && pwd)
b=$(cd "$2" && pwd)
mkdir -p "$3"
out=$(cd "$3" && pwd)
i=0
for side in a b b a; do
  i=$((i + 1))
  if [ "$side" = a ]; then dir=$a; else dir=$b; fi
  (cd "$dir" && python3 chip_smoke.py --out-dir "$out/ab${i}_$side" --only "$4" \
     > "$out/ab${i}_$side.out" 2> "$out/ab${i}_$side.err")
  echo "ab${i}_$side: exit 0"
done
