#!/bin/bash
# Parent against change on the port's serving cells (chip_smoke.py's
# serving phases; by default phase 3, the LC-512 slice: 512 LC streams
# through BatchDecoder.decode_pipelined, five runs), in one process per
# turn, in the order parent, change, change, parent, so that both sides see
# the same machine.  Needs one CUDA GPU.
#
#   git archive <parent> | tar -x -C build/parent
#   bash scripts/ab_slice.sh build/parent [PHASE ...]
#
# PHASE names chip_smoke functions that take (torch), for example
# phase_slice phase_he_serving phase_ps_serving.  Each line of their
# output that gives a realtime_x or a stage split is printed with the tree
# it came from.
set -o pipefail
parent=${1:?usage: scripts/ab_slice.sh PARENT_TREE [PHASE ...]}
shift
phases=${*:-phase_slice}
calls=$(printf 'CS.%s(torch); ' $phases)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for d in "$parent" . . "$parent"; do
  (cd "$d" && python3 -c "import sys; sys.path.insert(0, '.'); import torch, chip_smoke as CS; $calls" 2>&1 \
     | grep -E "realtime_x|wall per chunk|Error|FAIL" | sed "s|^|[$d] |") || rc=1
done
exit $rc
