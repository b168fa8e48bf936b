#!/bin/bash
# Parent against change on the port's serving slice (chip_smoke.py phase 3:
# 512 LC streams through BatchDecoder.decode_pipelined, five runs), in one
# process per turn, in the order parent, change, change, parent, so that
# both sides see the same machine.  Needs one CUDA GPU.
#
#   git archive <parent> | tar -x -C build/parent
#   bash scripts/ab_slice.sh build/parent
#
# Each line of phase 3's output is printed with the tree it came from.
set -o pipefail
parent=${1:?usage: scripts/ab_slice.sh PARENT_TREE}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for d in "$parent" . . "$parent"; do
  (cd "$d" && python3 -c "import sys; sys.path.insert(0, '.'); import torch, chip_smoke as CS; CS.phase_slice(torch)" 2>&1 \
     | grep -E "slice:|Error|FAIL" | sed "s|^|[$d] |") || rc=1
done
exit $rc
