#!/bin/bash
# Parent against change on the batched encoder (scripts/ab_encoder.py: each
# tree's ENC-512 phase and its analysis program eager and as a CUDA graph),
# one process per turn, in the order parent, change, change, parent, so
# that both sides see the same card.  Needs one CUDA GPU.
#
#   git archive <parent> | tar -x -C build/parent
#   bash scripts/ab_encoder.sh build/parent
set -o pipefail
parent=${1:?usage: scripts/ab_encoder.sh PARENT_TREE}
here=$(cd "$(dirname "$0")/.." && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for d in "$parent" "$here" "$here" "$parent"; do
  python3 "$here/scripts/ab_encoder.py" --tree "$d" 2>&1 \
    | grep -E "^\[|Error|error|FAIL" || rc=1
done
exit $rc
