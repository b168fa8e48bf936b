#!/bin/bash
# Parent against change on the port's hand-written kernels
# (scripts/ab_kernels.py: each tree's chip_smoke.phase_kernels), one
# process per turn, in the order parent, change, change, parent, so that
# both sides see the same card.  Needs one CUDA GPU.
#
#   git archive <parent> | tar -x -C build/parent
#   bash scripts/ab_kernels.sh build/parent
set -o pipefail
parent=${1:?usage: scripts/ab_kernels.sh PARENT_TREE}
here=$(cd "$(dirname "$0")/.." && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for d in "$parent" "$here" "$here" "$parent"; do
  python3 "$here/scripts/ab_kernels.py" --tree "$d" 2>&1 \
    | grep -E "^\[|Error|error|FAIL|not available" || rc=1
done
exit $rc
