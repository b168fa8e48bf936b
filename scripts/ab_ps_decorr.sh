#!/bin/bash
# Parent against change on the port's PS decorrelation
# (scripts/ab_ps_decorr.py: ps_batch._decorrelate at C = 1024, T = 8 in
# both band modes, and one sbr_ps_apply at PS-512's chunk shape), one
# process per turn, in the order parent, change, change, parent, so that
# both sides see the same card.  Needs one CUDA GPU.
#
#   git archive <parent> | tar -x -C build/parent
#   bash scripts/ab_ps_decorr.sh build/parent
set -o pipefail
parent=${1:?usage: scripts/ab_ps_decorr.sh PARENT_TREE}
here=$(cd "$(dirname "$0")/.." && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for d in "$parent" "$here" "$here" "$parent"; do
  python3 "$here/scripts/ab_ps_decorr.py" --tree "$d" 2>&1 \
    | grep -E "^\[|Error|error|FAIL|not available" || rc=1
done
exit $rc
