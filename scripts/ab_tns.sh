#!/bin/bash
# Parent against change on the port's TNS route (scripts/ab_tns.py: the TNS
# wrapper at 256, 4096 and 16384 rows, the serving mix from compact spectra
# and packed planes, and the stages of one LC-512-tns chunk), one process
# per turn, in the order parent, change, change, parent, so that both sides
# see the same card.  Needs one CUDA GPU.
#
#   git archive <parent> | tar -x -C build/parent
#   bash scripts/ab_tns.sh build/parent
set -o pipefail
parent=${1:?usage: scripts/ab_tns.sh PARENT_TREE}
here=$(cd "$(dirname "$0")/.." && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for d in "$parent" "$here" "$here" "$parent"; do
  python3 "$here/scripts/ab_tns.py" --tree "$d" 2>&1 \
    | grep -E "^\[|Error|error|FAIL|not available" || rc=1
done
exit $rc
