#!/bin/bash
# Where a PS-512 chunk's time goes on a 4x1 mesh of virtual shards of one
# CUDA GPU, unsharded beside it (scripts/trace_ps_mesh.py), for the parent
# tree and this one in one call, so that both see the same card.
#
#   git archive <parent> | tar -x -C build/parent
#   bash scripts/trace_ps_mesh.sh build/parent
set -o pipefail
parent=${1:?usage: scripts/trace_ps_mesh.sh PARENT_TREE}
here=$(cd "$(dirname "$0")/.." && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for d in "$parent" "$here"; do
  python3 "$here/scripts/trace_ps_mesh.py" --tree "$d" 2>&1 \
    | grep -E "^\[|Error|error|FAIL" || rc=1
done
exit $rc
