#!/usr/bin/env bash
# chip_smoke's serving phases (5: in-process churn, 6: the daemon stack) for
# two trees in turns on one card: A, B, B, A.  Each tree is a checkout with
# its own chip_smoke.py and port package (for the parent commit, unpack
# `git archive <commit>` into a directory that .gitignore lists).
#
#     scripts/serving_ab.sh A_DIR B_DIR
set -e
run() {  # $1 = tree root, $2 = label
  (cd "$1" && python3 -c "
import sys
sys.path.insert(0, '.')
import chip_smoke
from kubernetes_tpu_torch.ops import fused_scan
fused_scan.load()
print('== $2 ==', flush=True)
chip_smoke.churn_phase()
chip_smoke.daemon_phase()
" 2>&1 | grep -E "^== |phase (5a churn|5b|6a daemons|6b)" | cut -c1-330)
}
run "$1" A
run "$2" B
run "$2" B
run "$1" A
