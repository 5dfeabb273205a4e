#!/usr/bin/env bash
# Single CI entry point (round-3 VERDICT next #9 / weak #7+#8).
#
# Tiers:
#   quick  — `pytest -m quick`: the <5-minute smoke set (default tier for
#            iterating; every test not marked deep/slow).
#   deep   — `pytest -m "deep or slow"`: the heavy dist/sampler/model
#            tests (~20+ min of 2-CPU wall).
#   multihost — the jax.distributed bootstrap scripts (2- and 4-process) and the
#            supervised coordinator-kill recovery run, which no pytest
#            marker previously invoked (they rot silently otherwise).
#
# Usage:
#   tests/run_ci.sh quick          # smoke only
#   tests/run_ci.sh deep           # heavy tier only
#   tests/run_ci.sh multihost      # multi-process scripts only
#   tests/run_ci.sh all            # everything (default)
set -u
cd "$(dirname "$0")/.."

tier="${1:-all}"
rc=0

run() {
  echo "==> $*"
  "$@" || rc=1
}

if [ "$tier" = quick ] || [ "$tier" = all ]; then
  run timeout 900 python -m pytest tests/ -m quick -q
fi

if [ "$tier" = deep ] || [ "$tier" = all ]; then
  run timeout 3600 python -m pytest tests/ -m "deep or slow" -q
fi

if [ "$tier" = multihost ] || [ "$tier" = all ]; then
  # 2- and 4-process runs + supervised coordinator-SIGKILL recovery
  run timeout 600 python tests/multihost/run_multihost.py 2
  run timeout 600 python tests/multihost/run_multihost.py 4
  run timeout 900 python tests/multihost/run_supervised_multihost.py
fi

exit $rc
