#!/usr/bin/env bash
# Crash-isolated test suite runner.
#
# jaxlib 0.9.0's CPU backend has a rare native crash in compile-adjacent code
# (observed across r2/r3 full-suite runs: SIGSEGV/abort inside
# LoadedExecutable.serialize() twice and backend_compile_and_load once, each
# in a different test file, never reproducible in isolation). One in-process
# crash kills a monolithic `pytest tests/` run; this runner executes each test
# file in its OWN pytest process and retries a crashed/failed file once, so a
# single native flake costs one file's re-run instead of the suite.
#
# Usage: scripts/run_suite.sh [extra pytest args...]
#   CONT2_CACHE_WRITE=1 scripts/run_suite.sh   # also warm the compile cache
#                                              # (crash risk contained per file)
#
# Wall time is COMPILE-CACHE-BOUND: a warm cache (utils/compile_cache.py;
# tests/conftest.py keeps a per-machine subdirectory) makes reruns fast; the
# cold cost IS the distinct-graph compile set, and the persistent cache's
# CPU AOT entries do not port across machine types.
set -u
cd "$(dirname "$0")/.."

rc_all=0
failed=()
for f in tests/test_*.py; do
    echo "=== $f"
    python -m pytest "$f" -q "$@"
    rc=$?
    if [ $rc -ne 0 ]; then
        echo "=== $f rc=$rc — retrying once"
        python -m pytest "$f" -q "$@"
        rc=$?
    fi
    if [ $rc -ne 0 ]; then
        rc_all=1
        failed+=("$f")
    fi
done

echo
if [ $rc_all -eq 0 ]; then
    echo "SUITE OK (every file green, crash-isolated)"
else
    echo "SUITE FAILED: ${failed[*]}"
fi
exit $rc_all
