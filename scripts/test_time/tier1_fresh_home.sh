#!/bin/bash
# The tier-1 command (ROADMAP.md) on the checkout at $1 from a fresh HOME
# and TMPDIR, its junit file and log at $2.xml / $2.log, the wall seconds
# on the log's last line.  Run parent and change back to back, in turns
# (parent, change, change, parent), on an otherwise idle host:
#   bash scripts/test_time/tier1_fresh_home.sh /path/to/parent out/P1
tree=$(cd "$1" && pwd); out=$(mkdir -p "$(dirname "$2")" && cd "$(dirname "$2")" && pwd)/$(basename "$2")
home=$(mktemp -d); tmp=$(mktemp -d)
cd "$tree" || exit 2
start=$(date +%s.%N)
HOME=$home TMPDIR=$tmp timeout -k 10 2400 env JAX_PLATFORMS=cpu \
    ALLOW_MULTIPLE_LIBTPU_LOAD=1 python -m pytest tests/ -q -m 'not slow' \
    --continue-on-collection-errors -p no:cacheprovider -p xdist -n 6 \
    --dist loadfile --junitxml="$out.xml" -p no:randomly > "$out.log" 2>&1
rc=$?
echo "RC=$rc WALL=$(python3 -c "import time; print(time.time() - $start)")" >> "$out.log"
rm -rf "$home" "$tmp"
exit $rc
