"""Summarize ``compile_log.py``'s lines: per test file its wall, CPU and
``Atom.rho`` seconds, compiles (misses) and persistent-cache reads (hits)
with their seconds, and the totals, the programs over one second apart.

    python scripts/test_time/compile_log_sum.py /tmp/cl [file.py ...]
"""
import collections
import glob
import json
import sys


def main(prefix, files=()):
    per = collections.defaultdict(collections.Counter)
    names = collections.defaultdict(collections.Counter)
    for path in glob.glob(f"{prefix}_*.jsonl"):
        for line in open(path):
            r = json.loads(line)
            f = r["test"].split("::")[0].split("/")[-1]
            p = per[f]
            p["wall"] += r["wall"]
            p["cpu"] += r["cpu"]
            p["rho"] += r.get("rho", 0.0)
            for name, s, hit in r["events"]:
                k = "hit" if hit else "miss"
                p[k] += s
                p["n_" + k] += 1
                if not hit and s > 1:
                    p["big"] += s
                    p["n_big"] += 1
                if not hit:
                    names[f][name] += s
    print(f"{'file':34} {'wall':>7} {'cpu':>7} {'rho':>6} {'compile':>8} "
          f"{'n':>5} {'>1s':>7} {'n':>4} {'hits':>6} {'n':>5}")
    tot = collections.Counter()
    for f, p in sorted(per.items(), key=lambda x: -x[1]["wall"]):
        tot.update(p)
        print(f"{f:34} {p['wall']:7.1f} {p['cpu']:7.1f} {p['rho']:6.1f} "
              f"{p['miss']:8.1f} {p['n_miss']:5d} {p['big']:7.1f} "
              f"{p['n_big']:4d} {p['hit']:6.1f} {p['n_hit']:5d}")
    print("total", {k: round(v, 1) for k, v in sorted(tot.items())})
    for f in files:
        print(f, names[f].most_common(10))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
