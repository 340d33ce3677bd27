"""Summed case time of a pytest junit file, split into the port's test
files (``test_torch_*``) and the rest, with the heaviest files and cases;
given two files, each port file's change.

    python scripts/test_time/junit_sum.py parent.xml [change.xml]
"""
import collections
import sys
import xml.etree.ElementTree as ET


def load(path):
    per, cases = collections.Counter(), {}
    for tc in ET.parse(path).getroot().iter("testcase"):
        parts = tc.get("classname", "").split(".")
        f = parts[1] if parts[0] == "tests" and len(parts) > 1 else parts[0]
        s = float(tc.get("time", 0))
        per[f] += s
        cases[f"{tc.get('classname')}::{tc.get('name')}"] = s
    return per, cases


def split(per):
    port = sum(v for k, v in per.items() if k.startswith("test_torch_"))
    return port, sum(per.values()) - port


def main(paths):
    runs = [load(p) for p in paths]
    for p, (per, cases) in zip(paths, runs):
        port, rest = split(per)
        print(f"{p}: summed {port + rest:.1f} s, port {port:.1f}, rest "
              f"{rest:.1f}, {len(cases)} cases")
    if len(runs) == 2:
        a, b = runs[0][0], runs[1][0]
        moved = sorted((b[k] - a[k], k) for k in set(a) | set(b)
                       if k.startswith("test_torch_"))
        print("port files that moved most:")
        for d, k in moved[:5] + moved[-5:]:
            print(f"  {k:34} {a[k]:7.1f} -> {b[k]:7.1f} ({d:+.1f})")
    else:
        per, cases = runs[0]
        for k, v in per.most_common(15):
            print(f"  {v:8.1f} {k}")


if __name__ == "__main__":
    main(sys.argv[1:])
