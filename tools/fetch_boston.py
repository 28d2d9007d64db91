#!/usr/bin/env python
"""Fetch MASS::Boston (506×14) for the banded CV regression tests.

``tests/test_boston.py`` validates this build against the reference's
published 5-fold CV quality bands (``examples/bigKRLS_boston_kcv.md``),
but the dataset ships with R's MASS package, which is not in this image,
and the build environment has no network egress — so the test gates on a
user-supplied CSV.  On a machine WITH egress, this script makes the test
one command away:

    python tools/fetch_boston.py          # writes tests/data/boston.csv
    python -m pytest tests/test_boston.py -q

Column order written: crim, zn, indus, chas, nox, rm, age, dis, rad, tax,
ptratio, black, lstat, medv — i.e. MASS::Boston's own order, 14 columns,
header row included (the test accepts either).

Source: the original CMU StatLib "boston" file (Harrison & Rubinfeld
1978), the same data MASS::Boston is built from.
"""
import os
import sys
import urllib.request

URL = "http://lib.stat.cmu.edu/datasets/boston"
COLS = ["crim", "zn", "indus", "chas", "nox", "rm", "age", "dis", "rad",
        "tax", "ptratio", "black", "lstat", "medv"]
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data", "boston.csv")


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    try:
        raw = urllib.request.urlopen(URL, timeout=60).read().decode()
    except Exception as e:
        print(f"could not fetch {URL}: {e}\n"
              "(this environment may have no egress; run this on a machine "
              "that does, or export the data frame from R with\n"
              "  write.csv(MASS::Boston, 'boston.csv', row.names=FALSE))",
              file=sys.stderr)
        return 1
    # StatLib layout: 22 header lines, then each observation wrapped over
    # two physical lines with whitespace separation.
    values = raw.split("\n", 22)[22].split()
    rows = [values[i:i + 14] for i in range(0, len(values), 14)]
    rows = [r for r in rows if len(r) == 14]
    if len(rows) != 506:
        print(f"unexpected row count {len(rows)} (want 506); source layout "
              "may have changed — use the R export route instead",
              file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        fh.write(",".join(COLS) + "\n")
        for r in rows:
            fh.write(",".join(r) + "\n")
    print(f"wrote {out} (506x14)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
