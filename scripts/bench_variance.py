#!/usr/bin/env python
"""Benchmark variance: N fresh-process bench.py runs.

Runs ``python bench.py`` N times in fresh processes, one after another
(one JAX process on the card at a time; this parent never imports JAX),
so the spread of the headline metric can be told from a regression.  The
persistent compile cache keeps compiles warm, so each run measures steady
state.  Writes every raw line to ``--out`` and prints median / min / max
for the headline metric.

  python scripts/bench_variance.py --runs 5
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/bench_variance.jsonl")
    args = ap.parse_args()

    vals = []
    rows = []
    for i in range(args.runs):
        t0 = time.time()
        proc = subprocess.run([sys.executable, "bench.py"],
                              capture_output=True, text=True, timeout=1800)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")][-1]
        rec = json.loads(line)
        rec["run"] = i
        rec["walltime_s"] = time.time() - t0
        rows.append(rec)
        vals.append(rec["value"])
        print(json.dumps(rec), flush=True)

    vals.sort()
    n = len(vals)
    median = (vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2]))
    summary = {
        "summary": True,
        "runs": n,
        "metric": rows[0]["metric"],
        "median": median,
        "min": vals[0],
        "max": vals[-1],
        "spread_pct": 100.0 * (vals[-1] - vals[0]) / median,
    }
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for r in rows + [summary]:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
