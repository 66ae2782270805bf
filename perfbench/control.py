"""Run a cell's control in the program's place, on several seeds in one
process, and print what each run compared.

    python3 perfbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

The control has to come out as not correct.  For the KV cells it is the
program with one guarantee broken (an update acknowledged in 1 RTT though
its witnesses rejected the record: ``entries/kv.py`` ``_control``); for the
serving cell it is the reference computed in float8 e4m3, whose first
token at each served position is judged by the float32 reference
(``entries/serve.py`` ``check_gaps``).  The serving control's run reads the
program's own gap beside it.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench_run.harness.set_cache_dirs(bench_run.ROOT)
    for seed in args.seeds:
        result, run = bench_run.execute(args.workload, seed, args.seconds,
                                        False, control=True)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "compared": result["compared"],
                          "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
