"""Run one cell of the benchmark and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Loads, warms up every shape the cell uses
(set-up, reported as ``setup_s``), measures for ``--seconds``, checks what
the timed path produced against the plain reference under
``perfbench/reference/`` and prints one JSON object.  ``--trace 1`` runs
the profiler over the window and reports the cell's per-layer metrics;
``--trace 0`` its end-to-end metrics.  Exits non-zero, with no result,
without a CUDA device, when the program is not in the checkout, or when the
process holds ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
after the window.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()   # set-up is counted from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# Few host threads, set before numpy and torch load: the load comes from one
# process, and its numbers should not depend on how many cores it finds.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import harness  # noqa: E402


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", root: Path = ROOT, config_overrides=None,
            control: bool = False, t0: float = None):
    """One run of ``workload``; returns (result dict, Run).  ``device`` and
    ``config_overrides`` are for the CPU tests, which drive a run at a
    small size with the look for a card skipped; ``control`` runs the
    cell's control (``perfbench/control.py``) in the program's place."""
    bench = harness.load_bench(root)
    resolved = harness.resolve_cell(bench, workload, root)
    if config_overrides:
        resolved["config"] = config_overrides(resolved["config"])
    run = harness.Run(workload, resolved, seed, seconds, trace, device, t0)
    run.control = control
    harness.entry_module(resolved["traffic"], root).run(run)
    metrics = resolved["per_layer"] if trace else resolved["end_to_end"]
    result = {
        "correct": run.correct,
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": harness.read_metrics(run, metrics, root),
    }
    if device == "cuda":
        result["device"] = harness.device_info(run)
    if trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in run.checks}
    return result, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_dirs(ROOT)
    bench = harness.load_bench(ROOT)
    chips = harness.resolve_cell(bench, args.workload, ROOT)["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, run = execute(args.workload, args.seed, args.seconds,
                          bool(args.trace), t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the measured process holds {bad}", file=sys.stderr)
        return 4
    print(f"perfbench: correct={run.correct}", file=sys.stderr)
    for line in harness.checks_text(run):
        print(f"perfbench check: {line}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
