"""What every cell shares: finding its files by name, the run's record,
the profiler's trace, the metric readers and the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix.  The configuration's file is the one ``configs`` gives it; the
traffic mix is ``traffic/<traffic>.json``, whose ``entry`` names the driver
``entries/<entry>.py``; each metric is read by ``metrics/<metric>.py``, or,
where there is no such file, by the reader of its longest dotted prefix
(``device.idle.lone`` by ``metrics/device.idle.py``).  A later cell, mix, configuration or metric is a new file and a new entry in
``BENCHMARK.json``: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Modules the measured process may not hold once the window has closed
# (top-level names, compared whole: ``repro_torch`` is not ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# finding a cell's files
# ---------------------------------------------------------------------------
def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(items: Sequence[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def resolve_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic and metric names."""
    cell = _by_name(bench["workloads"], workload, "workload")
    conf = _by_name(bench["configs"], cell["config"], "config")
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(
        cell=cell, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def load_module(path: Path):
    """Import a file whose name may hold dots (``metrics/a.b.py``)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(traffic: dict, root: Path = ROOT):
    return load_module(root / "perfbench" / "entries" / f"{traffic['entry']}.py")


def metric_reader(name: str, root: Path = ROOT):
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    its longest dotted prefix that has a file."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "perfbench" / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return load_module(path).read
    raise FileNotFoundError(f"no reader for metric {name!r} under metrics/")


# ---------------------------------------------------------------------------
# statistics over all samples of a window
# ---------------------------------------------------------------------------
def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile of every sample (nearest rank): the smallest
    sample with at least ``q`` percent of the samples at or below it."""
    if not xs:
        return None
    s = sorted(xs)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[k - 1])


def median(xs: Sequence[float]) -> Optional[float]:
    return float(statistics.median(xs)) if xs else None


# ---------------------------------------------------------------------------
# the run's record
# ---------------------------------------------------------------------------
class Run:
    """What one run saw.  Entries fill it; metric readers read it.

    ``samples``: lists of host-clock readings (seconds) by name;
    ``counts``: numbers the program or the benchmark counted;
    ``values``: single readings (``setup_s``, ``window_s``, ...);
    ``checks``: (name, value, limit): the run is correct iff every value
    is at or under its limit;
    ``trace``: the profiler's view of the traced window (``--trace 1``).
    """

    def __init__(self, workload: str, resolved: dict, seed: int,
                 seconds: float, trace: bool, device: str = "cuda",
                 t0: Optional[float] = None) -> None:
        self.workload = workload
        self.cell = resolved["cell"]
        self.config = resolved["config"]
        self.traffic = resolved["traffic"]
        self.seed, self.seconds, self.trace_on = seed, seconds, trace
        self.device = device
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.counts: Dict[str, float] = defaultdict(float)
        self.values: Dict[str, float] = {}
        self.checks: List[Tuple[str, float, float]] = []
        self.attempted = 0
        self.failed = 0
        self.trace: Optional["TraceView"] = None
        self.memory_peak_bytes = 0
        self.control = False
        self._prof = None
        self._t_setup = time.perf_counter() if t0 is None else t0

    # -- set-up and window ---------------------------------------------------
    def setup_done(self) -> None:
        self.values["setup_s"] = time.perf_counter() - self._t_setup

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _n, v, lim
                                         in self.checks)

    def read_memory_peak(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    # -- tracing -------------------------------------------------------------
    def start_trace(self) -> None:
        """Start the profiler (``--trace 1`` only)."""
        if not self.trace_on or self._prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t_trace = time.perf_counter()

    def stop_trace(self) -> None:
        if self._prof is None:
            return
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter() - self._t_trace
        self._prof.__exit__(None, None, None)
        self.trace = TraceView(self._prof, t)
        self._prof = None

    @contextmanager
    def span(self, name: str):
        """A host span the trace can attribute idle gaps to (a
        ``record_function`` while tracing, nothing otherwise)."""
        if self._prof is None:
            yield
            return
        from torch.profiler import record_function

        with record_function(name):
            yield


class TraceView:
    """The profiler's trace of one window: device operations (kernels,
    copies, fills) and the benchmark's host spans, on one clock."""

    def __init__(self, prof, window_s: float) -> None:
        self.window_s = window_s
        self.device_ops: List[Tuple[str, int, int]] = []   # name, start, end ns
        self.host_spans: List[Tuple[str, int, int]] = []
        for e in prof.profiler.kineto_results.events():
            on_host = str(e.device_type()).endswith("CPU")
            start, dur = int(e.start_ns()), int(e.duration_ns())
            if e.is_user_annotation():
                # A span of the benchmark's (the trace mirrors each on the
                # device's timeline too; that copy is no device work).
                if on_host:
                    self.host_spans.append((e.name(), start, start + dur))
            elif not on_host and dur > 0:
                self.device_ops.append((e.name(), start, start + dur))
        self.device_ops.sort(key=lambda t: t[1])
        self.host_spans.sort(key=lambda t: t[1])

    def intervals(self) -> List[Tuple[int, int]]:
        """Device-busy intervals: the union of every device operation."""
        out: List[List[int]] = []
        for _n, a, b in self.device_ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e9

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel(self, name_part: str) -> List[float]:
        """Device seconds of each operation whose name holds ``name_part``."""
        return [(b - a) / 1e9 for n, a, b in self.device_ops
                if name_part in n]

    def kernel_within(self, name_parts: Sequence[str],
                      spans: Sequence[Tuple[int, int]]) -> float:
        """Device seconds of the operations whose name holds one of
        ``name_parts`` and that start inside one of the host spans."""
        starts = sorted(spans)
        total, j = 0, 0
        for n, a, b in self.device_ops:        # sorted by start
            while j < len(starts) and starts[j][1] < a:
                j += 1
            if j < len(starts) and starts[j][0] <= a \
                    and any(p in n for p in name_parts):
                total += b - a
        return total / 1e9

    def spans(self, name: str) -> List[Tuple[int, int]]:
        return [(a, b) for n, a, b in self.host_spans if n == name]

    def device_s_within(self, spans: Sequence[Tuple[int, int]]) -> float:
        """Device-busy seconds that fall inside the given host spans (the
        device work an operation enqueued runs before its span ends when
        the span ends in a synchronisation, as the spans here do)."""
        iv = self.intervals()
        total, j = 0, 0
        for a, b in sorted(spans):
            while j < len(iv) and iv[j][1] <= a:
                j += 1
            k = j
            while k < len(iv) and iv[k][0] < b:
                total += min(b, iv[k][1]) - max(a, iv[k][0])
                k += 1
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_op: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device_ops:
            by_op[n] += (b - a) / 1e9
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        # Idle gaps between busy intervals, each named by the innermost
        # host span open at its middle.
        gaps: Dict[str, float] = defaultdict(float)
        iv = self.intervals()
        spans = self.host_spans
        for (a0, b0), (a1, _b1) in zip(iv, iv[1:]):
            mid = (b0 + a1) // 2
            name = "outside any span"
            best = None
            for n, s, e in spans:
                if s > mid:
                    break
                if e >= mid and (best is None or s >= best):
                    name, best = n, s
            gaps[name] += (a1 - b0) / 1e9
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------
def device_info(run: Run) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def read_metrics(run: Run, metrics: Sequence[dict], root: Path = ROOT) -> dict:
    """Each metric's reader over the run; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        v = metric_reader(m["name"], root)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def checks_text(run: Run) -> List[str]:
    return [f"{n}={v!r} limit={lim!r}" for n, v, lim in run.checks]


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "build" / "perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
