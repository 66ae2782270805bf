"""Flight recorder: metrics registry, wall-clock spans and simulated-time
tracing for the CURP stack.

Three facilities, each cheap enough to stay on by default:

* ``MetricsRegistry`` — named ``Counter``/``Gauge``/``Histogram`` instruments.
  Histograms are log-bucketed (HDR-style: 2^SUB sub-buckets per power-of-two
  octave, so relative quantile error is bounded at ~1/2^SUB) and record in
  O(1) with no allocation on the hot path.  Every layer of the stack
  (witness, master, RIFL, admission control, migration, 2PC, kernels, sim)
  increments instruments obtained from the process-global registry
  (``get_registry()``); ``snapshot()`` turns the whole registry into a
  JSON-able dict for BENCH merging.  A ``DeviceCounter`` keeps its count
  in a device tensor that a captured CUDA graph adds to at each replay
  (the decode step's MoE routing counts); it reaches the host only when
  read.

* ``span(name)`` — the port's wall-clock spans.  Each layer boundary of the
  store's hot path, recovery and the serving step opens one; while a
  ``torch.profiler`` is running it is a ``record_function``, so the span
  lands in the profiler's trace on the same clock as the device's work,
  and otherwise it is one shared null context (one check, no allocation).
  There is no switch: the spans record exactly when a profiler runs.

* ``Tracer`` — causal RPC spans keyed by RIFL id ``(client_id, seq)``, in
  the discrete-event sim's simulated time.  The client's issue..complete
  window is the root span; witness records, master speculative execution,
  batched syncs, and gc rounds attach as children (or as instant detour
  events: sheds, NOT_OWNER redirects, timeouts).  Spans carry the explicit
  µs timestamps the sim supplies (``sim.now``), and ``export_chrome()``
  writes Chrome-trace/Perfetto JSON so a 1-RTT vs 2-RTT write is visually
  attributable.

Sampling: ``Tracer(sample=0.01)`` keeps 1% of traces, chosen by a
deterministic hash of the trace id (NOT Python's randomized ``hash``), so
every actor in a distributed flow makes the same keep/drop decision with no
coordination.  Spans outside the per-RPC id space (sync batches, gc rounds)
pass ``force=True`` and are always kept.

Overhead discipline: instruments are plain attribute bumps; tracing does one
dict insert per span.  ``disable()`` swaps ``get_registry()`` to a null
registry whose instruments are no-ops — used by benchmarks/fig_obs.py to
measure the (near-zero) registry cost on the device fast path.
"""
from __future__ import annotations

import contextlib
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

__all__ = [
    "Counter", "DeviceCounter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Tracer", "get_registry", "registry", "reset_registry", "enable", "disable",
    "enabled", "span",
]


# --------------------------------------------------------------------------
# Instruments
# --------------------------------------------------------------------------
class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class DeviceCounter:
    """A count kept on the device it is counted on: ``add`` is one device
    add into an int64 tensor (graph-safe: the tensor never moves, and
    ``reset`` zeroes it in place); ``value`` copies it to the host, the
    only sync, summed over the devices that added to it."""

    __slots__ = ("name", "_by_device")

    def __init__(self, name: str) -> None:
        self.name = name
        self._by_device: Dict[torch.device, torch.Tensor] = {}

    def add(self, n: torch.Tensor) -> None:
        t = self._by_device.get(n.device)
        if t is None:
            t = self._by_device[n.device] = torch.zeros(
                (), dtype=torch.int64, device=n.device)
        t.add_(n)

    @property
    def value(self) -> int:
        return sum(int(t.item()) for t in self._by_device.values())

    def reset(self) -> None:
        for t in self._by_device.values():
            t.zero_()

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "device_counter", "value": self.value}


class Gauge:
    """Last-set value plus its high watermark (queue depths, occupancy)."""

    __slots__ = ("name", "value", "max")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0
        self.max = 0.0

    def set(self, v: float) -> None:
        self.value = v
        if v > self.max:
            self.max = v

    def reset(self) -> None:
        self.value = 0.0
        self.max = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value, "max": self.max}


# Sub-bucket resolution: 2^_SUB buckets per octave -> relative quantile
# error bounded by 2^(1/2^_SUB) - 1 ~= 2.2% at _SUB = 5.
_SUB = 5
_SUB_N = 1 << _SUB


class Histogram:
    """Log-bucketed HDR-style histogram for non-negative values.

    Bucket index for v >= 1 is ``octave * 2^SUB + sub`` where octave =
    floor(log2 v) and sub refines the octave linearly; values in [0, 1) and
    exact zeros share bucket 0.  ``record`` is O(1); ``percentile`` walks
    the sparse bucket dict (len <= 64*2^SUB in practice).
    """

    __slots__ = ("name", "count", "sum", "min", "max", "_buckets")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0
        self._buckets: Dict[int, int] = {}

    @staticmethod
    def _index(v: float) -> int:
        if v < 1.0:
            return 0
        m, e = math.frexp(v)            # v = m * 2^e, m in [0.5, 1)
        octave = e - 1                  # floor(log2 v)
        sub = int((m * 2.0 - 1.0) * _SUB_N)  # linear refine within octave
        if sub >= _SUB_N:
            sub = _SUB_N - 1
        return octave * _SUB_N + sub + 1

    @staticmethod
    def _upper_edge(idx: int) -> float:
        if idx == 0:
            return 1.0
        idx -= 1
        octave, sub = divmod(idx, _SUB_N)
        return (2.0 ** octave) * (1.0 + (sub + 1) / _SUB_N)

    def record(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        idx = self._index(v)
        b = self._buckets
        b[idx] = b.get(idx, 0) + 1

    def percentile(self, q: float) -> float:
        """Nearest-rank quantile estimate (bucket upper edge), q in [0, 1]."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= rank:
                return min(self._upper_edge(idx), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0
        self._buckets.clear()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": "histogram", "count": self.count, "mean": self.mean,
            "min": self.min if self.count else 0.0, "max": self.max,
            "p50": self.percentile(0.50), "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
class MetricsRegistry:
    """Name -> instrument map.  Fetch-or-create handles once (at object
    construction), then bump them on the hot path; ``reset()`` zeroes every
    instrument IN PLACE so held handles stay live across scenario runs."""

    def __init__(self) -> None:
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is {type(inst).__name__}, wanted {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def device_counter(self, name: str) -> DeviceCounter:
        return self._get(name, DeviceCounter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def reset(self) -> None:
        for inst in self._instruments.values():
            inst.reset()

    def snapshot(self, prefix: str = "") -> Dict[str, Dict[str, Any]]:
        return {
            name: inst.to_dict()
            for name, inst in sorted(self._instruments.items())
            if name.startswith(prefix)
        }


class _NullInstrument:
    """No-op stand-in handed out while telemetry is disabled."""

    __slots__ = ()
    name = "null"
    value = 0
    max = 0.0
    count = 0
    sum = 0.0
    min = 0.0
    mean = 0.0

    def inc(self, n: int = 1) -> None: ...
    def add(self, n: Any) -> None: ...
    def set(self, v: float) -> None: ...
    def record(self, v: float) -> None: ...
    def reset(self) -> None: ...
    def percentile(self, q: float) -> float:
        return 0.0
    def to_dict(self) -> Dict[str, Any]:
        return {"type": "null"}


class _NullRegistry:
    _NULL = _NullInstrument()

    def counter(self, name: str) -> Any:
        return self._NULL

    gauge = counter
    histogram = counter
    device_counter = counter

    def reset(self) -> None: ...
    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        return {}


_REGISTRY = MetricsRegistry()
_NULL_REGISTRY = _NullRegistry()
_ENABLED = True


def get_registry():
    """The process-global registry (a null registry while disabled).
    Instrumented objects fetch handles at construction time, so a
    disable()/enable() flip takes effect for objects built after it."""
    return _REGISTRY if _ENABLED else _NULL_REGISTRY


def registry() -> MetricsRegistry:
    """The real registry, regardless of the enabled flag (for readers:
    benchmarks, snapshots, the dispatch-count shims)."""
    return _REGISTRY


def reset_registry() -> None:
    _REGISTRY.reset()


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


# --------------------------------------------------------------------------
# Wall-clock spans (on the profiler's clock)
# --------------------------------------------------------------------------
_profiler_enabled = torch.autograd._profiler_enabled
_NULL_SPAN = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` around a ``with`` block: a
    ``torch.profiler.record_function`` while a profiler is running (the
    trace's host user annotations), else one shared null context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL_SPAN


# --------------------------------------------------------------------------
# Tracing (simulated time)
# --------------------------------------------------------------------------
def _mix_id(tid: Any) -> int:
    """Deterministic 64-bit mix of a trace id (Python's ``hash`` is
    per-process randomized for strings, so it cannot make the keep/drop
    sampling decision)."""
    if isinstance(tid, tuple):
        h = 0x9E3779B97F4A7C15
        for e in tid:
            h = (h * 0x100000001B3) ^ (_mix_id(e) & 0xFFFFFFFFFFFFFFFF)
            h &= 0xFFFFFFFFFFFFFFFF
    elif isinstance(tid, int):
        h = tid & 0xFFFFFFFFFFFFFFFF
    else:
        import zlib

        h = zlib.crc32(repr(tid).encode())
    # splitmix64 finalizer
    h = (h + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return h ^ (h >> 31)


class Span:
    __slots__ = ("span_id", "trace_id", "name", "actor", "start", "end",
                 "parent", "status", "args")

    def __init__(self, span_id: int, trace_id: Any, name: str, actor: str,
                 start: float, parent: Optional[int],
                 args: Optional[Dict[str, Any]]) -> None:
        self.span_id = span_id
        self.trace_id = trace_id
        self.name = name
        self.actor = actor
        self.start = start
        self.end: Optional[float] = None
        self.parent = parent
        self.status: Optional[str] = None
        self.args = args


class Tracer:
    """Causal span collector with deterministic trace-id sampling.

    ``begin``/``end`` bracket a span whose close site differs from its open
    site (the client root span); ``span`` records a complete child span in
    one call (server-side actors know their service window when the handler
    runs); ``instant`` marks detours (shed, NOT_OWNER, timeout).  Children
    parent to the root span of their trace id by default, so the Perfetto
    flow for one RIFL id reads top-down: issue -> witness record -> master
    execute -> sync -> gc.
    """

    def __init__(self, sample: float = 1.0) -> None:
        self.sample = sample
        self.spans: List[Span] = []
        self.instants: List[Dict[str, Any]] = []
        self._open: Dict[int, Span] = {}
        self._roots: Dict[Any, int] = {}
        self._next_id = 1
        self.dropped = 0   # unsampled begin/span/instant calls

    # -- sampling ----------------------------------------------------------
    def sampled(self, trace_id: Any) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return (_mix_id(trace_id) % 10_000) < self.sample * 10_000

    # -- span lifecycle ----------------------------------------------------
    def begin(self, trace_id: Any, name: str, ts: float, actor: str = "",
              parent: Optional[int] = None, args: Optional[Dict] = None,
              force: bool = False) -> Optional[int]:
        if not force and not self.sampled(trace_id):
            self.dropped += 1
            return None
        sid = self._next_id
        self._next_id += 1
        span = Span(sid, trace_id, name, actor, ts, parent, args)
        self._open[sid] = span
        self.spans.append(span)
        if trace_id not in self._roots:
            self._roots[trace_id] = sid
        return sid

    def end(self, span_id: Optional[int], ts: float,
            status: Optional[str] = None) -> None:
        if span_id is None:
            return
        span = self._open.pop(span_id, None)
        if span is None:
            return
        span.end = ts
        span.status = status

    def span(self, trace_id: Any, name: str, ts: float, dur: float,
             actor: str = "", status: Optional[str] = None,
             args: Optional[Dict] = None, force: bool = False) -> Optional[int]:
        """One-call complete span, parented to the trace's root (if any)."""
        if not force and not self.sampled(trace_id):
            self.dropped += 1
            return None
        sid = self._next_id
        self._next_id += 1
        span = Span(sid, trace_id, name, actor, ts,
                    self._roots.get(trace_id), args)
        span.end = ts + dur
        span.status = status
        self.spans.append(span)
        if trace_id not in self._roots:
            self._roots[trace_id] = sid
        return sid

    def instant(self, trace_id: Any, name: str, ts: float, actor: str = "",
                args: Optional[Dict] = None, force: bool = False) -> None:
        if not force and not self.sampled(trace_id):
            self.dropped += 1
            return
        self.instants.append({
            "trace_id": trace_id, "name": name, "ts": ts, "actor": actor,
            "args": args,
        })

    def root_id(self, trace_id: Any) -> Optional[int]:
        return self._roots.get(trace_id)

    def open_spans(self) -> List[Span]:
        return list(self._open.values())

    def drain(self, ts: float, status: str = "unfinished") -> int:
        """Close every still-open span and return how many there were.

        Two callers, one discipline: scenario teardown (ops in flight at
        the horizon never complete — they must not leak unclosed spans) and
        the watchdog's black-box dump (a breach snapshots the trace MID-run,
        so in-flight spans must be sealed at breach time for the slice to
        be well-formed).  Idempotent: a teardown after a breach dump finds
        nothing left open."""
        n = len(self._open)
        for sid in list(self._open):
            self.end(sid, ts, status)
        return n

    def close_open(self, ts: float, status: str = "unfinished") -> int:
        """Teardown-time alias of ``drain`` (kept for existing callers)."""
        return self.drain(ts, status)

    # -- derived views -----------------------------------------------------
    def by_trace(self) -> Dict[Any, List[Span]]:
        out: Dict[Any, List[Span]] = {}
        for s in self.spans:
            out.setdefault(s.trace_id, []).append(s)
        return out

    # -- export ------------------------------------------------------------
    def export_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome-trace JSON (load in Perfetto / chrome://tracing).

        Actors map to tids (named via metadata events); spans are ``ph: X``
        complete events with µs timestamps; instants are ``ph: i``.
        """
        tids: Dict[str, int] = {}

        def tid_of(actor: str) -> int:
            t = tids.get(actor)
            if t is None:
                t = tids[actor] = len(tids) + 1
            return t

        events: List[Dict[str, Any]] = []
        for s in self.spans:
            end = s.end if s.end is not None else s.start
            args = {"trace_id": repr(s.trace_id), "span_id": s.span_id}
            if s.parent is not None:
                args["parent"] = s.parent
            if s.status is not None:
                args["status"] = s.status
            if s.args:
                args.update(s.args)
            events.append({
                "name": s.name, "ph": "X", "pid": 1,
                "tid": tid_of(s.actor or "main"),
                "ts": s.start, "dur": max(end - s.start, 0.0),
                "cat": "curp", "args": args,
            })
        for ev in self.instants:
            args = {"trace_id": repr(ev["trace_id"])}
            if ev["args"]:
                args.update(ev["args"])
            events.append({
                "name": ev["name"], "ph": "i", "pid": 1,
                "tid": tid_of(ev["actor"] or "main"),
                "ts": ev["ts"], "s": "t", "cat": "curp", "args": args,
            })
        for actor, t in sorted(tids.items(), key=lambda kv: kv[1]):
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": t,
                "args": {"name": actor},
            })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def stage_attribution(tracer: Tracer,
                      tail_q: float = 0.99) -> Dict[str, Any]:
    """Where does tail latency go?  Groups closed ROOT spans by duration,
    takes the ops at/above the ``tail_q`` quantile, and attributes their
    child-span time by stage name.  Returns per-stage µs means for the tail
    cohort vs the full population (the fig_obs report body)."""
    by_trace = tracer.by_trace()
    roots: List[Tuple[float, Any]] = []
    for tid, spans in by_trace.items():
        root = spans[0]
        if root.end is None or root.status == "unfinished":
            continue
        roots.append((root.end - root.start, tid))
    if not roots:
        return {"n_ops": 0, "tail_n": 0, "p99_us": 0.0,
                "stages_all": {}, "stages_tail": {}}
    roots.sort()
    durs = [d for d, _ in roots]
    cut = durs[min(len(durs) - 1, max(0, math.ceil(tail_q * len(durs)) - 1))]
    tail = [tid for d, tid in roots if d >= cut]
    tail_set = set(tail)

    def stage_sums(which: Optional[set]) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        n = 0
        for tid, spans in by_trace.items():
            if which is not None and tid not in which:
                continue
            n += 1
            for s in spans[1:]:
                if s.end is None:
                    continue
                sums[s.name] = sums.get(s.name, 0.0) + (s.end - s.start)
        return {k: v / max(n, 1) for k, v in sorted(sums.items())}

    return {
        "n_ops": len(roots),
        "tail_n": len(tail),
        "p99_us": cut,
        "mean_us": sum(durs) / len(durs),
        "stages_all": stage_sums(None),
        "stages_tail": stage_sums(tail_set),
    }
