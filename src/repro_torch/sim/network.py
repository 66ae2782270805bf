"""Discrete-event network + node model.

* Asynchronous network: per-message one-way delay = fixed + lognormal jitter
  + rare heavy tail; optional drops.  No ordering guarantees — messages race
  (CURP §3.1 assumes exactly this).
* Node: a single-server queue (models RAMCloud's dispatch thread, the
  bottleneck in §5.1).  ``deliver`` enqueues; the handler runs when the CPU
  frees up; sends made by the handler depart at handler completion time.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class Sim:
    def __init__(self, seed: int = 0) -> None:
        self.now: float = 0.0
        self.rng = random.Random(seed)
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.events_processed = 0
        # Optional flight recorder (repro_torch.core.telemetry.Tracer).  Actors
        # null-check it, so a tracer can be attached/detached at any time.
        self.tracer = None
        # Optional protocol watchdog (repro_torch.sim.watchdog.Watchdog): same
        # null-check idiom; actors emit journal events / checker feed points
        # through it when attached.
        self.watchdog = None

    def at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.now + dt, fn)

    def run(self, until: float = math.inf, max_events: int = 50_000_000) -> None:
        while self._heap and self.events_processed < max_events:
            t, _, fn = heapq.heappop(self._heap)
            if t > until:
                self.now = until
                return
            self.now = t
            fn()
            self.events_processed += 1


class Network:
    def __init__(self, sim: Sim, params) -> None:
        from ..core.telemetry import get_registry

        self.sim = sim
        self.p = params
        self.bytes_sent = 0
        self.msgs_sent = 0
        self._m_msgs = get_registry().counter("net.msgs")
        self._m_drops = get_registry().counter("net.drops")

    def one_way_delay(self) -> float:
        p = self.p
        d = p.one_way_delay_us
        if p.delay_jitter_sigma > 0:
            d *= self.sim.rng.lognormvariate(0.0, p.delay_jitter_sigma)
        if p.tail_prob > 0 and self.sim.rng.random() < p.tail_prob:
            d += self.sim.rng.uniform(0.3, 1.0) * p.tail_extra_us
        return d

    def send(self, dst: "Node", msg: Any, size_bytes: int = 128) -> None:
        self.msgs_sent += 1
        self.bytes_sent += size_bytes
        self._m_msgs.inc()
        if self.p.drop_prob > 0 and self.sim.rng.random() < self.p.drop_prob:
            self._m_drops.inc()
            return
        self.sim.at(self.sim.now + self.one_way_delay(),
                    lambda: dst.deliver(msg))


class Node:
    """Single-server queue: one message handled at a time.

    Subclasses implement ``service_time(msg)`` and ``handle(msg)``; sends from
    ``handle`` happen at handler-completion time (the sim clock is already
    advanced when handle runs).
    """

    def __init__(self, sim: Sim, name: str) -> None:
        self.sim = sim
        self.name = name
        self.busy_until: float = 0.0
        self.crashed: bool = False
        self.busy_time: float = 0.0   # utilization accounting

    def deliver(self, msg: Any) -> None:
        if self.crashed:
            return
        start = max(self.sim.now, self.busy_until)
        svc = self.service_time(msg)
        done = start + svc
        self.busy_until = done
        self.busy_time += svc
        self.sim.at(done, lambda: self._run(msg))

    def _run(self, msg: Any) -> None:
        if self.crashed:
            return
        self.handle(msg)

    def occupy(self, dt: float) -> None:
        """Block the server for dt more µs (e.g. §4.4 sync-poll waste)."""
        self.busy_until = max(self.busy_until, self.sim.now) + dt
        self.busy_time += dt

    # -- overridables ---------------------------------------------------------
    def service_time(self, msg: Any) -> float:
        return 0.0

    def handle(self, msg: Any) -> None:
        raise NotImplementedError
