"""Serving-layer survival kit: admission control, throttling, circuit
breaking, and graceful degradation for overloaded CURP servers.

These are the protocol-agnostic policy objects behind the "production
traffic armor" scenarios (repro_torch.sim's open-loop storms, benchmarks/fig_slo):

* ``AdmissionQueue`` — queue-based load leveling in front of a single-server
  node: a bounded count of delivered-but-not-yet-served messages.  Arrivals
  beyond the bound are shed *immediately* (fail fast) instead of joining a
  queue whose wait already exceeds any useful deadline.  The shed reply is
  explicit, so clients back off rather than timing out and retrying into
  the same overload.
* ``TokenBucket`` / ``ClientThrottle`` — per-client rate limiting at the
  server: one misbehaving (or retry-storming) client cannot claim more than
  its provisioned share of admission slots.
* ``CircuitBreaker`` — client-side per-shard failure accounting: trips OPEN
  after consecutive failures (timeouts, NOT_OWNER on a mid-migration slot,
  crashed-master silence), fails fast while OPEN, and re-probes with a
  bounded number of HALF_OPEN trial requests after a cooldown.
* ``DegradeLevel``/``degrade_level`` — graceful degradation policy: under
  pressure the server sheds *slow-path* work first (defer batched backup
  syncs and witness gc), keeping the witness-backed 1-RTT write path alive;
  conflict-path syncs that gate withheld client replies are never deferred.

All times are caller-supplied floats (the discrete-event sim passes
``sim.now`` in µs); nothing here reads a wall clock, so the objects are
deterministic under simulation and trivially unit-testable.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional

from .telemetry import Histogram, get_registry


# --------------------------------------------------------------------------
# Admission control (queue-based load leveling)
# --------------------------------------------------------------------------
class AdmissionQueue:
    """Bounded admission in front of a single-server queue.

    ``admit()`` reserves a slot (returns False when the bound is hit —
    caller sheds the request), ``release()`` frees it when the request
    finishes service.  ``depth``/``max_depth``/``shed`` expose the load
    signal the degradation policy and the benchmarks read.  The bound may
    move at runtime (``set_capacity``) — the AIMD controller below drives
    it from the measured service-time distribution.
    """

    def __init__(self, capacity: int, scope: str = "admission") -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.depth = 0
        self.max_depth = 0
        self.admitted = 0
        self.shed = 0
        reg = get_registry()
        self._m_admitted = reg.counter(f"{scope}.admitted")
        self._m_shed = reg.counter(f"{scope}.shed")
        self._g_depth = reg.gauge(f"{scope}.depth")

    def admit(self) -> bool:
        if self.depth >= self.capacity:
            self.shed += 1
            self._m_shed.inc()
            return False
        self.depth += 1
        self.admitted += 1
        self._m_admitted.inc()
        if self.depth > self.max_depth:
            self.max_depth = self.depth
        self._g_depth.set(self.depth)
        return True

    def release(self) -> None:
        assert self.depth > 0, "release without admit"
        self.depth -= 1

    def set_capacity(self, capacity: int) -> None:
        """Move the bound (adaptive control).  In-flight requests above a
        lowered bound drain naturally; only new admissions see the change."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity

    def frac(self) -> float:
        """Current fill fraction — the pressure signal for degradation."""
        return self.depth / self.capacity


class AimdBound:
    """Adaptive admission bound: AIMD around a queueing-delay target.

    A static bound is tuned for one service-time regime; when the measured
    per-request service time drifts (op-mix change, degraded backend), the
    same depth means a very different queueing delay.  This controller
    derives the depth that keeps expected worst-case queue delay near
    ``target_delay_us`` (depth x p50 service time ~= delay, single-server
    queue) from the registry's live service-time histogram, and moves the
    queue's capacity toward it AIMD-style: +1 per tick while below the
    derived bound (gentle probing), multiplicative decrease (x ``beta``)
    when above it (fast backoff when service times inflate).
    """

    def __init__(self, queue: AdmissionQueue, service_hist: Histogram,
                 target_delay_us: float, min_cap: int = 4,
                 max_cap: int = 1024, beta: float = 0.7) -> None:
        self.queue = queue
        self.service_hist = service_hist
        self.target_delay_us = target_delay_us
        self.min_cap = min_cap
        self.max_cap = max_cap
        self.beta = beta
        self.ticks = 0
        self._g_cap = get_registry().gauge("admission.capacity")

    def derived_bound(self) -> Optional[int]:
        if self.service_hist.count < 16:
            return None   # not enough signal yet; hold the current bound
        p50 = self.service_hist.percentile(0.50)
        if p50 <= 0:
            return None
        want = int(self.target_delay_us / p50)
        return max(self.min_cap, min(self.max_cap, want))

    def tick(self) -> int:
        """One control step; returns the (possibly unchanged) capacity."""
        self.ticks += 1
        want = self.derived_bound()
        cap = self.queue.capacity
        if want is not None:
            if cap < want:
                cap += 1                                   # additive increase
            elif cap > want:
                cap = max(want, self.min_cap, int(cap * self.beta))
            if cap != self.queue.capacity:
                self.queue.set_capacity(cap)
        self._g_cap.set(cap)
        return cap


# --------------------------------------------------------------------------
# Per-client throttling
# --------------------------------------------------------------------------
class TokenBucket:
    """Classic token bucket: ``rate`` tokens per time unit, ``burst`` cap.

    Lazy refill — tokens accrue on each ``allow`` call from the elapsed
    time, so idle buckets cost nothing.
    """

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float = 0.0) -> None:
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.t_last = now

    def allow(self, now: float, cost: float = 1.0) -> bool:
        if now > self.t_last:
            self.tokens = min(self.burst, self.tokens + (now - self.t_last) * self.rate)
            self.t_last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class ClientThrottle:
    """Per-client token buckets, materialized lazily (an open-loop storm has
    10^5–10^6 client ids; only active ones pay memory)."""

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = rate
        self.burst = burst
        self._buckets: Dict[int, TokenBucket] = {}
        self.throttled = 0

    def allow(self, client_id: int, now: float) -> bool:
        b = self._buckets.get(client_id)
        if b is None:
            b = self._buckets[client_id] = TokenBucket(self.rate, self.burst, now)
        if b.allow(now):
            return True
        self.throttled += 1
        return False


# --------------------------------------------------------------------------
# Circuit breaker (client side, per shard)
# --------------------------------------------------------------------------
class BreakerState(enum.Enum):
    CLOSED = "CLOSED"
    OPEN = "OPEN"
    HALF_OPEN = "HALF_OPEN"


class CircuitBreaker:
    """Trip after ``failure_threshold`` consecutive failures; while OPEN all
    requests fail fast (no network attempt).  After ``reset_timeout`` the
    breaker admits up to ``half_open_probes`` trial requests: one success
    closes it, one failure re-opens it (and restarts the cooldown).
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout: float = 2000.0,
                 half_open_probes: int = 1) -> None:
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.half_open_probes = half_open_probes
        self.state = BreakerState.CLOSED
        self.failures = 0
        self.opened_at: Optional[float] = None
        self._probes_out = 0
        self.stats = {"trips": 0, "fast_fails": 0, "probes": 0, "closes": 0}
        reg = get_registry()
        self._m_trips = reg.counter("breaker.trips")
        self._m_closes = reg.counter("breaker.closes")
        self._m_fast_fails = reg.counter("breaker.fast_fails")
        self._m_half_opens = reg.counter("breaker.half_opens")

    def allow(self, now: float) -> bool:
        """May a request be sent now?  (HALF_OPEN admissions count as probes
        until an outcome is recorded.)"""
        if self.state is BreakerState.CLOSED:
            return True
        if self.state is BreakerState.OPEN:
            if now - self.opened_at >= self.reset_timeout:
                self.state = BreakerState.HALF_OPEN
                self._m_half_opens.inc()
                self._probes_out = 0
            else:
                self.stats["fast_fails"] += 1
                self._m_fast_fails.inc()
                return False
        # HALF_OPEN: bounded concurrent probes.
        if self._probes_out < self.half_open_probes:
            self._probes_out += 1
            self.stats["probes"] += 1
            return True
        self.stats["fast_fails"] += 1
        self._m_fast_fails.inc()
        return False

    def record_success(self) -> None:
        if self.state is BreakerState.HALF_OPEN:
            self.stats["closes"] += 1
            self._m_closes.inc()
        self.state = BreakerState.CLOSED
        self.failures = 0
        self._probes_out = 0

    def record_failure(self, now: float) -> None:
        if self.state is BreakerState.HALF_OPEN:
            self._trip(now)
            return
        self.failures += 1
        if self.state is BreakerState.CLOSED and \
                self.failures >= self.failure_threshold:
            self._trip(now)

    def _trip(self, now: float) -> None:
        self.state = BreakerState.OPEN
        self.opened_at = now
        self.failures = 0
        self._probes_out = 0
        self.stats["trips"] += 1
        self._m_trips.inc()


# --------------------------------------------------------------------------
# Graceful degradation
# --------------------------------------------------------------------------
class DegradeLevel(enum.IntEnum):
    NORMAL = 0      # full service
    DEFER_SLOW = 1  # defer batched backup syncs + witness gc (slow path)


def degrade_level(frac: float, level: DegradeLevel,
                  hi: float, lo: float) -> DegradeLevel:
    """Hysteresis thresholding of the admission-fill signal: enter
    DEFER_SLOW at ``hi``, leave it only below ``lo`` (lo < hi), so the
    server does not flap at the boundary."""
    if level is DegradeLevel.NORMAL:
        return DegradeLevel.DEFER_SLOW if frac >= hi else DegradeLevel.NORMAL
    return DegradeLevel.NORMAL if frac < lo else DegradeLevel.DEFER_SLOW


# --------------------------------------------------------------------------
# Armor configuration bundle
# --------------------------------------------------------------------------
@dataclass
class ArmorConfig:
    """One knob bundle for a server's survival kit (sim wiring reads this).

    ``throttle_rate`` is in ops per µs per client (e.g. 0.01 = 10k ops/s);
    rate <= 0 disables the per-client throttle.  ``degrade_hi``/``lo`` are
    admission-fill fractions with hysteresis (see ``degrade_level``).

    ``adaptive`` replaces the static master admission bound with the AIMD
    controller (``AimdBound``) driven by the registry's measured master
    service-time histogram: ``queue_capacity`` becomes the starting point,
    and the bound converges to ~``adaptive_target_delay_us`` of expected
    queueing delay within [``adaptive_min``, ``adaptive_max``], re-derived
    every ``adaptive_interval_ops`` served requests.
    """
    queue_capacity: int = 64
    witness_queue_capacity: int = 128
    throttle_rate: float = 0.0
    throttle_burst: float = 8.0
    degrade_hi: float = 0.75
    degrade_lo: float = 0.40
    adaptive: bool = False
    adaptive_target_delay_us: float = 40.0
    adaptive_min: int = 4
    adaptive_max: int = 256
    adaptive_interval_ops: int = 32

    def make_queue(self) -> AdmissionQueue:
        return AdmissionQueue(self.queue_capacity, scope="admission")

    def make_witness_queue(self) -> AdmissionQueue:
        return AdmissionQueue(self.witness_queue_capacity,
                              scope="admission_witness")

    def make_aimd(self, queue: AdmissionQueue,
                  service_hist: Histogram) -> Optional[AimdBound]:
        if not self.adaptive:
            return None
        return AimdBound(queue, service_hist, self.adaptive_target_delay_us,
                         self.adaptive_min, self.adaptive_max)

    def make_throttle(self) -> Optional[ClientThrottle]:
        if self.throttle_rate <= 0:
            return None
        return ClientThrottle(self.throttle_rate, self.throttle_burst)
