"""Black-box event journal: a bounded ring buffer of protocol events.

The watchdog (repro_torch.sim.watchdog) audits CURP's paper invariants *online*;
this module is its sensor bus.  Protocol objects (Master, Witness,
SlotMigration, TxnCoordinator) and the sim actors carry an optional
``journal`` attribute (default None) and emit one cheap event per protocol
step — execute, sync, record, gc, fence, freeze, handover, intent, ack —
keyed by RIFL id where one applies.  Emission is O(1) and allocation-light;
with no journal attached the hook is a single attribute load + None check,
so the hooks are safe to leave in the hot path permanently.

The buffer is a fixed-capacity ring: old events are overwritten, never
reallocated, so a million-op storm journals in constant memory.  ``dropped``
counts the overwritten prefix; ``last(n)`` / ``to_jsonable()`` feed the
black-box dump a breach produces (the flight-recorder "last N seconds").

Subscribers (the watchdog's monitors) observe every event at emit time —
they run *inside* the discrete-event loop, which is what makes the
invariant checks incremental rather than post-hoc.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

# RIFL identity: (client_id, seq) — the key the journal indexes events by.
RpcKey = Optional[Tuple[int, int]]


class Event:
    """One journal entry.  ``seq`` is the global emission counter (never
    wraps — only the ring storage does), ``t`` the emitting clock's time
    (sim µs when attached to a Sim; the seq itself otherwise)."""

    __slots__ = ("seq", "t", "kind", "actor", "rpc", "args")

    def __init__(self, seq: int, t: float, kind: str, actor: str,
                 rpc: RpcKey, args: Dict[str, Any]) -> None:
        self.seq = seq
        self.t = t
        self.kind = kind
        self.actor = actor
        self.rpc = rpc
        self.args = args

    def to_jsonable(self) -> Dict[str, Any]:
        def enc(v):
            if isinstance(v, (str, int, float, bool)) or v is None:
                return v
            if isinstance(v, (tuple, list)):
                return [enc(x) for x in v]
            return repr(v)

        return {
            "seq": self.seq, "t": self.t, "kind": self.kind,
            "actor": self.actor,
            "rpc": list(self.rpc) if self.rpc is not None else None,
            "args": {k: enc(v) for k, v in self.args.items()},
        }

    def __repr__(self) -> str:  # diagnostics only
        return (f"Event(#{self.seq} t={self.t:.1f} {self.kind} "
                f"{self.actor} rpc={self.rpc} {self.args})")


class EventJournal:
    """Bounded-memory protocol event ring (see module docstring).

    ``clock`` is an optional zero-arg callable returning the current time
    (the sim harness installs ``lambda: sim.now``); without one, events are
    stamped with their own sequence number, which keeps the instant
    harnesses' journals totally ordered too.
    """

    def __init__(self, capacity: int = 8192,
                 clock: Optional[Callable[[], float]] = None) -> None:
        assert capacity >= 1
        self.capacity = capacity
        self.clock = clock
        self.seq = 0
        self._buf: List[Optional[Event]] = [None] * capacity
        self._subs: List[Callable[[Event], None]] = []

    # ------------------------------------------------------------------ emit
    def emit(self, kind: str, actor: str = "", rpc: RpcKey = None,
             **args: Any) -> Event:
        clock = self.clock
        t = clock() if clock is not None else float(self.seq)
        ev = Event(self.seq, t, kind, actor, rpc, args)
        self._buf[self.seq % self.capacity] = ev
        self.seq += 1
        for fn in self._subs:
            fn(ev)
        return ev

    def subscribe(self, fn: Callable[[Event], None]) -> None:
        """Register an observer called synchronously on every emit (the
        watchdog's monitor dispatch)."""
        self._subs.append(fn)

    # ------------------------------------------------------------------ read
    @property
    def dropped(self) -> int:
        """Events overwritten by the ring (total emitted minus retained)."""
        return max(0, self.seq - self.capacity)

    def events(self) -> List[Event]:
        """Surviving events, oldest first."""
        if self.seq <= self.capacity:
            return [e for e in self._buf[:self.seq]]
        head = self.seq % self.capacity
        return [e for e in self._buf[head:] + self._buf[:head]
                if e is not None]

    def last(self, n: int) -> List[Event]:
        evs = self.events()
        return evs[-n:] if n < len(evs) else evs

    def to_jsonable(self, last_n: Optional[int] = None) -> List[Dict[str, Any]]:
        evs = self.events() if last_n is None else self.last(last_n)
        return [e.to_jsonable() for e in evs]
