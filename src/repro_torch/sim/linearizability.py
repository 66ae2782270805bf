"""Linearizability checkers (Wing & Gong search with memoization).

CURP's guarantee (§3.4) is linearizability of single-/multi-key NoSQL ops.
Our histories come from the simulator and the in-process harnesses: each
entry has invoke/complete times, the op, and the externalized value.  Ops
whose completion was never externalized (client crashed / gave up / sim
ended) are "maybe" ops: a valid linearization may either include them at any
legal point or exclude them.

Two checkers live here:

* ``check_linearizable`` — the per-key projection.  Single-key histories
  decompose per key, which keeps the NP-hard search tractable; multi-key
  ops (MSET / TXN) are projected onto each touched key.  **This projection
  is blind to torn multi-key writes**: a "maybe" MSET's per-key legs are
  dropped or kept INDEPENDENTLY per key, so a client crash that applied the
  write on shard A but not shard B still passes — each key's sub-history is
  individually fine.
* ``check_linearizable_strict`` — strict multi-key atomicity.  A GLOBAL
  Wing & Gong search over whole ops and a whole-store state: every
  multi-key op (MSET / TXN) linearizes at ONE point that all of its keys
  share, and a maybe op is included at some single point or excluded
  entirely.  Per-key decomposition fundamentally cannot express this —
  each key's sub-search may place the same op at a different point, which
  is exactly how a torn write hides — so the strict checker does not
  decompose.  It is what catches a torn cross-shard ``mset`` and what the
  transaction subsystem (repro_torch.core.txn) must pass under crash injection.
  Cost: exponential in true concurrency; our harness histories are
  near-sequential (disjoint logical windows), so the memoized search stays
  effectively linear.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

from ..core.store import merge_append, merge_max, merge_sadd
from ..core.types import Op, OpType

# Op types the checkers model.  The merge classes (INCR/SADD/APPEND/MAX/
# HMSET) use the STORE's own merge functions as their legality model —
# imported, not re-implemented, so checker and state machine cannot drift.
_SINGLE = (OpType.SET, OpType.GET, OpType.INCR, OpType.DEL,
           OpType.SADD, OpType.APPEND, OpType.MAX, OpType.HMSET)
_MULTI = (OpType.MSET, OpType.TXN)

# Merge ops whose argument is args[0] and whose externalized value is the
# uninformative "OK" (no per-op contradiction check; legality is the state).
_MERGE_ARG0 = (OpType.SADD, OpType.APPEND, OpType.MAX)


def _canon(v):
    """Hashable canonical form of a store value (the Wing & Gong memo keys
    on state, so dict values from HMSET must canonicalize)."""
    if isinstance(v, dict):
        return ("#H", tuple(sorted(v.items(), key=repr)))
    return v


def _canon_hmset(cur, fields):
    """Apply HMSET fields over a canonicalized prior hash value."""
    h = (dict(cur[1]) if isinstance(cur, tuple) and len(cur) == 2
         and cur[0] == "#H" else {})
    for f, v in fields:
        h[f] = v
    return _canon(h)


@dataclass(frozen=True)
class HEvent:
    idx: int
    invoke: float
    complete: Optional[float]   # None => "maybe" op (no externalized response)
    op_type: OpType
    arg: Any                    # SET value / INCR delta / None
    value: Any                  # externalized result (GET value, INCR result)


def _txn_legs(op: Op, value: Any):
    """(write_kvs, read_kvs) of a TXN history entry: writes from the spec,
    read values from the externalized result (None when never completed)."""
    spec = op.args[0]
    write_kvs = tuple(spec.write_kvs)
    read_kvs: Tuple[Tuple[Any, Any], ...] = ()
    if isinstance(value, tuple) and len(value) == 2 and value[0] == "COMMITTED":
        read_kvs = tuple(zip(spec.read_keys, value[1]))
    return write_kvs, read_kvs


def _project(history: List[dict]) -> Dict[Any, List[HEvent]]:
    """Per-key projection (the fast, torn-write-blind decomposition)."""
    per_key: Dict[Any, List[HEvent]] = {}
    idx = 0

    def add(key, invoke, complete, op_type, arg, value):
        nonlocal idx
        per_key.setdefault(key, []).append(HEvent(
            idx=idx, invoke=invoke, complete=complete, op_type=op_type,
            arg=arg, value=value,
        ))
        idx += 1

    for h in history:
        op: Op = h["op"]
        if op.op_type not in _SINGLE + _MULTI:
            continue
        complete = h["complete"] if not h.get("failed") else None
        if op.op_type is OpType.TXN:
            write_kvs, read_kvs = _txn_legs(op, h["value"])
            for k, v in write_kvs:
                add(k, h["invoke"], complete, OpType.SET, v, h["value"])
            for k, v in read_kvs:
                # Read legs externalize only with a committed result.
                add(k, h["invoke"], complete, OpType.GET, None, v)
            continue
        for ki, key in enumerate(op.keys):
            if op.op_type == OpType.MSET:
                arg = op.args[ki]
            elif op.op_type == OpType.SET:
                arg = op.args[0]
            elif op.op_type == OpType.INCR:
                arg = op.args[0] if op.args else 1
            elif op.op_type in _MERGE_ARG0:
                arg = op.args[0]
            elif op.op_type == OpType.HMSET:
                arg = tuple(op.args[0]) if op.args else ()
            else:
                arg = None
            add(key, h["invoke"], complete,
                (OpType.SET if op.op_type == OpType.MSET else op.op_type),
                arg, h["value"])
    return per_key


def _check_key(events: List[HEvent]) -> bool:
    """Search for a linearization of one key's history."""
    events = sorted(events, key=lambda e: e.invoke)
    n = len(events)
    if n == 0:
        return True
    all_ids = frozenset(range(n))
    ev = {i: events[i] for i in range(n)}

    def apply(state, e: HEvent):
        """Returns next state, or None if e's externalized value contradicts."""
        if e.op_type == OpType.SET:
            return ("V", e.arg)
        if e.op_type == OpType.DEL:
            return ("V", None)
        if e.op_type == OpType.INCR:
            base = state[1] if state[0] == "V" and isinstance(state[1], int) else 0
            new = base + (e.arg if e.arg is not None else 1)
            if e.complete is not None and e.value is not None and e.value != new:
                return None
            return ("V", new)
        if e.op_type == OpType.SADD:
            return ("V", merge_sadd(state[1] if state[0] == "V" else None,
                                    e.arg))
        if e.op_type == OpType.APPEND:
            return ("V", merge_append(state[1] if state[0] == "V" else None,
                                      e.arg))
        if e.op_type == OpType.MAX:
            return ("V", merge_max(state[1] if state[0] == "V" else None,
                                   e.arg))
        if e.op_type == OpType.HMSET:
            return ("V", _canon_hmset(state[1] if state[0] == "V" else None,
                                      e.arg))
        if e.op_type == OpType.GET:
            cur = state[1] if state[0] == "V" else None
            if e.complete is not None and _canon(e.value) != _canon(cur):
                return None
            return state
        return state

    import sys
    sys.setrecursionlimit(10000)
    seen = set()

    def search(remaining: FrozenSet[int], state) -> bool:
        if not remaining:
            return True
        key = (remaining, state)
        if key in seen:
            return False
        # Candidates: ops that are minimal in the real-time order, i.e. whose
        # invocation precedes every remaining op's completion.
        min_complete = min(
            (ev[i].complete for i in remaining if ev[i].complete is not None),
            default=float("inf"),
        )
        for i in remaining:
            e = ev[i]
            if e.invoke > min_complete:
                continue
            nxt = apply(state, e)
            if nxt is not None and search(remaining - {i}, nxt):
                return True
            # Maybe-ops can also be dropped entirely (they never took effect).
            if e.complete is None and search(remaining - {i}, state):
                return True
        seen.add(key)
        return False

    # Completed ops must all be linearized; maybe-ops may be dropped.  The
    # search above handles dropping inline.
    return search(all_ids, ("V", None))


def _check_projection(per_key) -> Tuple[bool, Optional[Any]]:
    for key, events in per_key.items():
        if not _check_key(events):
            return False, key
    return True, None


def check_linearizable(history: List[dict]) -> Tuple[bool, Optional[Any]]:
    """Per-key projection checker.  Returns (ok, offending_key).  Sound for
    single-key ops; CANNOT detect torn multi-key writes (see module
    docstring) — use ``check_linearizable_strict`` for those."""
    return _check_projection(_project(history))


# ---------------------------------------------------------------------------
# Strict multi-key atomicity: a single global linearization order
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class _GEvent:
    """One whole op (all keys) for the global search."""
    idx: int
    invoke: float
    complete: Optional[float]
    # Effects: ((key, new_value) writes, (key, incr_delta) incrs,
    #           (key, expected) reads-with-externalized-values,
    #           (key,) unchecked reads) — reads check only when completed.
    writes: Tuple[Tuple[Any, Any], ...]
    incrs: Tuple[Tuple[Any, int], ...]
    reads: Tuple[Tuple[Any, Any], ...]
    incr_expect: Any = None      # externalized INCR result (None: unchecked)
    # Merge-class effects: (key, op_type, arg) folded through the store's
    # own merge functions (SADD/APPEND/MAX) or the canonical hash (HMSET).
    merges: Tuple[Tuple[Any, Any, Any], ...] = ()


def _global_events(history: List[dict]) -> List[_GEvent]:
    events: List[_GEvent] = []
    for h in history:
        op: Op = h["op"]
        if op.op_type not in _SINGLE + _MULTI:
            continue
        complete = h["complete"] if not h.get("failed") else None
        value = h["value"]
        writes: Tuple = ()
        incrs: Tuple = ()
        reads: Tuple = ()
        merges: Tuple = ()
        incr_expect = None
        if op.op_type is OpType.SET:
            writes = ((op.keys[0], op.args[0]),)
        elif op.op_type is OpType.DEL:
            writes = ((op.keys[0], None),)
        elif op.op_type is OpType.INCR:
            incrs = ((op.keys[0], op.args[0] if op.args else 1),)
            if complete is not None:
                incr_expect = value
        elif op.op_type in _MERGE_ARG0:
            merges = ((op.keys[0], op.op_type, op.args[0]),)
        elif op.op_type is OpType.HMSET:
            merges = ((op.keys[0], OpType.HMSET,
                       tuple(op.args[0]) if op.args else ()),)
        elif op.op_type is OpType.GET:
            if complete is not None:
                reads = ((op.keys[0], value),)
        elif op.op_type is OpType.MSET:
            writes = tuple(zip(op.keys, op.args))
        elif op.op_type is OpType.TXN:
            write_kvs, read_kvs = _txn_legs(op, value)
            writes = tuple(write_kvs)
            if complete is not None:
                reads = tuple(read_kvs)
        events.append(_GEvent(
            idx=len(events), invoke=h["invoke"], complete=complete,
            writes=writes, incrs=incrs, reads=reads,
            incr_expect=incr_expect, merges=merges,
        ))
    return events


def _apply_global(state: Tuple[Tuple[Any, Any], ...], e: _GEvent):
    """Apply one whole op to a canonical whole-store state; None if the
    op's externalized values contradict the state.  Shared by the strict
    whole-history search and the windowed incremental checker, so the two
    can never disagree on op semantics."""
    d = dict(state)
    for k, expect in e.reads:
        if _canon(d.get(k)) != _canon(expect):
            return None
    for k, delta in e.incrs:
        base = d.get(k)
        new = (base if isinstance(base, int) else 0) + delta
        if e.incr_expect is not None and e.incr_expect != new:
            return None
        d[k] = new
    for k, t, arg in e.merges:
        cur = d.get(k)
        if t is OpType.SADD:
            d[k] = merge_sadd(cur, arg)
        elif t is OpType.APPEND:
            d[k] = merge_append(cur, arg)
        elif t is OpType.MAX:
            d[k] = merge_max(cur, arg)
        else:   # HMSET over the canonical hashable hash value
            d[k] = _canon_hmset(cur, arg)
    for k, v in e.writes:
        d[k] = v
    return tuple(sorted(d.items(), key=lambda kv: repr(kv[0])))


def check_linearizable_strict(
    history: List[dict],
) -> Tuple[bool, Optional[Any]]:
    """Strict multi-key linearizability: ONE global linearization order over
    whole ops and a whole-store state.

    A multi-key op takes effect at a single point for ALL of its keys (the
    per-key projection lets each key's sub-search place the same op at a
    different point — the loophole a torn write hides in), and a maybe op
    is included at one point or excluded entirely.  Returns (ok,
    offending_key) where the key is taken from the op that could not be
    linearized (diagnostic).  Worst-case exponential in true concurrency;
    near-linear on our harness histories (disjoint logical windows).
    """
    events = _global_events(history)
    n = len(events)
    if n == 0:
        return True, None
    ev = {e.idx: e for e in events}
    all_ids = frozenset(ev)
    apply = _apply_global

    import sys
    sys.setrecursionlimit(100_000)
    seen = set()
    blamed: List[_GEvent] = []

    def search(remaining: FrozenSet[int], state) -> bool:
        if not remaining:
            return True
        key = (remaining, state)
        if key in seen:
            return False
        min_complete = min(
            (ev[i].complete for i in remaining if ev[i].complete is not None),
            default=float("inf"),
        )
        for i in remaining:
            e = ev[i]
            if e.invoke > min_complete:
                continue
            nxt = apply(state, e)
            if nxt is not None and search(remaining - {i}, nxt):
                return True
            if nxt is None and not blamed:
                blamed.append(e)
            # Maybe-ops may be excluded entirely (they never took effect —
            # ATOMICALLY: this drops every key's effect at once).
            if e.complete is None and search(remaining - {i}, state):
                return True
        seen.add(key)
        return False

    if search(all_ids, ()):
        return True, None
    offender = None
    if blamed:
        e = blamed[0]
        for group in (e.reads, e.writes, e.incrs, e.merges):
            if group:
                offender = group[0][0]
                break
    return False, offender


# ---------------------------------------------------------------------------
# Windowed incremental checker: strict semantics, bounded memory
# ---------------------------------------------------------------------------
class _Saturated(Exception):
    pass


def _blame_key(e: _GEvent):
    for group in (e.reads, e.writes, e.incrs, e.merges):
        if group:
            return group[0][0]
    return None


def _event_keys(e: _GEvent) -> set:
    ks = set()
    for k, _ in e.writes:
        ks.add(k)
    for k, _ in e.incrs:
        ks.add(k)
    for k, _ in e.reads:
        ks.add(k)
    for k, _t, _a in e.merges:
        ks.add(k)
    return ks


def _components(chunk: List[_GEvent]) -> List[Tuple[set, List[_GEvent]]]:
    """Partition a chunk into key-connected components.

    Linearizability is compositional over disjoint objects (Herlihy & Wing
    locality): ops that share no key — directly or through a chain of
    multi-key ops — constrain each other only through real-time order, and
    any per-component linearization interleaves into a global one that
    respects it.  Every multi-key op keeps ALL its keys in one component,
    so torn-write atomicity is preserved exactly.  This is what makes the
    windowed checker tractable on open-loop histories: hundreds of
    concurrent ops over a spread key space decompose into near-singleton
    searches, while a genuinely entangled (hot-key) chunk stays whole and
    falls back on the node budget.  Events with no effects at all (e.g. a
    never-completed read) constrain nothing and are dropped."""
    parent: Dict[Any, Any] = {}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ev_keys = []
    for e in chunk:
        ks = _event_keys(e)
        ev_keys.append(ks)
        it = iter(ks)
        first = next(it, None)
        if first is not None and first not in parent:
            parent[first] = first
        for k in it:
            if k not in parent:
                parent[k] = k
            ra, rb = find(first), find(k)
            if ra != rb:
                parent[ra] = rb
    comps: Dict[Any, Tuple[set, List[_GEvent]]] = {}
    for e, ks in zip(chunk, ev_keys):
        if not ks:
            continue
        entry = comps.setdefault(find(next(iter(ks))), (set(), []))
        entry[0].update(ks)
        entry[1].append(e)
    return list(comps.values())


class WindowedChecker:
    """Strict Wing & Gong, advanced incrementally over a completed-op
    frontier so 10^5–10^6-op open-loop runs are checked online in bounded
    memory (the whole-history checker holds every op until the end).

    Feed: ``invoke(rpc_id, t)`` when an op is issued, ``complete(entry)``
    when its history entry is known (including give-ups: ``failed`` entries
    become maybe-ops), ``finish()`` at teardown.

    Retirement rule: pending ops sorted by invoke; a prefix is *closed*
    when every op in it settles strictly before both (a) the earliest
    invoke of any later pending op and (b) the earliest invoke of any
    still-in-flight op.  No op outside a closed prefix can linearize inside
    it, so the prefix is searched exactly (collecting ALL reachable end
    states — carrying a single greedy state would mis-blame later chunks)
    and then discarded.  This is the same decomposition that keeps the
    strict checker near-linear on near-sequential histories, made explicit.

    Maybe-ops never complete, so they would pin the frontier forever; they
    settle at ``invoke + maybe_horizon`` instead.  The search may still
    drop them (a maybe both applied-and-not is two states in the carried
    set), but their effect is assumed to land within the horizon — sound
    for the sim, whose abandoned packets die within the retry/drain bound.
    ``maybe_horizon=None`` disables the assumption (exact, but a maybe op
    then blocks retirement of everything after it until ``finish``).

    Saturation (``max_pending`` overlapping ops, ``max_states`` carried
    states, or ``max_nodes`` search nodes per chunk) sets ``saturated`` and
    stops checking rather than guessing: no false alarms, explicitly
    reported coverage.
    """

    def __init__(self, flush_every: int = 256,
                 maybe_horizon: Optional[float] = None,
                 max_pending: int = 50_000, max_states: int = 256,
                 max_nodes: int = 500_000,
                 max_maybe: Optional[int] = 32,
                 max_overlap: Optional[int] = 16) -> None:
        self.flush_every = flush_every
        self.maybe_horizon = maybe_horizon
        self.max_pending = max_pending
        self.max_states = max_states
        self.max_nodes = max_nodes
        self.max_maybe = max_maybe
        self.max_overlap = max_overlap
        self._open: Dict[Any, float] = {}      # rpc_id -> invoke time
        self._pending: List[_GEvent] = []
        self._states: set = {()}
        self._since_flush = 0
        self.violation: Optional[Tuple[Any, dict]] = None
        self.saturated = False
        self.ops_checked = 0
        self.chunks = 0
        self.max_chunk = 0

    # ------------------------------------------------------------------ feed
    def invoke(self, rpc_id, t: float) -> None:
        self._open[rpc_id] = t

    def complete(self, entry: dict) -> None:
        """Ingest one finished history entry (completed or failed)."""
        self._open.pop(entry["op"].rpc_id, None)
        if self.violation is not None or self.saturated:
            return
        for g in _global_events([entry]):
            self._pending.append(g)
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self._since_flush = 0
            self._flush(final=False)

    def finish(self) -> bool:
        self._flush(final=True)
        return self.ok

    @property
    def ok(self) -> bool:
        return self.violation is None

    @property
    def pending(self) -> int:
        return len(self._pending)

    def stats(self) -> dict:
        return {
            "ops_checked": self.ops_checked, "chunks": self.chunks,
            "max_chunk": self.max_chunk, "pending": len(self._pending),
            "states": len(self._states), "saturated": self.saturated,
            "ok": self.ok,
        }

    # ----------------------------------------------------------------- flush
    def _settle(self, e: _GEvent) -> float:
        if e.complete is not None:
            return e.complete
        if self.maybe_horizon is None:
            return float("inf")
        return e.invoke + self.maybe_horizon

    def _flush(self, final: bool) -> None:
        if self.violation is not None or self.saturated:
            return
        self._pending.sort(key=lambda e: e.invoke)
        if final:
            chunk, rest = self._pending, []
        else:
            cut = min(self._open.values(), default=float("inf"))
            split, hi = 0, float("-inf")
            for i, e in enumerate(self._pending):
                if hi < cut and hi < e.invoke:
                    split = i   # prefix [0, i) is real-time closed
                hi = max(hi, self._settle(e))
            if hi < cut:
                split = len(self._pending)
            chunk, rest = self._pending[:split], self._pending[split:]
        if not chunk:
            if len(self._pending) > self.max_pending:
                self.saturated = True
            return
        # Each maybe-op forks the search (included-or-dropped); a chunk
        # dense with them — crash fallout, mass give-ups — would only burn
        # the whole node budget before saturating anyway.  Bail up front:
        # same verdict (saturated, honestly reported), none of the cost.
        if self.max_maybe is not None and \
                sum(1 for e in chunk if e.complete is None) > self.max_maybe:
            self.saturated = True
            return
        self._search_chunk(chunk)
        self._pending = rest
        if self.violation is None and not self.saturated:
            self.ops_checked += len(chunk)
            self.chunks += 1
            self.max_chunk = max(self.max_chunk, len(chunk))

    def _search_chunk(self, chunk: List[_GEvent]) -> None:
        """Search one real-time-closed chunk: decompose into key-connected
        components (see ``_components`` — exact by locality), run the
        Wing & Gong search per component from each carried state's
        projection, and carry the cross product of per-component end
        substates forward.  A chunk fails only when NO carried state admits
        a linearization of every component."""
        import itertools
        import sys

        sys.setrecursionlimit(100_000)
        comps = _components(chunk)
        if not comps:
            return
        comp_keys: set = set()
        for keys, _evs in comps:
            comp_keys |= keys
        nodes = [0]
        blamed: List[_GEvent] = []
        # Component results memoized on the start SUBSTATE: carried states
        # usually agree on a component's keys, so each search runs once.
        memo: Dict[Tuple[int, Tuple], FrozenSet] = {}
        new_states: set = set()

        try:
            for st in self._states:
                parts: List[List[Tuple]] = []
                ok = True
                for ci, (keys, evs) in enumerate(comps):
                    sub0 = tuple(sorted(
                        (kv for kv in st if kv[0] in keys),
                        key=lambda kv: repr(kv[0]),
                    ))
                    finals = memo.get((ci, sub0))
                    if finals is None:
                        finals = self._search_component(
                            evs, sub0, nodes, blamed)
                        memo[(ci, sub0)] = finals
                    if not finals:
                        ok = False
                        break
                    parts.append(sorted(finals))
                if not ok:
                    continue
                base = [kv for kv in st if kv[0] not in comp_keys]
                for combo in itertools.product(*parts):
                    d = dict(base)
                    for sub in combo:
                        d.update(sub)
                    new_states.add(tuple(
                        sorted(d.items(), key=lambda kv: repr(kv[0]))))
                    if len(new_states) > self.max_states:
                        self.saturated = True
                        return
        except _Saturated:
            self.saturated = True
            return
        if not new_states:
            e = blamed[0] if blamed else chunk[0]
            self.violation = (_blame_key(e), {
                "chunk_ops": len(chunk), "invoke": e.invoke,
                "complete": e.complete,
            })
            return
        self._states = new_states

    def _search_component(self, evs: List[_GEvent], start: Tuple,
                          nodes: List[int],
                          blamed: List[_GEvent]) -> FrozenSet:
        """All reachable end substates of one component from ``start``
        (empty set: no linearization exists).  The shared ``nodes`` budget
        spans the whole chunk, so one entangled component cannot starve
        the rest silently — it saturates the checker instead."""
        # Concurrency guard: k mutually-overlapping ops admit up to k!
        # interleavings — a crash-window retry pile-up on one hot key (50+
        # concurrent ops) would only grind the node budget down before
        # saturating anyway.  Measure the overlap degree up front and bail
        # with the same verdict at none of the cost.
        if self.max_overlap is not None and len(evs) > self.max_overlap:
            marks: List[Tuple[float, int]] = []
            for e in evs:
                marks.append((e.invoke, 1))
                if e.complete is not None:
                    marks.append((e.complete, -1))
            marks.sort()
            depth = peak = 0
            for _t, d in marks:
                depth += d
                peak = max(peak, depth)
            if peak > self.max_overlap:
                raise _Saturated

        ev = {i: e for i, e in enumerate(evs)}
        all_ids = frozenset(ev)
        finals: set = set()
        seen: set = set()

        def rec(remaining: FrozenSet[int], state) -> None:
            key = (remaining, state)
            if key in seen:
                return
            seen.add(key)
            nodes[0] += 1
            if nodes[0] > self.max_nodes:
                raise _Saturated
            if not remaining:
                finals.add(state)
                return
            min_complete = min(
                (ev[i].complete for i in remaining
                 if ev[i].complete is not None),
                default=float("inf"),
            )
            for i in remaining:
                e = ev[i]
                if e.invoke > min_complete:
                    continue
                nxt = _apply_global(state, e)
                if nxt is not None:
                    rec(remaining - {i}, nxt)
                elif not blamed:
                    blamed.append(e)
                if e.complete is None:   # maybe-op: droppable atomically
                    rec(remaining - {i}, state)

        rec(all_ids, start)
        return frozenset(finals)


def check_linearizable_windowed(
    history: List[dict], flush_every: int = 64,
    maybe_horizon: Optional[float] = None,
) -> Tuple[bool, Optional[Any]]:
    """Drive a WindowedChecker over a recorded history in event-time order
    (invokes and completions interleaved as they actually happened).
    Returns (ok, offending_key) like ``check_linearizable_strict``; with
    the default exact settings the verdicts provably agree — the windowed
    search is the strict search applied chunk-by-chunk with all reachable
    states carried across chunk boundaries."""
    chk = WindowedChecker(flush_every=flush_every,
                          maybe_horizon=maybe_horizon)
    stream = []
    for h in history:
        done = h["complete"] if h.get("complete") is not None else h["invoke"]
        stream.append((h["invoke"], 0, h))
        stream.append((done, 1, h))
    stream.sort(key=lambda x: (x[0], x[1]))
    for _t, phase, h in stream:
        if phase == 0:
            chk.invoke(h["op"].rpc_id, h["invoke"])
        else:
            chk.complete(h)
    ok = chk.finish()
    if chk.saturated:
        # Fall back to the whole-history search rather than under-report.
        return check_linearizable_strict(history)
    return ok, (chk.violation[0] if chk.violation else None)
