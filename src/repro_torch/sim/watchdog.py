"""Protocol watchdog: always-on invariant monitors over the black-box journal.

CURP's correctness argument (paper §3.4, §B) rests on a handful of
invariants that the implementation is supposed to maintain at every step:

* **acked-write durability** (§3.2.2/§B.1) — a 1-RTT (fast-path) ack means
  the op is recorded on all ``f`` witnesses, or already backup-synced;
* **epoch / witness-list-version monotonicity** (§3.6) — every recovery or
  migration fence strictly advances the shard's epoch and never regresses
  its witness list version, and no master executes under a regressed epoch;
* **single owner per slot** (§3.6 reconfiguration) — between a slot's
  freeze and its handover commit, NO client op executes on that slot;
* **RIFL exactly-once** (§4.8) — a master's applied ack frontier per client
  never regresses, and no op below the frontier re-executes;
* **intent liveness** (Sinfonia-style 2PC, repro_torch.core.txn) — a prepared
  transaction intent is decided (commit/abort) within a bounded horizon;
* **fast-path commutativity** (§2, §3.2.2) — an op acked FAST commutes
  (per the repro_torch.core.merge lattice) with every op in the master's
  unsynced window at execution time;
* **linearizability** (§3.4) — the external history has a strict (whole-op,
  multi-key-atomic) linearization; checked online by the windowed
  incremental Wing & Gong checker (repro_torch.sim.linearizability).

The protocol objects emit cheap events into a bounded ring journal
(repro_torch.core.journal); this module subscribes a monitor dispatch to that
journal so every invariant is evaluated incrementally INSIDE the
discrete-event loop — a breach is caught within events of the violation,
not at teardown.  On the first breach the watchdog seals a **black box**:
the last-N journal events, a metrics-registry snapshot, a drained
flight-recorder trace slice, and the scenario seed/kwargs needed for
``replay()`` to re-run the simulation deterministically to the same breach.

``ChaosConfig`` is the watchdog's validation layer: seven one-shot protocol
mutations (skip a migration fence, ack before any witness records, leak a
txn intent, ...) wired into the sim actors, each violating EXACTLY ONE
monitor's invariant — benchmarks/fig_watchdog.py asserts every monitor
fires under its switch (non-vacuous) and none fires on clean runs.
"""
from __future__ import annotations

import copy
import json
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core.journal import Event, EventJournal
from ..core.merge import conflicts

# Chaos switch -> the single monitor that must catch it (the contract
# fig_watchdog and tests/test_watchdog.py assert, switch by switch).
CHAOS_MONITOR = {
    "early_ack": "durability",
    "skip_epoch_bump": "epoch",
    "skip_fence": "single_owner",
    "rifl_rollback": "rifl",
    "leak_intent": "intent",
    "force_commute": "commutativity",
    "corrupt_value": "linearizability",
}

_MIGRATE_OPS = ("MIGRATE_IN", "MIGRATE_OUT")
_TXN_DECIDE_OPS = ("TXN_COMMIT", "TXN_ABORT")


def _json_safe(v):
    """Best-effort JSON projection: live objects (workloads, tracers) in
    the replay coordinates become their repr in the sealed black box."""
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


@dataclass
class ChaosConfig:
    """One-shot protocol mutation switches (fault injection FOR the
    watchdog, not for the protocol under test: each switch breaks exactly
    one paper invariant so the matching monitor can prove it watches).

    Sites live in repro_torch.sim.curp_sim (timed transport) except
    ``leak_intent``, which the instant-transport harness below injects via
    the 2PC crash hook.  Every switch fires at most once per run
    (``fire``/``fired`` latches), so a run's journal contains exactly one
    seeded violation — and ``clone()`` resets the latches so a replay
    re-fires them at the same protocol step.
    """

    early_ack: bool = False        # ack a fast-path op with 0 witness records
    skip_fence: bool = False       # migrate a slot without freezing it
    leak_intent: bool = False      # crash the 2PC coordinator mid-decide
    skip_epoch_bump: bool = False  # recover a master without the epoch fence
    force_commute: bool = False    # conflicting op rides the fast path
    rifl_rollback: bool = False    # regress one client's applied ack frontier
    corrupt_value: bool = False    # return a read value nobody ever wrote
    _latched: set = field(default_factory=set, repr=False)
    # Set by Watchdog.__init__: lets ``fire`` stamp the journal seq of each
    # injection, so detection latency is measurable in journal events.
    _journal: Any = field(default=None, repr=False)
    _fire_seq: dict = field(default_factory=dict, repr=False)

    _SWITCHES = tuple(CHAOS_MONITOR)

    def any(self) -> bool:
        return any(getattr(self, s) for s in self._SWITCHES)

    def active(self) -> Tuple[str, ...]:
        return tuple(s for s in self._SWITCHES if getattr(self, s))

    def fired(self, name: str) -> bool:
        return name in self._latched

    def fire(self, name: str) -> None:
        self._latched.add(name)
        if self._journal is not None and name not in self._fire_seq:
            self._fire_seq[name] = self._journal.seq

    def clone(self) -> "ChaosConfig":
        """Same switches, fresh latches — what ``replay`` runs with."""
        return ChaosConfig(**{s: getattr(self, s) for s in self._SWITCHES})


@dataclass(frozen=True)
class Breach:
    """One detected invariant violation.  ``key()`` is the deterministic
    identity two runs of the same seed must agree on bit-for-bit."""

    monitor: str
    seq: int            # journal sequence number of the triggering event
    t: float            # journal clock at detection
    rpc: Any            # RIFL id involved, when one applies
    reason: str

    def key(self) -> Tuple:
        return (self.monitor, self.seq, self.t, self.rpc, self.reason)

    def to_jsonable(self) -> Dict[str, Any]:
        return {
            "monitor": self.monitor, "seq": self.seq, "t": self.t,
            "rpc": list(self.rpc) if isinstance(self.rpc, tuple) else self.rpc,
            "reason": self.reason,
        }


class Watchdog:
    """Always-on protocol auditor: owns the event journal, runs the
    incremental invariant monitors as a journal subscriber, feeds the
    windowed linearizability checker from the client-side hooks, and seals
    a black-box dump on the first breach.

    Attach with ``attach(sim, cluster, f=..., mode=...)`` (timed transport)
    or ``attach_cluster(cluster)`` (instant ShardedCluster).  The per-event
    cost is a dict update or two per monitor — fig_watchdog asserts the
    watched overload ramp keeps >= 95% of the unwatched goodput.
    """

    def __init__(self, chaos: Optional[ChaosConfig] = None,
                 capacity: int = 8192, intent_bound: int = 5000,
                 maybe_horizon: Optional[float] = 50_000.0,
                 flush_every: int = 256, blackbox_last_n: int = 512,
                 check_linearizability: bool = True,
                 state_cap: int = 8192) -> None:
        from .linearizability import WindowedChecker

        self.chaos = chaos if chaos is not None else ChaosConfig()
        self.journal = EventJournal(capacity=capacity)
        self.journal.subscribe(self._on_event)
        self.chaos._journal = self.journal
        self.intent_bound = intent_bound
        self.blackbox_last_n = blackbox_last_n
        self.state_cap = state_cap
        self._ctor = dict(
            capacity=capacity, intent_bound=intent_bound,
            maybe_horizon=maybe_horizon, flush_every=flush_every,
            blackbox_last_n=blackbox_last_n,
            check_linearizability=check_linearizability,
            state_cap=state_cap,
        )
        self.checker = WindowedChecker(
            flush_every=flush_every, maybe_horizon=maybe_horizon,
        ) if check_linearizability else None

        self.breaches: List[Breach] = []
        self.blackbox: Optional[Dict[str, Any]] = None
        self.events_seen = 0
        self.finalized = False
        # Scenario identity for deterministic replay (run_watched_scenario
        # fills these; None when the watchdog is attached by hand).
        self.run_args: Optional[Dict[str, Any]] = None

        self.sim = None
        self.router = None
        self._f = 0
        self._mode = "curp"
        self._commut_on = False

        # -- monitor state (all bounded) -----------------------------------
        # Per-master state is keyed on the journal ACTOR string (unique per
        # shard AND per master incarnation by construction — attach prefixes
        # it with the shard index), never on the raw master id: SimClusters
        # allocate ids from their own counters, so two shards' masters can
        # share a master_id.
        # durability: rpc -> set of witness actors that accepted it
        self._accepts: "OrderedDict[Any, set]" = OrderedDict()
        # durability: rpc -> (actor, 1-based log index) of its execution
        self._exec_at: "OrderedDict[Any, Tuple[str, int]]" = OrderedDict()
        self._synced_through: Dict[str, int] = {}    # actor -> synced index
        # epoch: shard -> (epoch, wlv) at the last fence
        self._shard_cfg: Dict[int, Tuple[int, int]] = {}
        self._mid_epoch: Dict[str, int] = {}         # actor -> last exec epoch
        self._mid_shard: Dict[str, int] = {}         # actor -> shard index
        # single-owner: slot -> freeze-event seq (open handover windows)
        self._moving: Dict[int, int] = {}
        # rifl: (actor, client) -> last journaled ack frontier
        self._frontier: Dict[Tuple[str, int], int] = {}
        # intent: (txn_id, actor) -> prepare-event seq, insertion-ordered
        self._intents: "OrderedDict[Tuple[Any, str], int]" = OrderedDict()
        self._intents_flagged: set = set()
        # commutativity: per master actor, the unsynced window mirror —
        #   actor -> OrderedDict{index -> pairs}  (insertion == index order)
        #   actor -> {key_hash -> {cls -> refcount}}
        self._win: Dict[str, "OrderedDict[int, tuple]"] = {}
        self._win_kh: Dict[str, Dict[int, Dict[int, int]]] = {}

    # ------------------------------------------------------------ attachment
    def attach(self, sim, cluster, f: int = 0, mode: str = "curp") -> None:
        """Wire the watchdog into a timed-transport run: install self on the
        Sim (actors null-check ``sim.watchdog``), point the journal clock at
        the sim clock, hand the journal to every master/witness core, and
        emit one baseline ``init`` fence per shard (the epoch monitor's
        first comparison point)."""
        self.sim = sim
        sim.watchdog = self
        self.journal.clock = lambda: sim.now
        self._f = f
        self._mode = mode
        self._commut_on = mode == "curp"
        shards = getattr(cluster, "shards", None)
        if shards is not None and hasattr(cluster, "router"):
            self.router = cluster.router
            for i, s in enumerate(shards):
                self._wire_sim_shard(s, i)
        else:
            self.router = None
            self._wire_sim_shard(cluster, 0)

    def _wire_sim_shard(self, s, shard_idx: int) -> None:
        # Actor names must be globally unique: each SimCluster allocates
        # master ids from its OWN counter, so two shards' masters share a
        # master_id and the per-master monitor state would mix their
        # windows without the shard prefix.
        s.wd_shard = shard_idx
        core = s.master_node.core
        core.journal = self.journal
        core.journal_actor = f"s{shard_idx}m{core.master_id}"
        self._mid_shard[core.journal_actor] = shard_idx
        for j, w in enumerate(s.witness_cores):
            w.journal = self.journal
            w.journal_actor = f"s{shard_idx}w{j}"
        self.journal.emit(
            "fence", actor=core.journal_actor, shard=shard_idx,
            epoch=s.epoch, wlv=s.wlv, mid=core.master_id, reason="init",
        )

    def attach_cluster(self, cluster) -> None:
        """Wire into an instant-transport ShardedCluster (repro_torch.core.shard):
        same journal, seq-stamped clock, migration/txn events via the
        MigrationManager's journal slot."""
        self._commut_on = True
        self.router = cluster.router
        cluster.migration.journal = self.journal
        for g in cluster.shards:
            if g.retired:
                continue
            g.master.journal = self.journal
            g.master.journal_actor = f"s{g.shard_id}m{g.master.master_id}"
            self._mid_shard[g.master.journal_actor] = g.shard_id
            for j, w in enumerate(g.witnesses):
                w.journal = self.journal
                w.journal_actor = f"s{g.shard_id}w{j}"
            self.journal.emit(
                "fence", actor=g.master.journal_actor, shard=g.shard_id,
                epoch=g.master.epoch, wlv=g.master.witness_list_version,
                mid=g.master.master_id, reason="init",
            )

    # ------------------------------------------------- client-side feed hooks
    def op_invoked(self, rpc_id, t: float) -> None:
        if self.checker is not None:
            self.checker.invoke(rpc_id, t)

    def op_completed(self, entry: Dict[str, Any]) -> None:
        if self.checker is not None:
            self.checker.complete(entry)
            self._check_linearizability()

    def op_failed(self, entry: Dict[str, Any]) -> None:
        """A give-up / crash casualty: a 'maybe' op for the checker."""
        if self.checker is not None:
            self.checker.complete(entry)
            self._check_linearizability()

    def _check_linearizability(self) -> None:
        chk = self.checker
        if chk is not None and chk.violation is not None \
                and not self._has("linearizability"):
            key, detail = chk.violation
            self._breach(
                "linearizability",
                f"no valid linearization (key={key!r}, {detail})",
                rpc=None, ev=None,
            )

    # ---------------------------------------------------------------- dispatch
    def _on_event(self, ev: Event) -> None:
        self.events_seen += 1
        kind = ev.kind
        if kind == "execute":
            self._m_execute(ev)
        elif kind == "record":
            self._m_record(ev)
        elif kind == "sync":
            self._m_sync(ev)
        elif kind == "ack":
            self._m_ack(ev)
        elif kind == "fence":
            self._m_fence(ev)
        elif kind == "freeze":
            self._m_freeze(ev)
        elif kind == "handover":
            self._m_handover(ev)
        # intent liveness is clocked by EVERY event: the bound is "decided
        # within N journal events of the prepare", whatever those events are.
        self._m_intent_tick(ev)

    # ------------------------------------------------------------- monitors
    def _m_execute(self, ev: Event) -> None:
        a = ev.args
        mid = ev.actor           # unique per master incarnation, unlike a["mid"]
        op_name = a["op"]
        txn = a.get("txn")

        # epoch monotonicity, per master: an execute under an epoch lower
        # than one this master already journaled means time ran backwards.
        ep = a["epoch"]
        prev_ep = self._mid_epoch.get(mid)
        if prev_ep is not None and ep < prev_ep:
            self._breach("epoch",
                         f"master {mid} executed under epoch {ep} after "
                         f"epoch {prev_ep}", rpc=ev.rpc, ev=ev)
        self._mid_epoch[mid] = max(ep, prev_ep if prev_ep is not None else ep)

        # single owner per slot (§3.6): no client op may execute on a slot
        # between its freeze and its handover commit.  Migration transfer
        # legs and txn decide legs are the protocol's OWN traffic through
        # the window and are exempt.
        if self._moving and self.router is not None and txn is None \
                and op_name not in _MIGRATE_OPS:
            for kh, _cls in a["pairs"]:
                slot = self.router.slot_of_hash(kh)
                if slot in self._moving:
                    self._breach(
                        "single_owner",
                        f"op executed on slot {slot} mid-handover "
                        f"(frozen at event #{self._moving[slot]})",
                        rpc=ev.rpc, ev=ev)
                    break

        # RIFL exactly-once (§4.8): the applied ack frontier per (master,
        # client) never regresses, and no plain client op re-executes below
        # it (a dup the RIFL table should have absorbed).
        if ev.rpc is not None:
            client, seq = ev.rpc
            fr = a["frontier"]
            prev_fr = self._frontier.get((mid, client))
            if prev_fr is not None and fr < prev_fr:
                self._breach(
                    "rifl",
                    f"ack frontier of client {client} at master {mid} "
                    f"regressed {prev_fr} -> {fr}", rpc=ev.rpc, ev=ev)
            self._frontier[(mid, client)] = max(
                fr, prev_fr if prev_fr is not None else fr)
            if a["checked"] and txn is None and op_name not in _MIGRATE_OPS \
                    and seq < fr:
                self._breach(
                    "rifl",
                    f"op seq {seq} re-executed below ack frontier {fr}",
                    rpc=ev.rpc, ev=ev)

        # intent liveness: prepares install, decides retire.
        if txn is not None:
            if op_name == "TXN_PREPARE":
                self._intents.setdefault((txn, mid), ev.seq)
            elif op_name in _TXN_DECIDE_OPS:
                self._intents.pop((txn, mid), None)

        # fast => commutes (§2/§3.2.2): mirror the master's unsynced window
        # from the journal and re-derive the conflict verdict from the
        # merge lattice.  ``checked=False`` verdicts (MIGRATE_IN, txn
        # decide legs) reply FAST by design without a window check.
        if self._commut_on and a["checked"]:
            win_kh = self._win_kh.setdefault(mid, {})
            if a["verdict"] == "fast":
                hit = None
                for kh, cls in a["pairs"]:
                    for other_cls, n in win_kh.get(kh, {}).items():
                        if n > 0 and conflicts(cls, other_cls):
                            hit = (kh, cls, other_cls)
                            break
                    if hit:
                        break
                if hit:
                    self._breach(
                        "commutativity",
                        f"FAST ack for op conflicting (cls {hit[1]} vs "
                        f"{hit[2]}) with an unsynced op on key hash "
                        f"{hit[0]:#x}", rpc=ev.rpc, ev=ev)
            win = self._win.setdefault(mid, OrderedDict())
            win[a["index"]] = a["pairs"]
            for kh, cls in a["pairs"]:
                per = win_kh.setdefault(kh, {})
                per[cls] = per.get(cls, 0) + 1
            if len(win) > self.state_cap:   # safety valve, never hit in curp
                self._retire_window(mid, next(iter(win)))

        # durability bookkeeping: where (and at what log index) the op ran.
        if ev.rpc is not None:
            self._exec_at[ev.rpc] = (mid, a["index"])
            self._cap(self._exec_at)

    def _m_record(self, ev: Event) -> None:
        if ev.args["status"] == "accepted":
            acc = self._accepts.get(ev.rpc)
            if acc is None:
                acc = self._accepts[ev.rpc] = set()
                self._cap(self._accepts)
            acc.add(ev.actor)

    def _m_sync(self, ev: Event) -> None:
        mid = ev.actor
        through = ev.args["through"]
        self._synced_through[mid] = max(
            through, self._synced_through.get(mid, 0))
        # retire the commutativity mirror's entries now backup-durable
        win = self._win.get(mid)
        if win:
            while win and next(iter(win)) <= through:
                self._retire_window(mid, next(iter(win)))

    def _retire_window(self, mid: int, index: int) -> None:
        pairs = self._win[mid].pop(index)
        win_kh = self._win_kh[mid]
        for kh, cls in pairs:
            per = win_kh.get(kh)
            if per is not None:
                per[cls] -= 1
                if per[cls] <= 0:
                    del per[cls]
                if not per:
                    del win_kh[kh]

    def _m_ack(self, ev: Event) -> None:
        """Acked-write durability (§3.2.2/§B.1): a 1-RTT ack requires the
        op recorded at all f witnesses, or already covered by a backup
        sync.  Reads and slow-path (>=2 RTT) acks carry no fast-path
        durability claim."""
        if ev.args["rtts"] != 1 or self._mode != "curp" or self._f <= 0:
            return
        where = self._exec_at.pop(ev.rpc, None)
        accepts = self._accepts.pop(ev.rpc, None)
        if where is None:
            return   # read (no execute event): nothing to prove
        mid, index = where
        n_acc = len(accepts) if accepts else 0
        if n_acc >= self._f:
            return
        if index <= self._synced_through.get(mid, 0):
            return   # backup-synced before the ack: durable without witnesses
        self._breach(
            "durability",
            f"1-RTT ack with {n_acc}/{self._f} witness records and log "
            f"index {index} > synced_through "
            f"{self._synced_through.get(mid, 0)}", rpc=ev.rpc, ev=ev)

    def _m_fence(self, ev: Event) -> None:
        a = ev.args
        shard, epoch, wlv = a["shard"], a["epoch"], a["wlv"]
        self._mid_shard[ev.actor] = shard
        prev = self._shard_cfg.get(shard)
        if a["reason"] != "init" and prev is not None:
            pe, pw = prev
            if epoch <= pe:
                self._breach(
                    "epoch",
                    f"{a['reason']} fence on shard {shard} did not advance "
                    f"the epoch ({pe} -> {epoch})", rpc=a.get("mid"), ev=ev)
            if wlv < pw:
                self._breach(
                    "epoch",
                    f"{a['reason']} fence on shard {shard} regressed the "
                    f"witness list version ({pw} -> {wlv})",
                    rpc=a.get("mid"), ev=ev)
        self._shard_cfg[shard] = (max(epoch, prev[0] if prev else epoch),
                                  max(wlv, prev[1] if prev else wlv))

    def _m_freeze(self, ev: Event) -> None:
        for slot in self._ev_slots(ev):
            self._moving[slot] = ev.seq

    def _m_handover(self, ev: Event) -> None:
        for slot in self._ev_slots(ev):
            self._moving.pop(slot, None)

    @staticmethod
    def _ev_slots(ev: Event):
        if "slots" in ev.args:
            return tuple(ev.args["slots"])
        return (ev.args["slot"],)

    def _m_intent_tick(self, ev: Event) -> None:
        """Intent liveness: the OLDEST undecided prepare must be decided
        within ``intent_bound`` journal events (a leaked intent wedges its
        keys forever — reads and writes under it draw TXN_PENDING)."""
        if not self._intents:
            return
        (txn, mid), seq0 = next(iter(self._intents.items()))
        if ev.seq - seq0 > self.intent_bound \
                and (txn, mid) not in self._intents_flagged:
            self._intents_flagged.add((txn, mid))
            self._breach(
                "intent",
                f"txn {txn!r} intent at master {mid} undecided after "
                f"{ev.seq - seq0} events (bound {self.intent_bound})",
                rpc=txn if isinstance(txn, tuple) else None, ev=ev)

    def _cap(self, od: OrderedDict) -> None:
        """Bound a per-rpc state dict: evict oldest entries (ops that never
        acked — give-ups, crash casualties — would otherwise accumulate)."""
        while len(od) > self.state_cap:
            od.popitem(last=False)

    # --------------------------------------------------------------- breaches
    def _has(self, monitor: str) -> bool:
        return any(b.monitor == monitor for b in self.breaches)

    def fired_monitors(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for b in self.breaches:
            if b.monitor not in seen:
                seen.append(b.monitor)
        return tuple(seen)

    def _breach(self, monitor: str, reason: str, rpc, ev: Optional[Event]) -> None:
        if ev is not None:
            seq, t = ev.seq, ev.t
        else:
            seq = self.journal.seq
            t = (self.journal.clock() if self.journal.clock is not None
                 else float(seq))
        b = Breach(monitor=monitor, seq=seq, t=t, rpc=rpc, reason=reason)
        self.breaches.append(b)
        if self.blackbox is None:
            self.blackbox = self._dump(b)

    def _dump(self, breach: Breach) -> Dict[str, Any]:
        """Seal the black box: last-N journal events, metrics snapshot,
        drained trace slice, and the replay coordinates.  Everything is
        plain JSON-able data — this is what an operator (or ``replay``)
        gets when the flight recorder is pulled after a crash."""
        from ..core.telemetry import get_registry

        box: Dict[str, Any] = {
            "breach": breach.to_jsonable(),
            "journal": self.journal.to_jsonable(last_n=self.blackbox_last_n),
            "journal_dropped": self.journal.dropped,
            "journal_seq": self.journal.seq,
            "metrics": get_registry().snapshot(),
            "chaos": {s: getattr(self.chaos, s)
                      for s in self.chaos._SWITCHES},
            "run_args": _json_safe(self.run_args),
        }
        tracer = getattr(self.sim, "tracer", None) if self.sim else None
        if tracer is not None:
            now = self.sim.now if self.sim is not None else breach.t
            box["trace_spans_sealed"] = tracer.drain(now, status="breach-dump")
            box["trace"] = tracer.export_chrome()
        return box

    # --------------------------------------------------------------- teardown
    def finalize(self, now: float) -> "Watchdog":
        """End-of-run sweep: flush the windowed checker's tail (teardown
        maybe-ops included) and record its verdict.  Idempotent."""
        if self.finalized:
            return self
        self.finalized = True
        if self.checker is not None:
            self.checker.finish()
            self._check_linearizability()
        return self

    @property
    def ok(self) -> bool:
        return not self.breaches

    def report(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "breaches": [b.to_jsonable() for b in self.breaches],
            "monitors_fired": list(self.fired_monitors()),
            "events_seen": self.events_seen,
            "journal_dropped": self.journal.dropped,
            "checker": self.checker.stats() if self.checker else None,
            "chaos_active": list(self.chaos.active()),
        }


# ---------------------------------------------------------------------------
# Watched scenario runner + deterministic replay
# ---------------------------------------------------------------------------
def run_watched_scenario(scenario: str = "openloop",
                         chaos: Optional[ChaosConfig] = None,
                         watchdog_kwargs: Optional[Dict[str, Any]] = None,
                         **kwargs):
    """Run one sim scenario with a fresh watchdog attached.

    ``scenario`` selects the harness: ``"openloop"``
    (run_openloop_scenario), ``"closed"`` (run_scenario) or ``"sharded"``
    (run_sharded_scenario); ``kwargs`` pass through unchanged.  Returns
    ``(result, watchdog)``; the watchdog records the scenario coordinates,
    so ``replay(watchdog)`` re-runs it deterministically — same seed, same
    chaos switches with fresh latches — and must reproduce the same breach
    sequence bit-for-bit (Breach.key()).
    """
    from . import curp_sim

    runners = {
        "openloop": curp_sim.run_openloop_scenario,
        "closed": curp_sim.run_scenario,
        "sharded": curp_sim.run_sharded_scenario,
    }
    if scenario not in runners:
        raise ValueError(f"unknown scenario {scenario!r}; "
                         f"one of {sorted(runners)}")
    wd = Watchdog(chaos=chaos.clone() if chaos is not None else None,
                  **(watchdog_kwargs or {}))
    # Snapshot the kwargs BEFORE the run: workload objects carry RNG state
    # the run mutates, so replaying with the live objects would diverge.
    wd.run_args = {
        "scenario": scenario,
        "kwargs": copy.deepcopy(kwargs),
        "chaos": {s: getattr(wd.chaos, s) for s in wd.chaos._SWITCHES},
        "watchdog_kwargs": dict(watchdog_kwargs or {}),
    }
    result = runners[scenario](watchdog=wd, **kwargs)
    return result, wd


def replay(wd: Watchdog):
    """Deterministically re-run a watched scenario from its black-box
    coordinates.  Returns ``(watchdog2, identical)`` where ``identical``
    means the replay produced the exact same breach sequence (monitor,
    event seq, sim time, RIFL id, reason) as the original — the property
    that makes a watchdog report debuggable offline."""
    if wd.run_args is None:
        raise ValueError("watchdog was not started by run_watched_scenario; "
                         "nothing to replay")
    ra = wd.run_args
    chaos = ChaosConfig(**ra["chaos"])
    _result, wd2 = run_watched_scenario(
        scenario=ra["scenario"], chaos=chaos,
        watchdog_kwargs=ra["watchdog_kwargs"],
        **copy.deepcopy(ra["kwargs"]),
    )
    identical = [b.key() for b in wd2.breaches] == \
        [b.key() for b in wd.breaches]
    return wd2, identical


# ---------------------------------------------------------------------------
# Intent-leak harness (instant transport: the 2PC machinery lives there)
# ---------------------------------------------------------------------------
def run_intent_leak_scenario(chaos: Optional[ChaosConfig] = None,
                             n_shards: int = 2, f: int = 1,
                             intent_bound: int = 300,
                             pump_ops: Optional[int] = None,
                             seed: int = 0):
    """Cross-shard 2PC against an instant ShardedCluster with the watchdog
    attached.  With ``chaos.leak_intent`` the coordinator is crashed after
    sending the FIRST decide leg (second leg's intent never decided) and —
    unlike the clean crash suites — nobody runs recovery resolution; the
    harness then pumps unrelated traffic until the intent monitor's event
    bound is exceeded.  Clean runs decide every intent and pump the same
    traffic: zero breaches expected.  Returns the watchdog."""
    from ..core.shard import ShardedCluster
    from ..core.txn import STAGE_DECIDE, CoordinatorCrash

    chaos = chaos.clone() if chaos is not None else ChaosConfig()
    cluster = ShardedCluster(n_shards=n_shards, f=f, seed=seed)
    wd = Watchdog(chaos=chaos, intent_bound=intent_bound)
    wd.attach_cluster(cluster)
    session = cluster.new_client()

    # two keys on different shards => a genuine 2-leg 2PC
    k0 = "leak-a0"
    k1 = next(f"leak-b{i}" for i in range(256)
              if cluster.shard_of(f"leak-b{i}") != cluster.shard_of(k0))

    def crash_hook(stage, shard_id, idx):
        if stage == STAGE_DECIDE and idx == 1 \
                and not chaos.fired("leak_intent"):
            chaos.fire("leak_intent")
            raise CoordinatorCrash(
                f"chaos: coordinator died before decide leg {idx}")

    hook = crash_hook if chaos.leak_intent else None
    try:
        cluster.txn(session, writes=[(k0, "v0"), (k1, "v1")],
                    on_message=hook)
    except CoordinatorCrash:
        pass

    # Unrelated traffic: every op journals events, so this advances the
    # intent monitor's event clock well past the bound.
    n_pump = pump_ops if pump_ops is not None else 2 * intent_bound
    for i in range(n_pump):
        cluster.update(session, session.op_set(f"pump{i % 64}", i))
    wd.finalize(0.0)
    return wd


__all__ = [
    "CHAOS_MONITOR", "Breach", "ChaosConfig", "Watchdog",
    "replay", "run_intent_leak_scenario", "run_watched_scenario",
]
