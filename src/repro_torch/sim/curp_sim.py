"""Timed CURP cluster simulation: clients, master, witnesses, backups,
coordinator — with crash injection and recovery, driving the *same*
repro_torch.core state machines as the unit harness.

Modes (the four lines of the paper's Figs. 5/6):
  * "curp"         — full protocol: witness records + batched async syncs.
  * "sync"         — original primary-backup: respond after backup sync
                      (+ §4.4 polling waste at the master).
  * "async"        — respond before sync, NO witnesses (fast but unsafe;
                      the paper's "Async" comparison).
  * "unreplicated" — no backups, no witnesses.

Sharded mode (§4, Fig. 3): ``run_sharded_scenario`` builds N independent
shard groups — each with its own master, witness group, and backups — in one
simulated network.  Clients route every op through the same KeyRouter the
protocol layer uses, so per-shard witnesses only ever see their own
partition's key hashes, and a crash on one shard replays only that shard.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.backup import Backup
from ..core.client import ClientSession, Decision, decide
from ..core.config import HeartbeatDetector
from ..core.master import DUP, ERROR, FAST, SYNCED, Master
from ..core.overload import (
    AdmissionQueue,
    ArmorConfig,
    CircuitBreaker,
    DegradeLevel,
    degrade_level,
)
from ..core.shard import KeyRouter, ShardedClientSession, SlotRouter
from ..core.telemetry import get_registry
from ..core.types import ExecResult, Op, OpType, RecordStatus
from ..core.witness import Witness

from .linearizability import check_linearizable_strict
from .network import Network, Node, Sim
from .params import DEFAULT, SimParams


# --------------------------------------------------------------------------
# Sim-level message envelopes
# --------------------------------------------------------------------------
@dataclass
class MUpdate:
    src: "SimClient"
    op: Op
    wlv: int
    acks: tuple


@dataclass
class MUpdateResp:
    rpc_id: tuple
    result: ExecResult


@dataclass
class MRead:
    src: "SimClient"
    op: Op


@dataclass
class MRecord:
    src: "SimClient"
    master_id: int
    op: Op
    attempt: int = 0


@dataclass
class MRecordResp:
    rpc_id: tuple
    status: RecordStatus
    witness: "SimWitness"
    attempt: int = 0


@dataclass
class MSyncReq:
    src: "SimClient"
    rpc_id: tuple


@dataclass
class MSyncResp:
    rpc_id: tuple


@dataclass
class MBackupSync:
    src: "SimMaster"
    req: Any
    through: int = -1    # per-op sync tag (sync mode only)


@dataclass
class MBackupAck:
    src: "SimBackup"
    ok: bool
    through: int = -1


@dataclass
class MGc:
    src: "SimMaster"
    entries: tuple


@dataclass
class MGcResp:
    stale: tuple


@dataclass
class MShedResp:
    """Explicit load-shed reply (admission queue full / client throttled).

    Sent at DELIVERY time, before any service cost — the fail-fast half of
    queue-based load leveling.  Clients back off on it instead of timing
    out and retrying into the same overload."""
    rpc_id: tuple
    kind: str           # "QUEUE" | "THROTTLE"


@dataclass
class MHeartbeat:
    shard_id: int
    master_id: int


@dataclass
class MDoSync:      # master self-message: issue the batched backup sync
    pass


@dataclass
class MDoGc:        # master self-message: issue witness gc after a sync
    entries: tuple


# --------------------------------------------------------------------------
# Actors
# --------------------------------------------------------------------------
class SimWitness(Node):
    def __init__(self, sim, net, params, core: Witness, name: str,
                 armor: Optional[ArmorConfig] = None) -> None:
        super().__init__(sim, name)
        self.net = net
        self.p = params
        self.core = core
        self.admission = armor.make_witness_queue() if armor else None

    def deliver(self, msg) -> None:
        if self.admission is not None and isinstance(msg, MRecord) \
                and not self.crashed:
            if not self.admission.admit():
                # Shed at delivery (no service cost): reply REJECTED so the
                # client falls back to the 2-RTT sync path — correct, just
                # slower, which is exactly the graceful-degradation contract.
                if self.sim.tracer is not None:
                    self.sim.tracer.instant(msg.op.rpc_id, "witness_shed",
                                            self.sim.now, actor=self.name)
                self.net.send(msg.src, MRecordResp(
                    msg.op.rpc_id, RecordStatus.REJECTED, self, msg.attempt
                ))
                return
            super().deliver(msg)
            return
        super().deliver(msg)

    def _run(self, msg) -> None:
        if self.admission is not None and isinstance(msg, MRecord):
            self.admission.release()
        super()._run(msg)

    def service_time(self, msg) -> float:
        if isinstance(msg, MRecord):
            return self.p.witness_service_us
        if isinstance(msg, MGc):
            return self.p.witness_gc_service_us
        return 0.2

    def handle(self, msg) -> None:
        tr = self.sim.tracer
        if isinstance(msg, MRecord):
            st = self.core.record(
                msg.master_id, msg.op.key_hashes(), msg.op.rpc_id, msg.op
            )
            if tr is not None:
                # The handler runs at service completion; the server span
                # covers [now - svc, now].
                svc = self.service_time(msg)
                tr.span(msg.op.rpc_id, "witness_record", self.sim.now - svc,
                        svc, actor=self.name, status=st.name.lower())
            self.net.send(
                msg.src, MRecordResp(msg.op.rpc_id, st, self, msg.attempt)
            )
        elif isinstance(msg, MGc):
            resp = self.core.gc(msg.entries)
            if tr is not None:
                svc = self.service_time(msg)
                tr.span(("gc", self.name), "witness_gc", self.sim.now - svc,
                        svc, actor=self.name,
                        args={"entries": len(msg.entries),
                              "stale": len(resp.stale_requests)}, force=True)
            self.net.send(msg.src, MGcResp(resp.stale_requests))


class SimBackup(Node):
    def __init__(self, sim, net, params, core: Backup, name: str,
                 service_us: Optional[float] = None) -> None:
        super().__init__(sim, name)
        self.net = net
        self.p = params
        self.core = core
        self._service = service_us if service_us is not None else params.backup_service_us

    def service_time(self, msg) -> float:
        return self._service

    def handle(self, msg) -> None:
        if isinstance(msg, MBackupSync):
            resp = self.core.handle_sync(msg.req)
            self.net.send(msg.src, MBackupAck(self, resp.ok, msg.through))


class SimMaster(Node):
    def __init__(self, sim, net, params, core: Master, name: str,
                 mode: str, backups: List[SimBackup],
                 witnesses: List[SimWitness],
                 armor: Optional[ArmorConfig] = None) -> None:
        super().__init__(sim, name)
        self.net = net
        self.p = params
        self.core = core
        self.mode = mode
        self.backups = backups
        self.witnesses = witnesses
        # Responses withheld until the log is synced through some index:
        self._withheld: List[Tuple[int, Node, Any]] = []
        self._sync_acks_needed = 0
        # sync mode: per-op replication RPCs, multiple outstanding.
        self._sync_issued_through = 0
        self._per_op_acks: Dict[int, int] = {}
        self._sync_scheduled = False   # an MDoSync is queued but not yet run
        self.stats = {"updates": 0, "reads": 0}
        # --- traffic armor (core.overload) --------------------------------
        self.armor = armor
        self.admission = armor.make_queue() if armor else None
        self.throttle = armor.make_throttle() if armor else None
        self.degrade = DegradeLevel.NORMAL
        self._deferred_gc: List[tuple] = []
        self._degrade_retry_scheduled = False
        # Client-RPC queue depth, tracked with or without armor so the
        # no-armor baseline's unbounded growth is measurable.
        self.qdepth = 0
        self.max_qdepth = 0
        self.armor_stats = {"shed_queue": 0, "shed_throttle": 0,
                            "deferred_syncs": 0, "deferred_gcs": 0}
        # --- flight recorder ----------------------------------------------
        # Measured client-RPC service times feed the adaptive admission
        # bound (ArmorConfig.adaptive) and the fig_obs stage attribution.
        self._h_service = get_registry().histogram("sim.master_service_us")
        self._aimd = (armor.make_aimd(self.admission, self._h_service)
                      if armor is not None and self.admission is not None
                      else None)
        self._aimd_pending = 0
        self._sync_t0 = 0.0
        self._sync_n = 0

    # -- admission (queue-based load leveling; fail fast at delivery) ---------
    def deliver(self, msg) -> None:
        if isinstance(msg, (MUpdate, MRead)) and not self.crashed:
            if self.admission is not None:
                if not self.admission.admit():
                    self.armor_stats["shed_queue"] += 1
                    if self.sim.tracer is not None:
                        self.sim.tracer.instant(
                            msg.op.rpc_id, "master_shed", self.sim.now,
                            actor=self.name, args={"reason": "QUEUE"})
                    self.net.send(msg.src,
                                  MShedResp(msg.op.rpc_id, "QUEUE"))
                    return
                if self.throttle is not None and not self.throttle.allow(
                        msg.op.rpc_id[0], self.sim.now):
                    self.admission.release()
                    self.armor_stats["shed_throttle"] += 1
                    if self.sim.tracer is not None:
                        self.sim.tracer.instant(
                            msg.op.rpc_id, "master_shed", self.sim.now,
                            actor=self.name, args={"reason": "THROTTLE"})
                    self.net.send(msg.src,
                                  MShedResp(msg.op.rpc_id, "THROTTLE"))
                    return
            self.qdepth += 1
            if self.qdepth > self.max_qdepth:
                self.max_qdepth = self.qdepth
        super().deliver(msg)

    def _run(self, msg) -> None:
        if isinstance(msg, (MUpdate, MRead)):
            self.qdepth -= 1
            self._h_service.record(self.service_time(msg))
            if self.admission is not None:
                self.admission.release()
                self.degrade = degrade_level(
                    self.admission.frac(), self.degrade,
                    self.armor.degrade_hi, self.armor.degrade_lo,
                )
                if self._aimd is not None:
                    self._aimd_pending += 1
                    if self._aimd_pending >= self.armor.adaptive_interval_ops:
                        self._aimd_pending = 0
                        self._aimd.tick()
        super()._run(msg)

    # -- service costs ----------------------------------------------------------
    def service_time(self, msg) -> float:
        p = self.p
        if isinstance(msg, MUpdate):
            # Per-command pricing (Fig. 10): the op type's execution-cost
            # delta rides on the base update cost.
            c = p.master_update_cost_us + p.op_cost_extra_us.get(
                msg.op.op_type.name, 0.0
            )
            if self.mode == "sync":
                # Original primary-backup: the per-op sync RPCs are issued
                # inside the update handler (no batching).  The §4.4 polling
                # waste is charged when the acks return (occupy), so it burns
                # master CPU without artificially delaying this op's release.
                c += len(self.backups) * p.repl_send_cost_us
            return c
        if isinstance(msg, MRead):
            return p.master_read_cost_us
        if isinstance(msg, MBackupAck):
            return p.repl_ack_cost_us
        if isinstance(msg, MSyncReq):
            return p.sync_rpc_cost_us
        if isinstance(msg, MGcResp):
            return p.gc_resp_cost_us
        if isinstance(msg, MDoSync):
            return len(self.backups) * p.repl_send_cost_us
        if isinstance(msg, MDoGc):
            return len(self.witnesses) * p.gc_send_cost_us
        return 0.2

    # -- logic --------------------------------------------------------------------
    def handle(self, msg) -> None:
        tr = self.sim.tracer
        if isinstance(msg, MUpdate):
            self.stats["updates"] += 1
            wd = self.sim.watchdog
            commutes = None
            acks = msg.acks
            if wd is not None and wd.chaos.any():
                ch = wd.chaos
                if ch.force_commute:
                    # Chaos: lie to the master — every op "commutes", so a
                    # genuinely conflicting op rides the 1-RTT fast path
                    # inside an unsynced window that cannot replay (§3.2.2
                    # violated; the commutativity monitor must notice).
                    commutes = True
                if ch.rifl_rollback and not ch.fired("rifl_rollback"):
                    cid = msg.op.rpc_id[0]
                    if self.core.rifl.acked_frontier(cid) > 0 \
                            and self.core.rifl.check_duplicate(
                                msg.op.rpc_id) is None:
                        # Chaos: regress one client's applied ack frontier
                        # (exactly-once bookkeeping corrupted).  This
                        # message's piggybacked acks are dropped too —
                        # apply_client_acks would otherwise restore the
                        # frontier before the execute event journals it.
                        ch.fire("rifl_rollback")
                        self.core.rifl._acked_below[cid] = 0
                        acks = ()
            verdict, result = self.core.handle_update(
                msg.op, msg.wlv, acks, now=self.sim.now, commutes=commutes
            )
            if tr is not None:
                svc = self.service_time(msg)
                tr.span(msg.op.rpc_id, "master_update", self.sim.now - svc,
                        svc, actor=self.name, status=verdict)
            resp = MUpdateResp(msg.op.rpc_id, result)
            if verdict == ERROR:
                self.net.send(msg.src, resp)
                return
            withhold = (self.mode == "sync" and not result.synced
                        and verdict != DUP) or (verdict == SYNCED)
            if self.mode == "unreplicated":
                withhold = False
            if withhold:
                self._withheld.append((len(self.core.log), msg.src, resp))
                self.core.want_sync = True
            else:
                self.net.send(msg.src, resp)
            if self.mode == "sync":
                # Sync RPCs depart at handler end (their cost is already in
                # this handler's service time).
                self._begin_sync_inline()
            else:
                self._maybe_sync()

        elif isinstance(msg, MRead):
            self.stats["reads"] += 1
            verdict, result = self.core.handle_read(msg.op, now=self.sim.now)
            wd = self.sim.watchdog
            if wd is not None and wd.chaos.corrupt_value and result.ok \
                    and result.value is not None \
                    and not wd.chaos.fired("corrupt_value"):
                # Chaos: return a value nobody ever wrote — only the
                # windowed linearizability checker can catch this.
                wd.chaos.fire("corrupt_value")
                result = dataclasses.replace(result, value="~corrupted~")
            if tr is not None:
                svc = self.service_time(msg)
                tr.span(msg.op.rpc_id, "master_read", self.sim.now - svc,
                        svc, actor=self.name, status=verdict)
            resp = MUpdateResp(msg.op.rpc_id, result)
            if verdict == SYNCED and self.mode != "unreplicated":
                self._withheld.append((len(self.core.log), msg.src, resp))
                self.core.want_sync = True
                self._maybe_sync()
            else:
                self.net.send(msg.src, resp)

        elif isinstance(msg, MSyncReq):
            rec = self.core.rifl.check_duplicate(msg.rpc_id)
            if rec is not None and rec.synced:
                self.net.send(msg.src, MSyncResp(msg.rpc_id))
            else:
                self._withheld.append(
                    (len(self.core.log), msg.src, MSyncResp(msg.rpc_id))
                )
                self.core.want_sync = True
                self._maybe_sync()

        elif isinstance(msg, MDoSync):
            self._sync_scheduled = False
            req = self.core.begin_sync()
            if req is None:
                return
            self._sync_t0 = self.sim.now - self.service_time(msg)
            self._sync_n = len(req.entries)
            if not self.backups:     # unreplicated: trivially synced
                gc_entries = self.core.complete_sync()
                if tr is not None:
                    tr.span(("sync", self.name), "master_sync",
                            self._sync_t0, self.sim.now - self._sync_t0,
                            actor=self.name,
                            args={"entries": self._sync_n}, force=True)
                self._release(self.core.synced_index)
                return
            self._sync_acks_needed = len(self.backups)
            for b in self.backups:
                self.net.send(b, MBackupSync(self, req), size_bytes=2048)

        elif isinstance(msg, MBackupAck):
            if self.mode == "sync":
                if msg.through in self._per_op_acks and msg.ok:
                    self._per_op_acks[msg.through] -= 1
                    if self._per_op_acks[msg.through] == 0:
                        del self._per_op_acks[msg.through]
                        self.core.force_synced_through(msg.through)
                        self._release(self.core.synced_index)
                        # §4.4: polling wasted while this sync was in flight.
                        self.occupy(self.p.sync_poll_waste_us)
                return
            if self.core.sync_in_progress is None:
                return
            if not msg.ok:
                self.core.abort_sync()
                return
            self._sync_acks_needed -= 1
            if self._sync_acks_needed == 0:
                gc_entries = self.core.complete_sync()
                if tr is not None:
                    # One span per batched sync CYCLE (begin_sync -> last
                    # backup ack), forced: syncs batch many rpc ids.
                    tr.span(("sync", self.name), "master_sync",
                            self._sync_t0, self.sim.now - self._sync_t0,
                            actor=self.name,
                            args={"entries": self._sync_n}, force=True)
                self._release(self.core.synced_index)
                if self.witnesses and gc_entries:
                    if self.degrade is DegradeLevel.DEFER_SLOW:
                        # Degraded: witness gc is slow-path work — batch it
                        # up for when the queue drains (records age a bit
                        # longer; §4.5 suspicion handles true garbage).
                        self._deferred_gc.extend(gc_entries)
                        self.armor_stats["deferred_gcs"] += 1
                    else:
                        self.deliver(MDoGc(gc_entries))
                self._maybe_sync()   # more batched work may be pending

        elif isinstance(msg, MDoGc):
            for w in self.witnesses:
                self.net.send(w, MGc(self, msg.entries), size_bytes=512)

        elif isinstance(msg, MGcResp):
            # §4.5: retry suspected uncollected garbage (RIFL will filter).
            for op in msg.stale:
                self.core.handle_update(
                    op, self.core.witness_list_version, (), now=self.sim.now
                )
            self.core.want_sync = self.core.want_sync or bool(msg.stale)
            self._maybe_sync()

    def _begin_sync_inline(self) -> None:
        """Sync mode: issue THIS op's replication RPCs immediately (original
        RAMCloud: 3 replication RPCs per write, no cross-client batching)."""
        from ..core.types import BackupSyncReq

        through = len(self.core.log)
        if through == self._sync_issued_through:
            return
        req = BackupSyncReq(
            master_id=self.core.master_id,
            epoch=self.core.epoch,
            from_index=self._sync_issued_through,
            entries=tuple(
                (e.op, e.result)
                for e in self.core.log[self._sync_issued_through:through]
            ),
        )
        self._sync_issued_through = through
        self._per_op_acks[through] = len(self.backups)
        self.core.want_sync = False
        for b in self.backups:
            self.net.send(b, MBackupSync(self, req, through), size_bytes=2048)

    def _maybe_sync(self) -> None:
        if self._sync_scheduled:
            return
        if self.mode == "unreplicated":
            # No backups: syncs are a no-op; still release withheld (none).
            if self.core.want_sync:
                self._sync_scheduled = True
                self.deliver(MDoSync())
            return
        if self.degrade is not DegradeLevel.DEFER_SLOW and self._deferred_gc:
            # Pressure lifted: flush the witness gc batched up while degraded.
            entries = tuple(self._deferred_gc)
            self._deferred_gc = []
            self.deliver(MDoGc(entries))
        if self.core.want_sync and self.core.sync_in_progress is None:
            if self.degrade is DegradeLevel.DEFER_SLOW and not self._withheld:
                # Graceful degradation: the batch-full sync is deferrable
                # slow-path work (nobody's reply is gated on it — conflict
                # and read syncs withhold responses and are never deferred).
                # The 1-RTT witness-backed fast path stays fully alive; the
                # unsynced window just grows until pressure drops.
                self.armor_stats["deferred_syncs"] += 1
                if not self._degrade_retry_scheduled:
                    # Bounded staleness: re-check even if traffic stops.
                    self._degrade_retry_scheduled = True

                    def retry() -> None:
                        self._degrade_retry_scheduled = False
                        self._maybe_sync()
                    self.sim.after(2 * self.p.rpc_timeout_us, retry)
                return
            self._sync_scheduled = True
            self.deliver(MDoSync())

    def _release(self, synced_through: int) -> None:
        still = []
        for idx, dst, resp in self._withheld:
            if idx <= synced_through:
                if isinstance(resp, MUpdateResp):
                    resp = MUpdateResp(
                        resp.rpc_id,
                        dataclasses.replace(resp.result, synced=True),
                    )
                self.net.send(dst, resp)
            else:
                still.append((idx, dst, resp))
        self._withheld = still


@dataclass
class PendingOp:
    op: Op
    is_update: bool
    t_invoke: float            # first attempt (for linearizability history)
    t_attempt: float
    master_result: Optional[ExecResult] = None
    witness_statuses: List[RecordStatus] = field(default_factory=list)
    want_witnesses: int = 0
    sync_requested: bool = False
    retries: int = 0
    done: bool = False


class SimClient(Node):
    def __init__(self, sim, net, params, session: ClientSession, name: str,
                 cluster: "SimCluster", n_ops: int,
                 op_factory: Callable[[ClientSession], Op]) -> None:
        super().__init__(sim, name)
        self.net = net
        self.p = params
        self.session = session
        self.cluster = cluster
        self.n_ops = n_ops
        self.op_factory = op_factory
        self.completed = 0
        self.latencies: List[Tuple[float, float, bool]] = []  # (lat, t, is_update)
        self.history: List[dict] = []
        self.pending: Optional[PendingOp] = None
        self.fast_completions = 0
        self.rtt2_completions = 0

    def service_time(self, msg) -> float:
        if isinstance(msg, MRecordResp):
            return 0.1   # record responses are tiny (no payload to parse)
        return self.p.client_recv_cost_us

    # -- issuing ------------------------------------------------------------------
    def start(self) -> None:
        self.sim.after(self.sim.rng.random() * 1.0, self._issue_next)

    def _issue_next(self) -> None:
        if self.completed >= self.n_ops:
            return
        op = self.op_factory(self.session)
        self.pending = PendingOp(
            op=op, is_update=op.is_update,
            t_invoke=self.sim.now, t_attempt=self.sim.now,
        )
        if self.sim.watchdog is not None:
            self.sim.watchdog.op_invoked(op.rpc_id, self.sim.now)
        self._send_attempt()

    def _send_attempt(self) -> None:
        assert self.pending is not None
        pend = self.pending
        op = pend.op
        mode = self.cluster.mode
        # Route to the owning shard (single-shard clusters route to self).
        target = self.cluster.route(op)
        master = target.master_node
        t0 = self.sim.now
        if pend.is_update and mode == "curp":
            wits = target.witness_nodes
            pend.want_witnesses = len(wits)
            pend.witness_statuses = []
            # Client serializes the extra record sends before the update RPC
            # (the measured +0.13 µs/record of §5.1).
            att = pend.retries
            for k, w in enumerate(wits):
                self.sim.at(
                    t0 + (k + 1) * self.p.client_record_send_cost_us,
                    lambda w=w, op=op, att=att: self.net.send(
                        w, MRecord(self, target.master_id, op, att)
                    ),
                )
            t0 += len(wits) * self.p.client_record_send_cost_us
        else:
            pend.want_witnesses = 0
            pend.witness_statuses = []
        t0 += self.p.client_send_cost_us
        if pend.is_update:
            msg = MUpdate(self, op, target.wlv, self.session.acks())
        else:
            msg = MRead(self, op)
        self.sim.at(t0, lambda: self.net.send(master, msg, size_bytes=256))
        # Timeout/retry.
        rpc_id, attempt = op.rpc_id, pend.retries
        self.sim.after(self.p.rpc_timeout_us,
                       lambda: self._check_timeout(rpc_id, attempt))

    def _check_timeout(self, rpc_id, attempt) -> None:
        pend = self.pending
        if pend is None or pend.done or pend.op.rpc_id != rpc_id:
            return
        if pend.retries != attempt:
            return
        pend.retries += 1
        if pend.retries > 40:
            self._record_history(pend, value=None, failed=True)
            self.pending = None
            self._issue_next()
            return
        # Refetch config (the master may have changed), then resend.
        self.sim.after(self.p.config_fetch_us, self._resend)

    def _resend(self) -> None:
        if self.pending is None or self.pending.done:
            return
        self.pending.master_result = None
        self.pending.sync_requested = False
        self.pending.t_attempt = self.sim.now
        self._send_attempt()

    # -- responses -------------------------------------------------------------------
    def handle(self, msg) -> None:
        pend = self.pending
        if pend is None or pend.done:
            return
        if isinstance(msg, MShedResp) and msg.rpc_id == pend.op.rpc_id:
            # Explicit load-shed: back off (linearly growing, jittered)
            # instead of hammering the overloaded server until timeout.
            pend.retries += 1
            if pend.retries > 40:
                self._record_history(pend, value=None, failed=True)
                self.pending = None
                self._issue_next()
                return
            delay = min(self.p.ol_shed_backoff_us * pend.retries,
                        self.p.ol_backoff_cap_us)
            delay *= 1.0 + self.p.ol_backoff_jitter * (
                2 * self.sim.rng.random() - 1)
            self.sim.after(delay, self._resend)
            return
        if isinstance(msg, MUpdateResp) and msg.rpc_id == pend.op.rpc_id:
            if not msg.result.ok:
                # Stale config (witness list version): refetch + retry.
                pend.retries += 1
                self.sim.after(self.p.config_fetch_us, self._resend)
                return
            pend.master_result = msg.result
        elif isinstance(msg, MRecordResp) and msg.rpc_id == pend.op.rpc_id:
            if msg.attempt != pend.retries:
                return  # stale response from a pre-retry witness set
            pend.witness_statuses.append(msg.status)
        elif isinstance(msg, MSyncResp) and msg.rpc_id == pend.op.rpc_id:
            if pend.master_result is None:
                return
            self._complete(pend, pend.master_result, rtts=3)
            return
        else:
            return
        self._evaluate(pend)

    def _evaluate(self, pend: PendingOp) -> None:
        if pend.master_result is None:
            return
        if not pend.is_update or self.cluster.mode != "curp":
            self._complete(pend, pend.master_result,
                           rtts=2 if pend.master_result.synced else 1)
            return
        if pend.master_result.synced:
            # Conflict path: master synced before responding — 2 RTTs, no
            # witness accepts needed (§3.2.3).
            self._complete(pend, pend.master_result, rtts=2)
            return
        if len(pend.witness_statuses) < pend.want_witnesses:
            return
        d = decide(pend.master_result, pend.witness_statuses)
        if d is Decision.COMPLETE:
            self._complete(pend, pend.master_result, rtts=1)
        elif not pend.sync_requested:
            pend.sync_requested = True
            self.sim.after(
                self.p.client_send_cost_us,
                lambda: self.net.send(
                    self.cluster.route(pend.op).master_node,
                    MSyncReq(self, pend.op.rpc_id),
                ),
            )

    def _complete(self, pend: PendingOp, result, rtts: int) -> None:
        pend.done = True
        if self.sim.watchdog is not None:
            self.sim.watchdog.journal.emit(
                "ack", actor=self.name, rpc=pend.op.rpc_id, rtts=rtts,
            )
        lat = self.sim.now - pend.t_invoke
        self.latencies.append((lat, self.sim.now, pend.is_update))
        if rtts == 1:
            self.fast_completions += 1
        else:
            self.rtt2_completions += 1
        self.session.mark_completed(pend.op.rpc_id)
        self._record_history(pend, value=result.value if result else None)
        self.completed += 1
        self.cluster.on_completion(self.sim.now)
        self.pending = None
        self._issue_next()

    def _record_history(self, pend: PendingOp, value, failed: bool = False) -> None:
        entry = {
            "client": self.session.client_id,
            "op": pend.op,
            "invoke": pend.t_invoke,
            "complete": None if failed else self.sim.now,
            "value": value,
            "failed": failed,
        }
        wd = self.sim.watchdog
        if wd is not None:
            (wd.op_failed if failed else wd.op_completed)(entry)
        self.history.append(entry)


# --------------------------------------------------------------------------
# Cluster + scenario
# --------------------------------------------------------------------------
class SimCluster:
    def __init__(self, sim: Sim, net: Network, params: SimParams, mode: str,
                 f: int, backup_service_us: Optional[float] = None,
                 armor: Optional[ArmorConfig] = None) -> None:
        self.sim = sim
        self.net = net
        self.p = params
        self.mode = mode
        self.f = f
        self.armor = armor
        self.epoch = 0
        self.wlv = 0
        self._id = 0

        use_backups = mode in ("curp", "sync", "async")
        use_witnesses = mode == "curp"
        self.backup_cores = [Backup(self._next_id()) for _ in range(f)] \
            if use_backups else []
        self.backup_nodes = [
            SimBackup(sim, net, params, b, f"backup{i}",
                      service_us=backup_service_us)
            for i, b in enumerate(self.backup_cores)
        ]
        self.master_id = self._next_id()
        core_master = Master(
            self.master_id, epoch=0,
            sync_batch=(1 if mode == "sync" else params.sync_batch),
            hot_key_window=params.hot_key_window_us,
        )
        self.witness_cores = [
            Witness(params.witness_sets, params.witness_ways,
                    class_budget=params.witness_class_budget)
            for _ in range(f)
        ] if use_witnesses else []
        self.witness_nodes = [
            SimWitness(sim, net, params, w, f"witness{i}", armor=armor)
            for i, w in enumerate(self.witness_cores)
        ]
        for w in self.witness_cores:
            w.start(self.master_id)
        self.master_node = SimMaster(
            sim, net, params, core_master, "master", mode,
            self.backup_nodes, self.witness_nodes, armor=armor,
        )
        self.clients: List[SimClient] = []
        self.completions: List[float] = []
        self.recovery_report: Optional[dict] = None
        # Optional key-ownership filter installed on every master this
        # cluster creates (incl. post-recovery ones); the sharded wrapper
        # uses it for timed slot migration (NOT_OWNER on frozen slots).
        self.owned_filter = None
        # Heartbeat failover (SimCoordinator.watch wires these):
        self.coordinator: Optional["SimCoordinator"] = None
        self.hb_shard_id: Optional[int] = None
        self._recovering = False
        self._detect_source = "harness"
        self.master_nodes_retired: List[SimMaster] = []  # armor stats survive failover
        # Shard index under an attached watchdog (ShardedSimCluster attach
        # renumbers; single clusters are shard 0).
        self.wd_shard = 0

    def _next_id(self) -> int:
        self._id += 1
        return self._id

    def route(self, op: Op) -> "SimCluster":
        """Single-master cluster: every key lives here."""
        return self

    def on_completion(self, t: float) -> None:
        self.completions.append(t)

    def set_owned_filter(self, fn) -> None:
        """Install a key-ownership predicate on the current AND every future
        master core (timed migration: frozen/moved slots draw NOT_OWNER)."""
        self.owned_filter = fn
        self.master_node.core.owned_partition = fn

    # -- heartbeat failover (SimCoordinator-driven) -----------------------------
    def attach_heartbeat(self, shard_id: int,
                         coordinator: "SimCoordinator") -> None:
        self.coordinator = coordinator
        self.hb_shard_id = shard_id
        self._start_heartbeat_loop(self.master_node)

    def _start_heartbeat_loop(self, node: SimMaster) -> None:
        """Self-rescheduling beat from ``node`` over the (lossy, jittery)
        timed transport.  The loop dies silently with its master: beats just
        stop, and only the coordinator's miss-count detector notices."""
        def beat() -> None:
            if node.crashed or node is not self.master_node:
                return
            self.net.send(self.coordinator,
                          MHeartbeat(self.hb_shard_id, self.master_id),
                          size_bytes=32)
            self.sim.after(self.p.heartbeat_interval_us, beat)
        # Desynchronize shard beats slightly.
        self.sim.after(self.sim.rng.random() * self.p.heartbeat_interval_us,
                       beat)

    def begin_failover(self, source: str) -> None:
        """Entry point for DETECTED failures (heartbeat silence): run the
        standard recovery path exactly once."""
        if self._recovering:
            return
        self._recovering = True
        self._detect_source = source
        self._recover()

    # -- crash + recovery (timed mirror of core.recovery) -------------------------
    def crash_master_at(self, t: float) -> None:
        self.sim.at(t, self._crash)

    def fail_master_at(self, t: float) -> None:
        """Kill the master SILENTLY: no harness-scheduled recovery.  The
        node stops serving and stops heartbeating; failover happens iff a
        SimCoordinator's failure detector notices the silence."""
        def fail() -> None:
            self.master_node.crashed = True
        self.sim.at(t, fail)

    def _crash(self) -> None:
        self.master_node.crashed = True
        if self._recovering:
            return
        self._recovering = True
        self._detect_source = "harness"
        self.sim.after(self.p.crash_detect_us, self._recover)

    def _recover(self) -> None:
        p = self.p
        old_master_id = self.master_id
        # 1. restore from the longest backup log
        entries = max(
            (b.get_log() for b in self.backup_cores), key=len, default=()
        )
        restore_us = p.recovery_fixed_us + len(entries) * p.restore_per_entry_us
        new_master_core = Master(
            self._next_id(), epoch=self.epoch + 1,
            sync_batch=(1 if self.mode == "sync" else p.sync_batch),
            hot_key_window=p.hot_key_window_us,
        )
        new_master_core.restore_from_log(entries)

        def after_restore():
            # 2. getRecoveryData from one witness (freeze) — 1 RTT.
            reqs = ()
            if self.witness_cores:
                reqs = self.witness_cores[0].get_recovery_data(old_master_id)
            replayed = new_master_core.replay_from_witness(reqs)
            replay_us = 2 * p.one_way_delay_us + replayed * p.master_update_cost_us

            def after_replay():
                # 3. bump epoch; sync to backups — 1 RTT.
                wd = self.sim.watchdog
                if wd is not None and wd.chaos.skip_epoch_bump \
                        and not wd.chaos.fired("skip_epoch_bump"):
                    # Chaos: recover WITHOUT the §3.6 epoch fence — a zombie
                    # pre-crash master would no longer be fenced at the
                    # backups.  The fence below journals the stale epoch.
                    wd.chaos.fire("skip_epoch_bump")
                else:
                    self.epoch += 1
                new_master_core.epoch = self.epoch
                for b in self.backup_cores:
                    b.set_epoch(self.epoch)
                req = new_master_core.begin_sync()
                if req is not None:
                    for b in self.backup_cores:
                        b.handle_sync(req)
                    new_master_core.complete_sync()
                sync_us = 2 * p.one_way_delay_us + p.backup_service_us

                def finish():
                    # 4. fresh witnesses + publish config.
                    self.master_id = new_master_core.master_id
                    self.wlv += 1
                    new_master_core.witness_list_version = self.wlv
                    if self.owned_filter is not None:
                        new_master_core.owned_partition = self.owned_filter
                    self.witness_cores = [
                        Witness(p.witness_sets, p.witness_ways,
                                class_budget=p.witness_class_budget)
                        for _ in range(self.f)
                    ] if self.mode == "curp" else []
                    self.witness_nodes = [
                        SimWitness(self.sim, self.net, p, w, f"witness'{i}",
                                   armor=self.armor)
                        for i, w in enumerate(self.witness_cores)
                    ]
                    for w in self.witness_cores:
                        w.start(self.master_id)
                    # Black box survives failover: the new master/witness
                    # cores inherit the journal AFTER replay (recovery
                    # internals are not client-visible protocol steps), and
                    # the epoch/WLV fence is journaled for the monotonicity
                    # monitor (``mid`` lets the watchdog re-map shard
                    # ownership to the new master id).
                    jr = self.master_node.core.journal
                    new_master_core.journal = jr
                    new_master_core.journal_actor = \
                        f"s{self.wd_shard}m{new_master_core.master_id}"
                    for k, w in enumerate(self.witness_cores):
                        w.journal = jr
                        w.journal_actor = f"s{self.wd_shard}e{self.epoch}w{k}"
                    if jr is not None:
                        jr.emit("fence", actor=new_master_core.journal_actor,
                                shard=self.wd_shard, epoch=self.epoch,
                                wlv=self.wlv, mid=new_master_core.master_id,
                                reason="recovery")
                    self.master_nodes_retired.append(self.master_node)
                    self.master_node = SimMaster(
                        self.sim, self.net, p, new_master_core, "master'",
                        self.mode, self.backup_nodes, self.witness_nodes,
                        armor=self.armor,
                    )
                    self.recovery_report = {
                        "restored": len(entries), "replayed": replayed,
                        "recovered_at": self.sim.now,
                        "detected_by": self._detect_source,
                    }
                    self._recovering = False
                    if self.coordinator is not None:
                        # Re-arm the failure detector and start the new
                        # master's beat loop.
                        self.coordinator.detector.watch(
                            self.hb_shard_id, self.sim.now)
                        self._start_heartbeat_loop(self.master_node)
                self.sim.after(sync_us, finish)
            self.sim.after(replay_us, after_replay)
        self.sim.after(restore_us, after_restore)


class SimCoordinator(Node):
    """ConfigManager-side failure detector in the timed transport (§3.6).

    Masters heartbeat every ``heartbeat_interval_us`` over the same lossy
    network as client traffic; the HeartbeatDetector (repro_torch.core.config)
    declares a master suspect after ``heartbeat_miss_threshold`` silent
    intervals, and the coordinator then drives the shard's standard
    recovery path (backup restore -> witness freeze/replay -> epoch+WLV
    bump -> fresh witnesses) with NO harness intervention.  The epoch/WLV
    fences make a falsely-suspected (or zombie) old master harmless: its
    syncs are refused by backups and clients' stale configs draw
    WRONG_WITNESS_VERSION."""

    def __init__(self, sim, net, params, name: str = "coordinator") -> None:
        super().__init__(sim, name)
        self.net = net
        self.p = params
        self.detector = HeartbeatDetector(
            params.heartbeat_interval_us, params.heartbeat_miss_threshold
        )
        self.watched: Dict[int, SimCluster] = {}
        self.failovers: List[dict] = []
        self._loop_started = False

    def service_time(self, msg) -> float:
        return self.p.heartbeat_service_us

    def watch(self, shard_id: int, cluster: SimCluster) -> None:
        self.watched[shard_id] = cluster
        self.detector.watch(shard_id, self.sim.now)
        cluster.attach_heartbeat(shard_id, self)
        if not self._loop_started:
            self._loop_started = True
            self.sim.after(self.p.heartbeat_interval_us, self._check)

    def handle(self, msg) -> None:
        if isinstance(msg, MHeartbeat):
            self.detector.beat(msg.shard_id, self.sim.now)

    def _check(self) -> None:
        for shard_id in self.detector.check(self.sim.now):
            self.failovers.append({
                "shard": shard_id, "detected_at": self.sim.now,
            })
            self.watched[shard_id].begin_failover("heartbeat")
        self.sim.after(self.p.heartbeat_interval_us, self._check)


class ShardedSimCluster:
    """N shard groups (each a full SimCluster: master + witnesses + backups)
    sharing one simulated network, behind the protocol-layer KeyRouter.

    Exposes the same client-facing surface as SimCluster (``mode``,
    ``route``, ``on_completion``), so SimClient drives either transparently.
    """

    def __init__(self, sim: Sim, net: Network, params: SimParams, mode: str,
                 f: int, n_shards: int,
                 backup_service_us: Optional[float] = None,
                 router: Optional[SlotRouter] = None,
                 armor: Optional[ArmorConfig] = None,
                 enforce_ownership: bool = False) -> None:
        self.sim = sim
        self.net = net
        self.p = params
        self.mode = mode
        self.f = f
        self.n_shards = n_shards
        # Routing is slot-table based; pass a custom router to simulate a
        # post-migration placement (e.g. fig_migration's rebalanced skew80
        # run) — the default is the uniform round-robin map.
        self.router = router if router is not None else KeyRouter(n_shards)
        self.shards = [
            SimCluster(sim, net, params, mode, f,
                       backup_service_us=backup_service_us, armor=armor)
            for _ in range(n_shards)
        ]
        self.clients: List[SimClient] = []
        self.completions: List[float] = []
        # -- timed slot migration state ------------------------------------
        self._frozen: set = set()           # slots mid-handover (NOT_OWNER)
        self.migrations: List[dict] = []
        self._mig_session = ClientSession(client_id=1)  # migration RPC ids
        if enforce_ownership:
            # Masters answer NOT_OWNER for keys their shard does not own
            # under the LIVE map (or that are frozen mid-handover) — this is
            # what makes client-cached slot maps observable: a stale cache
            # draws NOT_OWNER instead of silently landing on the old owner.
            for i, s in enumerate(self.shards):
                s.set_owned_filter(self._make_owned_filter(i))

    def _make_owned_filter(self, shard_id: int):
        def owns(key) -> bool:
            slot = self.router.slot_of(key)
            return self.router.slot_map[slot] == shard_id \
                and slot not in self._frozen
        return owns

    # -- timed slot migration (freeze -> transfer -> flip) ---------------------
    def migrate_slot_at(self, t: float, slot: int, dst: int) -> None:
        """Schedule a live handover of ``slot`` to shard ``dst`` inside the
        timed transport: the slot freezes (donor answers NOT_OWNER; clients
        with the stale map pay the §3.6 refetch), the resident keys + live
        RIFL completions transfer after a size-dependent delay as one
        MIGRATE_IN absorb on the receiver, then the map flips (version
        bump) and the slot thaws.  Requires enforce_ownership=True."""
        self.sim.at(t, lambda: self._migrate_slot(slot, dst))

    def _migrate_slot(self, slot: int, dst: int) -> None:
        src = self.router.slot_map[slot]
        if src == dst or slot in self._frozen:
            return
        donor = self.shards[src]
        recv = self.shards[dst]
        wd = self.sim.watchdog
        if wd is not None and wd.chaos.skip_fence \
                and not wd.chaos.fired("skip_fence"):
            # Chaos: start the handover WITHOUT freezing the slot — the
            # donor keeps executing client writes mid-migration (two owners;
            # the single-owner monitor must notice).  The freeze event below
            # is still journaled: it marks where the fence SHOULD hold.
            wd.chaos.fire("skip_fence")
        else:
            self._frozen.add(slot)
        if wd is not None:
            wd.journal.emit("freeze", actor="migration", slot=slot,
                            src=src, dst=dst)
        t_freeze = self.sim.now
        n_resident = sum(
            1 for k in donor.master_node.core.store.keys()
            if self.router.slot_of(k) == slot
        )
        transfer_us = 20.0 + n_resident * self.p.restore_per_entry_us \
            + 4 * self.p.one_way_delay_us

        def transfer() -> None:
            # Freeze held while the delay elapsed, so this state is exactly
            # what was durable when clients stopped landing on the donor.
            d_core = donor.master_node.core
            kvs = tuple(
                (k, d_core.store.get(k)) for k in d_core.store.keys()
                if self.router.slot_of(k) == slot
            )
            records: Dict[tuple, tuple] = {}
            for e in d_core.log:
                op = e.op
                if op.op_type in (OpType.MIGRATE_IN, OpType.MIGRATE_OUT):
                    continue
                if not op.keys or not all(
                        self.router.slot_of(k) == slot for k in op.keys):
                    continue
                rec = d_core.rifl.check_duplicate(op.rpc_id)
                if rec is None:
                    continue
                records[(op.rpc_id, op.key_hashes())] = (
                    op.rpc_id, op.key_hashes(), rec.result
                )
            for (rpc_id, khs), result in d_core.migrated_rifl.items():
                if all(self.router.slot_of_hash(kh) == slot for kh in khs):
                    records[(rpc_id, khs)] = (rpc_id, khs, result)
            # Commit point: flip the map (bumps router.version) and thaw,
            # then absorb — all inside this one callback, so no client event
            # can interleave between the flip and the MIGRATE_IN apply.  The
            # flip must come first or the receiver's own ownership filter
            # would reject the still-frozen slot.
            self.router.assign([slot], dst)
            self._frozen.discard(slot)
            if self.sim.watchdog is not None:
                self.sim.watchdog.journal.emit(
                    "handover", actor="migration", slot=slot,
                    src=src, dst=dst,
                )
            if kvs or records:
                op = Op(
                    OpType.MIGRATE_IN,
                    tuple(k for k, _ in kvs),
                    (kvs, tuple(records.values())),
                    self._mig_session.next_rpc_id(),
                )
                r_core = recv.master_node.core
                verdict, result = r_core.handle_update(
                    op, r_core.witness_list_version, (), now=self.sim.now
                )
                assert verdict in (FAST, SYNCED, DUP), (verdict, result.error)
                # The absorb is one log entry; charge the receiver for it.
                recv.master_node.occupy(
                    1.0 + len(kvs) * self.p.restore_per_entry_us
                )
            self.migrations.append({
                "slot": slot, "src": src, "dst": dst,
                "frozen_at": t_freeze, "committed_at": self.sim.now,
                "keys_moved": len(kvs) if (kvs or records) else 0,
                "rifl_moved": len(records),
            })
        self.sim.after(transfer_us, transfer)

    def route(self, op: Op) -> SimCluster:
        sids = {self.router.shard_of(k) for k in op.keys}
        if len(sids) != 1:
            # Mirror ShardedCluster._group_for: the sim models per-shard
            # placement, so a cross-shard op must fail loudly, not land
            # whole on keys[0]'s shard.
            raise ValueError(f"op spans shards {sorted(sids)}; "
                             "sharded sim clients issue single-shard ops")
        return self.shards[sids.pop()]

    def on_completion(self, t: float) -> None:
        self.completions.append(t)

    def crash_shard_at(self, t: float, shard: int) -> None:
        """Crash exactly one shard's master; the other shards keep serving
        and none of their witnesses are frozen."""
        self.shards[shard].crash_master_at(t)

    @property
    def recovery_reports(self) -> Dict[int, dict]:
        return {i: s.recovery_report for i, s in enumerate(self.shards)
                if s.recovery_report is not None}

    def master_stats(self) -> dict:
        agg: Dict[str, int] = {}
        for s in self.shards:
            for k, v in s.master_node.core.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg


@dataclass
class ScenarioResult:
    mode: str
    f: int
    n_clients: int
    update_latencies: list
    read_latencies: list
    throughput_ops_per_sec: float
    fast_fraction: float
    completed: int
    history: list
    recovery: Optional[dict]
    master_stats: dict
    sim_time_us: float


def _spawn_clients(sim, net, p, cluster, n_clients, n_ops, op_factory):
    if op_factory is None:
        counter = [0]

        def op_factory(session: ClientSession) -> Op:
            counter[0] += 1
            return session.op_set(f"key{session.client_id}_{counter[0]}", "v")

    for i in range(n_clients):
        session = ClientSession(client_id=10_000 + i)
        c = SimClient(sim, net, p, session, f"client{i}", cluster,
                      n_ops, op_factory)
        cluster.clients.append(c)
        c.start()


def _collect_run(cluster, warmup_frac: float):
    """Aggregate client-side results after sim.run: latencies, fast/slow
    counts, history (with never-completed "maybe" ops for the checker), and
    warmup-windowed aggregate throughput."""
    upd, rd = [], []
    fast = slow = 0
    history = []
    for c in cluster.clients:
        if c.pending is not None and not c.pending.done:
            # Never completed: a "maybe" op for the linearizability checker.
            c._record_history(c.pending, value=None, failed=True)
    for c in cluster.clients:
        for lat, t, is_update in c.latencies:
            (upd if is_update else rd).append(lat)
        fast += c.fast_completions
        slow += c.rtt2_completions
        history.extend(c.history)
    completions = sorted(cluster.completions)
    completed = len(completions)
    if completed > 20:
        lo = completions[int(completed * warmup_frac)]
        hi = completions[-1]
        n_mid = completed - int(completed * warmup_frac) - 1
        thr = n_mid / (hi - lo) * 1e6 if hi > lo else 0.0
    else:
        thr = 0.0
    return upd, rd, fast, slow, history, completed, thr


def run_scenario(
    mode: str = "curp",
    f: int = 3,
    n_clients: int = 1,
    n_ops: int = 2000,
    seed: int = 0,
    params: Optional[SimParams] = None,
    op_factory: Optional[Callable[[ClientSession], Op]] = None,
    crash_at_us: Optional[float] = None,
    backup_service_us: Optional[float] = None,
    warmup_frac: float = 0.1,
    watchdog: Any = None,
) -> ScenarioResult:
    p = params or DEFAULT
    sim = Sim(seed=seed)
    net = Network(sim, p)
    cluster = SimCluster(sim, net, p, mode, f,
                         backup_service_us=backup_service_us)
    if watchdog is not None:
        watchdog.attach(sim, cluster, f=f, mode=mode)
    _spawn_clients(sim, net, p, cluster, n_clients, n_ops, op_factory)

    if crash_at_us is not None:
        cluster.crash_master_at(crash_at_us)

    sim.run(until=60_000_000.0)  # 60 simulated seconds hard cap

    upd, rd, fast, slow, history, completed, thr = _collect_run(
        cluster, warmup_frac
    )
    if watchdog is not None:
        watchdog.finalize(sim.now)
    return ScenarioResult(
        mode=mode, f=f, n_clients=n_clients,
        update_latencies=upd, read_latencies=rd,
        throughput_ops_per_sec=thr,
        fast_fraction=fast / max(1, fast + slow),
        completed=completed,
        history=history,
        recovery=cluster.recovery_report,
        master_stats=dict(cluster.master_node.core.stats),
        sim_time_us=sim.now,
    )


@dataclass
class ShardedScenarioResult:
    mode: str
    f: int
    n_shards: int
    n_clients: int
    update_latencies: list
    read_latencies: list
    throughput_ops_per_sec: float   # aggregate committed-ops/s across shards
    fast_fraction: float
    completed: int
    history: list
    recoveries: Dict[int, dict]     # shard -> recovery report (crashed shards)
    master_stats: dict              # summed across shard masters
    per_shard_stats: List[dict]
    sim_time_us: float


@dataclass
class BatchedRunResult:
    """Result of a wall-clock batched-client run (see run_batched_throughput).

    Unlike ScenarioResult this is NOT simulated time: it measures the real
    host/device cost of driving the protocol through the batched client path
    (the quantity the fast-path refactor optimizes)."""
    n_shards: int
    batch_size: int
    n_batches: int
    ops: int
    wall_s: float
    ops_per_sec: float
    fast_fraction: float
    witness_accepts: int


def run_batched_throughput(
    n_shards: int = 2,
    batch_size: int = 64,
    n_batches: int = 10,
    f: int = 3,
    seed: int = 0,
    conflict_frac: float = 0.0,
    witness_backend: str = "python",
    geometry=None,
    workload=None,
    device: str = "cuda",
) -> BatchedRunResult:
    """Drive a real ShardedCluster through the batched client path
    (update_batch) with a BatchedWorkload and measure wall-clock throughput
    + fast-path ratio.  With ``witness_backend="device"`` each shard's
    witnesses resolve every batch in one set-parallel kernel dispatch, on
    ``device`` (default "cuda", which raises without a card).

    ``workload`` must follow the BatchedWorkload interface — a ``batch(
    session) -> list[Op]`` method and a ``batch_size`` attribute.  The
    per-op workloads (UniformWriteWorkload etc.) are callables, not batch
    generators, and are rejected up front.
    """
    import time as _time

    from ..core import ShardedCluster

    from .workload import BatchedWorkload

    cluster = ShardedCluster(
        n_shards=n_shards, f=f, seed=seed, witness_backend=witness_backend,
        geometry=geometry, device=device,
    )
    session = cluster.new_client()
    wl = workload or BatchedWorkload(
        batch_size=batch_size, conflict_frac=conflict_frac, seed=seed
    )
    if not callable(getattr(wl, "batch", None)) or \
            not hasattr(wl, "batch_size"):
        raise TypeError(
            "workload must expose batch(session) and batch_size "
            "(BatchedWorkload interface); per-op workloads are not batched"
        )
    # Warm outside the timed window: two batches compile the fused
    # record/fast-path kernels, and an explicit sync on every shard compiles
    # the gc kernel at its drain-time shape — otherwise the first in-window
    # drain pays the compile and the recorded kops is cold-start noise, not
    # steady-state protocol cost.
    cluster.update_batch(session, wl.batch(session))
    cluster.update_batch(session, wl.batch(session))
    for _g in cluster.shards:
        _g.sync_now()
    fast = slow = accepts = 0
    t0 = _time.perf_counter()
    for _ in range(n_batches):
        outs = cluster.update_batch(session, wl.batch(session))
        for o in outs:
            if o.fast_path:
                fast += 1
            else:
                slow += 1
            accepts += o.witness_accepts
    wall = _time.perf_counter() - t0
    ops = n_batches * wl.batch_size
    return BatchedRunResult(
        n_shards=n_shards, batch_size=wl.batch_size, n_batches=n_batches,
        ops=ops, wall_s=wall, ops_per_sec=ops / wall if wall > 0 else 0.0,
        fast_fraction=fast / max(1, fast + slow),
        witness_accepts=accepts,
    )


# --------------------------------------------------------------------------
# Open-loop timed workload (production traffic armor)
# --------------------------------------------------------------------------
@dataclass
class _OlOp:
    """In-flight state for one open-loop op (the hub's PendingOp)."""
    op: Op
    session: ClientSession
    is_update: bool
    t_invoke: float
    shard_idx: int = 0
    attempts: int = 0
    master_result: Optional[ExecResult] = None
    witness_statuses: List[RecordStatus] = field(default_factory=list)
    want_witnesses: int = 0
    sync_requested: bool = False
    done: bool = False
    span_id: Optional[int] = None   # root trace span (tracer attached runs)


class OpenLoopDriver(Node):
    """Open-loop client tier: ops arrive on a nonhomogeneous-Poisson clock
    (diurnal ramps, flash crowds) and are issued IMMEDIATELY — no op ever
    waits for another's response, so offered load is set by the arrival
    process, not by server latency.  That is what makes overload visible:
    a closed loop self-throttles, an open loop buries a slow server.

    One hub node stands in for 10^5–10^6 client machines (sessions are
    materialized lazily per client id); its service time is ~0 so the
    client tier is never the bottleneck being measured.  Retries use
    capped exponential backoff + jitter (ol_* params); explicit MShedResp
    replies back off on a separate (linear, jittered) schedule.  The hub
    caches the slot map and pays the §3.6 config refetch only when a
    master answers NOT_OWNER, and runs one client-side circuit breaker
    per shard (armor runs only)."""

    def __init__(self, sim, net, params, cluster, workload,
                 use_breakers: bool = False,
                 record_history: bool = False) -> None:
        super().__init__(sim, "openloop-hub")
        self.net = net
        self.p = params
        self.cluster = cluster
        self.workload = workload
        self.record_history = record_history
        self.sessions: Dict[int, ClientSession] = {}
        self.inflight: Dict[tuple, _OlOp] = {}
        # Client-cached routing state (§3.6): a stale map draws NOT_OWNER
        # and only then pays config_fetch_us for a fresh snapshot.
        self._router = getattr(cluster, "router", None)
        self._slot_map = list(self._router.slot_map) if self._router else None
        self._map_version = self._router.version if self._router else 0
        self._refetching = False
        n_shards = getattr(cluster, "n_shards", 1)
        self.breakers: Dict[int, CircuitBreaker] = {
            i: CircuitBreaker(params.breaker_failures,
                              params.breaker_reset_us,
                              params.breaker_probes)
            for i in range(n_shards)
        } if use_breakers else {}
        self._t_end = 0.0
        self.stats = {
            "issued": 0, "completed": 0, "failed": 0, "timeouts": 0,
            "sheds_seen": 0, "breaker_fast_fails": 0, "refetches": 0,
            "not_owner": 0, "stale_config": 0, "sync_paths": 0,
        }
        self.fast_completions = 0
        self.rtt2_completions = 0
        self.latencies: List[Tuple[float, float, bool]] = []
        self.issue_times: List[float] = []
        self.history: List[dict] = []

    def service_time(self, msg) -> float:
        return 0.0   # the hub aggregates many machines; never the bottleneck

    # -- arrivals ---------------------------------------------------------------
    def start(self, t_end: float) -> None:
        self._t_end = t_end
        self.sim.after(self.workload.next_interarrival(self.sim.now),
                       self._arrive)

    def _arrive(self) -> None:
        if self.sim.now >= self._t_end:
            return
        self._issue()
        self.sim.after(self.workload.next_interarrival(self.sim.now),
                       self._arrive)

    def _issue(self) -> None:
        cid = self.workload.next_client()
        session = self.sessions.get(cid)
        if session is None:
            session = self.sessions[cid] = ClientSession(
                client_id=1_000_000 + cid)
        op = self.workload.make_op(session)
        st = _OlOp(op=op, session=session, is_update=op.is_update,
                   t_invoke=self.sim.now)
        self.inflight[op.rpc_id] = st
        self.stats["issued"] += 1
        self.issue_times.append(self.sim.now)
        if self.sim.watchdog is not None:
            self.sim.watchdog.op_invoked(op.rpc_id, self.sim.now)
        if self.sim.tracer is not None:
            # Root span for the whole op lifetime; every server-side span
            # for this RIFL id parents to it.
            st.span_id = self.sim.tracer.begin(
                op.rpc_id, "op", self.sim.now, actor=self.name,
                args={"type": op.op_type.name, "update": st.is_update})
        self._attempt(st)

    # -- routing (cached slot map) -----------------------------------------------
    def _shard_of(self, op: Op) -> int:
        if self._router is None:
            return 0
        return self._slot_map[self._router.slot_of(op.keys[0])]

    def _target(self, shard_idx: int):
        shards = getattr(self.cluster, "shards", None)
        return shards[shard_idx] if shards is not None else self.cluster

    def _refetch_map(self) -> None:
        if self._refetching or self._router is None:
            return
        self._refetching = True

        def done() -> None:
            self._refetching = False
            self._slot_map = list(self._router.slot_map)
            self._map_version = self._router.version
            self.stats["refetches"] += 1
        self.sim.after(self.p.config_fetch_us, done)

    # -- attempts -----------------------------------------------------------------
    def _attempt(self, st: _OlOp) -> None:
        if st.done:
            return
        st.shard_idx = self._shard_of(st.op)
        br = self.breakers.get(st.shard_idx)
        if br is not None and not br.allow(self.sim.now):
            # Breaker OPEN: fail fast locally — no packet, no server work —
            # and come back after a backoff instead of piling onto a shard
            # that is down or mid-handover.
            self.stats["breaker_fast_fails"] += 1
            self._backoff(st, self.p.ol_backoff_base_us)
            return
        target = self._target(st.shard_idx)
        master = target.master_node
        op = st.op
        t0 = self.sim.now
        wd = self.sim.watchdog
        record_wits = st.is_update and self.cluster.mode == "curp"
        if record_wits and wd is not None and wd.chaos.early_ack \
                and not wd.chaos.fired("early_ack"):
            # Chaos: skip the witness records entirely for one op — the
            # client then acks on the master result alone (0 accepts), i.e.
            # an ack without f-durability.  Only the durability monitor can
            # tell this apart from a legitimate 1-RTT completion.
            wd.chaos.fire("early_ack")
            record_wits = False
        if record_wits:
            wits = target.witness_nodes
            st.want_witnesses = len(wits)
            st.witness_statuses = []
            att = st.attempts
            for k, w in enumerate(wits):
                self.sim.at(
                    t0 + (k + 1) * self.p.client_record_send_cost_us,
                    lambda w=w, op=op, att=att: self.net.send(
                        w, MRecord(self, target.master_id, op, att)
                    ),
                )
            t0 += len(wits) * self.p.client_record_send_cost_us
        else:
            st.want_witnesses = 0
            st.witness_statuses = []
        t0 += self.p.client_send_cost_us
        if st.is_update:
            msg = MUpdate(self, op, target.wlv, st.session.acks())
        else:
            msg = MRead(self, op)
        self.sim.at(t0, lambda: self.net.send(master, msg, size_bytes=256))
        rpc_id, attempt = op.rpc_id, st.attempts
        self.sim.after(self.p.rpc_timeout_us,
                       lambda: self._check_timeout(rpc_id, attempt))

    def _check_timeout(self, rpc_id, attempt) -> None:
        st = self.inflight.get(rpc_id)
        if st is None or st.done or st.attempts != attempt:
            return
        self.stats["timeouts"] += 1
        if self.sim.tracer is not None:
            self.sim.tracer.instant(rpc_id, "timeout", self.sim.now,
                                    actor=self.name,
                                    args={"attempt": attempt})
        br = self.breakers.get(st.shard_idx)
        if br is not None:
            br.record_failure(self.sim.now)
        self._backoff(st, self.p.ol_backoff_base_us, exponential=True)

    def _backoff(self, st: _OlOp, base_us: float,
                 exponential: bool = False) -> None:
        """Count an attempt; give up past ol_max_attempts, else schedule a
        jittered retry (capped exponential for timeouts, capped linear for
        explicit sheds and breaker fast-fails)."""
        st.attempts += 1
        if st.attempts >= self.p.ol_max_attempts:
            self._give_up(st)
            return
        if exponential:
            delay = min(base_us * (2 ** (st.attempts - 1)),
                        self.p.ol_backoff_cap_us)
        else:
            delay = min(base_us * st.attempts, self.p.ol_backoff_cap_us)
        delay *= 1.0 + self.p.ol_backoff_jitter * (
            2 * self.sim.rng.random() - 1)
        self.sim.after(delay, lambda: self._resend(st))

    def _resend(self, st: _OlOp) -> None:
        if st.done:
            return
        st.master_result = None
        st.sync_requested = False
        self._attempt(st)

    def _give_up(self, st: _OlOp) -> None:
        st.done = True
        self.inflight.pop(st.op.rpc_id, None)
        self.stats["failed"] += 1
        if self.sim.watchdog is not None:
            self.sim.watchdog.op_failed({
                "client": st.session.client_id, "op": st.op,
                "invoke": st.t_invoke, "complete": None,
                "value": None, "failed": True,
            })
        if self.sim.tracer is not None:
            self.sim.tracer.end(st.span_id, self.sim.now, status="failed")
        # The client walks away: RIFL may reclaim the completion record (the
        # op stays a "maybe" for the checker — it may or may not have run).
        st.session.abandon(st.op.rpc_id)
        if self.record_history:
            self._record(st, value=None, failed=True)

    # -- responses -----------------------------------------------------------------
    def handle(self, msg) -> None:
        rpc_id = getattr(msg, "rpc_id", None)
        st = self.inflight.get(rpc_id)
        if st is None or st.done:
            return
        if isinstance(msg, MShedResp):
            # Explicit backpressure: the server is alive but full.  Back off
            # harder than a normal retry, and do NOT count it against the
            # breaker (a shed is a healthy signal, not a dead shard).
            self.stats["sheds_seen"] += 1
            self._backoff(st, self.p.ol_shed_backoff_us)
            return
        if isinstance(msg, MUpdateResp):
            if not msg.result.ok:
                br = self.breakers.get(st.shard_idx)
                if msg.result.error == "NOT_OWNER":
                    # Stale cached slot map (§3.6): refetch, then retry
                    # against the fresh map.
                    self.stats["not_owner"] += 1
                    if self.sim.tracer is not None:
                        self.sim.tracer.instant(rpc_id, "not_owner",
                                                self.sim.now,
                                                actor=self.name)
                    if br is not None:
                        br.record_failure(self.sim.now)
                    self._refetch_map()
                else:
                    self.stats["stale_config"] += 1
                st.attempts += 1
                if st.attempts >= self.p.ol_max_attempts:
                    self._give_up(st)
                    return
                self.sim.after(self.p.config_fetch_us,
                               lambda: self._resend(st))
                return
            st.master_result = msg.result
        elif isinstance(msg, MRecordResp):
            if msg.attempt != st.attempts:
                return   # stale response from a pre-retry witness set
            st.witness_statuses.append(msg.status)
        elif isinstance(msg, MSyncResp):
            if st.master_result is None:
                return
            self._complete(st, st.master_result, rtts=3)
            return
        else:
            return
        self._evaluate(st)

    def _evaluate(self, st: _OlOp) -> None:
        if st.master_result is None:
            return
        if not st.is_update or self.cluster.mode != "curp":
            self._complete(st, st.master_result,
                           rtts=2 if st.master_result.synced else 1)
            return
        if st.master_result.synced:
            self._complete(st, st.master_result, rtts=2)
            return
        if len(st.witness_statuses) < st.want_witnesses:
            return
        d = decide(st.master_result, st.witness_statuses)
        if d is Decision.COMPLETE:
            self._complete(st, st.master_result, rtts=1)
        elif not st.sync_requested:
            st.sync_requested = True
            self.stats["sync_paths"] += 1
            self.sim.after(
                self.p.client_send_cost_us,
                lambda: self.net.send(
                    self._target(st.shard_idx).master_node,
                    MSyncReq(self, st.op.rpc_id),
                ),
            )

    def _complete(self, st: _OlOp, result, rtts: int) -> None:
        st.done = True
        self.inflight.pop(st.op.rpc_id, None)
        wd = self.sim.watchdog
        if wd is not None:
            wd.journal.emit("ack", actor=self.name, rpc=st.op.rpc_id,
                            rtts=rtts)
            wd.op_completed({
                "client": st.session.client_id, "op": st.op,
                "invoke": st.t_invoke, "complete": self.sim.now,
                "value": result.value if result else None, "failed": False,
            })
        if self.sim.tracer is not None:
            self.sim.tracer.end(st.span_id, self.sim.now,
                                status=f"{rtts}rtt")
        lat = self.sim.now - st.t_invoke
        self.latencies.append((lat, self.sim.now, st.is_update))
        if rtts == 1:
            self.fast_completions += 1
        else:
            self.rtt2_completions += 1
        st.session.mark_completed(st.op.rpc_id)
        br = self.breakers.get(st.shard_idx)
        if br is not None:
            br.record_success()
        self.stats["completed"] += 1
        if self.record_history:
            self._record(st, value=result.value if result else None)

    def _record(self, st: _OlOp, value, failed: bool = False) -> None:
        self.history.append({
            "client": st.session.client_id,
            "op": st.op,
            "invoke": st.t_invoke,
            "complete": None if failed else self.sim.now,
            "value": value,
            "failed": failed,
        })


@dataclass
class OpenLoopResult:
    mode: str
    armored: bool
    duration_us: float
    issued: int
    completed: int
    failed: int
    offered_ops_per_sec: float      # arrivals in the measure window
    goodput_ops_per_sec: float      # completions in-window AND under SLO
    completed_ops_per_sec: float    # completions in-window (any latency)
    slo_us: float
    p50_us: float
    p99_us: float
    p999_us: float
    fast_fraction: float
    client_stats: dict              # OpenLoopDriver.stats
    breaker_stats: dict             # summed across per-shard breakers
    armor_stats: dict               # summed across masters (incl. retired)
    witness_sheds: int
    max_qdepth: int                 # deepest master RPC queue seen anywhere
    recoveries: Dict[int, dict]
    failovers: List[dict]           # coordinator-detected (heartbeat)
    migrations: List[dict]
    history: list
    sim_time_us: float


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def run_openloop_scenario(
    workload=None,
    duration_us: float = 20_000.0,
    mode: str = "curp",
    f: int = 1,
    n_shards: int = 1,
    armor: Any = None,               # None/False, True, or an ArmorConfig
    params: Optional[SimParams] = None,
    seed: int = 0,
    slo_us: float = 50.0,
    heartbeat: bool = False,
    fail_master_at: Optional[Dict[int, float]] = None,
    migrate_slots: Optional[List[Tuple[float, int, int]]] = None,
    warmup_frac: float = 0.2,
    record_history: bool = False,
    tracer: Any = None,
    watchdog: Any = None,
) -> OpenLoopResult:
    """Drive an open-loop timed workload against a (possibly sharded,
    possibly armored) cluster and measure SLO survival.

    ``armor=True`` builds an ArmorConfig from params and also enables the
    client-side circuit breakers; ``armor=None/False`` is the naked
    baseline (unbounded queues, no shedding, no breakers).
    ``fail_master_at`` maps shard index -> silent-kill time; with
    ``heartbeat=True`` a SimCoordinator detects the silence and drives
    failover — the harness never schedules recovery itself.
    ``migrate_slots`` is a list of (t_us, slot, dst_shard) live handovers
    (sharded runs only; implies ownership enforcement).
    ``tracer`` (repro_torch.core.telemetry.Tracer) attaches the flight recorder:
    every sim actor emits causal spans keyed by RIFL id, closed out at
    scenario teardown so in-flight ops never leak open spans.
    ``watchdog`` (repro_torch.sim.watchdog.Watchdog) attaches the always-on
    protocol watchdog: journal emit hooks light up on every actor and the
    invariant monitors (incl. the windowed linearizability checker) run
    inside the event loop; ``watchdog.finalize`` is called at teardown."""
    from .workload import OpenLoopWorkload

    p = params or DEFAULT
    sim = Sim(seed=seed)
    sim.tracer = tracer
    net = Network(sim, p)
    if isinstance(armor, ArmorConfig):
        armor_cfg = armor
    elif armor:
        armor_cfg = ArmorConfig(
            queue_capacity=p.admit_queue_depth,
            witness_queue_capacity=p.admit_queue_depth_witness,
            throttle_rate=p.throttle_rate_ops_per_us,
            throttle_burst=p.throttle_burst,
            degrade_hi=p.degrade_hi_frac,
            degrade_lo=p.degrade_lo_frac,
        )
    else:
        armor_cfg = None

    if n_shards > 1:
        cluster = ShardedSimCluster(
            sim, net, p, mode, f, n_shards, armor=armor_cfg,
            enforce_ownership=bool(migrate_slots),
        )
        shard_clusters = cluster.shards
    else:
        cluster = SimCluster(sim, net, p, mode, f, armor=armor_cfg)
        shard_clusters = [cluster]

    if watchdog is not None:
        watchdog.attach(sim, cluster, f=f, mode=mode)

    coord = None
    if heartbeat:
        coord = SimCoordinator(sim, net, p)
        for i, s in enumerate(shard_clusters):
            coord.watch(i, s)
    for shard_idx, t in (fail_master_at or {}).items():
        shard_clusters[shard_idx].fail_master_at(t)
    for t, slot, dst in (migrate_slots or []):
        cluster.migrate_slot_at(t, slot, dst)

    wl = workload or OpenLoopWorkload(rate_ops_per_us=0.5, seed=seed)
    driver = OpenLoopDriver(sim, net, p, cluster, wl,
                            use_breakers=armor_cfg is not None,
                            record_history=record_history)
    driver.start(duration_us)
    # Arrivals stop at duration_us; leave room for retries/backoff to drain
    # and for any in-flight failover to finish.
    drain_us = max(20 * p.rpc_timeout_us,
                   p.ol_max_attempts * p.ol_backoff_cap_us / 4)
    sim.run(until=duration_us + drain_us)
    if tracer is not None:
        tracer.close_open(sim.now)
    if watchdog is not None:
        watchdog.finalize(sim.now)

    # -- measure window: [warmup, end of arrivals] ---------------------------
    w_lo, w_hi = duration_us * warmup_frac, duration_us
    window_s = (w_hi - w_lo) / 1e6
    offered = sum(1 for t in driver.issue_times if w_lo <= t < w_hi)
    in_window = [(lat, t) for lat, t, _ in driver.latencies
                 if w_lo <= t < w_hi]
    good = sum(1 for lat, _ in in_window if lat <= slo_us)
    lats = sorted(lat for lat, _ in in_window)

    armor_stats: Dict[str, int] = {}
    max_qdepth = 0
    witness_sheds = 0
    for s in shard_clusters:
        for m in [s.master_node] + s.master_nodes_retired:
            for k, v in m.armor_stats.items():
                armor_stats[k] = armor_stats.get(k, 0) + v
            max_qdepth = max(max_qdepth, m.max_qdepth)
        for w in s.witness_nodes:
            if w.admission is not None:
                witness_sheds += w.admission.shed
    breaker_stats: Dict[str, int] = {}
    for br in driver.breakers.values():
        for k, v in br.stats.items():
            breaker_stats[k] = breaker_stats.get(k, 0) + v

    if n_shards > 1:
        recoveries = cluster.recovery_reports
        migrations = cluster.migrations
    else:
        recoveries = ({0: cluster.recovery_report}
                      if cluster.recovery_report else {})
        migrations = []

    return OpenLoopResult(
        mode=mode,
        armored=armor_cfg is not None,
        duration_us=duration_us,
        issued=driver.stats["issued"],
        completed=driver.stats["completed"],
        failed=driver.stats["failed"],
        offered_ops_per_sec=offered / window_s if window_s > 0 else 0.0,
        goodput_ops_per_sec=good / window_s if window_s > 0 else 0.0,
        completed_ops_per_sec=(len(in_window) / window_s
                               if window_s > 0 else 0.0),
        slo_us=slo_us,
        p50_us=_percentile(lats, 0.50),
        p99_us=_percentile(lats, 0.99),
        p999_us=_percentile(lats, 0.999),
        fast_fraction=driver.fast_completions / max(
            1, driver.fast_completions + driver.rtt2_completions),
        client_stats=dict(driver.stats),
        breaker_stats=breaker_stats,
        armor_stats=armor_stats,
        witness_sheds=witness_sheds,
        max_qdepth=max_qdepth,
        recoveries=recoveries,
        failovers=list(coord.failovers) if coord else [],
        migrations=migrations,
        history=driver.history,
        sim_time_us=sim.now,
    )


# --------------------------------------------------------------------------
# Mini-transaction crash scenarios (repro_torch.core.txn)
# --------------------------------------------------------------------------
# Message-level coordinator crash points, one per 2PC stage: the coordinator
# dies with the named message (and everything after it) unsent.
#   prepare-sent : first PREPARE sent, the rest never leave the coordinator
#   prepared     : every PREPARE sent and voted, no decision message sent
#   commit-sent  : first COMMIT sent, the rest never leave the coordinator
TXN_CRASH_STAGES = ("prepare-sent", "prepared", "commit-sent")

_STAGE_TO_HOOK = {
    "prepare-sent": ("prepare", 1),
    "prepared": ("decide", 0),
    "commit-sent": ("decide", 1),
}


@dataclass
class TxnScenarioResult:
    """Result of one crash-injected transaction run (instant transport —
    the protocol steps are the real ones; repro_torch.sim timing is orthogonal)."""
    stage: str
    n_txns: int
    committed: int
    aborted: int
    crashed_decision: Optional[str]    # how resolution decided the orphan
    intents_after: int                 # undecided intents left anywhere (0!)
    history_ok: bool                   # strict multi-key checker verdict
    offending_key: Optional[str]
    fast_single: float                 # 1-RTT fraction of single-shard txns
    fast_multi: float                  # all-legs-fast fraction of 2PC txns
    final_reads: dict                  # key -> value after recovery


def run_txn_crash_scenario(
    stage: str = "prepared",
    n_shards: int = 3,
    n_txns: int = 20,
    crash_txn: Optional[int] = None,
    participant_crash: bool = False,
    seed: int = 0,
    witness_backend: str = "python",
    workload=None,
    device: str = "cuda",
) -> TxnScenarioResult:
    """Drive cross-shard transactions through a real ShardedCluster with a
    coordinator crash injected at a 2PC message boundary, then recover and
    validate atomicity.

    One transaction (``crash_txn``, default: the middle one) crashes its
    coordinator at ``stage`` (see TXN_CRASH_STAGES).  If
    ``participant_crash``, a participant master holding the orphaned intent
    is then crashed and recovered (backup restore + witness replay
    re-surface the intent; recovery resolves it).  Otherwise the orphan is
    resolved lazily — the next conflicting read trips TXN_PENDING and the
    cluster applies the Sinfonia recovery rule.  Every key the workload
    touched is read back at the end, and the STRICT multi-key checker runs
    over the full history: a torn transaction write fails it.
    ``device`` places the gang of ``witness_backend="device"`` (default
    "cuda", which raises without a card).
    """
    from ..core import CoordinatorCrash, ShardedCluster, TxnStatus

    from .workload import TxnWorkload

    assert stage in TXN_CRASH_STAGES, stage
    cluster = ShardedCluster(n_shards=n_shards, f=3, seed=seed,
                             witness_backend=witness_backend, device=device)
    session = cluster.new_client()
    wl = workload or TxnWorkload(n_shards=n_shards, cross_shard_frac=0.7,
                                 seed=seed)
    crash_txn = n_txns // 2 if crash_txn is None else crash_txn
    hook_stage, hook_idx = _STAGE_TO_HOOK[stage]

    def crash_hook(s, shard_id, idx):
        if s == hook_stage and idx == hook_idx:
            raise CoordinatorCrash()

    committed = aborted = 0
    fast = {"single": [0, 0], "multi": [0, 0]}   # [fast, total]
    touched: set = set()
    crashed_spec = None
    for i in range(n_txns):
        writes, reads = wl.next_txn()
        touched.update(k for k, _ in writes)
        touched.update(reads)
        spec = session.txn_spec(writes, reads)
        is_multi = len(spec.parts) > 1
        # Crash the first MULTI-shard txn at/after the target index (only a
        # 2PC has message boundaries to crash at).
        if crashed_spec is None and i >= crash_txn and is_multi:
            try:
                cluster.txn(session, writes, reads, spec=spec,
                            on_message=crash_hook)
                raise AssertionError("crash hook did not fire")
            except CoordinatorCrash:
                crashed_spec = spec
            continue
        out = cluster.txn(session, writes, reads, spec=spec)
        if out.status is TxnStatus.COMMITTED:
            committed += 1
            bucket = fast["multi" if is_multi else "single"]
            bucket[0] += int(out.fast_path)
            bucket[1] += 1
        else:
            aborted += 1

    crashed_decision = None
    if participant_crash and crashed_spec is not None:
        # Kill a participant master that holds the orphaned intent; its
        # recovery re-surfaces the intent and resolves it cluster-wide.
        victim = next(
            (p.shard_id for p in crashed_spec.parts
             if cluster.shards[p.shard_id].master.store.txn_intent(
                 crashed_spec.txn_id) is not None),
            crashed_spec.parts[0].shard_id,
        )
        rep = cluster.crash_master(victim)
        if rep.txn_resolved:
            crashed_decision = ("COMMITTED" if rep.txn_committed
                                else "ABORTED")
    # Final reads of every touched key: lazy resolution (TXN_PENDING ->
    # resolve -> retry) finishes any remaining orphan on first contact.
    final_reads = {}
    for k in sorted(touched):
        final_reads[k] = cluster.read(session, session.op_get(k)).value
    if crashed_spec is not None and crashed_decision is None:
        from ..core.txn import participant_state

        states = {
            p.shard_id: participant_state(
                cluster.shards[p.shard_id].master, crashed_spec, p)
            for p in crashed_spec.parts
        }
        if any(s in ("committed", "decided") for s in states.values()):
            crashed_decision = "COMMITTED"
        elif any(s == "aborted" for s in states.values()):
            crashed_decision = "ABORTED"
    intents_after = sum(
        len(g.master.store.txn_intents()) for g in cluster.shards
    )
    ok, key = check_linearizable_strict(cluster.history)
    return TxnScenarioResult(
        stage=stage, n_txns=n_txns, committed=committed, aborted=aborted,
        crashed_decision=crashed_decision, intents_after=intents_after,
        history_ok=ok, offending_key=key,
        fast_single=fast["single"][0] / max(1, fast["single"][1]),
        fast_multi=fast["multi"][0] / max(1, fast["multi"][1]),
        final_reads=final_reads,
    )


def run_sharded_scenario(
    n_shards: int = 4,
    mode: str = "curp",
    f: int = 3,
    n_clients: int = 8,
    n_ops: int = 2000,
    seed: int = 0,
    params: Optional[SimParams] = None,
    op_factory: Optional[Callable[[ClientSession], Op]] = None,
    crash_shard_at: Optional[Tuple[float, int]] = None,
    backup_service_us: Optional[float] = None,
    warmup_frac: float = 0.1,
    router: Optional[SlotRouter] = None,
    watchdog: Any = None,
) -> ShardedScenarioResult:
    """Timed sharded run: clients route each op to its owning shard's master
    and witness group.  ``crash_shard_at=(t_us, shard)`` kills exactly that
    shard's master; the rest of the cluster keeps serving.  ``router``
    overrides the slot map (simulate a rebalanced placement)."""
    p = params or DEFAULT
    sim = Sim(seed=seed)
    net = Network(sim, p)
    cluster = ShardedSimCluster(sim, net, p, mode, f, n_shards,
                                backup_service_us=backup_service_us,
                                router=router)
    if watchdog is not None:
        watchdog.attach(sim, cluster, f=f, mode=mode)
    _spawn_clients(sim, net, p, cluster, n_clients, n_ops, op_factory)

    if crash_shard_at is not None:
        t, shard = crash_shard_at
        cluster.crash_shard_at(t, shard)

    sim.run(until=60_000_000.0)  # 60 simulated seconds hard cap

    upd, rd, fast, slow, history, completed, thr = _collect_run(
        cluster, warmup_frac
    )
    if watchdog is not None:
        watchdog.finalize(sim.now)
    return ShardedScenarioResult(
        mode=mode, f=f, n_shards=n_shards, n_clients=n_clients,
        update_latencies=upd, read_latencies=rd,
        throughput_ops_per_sec=thr,
        fast_fraction=fast / max(1, fast + slow),
        completed=completed,
        history=history,
        recoveries=cluster.recovery_reports,
        master_stats=cluster.master_stats(),
        per_shard_stats=[dict(s.master_node.core.stats)
                         for s in cluster.shards],
        sim_time_us=sim.now,
    )


# --------------------------------------------------------------------------
# Timed 2PC coordinator: concurrent prepare fan-out (ROADMAP follow-on)
# --------------------------------------------------------------------------
class SimTxnClient(Node):
    """Timed mini-transaction coordinator over the sharded sim.

    ``mode="fanout"`` sends every PREPARE leg (witness records + update RPC)
    at the same time and every decide leg at the same time — the true
    2-round transaction shape, wall-clock ≈ 2 RTTs regardless of span.
    ``mode="sequential"`` drives legs one at a time (the instant harness's
    old shape, ≈ 2·span RTTs) for comparison.  ``mode="mset"`` issues the
    same key set as per-shard MSET sub-ops concurrently (durable, NOT
    atomic) — the 1-round baseline the 2PC's extra decide round is measured
    against.

    A leg voting NO (intent conflict across concurrent coordinators) aborts
    the transaction: decide legs carry TXN_ABORT instead of TXN_COMMIT.
    """

    def __init__(self, sim, net, params, session: ShardedClientSession,
                 name: str, cluster: ShardedSimCluster, n_txns: int,
                 txn_factory, mode: str = "fanout") -> None:
        super().__init__(sim, name)
        assert mode in ("fanout", "sequential", "mset"), mode
        self.net = net
        self.p = params
        self.session = session
        self.cluster = cluster
        self.n_txns = n_txns
        self.txn_factory = txn_factory
        self.mode = mode
        self.completed = 0
        self.committed = 0
        self.aborted = 0
        self.latencies: List[float] = []
        self.pending: Optional[dict] = None

    def service_time(self, msg) -> float:
        if isinstance(msg, MRecordResp):
            return 0.1
        return self.p.client_recv_cost_us

    # -- issuing ------------------------------------------------------------
    def start(self) -> None:
        self.sim.after(self.sim.rng.random() * 1.0, self._issue_next)

    def _issue_next(self) -> None:
        if self.completed >= self.n_txns:
            return
        writes, reads = self.txn_factory()
        if self.mode == "mset":
            parts = self.session.mset_parts(writes)
            legs = {
                sid: {"op": op, "shard": sid, "result": None,
                      "statuses": [], "want": 0, "sync_req": False,
                      "done": False}
                for sid, op in parts.items()
            }
            self.pending = {"stage": "mset", "legs": legs,
                            "t0": self.sim.now, "by_rpc": {
                                leg["op"].rpc_id: leg for leg in legs.values()
                            }}
            for leg in legs.values():
                self._send_update_leg(leg, with_records=True)
            return
        from ..core.txn import prepare_op

        spec = self.session.txn_spec(writes, reads)
        legs = {}
        for part in spec.parts:
            legs[part.shard_id] = {
                "part": part, "shard": part.shard_id,
                "op": prepare_op(spec, part), "result": None,
                "statuses": [], "want": 0, "sync_req": False, "done": False,
            }
        self.pending = {
            "stage": "prepare", "spec": spec, "legs": legs,
            "t0": self.sim.now, "order": [p.shard_id for p in spec.parts],
            "sent": 0,
            "by_rpc": {leg["op"].rpc_id: leg for leg in legs.values()},
        }
        if self.mode == "sequential":
            self._send_update_leg(legs[self.pending["order"][0]],
                                  with_records=True)
            self.pending["sent"] = 1
        else:
            for leg in legs.values():
                self._send_update_leg(leg, with_records=True)
            self.pending["sent"] = len(legs)

    def _send_update_leg(self, leg: dict, with_records: bool) -> None:
        target = self.cluster.shards[leg["shard"]]
        op = leg["op"]
        t0 = self.sim.now
        if with_records and op.is_update:
            wits = target.witness_nodes
            leg["want"] = len(wits)
            for k, w in enumerate(wits):
                self.sim.at(
                    t0 + (k + 1) * self.p.client_record_send_cost_us,
                    lambda w=w, op=op, mid=target.master_id:
                    self.net.send(w, MRecord(self, mid, op)),
                )
            t0 += len(wits) * self.p.client_record_send_cost_us
        t0 += self.p.client_send_cost_us
        msg = MUpdate(self, op, target.wlv, self.session.acks())
        self.sim.at(t0, lambda: self.net.send(target.master_node, msg,
                                              size_bytes=256))

    # -- responses ----------------------------------------------------------
    def handle(self, msg) -> None:
        p = self.pending
        if p is None:
            return
        if isinstance(msg, (MUpdateResp, MRecordResp, MSyncResp)):
            leg = p["by_rpc"].get(msg.rpc_id)
            if leg is None or leg["done"]:
                return
            if isinstance(msg, MUpdateResp):
                leg["result"] = msg.result
            elif isinstance(msg, MRecordResp):
                leg["statuses"].append(msg.status)
            else:
                leg["done"] = True
            self._evaluate_leg(leg)

    def _evaluate_leg(self, leg: dict) -> None:
        if leg["done"]:
            self._advance()
            return
        res = leg["result"]
        if res is None:
            return
        if not res.ok:
            # Vote NO (intent conflict): the leg is complete, nothing durable.
            leg["done"] = True
            leg["no"] = True
            self._advance()
            return
        if self.pending["stage"] == "decide":
            leg["done"] = True     # decide legs need no witness accepts
            self._advance()
            return
        if res.synced:
            leg["done"] = True
            self._advance()
            return
        if len(leg["statuses"]) < leg["want"]:
            return
        if decide(res, leg["statuses"]) is Decision.COMPLETE:
            leg["done"] = True
            self._advance()
        elif not leg["sync_req"]:
            leg["sync_req"] = True
            target = self.cluster.shards[leg["shard"]]
            self.sim.after(
                self.p.client_send_cost_us,
                lambda: self.net.send(target.master_node,
                                      MSyncReq(self, leg["op"].rpc_id)),
            )

    def _advance(self) -> None:
        p = self.pending
        legs = p["legs"]
        if self.mode == "sequential" and p["sent"] < len(p["order"]):
            # One leg at a time, in BOTH rounds (the pre-fan-out baseline).
            nxt = legs[p["order"][p["sent"]]]
            p["sent"] += 1
            self._send_update_leg(nxt, with_records=p["stage"] != "decide")
            return
        if not all(leg["done"] for leg in legs.values()):
            return
        if p["stage"] == "mset":
            self._complete()
            return
        if p["stage"] == "prepare":
            from ..core.txn import abort_op, commit_op

            for leg in legs.values():
                self.session.mark_completed(leg["op"].rpc_id)
            commit = not any(leg.get("no") for leg in legs.values())
            p["stage"] = "decide"
            p["commit"] = commit
            spec = p["spec"]
            decide_legs = {}
            for part in spec.parts:
                op = (commit_op(spec, part) if commit
                      else abort_op(spec, part))
                decide_legs[part.shard_id] = {
                    "op": op, "shard": part.shard_id, "result": None,
                    "statuses": [], "want": 0, "sync_req": False,
                    "done": False,
                }
            p["legs"] = decide_legs
            p["by_rpc"] = {leg["op"].rpc_id: leg
                           for leg in decide_legs.values()}
            if self.mode == "sequential":
                p["sent"] = 1
                self._send_update_leg(decide_legs[p["order"][0]],
                                      with_records=False)
            else:
                p["sent"] = len(decide_legs)
                for leg in decide_legs.values():
                    self._send_update_leg(leg, with_records=False)
            return
        # decide stage fully acked
        self._complete()

    def _complete(self) -> None:
        p = self.pending
        for leg in p["legs"].values():
            self.session.mark_completed(leg["op"].rpc_id)
        self.latencies.append(self.sim.now - p["t0"])
        if p["stage"] == "decide" and not p.get("commit", True):
            self.aborted += 1
        else:
            self.committed += 1
        self.completed += 1
        self.cluster.on_completion(self.sim.now)
        self.pending = None
        self._issue_next()


@dataclass
class TimedTxnResult:
    """Wall-clock (simulated) latency of the timed transaction coordinator."""
    mode: str
    n_shards: int
    span: int
    completed: int
    committed: int
    aborted: int
    mean_us: float
    p50_us: float
    p99_us: float


def run_timed_txn_scenario(
    mode: str = "fanout",
    n_shards: int = 4,
    span: int = 3,
    n_txns: int = 60,
    n_clients: int = 2,
    seed: int = 0,
    params: Optional[SimParams] = None,
) -> TimedTxnResult:
    """Measure true timed 2PC latency in the discrete-event transport.

    ``fanout`` drives prepare legs concurrently (the ROADMAP follow-on);
    ``sequential`` is the one-leg-at-a-time baseline; ``mset`` is the
    non-atomic per-shard 1-round comparison on the same key pattern.
    """
    from .workload import TxnWorkload

    p = params or DEFAULT
    sim = Sim(seed=seed)
    net = Network(sim, p)
    cluster = ShardedSimCluster(sim, net, p, "curp", 3, n_shards)
    wl = TxnWorkload(n_shards=n_shards, cross_shard_frac=1.0,
                     span_shards=span, keys_per_txn=span, seed=seed + 1)
    clients = []
    for i in range(n_clients):
        session = ShardedClientSession(20_000 + i, cluster.router)
        c = SimTxnClient(sim, net, p, session, f"txn{i}", cluster,
                         n_txns, wl.next_txn, mode=mode)
        clients.append(c)
        c.start()
    sim.run(until=60_000_000.0)
    lats = sorted(l for c in clients for l in c.latencies)

    def pct(q: float) -> float:
        return lats[min(len(lats) - 1, int(q * len(lats)))] if lats else 0.0

    return TimedTxnResult(
        mode=mode, n_shards=n_shards, span=span,
        completed=sum(c.completed for c in clients),
        committed=sum(c.committed for c in clients),
        aborted=sum(c.aborted for c in clients),
        mean_us=sum(lats) / len(lats) if lats else 0.0,
        p50_us=pct(0.5), p99_us=pct(0.99),
    )


# --------------------------------------------------------------------------
# Live slot-migration scenario (repro_torch.core.migration) under traffic + crash
# --------------------------------------------------------------------------
@dataclass
class MigrationScenarioResult:
    """One live reshard under continuous client traffic (instant transport —
    the protocol steps are the real ones, like run_txn_crash_scenario)."""
    windows: List[dict]            # per-window: phase, ops, fast, redirects
    steady_fast: float             # fast-path ratio before the reshard
    migration_fast_untouched: float  # fast ratio of NON-moving-slot ops
    redirects: int                 # retryable SlotMoving redirects seen
    redirected_retried_ok: int     # redirected writes that landed on retry
    mismatches: int                # final reads disagreeing with the shadow
    history_ok: bool
    offending_key: Optional[str]
    reports: list                  # MigrationReports of every handover
    crash: Optional[str]
    resumed: int                   # handovers that survived a crash-resume


def run_migration_scenario(
    n_shards_before: int = 2,
    n_shards_after: int = 4,
    n_slots: int = 64,
    ops_per_window: int = 30,
    n_keys: int = 160,
    n_clients: int = 3,
    crash: Optional[str] = None,     # None | "donor" | "receiver"
    seed: int = 0,
    read_frac: float = 0.25,
) -> MigrationScenarioResult:
    """Live-reshard a ShardedCluster ``n_shards_before -> n_shards_after``
    while clients keep writing/reading, optionally crashing the donor or the
    receiver master mid-handover (after the transfer, before the commit) and
    resuming.  Validates the acceptance criteria end to end: a shadow map
    catches lost/duplicated writes, the strict multi-key checker runs over
    the full history, redirected writes are re-issued and must land, and the
    fast-path ratio is tracked separately for ops on untouched slots.
    """
    import random as _random

    from ..core import ShardedCluster
    from ..core.migration import SlotMoving

    # A small sync batch keeps the unsynced windows (and with them the
    # baseline conflict rate) at steady state from the first measured
    # window — the fast-ratio comparison is then apples to apples.
    cluster = ShardedCluster(n_shards=n_shards_before, f=3, n_slots=n_slots,
                             sync_batch=8, seed=seed)
    sessions = [cluster.new_client() for _ in range(n_clients)]
    rng = _random.Random(seed)
    keys = [f"mk{i}" for i in range(n_keys)]
    shadow: Dict[str, str] = {}
    deferred: List[Tuple[str, str]] = []
    windows: List[dict] = []
    redirects = 0
    retried_ok = 0
    seq = 0
    # Slots scheduled to move at any point in the reshard ("touched").
    desired = [s % n_shards_after for s in range(n_slots)]
    touched = {s for s in range(n_slots)
               if desired[s] != cluster.router.slot_map[s]}

    def flush_deferred() -> None:
        nonlocal retried_ok
        still: List[Tuple[str, str]] = []
        for k, v in deferred:
            sess = rng.choice(sessions)
            op = sess.op_set(k, v)
            try:
                # Redirected ops were never accepted anywhere: re-issue
                # under a FRESH identity from the (new) owner.
                out = cluster.update(sess, op)
                assert out.value == "OK"
                shadow[k] = v
                retried_ok += 1
            except SlotMoving:
                sess.abandon(op.rpc_id)
                still.append((k, v))
        deferred[:] = still

    # Pooled fast/total counters over UNTOUCHED-slot writes, keyed by phase
    # kind — totals beat means-of-window-ratios statistically (the windows
    # are small).
    pooled = {"steady": [0, 0], "migrate": [0, 0]}

    def run_window(phase: str) -> None:
        nonlocal seq, redirects
        flush_deferred()
        fast = tot = fast_u = tot_u = n_redir = 0
        for _ in range(ops_per_window):
            sess = rng.choice(sessions)
            k = rng.choice(keys)
            untouched = cluster.router.slot_of(k) not in touched
            if rng.random() < read_frac:
                op = sess.op_get(k)
                try:
                    got = cluster.read(sess, op).value
                    assert got == shadow.get(k), (k, got, shadow.get(k))
                except SlotMoving:
                    sess.abandon(op.rpc_id)   # never transmitted
                    n_redir += 1
                continue
            seq += 1
            v = f"v{seq}"
            op = sess.op_set(k, v)
            try:
                out = cluster.update(sess, op)
            except SlotMoving:
                # Never transmitted: release the identity and re-issue
                # fresh after the handover (flush_deferred).
                sess.abandon(op.rpc_id)
                n_redir += 1
                deferred.append((k, v))
                continue
            shadow[k] = v
            tot += 1
            fast += int(out.fast_path)
            if untouched:
                tot_u += 1
                fast_u += int(out.fast_path)
                if phase.startswith("steady"):
                    pooled["steady"][0] += int(out.fast_path)
                    pooled["steady"][1] += 1
                elif phase.startswith("migrate"):
                    pooled["migrate"][0] += int(out.fast_path)
                    pooled["migrate"][1] += 1
        redirects += n_redir
        windows.append({
            "phase": phase, "t": len(windows), "ops": tot,
            "fast_frac": fast / tot if tot else None,
            "fast_frac_untouched": fast_u / tot_u if tot_u else None,
            "redirects": n_redir,
        })

    # -- warmup (unmeasured) + steady state before --------------------------
    for _ in range(2):
        run_window("warmup")
    for _ in range(4):
        run_window("steady-before")

    # -- grow + live reshard ------------------------------------------------
    for _ in range(n_shards_before, n_shards_after):
        cluster.add_shard()
    reports = []
    crashed = False
    resumed = 0
    for dst in range(n_shards_before, n_shards_after):
        slots = [s for s in range(n_slots) if desired[s] == dst]
        for mig in cluster.start_migration(slots, dst):
            while mig.stage != "done":
                stage = mig.step()
                if (crash and not crashed and stage == "handover"):
                    # Mid-handover: transfer done, commit pending.
                    victim = mig.src if crash == "donor" else mig.dst
                    cluster.crash_master(victim)
                    mig.resume()
                    crashed = True
                run_window(f"migrate->{dst}")
            resumed += mig.resumed
            reports.append(mig.report())

    # -- steady state after -------------------------------------------------
    for _ in range(4):
        run_window("steady-after")
    flush_deferred()
    assert not deferred, "redirected writes never landed"

    # -- verification -------------------------------------------------------
    sess = sessions[0]
    mismatches = 0
    for k in keys:
        got = cluster.read(sess, sess.op_get(k)).value
        if got != shadow.get(k):
            mismatches += 1
    ok, off = check_linearizable_strict(cluster.history)

    # Untouched-slot fast ratios from the POOLED counters: steady spans both
    # the before and after phases (same placement-independent workload), so
    # the comparison against the migration window is apples to apples.
    steady = (pooled["steady"][0] / pooled["steady"][1]
              if pooled["steady"][1] else 0.0)
    mig_untouched = (pooled["migrate"][0] / pooled["migrate"][1]
                     if pooled["migrate"][1] else 0.0)
    return MigrationScenarioResult(
        windows=windows,
        steady_fast=steady,
        migration_fast_untouched=mig_untouched,
        redirects=redirects,
        redirected_retried_ok=retried_ok,
        mismatches=mismatches,
        history_ok=ok,
        offending_key=off,
        reports=reports,
        crash=crash,
        resumed=resumed,
    )
