"""Cross-shard atomic mini-transactions over the per-shard CURP fast paths.

CURP (§3.6, §B) entangles only ordering and durability per key range, so the
sharded cluster's ``mset`` gives per-shard durability but no cross-shard
atomicity — a client crash mid-``mset`` can leave a torn multi-key write.
This module layers a Sinfonia-style mini-transaction (the paper's related
work) on top: a RIFL-identified two-phase commit where the COORDINATOR is the
client session and the PARTICIPANTS are the shard masters.

Shape of a transaction
----------------------
A ``TxnSpec`` is a read-set + write-set split into per-shard ``TxnPart`` legs
by the cluster's KeyRouter.  Every leg carries TWO rpc_ids from that shard's
RIFL space, allocated up front at spec-build time:

  * ``prepare_rpc`` — identity of the PREPARE leg, and
  * ``decide_rpc``  — identity of the decision (COMMIT or ABORT; one
    decision per transaction, so one identity suffices).

Because both identities are fixed in the spec (and the spec itself rides
inside every leg's payload), any retry — by the client or by crash recovery
— replays the same RPCs and RIFL dedupes them: decisions apply exactly once.

Protocol
--------
1. **Single-shard short-circuit**: a transaction whose keys all route to one
   shard is ONE ``OpType.TXN`` op through the untouched 1-RTT fast path
   (speculative master execution + witness records of all keys, §4.2
   multi-object rules) — no prepare/commit round at all.
2. **PREPARE** (multi-shard): each participant master installs a txn intent
   (write-set + read values, keys locked against overlapping ops) and the
   client records the prepare op at that shard's witnesses — the tombstoned
   intent that keeps commutativity checks sound during the window: any
   overlapping record conflicts until the intent is gc'ed.  A prepare is
   durable the usual CURP way: all-f witness accepts (1 RTT) or a synced
   backup round (2 RTTs).  A participant votes NO if a key is locked by
   another transaction's intent or if a decision tombstone already exists.
3. **DECIDE**: commit iff every participant voted yes.  The decision op
   applies/drops the intent and replies immediately WITHOUT witness records
   or a sync: the decision is a deterministic function of durable prepare
   state ("commit iff all prepared"), so a crashed participant re-derives it
   during recovery instead of needing it pre-logged.

Recovery
--------
``resolve_txn`` implements the Sinfonia recovery-coordinator rule from
participant intent state alone: COMMIT iff some participant already
committed or every participant holds a prepared intent; ABORT otherwise.
Aborting also tombstones not-yet-prepared participants (the abort decision
lands in their RIFL tables under ``decide_rpc``), so a straggling PREPARE
from a crashed-and-revived coordinator is refused — the classic 2PC
prepare/resolve race cannot commit a resolved-aborted transaction.
``resolve_pending`` sweeps every shard after a crash; masters re-surface
intents from backup logs and witness replay, so no intent outlives recovery
undecided.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .telemetry import get_registry
from .types import Op, OpType, RpcId


class TxnStatus(enum.Enum):
    COMMITTED = "COMMITTED"
    ABORTED = "ABORTED"


class CoordinatorCrash(Exception):
    """Raised by a crash-injection hook to kill the coordinator between two
    2PC messages (the transaction is left for ``resolve_txn`` to finish)."""


class TxnPending(Exception):
    """An op touched keys locked by an undecided transaction intent; the
    caller should resolve the transaction (``resolve_txn``) and retry."""

    def __init__(self, spec: "TxnSpec") -> None:
        super().__init__(f"keys locked by pending txn {spec.txn_id}")
        self.spec = spec


@dataclass(frozen=True)
class TxnPart:
    """One shard's leg of a transaction (its slice of the read/write sets)."""
    shard_id: int
    prepare_rpc: RpcId
    decide_rpc: RpcId
    write_kvs: Tuple[Tuple[Any, Any], ...]
    read_keys: Tuple[Any, ...] = ()

    @property
    def keys(self) -> Tuple[Any, ...]:
        """All keys this leg touches (write first, then read) — the lock set
        and the witness-record key set."""
        return tuple(k for k, _ in self.write_kvs) + tuple(self.read_keys)


@dataclass(frozen=True)
class TxnSpec:
    """The full transaction: every participant's leg, with all RIFL
    identities fixed up front.  The spec rides inside every leg's op payload
    (Sinfonia-style), so ANY single surviving intent names every participant
    — that is what makes coordinator-crash resolution possible."""
    txn_id: Tuple[int, int]          # (client_id, txn_seq) — intent-table key
    parts: Tuple[TxnPart, ...]

    def part_on(self, shard_id: int) -> TxnPart:
        """The leg for one shard.  Legs are addressed by shard, not by
        rpc_id: the per-shard RIFL spaces share (client_id, seq) pairs, so
        the same rpc_id can legitimately name different legs on different
        shards — every leg op carries its shard_id for exactly this."""
        for p in self.parts:
            if p.shard_id == shard_id:
                return p
        raise KeyError(f"no part on shard {shard_id}")

    @property
    def write_kvs(self) -> Tuple[Tuple[Any, Any], ...]:
        return tuple(kv for p in self.parts for kv in p.write_kvs)

    @property
    def read_keys(self) -> Tuple[Any, ...]:
        return tuple(k for p in self.parts for k in p.read_keys)


# ---------------------------------------------------------------------------
# Leg op constructors (the only places TXN_* ops are built)
# ---------------------------------------------------------------------------
def prepare_op(spec: TxnSpec, part: TxnPart) -> Op:
    return Op(OpType.TXN_PREPARE, part.keys, (spec, part.shard_id),
              part.prepare_rpc)


def commit_op(spec: TxnSpec, part: TxnPart) -> Op:
    return Op(OpType.TXN_COMMIT, part.keys, (spec, part.shard_id),
              part.decide_rpc)


def abort_op(spec: TxnSpec, part: TxnPart) -> Op:
    return Op(OpType.TXN_ABORT, part.keys, (spec, part.shard_id),
              part.decide_rpc)


def single_shard_op(spec: TxnSpec) -> Op:
    """The 1-RTT short-circuit: the whole transaction as one atomic op on
    its only shard, under the prepare identity (a retry that got promoted to
    2PC, or vice versa, can never double-apply)."""
    (part,) = spec.parts
    return Op(OpType.TXN, part.keys, (spec, part.shard_id), part.prepare_rpc)


@dataclass
class TxnOutcome:
    status: TxnStatus
    reads: Optional[Dict[Any, Any]]   # read-set values; None unless committed
    rtts: int                         # message rounds the coordinator paid
    fast_path: bool                   # every prepare leg completed in 1 RTT
    n_shards: int
    abort_reason: Optional[str] = None


# ---------------------------------------------------------------------------
# Participant state + recovery resolution (Sinfonia recovery-coordinator)
# ---------------------------------------------------------------------------
def participant_state(master, spec: TxnSpec, part: TxnPart) -> str:
    """One participant's view: 'committed' / 'aborted' / 'decided' (decision
    applied but result since acked away) / 'prepared' / 'none'."""
    rec = master.rifl.check_duplicate(part.decide_rpc)
    if rec is not None:
        if rec.result == "COMMITTED":
            return "committed"
        if rec.result == "ABORTED":
            return "aborted"
        return "decided"
    if master.store.txn_intent(spec.txn_id) is not None:
        return "prepared"
    return "none"


def resolve_txn(cluster, spec: TxnSpec) -> TxnStatus:
    """Finish an orphaned transaction from participant intent state alone.

    Rule: COMMIT iff some participant already committed (the coordinator may
    have externalized success) or EVERY participant holds a prepared intent
    (the coordinator was bound to commit); ABORT otherwise.  The decision is
    applied at every participant — including 'none' ones, where the abort
    lands as a RIFL tombstone that refuses any straggling PREPARE.
    """
    states = {
        p.shard_id: participant_state(cluster.shards[p.shard_id].master,
                                       spec, p)
        for p in spec.parts
    }
    if any(s == "committed" for s in states.values()):
        decision = TxnStatus.COMMITTED
    elif any(s == "aborted" for s in states.values()):
        decision = TxnStatus.ABORTED
    elif all(s in ("prepared", "decided") for s in states.values()):
        decision = TxnStatus.COMMITTED
    else:
        decision = TxnStatus.ABORTED
    for part in spec.parts:
        if states[part.shard_id] in ("committed", "aborted"):
            continue  # decision already durable at this participant
        group = cluster.shards[part.shard_id]
        op = (commit_op(spec, part) if decision is TxnStatus.COMMITTED
              else abort_op(spec, part))
        group.txn_decide(op)
    return decision


def resolve_pending(cluster) -> Dict[str, int]:
    """Sweep every shard for undecided intents (post-crash hygiene) and
    resolve each.  Returns {'resolved', 'committed', 'aborted'} counts."""
    seen: Dict[Tuple[int, int], TxnSpec] = {}
    for group in cluster.shards:
        for txn_id, (spec, _part) in group.master.store.txn_intents().items():
            seen.setdefault(txn_id, spec)
    out = {"resolved": 0, "committed": 0, "aborted": 0}
    for spec in seen.values():
        decision = resolve_txn(cluster, spec)
        out["resolved"] += 1
        out["committed" if decision is TxnStatus.COMMITTED else "aborted"] += 1
    return out


# ---------------------------------------------------------------------------
# The coordinator (client side of the 2PC)
# ---------------------------------------------------------------------------
# Stages passed to the crash-injection hook, in message order.  The hook is
# called BEFORE each message leaves the coordinator; raising CoordinatorCrash
# models the client dying with that message (and everything after) unsent.
STAGE_PREPARE = "prepare"     # about to send leg k's PREPARE
STAGE_DECIDE = "decide"       # about to send leg k's COMMIT/ABORT


class TxnCoordinator:
    """Drives one transaction through a ShardedCluster.

    The coordinator is client-session state: all RIFL identities come from
    the session's space, so a re-run with the same spec is a RIFL-dedup'd
    retry, not a new transaction.

    Intent-conflict policy (``wound_wait``, default on): instead of voting
    NO on ANY foreign intent, conflicts order deterministically by txn_id —
    **lower txn_id wins**.  A prepare that hits a HIGHER-id holder wounds it
    through the safe resolve primitive (``resolve_txn`` commits the holder
    iff it was already fully prepared, aborts-with-tombstones otherwise —
    either way its locks drop) and retries; a prepare that hits a LOWER-id
    holder waits-by-retry up to ``wait_retries`` times (the older holder
    decides soon under live interleaving), then falls back to the vote-NO
    abort.  Deadlock-free: in any conflict cycle the lowest txn wounds its
    way through, and waits are bounded.
    """

    def __init__(self, cluster, session, wound_wait: bool = True,
                 wait_retries: int = 3) -> None:
        self.cluster = cluster
        self.session = session
        self.wound_wait = wound_wait
        self.wait_retries = wait_retries
        self.wounds = 0          # holders resolved out of the way
        self.waits = 0           # bounded prepare retries spent waiting
        # Optional black-box journal: intent begin/decide events bracket the
        # 2PC window the watchdog's intent-leak monitor bounds.
        self.journal = None
        reg = get_registry()
        self._m_leg = {
            "prepare_granted": reg.counter("txn.legs.prepare_granted"),
            "prepare_refused": reg.counter("txn.legs.prepare_refused"),
            "commit": reg.counter("txn.legs.commit"),
            "abort": reg.counter("txn.legs.abort"),
            "single_1rtt": reg.counter("txn.legs.single_1rtt"),
            "wounds": reg.counter("txn.wounds"),
            "waits": reg.counter("txn.waits"),
        }

    def run(
        self,
        spec: TxnSpec,
        now: float = 0.0,
        on_message: Optional[Callable[[str, int, int], None]] = None,
    ) -> TxnOutcome:
        hook = on_message or (lambda stage, shard_id, idx: None)
        if len(spec.parts) == 1:
            return self._run_single(spec, now, hook)
        return self._run_2pc(spec, now, hook)

    # -- single-shard short-circuit (1 RTT, untouched fast path) -------------
    def _run_single(self, spec: TxnSpec, now: float, hook) -> TxnOutcome:
        (part,) = spec.parts
        hook(STAGE_PREPARE, part.shard_id, 0)
        group = self.cluster.shards[part.shard_id]
        sub = self.session.session_for(part.shard_id)
        out = group.update(sub, single_shard_op(spec), now)
        self._m_leg["single_1rtt"].inc()
        _status, read_vals = out.value
        return TxnOutcome(
            status=TxnStatus.COMMITTED,
            reads=dict(zip(part.read_keys, read_vals)),
            rtts=out.rtts,
            fast_path=out.fast_path,
            n_shards=1,
        )

    def _prepare_leg(self, spec: TxnSpec, part: TxnPart,
                     now: float) -> "TxnVote":
        """One PREPARE leg under the wound/wait policy (class docstring).
        Retrying re-sends the SAME op (same prepare_rpc): a refused prepare
        recorded nothing, so the identity is still fresh."""
        group = self.cluster.shards[part.shard_id]
        sub = self.session.session_for(part.shard_id)
        vote = group.txn_prepare(sub, prepare_op(spec, part), now)
        waited = 0
        while (self.wound_wait and not vote.granted
               and vote.error == "TXN_LOCKED" and vote.blocking is not None):
            if spec.txn_id < vote.blocking.txn_id:
                # We are older: wound the younger holder (safe — resolve
                # commits it iff it was already fully prepared).
                resolve_txn(self.cluster, vote.blocking)
                self.wounds += 1
                self._m_leg["wounds"].inc()
            else:
                # We are younger: wait-by-retry for the older holder.
                if waited >= self.wait_retries:
                    break
                waited += 1
                self.waits += 1
                self._m_leg["waits"].inc()
            vote = group.txn_prepare(sub, prepare_op(spec, part), now)
        self._m_leg[
            "prepare_granted" if vote.granted else "prepare_refused"
        ].inc()
        return vote

    # -- the 2PC proper ------------------------------------------------------
    def _run_2pc(self, spec: TxnSpec, now: float, hook) -> TxnOutcome:
        jr = self.journal
        if jr is not None:
            jr.emit("intent", actor="txn", phase="begin", txn=spec.txn_id,
                    parts=len(spec.parts))
        votes: Dict[int, Any] = {}
        all_fast = True
        max_rtts = 1
        abort_reason = None
        for idx, part in enumerate(spec.parts):
            hook(STAGE_PREPARE, part.shard_id, idx)
            vote = self._prepare_leg(spec, part, now)
            votes[part.shard_id] = vote
            if not vote.granted:
                abort_reason = vote.error
                break
            all_fast = all_fast and vote.fast
            max_rtts = max(max_rtts, vote.rtts)

        from .client import decide_commit

        commit = decide_commit(votes.values(), len(spec.parts))
        if jr is not None:
            jr.emit("intent", actor="txn", phase="decide", txn=spec.txn_id,
                    commit=commit)
        for idx, part in enumerate(spec.parts):
            hook(STAGE_DECIDE, part.shard_id, idx)
            op = commit_op(spec, part) if commit else abort_op(spec, part)
            self.cluster.shards[part.shard_id].txn_decide(
                op, self.session.session_for(part.shard_id)
            )
            self._m_leg["commit" if commit else "abort"].inc()
        if not commit:
            return TxnOutcome(
                status=TxnStatus.ABORTED, reads=None,
                rtts=max_rtts + 1, fast_path=False,
                n_shards=len(spec.parts), abort_reason=abort_reason,
            )
        reads: Dict[Any, Any] = {}
        for part in spec.parts:
            reads.update(zip(part.read_keys, votes[part.shard_id].read_values))
        # Prepare round (1 RTT when every leg was witness-fast) + decide
        # round: the multi-shard floor is 2 message rounds.
        return TxnOutcome(
            status=TxnStatus.COMMITTED, reads=reads,
            rtts=max_rtts + 1, fast_path=all_fast,
            n_shards=len(spec.parts),
        )


@dataclass
class TxnVote:
    """A participant's PREPARE reply, folded with its witness statuses."""
    granted: bool
    fast: bool = False                 # leg completed via 1-RTT witness path
    rtts: int = 1
    read_values: Tuple[Any, ...] = ()
    error: Optional[str] = None
    # On a TXN_LOCKED refusal: the holder's spec, so the coordinator's
    # wound/wait policy can order the conflict by txn_id.
    blocking: Optional["TxnSpec"] = None
