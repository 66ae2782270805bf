"""CURP witness (§3.2.2, §4.1, §4.2, §4.5).

A witness guarantees durability-without-ordering: it accepts a record only if
it commutes with everything it currently holds (disjoint 64-bit key hashes).
The data structure is a W-way set-associative cache over key hashes (§4.2,
Appendix B.1: direct-mapped conflicts after ~80 inserts at 4096 slots; 4-way
associativity fixes that).

This Python object is the protocol-level reference; the GPU-side batched
version is the gang kernels in repro_torch/kernels/csrc/ (held against this
semantics through their plain PyTorch versions in repro_torch/kernels/ref.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .merge import CLS_OTHER, conflicts
from .telemetry import get_registry
from .types import (
    GcResp,
    Op,
    RecordStatus,
    RpcId,
    WitnessMode,
)


@dataclass
class _Slot:
    key_hash: int = 0
    rpc_id: Optional[RpcId] = None
    request: Optional[Op] = None
    occupied: bool = False
    gc_age: int = 0  # number of master gc rounds survived (§4.5 suspicion)
    op_class: int = 0  # merge-lattice class of the held pair (repro.core.merge)


class Witness:
    """One witness instance serving one master (started via ``start``)."""

    # §4.5: a surviving record is suspected as uncollected garbage after this
    # many gc rounds ("three is a good number if a master performs only one gc
    # RPC at a time").
    SUSPECT_AGE = 3

    def __init__(self, n_sets: int = 1024, n_ways: int = 4,
                 class_budget: Optional[int] = None) -> None:
        self.n_sets = n_sets
        self.n_ways = n_ways
        # Per-class way budget: cap on how many ways of ONE set a single
        # mergeable (key_hash, class) stack may occupy.  Without it a hot
        # commuting key (INCR storm) fills all W ways between gc rounds and
        # every other class mapping to that set rejects as full — the budget
        # bounds the stack so non-merge traffic keeps a seat.  None (the
        # default, and the paper's behavior) disables the cap.  Host-witness
        # knob only: the device kernels implement the uncapped semantics, so
        # parity checks run with the default.
        self.class_budget = class_budget
        self.mode = WitnessMode.ENDED
        self.master_id: Optional[int] = None
        self._slots: List[List[_Slot]] = []
        # Optional black-box journal (repro.core.journal); the watchdog's
        # durability monitor counts per-rpc witness accepts through this.
        self.journal = None
        self.journal_actor = "w?"
        self.stats = {"accepts": 0, "accepts_dup": 0, "rejects_conflict": 0,
                      "rejects_full": 0, "rejects_mode": 0,
                      "rejects_budget": 0, "gc_drops": 0}
        reg = get_registry()
        self._m_accepts = reg.counter("witness.accepts")
        self._m_dups = reg.counter("witness.dups")
        self._m_rej_conflict = reg.counter("witness.rejects_conflict")
        self._m_rej_full = reg.counter("witness.rejects_full")
        self._m_rej_mode = reg.counter("witness.rejects_mode")
        self._m_gc_drops = reg.counter("witness.gc_drops")

    # -- lifecycle (Fig. 4: coordinator -> witness) ---------------------------
    def start(self, master_id: int) -> bool:
        self.master_id = master_id
        self.mode = WitnessMode.NORMAL
        self._slots = [
            [_Slot() for _ in range(self.n_ways)] for _ in range(self.n_sets)
        ]
        return True

    def end(self) -> None:
        self.mode = WitnessMode.ENDED
        self.master_id = None
        self._slots = []

    # -- client -> witness ----------------------------------------------------
    def record(
        self,
        master_id: int,
        key_hashes: Tuple[int, ...],
        rpc_id: RpcId,
        request: Op,
    ) -> RecordStatus:
        """Accept iff commutative with all held requests AND space available.

        Commutativity is the WIDENED merge-lattice relation (repro.core.merge):
        a same-key-hash pair conflicts only if its op classes conflict, so two
        concurrent INCRs (or SADDs, APPENDs, MAXes, disjoint-field HMSETs) of
        one key coexist in different ways of the same set.

        Multi-object updates (§4.2): the commutativity and space check runs for
        every affected object; on accept the request is written n times, once
        per object.  Ways are RESERVED as the placement loop claims them —
        two pairs of one op that land in the same set take distinct free ways
        (and reject as full when the set can't seat them all), instead of the
        old compute-all-then-write aliasing that let the second key silently
        clobber the first out of gc/recovery data.
        """
        if self.mode is not WitnessMode.NORMAL or master_id != self.master_id:
            self.stats["rejects_mode"] += 1
            self._m_rej_mode.inc()
            return self._jrecord(rpc_id, master_id, RecordStatus.REJECTED,
                                 "mode")

        pairs = self._pairs(key_hashes, request)
        placements: List[Tuple[int, int, int, int]] = []  # (set, way, kh, cls)
        claimed: set = set()   # (set_idx, way) taken by earlier pairs of THIS op
        placed: set = set()    # (kh, cls) pairs of THIS op already seated
        any_dup = False
        for kh, cls in pairs:
            if (kh, cls) in placed:
                # The op lists the same key twice (e.g. MSET a=1 a=2): one
                # slot covers both occurrences — the conflict check is
                # identical and recovery dedupes by rpc_id anyway.
                continue
            placed.add((kh, cls))
            set_idx = kh % self.n_sets
            ways = self._slots[set_idx]
            free_way = None
            is_dup = False
            stack = 0   # occupied ways already holding this (kh, cls) stack
            for w, slot in enumerate(ways):
                if slot.occupied:
                    if slot.key_hash == kh and slot.rpc_id == rpc_id:
                        # Duplicate record RPC (client retry): idempotent accept.
                        free_way = w
                        is_dup = True
                        any_dup = True
                        break
                    if slot.key_hash == kh:
                        if conflicts(slot.op_class, cls):
                            # Non-commutative with a held request: must reject —
                            # the witness cannot order them (§3.2.2).
                            self.stats["rejects_conflict"] += 1
                            self._m_rej_conflict.inc()
                            self._note_suspect(slot)
                            return self._jrecord(rpc_id, master_id,
                                                 RecordStatus.REJECTED,
                                                 "conflict")
                        if slot.op_class == cls:
                            stack += 1
                elif free_way is None and (set_idx, w) not in claimed:
                    free_way = w
            if not is_dup and self.class_budget is not None \
                    and stack >= self.class_budget:
                # The mergeable stack for this (kh, cls) is at its way
                # budget: reject so the op takes the sync path instead of
                # starving other classes out of this set.
                self.stats["rejects_budget"] += 1
                return self._jrecord(rpc_id, master_id, RecordStatus.REJECTED,
                                     "budget")
            if free_way is None:
                self.stats["rejects_full"] += 1
                self._m_rej_full.inc()
                return self._jrecord(rpc_id, master_id, RecordStatus.REJECTED,
                                     "full")
            claimed.add((set_idx, free_way))
            placements.append((set_idx, free_way, kh, cls))

        for set_idx, way, kh, cls in placements:
            slot = self._slots[set_idx][way]
            slot.key_hash = kh
            slot.rpc_id = rpc_id
            slot.request = request
            slot.occupied = True
            slot.gc_age = 0
            slot.op_class = cls
        self.stats["accepts"] += 1
        self._m_accepts.inc()
        if any_dup:
            self.stats["accepts_dup"] += 1
            self._m_dups.inc()
        return self._jrecord(rpc_id, master_id, RecordStatus.ACCEPTED, "ok")

    def _jrecord(self, rpc_id: RpcId, master_id: int,
                 status: "RecordStatus", why: str) -> "RecordStatus":
        jr = self.journal
        if jr is not None:
            jr.emit("record", actor=self.journal_actor, rpc=rpc_id,
                    mid=master_id,
                    status="accepted" if status is RecordStatus.ACCEPTED
                    else "rejected", why=why)
        return status

    @staticmethod
    def _pairs(key_hashes: Tuple[int, ...], request: Optional[Op]):
        """The (key_hash, class) pairs to place.  Derived from the request
        when the caller passed its routing hashes (the Fig. 4 RPC always
        does); a bare hash list falls back to the conservative OTHER class,
        reproducing the un-widened check exactly."""
        if request is not None and \
                tuple(request.key_hashes()) == tuple(key_hashes):
            return request.hash_classes()
        return tuple((kh, CLS_OTHER) for kh in key_hashes)

    def record_batch(self, master_id: int, ops: List[Op]) -> List[RecordStatus]:
        """One witness invocation for a whole update batch (the batched
        client path): per-op accept/reject with the same in-order semantics
        as issuing ``record`` once per op.  The kernel-backed DeviceWitness
        overrides this with a single set-parallel kernel call."""
        return [
            self.record(master_id, op.key_hashes(), op.rpc_id, op)
            for op in ops
        ]

    # -- master -> witness ----------------------------------------------------
    def gc(self, entries: Tuple[Tuple[int, RpcId], ...]) -> GcResp:
        """Drop synced records; report suspected uncollected garbage (§4.5)."""
        if self.mode is not WitnessMode.NORMAL:
            return GcResp(stale_requests=())
        for kh, rpc_id in entries:
            set_idx = kh % self.n_sets
            for slot in self._slots[set_idx]:
                if slot.occupied and slot.key_hash == kh and slot.rpc_id == rpc_id:
                    slot.occupied = False
                    slot.request = None
                    slot.rpc_id = None
                    self.stats["gc_drops"] += 1
                    self._m_gc_drops.inc()
        # Age all survivors; collect suspects.
        stale: List[Op] = []
        seen: set = set()
        for ways in self._slots:
            for slot in ways:
                if slot.occupied:
                    slot.gc_age += 1
                    if slot.gc_age >= self.SUSPECT_AGE and slot.rpc_id not in seen:
                        seen.add(slot.rpc_id)
                        stale.append(slot.request)
        jr = self.journal
        if jr is not None:
            jr.emit("gc", actor=self.journal_actor, mid=self.master_id,
                    entries=len(entries), stale=len(stale))
        return GcResp(stale_requests=tuple(stale))

    def get_recovery_data(self, master_id: int) -> Tuple[Op, ...]:
        """Irreversibly freeze (recovery mode) and return all held requests."""
        if self.master_id != master_id or self.mode is WitnessMode.ENDED:
            return ()
        self.mode = WitnessMode.RECOVERY
        out: Dict[RpcId, Op] = {}
        for ways in self._slots:
            for slot in ways:
                if slot.occupied and slot.request is not None:
                    out[slot.rpc_id] = slot.request  # dedupe multi-key entries
        return tuple(out.values())

    # -- §A.1 consistent reads from backups ------------------------------------
    def commutes_with_all(self, key_hashes: Tuple[int, ...],
                          classes: Optional[Tuple[int, ...]] = None) -> bool:
        """True iff no held request CONFLICTS with any of these pairs under
        the merge lattice.  Without ``classes`` the query is the conservative
        OTHER class — it conflicts with every held class, i.e. the original
        "no held request touches these keys" read check."""
        if self.mode is not WitnessMode.NORMAL:
            return False
        if classes is None:
            classes = (CLS_OTHER,) * len(key_hashes)
        for kh, cls in zip(key_hashes, classes):
            set_idx = kh % self.n_sets
            for slot in self._slots[set_idx]:
                if slot.occupied and slot.key_hash == kh \
                        and conflicts(slot.op_class, cls):
                    return False
        return True

    # -- internals -------------------------------------------------------------
    def _note_suspect(self, slot: _Slot) -> None:
        # Rejection against an old record hints at uncollected garbage; the
        # aging in gc() will surface it to the master.
        pass

    @property
    def occupancy(self) -> int:
        return sum(1 for ways in self._slots for s in ways if s.occupied)


def record_many(witnesses: Sequence[Witness], master_id: int,
                key_hashes: Tuple[int, ...], rpc_id: RpcId,
                request: Op) -> List[RecordStatus]:
    """One op's record at each of ``witnesses``, in order: a ``record`` call
    each (the device backend's counterpart is one dispatch for all)."""
    return [w.record(master_id, key_hashes, rpc_id, request)
            for w in witnesses]


def gc_many(witnesses: Sequence[Witness],
            entries: Tuple[Tuple[int, RpcId], ...]) -> List[GcResp]:
    """One sync batch's gc at each of ``witnesses``, in order."""
    return [w.gc(entries) for w in witnesses]
