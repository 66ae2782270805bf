"""Kernel-backed CURP witness: the accept/reject hot path runs on device.

``DeviceWitness`` is a drop-in for :class:`repro_torch.core.witness.Witness`
whose conflict/capacity decisions come from the CUDA gang kernels
(repro_torch.kernels; their plain PyTorch versions when the gang lives on
the CPU).  The kernel table holds MORE than
the keyhash lanes: every slot carries the recording op's RIFL identity
(rpc_hi/rpc_lo) and a §4.5 gc-age counter, so

  * duplicate record retries (same rpc_id, same key) are accepted
    idempotently IN-KERNEL (reason code 2),
  * gc entries whose rpc_id doesn't match the held record are ignored
    IN-KERNEL (the clear requires key AND rpc to match), so a stale gc can
    never drop a newer same-key record,
  * survivors age in-kernel per gc round.

The host mirror (mixed keyhash lanes -> (rpc_id, Op)) is demoted to a
RECOVERY-TIME VIEW: it stores the Op objects the device cannot hold (replay
data for ``get_recovery_data``), answers ``commutes_with_all`` for backup
reads, and carries the suspect ages reported to the master — it is never
consulted to decide accept/reject/gc outcomes on the hot path.

Many witness instances share one device-resident **gang**
(:class:`WitnessGang`): all shards' x all witnesses' tables stacked into a
single [n_lanes*S, W] array, so a routed cross-shard batch records at every
target lane in ONE dispatch (repro_torch.kernels.gang_fastpath_batch), a
lone op records at every witness of a shard in ONE dispatch
(``record_many``) and a sync round gc's every witness of a shard in ONE
dispatch (``gc_many``).

Set placement differs from the Python witness (keyhash2x32-mixed low lane
masked by S-1, vs ``kh % n_sets`` on the raw 64-bit hash), so occupancy
patterns differ between backends; accept/reject *semantics* do not.

Multi-key ops resolve all-or-nothing through the grouped record kernel
(repro_torch.kernels.gang_record_groups): every key's conflict/capacity verdict is
computed against the pre-op table and writes happen only when the whole op
accepted — ONE dispatch whether the op accepts or rejects, for a whole batch
of multi-key ops at once.  The pre-refactor record-then-rollback scheme
(2 dispatches on the reject path) is kept as ``_record_keys_rollback`` for
the old-vs-new comparison that ``chip_smoke.py``'s transaction phase makes,
as the JAX package's benchmarks/fig_txn.py does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .merge import CLS_OTHER, conflicts
from .types import GcResp, Op, RecordStatus, RpcId, WitnessMode

_M32 = 0xFFFFFFFF

# Reason codes emitted by the gang kernels (repro_torch.kernels.ref).
_R_INSERT = 1
_R_DUP = 2
_R_CONFLICT = 3
_R_FULL = 4

_REASON_STAT = {
    _R_INSERT: "reason_insert",
    _R_DUP: "reason_dup",
    _R_CONFLICT: "reason_conflict",
    _R_FULL: "reason_full",
}


@dataclass
class _Held:
    rpc_id: RpcId
    request: Op
    gc_age: int = 0
    op_class: int = 0


def _op_pairs(key_hashes, request: Optional[Op]):
    """The (key_hash, class) pairs to place — same derivation rule as
    ``Witness._pairs``: trust the request's lattice expansion only when the
    caller passed its own routing hashes; bare hash lists get the
    conservative OTHER class (un-widened CURP check)."""
    if request is not None and tuple(request.key_hashes()) == tuple(key_hashes):
        return request.hash_classes()
    return tuple((kh, CLS_OTHER) for kh in key_hashes)


def _lanes(khs) -> Tuple[np.ndarray, np.ndarray]:
    hi = np.fromiter(((kh >> 32) & _M32 for kh in khs), np.uint32, len(khs))
    lo = np.fromiter((kh & _M32 for kh in khs), np.uint32, len(khs))
    return hi, lo


def _rpc_lanes(rpc_ids: Sequence[RpcId]) -> Tuple[np.ndarray, np.ndarray]:
    hi = np.fromiter((r[0] & _M32 for r in rpc_ids), np.uint32, len(rpc_ids))
    lo = np.fromiter((r[1] & _M32 for r in rpc_ids), np.uint32, len(rpc_ids))
    return hi, lo


class WitnessGang:
    """Device-resident stack of witness tables (one lane per instance).

    Owns the single :class:`repro_torch.kernels.GangTable` that every
    attached ``DeviceWitness`` records into; lanes are allocated on
    ``start`` and recycled on ``end``.  The gang starts with the least power
    of two lanes that holds ``n_lanes`` witnesses and grows by doubling (a
    device-side concat of zero rows), so the lane count stays a power of
    two, as the JAX package's tiling required.

    The gang lives on ``device``: ``"cuda"`` (the default) runs the CUDA
    kernels and raises when no CUDA device is present; ``"cpu"`` runs
    their plain PyTorch versions (the tests).
    """

    def __init__(self, n_sets: int = 1024, n_ways: int = 4,
                 n_lanes: int = 4, device="cuda") -> None:
        from ..kernels import N_REASON_CODES, GangTable
        from ..kernels.ref import resolve_device

        self.device = device = resolve_device(device)
        self.n_sets = n_sets
        self.n_ways = n_ways
        self.n_lanes = n_lanes = 1 << max(n_lanes - 1, 0).bit_length()
        self.table = GangTable.empty(n_sets, n_ways, n_lanes, device)
        # In-dispatch telemetry plane: [n_lanes, 5] reason-code counters the
        # record kernels accumulate into (flight recorder).  Drained and
        # zeroed by ``drain_counters``.
        self.counters = torch.zeros((n_lanes, N_REASON_CODES),
                                    dtype=torch.int32, device=device)
        self._free = list(range(n_lanes - 1, -1, -1))
        self._dirty: set = set()

    def drain_counters(self) -> np.ndarray:
        """Materialize the per-lane reason-code counters and zero the plane.

        Returns an [n_lanes, 5] int32 numpy array (columns indexed by the
        kernel reason codes; column 0 is unused).  Bit-exact with the host
        ``DeviceWitness.stats["reason_*"]`` accounting over the same drain
        interval — tests assert the parity.
        """
        out = self.counters.cpu().numpy().copy()
        self.counters.zero_()
        return out

    def alloc(self) -> int:
        if not self._free:
            self._grow()
        lane = self._free.pop()
        if lane in self._dirty:
            self._zero(lane)
            self._dirty.discard(lane)
        return lane

    def free(self, lane: int) -> None:
        self._dirty.add(lane)
        self._free.append(lane)

    def _grow(self) -> None:
        from ..kernels import GangTable

        old = self.n_lanes
        self.n_lanes = old * 2
        self.table = GangTable(*(
            torch.cat([a, torch.zeros_like(a)]) for a in self.table
        ))
        self.counters = torch.cat([self.counters,
                                   torch.zeros_like(self.counters)])
        self._free.extend(range(self.n_lanes - 1, old - 1, -1))

    def _zero(self, lane: int) -> None:
        # Only occupancy and age gate kernel decisions; stale key/rpc lanes
        # under occ == 0 are never read.
        rows = slice(lane * self.n_sets, (lane + 1) * self.n_sets)
        self.table.occ[rows] = 0
        self.table.age[rows] = 0
        # A recycled lane starts its telemetry from zero too, so per-lane
        # counters always describe the CURRENT tenant.
        self.counters[lane] = 0


class DeviceWitness:
    """One witness instance serving one master; table state lives in one
    lane of a (possibly shared) device-resident gang."""

    SUSPECT_AGE = 3

    def __init__(self, n_sets: int = 1024, n_ways: int = 4,
                 gang: Optional[WitnessGang] = None,
                 device="cuda") -> None:
        self.n_sets = n_sets
        self.n_ways = n_ways
        self.device = device      # of the private gang, if one is made
        self.mode = WitnessMode.ENDED
        self.master_id: Optional[int] = None
        self.gang = gang          # shared gang, or private (made on start)
        self.lane: Optional[int] = None
        # mixed (q_hi, q_lo) -> {rpc_id -> metadata}: the recovery-time
        # view.  Nested because the merge lattice lets several MERGEABLE
        # records of one key coexist (one device slot each, one rpc each).
        self._held: Dict[Tuple[int, int], Dict[RpcId, _Held]] = {}
        self.stats = {"accepts": 0, "rejects_conflict": 0, "rejects_full": 0,
                      "rejects_mode": 0, "gc_drops": 0, "kernel_batches": 0,
                      # Host-side mirror of the device reason-counter plane
                      # (same granularity as the kernel's accumulation: one
                      # count per settled outcome).  Parity-asserted against
                      # ``WitnessGang.drain_counters`` by the telemetry
                      # tests.
                      "reason_insert": 0, "reason_dup": 0,
                      "reason_conflict": 0, "reason_full": 0}

    # -- lifecycle (Fig. 4: coordinator -> witness) ---------------------------
    def start(self, master_id: int) -> bool:
        if self.gang is None:
            self.gang = WitnessGang(self.n_sets, self.n_ways, n_lanes=1,
                                    device=self.device)
        elif (self.gang.n_sets, self.gang.n_ways) != (self.n_sets,
                                                      self.n_ways):
            raise ValueError("witness geometry does not match its gang")
        if self.lane is None:
            self.lane = self.gang.alloc()
        self.master_id = master_id
        self.mode = WitnessMode.NORMAL
        self._held = {}
        return True

    def end(self) -> None:
        self.mode = WitnessMode.ENDED
        self.master_id = None
        if self.lane is not None:
            self.gang.free(self.lane)
            self.lane = None
        self._held = {}

    # -- client -> witness ----------------------------------------------------
    def record(
        self, master_id: int, key_hashes: Tuple[int, ...], rpc_id: RpcId,
        request: Op,
    ) -> RecordStatus:
        """Single-op record: a group of one through the grouped kernel."""
        return record_many([self], master_id, key_hashes, rpc_id, request)[0]

    def record_batch(self, master_id: int, ops: List[Op]) -> List[RecordStatus]:
        """Whole-batch record, ONE kernel dispatch, any mix of group sizes.

        All-single-key batches (the batched client path's common case) go
        through the set-parallel kernel; batches containing multi-key ops go
        through the grouped all-or-nothing kernel.  Batch order is preserved
        exactly in both (the set-parallel prep keeps per-set order; the
        grouped kernel is sequential in group index)."""
        if self.mode is not WitnessMode.NORMAL or master_id != self.master_id:
            self.stats["rejects_mode"] += len(ops)
            return [RecordStatus.REJECTED] * len(ops)
        if not ops:
            return []
        from ..kernels import gang_record

        pairs = [op.hash_classes() for op in ops]
        if any(len(p) != 1 for p in pairs):
            # Groups are the ops' lattice pairs: HMSET contributes its
            # derived per-field FIELD sub-hashes, so field overlap
            # conflicts in-kernel.
            return _record_groups([(self, p, op.rpc_id, op)
                                   for op, p in zip(ops, pairs)])
        khs = [p[0][0] for p in pairs]
        kcls = np.fromiter((p[0][1] for p in pairs), np.int32, len(pairs))
        hi, lo = _lanes(khs)
        rhi, rlo = _rpc_lanes([op.rpc_id for op in ops])
        lanes = np.full(len(ops), self.lane, np.int32)
        rsn, qh, ql, table, counters = gang_record(
            self.gang.table, self.n_sets, hi, lo, lanes, rhi, rlo, kcls,
            counters=self.gang.counters,
        )
        self.gang.table = table
        self.gang.counters = counters
        self.stats["kernel_batches"] += 1
        return [
            self._settle(int(rsn[i]), [(int(qh[i]), int(ql[i]))],
                         ops[i].rpc_id, ops[i], [int(kcls[i])])
            for i in range(len(ops))
        ]

    def _settle(self, reason: int, keys: List[Tuple[int, int]],
                rpc_id: RpcId, request: Op,
                classes: List[int]) -> RecordStatus:
        """Fold a kernel reason code into protocol status + mirror + stats.

        The mirror write mirrors the Python reference's slot overwrite: on
        any accept (fresh insert or idempotent dup) every key's entry is
        re-stamped with age 0.  Entries nest per rpc so mergeable same-key
        records (each holding its own device slot) coexist in the mirror."""
        self.stats[_REASON_STAT[reason]] += 1
        if reason in (_R_INSERT, _R_DUP):
            for key, cls in zip(keys, classes):
                self._held.setdefault(key, {})[rpc_id] = _Held(
                    rpc_id, request, op_class=cls
                )
            self.stats["accepts"] += 1
            return RecordStatus.ACCEPTED
        if reason == _R_CONFLICT:
            self.stats["rejects_conflict"] += 1
        else:
            self.stats["rejects_full"] += 1
        return RecordStatus.REJECTED

    def _record_keys(self, key_hashes: Tuple[int, ...], rpc_id: RpcId,
                     request: Op) -> RecordStatus:
        """All-or-nothing multi-pair record: ONE grouped-kernel dispatch
        whether the op accepts or rejects (the kernel leaves the table
        bit-identical on reject, so no rollback gc).  Dup/conflict verdicts
        come from the kernel-held rpc lanes — no host mirror input."""
        return _record_groups([(self, _op_pairs(key_hashes, request), rpc_id,
                                request)])[0]

    def _record_keys_rollback(self, key_hashes: Tuple[int, ...], rpc_id: RpcId,
                              request: Op) -> RecordStatus:
        """Pre-refactor record-then-rollback scheme, kept only for an
        old-vs-new dispatch comparison (see the module docstring): the keys
        record individually (set-parallel dispatch) and any accepted prefix
        is rolled back by a second gc dispatch when the op rejects."""
        from ..kernels import gang_gc, gang_record

        khs = list(dict.fromkeys(key_hashes))
        hi, lo = _lanes(khs)
        K = len(khs)
        lanes = np.full(K, self.lane, np.int32)
        rhi = np.full(K, rpc_id[0] & _M32, np.uint32)
        rlo = np.full(K, rpc_id[1] & _M32, np.uint32)
        rsn, qh, ql, table = gang_record(
            self.gang.table, self.n_sets, hi, lo, lanes, rhi, rlo
        )
        self.stats["kernel_batches"] += 1
        ok = all(int(r) in (_R_INSERT, _R_DUP) for r in rsn)
        if ok:
            self.gang.table = table
            for k in range(K):
                key = (int(qh[k]), int(ql[k]))
                self._held.setdefault(key, {})[rpc_id] = _Held(
                    rpc_id, request, op_class=0
                )
            self.stats["accepts"] += 1
            return RecordStatus.ACCEPTED
        # Roll back freshly inserted keys (the second dispatch on reject);
        # dup hits predate this op and must survive.  No aging: a rollback
        # is not a §4.5 gc round.
        ins = [k for k in range(K) if int(rsn[k]) == _R_INSERT]
        if ins:
            _clr, table = gang_gc(
                table, self.n_sets,
                qh[ins], ql[ins], rhi[ins], rlo[ins], lanes[ins],
                np.zeros(self.gang.n_lanes, np.int32), do_age=False,
            )
        self.gang.table = table
        if any(int(r) == _R_CONFLICT for r in rsn):
            self.stats["rejects_conflict"] += 1
        else:
            self.stats["rejects_full"] += 1
        return RecordStatus.REJECTED

    # -- master -> witness ----------------------------------------------------
    def gc(self, entries: Tuple[Tuple[int, RpcId], ...]) -> GcResp:
        """Drop synced records (one gang gc dispatch); report suspects."""
        return gc_many([self], entries)[0]

    def _apply_gc(self, keys: List[Tuple[int, int]],
                  rpc_ids: List[RpcId], cleared) -> GcResp:
        """Fold per-entry cleared bits into mirror + stats; age survivors
        host-side for suspect reporting (the kernel ages its lanes too —
        that state is the device-side view of suspicion)."""
        for (key, rpc_id, clr) in zip(keys, rpc_ids, cleared):
            if not clr:
                continue
            by_rpc = self._held.get(key)
            if by_rpc is not None and rpc_id in by_rpc:
                del by_rpc[rpc_id]
                if not by_rpc:
                    del self._held[key]
            self.stats["gc_drops"] += 1
        stale: List[Op] = []
        seen: set = set()
        for by_rpc in self._held.values():
            for held in by_rpc.values():
                held.gc_age += 1
                if held.gc_age >= self.SUSPECT_AGE and held.rpc_id not in seen:
                    seen.add(held.rpc_id)
                    stale.append(held.request)
        return GcResp(stale_requests=tuple(stale))

    def get_recovery_data(self, master_id: int) -> Tuple[Op, ...]:
        """Irreversibly freeze (recovery mode) and return all held requests."""
        if self.master_id != master_id or self.mode is WitnessMode.ENDED:
            return ()
        self.mode = WitnessMode.RECOVERY
        out: Dict[RpcId, Op] = {}
        for by_rpc in self._held.values():
            for held in by_rpc.values():
                out[held.rpc_id] = held.request  # dedupe multi-key entries
        return tuple(out.values())

    # -- §A.1 consistent reads from backups ------------------------------------
    def commutes_with_all(self, key_hashes: Tuple[int, ...],
                          classes: Optional[Tuple[int, ...]] = None) -> bool:
        """True iff no held record CONFLICTS with any query pair under the
        merge lattice.  Without ``classes`` the query is the conservative
        OTHER class (conflicts with every held class) — the original "no
        held request touches these keys" read check."""
        if self.mode is not WitnessMode.NORMAL:
            return False
        if not key_hashes:
            return True
        from ..kernels import np_keyhash2x32

        if classes is None:
            classes = (CLS_OTHER,) * len(key_hashes)
        hi, lo = _lanes(list(key_hashes))
        qh, ql = np_keyhash2x32(hi, lo)
        for i, cls in enumerate(classes):
            by_rpc = self._held.get((int(qh[i]), int(ql[i])))
            if by_rpc and any(
                conflicts(h.op_class, cls) for h in by_rpc.values()
            ):
                return False
        return True

    @property
    def occupancy(self) -> int:
        return sum(len(by_rpc) for by_rpc in self._held.values())


def record_many(witnesses: Sequence[DeviceWitness], master_id: int,
                key_hashes: Tuple[int, ...], rpc_id: RpcId,
                request: Op) -> List[RecordStatus]:
    """Record one op at MANY witnesses of one gang in ONE dispatch.

    Every witness that ``record`` would not reject by mode becomes one group
    of the grouped kernel: the op's keys, classes and rpc at the witness's
    lane.  Lanes are disjoint, so each group resolves exactly as that
    witness's own ``record`` would; a witness not in NORMAL mode, or serving
    another master, rejects without a group, and with no group there is no
    dispatch.  Returns one status per witness, in order.
    """
    out = [RecordStatus.REJECTED] * len(witnesses)
    live = []
    for i, w in enumerate(witnesses):
        if w.mode is WitnessMode.NORMAL and master_id == w.master_id:
            live.append(i)
        else:
            w.stats["rejects_mode"] += 1
    if live:
        pairs = _op_pairs(key_hashes, request)
        got = _record_groups([(witnesses[i], pairs, rpc_id, request)
                              for i in live])
        for i, st in zip(live, got):
            out[i] = st
    return out


def _record_groups(
    groups: Sequence[Tuple[DeviceWitness, Sequence[Tuple[int, int]], RpcId,
                           Op]],
) -> List[RecordStatus]:
    """ONE grouped-kernel dispatch: each group, a (witness, pairs, rpc_id,
    request), records the op's (key_hash, class) pairs at its witness's
    lane, all or nothing, in group order.  One op at many witnesses (a
    group a lane) and many ops at one witness (a group an op) are both
    this call.  Each group settles at its witness, and each witness counts
    one kernel batch."""
    from ..kernels import gang_record_groups

    gang = groups[0][0].gang
    assert all(w.gang is gang for w, *_ in groups), \
        "witnesses must share a gang"
    G = len(groups)
    K = max(len(pairs) for _w, pairs, *_ in groups)
    khi = np.zeros((G, K), np.uint32)
    klo = np.zeros((G, K), np.uint32)
    kval = np.zeros((G, K), np.int32)
    kcls = np.zeros((G, K), np.int32)
    for g, (_w, pairs, _rpc, _req) in enumerate(groups):
        n = len(pairs)
        khi[g, :n], klo[g, :n] = _lanes([kh for kh, _c in pairs])
        kval[g, :n] = 1
        kcls[g, :n] = [c for _kh, c in pairs]
    rhi, rlo = _rpc_lanes([rpc for _w, _p, rpc, _req in groups])
    res = gang_record_groups(
        gang.table, gang.n_sets, khi, klo, kval,
        np.fromiter((w.lane for w, *_ in groups), np.int32, G), rhi, rlo,
        kcls, counters=gang.counters,
    )
    gang.table = res.table
    gang.counters = res.counters
    for w in dict.fromkeys(w for w, *_ in groups):
        w.stats["kernel_batches"] += 1
    return [
        w._settle(int(res.reasons[g]),
                  [(int(res.q_hi[g, k]), int(res.q_lo[g, k]))
                   for k in range(len(pairs))],
                  rpc, req, [c for _kh, c in pairs])
        for g, (w, pairs, rpc, req) in enumerate(groups)
    ]


def gc_many(witnesses: Sequence[DeviceWitness],
            entries: Tuple[Tuple[int, RpcId], ...]) -> List[GcResp]:
    """Gc the same sync batch at MANY witnesses of one gang in ONE dispatch.

    Entries are lane-expanded (every witness gets its own copy targeting its
    lane) and deduplicated per (key, rpc) — the Python reference clears a
    slot once however many times the pair appears.  Aging covers exactly
    the participating lanes.  A witness not in NORMAL mode takes no part and
    gets an empty response, as its own ``gc`` would; with no witness in
    NORMAL mode there is no dispatch.  Returns one GcResp per witness, in
    order.
    """
    from ..kernels import gang_gc, np_keyhash2x32

    out = [GcResp(stale_requests=()) for _ in witnesses]
    live = [i for i, w in enumerate(witnesses)
            if w.mode is WitnessMode.NORMAL]
    uniq = list(dict.fromkeys((kh, rpc) for kh, rpc in entries))
    if not live or not uniq:
        # Pure aging round: Python gc ages survivors even with no entries.
        for i in live:
            out[i] = witnesses[i]._apply_gc([], [], [])
        return out
    gang = witnesses[live[0]].gang
    assert all(witnesses[i].gang is gang for i in live), \
        "witnesses must share a gang"
    hi, lo = _lanes([kh for kh, _rpc in uniq])
    qh, ql = np_keyhash2x32(hi, lo)
    rhi, rlo = _rpc_lanes([rpc for _kh, rpc in uniq])
    E, L = len(uniq), len(live)
    lanes = np.fromiter((witnesses[i].lane for i in live), np.int32, L)
    aged = np.zeros(gang.n_lanes, np.int32)
    aged[lanes] = 1
    cleared, table = gang_gc(
        gang.table, gang.n_sets, np.tile(qh, L), np.tile(ql, L),
        np.tile(rhi, L), np.tile(rlo, L), np.repeat(lanes, E), aged,
    )
    gang.table = table
    keys = [(int(qh[e]), int(ql[e])) for e in range(E)]
    rpcs = [rpc for _kh, rpc in uniq]
    for j, i in enumerate(live):
        w = witnesses[i]
        w.stats["kernel_batches"] += 1
        out[i] = w._apply_gc(keys, rpcs,
                             [bool(c) for c in cleared[j * E:(j + 1) * E]])
    return out
