"""Seeded inputs for the kernels, and the kernel-against-plain checks.

The generators build numpy state and batches that reach every branch of
the kernels: a pre-filled table whose keys the batch hits again, idempotent
duplicates (a retried rpc), conflicts and mergeable-class stacking, rows
flooded past their ways (FULL), multi-key groups with same-row keys, stale
rpc gc entries, aged lanes, and ring spans that wrap past CAP.  An rpc's op
class is a function of its identity (one rpc is one op), as in the protocol.
For the single-table kernels: windows of mixed classes, invalid entries and
keys the batch repeats, so that scans hit and miss under every class
pairing.  For the transaction probe, a chain of multi-key ops over a table
near full (conflicts, FULL rejects, own-rpc retries, same-set inserters,
duplicate keys, padding); for the table gc, stale keys left in cleared
slots and repeated entries; for the sequential record, same keys held
under other classes.

The same inputs serve the CPU tests (plain versions against the JAX
package's oracles) and ``chip_smoke.py`` (each CUDA kernel against its
plain version on the card, :func:`check_kernels` for the gang kernels,
:func:`check_table_kernels` for the single-table ones and
:func:`check_txn_kernels` for the transaction probe, the table gc and the
sequential record).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import ops, ref

# SET, INCR, SADD, OTHER: conflicting, mergeable and catch-all classes.
CLASSES = np.array([0, 2, 5, 8], np.int32)

# Coverage codes of the single-table kernels beyond the reason codes 1, 3
# and 4 (insert, conflict, full) and ref.OUTCOME_STACKED (5): a query's key
# meets a valid window entry and the classes conflict (a hit), or it meets
# only valid entries whose classes the matrix lets commute (a miss).
SCAN_HIT = 6
SCAN_COMMUTES = 7
# The transaction probe's ops (beyond 1 accept, 3 conflict, 4 full): an
# accepted op with a key held under its own rpc, one whose inserters share a
# set (distinct ways), one with a key twice, and one padded to its bucket.
TXN_OWN_PASS = 8
TXN_SAME_SET = 9
TXN_DUP_KEY = 10
TXN_PADDED = 11
# The table gc's entries: one that clears an occupied slot, one that meets
# no slot, one whose key is left only in cleared slots (occ == 0: stays 0,
# no hit), one that repeats an earlier entry, and a batch of none.
GC_HIT = 12
GC_MISS = 13
GC_STALE = 14
GC_REPEAT = 15
GC_EMPTY = 16
N_CODES = 17

# The outcomes (reason codes; gc: cleared bits) each kernel's inputs must
# reach.  A fused batch carries fresh rpcs only, so its record stage never
# meets a DUP; that stage is the gang_record kernel, whose own inputs do.
# The single-table kernels return accept and conflict bits; their outcomes
# are read from the plain version on the same inputs.
BRANCHES = {"gang_record": (1, 2, 3, 4), "gang_record_groups": (1, 2, 3, 4),
            "gang_gc": (0, 1), "gang_fastpath": (1, 3, 4),
            "keyhash": (), "witness_record": (1, 3, 4, 5),
            "fastpath_record_scan": (1, 3, 4, 5, SCAN_HIT, SCAN_COMMUTES),
            "conflict_scan": (SCAN_HIT, SCAN_COMMUTES),
            "txn_probe": (1, 3, 4, TXN_OWN_PASS, TXN_SAME_SET, TXN_DUP_KEY,
                          TXN_PADDED),
            "witness_gc": (GC_HIT, GC_MISS, GC_STALE, GC_REPEAT, GC_EMPTY),
            "witness_record_seq": (1, 3, 4, 5)}


def cls_of_rpc(rpc_lo) -> np.ndarray:
    return CLASSES[np.asarray(rpc_lo, np.int64) % len(CLASSES)]


@dataclass
class KeyPool:
    """Raw 64-bit keyhash lanes and their mixed lanes, bucketed by set."""
    hi: np.ndarray
    lo: np.ndarray
    q_hi: np.ndarray
    q_lo: np.ndarray
    by_set: Dict[int, np.ndarray]


def key_pool(rng: np.random.Generator, n: int, n_sets: int) -> KeyPool:
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hi[: n // 8] |= np.uint32(0x80000000)       # sign bits set on purpose
    qh, ql = ref.np_keyhash2x32(hi, lo)
    sets = (ql & np.uint32(n_sets - 1)).astype(np.int64)
    order = np.argsort(sets, kind="stable")
    bounds = np.searchsorted(sets[order], np.arange(n_sets + 1))
    by_set = {s: order[bounds[s]:bounds[s + 1]] for s in range(n_sets)}
    return KeyPool(hi, lo, qh, ql, by_set)


def gang_planes(rng: np.random.Generator, pool: KeyPool, n_lanes: int,
                n_sets: int, n_ways: int, n_rpcs: int,
                fill: float = 0.5) -> Tuple[np.ndarray, ...]:
    """A pre-filled gang (six planes, the JAX package's dtypes): about
    ``fill`` of the ways hold pool keys (each key at most once per row)
    under rpcs drawn from ``n_rpcs`` identities, with ages 0..4."""
    R = n_lanes * n_sets
    khi = np.zeros((R, n_ways), np.uint32)
    klo = np.zeros((R, n_ways), np.uint32)
    occ = np.zeros((R, n_ways), np.int32)
    rhi = np.zeros((R, n_ways), np.uint32)
    rlo = np.zeros((R, n_ways), np.uint32)
    age = np.zeros((R, n_ways), np.int32)
    n_fill = int(fill * R * n_ways)
    picks = rng.integers(0, len(pool.hi), n_fill)
    lanes = rng.integers(0, n_lanes, n_fill)
    rpcs = rng.integers(0, n_rpcs, n_fill)
    for k, lane, rpc in zip(picks, lanes, rpcs):
        row = lane * n_sets + int(pool.q_lo[k] & np.uint32(n_sets - 1))
        held = (occ[row] > 0) & (khi[row] == pool.q_hi[k]) \
            & (klo[row] == pool.q_lo[k])
        free = np.flatnonzero(occ[row] == 0)
        if held.any() or not free.size:
            continue
        w = free[rng.integers(0, free.size)]
        khi[row, w], klo[row, w] = pool.q_hi[k], pool.q_lo[k]
        rhi[row, w], rlo[row, w] = 7, rpc
        occ[row, w] = 1 + cls_of_rpc(rpc)
        age[row, w] = rng.integers(0, 5)
    return khi, klo, occ, rhi, rlo, age


def record_batch(rng: np.random.Generator, pool: KeyPool, B: int,
                 n_lanes: int, n_sets: int, n_rpcs: int,
                 flood: int = 8) -> Dict[str, np.ndarray]:
    """[B] single-key queries: pool keys (hits and retries), fresh keys,
    and a flood of ``flood`` distinct keys into one row of lane 0."""
    k = rng.integers(0, len(pool.hi), B)
    key_hi, key_lo = pool.hi[k].copy(), pool.lo[k].copy()
    fresh = rng.random(B) < 0.25
    key_hi[fresh] = rng.integers(0, 2**32, fresh.sum(), dtype=np.uint64)
    key_lo[fresh] = rng.integers(0, 2**32, fresh.sum(), dtype=np.uint64)
    lanes = rng.integers(0, n_lanes, B).astype(np.int32)
    rpc_lo = rng.integers(0, n_rpcs, B).astype(np.uint32)
    # Retries: a later query repeats an earlier one (same key, lane, rpc).
    for b in np.flatnonzero(rng.random(B) < 0.15):
        if b:
            src = rng.integers(0, b)
            key_hi[b], key_lo[b] = key_hi[src], key_lo[src]
            lanes[b], rpc_lo[b] = lanes[src], rpc_lo[src]
    big = max(pool.by_set.values(), key=len)
    if flood and B >= flood and len(big) >= flood:
        at = rng.choice(B - flood + 1)
        sel = big[:flood]
        key_hi[at:at + flood] = pool.hi[sel]
        key_lo[at:at + flood] = pool.lo[sel]
        lanes[at:at + flood] = 0
        rpc_lo[at:at + flood] = np.arange(flood) * len(CLASSES) + n_rpcs
    return dict(key_hi=key_hi, key_lo=key_lo, lanes=lanes,
                rpc_hi=np.full(B, 7, np.uint32), rpc_lo=rpc_lo,
                key_cls=cls_of_rpc(rpc_lo))


def group_batch(rng: np.random.Generator, pool: KeyPool, G: int, K: int,
                n_lanes: int, n_rpcs: int) -> Dict[str, np.ndarray]:
    """[G, K] groups of 1..K keys: same-row keys (one set's bucket), pool
    keys, and exact repeats of earlier groups (dup-all retries)."""
    key_hi = np.zeros((G, K), np.uint32)
    key_lo = np.zeros((G, K), np.uint32)
    key_valid = np.zeros((G, K), np.int32)
    lanes = rng.integers(0, n_lanes, G).astype(np.int32)
    rpc_lo = rng.integers(0, n_rpcs, G).astype(np.uint32)
    buckets = [b for b in pool.by_set.values() if len(b) >= K]
    for g in range(G):
        n = int(rng.integers(1, K + 1))
        if g >= 2 and rng.random() < 0.2:           # retry an earlier group
            src = int(rng.integers(0, g))
            key_hi[g], key_lo[g] = key_hi[src], key_lo[src]
            key_valid[g], lanes[g], rpc_lo[g] = (key_valid[src], lanes[src],
                                                 rpc_lo[src])
            continue
        if buckets and rng.random() < 0.4:          # same-row keys
            b = buckets[int(rng.integers(0, len(buckets)))]
            sel = rng.choice(b, n, replace=False)
        else:
            sel = rng.integers(0, len(pool.hi), n)
        key_hi[g, :n] = pool.hi[sel]
        key_lo[g, :n] = pool.lo[sel]
        key_valid[g, :n] = 1
    key_cls = np.repeat(cls_of_rpc(rpc_lo)[:, None], K, axis=1)
    return dict(key_hi=key_hi, key_lo=key_lo, key_valid=key_valid,
                lanes=lanes, rpc_hi=np.full(G, 7, np.uint32), rpc_lo=rpc_lo,
                key_cls=key_cls)


def gc_batch(rng: np.random.Generator, planes, n_sets: int, G: int,
             n_rpcs: int) -> Dict[str, np.ndarray]:
    """[G] deduplicated gc entries: held (key, rpc) pairs, the same keys
    under a stale rpc, and unknown keys; plus a random aged-lane mask."""
    khi, klo, occ, rhi, rlo, _age = planes
    R, W = occ.shape
    L = R // n_sets
    rows, ways = np.nonzero(occ > 0)
    pick = rng.integers(0, max(len(rows), 1), G)
    g_hi = khi[rows[pick], ways[pick]] if len(rows) else np.zeros(G, np.uint32)
    g_lo = klo[rows[pick], ways[pick]] if len(rows) else np.zeros(G, np.uint32)
    g_rh = rhi[rows[pick], ways[pick]] if len(rows) else np.zeros(G, np.uint32)
    g_rl = rlo[rows[pick], ways[pick]] if len(rows) else np.zeros(G, np.uint32)
    g_lane = (rows[pick] // n_sets).astype(np.int32) if len(rows) \
        else np.zeros(G, np.int32)
    stale = rng.random(G) < 0.25
    g_rl = np.where(stale, g_rl + np.uint32(n_rpcs + 1), g_rl).astype(np.uint32)
    unknown = rng.random(G) < 0.1
    g_hi = np.where(unknown, rng.integers(0, 2**32, G, dtype=np.uint64),
                    g_hi).astype(np.uint32)
    uniq = np.unique(np.stack([g_lane.astype(np.uint32), g_hi, g_lo, g_rh,
                               g_rl]), axis=1)
    uniq = uniq[:, rng.permutation(uniq.shape[1])]
    aged = (rng.random(L) < 0.5).astype(np.int32)
    return dict(g_hi=uniq[1], g_lo=uniq[2], g_rpc_hi=uniq[3], g_rpc_lo=uniq[4],
                g_lane=uniq[0].astype(np.int32), aged_lanes=aged)


def fastpath_batch(rng: np.random.Generator, pool: KeyPool, B: int, NS: int,
                   CAP: int, f: int, n_lanes: int, n_slots: int,
                   n_rpcs: int) -> Dict[str, np.ndarray]:
    """One cluster batch and the rings it meets: [B] ops over pool keys
    (repeats make in-batch conflicts), a random slot map, a lane map, and
    per-shard rings whose live spans start anywhere (wrapping past CAP) and
    hold pool keys, with room left for this batch's appends."""
    k = rng.integers(0, len(pool.hi) // 4 + 1, B)
    key_hi, key_lo = pool.hi[k], pool.lo[k]
    rpc_lo = (rng.permutation(n_rpcs + B)[:B]).astype(np.uint32)
    exec_pred = (rng.random(B) < 0.9).astype(np.int32)
    slot_map = rng.integers(0, NS, n_slots).astype(np.int32)
    lane_map = (np.arange(NS * f, dtype=np.int32) % n_lanes).reshape(NS, f)
    qh, ql = pool.q_hi[k], pool.q_lo[k]
    shard = slot_map[ql % np.uint32(n_slots)]
    appends = np.bincount(shard[exec_pred == 1], minlength=NS)
    tail = rng.integers(0, CAP, NS).astype(np.int32)
    tail[: NS // 2] = CAP - rng.integers(1, 8, NS // 2)     # wrap past CAP
    count = np.minimum(rng.integers(0, CAP, NS), CAP - appends).astype(np.int32)
    ring_k = rng.integers(0, len(pool.hi) // 4 + 1, (NS, CAP))
    ring_hi = pool.q_hi[ring_k]
    ring_lo = pool.q_lo[ring_k]
    ring_cls = CLASSES[rng.integers(0, len(CLASSES), (NS, CAP))]
    return dict(key_hi=key_hi, key_lo=key_lo, rpc_hi=np.full(B, 9, np.uint32),
                rpc_lo=rpc_lo, exec_pred=exec_pred, slot_map=slot_map,
                lane_map=lane_map, tail_slot=tail, count=count,
                key_cls=cls_of_rpc(rpc_lo), ring_hi=ring_hi, ring_lo=ring_lo,
                ring_cls=ring_cls)


# ---------------------------------------------------------------------------
# Kernel against plain version, on the same device tensors
# ---------------------------------------------------------------------------
@dataclass
class Parity:
    name: str
    max_abs_err: int            # largest |kernel - plain| over every output
    outputs: int                # number of integers compared
    coverage: np.ndarray        # the kernel's reason codes (gc: cleared
    #                             bits; the single-table codes above)
    #                             counted by value, 0..N_CODES-1

    @property
    def missed(self) -> List[int]:
        """The outcomes of ``BRANCHES`` these inputs never reached."""
        return [v for v in BRANCHES[self.name] if self.coverage[v] == 0]


def _diff(pairs) -> Tuple[int, int]:
    err, n = 0, 0
    for a, b in pairs:
        a = a.to(torch.int64)
        b = b.to(torch.int64)
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a - b).abs().max()))
        n += a.numel()
    return err, n


def check_kernels(planes, n_sets: int, rec: dict, grp: dict, gc: dict,
                  fp: dict, f: int, device="cuda") -> List[Parity]:
    """Run each CUDA kernel and its plain version on identical copies of
    the same device tensors; compare every output, every table plane, the
    rings and the counter plane.  Returns one :class:`Parity` per kernel."""
    device = torch.device(device)
    base = ref.gang_from_numpy(planes, device)
    L = base.occ.shape[0] // n_sets
    out = []

    def twins():
        return [(base.clone(), torch.zeros((L, ref.N_REASON_CODES),
                                           dtype=torch.int32, device=device))
                for _ in range(2)]

    (ta, ca), (tb, cb) = twins()
    args = ops.record_operands(base, n_sets, **rec)
    ra = ops.gang_record_cuda(ta, n_sets, *args, ca)
    rb = ref.gang_record_plain(tb, n_sets, *args, cb)
    out.append(Parity("gang_record", *_diff(
        list(zip(ra, rb)) + list(zip(ta, tb)) + [(ca, cb)]),
        _coverage(ra[0][args[3] == 1])))

    (ta, ca), (tb, cb) = twins()
    args = ops.groups_operands(base, n_sets, **grp)
    ra = ops.gang_groups_cuda(ta, n_sets, *args, ca)
    rb = ref.gang_groups_plain(tb, n_sets, *args, cb)
    out.append(Parity("gang_record_groups", *_diff(
        list(zip(ra, rb)) + list(zip(ta, tb)) + [(ca, cb)]),
        _coverage(ra[0][args[7] == 1])))

    for do_age in (True, False):
        (ta, _), (tb, _) = twins()
        args = ops.gc_operands(base, n_sets, **gc)
        ra = ops.gang_gc_cuda(ta, n_sets, *args, do_age)
        rb = ref.gang_gc_plain(tb, n_sets, *args, do_age)
        err, n = _diff([(ra, rb)] + list(zip(ta, tb)))
        cov = _coverage(ra[args[5] == 1])
        if not do_age:
            prev = out.pop()
            err, n = max(err, prev.max_abs_err), n + prev.outputs
            cov = cov + prev.coverage
        out.append(Parity("gang_gc", err, n, cov))

    (ta, ca), (tb, cb) = twins()
    fp = dict(fp)
    rings = ref.ring_from_numpy(fp.pop("ring_hi"), fp.pop("ring_lo"),
                                fp.pop("ring_cls"), device)
    ring_a = [r.clone() for r in rings]
    ring_b = [r.clone() for r in rings]
    args = ops.fastpath_operands(base, n_sets, **fp)
    k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, ex, sm, lm, tail, count = args
    ra = ops.gang_fastpath_cuda(ta, n_sets, f, k_hi, k_lo, k_cls, k_valid,
                                r_hi, r_lo, ex, sm, lm, *ring_a, tail, count, ca)
    rb = ref.gang_fastpath_plain(tb, n_sets, f, k_hi, k_lo, k_cls, k_valid,
                                 r_hi, r_lo, ex, sm, lm, *ring_b, tail, count,
                                 cb)
    out.append(Parity("gang_fastpath", *_diff(
        list(zip(ra, rb)) + list(zip(ta, tb)) + list(zip(ring_a, ring_b))
        + [(ca, cb)]), _coverage(ra[0][k_valid.repeat_interleave(f) == 1])))
    return out


def _coverage(values: torch.Tensor, n: int = 5) -> np.ndarray:
    return reason_coverage(values.cpu().numpy(), n)


def reason_coverage(reasons: np.ndarray, n: int = 5) -> np.ndarray:
    """How often each code 0..n-1 occurs (tests assert the inputs reach
    every branch); the single-table kernels count ``N_CODES`` codes."""
    return np.bincount(np.asarray(reasons).reshape(-1), minlength=n)


# ---------------------------------------------------------------------------
# Single-table kernels: seeded inputs
# ---------------------------------------------------------------------------
def table_planes(rng: np.random.Generator, pool: KeyPool, n_sets: int,
                 n_ways: int, fill: float = 0.5) -> Tuple[np.ndarray, ...]:
    """A pre-filled single table (keys_hi, keys_lo uint32, occ int32):
    about ``fill`` of the ways hold pool keys (mixed lanes, each key at
    most once per set) under classes drawn from ``CLASSES``."""
    khi = np.zeros((n_sets, n_ways), np.uint32)
    klo = np.zeros((n_sets, n_ways), np.uint32)
    occ = np.zeros((n_sets, n_ways), np.int32)
    for k in rng.integers(0, len(pool.hi), int(fill * n_sets * n_ways)):
        s = int(pool.q_lo[k] & np.uint32(n_sets - 1))
        held = ((occ[s] > 0) & (khi[s] == pool.q_hi[k])
                & (klo[s] == pool.q_lo[k]))
        free = np.flatnonzero(occ[s] == 0)
        if held.any() or not free.size:
            continue
        w = free[rng.integers(0, free.size)]
        khi[s, w], klo[s, w] = pool.q_hi[k], pool.q_lo[k]
        occ[s, w] = 1 + CLASSES[rng.integers(0, len(CLASSES))]
    return khi, klo, occ


def _pool_lanes(rng, pool: KeyPool, B: int, flood: int, mixed: bool):
    """[B] keys: pool keys (repeats and table hits), 25% fresh keys, and a
    flood of up to ``flood`` distinct keys of the pool's largest set in a
    row (FULL).  Mixed lanes if ``mixed``, else the raw lanes the mix turns
    into them."""
    src_hi, src_lo = (pool.q_hi, pool.q_lo) if mixed else (pool.hi, pool.lo)
    k = rng.integers(0, len(pool.hi), B)
    hi, lo = src_hi[k].copy(), src_lo[k].copy()
    fresh = rng.random(B) < 0.25
    hi[fresh] = rng.integers(0, 2**32, fresh.sum(), dtype=np.uint64)
    lo[fresh] = rng.integers(0, 2**32, fresh.sum(), dtype=np.uint64)
    big = max(pool.by_set.values(), key=len)
    n = min(flood, len(big), B)
    at = rng.choice(B - n + 1)
    hi[at:at + n] = src_hi[big[:n]]
    lo[at:at + n] = src_lo[big[:n]]
    return hi, lo


def table_batch(rng: np.random.Generator, pool: KeyPool, B: int,
                n_ways: int) -> Dict[str, np.ndarray]:
    """[B] ``witness_record`` queries (MIXED lanes) with classes drawn from
    ``CLASSES``; same-key repeats conflict or stack by the matrix, and a
    flood of 2W + 1 keys fills one set."""
    q_hi, q_lo = _pool_lanes(rng, pool, B, 2 * n_ways + 1, True)
    return dict(q_hi=q_hi, q_lo=q_lo,
                q_cls=CLASSES[rng.integers(0, len(CLASSES), B)])


def window(rng: np.random.Generator, pool: KeyPool, U: int):
    """A U-entry unsynced window of MIXED lanes of the first half of the
    pool (which batches repeat; distinct keys while the half lasts, so a
    same-key query meets one class), with ``w_valid`` 1 + class over
    ``CLASSES`` and 10% invalid entries."""
    half = len(pool.hi) // 2
    k = rng.choice(half, U, replace=U > half)
    valid = 1 + CLASSES[rng.integers(0, len(CLASSES), U)]
    valid[rng.random(U) < 0.1] = 0
    return pool.q_hi[k], pool.q_lo[k], valid.astype(np.int32)


def table_fastpath_batch(rng: np.random.Generator, pool: KeyPool, B: int,
                         U: int, n_ways: int, n_shards: int,
                         n_slots: int = 256) -> Dict[str, np.ndarray]:
    """[B] ``fastpath_batch`` ops (RAW lanes, classes over ``CLASSES``),
    half of them keys of the window's half of the pool, a U-entry window
    and a random slot map over ``n_shards``."""
    key_hi, key_lo = _pool_lanes(rng, pool, B, 2 * n_ways + 1, False)
    hot = rng.random(B) < 0.5
    k = rng.integers(0, len(pool.hi) // 2, int(hot.sum()))
    key_hi[hot], key_lo[hot] = pool.hi[k], pool.lo[k]
    w_hi, w_lo, w_valid = window(rng, pool, U)
    return dict(key_hi=key_hi, key_lo=key_lo,
                key_cls=CLASSES[rng.integers(0, len(CLASSES), B)],
                window_hi=w_hi, window_lo=w_lo, window_valid=w_valid,
                slot_map=rng.integers(0, n_shards, n_slots).astype(np.int32))


def scan_batch(rng: np.random.Generator, pool: KeyPool, B: int,
               U: int) -> Dict[str, np.ndarray]:
    """``conflict_scan`` inputs: a U-entry window and [B] MIXED queries,
    most of them keys of the window's half of the pool."""
    w_hi, w_lo, w_valid = window(rng, pool, U)
    k = rng.integers(0, len(pool.hi) * 2 // 3, B)
    return dict(w_hi=w_hi, w_lo=w_lo, w_valid=w_valid, q_hi=pool.q_hi[k],
                q_lo=pool.q_lo[k],
                q_cls=CLASSES[rng.integers(0, len(CLASSES), B)])


# ---------------------------------------------------------------------------
# Single-table kernels against their plain versions
# ---------------------------------------------------------------------------
def scan_codes(con, w_hi, w_lo, w_valid, q_hi, q_lo) -> torch.Tensor:
    """Per query: ``SCAN_HIT`` on a conflict, ``SCAN_COMMUTES`` when the
    key meets valid window entries whose classes all commute with it, 0
    when it meets none."""
    meets = ((q_hi[:, None] == w_hi[None, :])
             & (q_lo[:, None] == w_lo[None, :])
             & (w_valid[None, :] > 0)).any(1)
    return torch.where(con == 1, SCAN_HIT,
                       torch.where(meets, SCAN_COMMUTES, 0))


def _merge(name: str, parts) -> Parity:
    """One :class:`Parity` over several cases of one kernel."""
    return Parity(name, max(p[0] for p in parts), sum(p[1] for p in parts),
                  sum(p[2] for p in parts))


def check_table_kernels(keys: dict, records, fastpaths, scans,
                        device="cuda") -> List[Parity]:
    """Run each single-table CUDA kernel and its plain version on the same
    device tensors (tables on identical copies) and compare every output
    and all three table planes.  ``keys`` holds raw ``hi``/``lo`` lanes and
    a ``slot_map`` (K1 runs with and without the route); ``records`` and
    ``fastpaths`` are lists of (table planes, batch) cases of
    ``witness_record`` (K6) and ``fastpath_batch`` (K7), ``scans`` a list
    of ``conflict_scan`` (K8) cases.  Returns one :class:`Parity` per
    kernel, over all its cases."""
    device = torch.device(device)
    hi, lo, sm = ops._to_device(device, keys["hi"], keys["lo"],
                                keys["slot_map"])
    pairs = []
    for slot_map in (None, sm):
        ra = ops.keyhash_cuda(hi, lo, slot_map)
        rb = ref.keyhash_plain(hi, lo, slot_map)
        pairs += [(a, b) for a, b in zip(ra, rb) if a is not None]
    out = [Parity("keyhash", *_diff(pairs),
                  reason_coverage(np.zeros(0, int), N_CODES))]

    parts = []
    for planes, q in records:
        base = ref.witness_table_from_numpy(planes, device)
        args = ops.table_record_operands(base, **q)
        ta, tb, tc = base.clone(), base.clone(), base.clone()
        ra = ops.witness_record_cuda(ta, *args)
        rb = ref.witness_record_plain(tb, *args)
        outcome = ref.witness_outcomes_plain(tc, *args)
        parts.append((*_diff([(ra, rb)] + list(zip(ta, tb))),
                      _coverage(outcome[args[3] == 1], N_CODES)))
    out.append(_merge("witness_record", parts))

    parts = []
    for planes, fp in fastpaths:
        base = ref.witness_table_from_numpy(planes, device)
        args = ops.table_fastpath_operands(base, **fp)
        k_cls, k_valid, w_hi, w_lo, w_valid = (args[2], args[3], *args[5:])
        ta, tb, tc = base.clone(), base.clone(), base.clone()
        ra = ops.fastpath_record_scan_cuda(ta, *args)
        rb = ref.fastpath_record_scan_plain(tb, *args)
        qh, ql = rb[3], rb[4]
        outcome = ref.witness_outcomes_plain(tc, qh, ql, k_cls, k_valid)
        codes = scan_codes(rb[1], w_hi, w_lo, w_valid, qh, ql)
        ok = k_valid == 1
        parts.append((*_diff(list(zip(ra, rb)) + list(zip(ta, tb))),
                      _coverage(outcome[ok], N_CODES)
                      + _coverage(codes[ok], N_CODES)))
    out.append(_merge("fastpath_record_scan", parts))

    parts = []
    for sc in scans:
        args = ops.scan_operands(device, **sc)
        ra = ops.conflict_scan_cuda(*args)
        rb = ref.conflict_scan_plain(*args)
        w_hi, w_lo, w_valid, q_hi, q_lo, _ = args
        parts.append((*_diff([(ra, rb)]),
                      _coverage(scan_codes(rb, w_hi, w_lo, w_valid, q_hi,
                                           q_lo), N_CODES)))
    out.append(_merge("conflict_scan", parts))
    return out


# ---------------------------------------------------------------------------
# Transaction probe (K9), table gc (K10), sequential record (K11)
# ---------------------------------------------------------------------------
def txn_chain(rng: np.random.Generator, pool: KeyPool, planes, n_ops: int,
              max_keys: int = 16, own_frac: float = 0.1,
              dup_frac: float = 0.05,
              same_set_frac: float = 0.1) -> List[Dict[str, np.ndarray]]:
    """``n_ops`` ``txn_probe`` ops for a chain that starts from ``planes``.

    Most ops take 1..``max_keys`` RAW pool keys (``dup_frac`` of them
    repeat a key); ``same_set_frac`` of them take 2 or 3 fresh keys of one
    set that had two free ways or more in ``planes`` (same-set inserters),
    and half of those are retried by the next op.  Each key has an
    ``own_coin``, set with probability ``own_frac`` (on every key of a
    retry): the chain marks a key ``own`` when its coin is set and the key
    is held at that point (a retry of the op's own record)."""
    occ = np.asarray(planes[2])
    fresh = key_pool(rng, 8 * occ.shape[0], occ.shape[0])
    roomy = [fresh.by_set[s] for s in np.flatnonzero((occ == 0).sum(1) >= 2)
             if fresh.by_set[s].size >= 3]
    out = []
    while len(out) < n_ops:
        if roomy and rng.random() < same_set_frac:
            keys = roomy[rng.integers(len(roomy))]
            k = rng.choice(keys, int(rng.integers(2, 4)), replace=False)
            hi, lo = fresh.hi[k], fresh.lo[k]
            retry = rng.random() < 0.5
        else:
            k = rng.integers(0, len(pool.hi), int(rng.integers(1,
                                                               max_keys + 1)))
            if k.size > 1 and rng.random() < dup_frac:
                k[-1] = k[0]
            hi, lo = pool.hi[k], pool.lo[k]
            retry = False
        out.append(dict(key_hi=hi, key_lo=lo, own_coin=(
            rng.random(k.size) < own_frac).astype(np.int32)))
        if retry:
            out.append(dict(key_hi=hi, key_lo=lo,
                            own_coin=np.ones(k.size, np.int32)))
    return out[:n_ops]


def held(table: ref.WitnessTable, k_hi: torch.Tensor,
         k_lo: torch.Tensor) -> torch.Tensor:
    """[K] int32: the RAW key is held (``occ > 0``) in its set of the
    table, as the probe's ``hit`` reads it."""
    S = table.occ.shape[0]
    qh, ql = ref.keyhash2x32(k_hi, k_lo)
    sets = ql.to(torch.int64) & (S - 1)
    return ((table.occ[sets] > 0) & (table.keys_hi[sets] == qh[:, None])
            & (table.keys_lo[sets] == ql[:, None])).any(1).to(torch.int32)


def txn_codes(acc, hit, own, valid, q_lo, k_hi, k_lo,
              n_sets: int) -> List[int]:
    """The coverage codes of one probe (host arrays; ``acc`` a bool)."""
    v = np.asarray(valid) == 1
    hit, own = np.asarray(hit)[v], np.asarray(own)[v]
    codes = [TXN_PADDED] if not v.all() else []
    if acc:
        codes.append(1)
        if (hit & own).any():
            codes.append(TXN_OWN_PASS)
        sets = (np.asarray(q_lo)[v] & np.uint32(n_sets - 1))[hit == 0]
        if np.unique(sets).size < sets.size:
            codes.append(TXN_SAME_SET)
    else:
        codes.append(3 if (hit & (own == 0)).any() else 4)
    keys = np.stack([np.asarray(k_hi)[v], np.asarray(k_lo)[v]], 1)
    if np.unique(keys, axis=0).shape[0] < keys.shape[0]:
        codes.append(TXN_DUP_KEY)
    return codes


def gc_planes(rng: np.random.Generator, pool: KeyPool, n_sets: int,
              n_ways: int) -> Tuple[np.ndarray, ...]:
    """A table for the gc: :func:`table_planes` at fill 0.8, with a fifth
    of the held slots cleared as a gc leaves them (occ 0, keys kept)."""
    khi, klo, occ = table_planes(rng, pool, n_sets, n_ways, fill=0.8)
    occ[(occ > 0) & (rng.random(occ.shape) < 0.2)] = 0
    return khi, klo, occ


def gc_entries(rng: np.random.Generator, planes, G: int):
    """``G`` MIXED gc entries for :func:`gc_planes`' table: half the keys of
    held slots, a fifth keys left in cleared slots, a fifth fresh keys, and
    a tenth repeats of earlier entries."""
    khi, klo, occ = (np.asarray(p).reshape(-1) for p in planes)
    live = np.flatnonzero(occ > 0)
    stale = np.flatnonzero((occ == 0) & ((khi != 0) | (klo != 0)))
    g_hi = rng.integers(0, 2**32, G, dtype=np.uint64).astype(np.uint32)
    g_lo = rng.integers(0, 2**32, G, dtype=np.uint64).astype(np.uint32)
    kind = rng.random(G)
    for mask, src in ((kind < 0.5, live), ((kind >= 0.5) & (kind < 0.7),
                                           stale)):
        if src.size and mask.any():
            at = src[rng.integers(0, src.size, int(mask.sum()))]
            g_hi[mask], g_lo[mask] = khi[at], klo[at]
    rep = np.flatnonzero(kind >= 0.9)
    rep = rep[rep > 0]
    src = (rng.random(rep.size) * rep).astype(np.int64)
    g_hi[rep], g_lo[rep] = g_hi[src], g_lo[src]
    return dict(g_hi=g_hi, g_lo=g_lo)


def gc_codes(planes, g_hi, g_lo) -> List[int]:
    """The coverage codes of one gc batch against the pre-gc table."""
    g_hi, g_lo = np.asarray(g_hi, np.uint32), np.asarray(g_lo, np.uint32)
    if g_hi.size == 0:
        return [GC_EMPTY]
    khi, klo, occ = (np.asarray(p).reshape(-1) for p in planes)
    meets = (khi[None] == g_hi[:, None]) & (klo[None] == g_lo[:, None])
    codes = np.where((meets & (occ[None] > 0)).any(1), GC_HIT,
                     np.where(meets.any(1), GC_STALE, GC_MISS)).tolist()
    keys = np.stack([g_hi, g_lo], 1)
    return codes + [GC_REPEAT] * (keys.shape[0]
                                  - np.unique(keys, axis=0).shape[0])


def check_txn_kernels(probe_planes, probes, gcs, seqs,
                      device="cuda") -> List[Parity]:
    """Run K9, K10 and K11 and their plain versions on the same device
    tensors (tables on identical copies); compare every output and all
    three table planes.

    ``probes`` (:func:`txn_chain`) run as one chain from ``probe_planes``,
    the kernel's table and the plain version's in lockstep; a probe the
    kernel rejects must leave its table bit-identical, which counts as part
    of the error.  ``gcs`` are (planes, entries) cases of ``witness_gc``,
    ``seqs`` (planes, queries) cases of ``witness_record_seq``."""
    device = torch.device(device)
    ta = ref.witness_table_from_numpy(probe_planes, device)
    tb = ta.clone()
    S = ta.occ.shape[0]
    pairs, kept, steps = [], torch.zeros((), dtype=torch.int64,
                                         device=device), []
    for p in probes:
        K = len(p["key_hi"])
        k_hi, k_lo, coin, valid = ops._to_device(device, *ops._pad_valid(
            K, p["key_hi"], p["key_lo"], p["own_coin"]))
        own = coin * held(tb, k_hi, k_lo)
        before = ta.clone()
        ra = ops.txn_probe_cuda(ta, k_hi, k_lo, own, valid)
        rb = ref.txn_probe_plain(tb, k_hi, k_lo, own, valid)
        pairs += list(zip(ra, rb))
        kept += (1 - ra[0][0]).to(torch.int64) * sum(
            (a != b).sum() for a, b in zip(before, ta))
        steps.append((rb[0], rb[1], own, valid, rb[3], k_hi, k_lo))
    err, n = _diff(pairs + list(zip(ta, tb)))
    codes = []
    for step in steps:
        acc, hit, own, valid, ql, k_hi, k_lo = (t.cpu().numpy()
                                                for t in step)
        codes += txn_codes(bool(acc[0]), hit, own, valid, ql.view(np.uint32),
                           k_hi, k_lo, S)
    out = [Parity("txn_probe", max(err, int(kept)), n,
                  reason_coverage(np.array(codes, int), N_CODES))]

    parts = []
    for planes, g in gcs:
        base = ref.witness_table_from_numpy(planes, device)
        args = ops.table_gc_operands(base, **g)
        ta, tb = base.clone(), base.clone()
        ops.witness_gc_cuda(ta, *args)
        ref.witness_gc_plain(tb, *args)
        parts.append((*_diff(list(zip(ta, tb))), reason_coverage(
            np.array(gc_codes(planes, g["g_hi"], g["g_lo"]), int), N_CODES)))
    out.append(_merge("witness_gc", parts))

    parts = []
    for planes, q in seqs:
        base = ref.witness_table_from_numpy(planes, device)
        args = ops.seq_operands(base, q["q_hi"], q["q_lo"])
        ta, tb, tc = base.clone(), base.clone(), base.clone()
        ra = ops.witness_record_seq_cuda(ta, *args)
        rb = ref.witness_record_seq_plain(tb, *args)
        outcome = ref.witness_seq_outcomes_plain(tc, *args)
        parts.append((*_diff([(ra, rb)] + list(zip(ta, tb))),
                      _coverage(outcome, N_CODES)))
    out.append(_merge("witness_record_seq", parts))
    return out


__all__ = ["BRANCHES", "CLASSES", "GC_EMPTY", "GC_HIT", "GC_MISS",
           "GC_REPEAT", "GC_STALE", "KeyPool", "N_CODES", "Parity",
           "SCAN_COMMUTES", "SCAN_HIT", "TXN_DUP_KEY", "TXN_OWN_PASS",
           "TXN_PADDED", "TXN_SAME_SET", "check_kernels",
           "check_table_kernels", "check_txn_kernels", "cls_of_rpc",
           "fastpath_batch", "gang_planes", "gc_batch", "gc_codes",
           "gc_entries", "gc_planes", "group_batch", "held", "key_pool",
           "reason_coverage", "record_batch", "scan_batch", "scan_codes",
           "table_batch", "table_fastpath_batch", "table_planes",
           "txn_chain", "txn_codes", "window"]
