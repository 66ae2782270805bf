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
# The grouped record's accepted groups in which two valid keys chose one
# way (a key repeated as a DUP, under two classes: the later key's write
# must win).
GROUP_SAME_WAY = 17
N_CODES = 18

# The outcomes (reason codes; gc: cleared bits) each kernel's inputs must
# reach.  A fused batch carries fresh rpcs only, so its record stage never
# meets a DUP; that stage is the gang_record kernel, whose own inputs do.
# The single-table kernels return accept and conflict bits; their outcomes
# are read from the plain version on the same inputs.
BRANCHES = {"gang_record": (1, 2, 3, 4),
            "gang_record_groups": (1, 2, 3, 4, GROUP_SAME_WAY),
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


def _gc_spread(rng: np.random.Generator, planes, n_sets: int, G: int,
               n_rpcs: int, lanes) -> Dict[str, np.ndarray]:
    """``G`` distinct gc entries over ``lanes``: up to half of them held
    (key, rpc) pairs of those lanes, the rest keys of their held slots under
    stale rpcs, each its own (a tenth of them unknown keys)."""
    khi, klo, occ, rhi, rlo, _age = planes
    rows, ways = np.nonzero(occ > 0)
    keep = np.isin(rows // n_sets, np.asarray(lanes))
    rows, ways = rows[keep], ways[keep]
    n_held = min(G // 2, rows.size)
    at = np.concatenate([rng.choice(rows.size, n_held, replace=False),
                         rng.integers(0, rows.size, G - n_held)])
    r, w = rows[at], ways[at]
    g_hi, g_lo = khi[r, w].copy(), klo[r, w].copy()
    g_rh, g_rl = rhi[r, w].copy(), rlo[r, w].copy()
    stale = np.arange(G) >= n_held
    g_rl[stale] = np.uint32(n_rpcs + 1) + np.arange(int(stale.sum()),
                                                    dtype=np.uint32)
    unknown = stale & (rng.random(G) < 0.1)
    g_hi[unknown] = rng.integers(0, 2**32, int(unknown.sum()),
                                 dtype=np.uint64).astype(np.uint32)
    order = rng.permutation(G)
    return dict(g_hi=g_hi[order], g_lo=g_lo[order], g_rpc_hi=g_rh[order],
                g_rpc_lo=g_rl[order],
                g_lane=(r[order] // n_sets).astype(np.int32))


GC_CORNERS = ("identical_entries", "one_row_all_ways", "non_aged_lanes",
              "no_aging", "no_entries", "big_one_lane", "big_eight_lanes")


def gc_corners(rng: np.random.Generator, planes, n_sets: int, n_rpcs: int):
    """(planes, entries, do_age) cases at the corners of K4's row-owning
    design, in the order of ``GC_CORNERS``: a :func:`gc_batch` whose every
    entry comes twice (identical entries both report 1, as the pre-gc rule
    says); one row of an aged lane whose W ways hold one key under W rpcs,
    each (key, rpc) an entry; entries only in lanes that do not age (the
    first half of the lanes age); a batch with ``do_age`` false; no entries
    with aging; and 4096 distinct entries in one aged lane, and spread
    over eight lanes (every other one aged), so that one block walks and
    owns many.  ``planes`` is a :func:`gang_planes` gang of at least eight
    lanes; the second case changes one row of a copy."""
    L = planes[2].shape[0] // n_sets
    W = planes[2].shape[1]

    def mask(lanes):
        m = np.zeros(L, np.int32)
        m[list(lanes)] = 1
        return m

    out = []
    e = gc_batch(rng, planes, n_sets, 64, n_rpcs)
    order = rng.permutation(2 * len(e["g_hi"]))
    out.append((planes, {k: (v if k == "aged_lanes"
                             else np.concatenate([v, v])[order])
                         for k, v in e.items()}, True))

    one = tuple(np.array(p, copy=True) for p in planes)
    lane = int(rng.integers(0, L))
    row = lane * n_sets + int(rng.integers(0, n_sets))
    k_hi = rng.integers(0, 2**32, dtype=np.uint64).astype(np.uint32)
    k_lo = (rng.integers(0, 2**32, dtype=np.uint64).astype(np.uint32)
            & ~np.uint32(n_sets - 1)) | np.uint32(row % n_sets)
    rpcs = (n_rpcs + 1 + np.arange(W)).astype(np.uint32)
    one[0][row], one[1][row], one[3][row], one[4][row] = k_hi, k_lo, 7, rpcs
    one[2][row] = 1 + cls_of_rpc(rpcs)
    one[5][row] = rng.integers(0, 5, W)
    out.append((one, dict(g_hi=np.full(W, k_hi), g_lo=np.full(W, k_lo),
                          g_rpc_hi=np.full(W, 7, np.uint32),
                          g_rpc_lo=rpcs[rng.permutation(W)],
                          g_lane=np.full(W, lane, np.int32),
                          aged_lanes=mask([lane])), True))

    half = range(L // 2)
    out.append((planes, dict(_gc_spread(rng, planes, n_sets, 200, n_rpcs,
                                        range(L // 2, L)),
                             aged_lanes=mask(half)), True))
    out.append((planes, gc_batch(rng, planes, n_sets, 200, n_rpcs), False))
    empty = np.zeros(0, np.uint32)
    out.append((planes, dict(g_hi=empty, g_lo=empty, g_rpc_hi=empty,
                             g_rpc_lo=empty, g_lane=np.zeros(0, np.int32),
                             aged_lanes=mask(half)), True))
    out.append((planes, dict(_gc_spread(rng, planes, n_sets, 4096, n_rpcs,
                                        [L - 1]),
                             aged_lanes=mask([L - 1, 0])), True))
    eight = range(8)
    out.append((planes, dict(_gc_spread(rng, planes, n_sets, 4096, n_rpcs,
                                        eight),
                             aged_lanes=mask(eight[::2])), True))
    return out


def fastpath_batch(rng: np.random.Generator, pool: KeyPool, B: int, NS: int,
                   CAP: int, f: int, n_lanes: int, n_slots: int,
                   n_rpcs: int, *, shards=None, exact_fit: bool = False,
                   hot: int = 0) -> Dict[str, np.ndarray]:
    """One cluster batch and the rings it meets: [B] ops over pool keys
    (repeats make in-batch conflicts), a random slot map, a lane map, and
    per-shard rings whose live spans start anywhere (wrapping past CAP) and
    hold pool keys, with room left for this batch's appends.

    Corners: ``shards`` limits the slot map to those shards (one shard
    takes every op; the others get none); ``exact_fit`` fills each ring to
    ``count + appends = CAP``; ``hot`` ops repeat two keys, executing, the
    first half as INCR (which commutes with itself) and the rest as SET
    (which does not)."""
    k = rng.integers(0, len(pool.hi) // 4 + 1, B)
    rpc_lo = (rng.permutation(n_rpcs + B)[:B]).astype(np.uint32)
    exec_pred = (rng.random(B) < 0.9).astype(np.int32)
    if shards is None:
        slot_map = rng.integers(0, NS, n_slots).astype(np.int32)
    else:
        shards = np.asarray(shards, np.int32)
        slot_map = shards[rng.integers(0, shards.size, n_slots)]
    if hot:
        at = rng.choice(B, hot, replace=False)
        kind = np.arange(hot) >= hot // 2          # 0: INCR, 1: SET
        k[at] = kind                               # pool keys 0 and 1
        rpc_lo[at] = (4 * (n_rpcs + B + at) + np.where(kind, 0, 1)).astype(
            np.uint32)                             # CLASSES[1] INCR, [0] SET
        exec_pred[at] = 1
    key_hi, key_lo = pool.hi[k], pool.lo[k]
    lane_map = (np.arange(NS * f, dtype=np.int32) % n_lanes).reshape(NS, f)
    qh, ql = pool.q_hi[k], pool.q_lo[k]
    shard = slot_map[ql % np.uint32(n_slots)]
    appends = np.bincount(shard[exec_pred == 1], minlength=NS)
    tail = rng.integers(0, CAP, NS).astype(np.int32)
    tail[: NS // 2] = CAP - rng.integers(1, 8, NS // 2)     # wrap past CAP
    if exact_fit:
        count = (CAP - appends).astype(np.int32)
    else:
        count = np.minimum(rng.integers(0, CAP, NS),
                           CAP - appends).astype(np.int32)
    ring_k = rng.integers(0, len(pool.hi) // 4 + 1, (NS, CAP))
    ring_hi = pool.q_hi[ring_k]
    ring_lo = pool.q_lo[ring_k]
    ring_cls = CLASSES[rng.integers(0, len(CLASSES), (NS, CAP))]
    return dict(key_hi=key_hi, key_lo=key_lo, rpc_hi=np.full(B, 9, np.uint32),
                rpc_lo=rpc_lo, exec_pred=exec_pred, slot_map=slot_map,
                lane_map=lane_map, tail_slot=tail, count=count,
                key_cls=cls_of_rpc(rpc_lo), ring_hi=ring_hi, ring_lo=ring_lo,
                ring_cls=ring_cls)


def fastpath_corners(rng: np.random.Generator, B: int, NS: int, CAP: int,
                     f: int, n_lanes: int, n_slots: int,
                     n_rpcs: int) -> List[Dict[str, np.ndarray]]:
    """The corners of K3's block-per-shard design, each a
    :func:`fastpath_batch` (pick B not a multiple of 32): every op in one
    shard (not shard 0); half the shards with no op, the rings of the
    others filled to ``count + appends = CAP``; every shard filled so, with
    hot keys that commute (INCR over INCR) beside hot keys that do not (SET
    over SET); and every op of a batch of 3 x B in one shard whose ring of
    4 x CAP is filled so (at B = 1000 the shard's list outgrows one block
    buffer of 1024 ops and its live span one staged table, so the kernel
    takes both in chunks).  Keys come from a pool of 16 x CAP, so full
    rings still miss most ops."""
    pool = key_pool(rng, 16 * CAP, 1)
    hot = min(64, B // 4)
    rest = (f, n_lanes, n_slots, n_rpcs)
    out = [fastpath_batch(rng, pool, B, NS, CAP, *rest, shards=[NS - 1],
                          hot=hot),
           fastpath_batch(rng, pool, B, NS, CAP, *rest,
                          shards=range(0, NS, 2), exact_fit=True),
           fastpath_batch(rng, pool, B, NS, CAP, *rest, exact_fit=True,
                          hot=hot)]
    big = key_pool(rng, 64 * CAP, 1)
    out.append(fastpath_batch(rng, big, 3 * B, NS, 4 * CAP, *rest,
                              shards=[NS - 1], exact_fit=True, hot=hot))
    return out


GANG_RECORD_CORNERS = ("one_row_chunks", "dup_conflict_orders", "full_row",
                       "1_way", "64_ways", "few_rows", "padding_only",
                       "no_counters", "rep_f")


def gang_record_corners(rng: np.random.Generator, B: int, f: int):
    """``gang_record`` cases at the corners of K2's row-owning design, in
    the order of ``GANG_RECORD_CORNERS``: each a dict of ``planes``,
    ``n_sets``, the batch ``rec`` (as :func:`record_batch` gives it) and
    ``counters`` (whether the [L, 5] plane is fed).  On a 4 x 64 x 4 gang
    unless named: 3 x B queries all in one row (at B = 1024 the owning
    block takes them in chunks of its list), 8 keys of one set under 24
    rpcs; DUP and CONFLICT of one key in both batch orders (insert, retry,
    foreign rpc; insert, foreign rpc, retry), and rows that hold one key
    under two INCR rpcs in either way order, met by retries of either, a
    SET and a third INCR; a row driven FULL by 2W + 1 distinct keys; W = 1
    and W = 64 (ways at a stride of 32); 2 lanes x 16 sets, fewer rows than
    blocks; no queries (the op pads to a bucket of padding only); a batch
    without counters; and the fused batch's stage, each of B ops at f
    lanes (``lanes`` is [B, f], f <= 4, and ``valid`` marks a tenth of
    them padding).  One rpc is one op, so its class is a function of
    it."""
    n_rpcs = 24
    out = []

    def case(planes, S, rec, counters=True):
        out.append(dict(planes=planes, n_sets=S, rec=rec, counters=counters))

    def gang(L, S, W, fill=0.5):
        pool = key_pool(rng, 4 * S * W, S)
        return pool, gang_planes(rng, pool, L, S, W, n_rpcs, fill=fill)

    def batch(key_hi, key_lo, lanes, rpc_lo):
        rpc_lo = np.asarray(rpc_lo, np.uint32)
        return dict(key_hi=np.asarray(key_hi, np.uint32),
                    key_lo=np.asarray(key_lo, np.uint32),
                    lanes=np.asarray(lanes, np.int32),
                    rpc_hi=np.full(rpc_lo.shape, 7, np.uint32),
                    rpc_lo=rpc_lo, key_cls=cls_of_rpc(rpc_lo))

    L, S, W = 4, 64, 4
    pool, planes = gang(L, S, W)
    keys = max(pool.by_set.values(), key=len)[:8]
    k = keys[rng.integers(0, keys.size, 3 * B)]
    case(planes, S, batch(pool.hi[k], pool.lo[k], np.ones(3 * B),
                          rng.integers(0, n_rpcs, 3 * B)))

    # Rows of lane 2 that hold a key twice under INCR rpcs, in either way
    # order (rpc 4a + 1 is an INCR, 4a a SET); fresh keys on lane 3.
    pool, planes = gang(L, S, W, fill=0.0)
    incr = 4 * n_rpcs + np.array([1, 5, 9], np.uint32)
    sets_ = 4 * n_rpcs + np.array([0, 4], np.uint32)
    queries = []                                  # (pool key, lane, rpc)
    for order, s in enumerate([s for s, v in pool.by_set.items()
                               if v.size >= 3][:2]):
        held, fresh = pool.by_set[s][0], pool.by_set[s][1 + order]
        row = 2 * S + s
        for way, rpc in enumerate(incr[:2] if order == 0 else incr[1::-1]):
            for plane, v in zip(planes, (pool.q_hi[held], pool.q_lo[held],
                                         1 + CLASSES[1], 7, rpc)):
                plane[row, way] = v
        queries += [(held, 2, rpc) for rpc in                # DUP DUP CONF INS
                    (incr[0], incr[1], sets_[0], incr[2])]
        queries += [(fresh, 3, rpc) for rpc in  # INS DUP CONF, INS CONF DUP
                    (sets_[[0, 0, 1]] if order == 0 else sets_[[0, 1, 0]])]
    k, q_lane, q_rpc = (np.array(v) for v in zip(*queries))
    case(planes, S, batch(pool.hi[k], pool.lo[k], q_lane, q_rpc))

    pool, planes = gang(L, S, W)
    case(planes, S, record_batch(rng, pool, B, L, S, n_rpcs, flood=2 * W + 1))
    for L_, S_, W_ in ((4, 64, 1), (2, 16, 64), (2, 16, 4)):
        pool, planes = gang(L_, S_, W_)
        case(planes, S_, record_batch(rng, pool, B, L_, S_, n_rpcs,
                                      flood=2 * W_ + 1))
    pool, planes = gang(L, S, W)
    case(planes, S, batch([], [], [], []))
    case(planes, S, record_batch(rng, pool, B, L, S, n_rpcs, flood=2 * W + 1),
         counters=False)
    rec = record_batch(rng, pool, B, L, S, n_rpcs, flood=2 * W + 1)
    first = rng.integers(0, L - f + 1, B)
    rec["lanes"] = (first[:, None] + np.arange(f)[None, :]).astype(np.int32)
    rec["valid"] = (rng.random(B) >= 0.1).astype(np.int32)
    case(planes, S, rec)
    return out


def copies_operands(table: ref.GangTable, n_sets: int, key_hi, key_lo, lanes,
                    rpc_hi, rpc_lo, key_cls, valid):
    """A :func:`gang_record_corners` ``rep_f`` batch -> the device operands
    of K2 as K3's record stage (``ops._record_launch`` and
    ``ref.record_copies_plain`` after (table, n_sets)): rows [B * f] (an
    invalid op's copies at row L * S, padding, as K3 gives them), rep, and
    the ops' mixed lanes, rpc and class."""
    B, f = np.asarray(lanes).shape
    qh, ql = ref.np_keyhash2x32(np.asarray(key_hi, np.uint32),
                                np.asarray(key_lo, np.uint32))
    rows = (np.asarray(lanes, np.int64) * n_sets
            + (ql & np.uint32(n_sets - 1)).astype(np.int64)[:, None])
    rows[np.asarray(valid) != 1] = table.occ.shape[0]
    rows, qh, ql, rh, rl, cls = ops._to_device(
        table.occ.device, rows.reshape(-1).astype(np.int32), qh, ql,
        np.asarray(rpc_hi, np.uint32), np.asarray(rpc_lo, np.uint32),
        np.asarray(key_cls, np.int32))
    return rows, f, qh, ql, rh, rl, cls


GANG_GROUPS_CORNERS = ("one_key", "no_valid_key", "padding_only",
                       "full_row", "dup_two_classes", "dup_all_retries",
                       "32_keys", "64_keys", "long_chain")


def _groups(keys, lanes, rpc_lo, cls=None, K=None) -> Dict[str, np.ndarray]:
    """``gang_record_groups`` inputs from per-group lists of RAW (hi, lo)
    keys, padded to ``K`` keys (default the longest group); ``cls`` per
    group a list of classes, else each key takes its rpc's class."""
    G = len(keys)
    K = K or max([len(k) for k in keys] + [1])
    key_hi = np.zeros((G, K), np.uint32)
    key_lo = np.zeros((G, K), np.uint32)
    key_valid = np.zeros((G, K), np.int32)
    rpc_lo = np.asarray(rpc_lo, np.uint32)
    key_cls = np.repeat(cls_of_rpc(rpc_lo)[:, None], K, axis=1)
    for g, ks in enumerate(keys):
        for k, (h, l) in enumerate(ks):
            key_hi[g, k], key_lo[g, k], key_valid[g, k] = h, l, 1
        if cls is not None and cls[g] is not None:
            key_cls[g, :len(cls[g])] = cls[g]
    return dict(key_hi=key_hi, key_lo=key_lo, key_valid=key_valid,
                lanes=np.asarray(lanes, np.int32),
                rpc_hi=np.full(G, 7, np.uint32), rpc_lo=rpc_lo,
                key_cls=key_cls.astype(np.int32))


def gang_groups_corners(rng: np.random.Generator, n_chain: int = 1024):
    """``gang_record_groups`` cases at the corners of K5's design, in the
    order of ``GANG_GROUPS_CORNERS``: each a dict of ``planes`` (a 4 x 64
    x 4 gang about half full of pool keys under rpcs 7:0..23), ``n_sets``
    and the batch ``grp``.  One group of one key (G = K = 1); a valid group
    with no valid key between two others (reason 1, nothing written,
    counted); no groups (the op pads to padding groups only); a group of
    W + 1 fresh keys in one row (FULL, the table untouched) then one that
    fits; held keys repeated in a group under two classes and the group's
    own rpc, alone, around a fresh key, and a fresh key inserted then
    repeated so (both DUPs of one way: the later class wins); six groups
    of fresh keys, some in one row, then the same six again (dup-all
    retries); groups of up to 32 and 64 keys (more than one warp), the
    first eight fresh keys of lane 1, three in one row, the second their
    retry with the first key again under another class; and ``n_chain``
    groups of up to two keys over one lane (a long chain, staged in
    several tiles).  No row
    holds a key twice, so none holds it both under a group's rpc and under
    a conflicting one."""
    n_rpcs, L, S, W = 24, 4, 64, 4
    pool = key_pool(rng, 4 * S * W, S)
    planes = gang_planes(rng, pool, L, S, W, n_rpcs)
    fresh = key_pool(rng, 16 * S * W, S)
    khi, klo, occ, _rhi, rlo, _age = planes
    held = np.argwhere(occ > 0)
    index = {(int(h), int(lo)): k for k, (h, lo) in
             enumerate(zip(pool.q_hi, pool.q_lo))}
    rpc = iter(range(100, 10_000))
    out = []

    def case(grp):
        out.append(dict(planes=planes, n_sets=S, grp=grp))

    def raw(bucket, n, at=0):
        return [(fresh.hi[k], fresh.lo[k]) for k in bucket[at:at + n]]

    def roomy(lane, n):
        """The sets whose row in ``lane`` has ``n`` free ways or more."""
        return np.flatnonzero((occ[lane * S:(lane + 1) * S] == 0).sum(1) >= n)

    def held_key(i):
        """The RAW key, lane and rpc of held slot i (row, way)."""
        r, w = held[i]
        k = index[(int(khi[r, w]), int(klo[r, w]))]
        return (pool.hi[k], pool.lo[k]), int(r) // S, int(rlo[r, w])

    k = int(rng.integers(0, len(pool.hi)))
    case(_groups([[(pool.hi[k], pool.lo[k])]], [int(rng.integers(0, L))],
                 [int(rng.integers(0, n_rpcs))]))
    grp = group_batch(rng, pool, 3, 2, L, n_rpcs)
    grp["key_valid"][1] = 0
    case(grp)
    case(_groups([], [], [], K=1))

    s = next(s for s in range(S) if (occ[2 * S + s] == 0).any()
             and fresh.by_set[s].size >= W + 2)
    case(_groups([raw(fresh.by_set[s], W + 1), raw(fresh.by_set[s], 1, W + 1)],
                 [2, 2], [next(rpc), next(rpc)]))

    a, b = (int(c) for c in CLASSES[1:3])
    picks = rng.choice(len(held), 2, replace=False)
    (x, lane_x, rpc_x), (y, lane_y, rpc_y) = (held_key(i) for i in picks)
    z = raw(fresh.by_set[int(rng.choice(roomy(3, 1)))], 1)[0]
    w_fresh = raw(fresh.by_set[int(rng.choice(roomy(lane_y, 1)))], 1)[0]
    rz = next(rpc)
    case(_groups([[x, x], [y, w_fresh, y], [z], [z, z]],
                 [lane_x, lane_y, 3, 3], [rpc_x, rpc_y, rz, rz],
                 cls=[[a, b], [b, 0, a], None, [a, b]]))

    keys, lanes, rpcs = [], [], []
    for g in range(6):
        n, lane = int(rng.integers(1, 4)), g % L
        s = int(rng.choice(roomy(lane, 3)))
        keys.append(raw(fresh.by_set[s], n, 4 * g))
        lanes.append(lane)
        rpcs.append(next(rpc))
    case(_groups(keys + keys, lanes + lanes, rpcs + rpcs))

    for K in (32, 64):
        s1 = int(rng.choice(roomy(1, 3)))
        others = rng.choice(np.setdiff1d(roomy(1, 1), [s1]), 5,
                            replace=False)
        ks = raw(fresh.by_set[s1], 3) + [raw(fresh.by_set[int(v)], 1)[0]
                                         for v in others]
        r = next(rpc)
        head = _groups([ks, ks + ks[:1]], [1, 1], [r, r],
                       cls=[None, [int(cls_of_rpc(r))] * 8 + [a]], K=K)
        grp = group_batch(rng, pool, 12, K, L, n_rpcs)
        case({name: np.concatenate([head[name], grp[name]]) for name in grp})

    grp = group_batch(rng, pool, n_chain, 2, L, n_rpcs)
    grp["lanes"][:] = 1
    case(grp)
    return out


def groups_codes(table: ref.GangTable, n_sets: int, reasons, k_hi, k_lo,
                 k_valid, lanes, r_hi, r_lo) -> np.ndarray:
    """K5's coverage codes: the reason of each valid group, and
    ``GROUP_SAME_WAY`` for each accepted group with a valid key repeated
    that the table after the call holds once in its row under the group's
    rpc (so both copies chose one way; repeated keys that insert take
    two)."""
    reasons = reasons.cpu().numpy()
    codes = [reasons[reasons > 0]]
    qh, ql = (t.cpu().numpy().view(np.uint32)
              for t in ref.keyhash2x32(k_hi.reshape(-1), k_lo.reshape(-1)))
    G, K = k_hi.shape
    qh, ql = qh.reshape(G, K), ql.reshape(G, K)
    valid = k_valid.cpu().numpy() == 1
    khi, klo, occ, rhi, rlo, _age = ref.gang_to_numpy(table)
    lanes, r_hi, r_lo = (t.cpu().numpy() for t in (lanes, r_hi, r_lo))
    for g in np.flatnonzero((reasons == 1) | (reasons == 2)):
        keys = np.stack([qh[g][valid[g]], ql[g][valid[g]]], 1)
        uniq, n = np.unique(keys, axis=0, return_counts=True)
        for h, lo in uniq[n > 1]:
            row = int(lanes[g]) * n_sets + int(lo & np.uint32(n_sets - 1))
            once = ((occ[row] > 0) & (khi[row] == h) & (klo[row] == lo)
                    & (rhi[row] == np.uint32(r_hi[g]))
                    & (rlo[row] == np.uint32(r_lo[g]))).sum() == 1
            if once:
                codes.append(np.array([GROUP_SAME_WAY]))
    return reason_coverage(np.concatenate(codes), N_CODES)


def _groups_corner(c: dict, device: torch.device, trim: bool):
    """One :func:`gang_groups_corners` case through K5 and its plain
    version on identical copies of its gang, as the op pads it or trimmed
    to its real groups and keys; returns (max_abs_err, outputs,
    coverage)."""
    base = ref.gang_from_numpy(c["planes"], device)
    S = c["n_sets"]
    L = base.occ.shape[0] // S
    ta, tb = base.clone(), base.clone()
    ca, cb = (torch.zeros((L, ref.N_REASON_CODES), dtype=torch.int32,
                          device=device) for _ in range(2))
    args = ops.groups_operands(base, S, **c["grp"])
    if trim:
        G, K = c["grp"]["key_hi"].shape
        args = ([a[:G, :K].contiguous() for a in args[:4]]
                + [a[:G] for a in args[4:]])
    ra = ops.gang_groups_cuda(ta, S, *args, ca)
    rb = ref.gang_groups_plain(tb, S, *args, cb)
    pairs = list(zip(ra, rb)) + list(zip(ta, tb)) + [(ca, cb)]
    return (*_diff(pairs), groups_codes(ta, S, ra[0], *args[:3], *args[4:7]))


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


def trace(fn, iters: int, before=None):
    """A ``torch.profiler`` trace (CUDA activity only) of ``iters`` calls of
    ``fn`` back to back, after one untraced call; ``before`` runs ahead of
    each call (e.g. an L2 flush)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    return prof


def launches_per_call(fn, iters: int = 20) -> Dict[str, float]:
    """Kernel launches of one call of ``fn`` by kernel name (copies and
    fills left out), as caught in a :func:`trace` of ``iters`` calls (a
    share under 1 is launches the trace missed)."""
    counts: Dict[str, float] = {}
    # A trace that caught no launch at all is taken again, up to three
    # traces: late in a long run the profiler can miss a whole window,
    # while a call that launches nothing reads empty every time.
    for _ in range(3):
        for e in trace(fn, iters).key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith(("Memcpy", "Memset"))):
                counts[e.key] = counts.get(e.key, 0) + e.count / iters
        if counts:
            break
    return counts


def _record_corner(c: dict, device: torch.device, trim: bool):
    """One :func:`gang_record_corners` case through K2 and its plain
    version on identical copies of its gang (a ``rep_f`` case through K3's
    record stage; any other as the op pads it, or trimmed to its real
    batch); returns (max_abs_err, outputs, coverage)."""
    base = ref.gang_from_numpy(c["planes"], device)
    S = c["n_sets"]
    L = base.occ.shape[0] // S
    ta, tb = base.clone(), base.clone()
    ca, cb = ((torch.zeros((L, ref.N_REASON_CODES), dtype=torch.int32,
                           device=device) for _ in range(2))
              if c["counters"] else (None, None))
    if "valid" in c["rec"]:
        args = copies_operands(base, S, **c["rec"])
        ra = (ops._record_launch(ta, S, *args, ca),)
        rb = (ref.record_copies_plain(tb, S, *args, cb),)
        valid = args[0] < base.occ.shape[0]
    else:
        args = ops.record_operands(base, S, **c["rec"])
        if trim:
            args = [a[:len(c["rec"]["key_hi"])] for a in args]
        ra = ops.gang_record_cuda(ta, S, *args, ca)
        rb = ref.gang_record_plain(tb, S, *args, cb)
        valid = args[3] == 1
    pairs = list(zip(ra, rb)) + list(zip(ta, tb))
    if ca is not None:
        pairs.append((ca, cb))
    return (*_diff(pairs), _coverage(ra[0][valid]))


def check_kernels(planes, n_sets: int, rec: dict, grp: dict, gc: dict,
                  fp: dict, f: int, device="cuda", fp_corners=(),
                  gc_corners=(), rec_corners=(),
                  grp_corners=()) -> List[Parity]:
    """Run each CUDA kernel and its plain version on identical copies of
    the same device tensors; compare every output, every table plane, the
    rings and the counter plane.  ``fp_corners`` (:func:`fastpath_corners`)
    are more K3 cases and ``gc_corners`` (:func:`gc_corners`) more K4
    cases, each run as the op pads it and trimmed to its real batch;
    ``rec_corners`` (:func:`gang_record_corners`) more K2 cases, the same
    (a ``rep_f`` case once, as K3's stage), and ``grp_corners``
    (:func:`gang_groups_corners`) more K5 cases, the same.  Returns one
    :class:`Parity` per kernel."""
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
    parts = [(*_diff(list(zip(ra, rb)) + list(zip(ta, tb)) + [(ca, cb)]),
              _coverage(ra[0][args[3] == 1]))]
    for c in rec_corners:
        for trim in (False,) if "valid" in c["rec"] else (False, True):
            parts.append(_record_corner(c, device, trim))
    out.append(_merge("gang_record", parts))

    (ta, ca), (tb, cb) = twins()
    args = ops.groups_operands(base, n_sets, **grp)
    ra = ops.gang_groups_cuda(ta, n_sets, *args, ca)
    rb = ref.gang_groups_plain(tb, n_sets, *args, cb)
    parts = [(*_diff(list(zip(ra, rb)) + list(zip(ta, tb)) + [(ca, cb)]),
              groups_codes(ta, n_sets, ra[0], *args[:3], *args[4:7]))]
    for c in grp_corners:
        for trim in (False, True):
            parts.append(_groups_corner(c, device, trim))
    out.append(_merge("gang_record_groups", parts))

    parts = []
    cases = [(planes, gc, True, None), (planes, gc, False, None)]
    for p, g, do_age in gc_corners:
        cases += [(p, g, do_age, None), (p, g, do_age, len(g["g_hi"]))]
    for p, g, do_age, trim in cases:
        b = base if p is planes else ref.gang_from_numpy(p, device)
        ta, tb = b.clone(), b.clone()
        args = ops.gc_operands(b, n_sets, **g)
        if trim is not None:         # the real entries, without the padding
            args = [a[:trim] for a in args[:6]] + [args[6]]
        ra = ops.gang_gc_cuda(ta, n_sets, *args, do_age)
        rb = ref.gang_gc_plain(tb, n_sets, *args, do_age)
        parts.append((*_diff([(ra, rb)] + list(zip(ta, tb))),
                      _coverage(ra[args[5] == 1])))
    out.append(_merge("gang_gc", parts))

    parts = []
    cases = [(fp, None)]
    for c in fp_corners:
        cases += [(c, None), (c, len(c["key_hi"]))]
    for case, trim in cases:
        (ta, ca), (tb, cb) = twins()
        case = dict(case)
        rings = ref.ring_from_numpy(case.pop("ring_hi"), case.pop("ring_lo"),
                                    case.pop("ring_cls"), device)
        ring_a = [r.clone() for r in rings]
        ring_b = [r.clone() for r in rings]
        args = ops.fastpath_operands(base, n_sets, **case)
        if trim is not None:         # the real batch, without the padding
            args = [a[:trim] for a in args[:7]] + list(args[7:])
        k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, ex, sm, lm, tail, count = args
        ra = ops.gang_fastpath_cuda(ta, n_sets, f, k_hi, k_lo, k_cls, k_valid,
                                    r_hi, r_lo, ex, sm, lm, *ring_a, tail,
                                    count, ca)
        rb = ref.gang_fastpath_plain(tb, n_sets, f, k_hi, k_lo, k_cls,
                                     k_valid, r_hi, r_lo, ex, sm, lm, *ring_b,
                                     tail, count, cb)
        parts.append((*_diff(list(zip(ra, rb)) + list(zip(ta, tb))
                             + list(zip(ring_a, ring_b)) + [(ca, cb)]),
                      _coverage(ra[0][k_valid.repeat_interleave(f) == 1])))
    out.append(_merge("gang_fastpath", parts))
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


TABLE_RECORD_CORNERS = ("one_set_big_batch", "1_way", "8_ways", "64_ways",
                        "16_sets", "padding_only")


def table_record_corners(rng: np.random.Generator, B: int):
    """(planes, queries) cases at the corners of K6's set-owning design, in
    the order of ``TABLE_RECORD_CORNERS``: 4 x B queries all in one set of
    a 1024 x 4 table (at B = 1024 the owning block's list of 1024 overflows,
    so it takes them in chunks), repeating 64 keys under mixed classes;
    :func:`table_batch` on 256 x 1, 128 x 8 and 64 x 64 (lanes at a stride
    of 32) and on 16 x 4 (fewer sets than blocks); and a batch of no
    queries, which the op pads to a bucket of padding only."""
    out = []
    S, W = 1024, 4
    pool = key_pool(rng, 4 * S, S)
    s = int(rng.integers(0, S))
    k_hi = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    k_lo = ((rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
             & ~np.uint32(S - 1)) | np.uint32(s))
    k = rng.integers(0, 64, 4 * B)
    out.append((table_planes(rng, pool, S, W), dict(
        q_hi=k_hi[k], q_lo=k_lo[k],
        q_cls=CLASSES[rng.integers(0, len(CLASSES), 4 * B)])))
    for S, W in ((256, 1), (128, 8), (64, 64), (16, 4)):
        pool = key_pool(rng, 4 * S * W, S)
        out.append((table_planes(rng, pool, S, W),
                    table_batch(rng, pool, B, W)))
    empty = np.zeros(0, np.uint32)
    out.append((table_planes(rng, key_pool(rng, 64, 16), 16, 4),
                dict(q_hi=empty, q_lo=empty, q_cls=np.zeros(0, np.int32))))
    return out


def window(rng: np.random.Generator, pool: KeyPool, U: int,
           dup_frac: float = 0.0):
    """A U-entry unsynced window of MIXED lanes of the first half of the
    pool (which batches repeat; distinct keys while the half lasts, so a
    same-key query meets one class), with ``w_valid`` 1 + class over
    ``CLASSES`` and 10% invalid entries.  With ``dup_frac``, that share of
    the entries repeats the key of an earlier entry under its own class."""
    half = len(pool.hi) // 2
    k = rng.choice(half, U, replace=U > half)
    valid = 1 + CLASSES[rng.integers(0, len(CLASSES), U)]
    valid[rng.random(U) < 0.1] = 0
    if dup_frac:
        rep = np.flatnonzero(rng.random(U) < dup_frac)
        rep = rep[rep > 0]
        k[rep] = k[(rng.random(rep.size) * rep).astype(np.int64)]
    return pool.q_hi[k], pool.q_lo[k], valid.astype(np.int32)


def table_fastpath_batch(rng: np.random.Generator, pool: KeyPool, B: int,
                         U: int, n_ways: int, n_shards: int,
                         n_slots: int = 256,
                         dup_frac: float = 0.0) -> Dict[str, np.ndarray]:
    """[B] ``fastpath_batch`` ops (RAW lanes, classes over ``CLASSES``),
    half of them keys of the window's half of the pool, a U-entry window
    (``dup_frac``: see :func:`window`; U = 0 gives an empty one) and a
    random slot map over ``n_shards``."""
    key_hi, key_lo = _pool_lanes(rng, pool, B, 2 * n_ways + 1, False)
    hot = rng.random(B) < 0.5
    k = rng.integers(0, len(pool.hi) // 2, int(hot.sum()))
    key_hi[hot], key_lo[hot] = pool.hi[k], pool.lo[k]
    w_hi, w_lo, w_valid = window(rng, pool, U, dup_frac)
    return dict(key_hi=key_hi, key_lo=key_lo,
                key_cls=CLASSES[rng.integers(0, len(CLASSES), B)],
                window_hi=w_hi, window_lo=w_lo, window_valid=w_valid,
                slot_map=rng.integers(0, n_shards, n_slots).astype(np.int32))


def table_fastpath_corners(rng: np.random.Generator, B: int, n_shards: int,
                           big_window: int):
    """(planes, batch) cases at the corners of K7's set-owning design, B
    not a power of two (the ops pad it): an empty window on a 1024 x 4
    table; 777 entries with repeated keys of other classes on 256 x 1 (one
    way) and on 128 x 8; ``big_window`` entries (more than one shared-memory
    table) on 16 x 2.  Then batches of 4 x B on tables of one and four sets,
    against a window of 1024 entries (one staged table) and of
    ``big_window``: at B = 1000 each block owns more than its buffer of
    1024 queries holds, so it takes them in chunks."""
    out = []
    for S, W, U, b in ((1024, 4, 0, B), (256, 1, 777, B), (128, 8, 777, B),
                       (16, 2, big_window, B), (1, 4, 1024, 4 * B),
                       (4, 2, big_window, 4 * B)):
        pool = key_pool(rng, 4 * S if b == B else 4096, S)
        out.append((table_planes(rng, pool, S, W), table_fastpath_batch(
            rng, pool, b, U, W, n_shards, dup_frac=0.2)))
    return out


def scan_batch(rng: np.random.Generator, pool: KeyPool, B: int,
               U: int) -> Dict[str, np.ndarray]:
    """``conflict_scan`` inputs: a U-entry window and [B] MIXED queries,
    most of them keys of the window's half of the pool."""
    w_hi, w_lo, w_valid = window(rng, pool, U)
    k = rng.integers(0, len(pool.hi) * 2 // 3, B)
    return dict(w_hi=w_hi, w_lo=w_lo, w_valid=w_valid, q_hi=pool.q_hi[k],
                q_lo=pool.q_lo[k],
                q_cls=CLASSES[rng.integers(0, len(CLASSES), B)])


SCAN_CORNERS = ("empty_window", "repeated_keys", "all_ones_key",
                "three_tiles", "legacy_valid", "class_32_up", "batch_1000")

ALL_ONES = np.uint32(0xFFFFFFFF)


def scan_corners(rng: np.random.Generator, B: int, U: int):
    """``conflict_scan`` cases at the corners of K8's table join, in the
    order of ``SCAN_CORNERS``, B queries against U entries unless named:
    no window; 32 keys held by up to U / 32 entries each, half of them
    only under INCR (which commutes with itself), half under mixed
    classes, probed by INCR and SET queries; a window entry and queries
    equal to the all-ones key (the table's empty marker) beside keys that
    are all ones in one lane; 3 x U entries (three shared-memory tables at
    U = 1024); a legacy 0/1 window; window classes of 16 to 40 and query
    classes of 16 to 40 (outside the matrix) beside ordinary ones; and
    B = 1000, not a multiple of the block."""
    pool = key_pool(rng, max(4 * U, 256), 64)
    out = [scan_batch(rng, pool, B, 0)]

    hot = rng.integers(0, len(pool.hi), 32)
    k = rng.integers(0, 32, U)
    w_valid = np.where(k < 16, 1 + CLASSES[1],
                       1 + CLASSES[rng.integers(0, len(CLASSES), U)])
    q = rng.integers(0, 32, B)
    out.append(dict(w_hi=pool.q_hi[hot[k]], w_lo=pool.q_lo[hot[k]],
                    w_valid=w_valid.astype(np.int32), q_hi=pool.q_hi[hot[q]],
                    q_lo=pool.q_lo[hot[q]],
                    q_cls=CLASSES[rng.integers(0, 2, B)]))

    sc = scan_batch(rng, pool, B, U)
    n = min(8, B)
    sc["w_hi"][:2] = sc["w_lo"][:2] = ALL_ONES
    sc["w_valid"][:2] = (1 + CLASSES[1], 1 + CLASSES[0])
    sc["w_hi"][2], sc["w_lo"][2] = ALL_ONES, np.uint32(0)
    sc["q_hi"][:n] = sc["q_lo"][:n] = ALL_ONES
    sc["q_hi"][n - 2:n] = (ALL_ONES, np.uint32(0))
    sc["q_lo"][n - 2:n] = (np.uint32(0), ALL_ONES)
    sc["q_cls"][:n] = CLASSES[np.arange(n) % 2]
    out.append(sc)

    out.append(scan_batch(rng, pool, B, 3 * U))
    sc = scan_batch(rng, pool, B, U)
    sc["w_valid"] = (sc["w_valid"] > 0).astype(np.int32)
    out.append(sc)
    sc = scan_batch(rng, pool, B, U)
    odd = rng.random(U) < 0.3
    sc["w_valid"][odd] = 1 + rng.integers(16, 41, int(odd.sum()))
    odd = rng.random(B) < 0.3
    sc["q_cls"][odd] = rng.integers(16, 41, int(odd.sum()))
    out.append(sc)
    out.append(scan_batch(rng, pool, 1000, U))
    return out


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
    of ``conflict_scan`` (K8) cases.  Each K6 and K7 case runs as the op
    pads it and trimmed to its real batch (K7 also to its window; B and U
    may be 0).  Returns one :class:`Parity` per kernel, over all its
    cases."""
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
        padded = ops.table_record_operands(base, **q)
        trimmed = [a[:len(q["q_hi"])] for a in padded]
        for args in (padded, trimmed):   # as the op pads them, and the real
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
        padded = ops.table_fastpath_operands(base, **fp)
        B = len(fp["key_hi"])
        U = 0 if fp.get("window_hi") is None else len(fp["window_hi"])
        trimmed = ([a[:B] for a in padded[:4]] + [padded[4]]
                   + [a[:U] for a in padded[5:]])
        for args in (padded, trimmed):   # as the op pads them, and the real
            k_cls, k_valid, w_hi, w_lo, w_valid = (args[2], args[3],
                                                   *args[5:])
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


TXN_CORNERS = ("1024_keys_distinct_sets", "64_keys_one_set", "all_own",
               "repeated_key", "padding_only", "1_way", "64_ways",
               "all_ones_key", "wide_same_sets")


def _op(hi, lo, coin) -> Dict[str, np.ndarray]:
    """One :func:`txn_chain` op of RAW keys, every key's own coin set to
    ``coin`` (a scalar or one per key)."""
    hi, lo = np.asarray(hi, np.uint32), np.asarray(lo, np.uint32)
    return dict(key_hi=hi, key_lo=lo,
                own_coin=np.broadcast_to(np.asarray(coin, np.int32),
                                         hi.shape).copy())


def _held_raw(pool: KeyPool, planes, rng: np.random.Generator,
              n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The RAW lanes of ``n`` distinct pool keys the table holds."""
    khi, klo, occ = planes
    index = {(int(h), int(lo)): k for k, (h, lo) in
             enumerate(zip(pool.q_hi, pool.q_lo))}
    held_k = np.array([index[(int(khi[s, w]), int(klo[s, w]))]
                       for s, w in np.argwhere(occ > 0)])
    k = rng.choice(held_k, n, replace=False)
    return pool.hi[k], pool.lo[k]


def txn_corners(rng: np.random.Generator):
    """``txn_probe`` chains at the corners of K9's design, in the order of
    ``TXN_CORNERS``: each a dict of ``planes`` and ``probes`` (ops of RAW
    keys with own coins, :func:`txn_chain`'s form; the check marks a key
    own where its coin is set and the key is held).  1024 fresh keys in
    the 1024 distinct sets of a 1024 x 4 table with a free way in every set
    (the block path at its widest: accept), then their retry with every
    key own (an own pass) and without (a conflict at K = 1024, the table
    unchanged); 64 fresh keys in one set of 64 x 4 (FULL, the table
    unchanged), then as many keys of that set as it has free ways spread
    over an op of 64 keys of distinct sets (the rank across warps, an exact
    fit); 16 and 40 held keys, every key own (an own pass that writes
    nothing, on one warp and on a block); a key repeated in an op, fresh
    (both copies claim, two ways), held and own (two passes), held and not
    own (a conflict), and a fresh key repeated across warps of a 48-key op;
    an op of padding only; :func:`txn_chain`s of up to 40 keys on 256 x 1
    and 16 x 64, after 40 and then 12 fresh keys in free sets of 256 x 1
    (a block and a warp that write) and after 64 keys of one set of 16 x
    64 (FULL) and as many as its free ways (an exact fit); the raw all-ones
    key beside the raw zero key and keys all ones in one lane, in sets
    emptied for them, then retried own and not;
    and ops of 40 to 300 fresh keys over a 64 x 8 table, many in a set and
    across warps."""
    out = []

    def case(planes, probes):
        out.append(dict(planes=planes, probes=probes))

    def fresh_in(fresh: KeyPool, sets, n=1):
        k = np.concatenate([fresh.by_set[int(x)][:n] for x in sets])
        return fresh.hi[k], fresh.lo[k]

    S, W = 1024, 4
    pool = key_pool(rng, 2 * S * W, S)
    planes = table_planes(rng, pool, S, W, fill=0.75)
    full = np.flatnonzero((planes[2] > 0).all(1))
    planes[2][full, rng.integers(0, W, full.size)] = 0
    fresh = key_pool(rng, 32 * S, S)
    hi, lo = fresh_in(fresh, rng.permutation(S))
    case(planes, [_op(hi, lo, 0), _op(hi, lo, 1), _op(hi, lo, 0)])

    S, W = 64, 4
    pool = key_pool(rng, 2 * S * W, S)
    planes = table_planes(rng, pool, S, W)
    fresh = key_pool(rng, 256 * S, S)
    s = int(rng.integers(0, S))
    hi, lo = fresh_in(fresh, [s], 64)
    n_free = int((planes[2][s] == 0).sum())
    roomy = [x for x in np.flatnonzero((planes[2] == 0).any(1)) if x != s]
    ohi, olo = fresh_in(fresh, rng.permutation(roomy)[:64 - n_free])
    mix = rng.permutation(ohi.size + n_free)
    fit_hi = np.concatenate([ohi, hi[:n_free]])[mix]
    fit_lo = np.concatenate([olo, lo[:n_free]])[mix]
    case(planes, [_op(hi, lo, 0), _op(fit_hi, fit_lo, 0)])

    pool = key_pool(rng, 2 * S * W, S)
    planes = table_planes(rng, pool, S, W, fill=1.0)
    case(planes, [_op(*_held_raw(pool, planes, rng, n), 1) for n in (16, 40)])

    S = 256
    pool = key_pool(rng, 2 * S * W, S)
    planes = table_planes(rng, pool, S, W)
    fresh = key_pool(rng, 64 * S, S)
    two = rng.permutation(np.flatnonzero((planes[2] == 0).sum(1) >= 2))
    (xh, yh), (xl, yl) = fresh_in(fresh, two[:2])
    (hh, zh), (hl, zl) = _held_raw(pool, planes, rng, 2)
    wide_h, wide_l = fresh_in(fresh, two[2:49])
    wide_h[40], wide_l[40] = wide_h[3], wide_l[3]
    case(planes, [_op([xh, yh, xh], [xl, yl, xl], 0),
                  _op([hh, hh, zh], [hl, hl, zl], 1),
                  _op([hh, yh, hh], [hl, yl, hl], 0),
                  _op(wide_h[:48], wide_l[:48], 0)])

    pool = key_pool(rng, 2 * 64 * 4, 64)
    empty = np.zeros(0, np.uint32)
    case(table_planes(rng, pool, 64, 4), [_op(empty, empty, 0)])

    for S, W in ((256, 1), (16, 64)):
        pool = key_pool(rng, 2 * S * W, S)
        planes = table_planes(rng, pool, S, W)
        fresh = key_pool(rng, 128 * S, S)
        if W == 1:
            free = rng.permutation(np.flatnonzero(planes[2][:, 0] == 0))
            fits = [fresh_in(fresh, free[:40]), fresh_in(fresh, free[40:52])]
        else:
            s = int(rng.integers(0, S))
            hi, lo = fresh_in(fresh, [s], 64)
            n_free = int((planes[2][s] == 0).sum())
            fits = [(hi, lo), (hi[:n_free], lo[:n_free])]
        case(planes, [_op(hi, lo, 0) for hi, lo in fits] + txn_chain(
            rng, pool, planes, 60, max_keys=40, own_frac=0.3, dup_frac=0.2,
            same_set_frac=0.2))

    S, W = 64, 4
    pool = key_pool(rng, 2 * S * W, S)
    planes = table_planes(rng, pool, S, W)
    hi = np.array([ALL_ONES, 0, ALL_ONES, 0], np.uint32)
    lo = np.array([ALL_ONES, 0, 0, ALL_ONES], np.uint32)
    sets = ref.np_keyhash2x32(hi, lo)[1] & np.uint32(S - 1)
    planes[2][sets] = 0                      # room for all four
    case(planes, [_op(hi, lo, 0), _op(hi, lo, 1), _op(hi, lo, 0)])

    S, W = 64, 8
    pool = key_pool(rng, 2 * S * W, S)
    planes = table_planes(rng, pool, S, W, fill=0.3)
    fresh = key_pool(rng, 4096, S)
    probes = []
    for n in (200, 120, 60, 300, 40, 100):
        k = rng.choice(len(fresh.hi), n, replace=False)
        probes.append(_op(fresh.hi[k], fresh.lo[k], 0))
    probes.append(dict(probes[0], own_coin=np.ones(200, np.int32)))
    case(planes, probes)
    return out


TABLE_GC_CORNERS = ("no_entries", "one_entry", "4096_entries",
                    "one_key_repeated", "all_ones_key", "zero_key",
                    "keys_outside_their_set", "4096x1", "64x64", "512x3")


def table_gc_corners(rng: np.random.Generator):
    """(planes, entries) cases of ``witness_gc`` at the corners of K10's
    join, in the order of ``TABLE_GC_CORNERS``, on :func:`gc_planes`'
    tables (64 x 4 unless named) with :func:`gc_entries`: no entries; one
    held key; 4096 entries on 1024 x 4 (four staged tables); 300 copies of
    one held key; the mixed all-ones key (the staged table's empty marker)
    held in one slot and left in a cleared one, given twice among 50
    entries beside keys all ones in one lane (one held, one not); zero entries against slots
    left zero (unoccupied, and one at occ -1 that must stay so) and one
    held slot of key zero; a table whose slots were shuffled across sets
    (the contract reads no set index); and 300 entries on 4096 x 1, 64 x
    64 and 512 x 3 (S x W not a multiple of the block's 1024 slots)."""
    out = []

    def planes_of(S, W):
        return gc_planes(rng, key_pool(rng, 2 * S * W, S), S, W)

    planes = planes_of(64, 4)
    out.append((planes, gc_entries(rng, planes, 0)))
    planes = planes_of(64, 4)
    s, w = np.argwhere(planes[2] > 0)[0]
    out.append((planes, dict(g_hi=planes[0][s, w:w + 1].copy(),
                             g_lo=planes[1][s, w:w + 1].copy())))
    planes = planes_of(1024, 4)
    out.append((planes, gc_entries(rng, planes, 4096)))
    planes = planes_of(64, 4)
    s, w = np.argwhere(planes[2] > 0)[1]
    out.append((planes, dict(g_hi=np.full(300, planes[0][s, w]),
                             g_lo=np.full(300, planes[1][s, w]))))

    planes = planes_of(64, 4)
    (s1, w1), (s2, w2), (s3, w3) = np.argwhere(planes[2] > 0)[:3]
    planes[0][s1, w1] = planes[1][s1, w1] = ALL_ONES
    planes[0][s2, w2] = planes[1][s2, w2] = ALL_ONES
    planes[2][s2, w2] = 0
    planes[0][s3, w3], planes[1][s3, w3] = ALL_ONES, np.uint32(0)
    g = gc_entries(rng, planes, 50)
    g["g_hi"][[5, 30, 31, 32]] = (ALL_ONES, ALL_ONES, ALL_ONES, 0)
    g["g_lo"][[5, 30, 31, 32]] = (ALL_ONES, ALL_ONES, 0, ALL_ONES)
    out.append((planes, g))

    planes = planes_of(64, 4)
    zero = np.flatnonzero((planes[2].reshape(-1) == 0)
                          & (planes[0].reshape(-1) == 0)
                          & (planes[1].reshape(-1) == 0))
    held = np.flatnonzero(planes[2].reshape(-1) > 0)
    for p in planes[:2]:
        p.reshape(-1)[held[0]] = 0
    planes[2].reshape(-1)[zero[0]] = -1
    g = gc_entries(rng, planes, 20)
    for lane in ("g_hi", "g_lo"):
        g[lane][[0, 7, 19]] = 0
    out.append((planes, g))

    planes = planes_of(64, 4)
    order = rng.permutation(planes[2].size)
    planes = tuple(p.reshape(-1)[order].reshape(p.shape) for p in planes)
    out.append((planes, gc_entries(rng, planes, 64)))

    for S, W in ((4096, 1), (64, 64), (512, 3)):
        planes = planes_of(S, W)
        out.append((planes, gc_entries(rng, planes, 300)))
    return out


def _probe_chain(planes, probes, device: torch.device):
    """One :func:`txn_chain` of probes from ``planes`` through K9 and its
    plain version, their tables in lockstep; returns (max_abs_err, outputs,
    coverage codes).  A probe the kernel rejects must leave its table
    bit-identical, which counts as part of the error."""
    ta = ref.witness_table_from_numpy(planes, device)
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
    return max(err, int(kept)), n, reason_coverage(np.array(codes, int),
                                                   N_CODES)


def check_txn_kernels(probe_planes, probes, gcs, seqs, device="cuda",
                      probe_corners=(), gc_corners=()) -> List[Parity]:
    """Run K9, K10 and K11 and their plain versions on the same device
    tensors (tables on identical copies); compare every output and all
    three table planes.

    ``probes`` (:func:`txn_chain`) run as one chain from ``probe_planes``
    (:func:`_probe_chain`), and so does each case of ``probe_corners``
    (:func:`txn_corners`) from its own planes.  ``gcs`` and ``gc_corners``
    (:func:`table_gc_corners`) are (planes, entries) cases of
    ``witness_gc``, ``seqs`` (planes, queries) cases of
    ``witness_record_seq``."""
    device = torch.device(device)
    parts = [_probe_chain(probe_planes, probes, device)]
    parts += [_probe_chain(c["planes"], c["probes"], device)
              for c in probe_corners]
    out = [_merge("txn_probe", parts)]

    parts = []
    for planes, g in list(gcs) + list(gc_corners):
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


# ---------------------------------------------------------------------------
# Decode attention (decode_attn.cu): inputs, and the bound on its gap
# ---------------------------------------------------------------------------
def live_slots(cur_pos: torch.Tensor, C: int) -> torch.Tensor:
    """n_b: the ring slots row b attends, all C once the ring has wrapped
    (``cur_pos[b] >= C``), else ``cur_pos[b] + 1``."""
    return torch.where(cur_pos >= C, C, cur_pos + 1)


def decode_attention_case(B: int, C: int, Hkv: int, rep: int, dh: int,
                          dtype: torch.dtype, device, positions, scale: float,
                          seed: int = 0, score_std: float = 1.5):
    """One decode layer's operands: q [B, 1, Hkv * rep, dh], k and v [B, C,
    Hkv, dh] and cur_pos [B] int32 (``positions`` for the first rows, the
    rest drawn from [0, 2C)).  q is drawn so that the scaled scores have a
    spread of ``score_std``; the slots a row does not hold are 100x larger,
    which the mask has to keep out."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pos = torch.randint(0, 2 * C, (B,), generator=gen, device=device,
                        dtype=torch.int32)
    head = torch.as_tensor(list(positions)[:B], dtype=torch.int32)
    pos[:len(head)] = head.to(device)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q = draw(B, 1, Hkv * rep, dh) * (score_std / (scale * dh ** 0.5))
    k, v = draw(B, C, Hkv, dh), draw(B, C, Hkv, dh)
    dead = (torch.arange(C, device=device)[None, :]
            >= live_slots(pos, C)[:, None])
    k[dead] *= 100
    v[dead] *= 100
    return q.to(dtype), k.to(dtype), v.to(dtype), pos


def decode_attention_bound(q: torch.Tensor, kc: torch.Tensor,
                           vc: torch.Tensor, cur_pos: torch.Tensor,
                           scale: float, o_ref: torch.Tensor) -> torch.Tensor:
    """How far ``decode_attn.cu``'s o may lie from the plain path's
    ``o_ref`` by their arithmetic, element by element ([B, 1, Hq, dh]).
    Both round in the same places and differ only in the order of their
    sums.  With u the type's unit roundoff (2^-8 bf16, 2^-24 f32):

    - each side sums q.k in f32 (the two sums part by at most 2 dh 2^-24
      sum_d |q_d k_td|) and rounds it to the type, one ulp (<= 2u |raw|)
      apart at most: the scaled scores part by delta_t = scale (2u |raw_t|
      + 2 dh 2^-24 sum_d |q_d k_td|) (1 + 2u);
    - a live slot's exact probability then moves by a factor within
      [exp(-delta_t) / D+, exp(delta_t) / D-], D+- = sum_s p_s
      exp(+-delta_s) over the row's live slots; each side rounds p to the
      type (u each) and sums exp in f32 in its own order (n 2^-24 each):
      eps_t = shift_t (1 + 2u) + 2u + (2n + 8) 2^-24;
    - the PV sums part by sum_t eps_t p_t |v_t| from p, by each side's
      summation of its partial sums in f32 or, where the plain path's GEMM
      reduces in the output type, in T (2u sum_t p_t |v_t| each), and by
      each side's final rounding (2u |o|); the whole with a margin of 4u
      for the probabilities' own rounding."""
    B, C, G, dh = kc.shape
    rep = q.shape[2] // G
    u = 2.0 ** -8 if kc.dtype == torch.bfloat16 else 2.0 ** -24
    qf = q.float().reshape(B, G, rep, dh)
    kf = kc.float()
    raw = torch.einsum("bgrd,btgd->bgrt", qf, kf)
    mag = torch.einsum("bgrd,btgd->bgrt", qf.abs(), kf.abs())
    del kf
    n = live_slots(cur_pos, C)
    live = (torch.arange(C, device=kc.device)[None, :] < n[:, None])
    live = live[:, None, None, :]
    delta = torch.where(live, scale * (2 * u * raw.abs() + 2 * dh
                                       * 2.0 ** -24 * mag) * (1 + 2 * u), 0.0)
    p = torch.softmax(torch.where(live, raw * scale, -torch.inf), dim=-1)
    up, down = torch.exp(delta), torch.exp(-delta)
    shift = torch.maximum(up / (p * down).sum(-1, keepdim=True) - 1,
                          1 - down / (p * up).sum(-1, keepdim=True))
    nf = n.float()[:, None, None, None]
    eps = shift * (1 + 2 * u) + 2 * u + (2 * nf + 8) * 2.0 ** -24
    av = vc.float().abs()
    w = torch.einsum("bgrt,btgd->bgrd", p, av)
    we = torch.einsum("bgrt,btgd->bgrd", p * eps, av)
    tol = (we + 4 * u * w
           + 2 * u * o_ref.float().reshape(B, G, rep, dh).abs()) * (1 + 4 * u)
    return tol.reshape(B, 1, G * rep, dh)


# How close decode_attn.cu comes to the plain path, beyond the bound: by
# type, the least share of o's elements that are bit-equal and the largest
# root mean square of the gap over that of the plain o, in units of the
# type's roundoff u (2^-8 bf16, 2^-24 f32).  The bound above is the worst
# case of the summation order, about as large as a typical |o| in bf16, so
# a kernel one slot short or rounding p elsewhere may still pass it; these
# limits do not let them.  Readings on one H100 (bf16, the five layers of
# chip_smoke.py's phase 7c, four seeds each): 0.9878-0.9995 equal, rms
# 0.006-0.096 u.  The kernel built one slot short: 0.34-0.68 equal, 2.1-11
# u; rounding no p: 0.58-0.59 equal, 0.66-0.67 u; dropping one of its 16
# warps' share: 0.008-0.012 equal, 62-71 u (7 of these 15 within the
# bound).  f32 (the contract summed exactly on the CPU, the served layers'
# widths): 10-14 u; a slot short or a warp dropped, 2e5 u and more.
DECODE_ATTENTION_AGREEMENT = {torch.bfloat16: (0.95, 0.4),
                              torch.float32: (0.0, 128.0)}


def decode_attention_agreement(got: torch.Tensor,
                               want: torch.Tensor) -> Tuple[float, float]:
    """(the share of o's elements bit-equal to the plain path's ``want``,
    the root mean square of their gap over that of ``want`` in units of the
    type's roundoff), to hold against ``DECODE_ATTENTION_AGREEMENT``."""
    u = 2.0 ** -8 if want.dtype == torch.bfloat16 else 2.0 ** -24
    gap = (got.float() - want.float()).norm() / want.float().norm()
    return float((got == want).float().mean()), float(gap) / u


def decode_attention_agrees(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether ``got`` meets ``DECODE_ATTENTION_AGREEMENT`` for its type."""
    equal, rms = decode_attention_agreement(got, want)
    least, most = DECODE_ATTENTION_AGREEMENT[want.dtype]
    return equal >= least and rms <= most


__all__ = ["ALL_ONES", "BRANCHES", "CLASSES", "GANG_RECORD_CORNERS",
           "GANG_GROUPS_CORNERS", "GC_CORNERS", "GC_EMPTY", "GC_HIT",
           "GROUP_SAME_WAY", "GC_MISS", "GC_REPEAT",
           "GC_STALE", "KeyPool", "N_CODES", "Parity", "SCAN_COMMUTES",
           "SCAN_CORNERS", "SCAN_HIT", "TABLE_RECORD_CORNERS", "TXN_DUP_KEY",
           "TABLE_GC_CORNERS", "TXN_CORNERS", "TXN_OWN_PASS", "TXN_PADDED",
           "TXN_SAME_SET", "check_kernels",
           "check_table_kernels", "check_txn_kernels", "cls_of_rpc",
           "copies_operands", "DECODE_ATTENTION_AGREEMENT",
           "decode_attention_agreement", "decode_attention_agrees",
           "decode_attention_bound", "decode_attention_case", "fastpath_batch", "fastpath_corners",
           "gang_groups_corners", "gang_planes", "gang_record_corners",
           "gc_batch", "gc_codes", "groups_codes",
           "gc_corners", "gc_entries", "gc_planes", "group_batch", "held",
           "key_pool", "launches_per_call", "live_slots", "reason_coverage",
           "record_batch",
           "scan_batch", "scan_codes", "scan_corners", "table_batch",
           "table_fastpath_batch", "table_fastpath_corners", "table_planes",
           "table_gc_corners", "table_record_corners", "trace", "txn_chain",
           "txn_codes", "txn_corners", "window"]
