"""Plain PyTorch versions of the kernels, and the state they share.

Each CUDA kernel in ``csrc/`` has its plain version here, with the same
signature as its launcher in ``ops.py``: the wrapper takes it for tensors
that lie on the CPU, and ``chip_smoke.py`` holds every kernel against it on
the card.  Nothing on the main path calls these for CUDA tensors.  Two
families: the gang kernels (K2-K5, many witness tables stacked with rpc and
age planes) and the single-table kernels (K1, K6-K11: one ``[S, W]`` table
with key and class planes only, the window scan, the transactional probe,
the gc and the sequential record).

Lane arithmetic.  The uint32 planes are stored as ``torch.int32`` holding
the same bits (``np.ndarray.view(np.int32)`` in, ``.view(np.uint32)`` out);
the CUDA side reads them as ``uint32_t``.  Equality tests need no care, but
CPU torch has no uint32 shift, add, multiply or modulo, and int32 ``>>`` is
arithmetic, so every such step widens to int64 and masks with
``& 0xFFFFFFFF`` first (an int64 product that wraps still has the right low
32 bits).

Reason codes (the protocol layer folds them into RecordStatus):
1 insert / 2 idempotent dup / 3 conflict / 4 set full / 0 padding.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_MIXC = 0xE6546B64

REASON_NONE = 0
REASON_INSERT = 1
REASON_DUP = 2
REASON_CONFLICT = 3
REASON_FULL = 4
N_REASON_CODES = 5   # counter columns; column 0 is unused
# Single-table outcome, seen only by the plain version (the kernels return
# accept bits): accepted into a free way beside a same-key record whose
# class does not conflict (e.g. INCR over INCR).
OUTCOME_STACKED = 5

PLANES = ("keys_hi", "keys_lo", "occ", "rpc_hi", "rpc_lo", "age")
TABLE_PLANES = ("keys_hi", "keys_lo", "occ")


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (there is no
    fallback to the CPU: the caller asks for it by name)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port's kernels need a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions")
    return device


# ---------------------------------------------------------------------------
# Merge-lattice conflict matrix
# ---------------------------------------------------------------------------
def conflict_matrix_np() -> np.ndarray:
    """``CONFLICT_MATRIX`` as int32 bitmask rows (bit b of row a set iff
    class a conflicts with class b).  Imported lazily: repro_torch.core's
    device witness imports this package, so a module-level edge back into
    repro_torch.core would cycle."""
    from ..core.merge import CONFLICT_MATRIX

    return np.asarray(CONFLICT_MATRIX, np.int32)


def matrix_rows(q_cls: torch.Tensor) -> torch.Tensor:
    """``mrow[i] = CONFLICT_MATRIX[q_cls[i]]``; a class outside the matrix
    reads an all-zero row, as the where-sum of the JAX version does."""
    rows = torch.as_tensor(conflict_matrix_np(), device=q_cls.device)
    n = rows.shape[0]
    c = q_cls.to(torch.int64)
    inside = (c >= 0) & (c < n)
    return torch.where(inside, rows[c.clamp(0, n - 1)],
                       torch.zeros((), dtype=torch.int32, device=q_cls.device))


def matrix_bit(mrow: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """``((mrow >> cls) & 1) == 1`` with the shift count bounded: rows are
    16-bit, so a class of 32 or more reads 0 (as XLA's shift does)."""
    c = cls.to(torch.int64)
    ok = (c >= 0) & (c < 32)
    return ok & (((mrow.to(torch.int64) >> c.clamp(0, 31)) & 1) == 1)


# ---------------------------------------------------------------------------
# Keyhash mix: numpy (host) and torch (any device), bit-exact with each other
# and with keyhash.cuh
# ---------------------------------------------------------------------------
def np_fmix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_C1)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(_C2)
    x = x ^ (x >> np.uint32(16))
    return x


def np_keyhash2x32(hi: np.ndarray, lo: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """64-bit-equivalent key hash as two cross-mixed uint32 lanes."""
    old = np.seterr(over="ignore")
    try:
        hi = np.asarray(hi, np.uint32)
        lo = np.asarray(lo, np.uint32)
        h1 = np_fmix32(lo + np.uint32(_GOLD))
        h2 = np_fmix32(hi ^ h1)
        h3 = np_fmix32(h1 + h2 * np.uint32(5) + np.uint32(_MIXC))
    finally:
        np.seterr(**old)
    return h2, h3


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the unsigned value."""
    return x.to(torch.int64) & _M32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> int32 with the same bits."""
    x = x & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 13)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def keyhash2x32(hi: torch.Tensor, lo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch twin of ``np_keyhash2x32`` on int32 bit-pattern lanes."""
    h1 = _fmix32((u32(lo) + _GOLD) & _M32)
    h2 = _fmix32(u32(hi) ^ h1)
    h3 = _fmix32((h1 + h2 * 5 + _MIXC) & _M32)
    return i32(h2), i32(h3)


# ---------------------------------------------------------------------------
# Gang table and the state carried across from the JAX package
# ---------------------------------------------------------------------------
class GangTable(NamedTuple):
    """L stacked witness tables as six ``[L*S, W]`` int32 planes (global row
    = lane * S + (q_lo & (S-1))).  ``keys_hi``/``keys_lo``/``rpc_hi``/
    ``rpc_lo`` hold uint32 bits; ``occ`` is 0 (empty) or 1 + op class;
    ``age`` counts the gc rounds a slot survived.  The kernels update the
    planes in place."""
    keys_hi: torch.Tensor
    keys_lo: torch.Tensor
    occ: torch.Tensor
    rpc_hi: torch.Tensor
    rpc_lo: torch.Tensor
    age: torch.Tensor

    @staticmethod
    def empty(n_sets: int, n_ways: int, n_lanes: int = 1,
              device="cuda") -> "GangTable":
        """An empty gang, on the card unless the caller asks for another
        device."""
        assert n_sets & (n_sets - 1) == 0, "n_sets must be a power of two"
        device = resolve_device(device)
        R = n_lanes * n_sets
        return GangTable(*(torch.zeros((R, n_ways), dtype=torch.int32,
                                       device=device) for _ in PLANES))

    def clone(self) -> "GangTable":
        return GangTable(*(p.clone() for p in self))


def gang_from_numpy(planes: Sequence[np.ndarray], device="cuda") -> GangTable:
    """The JAX package's gang state (six numpy planes, uint32/int32 as
    ``repro.kernels.ref._gang_np`` gives them) as the port's tensors, on
    the card unless the caller asks for another device."""
    device = resolve_device(device)
    return GangTable(*(
        torch.from_numpy(np.ascontiguousarray(np.asarray(a)).view(np.int32)
                         .copy()).to(device)
        for a in planes))


def gang_to_numpy(table: GangTable) -> Tuple[np.ndarray, ...]:
    """The port's gang as six numpy planes with the JAX package's dtypes."""
    out = []
    for name, p in zip(PLANES, table):
        a = p.detach().cpu().numpy()
        out.append(a.view(np.int32 if name in ("occ", "age") else np.uint32))
    return tuple(out)


def ring_from_numpy(hi: np.ndarray, lo: np.ndarray, cls: np.ndarray,
                    device="cuda") -> Tuple[torch.Tensor, ...]:
    """``[NS, CAP]`` uint32/uint32/int32 rings as int32 tensors, on the card
    unless the caller asks for another device."""
    device = resolve_device(device)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()).to(device)
        for a in (np.asarray(hi, np.uint32), np.asarray(lo, np.uint32),
                  np.asarray(cls, np.int32)))


def ring_to_numpy(hi: torch.Tensor, lo: torch.Tensor, cls: torch.Tensor):
    return (hi.cpu().numpy().view(np.uint32), lo.cpu().numpy().view(np.uint32),
            cls.cpu().numpy())


def reason_counts_update(counters: torch.Tensor, lanes: torch.Tensor,
                         reasons: torch.Tensor, valid: torch.Tensor) -> None:
    """Accumulate one count per valid outcome at ``[lane, reason]``, in
    place on the ``[L, 5]`` counter plane."""
    keep = valid.to(torch.bool)
    counters.index_put_(
        (lanes[keep].to(torch.int64), reasons[keep].to(torch.int64)),
        torch.ones((), dtype=counters.dtype, device=counters.device)
        .expand(int(keep.sum())),
        accumulate=True)


# ---------------------------------------------------------------------------
# K2: set-parallel single-key gang record (plain version)
# ---------------------------------------------------------------------------
def _rounds(rows: torch.Tensor, valid: torch.Tensor):
    """The valid queries in rounds for an ordered walk of each row: round r
    holds the r-th query of every row (batch order within a row).  Yields
    (q, rw) per round: batch positions and their rows, one query per row."""
    idx = torch.nonzero(valid.to(torch.bool)).flatten()
    if idx.numel() == 0:
        return
    r_sorted, order = torch.sort(rows[idx].to(torch.int64), stable=True)
    orig = idx[order]
    pos = torch.arange(r_sorted.shape[0], device=rows.device)
    start = torch.ones_like(r_sorted, dtype=torch.bool)
    start[1:] = r_sorted[1:] != r_sorted[:-1]
    run_start = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank = pos - run_start
    for r in range(int(rank.max()) + 1):
        at = rank == r
        yield orig[at], r_sorted[at]


def record_rows_plain(table: GangTable, rows: torch.Tensor,
                      qh: torch.Tensor, ql: torch.Tensor,
                      rh: torch.Tensor, rl: torch.Tensor, cls: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Record single-key queries at global ``rows``: queries to one row
    resolve in batch order, rows are independent.  Per query: CONFLICT (3)
    if a same-key way is held under another rpc and the matrix bit is set
    (conflict wins over dup); else DUP (2) at the first same-key same-rpc
    way; else INSERT (1) at the first free way; else FULL (4).  An accept
    writes key, 1 + class, rpc and age 0 into its way.  Returns [N] reasons
    (0 for invalid queries); the table is updated in place.

    Vectorised by rounds: round r resolves the r-th query of every row."""
    dev = rows.device
    N = rows.shape[0]
    W = table.occ.shape[1]
    reasons = torch.zeros(N, dtype=torch.int32, device=dev)
    mrow_all = matrix_rows(cls)
    way_iota = torch.arange(W, device=dev)
    for q, rw in _rounds(rows, valid):
        row_hi, row_lo = table.keys_hi[rw], table.keys_lo[rw]
        row_occ, row_rh = table.occ[rw], table.rpc_hi[rw]
        row_rl, row_age = table.rpc_lo[rw], table.age[rw]
        keym = ((row_occ > 0) & (row_hi == qh[q, None])
                & (row_lo == ql[q, None]))
        rpcm = (row_rh == rh[q, None]) & (row_rl == rl[q, None])
        dupm = keym & rpcm
        wcls = torch.clamp(row_occ - 1, min=0)
        confm = keym & ~rpcm & matrix_bit(mrow_all[q, None], wcls)
        is_dup = dupm.any(1)
        is_conf = confm.any(1)
        free = row_occ == 0
        has_free = free.any(1)
        way = torch.where(is_dup, dupm.to(torch.int8).argmax(1),
                          free.to(torch.int8).argmax(1))
        acc = ~is_conf & (is_dup | has_free)
        reason = torch.where(is_conf, 3, torch.where(
            is_dup, 2, torch.where(has_free, 1, 4))).to(torch.int32)
        reasons[q] = reason
        sel = (way_iota[None, :] == way[:, None]) & acc[:, None]
        table.keys_hi[rw] = torch.where(sel, qh[q, None], row_hi)
        table.keys_lo[rw] = torch.where(sel, ql[q, None], row_lo)
        table.occ[rw] = torch.where(sel, 1 + cls[q, None], row_occ)
        table.rpc_hi[rw] = torch.where(sel, rh[q, None], row_rh)
        table.rpc_lo[rw] = torch.where(sel, rl[q, None], row_rl)
        table.age[rw] = torch.where(sel, torch.zeros_like(row_age), row_age)
    return reasons


def record_copies_plain(table: GangTable, n_sets: int, rows: torch.Tensor,
                        rep: int, qh, ql, r_hi, r_lo, cls,
                        counters=None) -> torch.Tensor:
    """Plain version of the ``gang_record`` kernel as K3's record stage:
    copy e of op e // rep at gang row ``rows[e]`` (a row outside
    [0, L * S) is padding: reason 0, no count), and one count per recorded
    copy at its lane ``rows[e] // S``.  Returns [N] reasons."""
    rows = rows.to(torch.int64)
    valid = (rows >= 0) & (rows < table.occ.shape[0])
    rep_ = lambda x: torch.repeat_interleave(x, rep)  # noqa: E731
    rsn = record_rows_plain(table, rows, rep_(qh), rep_(ql), rep_(r_hi),
                            rep_(r_lo), rep_(cls), valid)
    if counters is not None:
        reason_counts_update(counters, rows // n_sets, rsn, valid)
    return rsn


def gang_rows(lanes: torch.Tensor, ql: torch.Tensor, n_sets: int) -> torch.Tensor:
    """Global gang row ``lane * S + (ql & (S-1))`` (S a power of two, so the
    mask reads the low bits of the int32 pattern unchanged)."""
    return lanes.to(torch.int64) * n_sets + (ql.to(torch.int64) & (n_sets - 1))


def gang_record_plain(table: GangTable, n_sets: int, k_hi, k_lo, k_cls,
                      k_valid, lanes, r_hi, r_lo, counters=None):
    """Plain version of the ``gang_record`` kernel (K2): hash the raw key
    lanes, record at ``lanes``, and add one count per valid query at its
    lane.  Returns (reasons, q_hi, q_lo) as [B] int32 tensors."""
    qh, ql = keyhash2x32(k_hi, k_lo)
    rows = gang_rows(lanes, ql, n_sets)
    rsn = record_rows_plain(table, rows, qh, ql, r_hi, r_lo, k_cls, k_valid)
    if counters is not None:
        reason_counts_update(counters, lanes, rsn, k_valid)
    return rsn, qh, ql


# ---------------------------------------------------------------------------
# K5: grouped all-or-nothing gang record (plain version)
# ---------------------------------------------------------------------------
def gang_groups_plain(table: GangTable, n_sets: int, k_hi, k_lo, k_valid,
                      k_cls, lanes, r_hi, r_lo, g_valid, counters=None):
    """Plain version of the ``gang_record_groups`` kernel (K5).

    ``k_*`` are [G, K]; ``lanes``/``r_*``/``g_valid`` are [G].  Groups run in
    index order; each group's keys decide against the table as earlier
    groups left it.  A key is a DUP on a same-key same-rpc way, a CONFLICT
    on a foreign-rpc same-key way whose class conflicts; an inserting key
    takes its row's (rank+1)-th free way, rank counting the group's earlier
    inserters into that row.  The group accepts only if every valid key is
    placed, and writes only then.  Reason: 2 if every valid key was a dup,
    1 on accept, else 3 or 4 from the first failing key; 0 for padding
    groups.  Returns (reasons [G], q_hi [G, K], q_lo [G, K])."""
    G, K = k_hi.shape
    dev = k_hi.device
    W = table.occ.shape[1]
    qh, ql = keyhash2x32(k_hi.reshape(-1), k_lo.reshape(-1))
    qh, ql = qh.reshape(G, K), ql.reshape(G, K)
    rows = gang_rows(lanes[:, None], ql, n_sets)                   # [G, K]
    mrow = matrix_rows(k_cls)
    reasons = torch.zeros(G, dtype=torch.int32, device=dev)
    earlier = (torch.arange(K, device=dev)[None, :]
               < torch.arange(K, device=dev)[:, None])             # j < k
    way_iota = torch.arange(W, device=dev)
    for g in range(G):
        if int(g_valid[g]) != 1:
            continue
        rw = rows[g]
        vk = k_valid[g] == 1
        row_hi, row_lo = table.keys_hi[rw], table.keys_lo[rw]
        row_occ = table.occ[rw]
        keym = ((row_occ > 0) & (row_hi == qh[g, :, None])
                & (row_lo == ql[g, :, None]))
        rpcm = (table.rpc_hi[rw] == r_hi[g]) & (table.rpc_lo[rw] == r_lo[g])
        dupm = keym & rpcm
        wcls = torch.clamp(row_occ - 1, min=0)
        confm = keym & ~rpcm & matrix_bit(mrow[g, :, None], wcls)
        dup_k = dupm.any(1)
        conf_k = confm.any(1)
        free = row_occ == 0
        claim = vk & ~dup_k
        rank = ((rw[:, None] == rw[None, :]) & earlier
                & claim[None, :]).sum(1)
        n_free = free.sum(1)
        seat = n_free > rank
        cfree = torch.cumsum(free.to(torch.int64), dim=1)
        selw = free & (cfree == (rank + 1)[:, None])
        way_k = torch.where(dup_k, dupm.to(torch.int8).argmax(1),
                            selw.to(torch.int8).argmax(1))
        ok_k = ~conf_k & (dup_k | seat)
        acc = bool((ok_k | ~vk).all())
        if acc:
            reason = 2 if bool((dup_k | ~vk).all() & vk.any()) else 1
            for k in range(K):
                if not bool(vk[k]):
                    continue
                r, w = int(rw[k]), int(way_k[k])
                table.keys_hi[r, w] = qh[g, k]
                table.keys_lo[r, w] = ql[g, k]
                table.occ[r, w] = 1 + k_cls[g, k]
                table.rpc_hi[r, w] = r_hi[g]
                table.rpc_lo[r, w] = r_lo[g]
                table.age[r, w] = 0
        else:
            first = int((vk & ~ok_k).to(torch.int8).argmax())
            reason = 3 if bool(conf_k[first]) else 4
        reasons[g] = reason
    if counters is not None:
        reason_counts_update(counters, lanes, reasons, g_valid)
    return reasons, qh, ql


# ---------------------------------------------------------------------------
# K4: rpc-matched gang gc with aging (plain version)
# ---------------------------------------------------------------------------
def gang_gc_plain(table: GangTable, n_sets: int, g_hi, g_lo, g_rh, g_rl,
                  g_lane, g_valid, aged_idx, do_age: bool):
    """Plain version of the ``gang_gc`` kernel (K4).

    Entries carry MIXED key lanes, rpc lanes and a target lane.  Every
    decision is taken against the PRE-gc table: a slot clears (occ and age
    to 0) when key, rpc and row all match a valid entry, and each entry's
    cleared bit says whether it matched any slot — two identical entries
    both report 1.  With ``do_age`` every slot of the lanes in ``aged_idx``
    then ages: occupied survivors +1, empty slots 0.  Returns [G] int32."""
    W = table.occ.shape[1]
    dev = g_hi.device
    rows = gang_rows(g_lane, g_lo, n_sets)
    m = ((table.occ[rows] > 0) & (table.keys_hi[rows] == g_hi[:, None])
         & (table.keys_lo[rows] == g_lo[:, None])
         & (table.rpc_hi[rows] == g_rh[:, None])
         & (table.rpc_lo[rows] == g_rl[:, None])
         & (g_valid[:, None] == 1))                                # [G, W]
    cleared = m.any(1).to(torch.int32)
    flat = (rows[:, None] * W + torch.arange(W, device=dev)[None, :])[m]
    table.occ.view(-1)[flat] = 0
    table.age.view(-1)[flat] = 0
    if do_age and aged_idx.numel():
        arows = (aged_idx.to(torch.int64)[:, None] * n_sets
                 + torch.arange(n_sets, device=dev)[None, :]).reshape(-1)
        occ, age = table.occ[arows], table.age[arows]
        table.age[arows] = torch.where(occ > 0, age + 1,
                                       torch.zeros_like(age))
    return cleared


# ---------------------------------------------------------------------------
# K3: fused cluster batch (plain version)
# ---------------------------------------------------------------------------
def gang_fastpath_plain(table: GangTable, n_sets: int, f: int,
                        k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, exec_pred,
                        slot_map, lane_map, ring_hi, ring_lo, ring_cls,
                        tail, count, counters=None):
    """Plain version of the ``gang_fastpath_batch`` kernels (K3, with K2 as
    its record stage).

    hash -> slot route (``slot_map[lo % n_slots]``, unsigned) -> scan of
    each shard's live ring span (``(c - tail) % CAP < count``, key match and
    matrix bit) -> conflict with EARLIER same-shard same-key ops that will
    execute (matrix bit) -> ring append of executing ops at
    ``(tail + count + rank) % CAP`` -> record every op at its shard's ``f``
    witness lanes (``lane_map``) -> one count per (op, copy).  Rings, table
    and counters update in place.  Returns (reasons [B*f], conflicts [B],
    shard [B], q_hi [B], q_lo [B], new_count [NS])."""
    dev = k_hi.device
    B = k_hi.shape[0]
    NS, CAP = ring_hi.shape
    n_slots = slot_map.shape[0]
    qh, ql = keyhash2x32(k_hi, k_lo)
    shard = slot_map[u32(ql) % n_slots].to(torch.int64)          # [B]
    valid = k_valid == 1
    mrow = matrix_rows(k_cls)
    tail_b = tail.to(torch.int64)[shard]
    count_b = count.to(torch.int64)[shard]
    c_iota = torch.arange(CAP, device=dev)[None, :]
    live = torch.remainder(c_iota - tail_b[:, None], CAP) < count_b[:, None]
    ring_hit = (live & (ring_hi[shard] == qh[:, None])
                & (ring_lo[shard] == ql[:, None])
                & matrix_bit(mrow[:, None], ring_cls[shard])).any(1)
    app = (exec_pred == 1) & valid
    b_iota = torch.arange(B, device=dev)
    earlier = b_iota[:, None] > b_iota[None, :]
    same_shard = shard[:, None] == shard[None, :]
    intra_hit = ((qh[:, None] == qh[None, :]) & (ql[:, None] == ql[None, :])
                 & same_shard & matrix_bit(mrow[:, None], k_cls[None, :])
                 & earlier & app[None, :]).any(1)
    conflicts = ((ring_hit | intra_hit) & valid).to(torch.int32)
    rank = (same_shard & earlier & app[None, :]).sum(1)
    pos = torch.remainder(tail_b + count_b + rank, CAP)
    ring_hi[shard[app], pos[app]] = qh[app]
    ring_lo[shard[app], pos[app]] = ql[app]
    ring_cls[shard[app], pos[app]] = k_cls[app]
    new_count = (count.to(torch.int64)
                 + torch.bincount(shard[app], minlength=NS)).to(torch.int32)
    lanes_e = lane_map[shard].reshape(-1)                          # [B*f]
    rows_e = torch.where(torch.repeat_interleave(valid, f),
                         gang_rows(lanes_e, torch.repeat_interleave(ql, f),
                                   n_sets), table.occ.shape[0])
    rsn = record_copies_plain(table, n_sets, rows_e, f, qh, ql, r_hi, r_lo,
                              k_cls, counters)
    return rsn, conflicts, shard.to(torch.int32), qh, ql, new_count


# ---------------------------------------------------------------------------
# Single-table family: one [S, W] witness table, the window scan, the hash
# ---------------------------------------------------------------------------
class WitnessTable(NamedTuple):
    """One witness table of S sets x W ways as three ``[S, W]`` int32
    planes: ``keys_hi``/``keys_lo`` hold the mixed keyhash lanes' uint32
    bits, ``occ`` is 0 (empty) or 1 + op class.  The kernels update the
    planes in place."""
    keys_hi: torch.Tensor
    keys_lo: torch.Tensor
    occ: torch.Tensor

    @staticmethod
    def empty(n_sets: int, n_ways: int, device="cuda") -> "WitnessTable":
        assert n_sets & (n_sets - 1) == 0, "n_sets must be a power of two"
        device = resolve_device(device)
        return WitnessTable(*(torch.zeros((n_sets, n_ways), dtype=torch.int32,
                                          device=device)
                              for _ in TABLE_PLANES))

    def clone(self) -> "WitnessTable":
        return WitnessTable(*(p.clone() for p in self))


def witness_table_from_numpy(planes: Sequence[np.ndarray],
                             device="cuda") -> WitnessTable:
    """The JAX package's ``WitnessTable`` state (``keys_hi``, ``keys_lo``
    uint32 and ``occ`` int32, as numpy) as the port's tensors."""
    device = resolve_device(device)
    return WitnessTable(*(
        torch.from_numpy(np.ascontiguousarray(np.asarray(a)).view(np.int32)
                         .copy()).to(device)
        for a in planes))


def witness_table_to_numpy(table: WitnessTable) -> Tuple[np.ndarray, ...]:
    """The port's table as three numpy planes with the JAX dtypes."""
    hi, lo, occ = (p.detach().cpu().numpy() for p in table)
    return hi.view(np.uint32), lo.view(np.uint32), occ


def keyhash_plain(hi: torch.Tensor, lo: torch.Tensor, slot_map=None):
    """Plain version of the ``keyhash`` kernel (K1): the mixed lanes and,
    with a slot map, the shard of each key (``slot_map[lo % n_slots]``,
    unsigned).  Returns (q_hi, q_lo, shard or None)."""
    qh, ql = keyhash2x32(hi, lo)
    if slot_map is None:
        return qh, ql, None
    return qh, ql, slot_map[u32(ql) % slot_map.shape[0]]


def witness_sets(q_lo: torch.Tensor, q_valid: torch.Tensor,
                 n_sets: int) -> torch.Tensor:
    """Probed set ``q_lo & (S-1)`` per query (S a power of two: the mask
    reads the low bits of the int32 pattern unchanged); padding gets S."""
    sets = q_lo.to(torch.int64) & (n_sets - 1)
    return torch.where(q_valid == 1, sets, torch.full_like(sets, n_sets))


def witness_outcomes_plain(table: WitnessTable, q_hi, q_lo, q_cls,
                           q_valid) -> torch.Tensor:
    """Record MIXED query lanes into one table, queries to one set in batch
    order, sets independent (``ref_witness_record`` of the JAX package).
    Per query: CONFLICT (3) if a way holds the same key and the matrix bit
    ``(mrow >> (occ-1)) & 1`` is set; else insert at the first free way
    with ``occ = 1 + class``: INSERT (1), or ``OUTCOME_STACKED`` (5) when a
    same-key record of a non-conflicting class is held; else FULL (4).
    There is no rpc, no DUP and no age.  Returns [B] outcomes (0 for
    padding); the table is updated in place."""
    S, W = table.occ.shape
    dev = q_hi.device
    outcome = torch.zeros(q_hi.shape[0], dtype=torch.int32, device=dev)
    mrow_all = matrix_rows(q_cls)
    way_iota = torch.arange(W, device=dev)
    for q, rw in _rounds(witness_sets(q_lo, q_valid, S), q_valid):
        row_hi, row_lo = table.keys_hi[rw], table.keys_lo[rw]
        row_occ = table.occ[rw]
        keym = ((row_occ > 0) & (row_hi == q_hi[q, None])
                & (row_lo == q_lo[q, None]))
        conf = (keym & matrix_bit(mrow_all[q, None],
                                  torch.clamp(row_occ - 1, min=0))).any(1)
        free = row_occ == 0
        has_free = free.any(1)
        acc = ~conf & has_free
        outcome[q] = torch.where(conf, REASON_CONFLICT, torch.where(
            ~has_free, REASON_FULL, torch.where(
                keym.any(1), OUTCOME_STACKED, REASON_INSERT))).to(torch.int32)
        sel = ((way_iota[None, :] == free.to(torch.int8).argmax(1)[:, None])
               & acc[:, None])
        table.keys_hi[rw] = torch.where(sel, q_hi[q, None], row_hi)
        table.keys_lo[rw] = torch.where(sel, q_lo[q, None], row_lo)
        table.occ[rw] = torch.where(sel, 1 + q_cls[q, None], row_occ)
    return outcome


def witness_record_plain(table: WitnessTable, q_hi, q_lo, q_cls,
                         q_valid) -> torch.Tensor:
    """Plain version of the ``witness_record`` kernel (K6): the accept bit
    of :func:`witness_outcomes_plain` ([B] int32, 0 for padding)."""
    out = witness_outcomes_plain(table, q_hi, q_lo, q_cls, q_valid)
    return ((out == REASON_INSERT) | (out == OUTCOME_STACKED)).to(torch.int32)


def conflict_scan_plain(w_hi, w_lo, w_valid, q_hi, q_lo,
                        q_cls) -> torch.Tensor:
    """Plain version of the ``conflict_scan`` kernel (K8):
    ``conflicts[b] = OR_u (same key & w_valid[u] > 0 & matrix bit)``, where
    ``w_valid`` packs 0 (invalid) or 1 + class (legacy 0/1 means SET).
    Returns [B] int32."""
    wv = w_valid.to(torch.int64)
    mrow = matrix_rows(q_cls)
    eq = ((q_hi[:, None] == w_hi[None, :]) & (q_lo[:, None] == w_lo[None, :])
          & (wv[None, :] > 0)
          & matrix_bit(mrow[:, None], torch.clamp(wv - 1, min=0)[None, :]))
    return eq.any(1).to(torch.int32)


def fastpath_record_scan_plain(table: WitnessTable, k_hi, k_lo, k_cls,
                               k_valid, slot_map, w_hi, w_lo, w_valid):
    """Plain version of the ``fastpath_record_scan`` kernels (K7): hash the
    raw key lanes, route (``slot_map[lo % n_slots]``), record the mixed
    lanes (K6) and scan them against the window (K8) -- the window only,
    with no in-batch check and no append.  Returns (accepted, conflicts,
    shard, q_hi, q_lo), each [B] int32; padding neither accepts nor hits."""
    qh, ql, shard = keyhash_plain(k_hi, k_lo, slot_map)
    acc = witness_record_plain(table, qh, ql, k_cls, k_valid)
    con = conflict_scan_plain(w_hi, w_lo, w_valid, qh, ql, k_cls)
    con = torch.where(k_valid == 1, con, torch.zeros_like(con))
    return acc, con, shard, qh, ql


# ---------------------------------------------------------------------------
# K9-K11: the transactional probe, the gc and the sequential record of one
# table (plain versions)
# ---------------------------------------------------------------------------
def txn_probe_plain(table: WitnessTable, k_hi, k_lo, own, valid):
    """Plain version of the ``txn_probe`` kernel (K9, with K1's mix before
    it): the all-or-nothing record of ONE op's K raw keys.

    Every key decides against the PRE-op table: ``hit`` = the key is held
    in its set (``occ > 0``).  A key with ``own = 1`` passes on a hit (a
    retry of this op's own record) or if it seats; any other key must miss
    and seat.  An inserter (valid, no hit) ranks among the op's earlier
    inserters into its set and claims the set's (rank+1)-th free way; it
    seats if the set has more free ways than its rank.  The op accepts iff
    every valid key passes; only then are the inserters written (keys,
    ``occ = 1``), so a rejected op leaves the table bit-identical.  Returns
    (accepted [1], hit [K] masked by ``valid``, q_hi [K], q_lo [K]), int32.
    """
    S, W = table.occ.shape
    K = k_hi.shape[0]
    dev = k_hi.device
    qh, ql = keyhash2x32(k_hi, k_lo)
    sets = ql.to(torch.int64) & (S - 1)
    row_hi, row_lo, row_occ = (table.keys_hi[sets], table.keys_lo[sets],
                               table.occ[sets])                   # [K, W]
    hit = ((row_occ > 0) & (row_hi == qh[:, None])
           & (row_lo == ql[:, None])).any(1)
    free = row_occ == 0
    vk = valid == 1
    claim = vk & ~hit
    k_iota = torch.arange(K, device=dev)
    earlier = k_iota[None, :] < k_iota[:, None]                     # j < k
    rank = ((sets[:, None] == sets[None, :]) & earlier
            & claim[None, :]).sum(1)
    seat = free.sum(1) > rank
    cfree = torch.cumsum(free.to(torch.int64), dim=1)
    way = (free & (cfree == (rank + 1)[:, None])).to(torch.int8).argmax(1)
    ok = torch.where(own == 1, hit | seat, ~hit & seat)
    accepted = bool((ok | ~vk).all())
    if accepted:
        w = claim.nonzero().flatten()
        table.keys_hi[sets[w], way[w]] = qh[w]
        table.keys_lo[sets[w], way[w]] = ql[w]
        table.occ[sets[w], way[w]] = 1
    acc = torch.full((1,), int(accepted), dtype=torch.int32, device=dev)
    return acc, (hit & vk).to(torch.int32), qh, ql


def witness_gc_plain(table: WitnessTable, g_hi, g_lo) -> None:
    """Plain version of the ``witness_gc`` kernel (K10): ``occ <- 0`` in
    every slot of the table whose MIXED key lanes equal any gc entry's and
    whose ``occ > 0``.  No set index, no rpc and no age: a slot anywhere
    in the table clears on a key match; key planes are untouched.  G may
    be 0.  The table is updated in place."""
    if g_hi.shape[0] == 0:
        return
    m = ((table.keys_hi[:, :, None] == g_hi[None, None, :])
         & (table.keys_lo[:, :, None] == g_lo[None, None, :])).any(2)
    table.occ[m & (table.occ > 0)] = 0


def witness_seq_outcomes_plain(table: WitnessTable, q_hi,
                              q_lo) -> torch.Tensor:
    """The classless sequential record of MIXED lanes, in batch order
    (``_record_seq_kernel`` of the JAX package).  Per query, in set
    ``q_lo & (S-1)``: CONFLICT (3) on a same-key way with ``occ == 1``
    exactly; else insert at the first free way with ``occ = 1``: INSERT
    (1), or ``OUTCOME_STACKED`` (5) when the key is held under another
    class (``occ > 1``: occupied, but no conflict); else FULL (4).  No
    padding, no valid mask.  Returns [B] outcomes; the table is updated in
    place.

    Only queries to one set depend on each other, so this resolves them in
    rounds (the r-th query of every set at once), as the ordered loop
    would."""
    S, W = table.occ.shape
    dev = q_hi.device
    outcome = torch.zeros(q_hi.shape[0], dtype=torch.int32, device=dev)
    sets = q_lo.to(torch.int64) & (S - 1)
    way_iota = torch.arange(W, device=dev)
    for q, rw in _rounds(sets, torch.ones_like(q_hi)):
        row_hi, row_lo = table.keys_hi[rw], table.keys_lo[rw]
        row_occ = table.occ[rw]
        keym = (row_hi == q_hi[q, None]) & (row_lo == q_lo[q, None])
        conf = (keym & (row_occ == 1)).any(1)
        free = row_occ == 0
        has_free = free.any(1)
        acc = ~conf & has_free
        outcome[q] = torch.where(conf, REASON_CONFLICT, torch.where(
            ~has_free, REASON_FULL, torch.where(
                (keym & (row_occ > 1)).any(1), OUTCOME_STACKED,
                REASON_INSERT))).to(torch.int32)
        sel = ((way_iota[None, :] == free.to(torch.int8).argmax(1)[:, None])
               & acc[:, None])
        table.keys_hi[rw] = torch.where(sel, q_hi[q, None], row_hi)
        table.keys_lo[rw] = torch.where(sel, q_lo[q, None], row_lo)
        table.occ[rw] = torch.where(sel, torch.ones_like(row_occ), row_occ)
    return outcome


def witness_record_seq_plain(table: WitnessTable, q_hi,
                             q_lo) -> torch.Tensor:
    """Plain version of the ``witness_record_seq`` kernel (K11): the accept
    bit of :func:`witness_seq_outcomes_plain` ([B] int32)."""
    out = witness_seq_outcomes_plain(table, q_hi, q_lo)
    return ((out == REASON_INSERT) | (out == OUTCOME_STACKED)).to(torch.int32)
