"""Public wrappers of the gang kernels: one dispatch per call.

Counterpart of the gang ops in ``src/repro/kernels/ops.py``:
``gang_record`` (K2), ``gang_record_groups`` (K5), ``gang_gc`` (K4) and
``gang_fastpath_batch`` (K3, with K2 as its record stage).  Signatures,
result tuples and reason codes are the JAX package's, without its TPU-only
options (``interpret``, ``tile_sets``).

Each op pads its host (numpy) inputs to a power-of-two bucket as the JAX
version does (``_bucket``/``_pad_valid``), moves them to the table's device
in one copy, runs, and brings every host-side output back in one copy.  On
CUDA tensors it launches the hand-written kernels of ``csrc/``; on CPU
tensors it runs their plain versions in ``ref.py``; any other device
raises.  There is no fallback from one to the other.

The table planes, the rings and the ``[L, 5]`` counter plane are updated
IN PLACE (the JAX version donated their buffers instead); the results hand
back the same tensors, so callers rebind exactly as before.

``dispatch_count()`` counts public op calls on the port's telemetry
registry, as the JAX package counts jitted-program launches.  Each
:class:`CudaKernel` below also counts its own launches (``launches``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import ref
from .build import CudaKernel, I, P
from .ref import GangTable, N_REASON_CODES

# ---------------------------------------------------------------------------
# Host-side dispatch accounting (on the port's own telemetry registry)
# ---------------------------------------------------------------------------
_DISPATCH_COUNTER = "kernels.dispatches"


def _count_dispatch(n: int = 1) -> None:
    from ..core.telemetry import registry

    registry().counter(_DISPATCH_COUNTER).inc(n)


def dispatch_count() -> int:
    """Public gang-op calls since the last reset (one per call, whatever
    the device)."""
    from ..core.telemetry import registry

    return registry().counter(_DISPATCH_COUNTER).value


def reset_dispatch_count() -> None:
    from ..core.telemetry import registry

    registry().counter(_DISPATCH_COUNTER).reset()


# ---------------------------------------------------------------------------
# The kernels of this slice
# ---------------------------------------------------------------------------
_CSRC = "src/repro_torch/kernels/csrc/"

GANG_RECORD = CudaKernel(
    "gang_record", _CSRC + "gang_record.cu",
    "src/repro/kernels/witness_record.py:681",
    {"gang_record_prep": [I, P, P, P, P, I, I, P, P, P, P],
     "gang_record_runs": [I, I] + [P] * 8 + [I] * 4 + [P] * 9})
GANG_FASTPATH = CudaKernel(
    "gang_fastpath", _CSRC + "gang_fastpath.cu",
    "src/repro/kernels/ops.py:787",
    {"gang_fastpath_route": [I, P, P, P, P, I, P, I, I, I, P, P, P, P, P],
     "gang_fastpath_window": [I] + [P] * 7 + [I] + [P] * 3 + [I] + [P] * 5})
GANG_GC = CudaKernel(
    "gang_gc", _CSRC + "gang_gc.cu",
    "src/repro/kernels/witness_record.py:943",
    {"gang_gc_launch": [I] + [P] * 6 + [I, P, I, I] + [P] * 9})
GANG_GROUPS = CudaKernel(
    "gang_record_groups", _CSRC + "gang_groups.cu",
    "src/repro/kernels/witness_record.py:846",
    {"gang_groups_launch": [I, I] + [P] * 9 + [I] * 3 + [P] * 11})

KERNELS = (GANG_RECORD, GANG_FASTPATH, GANG_GC, GANG_GROUPS)


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Launchers: same signatures as the plain versions in ref.py
# ---------------------------------------------------------------------------
_MATRIX: Dict[torch.device, torch.Tensor] = {}


def _matrix(device: torch.device) -> torch.Tensor:
    m = _MATRIX.get(device)
    if m is None:
        m = _MATRIX[device] = torch.as_tensor(ref.conflict_matrix_np(),
                                              device=device)
    return m


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_cuda(device: torch.device, *tensors) -> None:
    """What the kernels take: contiguous int32 tensors on one CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"CUDA launcher called on {device}")
    for t in tensors:
        if t is None:
            continue
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"kernel operand must be a contiguous int32 tensor on "
                f"{device}, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def _record_runs(table: GangTable, n_sets: int, rows, rep: int, qh, ql,
                 r_hi, r_lo, cls, counters) -> torch.Tensor:
    """K2's record stage over ``rows`` (one per query copy; copy e reads
    op e // rep).  Returns reasons per copy."""
    dev = rows.device
    R, W = table.occ.shape
    rows_sorted, perm = torch.sort(rows, stable=True)
    N = rows.shape[0]
    reasons = torch.zeros(N, dtype=torch.int32, device=dev)
    m = _matrix(dev)
    GANG_RECORD.call(
        "gang_record_runs", N, rep, _ptr(rows_sorted), _ptr(perm), _ptr(qh),
        _ptr(ql), _ptr(r_hi), _ptr(r_lo), _ptr(cls), _ptr(m), m.numel(), R,
        n_sets, W, *(_ptr(p) for p in table), _ptr(reasons), _ptr(counters),
        _stream(dev))
    GANG_RECORD.launches += 1
    return reasons


def gang_record_cuda(table: GangTable, n_sets: int, k_hi, k_lo, k_cls,
                     k_valid, lanes, r_hi, r_lo, counters=None):
    """K2 on the card; see ``ref.gang_record_plain`` for the contract."""
    dev = k_hi.device
    _check_cuda(dev, *table, k_hi, k_lo, k_cls, k_valid, lanes, r_hi, r_lo,
                counters)
    B = k_hi.shape[0]
    qh = torch.empty_like(k_hi)
    ql = torch.empty_like(k_hi)
    rows = torch.empty_like(k_hi)
    GANG_RECORD.call("gang_record_prep", B, _ptr(k_hi), _ptr(k_lo),
                     _ptr(lanes), _ptr(k_valid), n_sets, table.occ.shape[0],
                     _ptr(qh), _ptr(ql), _ptr(rows), _stream(dev))
    rsn = _record_runs(table, n_sets, rows, 1, qh, ql, r_hi, r_lo, k_cls,
                       counters)
    return rsn, qh, ql


def gang_groups_cuda(table: GangTable, n_sets: int, k_hi, k_lo, k_valid,
                     k_cls, lanes, r_hi, r_lo, g_valid, counters=None):
    """K5 on the card; see ``ref.gang_groups_plain`` for the contract."""
    dev = k_hi.device
    _check_cuda(dev, *table, k_hi, k_lo, k_valid, k_cls, lanes, r_hi, r_lo,
                g_valid, counters)
    G, K = k_hi.shape
    if K > 1024:
        raise ValueError(f"gang_record_groups takes at most 1024 keys per "
                         f"group, got {K}")
    reasons = torch.zeros(G, dtype=torch.int32, device=dev)
    qh = torch.empty_like(k_hi)
    ql = torch.empty_like(k_hi)
    m = _matrix(dev)
    GANG_GROUPS.call(
        "gang_groups_launch", G, K, _ptr(k_hi), _ptr(k_lo), _ptr(k_valid),
        _ptr(k_cls), _ptr(lanes), _ptr(r_hi), _ptr(r_lo), _ptr(g_valid),
        _ptr(m), m.numel(), n_sets, table.occ.shape[1],
        *(_ptr(p) for p in table), _ptr(reasons), _ptr(qh), _ptr(ql),
        _ptr(counters), _stream(dev))
    GANG_GROUPS.launches += 1
    return reasons, qh, ql


def gang_gc_cuda(table: GangTable, n_sets: int, g_hi, g_lo, g_rh, g_rl,
                 g_lane, g_valid, aged_idx, do_age: bool):
    """K4 on the card; see ``ref.gang_gc_plain`` for the contract."""
    dev = g_hi.device
    _check_cuda(dev, *table, g_hi, g_lo, g_rh, g_rl, g_lane, g_valid,
                aged_idx)
    W = table.occ.shape[1]
    if W > 32:
        raise ValueError(f"gang_gc takes at most 32 ways, got {W}")
    G = g_hi.shape[0]
    cleared = torch.empty(G, dtype=torch.int32, device=dev)
    way_mask = torch.empty(G, dtype=torch.int32, device=dev)
    n_aged = aged_idx.shape[0] if do_age else 0
    GANG_GC.call(
        "gang_gc_launch", G, _ptr(g_hi), _ptr(g_lo), _ptr(g_rh), _ptr(g_rl),
        _ptr(g_lane), _ptr(g_valid), n_aged, _ptr(aged_idx), n_sets, W,
        *(_ptr(p) for p in table), _ptr(cleared), _ptr(way_mask),
        _stream(dev))
    GANG_GC.launches += 1
    return cleared


def gang_fastpath_cuda(table: GangTable, n_sets: int, f: int,
                       k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, exec_pred,
                       slot_map, lane_map, ring_hi, ring_lo, ring_cls,
                       tail, count, counters=None):
    """K3 (then K2's record stage) on the card; see
    ``ref.gang_fastpath_plain`` for the contract."""
    dev = k_hi.device
    _check_cuda(dev, *table, k_hi, k_lo, k_cls, k_valid, r_hi, r_lo,
                exec_pred, slot_map, lane_map, ring_hi, ring_lo, ring_cls,
                tail, count, counters)
    B = k_hi.shape[0]
    R = table.occ.shape[0]
    NS, CAP = ring_hi.shape
    qh = torch.empty_like(k_hi)
    ql = torch.empty_like(k_hi)
    shard = torch.empty_like(k_hi)
    rows_e = torch.empty(B * f, dtype=torch.int32, device=dev)
    conflicts = torch.empty_like(k_hi)
    new_count = count.clone()
    m = _matrix(dev)
    st = _stream(dev)
    GANG_FASTPATH.call(
        "gang_fastpath_route", B, _ptr(k_hi), _ptr(k_lo), _ptr(k_valid),
        _ptr(slot_map), slot_map.shape[0], _ptr(lane_map), f, n_sets, R,
        _ptr(qh), _ptr(ql), _ptr(shard), _ptr(rows_e), st)
    GANG_FASTPATH.call(
        "gang_fastpath_window", B, _ptr(qh), _ptr(ql), _ptr(shard),
        _ptr(k_cls), _ptr(k_valid), _ptr(exec_pred), _ptr(m), m.numel(),
        _ptr(ring_hi), _ptr(ring_lo), _ptr(ring_cls), CAP, _ptr(tail),
        _ptr(count), _ptr(conflicts), _ptr(new_count), st)
    GANG_FASTPATH.launches += 1
    rsn = _record_runs(table, n_sets, rows_e, f, qh, ql, r_hi, r_lo, k_cls,
                       counters)
    return rsn, conflicts, shard, qh, ql, new_count


# ---------------------------------------------------------------------------
# Host-side prep shared by the public ops
# ---------------------------------------------------------------------------
def _bucket(n: int, lo: int = 16) -> int:
    """Next power of two >= n (>= lo), as the JAX package pads."""
    b = lo
    while b < n:
        b <<= 1
    return b


def _pad_valid(B: int, *arrays):
    """Pad 1-D arrays to the bucket size; returns (padded..., valid)."""
    pad = _bucket(B) - B
    valid = np.ones((B + pad,), np.int32)
    valid[B:] = 0
    out = tuple(
        np.concatenate([np.asarray(a), np.zeros((pad,), np.asarray(a).dtype)])
        if pad else np.asarray(a)
        for a in arrays
    )
    return out + (valid,)


def _to_device(device: torch.device, *arrays):
    """Move 4-byte numpy arrays to ``device`` in ONE copy; returns int32
    tensors (same bits, same shapes), each a contiguous view of the one
    buffer."""
    flat = [np.ascontiguousarray(a).view(np.int32).reshape(-1) for a in arrays]
    buf = torch.from_numpy(np.concatenate(flat)).to(device)
    out, off = [], 0
    for a, fl in zip(arrays, flat):
        out.append(buf[off:off + fl.size].view(np.asarray(a).shape))
        off += fl.size
    return out


def _to_host(*tensors):
    """Bring int32 tensors to numpy in ONE copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].reshape(tuple(t.shape)))
        off += n
    return out


def _pick(device: torch.device, cuda_fn, plain_fn):
    if device.type == "cuda":
        return cuda_fn
    if device.type == "cpu":
        return plain_fn
    raise ValueError(f"gang ops run on CUDA or CPU tensors, not {device}")


def _n_lanes(table: GangTable, n_sets: int) -> int:
    return table.occ.shape[0] // n_sets


def _check_range(name: str, values: np.ndarray, hi: int) -> None:
    if values.size and (values.min() < 0 or values.max() >= hi):
        raise ValueError(f"{name} out of range [0, {hi}): "
                         f"{values.min()}..{values.max()}")


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------
class GangRecordResult(NamedTuple):
    """Result of one grouped gang record (all caller order)."""
    reasons: np.ndarray      # [G] reason code per group
    q_hi: np.ndarray         # [G, K] mixed lanes of every key (padding = 0)
    q_lo: np.ndarray         # [G, K]
    table: GangTable         # the gang table (updated in place)
    counters: Optional[torch.Tensor] = None  # [L, 5] reason counters, if fed


class GangFastPathResult(NamedTuple):
    """Result of one fused cluster-batch dispatch (all caller order)."""
    reasons: np.ndarray      # [B, f] reason code per op per witness copy
    conflicts: np.ndarray    # [B] device master-window conflict bit
    shard_ids: np.ndarray    # [B] slot-table placement
    q_hi: np.ndarray         # [B] mixed keyhash lanes
    q_lo: np.ndarray         # [B]
    table: GangTable         # the gang table (updated in place)
    ring_hi: torch.Tensor    # [NS, CAP] unsynced-window rings (in place)
    ring_lo: torch.Tensor    # [NS, CAP]
    counts: np.ndarray       # [NS] post-append live-entry count per ring
    ring_cls: torch.Tensor   # [NS, CAP] merge-lattice class per ring entry
    counters: Optional[torch.Tensor] = None  # [L, 5] reason counters, if fed


def record_operands(table: GangTable, n_sets: int, key_hi, key_lo, lanes,
                    rpc_hi, rpc_lo, key_cls=None):
    """Host inputs of ``gang_record`` -> the padded device operands that
    ``gang_record_cuda`` and ``ref.gang_record_plain`` take after
    (table, n_sets): k_hi, k_lo, k_cls, k_valid, lanes, r_hi, r_lo."""
    key_hi = np.asarray(key_hi, np.uint32)
    (B,) = key_hi.shape
    key_cls = (np.zeros((B,), np.int32) if key_cls is None
               else np.asarray(key_cls, np.int32))
    lanes = np.asarray(lanes, np.int32)
    _check_range("lanes", lanes, _n_lanes(table, n_sets))
    key_hi, key_lo, key_cls, lanes, rpc_hi, rpc_lo, valid = _pad_valid(
        B, key_hi, np.asarray(key_lo, np.uint32), key_cls, lanes,
        np.asarray(rpc_hi, np.uint32), np.asarray(rpc_lo, np.uint32),
    )
    return _to_device(table.occ.device, key_hi, key_lo, key_cls, valid,
                      lanes, rpc_hi, rpc_lo)


def gang_record(table: GangTable, n_sets: int, key_hi, key_lo, lanes,
                rpc_hi, rpc_lo, key_cls=None, *, counters=None):
    """Set-parallel single-key record over the gang: ONE dispatch for a
    batch of [B] single-key ops (each with its own lane and rpc identity).
    ``key_cls`` is the optional [B] merge-lattice class (default SET).

    Returns (reasons [B], q_hi [B], q_lo [B], table) as numpy outputs in
    caller order; with the optional ``counters`` plane ([L, 5] int32, one
    count per op at its lane, added in the same launch) the tuple grows a
    fifth element, the plane itself."""
    _count_dispatch()
    B = np.asarray(key_hi).shape[0]
    operands = record_operands(table, n_sets, key_hi, key_lo, lanes, rpc_hi,
                               rpc_lo, key_cls)
    fn = _pick(table.occ.device, gang_record_cuda, ref.gang_record_plain)
    rsn, qh, ql = _to_host(*fn(table, n_sets, *operands, counters))
    out = (rsn[:B], qh.view(np.uint32)[:B], ql.view(np.uint32)[:B], table)
    return out + (counters,) if counters is not None else out


def groups_operands(table: GangTable, n_sets: int, key_hi, key_lo,
                    key_valid, lanes, rpc_hi, rpc_lo, key_cls=None):
    """Host inputs of ``gang_record_groups`` -> the padded device operands
    of ``gang_groups_cuda`` / ``ref.gang_groups_plain``: k_hi, k_lo,
    k_valid, k_cls ([Gp, Kp]), lanes, r_hi, r_lo, g_valid ([Gp])."""
    key_hi = np.asarray(key_hi, np.uint32)
    G, K = key_hi.shape
    key_cls = (np.zeros((G, K), np.int32) if key_cls is None
               else np.asarray(key_cls, np.int32))
    lanes = np.asarray(lanes, np.int32)
    _check_range("lanes", lanes, _n_lanes(table, n_sets))
    Gp, Kp = _bucket(G, lo=4), _bucket(K, lo=2)
    pad2 = ((0, Gp - G), (0, Kp - K))
    g_valid = np.zeros((Gp,), np.int32)
    g_valid[:G] = 1
    return _to_device(
        table.occ.device, np.pad(key_hi, pad2),
        np.pad(np.asarray(key_lo, np.uint32), pad2),
        np.pad(np.asarray(key_valid, np.int32), pad2), np.pad(key_cls, pad2),
        np.pad(lanes, (0, Gp - G)),
        np.pad(np.asarray(rpc_hi, np.uint32), (0, Gp - G)),
        np.pad(np.asarray(rpc_lo, np.uint32), (0, Gp - G)), g_valid)


def gang_record_groups(table: GangTable, n_sets: int, key_hi, key_lo,
                       key_valid, lanes, rpc_hi, rpc_lo, key_cls=None,
                       *, counters=None) -> GangRecordResult:
    """Batched per-group all-or-nothing record: ONE dispatch for a whole
    batch of (possibly multi-key) ops.

    ``key_hi``/``key_lo``/``key_valid`` are [G, K] RAW keyhash lanes padded
    to a common key count; ``key_cls`` is the optional [G, K] class per key
    (default SET); ``lanes``/``rpc_hi``/``rpc_lo`` are [G].  Groups resolve
    in index order with the Python witness's placement semantics.  With
    ``counters``, one count per group is added at its lane in the same
    launch."""
    _count_dispatch()
    G, K = np.asarray(key_hi).shape
    operands = groups_operands(table, n_sets, key_hi, key_lo, key_valid,
                               lanes, rpc_hi, rpc_lo, key_cls)
    fn = _pick(table.occ.device, gang_groups_cuda, ref.gang_groups_plain)
    rsn, qh, ql = _to_host(*fn(table, n_sets, *operands, counters))
    return GangRecordResult(rsn[:G], qh.view(np.uint32)[:G, :K],
                            ql.view(np.uint32)[:G, :K], table, counters)


def gc_operands(table: GangTable, n_sets: int, g_hi, g_lo, g_rpc_hi,
                g_rpc_lo, g_lane, aged_lanes):
    """Host inputs of ``gang_gc`` -> the padded device operands of
    ``gang_gc_cuda`` / ``ref.gang_gc_plain``: g_hi, g_lo, g_rh, g_rl,
    g_lane, g_valid, aged_idx (the ids of the lanes to age)."""
    g_hi = np.asarray(g_hi, np.uint32)
    (G,) = g_hi.shape
    L = _n_lanes(table, n_sets)
    g_lane = np.asarray(g_lane, np.int32)
    _check_range("g_lane", g_lane, L)
    aged = np.asarray(aged_lanes, np.int32)
    if aged.shape != (L,):
        raise ValueError(f"aged_lanes must be an [{L}] mask, got {aged.shape}")
    g_hi, g_lo, g_rh, g_rl, g_lane, valid = _pad_valid(
        G, g_hi, np.asarray(g_lo, np.uint32),
        np.asarray(g_rpc_hi, np.uint32), np.asarray(g_rpc_lo, np.uint32),
        g_lane,
    )
    return _to_device(table.occ.device, g_hi, g_lo, g_rh, g_rl, g_lane,
                      valid, np.flatnonzero(aged == 1).astype(np.int32))


def gang_gc(table: GangTable, n_sets: int, g_hi, g_lo, g_rpc_hi, g_rpc_lo,
            g_lane, aged_lanes, *, do_age: bool = True):
    """Gang gc, ONE dispatch: rpc-matched clears plus in-kernel aging.

    Entry lanes are MIXED key lanes (as the record ops return them) plus
    the recording rpc identity and target lane; a slot clears only on a
    full (key, rpc, lane) match, so a stale entry never drops a newer
    same-key record.  ``aged_lanes`` is an [L] 0/1 mask of lanes whose
    survivors age this round; ``do_age=False`` is the rollback variant.
    Returns (cleared [G] numpy bit per entry, table)."""
    _count_dispatch()
    G = np.asarray(g_hi).shape[0]
    operands = gc_operands(table, n_sets, g_hi, g_lo, g_rpc_hi, g_rpc_lo,
                           g_lane, aged_lanes)
    fn = _pick(table.occ.device, gang_gc_cuda, ref.gang_gc_plain)
    (clr,) = _to_host(fn(table, n_sets, *operands, do_age))
    return clr[:G], table


def fastpath_operands(table: GangTable, n_sets: int, key_hi, key_lo,
                      rpc_hi, rpc_lo, exec_pred, slot_map, lane_map,
                      tail_slot, count, key_cls=None):
    """Host inputs of ``gang_fastpath_batch`` -> the padded device operands
    of ``gang_fastpath_cuda`` / ``ref.gang_fastpath_plain`` that come from
    the host: k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, exec_pred, slot_map,
    lane_map, tail, count (the rings are already on the device)."""
    slot_map = np.asarray(slot_map, np.int32)
    lane_map = np.asarray(lane_map, np.int32)
    NS, _f = lane_map.shape
    key_hi = np.asarray(key_hi, np.uint32)
    (B,) = key_hi.shape
    _check_range("slot_map", slot_map, NS)
    _check_range("lane_map", lane_map, _n_lanes(table, n_sets))
    key_cls = (np.zeros((B,), np.int32) if key_cls is None
               else np.asarray(key_cls, np.int32))
    key_hi, key_lo, key_cls, rpc_hi, rpc_lo, exec_pred, valid = _pad_valid(
        B, key_hi, np.asarray(key_lo, np.uint32), key_cls,
        np.asarray(rpc_hi, np.uint32), np.asarray(rpc_lo, np.uint32),
        np.asarray(exec_pred, np.int32),
    )
    return _to_device(table.occ.device, key_hi, key_lo, key_cls, valid,
                      rpc_hi, rpc_lo, exec_pred, slot_map, lane_map,
                      np.asarray(tail_slot, np.int32),
                      np.asarray(count, np.int32))


def gang_fastpath_batch(table: GangTable, n_sets: int, key_hi, key_lo,
                        rpc_hi, rpc_lo, exec_pred, slot_map, lane_map,
                        ring_hi, ring_lo, tail_slot, count,
                        *, key_cls=None, ring_cls=None,
                        counters=None) -> GangFastPathResult:
    """The whole cluster-batch hot loop in ONE dispatch:

        hash -> slot route -> ring conflict scan (device-resident master
        window, incl. in-batch growth) -> ring append -> record at every
        target shard's f witness lanes (rpc and age held in the table)

    ``lane_map`` is [NS, f] (gang lane of witness j of shard s);
    ``ring_hi``/``ring_lo`` are the [NS, CAP] per-shard unsynced-keyhash
    rings with ``tail_slot``/``count`` the live span (count + appends must
    fit CAP: callers drain first, and a batch that overflows raises).
    ``exec_pred[b] = 1`` marks ops that will execute at their master.
    ``key_cls`` ([B]) and ``ring_cls`` ([NS, CAP]) carry the merge-lattice
    classes (default SET).  Reasons and conflicts come back per op as
    numpy; rings and table stay on the device, updated in place."""
    NS, f = np.asarray(lane_map).shape
    _count_dispatch()
    B = np.asarray(key_hi).shape[0]
    if ring_hi.shape[0] != NS:
        raise ValueError(f"{ring_hi.shape[0]} rings for {NS} shards")
    dev = table.occ.device
    if ring_cls is None:
        ring_cls = torch.zeros(ring_hi.shape, dtype=torch.int32, device=dev)
    (k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, t_exec, t_slots, t_lanes,
     t_tail, t_count) = fastpath_operands(
        table, n_sets, key_hi, key_lo, rpc_hi, rpc_lo, exec_pred, slot_map,
        lane_map, tail_slot, count, key_cls)
    # Before the launch: the kernel appends in place beyond each live span,
    # which is safe only while count + appends fits CAP.
    slot_map = np.asarray(slot_map, np.int32)
    lo = ref.np_keyhash2x32(key_hi, key_lo)[1]
    shards = slot_map[lo % np.uint32(slot_map.shape[0])]
    appends = np.bincount(shards[np.asarray(exec_pred) == 1], minlength=NS)
    if (np.asarray(count, np.int64) + appends).max(initial=0) \
            > ring_hi.shape[1]:
        raise ValueError("ring overflow: count + appends exceeds CAP "
                         "(the caller must drain first)")
    fn = _pick(dev, gang_fastpath_cuda, ref.gang_fastpath_plain)
    rsn, con, shard, qh, ql, new_count = _to_host(*fn(
        table, n_sets, f, k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, t_exec,
        t_slots, t_lanes, ring_hi, ring_lo, ring_cls, t_tail, t_count,
        counters))
    return GangFastPathResult(
        rsn.reshape(-1, f)[:B], con[:B], shard[:B],
        qh.view(np.uint32)[:B], ql.view(np.uint32)[:B], table,
        ring_hi, ring_lo, new_count, ring_cls, counters,
    )


__all__ = [
    "GangTable", "GangRecordResult", "GangFastPathResult", "N_REASON_CODES",
    "gang_record", "gang_record_groups", "gang_gc", "gang_fastpath_batch",
    "dispatch_count", "reset_dispatch_count", "launch_counts",
    "reset_launch_counts", "KERNELS", "CudaKernel",
]
