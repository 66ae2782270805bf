"""The port's gang kernels, held against the JAX package's oracles (CPU).

On CPU tensors every public op of ``repro_torch.kernels`` runs the plain
PyTorch version of its CUDA kernel; these tests feed it the same seeded
numpy inputs as ``repro.kernels.ref``'s oracles (never ``repro.kernels.ops``,
whose Pallas bodies need a Pallas with ``pl.load``) and require exact
integer equality of every reason, mixed lane and table plane.  Shapes: 4
lanes x 64 sets x 4 ways; K2's corners (``parity.gang_record_corners``)
add 1 and 64 ways, 2 x 16 sets, one row of 300 queries, DUP and CONFLICT
in both orders, padding only, and K3's record stage of 100 ops x 3.
"""
import numpy as np
import pytest
import torch

from repro.kernels.ref import GangTable as JaxGangTable
from repro.kernels.ref import np_keyhash2x32 as jax_np_keyhash2x32
from repro.kernels.ref import ref_gang_gc, ref_gang_record
from repro_torch.kernels import (
    GangTable,
    gang_fastpath_batch,
    gang_from_numpy,
    gang_gc,
    gang_record,
    gang_record_groups,
    gang_to_numpy,
    np_keyhash2x32,
    ring_from_numpy,
    ring_to_numpy,
)
from repro_torch.kernels import ops, parity, ref
from repro_torch.kernels.ops import gc_operands
from repro_torch.kernels.ref import keyhash2x32

L, S, W = 4, 64, 4
N_RPCS = 24
SEEDS = [0, 1, 2]


def _state(seed):
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 4 * S, S)
    planes = parity.gang_planes(rng, pool, L, S, W, N_RPCS, fill=0.55)
    return rng, pool, planes


def _planes_equal(port: GangTable, oracle) -> None:
    for name, a, b in zip(("keys_hi", "keys_lo", "occ", "rpc_hi", "rpc_lo",
                           "age"), gang_to_numpy(port), oracle):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def _counts(lanes, reasons, n_lanes=L):
    out = np.zeros((n_lanes, 5), np.int64)
    np.add.at(out, (np.asarray(lanes), np.asarray(reasons)), 1)
    return out


# ---------------------------------------------------------------------------
# K1 mix (inlined in every gang kernel)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 33, 4096])
def test_keyhash_matches_numpy_with_sign_bits(n):
    rng = np.random.default_rng(n)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hi[::2] |= np.uint32(0x80000000)
    lo[::3] |= np.uint32(0xF0000001)
    jh, jl = jax_np_keyhash2x32(hi, lo)
    ph, pl_ = np_keyhash2x32(hi, lo)
    th, tl = keyhash2x32(torch.from_numpy(hi.view(np.int32)),
                         torch.from_numpy(lo.view(np.int32)))
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pl_, jl)
    np.testing.assert_array_equal(th.numpy().view(np.uint32), jh)
    np.testing.assert_array_equal(tl.numpy().view(np.uint32), jl)


def test_gang_state_round_trips_between_packages():
    _rng, _pool, planes = _state(0)
    port = gang_from_numpy(planes, device="cpu")
    assert all(p.dtype == torch.int32 for p in port)
    _planes_equal(port, planes)
    ring = [np.array([[0xF0000001, 3]], np.uint32),
            np.array([[1, 0x80000000]], np.uint32),
            np.array([[2, 8]], np.int32)]
    rings = ring_from_numpy(*ring, device="cpu")
    for a, b in zip(ring_to_numpy(*rings), ring):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# K2: set-parallel single-key record
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_gang_record_matches_ref_in_batch_order(seed):
    rng, pool, planes = _state(seed)
    q = parity.record_batch(rng, pool, 96, L, S, N_RPCS, flood=9)
    table = gang_from_numpy(planes, device="cpu")
    counters = torch.zeros((L, 5), dtype=torch.int32)
    rsn, qh, ql, table, counters = gang_record(
        table, S, q["key_hi"], q["key_lo"], q["lanes"], q["rpc_hi"],
        q["rpc_lo"], q["key_cls"], counters=counters)
    mh, ml = jax_np_keyhash2x32(q["key_hi"], q["key_lo"])
    groups = [(int(q["lanes"][i]), (int(q["rpc_hi"][i]), int(q["rpc_lo"][i])),
               [(int(mh[i]), int(ml[i]), int(q["key_cls"][i]))])
              for i in range(len(mh))]
    want, want_table = ref_gang_record(JaxGangTable(*planes), S, groups)
    np.testing.assert_array_equal(rsn, want)
    np.testing.assert_array_equal(qh, mh)
    np.testing.assert_array_equal(ql, ml)
    _planes_equal(table, want_table)
    np.testing.assert_array_equal(counters.numpy(), _counts(q["lanes"], want))
    assert all(parity.reason_coverage(rsn)[1:] > 0), "every reason reached"


# The corners of the row-owning kernel at a batch of REC_CORNER_B (the card
# runs them at 1024, where the one-row batch of 3 x B is taken in chunks).
REC_CORNER_B = 100


def _record_corner(seed, corner):
    """One ``parity.gang_record_corners`` case through the plain version on
    the operands the kernel takes (the op's padded batch, or K3's copies
    for ``rep_f``), held against ``ref_gang_record`` with one group per
    recorded copy.  Returns the reasons per copy."""
    c = parity.gang_record_corners(np.random.default_rng(seed),
                                   REC_CORNER_B, 3)[corner]
    planes, n_sets, rec = c["planes"], c["n_sets"], c["rec"]
    table = gang_from_numpy(planes, device="cpu")
    n_lanes = table.occ.shape[0] // n_sets
    counters = (torch.zeros((n_lanes, 5), dtype=torch.int32)
                if c["counters"] else None)
    if "valid" in rec:               # K3's stage: every op at f lanes
        args = parity.copies_operands(table, n_sets, **rec)
        rsn = ref.record_copies_plain(table, n_sets, *args, counters)
        f = args[1]
        lanes = rec["lanes"].reshape(-1)
        keep = np.repeat(rec["valid"] == 1, f)
        qh, ql, rh, rl, cls = (np.asarray(a.numpy()).view(np.uint32)
                               for a in args[2:])
    else:
        args = ops.record_operands(table, n_sets, **rec)
        rsn, qh, ql = ref.gang_record_plain(table, n_sets, *args, counters)
        k_hi, k_lo, _cls, valid, lanes, _rh, _rl = (
            a.numpy().view(np.uint32) for a in args)
        # The mixed lanes of every op, padding included.
        mh, ml = jax_np_keyhash2x32(k_hi, k_lo)
        np.testing.assert_array_equal(qh.numpy().view(np.uint32), mh)
        np.testing.assert_array_equal(ql.numpy().view(np.uint32), ml)
        f, keep = 1, valid == 1
        qh, ql, cls, rh, rl = mh, ml, _cls, _rh, _rl
    groups = [(int(lanes[e]), (int(rh[e // f]), int(rl[e // f])),
               [(int(qh[e // f]), int(ql[e // f]), int(cls[e // f]))])
              for e in np.flatnonzero(keep)]
    want, want_table = ref_gang_record(JaxGangTable(*planes), n_sets, groups)
    want = np.asarray(want, np.int64)
    expected = np.zeros(keep.size, np.int64)
    expected[keep] = want
    np.testing.assert_array_equal(rsn.numpy(), expected)
    _planes_equal(table, want_table)
    if counters is not None:
        np.testing.assert_array_equal(
            counters.numpy(), _counts(lanes[keep], want, n_lanes))
    return rsn.numpy()


@pytest.mark.parametrize("corner", range(len(parity.GANG_RECORD_CORNERS)),
                         ids=list(parity.GANG_RECORD_CORNERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_gang_record_corner_matches_ref(seed, corner):
    rsn = _record_corner(seed, corner)
    if parity.GANG_RECORD_CORNERS[corner] == "padding_only":
        assert not rsn.any()
    else:
        assert len(set(rsn[rsn > 0])) > 1


@pytest.mark.parametrize("seed", SEEDS)
def test_gang_record_corners_have_their_shape(seed):
    names = parity.GANG_RECORD_CORNERS
    cases = dict(zip(names, parity.gang_record_corners(
        np.random.default_rng(seed), REC_CORNER_B, 3)))
    geometry = {n: (c["planes"][2].shape[0] // c["n_sets"], c["n_sets"],
                    c["planes"][2].shape[1]) for n, c in cases.items()}
    assert geometry.pop("1_way") == (4, 64, 1)
    assert geometry.pop("64_ways") == (2, 16, 64)
    assert geometry.pop("few_rows") == (2, 16, 4)   # 32 rows, < 128 blocks
    assert set(geometry.values()) == {(4, 64, 4)}
    one = cases["one_row_chunks"]["rec"]
    ql = jax_np_keyhash2x32(one["key_hi"], one["key_lo"])[1]
    assert len(ql) == 3 * REC_CORNER_B and len(set(ql % 64)) == 1
    assert set(one["lanes"]) == {1}
    assert len(cases["padding_only"]["rec"]["key_hi"]) == 0
    assert [c["counters"] for c in cases.values()].count(False) == 1
    assert not cases["no_counters"]["counters"]
    rep = cases["rep_f"]["rec"]
    assert rep["lanes"].shape == (REC_CORNER_B, 3)
    assert 0 < (rep["valid"] == 0).sum() < REC_CORNER_B
    # Held INCR twice (either way order): DUP, DUP, CONFLICT (a SET),
    # INSERT (an INCR stacks); a fresh key: INSERT, DUP, CONFLICT, then
    # INSERT, CONFLICT, DUP.
    np.testing.assert_array_equal(
        _record_corner(seed, names.index("dup_conflict_orders"))[:14],
        [2, 2, 3, 1, 1, 2, 3, 2, 2, 3, 1, 1, 3, 2])
    assert 4 in _record_corner(seed, names.index("full_row"))


# ---------------------------------------------------------------------------
# K5: grouped all-or-nothing record
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_gang_record_groups_matches_ref(seed):
    rng, pool, planes = _state(seed)
    g = parity.group_batch(rng, pool, 40, 4, L, N_RPCS)
    table = gang_from_numpy(planes, device="cpu")
    counters = torch.zeros((L, 5), dtype=torch.int32)
    res = gang_record_groups(table, S, g["key_hi"], g["key_lo"],
                             g["key_valid"], g["lanes"], g["rpc_hi"],
                             g["rpc_lo"], g["key_cls"], counters=counters)
    mh, ml = jax_np_keyhash2x32(g["key_hi"], g["key_lo"])
    groups = []
    for i in range(g["key_hi"].shape[0]):
        n = int(g["key_valid"][i].sum())
        groups.append((int(g["lanes"][i]),
                       (int(g["rpc_hi"][i]), int(g["rpc_lo"][i])),
                       [(int(mh[i, k]), int(ml[i, k]), int(g["key_cls"][i, k]))
                        for k in range(n)]))
    want, want_table = ref_gang_record(JaxGangTable(*planes), S, groups)
    np.testing.assert_array_equal(res.reasons, want)
    np.testing.assert_array_equal(res.q_hi, mh)
    np.testing.assert_array_equal(res.q_lo, ml)
    _planes_equal(res.table, want_table)
    np.testing.assert_array_equal(counters.numpy(), _counts(g["lanes"], want))
    assert all(parity.reason_coverage(res.reasons)[1:] > 0)


def _groups_corner(seed, corner, trim):
    """One ``parity.gang_groups_corners`` case through the plain version on
    the operands the kernel takes (the op's padded groups, or trimmed to
    the real groups and keys), held against ``ref_gang_record`` with one
    group per real group and its valid keys.  Returns (reasons of the real
    groups, coverage codes)."""
    c = parity.gang_groups_corners(np.random.default_rng(seed))[corner]
    planes, n_sets, grp = c["planes"], c["n_sets"], c["grp"]
    G, K = grp["key_hi"].shape
    table = gang_from_numpy(planes, device="cpu")
    counters = torch.zeros((L, 5), dtype=torch.int32)
    args = ops.groups_operands(table, n_sets, **grp)
    if trim:
        args = ([a[:G, :K].contiguous() for a in args[:4]]
                + [a[:G] for a in args[4:]])
    rsn, qh, ql = ref.gang_groups_plain(table, n_sets, *args, counters)
    codes = parity.groups_codes(table, n_sets, rsn, *args[:3], *args[4:7])
    mh, ml = jax_np_keyhash2x32(args[0].numpy().view(np.uint32),
                                args[1].numpy().view(np.uint32))
    np.testing.assert_array_equal(qh.numpy().view(np.uint32), mh)
    np.testing.assert_array_equal(ql.numpy().view(np.uint32), ml)
    groups = [(int(grp["lanes"][g]), (int(grp["rpc_hi"][g]),
                                      int(grp["rpc_lo"][g])),
               [(int(mh[g, k]), int(ml[g, k]), int(grp["key_cls"][g, k]))
                for k in np.flatnonzero(grp["key_valid"][g] == 1)])
              for g in range(G)]
    want, want_table = ref_gang_record(JaxGangTable(*planes), n_sets, groups)
    rsn = rsn.numpy()
    np.testing.assert_array_equal(rsn[:G], np.asarray(want, np.int64))
    assert not rsn[G:].any()                 # padding groups: reason 0
    _planes_equal(table, want_table)
    np.testing.assert_array_equal(
        counters.numpy(), _counts(grp["lanes"], np.asarray(want, np.int64)))
    return rsn[:G], codes


@pytest.mark.parametrize("trim", [False, True], ids=["padded", "as_given"])
@pytest.mark.parametrize("corner", range(len(parity.GANG_GROUPS_CORNERS)),
                         ids=list(parity.GANG_GROUPS_CORNERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_gang_record_groups_corner_matches_ref(seed, corner, trim):
    """K5's corners (``parity.gang_groups_corners``) through its plain
    version, as the op pads them and as given, against the JAX oracle;
    each corner reaches what it is there for."""
    rsn, codes = _groups_corner(seed, corner, trim)
    name = parity.GANG_GROUPS_CORNERS[corner]
    expect = {"one_key": lambda: rsn.shape == (1,) and rsn[0] > 0,
              "no_valid_key": lambda: rsn[1] == 1,
              "padding_only": lambda: rsn.size == 0,
              "full_row": lambda: rsn[0] == 4,
              "dup_two_classes": lambda: codes[parity.GROUP_SAME_WAY] >= 2,
              "dup_all_retries": lambda: (rsn[6:] == 2).sum() >= 3,
              "32_keys": lambda: codes[parity.GROUP_SAME_WAY] >= 1,
              "64_keys": lambda: codes[parity.GROUP_SAME_WAY] >= 1,
              "long_chain": lambda: all(codes[1:5] > 0)}[name]
    assert expect(), (name, rsn, codes)


def test_gang_record_groups_same_row_keys_take_distinct_ways():
    """Two keys of one group in one row reserve two ways, as the Python
    witness's placement loop does; a third key with no way left rejects
    the whole group as FULL and writes nothing."""
    rng, pool, _planes = _state(3)
    bucket = next(b for b in pool.by_set.values() if len(b) >= 7)
    empty = tuple(np.zeros((L * S, W), d) for d in
                  (np.uint32, np.uint32, np.int32, np.uint32, np.uint32,
                   np.int32))
    table = gang_from_numpy(empty, device="cpu")
    key_hi = np.zeros((2, 5), np.uint32)
    key_lo = np.zeros((2, 5), np.uint32)
    key_hi[0, :2], key_lo[0, :2] = pool.hi[bucket[:2]], pool.lo[bucket[:2]]
    key_hi[1, :5], key_lo[1, :5] = pool.hi[bucket[2:7]], pool.lo[bucket[2:7]]
    valid = np.array([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    res = gang_record_groups(table, S, key_hi, key_lo, valid,
                             np.array([2, 2]), np.array([1, 1]),
                             np.array([5, 6]))
    assert list(res.reasons) == [1, 4]
    row = 2 * S + int(res.q_lo[0, 0] & (S - 1))
    occ = gang_to_numpy(res.table)[2]
    assert list(occ[row]) == [1, 1, 0, 0]
    assert occ.sum() == 2


# ---------------------------------------------------------------------------
# K4: rpc-matched gc with aging
# ---------------------------------------------------------------------------
def _check_gang_gc(planes, e, do_age, n_lanes=L):
    """One gang gc through the port's op on the CPU against
    ``ref_gang_gc`` on the distinct entries (each repeat takes its first
    copy's bit: decisions are taken against the pre-gc table); returns the
    cleared bits."""
    table = gang_from_numpy(planes, device="cpu")
    clr, table = gang_gc(table, S, e["g_hi"], e["g_lo"], e["g_rpc_hi"],
                         e["g_rpc_lo"], e["g_lane"], e["aged_lanes"],
                         do_age=do_age)
    keys = np.stack([np.asarray(e["g_lane"]).astype(np.uint32), e["g_hi"],
                     e["g_lo"], e["g_rpc_hi"], e["g_rpc_lo"]])
    uniq, first, inverse = np.unique(keys, axis=1, return_index=True,
                                     return_inverse=True)
    entries = [(int(e["g_lane"][i]), (int(e["g_hi"][i]), int(e["g_lo"][i])),
                (int(e["g_rpc_hi"][i]), int(e["g_rpc_lo"][i])))
               for i in first]
    aged = list(np.flatnonzero(e["aged_lanes"])) if do_age else []
    want, want_table = ref_gang_gc(JaxGangTable(*planes), S, entries, aged)
    assert clr.shape == (len(e["g_hi"]),)
    np.testing.assert_array_equal(
        clr, np.asarray(want, np.int32)[inverse.reshape(-1)])
    _planes_equal(table, want_table)
    return clr


@pytest.mark.parametrize("do_age", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_gang_gc_matches_ref_with_dedup_entries(seed, do_age):
    rng, _pool, planes = _state(seed)
    e = parity.gc_batch(rng, planes, S, 80, N_RPCS)
    clr = _check_gang_gc(planes, e, do_age)
    assert 0 < int(clr.sum()) < len(clr), "clears and stale misses both"


# The corners of the row-owning kernel, on a gang of eight lanes (entries
# spread over eight lanes need them): the two big corners' 4096 entries
# are one aged block's whole tile at 64 sets (on the card, one block walks
# them all).
GC_LANES = 8


def _gc_corners(seed):
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 4 * S, S)
    planes = parity.gang_planes(rng, pool, GC_LANES, S, W, N_RPCS, fill=0.55)
    return parity.gc_corners(rng, planes, S, N_RPCS)


@pytest.mark.parametrize("corner", range(len(parity.GC_CORNERS)),
                         ids=list(parity.GC_CORNERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_gang_gc_corner_matches_ref(seed, corner):
    planes, e, do_age = _gc_corners(seed)[corner]
    clr = _check_gang_gc(planes, e, do_age)
    if parity.GC_CORNERS[corner] == "identical_entries":
        # The pre-gc rule: both copies of a held entry report 1.
        assert int(clr.sum()) % 2 == 0 and clr.sum() > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_gang_gc_corners_have_their_shape(seed):
    cases = dict(zip(parity.GC_CORNERS, _gc_corners(seed)))
    for name, (planes, e, do_age) in cases.items():
        assert planes[2].shape == (GC_LANES * S, W), name
        assert do_age == (name != "no_aging"), name
        lanes = np.asarray(e["g_lane"])
        aged = np.flatnonzero(e["aged_lanes"])
        if name == "identical_entries":
            keys = np.stack([lanes.astype(np.uint32), e["g_hi"], e["g_lo"],
                             e["g_rpc_hi"], e["g_rpc_lo"]])
            _, n = np.unique(keys, axis=1, return_counts=True)
            assert (n == 2).all()
        elif name == "one_row_all_ways":
            rows = lanes * S + (e["g_lo"] & np.uint32(S - 1))
            assert len(lanes) == W and np.unique(rows).size == 1
            assert np.unique(e["g_rpc_lo"]).size == W
            assert np.unique(np.stack([e["g_hi"], e["g_lo"]]),
                             axis=1).shape[1] == 1
            assert (planes[2][rows[0]] > 0).all() and lanes[0] in aged
        elif name == "non_aged_lanes":
            assert len(lanes) and aged.size
            assert not set(lanes.tolist()) & set(aged.tolist())
        elif name == "no_entries":
            assert len(lanes) == 0 and aged.size
        elif name.startswith("big"):
            keys = np.stack([lanes.astype(np.uint32), e["g_hi"], e["g_lo"],
                             e["g_rpc_hi"], e["g_rpc_lo"]])
            assert np.unique(keys, axis=1).shape[1] == 4096
            want = 1 if name == "big_one_lane" else 8
            assert np.unique(lanes).size == want, name
            assert set(lanes.tolist()) & set(aged.tolist())
            if want == 8:
                assert set(lanes.tolist()) - set(aged.tolist())


def test_gang_gc_identical_entries_both_report_cleared():
    """Decisions are taken against the pre-gc table (the Pallas cube), so a
    repeated entry reports 1 twice, where the sequential oracle reports the
    second as 0."""
    _rng, _pool, planes = _state(0)
    rows, ways = np.nonzero(planes[2] > 0)
    r, w = rows[0], ways[0]
    one = [planes[i][r, w] for i in (0, 1, 3, 4)]
    clr, table = gang_gc(gang_from_numpy(planes, device="cpu"), S,
                         [one[0]] * 2, [one[1]] * 2, [one[2]] * 2,
                         [one[3]] * 2, [r // S] * 2, np.zeros(L, np.int32))
    assert list(clr) == [1, 1]
    assert gang_to_numpy(table)[2][r, w] == 0


# ---------------------------------------------------------------------------
# K3: ring scan, in-batch check and append (then K2 at every witness lane)
# ---------------------------------------------------------------------------
def _np_ring_stage(fp, n_slots):
    """numpy transcription of ops.py:795-836 (_gang_fastpath_impl) of the
    JAX package, one op at a time."""
    qh, ql = jax_np_keyhash2x32(fp["key_hi"], fp["key_lo"])
    ring_hi, ring_lo = fp["ring_hi"].copy(), fp["ring_lo"].copy()
    ring_cls = fp["ring_cls"].copy()
    tail, count = fp["tail_slot"], fp["count"]
    NS, CAP = ring_hi.shape
    matrix = parity.ref.conflict_matrix_np()
    B = len(qh)
    shard = fp["slot_map"][ql % np.uint32(n_slots)]
    cls = fp["key_cls"]
    app = fp["exec_pred"] == 1
    conflicts = np.zeros(B, np.int32)
    new_count = count.astype(np.int64).copy()
    rank_of = np.zeros(NS, np.int64)
    writes = []
    for b in range(B):
        s = shard[b]
        mrow = int(matrix[cls[b]])
        hit = any((c - tail[s]) % CAP < count[s]
                  and ring_hi[s, c] == qh[b] and ring_lo[s, c] == ql[b]
                  and (mrow >> int(ring_cls[s, c])) & 1
                  for c in range(CAP))
        intra = any(app[j] and shard[j] == s and qh[j] == qh[b]
                    and ql[j] == ql[b] and (mrow >> int(cls[j])) & 1
                    for j in range(b))
        conflicts[b] = int(hit or intra)
        if app[b]:
            pos = (tail[s] + count[s] + rank_of[s]) % CAP
            writes.append((s, pos, qh[b], ql[b], cls[b]))
            rank_of[s] += 1
            new_count[s] += 1
    for s, pos, h, l_, c in writes:      # scan first, then append
        ring_hi[s, pos], ring_lo[s, pos], ring_cls[s, pos] = h, l_, c
    return conflicts, shard, qh, ql, new_count, ring_hi, ring_lo, ring_cls


def _check_gang_fastpath(planes, fp, n_slots, f):
    """One fused batch through the port's op on the CPU against the numpy
    loop of the JAX package's ring stage and ``ref_gang_record``; returns
    the op's result."""
    table = gang_from_numpy(planes, device="cpu")
    ring_hi, ring_lo, ring_cls = ring_from_numpy(fp["ring_hi"], fp["ring_lo"],
                                                 fp["ring_cls"], device="cpu")
    counters = torch.zeros((L, 5), dtype=torch.int32)
    res = gang_fastpath_batch(
        table, S, fp["key_hi"], fp["key_lo"], fp["rpc_hi"], fp["rpc_lo"],
        fp["exec_pred"], fp["slot_map"], fp["lane_map"], ring_hi, ring_lo,
        fp["tail_slot"], fp["count"], key_cls=fp["key_cls"],
        ring_cls=ring_cls, counters=counters)
    con, shard, qh, ql, new_count, rh, rl, rc = _np_ring_stage(fp, n_slots)
    np.testing.assert_array_equal(res.conflicts, con)
    np.testing.assert_array_equal(res.shard_ids, shard)
    np.testing.assert_array_equal(res.q_hi, qh)
    np.testing.assert_array_equal(res.q_lo, ql)
    np.testing.assert_array_equal(res.counts, new_count)
    for got, want in zip(ring_to_numpy(res.ring_hi, res.ring_lo,
                                       res.ring_cls), (rh, rl, rc)):
        np.testing.assert_array_equal(got, want)
    assert 0 < con.sum() < len(con)
    # The record stage: every op at its shard's f lanes, ops in batch order.
    lanes = fp["lane_map"][shard]                                 # [B, f]
    groups = [(int(lanes[b, j]),
               (int(fp["rpc_hi"][b]), int(fp["rpc_lo"][b])),
               [(int(qh[b]), int(ql[b]), int(fp["key_cls"][b]))])
              for b in range(len(qh)) for j in range(f)]
    want, want_table = ref_gang_record(JaxGangTable(*planes), S, groups)
    np.testing.assert_array_equal(res.reasons.reshape(-1), want)
    _planes_equal(res.table, want_table)
    np.testing.assert_array_equal(counters.numpy(),
                                  _counts(lanes.reshape(-1), want))
    return res


@pytest.mark.parametrize("seed", SEEDS)
def test_gang_fastpath_matches_numpy_loop_and_ref(seed):
    rng, pool, planes = _state(seed)
    NS, CAP, f, n_slots = 8, 64, 3, 32
    fp = parity.fastpath_batch(rng, pool, 48, NS, CAP, f, L, n_slots, N_RPCS)
    assert (fp["tail_slot"] + fp["count"] > CAP).any(), "a span wraps"
    _check_gang_fastpath(planes, fp, n_slots, f)


# The corners of the block-per-shard kernel: every op in one shard, shards
# with no op, rings filled to count + appends = CAP, hot keys of a class
# that commutes with itself (INCR) beside one that does not (SET), and a
# batch of 3 x CORNER_B in one shard of rings of 4 x CORNER_CAP (at the
# card's sizes, the one the kernel takes in chunks).
CORNER_NS, CORNER_CAP, CORNER_SLOTS, CORNER_B = 8, 128, 32, 100


def _corners(seed):
    rng, _pool, planes = _state(seed)
    return planes, parity.fastpath_corners(
        rng, CORNER_B, CORNER_NS, CORNER_CAP, 3, L, CORNER_SLOTS, N_RPCS)


@pytest.mark.parametrize("corner", [0, 1, 2, 3],
                         ids=["one_shard", "idle_shards", "full_rings",
                              "one_shard_big_batch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_gang_fastpath_corner_matches_numpy_loop_and_ref(seed, corner):
    planes, cases = _corners(seed)
    res = _check_gang_fastpath(planes, cases[corner], CORNER_SLOTS, 3)
    assert len(res.conflicts) == (3 if corner == 3 else 1) * CORNER_B


@pytest.mark.parametrize("seed", SEEDS)
def test_gang_fastpath_corners_have_their_shape(seed):
    _planes, (one, idle, full, big) = _corners(seed)

    def shards(fp):
        ql = jax_np_keyhash2x32(fp["key_hi"], fp["key_lo"])[1]
        return fp["slot_map"][ql % np.uint32(CORNER_SLOTS)]

    def appends(fp):
        return np.bincount(shards(fp)[fp["exec_pred"] == 1],
                           minlength=CORNER_NS)

    assert set(shards(one)) == set(shards(big)) == {CORNER_NS - 1}
    assert not set(shards(idle)) & set(range(1, CORNER_NS, 2))
    for fp, cap in ((idle, CORNER_CAP), (full, CORNER_CAP),
                    (big, 4 * CORNER_CAP)):
        assert fp["ring_hi"].shape == (CORNER_NS, cap)
        np.testing.assert_array_equal(fp["count"] + appends(fp), cap)
        assert (fp["tail_slot"] + fp["count"] > cap).any()
    assert len(big["key_hi"]) == 3 * CORNER_B
    # Hot keys: the INCRs on one key never conflict with each other, so
    # they share one verdict (their ring's); every SET after the first
    # conflicts with it.
    for fp in (one, full):
        con = _np_ring_stage(fp, CORNER_SLOTS)[0]
        hot = np.flatnonzero(fp["rpc_lo"] >= 4 * (N_RPCS + CORNER_B))
        incr = hot[fp["key_cls"][hot] == 2]
        sets = hot[fp["key_cls"][hot] == 0]
        assert incr.size and sets.size
        assert len(set(con[incr])) == 1
        assert (con[np.sort(sets)[1:]] == 1).all()


def test_gang_fastpath_overflow_raises():
    rng, pool, planes = _state(0)
    fp = parity.fastpath_batch(rng, pool, 16, 1, 8, 1, L, 4, N_RPCS)
    fp["count"][:] = 8
    fp["exec_pred"][:] = 1
    rings = ring_from_numpy(fp["ring_hi"], fp["ring_lo"], fp["ring_cls"],
                            device="cpu")
    table = gang_from_numpy(planes, device="cpu")
    with pytest.raises(ValueError, match="ring overflow"):
        gang_fastpath_batch(
            table, S, fp["key_hi"], fp["key_lo"],
            fp["rpc_hi"], fp["rpc_lo"], fp["exec_pred"], fp["slot_map"],
            fp["lane_map"], rings[0], rings[1], fp["tail_slot"], fp["count"],
            key_cls=fp["key_cls"], ring_cls=rings[2])
    # The check runs before the launch: rings and table are untouched.
    for got, want in zip(ring_to_numpy(*rings),
                         (fp["ring_hi"], fp["ring_lo"], fp["ring_cls"])):
        np.testing.assert_array_equal(got, want)
    _planes_equal(table, planes)


def test_out_of_range_lane_raises():
    table = GangTable.empty(S, W, L, device="cpu")
    with pytest.raises(ValueError, match="lanes out of range"):
        gang_record(table, S, [1], [2], [L], [0], [0])


@pytest.mark.parametrize("aged,match", [([1, 3, 1], "repeats a lane"),
                                        ([0, L], "out of range")],
                         ids=["repeated", "out_of_range"])
def test_gang_gc_cuda_refuses_bad_aged_lanes(aged, match):
    """K4 gives each aged tile one owning block and marks the aged lanes in
    a shared bitmap, so its wrapper checks ``aged_idx`` before it launches
    (here, before it refuses the CPU tensors)."""
    table = GangTable.empty(S, W, L, device="cpu")
    args = list(gc_operands(table, S, [1], [2], [3], [4], [0],
                            np.zeros(L, np.int32)))
    args[-1] = torch.tensor(aged, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        ops.gang_gc_cuda(table, S, *args, True)


@pytest.mark.parametrize("lane", [L, -1], ids=["past_the_end", "negative"])
def test_gang_gc_cuda_refuses_bad_g_lane(lane):
    """An entry's lane indexes K4's shared bitmap of aged lanes, so the
    wrapper checks ``g_lane`` before it launches (here, before it refuses
    the CPU tensors)."""
    table = GangTable.empty(S, W, L, device="cpu")
    args = list(gc_operands(table, S, [1], [2], [3], [4], [0],
                            np.zeros(L, np.int32)))
    args[4] = torch.full_like(args[4], lane)
    with pytest.raises(ValueError, match="g_lane out of range"):
        ops.gang_gc_cuda(table, S, *args, True)


def test_gang_gc_cuda_checks_the_host_lanes_it_is_given():
    """Given the host arrays the operands were copied from (as ``gang_gc``
    passes them), the wrapper checks those and copies nothing back: bad
    device lanes pass the check when the host lanes are good, and bad host
    lanes are refused whatever the device holds."""
    table = GangTable.empty(S, W, L, device="cpu")
    aged = np.zeros(L, np.int32)
    aged[[1, 3]] = 1
    host = ops.gc_host_operands(table, S, [1], [2], [3], [4], [0], aged)
    args = list(gc_operands(table, S, [1], [2], [3], [4], [0], aged))
    args[4] = torch.full_like(args[4], L)
    args[6] = torch.tensor([1, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA launcher"):
        ops.gang_gc_cuda(table, S, *args, True, g_lane_host=host[4],
                         aged_host=host[6])
    with pytest.raises(ValueError, match="aged_idx repeats a lane"):
        ops.gang_gc_cuda(table, S, *args, True, g_lane_host=host[4],
                         aged_host=np.array([3, 3], np.int32))
