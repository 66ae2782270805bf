"""The port's single-table ops, held against the JAX package (CPU).

On CPU tensors ``repro_torch.kernels`` runs the plain PyTorch versions of
K1 (``keyhash2x32``, ``shard_route``), K6 (``witness_record``), K7
(``fastpath_batch``) and K8 (``conflict_scan``).  K1, ``shard_route`` and K8
are held against ``repro.kernels.ops`` itself (their Pallas kernels trace
in interpret mode here); K6 and K7 against the ``repro.kernels.ref``
oracles (their Pallas bodies need a Pallas with ``pl.load``).  The same
seeded numpy inputs go to both sides; equality is exact.  Shapes: 64x4,
16x2 and 256x1 tables, batches of at most 512, windows of at most 128; K7's
corners add 1024x4, 128x8, 4x2 and 1x4 tables, empty windows, ones of 1024
and 1500, and batches of 800; K8's corners (``parity.scan_corners``) add an
empty window, repeated keys, the all-ones key, 384 entries, legacy 0/1
validity, classes outside the matrix and a batch of 1000.
"""
import statistics

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import WitnessTable as JaxWitnessTable
from repro.kernels.ref import (
    ref_conflict_scan,
    ref_keyhash2x32,
    ref_witness_record,
)
from repro_torch.core.shard import SlotRouter
from repro_torch.kernels import (
    WitnessTable,
    conflict_scan,
    default_slot_map,
    dispatch_count,
    fastpath_batch,
    keyhash2x32,
    ops,
    parity,
    ref,
    reset_dispatch_count,
    shard_route,
    witness_record,
    witness_table_from_numpy,
    witness_table_to_numpy,
)

SEEDS = [0, 1, 2]
GEOMETRIES = [(64, 4), (16, 2), (256, 1)]


def _case(seed, S, W):
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 4 * S, S)
    return rng, pool, parity.table_planes(rng, pool, S, W)


def _oracle_record(planes, q_hi, q_lo, q_cls):
    acc, table = ref_witness_record(
        JaxWitnessTable(*(jnp.asarray(p) for p in planes)),
        jnp.asarray(q_hi, jnp.uint32), jnp.asarray(q_lo, jnp.uint32),
        jnp.asarray(q_cls, jnp.int32))
    return np.asarray(acc), tuple(np.asarray(p) for p in table)


def _tables_equal(port: WitnessTable, oracle) -> None:
    for name, a, b in zip(ref.TABLE_PLANES, witness_table_to_numpy(port),
                          oracle):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def _lanes(rng, n):
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hi[::2] |= np.uint32(0x80000000)
    lo[::3] = np.uint32(0xF0000001)
    return hi, lo


# ---------------------------------------------------------------------------
# K6: witness_record
# ---------------------------------------------------------------------------
def _check_record(planes, q):
    """One witness_record through the port's op on the CPU against
    ``ref_witness_record``; returns the accept bits."""
    acc, table = witness_record(witness_table_from_numpy(planes, "cpu"),
                                q["q_hi"], q["q_lo"], q["q_cls"])
    want, want_table = _oracle_record(planes, q["q_hi"], q["q_lo"],
                                      q["q_cls"])
    assert acc.shape == (len(q["q_hi"]),)
    np.testing.assert_array_equal(acc, want)
    _tables_equal(table, want_table)
    return acc


@pytest.mark.parametrize("S,W", GEOMETRIES, ids=lambda v: str(v))
@pytest.mark.parametrize("seed", SEEDS)
def test_witness_record_matches_ref_with_classes(seed, S, W):
    rng, pool, planes = _case(seed, S, W)
    q = parity.table_batch(rng, pool, 512 if S > 16 else 200, W)
    acc = _check_record(planes, q)
    assert 0 < acc.sum() < len(acc)


# The corners of the set-owning kernel at a batch of RECORD_CORNER_B (the
# card runs them at 1024, where the one-set batch of 4 x B is taken in
# chunks).
RECORD_CORNER_B = 200


@pytest.mark.parametrize("corner", range(len(parity.TABLE_RECORD_CORNERS)),
                         ids=list(parity.TABLE_RECORD_CORNERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_witness_record_corner_matches_ref(seed, corner):
    rng = np.random.default_rng(seed)
    planes, q = parity.table_record_corners(rng, RECORD_CORNER_B)[corner]
    acc = _check_record(planes, q)
    if len(acc):
        assert 0 < acc.sum() < len(acc)


@pytest.mark.parametrize("seed", SEEDS)
def test_witness_record_corners_have_their_shape(seed):
    rng = np.random.default_rng(seed)
    cases = dict(zip(parity.TABLE_RECORD_CORNERS,
                     parity.table_record_corners(rng, RECORD_CORNER_B)))
    shapes = {"one_set_big_batch": (1024, 4, 4 * RECORD_CORNER_B),
              "1_way": (256, 1, RECORD_CORNER_B),
              "8_ways": (128, 8, RECORD_CORNER_B),
              "64_ways": (64, 64, RECORD_CORNER_B),
              "16_sets": (16, 4, RECORD_CORNER_B), "padding_only": (16, 4, 0)}
    for name, (planes, q) in cases.items():
        S, W, B = shapes[name]
        assert all(np.asarray(p).shape == (S, W) for p in planes), name
        assert len(q["q_hi"]) == len(q["q_lo"]) == len(q["q_cls"]) == B
        assert (np.asarray(planes[2]) > 0).any(), name
    q = cases["one_set_big_batch"][1]
    assert np.unique(q["q_lo"] & np.uint32(1023)).size == 1
    assert np.unique(q["q_cls"]).size > 1
    # The op pads the empty batch to a bucket of padding only.
    planes, q = cases["padding_only"]
    args = ops.table_record_operands(witness_table_from_numpy(planes, "cpu"),
                                     **q)
    assert args[0].shape == (16,) and int(args[3].sum()) == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_witness_record_inputs_reach_every_outcome(seed):
    """Insert, conflict under the matrix, a same-key record of a class that
    commutes (it inserts beside), and FULL."""
    rng, pool, planes = _case(seed, 64, 4)
    q = parity.table_batch(rng, pool, 512, 4)
    args = [torch.from_numpy(np.asarray(a).view(np.int32).copy())
            for a in (q["q_hi"], q["q_lo"], q["q_cls"])]
    out = ref.witness_outcomes_plain(witness_table_from_numpy(planes, "cpu"),
                                     *args, torch.ones(512, dtype=torch.int32))
    cov = parity.reason_coverage(out.numpy(), parity.N_CODES)
    assert all(cov[c] > 0 for c in parity.BRANCHES["witness_record"]), cov


def test_witness_record_stacks_commuting_classes_and_rejects_the_rest():
    """INCR over INCR stacks in the next free way; SET over INCR conflicts;
    a third INCR with no free way left is rejected as FULL."""
    table = WitnessTable.empty(4, 2, device="cpu")
    acc, table = witness_record(table, [7, 7, 7, 7], [1, 1, 1, 1],
                                [2, 2, 0, 2])
    assert list(acc) == [1, 1, 0, 0]
    occ = witness_table_to_numpy(table)[2]
    assert list(occ[1]) == [3, 3] and occ.sum() == 6


def test_witness_record_does_not_hash_and_pads_to_a_bucket():
    """The set is q_lo & (S-1) of the lanes given; a batch of 5 pads to 16
    lanes that never accept, and the outputs come back sliced to 5."""
    table = WitnessTable.empty(8, 1, device="cpu")
    acc, table = witness_record(table, np.arange(5),
                                [3, 11, 4, 12, 0xF0000001])
    assert acc.shape == (5,) and list(acc) == [1, 0, 1, 0, 1]
    occ = witness_table_to_numpy(table)[2][:, 0]
    assert list(np.flatnonzero(occ)) == [1, 3, 4]


# ---------------------------------------------------------------------------
# K7: fastpath_batch = hash -> route -> record -> window scan
# ---------------------------------------------------------------------------
def _check_fastpath(planes, fp):
    """One fastpath_batch through the port's op on the CPU against the JAX
    package's pipeline of oracles; returns the conflict bits."""
    res = fastpath_batch(witness_table_from_numpy(planes, "cpu"),
                         fp["key_hi"], fp["key_lo"], fp["key_cls"],
                         window_hi=fp["window_hi"], window_lo=fp["window_lo"],
                         window_valid=fp["window_valid"],
                         slot_map=fp["slot_map"])
    qh, ql = (np.asarray(x) for x in ref_keyhash2x32(
        jnp.asarray(fp["key_hi"]), jnp.asarray(fp["key_lo"])))
    shard = fp["slot_map"][ql % np.uint32(fp["slot_map"].size)]
    acc, table = _oracle_record(planes, qh, ql, fp["key_cls"])
    if len(fp["window_hi"]):
        con = np.asarray(ref_conflict_scan(
            jnp.asarray(fp["window_hi"]), jnp.asarray(fp["window_lo"]),
            jnp.asarray(fp["window_valid"]), jnp.asarray(qh),
            jnp.asarray(ql), jnp.asarray(fp["key_cls"])))
    else:
        con = np.zeros(len(qh), np.int32)
    np.testing.assert_array_equal(res.q_hi, qh)
    np.testing.assert_array_equal(res.q_lo, ql)
    np.testing.assert_array_equal(res.shard_ids, shard)
    np.testing.assert_array_equal(res.accepted, acc)
    np.testing.assert_array_equal(res.conflicts, con)
    _tables_equal(res.table, table)
    return con


@pytest.mark.parametrize("S,W", GEOMETRIES, ids=lambda v: str(v))
@pytest.mark.parametrize("seed", SEEDS)
def test_fastpath_batch_matches_ref_pipeline(seed, S, W):
    rng, pool, planes = _case(seed, S, W)
    fp = parity.table_fastpath_batch(rng, pool, 300, 128, W, n_shards=6)
    con = _check_fastpath(planes, fp)
    assert 0 < con.sum() < len(con)


@pytest.mark.parametrize("corner", [0, 1, 2, 3, 4, 5],
                         ids=["1024x4_empty_window", "256x1_dup_window",
                              "128x8_dup_window", "16x2_big_window",
                              "1x4_big_batch", "4x2_big_batch_big_window"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fastpath_batch_corner_matches_ref_pipeline(seed, corner):
    """The corners of the set-owning kernel: no window, a window with
    repeated keys of other classes, one larger than a shared-memory table
    (1024 entries), one way and eight, a batch the op pads, and batches of
    4 x B on tables of one and four sets (on the card, more queries than a
    block's list holds)."""
    rng = np.random.default_rng(seed)
    planes, fp = parity.table_fastpath_corners(rng, 200, 6, 1500)[corner]
    assert len(fp["key_hi"]) == (800 if corner >= 4 else 200)
    con = _check_fastpath(planes, fp)
    U = len(fp["window_hi"])
    assert (con.sum() == 0) if U == 0 else (0 < con.sum() < len(con))
    if U:
        keys = np.stack([fp["window_hi"], fp["window_lo"]], 1)
        assert np.unique(keys, axis=0).shape[0] < U, "repeated window keys"


def test_fastpath_batch_empty_window_and_default_route():
    rng = np.random.default_rng(4)
    hi, lo = _lanes(rng, 37)
    res = fastpath_batch(WitnessTable.empty(16, 2, device="cpu"), hi, lo,
                         n_shards=4)
    assert res.accepted.shape == res.conflicts.shape == (37,)
    assert res.conflicts.sum() == 0
    np.testing.assert_array_equal(
        res.shard_ids, np.asarray(jops.shard_route(hi, lo, n_shards=4)))
    with pytest.raises(ValueError, match="window_hi given without"):
        fastpath_batch(WitnessTable.empty(16, 2, device="cpu"), hi, lo,
                       window_hi=hi[:3])


# ---------------------------------------------------------------------------
# K1, shard_route and K8 against the JAX package's own ops (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 1000, 1025, 3001])
def test_keyhash2x32_matches_jax_op_with_sign_bits(n):
    hi, lo = _lanes(np.random.default_rng(n), n)
    got = keyhash2x32(hi, lo, device="cpu")
    want = jops.keyhash2x32(hi, lo)
    for a, b in zip(got, want):
        assert a.dtype == np.uint32 and a.shape == (n,)
        np.testing.assert_array_equal(a, np.asarray(b))
    # A CPU tensor of int32 bit patterns picks the CPU by itself.
    t = keyhash2x32(torch.from_numpy(hi.view(np.int32)),
                    torch.from_numpy(lo.view(np.int32)))
    np.testing.assert_array_equal(t[0], got[0])


@pytest.mark.parametrize("slot_map", ["default4", "default7", "random"])
def test_shard_route_matches_jax_op_and_slot_router(slot_map):
    rng = np.random.default_rng(11)
    hi, lo = _lanes(rng, 700)
    if slot_map == "random":
        sm = rng.integers(0, 5, 256).astype(np.int32)
        got = shard_route(hi, lo, slot_map=sm, device="cpu")
        want = jops.shard_route(hi, lo, slot_map=sm)
    else:
        n = int(slot_map[-1])
        sm = default_slot_map(n)
        got = shard_route(hi, lo, n, device="cpu")
        want = jops.shard_route(hi, lo, n)
    np.testing.assert_array_equal(got, np.asarray(want))
    router = SlotRouter(sm)
    host = [router.shard_of_hash((int(h) << 32) | int(l))
            for h, l in zip(hi, lo)]
    np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("B,U", [(1000, 777), (256, 512), (33, 1), (500, 128)])
@pytest.mark.parametrize("seed", SEEDS)
def test_conflict_scan_matches_jax_op_padded_or_not(seed, B, U):
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 256, 64)
    sc = parity.scan_batch(rng, pool, B, U)
    got = conflict_scan(sc["w_hi"], sc["w_lo"], sc["w_valid"], sc["q_hi"],
                        sc["q_lo"], sc["q_cls"], device="cpu")
    want = jops.conflict_scan(sc["w_hi"], sc["w_lo"], sc["w_valid"],
                              sc["q_hi"], sc["q_lo"], sc["q_cls"])
    assert got.shape == (B,)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_conflict_scan_legacy_valid_bits_mean_set():
    """A 0/1 window is class SET: it conflicts with every class, and an
    invalid entry never does."""
    rng = np.random.default_rng(5)
    pool = parity.key_pool(rng, 64, 16)
    sc = parity.scan_batch(rng, pool, 200, 64)
    legacy = (sc["w_valid"] > 0).astype(np.int32)
    got = conflict_scan(sc["w_hi"], sc["w_lo"], legacy, sc["q_hi"],
                        sc["q_lo"], sc["q_cls"], device="cpu")
    meets = ((sc["q_hi"][:, None] == sc["w_hi"][None])
             & (sc["q_lo"][:, None] == sc["w_lo"][None])
             & (legacy[None] == 1)).any(1)
    np.testing.assert_array_equal(got, meets.astype(np.int32))
    np.testing.assert_array_equal(
        got, np.asarray(jops.conflict_scan(sc["w_hi"], sc["w_lo"], legacy,
                                           sc["q_hi"], sc["q_lo"],
                                           sc["q_cls"])))


# The corners of the table join (K8) at SCAN_CORNER_B queries against
# SCAN_CORNER_U entries (the card runs them at 4096 x 1024, where the
# three_tiles window fills three shared-memory tables).
SCAN_CORNER_B, SCAN_CORNER_U = 300, 128
SCAN_ARGS = ("w_hi", "w_lo", "w_valid", "q_hi", "q_lo", "q_cls")


@pytest.mark.parametrize("corner", range(len(parity.SCAN_CORNERS)),
                         ids=list(parity.SCAN_CORNERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_conflict_scan_corner_matches_jax_op_and_ref(seed, corner):
    sc = parity.scan_corners(np.random.default_rng(seed), SCAN_CORNER_B,
                             SCAN_CORNER_U)[corner]
    args = [sc[k] for k in SCAN_ARGS]
    got = conflict_scan(*args, device="cpu")
    np.testing.assert_array_equal(
        got, np.asarray(ref_conflict_scan(*(jnp.asarray(a) for a in args))))
    if len(sc["w_hi"]):      # the JAX op takes no empty window
        np.testing.assert_array_equal(
            got, np.asarray(jops.conflict_scan(*args)))
    if parity.SCAN_CORNERS[corner] == "empty_window":
        assert not got.any()
    else:
        assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("seed", SEEDS)
def test_conflict_scan_corners_have_their_shape(seed):
    B, U = SCAN_CORNER_B, SCAN_CORNER_U
    cases = dict(zip(parity.SCAN_CORNERS, parity.scan_corners(
        np.random.default_rng(seed), B, U)))
    shapes = {"empty_window": (B, 0), "three_tiles": (B, 3 * U),
              "batch_1000": (1000, U)}
    for name, sc in cases.items():
        assert (len(sc["q_hi"]), len(sc["w_hi"])) == shapes.get(name, (B, U))
    # Keys held only under INCR commute with INCR queries; the others meet
    # a SET somewhere and conflict.
    rk = cases["repeated_keys"]
    key = lambda h, l: (h.astype(np.uint64) << np.uint64(32)) | l
    wk, qk = key(rk["w_hi"], rk["w_lo"]), key(rk["q_hi"], rk["q_lo"])
    assert np.unique(wk, return_counts=True)[1].max() > 1
    got = conflict_scan(*(rk[k] for k in SCAN_ARGS), device="cpu")
    meets = ((qk[:, None] == wk[None]) & (rk["w_valid"][None] > 0)).any(1)
    assert (meets & (got == 0)).any() and (got == 1).any()
    ones = cases["all_ones_key"]
    marker = (ones["w_hi"] == 0xFFFFFFFF) & (ones["w_lo"] == 0xFFFFFFFF)
    assert marker.sum() == 2 and (ones["w_valid"][marker] > 0).all()
    assert ((ones["q_hi"] == 0xFFFFFFFF) & (ones["q_lo"] == 0xFFFFFFFF)).any()
    assert set(np.unique(cases["legacy_valid"]["w_valid"])) == {0, 1}
    odd = cases["class_32_up"]
    assert (odd["w_valid"] > 33).any() and (odd["q_cls"] >= 16).any()


# ---------------------------------------------------------------------------
# The programs that drive this path: dispatch counts and figure 11
# ---------------------------------------------------------------------------
def test_per_op_path_pays_three_dispatches_per_op_fused_path_one():
    """fig_fastpath's claim: keyhash2x32 -> witness_record -> conflict_scan
    per op is 3 dispatches per op; fastpath_batch is 1 per batch."""
    rng = np.random.default_rng(3)
    khi, klo = _lanes(rng, 16)
    win = np.zeros(8, np.uint32)
    wv = np.zeros(8, np.int32)
    t = WitnessTable.empty(1024, 4, device="cpu")
    reset_dispatch_count()
    accepted = []
    for i in range(16):
        qh, ql = keyhash2x32(khi[i:i + 1], klo[i:i + 1], device="cpu")
        acc, t = witness_record(t, qh, ql)
        conflict_scan(win, win, wv, qh, ql, device="cpu")
        accepted.append(int(acc[0]))
    assert dispatch_count() == 3 * 16
    reset_dispatch_count()
    res = fastpath_batch(WitnessTable.empty(1024, 4, device="cpu"), khi, klo,
                         window_hi=win, window_lo=win, window_valid=wv)
    assert dispatch_count() == 1
    np.testing.assert_array_equal(res.accepted, accepted)


def test_witness_capacity_figure11_shape_on_the_port():
    """Appendix B.1 (tests/test_system.py on the JAX package): 4-way
    associativity outlasts direct-mapped by more than 2.5x."""
    def inserts_to_first_reject(ways, slots=256, seed=0):
        rng = np.random.default_rng(seed)
        t = WitnessTable.empty(slots // ways, ways, device="cpu")
        qh = rng.integers(0, 2**32, slots * 4, dtype=np.uint32)
        ql = rng.integers(0, 2**32, slots * 4, dtype=np.uint32)
        acc, _ = witness_record(t, qh, ql)
        rejects = np.flatnonzero(acc == 0)
        return int(rejects[0]) if len(rejects) else len(acc)

    direct = statistics.mean(inserts_to_first_reject(1, seed=s)
                             for s in range(5))
    assoc4 = statistics.mean(inserts_to_first_reject(4, seed=s)
                             for s in range(5))
    assert assoc4 > 2.5 * direct


def test_ops_refuse_operands_a_kernel_would_read_past():
    """Lanes of unequal length, or table planes of unequal shape, raise
    before anything reaches a kernel."""
    t = WitnessTable.empty(16, 2, device="cpu")
    with pytest.raises(ValueError, match="one length"):
        witness_record(t, [1, 2], [3])
    with pytest.raises(ValueError, match="one length"):
        conflict_scan([1, 2], [1], [1, 1], [1], [1], device="cpu")
    with pytest.raises(ValueError, match="one length"):
        fastpath_batch(t, [1], [2], window_hi=[1, 2], window_lo=[1],
                       window_valid=[1, 1])
    with pytest.raises(ValueError, match="one length"):
        keyhash2x32([1, 2], [3], device="cpu")
    bad = WitnessTable(t.keys_hi, t.keys_lo,
                       torch.zeros((8, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="one \\[S, W\\] shape"):
        witness_record(bad, [1], [2])


# ---------------------------------------------------------------------------
# State carried across from the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,W", GEOMETRIES, ids=lambda v: str(v))
def test_witness_table_round_trips_between_packages(S, W):
    _rng, _pool, planes = _case(0, S, W)
    planes[0][0, 0] = 0xF0000001
    port = witness_table_from_numpy(planes, "cpu")
    assert all(p.dtype == torch.int32 and p.shape == (S, W) for p in port)
    back = witness_table_to_numpy(port)
    for a, b in zip(back, planes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    empty = witness_table_to_numpy(WitnessTable.empty(S, W, device="cpu"))
    for a, b in zip(empty, JaxWitnessTable.empty(S, W)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
