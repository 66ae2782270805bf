"""The port's transaction probe, table gc and sequential record, and the
transaction path on the device backend, held against the JAX package (CPU).

On CPU tensors ``repro_torch.kernels`` runs the plain PyTorch versions of
K9 (``txn_probe``, on K1's mix), K10 (``witness_gc``) and K11
(``witness_record_seq``).  K10 is held against ``repro.kernels.ops`` itself
(its Pallas kernel traces in interpret mode here) and ``ref_witness_gc``;
K9 and K11 against the ``repro.kernels.ref`` oracles (their Pallas bodies
need a Pallas with ``pl.load``).  The same seeded numpy inputs go to both
sides; equality is exact.  Shapes: 16x2, 64x4 and 256x1 tables, probes of
at most 16 keys, gc batches of at most 64 entries, 4-shard clusters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ShardedCluster as JaxShardedCluster
from repro.core import Witness as JaxWitness
from repro.core.types import Op as JaxOp
from repro.core.types import OpType as JaxOpType
from repro.kernels import ops as jops
from repro.kernels.ref import WitnessTable as JaxWitnessTable
from repro.kernels.ref import (
    ref_keyhash2x32,
    ref_witness_gc,
    ref_witness_record,
    ref_witness_record_txn,
)
from repro.sim import TxnWorkload as JaxTxnWorkload
from repro_torch.core import DeviceWitness, ShardedCluster, TxnStatus
from repro_torch.core.types import Op, OpType
from repro_torch.kernels import (
    WitnessTable,
    dispatch_count,
    parity,
    ref,
    reset_dispatch_count,
    txn_probe,
    witness_gc,
    witness_record,
    witness_record_seq,
    witness_table_from_numpy,
    witness_table_to_numpy,
)
from repro_torch.sim import TxnWorkload

SEEDS = [0, 1, 2]
GEOMETRIES = [(16, 2), (64, 4), (256, 1)]
# The oracles, jitted: probes pad to one bucket, so each compiles once.
_mix = jax.jit(ref_keyhash2x32)
_probe = jax.jit(ref_witness_record_txn)


def _jax_table(planes):
    return JaxWitnessTable(*(jnp.asarray(np.asarray(p)) for p in planes))


def _tables_equal(port: WitnessTable, oracle) -> None:
    for name, a, b in zip(ref.TABLE_PLANES, witness_table_to_numpy(port),
                          oracle):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def _oracle_probe(table, hi, lo, own):
    """``_txn_probe_impl`` of the JAX package through its oracles: K1's
    mix, the bucket padding, then ``ref_witness_record_txn``."""
    K = len(hi)
    qh, ql = _mix(jnp.asarray(hi, jnp.uint32), jnp.asarray(lo, jnp.uint32))
    qhp, qlp, ownp, valid = jops._pad_valid(K, np.asarray(qh), np.asarray(ql),
                                            np.asarray(own, np.int32))
    acc, hit, table = _probe(
        table, jnp.asarray(qhp), jnp.asarray(qlp), jnp.asarray(ownp),
        jnp.asarray(valid))
    return (bool(np.asarray(acc)[0]), np.asarray(hit)[:K], np.asarray(qh),
            np.asarray(ql), table)


def _probe_case(seed, S, W):
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 2 * S * W, S)
    planes = parity.table_planes(rng, pool, S, W, fill=1.5)
    return rng, pool, planes


def _own(table: WitnessTable, p) -> np.ndarray:
    """The chain's rule: ``own`` where the coin is set and the key is held."""
    hi, lo = (torch.from_numpy(np.asarray(p[k]).view(np.int32).copy())
              for k in ("key_hi", "key_lo"))
    return p["own_coin"] * parity.held(table, hi, lo).numpy()


# ---------------------------------------------------------------------------
# K9: txn_probe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,W", GEOMETRIES, ids=lambda v: str(v))
@pytest.mark.parametrize("seed", SEEDS)
def test_txn_probe_chain_matches_ref_slot_for_slot(seed, S, W):
    """A chain of multi-key probes over a table near full: accept, hit,
    the mixed lanes and all three planes equal the oracle after every op."""
    rng, pool, planes = _probe_case(seed, S, W)
    table = witness_table_from_numpy(planes, "cpu")
    oracle = _jax_table(planes)
    verdicts = []
    for p in parity.txn_chain(rng, pool, planes, 40, max_keys=4,
                              own_frac=0.3, same_set_frac=0.2):
        own = _own(table, p)
        res = txn_probe(table, p["key_hi"], p["key_lo"], own)
        acc, hit, qh, ql, oracle = _oracle_probe(oracle, p["key_hi"],
                                                 p["key_lo"], own)
        assert res.accepted == acc
        np.testing.assert_array_equal(res.hit, hit)
        np.testing.assert_array_equal(res.q_hi, qh)
        np.testing.assert_array_equal(res.q_lo, ql)
        _tables_equal(res.table, oracle)
        verdicts.append(acc)
    assert 0 < sum(verdicts) < len(verdicts)


@pytest.mark.parametrize("seed", SEEDS)
def test_txn_probe_inputs_reach_every_outcome(seed):
    """Accept, reject on a conflict, reject as FULL, an own retry that
    passes, same-set inserters, a duplicate key and padding lanes."""
    rng, pool, planes = _probe_case(seed, 64, 4)
    table = witness_table_from_numpy(planes, "cpu")
    codes = []
    for p in parity.txn_chain(rng, pool, planes, 200, max_keys=4,
                              own_frac=0.3, dup_frac=0.2):
        own = _own(table, p)
        res = txn_probe(table, p["key_hi"], p["key_lo"], own)
        valid = np.ones(len(own), np.int32)
        codes += parity.txn_codes(res.accepted, res.hit, own, valid,
                                  res.q_lo, p["key_hi"], p["key_lo"], 64)
        codes.append(parity.TXN_PADDED)           # K < 16 pads every op
    cov = parity.reason_coverage(np.array(codes), parity.N_CODES)
    assert all(cov[c] > 0 for c in parity.BRANCHES["txn_probe"]), cov


def test_txn_probe_reject_leaves_the_table_bit_identical():
    """A conflict and a FULL reject write nothing, not even the keys that
    would have seated; an own retry of the held key passes."""
    table = WitnessTable.empty(4, 2, device="cpu")
    res = txn_probe(table, [0], [7])
    assert res.accepted and list(res.hit) == [0]
    before = [p.clone() for p in table]
    res = txn_probe(table, [1, 0], [1, 7])
    assert not res.accepted and list(res.hit) == [0, 1]
    assert all(torch.equal(a, b) for a, b in zip(before, table))
    res = txn_probe(table, [1, 0], [1, 7], own=[0, 1])
    assert res.accepted and list(res.hit) == [0, 1]
    assert int(table.occ.sum()) == 2


def test_txn_probe_same_set_keys_take_distinct_ways():
    """Two inserters into one set take its first and second free way; a
    third key of that set rejects the op as FULL when only two are free."""
    table = WitnessTable.empty(1, 2, device="cpu")
    res = txn_probe(table, [1, 2], [3, 4])
    assert res.accepted
    occ = witness_table_to_numpy(table)[2]
    assert list(occ[0]) == [1, 1]
    assert set(witness_table_to_numpy(table)[1][0]) == set(res.q_lo)
    table = WitnessTable.empty(1, 2, device="cpu")
    res = txn_probe(table, [1, 2, 5], [3, 4, 6])
    assert not res.accepted and int(table.occ.sum()) == 0


def test_txn_probe_is_one_dispatch_on_accept_and_reject():
    table = WitnessTable.empty(16, 2, device="cpu")
    reset_dispatch_count()
    assert txn_probe(table, [1, 2], [3, 4]).accepted
    assert dispatch_count() == 1
    assert not txn_probe(table, [1], [3]).accepted
    assert dispatch_count() == 2


# ---------------------------------------------------------------------------
# K10: witness_gc
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,W", GEOMETRIES, ids=lambda v: str(v))
@pytest.mark.parametrize("seed", SEEDS)
def test_witness_gc_matches_pallas_and_ref(seed, S, W):
    """The table after gc equals the Pallas kernel's (interpret mode) and
    ``ref_witness_gc``'s, at G of 0 (oracle only: the interpret path
    divides by G), 50 and 64."""
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 4 * S * W, S)
    planes = parity.gc_planes(rng, pool, S, W)
    for G in (0, 50, 64):
        g = parity.gc_entries(rng, planes, G)
        table = witness_gc(witness_table_from_numpy(planes, "cpu"),
                           g["g_hi"], g["g_lo"])
        want = ref_witness_gc(_jax_table(planes), jnp.asarray(g["g_hi"]),
                              jnp.asarray(g["g_lo"]))
        _tables_equal(table, want)
        if G:
            _tables_equal(table, jops.witness_gc(_jax_table(planes),
                                                 g["g_hi"], g["g_lo"]))


@pytest.mark.parametrize("seed", SEEDS)
def test_witness_gc_inputs_reach_every_outcome(seed):
    """A hit, a miss, a key left only in a cleared slot (stays 0, no hit),
    a repeated entry, and an empty batch."""
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 1024, 64)
    planes = parity.gc_planes(rng, pool, 64, 4)
    codes = []
    for G in (0, 50, 64):
        g = parity.gc_entries(rng, planes, G)
        codes += parity.gc_codes(planes, g["g_hi"], g["g_lo"])
    cov = parity.reason_coverage(np.array(codes), parity.N_CODES)
    assert all(cov[c] > 0 for c in parity.BRANCHES["witness_gc"]), cov


def test_witness_gc_clears_occ_only_and_ignores_cleared_slots():
    table = WitnessTable.empty(4, 2, device="cpu")
    acc, table = witness_record(table, [9, 9, 8], [1, 5, 2])
    assert list(acc) == [1, 1, 1]
    table = witness_gc(table, [9, 9], [1, 1])          # repeated entry
    hi, lo, occ = witness_table_to_numpy(table)
    assert list(occ[1]) == [0, 1] and occ[2, 0] == 1
    assert hi[1, 0] == 9 and lo[1, 0] == 1             # keys untouched
    before = [p.clone() for p in table]
    reset_dispatch_count()
    witness_gc(table, [9], [1])                        # only a cleared slot
    witness_gc(table, [], [])
    assert dispatch_count() == 2
    assert all(torch.equal(a, b) for a, b in zip(before, table))


# ---------------------------------------------------------------------------
# K11: witness_record_seq
# ---------------------------------------------------------------------------
def _seq_numpy(planes, q_hi, q_lo):
    """``_record_seq_kernel`` of the JAX package, transcribed to numpy: one
    ordered loop, conflict on ``occ == 1`` exactly."""
    khi, klo, occ = (np.array(p) for p in planes)
    S = khi.shape[0]
    acc = np.zeros(len(q_hi), np.int32)
    for b, (h, l) in enumerate(zip(q_hi, q_lo)):
        s = int(l) & (S - 1)
        conflict = ((occ[s] == 1) & (khi[s] == h) & (klo[s] == l)).any()
        free = np.flatnonzero(occ[s] == 0)
        if not conflict and free.size:
            khi[s, free[0]], klo[s, free[0]], occ[s, free[0]] = h, l, 1
            acc[b] = 1
    return acc, (khi, klo, occ)


@pytest.mark.parametrize("S,W", GEOMETRIES, ids=lambda v: str(v))
@pytest.mark.parametrize("seed", SEEDS)
def test_witness_record_seq_matches_ref_all_set(seed, S, W):
    """On a table of SET records only, the sequential record is
    ``ref_witness_record`` with every class SET (and so K6's result)."""
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 4 * S, S)
    for fill in (0.0, 0.5):
        planes = parity.table_planes(rng, pool, S, W, fill=fill)
        planes[2][planes[2] > 0] = 1
        q = parity.table_batch(rng, pool, 200, W)
        acc, table = witness_record_seq(witness_table_from_numpy(planes,
                                                                 "cpu"),
                                        q["q_hi"], q["q_lo"])
        want, want_table = ref_witness_record(
            _jax_table(planes), jnp.asarray(q["q_hi"]),
            jnp.asarray(q["q_lo"]))
        np.testing.assert_array_equal(acc, np.asarray(want))
        _tables_equal(table, want_table)
        k6, k6_table = witness_record(witness_table_from_numpy(planes, "cpu"),
                                      q["q_hi"], q["q_lo"])
        np.testing.assert_array_equal(acc, k6)
        _tables_equal(table, witness_table_to_numpy(k6_table))


@pytest.mark.parametrize("S,W", GEOMETRIES, ids=lambda v: str(v))
@pytest.mark.parametrize("seed", SEEDS)
def test_witness_record_seq_matches_the_ordered_loop_with_classes(seed, S, W):
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 4 * S, S)
    planes = parity.table_planes(rng, pool, S, W)
    q = parity.table_batch(rng, pool, 200, W)
    acc, table = witness_record_seq(witness_table_from_numpy(planes, "cpu"),
                                    q["q_hi"], q["q_lo"])
    want, want_table = _seq_numpy(planes, q["q_hi"], q["q_lo"])
    np.testing.assert_array_equal(acc, want)
    _tables_equal(table, want_table)


@pytest.mark.parametrize("seed", SEEDS)
def test_witness_record_seq_inputs_reach_every_outcome(seed):
    """Insert, a conflict on occ == 1, a same key held under another class
    (occupied, no conflict: it inserts beside), and FULL."""
    rng = np.random.default_rng(seed)
    pool = parity.key_pool(rng, 256, 64)
    planes = parity.table_planes(rng, pool, 64, 4)
    q = parity.table_batch(rng, pool, 512, 4)
    args = [torch.from_numpy(np.asarray(q[k]).view(np.int32).copy())
            for k in ("q_hi", "q_lo")]
    out = ref.witness_seq_outcomes_plain(
        witness_table_from_numpy(planes, "cpu"), *args)
    cov = parity.reason_coverage(out.numpy(), parity.N_CODES)
    assert all(cov[c] > 0 for c in parity.BRANCHES["witness_record_seq"]), cov


# ---------------------------------------------------------------------------
# The record -> gc -> record chain (test_fastpath.py's round trip)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_record_gc_record_leaves_no_stale_occupancy(seed):
    rng = np.random.default_rng(seed)
    table = WitnessTable.empty(64, 4, device="cpu")
    qh = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    ql = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    acc1, table = witness_record(table, qh, ql)
    ok = np.flatnonzero(acc1 == 1)
    half = ok[: ok.size // 2]
    table = witness_gc(table, qh[half], ql[half])
    assert int(table.occ.sum()) == ok.size - half.size
    acc2, table = witness_record(table, qh[half], ql[half])
    assert (acc2 == 1).all()
    assert int(table.occ.sum()) == ok.size


# ---------------------------------------------------------------------------
# The transaction path on the device backend
# ---------------------------------------------------------------------------
def _stream(cluster, workload, n):
    session = cluster.new_client()
    out = []
    for _ in range(n):
        writes, reads = workload.next_txn()
        o = cluster.txn(session, writes, reads)
        out.append((o.status.value, o.fast_path, o.rtts, o.reads))
    return out


@pytest.mark.parametrize("cross", [0.0, 1.0], ids=["single", "cross"])
@pytest.mark.parametrize("seed", SEEDS)
def test_txn_stream_on_device_backend_matches_python_backend(seed, cross):
    """fig_txn's single- and cross-shard streams: the port's device backend
    on the CPU against the JAX package's Python backend, 4 shards."""
    kw = dict(n_shards=4, cross_shard_frac=cross, keys_per_txn=2,
              reads_per_txn=1, seed=9 + seed)
    port = _stream(ShardedCluster(n_shards=4, f=3, seed=5 + seed,
                                  witness_backend="device", device="cpu"),
                   TxnWorkload(**kw), 60)
    jax_ = _stream(JaxShardedCluster(n_shards=4, f=3, seed=5 + seed),
                   JaxTxnWorkload(**kw), 60)
    assert port == jax_
    assert all(o[0] == TxnStatus.COMMITTED.value for o in port)
    rounds = [o[2] for o in port]
    if cross == 0.0:            # fig_txn's bounds
        assert sum(o[1] for o in port) >= 0.95 * len(port)
        assert sum(rounds) <= 1.05 * len(port)
    else:
        assert min(rounds) >= 2


def _fresh_witness():
    w = DeviceWitness(256, 4, device="cpu")
    w.start(master_id=1)
    w.record(1, (7,), (999, 1), Op(OpType.SET, ("c",), ("v",), (999, 1)))
    return w


def test_probe_dispatches_one_on_accept_and_reject_two_on_rollback():
    """fig_txn's claim 3: the grouped record is one dispatch on accept and
    on reject; record-then-rollback pays a second on reject."""
    multi = Op(OpType.MSET, ("a", "b", "c"), (1, 2, 3), (1000, 1))
    w = _fresh_witness()
    reset_dispatch_count()
    st_new = w._record_keys((5, 6, 7), multi.rpc_id, multi)
    assert dispatch_count() == 1
    w = _fresh_witness()
    reset_dispatch_count()
    st_old = w._record_keys_rollback((5, 6, 7), multi.rpc_id, multi)
    assert dispatch_count() == 2
    assert st_new == st_old and st_new.value == "REJECTED"
    w = _fresh_witness()
    reset_dispatch_count()
    assert w._record_keys((5, 6, 8), (1001, 1), multi).value == "ACCEPTED"
    assert dispatch_count() == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_device_witness_probe_matches_python_witness(seed):
    """fig_txn's collision-heavy multi-key ops (keys 0..23, 1-4 a op): the
    port's DeviceWitness and the JAX package's Witness agree on every
    verdict, retries included."""
    r = np.random.default_rng(7 + seed)
    py = JaxWitness(1024, 4)
    dv = DeviceWitness(1024, 4, device="cpu")
    py.start(1)
    dv.start(1)
    verdicts = []
    for i in range(60):
        n_keys = int(r.integers(1, 5))
        khs = tuple(int(k) for k in r.integers(0, 24, n_keys))
        rpc = (50 + i, 1)
        keys, vals = tuple(f"k{k}" for k in khs), tuple(range(n_keys))
        op = Op(OpType.MSET, keys, vals, rpc)
        jop = JaxOp(JaxOpType.MSET, keys, vals, rpc)
        st_py = py.record(1, khs, rpc, jop)
        st_dv = dv.record(1, khs, rpc, op)
        assert st_py.value == st_dv.value, (i, khs)
        if st_py.value == "ACCEPTED":
            assert (dv.record(1, khs, rpc, op).value
                    == py.record(1, khs, rpc, jop).value)
        verdicts.append(st_py.value)
    assert len(set(verdicts)) == 2
