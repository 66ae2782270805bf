"""The port's serving path (``repro_torch.serving``) against the JAX
package's.

``CurpSessionStore``: each scenario twins a case of the reference's own
tests (tests/test_fastpath.py ``TestCommitBatch``, tests/test_migration.py
``TestServingLiveMigration``, tests/test_sharded.py
``TestShardedSessionStore``, tests/test_txn.py ``TestServingAtomicCommit``)
and runs, with the same seeds, on ``repro.serving.kvstore`` over the Python
witness backend and on the port over its Python backend and over its
device backend on the CPU (the plain versions of the gang kernels).  Each
side keeps that case's own asserts and the observations (fast/slow counts,
per-shard commits, placements, loads, transaction outcomes, rebalance
moves) must be equal.

``CurpServeDriver``: the port with the reference's weights
(``init_params(cfg, PRNGKey(3))`` through ``params_from_jax``), f32 on the
CPU, must generate exactly the reference driver's tokens, through a crash
and recovery, on both witness backends and with ``atomic_step_commit``.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.serving.kvstore as ref_kv
import repro_torch.core as tcore
import repro_torch.serving.kvstore as port_kv
from repro.configs import ARCHS
from repro.models import init_params
from _port_cfg import reduced
from repro.serving.server import CurpServeDriver as RefDriver
from repro.serving.server import ServeConfig as RefServeConfig
from repro_torch.kernels import dispatch_count, reset_dispatch_count
from repro_torch.models import Transformer, cache_tensors
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import CurpServeDriver, ServeConfig

BACKENDS = ["python", "device"]
SERVE_ARCHS = ["llama3.2-1b", "hymba-1.5b"]


def _reference_side():
    return SimpleNamespace(
        store=lambda **kw: ref_kv.CurpSessionStore(witness_backend="python",
                                                   **kw),
        State=ref_kv.SessionState, Geometry=jcore.WitnessGeometry,
        TxnStatus=jcore.TxnStatus)


def _port_side(backend):
    return SimpleNamespace(
        store=lambda **kw: port_kv.CurpSessionStore(witness_backend=backend,
                                                    device="cpu", **kw),
        State=port_kv.SessionState, Geometry=tcore.WitnessGeometry,
        TxnStatus=tcore.TxnStatus)


def _loads(store, sids):
    out = []
    for sid in sids:
        st = store.load(sid)
        out.append(None if st is None else (st.tokens, st.done))
    return out


# ---------------------------------------------------------------------------
# Store scenarios: each returns what it observed, with its reference case's
# asserts inline.
# ---------------------------------------------------------------------------
def commit_batch_fast_and_recoverable(side):
    store = side.store(n_shards=2, geometry=side.Geometry(256, 4))
    states = [side.State(f"s{i}", [1, 2, i]) for i in range(6)]
    seen = []
    store.commit_batch(states)
    assert store.fast_commits == 6 and store.slow_commits == 0
    seen.append((store.fast_commits, store.slow_commits))
    for st_ in states:
        st_.tokens.append(9)
    store.commit_batch(states)
    assert store.fast_commits == 6 and store.slow_commits == 6
    for st_ in states:
        st_.tokens.append(11)
    store.commit_batch(states)
    assert store.fast_commits == 12 and store.slow_commits == 6
    assert sum(store.per_shard_commits()) == 18
    seen.append(store.per_shard_commits())
    seen.append([store.shard_of(s.session_id) for s in states])
    store.crash_and_recover()
    got = _loads(store, [f"s{i}" for i in range(6)])
    assert all(g == ([1, 2, i, 9, 11], False) for i, g in enumerate(got))
    return seen + got


def commit_batch_empty_noop(side):
    store = side.store()
    store.commit_batch([])
    assert store.fast_commits == 0 and store.slow_commits == 0
    return [store.per_shard_commits()]


def sessions_survive_live_migration_and_crash(side):
    store = side.store(f=3, sync_batch=8, n_shards=2, n_slots=64)
    for i in range(12):
        store.commit(side.State(f"s{i}", [1, 2, i]))
    placed = {f"s{i}": store.shard_of(f"s{i}") for i in range(12)}
    dst = store.add_shard()
    slots = store.cluster.router.slots_of_shard(0)[:16]
    store.migrate_sessions(slots, dst)
    moved = [sid for sid in placed
             if store.cluster.router.slot_of(f"session:{sid}") in set(slots)]
    for sid in moved:
        assert store.shard_of(sid) == dst
    for i in range(12):
        store.commit(side.State(f"s{i}", [1, 2, i, 99]))
    store.crash_and_recover()
    got = _loads(store, [f"s{i}" for i in range(12)])
    assert all(g == ([1, 2, i, 99], False) for i, g in enumerate(got))
    return [placed, dst, sorted(moved), store.n_shards,
            store.per_shard_commits(), store.fast_commits,
            store.slow_commits] + got


def store_rebalance_passthrough(side):
    store = side.store(f=3, n_shards=2, n_slots=64)
    for i in range(30):
        store.commit(side.State(f"r{i}", [i]))
    out = store.rebalance()
    assert "moves" in out and "reports" in out
    got = _loads(store, [f"r{i}" for i in range(30)])
    assert all(g == ([i], False) for i, g in enumerate(got))
    return [dict(out["moves"]), len(out["reports"]),
            [store.shard_of(f"r{i}") for i in range(30)]] + got


def sessions_spread_and_survive_full_crash(side):
    store = side.store(f=3, sync_batch=8, n_shards=4)
    for i in range(16):
        store.commit(side.State(f"s{i}", [1, 2, i]))
    shards = [store.shard_of(f"s{i}") for i in range(16)]
    assert len(set(shards)) >= 3
    rep = store.crash_and_recover()
    assert len(rep.per_shard) == 4
    got = _loads(store, [f"s{i}" for i in range(16)])
    assert all(g == ([1, 2, i], False) for i, g in enumerate(got))
    return [shards, rep.replayed, store.fast_commits,
            store.slow_commits] + got


def one_shard_crash_keeps_other_sessions_unsynced(side):
    store = side.store(f=3, sync_batch=1000, n_shards=2)
    sids = [f"s{i}" for i in range(8)]
    for sid in sids:
        store.commit(side.State(sid, [1]))
    by_shard = {0: [], 1: []}
    for sid in sids:
        by_shard[store.shard_of(sid)].append(sid)
    assert by_shard[0] and by_shard[1]
    other = store.cluster.shards[1].master.unsynced_count
    rep = store.crash_shard(0)
    assert rep.shard_id == 0
    assert store.cluster.shards[1].master.unsynced_count == other
    got = _loads(store, sids)
    assert all(g is not None for g in got)
    return [by_shard, other, rep.replayed] + got


def store_txn_atomic_group_commit(side):
    store = side.store(f=3, sync_batch=8, n_shards=4)
    group = [side.State(f"g{i}", [1, i]) for i in range(6)]
    out = store.txn(group)
    assert out.status is side.TxnStatus.COMMITTED
    shards = {store.shard_of(s.session_id) for s in group}
    assert out.n_shards == len(shards) >= 2
    got = _loads(store, [s.session_id for s in group])
    assert all(g == (s.tokens, False) for g, s in zip(got, group))
    return [out.status.name, out.n_shards, out.rtts, out.fast_path,
            store.fast_commits, store.slow_commits,
            store.per_shard_commits()] + got


def store_txn_survives_full_crash(side):
    store = side.store(f=3, sync_batch=1000, n_shards=2)
    out = store.txn([side.State(f"c{i}", [i]) for i in range(4)])
    store.crash_and_recover()
    got = _loads(store, [f"c{i}" for i in range(4)])
    assert all(g == ([i], False) for i, g in enumerate(got))
    return [out.status.name, out.rtts, out.fast_path] + got


def store_txn_empty_group_noop(side):
    store = side.store(f=3, n_shards=2)
    out = store.txn([])
    assert out.status is side.TxnStatus.COMMITTED and out.rtts == 0
    return [out.n_shards, store.fast_commits, store.slow_commits]


SCENARIOS = [
    commit_batch_fast_and_recoverable, commit_batch_empty_noop,
    sessions_survive_live_migration_and_crash, store_rebalance_passthrough,
    sessions_spread_and_survive_full_crash,
    one_shard_crash_keeps_other_sessions_unsynced,
    store_txn_atomic_group_commit, store_txn_survives_full_crash,
    store_txn_empty_group_noop,
]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_store_matches_reference(scenario, backend):
    assert scenario(_port_side(backend)) == scenario(_reference_side())


# ---------------------------------------------------------------------------
# The decode driver
# ---------------------------------------------------------------------------
def _serve_kw(**kw):
    return dict(dict(max_batch=4, max_seq=64, f=3, sync_batch=8), **kw)


@functools.lru_cache(maxsize=None)
def _reference_run(arch, **kw):
    """The reference driver (Python backend, its own jitted decode) on the
    reduced config with ``init_params(cfg, PRNGKey(3))``: tokens and the
    store's fast/slow counts after two sessions and 8 steps."""
    cfg = reduced(ARCHS[arch])
    a = RefDriver(cfg, RefServeConfig(**_serve_kw(**kw)), seed=3)
    a.submit("s1", [5, 17, 99])
    a.submit("s2", [1, 2])
    a.generate(8)
    return ({sid: list(s.tokens) for sid, s in a.sessions.items()},
            (a.store.fast_commits, a.store.slow_commits))


@functools.lru_cache(maxsize=None)
def _reference_state(arch):
    cfg = reduced(ARCHS[arch])
    params = jax.tree_util.tree_map(
        np.asarray, init_params(cfg, jax.random.PRNGKey(3)))
    return params_from_jax(cfg, params)


def _port_driver(arch, backend, **kw):
    cfg = reduced(ARCHS[arch])
    model = Transformer.from_state_dict(cfg, _reference_state(arch),
                                        device="cpu")
    serve = ServeConfig(**_serve_kw(witness_backend=backend, device="cpu",
                                    **kw))
    d = CurpServeDriver(cfg, serve, params=model)
    d.submit("s1", [5, 17, 99])
    d.submit("s2", [1, 2])
    return d


def _tokens(d):
    return {sid: list(s.tokens) for sid, s in d.sessions.items()}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_tokens_match_reference_driver(arch, backend):
    want, counts = _reference_run(arch)
    reset_dispatch_count()
    d = _port_driver(arch, backend)
    d.generate(8)
    assert _tokens(d) == want
    assert (d.store.fast_commits, d.store.slow_commits) == counts
    if backend == "device":      # the gang ops ran, one call per batch or more
        assert dispatch_count() >= 8


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_crash_recovery_identical_tokens(arch, backend):
    """Twin of TestCurpServe.test_crash_recovery_identical_tokens, on the
    reference's weights, held to the reference driver's tokens."""
    want, _ = _reference_run(arch)
    b = _port_driver(arch, backend)
    b.generate(5)
    rep = b.crash_and_recover()
    assert rep["recovered_sessions"] == 2
    b.generate(3)
    assert _tokens(b) == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_commits_take_fast_path(backend):
    """Twin of TestCurpServe.test_commits_take_fast_path (the port's own
    random init)."""
    cfg = reduced(ARCHS["llama3.2-1b"])
    sc = ServeConfig(max_batch=2, max_seq=32, f=3, sync_batch=50,
                     witness_backend=backend, device="cpu")
    d = CurpServeDriver(cfg, sc, seed=0)
    d.submit("a", [1, 2])
    d.submit("b", [3])
    d.generate(6)
    assert d.store.fast_commits >= 10
    assert d.store.slow_commits <= 2


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_atomic_step_commit_matches_reference(arch, backend):
    """Each step as one mini-transaction over 4 shards: the same tokens,
    and the reference's fast/slow counts (cross-shard steps pay 2PC)."""
    want, counts = _reference_run(arch, atomic_step_commit=True, n_shards=4)
    assert want == _reference_run(arch)[0]
    d = _port_driver(arch, backend, atomic_step_commit=True, n_shards=4)
    d.generate(8)
    assert _tokens(d) == want
    assert (d.store.fast_commits, d.store.slow_commits) == counts


# ---------------------------------------------------------------------------
# What capturing the decode step as a CUDA graph rests on (the card replays
# one graph a token; here, on the CPU, the same step runs eagerly)
# ---------------------------------------------------------------------------
CAPTURE_ARCHS = ["llama3.2-1b", "hymba-1.5b", "mamba2-130m",
                 "qwen2-moe-a2.7b"]


def _filled_cache(arch, steps=5, batch=3, max_seq=16):
    """A reduced model and a cache after ``steps`` decode steps of random
    tokens under a random active mask (every row active at least once)."""
    import torch

    from repro_torch.models import decode_step, init_decode_cache

    cfg = reduced(ARCHS[arch])
    model = Transformer(cfg, device="cpu", seed=5)
    cache = init_decode_cache(cfg, batch, max_seq, device="cpu")
    rng = np.random.default_rng(9)
    for i in range(steps):
        act = rng.integers(0, 2, batch) if i else np.ones(batch, np.int64)
        decode_step(cfg, model, {
            "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, 1))),
            "active": torch.from_numpy(act).int()}, cache)
    return cfg, model, cache, rng


@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_inactive_decode_leaves_cache_bit_unchanged(arch):
    """The capture's precondition: a step with every row inactive (as the
    driver warms up and captures) leaves every cache tensor bit-unchanged,
    K/V rings, SSM state and conv window and positions alike."""
    import torch

    from repro_torch.models import decode_step

    cfg, model, cache, rng = _filled_cache(arch)
    before = [t.clone() for t in cache_tensors(cache)]
    assert any(bool(t.ne(0).any()) for t in before[1:])
    for _ in range(2):
        decode_step(cfg, model, {
            "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1))),
            "active": torch.zeros(3, dtype=torch.int32)}, cache)
    after = cache_tensors(cache)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_decode_step_advances_pos_in_place(arch):
    """``decode_step`` writes every cache tensor in place, positions too:
    the same tensors (and storage) before and after, ``pos`` grown by the
    active mask."""
    import torch

    from repro_torch.models import decode_step

    cfg, model, cache, rng = _filled_cache(arch)
    tensors = cache_tensors(cache)
    ptrs = [t.data_ptr() for t in tensors]
    pos0 = cache["pos"].clone()
    act = torch.tensor([1, 0, 1], dtype=torch.int32)
    _, out = decode_step(cfg, model, {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1))),
        "active": act}, cache)
    assert out is cache
    assert all(a is b for a, b in zip(cache_tensors(cache), tensors))
    assert [t.data_ptr() for t in cache_tensors(cache)] == ptrs
    assert cache["pos"].dtype == torch.int32
    assert torch.equal(cache["pos"], pos0 + act)


def _capture_driver(arch):
    cfg = reduced(ARCHS[arch])
    d = CurpServeDriver(cfg, ServeConfig(max_batch=3, max_seq=16, f=3,
                                         sync_batch=8, device="cpu"), seed=2)
    d.submit("a", [5, 17, 99])
    d.submit("b", [1, 2])
    d.generate(3)
    return d


@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_reset_and_recovery_zero_the_cache_in_place(arch):
    """``_reset_cache`` and ``crash_and_recover`` keep every cache tensor
    (a captured graph holds their addresses) and zero it: the recovery's
    re-prefill starts from an all-zero cache in the same tensors."""
    import torch

    d = _capture_driver(arch)
    tensors = cache_tensors(d.cache)
    ptrs = [t.data_ptr() for t in tensors]
    assert any(bool(t.ne(0).any()) for t in tensors)
    seen = []
    replay = d._replay_tokens

    def first_replay(slot, tokens):
        if not seen:
            seen.append([bool(t.eq(0).all()) for t in cache_tensors(d.cache)])
        replay(slot, tokens)

    d._replay_tokens = first_replay
    want = {sid: list(s.tokens) for sid, s in d.sessions.items()}
    rep = d.crash_and_recover()
    assert rep["recovered_sessions"] == 2
    assert seen and all(seen[0])
    assert {sid: list(s.tokens) for sid, s in d.sessions.items()} == want
    assert all(a is b for a, b in zip(cache_tensors(d.cache), tensors))
    assert [t.data_ptr() for t in cache_tensors(d.cache)] == ptrs
    d._reset_cache()
    assert all(a is b for a, b in zip(cache_tensors(d.cache), tensors))
    assert all(bool(t.eq(0).all()) for t in tensors)
    assert d.slots == [None] * 3
    assert d.graph_replays == 0          # the CPU runs the step eagerly
    d.submit("c", [4])
    d.generate(2)
    assert len(d.sessions["c"].tokens) == 3
    assert isinstance(d.sessions["c"].tokens[-1], int)
    assert torch.equal(d.cache["pos"], torch.tensor([2, 0, 0],
                                                    dtype=torch.int32))


@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_decode_logits_are_the_callers_own(arch):
    """The logits ``_decode`` returns are not changed by a later step (on
    the card the graph's output buffer is, so the driver hands out a
    copy); the greedy tokens it leaves are their argmax."""
    import torch

    d = _capture_driver(arch)
    host = np.zeros((2, 3), np.int32)
    host[:, 0] = (7, 1)
    first = d._decode(host)
    assert torch.equal(d._next, first.argmax(-1))
    kept = first.clone()
    host[:, 1] = (3, 1)
    second = d._decode(host)
    assert torch.equal(first, kept)
    assert second.shape == first.shape == (3, d.cfg.vocab)
    assert not torch.equal(first[0], second[0])   # row 0 moved on a token
