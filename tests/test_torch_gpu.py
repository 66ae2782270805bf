"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (decided in the
fixture, so every pytest-xdist worker collects the same tests).  On the card
each kernel is built from ``src/repro_torch/kernels/csrc`` and must agree bit
for bit with its plain version on identical inputs; ``chip_smoke.py`` does
the same at full size.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import parity

# Deterministic cuBLAS for the trainer's bit-exact replay, set before the
# process's first CUDA product (collection imports this module before any
# test runs).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

pytestmark = pytest.mark.gpu

L, S, W, NS, CAP, F = 8, 64, 4, 4, 64, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(params=[0, 1])
def case(request):
    rng = np.random.default_rng(request.param)
    pool = parity.key_pool(rng, 4 * S, S)
    planes = parity.gang_planes(rng, pool, L, S, W, 24, fill=0.5)
    return dict(
        planes=planes,
        rec=parity.record_batch(rng, pool, 200, L, S, 24),
        grp=parity.group_batch(rng, pool, 64, 4, L, 24),
        gc=parity.gc_batch(rng, planes, S, 64, 24),
        fp=parity.fastpath_batch(rng, pool, 100, NS, CAP, F, L, 32, 24),
        corners=parity.fastpath_corners(rng, 1000, NS, 1024, F, L, 32, 24),
        gc_corners=parity.gc_corners(rng, planes, S, 24),
        rec_corners=parity.gang_record_corners(rng, 1024, F),
        grp_corners=parity.gang_groups_corners(rng),
    )


@pytest.mark.parametrize("kernel", ["gang_record", "gang_record_groups",
                                    "gang_gc", "gang_fastpath"])
def test_kernel_matches_plain_version(cuda, case, kernel):
    """gang_fastpath also at its corners: every op in one shard, shards
    with no op, rings filled to count + appends = CAP, hot keys that
    commute or not; B = 1000, padded by the op and as given; and B = 3000
    in one shard of a 4096-slot ring, which the kernel takes in chunks.
    gang_gc also at its corners, padded and as given: identical entries,
    one row's W ways cleared by W rpcs of one key, entries only in lanes
    that do not age, no aging, no entries, and 4096 entries in one aged
    lane and over eight lanes.  gang_record also at its corners, padded
    and as given: 3072 queries in one row (taken in chunks), DUP and
    CONFLICT in both orders, a row driven FULL, 1 and 64 ways, fewer rows
    than blocks, padding only, no counters, and K3's record stage of 1024
    ops x 3 lanes.  gang_record_groups also at its corners, padded and as
    given: G = K = 1, a group with no valid key, padding only, a FULL
    group, a key repeated as a DUP under two classes, dup-all retries, 32
    and 64 keys a group (more than one warp) and 1024 groups over one
    lane."""
    results = parity.check_kernels(case["planes"], S, case["rec"],
                                   case["grp"], case["gc"], case["fp"], F,
                                   device=cuda, fp_corners=case["corners"],
                                   gc_corners=case["gc_corners"],
                                   rec_corners=case["rec_corners"],
                                   grp_corners=case["grp_corners"])
    torch.cuda.synchronize()
    got = {r.name: r for r in results}[kernel]
    assert got.outputs > 0
    assert got.max_abs_err == 0
    assert not got.missed, got.coverage


@pytest.fixture(params=[0, 1])
def table_case(request):
    """Single-table inputs at 64x4, 16x2 and 128x8, with K8 at a batch and
    window that are not tile multiples, and K7's corners: no window, 777
    entries with repeated keys (256x1, 128x8), 2500 entries (more than one
    shared-memory table, 16x2), B = 1000; and B = 4000 on 1x4 (1024
    entries) and 4x2 (2500), which each block takes in chunks.  K6's
    corners: 4096 queries in one set of 1024x4 (taken in chunks), 256x1,
    128x8, 64x64 (ways at a stride of 32), 16x4 (fewer sets than blocks)
    and a batch of padding only.  K8's corners at 4096 x 1024: no window,
    repeated keys, the all-ones key, 3072 entries (three shared-memory
    tables), legacy 0/1 validity, classes outside the matrix and B =
    1000."""
    rng = np.random.default_rng(request.param)
    records, fastpaths = [], []
    for S, W in ((64, 4), (16, 2), (128, 8)):
        pool = parity.key_pool(rng, 4 * S, S)
        planes = parity.table_planes(rng, pool, S, W)
        records.append((planes, parity.table_batch(rng, pool, 512, W)))
        fastpaths.append((planes, parity.table_fastpath_batch(
            rng, pool, 300, 100, W, 4)))
    fastpaths += parity.table_fastpath_corners(rng, 1000, 4, 2500)
    records += parity.table_record_corners(rng, 1024)
    scans = [parity.scan_batch(rng, pool, 1000, 777),
             parity.scan_batch(rng, pool, 33, 1)]
    scans += parity.scan_corners(rng, 4096, 1024)
    keys = dict(hi=pool.hi, lo=pool.lo,
                slot_map=rng.integers(0, 7, 256).astype(np.int32))
    return keys, records, fastpaths, scans


@pytest.mark.parametrize("kernel", ["keyhash", "witness_record",
                                    "fastpath_record_scan", "conflict_scan"])
def test_table_kernel_matches_plain_version(cuda, table_case, kernel):
    results = parity.check_table_kernels(*table_case, device=cuda)
    torch.cuda.synchronize()
    got = {r.name: r for r in results}[kernel]
    assert got.outputs > 0
    assert got.max_abs_err == 0
    assert not got.missed, got.coverage


def test_redesigned_kernels_launch_once_per_call(cuda, case, table_case):
    """fastpath_record_scan, witness_record, gang_gc, conflict_scan,
    gang_record, gang_record_groups, txn_probe (one warp, and a block at
    K = 1024 and at 64 ways), witness_gc (G of 50, 1645 and 4096) and
    witness_record_seq (staged and walking global memory) each launch only
    their own kernel (no sort, no prep, no fill); gang_fastpath launches
    its own kernel and gang_record's, and no other."""
    from repro_torch.kernels import ops, ref

    def only(fn, *kernels):
        per_call = parity.launches_per_call(fn)
        assert len(per_call) == len(kernels), per_call
        for kernel in kernels:
            (n,) = [n for name, n in per_call.items() if kernel in name]
            assert 0 < n <= 1, per_call

    planes, fp = table_case[2][0]
    table = ref.witness_table_from_numpy(planes, cuda)
    args = ops.table_fastpath_operands(table, **fp)
    only(lambda: ops.fastpath_record_scan_cuda(table, *args),
         "fastpath_batch_kernel")
    planes, q = table_case[1][0]
    table = ref.witness_table_from_numpy(planes, cuda)
    args = ops.table_record_operands(table, **q)
    only(lambda: ops.witness_record_cuda(table, *args),
         "witness_record_kernel")
    args = ops.scan_operands(cuda, **table_case[3][0])
    only(lambda: ops.conflict_scan_cuda(*args), "conflict_scan_kernel")
    gang = ref.gang_from_numpy(case["planes"], cuda)
    args = ops.gc_operands(gang, S, **case["gc"])
    only(lambda: ops.gang_gc_cuda(gang, S, *args, True), "gang_gc_kernel")
    args = ops.record_operands(gang, S, **case["rec"])
    only(lambda: ops.gang_record_cuda(gang, S, *args), "gang_record_kernel")
    for c in (case["grp"], case["grp_corners"][0]["grp"]):
        args = ops.groups_operands(gang, S, **c)
        only(lambda: ops.gang_groups_cuda(gang, S, *args),
             "gang_groups_kernel")
    rng = np.random.default_rng(5)
    for K, W_, path in ((5, 4, "<true>"), (1024, 4, "<false>"),
                        (16, 64, "<false>")):
        table = ref.WitnessTable.empty(1024, W_, device=cuda)
        lanes = rng.integers(0, 2**32, (2, K), dtype=np.uint64)
        args = ops.txn_probe_operands(table, *lanes.astype(np.uint32))
        only(lambda: ops.txn_probe_cuda(table, *args), "txn_probe_kernel")
        (name,) = parity.launches_per_call(
            lambda: ops.txn_probe_cuda(table, *args))
        assert path in name or "<" not in name, name
    for g in (50, 1645, 4096):
        table = ref.WitnessTable.empty(1024, 4, device=cuda)
        lanes = rng.integers(0, 2**32, (2, 4096), dtype=np.uint64)
        ops.witness_record(table, *lanes.astype(np.uint32))
        args = ops.table_gc_operands(table, *lanes[:, :g].astype(np.uint32))
        only(lambda: ops.witness_gc_cuda(table, *args), "witness_gc_kernel")
    for s_, w_, staged in ((1024, 4, True), (4096, 8, False)):
        table = ref.WitnessTable.empty(s_, w_, device=cuda)
        assert ops.witness_record_seq_staged(table) == staged
        lanes = rng.integers(0, 2**32, (2, 512), dtype=np.uint64)
        args = ops.seq_operands(table, *lanes.astype(np.uint32))
        only(lambda: ops.witness_record_seq_cuda(table, *args),
             "witness_seq_kernel")

    gang = ref.gang_from_numpy(case["planes"], cuda)
    fpc = dict(case["fp"])
    rings = ref.ring_from_numpy(fpc.pop("ring_hi"), fpc.pop("ring_lo"),
                                fpc.pop("ring_cls"), cuda)
    args = ops.fastpath_operands(gang, S, **fpc)
    only(lambda: ops.gang_fastpath_cuda(gang, S, F, *args[:9], *rings,
                                        *args[9:]),
         "gang_fastpath_kernel", "gang_record_kernel")


def test_single_table_ops_on_the_card_match_the_cpu(cuda):
    from repro_torch.kernels import WitnessTable, fastpath_batch

    rng = np.random.default_rng(9)
    pool = parity.key_pool(rng, 1024, 256)
    fp = parity.table_fastpath_batch(rng, pool, 1000, 64, 4, 8)
    out = []
    for device in (cuda, "cpu"):
        res = fastpath_batch(WitnessTable.empty(256, 4, device=device),
                             fp["key_hi"], fp["key_lo"], fp["key_cls"],
                             window_hi=fp["window_hi"],
                             window_lo=fp["window_lo"],
                             window_valid=fp["window_valid"],
                             slot_map=fp["slot_map"])
        out.append(res)
    for a, b in zip(out[0][:5], out[1][:5]):
        np.testing.assert_array_equal(a, b)


def test_cluster_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core import ShardedCluster, WitnessGeometry

    def drive(device):
        c = ShardedCluster(n_shards=4, f=3, witness_backend="device",
                           geometry=WitnessGeometry(256, 4), seed=7,
                           sync_batch=10, device=device)
        s = c.new_client()
        out = []
        for r in range(6):
            ops = [s.op_set(f"k{(r * 7 + i) % 11}", f"v{r}") if i % 4
                   else s.op_incr(f"k{i % 5}") for i in range(16)]
            out += [(o.value, o.rtts, o.fast_path, o.synced_path,
                     o.witness_accepts) for o in c.update_batch(s, ops)]
        return out, c.gang.drain_counters()

    on_card, cnt_card = drive(cuda)
    on_cpu, cnt_cpu = drive("cpu")
    assert on_card == on_cpu
    np.testing.assert_array_equal(cnt_card, cnt_cpu)


def test_lone_update_records_its_witnesses_in_one_launch(cuda):
    """A lone update's f = 3 witness records are ONE K5 launch on the
    card, and its statuses, every gang table plane and the counter plane
    equal the CPU plain path's on the same ops: hot keys that conflict,
    merge-lattice INCRs, multi-key MSETs and RIFL retries."""
    from repro_torch.core import ShardedCluster, WitnessGeometry
    from repro_torch.kernels import ops

    def drive(device):
        c = ShardedCluster(n_shards=4, f=3, witness_backend="device",
                           geometry=WitnessGeometry(256, 4), seed=7,
                           sync_batch=1000, device=device)
        s = c.new_client()
        group = c.shards[0]
        keys = [f"k{i}" for i in range(400) if c.shard_of(f"k{i}") == 0]
        sub = s.session_for(0)
        statuses, launches, made = [], [], []
        for i in range(40):
            if i % 9 == 8:
                op = made[-1]
            elif i % 4 == 3:
                op = sub.op_mset([(keys[i % 5], i), (keys[5 + i % 7], i)])
            elif i % 4 == 2:
                op = sub.op_incr(keys[i % 3])
            else:
                op = sub.op_set(keys[i % 6], i)
            made.append(op)
            before = ops.GANG_GROUPS.launches
            _v, _r, st = group.attempt_update(op, sub.acks())
            launches.append(ops.GANG_GROUPS.launches - before)
            statuses.append([x.value for x in st])
        planes = [p.cpu() for p in c.gang.table]
        return statuses, launches, planes, c.gang.drain_counters(), \
            (group, made[0], sub.acks())

    on_card, launches, planes_card, cnt_card, (group, op, acks) = \
        drive(cuda)
    on_cpu, _l, planes_cpu, cnt_cpu, _ = drive("cpu")
    assert launches == [1] * len(launches)
    assert on_card == on_cpu
    assert {tuple(x) for x in on_card} >= {("ACCEPTED",) * 3,
                                           ("REJECTED",) * 3}
    for a, b in zip(planes_card, planes_cpu):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(cnt_card, cnt_cpu)
    per_call = parity.launches_per_call(
        lambda: group.attempt_update(op, acks))
    gang = {k: n for k, n in per_call.items() if "gang_" in k}
    assert gang and all("gang_groups_kernel" in k for k in gang), per_call
    assert 0 < sum(gang.values()) <= 1, per_call


@pytest.fixture(params=[0, 1])
def txn_case(request):
    """K9's chain over a 64x4 table near full, K10 at 64x4 and 256x1 with
    G of 0, 50 and 300 (more than one staged tile), K11 at 64x4 on an
    empty and a pre-filled table, at 16x40 (ways in two chunks), at 32x128
    (four chunks, a staged block of 512 threads), at 2048x4 (98,304 B
    staged in shared memory, over the 48 KB a block has without opting
    in) and at 4096x8 (393,216 B: global memory).  K9's corners
    (``parity.txn_corners``: 1024 keys in distinct sets, 64 in one set,
    every key own, repeated keys, padding only, 1 and 64 ways, the all-ones
    raw key, wide ops) and K10's (``parity.table_gc_corners``: no entries,
    one, 4096, one key repeated, the mixed all-ones key, zero keys, keys
    outside their set, 4096x1, 64x64, 512x3) come with them."""
    rng = np.random.default_rng(request.param)
    pool = parity.key_pool(rng, 512, 64)
    planes = parity.table_planes(rng, pool, 64, 4, fill=1.5)
    corners = dict(probe_corners=parity.txn_corners(rng),
                   gc_corners=parity.table_gc_corners(rng))
    probes = parity.txn_chain(rng, pool, planes, 300, max_keys=6,
                              own_frac=0.3, dup_frac=0.2)
    gcs = []
    for S, W in ((64, 4), (256, 1)):
        gp = parity.gc_planes(rng, parity.key_pool(rng, 4 * S * W, S), S, W)
        gcs += [(gp, parity.gc_entries(rng, gp, G)) for G in (0, 50, 300)]
    seqs = []
    for S, W, fill in ((64, 4, 0.0), (64, 4, 0.5), (16, 40, 0.5),
                       (32, 128, 0.5), (2048, 4, 0.5), (4096, 8, 0.5)):
        p = parity.key_pool(rng, 4 * S * W, S)
        seqs.append((parity.table_planes(rng, p, S, W, fill=fill),
                     parity.table_batch(rng, p, 1000, W)))
    return (planes, probes, gcs, seqs), corners


@pytest.mark.parametrize("kernel", ["txn_probe", "witness_gc",
                                    "witness_record_seq"])
def test_txn_kernel_matches_plain_version(cuda, txn_case, kernel):
    results = parity.check_txn_kernels(*txn_case[0], device=cuda,
                                       **txn_case[1])
    torch.cuda.synchronize()
    got = {r.name: r for r in results}[kernel]
    assert got.outputs > 0
    assert got.max_abs_err == 0
    assert not got.missed, got.coverage


def test_txn_stream_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core import ShardedCluster
    from repro_torch.sim import TxnWorkload

    def drive(device):
        c = ShardedCluster(n_shards=4, f=3, witness_backend="device",
                           seed=5, device=device)
        s = c.new_client()
        wl = TxnWorkload(n_shards=4, cross_shard_frac=0.5, keys_per_txn=3,
                         reads_per_txn=1, seed=9)
        out = []
        for _ in range(40):
            writes, reads = wl.next_txn()
            o = c.txn(s, writes, reads)
            out.append((o.status, o.rtts, o.fast_path, o.reads))
        return out, c.gang.drain_counters()

    on_card, cnt_card = drive(cuda)
    on_cpu, cnt_cpu = drive("cpu")
    assert on_card == on_cpu
    np.testing.assert_array_equal(cnt_card, cnt_cpu)


def test_reduced_decode_on_the_card_matches_the_cpu(cuda):
    """The reduced llama in f32 (TF32 off), one module's weights on both
    devices: 12 decode steps of 4 rows with a random active mask; logits
    within 1e-4 (f32 sums in other orders), pos and the tokens' argmax
    identical, and a serving driver on the card's device witness gang
    generating the CPU driver's tokens."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import (
        Transformer,
        decode_step,
        init_decode_cache,
        reduced,
    )
    from repro_torch.serving import CurpServeDriver, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(ARCHS["llama3.2-1b"])
    cpu = Transformer(cfg, device="cpu", seed=4)
    card = Transformer.from_state_dict(cfg, cpu.state_dict(), device=cuda)
    rng = np.random.default_rng(6)
    caches = {d: init_decode_cache(cfg, 4, 16, device=d)
              for d in ("cpu", cuda)}
    for _ in range(12):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1))).int()
        act = torch.from_numpy(rng.integers(0, 2, 4)).int()
        got, caches[cuda] = decode_step(cfg, card, {
            "tokens": toks.to(cuda), "active": act.to(cuda)}, caches[cuda])
        want, caches["cpu"] = decode_step(cfg, cpu, {
            "tokens": toks, "active": act}, caches["cpu"])
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-4)
    assert torch.equal(caches[cuda]["pos"].cpu(), caches["cpu"]["pos"])

    def serve(device, model):
        d = CurpServeDriver(cfg, ServeConfig(
            max_batch=4, max_seq=32, n_shards=2, witness_backend="device",
            device=device), params=model)
        d.submit("a", [5, 17, 99])
        d.submit("b", [1, 2])
        d.generate(6)
        return {sid: s.tokens for sid, s in d.sessions.items()}

    before = ops.GANG_FASTPATH.launches
    assert serve(cuda, card) == serve("cpu", cpu)
    assert ops.GANG_FASTPATH.launches >= before + 6


def test_reduced_hymba_decode_wraps_its_window_on_the_card(cuda):
    """hymba's SWA ring wrapping on the card: the reduced hymba (window 8,
    global layer 0, an SSM beside attention in every layer) in f32 (TF32
    off), one module's weights on both devices, 24 decode steps of 4 rows
    (all active for the first 10, then a random active mask), so every
    row decodes past its window and its ring slots are rewritten; logits
    within 1e-4 (f32 sums in other orders), pos and the tokens' argmax
    identical, and a serving driver on the card's device witness gang
    generating the CPU driver's tokens past the window."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import (
        Transformer,
        decode_step,
        init_decode_cache,
        reduced,
    )
    from repro_torch.serving import CurpServeDriver, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(ARCHS["hymba-1.5b"])
    assert cfg.swa_window == 8 and cfg.global_attn_layers == (0,)
    cpu = Transformer(cfg, device="cpu", seed=4)
    card = Transformer.from_state_dict(cfg, cpu.state_dict(), device=cuda)
    rng = np.random.default_rng(6)
    caches = {d: init_decode_cache(cfg, 4, 32, device=d)
              for d in ("cpu", cuda)}
    for i in range(24):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1))).int()
        act = torch.from_numpy(rng.integers(0, 2, 4) if i >= 10
                               else np.ones(4, np.int64)).int()
        got, caches[cuda] = decode_step(cfg, card, {
            "tokens": toks.to(cuda), "active": act.to(cuda)}, caches[cuda])
        want, caches["cpu"] = decode_step(cfg, cpu, {
            "tokens": toks, "active": act}, caches["cpu"])
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))
    assert torch.equal(caches[cuda]["pos"].cpu(), caches["cpu"]["pos"])
    assert int(caches["cpu"]["pos"].min()) > cfg.swa_window

    def serve(device, model):
        d = CurpServeDriver(cfg, ServeConfig(
            max_batch=4, max_seq=32, n_shards=2, witness_backend="device",
            device=device), params=model)
        d.submit("a", [5, 17, 99])
        d.submit("b", [1, 2])
        d.generate(12)
        return {sid: s.tokens for sid, s in d.sessions.items()}

    tokens = serve(cuda, card)
    assert tokens == serve("cpu", cpu)
    assert all(len(t) > cfg.swa_window for t in tokens.values())


def _against_eager(d, log):
    """Wrap the driver's ``_decode``: each step also runs eagerly, by
    ``decode_step`` on a clone of the driver's cache taken just before it,
    and ``log`` gathers (graph logits, eager logits, active mask, the
    caches' largest difference) after the step."""
    from repro_torch.models import cache_tensors, decode_step

    graph_decode = d._decode

    def clone(cache):
        return {"pos": cache["pos"].clone(), "segments": [
            {k: ({n: t.clone() for n, t in v.items()} if k == "ssm"
                 else v.clone()) for k, v in e.items()}
            for e in cache["segments"]]}

    def checked(host):
        twin = clone(d.cache)
        dev = torch.from_numpy(host).to(d.device)
        want, _ = decode_step(d.cfg, d.params, {
            "tokens": dev[0][:, None], "active": dev[1]}, twin)
        got = graph_decode(host)
        apart = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(cache_tensors(d.cache),
                                    cache_tensors(twin)))
        log.append((got, want, dev[1] > 0, apart))
        return got

    d._decode = checked


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b",
                                  "qwen2-moe-a2.7b"])
def test_serving_graph_matches_eager_decode_on_the_card(cuda, arch):
    """On the card the driver decodes by replaying one CUDA graph a step,
    captured at its first decode: every decode of a run (prompts fed, 24
    generated tokens, a crash and its re-prefill after 12) is one replay,
    counted on the driver, and is held against the same step run eagerly
    by ``decode_step`` on a clone of the cache: greedy tokens equal;
    logits and caches bit-equal for llama and hymba (the graph launches
    the eager step's kernels on the same inputs), within 1e-4 for the
    capacity MoE (f32, its scatter-adds are float atomics, order not
    fixed)."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.models import Transformer, reduced
    from repro_torch.serving import CurpServeDriver, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(ARCHS[arch])
    if cfg.has_moe:
        cfg = replace(cfg, moe_dispatch="capacity")
    d = CurpServeDriver(cfg, ServeConfig(
        max_batch=4, max_seq=32, n_shards=2, witness_backend="device",
        device=cuda), params=Transformer(cfg, device=cuda, seed=4))
    log = []
    _against_eager(d, log)
    d.submit("a", [5, 17, 99])
    d.submit("b", [1, 2])
    d.submit("c", [7, 7, 3, 12, 40])
    d.generate(12)
    assert d.crash_and_recover()["recovered_sessions"] == 3
    d.generate(12)
    assert d._graph is not None and d.graph_replays == len(log) > 24
    tol = 1e-4 if cfg.has_moe else 0.0
    for got, want, active, apart in log:
        assert torch.equal(got.argmax(-1)[active], want.argmax(-1)[active])
        assert float((got - want).abs().max()) <= tol
        assert apart <= tol
    assert all(len(s.tokens) > 24 for s in d.sessions.values())


def test_granite_serving_graph_matches_eager_decode_on_the_card(cuda):
    """Reduced granite-4.0-h-small in bf16 (Mamba2 and NoPE attention, one
    a layer; 8 experts top-2 by the capacity dispatch and a shared expert;
    the published multipliers), served through the driver: every decode
    is one replay of the captured graph, held against eager
    ``decode_step`` on a clone of the cache.  Greedy tokens equal where the
    eager top-2 margin exceeds 0.25, logits and caches within 0.25: the
    bound ``chip_smoke.py`` phase 7 holds a bf16 decode graph to
    (``BF16_LOGIT_TOL``; the graph runs the eager step's kernels, and only
    the dispatch's float atomic adds may sum in another order).  The
    driver counts every live pick, and the step's device counter at least
    one expert a layer in each step with a live row."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.telemetry import registry
    from repro_torch.models import Transformer, reduced
    from repro_torch.serving import CurpServeDriver, ServeConfig

    cfg = reduced(ARCHS["granite-4.0-h-small"], dtype="bfloat16",
                  moe_dispatch="capacity")
    state = Transformer(cfg, device=cuda, seed=4).state_dict()
    model = Transformer.from_state_dict(cfg, state, device="cuda")
    assert all(p.data_ptr() == state[n].data_ptr()      # adopted, no copy
               for n, p in model.named_parameters())
    d = CurpServeDriver(cfg, ServeConfig(
        max_batch=4, max_seq=32, n_shards=2, witness_backend="device",
        device=cuda), params=model)
    routed0 = registry().counter("moe.routed").value
    touched0 = registry().device_counter("moe.experts_touched").value
    log = []
    _against_eager(d, log)
    d.submit("a", [5, 17, 99])
    d.submit("b", [1, 2])
    d.submit("c", [7, 7, 3, 12, 40])
    d.generate(12)
    assert d.crash_and_recover()["recovered_sessions"] == 3
    d.generate(12)
    assert d._graph is not None and d.graph_replays == len(log) > 24
    tol = 0.25
    for got, want, active, apart in log:
        top2 = torch.topk(want[active], 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol
        assert torch.equal(got.argmax(-1)[active][sure],
                           want.argmax(-1)[active][sure])
        assert float((got - want)[active].abs().max()) <= tol
        assert apart <= tol
    live = sum(int(a.sum()) for _g, _w, a, _d in log)
    routed = registry().counter("moe.routed").value - routed0
    assert routed == live * cfg.top_k * cfg.n_layers
    touched = (registry().device_counter("moe.experts_touched").value
               - touched0)
    assert cfg.n_layers * sum(1 for _g, _w, a, _d in log if a.any()) \
        <= touched <= routed


def test_serving_graph_capture_refusal_raises(cuda, monkeypatch):
    """A decode step that cannot be captured (here one that reads a value
    back to the host mid-step) raises, naming the line that refused, at
    every decode: the driver never falls back to the eager step."""
    import repro_torch.serving.server as server
    from repro_torch.configs import ARCHS
    from repro_torch.models import reduced
    from repro_torch.serving import CurpServeDriver, ServeConfig

    real = server.decode_step

    def syncing(cfg, params, batch, cache):
        if int(batch["active"].sum()) < 0:       # a host sync
            raise AssertionError
        return real(cfg, params, batch, cache)

    monkeypatch.setattr(server, "decode_step", syncing)
    cfg = reduced(ARCHS["llama3.2-1b"])
    d = CurpServeDriver(cfg, ServeConfig(max_batch=2, max_seq=16,
                                         device=cuda), seed=0)
    host = np.array([[3, 0], [1, 0]], np.int32)
    for _ in range(2):
        with pytest.raises(RuntimeError,
                           match=r"cannot be captured.* at server\.py:\d+"):
            d._decode(host)
    assert d._graph is None and d.graph_replays == 0
    assert int(d.cache["pos"].abs().sum()) == 0
    monkeypatch.setattr(server, "decode_step", real)
    d._decode(host)
    assert d.graph_replays == 1 and d.cache["pos"].tolist() == [1, 0]


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b"])
def test_reduced_trainer_recovers_bit_exact_on_the_card(cuda, arch,
                                                        tmp_path):
    """A reduced trainer on the card (a dense model; a hybrid with SSM
    scans and single layers) trains 8 steps, crashes, restores the step-5
    backup, replays 3 journaled steps and trains to 13: its parameters
    and moments equal the uninterrupted run's bit for bit, and its losses
    are the CPU trainer's within 1e-4 relative (f32, TF32 off, sums in
    other orders)."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig
    from repro_torch.ft import FTConfig, FaultTolerantTrainer
    from repro_torch.ft.runner import state_digest
    from repro_torch.models import Transformer, reduced

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(ARCHS[arch])
    weights = Transformer(cfg, device="cpu", seed=2).state_dict()

    def trainer(name, device):
        return FaultTolerantTrainer(
            cfg, DataConfig(batch=2, seq=32),
            FTConfig(f=3, sync_every=5, workdir=tmp_path / name,
                     device=device),
            params=Transformer.from_state_dict(cfg, weights, device))

    a, b, c = trainer("a", cuda), trainer("b", cuda), trainer("c", "cpu")
    a.train(13)
    c.train(13)
    b.train(8)
    b.crash()
    rep = b.recover()
    assert rep["restored_step"] == 5 and rep["replayed"] == 3
    b.train(13 - b.step)
    assert b.params_digest() == a.params_digest()
    assert state_digest(b.opt_state) == state_digest(a.opt_state)
    assert a.params.embed.device.type == "cuda"
    np.testing.assert_allclose([m["loss"] for m in a.metrics_log],
                               [m["loss"] for m in c.metrics_log], rtol=1e-4)


# The Mamba2 state update (``ssm_update.cu``) against its plain version:
# (name, B, H, P, N, G, dtype).  granite-4.0-h-small's and hymba-1.5b's
# layers as served, heads sharing groups, and f32 (the reduced configs
# the card runs in f32 take the kernel too).
SSM_SHAPES = [
    ("granite", 16, 128, 64, 128, 1, torch.bfloat16),
    ("hymba", 8, 50, 64, 16, 1, torch.bfloat16),
    ("groups", 4, 8, 32, 128, 4, torch.bfloat16),
    ("f32", 4, 8, 16, 16, 2, torch.float32),
    ("f32-wide", 2, 4, 16, 128, 1, torch.float32),
]


def _ssm_operands(device, B, H, P, N, G, dtype, seed=0):
    """A state, its step's operands and an active mask with rows off.  B
    and C are views of one wider row laid out batch-fastest and xdt is
    permuted, as ``ssm_decode`` finds them after its conv's einsum."""
    g = torch.Generator().manual_seed(seed)

    def draw(*shape, lo=None):
        t = torch.randn(shape, generator=g)
        if lo is not None:
            t = lo + (1 - lo) * torch.rand(shape, generator=g)
        return t.to(device=device, dtype=dtype)

    row = draw(2 * G * N + 8, B).t()
    Bm = row[:, 8:8 + G * N].reshape(B, G, N)
    Cm = row[:, 8 + G * N:].reshape(B, G, N)
    xdt = (draw(P, H, B) * 0.5).permute(2, 1, 0)
    active = torch.ones(B, dtype=torch.int32)
    active[1::3] = 0
    return (draw(B, H, P, N), draw(B, H, lo=0.5), xdt, Bm, Cm,
            active.to(device))


@pytest.mark.parametrize("shape", SSM_SHAPES, ids=[s[0] for s in SSM_SHAPES])
def test_ssm_state_update_kernel_matches_plain_version(cuda, shape):
    """The kernel's state is the plain path's bit for bit (the same
    products and sum, each rounded where the plain path rounds), active
    rows updated and inactive ones untouched, in one launch.  y is read
    out of the new state for every row and may differ only by the order
    of its f32 sum: each side rounds that sum once to the state's type
    (2^-8 of |y| each in bf16) and two f32 sums of N <= 128 terms in other
    orders part by at most 2 x 128 x 2^-24 of the terms' absolute sum,
    hence |y - y_plain| <= 2^-7 |y_plain| + 2^-14 sum_n |new C|."""
    from repro_torch.kernels import ops
    from repro_torch.models.ssm import ssm_state_update_plain

    _name, B, H, P, N, G, dtype = shape
    state, dA, xdt, Bm, Cm, active = _ssm_operands(cuda, B, H, P, N, G,
                                                   dtype)
    want, y_want = ssm_state_update_plain(state, dA, xdt, Bm, Cm, active)
    new_all, _ = ssm_state_update_plain(state, dA, xdt, Bm, Cm, None)
    got = state.clone()
    before = ops.SSM_UPDATE.launches
    y = ops.ssm_state_update_cuda(got, dA, xdt, Bm, Cm, active)
    torch.cuda.synchronize()
    assert ops.SSM_UPDATE.launches == before + 1
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    off = active == 0
    assert torch.equal(got[off].view(bits), state[off].view(bits))
    assert not torch.equal(got[~off], state[~off])
    Ch = Cm.repeat_interleave(H // G, dim=1).float()
    terms = (new_all.float() * Ch[:, :, None, :]).abs().sum(-1)
    gap = (y.float() - y_want.float()).abs()
    assert bool((gap <= 2**-7 * y_want.float().abs()
                 + 2**-14 * terms).all()), float(gap.max())


def test_granite_decode_step_updates_each_mamba_state_in_one_launch(cuda):
    """granite-4.0-h-small at its published widths and four layers
    (Mamba2, attention, Mamba2, Mamba2), 16 rows as served, in bf16: one
    eager ``decode_step`` launches the state-update kernel once a Mamba2
    layer, and no PyTorch operation reads a state-sized tensor (the plain
    path's multiplies, sum, read-out, ``where`` and copy back are gone)."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer, decode_step, init_decode_cache

    cfg = replace(ARCHS["granite-4.0-h-small"], n_layers=4,
                  layer_types=("mamba", "attention", "mamba", "mamba"),
                  dtype="bfloat16", moe_dispatch="capacity")
    model = Transformer(cfg, device=cuda, seed=1)
    B = 16
    cache = init_decode_cache(cfg, B, 64, device=cuda)
    rng = np.random.default_rng(3)

    def step():
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).int()
        act = torch.ones(B, dtype=torch.int32)
        act[5] = 0
        decode_step(cfg, model, {"tokens": toks.to(cuda),
                                 "active": act.to(cuda)}, cache)

    step()                                     # builds and loads the kernel
    torch.cuda.synchronize()
    before = ops.SSM_UPDATE.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    assert ops.SSM_UPDATE.launches == before + 3
    state_shape = [B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state]
    assert state_shape == [16, 128, 64, 128]
    readers = {e.name for e in prof.events()
               if state_shape in [list(s) for s in e.input_shapes]
               and e.kernels}
    assert not readers, readers
    launched = sum(e.count for e in prof.key_averages()
                   if "ssm_update_kernel" in e.key)
    assert launched == 3, launched


def test_driver_counts_fused_state_updates_on_the_card(cuda):
    """``ssm.fused_updates``: the driver adds the captured step's Mamba2
    layers (three in the reduced granite) at every replay."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.telemetry import registry
    from repro_torch.models import Transformer, reduced
    from repro_torch.serving import CurpServeDriver, ServeConfig

    cfg = reduced(ARCHS["granite-4.0-h-small"], dtype="bfloat16",
                  moe_dispatch="capacity")
    d = CurpServeDriver(cfg, ServeConfig(max_batch=4, max_seq=32,
                                         device=cuda),
                        params=Transformer(cfg, device=cuda, seed=2))
    counter = registry().counter("ssm.fused_updates")
    before = counter.value
    d.submit("a", [5, 17, 99])
    d.generate(4)
    assert d.graph_replays == 6
    assert counter.value - before == 3 * d.graph_replays


# One layer's decode attention (``decode_attn.cu``) against the plain path:
# (name, B, C, Hkv, rep, dh, positions of the first rows).  hymba-1.5b's
# global and window layers and granite-4.0-h-small's as served, and the
# reduced configs' head size; each with rows at 0, C - 1, exactly C, past C
# (wrapped) and at the served windows' lengths; and the most query heads a
# KV head may serve, whose f32 scores outgrow shared memory past 6,400 slots.
ATTN_SHAPES = [
    ("hymba-global", 8, 16384, 5, 5, 64, (0, 16383, 16384, 40000, 1, 1700)),
    ("hymba-window", 8, 1024, 5, 5, 64, (0, 1023, 1024, 1700, 600, 5)),
    ("granite", 16, 8192, 8, 4, 128, (0, 8191, 8192, 20000, 600, 550, 1)),
    ("rep8", 16, 8192, 8, 8, 128, (0, 8191, 8192, 7000, 6000)),
    ("reduced", 4, 32, 2, 2, 16, (0, 31, 32, 70)),
]


def _attn_case(cuda, shape, dtype):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import parity
    from repro_torch.models import reduced
    from repro_torch.models.layers import attn_scale

    _name, B, C, Hkv, rep, dh, positions = shape
    scale = attn_scale(reduced(ARCHS["llama3.2-1b"]), dh)
    return (*parity.decode_attention_case(B, C, Hkv, rep, dh, dtype, cuda,
                                          positions, scale, seed=C + dh),
            scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=[s[0] for s in ATTN_SHAPES])
def test_decode_attention_kernel_matches_plain_version(cuda, shape, dtype):
    """The kernel against ``sdpa_decode_plain`` (``_sdpa`` under the ring's
    mask) on the same card tensors, in one launch, within the bound its
    arithmetic allows (``parity.decode_attention_bound``: the two differ
    only in the order of their f32 sums, which may move a score by an ulp
    of the type and p by the factor that follows) and within
    ``parity.DECODE_ATTENTION_AGREEMENT`` (the share of elements bit-equal
    and the rms gap, which a kernel one slot short or rounding p elsewhere
    fails).  Exactly: a row at position 0 returns its one slot's V; the
    slots a row does not hold are never read (other values there leave o
    bit-equal); the first and the newest live slots are read.  rep 8 in
    f32 exceeds the shared memory for its scores past 6,400 slots (200 KiB
    over 8 heads of 4 bytes), so its longest rows take the path that
    recomputes them."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops, parity
    from repro_torch.models import reduced
    from repro_torch.models.layers import attn_scale, sdpa_decode_plain

    q, k, v, pos, scale = _attn_case(cuda, shape, dtype)
    B, C, Hkv, dh = k.shape
    rep = q.shape[2] // Hkv
    cfg = reduced(ARCHS["llama3.2-1b"])
    assert attn_scale(cfg, dh) == scale
    before = ops.DECODE_ATTN.launches
    got = ops.decode_attention_cuda(q, k, v, pos, scale)
    torch.cuda.synchronize()
    assert ops.DECODE_ATTN.launches == before + 1
    want = sdpa_decode_plain(cfg, q, k, v, pos)
    tol = parity.decode_attention_bound(q, k, v, pos, scale, want)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= tol).all()), (float(gap.max()),
                                      float((gap / tol).max()))
    assert parity.decode_attention_agrees(got, want), \
        parity.decode_attention_agreement(got, want)
    n = parity.live_slots(pos, C)
    if shape[0] == "rep8":
        assert int(n.max()) > 200 * 1024 // (rep * 4)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    first = (pos == 0).nonzero()[:, 0]
    assert len(first) and torch.equal(
        got[first].view(bits),
        v[first, 0].repeat_interleave(rep, dim=1)[:, None].view(bits))
    dead = torch.arange(C, device=cuda)[None, :] >= n[:, None]
    k2, v2 = k.clone(), v.clone()
    k2[dead], v2[dead] = -k2[dead], 7.0
    assert torch.equal(ops.decode_attention_cuda(q, k2, v2, pos, scale)
                       .view(bits), got.view(bits))
    rows = torch.arange(B, device=cuda)
    for slot in (n - 1, torch.zeros_like(n)):
        v3 = v.clone()
        v3[rows, slot.long()] = 1e5
        moved = ops.decode_attention_cuda(q, k, v3, pos, scale) != got
        assert bool(moved.reshape(B, Hkv * rep, dh).any(-1).all())


def test_attention_decode_on_the_card_matches_the_plain_path(cuda,
                                                             monkeypatch):
    """``attention_decode`` at hymba-1.5b's published widths in bf16 (a
    window ring of 1024, rows wrapped and not, two of eight inactive):
    through the kernel and through the plain path on clones of one cache.
    The ring writes are the same bits (inactive rows untouched), and the
    layer's output differs only within the attention's bound carried
    through ``wo``; inactive rows are computed as the plain path computes
    them."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops, parity
    from repro_torch.models import layers
    from repro_torch.models.layers import Attention, Init, attention_decode

    cfg = ARCHS["hymba-1.5b"]
    B, C, Hkv, dh = 8, cfg.swa_window, cfg.n_kv_heads, cfg.d_head
    attn = Attention(cfg, Init(cuda, torch.bfloat16, seed=3))
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((B, 1, cfg.d_model), generator=gen, device=cuda).to(
        torch.bfloat16)
    kc = torch.randn((B, C, Hkv, dh), generator=gen, device=cuda).to(
        torch.bfloat16)
    vc = torch.randn_like(kc)
    pos = torch.tensor([0, 1, 500, 1022, 1023, 1024, 1700, 3000],
                       dtype=torch.int32, device=cuda)
    active = torch.tensor([1, 0, 1, 1, 1, 0, 1, 1], dtype=torch.int32,
                          device=cuda)
    positions = pos[:, None]
    caches = [(kc.clone(), vc.clone()) for _ in range(2)]
    before = ops.DECODE_ATTN.launches
    got, (k1, v1) = attention_decode(cfg, attn, x, caches[0], pos,
                                     positions, False, active)
    assert ops.DECODE_ATTN.launches == before + 1
    seen = {}

    def plain(q, kc, vc, cur_pos, scale):
        seen.update(q=q, scale=scale)
        return layers.sdpa_decode_plain(cfg, q, kc, vc, cur_pos)

    monkeypatch.setattr(layers, "decode_attention_cuda", plain)
    want, (k2, v2) = attention_decode(cfg, attn, x, caches[1], pos,
                                      positions, False, active)
    assert ops.DECODE_ATTN.launches == before + 1
    for a, b in ((k1, k2), (v1, v2)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    off = active == 0
    assert torch.equal(k1[off], kc[off]) and torch.equal(v1[off], vc[off])
    o = layers.sdpa_decode_plain(cfg, seen["q"], k2, v2, pos)
    tol_o = parity.decode_attention_bound(seen["q"], k2, v2, pos,
                                          seen["scale"], o)
    # the output projection in bf16: its inputs' gap through |wo|, and
    # each side's rounding of its sum (2^-8 of sum |o wo| each, and as
    # much again where the GEMM reduces in bf16)
    wo = attn.wo.float().abs()
    terms = o.float().reshape(B, -1).abs() @ wo
    tol = (tol_o.reshape(B, -1) @ wo) * (1 + 2 ** -6) + 2 ** -6 * terms
    gap = (got.float() - want.float()).abs().reshape(B, -1)
    assert bool((gap <= tol).all()), float((gap / tol).max())


@pytest.mark.parametrize("arch", ["granite-4.0-h-small", "hymba-1.5b"])
def test_decode_step_attends_each_layer_in_one_launch(cuda, arch):
    """granite-4.0-h-small at its published widths and four layers (one
    attention) and hymba-1.5b whole (32 attention layers, three of them on
    a 16384 ring), rows as served, in bf16, part way into their windows:
    one eager ``decode_step`` launches the attention kernel once an
    attention layer, and no PyTorch operation that launches work reads a
    cache-sized tensor other than the ring write's gather and scatter of
    each row's one slot (the einsums' copies of K and V, the scores, the
    mask's ``where`` and the softmax over every slot are gone)."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer, decode_step, init_decode_cache
    from repro_torch.models.config import layer_has_attn

    if arch == "hymba-1.5b":
        cfg, B, max_seq = replace(ARCHS[arch], dtype="bfloat16"), 8, 16384
    else:
        cfg = replace(ARCHS[arch], n_layers=4,
                      layer_types=("mamba", "attention", "mamba", "mamba"),
                      dtype="bfloat16", moe_dispatch="capacity")
        B, max_seq = 16, 8192
    n_attn = sum(layer_has_attn(cfg, i) for i in range(cfg.n_layers))
    assert n_attn == (32 if arch == "hymba-1.5b" else 1)
    model = Transformer(cfg, device=cuda, seed=1)
    cache = init_decode_cache(cfg, B, max_seq, device=cuda)
    cache["pos"].copy_(torch.arange(B, dtype=torch.int32) * 97 + 500)
    rng = np.random.default_rng(3)

    def step():
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).int()
        act = torch.ones(B, dtype=torch.int32)
        act[5] = 0
        decode_step(cfg, model, {"tokens": toks.to(cuda),
                                 "active": act.to(cuda)}, cache)

    step()                                     # builds and loads the kernel
    torch.cuda.synchronize()
    before = ops.DECODE_ATTN.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    assert ops.DECODE_ATTN.launches == before + n_attn
    rings = {tuple(t.shape[1:]) for e in cache["segments"] if "k" in e
             for t in (e["k"], e["v"])}
    readers = {e.name for e in prof.events()
               if rings & {tuple(s) for s in e.input_shapes} and e.kernels}
    assert readers <= {"aten::index", "aten::index_put_",
                       "aten::_index_put_impl_"}, readers
    launched = sum(e.count for e in prof.key_averages()
                   if "decode_attn_kernel" in e.key)
    assert launched == n_attn, launched


@pytest.mark.parametrize("arch", ["granite-4.0-h-small", "hymba-1.5b"])
def test_driver_counts_fused_decode_attentions_on_the_card(cuda, arch):
    """``attn.fused_decodes``: the driver adds the captured step's attention
    layers (one in the reduced granite, two in the reduced hymba) at every
    replay."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.telemetry import registry
    from repro_torch.models import Transformer, reduced
    from repro_torch.serving import CurpServeDriver, ServeConfig

    cfg = reduced(ARCHS[arch], dtype="bfloat16")
    if cfg.has_moe:
        cfg = reduced(ARCHS[arch], dtype="bfloat16", moe_dispatch="capacity")
    d = CurpServeDriver(cfg, ServeConfig(max_batch=4, max_seq=32,
                                         device=cuda),
                        params=Transformer(cfg, device=cuda, seed=2))
    counter = registry().counter("attn.fused_decodes")
    before = counter.value
    d.submit("a", [5, 17, 99])
    d.generate(4)
    assert d.graph_replays == 6
    per_step = 1 if cfg.layer_types else cfg.n_layers
    assert counter.value - before == per_step * d.graph_replays


def test_captured_decode_attention_survives_launches_of_other_shapes(cuda):
    """A CUDA graph holding the kernel at hymba's global ring (the most
    shared memory a launch takes) replays bit-equal to an eager launch
    after launches at its window ring and at the reduced configs' head
    size, which need far less: no later launch lowers what the captured
    one may take."""
    from repro_torch.kernels import ops, parity

    big = _attn_case(cuda, ATTN_SHAPES[0], torch.bfloat16)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.decode_attention_cuda(*big)               # built and planned
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            held = ops.decode_attention_cuda(*big)
    torch.cuda.current_stream().wait_stream(stream)
    for shape in ATTN_SHAPES[1:]:
        ops.decode_attention_cuda(*_attn_case(cuda, shape, torch.bfloat16))
    graph.replay()
    want = ops.decode_attention_cuda(*big)
    torch.cuda.synchronize()
    assert torch.equal(held.view(torch.int16), want.view(torch.int16))
    assert parity.live_slots(big[3], big[1].shape[1]).max() > 1


def test_kanana_serving_graph_matches_eager_decode_on_the_card(cuda):
    """Reduced kanana-2-30b-a3b in bf16 (multi-head latent attention over
    the latent cache, one dense layer, 8 experts top-2 by the sigmoid
    router with its correction bias, capacity dispatch, a shared expert),
    served through the driver: every decode is one replay of the captured
    graph, held against eager ``decode_step`` on a clone of the cache, to
    the bound of the granite test above (0.25 on logits and caches, tokens
    equal where the eager top-2 margin exceeds it: only the dispatch's
    float atomic adds may sum in another order).  The MLA layers never
    launch A1, and the driver counts their latent slots and the MoE
    layers' picks (the dense layer routes nothing)."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.telemetry import registry
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer, reduced
    from repro_torch.serving import CurpServeDriver, ServeConfig

    cfg = reduced(ARCHS["kanana-2-30b-a3b"], dtype="bfloat16",
                  moe_dispatch="capacity")
    model = Transformer(cfg, device=cuda, seed=4)
    with torch.no_grad():                 # a bias that moves some picks
        for block in model.blocks[cfg.first_k_dense:]:
            block.moe.correction_bias.normal_(0.0, 0.2)
    d = CurpServeDriver(cfg, ServeConfig(
        max_batch=4, max_seq=32, n_shards=2, witness_backend="device",
        device=cuda), params=model)
    names = ("moe.routed", "mla.slots_read", "mla.slots_live")
    before = {n: registry().counter(n).value for n in names}
    launched = ops.DECODE_ATTN.launches
    log = []
    _against_eager(d, log)
    d.submit("a", [5, 17, 99])
    d.submit("b", [1, 2])
    d.submit("c", [7, 7, 3, 12, 40])
    d.generate(12)
    assert d.crash_and_recover()["recovered_sessions"] == 3
    d.generate(12)
    assert d._graph is not None and d.graph_replays == len(log) > 24
    assert [set(e) for e in d.cache["segments"]] == [{"latent"}]
    assert ops.DECODE_ATTN.launches == launched
    tol = 0.25
    for got, want, active, apart in log:
        top2 = torch.topk(want[active], 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol
        assert torch.equal(got.argmax(-1)[active][sure],
                           want.argmax(-1)[active][sure])
        assert float((got - want)[active].abs().max()) <= tol
        assert apart <= tol
    live = sum(int(a.sum()) for _g, _w, a, _d in log)
    got = {n: registry().counter(n).value - before[n] for n in names}
    assert got["moe.routed"] == live * cfg.top_k * (cfg.n_layers
                                                    - cfg.first_k_dense)
    assert got["mla.slots_read"] == len(log) * cfg.n_layers * 4 * 32
    assert 0 < got["mla.slots_live"] < got["mla.slots_read"]


def _mla_expanded(cfg, attn, x, latent, cur_pos, scale, short=0):
    """One token's MLA in the expanded form, in f32 from the same bf16
    values: per head K = [latent W_UK, k_pe], V = latent W_UV, over each
    row's valid slots (``short`` fewer: a planted fault)."""
    from repro_torch.models.layers import mla_query

    B, C, _ = latent.shape
    H, dn, dv, r = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim,
                    cfg.kv_lora_rank)
    f32 = {n: t.float() for n, t in attn.named_parameters()}
    q_nope, q_pe = mla_query(cfg, attn, x, cur_pos[:, None])
    q = torch.cat([q_nope, q_pe], -1)[:, 0].float()          # [B, H, 192]
    w_kv = f32["wkv_b"].view(r, H, dn + dv)
    out = torch.empty((B, H * dv), device=x.device)
    for b in range(B):
        n = min(int(cur_pos[b]) + 1, C)
        n -= short if n > 1 else 0
        lat = latent[b, :n].float()
        k = torch.cat([torch.einsum("tr,rhn->thn", lat[:, :r],
                                    w_kv[..., :dn]),
                       lat[:, None, r:].expand(n, H, -1)], -1)
        v = torch.einsum("tr,rhv->thv", lat[:, :r], w_kv[..., dn:])
        p = torch.softmax(torch.einsum("hd,thd->ht", q[b], k) * scale, -1)
        out[b] = torch.einsum("ht,thv->hv", p, v).reshape(-1)
    return out @ f32["wo"]


def test_mla_decode_at_the_cells_shape_matches_the_expanded_form(cuda):
    """One MLA decode layer at kanana's published widths and the cell's
    shape (32 rows x 4096 latent slots of 512 + 64, bf16; rows at 0, 1,
    mid, full and wrapped, a quarter inactive) against the expanded form
    in f32 on the same bf16 values.  The cache write is the new latent
    row at ``cur_pos % C`` for active rows and nothing else.  Tolerance:
    each row's rms gap at most 2^-5 of its output's rms, room for the absorbed
    path's seven bf16 roundings in series (q, q_lat, the cache row,
    probabilities, o_lat, o, the output; 2^-9 relative each) carried
    through sums of thousands of terms; one slot short or the scale
    1/sqrt(128) reads well past it, checked here."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.layers import MLA, Init, mla_decode, mla_latent

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["kanana-2-30b-a3b"]
    B, C = 32, 4096
    attn = MLA(cfg, Init(cuda, torch.bfloat16, seed=3))
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((B, 1, cfg.d_model), generator=gen, device=cuda).to(
        torch.bfloat16)
    latent = torch.randn((B, C, cfg.latent_width), generator=gen,
                         device=cuda).to(torch.bfloat16)
    pos = torch.tensor([0, 1, 2, 100, 700, 900, 2047, 4094, 4095, 4096, 5000,
                        9000] + list(range(300, 300 + 20 * 37, 37)),
                       dtype=torch.int32, device=cuda)
    active = (torch.arange(B, device=cuda) % 4 != 3).to(torch.int32)
    before = latent.clone()
    with torch.no_grad():
        got = mla_decode(cfg, attn, x, latent, pos, pos[:, None], active)
        row = mla_latent(cfg, attn, x, pos[:, None])[:, 0]
        slot = (pos % C).long()
        b = torch.arange(B, device=cuda)
        want_cache = before.clone()
        want_cache[b[active > 0], slot[active > 0]] = row[active > 0]
        assert torch.equal(latent.view(torch.int16),
                           want_cache.view(torch.int16))
        gaps = {}
        for name, scale, short in (("sound", cfg.d_head ** -0.5, 0),
                                   ("short", cfg.d_head ** -0.5, 1),
                                   ("scale", 128 ** -0.5, 0)):
            want = _mla_expanded(cfg, attn, x, latent, pos, scale, short)
            gaps[name] = float(((got[:, 0].float() - want).pow(2).mean(-1)
                                / want.pow(2).mean(-1)).sqrt().max())
    assert gaps["sound"] <= 2 ** -5, gaps
    assert min(gaps["short"], gaps["scale"]) > 4 * 2 ** -5, gaps
