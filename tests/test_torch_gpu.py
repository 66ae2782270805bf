"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (decided in the
fixture, so every pytest-xdist worker collects the same tests).  On the card
each kernel is built from ``src/repro_torch/kernels/csrc`` and must agree bit
for bit with its plain version on identical inputs; ``chip_smoke.py`` does
the same at full size.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import parity

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
    )


@pytest.mark.parametrize("kernel", ["gang_record", "gang_record_groups",
                                    "gang_gc", "gang_fastpath"])
def test_kernel_matches_plain_version(cuda, case, kernel):
    results = parity.check_kernels(case["planes"], S, case["rec"],
                                   case["grp"], case["gc"], case["fp"], F,
                                   device=cuda)
    torch.cuda.synchronize()
    got = {r.name: r for r in results}[kernel]
    assert got.outputs > 0
    assert got.max_abs_err == 0
    assert not got.missed, got.coverage


@pytest.fixture(params=[0, 1])
def table_case(request):
    """Single-table inputs at 64x4, 16x2 and 128x8, with K8 at a batch and
    window that are not tile multiples."""
    rng = np.random.default_rng(request.param)
    records, fastpaths = [], []
    for S, W in ((64, 4), (16, 2), (128, 8)):
        pool = parity.key_pool(rng, 4 * S, S)
        planes = parity.table_planes(rng, pool, S, W)
        records.append((planes, parity.table_batch(rng, pool, 512, W)))
        fastpaths.append((planes, parity.table_fastpath_batch(
            rng, pool, 300, 100, W, 4)))
    scans = [parity.scan_batch(rng, pool, 1000, 777),
             parity.scan_batch(rng, pool, 33, 1)]
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
