"""Each plain reference agrees with repro_torch's CPU path at small
sizes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import small_hymba, small_kv
from perfbench import run as bench_run
from perfbench.entries import serve
from perfbench.reference import hymba as ref_hymba
from perfbench.reference.kv import KVReference, keyhash, mix_lo, mix_lo_ranks


def test_kv_placement_matches_the_program():
    from repro_torch.core.shard import SlotRouter, mix2x32
    from repro_torch.core.types import keyhash as program_keyhash

    router = SlotRouter.uniform(64, 256)
    ref = KVReference(64, 3, 1024, 4, 50, 256)
    for k in range(2000):
        key = f"user{k}"
        kh = program_keyhash(key)
        assert keyhash(key) == kh
        assert mix_lo(kh) == mix2x32(kh >> 32, kh & 0xFFFFFFFF)[1]
        assert ref.place(key)[0] == router.shard_of(key)


def test_kv_placement_of_many_ranks_is_the_scalar_one():
    from repro_torch.core.shard import SlotRouter

    n = 1_000_000
    m = mix_lo_ranks("user", n)
    idx = np.r_[0:1200, 9990:10010, 99990:100010, n - 10:n,
                np.random.default_rng(3).integers(0, n, 2000)]
    assert all(int(m[i]) == mix_lo(keyhash(f"user{i}")) for i in idx)
    ref = KVReference(64, 3, 1024, 4, 50, 256)
    router = SlotRouter.uniform(64, 256)
    shards = ref.shards_of_ranks("user", 3000)
    assert [router.shard_of(f"user{k}") for k in range(3000)] \
        == shards.tolist()


def test_kv_reference_starts_loaded():
    ref = KVReference(4, 3, 64, 4, 50, 256)
    keys = [f"user{k}" for k in range(100)]
    ref.load(keys, [f"v{k}" for k in range(100)],
             ref.shards_of_ranks("user", 100))
    assert ref.read("user7") == "v7" and ref.read("user100") is None
    ref.update("user7", "w")
    ref.update("new", "x")
    parts = ref.by_shard()
    assert sum(len(p) for p in parts) == 101
    assert parts[ref.place("user7")[0]]["user7"] == "w"
    assert parts[ref.place("new")[0]]["new"] == "x"
    assert ref.written == {"user7", "new"}


@pytest.mark.parametrize("workload,n_shards,records", [
    ("ycsb-a.batched", 4, 2000),      # crash mid-window; FULL and CONFLICT
    ("ycsb-a.batched", 16, 100_000),
    ("ycsb-a.lone", 4, 2000),
    ("ycsb-b.batched", 16, 100_000),
])
def test_kv_reference_agrees_with_the_cpu_path(workload, n_shards, records):
    res, run = bench_run.execute(
        workload, 2**31 + 99, 1.0, False, device="cpu",
        config_overrides=lambda c: small_kv(c, n_shards, records))
    assert run.correct, res["compared"]
    assert run.counts["updates"] > 0
    assert 0 < run.counts["fast_updates"] < run.counts["updates"]
    if run.traffic.get("crash_at") is not None:
        assert len(run.samples["recovery_s"]) == 1


def _small_model(dtype="float32"):
    c = small_hymba({"model": dict(
        n_layers=32, d_model=1600, vocab=32001, n_heads=25, n_kv_heads=5,
        d_head=64, attn="swa", swa_window=1024, global_attn_layers=[0, 15, 31],
        pos="rope", rope_theta=10000.0, d_ff=5504, act="swiglu", ssm=True,
        ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_groups=1, ssm_conv=4,
        ssm_chunk=64, norm_eps=1e-5, dtype="bfloat16", remat=False,
        name="hymba-1.5b", family="hybrid"), "serve": {}}, dtype)
    return c["model"]


def test_hymba_reference_matches_the_program_forward():
    from repro_torch.models.transformer import Transformer, forward

    m = _small_model()
    cfg = serve._model_config(m)
    state = serve.make_weights(m, 2**32 + 3, "cpu", torch.float32)
    model = Transformer.from_state_dict(cfg, state, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 256, 48))
    with torch.no_grad():
        want = forward(cfg, model, {"tokens": tokens[None]})[0][0]
        got = ref_hymba.forward_logits(m, lambda n: state[n].float(), tokens)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4


def test_hymba_fp8_control_departs_from_f32():
    m = _small_model()
    state = serve.make_weights(m, 7, "cpu", torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 256, 24))
    with torch.no_grad():
        f32 = ref_hymba.forward_logits(m, lambda n: state[n], tokens)
        fp8 = ref_hymba.forward_logits(m, lambda n: state[n], tokens, "fp8")
    assert 1e-3 < float((f32 - fp8).abs().max()) < 5.0


def test_served_gap_reads_the_served_tokens():
    logits = torch.tensor([[0.0, 1.0, 3.0], [2.0, 0.5, 0.0],
                           [0.0, 0.0, 0.0]])
    tokens = torch.tensor([1, 2, 1])
    # Logits at position t judge token t + 1; from ``first`` on they are
    # served: token 2 at position 0 (gap 0), token 1 at position 1 (1.5).
    assert ref_hymba.served_gap(logits, tokens, first=0) == 1.5
    assert ref_hymba.served_gap(logits, tokens, first=1) == 1.5
    pick = torch.tensor([2, 0, 0])
    assert ref_hymba.served_gap(logits, tokens, first=0, pick=pick) == 0.0


def test_serve_cell_on_the_cpu_path_is_correct():
    res, run = bench_run.execute(
        "hymba.decode", 2**31 + 5, 1.0, False, device="cpu",
        config_overrides=small_hymba)
    assert run.correct, res["compared"]
    assert run.counts["tokens"] > 8 * 20
    gap = dict((n, v) for n, v, _l in run.checks)["served_logit_gap"]
    assert gap < 1e-4
