"""A run with the timed path broken underneath comes out not correct: the
look for a card skipped, the rest of a run driven at a small size on the
CPU.  One test per fault the cells can have, and the controls."""
from __future__ import annotations

import pytest

from conftest import small_hymba, small_kv
from perfbench import run as bench_run


def kv_run(workload="ycsb-a.batched", control=False, n_shards=4):
    return bench_run.execute(
        workload, 2**31 + 17, 1.0, False, device="cpu",
        config_overrides=lambda c: small_kv(c, n_shards), control=control)[1]


def serve_run(control=False, dtype="float32"):
    return bench_run.execute(
        "hymba.decode", 2**31 + 23, 1.0, False, device="cpu",
        config_overrides=lambda c: small_hymba(c, dtype),
        control=control)[1]


def compared(run):
    return {n: v for n, v, _lim in run.checks}


@pytest.mark.parametrize("workload", ["ycsb-a.batched", "ycsb-a.lone"])
def test_kv_update_that_leaves_the_store_unchanged(monkeypatch, workload):
    from repro_torch.core.store import KVStore

    execute = KVStore.execute

    def lost(self, op, now=0.0):
        if op.op_type.name == "SET":
            return "OK"
        return execute(self, op, now)
    monkeypatch.setattr(KVStore, "execute", lost)
    run = kv_run(workload)
    assert not run.correct
    assert compared(run)["read_mismatches"] > 0


def test_kv_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.core.shard import ShardedCluster

    update_batch = ShardedCluster.update_batch

    def half(self, session, ops, now=0.0):
        n = len(ops) // 2
        out = update_batch(self, session, ops[:n], now)
        return out + out[:len(ops) - n] if out else out
    monkeypatch.setattr(ShardedCluster, "update_batch", half)
    run = kv_run()
    assert not run.correct
    assert compared(run)["readback_mismatches"] > 0


@pytest.mark.parametrize("workload", ["ycsb-a.batched", "ycsb-b.batched"])
def test_kv_answer_altered_where_it_is_produced(monkeypatch, workload):
    from repro_torch.core.shard import ShardedCluster

    read = ShardedCluster.read

    def altered(self, session, op, now=0.0):
        out = read(self, session, op, now)
        if out.value is not None and op.keys[0].endswith("7"):
            out.value = out.value[::-1]
        return out
    monkeypatch.setattr(ShardedCluster, "read", altered)
    run = kv_run(workload)
    assert not run.correct
    assert compared(run)["read_mismatches"] > 0


def test_kv_verdict_altered_where_it_is_produced(monkeypatch):
    from repro_torch.core.device_witness import DeviceWitness

    settle = DeviceWitness._settle

    def accept_all(self, reason, *a):
        return settle(self, 1 if reason == 4 else reason, *a)
    monkeypatch.setattr(DeviceWitness, "_settle", accept_all)
    run = kv_run()
    assert not run.correct
    assert compared(run)["outcome_mismatches"] > 0


@pytest.mark.parametrize("workload",
                         ["ycsb-a.batched", "ycsb-a.lone", "ycsb-b.batched"])
def test_kv_control_is_not_correct(workload):
    # 16 shards on 64 witness sets: 4 sets a shard, so FULL rejects come
    # early, as on 64 shards of 1024 sets (16 sets a shard).
    run = kv_run(workload, control=True, n_shards=16)
    assert not run.correct
    assert compared(run)["outcome_mismatches"] > 0


def test_serve_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serving.server import CurpServeDriver

    body = CurpServeDriver._step_body

    def altered(self, inputs):
        logits, nxt = body(self, inputs)
        return logits, (nxt + 1) % logits.shape[-1]
    monkeypatch.setattr(CurpServeDriver, "_step_body", altered)
    run = serve_run()
    assert not run.correct
    assert compared(run)["served_logit_gap"] > run.traffic["gap_limit"]


def test_serve_step_that_leaves_its_state_unchanged(monkeypatch):
    import torch
    from repro_torch.models import transformer
    from repro_torch.serving import server

    decode_step = transformer.decode_step

    def stale(cfg, params, batch, cache):
        if int(batch["active"].sum()) < 2:       # the prompts: as served
            return decode_step(cfg, params, batch, cache)
        copy = {"pos": cache["pos"].clone(),
                "segments": [{k: (v.clone() if torch.is_tensor(v) else
                                  {n: t.clone() for n, t in v.items()})
                              for k, v in e.items()}
                             for e in cache["segments"]]}
        return decode_step(cfg, params, batch, copy)
    monkeypatch.setattr(server, "decode_step", stale)
    run = serve_run()
    assert not run.correct
    assert compared(run)["served_logit_gap"] > run.traffic["gap_limit"]


def test_serve_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.serving.kvstore import CurpSessionStore

    commit_batch = CurpSessionStore.commit_batch

    def half(self, states):
        return commit_batch(self, list(states)[:len(states) // 2 or 1])
    monkeypatch.setattr(CurpSessionStore, "commit_batch", half)
    run = serve_run()
    assert not run.correct
    assert compared(run)["store_mismatches"] > 0


def test_serve_control_reads_above_the_program():
    run = serve_run(control=True, dtype="bfloat16")
    c = compared(run)
    assert c["control_served_logit_gap"] > 3 * c["served_logit_gap"]
