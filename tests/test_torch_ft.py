"""CURP-FT on the port (``repro_torch.ft`` and the launchers), on the CPU.

Twins of ``tests/test_ft_serving.py``'s ``TestCurpFT`` and ``TestElastic``
with ``device="cpu"``; the backup format (bf16 kept as its bits, the
checksum, the zombie fence, the two newest kept); the port's trainer
against the JAX package's on the reference's weights; and both launchers in
a subprocess.  Reduced smollm-360m in f32 throughout.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.ft import FTConfig as RefFTConfig
from repro.ft import FaultTolerantTrainer as RefTrainer
from _port_cfg import reduced
from repro.models.transformer import init_params
from repro_torch.data import DataConfig
from repro_torch.ft import (
    BackupReplica,
    FTConfig,
    FaultTolerantTrainer,
    StragglerPolicy,
    plan_elastic_remesh,
    restore_into,
)
from repro_torch.ft.journal import FileWitness, StepOp
from repro_torch.ft.runner import state_digest
from repro_torch.models import Transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig, init_opt_state

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def small_cfg():
    return reduced(ARCHS["smollm-360m"])


def _ft(tmp, **kw):
    return FTConfig(**{"f": 3, "sync_every": 5, "workdir": tmp,
                       "device": "cpu", **kw})


class TestCurpFT:
    def test_bit_exact_recovery(self, small_cfg, tmp_path):
        dc = DataConfig(batch=2, seq=16)
        a = FaultTolerantTrainer(small_cfg, dc, _ft(tmp_path / "a"))
        a.train(13)
        da = a.params_digest()

        b = FaultTolerantTrainer(small_cfg, dc, _ft(tmp_path / "b"))
        b.train(8)
        b.crash()
        rep = b.recover()
        assert rep["restored_step"] == 5 and rep["replayed"] == 3
        b.train(13 - b.step)
        assert b.params_digest() == da
        assert state_digest(b.opt_state) == state_digest(a.opt_state)
        assert [s["step"] for s in b.sync_log] == [0, 5, 8, 10]

    def test_journal_survives_process_restart(self, small_cfg, tmp_path):
        """FileWitness rebuilds from its durable log (flash-backed-DRAM
        analogue)."""
        w1 = FileWitness(tmp_path / "w.jsonl", master_id=1)
        for i in range(5):
            w1.record(StepOp(i, 42, 0))
        w1.gc([0, 1])
        # "restart": new object from same file
        w2 = FileWitness(tmp_path / "w.jsonl", master_id=1)
        steps = [s.step for s in w2.get_recovery_data()]
        assert steps == [2, 3, 4]

    def test_backup_checksum_detects_corruption(self, small_cfg, tmp_path):
        dc = DataConfig(batch=2, seq=16)
        t = FaultTolerantTrainer(small_cfg, dc, _ft(tmp_path, f=1))
        t.train(5)
        b = t.backups[0]
        step = b.newest_step()
        state = b.root / f"step{step}" / "state.bin"
        data = bytearray(state.read_bytes())
        data[100] ^= 0xFF
        state.write_bytes(bytes(data))
        with pytest.raises(IOError):
            b.restore(step)


class TestElastic:
    def test_remesh_keeps_tokens_constant(self):
        full = plan_elastic_remesh(2, global_batch=256, baseline_pods=2)
        degraded = plan_elastic_remesh(1, global_batch=256, baseline_pods=2)
        assert full.per_pod_batch * full.n_pods * full.grad_accum == 256
        assert (degraded.per_pod_batch * degraded.n_pods
                * degraded.grad_accum) == 256
        assert degraded.grad_accum == 2

    def test_straggler_demotion(self):
        pol = StragglerPolicy(deadline_factor=3.0, demote_after=2)
        verdict = None
        for _ in range(10):
            pol.observe(0, 1.0)
        for _ in range(2):
            verdict = pol.observe(1, 10.0)
        assert verdict == "demote"


# ----------------------------------------------------------------------------
# backups
# ----------------------------------------------------------------------------
def _bf16_state(cfg):
    """A bf16 model and bf16-moment optimizer state with non-zero moments
    whose low bits matter (odd sizes, a 0-dim int32 step)."""
    model = Transformer(cfg, device="cpu", seed=3)
    opt = init_opt_state(model, AdamWConfig(moment_dtype="bfloat16"),
                         device="cpu")
    gen = torch.Generator().manual_seed(4)
    for mom in ("m", "v"):
        for t in opt[mom].values():
            t.copy_(torch.randn(t.shape, generator=gen))
    opt["step"].fill_(7)
    return model, opt


def test_backup_restores_bf16_bit_for_bit(tmp_path):
    """Params and moments in bf16 come back with their bits, dtypes and
    shapes, under the port's state-dict names; the manifest holds the step,
    the epoch, the digest and each tensor's dtype."""
    cfg = reduced(ARCHS["smollm-360m"], dtype="bfloat16")
    model, opt = _bf16_state(cfg)
    b = BackupReplica(tmp_path, 0)
    assert b.sync(7, {"params": model, "opt": opt}, epoch=2)
    flat, step = b.restore(7)
    assert step == 7
    manifest = json.loads((b.root / "step7" / "manifest.json").read_text())
    assert manifest["step"] == 7 and manifest["epoch"] == 2
    dtypes = {e["key"]: e["dtype"] for e in manifest["tensors"]}
    assert dtypes["params::blocks.1.attn.wq"] == "bfloat16"
    assert dtypes["opt::m.blocks.1.attn.wq"] == "bfloat16"
    assert dtypes["opt::step"] == "int32"
    assert flat["params"].keys() == model.state_dict().keys()
    back = restore_into(Transformer(cfg, device="meta"), flat["params"],
                        "cpu")
    back_opt = restore_into(init_opt_state(
        Transformer(cfg, device="meta"), AdamWConfig(moment_dtype="bfloat16"),
        "meta"), flat["opt"], "cpu")
    assert back.device == torch.device("cpu")
    assert state_digest(back) == state_digest(model)
    assert state_digest(back_opt) == state_digest(opt)
    assert back_opt["step"].dtype == torch.int32 and int(back_opt["step"]) == 7


def test_backup_fences_zombies_and_keeps_two(tmp_path):
    cfg = reduced(ARCHS["smollm-360m"])
    model = Transformer(cfg, device="cpu")
    b = BackupReplica(tmp_path, 1)
    for step in (0, 5, 10):
        assert b.sync(step, {"params": model}, epoch=1)
    assert sorted(b._steps()) == [5, 10] and b.newest_step() == 10
    assert not b.sync(15, {"params": model}, epoch=0)   # deposed master
    assert b.newest_step() == 10
    assert not list(b.root.glob(".tmp_*"))


def test_restore_into_is_strict(tmp_path):
    cfg = reduced(ARCHS["smollm-360m"])
    flat = dict(Transformer(cfg, device="cpu").state_dict())
    flat.pop("final_norm")
    with pytest.raises(KeyError, match="final_norm"):
        restore_into(Transformer(cfg, device="meta"), flat, "cpu")
    flat = dict(Transformer(cfg, device="cpu").state_dict())
    flat["final_norm"] = flat["final_norm"].double()
    with pytest.raises(ValueError, match="final_norm"):
        restore_into(Transformer(cfg, device="meta"), flat, "cpu")


# ----------------------------------------------------------------------------
# against the reference's trainer
# ----------------------------------------------------------------------------
def test_trainer_tracks_reference_trainer(small_cfg, tmp_path):
    """Both packages' trainers from the reference's weights (its trainer
    draws them from ``PRNGKey(seed)``): 8 steps, a crash, recovery from the
    step-5 backup and 5 more.  Losses step for step within 1e-5 relative
    (f32 in other orders, ~1e-7 measured in test_torch_train), and the
    final parameters within 2 x the sum of the 13 lrs (a near-zero m/sqrt(v)
    may take the other sign) with fewer than 0.1% of them apart by more
    than 1e-5."""
    dc = RefDataConfig(batch=2, seq=16)
    ref = RefTrainer(small_cfg, dc, RefFTConfig(f=3, sync_every=5,
                                                workdir=tmp_path / "ref"))
    params = Transformer.from_state_dict(small_cfg, params_from_jax(
        small_cfg, jax.tree_util.tree_map(
            np.asarray, init_params(small_cfg, jax.random.PRNGKey(0)))),
        device="cpu")
    port = FaultTolerantTrainer(small_cfg, DataConfig(batch=2, seq=16),
                                _ft(tmp_path / "port"), params=params)
    for t in (ref, port):
        t.train(8)
        t.crash()
        rep = t.recover()
        assert rep == {"restored_step": 5, "replayed": 3, "resumed_at": 8}
        t.train(5)
    losses = [[m["loss"] for m in t.metrics_log] for t in (port, ref)]
    assert len(losses[0]) == len(losses[1]) == 13
    np.testing.assert_allclose(*losses, rtol=1e-5)
    lrs = sum(m["lr"] for m in ref.metrics_log)
    want = params_from_jax(small_cfg, jax.tree_util.tree_map(np.asarray,
                                                             ref.params))
    diffs = np.concatenate([(p.detach() - want[k]).abs().reshape(-1).numpy()
                            for k, p in port.params.named_parameters()])
    assert diffs.max() <= 2 * lrs + 1e-6
    assert np.mean(diffs > 1e-5) < 1e-3


def test_trainer_refuses_params_on_another_device(small_cfg, tmp_path):
    params = Transformer(small_cfg, device="meta")
    with pytest.raises(ValueError, match="params live on"):
        FaultTolerantTrainer(small_cfg, DataConfig(batch=1, seq=8),
                             _ft(tmp_path), params=params)


def test_deterministic_mode_is_scoped_to_the_step(small_cfg, tmp_path):
    """The step runs under deterministic algorithms; the caller's setting
    comes back after it."""
    seen = []
    t = FaultTolerantTrainer(small_cfg, DataConfig(batch=1, seq=8),
                             _ft(tmp_path, f=1))
    step = t._train_step

    def spy(*a):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return step(*a)

    t._train_step = spy
    assert not torch.are_deterministic_algorithms_enabled()
    t.train(2)
    assert seen == [True, True]
    assert not torch.are_deterministic_algorithms_enabled()


# ----------------------------------------------------------------------------
# launchers
# ----------------------------------------------------------------------------
def _launch(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-m", module, *args], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    return done.stdout


def test_train_launcher_recovers_to_the_uninterrupted_digest(tmp_path):
    common = ["--smoke", "--device", "cpu", "--steps", "12", "--batch", "2",
              "--seq", "16", "--sync-every", "5"]
    crashed = _launch("repro_torch.launch.train", *common, "--crash-at", "8",
                      "--workdir", str(tmp_path / "a"))
    plain = _launch("repro_torch.launch.train", *common,
                    "--workdir", str(tmp_path / "b"))
    assert "recovered: backup@5 + 3 replayed journal steps" in crashed
    digest = [out.rsplit("digest ", 1)[1].strip() for out in (crashed, plain)]
    assert digest[0] == digest[1] and len(digest[0]) == 16


def test_serve_launcher_recovers_its_sessions():
    out = _launch("repro_torch.launch.serve", "--smoke", "--device", "cpu",
                  "--requests", "3", "--tokens", "6", "--crash-at", "3")
    assert "recovered 3 sessions" in out
    assert out.count("req") == 3 and "served" in out


def test_train_launcher_refuses_distributed(monkeypatch):
    """--distributed outside torchrun (no RANK, WORLD_SIZE, LOCAL_RANK)
    stops before training rather than train alone."""
    from repro_torch.launch import train

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(sys, "argv", ["train", "--distributed", "--device",
                                      "cpu"])
    with pytest.raises(SystemExit, match="launch under torchrun"):
        train.main()
