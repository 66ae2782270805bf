"""FaultTolerantTrainer: CURP-FT end to end.

Per step:
  1. build the batch from (seed, step) — pure function (data/pipeline.py);
  2. record the StepOp to all f witnesses (1-RTT durability; file-fsync'd);
  3. execute the train_step (speculative: state not yet on backups);
  4. every `sync_every` steps: sync full state to all f backup replicas,
     then gc the witnessed steps (the paper's batched syncs, §3.5/§4.4).

crash(): drops ALL in-memory state (master loss).
recover(): restore newest complete backup -> replay journaled steps (in
step order — ordering metadata rides in the op, commutativity makes witness
order irrelevant) -> sync -> fresh witnesses.  Deterministic data + fixed
step rng make recovery BIT-EXACT (tested).

The torch port of ``repro.ft.runner``, with the reference's step protocol.
The model is a ``Transformer`` on ``FTConfig.device`` ("cuda" unless the
caller asks for another; it raises without a card), drawn from
``FTConfig.seed`` or handed in as ``params``.  Bit-exact replay needs a
step that rounds the same way every time it runs: on CUDA the backward of
an index (the embedding lookup, the loss's gather) accumulates with atomics
unless ``torch.use_deterministic_algorithms`` is on, so each step runs
with it on (the caller's setting is restored afterwards), and cuBLAS needs
``CUBLAS_WORKSPACE_CONFIG`` set before its first handle exists.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..core.types import RecordStatus
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..launch.steps import make_train_step
from ..models.config import ModelConfig
from ..models.transformer import Transformer, resolve_device
from ..optim import AdamWConfig, init_opt_state

from .checkpoint import (
    BackupReplica,
    flatten_state,
    host_snapshot,
    restore_into,
)
from .journal import FileWitness, StepOp

# cuBLAS workspace settings under which its products are deterministic.
CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


@dataclass
class FTConfig:
    f: int = 3
    sync_every: int = 10        # backup sync batch (paper: 50)
    workdir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "curp_ft"))
    seed: int = 0
    device: str = "cuda"        # where the model and its state live


@contextmanager
def _deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for one step; the
    caller's setting comes back afterwards."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def state_digest(tree) -> str:
    """SHA-256 of a state's tensors sorted by name, each as its bits."""
    h = hashlib.sha256()
    flat = flatten_state({"": tree})
    for key in sorted(flat):
        t = flat[key].detach()
        h.update(t.reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


class FaultTolerantTrainer:
    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 ft: FTConfig, opt_cfg: Optional[AdamWConfig] = None,
                 params: Optional[Transformer] = None) -> None:
        self.cfg = model_cfg
        self.data_cfg = data_cfg
        self.ft = ft
        self.device = resolve_device(ft.device)
        if (self.device.type == "cuda" and os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_DETERMINISTIC):
            raise RuntimeError(
                "bit-exact replay on CUDA needs deterministic cuBLAS: set "
                "CUBLAS_WORKSPACE_CONFIG=:4096:8 before the process's first "
                "CUDA product")
        self.opt_cfg = opt_cfg or AdamWConfig(warmup_steps=5, total_steps=1000)
        self.root = Path(ft.workdir)
        self.root.mkdir(parents=True, exist_ok=True)
        self.pipeline = SyntheticPipeline(model_cfg, data_cfg, self.device)
        self._train_step = make_train_step(model_cfg, self.opt_cfg)
        self.epoch = 0
        self.master_id = 1
        self.backups = [BackupReplica(self.root, i) for i in range(ft.f)]
        self.witnesses = [
            FileWitness(self.root / f"witness{i}.jsonl", self.master_id)
            for i in range(ft.f)
        ]
        if params is None:
            params = Transformer(model_cfg, device=self.device, seed=ft.seed)
        elif params.device != self.device:
            raise ValueError(f"params live on {params.device}, the FT "
                             f"config asks for {self.device}")
        self.params = params
        self.opt_state = init_opt_state(self.params, self.opt_cfg,
                                        self.device)
        self.step = 0
        self._journaled: List[int] = []
        self.metrics_log: List[Dict[str, float]] = []
        # (step, seconds, bytes written to all replicas) of every sync
        self.sync_log: List[Dict[str, float]] = []
        # step 0 state is the implicit first backup
        self._sync_backups()

    # ------------------------------------------------------------------ train
    def train(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self._one_step()

    def _run_step(self, batch) -> Dict[str, torch.Tensor]:
        with _deterministic_algorithms():
            self.params, self.opt_state, metrics = self._train_step(
                self.params, self.opt_state, batch
            )
        return metrics

    def _one_step(self) -> None:
        sop = StepOp(self.step, self.data_cfg.seed, self.ft.seed)
        # 1-RTT durability: all f witnesses must accept (distinct step keys
        # always commute; a reject would mean journal corruption).
        for w in self.witnesses:
            st = w.record(sop)
            if st is not RecordStatus.ACCEPTED:
                raise RuntimeError(f"witness rejected {sop}: {st}")
        batch = self.pipeline.batch_for(self.step)
        metrics = self._run_step(batch)
        names = list(metrics)
        values = torch.stack([metrics[k].detach().float() for k in names])
        self.metrics_log.append(dict(zip(names, values.tolist())))
        self._journaled.append(self.step)
        self.step += 1
        if self.step % self.ft.sync_every == 0:
            self._sync_backups()

    def _sync_backups(self) -> None:
        t0 = time.perf_counter()
        state = host_snapshot({"params": self.params, "opt": self.opt_state})
        for b in self.backups:
            ok = b.sync(self.step, state, epoch=self.epoch)
            if not ok:
                raise RuntimeError("backup rejected sync (zombie fence?)")
        if self._journaled:
            for w in self.witnesses:
                w.gc(self._journaled)
            self._journaled = []
        self.sync_log.append({"step": self.step,
                              "seconds": time.perf_counter() - t0,
                              "bytes": state.nbytes * len(self.backups)})

    # --------------------------------------------------------------- failures
    def crash(self) -> None:
        """Master dies: all in-memory state is gone."""
        self.params = None
        self.opt_state = None
        self._journaled = []

    def recover(self) -> Dict[str, Any]:
        """Restore newest backup + replay witnessed steps (bit-exact)."""
        self.epoch += 1
        newest = max(
            (b for b in self.backups if b.newest_step() is not None),
            key=lambda b: b.newest_step(),
        )
        restored_step = newest.newest_step()
        flat, _ = newest.restore(restored_step)
        template_p = Transformer(self.cfg, device="meta")
        template_o = init_opt_state(template_p, self.opt_cfg, "meta")
        self.params = restore_into(template_p, flat["params"], self.device)
        self.opt_state = restore_into(template_o, flat["opt"], self.device)
        del flat
        self.step = restored_step

        # Replay from ONE witness (any — all contain every completed op).
        sops = self.witnesses[0].get_recovery_data()
        replayed = 0
        for sop in sops:
            if sop.step < restored_step:
                continue   # RIFL: already folded into the checkpoint
            batch = self.pipeline.batch_for(sop.step)
            self._run_step(batch)
            self.step = sop.step + 1
            replayed += 1
        # Fresh witnesses under the new epoch; sync what we replayed.
        self.master_id += 1
        for i in range(self.ft.f):
            p = self.root / f"witness{i}.jsonl"
            p.unlink(missing_ok=True)
        self.witnesses = [
            FileWitness(self.root / f"witness{i}.jsonl", self.master_id)
            for i in range(self.ft.f)
        ]
        self._sync_backups()
        return {"restored_step": restored_step, "replayed": replayed,
                "resumed_at": self.step}

    # ------------------------------------------------------------------ utils
    def params_digest(self) -> str:
        return state_digest(self.params)
