"""Training launcher: CURP-FT fault-tolerant training for any --arch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --steps 50 --sync-every 10 --crash-at 23 --device cpu

The torch port of ``repro.launch.train``, with its flags and printout plus
``--device`` ("cuda" by default; it raises without a card).  --smoke runs
the reduced config; without it the full config trains on one device.

--distributed joins a multi-process launch from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
NCCL on ``cuda:{LOCAL_RANK}``, gloo with ``--device cpu``.  Then each rank
runs the same trainer as without the flag (the reference does no more
than ``jax.distributed.initialize()``).  With more than one rank each
rank's --workdir gets a ``rank{r}`` suffix, so ranks on one host do not
share witness and backup files.  The group is destroyed at exit.

    torchrun --standalone --nproc_per_node 2 -m repro_torch.launch.train \
        --distributed --smoke --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def main() -> None:
    ap = argparse.ArgumentParser(description="CURP-FT training launcher")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--f", type=int, default=3, help="witness/backup count")
    ap.add_argument("--sync-every", type=int, default=10,
                    help="backup sync batch (paper §4.4)")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a master crash at this step, then recover")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "curp_ft_run"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process launch under torchrun")
    args = ap.parse_args()

    # Deterministic cuBLAS for bit-exact replay, set before the first
    # CUDA product creates a handle.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not args.distributed:
        train(args)
        return
    import torch.distributed as dist

    rank, world = init_distributed(args.device)
    try:
        if world > 1:
            args.workdir = os.path.join(args.workdir, f"rank{rank}")
        train(args)
    finally:
        dist.destroy_process_group()


def init_distributed(device: str):
    """Join the process group torchrun describes; returns (rank, world
    size).  A launch without torchrun's environment raises."""
    import torch
    import torch.distributed as dist

    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")
               if k not in os.environ]
    if missing:
        raise SystemExit(f"--distributed: {', '.join(missing)} not set; "
                         f"launch under torchrun")
    if device == "cpu":
        backend = "gloo"
    else:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl"
    dist.init_process_group(backend)
    return dist.get_rank(), dist.get_world_size()


def train(args) -> None:
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig
    from repro_torch.ft import FTConfig, FaultTolerantTrainer
    from repro_torch.models import reduced

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"layers={cfg.n_layers} d={cfg.d_model} device={args.device}")

    trainer = FaultTolerantTrainer(
        cfg,
        DataConfig(seed=1234, batch=args.batch, seq=args.seq),
        FTConfig(f=args.f, sync_every=args.sync_every,
                 workdir=args.workdir, seed=args.seed, device=args.device),
    )
    t0 = time.time()
    if args.crash_at is not None and args.crash_at < args.steps:
        trainer.train(args.crash_at)
        print(f"[{args.crash_at}] injecting master crash...")
        trainer.crash()
        rep = trainer.recover()
        print(f"  recovered: backup@{rep['restored_step']} "
              f"+ {rep['replayed']} replayed journal steps")
        trainer.train(args.steps - trainer.step)
    else:
        trainer.train(args.steps)
    dt = time.time() - t0
    losses = [m["loss"] for m in trainer.metrics_log]
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"digest {trainer.params_digest()[:16]}")


if __name__ == "__main__":
    main()
