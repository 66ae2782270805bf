#!/usr/bin/env python3
"""Time the port's one-device model steps of one checkout on the card: the
llama3.2-1b decode step that serving runs and the smollm-360m train step
that CURP-FT runs, both at their published widths in bf16.

    python3 scripts/torch_step_times.py [--src DIR]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch`` is
timed (default: this checkout's), so that two trees, e.g. a parent commit
unpacked under ``build/parent``, can be timed by the same script on the
same card, in turns (one process a tree: run parent, change, change,
parent).  Weights are drawn from a seed; no kernel of the port is built.

Shapes: ``decode_step`` of llama3.2-1b at batch 8 on a cache of 256 (as
chip_smoke.py's phase 7 drives it, without the store), 40 steps after 8
warm-up steps; ``make_train_step`` of smollm-360m (remat on, f32 moments)
at batch 2 x 4096, 5 steps after 1 warm-up step, under deterministic
algorithms as the trainer runs it.  For each: p50 and every step's ms
(CUDA events).  Prints one JSON object per model and the card's name and
power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SEED = 20171026


def _events(torch, run, n):
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in times]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    src = Path(ap.parse_args().src).resolve()
    sys.path.insert(0, str(src))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_step_times.py: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.configs import ARCHS, concrete_batch
    from repro_torch.launch import make_train_step
    from repro_torch.models import Transformer, decode_step, init_decode_cache
    from repro_torch.optim import AdamWConfig, init_opt_state

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(SEED)

    cfg = ARCHS["llama3.2-1b"]
    model = Transformer(cfg, device="cuda", seed=SEED)
    cache = init_decode_cache(cfg, 8, 256, device="cuda")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1))).int().cuda()
    batch = {"tokens": toks}
    for _ in range(8):
        decode_step(cfg, model, batch, cache)
    ms = _events(torch, lambda: decode_step(cfg, model, batch, cache), 40)
    print(json.dumps({"src": str(src), "model": cfg.name,
                      "step": "decode_step, batch 8, cache 256",
                      "p50_ms": float(np.percentile(ms, 50)), "ms": ms}))
    del model, cache
    torch.cuda.empty_cache()

    cfg = ARCHS["smollm-360m"]
    model = Transformer(cfg, device="cuda", seed=SEED)
    opt = AdamWConfig(warmup_steps=5, total_steps=1000)
    state = init_opt_state(model, opt, "cuda")
    step = make_train_step(cfg, opt)
    batch = concrete_batch(cfg, "train", 2, 4096, seed=SEED, device="cuda")
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        step(model, state, batch)
        ms = _events(torch, lambda: step(model, state, batch), 5)
    finally:
        torch.use_deterministic_algorithms(det)
    print(json.dumps({"src": str(src), "model": cfg.name,
                      "step": "train step, batch 2 x 4096, remat",
                      "p50_ms": float(np.percentile(ms, 50)), "ms": ms}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
