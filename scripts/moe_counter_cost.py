#!/usr/bin/env python3
"""What the MoE routing counters cost the served decode step of
granite-4.0-h-small on the card: the step's replay time with the
counters in the captured graph (telemetry on, the default) and without
them (telemetry off, so the driver captures a step that counts nothing),
in turns on the same weights.

    python3 scripts/moe_counter_cost.py [--turns 4] [--steps 40]

The weights are drawn as the ``granite.decode`` cell draws them
(``perfbench/entries/serve_granite.py``), once; each turn builds a
``CurpServeDriver`` with 16 rows, captures its step at the first decode,
replays 5 warm-up steps and then ``--steps`` timed ones with every row
active (CUDA events around each ``_decode``), and frees the driver.
Prints one JSON object a turn (mode, p50 and mean ms) and the card's name
and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 20171026


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    for p in (str(ROOT / "src"), str(ROOT)):
        sys.path.insert(0, p)
    import numpy as np
    import torch

    from perfbench import harness
    from repro_torch.core import telemetry
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import CurpServeDriver, ServeConfig

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip()}), flush=True)
    entry = harness.load_module(ROOT / "perfbench" / "entries"
                                / "serve_granite.py")
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / "granite-4.0-h-small-curp-serve.json").read_text())
    m = conf["model"]
    cfg = entry._serve._model_config(m)
    state = entry.make_weights(m, SEED, "cuda", torch.bfloat16)
    model = Transformer.from_state_dict(cfg, state, device="cuda")
    B = conf["serve"]["max_batch"]
    host = np.ones((2, B), np.int32)
    host[0] = np.arange(B) + 7
    for turn in range(args.turns):
        on = turn % 2 == 0
        (telemetry.enable if on else telemetry.disable)()
        d = CurpServeDriver(cfg, ServeConfig(max_batch=B, max_seq=256,
                                             device="cuda"), params=model)
        for _ in range(5):
            d._decode(host)
        times = []
        for _ in range(args.steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            d._decode(host)
            b.record()
            times.append((a, b))
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in times]
        print(json.dumps({"counters": on, "p50_ms": statistics.median(ms),
                          "mean_ms": statistics.fmean(ms),
                          "replays": d.graph_replays}), flush=True)
        del d
        gc.collect()
        torch.cuda.empty_cache()
    telemetry.enable()
    return 0


if __name__ == "__main__":
    sys.exit(main())
