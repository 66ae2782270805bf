#!/usr/bin/env python3
"""Time the port's K5 (gang_record_groups) and K11 (witness_record_seq)
kernels of one checkout on the card, at the shapes that compare two trees.

    python3 scripts/torch_kernel_times.py [--src DIR]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch`` is
timed (default: this checkout's), so that two trees, e.g. a parent commit
unpacked under ``build/parent``, can be timed by the same script on the
same card, in turns.  Each tree builds its own kernels.

Shapes: K5 at G = K = 1 (a lone op, padded by ``groups_operands`` to 4 x 2)
and at G = 64 groups of up to K = 4 keys, on a 256-lane x 1024-set x 4-way
gang about half full; K11 with 4096 queries into an empty 1024 x 4 table
and an empty 4096 x 8 table.  Each call starts from the same state.  For
each: "ms", CUDA events around the wrapper's launch (mean of 50), and
"device_ms", the kernel's device time per launch in a torch.profiler trace
of 20 calls.  Prints one JSON object per shape and the card's name and
power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 20171026


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    src = Path(ap.parse_args().src).resolve()
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_kernel_times.py: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.kernels import build, ops, parity, ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda")

    def event_ms(fn, restore, iters=50):
        for _ in range(2):
            restore()
            fn()
        total = 0.0
        for _ in range(iters):
            restore()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters

    def device_ms(fn, restore, kernel, iters=20):
        restore()
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                restore()
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = (getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0))
            if kernel in e.key and e.count and us:
                return us / e.count / 1e3
        return None

    def report(kernel, shape, fn, restore):
        print(json.dumps(dict(src=str(src), kernel=kernel, shape=shape,
                              ms=event_ms(fn, restore),
                              device_ms=device_ms(fn, restore,
                                                  kernel + "_kernel"))),
              flush=True)

    rng = np.random.default_rng(SEED)
    L, S, W = 256, 1024, 4
    pool = parity.key_pool(rng, 4 * S, S)
    gang0 = ref.gang_from_numpy(parity.gang_planes(rng, pool, L, S, W, 256),
                                dev)
    gang = gang0.clone()
    counters = torch.zeros((L, 5), dtype=torch.int32, device=dev)

    def restore_gang():
        for p, p0 in zip(gang, gang0):
            p.copy_(p0)
        counters.zero_()

    for G, K in ((1, 1), (64, 4)):
        args = ops.groups_operands(gang0, S, **parity.group_batch(
            rng, pool, G, K, L, 256))
        report("gang_groups", f"G={G},K={K}",
               lambda args=args: ops.gang_groups_cuda(gang, S, *args,
                                                      counters),
               restore_gang)

    for s, w in ((1024, 4), (4096, 8)):
        table = ref.WitnessTable.empty(s, w, device=dev)
        lanes = rng.integers(0, 2**32, (2, 4096), dtype=np.uint64)
        args = ops.seq_operands(table, *lanes.astype(np.uint32))

        def clear(table=table):
            for p in table:
                p.zero_()

        report("witness_seq", f"{s}x{w},B=4096",
               lambda table=table, args=args: ops.witness_record_seq_cuda(
                   table, *args), clear)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
