#!/usr/bin/env python3
"""Time the port's K5 (gang_record_groups), K9 (txn_probe), K10
(witness_gc), K11 (witness_record_seq) and Mamba2 state-update
(ssm_update) kernels of one checkout on the card, at the shapes that
compare two trees.

    python3 scripts/torch_kernel_times.py [--src DIR]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch`` is
timed (default: this checkout's), so that two trees, e.g. a parent commit
unpacked under ``build/parent``, can be timed by the same script on the
same card, in turns.  Each tree builds its own kernels.

Shapes: K5 at G = K = 1 (a lone op, padded by ``groups_operands`` to 4 x 2)
and at G = 64 groups of up to K = 4 keys, on a 256-lane x 1024-set x 4-way
gang about half full; K9 at its path shape (the last of 60 probes of 1 to
5 keys drawn from 4 x 4 raw lanes on a 64 x 4 table, padded to 16, one
warp), at 16 fresh keys on a 1024 x 4 table about 90% full, and at 1024
fresh keys in the 1024 distinct sets of a 1024 x 4 table with a free way
in each (it accepts); K10 on the table of the gc chain (4096 random lanes
recorded into an empty 1024 x 4 table) with one sync batch (G = 50) and
the chain's batch (half the accepted lanes, about 1645) of its keys, and
with 4096 entries of ``parity.gc_entries``' mix; K11 with 4096 queries
into an empty 1024 x 4 table and an empty 4096 x 8 table; ssm_update at
granite-4.0-h-small's layer as served (16 x 128 x 64 x 128, bf16, G = 1)
and hymba-1.5b's (8 x 50 x 64 x 16), every row active, the 50 MB L2 cache
flushed before each call (a decode step meets a layer's state cold), also
with its plain version's time ("plain_ms") and its bound ("bound_ms": the
state read and written once at 3.35e12 B/s).  Each other call starts from
the same state.  For
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

    def report(kernel, shape, fn, restore, **more):
        print(json.dumps(dict(src=str(src), kernel=kernel, shape=shape,
                              ms=event_ms(fn, restore),
                              device_ms=device_ms(fn, restore,
                                                  kernel + "_kernel"),
                              **more)),
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

    def table_restorer(table0):
        table = table0.clone()

        def restore():
            for p, p0 in zip(table, table0):
                p.copy_(p0)
        return table, restore

    r = np.random.default_rng(7)
    probe_table = ref.WitnessTable.empty(64, 4, device=dev)
    for i in range(60):           # the last probe is the one timed
        n = int(r.integers(1, 6))
        hi, lo = (r.integers(0, 4, n).astype(np.uint32) for _ in range(2))
        if i < 59:
            ops.txn_probe(probe_table, hi, lo)
    S, W = 1024, 4
    pool = parity.key_pool(rng, 2 * S * W, S)
    fresh = parity.key_pool(rng, 32 * S, S)
    full = ref.witness_table_from_numpy(
        parity.table_planes(rng, pool, S, W, fill=2.0), dev)
    k16 = rng.choice(len(fresh.hi), 16, replace=False)
    roomy = parity.table_planes(rng, pool, S, W, fill=0.75)
    busy = np.flatnonzero((roomy[2] > 0).all(1))
    roomy[2][busy, rng.integers(0, W, busy.size)] = 0
    k1024 = np.array([fresh.by_set[x][0] for x in rng.permutation(S)])
    for shape, table0, keys in (
            ("path,64x4", probe_table, (hi, lo)),
            ("K=16,1024x4,full", full, (fresh.hi[k16], fresh.lo[k16])),
            ("K=1024,1024x4", ref.witness_table_from_numpy(roomy, dev),
             (fresh.hi[k1024], fresh.lo[k1024]))):
        table, restore = table_restorer(table0)
        args = ops.txn_probe_operands(table0, *keys)
        report("txn_probe", shape,
               lambda table=table, args=args: ops.txn_probe_cuda(table,
                                                                 *args),
               restore)

    gc_table = ref.WitnessTable.empty(S, W, device=dev)
    qh, ql = (r.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    acc, gc_table = ops.witness_record(gc_table, qh, ql)
    ok = np.flatnonzero(acc == 1)
    half = ok[: ok.size // 2]
    more = parity.gc_entries(rng, ref.witness_table_to_numpy(gc_table), 4096)
    for shape, g_hi, g_lo in (
            ("G=50,1024x4", qh[half[:50]], ql[half[:50]]),
            (f"G={half.size},1024x4", qh[half], ql[half]),
            ("G=4096,1024x4", more["g_hi"], more["g_lo"])):
        table, restore = table_restorer(gc_table)
        args = ops.table_gc_operands(gc_table, g_hi, g_lo)
        report("witness_gc", shape,
               lambda table=table, args=args: ops.witness_gc_cuda(table,
                                                                  *args),
               restore)

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

    from repro_torch.models.ssm import ssm_state_update_plain

    flush = torch.empty(2 ** 27, dtype=torch.uint8, device=dev)
    for shape in ((16, 128, 64, 128), (8, 50, 64, 16)):
        B, H, P, N = shape
        g = torch.Generator(device=dev).manual_seed(SEED)
        state = torch.randn(shape, generator=g, device=dev,
                            dtype=torch.bfloat16)
        dA = torch.rand((B, H), generator=g, device=dev).to(torch.bfloat16)
        xdt = torch.randn((B, H, P), generator=g, device=dev,
                          dtype=torch.bfloat16)
        Bm, Cm = torch.randn((2, B, 1, N), generator=g, device=dev,
                             dtype=torch.bfloat16)
        active = torch.ones(B, dtype=torch.int32, device=dev)
        operands = (state, dA, xdt, Bm, Cm, active)
        plain = event_ms(lambda: ssm_state_update_plain(*operands),
                         flush.zero_)
        report("ssm_update", "x".join(map(str, shape)),
               lambda: ops.ssm_state_update_cuda(*operands), flush.zero_,
               plain_ms=plain,
               bound_ms=2 * state.numel() * state.element_size() / 3.35e9)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
