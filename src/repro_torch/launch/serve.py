"""Serving launcher: CURP-Serve batched decoding for any --arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --smoke --requests 6 --tokens 16 --crash-at 8 --device cpu

The torch port of ``repro.launch.serve``, with its flags and printout plus
``--device`` ("cuda" by default; it raises without a card), on
``repro_torch.serving.CurpServeDriver``: on the card each token is one
replay of the driver's captured decode graph, on the CPU an eager step.
"""
from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser(description="CURP-Serve launcher")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--f", type=int, default=3)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="crash the serving master after N generated tokens")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model serves: cuda (default) or cpu")
    args = ap.parse_args()

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import reduced
    from repro_torch.serving import CurpServeDriver, ServeConfig

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if not cfg.can_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"device={args.device}")

    driver = CurpServeDriver(
        cfg,
        ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                    f=args.f, device=args.device),
        seed=args.seed,
    )
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, rng.integers(1, 6)).tolist()
        driver.submit(f"req{i}", prompt)
    t0 = time.time()
    if args.crash_at is not None and args.crash_at < args.tokens:
        driver.generate(args.crash_at)
        print(f"[{args.crash_at} tokens] crashing serving master...")
        rep = driver.crash_and_recover()
        print(f"  recovered {rep['recovered_sessions']} sessions "
              f"({rep['replayed_ops']} witness-replayed commits)")
        driver.generate(args.tokens - args.crash_at)
    else:
        driver.generate(args.tokens)
    dt = time.time() - t0
    for sid, s in driver.sessions.items():
        print(f"  {sid}: {s.tokens}")
    print(f"served {driver.tokens_served} tokens in {dt:.1f}s "
          f"({driver.tokens_served/dt:.0f} tok/s); "
          f"commits fast={driver.store.fast_commits} "
          f"slow={driver.store.slow_commits}")


if __name__ == "__main__":
    main()
