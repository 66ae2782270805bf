#!/usr/bin/env python3
"""Measure the host costs under a CURP-FT backup sync and step journal.

    python3 scripts/ft_disk_probe.py [--gb 4] [--load-gb 12] [--after-s 30]

In a fresh temporary directory (``tempfile.mkdtemp``, removed at the end),
on the machine it runs on:

- ``sha256_gib_s``: SHA-256 of ``--gb`` GiB in memory (``hashlib``, one
  stream, as ``ft.checkpoint.host_snapshot`` hashes a state);
- ``write_gib_s``: one ``--gb`` GiB file written with no fsync (as a
  backup's ``state.bin``);
- ``read_gib_s``: the same file read back into a ``bytearray`` (as
  ``BackupReplica.restore`` reads it);
- ``fsync_idle_ms``: p50 and max of 20 fsyncs of a ~100-byte line
  appended to a small file (as ``FileWitness.record`` does), the disk
  otherwise idle;
- ``fsync_loaded_ms``: the same appends every 50 ms while another thread
  writes ``--load-gb`` GiB to a second file in 1 GiB chunks (a sync's three
  replicas), and ``load_s`` that write's wall time; ``fsync_after_ms``:
  the appends of the ``--after-s`` seconds after it, while the kernel
  writes the page cache back (a sync's next steps journal then).

Prints one JSON object.  It measures the host's disk and CPU, not a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time

GIB = 1 << 30


def _fsyncs(path, n, gap_s=0.0, stop=None):
    """(start, ms) of the fsyncs of n appended lines, or until ``stop`` is
    set."""
    out = []
    with open(path, "a") as f:
        while len(out) < n and not (stop is not None and stop.is_set()):
            f.write("x" * 100 + "\n")
            f.flush()
            t = time.perf_counter()
            os.fsync(f.fileno())
            out.append((t, (time.perf_counter() - t) * 1e3))
            time.sleep(gap_s)
    return out


def _p50_max(samples):
    xs = sorted(ms for _, ms in samples)
    if not xs:
        return {"n": 0}
    return {"p50": xs[len(xs) // 2], "max": xs[-1], "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gb", type=int, default=4)
    ap.add_argument("--load-gb", type=int, default=12)
    ap.add_argument("--after-s", type=float, default=30.0)
    args = ap.parse_args()
    d = tempfile.mkdtemp(prefix="ft_disk_probe_")
    try:
        buf = os.urandom(GIB) * args.gb
        t = time.perf_counter()
        hashlib.sha256(buf).hexdigest()
        sha = args.gb / (time.perf_counter() - t)
        big = os.path.join(d, "state.bin")
        t = time.perf_counter()
        with open(big, "wb") as f:
            f.write(buf)
        write = args.gb / (time.perf_counter() - t)
        t = time.perf_counter()
        raw = bytearray(os.path.getsize(big))
        with open(big, "rb") as f:
            f.readinto(raw)
        read = args.gb / (time.perf_counter() - t)
        del raw
        os.sync()
        idle = _fsyncs(os.path.join(d, "witness.jsonl"), 20)

        chunk = buf[:GIB]
        load_s = []

        def load():
            t0 = time.perf_counter()
            with open(os.path.join(d, "load.bin"), "wb") as f:
                for _ in range(args.load_gb):
                    f.write(chunk)
            load_s.append(time.perf_counter() - t0)

        stop = threading.Event()
        writer = threading.Thread(target=load)
        writer.start()
        loaded = []
        sampler = threading.Thread(target=lambda: loaded.extend(_fsyncs(
            os.path.join(d, "witness2.jsonl"), 10**6, 0.05, stop)))
        sampler.start()
        writer.join()
        load_end = time.perf_counter()
        time.sleep(args.after_s)
        stop.set()
        sampler.join()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps({
        "sha256_gib_s": sha, "write_gib_s": write, "read_gib_s": read,
        "fsync_idle_ms": _p50_max(idle),
        "fsync_loaded_ms": _p50_max([x for x in loaded if x[0] < load_end]),
        "fsync_after_ms": _p50_max([x for x in loaded if x[0] >= load_end]),
        "load_gib": args.load_gb, "load_s": load_s[0],
        "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
