"""Plain-Python reference of the CURP key-value store the KV cells drive.

A frozen statement of what the store promises for single-key SETs and GETs,
written from the CURP paper (NSDI 2019, sections 3 and 4) and the port's
documented placement rules, and independent of the code under test (it
imports nothing of ``repro_torch``):

* **Store.** Starts from the loaded records (YCSB's load phase, all
  synced); every acknowledged SET is applied in order; a GET returns the
  last acknowledged value, or None for a key never written.
* **Master window.** A shard's master holds the keys it executed since its
  last backup sync.  An update of a key in the window (or a read of one) is
  not commutative: the master replies SYNCED and syncs before replying.
  A fast update that brings the window to ``sync_batch`` entries asks for
  a sync.
* **Witnesses.** Each of the shard's ``f`` witnesses is a set-associative
  table of ``n_sets`` x ``n_ways``.  A record goes to set
  ``mix_lo(keyhash) & (n_sets - 1)``; it is a CONFLICT if the set holds the
  key, else it takes a free way, else it is rejected as FULL.  All ``f``
  witnesses of a shard see the same records, so they hold the same keys.
* **Client.** An update completes in 1 RTT (fast path) iff the master
  replied FAST and all ``f`` witnesses accepted; else in 2 RTTs, after a
  sync.  A batch of updates records at the witnesses in batch order, runs
  the master rounds in batch order, then syncs each shard that needs it.
  A lone update records after its master round and syncs at once if needed.
* **Sync.** Moves the whole window to the backups, empties it and clears
  every record the witnesses hold for it (the records are of window ops).
* **Crash.** A recovered master restores from a backup, replays one
  witness, syncs the result and opens fresh witnesses: the shard's window
  and witnesses are empty, and no acknowledged write is lost.

Keys hash with FNV-1a over their UTF-8 bytes finished by splitmix64; the
mixed lanes (``mix2x32``, murmur3's finalizer) place a key in its slot
(``mix_lo % n_slots``, slot ``s`` on shard ``s % n_shards``) and its
witness set.  An outcome is ``(value, rtts, fast_path, synced_path,
witness_accepts)``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return (x ^ (x >> 31)) & M64


def keyhash(key: str) -> int:
    h = 0xCBF29CE484222325
    for b in key.encode():
        h = ((h ^ b) * 0x100000001B3) & M64
    return splitmix64(h)


def fmix32(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def mix_lo(kh: int) -> int:
    """The low mixed lane of a 64-bit key hash."""
    hi, lo = (kh >> 32) & M32, kh & M32
    h1 = fmix32((lo + 0x9E3779B9) & M32)
    h2 = fmix32(hi ^ h1)
    return fmix32((h1 + h2 * 5 + 0xE6546B64) & M32)


def _u64(x: int) -> np.uint64:
    return np.uint64(x & M64)


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    x = x & _u64(M32)
    x ^= x >> _u64(16)
    x = (x * _u64(0x85EBCA6B)) & _u64(M32)
    x ^= x >> _u64(13)
    x = (x * _u64(0xC2B2AE35)) & _u64(M32)
    return x ^ (x >> _u64(16))


def mix_lo_ranks(prefix: str, n: int) -> np.ndarray:
    """``mix_lo(keyhash(prefix + str(k)))`` for every ``k < n``, at once:
    the same arithmetic as the scalar functions above, in wrapping uint64
    lanes, over the ranks grouped by their number of digits."""
    out = np.empty(n, np.uint64)
    h0 = 0xCBF29CE484222325
    for b in prefix.encode():
        h0 = ((h0 ^ b) * 0x100000001B3) & M64
    lo, digits = 0, 1
    with np.errstate(over="ignore"):
        while lo < n:
            hi = min(n, 10 ** digits)
            ranks = np.arange(lo, hi, dtype=np.uint64)
            h = np.full(hi - lo, h0, np.uint64)
            for d in range(digits - 1, -1, -1):
                digit = (ranks // _u64(10 ** d)) % _u64(10) + _u64(ord("0"))
                h = (h ^ digit) * _u64(0x100000001B3)
            # splitmix64
            h = h + _u64(0x9E3779B97F4A7C15)
            h = (h ^ (h >> _u64(30))) * _u64(0xBF58476D1CE4E5B9)
            h = (h ^ (h >> _u64(27))) * _u64(0x94D049BB133111EB)
            h = h ^ (h >> _u64(31))
            # mix_lo
            h1 = _fmix32_np((h & _u64(M32)) + _u64(0x9E3779B9))
            h2 = _fmix32_np((h >> _u64(32)) ^ h1)
            out[lo:hi] = _fmix32_np(h1 + h2 * _u64(5) + _u64(0xE6546B64))
            lo, digits = hi, digits + 1
    return out


class _Shard:
    __slots__ = ("window", "count", "want_sync", "sets")

    def __init__(self) -> None:
        self.window: set = set()
        self.count = 0
        self.want_sync = False
        self.sets: Dict[int, List[str]] = {}

    def sync(self) -> None:
        self.window.clear()
        self.count = 0
        self.want_sync = False
        self.sets.clear()


class KVReference:
    def __init__(self, n_shards: int, f: int, n_sets: int, n_ways: int,
                 sync_batch: int, n_slots: int) -> None:
        self.n_shards, self.f = n_shards, f
        self.n_sets, self.n_ways = n_sets, n_ways
        self.sync_batch, self.n_slots = sync_batch, n_slots
        self.store: Dict[str, str] = {}
        self.written: set = set()
        self.shards = [_Shard() for _ in range(n_shards)]
        self._place: Dict[str, Tuple[int, int]] = {}
        self._loaded: Tuple[List[str], np.ndarray] = ([], np.zeros(0, int))

    def shards_of_ranks(self, prefix: str, n: int) -> np.ndarray:
        """The owning shard of each key ``prefix + str(k)``, ``k < n``."""
        m = mix_lo_ranks(prefix, n)
        return ((m % np.uint64(self.n_slots))
                % np.uint64(self.n_shards)).astype(np.int64)

    def load(self, keys: Sequence[str], values: Sequence[str],
             shards: np.ndarray) -> None:
        """YCSB's load phase: every record stored and synced (no window,
        no witness record), ``shards[i]`` owning ``keys[i]``."""
        self.store.update(zip(keys, values))
        self._loaded = (list(keys), np.asarray(shards))

    def place(self, key: str) -> Tuple[int, int]:
        """(shard, witness set) of ``key``."""
        p = self._place.get(key)
        if p is None:
            m = mix_lo(keyhash(key))
            p = self._place[key] = ((m % self.n_slots) % self.n_shards,
                                    m & (self.n_sets - 1))
        return p

    def _record(self, g: _Shard, key: str, s: int) -> bool:
        held = g.sets.setdefault(s, [])
        if key in held:
            return False               # CONFLICT
        if len(held) >= self.n_ways:
            return False               # FULL
        held.append(key)
        return True

    def _master(self, g: _Shard, key: str) -> bool:
        """Execute an update at the master; True if FAST."""
        fast = key not in g.window
        g.window.add(key)
        g.count += 1
        if not fast or g.count >= self.sync_batch:
            g.want_sync = True
        return fast

    def _outcome(self, fast: bool, accepted: bool):
        accepts = self.f if accepted else 0
        if not fast:
            return ("OK", 2, False, True, accepts), True
        if accepted:
            return ("OK", 1, True, False, accepts), False
        return ("OK", 2, False, False, accepts), True

    def update_batch(self, kvs):
        placed = [self.place(k) for k, _v in kvs]
        accepted = [self._record(self.shards[sh], k, s)
                    for (k, _v), (sh, s) in zip(kvs, placed)]
        out, drain = [], set()
        for (k, v), (sh, _s), acc in zip(kvs, placed, accepted):
            fast = self._master(self.shards[sh], k)
            self.store[k] = v
            self.written.add(k)
            o, need = self._outcome(fast, acc)
            if need:
                drain.add(sh)
            out.append(o)
        for sh in {sh for sh, _s in placed}:
            g = self.shards[sh]
            if sh in drain or g.want_sync:
                g.sync()
        return out

    def update(self, key: str, value: str):
        sh, s = self.place(key)
        g = self.shards[sh]
        fast = self._master(g, key)
        self.store[key] = value
        self.written.add(key)
        acc = self._record(g, key, s)
        o, need = self._outcome(fast, acc)
        if need or g.want_sync:
            g.sync()
        return o

    def read(self, key: str):
        sh, _s = self.place(key)
        g = self.shards[sh]
        if key in g.window:
            g.sync()
        return self.store.get(key)

    def crash(self, shard: int) -> None:
        self.shards[shard].sync()

    def by_shard(self) -> List[Dict[str, str]]:
        """The store's keys and values, split by owning shard."""
        out: List[Dict[str, str]] = [{} for _ in range(self.n_shards)]
        keys, shards = self._loaded
        store = self.store
        for k, sh in zip(keys, shards.tolist()):
            out[sh][k] = store[k]
        for k in self.written:
            out[self.place(k)[0]][k] = store[k]
        return out
