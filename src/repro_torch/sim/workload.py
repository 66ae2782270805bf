"""Workload generators: uniform + YCSB-style zipfian key choosers (§5.3),
plus shard-aware skew for the sharded scenarios.

The zipfian chooser follows the YCSB implementation (Gray et al.'s algorithm)
with theta = 0.99 over 1M items — the defaults of YCSB-A (50/50 read/update)
and YCSB-B (95/5).

``ShardSkewedWorkload`` routes through the same KeyRouter as the protocol and
skews load toward one hot shard — the adversarial placement case for
multi-master scaling (a uniform workload spreads ~evenly by hash design).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Callable, Optional

from ..core.client import ClientSession
from ..core.types import Op


class ZipfianGenerator:
    """YCSB ScrambledZipfian-style generator."""

    _zeta_cache = {}

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0) -> None:
        self.n = n
        self.theta = theta
        self.rng = random.Random(seed)
        key = (n, theta)
        if key not in self._zeta_cache:
            self._zeta_cache[key] = sum(1.0 / (i ** theta) for i in range(1, n + 1))
        self.zetan = self._zeta_cache[key]
        self.zeta2 = 1.0 + 0.5 ** theta
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = (1 - (2.0 / n) ** (1 - theta)) / (1 - self.zeta2 / self.zetan)

    def next_rank(self) -> int:
        u = self.rng.random()
        uz = u * self.zetan
        if uz < 1.0:
            return 0
        if uz < self.zeta2:
            return 1
        return int(self.n * ((self.eta * u - self.eta + 1) ** self.alpha))

    def next_key(self) -> str:
        # Scramble so hot keys are spread over the keyspace (YCSB-style).
        from ..core.types import splitmix64

        return f"user{splitmix64(self.next_rank()) % (self.n * 8)}"


@dataclass
class OpenLoopWorkload:
    """Open-loop arrival process for the production-armor storms.

    Unlike the closed-loop workloads (one outstanding op per client, arrival
    rate throttled by completions), this models a POPULATION of
    ``n_clients`` independent clients whose aggregate arrivals form a
    nonhomogeneous Poisson process: arrivals keep coming at ``rate_at(t)``
    whether or not earlier ops completed — the regime where overload
    actually happens.  The driver (repro_torch.sim.curp_sim.OpenLoopDriver)
    materializes per-client RIFL sessions lazily, so 10^5–10^6 client ids
    cost memory only for clients that actually issued an op.

    Shape knobs:
      * ``rate_ops_per_us`` — base λ of the Poisson process.
      * ``diurnal_amplitude``/``diurnal_period_us`` — sinusoidal rate ramp
        (λ(t) = λ·(1 + A·sin(2πt/T))), the slow daily swell.
      * ``flash_crowds`` — ((t_start, duration, multiplier), ...): rate
        multiplied during the window, the sudden-hotspot case.
      * heavy-tailed op mix: zipfian keys (``theta``) and Pareto-tailed
        value sizes (``value_alpha``; most writes small, rare huge ones).
      * ``read_fraction``/``incr_fraction`` — op-type mix (the INCR share
        exercises the merge-lattice fast path under skew).
      * ``hot_client_frac`` — fraction of arrivals issued by client 0 (the
        misbehaving-tenant case per-client throttling exists for).
    """
    rate_ops_per_us: float
    n_clients: int = 100_000
    read_fraction: float = 0.0
    incr_fraction: float = 0.0
    n_items: int = 100_000
    theta: float = 0.99
    value_alpha: float = 1.5
    value_min: int = 16
    value_cap: int = 1024
    diurnal_amplitude: float = 0.0
    diurnal_period_us: float = 50_000.0
    flash_crowds: tuple = ()
    hot_client_frac: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        self.zipf = ZipfianGenerator(self.n_items, self.theta, self.seed)
        self.rng = random.Random(self.seed + 17)
        self._max_rate = self.rate_ops_per_us * (1 + self.diurnal_amplitude)
        for _t0, _dur, mult in self.flash_crowds:
            self._max_rate = max(self._max_rate, self.rate_ops_per_us * mult)

    # -- arrival process ----------------------------------------------------
    def rate_at(self, t: float) -> float:
        r = self.rate_ops_per_us
        if self.diurnal_amplitude > 0:
            r *= 1.0 + self.diurnal_amplitude * math.sin(
                2 * math.pi * t / self.diurnal_period_us
            )
        for t0, dur, mult in self.flash_crowds:
            if t0 <= t < t0 + dur:
                r *= mult
        return max(r, 1e-9)

    def next_interarrival(self, t: float) -> float:
        """Thinning (Lewis–Shedler): exact for the piecewise rate function —
        sample candidate arrivals at the peak rate, accept with
        rate(t)/peak.  Returns the gap to the next ACCEPTED arrival."""
        gap = 0.0
        while True:
            gap += self.rng.expovariate(self._max_rate)
            if self.rng.random() * self._max_rate <= self.rate_at(t + gap):
                return gap

    # -- per-arrival op shape ----------------------------------------------
    def next_client(self) -> int:
        if self.hot_client_frac > 0 and self.rng.random() < self.hot_client_frac:
            return 0
        return self.rng.randrange(self.n_clients)

    def _value(self) -> str:
        size = int(self.value_min * self.rng.paretovariate(self.value_alpha))
        return "x" * min(size, self.value_cap)

    def make_op(self, session: ClientSession) -> Op:
        key = self.zipf.next_key()
        u = self.rng.random()
        if u < self.read_fraction:
            return session.op_get(key)
        if u < self.read_fraction + self.incr_fraction:
            return session.op_incr(key, 1)
        return session.op_set(key, self._value())


@dataclass
class YcsbWorkload:
    """op_factory for run_scenario: mixed reads/updates over a zipfian keyspace."""
    read_fraction: float
    n_items: int = 1_000_000
    theta: float = 0.99
    seed: int = 0
    value_size: int = 100

    def __post_init__(self) -> None:
        self.zipf = ZipfianGenerator(self.n_items, self.theta, self.seed)
        self.rng = random.Random(self.seed + 1)
        self._value = "x" * self.value_size

    def __call__(self, session: ClientSession) -> Op:
        key = self.zipf.next_key()
        if self.rng.random() < self.read_fraction:
            return session.op_get(key)
        return session.op_set(key, self._value)


@dataclass
class UniformWriteWorkload:
    """100B random writes over a large keyspace (Figs. 5/6 workload)."""
    n_items: int = 2_000_000
    seed: int = 0
    value_size: int = 100

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)
        self._value = "x" * self.value_size

    def __call__(self, session: ClientSession) -> Op:
        key = f"k{self.rng.randrange(self.n_items)}"
        return session.op_set(key, self._value)


@dataclass
class BatchedWorkload:
    """Batches of single-key writes for the batched client path
    (ShardedCluster.update_batch / CurpSessionStore.commit_batch).

    Each call to ``batch`` yields ``batch_size`` ops drawn from a uniform
    keyspace; ``conflict_frac`` of them re-touch a small hot keyset so a
    tunable share of the batch exercises the witness conflict path (the
    adversarial case for set-parallel records).  Ops are created through the
    session's routing constructors, so each op carries an rpc_id from its
    owning shard's RIFL space.
    """
    batch_size: int = 64
    n_items: int = 2_000_000
    conflict_frac: float = 0.0
    hot_items: int = 8
    seed: int = 0
    value_size: int = 100

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)
        self._value = "x" * self.value_size

    def batch(self, session) -> list:
        ops = []
        for _ in range(self.batch_size):
            if self.conflict_frac > 0 and self.rng.random() < self.conflict_frac:
                key = f"hot{self.rng.randrange(self.hot_items)}"
            else:
                key = f"k{self.rng.randrange(self.n_items)}"
            ops.append(session.op_set(key, self._value))
        return ops


@dataclass
class HotKeyWorkload:
    """Contended-counter workload for the CRDT-CURP merge lattice: ``skew``
    is the probability an op targets the ONE hot key (skew -> 1.0 is the
    all-ops-one-key worst case), the rest spread over a cold keyspace.

    ``kind`` picks the op type on the hot path: ``"INCR"`` ops commute under
    the merge lattice (witnesses keep accepting, the fast path survives the
    skew), ``"SET"`` ops conflict pairwise (classic CURP collapses to the
    sync path).  SADD/APPEND/MAX are also accepted for the merge-class
    sweep scenarios.
    """
    skew: float = 1.0
    kind: str = "INCR"
    hot_key: str = "hot"
    n_items: int = 100_000
    seed: int = 0
    value_size: int = 16

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)
        self._value = "x" * self.value_size
        self._seq = 0

    def __call__(self, session: ClientSession) -> Op:
        self._seq += 1
        if self.rng.random() < self.skew:
            key = self.hot_key
        else:
            key = f"c{self.rng.randrange(self.n_items)}"
        if self.kind == "INCR":
            return session.op_incr(key, 1)
        if self.kind == "SADD":
            return session.op_sadd(key, f"m{self._seq}")
        if self.kind == "APPEND":
            return session.op_append(key, f"a{self._seq}")
        if self.kind == "MAX":
            return session.op_max(key, self._seq)
        return session.op_set(key, self._value)


@dataclass
class TxnWorkload:
    """Mini-transaction generator for the txn subsystem (repro_torch.core.txn).

    Each ``next_txn`` yields a (writes, reads) pair whose keys are drawn
    from per-shard pools (pre-bucketed by the protocol's own KeyRouter, like
    ShardSkewedWorkload): with probability ``cross_shard_frac`` the write
    set spans ``span_shards`` distinct shards (a true 2PC), otherwise every
    key stays on one shard (the 1-RTT short-circuit).  ``hot_frac`` of keys
    come from a tiny hot pool, so contention — and with it intent-lock
    conflicts and transaction aborts — is tunable.
    """
    n_shards: int
    cross_shard_frac: float = 0.5
    span_shards: int = 2
    keys_per_txn: int = 2
    reads_per_txn: int = 0
    n_items: int = 10_000
    hot_frac: float = 0.0
    hot_items: int = 4
    seed: int = 0
    value_size: int = 32

    def __post_init__(self) -> None:
        from ..core.shard import KeyRouter

        router = KeyRouter(self.n_shards)
        self.rng = random.Random(self.seed)
        self._value = "x" * self.value_size
        self._pools: list = [[] for _ in range(self.n_shards)]
        for i in range(self.n_items):
            key = f"t{i}"
            self._pools[router.shard_of(key)].append(key)
        assert all(self._pools), "n_items too small to cover every shard"
        # Hot pool: the first hot_items keys of every shard's pool.
        self._hot = [pool[:self.hot_items] for pool in self._pools]
        self._seq = 0

    def _key(self, shard: int) -> str:
        if self.hot_frac > 0 and self.rng.random() < self.hot_frac:
            pool = self._hot[shard]
        else:
            pool = self._pools[shard]
        return pool[self.rng.randrange(len(pool))]

    def next_txn(self):
        """Returns (writes, reads): write values are unique per txn, so
        torn writes are observable by the strict checker."""
        self._seq += 1
        if self.n_shards > 1 and self.rng.random() < self.cross_shard_frac:
            shards = self.rng.sample(
                range(self.n_shards), min(self.span_shards, self.n_shards)
            )
        else:
            shards = [self.rng.randrange(self.n_shards)]
        keys: list = []
        seen = set()
        for i in range(self.keys_per_txn):
            k = self._key(shards[i % len(shards)])
            if k not in seen:
                seen.add(k)
                keys.append(k)
        writes = [(k, f"v{self._seq}_{k}_{self._value[:4]}") for k in keys]
        reads = []
        for i in range(self.reads_per_txn):
            k = self._key(shards[i % len(shards)])
            if k not in seen:
                seen.add(k)
                reads.append(k)
        return writes, reads


@dataclass
class ShardSkewedWorkload:
    """Writes whose *shard* distribution is skewed: ``hot_frac`` of ops land
    on ``hot_shard``, the rest spread uniformly over the other shards.

    Keys are pre-bucketed by the protocol's own KeyRouter, so the skew is
    exact with respect to actual placement (not an approximation of the
    hash).  With hot_frac = 1/n_shards this degenerates to ~uniform.
    """
    n_shards: int
    hot_frac: float = 0.8
    hot_shard: int = 0
    n_items: int = 20_000
    seed: int = 0
    value_size: int = 100
    read_fraction: float = 0.0

    def __post_init__(self) -> None:
        from ..core.shard import KeyRouter

        router = KeyRouter(self.n_shards)
        self.rng = random.Random(self.seed)
        self._value = "x" * self.value_size
        self._pools: list = [[] for _ in range(self.n_shards)]
        for i in range(self.n_items):
            key = f"k{i}"
            self._pools[router.shard_of(key)].append(key)
        assert all(self._pools), "n_items too small to cover every shard"
        self._cold = [s for s in range(self.n_shards) if s != self.hot_shard]

    def _next_key(self) -> str:
        if self.n_shards == 1 or self.rng.random() < self.hot_frac:
            shard = self.hot_shard
        else:
            shard = self.rng.choice(self._cold)
        pool = self._pools[shard]
        return pool[self.rng.randrange(len(pool))]

    def __call__(self, session: ClientSession) -> Op:
        key = self._next_key()
        if self.read_fraction > 0 and self.rng.random() < self.read_fraction:
            return session.op_get(key)
        return session.op_set(key, self._value)
