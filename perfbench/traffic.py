"""Traffic generators, seeded only from ``--seed``.

The YCSB key draw is the one ``chip_smoke.py`` phase 2 makes (numpy's
``Generator.choice`` with zipfian probabilities: an inverse-CDF lookup of
uniform draws), frozen here so that a change to the program cannot move the
yardstick.  Key rank ``k`` is the key ``user<k>``; the store hashes keys
before placing them, so ranks need no scrambling to spread over shards.

Work is cut into rounds, and round ``r`` of a stream is drawn from its own
generator, seeded by ``(seed, stream, r)``: a run makes the same rounds
whatever speed it reaches, and two runs of one seed send identical work.
"""
from __future__ import annotations

import numpy as np

STREAM_KV = 1
STREAM_PROMPTS = 2
STREAM_CRASH = 3
STREAM_SAMPLE = 4
STREAM_LOAD = 5


def rng_for(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), stream, index])


class Zipfian:
    """P(rank k) proportional to (k + 1) ** -theta over ``n`` ranks."""

    def __init__(self, n: int, theta: float) -> None:
        p = np.arange(1, n + 1, dtype=np.float64) ** -theta
        self.cdf = np.cumsum(p / p.sum())
        self.cdf /= self.cdf[-1]

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        return self.cdf.searchsorted(rng.random(size), side="right")


def value_of(seed: int, r: int, i: int, nbytes: int) -> str:
    """The value the ``i``-th update of round ``r`` writes: ``nbytes``
    characters, distinct for every update of a run."""
    head = f"{seed}:{r}:{i}:"
    return (head * (nbytes // len(head) + 1))[:nbytes]


def load_values(seed: int, n: int, nbytes: int):
    """The values of the ``n`` records the load phase installs: ``nbytes``
    hex digits each, drawn in one call (no ``:``, so no update of the window
    writes one of them again)."""
    h = rng_for(seed, STREAM_LOAD).bytes((n * nbytes + 1) // 2).hex()
    return [h[i * nbytes:(i + 1) * nbytes] for i in range(n)]


def sample_ranks(seed: int, n: int, k: int):
    """``k`` distinct key ranks below ``n``, drawn from the seed."""
    rng = rng_for(seed, STREAM_SAMPLE, 1)
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def kv_round(zipf: Zipfian, seed: int, r: int, ops: int,
             read_share: float):
    """Round ``r``: (is_read [ops] bool, key ranks [ops] int64)."""
    rng = rng_for(seed, STREAM_KV, r)
    is_read = rng.random(ops) < read_share
    return is_read, zipf.draw(rng, ops)


def prompts(seed: int, n: int, lo: int, hi: int, vocab: int):
    """``n`` prompts of lengths uniform in [lo, hi], token ids uniform over
    the vocabulary."""
    rng = rng_for(seed, STREAM_PROMPTS)
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(L)).tolist() for L in lens]


def crash_shard(seed: int, n_shards: int) -> int:
    return int(rng_for(seed, STREAM_CRASH).integers(0, n_shards))
