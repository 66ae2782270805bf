"""The generators repeat per seed and follow their stated draws."""
from __future__ import annotations

import numpy as np

from perfbench import traffic


def test_kv_rounds_repeat_per_seed_and_differ_across_seeds():
    z = traffic.Zipfian(100_000, 0.99)
    a = traffic.kv_round(z, 2**31 + 7, 3, 2048, 0.5)
    b = traffic.kv_round(z, 2**31 + 7, 3, 2048, 0.5)
    c = traffic.kv_round(z, 2**31 + 8, 3, 2048, 0.5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    # A round does not depend on the rounds drawn before it.
    traffic.kv_round(z, 2**31 + 7, 2, 2048, 0.5)
    d = traffic.kv_round(z, 2**31 + 7, 3, 2048, 0.5)
    assert np.array_equal(a[1], d[1])


def test_zipfian_is_numpys_weighted_choice():
    n, theta = 1000, 0.99
    z = traffic.Zipfian(n, theta)
    p = np.arange(1, n + 1, dtype=np.float64) ** -theta
    p /= p.sum()
    want = np.random.default_rng(5).choice(n, size=4096, p=p)
    got = z.draw(np.random.default_rng(5), 4096)
    assert np.array_equal(want, got)


def test_read_share_and_skew():
    z = traffic.Zipfian(1_000_000, 0.99)
    is_read, ranks = traffic.kv_round(z, 11, 0, 200_000, 0.95)
    assert abs(is_read.mean() - 0.95) < 0.005
    assert (ranks == 0).mean() > 0.05          # the hottest key
    assert ranks.max() < 1_000_000


def test_values_are_sized_and_distinct():
    vals = {traffic.value_of(2**40, r, i, 100)
            for r in range(3) for i in range(100)}
    assert len(vals) == 300
    assert {len(v) for v in vals} == {100}


def test_prompts_repeat_per_seed():
    a = traffic.prompts(2**33, 8, 32, 128, 32001)
    assert a == traffic.prompts(2**33, 8, 32, 128, 32001)
    assert a != traffic.prompts(2**33 + 1, 8, 32, 128, 32001)
    assert all(32 <= len(p) <= 128 for p in a)
    assert all(0 <= t < 32001 for p in a for t in p)


def test_load_values_repeat_per_seed_and_never_equal_an_update():
    a = traffic.load_values(2**40, 1000, 100)
    assert a == traffic.load_values(2**40, 1000, 100)
    assert a != traffic.load_values(2**40 + 1, 1000, 100)
    assert len(set(a)) == 1000 and {len(v) for v in a} == {100}
    assert not any(":" in v for v in a)
    s = traffic.sample_ranks(2**40, 1000, 64)
    assert len(set(s.tolist())) == 64 and s.max() < 1000
    assert np.array_equal(s, traffic.sample_ranks(2**40, 1000, 64))
