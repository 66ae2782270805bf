"""The port's simulator (``repro_torch.sim``) against the JAX package's
(``repro.sim``), on the Python witness backend (CPU).

The simulator is a copy; these hold it to the same results on the same
seeds, field for field: the transaction crash scenarios at every 2PC stage,
a closed-loop timed scenario, the batched client path's counts and a
watched open-loop scenario with its replay.  Wall-clock rates are not
compared (they are host timings).  One crash scenario also runs on the
port's device backend, on the CPU (the plain versions of the kernels).
"""
import dataclasses
import enum

import pytest

import repro.sim as jsim
import repro_torch.sim as tsim

SEEDS = [0, 1, 2]


def _plain(x):
    """Results of either package as plain values: enums by value,
    dataclasses by class name and fields, containers element-wise."""
    if isinstance(x, enum.Enum):
        return x.value
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, _plain(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return frozenset(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("participant_crash", [False, True],
                         ids=["lazy", "participant"])
@pytest.mark.parametrize("stage", tsim.TXN_CRASH_STAGES)
def test_txn_crash_scenario_matches(stage, participant_crash):
    kw = dict(stage=stage, n_shards=3, n_txns=8,
              participant_crash=participant_crash, seed=11)
    got = tsim.run_txn_crash_scenario(**kw)
    want = jsim.run_txn_crash_scenario(**kw)
    assert _plain(got) == _plain(want)
    assert got.intents_after == 0 and got.history_ok
    assert got.crashed_decision in ("COMMITTED", "ABORTED")


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_loop_scenario_matches(seed):
    """A timed CURP run with a master crash part-way: latencies, history,
    recovery report and master stats (simulated time, so exact)."""
    kw = dict(mode="curp", f=3, n_clients=2, n_ops=100, seed=seed,
              crash_at_us=300.0)
    got = tsim.run_scenario(**kw)
    want = jsim.run_scenario(**kw)
    assert _plain(got) == _plain(want)
    assert got.completed > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_throughput_counts_match(seed):
    kw = dict(n_shards=2, batch_size=32, n_batches=4, seed=seed,
              conflict_frac=0.2)
    got = tsim.run_batched_throughput(**kw)
    want = jsim.run_batched_throughput(**kw)
    for field in ("ops", "fast_fraction", "witness_accepts", "n_batches"):
        assert getattr(got, field) == getattr(want, field), field
    assert 0 < got.fast_fraction < 1


def test_watched_openloop_scenario_and_replay_match():
    kw = dict(scenario="openloop", duration_us=1_500.0, seed=3)
    got, wd = tsim.run_watched_scenario(**kw)
    want, jwd = jsim.run_watched_scenario(**kw)
    assert _plain(got) == _plain(want)
    assert wd.ok == jwd.ok
    assert [b.key() for b in wd.breaches] == [b.key() for b in jwd.breaches]
    _wd2, identical = tsim.replay(wd)
    assert identical


def test_watched_chaos_trips_the_same_monitor():
    kw = dict(scenario="openloop", duration_us=1_500.0, seed=3,
              chaos=tsim.ChaosConfig(early_ack=True))
    _got, wd = tsim.run_watched_scenario(**kw)
    kw["chaos"] = jsim.ChaosConfig(early_ack=True)
    _want, jwd = jsim.run_watched_scenario(**kw)
    assert wd.fired_monitors() == jwd.fired_monitors() == ("durability",)
    _wd2, identical = tsim.replay(wd)
    assert identical


def test_txn_crash_scenario_on_the_device_backend():
    """The port's device witnesses (plain versions on the CPU) keep the
    transactions atomic, and agree with the Python backend."""
    kw = dict(stage="prepared", n_shards=3, n_txns=8, participant_crash=True,
              seed=4)
    got = tsim.run_txn_crash_scenario(witness_backend="device", device="cpu",
                                      **kw)
    assert got.intents_after == 0 and got.history_ok
    want = tsim.run_txn_crash_scenario(**kw)
    assert (got.committed, got.aborted, got.crashed_decision,
            got.final_reads) == (want.committed, want.aborted,
                                 want.crashed_decision, want.final_reads)
