"""The port stands alone: no JAX and nothing of ``repro`` in ``repro_torch``,
and its entry points run on the card unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# Deterministic cuBLAS for the trainer on the card (before any product).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.kernels.parity, repro_torch.sim\n"
        "import repro_torch.models, repro_torch.models.convert\n"
        "import repro_torch.configs, repro_torch.serving\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.ft\n"
        "import repro_torch.launch, repro_torch.launch.train\n"
        "import repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PORT.rglob("*.py")]
    + [Path("chip_smoke.py")]), ids=str)
def test_source_has_no_jax_or_repro_import(path):
    hits = _FORBIDDEN.findall((ROOT / path).read_text())
    assert not hits, f"{path} imports {hits}"


@pytest.mark.parametrize("name", ["shard.py", "fastbatch.py"])
def test_write_path_leaves_witness_launches_to_the_witness_modules(name):
    """ShardGroup and the fused driver do not decide which witnesses share
    a kernel call: neither tests a witness's type or compares gangs, and
    only ShardGroup's choice of backend names the device witness."""
    text = (PORT / "core" / name).read_text()
    assert not re.search(r"isinstance\([^)]*Witness", text)
    assert ".gang is" not in text
    assert text.count("DeviceWitness") == (name == "shard.py")


BENCH_CODE = sorted(p.relative_to(ROOT) for d in ("entries", "reference")
                    for p in (ROOT / "perfbench" / d).glob("*.py"))


@pytest.mark.parametrize("path", BENCH_CODE, ids=str)
def test_benchmark_entries_and_references_import_no_jax(path):
    """The benchmark's entries and plain references run beside the port
    on the card: neither imports JAX or the JAX package, and a reference
    imports nothing of the port either."""
    text = (ROOT / path).read_text()
    hits = _FORBIDDEN.findall(text)
    assert not hits, f"{path} imports {hits}"
    if path.parent.name == "reference":
        assert not re.search(r"^\s*(import|from)\s+repro_torch", text,
                             re.M), path


def _device_backends():
    from repro_torch.core import LocalCluster, ShardedCluster, ShardGroup
    from repro_torch.core.config import ConfigManager

    ids = iter(range(1, 100))
    return {
        "ShardedCluster": lambda: ShardedCluster(n_shards=1, f=1,
                                                 witness_backend="device"),
        "LocalCluster": lambda: LocalCluster(f=1, witness_backend="device"),
        "ShardGroup": lambda: ShardGroup(0, ConfigManager(),
                                         lambda: next(ids), f=1,
                                         witness_backend="device"),
    }


@pytest.mark.parametrize("name", ["ShardedCluster", "LocalCluster",
                                  "ShardGroup"])
def test_device_backend_runs_on_the_card_by_default(name):
    build = _device_backends()[name]
    if torch.cuda.is_available():
        c = build()
        gang = c.group.gang if name == "LocalCluster" else c.gang
        assert gang.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            build()


def _serving_entries():
    from repro_torch.configs import ARCHS, concrete_batch
    from repro_torch.models import Transformer, init_decode_cache, reduced
    from repro_torch.serving import (
        CurpServeDriver,
        CurpSessionStore,
        ServeConfig,
    )

    cfg = reduced(ARCHS["llama3.2-1b"])
    return {
        "CurpServeDriver": lambda: CurpServeDriver(cfg, ServeConfig()),
        "ServeConfig": lambda: CurpServeDriver(
            cfg, ServeConfig(witness_backend="device")),
        "Transformer": lambda: Transformer(cfg),
        "init_decode_cache": lambda: init_decode_cache(cfg, 2, 8),
        "concrete_batch": lambda: concrete_batch(cfg, "decode", 2, 1),
        "CurpSessionStore": lambda: CurpSessionStore(
            n_shards=2, witness_backend="device"),
    }


def _tensors_of(out):
    from repro_torch.models import Transformer
    from repro_torch.serving import CurpServeDriver, CurpSessionStore

    if isinstance(out, CurpServeDriver):
        return (list(out.params.parameters()) + [out.cache["pos"]]
                + [t for seg in out.cache["segments"] for t in seg.values()])
    if isinstance(out, Transformer):
        return list(out.parameters())
    if isinstance(out, CurpSessionStore):
        return list(out.cluster.gang.table)
    if isinstance(out, dict) and "segments" in out:
        return [out["pos"]] + [t for seg in out["segments"]
                               for t in seg.values()]
    return list(out.values())


@pytest.mark.parametrize("name", ["CurpServeDriver", "ServeConfig",
                                  "Transformer", "init_decode_cache",
                                  "concrete_batch", "CurpSessionStore"])
def test_serving_entry_runs_on_the_card_by_default(name):
    """The serving path's entry points, given no device (``ServeConfig``
    names "cuda" by default, for the model, its cache and, on the device
    witness backend, the store's gang), land on the card; without one they
    raise rather than falling back to the CPU."""
    from repro_torch.serving import ServeConfig

    assert ServeConfig().device == "cuda"
    call = _serving_entries()[name]
    if torch.cuda.is_available():
        tensors = _tensors_of(call())
        assert tensors and all(t.device.type == "cuda" for t in tensors)
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


def _training_entries(tmp):
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.ft import FTConfig, FaultTolerantTrainer
    from repro_torch.models import Transformer, reduced
    from repro_torch.optim import AdamWConfig, init_opt_state

    cfg = reduced(ARCHS["smollm-360m"])
    return {
        "FaultTolerantTrainer": lambda: FaultTolerantTrainer(
            cfg, DataConfig(batch=1, seq=8), FTConfig(f=1, workdir=tmp)),
        "SyntheticPipeline.batch_for": lambda: SyntheticPipeline(
            cfg, DataConfig(batch=1, seq=8)).batch_for(0),
        "init_opt_state": lambda: init_opt_state(
            Transformer(cfg, device="cuda" if torch.cuda.is_available()
                        else "cpu"), AdamWConfig()),
    }


def _training_tensors(out):
    from repro_torch.ft import FaultTolerantTrainer

    if isinstance(out, FaultTolerantTrainer):
        return (list(out.params.parameters())
                + list(out.opt_state["m"].values()) + [out.opt_state["step"]])
    if "m" in out:
        return list(out["m"].values()) + [out["step"]]
    return list(out.values())


@pytest.mark.parametrize("name", ["FaultTolerantTrainer",
                                  "SyntheticPipeline.batch_for",
                                  "init_opt_state"])
def test_training_entry_runs_on_the_card_by_default(name, tmp_path):
    """The training path's entry points, given no device (``FTConfig``
    names "cuda" by default, for the model, its optimizer state and its
    batches), land on the card; without one they raise rather than
    falling back to the CPU."""
    from repro_torch.ft import FTConfig

    assert FTConfig().device == "cuda"
    call = _training_entries(tmp_path)[name]
    if torch.cuda.is_available():
        tensors = _training_tensors(call())
        assert tensors and all(t.device.type == "cuda" for t in tensors)
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


def _single_table_entries():
    from repro_torch.kernels import (
        WitnessTable,
        conflict_scan,
        keyhash2x32,
        shard_route,
        witness_table_from_numpy,
    )

    lanes = np.array([1, 0xF0000001], np.uint32)
    planes = [np.zeros((16, 2), np.uint32)] * 2 + [np.zeros((16, 2), np.int32)]
    return {
        "WitnessTable.empty": lambda: WitnessTable.empty(16, 2),
        "witness_table_from_numpy": lambda: witness_table_from_numpy(planes),
        "keyhash2x32": lambda: keyhash2x32(lanes, lanes),
        "shard_route": lambda: shard_route(lanes, lanes, 4),
        "conflict_scan": lambda: conflict_scan(lanes, lanes, [1, 1], lanes,
                                               lanes),
    }


@pytest.mark.parametrize("name", ["WitnessTable.empty",
                                  "witness_table_from_numpy", "keyhash2x32",
                                  "shard_route", "conflict_scan"])
def test_single_table_entry_runs_on_the_card_by_default(name):
    from repro_torch.kernels import WitnessTable, ops

    call = _single_table_entries()[name]
    if torch.cuda.is_available():
        before = sum(k.launches for k in ops.TABLE_KERNELS)
        out = call()
        if isinstance(out, WitnessTable):
            assert out.occ.device.type == "cuda"
        else:
            assert sum(k.launches for k in ops.TABLE_KERNELS) == before + 1
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


def test_python_backend_needs_no_device():
    from repro_torch.core import ShardedCluster

    c = ShardedCluster(n_shards=2, f=3, witness_backend="python")
    s = c.new_client()
    assert c.update(s, s.op_set("k", "v")).fast_path
    assert c.gang is None


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    from repro_torch.kernels import GangTable, gang_record

    table = GangTable.empty(16, 2, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gang_record(table, 16, [1], [2], [0], [0], [0])


def test_cuda_launcher_refuses_cpu_tensors():
    from repro_torch.kernels import GangTable, ops

    table = GangTable.empty(16, 2, 1, device="cpu")
    operands = ops.record_operands(table, 16, np.array([1]), np.array([2]),
                                   [0], [0], [0])
    with pytest.raises(ValueError, match="CUDA launcher"):
        ops.gang_record_cuda(table, 16, *operands)


def test_table_ops_refuse_devices_they_have_no_kernel_for():
    from repro_torch.kernels import WitnessTable, conflict_scan, witness_record

    table = WitnessTable(*(torch.zeros((16, 2), dtype=torch.int32,
                                       device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        witness_record(table, [1], [2])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conflict_scan([1], [2], [1], [1], [2], device="meta")


def test_table_cuda_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import WitnessTable, ops

    table = WitnessTable.empty(16, 2, device="cpu")
    args = ops.table_record_operands(table, [1], [2])
    with pytest.raises(ValueError, match="CUDA launcher"):
        ops.witness_record_cuda(table, *args)
    with pytest.raises(ValueError, match="CUDA launcher"):
        ops.keyhash_cuda(*args[:2])
    with pytest.raises(ValueError, match="CUDA launcher"):
        ops.fastpath_record_scan_cuda(
            table, *ops.table_fastpath_operands(table, [1], [2]))
    with pytest.raises(ValueError, match="CUDA launcher"):
        ops.conflict_scan_cuda(*ops.scan_operands("cpu", [1], [2], [1], [1],
                                                  [2]))


def test_kernel_sources_compile_into_a_hashed_ignored_directory():
    from repro_torch.kernels import build

    d = build.build_dir()
    assert d.parent == ROOT / "build" / "repro_torch"
    assert d == build.build_dir()                     # stable for a checkout
    lib = d / "x.so"
    if (ROOT / ".git").exists():
        ignored = subprocess.run(["git", "check-ignore", "-q", str(lib)],
                                 cwd=ROOT, timeout=60)
        assert ignored.returncode == 0
    else:                  # a copy without git: the ignore file's own lines
        lines = {ln.strip().strip("/")
                 for ln in (ROOT / ".gitignore").read_text().splitlines()}
        assert lines & {"build", "build/repro_torch"}, lines
    assert {p.name for p in build.CSRC.glob("*.cu")} == {
        "gang_record.cu", "gang_fastpath.cu", "gang_gc.cu", "gang_groups.cu",
        "keyhash.cu", "witness_table.cu", "fastpath_batch.cu",
        "conflict_scan.cu", "witness_txn.cu", "witness_gc.cu",
        "witness_seq.cu", "chain_probe.cu", "ssm_update.cu"}


@pytest.mark.parametrize("name", ["gang_from_numpy", "ring_from_numpy",
                                  "GangTable.empty"])
def test_state_carrier_lands_on_the_card_by_default(name):
    """The JAX package's gang and ring state, carried into the port with no
    device named, and an empty gang made with none, land on the card;
    without one they raise rather than falling back to the CPU."""
    from repro_torch.kernels import GangTable, gang_from_numpy, ring_from_numpy

    plane = np.zeros((4, 2), np.uint32)
    call = {"gang_from_numpy": lambda: gang_from_numpy([plane] * 6),
            "ring_from_numpy": lambda: ring_from_numpy(plane, plane,
                                                       plane.view(np.int32)),
            "GangTable.empty": lambda: GangTable.empty(4, 2, 2)}
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in call[name]())
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call[name]()


def _txn_entries():
    from repro_torch.kernels import (
        WitnessTable,
        txn_probe,
        witness_gc,
        witness_record_seq,
    )
    from repro_torch.sim import run_batched_throughput, run_txn_crash_scenario

    return {
        "txn_probe": lambda: txn_probe(WitnessTable.empty(16, 2), [1, 2],
                                       [3, 4]),
        "witness_gc": lambda: witness_gc(WitnessTable.empty(16, 2), [1], [3]),
        "witness_record_seq": lambda: witness_record_seq(
            WitnessTable.empty(16, 2), [1], [3]),
        "run_txn_crash_scenario": lambda: run_txn_crash_scenario(
            n_shards=2, n_txns=4, witness_backend="device"),
        "run_batched_throughput": lambda: run_batched_throughput(
            n_shards=2, batch_size=8, n_batches=1, witness_backend="device"),
    }


@pytest.mark.parametrize("name", ["txn_probe", "witness_gc",
                                  "witness_record_seq",
                                  "run_txn_crash_scenario",
                                  "run_batched_throughput"])
def test_txn_entry_runs_on_the_card_by_default(name):
    """The three table ops on a table made on the default device, and the
    sim's entry points with the device backend, launch kernels on the card;
    without one they raise."""
    from repro_torch.kernels import ops

    call = _txn_entries()[name]
    if torch.cuda.is_available():
        before = sum(k.launches for k in ops.KERNELS)
        call()
        assert sum(k.launches for k in ops.KERNELS) > before
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


def test_txn_cuda_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import WitnessTable, ops

    table = WitnessTable.empty(16, 2, device="cpu")
    with pytest.raises(ValueError, match="CUDA launcher"):
        ops.txn_probe_cuda(table, *ops.txn_probe_operands(table, [1], [2]))
    with pytest.raises(ValueError, match="CUDA launcher"):
        ops.witness_gc_cuda(table, *ops.table_gc_operands(table, [1], [2]))
    with pytest.raises(ValueError, match="CUDA launcher"):
        ops.witness_record_seq_cuda(table,
                                    *ops.seq_operands(table, [1], [2]))


def test_txn_ops_refuse_devices_they_have_no_kernel_for():
    from repro_torch.kernels import (
        WitnessTable,
        txn_probe,
        witness_gc,
        witness_record_seq,
    )

    table = WitnessTable(*(torch.zeros((16, 2), dtype=torch.int32,
                                       device="meta") for _ in range(3)))
    for call in (lambda: txn_probe(table, [1], [2]),
                 lambda: witness_gc(table, [1], [2]),
                 lambda: witness_record_seq(table, [1], [2])):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
