"""The port's dry run (``repro_torch.launch.dryrun``), in subprocesses.

Twins of ``tests/test_dryrun_smoke.py``'s three cells at ``--mesh 4x4
--no-probes``: each cell runs on ``meta`` tensors under a fake process
group of 16 ranks in a process of its own, must come out ``ok`` with
FLOPs counted and a dominant roofline term, within 120 s.  And the
dry run counts one device's work: a cell whose every token is sharded
over the whole mesh (mamba2-130m's train_4k, batch over both axes)
counts a quarter of the 1 x 1 FLOPs on 2 x 2.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _dryrun(tmp_path, *args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--out", str(tmp_path)] + list(args),
        capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env)
    assert done.returncode == 0, done.stderr[-2000:]
    return done


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", "train_4k"),
    ("qwen3-moe-30b-a3b", "decode_32k"),
    ("mamba2-130m", "long_500k"),
])
def test_dryrun_small_mesh(arch, shape, tmp_path):
    _dryrun(tmp_path, "--arch", arch, "--shape", shape, "--mesh", "4x4",
            "--no-probes")
    arts = list(tmp_path.glob("*.json"))
    assert [a.name for a in arts] == [f"{arch}__{shape}__4x4.json"]
    rec = json.loads(arts[0].read_text())
    assert rec["status"] == "ok", rec
    assert rec["n_devices"] == 16
    assert rec["flops_per_device"] > 0
    assert rec["terms"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["argument_bytes"] > 0


def test_dryrun_counts_one_devices_flops(tmp_path):
    recs = {}
    for mesh in ("1x1", "2x2"):
        _dryrun(tmp_path, "--arch", "mamba2-130m", "--shape", "train_4k",
                "--mesh", mesh)
        recs[mesh] = json.loads(
            (tmp_path / f"mamba2-130m__train_4k__{mesh}.json").read_text())
    assert all(r["status"] == "ok" for r in recs.values()), recs
    one, four = recs["1x1"], recs["2x2"]
    assert four["flops_per_device"] * 4 == pytest.approx(
        one["flops_per_device"], rel=1e-9)
    assert one["collective_bytes_per_device"] == 0
    assert four["collective_bytes_per_device"] > 0


def test_dryrun_records_an_inapplicable_cell_as_skipped(tmp_path):
    _dryrun(tmp_path, "--arch", "hubert-xlarge", "--shape", "decode_32k",
            "--mesh", "2x2")
    rec = json.loads(
        (tmp_path / "hubert-xlarge__decode_32k__2x2.json").read_text())
    assert rec["status"] == "skipped"
    assert rec["skip_reason"] == "encoder-only: no decode step"
