"""Backup checkpoint replicas for CURP-FT.

Backups hold *ordered* state (the full params/opt state at a step), exactly
like the paper's backups hold the ordered op log.  `sync_every` steps of
journal records batch into one backup sync (§4.4); f replicas tolerate f-1
replica losses on top of the master loss.

Checkpoints are written atomically (tmp + rename) with a manifest carrying
the step and a content checksum, so a crash mid-sync never corrupts the
newest complete replica.

The torch port of ``repro.ft.checkpoint``.  A state is a mapping of trees
(``{"params": module or state dict, "opt": {"m": ..., "v": ..., "step":
...}}``), flattened to keys such as ``params::blocks.3.attn.wq`` and
``opt::m.blocks.3.attn.wq``.  ``host_snapshot`` copies it to the host once
per sync, as raw bytes (numpy has no bf16: every tensor is kept as its
bits, and the manifest records its dtype and shape), and hashes it once;
each replica writes those bytes to ``state.bin`` and the digest to its
manifest.  ``restore`` hashes the file again before it loads a byte.
"""
from __future__ import annotations

import hashlib
import json
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.transformer import resolve_device, torch_dtype

ALIGN = 64      # byte alignment of each tensor in state.bin


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    for name, v in tree.items():
        if isinstance(v, (Mapping, nn.Module)):
            _flatten(v, f"{prefix}{name}.", out)
        else:
            out[f"{prefix}{name}"] = v


def flatten_state(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": tree, "opt": tree}`` -> ``{"params::a.b": tensor}``."""
    out: Dict[str, torch.Tensor] = {}
    for tree_name, tree in state.items():
        _flatten(tree, f"{tree_name}::", out)
    return out


@dataclass
class HostState:
    """A state's bytes on the host, in key order, with its index and the
    SHA-256 of their concatenation (what ``state.bin`` holds)."""
    buffers: List[np.ndarray]         # uint8, one per tensor
    index: List[Dict[str, Any]]       # key, dtype, shape, offset, nbytes
    sha256: str
    nbytes: int


def host_snapshot(state: Mapping[str, Any]) -> HostState:
    """Copy a state to the host once and hash it once (every replica of a
    sync writes the same bytes)."""
    flat = flatten_state(state)
    h = hashlib.sha256()
    buffers, index, off = [], [], 0
    for key, t in flat.items():
        if off % ALIGN:              # so each tensor views its own dtype
            pad = np.zeros(ALIGN - off % ALIGN, np.uint8)
            h.update(pad)
            buffers.append(pad)
            off += pad.nbytes
        t = t.detach()
        raw = t.reshape(-1).view(torch.uint8).cpu().numpy()
        h.update(raw)
        buffers.append(raw)
        index.append({"key": key, "dtype": str(t.dtype).split(".")[-1],
                      "shape": list(t.shape), "offset": off,
                      "nbytes": raw.nbytes})
        off += raw.nbytes
    return HostState(buffers, index, h.hexdigest(), off)


class BackupReplica:
    def __init__(self, root: Path, replica_id: int) -> None:
        self.root = Path(root) / f"backup{replica_id}"
        self.root.mkdir(parents=True, exist_ok=True)
        self.replica_id = replica_id
        self.epoch = 0

    def sync(self, step: int, state: Union[HostState, Mapping[str, Any]],
             epoch: int = 0) -> bool:
        """Atomic full-state checkpoint at `step` (zombie-fenced by epoch)."""
        if epoch < self.epoch:
            return False   # §4.7: reject deposed masters
        self.epoch = epoch
        if not isinstance(state, HostState):
            state = host_snapshot(state)
        tmp = self.root / f".tmp_step{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        with (tmp / "state.bin").open("wb") as f:
            for buf in state.buffers:
                f.write(memoryview(buf))
        (tmp / "manifest.json").write_text(json.dumps({
            "step": step, "epoch": epoch, "sha256": state.sha256,
            "tensors": state.index,
        }))
        final = self.root / f"step{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        # keep only the 2 newest
        steps = sorted(self._steps())
        for s in steps[:-2]:
            shutil.rmtree(self.root / f"step{s}")
        return True

    def _steps(self) -> List[int]:
        return [
            int(p.name[4:]) for p in self.root.glob("step*")
            if (p / "manifest.json").exists()
        ]

    def newest_step(self) -> Optional[int]:
        steps = self._steps()
        return max(steps) if steps else None

    def restore(self, step: int
                ) -> Tuple[Dict[str, Dict[str, torch.Tensor]], int]:
        """The state synced at ``step`` as CPU tensors, ``{"params": {key:
        tensor}, "opt": {key: tensor}}``; raises ``IOError`` if the file's
        bytes do not hash to the manifest's digest."""
        d = self.root / f"step{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        path = d / "state.bin"
        raw = bytearray(path.stat().st_size)
        with path.open("rb") as f:
            f.readinto(raw)
        if hashlib.sha256(raw).hexdigest() != manifest["sha256"]:
            raise IOError(f"checksum mismatch in {d}")
        data = torch.frombuffer(raw, dtype=torch.uint8) if raw else None
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for e in manifest["tensors"]:
            tree_name, key = e["key"].split("::", 1)
            t = data[e["offset"]:e["offset"] + e["nbytes"]]
            out.setdefault(tree_name, {})[key] = (
                t.view(torch_dtype(e["dtype"])).reshape(e["shape"]))
        return out, manifest["step"]


def restore_into(template, flat: Mapping[str, torch.Tensor], device="cuda"):
    """Rebuild a state congruent with ``template`` from flattened tensors,
    on ``device``: a module (built on ``meta``) is moved there with
    ``to_empty`` and loads ``flat`` strictly; a nested dict of tensors is
    rebuilt key for key.  Every key, shape and dtype must match."""
    device = resolve_device(device)
    want: Dict[str, torch.Tensor] = {}
    _flatten(template, "", want)
    if want.keys() != flat.keys():
        raise KeyError("restored state and template differ in keys: "
                       f"{sorted(set(want) ^ set(flat))[:4]}")
    for k, t in want.items():
        if t.dtype != flat[k].dtype or t.shape != flat[k].shape:
            raise ValueError(f"{k}: restored {flat[k].dtype} "
                             f"{tuple(flat[k].shape)}, the template holds "
                             f"{t.dtype} {tuple(t.shape)}")
    if isinstance(template, nn.Module):
        module = template.to_empty(device=device)
        module.load_state_dict(flat, strict=True)
        return module
    return _unflatten_like(template, flat, "", device)


def _unflatten_like(template, flat, prefix: str, device):
    out = {}
    for name, v in template.items():
        if isinstance(v, Mapping):
            out[name] = _unflatten_like(v, flat, f"{prefix}{name}.", device)
        else:
            out[name] = flat[f"{prefix}{name}"].to(device)
    return out
