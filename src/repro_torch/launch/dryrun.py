"""Dry run of the sharded step: per-device FLOPs, bytes, collectives and
the roofline terms of every (arch x shape) cell on a production mesh, with
no device and no allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh 4x4 --out /tmp/dr

The torch port of ``repro.launch.dryrun``, with its flags, artifact names
and record keys where they mean the same thing.  The reference lowers each
cell on 256 or 512 placeholder XLA devices and reads XLA's cost analysis;
the port runs the step itself, eagerly, on ``meta`` tensors:

* each cell runs in a process of its own, under a fake process group
  (``FakeStore``) as large as the mesh, as rank 0, so no fake group leaks
  into the caller; the mesh is a CUDA ``DeviceMesh`` over that group, so
  DTensor picks the collectives it would pick on cards;
* parameters, batch, decode cache and optimizer state are DTensors laid
  out by the ported specs (``launch.sharding``: training or decode
  parameter specs, sanitized), and the step that ``launch.steps`` makes
  for the cell's kind runs under ``activation_rules`` for ``--strategy``;
* a dispatch mode below DTensor sees what rank 0 runs: the FLOPs of each
  local op by ``FlopCounterMode``'s formulas (``FlopCounterMode`` itself
  sits above DTensor and counts global shapes), the bytes every local op
  reads and writes (unfused, as XLA's 'bytes accessed' counts them), and
  the result bytes of every collective by type (``collective_bytes``'
  rule);
* HBM bytes come from ``analytic_hbm_bytes`` and the three terms from
  ``roofline_terms`` with the H100's constants (``launch.mesh``).

Eager mode runs every layer, where XLA counts a scan body once, so there
is no probe correction; ``--no-probes`` is accepted and changes nothing.
A cell whose step the fake group cannot carry (an op DTensor cannot shard)
is recorded as ``skipped`` with the exception's text as its reason.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..configs import ARCHS, SHAPES, applicable, batch_specs, cache_specs
from ..configs import get_arch
from ..configs.shapes import ShapeSpec
from ..models.config import ModelConfig
from ..models.shardctx import activation_sharding
from ..models.transformer import Transformer
from ..optim import AdamWConfig
from . import sharding as sh
from .hlo_analysis import analytic_hbm_bytes, roofline_terms
from .mesh import (
    HBM_BW, HBM_BYTES, ICI_BW, PEAK_FLOPS_BF16,
    make_mesh_from, make_production_mesh,
)
from .steps import make_prefill_step, make_serve_step, make_train_step

# Functional collectives by the XLA instruction they stand for.
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors_in(items) -> list:
    """The tensors among ``items`` and in their lists and tuples (an op's
    arguments or results; cheaper than a pytree walk per op)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _site() -> Tuple[str, str]:
    """Where a collective comes from: the innermost frame of the port's
    model or step code (``function:line``), and the autograd node whose
    backward runs it ("forward" outside the backward pass)."""
    import sys

    frame = sys._getframe(2)
    where = "?"
    while frame is not None:
        path = frame.f_code.co_filename
        if "repro_torch" in path and not path.endswith("dryrun.py"):
            where = f"{Path(path).stem}.{frame.f_code.co_name}:" \
                    f"{frame.f_lineno}"
            break
        frame = frame.f_back
    node = torch._C._current_autograd_node()
    return where, type(node).__name__ if node is not None else "forward"


def _step_counter():
    """A ``TorchDispatchMode`` that counts what one rank runs (built on
    call: it imports DTensor and the fake tensor class)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class StepCounter(TorchDispatchMode):
        """An op on DTensors is left to DTensor (``NotImplemented``), which
        runs its local op and its collectives on plain tensors, through
        this mode again.  DTensor's sharding propagation runs each op once
        more on fake tensors of the global shapes (whose meta kernels also
        pass through here); those are not counted."""

        def __init__(self) -> None:
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.largest, self.largest_op = 0, None
            self.by_site: Dict[tuple, int] = {}
            self.coll = {k: 0 for k in _KINDS}
            self.n_coll = {k: 0 for k in _KINDS}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            first = out[0] if isinstance(out, (tuple, list)) and out else out
            if (torch._C._meta_in_tls_dispatch_include()
                    or any(issubclass(t, FakeTensor) for t in types)
                    or isinstance(first, FakeTensor)):
                return out      # a fake tensor's meta kernel, not a step op
            ins = _tensors_in(args) + _tensors_in(kwargs.values())
            outs = _tensors_in((out,))
            packet = func._overloadpacket
            if packet.__name__ == "wait_tensor":     # the collective's end
                return out
            kind = (_COLLECTIVES.get(packet.__name__)
                    if func.namespace in _COLLECTIVE_NAMESPACES else None)
            if kind is not None:
                n = sum(_nbytes(o) for o in outs)
                self.coll[kind] += n
                self.n_coll[kind] += 1
                site = (kind,) + _site()
                self.by_site[site] = self.by_site.get(site, 0) + n
                return out
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if not func.is_view:
                self.bytes += (sum(_nbytes(a) for a in ins)
                               + sum(_nbytes(o) for o in outs))
            big = max([0] + [_nbytes(o) for o in outs])
            if big > self.largest:
                self.largest, self.largest_op = big, str(func)
            return out

        def collectives(self) -> Dict[str, int]:
            return {**self.coll,
                    **{f"n_{k}": v for k, v in self.n_coll.items()}}

        def top_sites(self, n: int = 12) -> list:
            """The call sites that moved the most collective bytes."""
            top = sorted(self.by_site.items(), key=lambda kv: -kv[1])[:n]
            return [{"kind": k[0], "site": k[1], "pass": k[2], "bytes": v}
                    for k, v in top]

    return StepCounter()


def _moment_dtype(cfg: ModelConfig) -> str:
    # bf16 moments for the memory-bound giant, as the reference keeps them.
    return "bfloat16" if cfg.name.startswith("nemotron") else "float32"


def _local_bytes(tensors) -> int:
    return sum(_nbytes(getattr(t, "_local_tensor", t)) for t in tensors)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               multi_pod: bool):
    """The cell's step and its arguments, all DTensors on ``meta`` laid
    out by the ported specs; and the local bytes of each argument."""
    sizes = sh.axis_sizes(mesh)
    tp = sizes.get("model", 1)
    n_dev = mesh.size()
    model = Transformer(cfg, device="meta")
    raw = (sh.param_specs_decode(cfg, tp=tp) if shape.kind == "decode"
           else sh.param_specs(cfg, tp=tp))
    named = dict(model.named_parameters())
    pspec = sh.sanitize_specs(sh.state_specs(cfg, raw), named, sizes)
    sh.distribute_model(model, mesh, pspec)
    train = shape.kind == "train"
    batch_meta = batch_specs(cfg, shape, with_labels=train)
    bspec = sh.sanitize_specs(
        sh.batch_pspecs(cfg, shape, multi_pod=multi_pod, with_labels=train,
                        n_dev=n_dev),
        batch_meta, sizes)
    batch = sh.distribute_tree(mesh, batch_meta, bspec)
    mem = {"param_bytes": _local_bytes(model.parameters()),
           "batch_bytes": _local_bytes(_tensors(batch))}
    if train:
        opt_cfg = AdamWConfig(moment_dtype=_moment_dtype(cfg))
        mdt = getattr(torch, opt_cfg.moment_dtype)
        zeros = {k: torch.empty(p.shape, dtype=mdt, device="meta")
                 for k, p in named.items()}
        ospec = sh.opt_specs(pspec)
        opt = {"m": sh.distribute_tree(mesh, zeros, ospec["m"]),
               "v": sh.distribute_tree(mesh, dict(zeros), ospec["v"]),
               "step": sh.distribute(
                   mesh, torch.empty((), dtype=torch.int32, device="meta"),
                   ospec["step"])}
        mem["opt_bytes"] = _local_bytes(_tensors(opt["m"])
                                        + _tensors(opt["v"]))
        # the step holds every gradient at once (autograd.grad)
        mem["grad_bytes"] = mem["param_bytes"]
        step = make_train_step(cfg, opt_cfg)
        return (lambda: step(model, opt, batch)), mem
    if shape.kind == "prefill":
        step = make_prefill_step(cfg)
        return (lambda: step(model, batch)), mem
    cache_meta = cache_specs(cfg, shape)
    cspec = sh.sanitize_specs(
        sh.cache_pspecs(cfg, shape, multi_pod=multi_pod), cache_meta, sizes)
    cache = sh.distribute_tree(mesh, cache_meta, cspec)
    mem["cache_bytes"] = _local_bytes(_tensors(cache))
    step = make_serve_step(cfg)
    return (lambda: step(model, batch, cache)), mem


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    n_act = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch   # decode: 1 token per sequence


def run_cell(arch: str, shape_name, mesh, mesh_tag: str, *,
             multi_pod: bool, strategy: str = "seq",
             remat: bool = True) -> dict:
    """One cell's record, on ``mesh`` (a DeviceMesh over a fake process
    group as large as the mesh, this process rank 0).  ``shape_name`` is
    a name of ``SHAPES`` or a ``ShapeSpec`` (a cell cut to another
    batch)."""
    cfg = get_arch(arch)
    if not remat:
        from dataclasses import replace as _replace

        cfg = _replace(cfg, remat=False)
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else SHAPES[shape_name])
    shape_name = shape.name
    ok, skip = applicable(cfg, shape)
    n_dev = mesh.size()
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "multi_pod": multi_pod, "n_devices": n_dev, "strategy": strategy,
    }
    if not ok:
        rec.update(status="skipped", skip_reason=skip)
        return rec
    t0 = time.time()
    rules = sh.activation_rules(cfg, shape, mesh, multi_pod=multi_pod,
                                strategy=strategy)
    step, mem = build_cell(cfg, shape, mesh, multi_pod=multi_pod)
    counter = _step_counter()
    try:
        with activation_sharding(rules), counter:
            step()
    except Exception as e:   # an op the fake group cannot carry: say which
        rec.update(status="skipped",
                   skip_reason=f"the fake process group cannot carry this "
                               f"cell's step: {type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-2000:])
        return rec
    t1 = time.time()
    axis = sh.axis_sizes(mesh)
    tp = axis.get("model", 1)
    dp = n_dev // tp
    flops_dev = float(counter.flops)
    bytes_dev = float(counter.bytes)
    coll = counter.collectives()
    coll_dev = float(sum(v for k, v in coll.items()
                         if not k.startswith("n_")))
    analytic_bytes = analytic_hbm_bytes(cfg, shape, n_dev, tp, dp)
    terms = roofline_terms(
        flops_dev, bytes_dev, coll_dev,
        peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, ici_bw=ICI_BW,
        analytic_bytes_per_device=analytic_bytes,
    )
    mflops = model_flops(cfg, shape)
    counted_total = flops_dev * n_dev
    argument = sum(mem.values())
    peak = argument + counter.largest
    rec.update(
        status="ok",
        trace_s=round(t1 - t0, 2),
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        analytic_bytes_per_device=analytic_bytes,
        collective_bytes_per_device=coll_dev,
        collectives=coll,
        collectives_by_site=counter.top_sites(),
        memory={
            **mem,
            "argument_bytes": argument,
            "largest_activation_bytes": counter.largest,
            "largest_activation_op": counter.largest_op,
            "peak_bytes_est": peak,
            "fits_80GB": bool(peak < HBM_BYTES),
            # the local shards are exact; the activation is the largest
            # tensor one op wrote, so the peak is a lower bound
            "estimates": ["largest_activation_bytes", "peak_bytes_est",
                          "fits_80GB"],
        },
        terms=terms,
        model_flops_total=mflops,
        counted_flops_total=counted_total,
        useful_flops_ratio=(mflops / counted_total if counted_total else 0.0),
        roofline_fraction=(
            (mflops / n_dev / PEAK_FLOPS_BF16) / terms["bound_step_s"]
            if terms["bound_step_s"] > 0 else 0.0
        ),
    )
    return rec


def mesh_for(dims: Tuple[int, ...]):
    """The production mesh for 16x16 and 2x16x16, else a test mesh with
    the trailing axis names; CUDA-typed, over the default group."""
    if dims == (16, 16):
        return make_production_mesh(multi_pod=False)
    if dims == (2, 16, 16):
        return make_production_mesh(multi_pod=True)
    return make_mesh_from(dims, ("pod", "data", "model")[-len(dims):])


def _cell_in_process(arch: str, shape_name, dims: Tuple[int, ...],
                     mesh_tag: str, strategy: str, remat: bool) -> dict:
    """``run_cell`` in this (fresh) process under a fake process group of
    the mesh's size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1
    for d in dims:
        n *= d
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        return run_cell(arch, shape_name, mesh_for(dims), mesh_tag,
                        multi_pod=len(dims) == 3, strategy=strategy,
                        remat=remat)
    finally:
        dist.destroy_process_group()


def run_cell_isolated(arch: str, shape_name, dims: Tuple[int, ...],
                      mesh_tag: str, *, strategy: str = "seq",
                      remat: bool = True) -> dict:
    """``run_cell`` in a spawned process of its own."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
        return pool.submit(_cell_in_process, arch, shape_name, tuple(dims),
                           mesh_tag, strategy, remat).result()


def main() -> None:
    ap = argparse.ArgumentParser(description="CURP framework dry-run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="16x16",
                    help="16x16 | 2x16x16 | RxC (test meshes)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default=None, help="variant tag for perf runs")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted for the reference's command lines; "
                         "changes nothing (eager mode counts every layer, "
                         "so there is no scan correction to skip)")
    ap.add_argument("--strategy", default="seq",
                    choices=["seq", "tp", "moe_ep", "hp"],
                    help="activation sharding strategy (perf iterations)")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing (perf iterations)")
    args = ap.parse_args()

    dims = tuple(int(x) for x in args.mesh.split("x"))
    mesh_tag = args.mesh if args.tag is None else f"{args.mesh}+{args.tag}"
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")

    for arch in archs:
        for shape_name in shapes:
            fname = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json".replace(
                "/", "_"
            )
            if args.skip_existing and fname.exists():
                print(f"[skip-existing] {fname.name}")
                continue
            try:
                rec = run_cell_isolated(arch, shape_name, dims, mesh_tag,
                                        strategy=args.strategy,
                                        remat=not args.no_remat)
            except Exception as e:  # a cell failure is a bug — record it
                rec = {
                    "arch": arch, "shape": shape_name, "mesh": mesh_tag,
                    "status": "error", "error": repr(e),
                    "traceback": traceback.format_exc()[-2000:],
                }
            fname.write_text(json.dumps(rec, indent=1))
            s = rec.get("status")
            if s == "ok":
                t = rec["terms"]
                print(
                    f"[{arch} x {shape_name} x {mesh_tag}] OK "
                    f"trace={rec['trace_s']}s "
                    f"compute={t['compute_s']*1e3:.1f}ms "
                    f"mem={t['memory_s']*1e3:.1f}ms "
                    f"coll={t['collective_s']*1e3:.1f}ms "
                    f"dom={t['dominant']} "
                    f"roofline={rec['roofline_fraction']:.2f} "
                    f"fits={rec['memory']['fits_80GB']}",
                    flush=True,
                )
            elif s == "skipped":
                print(f"[{arch} x {shape_name}] SKIP: {rec['skip_reason']}",
                      flush=True)
            else:
                print(f"[{arch} x {shape_name} x {mesh_tag}] ERROR: "
                      f"{rec['error']}", flush=True)


if __name__ == "__main__":
    main()
