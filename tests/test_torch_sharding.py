"""The port's sharding rules, mesh constants and roofline parser against the
JAX package's (``repro_torch.launch.{sharding,mesh,hlo_analysis}``).

Twins of ``tests/test_distribution_utils.py``'s ``TestSanitize``,
``TestHloParser`` and ``TestRooflineMath`` (the last with the H100's
constants), then every spec function of the port held to the reference's
entry by entry: ``param_specs``, ``param_specs_decode``, ``batch_pspecs``
and ``cache_pspecs`` for every arch x shape in this process (they need no
device), and ``activation_rules`` for every arch x shape x strategy on a
4 x 4 mesh, the JAX side in one subprocess of 16 host devices (this
process keeps its one device).  The port's mesh is a ``DeviceMesh`` made
without a process group (rules read only its names and shape).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS, SHAPES
from repro.launch import sharding as ref_sh
from repro.launch.hlo_analysis import collective_bytes as ref_collective_bytes
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import SHAPES as PORT_SHAPES
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import sharding as sh
from repro_torch.launch.hlo_analysis import (
    analytic_hbm_bytes,
    collective_bytes,
    roofline_terms,
)
from repro_torch.models import Transformer

ROOT = Path(__file__).resolve().parents[1]
AX = {"data": 16, "model": 16}
P = sh.P
STRATEGIES = ("seq", "tp", "moe_ep", "hp")


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _plain(tree):
    """A spec tree (either package's) as nested dicts / lists of tuples."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    assert isinstance(tree, (JP, sh.P)), tree
    return tuple(tree)


def _mesh(shape=(4, 4), axes=("data", "model")):
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for d in shape:
        n *= d
    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes, _init_backend=False, _rank=0)


class TestSanitize:
    def test_drops_nondivisible_axes(self):
        specs = {"embed": P("model", "data")}
        out = sh.sanitize_specs(specs, {"embed": _meta(50280, 768)}, AX)
        assert out["embed"] == P(None, "data")   # 50280 % 16 != 0; 768 ok

    def test_tuple_axes_product(self):
        specs = {"x": P(("pod", "data"), None)}
        out = sh.sanitize_specs(specs, {"x": _meta(48, 8)},
                                {"pod": 2, "data": 16, "model": 16})
        assert out["x"] == P(None, None)          # 48 % 32 != 0
        out2 = sh.sanitize_specs(specs, {"x": _meta(64, 8)},
                                 {"pod": 2, "data": 16})
        assert out2["x"] == P(("pod", "data"), None)

    @pytest.mark.parametrize("arch", sorted(ARCHS))
    def test_param_specs_cover_every_leaf(self, arch):
        """The port's state dict (built on meta) has exactly one spec per
        parameter, of at most its rank, after the unstacking walk."""
        cfg = PORT_ARCHS[arch]
        named = dict(Transformer(cfg, device="meta").named_parameters())
        for specs in (sh.param_specs(cfg, tp=16),
                      sh.param_specs_decode(cfg, tp=16)):
            out = sh.sanitize_specs(sh.state_specs(cfg, specs), named, AX)
            assert out.keys() == named.keys()
            for name, spec in out.items():
                assert len(spec) == named[name].ndim, (name, spec)


class TestHloParser:
    def test_counts_result_bytes_by_type(self):
        hlo = """
  %all-gather.1 = bf16[16,2048]{1,0} all-gather(bf16[1,2048] %p), replica_groups={}
  %ar = f32[128]{0} all-reduce(f32[128] %x), to_apply=%add
  %rs = (f32[64]{0}, f32[64]{0}) reduce-scatter(%a, %b), dimensions={0}
  %done = f32[8] all-gather-done(%start)
"""
        out = collective_bytes(hlo)
        assert out["all-gather"] == 16 * 2048 * 2
        assert out["all-reduce"] == 128 * 4
        assert out["reduce-scatter"] == 2 * 64 * 4
        assert out["n_all-gather"] == 1   # -done lines don't double count
        assert out == ref_collective_bytes(hlo)

    def test_start_forms_counted_once(self):
        hlo = "%s = bf16[256]{0} all-reduce-start(bf16[256] %x)\n" \
              "%d = bf16[256]{0} all-reduce-done(%s)\n"
        out = collective_bytes(hlo)
        assert out["all-reduce"] == 256 * 2
        assert out["n_all-reduce"] == 1


class TestRooflineMath:
    def test_dominant_selection(self):
        pk, hbm, ici = (port_mesh.PEAK_FLOPS_BF16, port_mesh.HBM_BW,
                        port_mesh.ICI_BW)
        t = roofline_terms(pk, 0, ici * 2.0, peak_flops=pk, hbm_bw=hbm,
                           ici_bw=ici, analytic_bytes_per_device=hbm * 0.5)
        assert t["compute_s"] == pytest.approx(1.0)
        assert t["memory_s"] == pytest.approx(0.5)
        assert t["collective_s"] == pytest.approx(2.0)
        assert t["dominant"] == "collective"
        assert t["bound_step_s"] == pytest.approx(2.0)

    def test_analytic_bytes_scales_sanely(self):
        cfg = PORT_ARCHS["llama3.2-1b"]
        train = analytic_hbm_bytes(cfg, PORT_SHAPES["train_4k"], 256, 16, 16)
        dec = analytic_hbm_bytes(cfg, PORT_SHAPES["decode_32k"], 256, 16, 16)
        assert train > dec
        assert dec < cfg.n_params() * 2


def test_mesh_constants_are_the_h100s():
    """NVIDIA's H100 SXM5 data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s
    HBM3, 450 GB/s NVLink 4 each way, 80 GB."""
    assert port_mesh.PEAK_FLOPS_BF16 == 989e12
    assert port_mesh.HBM_BW == 3.35e12
    assert port_mesh.ICI_BW == 450e9
    assert port_mesh.HBM_BYTES == 80e9


def test_spec_type_compares_as_partition_spec_does():
    for entries in [(None,), ("a",), (("a",),), ((),), (("a", "b"), None),
                    (["a"], "b")]:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries
    assert P(("data",), None) == P("data", None)
    assert P("data") != P("model")


def test_to_placements_on_tuple_entries():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh((2, 4, 4), ("pod", "data", "model"))
    assert sh.to_placements(mesh, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.to_placements(mesh, P(None, ("data", "model"))) == (
        Replicate(), Shard(1), Shard(1))
    assert sh.to_placements(mesh, P()) == (Replicate(),) * 3
    for bad in (P("model", "model"), P(("model", "data")), P("x")):
        with pytest.raises(ValueError):
            sh.to_placements(mesh, bad)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch):
    cfg, pcfg = ARCHS[arch], PORT_ARCHS[arch]
    for tp in (1, 4, 16):
        assert _plain(sh.param_specs(pcfg, tp=tp)) == _plain(
            ref_sh.param_specs(cfg, tp=tp)), tp
        assert _plain(sh.param_specs_decode(pcfg, tp=tp)) == _plain(
            ref_sh.param_specs_decode(cfg, tp=tp)), tp
    want = _plain(ref_sh.opt_specs(ref_sh.param_specs(cfg)))
    assert _plain(sh.opt_specs(sh.param_specs(pcfg))) == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_specs_equal_the_reference(arch):
    cfg, pcfg = ARCHS[arch], PORT_ARCHS[arch]
    for name in SHAPES:
        shape, pshape = SHAPES[name], PORT_SHAPES[name]
        for multi_pod in (False, True):
            for labels in (False, True):
                for n_dev in (16, 256, 512):
                    got = sh.batch_pspecs(pcfg, pshape, multi_pod=multi_pod,
                                          with_labels=labels, n_dev=n_dev)
                    want = ref_sh.batch_pspecs(cfg, shape,
                                               multi_pod=multi_pod,
                                               with_labels=labels,
                                               n_dev=n_dev)
                    assert _plain(got) == _plain(want), (name, n_dev)
            if cfg.can_decode:
                assert _plain(sh.cache_pspecs(
                    pcfg, pshape, multi_pod=multi_pod)) == _plain(
                    ref_sh.cache_pspecs(cfg, shape, multi_pod=multi_pod))


def test_sanitized_specs_equal_the_reference():
    """``sanitize_specs`` over the reference's abstract params and the
    port's meta state: the same entries, layer for layer."""
    from repro.models.transformer import init_params

    for arch in ("smollm-360m", "qwen2-moe-a2.7b", "mamba2-130m"):
        cfg, pcfg = ARCHS[arch], PORT_ARCHS[arch]
        shapes = jax.eval_shape(
            lambda c=cfg: init_params(c, jax.random.PRNGKey(0)))
        want = ref_sh.sanitize_specs(ref_sh.param_specs(cfg), shapes, AX)
        named = dict(Transformer(pcfg, device="meta").named_parameters())
        got = sh.sanitize_specs(sh.state_specs(pcfg, sh.param_specs(pcfg)),
                                named, AX)
        flat = sh.state_specs(pcfg, jax.tree_util.tree_map(
            lambda s: sh.P(*s), want, is_leaf=lambda x: isinstance(x, JP)))
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in flat.items()}, arch


_JAX_RULES = r"""
import json, sys
import jax
from repro.configs import ARCHS, SHAPES
from repro.launch import sharding as sh
from repro.launch.mesh import make_mesh_from
mesh = make_mesh_from((4, 4), ("data", "model"))
assert len(jax.devices()) == 16
out = {}
for arch, cfg in ARCHS.items():
    for name, shape in SHAPES.items():
        for strategy in sys.argv[1].split(","):
            key = f"{arch}|{name}|{strategy}"
            try:
                rules = sh.activation_rules(cfg, shape, mesh,
                                            multi_pod=False,
                                            strategy=strategy)
                out[key] = {k: list(r.spec) for k, r in rules.items()}
            except Exception:   # NamedSharding's DuplicateSpecError
                out[key] = "raises"
print(json.dumps(out))
"""


def _jsonable(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_activation_rules_equal_the_reference_on_4x4():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    done = subprocess.run(
        [sys.executable, "-c", _JAX_RULES, ",".join(STRATEGIES)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    want = json.loads(done.stdout.strip().splitlines()[-1])
    mesh = _mesh()
    got = {}
    for arch in ARCHS:                   # the reference's, from the port
        cfg = PORT_ARCHS[arch]
        for name, shape in PORT_SHAPES.items():
            for strategy in STRATEGIES:
                key = f"{arch}|{name}|{strategy}"
                try:
                    rules = sh.activation_rules(cfg, shape, mesh,
                                                multi_pod=False,
                                                strategy=strategy)
                    got[key] = {k: _jsonable(r.spec)
                                for k, r in rules.items()}
                    assert all(r.mesh is mesh for r in rules.values())
                except ValueError:
                    got[key] = "raises"
    assert len(got) == len(ARCHS) * len(SHAPES) * len(STRATEGIES)
    assert got == want
    raising = sorted(k for k, v in got.items() if v == "raises")
    assert raising, "some tp cell names the model axis twice on 4 x 4"


def test_launch_modules_import_no_jax_and_make_no_group():
    code = (
        "import sys\n"
        "import repro_torch.launch.mesh, repro_torch.launch.sharding\n"
        "import repro_torch.launch.hlo_analysis, repro_torch.launch.dryrun\n"
        "import torch.distributed as dist\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "assert not dist.is_initialized()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
