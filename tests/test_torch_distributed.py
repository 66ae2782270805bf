"""The port's sharded step on a 2 x 2 CPU mesh of gloo processes, against
the single-device run and the JAX package's.

Every multi-process case spawns 4 gloo processes on a free localhost port
and waits for them with a time limit of its own (a failure, never a hang).
Every JAX run on more than one device happens in one subprocess with
``--xla_force_host_platform_device_count=4`` (this process keeps its one
device).  Tolerances, all f32: outputs and losses within 1e-5 relative
plus 1e-5 of the tensor's largest magnitude (the collectives sum partial
products in other orders: a few 1e-6 at these sizes, 2.3e-5 on hymba's
logits of scale 5 under ``tp``, where the SSM's FSDP-sharded products go
through its exponentials), gradients within 1e-4 of each leaf's largest
magnitude, as the port's other f32 suites hold them.

* ``_sdpa_blockwise_flat`` against JAX's at S = 2048 (causal; SWA on a
  non-global layer) and against the port's grouped ``_sdpa_blockwise``;
* ``moe_mlp_shardmap`` under the ``moe_ep`` rules against JAX's shard_map
  on 2 x 2 host devices (outputs, ``aux`` and gradients against
  ``jax.grad``), with tokens sharded over both axes and replicated over
  "model";
* reduced forwards and losses on the 2 x 2 mesh equal to the one-device
  run: llama3.2-1b and hymba-1.5b under ``seq`` and ``tp`` (``tp`` at S =
  2048, where ``heads_are_tp`` takes the flat-heads attention), mamba2-130m
  under ``seq``, and qwen3-moe-30b-a3b (capacity dispatch) under
  ``moe_ep`` against JAX's forward under the same rules;
* ``constrain`` is the identity with no rules and on plain tensors;
* the train launcher with ``--distributed`` at world size 2 under
  torchrun: every rank's digest equals the one-process run's.
"""
import os
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from _port_cfg import reduced
from repro.models.layers import _sdpa_blockwise_flat as ref_flat
from repro_torch.models.layers import _sdpa_blockwise, _sdpa_blockwise_flat

ROOT = Path(__file__).resolve().parents[1]
OUT_TOL = 1e-5
GRAD_TOL = 1e-4
WORLD = 4
RANK_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# gloo processes
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, err_path):
    """One rank: join the gloo group, run ``fn(rank, *args)``, leave."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        try:
            fn(rank, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        Path(f"{err_path}.{rank}").write_text(traceback.format_exc())
        raise


def _run_ranks(fn, *args, tmp_path, world=WORLD, timeout=RANK_TIMEOUT_S):
    """``fn(rank, *args)`` in ``world`` spawned gloo processes; fails (and
    kills them) past ``timeout`` seconds or when any rank fails."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    err = tmp_path / "rank_error"
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, fn, args, str(err)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = [Path(f"{err}.{r}").read_text() for r in range(world)
              if Path(f"{err}.{r}").exists()]
    assert not hung, f"{len(hung)} ranks still running after {timeout} s"
    assert not errors and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs], errors[:1])


def _full(t):
    """A DTensor's whole value (a plain tensor, replicated, as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _mesh():
    from repro_torch.launch.mesh import make_mesh_from

    return make_mesh_from((2, 2), ("data", "model"), device_type="cpu")


# ---------------------------------------------------------------------------
# the JAX side: one subprocess on 2 x 2 host devices
# ---------------------------------------------------------------------------
_JAX_2X2 = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import ARCHS, ShapeSpec, concrete_batch
from repro.launch import sharding as sh
from repro.launch.mesh import make_mesh_from
from repro.models import forward, init_params, loss_fn
from repro.models.config import reduced
from repro.models.moe import init_moe_params, moe_forward
from repro.models.shardctx import activation_sharding

assert len(jax.devices()) == 4
out = {}
mesh = make_mesh_from((2, 2), ("data", "model"))
cfg = reduced(ARCHS["qwen3-moe-30b-a3b"], moe_dispatch="capacity")
p = init_moe_params(cfg, jax.random.PRNGKey(1), jnp.float32)
for k, v in p.items():
    out[f"moe_p_{k}"] = np.asarray(v)
for S in (256, 16):
    rng = np.random.default_rng(S)
    x = rng.normal(size=(4, S, cfg.d_model)).astype(np.float32)
    R = rng.normal(size=(4, S, cfg.d_model)).astype(np.float32)
    rules = sh.activation_rules(cfg, ShapeSpec("t", "train", S, 16), mesh,
                                multi_pod=False, strategy="moe_ep")
    with activation_sharding(rules):
        def L(x, p):
            o, aux = moe_forward(cfg, p, x)
            return jnp.sum(o * R) + 0.37 * aux, (o, aux)
        (_, (o, aux)), (gx, gp) = jax.value_and_grad(
            L, argnums=(0, 1), has_aux=True)(jnp.asarray(x), p)
    out.update({f"moe{S}_x": x, f"moe{S}_R": R, f"moe{S}_o": np.asarray(o),
                f"moe{S}_aux": np.asarray(aux), f"moe{S}_gx": np.asarray(gx)})
    for k, v in gp.items():
        out[f"moe{S}_g_{k}"] = np.asarray(v)

S = 256
params = init_params(cfg, jax.random.PRNGKey(0))
batch = concrete_batch(cfg, "train", 4, S, seed=3)
rules = sh.activation_rules(cfg, ShapeSpec("t", "train", S, 16), mesh,
                            multi_pod=False, strategy="moe_ep")
with activation_sharding(rules):
    logits, aux = jax.jit(lambda p, b: forward(cfg, p, b))(params, batch)
    loss, _ = jax.jit(lambda p, b: loss_fn(cfg, p, b))(params, batch)
out["fwd_logits"] = np.asarray(logits)
out["fwd_aux"] = np.asarray(aux)
out["fwd_loss"] = np.asarray(loss)
flat = jax.tree_util.tree_flatten_with_path(params)[0]
for path, leaf in flat:
    out["param/" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_2x2(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax2x2") / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    done = subprocess.run([sys.executable, "-c", _JAX_2X2, str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return dict(np.load(path))


def _unflatten_params(z):
    """The reference's parameter tree from the ``param/`` entries."""
    tree = {}
    for key, v in z.items():
        if not key.startswith("param/"):
            continue
        node = tree
        parts = key[len("param/"):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=OUT_TOL,
                               atol=OUT_TOL * max(scale, 1.0))


def _grad_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= GRAD_TOL * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# flat-heads attention (one process)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,is_global", [("llama3.2-1b", True),
                                            ("hymba-1.5b", False)])
def test_flat_attention_matches_jax_and_the_grouped_form(arch, is_global):
    """S = 2048 (four 512 blocks): causal full attention, and hymba's
    sliding window of 8 on a non-global layer."""
    cfg = reduced(ARCHS[arch])
    rng = np.random.default_rng(7)
    B, S, dh = 1, 2048, cfg.d_head
    q = rng.normal(size=(B, S, cfg.n_heads, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, cfg.n_kv_heads, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, cfg.n_kv_heads, dh)).astype(np.float32)
    want = np.asarray(ref_flat(cfg, jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), is_global=is_global))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _sdpa_blockwise_flat(cfg, tq, tk, tv, is_global=is_global)
    _close(got.numpy(), want)
    grouped = _sdpa_blockwise(cfg, tq, tk, tv, is_global=is_global)
    _close(got.numpy(), grouped.numpy())


def test_constrain_is_the_identity_without_rules_and_on_plain_tensors():
    from repro_torch.launch import sharding as sh
    from repro_torch.configs import ARCHS as PORT_ARCHS, SHAPES
    from repro_torch.models.shardctx import (
        activation_sharding,
        constrain,
        heads_are_tp,
    )
    from torch.distributed.device_mesh import DeviceMesh

    x = torch.randn(2, 8, 4, 16)
    for kind in ("residual", "heads", "kv_heads", "scores5", "logits"):
        assert constrain(x, kind) is x
    assert not heads_are_tp()
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"), _init_backend=False,
                      _rank=0)
    cfg = PORT_ARCHS["llama3.2-1b"]
    with activation_sharding(sh.activation_rules(
            cfg, SHAPES["train_4k"], mesh, multi_pod=False, strategy="tp")):
        assert heads_are_tp()
        for kind in ("residual", "heads", "kv_heads", "logits"):
            assert constrain(x, kind) is x
    assert not heads_are_tp()


# ---------------------------------------------------------------------------
# the shard_map MoE on 2 x 2
# ---------------------------------------------------------------------------
_MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def _moe_rank(rank, z_path, S, out_path):
    from repro_torch.configs import ARCHS as PA, ShapeSpec
    from repro_torch.launch import sharding as sh
    from repro_torch.models import reduced as preduced
    from repro_torch.models import moe as pmoe
    from repro_torch.models.layers import Init
    from repro_torch.models.shardctx import activation_sharding

    z = np.load(z_path)
    cfg = preduced(PA["qwen3-moe-30b-a3b"], moe_dispatch="capacity")
    mesh = _mesh()
    m = pmoe.MoE(cfg, Init(torch.device("meta"), torch.float32, 0)
                 ).to_empty(device="cpu")
    with torch.no_grad():
        for k in _MOE_KEYS:
            getattr(m, k).copy_(torch.from_numpy(z[f"moe_p_{k}"]))
    layer = sh.param_specs(cfg, tp=2)["layers"]["moe"]
    sh.distribute_model(m, mesh, {k: sh.P(*v[1:]) for k, v in layer.items()})
    rules = sh.activation_rules(cfg, ShapeSpec("t", "train", S, 16), mesh,
                                multi_pod=False, strategy="moe_ep")
    xs = rules["residual"].spec
    x = sh.distribute(mesh, torch.from_numpy(z[f"moe{S}_x"]), xs)
    x = x.detach().requires_grad_(True)
    R = sh.distribute(mesh, torch.from_numpy(z[f"moe{S}_R"]), xs)
    calls = []
    shardmap = pmoe.moe_mlp_shardmap
    pmoe.moe_mlp_shardmap = lambda *a: calls.append(1) or shardmap(*a)
    with activation_sharding(rules):
        o, aux = pmoe.moe_forward(cfg, m, x)
        ((o * R).sum() + 0.37 * aux).backward()
    res = {"o": o.full_tensor(), "aux": aux.full_tensor(),
           "gx": x.grad.full_tensor(), "calls": torch.tensor(len(calls))}
    for k in _MOE_KEYS:
        res[f"g_{k}"] = getattr(m, k).grad.full_tensor()
    if rank == 0:
        torch.save(res, out_path)


@pytest.mark.parametrize("S", [256, 16], ids=["tokens-sharded-2x2",
                                              "replicated-over-model"])
def test_moe_shardmap_matches_jax_on_2x2(S, jax_2x2, tmp_path):
    """At S = 256 the residual rule shards batch over "data" and sequence
    over "model"; at S = 16 the sequence stays whole, so every "model"
    rank routes the same tokens (their gradients must not count twice).
    The local capacity (8 x ceil) drops tokens at S = 256."""
    z_path = tmp_path / "in.npz"
    np.savez(z_path, **jax_2x2)
    out = tmp_path / "out.pt"
    _run_ranks(_moe_rank, str(z_path), S, str(out), tmp_path=tmp_path)
    got = torch.load(out)
    assert int(got["calls"]) == 1
    z = jax_2x2
    _close(got["o"].detach().numpy(), z[f"moe{S}_o"])
    _close(got["aux"].detach().numpy(), z[f"moe{S}_aux"])
    _grad_close(got["gx"], z[f"moe{S}_gx"], "x")
    for k in _MOE_KEYS:
        _grad_close(got[f"g_{k}"], z[f"moe{S}_g_{k}"], k)


def test_moe_local_body_with_identity_collectives_is_the_tp1_dispatch():
    """At tp = 1 the factored body with identity collectives is the
    shard_map's arithmetic on one device: against JAX's shard_map on a 1 x
    1 mesh, same weights and tokens."""
    from repro.launch.mesh import make_mesh_from
    from repro.launch import sharding as ref_sh
    from repro.configs import ShapeSpec as RShape
    from repro.models.moe import init_moe_params, moe_mlp_shardmap
    from repro.models.shardctx import activation_sharding as ref_act
    from repro_torch.models import moe as pmoe

    cfg = reduced(ARCHS["qwen3-moe-30b-a3b"], moe_dispatch="capacity")
    p = init_moe_params(cfg, jax.random.PRNGKey(2), jnp.float32)
    x = np.random.default_rng(3).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    mesh = make_mesh_from((1, 1), ("data", "model"))
    with ref_act(ref_sh.activation_rules(cfg, RShape("t", "train", 64, 16),
                                         mesh, multi_pod=False,
                                         strategy="moe_ep")):
        want_o, want_aux = moe_mlp_shardmap(cfg, p, jnp.asarray(x))
    w = {k: torch.from_numpy(np.asarray(p[k])) for k in _MOE_KEYS}
    o, aux = pmoe.moe_ep_local(cfg, torch.from_numpy(x), w["router"],
                               w["w_gate"], w["w_up"], w["w_down"],
                               pmoe.IdentityComm())
    _close(o.numpy(), np.asarray(want_o))
    _close(aux.numpy(), np.asarray(want_aux))


# ---------------------------------------------------------------------------
# reduced forwards on 2 x 2
# ---------------------------------------------------------------------------
def _forward_rank(rank, arch, strategy, S, gbatch, state_path, batch_path,
                  out_path):
    from repro_torch.configs import ARCHS as PA, ShapeSpec
    from repro_torch.launch import sharding as sh
    from repro_torch.models import Transformer, forward, loss_fn
    from repro_torch.models import layers as L
    from repro_torch.models import moe as pmoe
    from repro_torch.models import reduced as preduced
    from repro_torch.models.shardctx import activation_sharding

    over = {"moe_dispatch": "capacity"} if PA[arch].n_experts else {}
    cfg = preduced(PA[arch], **over)
    mesh = _mesh()
    sizes = sh.axis_sizes(mesh)
    model = Transformer.from_state_dict(cfg, torch.load(state_path), "cpu")
    named = dict(model.named_parameters())
    sh.distribute_model(model, mesh, sh.sanitize_specs(
        sh.state_specs(cfg, sh.param_specs(cfg, tp=2)), named, sizes))
    batch = torch.load(batch_path)
    shape = ShapeSpec("t", "train", S, gbatch)
    bspec = sh.sanitize_specs(sh.batch_pspecs(
        cfg, shape, multi_pod=False, with_labels=True, n_dev=WORLD),
        batch, sizes)
    dbatch = {k: sh.distribute(mesh, v, bspec[k]) for k, v in batch.items()}
    calls = {"flat": 0, "shardmap": 0}
    flat, shardmap = L._sdpa_blockwise_flat, pmoe.moe_mlp_shardmap

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    L._sdpa_blockwise_flat = count("flat", flat)
    pmoe.moe_mlp_shardmap = count("shardmap", shardmap)
    with activation_sharding(sh.activation_rules(
            cfg, shape, mesh, multi_pod=False, strategy=strategy)):
        with torch.no_grad():
            logits, aux = forward(cfg, model, dbatch)
            loss, _ = loss_fn(cfg, model, dbatch)
    res = {"logits": _full(logits), "aux": _full(aux), "loss": _full(loss),
           **calls}
    if rank == 0:
        torch.save(res, out_path)


def _port_twin(arch, jax_params=None, seed=11):
    """(cfg, the one-device model, its state dict) for a reduced arch."""
    import repro_torch.models as tm
    from repro_torch.configs import ARCHS as PA
    from repro_torch.models.convert import params_from_jax

    over = {"moe_dispatch": "capacity"} if PA[arch].n_experts else {}
    cfg = tm.reduced(PA[arch], **over)
    if jax_params is not None:
        model = tm.Transformer.from_state_dict(
            cfg, params_from_jax(cfg, jax_params), "cpu")
    else:
        model = tm.Transformer(cfg, device="cpu", seed=seed)
    return cfg, model


def _run_forward(arch, strategy, S, gbatch, tmp_path, batch, model):
    torch.save(model.state_dict(), tmp_path / "state.pt")
    torch.save(batch, tmp_path / "batch.pt")
    out = tmp_path / "out.pt"
    _run_ranks(_forward_rank, arch, strategy, S, gbatch,
               str(tmp_path / "state.pt"), str(tmp_path / "batch.pt"),
               str(out), tmp_path=tmp_path)
    return torch.load(out)


# (arch, strategy, S, the rules' global batch): "seq" at S = 256 shards
# batch over "data" and sequence over "model" (an SSM batch over both);
# "tp" at S = 2048 shards heads over "model" and takes the flat-heads
# attention (a global batch under 16 that the mesh does not divide leaves
# the batch whole, so hymba's SSM rule does not also claim "model").
FORWARDS = [
    ("llama3.2-1b", "seq", 256, 16),
    ("llama3.2-1b", "tp", 2048, 16),
    ("hymba-1.5b", "seq", 256, 16),
    ("hymba-1.5b", "tp", 2048, 2),
    ("mamba2-130m", "seq", 256, 16),
]


@pytest.mark.parametrize("arch,strategy,S,gbatch", FORWARDS,
                         ids=[f"{a}-{s}" for a, s, _, _ in FORWARDS])
def test_reduced_forward_on_2x2_equals_one_device(arch, strategy, S, gbatch,
                                                  tmp_path):
    import repro_torch.models as tm
    from repro_torch.configs import concrete_batch as port_batch

    cfg, model = _port_twin(arch)
    batch = port_batch(cfg, "train", 4, S, seed=5, device="cpu")
    with torch.no_grad():
        want, want_aux = tm.forward(cfg, model, batch)
        want_loss, _ = tm.loss_fn(cfg, model, batch)
    got = _run_forward(arch, strategy, S, gbatch, tmp_path, batch, model)
    # forward, then loss_fn's forward: every layer twice
    assert got["flat"] == (2 * cfg.n_layers if strategy == "tp" else 0)
    _close(got["logits"].numpy(), want.numpy())
    _close(got["loss"].numpy(), want_loss.numpy())
    _close(got["aux"].numpy(), want_aux.numpy())


def test_moe_ep_forward_on_2x2_equals_jax(jax_2x2, tmp_path):
    """qwen3-moe-30b-a3b (reduced, capacity dispatch) under ``moe_ep``:
    every layer's MoE through the shard_map dispatch on both sides, the
    reference's weights carried across."""
    from repro.configs import concrete_batch

    z = jax_2x2
    cfg, model = _port_twin("qwen3-moe-30b-a3b",
                            jax_params=_unflatten_params(z))
    S = 256
    ref = concrete_batch(cfg, "train", 4, S, seed=3)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()}
    got = _run_forward("qwen3-moe-30b-a3b", "moe_ep", S, 16, tmp_path,
                       batch, model)
    assert got["shardmap"] == 2 * cfg.n_layers   # forward, then loss_fn
    _close(got["logits"].numpy(), z["fwd_logits"])
    _close(got["aux"].numpy(), z["fwd_aux"])
    _close(got["loss"].numpy(), z["fwd_loss"])


# ---------------------------------------------------------------------------
# --distributed under torchrun
# ---------------------------------------------------------------------------
def test_train_launcher_distributed_at_world_size_2(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    flags = ["--smoke", "--device", "cpu", "--steps", "8", "--sync-every",
             "3", "--crash-at", "5"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2"]
    dist = subprocess.run(
        torchrun + ["-m", "repro_torch.launch.train", "--distributed",
                    "--workdir", str(tmp_path / "dist")] + flags,
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert dist.returncode == 0, dist.stderr[-3000:]
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--workdir",
         str(tmp_path / "one")] + flags,
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr[-3000:]

    def digests(out):
        return [line.split("digest ")[1] for line in out.splitlines()
                if "digest " in line]

    want = digests(one.stdout)
    assert len(want) == 1
    assert digests(dist.stdout) == want * 2
    assert sorted(p.name for p in (tmp_path / "dist").iterdir()) == [
        "rank0", "rank1"]
