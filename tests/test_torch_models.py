"""The port's model zoo (``repro_torch.models``) against the JAX package's.

Every case runs at ``reduced`` sizes in f32 on the CPU.  The reference's
weights (``init_params`` from a fixed key) cross into the port through
``convert.params_from_jax``; inputs are drawn with numpy from a seed and
handed to both packages.  Tolerance: ``atol = rtol = 1e-4`` on f32 logits
(the two packages sum in other orders; measured differences are ~5e-6),
except where a twin of ``tests/test_models.py`` keeps that file's own
bound.  Last, each full-width config is built on the ``meta`` device and
its parameter count held to the reference's abstract init.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, concrete_batch
from repro.configs import cache_specs as ref_cache_specs
from repro.models import decode_step, forward, init_decode_cache, init_params
from repro.models import loss_fn
from _port_cfg import port_cfg, reduced
from repro.models.moe import init_moe_params
from repro.models.moe import moe_mlp_capacity as ref_moe_capacity
from repro.models.ssm import ssd_chunked as ref_ssd_chunked
import repro_torch.models as tm
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import SHAPES, batch_specs, cache_specs
from repro_torch.configs import concrete_batch as port_batch
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import Init, _sdpa, _sdpa_blockwise
from repro_torch.models.layers import make_attn_mask
from repro_torch.models.moe import MoE, moe_mlp, moe_mlp_capacity
from repro_torch.models.ssm import ssd_chunked

ATOL = RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
DECODERS = [a for a in sorted(ARCHS) if ARCHS[a].can_decode]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **overrides):
    """(cfg, reference params, the same weights in the port on the CPU)."""
    cfg = reduced(ARCHS[arch], **overrides)
    params = init_params(cfg, KEY)
    model = tm.Transformer.from_state_dict(
        cfg, params_from_jax(cfg, _np(params)), device="cpu")
    return cfg, params, model


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_port_exports_the_reference_names():
    import repro.models

    assert set(repro.models.__all__) <= set(tm.__all__)
    model = tm.init_params(reduced(ARCHS["llama3.2-1b"]), seed=5,
                           device="cpu")
    again = tm.Transformer(reduced(ARCHS["llama3.2-1b"]), device="cpu",
                           seed=5)
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


def test_port_configs_are_the_reference_configs():
    """Every reference config is in the port, field for field, and the
    port's own fields (Granite's mixer list and scalars; kanana's latent
    attention, leading dense layers and sigmoid router) sit at their
    defaults there; the port's extra archs are granite-4.0-h-small and
    kanana-2-30b-a3b."""
    assert PORT_ARCHS.keys() - ARCHS.keys() == {"granite-4.0-h-small",
                                                "kanana-2-30b-a3b"}
    ref_fields = {f.name for f in dataclasses.fields(type(ARCHS["smollm-360m"]))}
    defaults = {f.name: f.default for f in dataclasses.fields(tm.ModelConfig)
                if f.name not in ref_fields}
    assert set(defaults) == {"layer_types", "embedding_multiplier",
                             "residual_multiplier", "attention_multiplier",
                             "logits_scaling", "kv_lora_rank",
                             "qk_nope_head_dim", "qk_rope_head_dim",
                             "v_head_dim", "first_k_dense", "router_score",
                             "routed_scaling"}
    for name, cfg in ARCHS.items():
        port = dataclasses.asdict(PORT_ARCHS[name])
        assert {k: port.pop(k) for k in defaults} == defaults
        assert port == dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_match_reference(arch):
    cfg, params, model = _pair(arch)
    ref_batch = concrete_batch(cfg, "train", batch=2, seq=32)
    batch = port_batch(cfg, "train", 2, 32, device="cpu")
    for k, v in ref_batch.items():                   # the same draws
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v))
    want_logits, want_aux = jax.jit(
        lambda p, b: forward(cfg, p, b))(params, ref_batch)
    want_loss, want_m = jax.jit(
        lambda p, b: loss_fn(cfg, p, b))(params, ref_batch)
    with torch.no_grad():
        logits, aux = tm.forward(cfg, model, batch)
        loss, m = tm.loss_fn(cfg, model, batch)
        last, _ = tm.prefill(cfg, model, batch)
    assert logits.shape == (2, 32, cfg.vocab)
    _close(logits, want_logits)
    _close(last, np.asarray(want_logits)[:, -1])
    _close(aux, want_aux)
    _close(loss, want_loss)
    _close(m["ce"], want_m["ce"])


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps_match_reference(arch):
    """12 steps of 3 rows with a random active mask (row 0 always active,
    so a reduced SWA ring of 8 wraps), logits every step and the final
    pos and caches."""
    cfg, params, model = _pair(arch)
    B, T, max_seq = 3, 12, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    embeds = rng.normal(0, 1, (B, T, cfg.frontend_dim or cfg.d_model))
    embeds = embeds.astype(np.float32)
    active = rng.integers(0, 2, (T, B)).astype(np.int32)
    active[:, 0] = 1
    ref_cache = init_decode_cache(cfg, B, max_seq)
    cache = tm.init_decode_cache(cfg, B, max_seq, device="cpu")
    step = jax.jit(lambda p, b, c: decode_step(cfg, p, b, c))
    for t in range(T):
        b = {"active": active[t]}
        if cfg.frontend == "token":
            b["tokens"] = toks[:, t:t + 1]
        else:
            b["embeds"] = embeds[:, t:t + 1]
        if cfg.pos == "mrope":
            pos = np.asarray(ref_cache["pos"])[None, :, None]
            b["positions"] = np.broadcast_to(pos, (3, B, 1)).astype(np.int32)
        want, ref_cache = step(params, {k: jnp.asarray(v)
                                        for k, v in b.items()}, ref_cache)
        got, cache = tm.decode_step(cfg, model, {
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}, cache)
        assert got.dtype == torch.float32
        _close(got, want)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))
    for seg, ref_seg in zip(cache["segments"], ref_cache["segments"]):
        for name in ("k", "v"):
            if name in seg:
                _close(seg[name], ref_seg[name])
        if "ssm" in seg:
            for name in ("state", "conv"):
                _close(seg["ssm"][name], ref_seg["ssm"][name])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b"])
def test_cpu_decode_attends_through_the_plain_path(arch, monkeypatch):
    """On the CPU every attention layer of a decode step takes
    ``sdpa_decode_plain`` (``_sdpa`` under the ring's mask), never the
    card's kernel, and the steps match the reference as before: 10 steps of
    3 rows past the reduced hymba's window of 8, logits within the file's
    tolerance."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    cfg, params, model = _pair(arch)
    calls = []
    real = layers.sdpa_decode_plain

    def counted(*args):
        calls.append(args[2].shape)
        return real(*args)

    monkeypatch.setattr(layers, "sdpa_decode_plain", counted)
    B, T = 3, 10
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (T, B, 1)).astype(np.int32)
    ref_cache = init_decode_cache(cfg, B, 16)
    cache = tm.init_decode_cache(cfg, B, 16, device="cpu")
    step = jax.jit(lambda p, b, c: decode_step(cfg, p, b, c))
    launched = ops.DECODE_ATTN.launches
    for t in range(T):
        want, ref_cache = step(params, {"tokens": jnp.asarray(toks[t])},
                               ref_cache)
        got, cache = tm.decode_step(cfg, model,
                                    {"tokens": torch.from_numpy(toks[t])},
                                    cache)
        _close(got, want)
    assert len(calls) == T * cfg.n_layers
    assert ops.DECODE_ATTN.launches == launched
    if cfg.attn == "swa":
        assert {s[1] for s in calls} == {16, cfg.swa_window}


def test_bf16_decode_tracks_reference():
    """The cast order in bf16 (rmsnorm casts before the weight, f32 scores,
    probabilities cast to bf16, f32 logits after the head): 8 steps of the
    reduced llama in bf16 on both sides.  The logits are rounded to bf16
    before the f32 cast, and every activation before them: one ulp is 2^-7
    of the value, 0.031 at 4, the logits' top scale.  The two packages
    accumulate in other orders, so a logit moves by an ulp of the scale
    it passed through or a little more (measured: 0.042 at most, on a
    logit of 0.23).  Bound: 0.08 absolute, between two and three ulps at
    the logits' top scale."""
    cfg, params, model = _pair("llama3.2-1b", dtype="bfloat16")
    B = 4
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (8, B, 1))
    ref_cache = init_decode_cache(cfg, B, 16)
    cache = tm.init_decode_cache(cfg, B, 16, device="cpu")
    assert cache["segments"][0]["k"].dtype == torch.bfloat16
    step = jax.jit(lambda p, b, c: decode_step(cfg, p, b, c))
    for t in range(8):
        want, ref_cache = step(
            params, {"tokens": jnp.asarray(toks[t], jnp.int32)}, ref_cache)
        got, cache = tm.decode_step(
            cfg, model, {"tokens": torch.from_numpy(toks[t]).int()}, cache)
        _close(got, want, atol=0.08, rtol=0)


class TestBlockwiseAttention:
    @pytest.mark.parametrize("attn,is_global,causal", [
        ("full", True, True), ("swa", False, True), ("full", True, False),
    ])
    def test_vs_direct(self, attn, is_global, causal):
        cfg = dataclasses.replace(
            reduced(ARCHS["smollm-360m"]), attn=attn, causal=causal,
            swa_window=40,
        )
        r = np.random.default_rng(0)
        B, S, Hq, Hkv, dh = 2, 2048, 4, 2, 16
        q = torch.from_numpy(r.normal(0, 1, (B, S, Hq, dh))).float()
        k = torch.from_numpy(r.normal(0, 1, (B, S, Hkv, dh))).float()
        v = torch.from_numpy(r.normal(0, 1, (B, S, Hkv, dh))).float()
        o_blk = _sdpa_blockwise(cfg, q, k, v, is_global=is_global, block=256)
        o_ref = _sdpa(cfg, q, k, v, make_attn_mask(cfg, S, is_global))
        _close(o_blk, o_ref, atol=2e-5, rtol=0)


class TestDecodeTrainConsistency:
    """Autoregressive decode must reproduce the training-forward logits —
    the property CURP-Serve recovery (re-prefill) depends on."""

    @pytest.mark.parametrize("arch", ["mamba2-130m", "llama3.2-1b",
                                      "hymba-1.5b"])
    def test_stepwise_matches_parallel(self, arch):
        cfg = reduced(ARCHS[arch])
        model = tm.Transformer(cfg, device="cpu", seed=0)
        T = 16
        toks = torch.from_numpy(
            np.random.default_rng(1).integers(0, cfg.vocab, (1, T))).int()
        with torch.no_grad():
            logits_par, _ = tm.forward(cfg, model, {"tokens": toks})
        cache = tm.init_decode_cache(cfg, 1, T, device="cpu")
        outs = []
        for t in range(T):
            lg, cache = tm.decode_step(
                cfg, model, {"tokens": toks[:, t:t + 1]}, cache)
            outs.append(lg)
        _close(logits_par[0], torch.stack(outs, dim=1)[0],
               atol=5e-3, rtol=1e-3)

    def test_active_mask_freezes_rows(self):
        cfg = reduced(ARCHS["llama3.2-1b"])
        model = tm.Transformer(cfg, device="cpu", seed=0)
        cache = tm.init_decode_cache(cfg, 2, 16, device="cpu")
        b = {"tokens": torch.tensor([[3], [4]], dtype=torch.int32),
             "active": torch.tensor([1, 0], dtype=torch.int32)}
        _, cache = tm.decode_step(cfg, model, b, cache)
        assert int(cache["pos"][0]) == 1 and int(cache["pos"][1]) == 0
        k0 = cache["segments"][0]["k"]
        assert k0[:, 1].abs().sum() == 0.0   # inactive row untouched
        assert k0[:, 0].abs().sum() > 0.0

    def test_inactive_rows_keep_ssm_state(self):
        cfg = reduced(ARCHS["hymba-1.5b"])
        model = tm.Transformer(cfg, device="cpu", seed=0)
        cache = tm.init_decode_cache(cfg, 2, 16, device="cpu")
        b = {"tokens": torch.tensor([[3], [4]], dtype=torch.int32),
             "active": torch.tensor([0, 1], dtype=torch.int32)}
        _, cache = tm.decode_step(cfg, model, b, cache)
        for seg in cache["segments"]:
            assert seg["ssm"]["state"][:, 0].abs().sum() == 0.0
            assert seg["ssm"]["conv"][:, 0].abs().sum() == 0.0
            assert seg["ssm"]["state"][:, 1].abs().sum() > 0.0


class TestMoE:
    def _moe(self, cf):
        cfg = dataclasses.replace(
            reduced(ARCHS["qwen3-moe-30b-a3b"]), moe_capacity_factor=cf)
        p = MoE(cfg, Init(CPU, torch.float32, seed=0))
        x = torch.from_numpy(np.random.default_rng(1).normal(
            0, 1, (2, 16, cfg.d_model))).float()
        return cfg, p, x

    def test_capacity_matches_dense_at_high_cf(self):
        cfg, p, x = self._moe(8.0)
        with torch.no_grad():
            o_d, _ = moe_mlp(cfg, p, x)
            o_c, _ = moe_mlp_capacity(cfg, p, x)
        _close(o_d, o_c, atol=1e-5, rtol=0)

    def test_capacity_drops_overflow_gracefully(self):
        cfg, p, x = self._moe(0.25)
        with torch.no_grad():
            o, aux = moe_mlp_capacity(cfg, p, x)
        assert torch.isfinite(o).all() and torch.isfinite(aux)

    @pytest.mark.parametrize("arch,cf", [("qwen3-moe-30b-a3b", 0.25),
                                         ("qwen3-moe-30b-a3b", 8.0),
                                         ("qwen2-moe-a2.7b", 1.25)])
    def test_capacity_matches_reference(self, arch, cf):
        """The capacity dispatch (C rounded up to 64, exclusive-cumsum
        slots, overflow dropped) on the reference's weights; with 32
        tokens at cf 0.25 some experts overflow even at C = 64."""
        cfg = dataclasses.replace(reduced(ARCHS[arch]),
                                  moe_capacity_factor=cf, top_k=4)
        ref_p = init_moe_params(cfg, KEY, jnp.float32)
        p = MoE(cfg, Init(torch.device("meta"), torch.float32, seed=0))
        p = p.to_empty(device="cpu")
        flat = jax.tree_util.tree_flatten_with_path(_np(ref_p))[0]
        p.load_state_dict({".".join(k.key for k in path): torch.tensor(a)
                           for path, a in flat}, strict=True)
        x = np.random.default_rng(1).normal(0, 1, (2, 16, cfg.d_model))
        x = x.astype(np.float32) * 4.0
        want, want_aux = ref_moe_capacity(cfg, ref_p, jnp.asarray(x))
        with torch.no_grad():
            got, aux = moe_mlp_capacity(cfg, p, torch.from_numpy(x))
        _close(got, want)
        _close(aux, want_aux)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    r = np.random.default_rng(3)
    b, l, h, p, g, n, chunk = 2, 64, 4, 8, 2, 16, 16
    X = r.normal(0, 1, (b, l, h, p)).astype(np.float32)
    A = -np.abs(r.normal(0, 0.5, (b, l, h))).astype(np.float32)
    Bm = r.normal(0, 1, (b, l, g, n)).astype(np.float32)
    Cm = r.normal(0, 1, (b, l, g, n)).astype(np.float32)
    st = r.normal(0, 1, (b, h, p, n)).astype(np.float32) if with_state \
        else None
    want_y, want_s = ref_ssd_chunked(
        *(jnp.asarray(a) for a in (X, A, Bm, Cm)), chunk,
        None if st is None else jnp.asarray(st))
    got_y, got_s = ssd_chunked(
        *(torch.from_numpy(a) for a in (X, A, Bm, Cm)), chunk,
        None if st is None else torch.from_numpy(st))
    _close(got_y, want_y)
    _close(got_s, want_s)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_width_module_on_meta(arch):
    """The published widths, built with no memory: the port's parameter
    count equals the reference's abstract init, leaf for leaf in total, and
    the decode_32k cell's cache and batch specs have the reference's
    shapes."""
    cfg = port_cfg(ARCHS[arch])
    model = tm.Transformer(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    abstract = jax.eval_shape(lambda: init_params(cfg, KEY))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(abstract))
    assert sum(p.numel() for p in model.parameters()) == want
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    shape = SHAPES["decode_32k"]
    specs = batch_specs(cfg, shape, with_labels=False)
    assert all(t.device.type == "meta" for t in specs.values())
    if cfg.can_decode:
        got = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                     cache_specs(cfg, shape))
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                      ref_cache_specs(cfg, shape))
        assert got == want
