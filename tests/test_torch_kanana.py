"""kanana-2-30b-a3b in the port against its plain f32 reference.

The reference is the benchmark's own (``perfbench/reference/kanana.py``,
loaded by path; it imports nothing of the port) and computes attention in
the expanded form (per-head K and V from ``wkv_b``), so the port's absorbed
decode over its latent cache is held to independent algebra.  The reduced
config keeps the DeepSeek-V3 block in three layers (one dense, two MoE):
multi-head latent attention with every width distinct (latent 32, rope
part 8 interleaved, nope 16, value 12, 4 heads), 8 experts top-2 by the
sigmoid router with its correction bias, normalised and scaled by 2.448,
and a shared expert, in f32 on the CPU; every parameter, the norms and the
bias too, is drawn at random so that each term of the equations shows.

Tolerance: ``atol = rtol = 1e-4`` on f32 logits, as the port's other
parity tests (tests/test_torch_granite.py): the port sums in other orders
(the absorbed scores q_nope W_UK . latent against the reference's
q_nope . (latent W_UK), grouped einsums against a loop over heads, RoPE's
angle in f32 against the reference's f64, a capacity or dense dispatch
against a loop over experts); the differences measured here are under
1e-5.  The planted faults move the logits by far more (the last test).
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.models as tm
from repro_torch.configs import ARCHS
from repro_torch.core.telemetry import registry
from repro_torch.models import layers, moe
from repro_torch.models.moe import _capacity
from repro_torch.serving import CurpServeDriver, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-4
NAME = "kanana-2-30b-a3b"
FULL = ARCHS[NAME]
DISPATCHES = ["dense", "capacity"]

# The catalog's row (config.json of hf:kakaocorp/kanana-2-30b-a3b-
# instruct-2601), every key the benchmark's configuration file must hold
# at its top level, value for value.
CATALOG = {
    "attention_bias": False, "first_k_dense_replace": 1, "head_dim": 64,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 6144,
    "kv_lora_rank": 512, "max_position_embeddings": 32768,
    "model_type": "deepseek_v3", "moe_intermediate_size": 768,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 128,
    "n_shared_experts": 2, "norm_topk_prob": True, "num_attention_heads": 32,
    "num_experts_per_tok": 6, "num_hidden_layers": 48,
    "num_key_value_heads": 32, "q_lora_rank": None, "qk_head_dim": 192,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_interleave": True, "rope_scaling": None, "rope_theta": 1000000,
    "routed_scaling_factor": 2.448, "scoring_func": "sigmoid",
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "noaux_tc",
    "v_head_dim": 128, "vocab_size": 128256,
}


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load(ROOT / "perfbench" / "reference" / "kanana.py")
entry = _load(ROOT / "perfbench" / "entries" / "serve_kanana.py")


def _cfg(dispatch="dense", **overrides):
    return tm.reduced(FULL, moe_dispatch=dispatch, **overrides)


def _model(cfg, seed=0):
    """The port's init, then every fixed-value parameter (norms, the
    latent's norm, the correction bias) moved by a seeded draw."""
    model = tm.Transformer(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
    return model


def _weights(model):
    state = model.state_dict()
    return lambda n: state[n].float()


def _ref_logits(cfg, model, tokens, picks=None):
    return ref.forward_logits(dataclasses.asdict(cfg), _weights(model),
                              torch.as_tensor(tokens), picks=picks)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)


def _forward_gap(cfg, model, toks):
    """Largest |port - reference| over ``forward``'s and ``prefill``'s
    logits, in units of the tolerance (<= 1 passes)."""
    with torch.no_grad():
        logits, _ = tm.forward(cfg, model, {"tokens": torch.as_tensor(toks)})
        last, _ = tm.prefill(cfg, model, {"tokens": torch.as_tensor(toks)})
    worst = 0.0
    for b in range(len(toks)):
        want = _ref_logits(cfg, model, toks[b])
        for got, w in ((logits[b], want), (last[b], want[-1])):
            worst = max(worst, float(((got - w).abs()
                                      / (ATOL + RTOL * w.abs())).max()))
    return worst


def _decode_gap(cfg, model, toks, active=None):
    """Decode ``toks`` [B, T] step by step from an empty latent cache (with
    ``active`` [T, B], rows whose flag is 0 neither write nor advance);
    the largest gap to the reference's full forward of each row's own fed
    tokens, in units of the tolerance."""
    B, T = toks.shape
    cache = tm.init_decode_cache(cfg, B, 16, device="cpu")
    fed = [[] for _ in range(B)]
    steps = []
    for t in range(T):
        act = np.ones(B, np.int32) if active is None else active[t]
        got, cache = tm.decode_step(cfg, model, {
            "tokens": torch.as_tensor(toks[:, t:t + 1], dtype=torch.int32),
            "active": torch.as_tensor(act)}, cache)
        for b in range(B):
            if act[b]:
                fed[b].append(int(toks[b, t]))
                steps.append((b, len(fed[b]) - 1, got[b]))
    want = [_ref_logits(cfg, model, f) if f else None for f in fed]
    worst = max(float(((g - want[b][i]).abs()
                       / (ATOL + RTOL * want[b][i].abs())).max())
                for b, i, g in steps)
    assert cache["pos"].tolist() == [len(f) for f in fed]
    return worst


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_forward_and_prefill_match_the_reference(dispatch):
    cfg = _cfg(dispatch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 32))
    assert _forward_gap(cfg, _model(cfg), toks) <= 1.0


def test_forward_past_the_blockwise_threshold_matches_the_reference():
    """1,536 tokens: ``forward`` and ``prefill`` take the blockwise
    attention (past 1,024; blocks of 512), with values narrower than keys
    (12 against 24), and still give the reference's logits.  Vocabulary
    cut to 256 to keep the reference's logits small; the dense dispatch,
    as a capacity buffer drops picks over 1,536 tokens (the reference's
    experts drop none)."""
    cfg = _cfg("dense", vocab=256)
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (1, 1536))
    assert _forward_gap(cfg, _model(cfg, seed=4), toks) <= 1.0


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_decode_through_the_latent_cache_matches_the_reference(dispatch):
    """12 decode steps of 3 rows from an empty cache, one row inactive at
    some steps: each row's logits at each of its steps are the
    reference's full forward at that position of its own tokens."""
    cfg = _cfg(dispatch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (3, 12))
    active = np.ones((12, 3), np.int32)
    active[[2, 5, 6], 1] = 0
    assert _decode_gap(cfg, _model(cfg, seed=1), toks, active) <= 1.0


def test_the_mla_layers_never_reach_the_gqa_decode_attention(monkeypatch):
    """Decode attends over the latent cache only: neither A1 nor its
    plain twin is called (each raises here)."""
    def refuse(*a, **k):
        raise AssertionError("MLA reached the GQA decode attention")

    monkeypatch.setattr(layers, "decode_attention_cuda", refuse)
    monkeypatch.setattr(layers, "sdpa_decode_plain", refuse)
    cfg = _cfg()
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 4))
    assert _decode_gap(cfg, _model(cfg, seed=2), toks) <= 1.0


def test_router_picks_and_weights_equal_the_references():
    """The sigmoid router on 64 tokens: the port's picks equal the
    reference's and their weights agree within 1e-6 (f32, the same
    operations); with the correction bias zeroed some token's picks
    change, in both, so the bias takes part in the selection; the weights
    are the unbiased scores, normalised and scaled (each row sums to
    ``routed_scaling``)."""
    cfg = _cfg()
    p = _model(cfg, seed=6).blocks[1].moe
    h = torch.randn((64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(7))
    m = dataclasses.asdict(cfg)
    got = {}
    for key, bias in (("biased", p.correction_bias),
                      ("zeroed", torch.zeros_like(p.correction_bias))):
        w = {"moe.router": p.router, "moe.correction_bias": bias}.get
        want_i, want_w = ref.route(m, lambda n: w(n).detach(), h,
                                   torch.matmul)
        with torch.no_grad():
            _s, got_w, got_i = moe.route_sigmoid(cfg, p.router, bias, h)
        assert torch.equal(got_i, want_i)
        np.testing.assert_allclose(got_w.numpy(), want_w.numpy(), atol=1e-6)
        np.testing.assert_allclose(got_w.sum(-1).numpy(),
                                   cfg.routed_scaling, rtol=1e-6)
        got[key] = got_i.sort(-1).values
    changed = int((got["biased"] != got["zeroed"]).any(-1).sum())
    assert 0 < changed < 64


@pytest.mark.parametrize("where", ["reduced", "full on meta"])
def test_decode_cache_holds_only_the_latent(where):
    """One segment of every layer, holding only ``latent`` [L, B, S,
    kv_lora_rank + qk_rope_head_dim]: no per-head K or V.  At full width
    that is 1,152 B a token a layer in bf16, 7.25 GB at the cell's 32 x
    4096, where per-head K/V would be 20,480 B (128.8 GB)."""
    if where == "reduced":
        cfg, B, S, dev = _cfg(), 3, 16, "cpu"
    else:
        cfg, B, S, dev = FULL, 32, 4096, "meta"
    cache = tm.init_decode_cache(cfg, B, S, dtype=torch.bfloat16, device=dev)
    assert [set(e) for e in cache["segments"]] == [{"latent"}]
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    assert cache["segments"][0]["latent"].shape == (cfg.n_layers, B, S,
                                                    width)
    assert sum(t.numel() * t.element_size()
               for t in tm.cache_tensors(cache)) == \
        2 * cfg.n_layers * B * S * width + 4 * B
    assert tm.transformer.latent_slots(cache) == (cfg.n_layers, B, S)
    if where != "reduced":
        assert 2 * width == 1_152
        assert cfg.n_layers * B * S * 1_152 == 7_247_757_312
        per_head_kv = 2 * cfg.n_heads * (cfg.d_head + cfg.v_head_dim)
        assert per_head_kv == 20_480
        assert cfg.n_layers * B * S * per_head_kv == 128_849_018_880


def test_full_width_parameter_count():
    """Built on meta at the published widths: 30,670,815,104 parameters,
    config.json's count with the correction biases (47 x 128) and the
    final norm (2,048).  ``n_params()`` keeps the port's convention (the
    reference's), which leaves out the final norm: 2,048 fewer."""
    model = tm.Transformer(FULL, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 30_670_815_104
    assert FULL.n_params() == 30_670_815_104 - 2_048
    assert hasattr(model.blocks[0], "mlp") and not hasattr(model.blocks[0],
                                                           "moe")
    assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
               for b in model.blocks[1:])
    assert isinstance(model.blocks[0].attn, layers.MLA)
    assert model.lm_head.shape == (2048, 128_256)
    # A decode step's 32 rows never overflow a capacity buffer (C = 64).
    assert _capacity(FULL, 32) == 64


def test_benchmark_config_is_the_arch_and_the_catalog_row():
    """The benchmark's configuration file: its ``model`` block builds the
    registered config (bf16, no remat), its top-level keys hold the
    catalog's row value for value, and those map onto the arch's fields."""
    c = json.loads((ROOT / "perfbench" / "configs"
                    / "kanana-2-30b-a3b-curp-serve.json").read_text())
    m = {k: (tuple(v) if isinstance(v, list) else v)
         for k, v in c["model"].items()}
    assert tm.ModelConfig(**m) == dataclasses.replace(
        FULL, dtype="bfloat16", remat=False)
    assert {k: c[k] for k in CATALOG} == CATALOG
    assert (c["num_hidden_layers"], c["hidden_size"], c["vocab_size"],
            c["num_attention_heads"], c["num_key_value_heads"],
            c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
            c["v_head_dim"], c["qk_head_dim"], c["intermediate_size"],
            c["first_k_dense_replace"], c["n_routed_experts"],
            c["num_experts_per_tok"], c["moe_intermediate_size"],
            c["n_shared_experts"] * c["moe_intermediate_size"],
            c["routed_scaling_factor"], c["rope_theta"], c["rms_norm_eps"],
            c["tie_word_embeddings"], c["scoring_func"]) == (
        FULL.n_layers, FULL.d_model, FULL.vocab, FULL.n_heads,
        FULL.n_kv_heads, FULL.kv_lora_rank, FULL.qk_nope_head_dim,
        FULL.qk_rope_head_dim, FULL.v_head_dim, FULL.d_head, FULL.d_ff,
        FULL.first_k_dense, FULL.n_experts, FULL.top_k, FULL.moe_d_ff,
        FULL.shared_d_ff, FULL.routed_scaling, FULL.rope_theta,
        FULL.norm_eps, FULL.tie_embeddings, FULL.router_score)
    # The keys the program builds at one value only: the entry accepts
    # the catalog's and refuses any other.
    entry.check_built(c)
    assert {k: c[k] for k in entry.BUILT} == entry.BUILT
    assert c["topk_method"] == "noaux_tc"
    for key, other in (("q_lora_rank", 1536), ("rope_interleave", False),
                       ("norm_topk_prob", False), ("n_group", 8)):
        with pytest.raises(ValueError, match=key):
            entry.check_built(dict(c, **{key: other}))


def _driver(cfg, model, **kw):
    return CurpServeDriver(cfg, ServeConfig(
        max_batch=4, max_seq=48, n_shards=2, witness_backend="device",
        device="cpu", **kw), params=model)


def _served_gap(cfg, model, prompt, tokens):
    """Widest gap by which a served token lies below the reference's best
    logit at its position."""
    lg = _ref_logits(cfg, model, tokens)
    first = len(prompt) - 1
    best = lg[first:-1].max(dim=-1).values
    got = lg[first:-1].gather(1, torch.as_tensor(tokens[first + 1:])[:, None])
    return float((best - got[:, 0]).max())


def test_driver_serves_the_reference_through_a_crash():
    """A CPU ``CurpServeDriver`` (device witness backend on the plain
    versions): three sessions, 6 tokens, a crash and recovery (latent
    caches rebuilt by re-prefill), 6 more.  Every served token is the
    reference's best at its position within 1e-4, and the run equals one
    with no crash token for token."""
    cfg = _cfg("capacity")
    model = _model(cfg, seed=2)
    prompts = {"a": [5, 17, 99], "b": [1, 2], "c": [7, 7, 3, 12, 40]}
    runs = []
    for crash in (True, False):
        d = _driver(cfg, model)
        for sid, p in prompts.items():
            d.submit(sid, p)
        d.generate(6)
        if crash:
            assert d.crash_and_recover()["recovered_sessions"] == 3
        d.generate(6)
        runs.append({sid: list(s.tokens) for sid, s in d.sessions.items()})
    assert runs[0] == runs[1]
    for sid, p in prompts.items():
        assert len(runs[0][sid]) == len(p) + 12
        assert _served_gap(cfg, model, p, runs[0][sid]) <= ATOL


def _logged_run(cfg, model, prompts, n, crash_after=None):
    """Serve ``prompts`` for ``n`` tokens (a crash and recovery after
    ``crash_after``); returns the driver, each decode's live (slot,
    position) pairs, and the counters' change over the run."""
    names = ("mla.slots_read", "mla.slots_live", "moe.routed",
             "moe.experts_touched", "moe.rows_computed")
    before = {k: registry().snapshot().get(k, {"value": 0})["value"]
              for k in names}
    d = _driver(cfg, model)
    fed, pos = [], [0] * 4
    decode = d._decode

    def logged(host):
        live = [(i, pos[i]) for i in range(4) if host[1, i]]
        for i, _p in live:
            pos[i] += 1
        fed.append(live)
        return decode(host)

    def reset():
        pos[:] = [0] * 4

    d._decode = logged
    for sid, p in prompts.items():
        d.submit(sid, p)
    if crash_after is None:
        d.generate(n)
    else:
        d.generate(crash_after)
        reset()
        d.crash_and_recover()
        d.generate(n - crash_after)
    snap = registry().snapshot()
    return d, fed, {k: snap[k]["value"] - before[k] for k in names}


def test_mla_counters_equal_the_counts_from_shapes_and_positions():
    """``mla.slots_read`` (rows x slots x MLA layers a step, as built) and
    ``mla.slots_live`` (each live row's context x MLA layers), the
    driver's host counts a step, over a served run with a crash: the
    counts from the cache's shape and each decode's live positions."""
    cfg = _cfg("capacity")
    d, fed, got = _logged_run(cfg, _model(cfg, seed=3),
                              {"a": [5, 17, 99], "b": [1, 2], "c": [9]}, 7,
                              crash_after=3)
    L, B, C = cfg.n_layers, 4, 48
    assert got["mla.slots_read"] == len(fed) * L * B * C
    assert got["mla.slots_live"] == L * sum(p + 1 for live in fed
                                            for _s, p in live)
    assert 0 < got["mla.slots_live"] < got["mla.slots_read"]


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_routing_counters_count_only_the_moe_layers(dispatch):
    """``moe.routed``, ``moe.experts_touched`` and ``moe.rows_computed``
    over a served run, against the reference's routing at every fed
    position of every session: the leading dense layer routes nothing."""
    cfg = _cfg(dispatch)
    model = _model(cfg, seed=5)
    d, fed, got = _logged_run(cfg, model,
                              {"a": [5, 17, 99], "b": [1, 2], "c": [9]}, 5)
    picks = {}
    for slot, sid in enumerate(d.slots[:3]):
        layers_ = []
        _ref_logits(cfg, model, d.sessions[sid].tokens, picks=layers_)
        picks[slot] = [chosen for chosen, _w in layers_]
    n_moe = cfg.n_layers - cfg.first_k_dense
    routed = touched = 0
    for live in fed:
        routed += len(live) * cfg.top_k * n_moe
        for li in range(n_moe):
            touched += len(set().union(*(picks[s][li][p].tolist()
                                         for s, p in live)))
    per_layer = {"dense": 4, "capacity": 64}[dispatch] * cfg.n_experts
    assert (got["moe.routed"], got["moe.experts_touched"],
            got["moe.rows_computed"]) == (
        routed, touched, len(fed) * n_moe * per_layer)


def _no_kv_norm(cfg, p, x, positions):
    c, k_pe = torch.split(x @ p.wkv_a,
                          [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    k_pe = layers.rope_pairs(k_pe[:, :, None, :], positions,
                             cfg.rope_theta)[:, :, 0]
    return torch.cat([c, k_pe], dim=-1)


def _no_bias(real):
    return lambda cfg, router, bias, x: real(cfg, router, None, x)


FAULTS = {
    "rope unrotated": (layers, "rope_pairs", lambda x, pos, theta: x),
    "rope half-split": (layers, "rope_pairs", layers.apply_rope),
    "bias dropped from selection": (moe, "route_sigmoid",
                                    _no_bias(moe.route_sigmoid)),
    "kv_norm skipped in the cache": (layers, "mla_latent", _no_kv_norm),
    "scale 1/sqrt(qk_nope_head_dim)": (
        layers, "attn_scale", lambda cfg, d: cfg.qk_nope_head_dim ** -0.5),
}


@pytest.mark.parametrize("fault", ["none"] + sorted(FAULTS))
def test_planted_faults_fail_the_checks(fault, monkeypatch):
    """Each planted fault moves the port's forward or its decode past
    the tolerance (1/sqrt(qk_nope_head_dim) is 1/sqrt(128) at full
    width); with none planted both pass."""
    if fault != "none":
        monkeypatch.setattr(*FAULTS[fault])
    cfg = _cfg("capacity")
    model = _model(cfg, seed=8)
    rng = np.random.default_rng(9)
    gaps = (_forward_gap(cfg, model, rng.integers(0, cfg.vocab, (2, 16))),
            _decode_gap(cfg, model, rng.integers(0, cfg.vocab, (2, 10))))
    if fault == "none":
        assert max(gaps) <= 1.0
    else:
        assert max(gaps) > 10.0, gaps
