"""granite-4.0-h-small in the port against its plain f32 reference.

The reference is the benchmark's own (``perfbench/reference/granite.py``,
loaded by path; it imports nothing of the port).  The reduced config keeps
the published pattern's two mixer kinds in four layers (Mamba2, NoPE
attention, Mamba2, Mamba2), 8 experts top-2 with a shared expert and the
published multipliers (embedding 12, residual 0.22, attention 1/128,
logits / 16), in f32 on the CPU; every parameter, the norms and biases
too, is drawn at random so that each term of the equations shows.

Tolerance: ``atol = rtol = 1e-4`` on f32 logits, as the port's other
parity tests (tests/test_torch_models.py): the port sums in other orders
(the chunked SSD scan against the reference's quadratic form, grouped
einsums against a loop over heads, a capacity or dense dispatch against a
loop over experts); the differences measured here are under 1e-6.
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
from repro_torch.models.moe import _capacity
from repro_torch.serving import CurpServeDriver, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-4
NAME = "granite-4.0-h-small"
FULL = ARCHS[NAME]
DISPATCHES = ["dense", "capacity"]


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load(ROOT / "perfbench" / "reference" / "granite.py")


def _cfg(dispatch="dense", **overrides):
    return tm.reduced(FULL, moe_dispatch=dispatch, **overrides)


def _model(cfg, seed=0):
    """The port's init, then every fixed-value parameter (norms, conv
    bias, A_log, D, dt_bias) moved by a seeded draw."""
    model = tm.Transformer(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
    return model


def _ref_logits(cfg, model, tokens, picks=None):
    state = model.state_dict()
    return ref.forward_logits(dataclasses.asdict(cfg),
                              lambda n: state[n].float(),
                              torch.as_tensor(tokens), picks=picks)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_forward_matches_the_reference(dispatch):
    cfg = _cfg(dispatch)
    model = _model(cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 32))
    with torch.no_grad():
        logits, _ = tm.forward(cfg, model, {"tokens": torch.as_tensor(toks)})
    for b in range(2):
        _close(logits[b], _ref_logits(cfg, model, toks[b]))


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_decode_steps_match_the_reference(dispatch):
    """12 decode steps of 3 rows from an empty cache: row r's logits at
    step t are the reference's at position t of its own tokens."""
    cfg = _cfg(dispatch)
    model = _model(cfg, seed=1)
    B, T = 3, 12
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, T))
    cache = tm.init_decode_cache(cfg, B, 16, device="cpu")
    want = [_ref_logits(cfg, model, toks[b]) for b in range(B)]
    for t in range(T):
        got, cache = tm.decode_step(cfg, model, {
            "tokens": torch.as_tensor(toks[:, t:t + 1], dtype=torch.int32)},
            cache)
        for b in range(B):
            _close(got[b], want[b][t])
    assert cache["pos"].tolist() == [T] * B


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
    versions): three sessions, 6 tokens, a crash and recovery (caches
    rebuilt by re-prefill), 6 more.  Every served token is the
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


@pytest.mark.parametrize("where", ["reduced", "full on meta"])
def test_each_segment_holds_only_its_mixers_state(where):
    """Attention layers are "single" segments with K/V alone, runs of
    Mamba2 layers "scan" segments with SSM state alone; the cache's bytes
    are the formula's."""
    if where == "reduced":
        cfg, B, S, dev = _cfg(), 3, 16, "cpu"
    else:
        cfg, B, S, dev = FULL, 16, 8192, "meta"
    cache = tm.init_decode_cache(cfg, B, S, dtype=torch.bfloat16, device=dev)
    segs = tm.transformer.segments(cfg)
    attn = [i for i, k in enumerate(cfg.layer_types) if k == "attention"]
    assert [s for kind, s, _e in segs if kind == "single"] == attn
    for (kind, s, e), entry in zip(segs, cache["segments"]):
        if kind == "single":
            assert set(entry) == {"k", "v"}
        else:
            assert set(entry) == {"ssm"}
            assert all(t == "mamba" for t in cfg.layer_types[s:e])
    n_mamba = cfg.n_layers - len(attn)
    kv = 2 * B * S * cfg.n_kv_heads * cfg.d_head
    ssm = B * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
               + (cfg.ssm_conv - 1) * cfg.ssm_conv_dim)
    want = 2 * (len(attn) * kv + n_mamba * ssm) + 4 * B
    assert sum(t.numel() * t.element_size()
               for t in tm.cache_tensors(cache)) == want
    if where != "reduced":     # K/V 2.15 GB, Mamba2 state 1.21 GB
        assert len(attn) * kv * 2 == 2_147_483_648
        assert n_mamba * B * cfg.ssm_heads * cfg.ssm_head_dim \
            * cfg.ssm_state * 2 == 1_207_959_552


def test_full_width_parameter_count():
    """Built on meta at the published widths: 32,207,337,984 parameters,
    HF's count.  ``n_params()`` keeps the port's convention (the
    reference's), which leaves out the 36 Mamba2 layers' conv biases
    (36 x 8,448) and the final norm (4,096): 308,224 fewer."""
    model = tm.Transformer(FULL, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 32_207_337_984
    assert FULL.n_params() == 32_207_337_984 - 36 * 8_448 - 4_096
    for i, block in enumerate(model.blocks):
        is_attn = FULL.layer_types[i] == "attention"
        assert hasattr(block, "attn") == is_attn
        assert hasattr(block, "ssm") != is_attn
    assert not hasattr(model, "lm_head")
    # A decode step's 16 rows never overflow a capacity buffer (C = 64).
    assert _capacity(FULL, 16) == 64


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_routing_counters_equal_the_references_routing(dispatch):
    """``moe.routed`` and ``moe.rows_computed`` (the driver's host counts
    a step, from the rows the step's dispatch was built with) and
    ``moe.experts_touched`` (a device counter added to inside the step)
    over a served run, against the counts the reference's routing gives at
    every fed position of every session and the dispatch's buffers (every
    expert over the 4 rows, or E x C with C rounded up to 64)."""
    cfg = _cfg(dispatch)
    model = _model(cfg, seed=5)
    reg = registry()
    names = ("moe.routed", "moe.experts_touched", "moe.rows_computed")
    before = [reg.snapshot()[n]["value"] if n in reg.snapshot() else 0
              for n in names]
    d = _driver(cfg, model)
    fed = []                       # each decode's live (slot, position)
    pos = [0] * 4
    decode = d._decode

    def logged(host):
        live = [(i, pos[i]) for i in range(4) if host[1, i]]
        for i, _p in live:
            pos[i] += 1
        fed.append(live)
        return decode(host)

    d._decode = logged
    for sid, p in {"a": [5, 17, 99], "b": [1, 2], "c": [9]}.items():
        d.submit(sid, p)
    d.generate(5)
    snap = reg.snapshot()
    got = [snap[n]["value"] - b for n, b in zip(names, before)]
    picks = {}
    for slot, sid in enumerate(d.slots[:3]):
        layers = []
        _ref_logits(cfg, model, d.sessions[sid].tokens, picks=layers)
        picks[slot] = layers
    routed = touched = 0
    for live in fed:
        routed += len(live) * cfg.top_k * cfg.n_layers
        for li in range(cfg.n_layers):
            touched += len(set().union(*(picks[s][li][p].tolist()
                                         for s, p in live)))
    per_layer = {"dense": 4, "capacity": 64}[dispatch] * cfg.n_experts
    rows = len(fed) * cfg.n_layers * per_layer
    assert got == [routed, touched, rows]
    assert touched < routed


def test_default_scalars_issue_no_op():
    """With Granite's scalars a decode step issues one multiply for the
    embedding, two a layer (the residual adds) and one divide for the
    logits; with the defaults none of them (the attention scale is a
    number either way), so the existing configs' steps are unchanged."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    published = _cfg()
    plain = dataclasses.replace(published, embedding_multiplier=1.0,
                                residual_multiplier=1.0,
                                attention_multiplier=0.0, logits_scaling=1.0)
    counts = []
    for cfg in (published, plain):
        model = _model(cfg)
        cache = tm.init_decode_cache(cfg, 2, 8, device="cpu")
        with Count() as c:
            tm.decode_step(cfg, model, {"tokens": torch.ones(
                (2, 1), dtype=torch.int32)}, cache)
        counts.append(c.n)
    assert counts[0] - counts[1] == 2 + 2 * published.n_layers


def test_from_state_dict_adopts_matching_tensors_and_casts_others():
    cfg = _cfg()
    state = _model(cfg).state_dict()
    model = tm.Transformer.from_state_dict(cfg, state, device="cpu")
    for name, p in model.named_parameters():
        assert p.data_ptr() == state[name].data_ptr()
        assert p.requires_grad
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    cast = tm.Transformer.from_state_dict(bf16, state, device="cpu")
    for name, p in cast.named_parameters():
        assert p.dtype == torch.bfloat16
        assert p.data_ptr() != state[name].data_ptr()
        assert torch.equal(p, state[name].to(torch.bfloat16))
    with pytest.raises(KeyError, match="missing"):
        tm.Transformer.from_state_dict(
            cfg, {k: v for k, v in state.items() if k != "embed"}, "cpu")


def test_benchmark_config_is_the_arch_and_the_catalog_row():
    """The benchmark's configuration file: its ``model`` block builds the
    registered config (bf16, no remat), and its top-level keys are the
    published config.json's."""
    c = json.loads((ROOT / "perfbench" / "configs"
                    / "granite-4.0-h-small-curp-serve.json").read_text())
    m = {k: (tuple(v) if isinstance(v, list) else v)
         for k, v in c["model"].items()}
    assert tm.ModelConfig(**m) == dataclasses.replace(
        FULL, dtype="bfloat16", remat=False)
    assert c["layer_types"] == list(FULL.layer_types)
    assert (c["num_hidden_layers"], c["hidden_size"], c["vocab_size"],
            c["num_attention_heads"], c["num_key_value_heads"],
            c["num_local_experts"], c["num_experts_per_tok"],
            c["intermediate_size"], c["shared_intermediate_size"],
            c["mamba_d_state"], c["mamba_d_head"], c["mamba_n_heads"],
            c["mamba_d_conv"], c["mamba_chunk_size"]) == (
        FULL.n_layers, FULL.d_model, FULL.vocab, FULL.n_heads,
        FULL.n_kv_heads, FULL.n_experts, FULL.top_k, FULL.moe_d_ff,
        FULL.shared_d_ff, FULL.ssm_state, FULL.ssm_head_dim, FULL.ssm_heads,
        FULL.ssm_conv, FULL.ssm_chunk)
    assert (c["embedding_multiplier"], c["residual_multiplier"],
            c["attention_multiplier"], c["logits_scaling"]) == (
        FULL.embedding_multiplier, FULL.residual_multiplier,
        FULL.attention_multiplier, FULL.logits_scaling)
    assert c["position_embedding_type"] == "nope" and FULL.pos == "none"


# --------------------------------------------------------------------------
# The Mamba2 state update: one kernel on the card, today's formula here
# --------------------------------------------------------------------------
def _ssm_decode_before_the_kernel(cfg, p, u, cache, active=None):
    """``ssm_decode`` as it was written before the state update became one
    kernel on the card: the formula the CPU path must keep bit for bit."""
    import torch.nn.functional as F

    from repro_torch.models.ssm import _gated_rmsnorm, _split_in_proj

    B = u.shape[0]
    di, g, N, h = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    zxbcdt = u[:, 0, :] @ p.in_proj
    z, xBC, dt = _split_in_proj(cfg, zxbcdt)
    win = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)
    conv = torch.einsum("bkc,kc->bc", win, p.conv_w) + p.conv_b
    new_conv = win[:, 1:, :]
    xBC = F.silu(conv)
    x, Bm, Cm = torch.split(xBC, [di, g * N, g * N], dim=-1)
    x = x.reshape(B, h, P)
    Bm = Bm.reshape(B, g, N).repeat_interleave(h // g, dim=1)
    Cm = Cm.reshape(B, g, N).repeat_interleave(h // g, dim=1)
    dt = F.softplus(dt.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    dA = torch.exp(dt * A)
    st = cache["state"]
    st = st * dA[..., None, None].to(st.dtype) + torch.einsum(
        "bhp,bhn->bhpn", x * dt[..., None].to(x.dtype), Bm
    ).to(st.dtype)
    y = torch.einsum("bhpn,bhn->bhp", st, Cm)
    y = y + x * p.D[None, :, None]
    y = _gated_rmsnorm(y.reshape(B, di), z, p.ssm_norm, cfg.norm_eps)
    out = (y @ p.out_proj)[:, None, :]
    if active is not None:
        keep = active > 0
        st = torch.where(keep[:, None, None, None], st, cache["state"])
        new_conv = torch.where(keep[:, None, None], new_conv, cache["conv"])
    return out, {"state": st, "conv": new_conv}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["hymba-1.5b", NAME])
def test_cpu_ssm_decode_keeps_the_formula_bit_for_bit(arch, dtype):
    """On the CPU ``ssm_decode`` is the formula it was before the kernel,
    bit for bit (its state update now ``ssm_state_update_plain``), with
    and without an active mask, and writes nothing of the cache given."""
    from repro_torch.models.ssm import ssm_decode

    cfg = tm.reduced(ARCHS[arch], dtype=dtype, ssm_groups=2)
    model = _model(cfg, seed=3).to(getattr(torch, dtype))
    p = model.blocks[0].ssm
    B, dt = 5, getattr(torch, dtype)
    g = torch.Generator().manual_seed(7)
    u = torch.randn((B, 1, cfg.d_model), generator=g).to(dt)
    cache = {"state": torch.randn((B, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state), generator=g).to(dt),
             "conv": torch.randn((B, cfg.ssm_conv - 1, cfg.ssm_conv_dim),
                                 generator=g).to(dt)}
    kept = {k: t.clone() for k, t in cache.items()}
    for active in (torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32), None):
        got_out, got = ssm_decode(cfg, p, u, cache, active)
        want_out, want = _ssm_decode_before_the_kernel(cfg, p, u, cache,
                                                       active)
        assert torch.equal(got_out, want_out)
        for name in ("state", "conv"):
            assert torch.equal(got[name], want[name])
            assert torch.equal(cache[name], kept[name])
            assert got[name] is not cache[name]


def test_block_decode_leaves_the_cache_equal_written_in_place_or_not(
        monkeypatch):
    """``_block_decode`` copies a mixer's new tensors into the cache and
    skips those the mixer already wrote there (the card's state update):
    a mixer that writes in place leaves the same cache and logits."""
    import repro_torch.models.transformer as tr

    real = tr.ssm_decode

    def in_place(cfg, p, u, cache, active=None):
        out, new = real(cfg, p, u, cache, active)
        for name, t in new.items():
            cache[name].copy_(t)
            new[name] = cache[name]
        return out, new

    cfg = _cfg()
    model = _model(cfg, seed=5)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (6, 3, 1))
    acts = rng.integers(0, 2, (6, 3))
    runs = []
    for mixer in (real, in_place):
        monkeypatch.setattr(tr, "ssm_decode", mixer)
        cache = tm.init_decode_cache(cfg, 3, 16, device="cpu")
        logits = [tm.decode_step(cfg, model, {
            "tokens": torch.from_numpy(t).int(),
            "active": torch.from_numpy(a).int()}, cache)[0]
            for t, a in zip(toks, acts)]
        runs.append((logits, tm.cache_tensors(cache)))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)
    assert any(t.abs().sum() > 0 for t in runs[1][1][1:])


def _update_operands(N=16, dtype=torch.bfloat16, B=2, H=4, P=8, G=2):
    return (torch.zeros((B, H, P, N), dtype=dtype),
            torch.zeros((B, H), dtype=dtype),
            torch.zeros((B, H, P), dtype=dtype),
            torch.zeros((B, G, N), dtype=dtype),
            torch.zeros((B, G, N), dtype=dtype),
            torch.ones((B,), dtype=torch.int32))


@pytest.mark.parametrize("case,match", [
    ("cpu", "one CUDA device"), ("N", "state sizes"),
    ("dtype", "one float type"), ("strided", "contiguous state"),
])
def test_state_update_kernel_refuses_what_it_is_not_built_for(case, match):
    """The kernel's wrapper raises, never falls back: on a CPU tensor, a
    state size it is not built for (16 and 128 are), a type other than
    bf16 or f32 (or operands of mixed types), a state that is not
    contiguous."""
    from repro_torch.kernels.ops import SSM_STATE_SIZES, ssm_state_update_cuda

    assert SSM_STATE_SIZES == (16, 128)
    ops = list(_update_operands(
        N=32 if case == "N" else 16,
        dtype=torch.float16 if case == "dtype" else torch.bfloat16))
    if case == "strided":
        ops[0] = torch.zeros((2, 4, 16, 8),
                             dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        ssm_state_update_cuda(*ops)


def test_fused_update_counter_reads_zero_on_the_cpu():
    """``ssm.fused_updates`` counts the Mamba2 layers a step updated in one
    launch: none on the CPU, where the plain state update runs."""
    from repro_torch.kernels.ops import SSM_UPDATE

    cfg = _cfg()
    d = CurpServeDriver(cfg, ServeConfig(max_batch=2, max_seq=32,
                                         device="cpu"),
                        params=_model(cfg, seed=1))
    counter = registry().counter("ssm.fused_updates")
    before, launched = counter.value, SSM_UPDATE.launches
    d.submit("a", [3, 1, 4])
    d.generate(3)
    assert counter.value == before and SSM_UPDATE.launches == launched
    assert len(d.sessions["a"].tokens) == 6
