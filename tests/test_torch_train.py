"""The port's training arithmetic (``repro_torch.optim``, ``data``,
``launch.steps`` and the model's backward) against the JAX package's.

Every case runs on the CPU in f32 at ``reduced`` sizes.  Inputs are drawn
with numpy from a seed and handed to both packages; the reference's weights
and optimizer state come over through ``convert.params_from_jax`` and
``convert.opt_state_from_jax``.  Each tolerance is stated where it is used.
The JAX side is jitted once per case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as ropt
from repro.configs import ARCHS
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticPipeline as RefPipeline
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import init_params, loss_fn
from _port_cfg import reduced
from repro.optim.compression import _quantize_leaf as ref_quantize
import repro_torch.models as tm
import repro_torch.optim as topt
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim.compression import _quantize_leaf

KEY = jax.random.PRNGKey(0)
# f32 holds 24 bits: one ulp is 2^-23 of the value.  The two packages run
# the same f32 operations in the same order, but XLA may contract a multiply
# and an add into one rounding and its cos and pow differ from torch's by an
# ulp, so a value may sit a few ulps away: 1e-6 relative, about 8 ulps.
# Where a sum cancels (m * b1 + g * (1 - b1) near 0) those ulps are of the
# terms, not of the result: so also 1e-6 of the leaf's largest value.
F32_RTOL = 1e-6
# A bf16 moment or parameter is the f32 result rounded to 8 bits: an f32
# result an ulp away can round the other way, one bf16 ulp (2^-7 of the
# value at most).
BF16_RTOL = 2.0 ** -7


def _assert_close(got, want, rtol):
    """|got - want| <= rtol |want| + F32_RTOL max |want|, element-wise."""
    got, want = _f32(got), _f32(want)
    bound = rtol * np.abs(want) + F32_RTOL * np.abs(want).max()
    bad = np.abs(got - want) > bound
    assert not bad.any(), (got[bad][:4], want[bad][:4])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


# ----------------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------------
SHAPES = {"a": (64, 32), "b": (7,), "c": (3, 5, 9), "d": (300,)}


def _adam_inputs(rng, cfg, moments=True):
    """Parameters (``d`` in bf16, the rest f32), grads of scale 1 and
    moments as a few steps leave them, at step 3."""
    params, grads, m, v = {}, {}, {}, {}
    for k, shape in SHAPES.items():
        dt = np.float32
        params[k] = rng.normal(0, 0.1, shape).astype(dt)
        grads[k] = rng.normal(0, 1.0, shape).astype(dt)
        m[k] = (rng.normal(0, 0.1, shape) if moments
                else np.zeros(shape)).astype(np.float32)
        v[k] = (rng.random(shape) * 0.02 if moments
                else np.zeros(shape)).astype(np.float32)
    mdt = jnp.dtype(cfg.moment_dtype)
    ref = (
        {k: jnp.asarray(a, jnp.bfloat16 if k == "d" else jnp.float32)
         for k, a in params.items()},
        {k: jnp.asarray(a, jnp.bfloat16 if k == "d" else jnp.float32)
         for k, a in grads.items()},
        {"m": {k: jnp.asarray(a, mdt) for k, a in m.items()},
         "v": {k: jnp.asarray(a, mdt) for k, a in v.items()},
         "step": jnp.asarray(3, jnp.int32)},
    )
    # the port's tensors are the reference's, bit for bit (bf16 included)
    def tensors(tree):
        return {k: torch.from_numpy(_f32(a)).to(
            tm.transformer.torch_dtype(str(a.dtype))) for k, a in tree.items()}

    port = (tensors(ref[0]), tensors(ref[1]),
            {"m": tensors(ref[2]["m"]), "v": tensors(ref[2]["v"]),
             "step": torch.tensor(3, dtype=torch.int32)})
    return ref, port


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e9], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(moment_dtype, clip_norm):
    """One update of f32 and bf16 parameters from non-zero moments at step
    3 (bias corrections and warmup in play).  The grads' global norm is
    ~60, so a clip norm of 1 scales them and 1e9 leaves them.  Parameters,
    moments and metrics within ``F32_RTOL`` of the reference (bf16 ones
    within ``BF16_RTOL``: one rounding to 8 bits)."""
    cfg = topt.AdamWConfig(moment_dtype=moment_dtype, clip_norm=clip_norm,
                           warmup_steps=5, total_steps=1000)
    rcfg = ropt.AdamWConfig(moment_dtype=moment_dtype, clip_norm=clip_norm,
                            warmup_steps=5, total_steps=1000)
    (rp, rg, ro), (p, g, o) = _adam_inputs(np.random.default_rng(7), cfg)
    want_p, want_o, want_m = jax.jit(
        lambda p, g, o: ropt.adamw_update(p, g, o, rcfg))(rp, rg, ro)
    got_p, got_o, got_m = topt.adamw_update(p, g, o, cfg)
    assert int(got_o["step"]) == int(want_o["step"]) == 4
    np.testing.assert_allclose(_f32(got_m["grad_norm"]),
                               _f32(want_m["grad_norm"]), rtol=F32_RTOL)
    np.testing.assert_allclose(_f32(got_m["lr"]), _f32(want_m["lr"]),
                               rtol=F32_RTOL)
    assert (float(want_m["grad_norm"]) > clip_norm) == (clip_norm == 1.0)
    for k in SHAPES:
        rtol = BF16_RTOL if k == "d" else F32_RTOL
        assert got_p[k].dtype == (torch.bfloat16 if k == "d"
                                  else torch.float32)
        _assert_close(got_p[k], want_p[k], rtol)
        mrtol = BF16_RTOL if moment_dtype == "bfloat16" else F32_RTOL
        for mom in ("m", "v"):
            assert got_o[mom][k].dtype == tm.transformer.torch_dtype(
                moment_dtype)
            _assert_close(got_o[mom][k], want_o[mom][k], mrtol)


def test_lr_schedule_matches_reference():
    """Warmup over 100 steps, cosine to a tenth by 1000, flat after:
    steps 0-1200 within ``F32_RTOL`` (cos in two libraries)."""
    cfg = topt.AdamWConfig(warmup_steps=100, total_steps=1000)
    rcfg = ropt.AdamWConfig(warmup_steps=100, total_steps=1000)
    steps = np.arange(1201, dtype=np.int32)
    want = np.asarray(ropt.lr_at(rcfg, jnp.asarray(steps)))
    got = topt.lr_at(cfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=0)
    assert got[0] == 0 and float(got[1200]) == pytest.approx(3e-5)


def test_opt_state_starts_at_zero_beside_the_params():
    model = tm.Transformer(reduced(ARCHS["smollm-360m"]), device="cpu")
    st = topt.init_opt_state(model, topt.AdamWConfig(moment_dtype="bfloat16"),
                             device="cpu")
    names = dict(model.named_parameters())
    assert st["m"].keys() == st["v"].keys() == names.keys()
    assert all(st["m"][k].shape == p.shape and st["m"][k].dtype
               == torch.bfloat16 and not st["v"][k].any()
               for k, p in names.items())
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    with pytest.raises(ValueError, match="lives on"):
        topt.init_opt_state(model, topt.AdamWConfig(), device="meta")


# ----------------------------------------------------------------------------
# compression
# ----------------------------------------------------------------------------
def _leaves(rng):
    """Odd sizes (padding), an all-zero block, exact ties at x.5 steps of
    the scale, and values of many magnitudes."""
    ties = np.zeros(256, np.float32)
    ties[0] = 127.0
    ties[1:64] = np.arange(63, dtype=np.float32) + 0.5
    return [rng.normal(0, 0.01, 1000).astype(np.float32),
            rng.normal(0, 1, (37, 29)).astype(np.float32),
            np.zeros(300, np.float32), ties,
            (rng.standard_cauchy(513) * 10).astype(np.float32),
            np.float32([3.0])]


def test_int8_codes_and_dequantized_bits_match_reference():
    """The same f32 leaves give the same int8 codes, the same f32 scales
    and the same dequantized bits, exactly (the same f32 divisions and
    products; rounding half to even on both sides)."""
    for x in _leaves(np.random.default_rng(3)):
        q_ref, s_ref = ref_quantize(jnp.asarray(x))
        q, s = _quantize_leaf(torch.from_numpy(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                      np.asarray(s_ref).view(np.uint32))
        want = np.asarray(ropt.roundtrip_leaf(jnp.asarray(x)))
        got = topt.roundtrip_leaf(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_error_feedback_rounds_match_reference():
    """Five rounds of ``compress_grads`` with error feedback on a dict of
    leaves: what is sent and what is fed back, bit for bit."""
    rng = np.random.default_rng(4)
    g = {f"l{i}": x for i, x in enumerate(_leaves(rng))}
    ef_ref = ef = None
    for _ in range(5):
        deq_ref, ef_ref = ropt.compress_grads(
            {k: jnp.asarray(x) for k, x in g.items()}, ef_ref)
        deq, ef = topt.compress_grads(
            {k: torch.from_numpy(x) for k, x in g.items()}, ef)
        for k in g:
            for got, want in ((deq[k], deq_ref[k]), (ef[k], ef_ref[k])):
                np.testing.assert_array_equal(
                    got.numpy().view(np.uint32),
                    np.asarray(want).view(np.uint32))


class TestCompression:
    """Twins of tests/test_ft_serving.py::TestCompression on the port."""

    def test_roundtrip_error_bounded(self):
        r = np.random.default_rng(0)
        g = torch.from_numpy(r.normal(0, 0.01, (1000,)).astype(np.float32))
        q = topt.roundtrip_leaf(g)
        rel = float((q - g).abs().max() / (g.abs().max() + 1e-12))
        assert rel < 0.01   # int8 per-block: <1% of block max

    def test_error_feedback_unbiased_over_steps(self):
        r = np.random.default_rng(0)
        g = {"w": torch.from_numpy(r.normal(0, 1, (512,)).astype(np.float32))}
        ef = None
        acc = np.zeros(512, np.float64)
        n = 20
        for _ in range(n):
            deq, ef = topt.compress_grads(g, ef)
            acc += deq["w"].numpy().astype(np.float64)
        mean_sent = acc / n
        err = np.abs(mean_sent - g["w"].numpy()).max()
        one_shot = np.abs(topt.compress_grads(g)[0]["w"].numpy()
                          - g["w"].numpy()).max()
        assert err <= one_shot + 1e-6   # EF never worse than one-shot
        assert err < 0.01


# ----------------------------------------------------------------------------
# data
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype", [("smollm-360m", "float32"),
                                        ("hubert-xlarge", "bfloat16"),
                                        ("qwen2-vl-2b", "float32")])
def test_batch_for_matches_reference(arch, dtype):
    """Tokens and labels (a token model), bf16 frame embeddings (an audio
    model) and M-RoPE positions (a VLM), element for element and in the
    reference's dtypes, at three steps; and a step's batch rebuilt alone
    equals the one built in sequence (the replay contract)."""
    cfg = reduced(ARCHS[arch], dtype=dtype)
    ref = RefPipeline(cfg, RefDataConfig(seed=11, batch=3, seq=40))
    port = SyntheticPipeline(cfg, DataConfig(seed=11, batch=3, seq=40),
                             device="cpu")
    want_keys = {"labels", "tokens" if cfg.frontend == "token" else "embeds"}
    if cfg.pos == "mrope":
        want_keys.add("positions")
    for step in (0, 1, 17):
        want, got = ref.batch_for(step), port.batch_for(step)
        assert got.keys() == want.keys() == want_keys
        for k, v in want.items():
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
            assert tuple(got[k].shape) == v.shape
            np.testing.assert_array_equal(_f32(got[k]), _f32(v))
    again = SyntheticPipeline(cfg, DataConfig(seed=11, batch=3, seq=40),
                              device="cpu").batch_for(17)
    assert all(torch.equal(again[k], got[k]) for k in got)


# ----------------------------------------------------------------------------
# the backward
# ----------------------------------------------------------------------------
def _pair(arch, **overrides):
    cfg = reduced(ARCHS[arch], **overrides)
    params = init_params(cfg, KEY)
    model = tm.Transformer.from_state_dict(
        cfg, params_from_jax(cfg, _np(params)), device="cpu")
    return cfg, params, model


def _batches(cfg, steps, batch=2, seq=32):
    ref = RefPipeline(cfg, RefDataConfig(seed=5, batch=batch, seq=seq))
    port = SyntheticPipeline(cfg, DataConfig(seed=5, batch=batch, seq=seq),
                             device="cpu")
    return [(ref.batch_for(s), port.batch_for(s)) for s in steps]


def _port_grads(cfg, model, batch):
    named = dict(model.named_parameters())
    loss, aux = tm.loss_fn(cfg, model, batch)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True, materialize_grads=True)
    return loss, aux, dict(zip(named, grads))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_grads_match_jax_grad(arch):
    """Every parameter's gradient against ``jax.grad`` of the reference's
    ``loss_fn`` on the same weights and batch: within 1e-4 of the leaf's
    largest |g| (f32 sums over 32-128 terms in other orders, through two
    layers and their backward; measured: at most 6e-6 of it, mamba2's), and
    the loss within 1e-5 relative (measured: at most 1.6e-7)."""
    cfg, params, model = _pair(arch)
    (rb, pb), = _batches(cfg, [0])
    (want_loss, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(cfg, p, b), has_aux=True))(params, rb)
    loss, aux, grads = _port_grads(cfg, model, pb)
    np.testing.assert_allclose(_f32(loss), _f32(want_loss), rtol=1e-5)
    np.testing.assert_allclose(_f32(aux["aux"]), _f32(want_aux["aux"]),
                               rtol=1e-5, atol=1e-7)
    want = params_from_jax(cfg, _np(want_g))
    assert want.keys() == grads.keys()
    for k, g in grads.items():
        assert g.dtype == want[k].dtype, k
        scale = float(want[k].abs().max())
        err = float((g - want[k]).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b",
                                  "mamba2-130m", "qwen3-moe-30b-a3b"])
def test_remat_gives_the_same_grads_bit_for_bit(arch):
    """Activation checkpointing recomputes each block's forward op for op,
    so loss and every gradient equal the plain run's exactly (a dense
    model, a hybrid with single and scan segments, an SSM and an MoE)."""
    cfg, _, model = _pair(arch)
    (_, pb), = _batches(cfg, [0])
    plain = _port_grads(cfg, model, pb)
    remat = _port_grads(reduced(ARCHS[arch], remat=True), model, pb)
    assert torch.equal(plain[0], remat[0])
    assert all(torch.equal(plain[2][k], remat[2][k]) for k in plain[2])


def test_three_train_steps_match_reference():
    """Three ``make_train_step`` steps (steps 3-5 of warmup 5) from the
    reference's params and moments after two of its own steps.  Loss, ce
    and ``grad_norm`` within 1e-5 relative (f32 forward and backward in
    other orders; measured: 1.1e-7 at most).  A parameter whose m/sqrt(v)
    sits near zero can take the other sign on the two sides, so a
    parameter may move apart by 2 x lr a step: bound 2 x (sum of the three
    lrs) + 1e-6; and fewer than 0.1% of the elements may differ by more
    than 1e-5, a thirtieth of one step's lr (measured: none; the largest
    difference 1.1e-6)."""
    cfg, params, _ = _pair("smollm-360m")
    ocfg = ropt.AdamWConfig(warmup_steps=5, total_steps=1000)
    step = jax.jit(ref_make_train_step(cfg, ocfg))
    batches = _batches(cfg, range(5))
    opt = ropt.init_opt_state(params, ocfg)
    for rb, _ in batches[:2]:
        params, opt, _ = step(params, opt, rb)
    model = tm.Transformer.from_state_dict(
        cfg, params_from_jax(cfg, _np(params)), device="cpu")
    port_opt = opt_state_from_jax(cfg, _np(opt))
    assert int(port_opt["step"]) == 2
    train_step = make_train_step(cfg, topt.AdamWConfig(warmup_steps=5,
                                                       total_steps=1000))
    lrs = 0.0
    for rb, pb in batches[2:]:
        params, opt, want = step(params, opt, rb)
        model, port_opt, got = train_step(model, port_opt, pb)
        assert set(got) == set(want) == {"loss", "ce", "aux", "grad_norm",
                                         "lr"}
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(_f32(got[k]), _f32(want[k]),
                                       rtol=1e-5)
        np.testing.assert_allclose(_f32(got["lr"]), _f32(want["lr"]),
                                   rtol=F32_RTOL)
        lrs += float(want["lr"])
    assert int(port_opt["step"]) == int(opt["step"]) == 5
    want_p = params_from_jax(cfg, _np(params))
    diffs = np.concatenate([
        (p.detach() - want_p[k]).abs().reshape(-1).numpy()
        for k, p in model.named_parameters()])
    assert diffs.max() <= 2 * lrs + 1e-6, diffs.max()
    assert np.mean(diffs > 1e-5) < 1e-3, np.mean(diffs > 1e-5)


def test_prefill_and_serve_steps():
    """The prefill step's last-position f32 logits are ``forward``'s, and
    the serve step's next tokens are the argmax of ``decode_step``."""
    cfg, _, model = _pair("llama3.2-1b")
    (_, pb), = _batches(cfg, [0])
    last = make_prefill_step(cfg)(model, pb)
    with torch.no_grad():
        logits, _ = tm.forward(cfg, model, pb)
    assert last.dtype == torch.float32 and torch.equal(last, logits[:, -1])
    cache = tm.init_decode_cache(cfg, 2, 8, device="cpu")
    tok = pb["tokens"][:, :1]
    nxt, cache = make_serve_step(cfg)(model, {"tokens": tok}, cache)
    ref_cache = tm.init_decode_cache(cfg, 2, 8, device="cpu")
    want, _ = tm.decode_step(cfg, model, {"tokens": tok}, ref_cache)
    assert nxt.dtype == torch.int32
    assert torch.equal(nxt, want.argmax(-1).int())
    assert cache["pos"].tolist() == [1, 1]
