"""The decode attention kernel's host side, on the CPU.

``decode_attn.cu`` runs only on the card (``tests/test_torch_gpu.py`` holds
it against the plain path there).  Here: its wrapper refuses what the
kernel is not built for, the driver's ``attn.fused_decodes`` counts no
launch on the CPU, and the bound the card's tests hold the kernel to
(``parity.decode_attention_bound``) holds the plain path against the same
contract summed exactly, the one difference it allows being the order of
the sums; and the tighter agreement they are also held to
(``parity.DECODE_ATTENTION_AGREEMENT``) holds that contract at the served
shapes and fails it with a planted fault.
"""
import numpy as np
import pytest
import torch

import repro_torch.models as tm
from repro_torch.configs import ARCHS
from repro_torch.core.telemetry import registry
from repro_torch.kernels import ops, parity
from repro_torch.models.layers import sdpa_decode_plain
from repro_torch.serving import CurpServeDriver, ServeConfig


def _operands(dh=64, dtype=torch.bfloat16, B=2, C=8, Hkv=2, rep=2):
    return (torch.zeros((B, 1, Hkv * rep, dh), dtype=dtype),
            torch.zeros((B, C, Hkv, dh), dtype=dtype),
            torch.zeros((B, C, Hkv, dh), dtype=dtype),
            torch.zeros((B,), dtype=torch.int32), 0.125)


@pytest.mark.parametrize("case,match", [
    ("cpu", "one CUDA device"), ("device", "one CUDA device"),
    ("dh", "head sizes"), ("rep", "query heads"),
    ("dtype", "one float type"), ("positions", "one float type"),
    ("strided", "contiguous cache"), ("shape", "do not fit one layer"),
])
def test_decode_attention_kernel_refuses_what_it_is_not_built_for(case,
                                                                   match):
    """The kernel's wrapper raises, never falls back: on CPU tensors, on
    tensors of two devices, a head size it is not built for (16, 64 and 128
    are), more than 8 query heads a KV head, q in another type than the
    cache or positions that are not int32, a cache that is not contiguous,
    and a V ring of another shape than K's."""
    assert ops.DECODE_HEAD_DIMS == (16, 64, 128)
    assert ops.DECODE_MAX_REP == 8
    q, k, v, pos, scale = _operands(
        dh=32 if case == "dh" else 64,
        rep=9 if case == "rep" else 2)
    if case == "device":
        q = q.to("meta")
    if case == "dtype":
        q = q.float()
    if case == "positions":
        pos = pos.long()
    if case == "strided":
        k = torch.zeros((2, 2, 8, 64), dtype=torch.bfloat16).transpose(1, 2)
    if case == "shape":
        v = v[:, :4]
    with pytest.raises(ValueError, match=match):
        ops.decode_attention_cuda(q, k, v, pos, scale)


def test_fused_decode_counter_reads_zero_on_the_cpu():
    """``attn.fused_decodes`` counts the attention layers a step ran in one
    launch: none on the CPU, where the plain path runs."""
    cfg = tm.reduced(ARCHS["hymba-1.5b"])
    d = CurpServeDriver(cfg, ServeConfig(max_batch=2, max_seq=32,
                                         device="cpu"),
                        params=tm.Transformer(cfg, device="cpu", seed=1))
    counter = registry().counter("attn.fused_decodes")
    before, launched = counter.value, ops.DECODE_ATTN.launches
    d.submit("a", [3, 1, 4])
    d.generate(3)
    assert counter.value == before and ops.DECODE_ATTN.launches == launched
    assert len(d.sessions["a"].tokens) == 6


def _contract(q, k, v, pos, scale, fault=None):
    """The kernel's contract (``decode_attn.cu``) with every sum exact (f64)
    and each rounding to the type where the contract rounds; or, by
    ``fault``, a kernel that reads one slot too few ("short"), leaves p
    unrounded before PV ("unrounded") or drops one of its 16 warps' slots
    from PV ("warp": the last warp at dh 64 and 128 in bf16)."""
    B, C, Hkv, dh = k.shape
    rep = q.shape[2] // Hkv
    dt = k.dtype
    n = parity.live_slots(pos, C) - int(fault == "short")
    qd = q.double().reshape(B, Hkv, rep, dh)
    raw = torch.einsum("bgrd,btgd->bgrt", qd, k.double()).to(dt)
    s = raw.float() * scale
    live = (torch.arange(C)[None, :] < n[:, None])
    s = torch.where(live[:, None, None, :], s, -torch.inf)
    e = torch.exp((s - s.amax(-1, keepdim=True)).double()).float()
    p = e / e.double().sum(-1, keepdim=True).float()
    if fault != "unrounded":
        p = p.to(dt)
    if fault == "warp":
        slots = 32 // (dh // 8)          # the slots a warp reads at once
        t = torch.arange(C)
        p = torch.where((t % (16 * slots)) // slots == 15, 0.0, p)
    o = torch.einsum("bgrt,btgd->bgrd", p.double(), v.double()).to(dt)
    return o.reshape(B, 1, Hkv * rep, dh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_decode_attention_bound_holds_the_plain_path_to_its_contract(dtype):
    """``sdpa_decode_plain`` (einsums, the ring's mask, softmax) and the
    contract summed exactly lie within ``decode_attention_bound`` of each
    other at a hymba-like layer (rows at 0, C - 1, C and wrapped, the slots
    a row does not hold filled with values 100x larger), and, in f32, not
    for a row that reads one slot too few."""
    B, C, Hkv, rep, dh = 6, 96, 2, 5, 64
    scale = dh ** -0.5
    q, k, v, pos = parity.decode_attention_case(
        B, C, Hkv, rep, dh, dtype, "cpu", (0, 95, 96, 300, 7, 50), scale,
        seed=11)
    cfg = tm.reduced(ARCHS["llama3.2-1b"])
    want = sdpa_decode_plain(cfg, q, k, v, pos)
    got = _contract(q, k, v, pos, scale)
    tol = parity.decode_attention_bound(q, k, v, pos, scale, want)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= tol).all()), float((gap / tol).max())
    if dtype == torch.float32:
        short = _contract(q, k, v, torch.where(pos == 50, 49, pos), scale)
        row = int((pos == 50).nonzero()[0, 0])
        miss = (short[row].float() - want[row].float()).abs() / tol[row]
        assert float(miss.max()) > 1.0


# The served layers at their cells' lengths, rows a few tokens apart (the
# ring cut to the live slots and a few more, which the mask keeps out):
# (name, B, C, Hkv, rep, dh, tokens of row 0).
SERVED = [("hymba-global", 8, 1800, 5, 5, 64, 1700),
          ("granite", 16, 700, 8, 4, 128, 600)]


def _served(shape, dtype, seed):
    _name, B, C, Hkv, rep, dh, tokens = shape
    scale = dh ** -0.5
    q, k, v, pos = parity.decode_attention_case(
        B, C, Hkv, rep, dh, dtype, "cpu", (tokens - 7 * np.arange(B)).tolist(),
        scale, seed=seed)
    want = sdpa_decode_plain(tm.reduced(ARCHS["llama3.2-1b"]), q, k, v, pos)
    return q, k, v, pos, scale, want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SERVED, ids=[s[0] for s in SERVED])
def test_exact_contract_agrees_with_the_plain_path(shape, dtype):
    """The contract summed exactly meets ``DECODE_ATTENTION_AGREEMENT``
    against the plain path at the served layers, within the bound too."""
    q, k, v, pos, scale, want = _served(shape, dtype, seed=5)
    got = _contract(q, k, v, pos, scale)
    assert parity.decode_attention_agrees(got, want), \
        parity.decode_attention_agreement(got, want)
    tol = parity.decode_attention_bound(q, k, v, pos, scale, want)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("fault,dtype", [
    ("short", torch.bfloat16), ("unrounded", torch.bfloat16),
    ("warp", torch.bfloat16), ("short", torch.float32),
    ("warp", torch.float32)],
    ids=["short-bf16", "unrounded-bf16", "warp-bf16", "short-f32",
         "warp-f32"])
@pytest.mark.parametrize("shape", SERVED, ids=[s[0] for s in SERVED])
def test_agreement_fails_a_planted_fault(shape, fault, dtype):
    """A kernel one slot short, rounding p elsewhere (bf16 only: f32 does
    not round p) or dropping one warp's slots fails the agreement at the
    served layers; the first two may still pass the summation order's
    bound, which is why the agreement is checked besides."""
    q, k, v, pos, scale, want = _served(shape, dtype, seed=6)
    got = _contract(q, k, v, pos, scale, fault)
    assert not parity.decode_attention_agrees(got, want), \
        parity.decode_attention_agreement(got, want)
