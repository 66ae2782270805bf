"""The granite cell: granite-4.0-h-small served through ``CurpServeDriver``,
and the serving window it shares with ``entries/serve_atomic.py``.

Traffic parameters as ``entries/serve.py`` takes them (``sessions``,
``prompt_min``/``prompt_max``, ``warm_steps``, ``trace_steps``,
``check_sessions``, ``gap_limit``).  The model config is built before any
weight is drawn, so a program that lacks one of its fields fails at once.
The weights, the benchmark's input, are drawn on the card from the seed in
one bf16 ``randn`` (32.2e9 values, 64.4 GB) and adopted by
``Transformer.from_state_dict`` without a copy: one copy is live.  After
the window the driver and its caches are freed and the f32 reference
(``reference/granite.py``) reads those same bf16 tensors, one weight at a
time, over the sampled sessions.

``served_logit_gap`` and ``gap_limit``: at each served position the gap
by which the served token's reference logit lies below the reference's
best, in units of that position's reference logit spread (the standard
deviation over the vocabulary), averaged over the session's served
positions; the widest session's mean is compared.  The logits are divided
by ``logits_scaling`` (16) over a tied head drawn small (see ``layout``),
so their spread is ~0.005 over 100,352 ids and the top ids lie close
together: the widest single gap (``entries/serve.py``'s reading) puts a
bf16 run's near-ties within 3x of the fp8 control's picks.  Averaged, a
near-tie weighs what it is, and a fault that moves every position of a
session (one slot's cache, the attention at length) moves the whole
mean.  The limit and the readings it rests on are in PERF.md.

Besides ``entries/serve.py``'s samples the window reads the program's MoE
counters at its edges (``moe.routed``, ``moe.rows_computed``: the driver's
host counts a step), and a traced run the experts its traced steps touched
(``moe.experts_touched``, a device counter read between steps, never
inside one) for their least bytes.
"""
from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from perfbench import counts_granite, harness, traffic
from perfbench.reference import granite as ref

_serve = harness.load_module(Path(__file__).with_name("serve.py"))
MOE_COUNTERS = ("moe.routed", "moe.rows_computed", "moe.experts_touched")


def layout(m: dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """(name, shape, init) of every parameter, in the program's names: init
    is a standard deviation (drawn) or ("value", what) for the fixed
    ones."""
    d, dh, hq, hkv = m["d_model"], m["d_head"], m["n_heads"], m["n_kv_heads"]
    E, ff, sff = m["n_experts"], m["moe_d_ff"], m["shared_d_ff"]
    di = m["ssm_expand"] * d
    H = di // m["ssm_head_dim"]
    N, K = m["ssm_state"], m["ssm_conv"]
    conv = di + 2 * m["ssm_groups"] * N
    # The embedding enters the residual stream times embedding_multiplier
    # (12) and is the tied head: drawn at d^-0.5 / 12, so that the scaled
    # input has a block input's scale.  At d^-0.5 the tied head scores each
    # position's own token ~7 standard deviations above the rest, the
    # random model only repeats its input, and no served token comes near
    # a tie: the comparison could not tell bf16 from fp8.
    out = [("embed", (m["vocab"], d),
            d ** -0.5 / m["embedding_multiplier"])]
    for i, kind in enumerate(m["layer_types"]):
        p = f"blocks.{i}."
        out.append((p + "norm1", (d,), ("value", "ones")))
        if kind == "attention":
            out += [
                (p + "attn.wq", (d, hq * dh), d ** -0.5),
                (p + "attn.wk", (d, hkv * dh), d ** -0.5),
                (p + "attn.wv", (d, hkv * dh), d ** -0.5),
                (p + "attn.wo", (hq * dh, d), (hq * dh) ** -0.5),
            ]
        else:
            out += [
                (p + "ssm.in_proj", (d, di + conv + H), d ** -0.5),
                (p + "ssm.conv_w", (K, conv), 0.2),
                (p + "ssm.conv_b", (conv,), 0.1),
                (p + "ssm.A_log", (H,), ("value", "log_1_16")),
                (p + "ssm.D", (H,), ("value", "ones")),
                (p + "ssm.dt_bias", (H,), ("value", "zeros")),
                (p + "ssm.ssm_norm", (di,), ("value", "ones")),
                (p + "ssm.out_proj", (di, d), di ** -0.5),
            ]
        out += [
            (p + "norm2", (d,), ("value", "ones")),
            (p + "moe.router", (d, E), d ** -0.5),
            (p + "moe.w_gate", (E, d, ff), d ** -0.5),
            (p + "moe.w_up", (E, d, ff), d ** -0.5),
            (p + "moe.w_down", (E, ff, d), ff ** -0.5),
            (p + "moe.shared.w_gate", (d, sff), d ** -0.5),
            (p + "moe.shared.w_up", (d, sff), d ** -0.5),
            (p + "moe.shared.w_down", (sff, d), sff ** -0.5),
        ]
    return out + [("final_norm", (d,), ("value", "ones"))]


def make_weights(m: dict, seed: int, device: str, dtype):
    """The named weights, the drawn ones from one ``randn`` over ``seed``
    on ``device`` (each a view of it, scaled in place)."""
    import torch

    lay = layout(m)
    drawn = [(n, s, std) for n, s, std in lay if not isinstance(std, tuple)]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**63 - 1))
    flat = torch.randn(sum(int(np.prod(s)) for _n, s, _ in drawn),
                       generator=g, device=device, dtype=dtype)
    state: Dict[str, "torch.Tensor"] = {}
    at = 0
    for n, s, std in drawn:
        k = int(np.prod(s))
        state[n] = flat[at:at + k].view(s).mul_(std)
        at += k
    fixed = {"ones": lambda s: torch.ones(s, device=device),
             "zeros": lambda s: torch.zeros(s, device=device),
             "log_1_16": lambda s: torch.log(torch.linspace(
                 1.0, 16.0, s[0], device=device))}
    for n, s, init in lay:
        if isinstance(init, tuple):
            state[n] = fixed[init[1]](s).to(dtype)
    return state


def position_gaps(logits, tokens, first: int, pick=None):
    """At each served position ``t >= first``: the gap by which the token
    at ``t + 1`` (or ``pick``'s at ``t``: a control's first) lies below the
    reference's best logit at ``t``, and ``t``'s logit spread."""
    lg = logits[first:-1]
    served = tokens[first + 1:] if pick is None else pick[first:-1]
    best = lg.max(dim=-1).values
    got = lg.gather(1, served[:, None].long())[:, 0]
    return best - got, lg.std(dim=-1)


def check_gaps(run, m, state, prompts, ids, served, control=False):
    """The widest sampled session's mean served gap in spread units
    against the f32 reference (with ``control``, also the fp8 control's).
    ``run.values`` keeps the widest single gap beside it, raw
    (``gap_widest``) and in spread units (``gap_widest_units``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    read = {"": [0.0, 0.0, 0.0], "control_": [0.0, 0.0, 0.0]}

    def logits(toks, precision):
        with torch.no_grad():
            return ref.forward_logits(
                m, lambda n: state[n].float(),
                torch.tensor(toks, device=run.device), precision)

    def note(key, gap, spread):
        if gap.numel():
            r = read[key]
            units = gap / spread
            r[0] = max(r[0], float(units.mean()))
            r[1] = max(r[1], float(gap.max()))
            r[2] = max(r[2], float(units.max()))

    for j in _serve.sample(run, ids, prompts):
        toks = served[ids[j]]
        first = len(prompts[j]) - 1
        lg = logits(toks, "f32")
        t = torch.tensor(toks, device=lg.device)
        note("", *position_gaps(lg, t, first))
        if control:
            pick = logits(toks, "fp8").argmax(dim=-1)
            note("control_", *position_gaps(lg, t, first, pick))
        del lg
    for key in read if control else ("",):
        mean, widest, widest_units = read[key]
        run.values[key + "gap"] = mean
        run.values[key + "gap_widest"] = widest
        run.values[key + "gap_widest_units"] = widest_units
    return read[""][0]


def _moe_counts() -> Dict[str, int]:
    from repro_torch.core.telemetry import registry

    snap = registry().snapshot("moe.")
    return {n: snap[n]["value"] for n in MOE_COUNTERS if n in snap}


def serve(run, *, make_weights, check_gaps, step_bytes, step_flops,
          atomic: bool = False) -> None:
    """One serving run: weights drawn and adopted, ``sessions`` submitted,
    ``warm_steps`` steps (set-up), ``step()`` back to back for the window
    (one graph replay and one CURP commit of every live session a token:
    ``commit_batch``, or with ``atomic`` one ``store.txn`` a step), then
    every session read back and ``check_sessions`` held against the
    reference.  ``step_bytes(m, contexts, touched)`` and
    ``step_flops(m, contexts)`` count a traced step."""
    import torch
    from repro_torch.core import WitnessGeometry
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.server import CurpServeDriver, ServeConfig

    m, sc, tr = run.config["model"], run.config["serve"], run.traffic
    dev = run.device
    cfg = _serve._model_config(m)
    state = make_weights(m, run.seed, dev, getattr(torch, m["dtype"]))
    model = Transformer.from_state_dict(cfg, state, device=dev)
    kw = dict(atomic_step_commit=True) if atomic else {}
    driver = CurpServeDriver(cfg, ServeConfig(
        max_batch=sc["max_batch"], max_seq=sc["max_seq"],
        commit_every=sc["commit_every"], f=sc["f"],
        sync_batch=sc["sync_batch"], n_shards=sc["n_shards"],
        n_slots=sc["n_slots"],
        witness_geometry=WitnessGeometry(sc["witness_sets"],
                                         sc["witness_ways"]),
        witness_backend=sc["witness_backend"], device=dev, **kw),
        params=model)
    prompts = traffic.prompts(run.seed, tr["sessions"], tr["prompt_min"],
                              tr["prompt_max"], m["vocab"])
    ids = [f"s{j}" for j in range(len(prompts))]
    for sid, p in zip(ids, prompts):
        driver.submit(sid, p)
    t_prev = None
    for _ in range(tr["warm_steps"]):
        driver.step()
        t_prev = time.perf_counter()
    _serve._sync(dev)
    run.setup_done()

    # The window.
    moe0 = _moe_counts() if cfg.has_moe else {}
    gaps = run.samples["token_gap_s"]
    n_tokens = steps = 0
    undo = None
    if run.trace_on:
        undo = _instrument(run, driver, m, atomic, step_bytes, step_flops)
        run.start_trace()
    t0 = time.perf_counter()
    t_prev = t_prev or t0
    while True:
        longest = max(len(s.tokens) for s in driver.sessions.values())
        if longest + 1 > sc["max_seq"]:
            raise RuntimeError(f"a session would pass max_seq "
                               f"{sc['max_seq']}")
        out = driver.step()
        t = time.perf_counter()
        gaps.extend([t - t_prev] * len(out))
        t_prev = t
        n_tokens += len(out)
        steps += 1
        if undo is not None and steps == tr["trace_steps"]:
            run.stop_trace()
            undo()
            undo = None
        if t - t0 >= run.seconds:
            break
    _serve._sync(dev)
    run.values["window_s"] = time.perf_counter() - t0
    if undo is not None:
        run.stop_trace()
        undo()
    run.read_memory_peak()
    for name, v in _moe_counts().items():
        if name in moe0:
            run.counts[name] = v - moe0[name]
    run.counts["tokens"] = n_tokens
    run.counts["steps"] = steps
    run.attempted = n_tokens

    served = {sid: list(driver.sessions[sid].tokens) for sid in ids}
    loaded = [driver.store.load(sid) for sid in ids]
    stored = sum(s is None or s.tokens != served[sid]
                 for s, sid in zip(loaded, ids))
    del driver, model
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    gap = check_gaps(run, m, state, prompts, ids, served, run.control)
    run.failed = stored
    run.check("store_mismatches", stored, 0)
    run.check("served_logit_gap", gap, tr["gap_limit"])
    if run.control:
        run.check("control_served_logit_gap", run.values["control_gap"],
                  tr["gap_limit"])


def _instrument(run, driver, m, atomic, step_bytes, step_flops):
    """Traced run only: a span and a synchronisation around each decode
    replay, a host timer around each commit (``store.txn`` when
    ``atomic``), and each traced step's bytes and FLOPs at its live rows'
    real contexts, with the experts the traced steps touched."""
    store = driver.store
    commit_name = "txn" if atomic else "commit_batch"
    decode0, commit0 = driver._decode, getattr(store, commit_name)
    touched0 = _moe_counts().get("moe.experts_touched", 0)
    contexts = []

    def decode(host):
        contexts.append([len(driver.sessions[sid].tokens)
                         for sid in driver.slots if sid])
        with run.span("decode"):
            out = decode0(host)
            _serve._sync(run.device)
        return out

    def commit(states):
        with run.span("commit"):
            t0 = time.perf_counter()
            out = commit0(states)
            run.samples["commit_s"].append(time.perf_counter() - t0)
        return out

    driver._decode = decode
    setattr(store, commit_name, commit)

    def undo():
        driver._decode = decode0
        setattr(store, commit_name, commit0)
        touched = (_moe_counts().get("moe.experts_touched", 0) - touched0) \
            / max(1, len(contexts))
        for ctx in contexts:
            run.samples["traced_step_bytes"].append(
                step_bytes(m, ctx, touched))
            run.samples["traced_step_flops"].append(step_flops(m, ctx))
    return undo


def run(run) -> None:
    serve(run, make_weights=make_weights, check_gaps=check_gaps,
          step_bytes=counts_granite.decode_bytes,
          step_flops=counts_granite.decode_flops)
