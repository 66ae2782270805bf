"""The serving cells: ``CurpServeDriver`` decoding sessions back to back.

Traffic parameters (``traffic/<mix>.json``): ``sessions`` submitted at
set-up (every slot of the batch live), prompt lengths uniform in
[``prompt_min``, ``prompt_max``] with token ids uniform over the
vocabulary; ``warm_steps`` decode steps in set-up; ``trace_steps``, the
steps the profiler covers at the start of a traced window;
``check_sessions``, how many sessions (the longest among them) the
reference reads after the window; ``gap_limit``, the widest served-token
logit gap a correct run may show.

The weights are the benchmark's input: drawn on the card from the seed in
one call, in bf16, scaled by fan-in, and loaded into the program
(``Transformer.from_state_dict``); the reference reads the same bf16
values in float32.

The window runs ``step()`` back to back: one decode-graph replay and one
CURP ``commit_batch`` of every live session a token.  A session that would
pass ``max_seq`` fails the run.  After the window each session's committed
state is read back through ``CurpSessionStore.load``, the program is freed,
and the reference runs over the sampled sessions' prompts and served
tokens; at each served position it reads the gap by which the served token
lies below its best logit.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np

from perfbench import counts, traffic
from perfbench.reference import hymba as ref


def layout(m: dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """(name, shape, init) of every parameter: init is a standard
    deviation (drawn) or ("value", what) for the fixed ones."""
    d, dh, hq, hkv = m["d_model"], m["d_head"], m["n_heads"], m["n_kv_heads"]
    ff, V = m["d_ff"], m["vocab"]
    di = m["ssm_expand"] * d
    H = di // m["ssm_head_dim"]
    N, K = m["ssm_state"], m["ssm_conv"]
    conv = di + 2 * N
    out = [("embed", (V, d), d ** -0.5)]
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [
            (p + "norm1", (d,), ("value", "ones")),
            (p + "attn.wq", (d, hq * dh), d ** -0.5),
            (p + "attn.wk", (d, hkv * dh), d ** -0.5),
            (p + "attn.wv", (d, hkv * dh), d ** -0.5),
            (p + "attn.wo", (hq * dh, d), (hq * dh) ** -0.5),
            (p + "ssm.in_proj", (d, 2 * di + 2 * N + H), d ** -0.5),
            (p + "ssm.conv_w", (K, conv), 0.2),
            (p + "ssm.conv_b", (conv,), ("value", "zeros")),
            (p + "ssm.A_log", (H,), ("value", "log_1_16")),
            (p + "ssm.D", (H,), ("value", "ones")),
            (p + "ssm.dt_bias", (H,), ("value", "zeros")),
            (p + "ssm.ssm_norm", (di,), ("value", "ones")),
            (p + "ssm.out_proj", (di, d), di ** -0.5),
            (p + "norm2", (d,), ("value", "ones")),
            (p + "mlp.w_gate", (d, ff), d ** -0.5),
            (p + "mlp.w_up", (d, ff), d ** -0.5),
            (p + "mlp.w_down", (ff, d), ff ** -0.5),
        ]
    out += [("final_norm", (d,), ("value", "ones")),
            ("lm_head", (d, V), d ** -0.5)]
    return out


def make_weights(m: dict, seed: int, device: str, dtype):
    """The named weights, drawn from ``seed`` on ``device`` in one call."""
    import torch

    lay = layout(m)
    drawn = [(n, s, std) for n, s, std in lay if not isinstance(std, tuple)]
    total = sum(int(np.prod(s)) for _n, s, _ in drawn)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**63 - 1))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    state: Dict[str, "torch.Tensor"] = {}
    at = 0
    for n, s, std in drawn:
        k = int(np.prod(s))
        state[n] = flat[at:at + k].view(s).mul_(std)
        at += k
    for n, s, (_v, what) in ((n, s, i) for n, s, i in lay
                             if isinstance(i, tuple)):
        if what == "ones":
            t = torch.ones(s, device=device)
        elif what == "zeros":
            t = torch.zeros(s, device=device)
        else:
            t = torch.log(torch.linspace(1.0, 16.0, s[0], device=device))
        state[n] = t.to(dtype)
    return state


def _model_config(m: dict):
    from repro_torch.models.config import ModelConfig

    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in m.items()}
    return ModelConfig(**kw)


def run(run) -> None:
    import torch
    from repro_torch.core import WitnessGeometry
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.server import CurpServeDriver, ServeConfig

    m, sc, tr = run.config["model"], run.config["serve"], run.traffic
    dev = run.device
    cfg = _model_config(m)
    dtype = getattr(torch, m["dtype"])
    state = make_weights(m, run.seed, dev, dtype)
    model = Transformer.from_state_dict(cfg, state, device=dev)
    serve = ServeConfig(
        max_batch=sc["max_batch"], max_seq=sc["max_seq"],
        commit_every=sc["commit_every"], f=sc["f"],
        sync_batch=sc["sync_batch"], n_shards=sc["n_shards"],
        n_slots=sc["n_slots"],
        witness_geometry=WitnessGeometry(sc["witness_sets"],
                                         sc["witness_ways"]),
        witness_backend=sc["witness_backend"], device=dev)
    driver = CurpServeDriver(cfg, serve, params=model)
    prompts = traffic.prompts(run.seed, tr["sessions"], tr["prompt_min"],
                              tr["prompt_max"], m["vocab"])
    ids = [f"s{j}" for j in range(len(prompts))]
    for sid, p in zip(ids, prompts):
        driver.submit(sid, p)
    t_prev = None
    for _ in range(tr["warm_steps"]):
        driver.step()
        t_prev = time.perf_counter()
    _sync(dev)
    run.setup_done()

    # The window.
    max_seq = sc["max_seq"]
    gaps = run.samples["token_gap_s"]
    n_tokens = steps = 0
    undo = None
    if run.trace_on:
        undo = _instrument(run, driver, m)
        run.start_trace()
    t0 = time.perf_counter()
    t_prev = t_prev or t0
    while True:
        longest = max(len(s.tokens) for s in driver.sessions.values())
        if longest + 1 > max_seq:
            raise RuntimeError(f"a session would pass max_seq {max_seq}")
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
    _sync(dev)
    run.values["window_s"] = time.perf_counter() - t0
    if undo is not None:
        run.stop_trace()
        undo()
    run.read_memory_peak()
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


def sample(run, ids, prompts):
    """The sessions the reference reads: the longest and others drawn from
    the seed, ``check_sessions`` in all."""
    k = min(run.traffic["check_sessions"], len(ids))
    longest = int(np.argmax([len(p) for p in prompts]))
    rest = [j for j in range(len(ids)) if j != longest]
    rng = traffic.rng_for(run.seed, traffic.STREAM_SAMPLE)
    pick = rng.permutation(rest)[:k - 1].tolist()
    return [longest] + sorted(pick)


def reference_logits(m, state, tokens, precision, device):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        return ref.forward_logits(
            m, lambda n: state[n].float(),
            torch.tensor(tokens, device=device), precision)


def check_gaps(run, m, state, prompts, ids, served, control=False):
    """Widest served-token gap over the sampled sessions (with
    ``control``, also the fp8 control's: the gap of the token fp8 puts
    first at each served position)."""
    import torch

    widest, widest_ctl = 0.0, 0.0
    for j in sample(run, ids, prompts):
        toks = served[ids[j]]
        first = len(prompts[j]) - 1
        lg = reference_logits(m, state, toks, "f32", run.device)
        t = torch.tensor(toks, device=lg.device)
        widest = max(widest, ref.served_gap(lg, t, first))
        if control:
            pick = reference_logits(m, state, toks, "fp8",
                                    run.device).argmax(dim=-1)
            widest_ctl = max(widest_ctl, ref.served_gap(lg, t, first, pick))
        del lg
    if control:
        run.values["control_gap"] = widest_ctl
    return widest


def _instrument(run, driver, m):
    """Traced run only: a span and a synchronisation around each decode
    replay, a host timer around each commit, and the step's bytes and
    FLOPs at each live row's real context."""
    decode0, commit0 = driver._decode, driver.store.commit_batch

    def decode(host):
        ctx = [len(driver.sessions[sid].tokens)
               for sid in driver.slots if sid]
        run.samples["traced_step_bytes"].append(counts.decode_bytes(m, ctx))
        run.samples["traced_step_flops"].append(counts.decode_flops(m, ctx))
        with run.span("decode"):
            out = decode0(host)
            _sync(run.device)
        return out

    def commit(states):
        with run.span("commit"):
            t0 = time.perf_counter()
            commit0(states)
            run.samples["commit_s"].append(time.perf_counter() - t0)

    driver._decode, driver.store.commit_batch = decode, commit

    def undo():
        driver._decode, driver.store.commit_batch = decode0, commit0
    return undo


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
