"""CurpServeDriver: batched autoregressive serving with CURP-durable
sessions.

The serving master is speculative state (model KV caches + live sessions);
durability comes from (a) witness-recorded session commits (1 RTT) and (b)
batched backup syncs — both via CurpSessionStore.  After a master crash the
driver restores sessions from the recovered store and REBUILDS the KV caches
by re-prefilling each live session's tokens (the compute-for-durability
trade CURP makes: journal bytes are tiny because state is recomputable).

The torch port of ``repro.serving.server``: the session and commit logic is
the reference's, line for line.  ``ServeConfig.device`` places the model,
its cache and the store's witness gang.  A decode step always runs at
``max_batch`` rows, so one row's logits never depend on which other rows
are active, and it is one fixed shape: where the reference jits it once,
the driver on a CUDA device captures it once, at its first decode, as a
CUDA graph (the embedding, ``decode_step`` over the driver's own cache and
the argmax), and each token is then one replay, its tokens and active mask
copied in through a pinned buffer and its next tokens read back in one
copy.  On the CPU the same step runs eagerly.  There is no switch and no
fallback, as the reference's jit has none: a step that cannot be captured
raises.
"""
from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import WitnessGeometry
from ..core.telemetry import enabled, get_registry, span
from ..kernels.ops import STEP_KERNELS, step_launches
from ..models.config import ModelConfig
from ..models.moe import RoutingTally
from ..models.transformer import (
    Transformer,
    cache_tensors,
    decode_step,
    init_decode_cache,
    latent_slots,
    resolve_device,
)
from .kvstore import CurpSessionStore, SessionState


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 128
    commit_every: int = 1      # session commits per generated token
    f: int = 3
    sync_batch: int = 50
    n_shards: int = 1          # session partitions (one master group each)
    # Slot-table size for the session router: the unit of live migration
    # (CurpSessionStore.migrate_sessions / rebalance moves slots between
    # master groups with no serving pause on untouched slots).
    n_slots: int = 256
    # Witness table shape (S x W), threaded down to the gang kernels.
    witness_geometry: WitnessGeometry = field(default_factory=WitnessGeometry)
    # "python" (protocol-reference slot walk) or "device" (the witness gang
    # on the CUDA kernels; one fused dispatch per commit batch).
    witness_backend: str = "python"
    # Commit each decode step's sessions as ONE atomic cross-shard
    # mini-transaction (CurpSessionStore.txn) instead of the per-session
    # durable batch: a crash can never persist half a step's sessions.
    atomic_step_commit: bool = False
    # Where the model, its decode cache and the store's witness gang live:
    # "cuda" (raises without a card) or "cpu".
    device: str = "cuda"


class CurpServeDriver:
    def __init__(self, cfg: ModelConfig, serve: ServeConfig,
                 params: Optional[Transformer] = None, seed: int = 0) -> None:
        assert cfg.can_decode, "serving needs a decoder"
        self.cfg = cfg
        self.serve = serve
        self.device = resolve_device(serve.device)
        if params is None:
            params = Transformer(cfg, device=self.device, seed=seed)
        elif params.device != self.device:
            raise ValueError(f"params live on {params.device}, the serve "
                             f"config asks for {self.device}")
        self.params = params
        self.store = CurpSessionStore(f=serve.f, sync_batch=serve.sync_batch,
                                      n_shards=serve.n_shards,
                                      geometry=serve.witness_geometry,
                                      witness_backend=serve.witness_backend,
                                      n_slots=serve.n_slots,
                                      device=serve.device)
        self.sessions: Dict[str, SessionState] = {}
        self.cache: Optional[Dict] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_replays = 0     # decode steps run as a replay of the graph
        self._reset_cache()
        self.tokens_served = 0
        reg = get_registry()
        self._m_tokens = reg.counter("serve.tokens")
        self._m_recoveries = reg.counter("serve.recoveries")
        self._m_replayed = reg.counter("serve.replayed_ops")
        # An MoE step's routing: the rows its dispatch multiplies and the
        # picks a live row makes, as the step was built (``RoutingTally``),
        # counted here at each step; the experts the live rows touched are
        # added on the device inside the step.
        self._count_routing = cfg.has_moe and enabled()
        self._m_rows = reg.counter("moe.rows_computed")
        self._m_routed = reg.counter("moe.routed")
        self._rows_a_step = self._picks_a_row = 0
        # The step's own kernels (``ssm.fused_updates``: the Mamba2 layers
        # whose state it updates in one launch; ``attn.fused_decodes``: the
        # attention layers it runs in one launch), their launches as the
        # step was built (none on the CPU), counted here at each step.
        self._m_step = {name: reg.counter(name) for name in STEP_KERNELS}
        self._launched_a_step: Dict[str, int] = {}
        # An MLA step's latent slots: those its attention reads (every
        # row's whole cache in each MLA layer, as the step is built) and
        # those holding a live row's context, from the host's copy of the
        # rows' positions.
        self._mla_layers, _rows, self._mla_slots = latent_slots(self.cache)
        self._count_mla = self._mla_layers > 0 and enabled()
        self._m_slots_read = reg.counter("mla.slots_read")
        self._m_slots_live = reg.counter("mla.slots_live")

    @torch.no_grad()
    def _step_body(self, inputs: torch.Tensor):
        """The step the graph holds: ``inputs`` [2, B] int32 (tokens over
        the active mask) through ``decode_step`` on the driver's cache.
        Returns (f32 logits [B, V], greedy tokens [B])."""
        batch = {"tokens": inputs[0][:, None], "active": inputs[1]}
        tally = RoutingTally(inputs[1]) if self._count_routing else None
        with step_launches() as self._launched_a_step:
            logits, _ = decode_step(self.cfg, self.params, batch, self.cache,
                                    tally)
        if tally is not None:
            self._rows_a_step = tally.rows
            self._picks_a_row = tally.picks_a_row
        return logits, torch.argmax(logits, dim=-1)

    def _decode(self, host: np.ndarray) -> torch.Tensor:
        """One decode step of all ``max_batch`` rows; ``host`` is [2, B]
        int32, tokens over the active mask.  Returns the f32 logits, a
        tensor of the caller's own, and leaves the greedy tokens in
        ``self._next`` until the next step."""
        if self.device.type != "cuda":
            logits, self._next = self._step_body(torch.from_numpy(host))
            self._count(host)
            return logits
        if self._graph is None:
            self._capture()
        self._check_addresses()
        self._staged.synchronize()     # the last step's copy has read it
        self._host_in.numpy()[:] = host
        self._inputs.copy_(self._host_in, non_blocking=True)
        self._staged.record()
        self._graph.replay()
        self.graph_replays += 1
        self._count(host)
        return self._logits.clone()    # the next replay overwrites _logits

    def _count(self, host: np.ndarray) -> None:
        """A step's host counts: its own kernels' launches, an MoE step's
        routing and an MLA step's latent slots (``host[1]`` is the step's
        active mask); then each live row's position moves on."""
        live = host[1] > 0
        for name, n in self._launched_a_step.items():
            self._m_step[name].inc(n)
        if self._count_routing:
            self._m_rows.inc(self._rows_a_step)
            self._m_routed.inc(self._picks_a_row * int(np.count_nonzero(live)))
        if self._count_mla:
            L, C = self._mla_layers, self._mla_slots
            self._m_slots_read.inc(L * self.serve.max_batch * C)
            self._m_slots_live.inc(L * int(np.minimum(self._pos[live] + 1,
                                                      C).sum()))
        self._pos += live

    def _capture(self) -> None:
        """Capture the decode step as a CUDA graph, once.  The warm-up and
        the capture run on a side stream with every row inactive, which
        leaves each cache tensor bit-unchanged (checked here against a host
        copy), so neither disturbs a live session."""
        if any(hasattr(p, "placements") for p in self.params.parameters()):
            raise NotImplementedError(
                "the serving driver captures its decode step as a CUDA graph, "
                "which is not shown to hold for DTensor parameters; serve "
                "plain tensors")
        B = self.serve.max_batch
        self._host_in = torch.zeros((2, B), dtype=torch.int32,
                                    pin_memory=True)
        self._inputs = torch.zeros((2, B), dtype=torch.int32,
                                   device=self.device)
        self._staged = torch.cuda.Event()
        before = [t.cpu() for t in cache_tensors(self.cache)]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                self._step_body(self._inputs)                # warm-up
            with torch.cuda.graph(graph, stream=side):
                self._logits, self._next = self._step_body(self._inputs)
        except Exception as e:
            raise RuntimeError("the decode step cannot be captured as a CUDA "
                               f"graph: {_refusal(e)}") from e
        torch.cuda.current_stream(self.device).wait_stream(side)
        if not all(torch.equal(a, t.cpu())
                   for a, t in zip(before, cache_tensors(self.cache))):
            raise RuntimeError("a decode step with no active row changed the "
                               "cache; it cannot be warmed up and captured "
                               "beside live sessions")
        self._addresses = [t.data_ptr() for t in cache_tensors(self.cache)]
        self._graph = graph

    def _check_addresses(self) -> None:
        """The captured graph reads and writes the cache at the addresses
        it had at capture: the cache must never be reallocated."""
        moved = [t.data_ptr() for t in cache_tensors(self.cache)]
        if self._graph is not None and moved != self._addresses:
            raise RuntimeError("the decode cache moved after its graph was "
                               "captured")

    def _reset_cache(self) -> None:
        """Every slot free and its cache zero: allocated at the first call,
        then zeroed in place (a captured graph holds the addresses)."""
        if self.cache is None:
            self.cache = init_decode_cache(
                self.cfg, self.serve.max_batch, self.serve.max_seq,
                device=self.device,
            )
        else:
            for t in cache_tensors(self.cache):
                t.zero_()
            self._check_addresses()
        self._pos = np.zeros(self.serve.max_batch, np.int64)  # cache "pos"
        self.slots: List[Optional[str]] = [None] * self.serve.max_batch

    # -- session management --------------------------------------------------------
    def submit(self, session_id: str, prompt: List[int]) -> None:
        s = SessionState(session_id, list(prompt))
        self.sessions[session_id] = s
        self.store.commit(s)
        slot = self.slots.index(None)
        self.slots[slot] = session_id
        # Feed all but the last token: step() feeds tokens[-1], keeping the
        # fed-token stream identical across normal and recovered runs.
        self._replay_tokens(slot, s.tokens[:-1])

    def _replay_tokens(self, slot: int, tokens: List[int]) -> None:
        """Feed tokens through decode to build this slot's KV/SSM state; the
        per-slot active mask keeps other sessions' caches and positions
        untouched (mixed-length batching)."""
        for t in tokens:
            self._decode(self._batch_for(slot, t))

    def _batch_for(self, slot: int, token: int) -> np.ndarray:
        host = np.zeros((2, self.serve.max_batch), np.int32)
        host[0, slot] = token
        host[1, slot] = 1
        return host

    # -- decoding -----------------------------------------------------------------
    def step(self) -> Dict[str, int]:
        """One batched decode step for every live slot; commit via CURP."""
        with span("serve.step"):
            live = [(i, sid) for i, sid in enumerate(self.slots) if sid]
            if not live:
                return {}
            host = np.zeros((2, self.serve.max_batch), np.int32)
            last, active = host
            for i, sid in live:
                last[i] = self.sessions[sid].tokens[-1]
                active[i] = 1
            self._decode(host)
            out: Dict[str, int] = {}
            nxt = self._next.tolist()          # one copy back
            to_commit: List[SessionState] = []
            for i, sid in live:
                tok = nxt[i]
                s = self.sessions[sid]
                s.tokens.append(tok)
                out[sid] = tok
                self.tokens_served += 1
                self._m_tokens.inc()
                if len(s.tokens) % self.serve.commit_every == 0:
                    to_commit.append(s)
            # One batched CURP round for the whole decode step: distinct
            # session keys commute, so the batch completes via each shard's
            # 1-RTT path.  With atomic_step_commit the step commits as ONE
            # mini-transaction instead (all-or-nothing across shards;
            # single-shard steps keep the 1-RTT short-circuit).
            with span("serve.commit"):
                if self.serve.atomic_step_commit:
                    self.store.txn(to_commit)
                else:
                    self.store.commit_batch(to_commit)
            return out

    def generate(self, n_tokens: int) -> None:
        for _ in range(n_tokens):
            self.step()

    # -- failures -----------------------------------------------------------------
    def crash_and_recover(self) -> Dict[str, int]:
        """Master (driver state) dies; sessions recover from CURP store; KV
        caches rebuild by re-prefill."""
        report = self.store.crash_and_recover()
        live_ids = [sid for sid in self.slots if sid]
        self.sessions = {}
        self._reset_cache()
        recovered = 0
        for sid in live_ids:
            s = self.store.load(sid)
            if s is None:
                continue
            self.sessions[sid] = s
            slot = self.slots.index(None)
            self.slots[slot] = sid
            self._replay_tokens(slot, s.tokens[:-1])
            recovered += 1
        self._m_recoveries.inc()
        self._m_replayed.inc(report.replayed)
        return {"recovered_sessions": recovered,
                "replayed_ops": report.replayed}


def _refusal(e: BaseException) -> str:
    """What refused a capture: the first error of the chain (a failed
    capture's end raises again over it) and the port's innermost line on
    its way."""
    while e.__context__ is not None:
        e = e.__context__
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in Path(f.filename).parts]
    where = ""
    if frames:
        f = frames[-1]
        where = f" at {Path(f.filename).name}:{f.lineno} ({f.line})"
    return f"{type(e).__name__}{where}: {e}"
