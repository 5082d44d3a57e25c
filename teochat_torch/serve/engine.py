"""Continuous-batching serving engine: per-request KV rows over one cache.

Port of teochat_tpu/serve/engine.py. Up to `max_slots` requests share ONE
KV cache of `max_slots + prefix_cache_slots` rows:

- each request prefills into its own cache row (`cache_row_offset`,
  models/llama.py) while the other rows keep decoding between chunks;
- decode runs in chunks of `chunk` steps over all request rows: one step
  (`_decode_step`) embeds each row's last token, writes at its position
  (an inactive row at the trash slot), runs the decoder with each row's live
  length capped on the device (`kv_len`, K2 reads an inactive row's one
  slot), samples, and records the token in a [max_slots, chunk] buffer;
- with `speculative_k` = k > 0 a chunk runs `chunk` verify iterations
  (`_spec_step`): each row drafts k tokens by prompt lookup over its
  history, the block [last token, drafts] goes through one spec_verify
  forward (K2m, each query up to its own slot), and each row emits 1 to
  k + 1 tokens into a [max_slots, chunk, k + 1] buffer with their counts.
  Greedy rows emit the plain step's tokens; sampled rows draw by exact
  speculative sampling against the point-mass draft (`_spec_emissions`).
  The adaptive controller (`_update_spec_mode`) falls back to plain chunks
  while the tokens an iteration stay below `spec_disable_below`, and
  re-probes with one speculative chunk every `spec_probe_every` chunks;
- admission and completion happen on the host at chunk boundaries;
- greedy rows give the tokens of a single-request `TEOChat.generate`, up to
  floating-point argmax ties between batch shapes.

Every forward goes through models/generation.py's backend dispatch
(`backend_embed`, `backend_forward`), so the engine serves the LLaMA and the
MPT decoder alike.

The scheduler's numbers live on the device in `EngineState`, fixed-shape
tensors written in place (never rebound): on the card each step is captured
once an engine in a CUDA graph (models/generation.py::DecodeGraph; the
plain step and the speculative step each have an entry the engine owns,
outside the session table) and replayed `chunk` times a chunk, and the
graphs read these tensors where they lay at their capture. On the CPU the
same steps run eagerly. The prefills run eagerly on the same stream between
chunks; each returns its first token as a device tensor, which the host
reads later (`_resolve_pending_first`).

Multi-LoRA: over params with adapter-stacked LoRA leaves
(train/lora.py::stack_lora_adapters) each request names its adapter (-1:
the base model). The steps route every row from `EngineState.adapter` on
the device (`_engine_route`), so the captured graphs read each slot's
adapter where it lies; the eager prefills route their one row; a pooled
prefix seeds only requests of its own adapter.

The cache is in `kv_dtype` (None: the model's dtype), e.g. "float8_e4m3fn",
which halves its bytes and so doubles the rows a card holds: its writes
cast once, K2 and K2m read it in place, and the prefix pool's row copies
move its bytes as they lie.

The host reads a chunk's tokens one chunk late (the JAX engine's depth-1
pipeline): chunk N + 1 is replayed before chunk N is read. A replay rewrites
the step's output buffers, so each chunk's outputs are copied into one of
two pinned host buffers of their kind (a plain chunk's tokens; a
speculative chunk's tokens and counts), with an event, before the next
chunk is replayed.

Every device call of the engine's scheduler thread is made under
`device_lock`; the chat server in engine mode takes it around each session
turn, so one thread at a time issues device work (a CUDA graph capture
fails if another thread allocates or synchronizes during it, and the
kernels' ticket buffers are shared).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from teochat_torch.config import GenerationConfig, TEOChatConfig
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.models import generation as gen_mod
from teochat_torch.models import llama as llama_mod
from teochat_torch.models import teochat as teochat_mod
from teochat_torch.train import lora as lora_mod

# Suffix-prefill panel widths (a prefix-cache hit prefills only [plen, end)):
# smaller low buckets than teochat.SEQ_BUCKETS, since hit suffixes are often
# a few dozen tokens
SUFFIX_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4352)


@dataclasses.dataclass
class EngineState:
    """The scheduler's state: fixed-shape device tensors, written in place."""

    cache: llama_mod.KVCache  # [L, max_slots + pool rows, max_len, Hkv, D]
    last_tokens: torch.Tensor  # [S] int32: each row's last token (fed next)
    positions: torch.Tensor  # [S] int32: the slot each row's next token is written at
    active: torch.Tensor  # [S] bool
    temperature: torch.Tensor  # [S] fp32
    do_sample: torch.Tensor  # [S] bool
    hist: torch.Tensor  # [S, max_len] int32: prompt text ids then generated ids (-1 past)
    hist_len: torch.Tensor  # [S] int32
    adapter: torch.Tensor  # [S] int32 (-1: the base model)
    tokens: torch.Tensor  # [S, chunk] int32: the chunk's tokens, column `col` a step
    col: torch.Tensor  # [1] int64: the step's column
    generator: torch.Generator  # the engine's own: every sampled row draws from it
    # a speculative engine's chunk outputs (None without speculative_k):
    spec_tokens: Optional[torch.Tensor] = None  # [S, chunk, k + 1] int32, column `col` an iteration
    spec_counts: Optional[torch.Tensor] = None  # [S, chunk] int32: tokens emitted an iteration

    @property
    def device(self) -> torch.device:
        return self.active.device


def _engine_route(params, adapter_ids: torch.Tensor) -> Optional[torch.Tensor]:
    """[rows] adapter ids on the device -> the [rows, A] route, or None for
    params without adapter-stacked leaves (A is a property of the tree's
    shapes, so a captured step keeps its choice)."""
    n = lora_mod.num_stacked_adapters(params)
    return lora_mod.adapter_route(adapter_ids, n) if n else None


def _request_route(params, adapter: int, device) -> Optional[torch.Tensor]:
    """One request's [1, A] route (or None), for the eager prefills."""
    n = lora_mod.num_stacked_adapters(params)
    ids = torch.tensor([adapter], dtype=torch.int32, device=device) if n else None
    return lora_mod.adapter_route(ids, n) if n else None


def _init_engine_state(cache: llama_mod.KVCache, max_slots: int, max_len: int,
                       chunk: int, spec_k: int = 0) -> EngineState:
    dev = cache.k.device

    def buf(shape, dtype=torch.int32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    return EngineState(
        cache=cache, last_tokens=buf((max_slots,)), positions=buf((max_slots,)),
        active=buf((max_slots,), torch.bool), temperature=buf((max_slots,), torch.float32),
        do_sample=buf((max_slots,), torch.bool), hist=buf((max_slots, max_len), fill=-1),
        hist_len=buf((max_slots,)), adapter=buf((max_slots,), fill=-1),
        tokens=buf((max_slots, chunk)), col=buf((1,), torch.int64),
        generator=torch.Generator(device=dev).manual_seed(0),
        spec_tokens=buf((max_slots, chunk, spec_k + 1)) if spec_k else None,
        spec_counts=buf((max_slots, chunk)) if spec_k else None,
    )


def _deactivate_slot(state: EngineState, slot: int) -> None:
    """Host-decided request completion (stop string / max_new_tokens)."""
    state.active[slot] = False
    state.temperature[slot] = 0.0
    state.do_sample[slot] = False


def _sample_rows(logits: torch.Tensor, generator: torch.Generator, temperature: torch.Tensor,
                 do_sample: torch.Tensor) -> torch.Tensor:
    """Per-row greedy / temperature sampling (no top_p). logits [B, V] fp32;
    temperature, do_sample [B]. Returns [B] int32. Every row draws (fixed
    shapes for the graph); a greedy row keeps its argmax."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temp = temperature.clamp(min=1e-6)[:, None]
    probs = torch.softmax(logits / temp, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.where(do_sample & (temperature > 0.0), sampled, greedy)


def _sample_rows_excluding(logits: torch.Tensor, generator: torch.Generator,
                           temperature: torch.Tensor, excluded: torch.Tensor) -> torch.Tensor:
    """A per-row-temperature draw with one token's mass taken out and the
    rest renormalized: the residual draw of speculative rejection sampling
    against a point-mass draft. logits [B, V] fp32; temperature [B];
    excluded [B], a token id or -1 (a plain draw). Returns [B] int32."""
    lf = logits / temperature.clamp(min=1e-6)[:, None]
    vocab = torch.arange(lf.shape[-1], device=lf.device)
    excl = (vocab[None, :] == excluded[:, None]) & (excluded >= 0)[:, None]
    probs = torch.softmax(torch.where(excl, float("-inf"), lf), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _spec_emissions(blk_logits: torch.Tensor, targets: torch.Tensor, drafts: torch.Tensor,
                    greedy_row: torch.Tensor, temperature: torch.Tensor,
                    generator: torch.Generator):
    """Each row's emissions and acceptances for one speculative iteration.

    blk_logits [B, k + 1, V] the targets' logits for the block [tok, d_1..d_k];
    targets = their argmax; drafts [B, k]; greedy_row [B]. A greedy row
    accepts draft j where it equals the target before it and emits the
    targets. A sampled row accepts draft j with probability P_j(d_j) at its
    temperature; an accepted slot emits the draft, the first rejected one a
    residual draw (the draft's mass taken out), slot k a plain draw from P_k:
    every emitted token is distributed as plain sampling's. Every row draws
    k + 2 times (fixed shapes for the graph), all from `generator`.
    Returns (match [B, k] bool, emissions [B, k + 1] int32)."""
    b, k1, _ = blk_logits.shape
    k = k1 - 1
    p = torch.softmax(blk_logits[:, :k] / temperature.clamp(min=1e-6)[:, None, None], dim=-1)
    pd = torch.gather(p, -1, drafts.long()[..., None])[..., 0]
    u = torch.rand(pd.shape, generator=generator, device=blk_logits.device)
    match = torch.where(greedy_row[:, None], drafts == targets[:, :k], u < pd)
    no_draft = torch.full((b,), -1, dtype=torch.int32, device=blk_logits.device)
    emits = []
    for j in range(k + 1):
        res = _sample_rows_excluding(blk_logits[:, j], generator, temperature,
                                     drafts[:, j] if j < k else no_draft)
        emit_s = torch.where(match[:, j], drafts[:, j], res) if j < k else res
        emits.append(torch.where(greedy_row, targets[:, j], emit_s))
    return match, torch.stack(emits, dim=1)


def _activate_slot(state: EngineState, slot: int, tok: torch.Tensor, position: int,
                   temperature: float, do_sample: bool, hist_row: np.ndarray, hist_n: int,
                   adapter: int) -> None:
    """Every per-slot state write of an admission, in place: the draft
    history (prompt ids, then the first token), the first token, the slot of
    the next write, the row's sampling and adapter, active."""
    state.hist[slot].copy_(torch.as_tensor(hist_row, device=state.device))
    state.hist[slot, hist_n] = tok[0]
    state.last_tokens[slot] = tok[0]
    state.positions[slot] = position
    state.active[slot] = True
    state.temperature[slot] = temperature
    state.do_sample[slot] = do_sample
    state.hist_len[slot] = hist_n + 1
    state.adapter[slot] = adapter


def _sample_first(logits: torch.Tensor, state: EngineState, temperature: float,
                  do_sample: bool) -> torch.Tensor:
    dev = state.device
    return _sample_rows(logits[:, 0], state.generator,
                        torch.tensor([temperature], dtype=torch.float32, device=dev),
                        torch.tensor([do_sample], device=dev))


@torch.no_grad()
def _prefill_slot(params, cache, state: EngineState, cfg, plan, vision_tokens, slot: int,
                  temperature: float, do_sample: bool, hist_row, hist_n: int,
                  adapter: int) -> torch.Tensor:
    """Prefill one request into cache row `slot` (its contiguous panel from
    slot 0; causal attention over the fresh K/V, K1), sample its first token
    and activate the slot. Returns the first token [1] on the device. Other
    rows' K/V are untouched; pad keys of the right-padded prompt are never
    attended by its valid queries, and decode writes overwrite them."""
    dev = state.device
    embeds = teochat_mod.fuse_embeds(params, plan, vision_tokens)
    pos = torch.as_tensor(plan.position_ids, device=dev)
    logits = gen_mod.backend_forward(
        params, cfg, embeds, position_ids=pos, cache=cache, write_slots=pos,
        logits_mode="last", last_index=torch.as_tensor(plan.seq_lens - 1, device=dev),
        cache_row_offset=slot, adapter_route=_request_route(params, adapter, dev),
    )
    tok = _sample_first(logits, state, temperature, do_sample)
    _activate_slot(state, slot, tok, int(plan.seq_lens[0]), temperature, do_sample, hist_row,
                   hist_n, adapter)
    return tok


def _piece_positions(emb: torch.Tensor, start: int) -> torch.Tensor:
    return torch.arange(start, start + emb.shape[1], dtype=torch.int32, device=emb.device)[None]


@torch.no_grad()
def _prefill_chunk_write(params, cache, cfg, emb, start: int, slot: int, adapter: int) -> None:
    """Chunked prefill, a piece before the last: write its K/V into row
    `slot` at slots [start, start + S), each query attending the row's cache
    up to its own slot (the earlier pieces, K2m). No logits, no state."""
    pos = _piece_positions(emb, start)
    gen_mod.backend_forward(
        params, cfg, emb, position_ids=pos, cache=cache, write_slots=pos, logits_mode="none",
        cache_row_offset=slot, prefill_start=start, attend_cache=True,
        adapter_route=_request_route(params, adapter, emb.device),
    )


@torch.no_grad()
def _prefill_slot_tail(params, cache, state: EngineState, cfg, emb, start: int, seq_len: int,
                       last_index: int, slot: int, temperature: float, do_sample: bool,
                       hist_row, hist_n: int, adapter: int) -> torch.Tensor:
    """Chunked prefill, the last piece: write its K/V, take the prompt's
    last-token logits (attention over every piece committed), sample the
    first token and activate the slot: the chunked twin of _prefill_slot.
    Pad queries past the prompt write K/V past it, where decode writes
    overwrite them before any query reads them."""
    pos = _piece_positions(emb, start)
    logits = gen_mod.backend_forward(
        params, cfg, emb, position_ids=pos, cache=cache, write_slots=pos, logits_mode="last",
        last_index=torch.tensor([last_index], device=emb.device), cache_row_offset=slot,
        prefill_start=start, attend_cache=True,
        adapter_route=_request_route(params, adapter, emb.device),
    )
    tok = _sample_first(logits, state, temperature, do_sample)
    _activate_slot(state, slot, tok, seq_len, temperature, do_sample, hist_row, hist_n, adapter)
    return tok


@torch.no_grad()
def _copy_cache_row(cache, src_row: int, dst_row: int, length: int):
    """Copy KV slots [0, length) of cache row src_row into row dst_row, for
    all layers, K and V, in place (JAX's `_copy_row` and `_copy_cache_row`).
    Copying past a prefix's valid slots is harmless: every such slot is
    overwritten by the suffix panel or by a decode write before anything
    attends it."""
    for buf in (cache.k, cache.v):
        buf[:, dst_row, :length].copy_(buf[:, src_row, :length])
    return cache


@torch.no_grad()
def _prefill_slot_from_prefix(params, cache, state: EngineState, cfg, plan, vision_tokens,
                              src_row: int, slot: int, plen: int, fused_len: int, w: int,
                              copy_len: int, temperature: float, do_sample: bool, hist_row,
                              hist_n: int, adapter: int) -> torch.Tensor:
    """Prefix-cache hit: copy the pooled row's KV [0, copy_len) into row
    `slot`, then prefill only the `w`-slot suffix window from `plen` over the
    seeded prefix (K2m), sample the first token and activate the slot. The
    JAX engine fuses these into one program to save TPU dispatches; here they
    run one after another, with the same tokens."""
    _copy_cache_row(cache, src_row, slot, copy_len)
    embeds = teochat_mod.fuse_embeds(params, plan, vision_tokens)
    # padded by w so the window [plen, plen + w) is always in range; the pad
    # tail's K/V land past fused_len, where decode overwrites them first
    emb = F.pad(embeds, (0, 0, 0, w))[:, plen:plen + w]
    pos = _piece_positions(emb, plen)
    logits = gen_mod.backend_forward(
        params, cfg, emb, position_ids=pos, cache=cache, write_slots=pos, logits_mode="last",
        last_index=torch.tensor([fused_len - 1 - plen], device=emb.device),
        cache_row_offset=slot, prefill_start=plen, attend_cache=True,
        adapter_route=_request_route(params, adapter, emb.device),
    )
    tok = _sample_first(logits, state, temperature, do_sample)
    _activate_slot(state, slot, tok, fused_len, temperature, do_sample, hist_row, hist_n, adapter)
    return tok


def _decode_step(params, cfg, st: EngineState, generator, *, eos_id: int, pad_id: int,
                 emb_dtype) -> None:
    """One decode step over all request rows, in place; reads nothing back.

    JAX's `_decode_chunk` step: an inactive row writes at the trash slot
    (max_len - 1), emits pad_id and attends its slot 0 alone (kv_len 1: its
    output is thrown away); an active row writes at its position and
    attends up to it. A row that emits EOS goes inactive. The token lands in
    column `col` of the chunk's buffer. Each row runs its slot's adapter."""
    b = st.active.shape[0]
    trash = st.cache.max_len - 1
    act, pos = st.active, st.positions
    emb = gen_mod.backend_embed(params, st.last_tokens[:, None].long(), dtype=emb_dtype)
    # a row the host has stopped decodes on until its chunk ends: past the
    # cache its writes go to the trash slot (JAX drops them there)
    write = torch.where(act, pos, trash).clamp(max=trash)[:, None]
    kv_len = torch.where(act, pos + 1, 1).clamp(max=trash + 1)
    logits = gen_mod.backend_forward(params, cfg, emb, position_ids=pos[:, None], cache=st.cache,
                                     write_slots=write, kv_len=kv_len, logits_mode="last",
                                     adapter_route=_engine_route(params, st.adapter))
    nxt = _sample_rows(logits[:, -1], generator, st.temperature, st.do_sample)
    nxt = torch.where(act, nxt, pad_id)
    # the draft history stays fresh in plain chunks (the engine's speculative
    # mode drafts from it)
    rows = torch.arange(b, device=nxt.device)
    h_idx = st.hist_len.clamp(max=st.hist.shape[1] - 1).long()
    st.hist[rows, h_idx] = torch.where(act, nxt, st.hist[rows, h_idx])
    st.hist_len.add_(act.to(torch.int32))
    st.positions.add_(act.to(torch.int32))
    st.active.logical_and_(nxt != eos_id)
    st.last_tokens.copy_(nxt)
    st.tokens.index_copy_(1, st.col, nxt[:, None])
    st.col.add_(1)


@torch.no_grad()
def _decode_chunk(params, cfg, state: EngineState, *, chunk: int, eos_id: int, pad_id: int,
                  emb_dtype, graph: Optional[gen_mod.DecodeGraph] = None) -> torch.Tensor:
    """Run `chunk` decode steps over all rows: replayed from `graph` on the
    card, eagerly without one. Returns the token buffer [max_slots, chunk]
    (rewritten by the next chunk)."""
    state.col.zero_()
    if graph is not None:
        graph.run(chunk, params, cfg, state.generator)
    else:
        for _ in range(chunk):
            _decode_step(params, cfg, state, state.generator, eos_id=eos_id, pad_id=pad_id,
                         emb_dtype=emb_dtype)
    return state.tokens


def _spec_step(params, cfg, st: EngineState, generator, *, spec_k: int, eos_id: int,
               pad_id: int, emb_dtype) -> None:
    """One speculative iteration over all request rows, in place; reads
    nothing back (JAX's `_decode_chunk_spec` step).

    A row within k + 1 slots of the trash slot goes inactive (the capacity
    guard). Each row drafts k tokens by prompt lookup over its history; the
    block [last token, drafts] is written at slots pos + j (an inactive row
    writes all of it at the trash slot) and verified in one spec_verify
    forward. JAX's mask `slot <= pos + k` is a prefix of each row, so it is
    passed as kv_len = pos + k + 1 (1 for an inactive row): K2m reads
    min(q_slot + 1, kv_len) and no host read is made. The emission chain
    runs to the first rejected draft and stops at an EOS; the row's
    tokens, their count, history, position and last token follow it, and an
    EOS row goes inactive. The emissions land in column `col` of the chunk's
    buffers. Each row runs its slot's adapter."""
    k = spec_k
    b = st.active.shape[0]
    trash = st.cache.max_len - 1
    dev = st.device
    rows = torch.arange(b, device=dev)
    h_max = st.hist.shape[1]
    pos = st.positions
    act = st.active & (pos + k + 1 <= trash)  # the block never reaches the trash slot
    drafts = gen_mod._draft_lookup(st.hist, st.hist_len, k)
    blk = torch.cat([st.last_tokens[:, None], drafts], dim=1)  # [S, k + 1]
    blk_pos = pos[:, None] + torch.arange(k + 1, device=dev)[None, :]
    write = torch.where(act[:, None], blk_pos.clamp(max=trash - 1), trash)
    kv_len = torch.where(act, pos + k + 1, 1)
    emb = gen_mod.backend_embed(params, blk.long(), dtype=emb_dtype)
    blk_logits = gen_mod.backend_forward(params, cfg, emb, position_ids=blk_pos, cache=st.cache,
                                         write_slots=write, kv_len=kv_len, logits_mode="all",
                                         spec_verify=True,
                                         adapter_route=_engine_route(params, st.adapter))
    targets = torch.argmax(blk_logits, dim=-1).to(torch.int32)
    greedy_row = ~(st.do_sample & (st.temperature > 0.0))
    match, emissions = _spec_emissions(blk_logits, targets, drafts, greedy_row, st.temperature,
                                       generator)
    acc = torch.cumprod(match.to(torch.int32), dim=1).bool()
    counts = torch.zeros(b, dtype=torch.int32, device=dev)
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)  # an EOS inside this block
    new_tok = st.last_tokens.clone()
    out = []
    for j in range(k + 1):
        # the chain: every draft before this slot accepted, no EOS before it
        valid = act if j == 0 else act & acc[:, j - 1] & ~stopped
        emit = torch.where(valid, emissions[:, j], pad_id)
        out.append(emit)
        counts += valid.to(torch.int32)
        new_tok = torch.where(valid, emit, new_tok)
        h_idx = st.hist_len.clamp(max=h_max - 1).long()
        st.hist[rows, h_idx] = torch.where(valid, emit, st.hist[rows, h_idx])
        st.hist_len.add_(valid.to(torch.int32))
        stopped |= valid & (emit == eos_id)
    st.positions.add_(counts)
    # only an EOS and the capacity guard end a row: a rejected draft ends
    # the chain of this iteration alone
    st.active.copy_(act & ~stopped)
    st.last_tokens.copy_(new_tok)
    st.spec_tokens.index_copy_(1, st.col, torch.stack(out, dim=1)[:, None])
    st.spec_counts.index_copy_(1, st.col, counts[:, None])
    st.col.add_(1)


@torch.no_grad()
def _decode_chunk_spec(params, cfg, state: EngineState, *, chunk: int, spec_k: int, eos_id: int,
                       pad_id: int, emb_dtype, graph: Optional[gen_mod.DecodeGraph] = None):
    """Run `chunk` speculative iterations over all rows: replayed from
    `graph` on the card, eagerly without one. Returns the buffers (tokens
    [max_slots, chunk, k + 1], counts [max_slots, chunk]), rewritten by the
    next speculative chunk."""
    state.col.zero_()
    if graph is not None:
        graph.run(chunk, params, cfg, state.generator)
    else:
        for _ in range(chunk):
            _spec_step(params, cfg, state, state.generator, spec_k=spec_k, eos_id=eos_id,
                       pad_id=pad_id, emb_dtype=emb_dtype)
    return state.spec_tokens, state.spec_counts


@dataclasses.dataclass
class _Request:
    input_ids: List[int]
    pixel_values: Optional[np.ndarray]
    gen: GenerationConfig
    stop_strings: Sequence[str]
    event: threading.Event
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    slot: int = -1
    remaining: int = 0
    # streaming: new tokens are pushed per chunk; None ends the stream
    stream_q: Optional["queue.Queue"] = None
    _streamed: int = 0
    # chunked-prefill progress (None once prefilled, and for short prompts)
    pf: Optional[dict] = None
    # prefix-cache hit: (the pool entry matched, the tokens reused)
    prefix_hit: Optional[tuple] = None
    adapter: int = -1  # multi-LoRA adapter index (-1: the base model)

    def _push_stream(self, final: bool = False):
        if self.stream_q is None:
            return
        fresh = self.tokens[self._streamed:]
        if fresh:
            self.stream_q.put(fresh)
            self._streamed = len(self.tokens)
        if final:
            self.stream_q.put(None)


class BatchEngine:
    """Continuous-batching scheduler over a TEOChat model.

    submit() is thread-safe and blocks until the request completes (the
    HTTP handler calls it per request; concurrency comes from many handler
    threads sharing the engine). The engine runs where the model's params
    are: on the card, or on the CPU for tests.
    """

    def __init__(self, model: teochat_mod.TEOChat, *, max_slots: int = 4,
                 max_len: int = 2048, chunk: int = 8, kv_dtype=None,
                 speculative_k: int = 0,
                 adaptive_spec: bool = True,
                 spec_disable_below: float = 1.3,
                 spec_probe_every: int = 32,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache_slots: int = 0,
                 prefix_min_tokens: int = 256):
        kv_dtype = llama_mod.kv_dtype_of(kv_dtype, model.dtype)
        self.model = model
        self.cfg: TEOChatConfig = model.cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.chunk = chunk
        self.speculative_k = speculative_k
        # adaptive speculation: prompt lookup pays only where the output
        # echoes its context. The engine keeps an EMA of the tokens a verify
        # iteration emits over speculative chunks; below spec_disable_below
        # it runs plain chunks (the same greedy tokens) and re-probes with
        # one speculative chunk every spec_probe_every chunks
        self.adaptive_spec = adaptive_spec
        self.spec_disable_below = spec_disable_below
        self.spec_probe_every = spec_probe_every
        self._spec_ema: Optional[float] = None
        self._spec_on = True
        self._spec_probe_in = 0
        # chunked prefill: prompts longer than this many fused tokens commit
        # their K/V in prefill_chunk pieces, one piece a scheduling
        # iteration, so a long admission stalls running decodes by at most
        # one piece. None: monolithic prefill
        self.prefill_chunk = prefill_chunk
        # automatic prefix caching: `prefix_cache_slots` pool rows after the
        # request rows. A request whose leading text run (the ids before the
        # first <image>) shares at least prefix_min_tokens with a pooled run
        # copies that row's KV and prefills only the suffix. No decode step
        # reads a pool row: its row slice ends at max_slots
        self.prefix_cache_slots = prefix_cache_slots
        self.prefix_min_tokens = prefix_min_tokens
        self._prefix_entries: List[dict] = []  # {key, plen, row, stamp, adapter}
        self._prefix_clock = 0
        # multi-LoRA: the stacked adapter count (0: plain or single-LoRA params)
        self._n_adapters = lora_mod.num_stacked_adapters(model.params["llm"])
        self.device = model.device
        self.cache = llama_mod.init_cache(self.cfg.llm, max_slots + prefix_cache_slots, max_len,
                                          dtype=kv_dtype, device=self.device)
        self._state = _init_engine_state(self.cache, max_slots, max_len, chunk, speculative_k)
        # the decode graph entries, made by the first chunk of their kind on the card
        self._graph: Optional[gen_mod.DecodeGraph] = None
        self._spec_graph: Optional[gen_mod.DecodeGraph] = None
        # pinned host copies of a chunk's outputs, two of each kind (one a
        # chunk in flight): plain chunks' tokens, speculative chunks' (tokens, counts)
        self._host_out = None
        if self.device.type == "cuda":
            def pinned(*shape):
                return torch.empty(shape, dtype=torch.int32, pin_memory=True)

            self._host_out = {"plain": [(pinned(max_slots, chunk),) for _ in range(2)]}
            if speculative_k:
                self._host_out["spec"] = [
                    (pinned(max_slots, chunk, speculative_k + 1), pinned(max_slots, chunk))
                    for _ in range(2)]
        self._flip = {"plain": 0, "spec": 0}
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._dead: Optional[str] = None  # the fatal scheduler error, if any
        self._slots: List[Optional[_Request]] = [None] * max_slots
        # admissions whose first token is on the device but not read yet
        self._pending_first: List[tuple] = []
        # the chunk replayed but not yet read: (snapshot, outputs)
        self._inflight: Optional[tuple] = None
        self._lock = threading.Lock()
        # held around every device call of the scheduler thread (module docstring)
        self.device_lock = threading.RLock()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._last_apply: Optional[float] = None
        self.stats = {"max_concurrent": 0, "chunks": 0, "requests": 0,
                      "prefix_hits": 0, "prefix_tokens_saved": 0, "max_chunk_gap_s": 0.0}

    # ------------------------------------------------------------- submit
    def submit(self, input_ids: Sequence[int],
               pixel_values: Optional[np.ndarray] = None,
               gen: Optional[GenerationConfig] = None,
               adapter: int = -1) -> List[int]:
        """Enqueue one request; blocks until done; returns the generated ids.
        `adapter` (multi-LoRA params only) is the request's adapter index,
        -1 the base model: requests of different adapters share chunks."""
        gen = gen or GenerationConfig()
        req = self._make_request(input_ids, pixel_values, gen, adapter)
        self._check_started()
        # the dead check and the enqueue under the lock the fatal drain
        # holds: no request can slip into the queue after the drain
        with self._lock:
            if self._dead:
                raise RuntimeError(f"engine failed: {self._dead}")
            self._queue.put(req)
        req.event.wait()
        if req.error:
            raise RuntimeError(req.error)
        return req.tokens

    def submit_stream(self, input_ids: Sequence[int],
                      pixel_values: Optional[np.ndarray] = None,
                      gen: Optional[GenerationConfig] = None,
                      adapter: int = -1):
        """Enqueue one request; yields lists of fresh token ids a decode
        chunk as they come (for server-sent events). Raises on its error."""
        gen = gen or GenerationConfig()
        req = self._make_request(input_ids, pixel_values, gen, adapter)
        req.stream_q = queue.Queue()
        self._check_started()
        with self._lock:
            if self._dead:
                raise RuntimeError(f"engine failed: {self._dead}")
            self._queue.put(req)
        while True:
            item = req.stream_q.get()
            if item is None:
                break
            yield item
        if req.error:
            raise RuntimeError(req.error)

    def _fused_len(self, input_ids) -> int:
        return len(input_ids) + sum(
            1 for t in input_ids if t == fusion_mod.IMAGE_TOKEN_INDEX
        ) * (self.model.tokens_per_frame - 1)

    def _make_request(self, input_ids, pixel_values, gen, adapter: int = -1) -> _Request:
        fused_len = self._fused_len(input_ids)
        if fused_len + gen.max_new_tokens + self.speculative_k + 1 > self.max_len:
            raise ValueError(
                f"prompt ({fused_len} fused tokens) + max_new_tokens "
                f"({gen.max_new_tokens}) exceeds engine max_len {self.max_len}"
            )
        if adapter >= 0 and adapter >= self._n_adapters:
            raise ValueError(
                f"adapter {adapter} out of range: model carries {self._n_adapters} stacked "
                "LoRA adapters" + ("" if self._n_adapters else
                                   " (stack with train.lora.stack_lora_adapters)"))
        return _Request(
            input_ids=list(input_ids), pixel_values=pixel_values, gen=gen,
            stop_strings=gen.stop_strings or (), event=threading.Event(),
            remaining=gen.max_new_tokens, adapter=max(adapter, -1),
        )

    def _check_started(self):
        """A submit to an engine never started would block its caller
        forever (the queue has no consumer): fail loudly instead."""
        if self._thread is None and not self._dead:
            raise RuntimeError(
                "engine not running: call .start() before submitting "
                "(BatchEngine(...).start())"
            )

    # ------------------------------------------------------------- engine
    def start(self):
        self._thread = threading.Thread(target=self.run_forever, daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        """Stop the scheduler, join it and drop the engine's decode graphs."""
        self._stop = True
        self._queue.put(None)  # wake the loop
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=60.0)
        with self.device_lock:
            for graph in (self._graph, self._spec_graph):
                if graph is not None:
                    graph.release()
            self._graph = self._spec_graph = None

    def run_forever(self):
        while not self._stop:
            try:
                made_progress = self._step_once(
                    block=all(s is None for s in self._slots)
                )
            except Exception as e:  # noqa: BLE001 — fatal: fail everything
                # a device error must not hang callers: fail every request in
                # flight and queued, and refuse new ones. _dead is set and the
                # queue drained under the lock submit() enqueues under
                with self._lock:
                    self._dead = f"{type(e).__name__}: {e}"
                    for slot, req in enumerate(self._slots):
                        if req is not None:
                            self._slots[slot] = None
                            req.error = f"engine failed: {self._dead}"
                            req._push_stream(final=True)
                            req.event.set()
                    while True:
                        try:
                            req = self._queue.get_nowait()
                        except queue.Empty:
                            break
                        if req is not None:
                            req.error = f"engine failed: {self._dead}"
                            req._push_stream(final=True)
                            req.event.set()
                return
            if not made_progress and self._stop:
                return

    def _step_once(self, block: bool = False) -> bool:
        """One scheduling iteration. With no request in a slot (`block`) it
        delivers the chunk in flight, then waits for a request outside the
        device lock; the rest runs under it (`_schedule`)."""
        first = None
        if block:
            with self.device_lock:
                self._flush_inflight()
            self._last_apply = None
            try:
                first = self._queue.get(timeout=5.0)
            except queue.Empty:
                return False
            if first is None:
                return False
        with self.device_lock:
            return self._schedule(first)

    # Pipelined one chunk deep: chunk N + 1 is replayed BEFORE chunk N's tokens
    # are read. Chunk N + 1 depends only on the device state, never on the
    # host's reading of chunk N; the cost is up to one extra chunk of decode
    # after a host-decided stop (stop string, max_new_tokens): those rows stay
    # active on the device one chunk longer, their tokens are dropped against
    # the dispatch-time snapshot, and their writes past the cache go to the
    # trash slot. EOS rows go inactive in the step and lose nothing.
    def _schedule(self, first: Optional[_Request]) -> bool:
        admitted = self._admit(first)
        if self._pending_first:
            # read fresh admissions' first tokens BEFORE the next chunk when no
            # OTHER slot is mid-decode: the read then costs nothing, and a
            # one-token request frees its slot before a chunk decodes it. With
            # other streams running (or several admissions at once, a storm
            # that measures throughput, not TTFT) the read rides after the chunk
            pending_slots = {s for _, s, _ in self._pending_first}
            others_decoding = any(
                r is not None and r.pf is None and s not in pending_slots
                for s, r in enumerate(self._slots)
            )
            if not others_decoding and len(self._pending_first) == 1:
                self._resolve_pending_first()
        # the slots THIS chunk decodes: mid-prefill rows are None (inactive on
        # the device, they emit pads)
        snapshot = [
            r if (r is not None and r.pf is None) else None
            for r in self._slots
        ]
        decoding = any(r is not None for r in snapshot)
        if not decoding:
            # nothing to decode between pieces: run the chunked prefills to
            # the end (no running stream to protect)
            self._flush_inflight()
            self._last_apply = None
            self._advance_prefills(drain=True)
            self._resolve_pending_first()
            return admitted or any(r is not None for r in self._slots)
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"],
            sum(r is not None for r in snapshot),
        )
        chunk_out = self._dispatch_chunk()
        # overlap: admissions and one piece of each chunked prefill while the
        # chunk runs (their rows join the NEXT chunk; `snapshot` keeps this
        # chunk's tokens off them)
        self._admit()
        self._advance_prefills()
        # apply the PREVIOUS chunk's tokens, then park this one
        prev, self._inflight = self._inflight, (snapshot, chunk_out)
        if prev is not None:
            self._apply_chunk(*prev)
        self._resolve_pending_first()
        return True

    def _flush_inflight(self):
        """Apply the parked chunk's tokens (waits for its copy)."""
        if self._inflight is not None:
            prev, self._inflight = self._inflight, None
            self._apply_chunk(*prev)

    def _admit(self, first: Optional[_Request] = None) -> bool:
        admitted = False
        while any(s is None for s in self._slots):
            if first is not None:
                req, first = first, None
            else:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
            if req is None:
                break
            slot = self._slots.index(None)
            self._slots[slot] = req  # reserved before the prefill (it may finish it)
            req.slot = slot
            try:
                self._prefill(req, slot)
                self.stats["requests"] += 1
                admitted = True
            except Exception as e:  # noqa: BLE001 — surfaced to the caller
                self._slots[slot] = None
                req.error = f"{type(e).__name__}: {e}"
                req._push_stream(final=True)
                req.event.set()
        return admitted

    def _prefill(self, req: _Request, slot: int):
        """One admission's prefill, enqueued on the device; its first token
        is read later (_resolve_pending_first)."""
        model, cfg = self.model, self.cfg
        llm = model.params["llm"]
        n_frames = fusion_mod.count_frames([req.input_ids])
        if n_frames:
            if req.pixel_values is None or req.pixel_values.shape[0] != n_frames:
                raise ValueError(f"prompt needs {n_frames} frames")
            vision_tokens = model.encode(req.pixel_values)
        else:
            vision_tokens = torch.zeros((1, model.tokens_per_frame, cfg.llm.hidden_size),
                                        dtype=model.dtype, device=self.device)
        fused_len = self._fused_len(req.input_ids)
        pad_to = teochat_mod.round_to_bucket(min(fused_len, self.max_len),
                                             teochat_mod.SEQ_BUCKETS)
        pad_to = min(pad_to, self.max_len)
        plan = fusion_mod.build_fusion_plan(
            [req.input_ids], tokens_per_frame=model.tokens_per_frame,
            max_length=self.max_len, pad_to=pad_to,
        )
        # the draft history row: the prompt's text ids (the first token follows)
        row = np.full((self.max_len,), -1, np.int32)
        n = min(len(req.input_ids), self.max_len - 1)
        row[:n] = req.input_ids[:n]
        sampling = (req.gen.temperature, req.gen.do_sample)
        plen, prefix_row, matched = self._prefix_match(req, fused_len)
        if plen:
            req.prefix_hit = (matched, plen)
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += plen
            suffix = fused_len - plen
            if not (self.prefill_chunk is not None and suffix > self.prefill_chunk):
                w = teochat_mod.round_to_bucket(suffix, SUFFIX_BUCKETS)
                w = min(w, self.max_len - plen)
                tok = _prefill_slot_from_prefix(
                    llm, self.cache, self._state, cfg.llm, plan, vision_tokens, prefix_row,
                    slot, plen, fused_len, w, self._copy_len(plen), *sampling, row, n,
                    req.adapter)
                self._pending_first.append((req, slot, tok))
                self._maybe_store_prefix(req, slot)
                return
            _copy_cache_row(self.cache, prefix_row, slot, self._copy_len(plen))
            self._start_pieces(req, slot, plan, vision_tokens, plen, fused_len, row, n)
            return
        if self.prefill_chunk is not None and fused_len > self.prefill_chunk:
            self._start_pieces(req, slot, plan, vision_tokens, 0, fused_len, row, n)
            return
        tok = _prefill_slot(llm, self.cache, self._state, cfg.llm, plan, vision_tokens, slot,
                            *sampling, row, n, req.adapter)
        self._pending_first.append((req, slot, tok))
        self._maybe_store_prefix(req, slot)

    def _start_pieces(self, req, slot, plan, vision_tokens, offset, fused_len, row, n):
        """Chunked prefill of slots [offset, fused_len): fuse the embeddings
        once, then one prefill_chunk piece a scheduling iteration."""
        c = self.prefill_chunk
        nchunks = -(-(fused_len - offset) // c)
        end = offset + nchunks * c
        embeds = teochat_mod.fuse_embeds(self.model.params["llm"], plan, vision_tokens)
        if embeds.shape[1] < end:
            embeds = F.pad(embeds, (0, 0, 0, end - embeds.shape[1]))
        req.pf = {"embeds": embeds[:, offset:end], "next": 0, "nchunks": nchunks,
                  "fused_len": fused_len, "offset": offset, "hist_row": row, "hist_n": n}
        self._advance_one_prefill(req, slot)

    # ------------------------------------------------------- prefix cache
    @staticmethod
    def _text_run(input_ids) -> tuple:
        """The leading text run (the cacheable prefix): ids before the first
        <image> fill fused slots [0, len(run)) and depend only on the ids."""
        run = []
        for t in input_ids:
            if t == fusion_mod.IMAGE_TOKEN_INDEX:
                break
            run.append(int(t))
        return tuple(run)

    def _bump(self) -> int:
        self._prefix_clock += 1
        return self._prefix_clock

    def _copy_len(self, plen: int) -> int:
        return min(teochat_mod.round_to_bucket(plen, teochat_mod.SEQ_BUCKETS), self.max_len)

    def _prefix_match(self, req: _Request, fused_len: int):
        """The longest usable pooled prefix: (plen, pool row, entry), or
        (0, -1, None). Longest common prefix against each pooled run, capped
        at fused_len - 1 (a token is left to prefill for logits), and at least
        prefix_min_tokens to be worth the row copy; entries are keyed by
        (adapter, run)."""
        if not self.prefix_cache_slots:
            return 0, -1, None
        run = self._text_run(req.input_ids)
        best, best_eff = None, 0
        for e in self._prefix_entries:
            if e["adapter"] != req.adapter:
                continue
            lcp = 0
            for a, b in zip(e["key"], run):
                if a != b:
                    break
                lcp += 1
            eff = min(lcp, fused_len - 1)
            if eff > best_eff:
                best, best_eff = e, eff
        if best is None or best_eff < self.prefix_min_tokens:
            return 0, -1, None
        best["stamp"] = self._bump()
        return best_eff, best["row"], best

    def _maybe_store_prefix(self, req: _Request, slot: int):
        """Pool this request's prefilled text run (LRU eviction); the copy
        is enqueued after the prefill's writes. A hit whose run extends the
        matched entry replaces it in place; a run that diverged from it is
        pooled only when its own tail is at least prefix_min_tokens."""
        if not self.prefix_cache_slots:
            return
        run = self._text_run(req.input_ids)
        if len(run) < self.prefix_min_tokens:
            return
        for e in self._prefix_entries:
            if e["key"] == run and e["adapter"] == req.adapter:
                e["stamp"] = self._bump()
                return
        if req.prefix_hit is not None:
            entry, lcp = req.prefix_hit
            alive = any(e is entry for e in self._prefix_entries)
            if alive and entry["plen"] == lcp and len(run) > lcp:
                _copy_cache_row(self.cache, slot, entry["row"], self._copy_len(len(run)))
                entry.update(key=run, plen=len(run), stamp=self._bump())
                return
            if len(run) - lcp < self.prefix_min_tokens:
                return
        if len(self._prefix_entries) < self.prefix_cache_slots:
            prow = self.max_slots + len(self._prefix_entries)
        else:
            victim = min(self._prefix_entries, key=lambda e: e["stamp"])
            self._prefix_entries.remove(victim)
            prow = victim["row"]
        _copy_cache_row(self.cache, slot, prow, self._copy_len(len(run)))
        self._prefix_entries.append(
            {"key": run, "plen": len(run), "row": prow, "stamp": self._bump(),
             "adapter": req.adapter}
        )

    def _advance_one_prefill(self, req: _Request, slot: int):
        """Enqueue the next chunked-prefill piece of one request; the last
        piece runs the tail (first-token sample, slot activation). A piece
        never runs past the cache's last slot."""
        pf = req.pf
        c = self.prefill_chunk
        i = pf["next"]
        start = pf["offset"] + i * c
        emb = pf["embeds"][:, i * c:i * c + min(c, self.max_len - start)]
        llm, cfg = self.model.params["llm"], self.cfg.llm
        if i < pf["nchunks"] - 1:
            _prefill_chunk_write(llm, self.cache, cfg, emb, start, slot, req.adapter)
            pf["next"] = i + 1
        else:
            tok = _prefill_slot_tail(
                llm, self.cache, self._state, cfg, emb, start, pf["fused_len"],
                pf["fused_len"] - 1 - start, slot, req.gen.temperature, req.gen.do_sample,
                pf["hist_row"], pf["hist_n"], req.adapter)
            req.pf = None
            self._pending_first.append((req, slot, tok))
            self._maybe_store_prefix(req, slot)

    def _advance_prefills(self, drain: bool = False):
        """Advance every chunked prefill by one piece (or, with nothing
        decoding, to the end: no decode to interleave)."""
        progressed = True
        while progressed:
            progressed = False
            for slot, req in enumerate(self._slots):
                if req is not None and req.pf is not None:
                    self._advance_one_prefill(req, slot)
                    progressed = True
            if not drain:
                break

    def _resolve_pending_first(self):
        """Read the deferred first tokens (waits for their prefills)."""
        pending, self._pending_first = self._pending_first, []
        for req, slot, tok in pending:
            req.tokens.append(int(tok.cpu()[0]))
            req.remaining -= 1
            req._push_stream()
            self._finish_if_done(req, slot)

    def _decode_graph(self, spec: bool = False) -> Optional[gen_mod.DecodeGraph]:
        """The engine's own graph entry for its plain or its speculative step
        on the card (made at the first chunk of that kind), None on the CPU.
        Both capture over the same state and cache, and draw from the
        engine's generator."""
        if self.device.type != "cuda":
            return None
        name = "_spec_graph" if spec else "_graph"
        if getattr(self, name) is None:
            st = self._state
            anchor = gen_mod.embedding_table(self.model.params["llm"])
            setattr(self, name, gen_mod.own_decode_graph(gen_mod.DecodeGraph(
                st, _spec_step if spec else _decode_step, anchor, self._step_kw(spec),
                generator=st.generator)))
        return getattr(self, name)

    def _step_kw(self, spec: bool = False) -> dict:
        llm = self.cfg.llm
        kw = dict(eos_id=int(llm.eos_token_id), pad_id=int(llm.pad_token_id),
                  emb_dtype=self.model.dtype)
        return dict(kw, spec_k=self.speculative_k) if spec else kw

    def _update_spec_mode(self, tokens: int, iterations: int):
        """The adaptive controller: fold one speculative chunk's tokens an
        iteration into the EMA and turn drafting off or on."""
        if not (self.adaptive_spec and self.speculative_k > 0) or not iterations:
            return
        rate = tokens / iterations
        if not self._spec_on:
            # a probe chunk decides on its own rate (the stale EMA is why
            # drafting was turned off)
            if rate >= self.spec_disable_below:
                self._spec_on = True
                self._spec_ema = rate
                self.stats["spec_mode_switches"] = self.stats.get("spec_mode_switches", 0) + 1
            else:
                self._spec_probe_in = self.spec_probe_every
            return
        self._spec_ema = rate if self._spec_ema is None else 0.7 * self._spec_ema + 0.3 * rate
        if self._spec_ema < self.spec_disable_below:
            self._spec_on = False
            self._spec_probe_in = self.spec_probe_every
            self.stats["spec_mode_switches"] = self.stats.get("spec_mode_switches", 0) + 1

    def _use_spec(self) -> bool:
        """Whether the next chunk is speculative. A probe re-arms its
        countdown when it is dispatched: the depth-1 pipeline dispatches the
        next chunk before the probe's verdict is applied, and a re-arm at
        apply time alone would fire two probes a window."""
        use_spec = self.speculative_k > 0
        if use_spec and self.adaptive_spec and not self._spec_on:
            self._spec_probe_in -= 1
            use_spec = self._spec_probe_in <= 0
            if use_spec:
                self._spec_probe_in = self.spec_probe_every
                self.stats["spec_probes"] = self.stats.get("spec_probes", 0) + 1
        return use_spec

    def _dispatch_chunk(self):
        """Enqueue one decode chunk over the device state: speculative or
        plain (`_use_spec`). Returns (the outputs' host copies, the event
        that says they are done: None on the CPU, where they are copied at
        once); a speculative chunk's outputs are (tokens, counts), a plain
        one's (tokens,)."""
        llm, cfg = self.model.params["llm"], self.cfg.llm
        if self._use_spec():
            kind = "spec"
            outs = _decode_chunk_spec(llm, cfg, self._state, chunk=self.chunk,
                                      graph=self._decode_graph(spec=True), **self._step_kw(True))
        else:
            kind = "plain"
            outs = (_decode_chunk(llm, cfg, self._state, chunk=self.chunk,
                                  graph=self._decode_graph(), **self._step_kw()),)
        if self._host_out is None:
            return tuple(t.clone() for t in outs), None
        bufs = self._host_out[kind][self._flip[kind]]
        self._flip[kind] ^= 1
        for buf, t in zip(bufs, outs):
            buf.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return bufs, done

    def _apply_chunk(self, snapshot, chunk_out):
        """Read a chunk's tokens and hand them to the snapshot's requests."""
        bufs, done = chunk_out
        if done is not None:
            done.synchronize()
        if len(bufs) == 2:  # a speculative chunk: each row's emissions by their counts
            toks3, counts = bufs[0].numpy(), bufs[1].numpy()
            emitting = int((counts > 0).sum())
            self.stats["spec_iterations"] = self.stats.get("spec_iterations", 0) + emitting
            self.stats["spec_tokens"] = self.stats.get("spec_tokens", 0) + int(counts.sum())
            self._update_spec_mode(int(counts.sum()), emitting)
            toks = [[int(t) for c in range(self.chunk) for t in toks3[r, c, :counts[r, c]]]
                    for r in range(self.max_slots)]
        else:
            toks = bufs[0].numpy().tolist()
        now = time.perf_counter()
        if self._last_apply is not None:
            self.stats["max_chunk_gap_s"] = max(self.stats["max_chunk_gap_s"],
                                                now - self._last_apply)
        self._last_apply = now
        eos = self.cfg.llm.eos_token_id
        self.stats["chunks"] += 1
        for slot, req in enumerate(snapshot):
            if req is None or req.event.is_set() or req.pf is not None:
                # an empty slot, a request that finished at its first token
                # before this chunk was read, or one mid-way through a
                # chunked prefill (its row emitted pads)
                continue
            for t in toks[slot]:
                if req.remaining <= 0:
                    break
                req.tokens.append(int(t))
                req.remaining -= 1
                if int(t) == eos or self._hit_stop(req):
                    req.remaining = 0
                    break
            req._push_stream()
            self._finish_if_done(req, slot)

    def _hit_stop(self, req: _Request) -> bool:
        if not req.stop_strings or self.model.tokenizer is None:
            return False
        text = self.model.tokenizer.decode(req.tokens)
        return any(s in text for s in req.stop_strings)

    def _finish_if_done(self, req: _Request, slot: int):
        done = (
            req.remaining <= 0
            or (req.tokens and req.tokens[-1] == self.cfg.llm.eos_token_id)
            or self._hit_stop(req)
        )
        if done:
            self._slots[slot] = None
            # push the host's stop into the device state (an EOS row is
            # inactive there already; this is idempotent for it)
            _deactivate_slot(self._state, slot)
            req._push_stream(final=True)
            req.event.set()
