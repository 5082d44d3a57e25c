"""Generation: prefill, then a decode loop with EOS and keyword stops.

Port of teochat_tpu/models/generation.py (`StopSpec`, `make_stop_spec`,
`_keyword_hit`, `sample_token`, `_filtered_logits`, `generate_tokens`,
`_run_decode_loop`, the session API `prefill_full`, `prefill_suffix`,
`decode_with_cache`, and prompt-lookup speculation `_ngram_match_start`,
`_draft_lookup`, `_sample_excluding`, `generate_tokens_spec`,
`_run_spec_decode_loop`, `decode_with_cache_spec`) and its backend
dispatch (`backend_embed`, `backend_forward`: the LLaMA or the MPT decoder,
by the config). The semantics are the
JAX package's: tokens after a row stops are `pad_id`, `n_gen` counts up to
and including the stop token, and the loop ends when every row is done.

The JAX loop is one `lax.while_loop` on the device, with no host round trip
a token. Here the loop's state is a set of fixed-shape device tensors
(`DecodeState`, the KV cache among them), and one iteration
(`_decode_iteration`: embed the last token, the decoder and the lm_head at
the device step's position, sample, record the token, shift the keyword
window, update n_gen and done) reads nothing back to the host. The host
runs the iterations in chunks of DECODE_CHUNK and reads `done.all()` once a
chunk; an iteration that runs after every row is done records `pad_id` and
adds nothing to n_gen, so the tokens are the while_loop's. The first token
is sampled from the prefill's logits before the chunks, and the last one's
forward, whose logits nothing reads, is not run.

On the card the iteration is captured once in a CUDA graph (`DecodeGraph`,
kept per key as `jax.jit` keeps a program) and replayed; on the CPU it runs
eagerly, in the same chunks: that is the plain version the tests hold
against the JAX function.

The session API (serve/session.py) keeps one KV cache across a chat's
turns: `prefill_full` prefills a fresh conversation, `prefill_suffix` only
what follows the committed prefix (spec_verify writes and K2m over the
cache), `decode_with_cache` runs the same chunked loop over the caller's
cache. Its graph entry is keyed by that cache's address and holds it only
weakly: the entry goes when the session drops its cache, and dropping an
entry never frees a session's cache.

Speculation runs the same way. Its state (`SpecState`: the draft history,
the carried logits, the rejected draft, device counters of iterations and
accepted drafts, the bench's keep probability and oracle) is again a set of
fixed-shape device tensors, and one iteration (`_spec_iteration`: JAX's
`step_fn`) drafts k tokens by prompt lookup, verifies the block of k + 1 in
one spec_verify forward (K2m over the cache) and records what it accepts,
reading nothing back. The host reads `done.all()` once every SPEC_CHUNK
iterations; an iteration after every row is done changes no token, n_gen,
history or counter, so the chunks give the while_loop's counts. On the card
the iteration replays from a CUDA graph (`DecodeGraph` is generic over the
iteration it captures); on the CPU it runs eagerly.

`generate_tokens(_spec)` take `kv_dtype` as the JAX functions do (None: the
embeddings' dtype; "float8_e4m3fn" halves the cache's bytes), and
`decode_with_cache(_spec)` embed in bf16 over an e4m3 cache (JAX's
`emb_dtype` rule). A graph entry is keyed by its cache's dtype too.

Every function takes `adapter_route` [B, A] as the JAX ones do, for params
with adapter-stacked LoRA leaves (multi-LoRA, train/lora.py). The loops
keep it as a tensor of their state (`DecodeState.route`,
`SpecState.route`), written in place before the first iteration, so a
graph replays with the route of the call at hand; an entry is keyed by the
route's width A, and two calls with other adapter lists reuse one entry.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from teochat_torch.config import LlamaConfig
from teochat_torch.models import llama as llama_mod
from teochat_torch.models import mpt as mpt_mod
from teochat_torch.ops import _build
from teochat_torch.utils import tree_leaves_with_path

# Iterations between two host reads of `done`. One read drains the queue of
# replays (the card idles until the host enqueues the next chunk), and a
# batch whose rows are all done runs on to the chunk's end. For a request
# of n tokens the sum is least near k = sqrt(2 n drain / step): measured on
# the card, 2 for answers of ~32 tokens (PERF.md, Findings).
DECODE_CHUNK = 2
# Verify iterations between two host reads of `done` in the speculative loop.
# The same trade as DECODE_CHUNK, but an iteration past the stop costs a
# whole verify block: measured on an H100 at int8 bs 1, k 4, a request
# that ends after 7 iterations took 244 ms at 1, 271 at 2, 276 at 4, and
# one of 33 iterations 986 / 951 / 951 ms (`chip_probe.py spec --chunks`;
# PERF.md, Findings).
SPEC_CHUNK = 1
MAX_DECODE_GRAPHS = 4  # live DecodeGraph entries; the least recently used goes first


# ------------------------------------------------------ backend dispatch
#
# The decode machinery is the same for both decoders; only the embedding
# table and the stack differ. The decoder's params pick the backend
# (mpt.is_mpt_params), as the JAX package's config type picks it.

def backend_embed(params, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    embed = mpt_mod.mpt_embed if mpt_mod.is_mpt_params(params) else llama_mod.embed_tokens
    return embed(params, ids, dtype=dtype)


def backend_forward(params, cfg, emb: torch.Tensor, *, position_ids: torch.Tensor,
                    act_quant_ok: Optional[bool] = None, **kw) -> torch.Tensor:
    """The cached-path decoder: llama_forward, or mpt_forward, which takes
    the same cache contract (`kw`) and ignores position_ids (ALiBi) and
    `act_quant_ok` (w8a8 prefill is a LLaMA-path knob)."""
    if mpt_mod.is_mpt_params(params):
        return mpt_mod.mpt_forward(params, cfg, emb, **kw)
    return llama_mod.llama_forward(params, cfg, emb, position_ids=position_ids,
                                   act_quant_ok=act_quant_ok, **kw)


def embedding_table(llm_params) -> torch.Tensor:
    """The decoder's token-embedding table: LLaMA's `embed_tokens` or MPT's tied `wte`."""
    return llm_params["wte" if mpt_mod.is_mpt_params(llm_params) else "embed_tokens"]["embedding"]


@dataclasses.dataclass
class StopSpec:
    """Stopping data: [K, M] keyword ids right-aligned (0-padded), lengths."""

    keyword_ids: np.ndarray  # [K, M] int32
    keyword_lens: np.ndarray  # [K] int32
    eos_id: int


def make_stop_spec(stop_strings: Sequence[str], tokenizer, eos_id: int) -> StopSpec:
    """Tokenize stop strings (dropping a leading BOS) into an id matrix."""
    bos = getattr(tokenizer, "bos_token_id", None)
    seqs: List[List[int]] = []
    for s in stop_strings:
        ids = list(tokenizer(s).input_ids)
        if len(ids) > 1 and bos is not None and ids[0] == bos:
            ids = ids[1:]
        seqs.append(ids)
    m = max((len(s) for s in seqs), default=1)
    k = max(len(seqs), 1)
    mat = np.zeros((k, m), np.int32)
    lens = np.zeros((k,), np.int32)
    for i, s in enumerate(seqs):
        mat[i, m - len(s):] = s  # right-aligned for the suffix compare
        lens[i] = len(s)
    return StopSpec(keyword_ids=mat, keyword_lens=lens, eos_id=int(eos_id))


def _keyword_hit(window: torch.Tensor, keyword_ids: torch.Tensor,
                 keyword_lens: torch.Tensor) -> torch.Tensor:
    """window [B, M] last tokens (right-aligned) -> [B] bool."""
    m = window.shape[1]
    pos = torch.arange(m, device=window.device)
    valid = pos[None, :] >= (m - keyword_lens[:, None])  # [K, M]
    eq = window[:, None, :] == keyword_ids[None, :, :]  # [B, K, M]
    hit = torch.all(eq | ~valid[None], dim=-1)  # [B, K]
    # zero-length rows (padding / no keywords) never match
    hit = hit & (keyword_lens > 0)[None, :]
    return hit.any(dim=-1)


def _filtered_logits(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """Temperature-scaled logits with tokens outside the top-p nucleus masked."""
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep tokens until the cumulative probability exceeds top_p (always the top-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample_token(logits: torch.Tensor, generator: torch.Generator, *,
                 temperature: float, do_sample: bool, top_p: float = 1.0) -> torch.Tensor:
    """Greedy or temperature/top-p sampling. logits [B, V] fp32 -> [B] int64."""
    if not do_sample or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filtered_logits(logits, temperature, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate_tokens(
    params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D] fused prompt embeddings
    seq_lens: torch.Tensor,  # [B] true prompt lengths
    attention_mask: torch.Tensor,  # [B, S] prompt validity
    position_ids: torch.Tensor,  # [B, S]
    stop: StopSpec,
    generator: torch.Generator,
    *,
    max_new_tokens: int,
    cache_len: int,
    temperature: float = 0.0,
    do_sample: bool = False,
    top_p: float = 1.0,
    pad_id: int = 0,
    kv_dtype=None,
    adapter_route: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_new_tokens] with pad_id after a stop, n_gen [B]).

    Generated tokens include the stop keyword; callers strip it. The cache
    holds `cache_len` slots; the last one is the trash slot where padded
    prompt positions point (never attended). `kv_dtype` is the cache's dtype
    (None: the embeddings'; "float8_e4m3fn" or the torch dtype halves its
    bytes). On the card the decode steps replay a CUDA graph of one
    iteration (`DecodeGraph`); a request of one token feeds nothing back, so
    it takes no graph (and no entry's cache). `adapter_route` [B, A] routes
    multi-LoRA params per row. No autograd graph is recorded."""
    tokens, n_gen, _ = _generate_tokens(
        params, cfg, inputs_embeds, seq_lens, attention_mask, position_ids, stop, generator,
        max_new_tokens=max_new_tokens, cache_len=cache_len, temperature=temperature,
        do_sample=do_sample, top_p=top_p, pad_id=pad_id, kv_dtype=kv_dtype,
        adapter_route=adapter_route, graphed=inputs_embeds.is_cuda)
    return tokens, n_gen


@torch.no_grad()
def _generate_tokens(params, cfg, inputs_embeds, seq_lens, attention_mask, position_ids,
                     stop: StopSpec, generator, *, max_new_tokens, cache_len, temperature,
                     do_sample, top_p, pad_id, graphed: bool, kv_dtype=None,
                     adapter_route=None):
    """`generate_tokens`, with the decode steps replayed from a CUDA graph
    (`graphed`) or run eagerly (the CPU's path; on the card, the reference
    the graph is held to). Returns (tokens, n_gen, the loop's state)."""
    b, _, _ = inputs_embeds.shape
    dev, dtype = inputs_embeds.device, inputs_embeds.dtype
    kv_dtype = llama_mod.kv_dtype_of(kv_dtype, dtype)
    graphed = graphed and max_new_tokens > 1  # one token feeds nothing back
    step_kw = dict(temperature=temperature, do_sample=do_sample, top_p=top_p,
                   pad_id=pad_id, emb_dtype=dtype)
    n_adapters = _route_width(adapter_route)
    if graphed:
        entry = _decode_graph(params, cfg, b, cache_len, max_new_tokens,
                              tuple(np.shape(stop.keyword_ids)), dev, step_kw,
                              kv_dtype=kv_dtype, n_adapters=n_adapters)
        state = entry.state
        state.cache.k.zero_()  # as JAX's init_cache: a zeroed cache each request
        state.cache.v.zero_()
    else:
        entry = None
        state = DecodeState.new(
            llama_mod.init_cache(cfg, b, cache_len, dtype=kv_dtype, device=dev),
            cfg.vocab_size, max_new_tokens, tuple(np.shape(stop.keyword_ids)), n_adapters)
    trash = cache_len - 1
    slots = torch.where(attention_mask, position_ids, trash)
    logits = backend_forward(
        params, cfg, inputs_embeds, position_ids=position_ids, cache=state.cache,
        write_slots=slots, logits_mode="last", last_index=seq_lens - 1,
        adapter_route=adapter_route,
    )
    state.reset(seq_lens, stop, pad_id, adapter_route)
    tokens, n_gen = _run_decode_loop(params, cfg, state, logits[:, -1], generator, entry,
                                     max_new_tokens=max_new_tokens, **step_kw)
    if entry is not None:  # the entry's buffers serve its next request
        tokens, n_gen = tokens.clone(), n_gen.clone()
    return tokens, n_gen, state


@dataclasses.dataclass
class DecodeState:
    """The decode loop's state: fixed-shape device tensors, updated in place
    (a CUDA graph of the iteration reads and writes them where they lie)."""

    cache: llama_mod.KVCache  # [L, B, T, Hkv, D] K and V
    step: torch.Tensor  # [1] int64: the index of the token last recorded
    start_pos: torch.Tensor  # [B] int64: each row's cache slot for its first generated token
    tok: torch.Tensor  # [B] int32: the token last recorded (pad_id in a done row)
    tokens: torch.Tensor  # [B, max_new_tokens] int32
    window: torch.Tensor  # [B, M] int32: the last M tokens, right-aligned
    done: torch.Tensor  # [B] bool
    n_gen: torch.Tensor  # [B] int32
    logits: torch.Tensor  # [B, V] fp32: the logits the token last recorded was drawn from
    keyword_ids: torch.Tensor  # [K, M] int32
    keyword_lens: torch.Tensor  # [K] int32
    eos_id: torch.Tensor  # [] int32
    route: Optional[torch.Tensor] = None  # [B, A] fp32: the multi-LoRA route (None: no stack)

    @property
    def device(self) -> torch.device:
        return self.done.device

    @classmethod
    def new(cls, cache, vocab_size: int, max_new_tokens: int, keyword_shape,
            n_adapters: int = 0) -> "DecodeState":
        b, dev = cache.k.shape[1], cache.k.device

        def buf(shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return cls(cache=cache, step=buf(1, torch.int64), start_pos=buf(b, torch.int64),
                   tok=buf(b), tokens=buf((b, max_new_tokens)), window=buf((b, keyword_shape[1])),
                   done=buf(b, torch.bool), n_gen=buf(b),
                   logits=buf((b, vocab_size), torch.float32), keyword_ids=buf(keyword_shape),
                   keyword_lens=buf(keyword_shape[:1]), eos_id=buf(()),
                   route=buf((b, n_adapters), torch.float32) if n_adapters else None)

    def reset(self, start_pos: torch.Tensor, stop: StopSpec, pad_id: int,
              route: Optional[torch.Tensor] = None) -> None:
        """The state before the first token, for a prompt whose rows'
        generated tokens start at cache slot `start_pos` [B], routed by
        `route` [B, A] (written in place)."""
        _set_route(self, route)
        self.step.zero_()
        self.start_pos.copy_(start_pos)
        self.tokens.fill_(pad_id)
        self.window.fill_(-1)
        self.done.zero_()
        self.n_gen.zero_()
        self.keyword_ids.copy_(torch.as_tensor(np.asarray(stop.keyword_ids)))
        self.keyword_lens.copy_(torch.as_tensor(np.asarray(stop.keyword_lens)))
        self.eos_id.fill_(int(stop.eos_id))


def _route_width(route: Optional[torch.Tensor]) -> int:
    """The adapter count A of a route [B, A] (0: no route)."""
    return 0 if route is None else int(route.shape[-1])


def _set_route(st, route: Optional[torch.Tensor]) -> None:
    """Write a call's route into its state's buffer, in place: a replay
    reads the buffer where it lay at the capture."""
    if (st.route is None) != (route is None) or (
            route is not None and st.route.shape != route.shape):
        raise ValueError(f"adapter_route of shape {None if route is None else tuple(route.shape)} "
                         f"for a state made for {None if st.route is None else tuple(st.route.shape)}")
    if route is not None:
        st.route.copy_(route)


def _record(st: DecodeState, logits: torch.Tensor, generator, *, temperature, do_sample,
            top_p, pad_id, **_) -> None:
    """Sample the token of step `st.step` from `logits` [B, V] and record it."""
    tok = sample_token(logits, generator, temperature=temperature,
                       do_sample=do_sample, top_p=top_p).to(torch.int32)
    tok = torch.where(st.done, pad_id, tok)
    st.tok.copy_(tok)
    st.logits.copy_(logits)
    st.tokens.index_copy_(1, st.step, tok[:, None])
    st.window.copy_(torch.cat([st.window[:, 1:], tok[:, None]], dim=1))
    st.n_gen.add_((~st.done).to(torch.int32))
    st.done.logical_or_((tok == st.eos_id) | _keyword_hit(st.window, st.keyword_ids,
                                                          st.keyword_lens))


def _decode_iteration(params, cfg, st: DecodeState, generator, *, emb_dtype, **step_kw) -> None:
    """Feed the last token at its row's slot, then sample and record the next.

    JAX's `step_fn` with its forward moved to the front: the token of step
    s was fed at slot start_pos + s. Reads nothing back to the host."""
    pos = (st.start_pos + st.step)[:, None]  # [B, 1]
    emb = backend_embed(params, st.tok[:, None].long(), dtype=emb_dtype)
    logits = backend_forward(params, cfg, emb, position_ids=pos, cache=st.cache,
                             write_slots=pos, logits_mode="last", adapter_route=st.route)
    st.step.add_(1)
    _record(st, logits[:, -1], generator, **step_kw)


def _run_decode_loop(params, cfg, st: DecodeState, logits0, generator,
                     graph: Optional["DecodeGraph"], *, max_new_tokens, **step_kw):
    """Sample from logits0, then feed, sample, repeat: chunks of DECODE_CHUNK
    tokens, `done` read once a chunk. `graph` replays the iterations on the
    card; None runs them eagerly. Returns (tokens [B, max_new_tokens], n_gen [B])."""
    n_done = 0
    while n_done < max_new_tokens:
        n = min(DECODE_CHUNK, max_new_tokens - n_done)
        iterations = n
        if n_done == 0:
            _record(st, logits0, generator, **step_kw)
            iterations -= 1
        if graph is not None:
            graph.run(iterations, params, cfg, generator)
        else:
            for _ in range(iterations):
                _decode_iteration(params, cfg, st, generator, **step_kw)
        n_done += n
        if bool(st.done.all()):  # the loop's one host read, once a chunk
            break
    return st.tokens, st.n_gen


# ------------------------------------------------ incremental (session) API


@torch.no_grad()
def prefill_full(params, cfg: LlamaConfig, cache: llama_mod.KVCache, embeds: torch.Tensor,
                 seq_lens: torch.Tensor, attention_mask: torch.Tensor,
                 position_ids: torch.Tensor, adapter_route: Optional[torch.Tensor] = None):
    """Prefill a fresh conversation into a session cache, from slot 0.

    Returns (last-token logits [B, V] fp32, cache); the cache is written in
    place. Contiguous panel writes and the flash kernel, as generate_tokens'
    prefill; padded positions write to the trash slot T_max - 1."""
    trash = cache.max_len - 1
    slots = torch.where(attention_mask.bool(), position_ids, trash)
    logits = backend_forward(
        params, cfg, embeds, position_ids=position_ids, cache=cache, write_slots=slots,
        logits_mode="last", last_index=seq_lens - 1, adapter_route=adapter_route,
    )
    return logits[:, -1], cache


@torch.no_grad()
def prefill_suffix(params, cfg: LlamaConfig, cache: llama_mod.KVCache, embeds: torch.Tensor,
                   start: torch.Tensor, seq_lens: torch.Tensor, attention_mask: torch.Tensor,
                   position_ids: torch.Tensor, adapter_route: Optional[torch.Tensor] = None):
    """Prefill a conversation's suffix against the committed cache.

    embeds / position_ids / attention_mask / seq_lens describe the
    right-padded suffix alone (positions from 0 within it); `start` [B] is
    the cache slot where it begins. Runs the spec_verify mode: writes at
    each token's slot, then every suffix query attends the cache up to its
    own slot (K2m), so it sees the committed conversation. Unlike a verify
    block it keeps the w8a8 activations of `int8_prefill_activations`.
    Returns (last-token logits [B, V] fp32, cache)."""
    t_max = cache.max_len
    abs_pos = start[:, None] + position_ids
    slots = torch.where(attention_mask.bool(), abs_pos, t_max - 1)
    kv_mask = (torch.arange(t_max, device=embeds.device)[None, :]
               < (start + seq_lens)[:, None])
    logits = backend_forward(
        params, cfg, embeds, position_ids=abs_pos, cache=cache, write_slots=slots,
        kv_mask=kv_mask, logits_mode="last", last_index=seq_lens - 1, spec_verify=True,
        act_quant_ok=True,  # a prefill: w8a8 where the config asks, as a stateless one
        adapter_route=adapter_route,
    )
    return logits[:, -1], cache


@torch.no_grad()
def decode_with_cache(params, cfg: LlamaConfig, cache: llama_mod.KVCache,
                      logits0: torch.Tensor, start_pos: torch.Tensor, stop: StopSpec,
                      generator: torch.Generator, *, max_new_tokens: int,
                      temperature: float = 0.0, do_sample: bool = False, top_p: float = 1.0,
                      pad_id: int = 0, adapter_route: Optional[torch.Tensor] = None):
    """Decode on from prefilled logits over the caller's cache, in place.

    `start_pos` [B]: the slot of each row's first generated token. Returns
    (tokens [B, max_new_tokens], n_gen [B], cache): the cache keeps every
    generated token's K/V but the last one's, for the session's next turn.
    On the card the steps replay a CUDA graph captured over this cache
    (`DecodeGraph`, keyed by its address); the cache is never zeroed. The
    steps embed in the cache's dtype, in bf16 over an e4m3 cache."""
    b = logits0.shape[0]
    dev = logits0.device
    step_kw = dict(temperature=temperature, do_sample=do_sample, top_p=top_p, pad_id=pad_id,
                   emb_dtype=_emb_dtype_over(cache))
    keyword_shape = tuple(np.shape(stop.keyword_ids))
    entry = None
    n_adapters = _route_width(adapter_route)
    if logits0.is_cuda and max_new_tokens > 1:  # one token feeds nothing back
        entry = _decode_graph(params, cfg, b, cache.max_len, max_new_tokens, keyword_shape,
                              dev, step_kw, cache=cache, n_adapters=n_adapters)
        state = entry.state
    else:
        state = DecodeState.new(cache, cfg.vocab_size, max_new_tokens, keyword_shape, n_adapters)
    state.reset(start_pos, stop, pad_id, adapter_route)
    try:
        tokens, n_gen = _run_decode_loop(params, cfg, state, logits0, generator, entry,
                                         max_new_tokens=max_new_tokens, **step_kw)
        if entry is not None:  # the entry's buffers serve its next call
            tokens, n_gen = tokens.clone(), n_gen.clone()
    finally:
        if entry is not None:
            state.cache = None  # the entry holds the caller's cache only weakly
    return tokens, n_gen, cache


def _emb_dtype_over(cache: llama_mod.KVCache) -> torch.dtype:
    """The steps' embedding dtype over a caller's cache: its own, bf16 over an
    e4m3 one (JAX's `emb_dtype` in decode_with_cache(_spec))."""
    return torch.bfloat16 if cache.dtype == torch.float8_e4m3fn else cache.dtype


# ----------------------------------------------- prompt-lookup speculation
#
# Greedy runs give the plain loop's tokens (drafts are accepted only where
# they equal the model's own argmax), up to argmax ties between the
# (k + 1)-token verify block and the 1-token step, which reduce in another
# order. Sampled runs are exact speculative sampling against the point-mass
# draft: the same distribution as plain sampling, other draws.


def _ngram_match_start(hist: torch.Tensor, hist_len: torch.Tensor, n: int) -> torch.Tensor:
    """The most recent earlier occurrence of each row's last n tokens.

    hist [B, H] int32, hist_len [B]. Returns [B] int32: the index where the
    continuation starts (match start + n), or -1 where the row has none."""
    b, h = hist.shape
    dev = hist.device
    if h <= n:  # no room for a query and an earlier occurrence
        return torch.full((b,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    idx = torch.arange(h - n + 1, device=dev)
    m = torch.ones((b, h - n + 1), dtype=torch.bool, device=dev)
    for j in range(n):
        qj = hist[rows, (hist_len.long() - n + j).clamp(0, h - 1)]
        m &= hist[:, j:h - n + 1 + j] == qj[:, None]
    # not the query window itself, nor anything overlapping its end
    m &= idx[None, :] <= (hist_len - n - 1)[:, None]
    m &= (hist_len >= n + 1)[:, None]
    best = torch.where(m, idx, -1).amax(dim=1)
    return torch.where(best >= 0, best + n, -1).to(torch.int32)


def _draft_lookup(hist: torch.Tensor, hist_len: torch.Tensor, k: int) -> torch.Tensor:
    """Prompt-lookup drafts: the k tokens after the most recent earlier
    occurrence of the last 3 tokens, else of the last 2. hist [B, H] holds
    the prompt's text ids then the generated ids; pads and image sentinels
    are negative and never match. A row with no match, or a draft past the
    history's end, drafts 0 (a valid embedding index that verification
    rejects or accepts on its merits). Returns [B, k] int32."""
    h = hist.shape[1]
    start3 = _ngram_match_start(hist, hist_len, 3)
    start2 = _ngram_match_start(hist, hist_len, 2)
    start = torch.where(start3 >= 0, start3, start2)
    gidx = (start[:, None] + torch.arange(k, device=hist.device)[None, :]).clamp(0, h - 1)
    d = torch.gather(hist, 1, gidx.long())
    usable = (start >= 0)[:, None] & (gidx <= (hist_len - 1)[:, None]) & (d >= 0)
    return torch.where(usable, d, 0).to(torch.int32)


def _sample_excluding(logits: torch.Tensor, generator: torch.Generator, temperature: float,
                      top_p: float, excluded: torch.Tensor) -> torch.Tensor:
    """Sample from the temperature / top-p filtered distribution with the
    mass of `excluded` [B] (-1: none) removed and the rest renormalized: the
    residual of speculative rejection sampling against a point-mass draft.
    logits [B, V] fp32 -> [B] int32."""
    lf = _filtered_logits(logits, temperature, top_p)
    vocab = torch.arange(lf.shape[-1], device=lf.device)
    excl = (vocab[None, :] == excluded[:, None]) & (excluded >= 0)[:, None]
    probs = torch.softmax(torch.where(excl, float("-inf"), lf), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@dataclasses.dataclass
class SpecState:
    """The speculative loop's state: fixed-shape device tensors, updated in
    place. `logits` are those after the last recorded token (the prefill's
    before the first iteration), `rejected` the draft the last iteration's
    chain stopped on by a sampled rejection (-1: none), `steps` the
    iterations that found a row not done, `accepted` the drafts recorded."""

    cache: llama_mod.KVCache
    start_pos: torch.Tensor  # [B] int64: each row's cache slot for its first generated token
    tokens: torch.Tensor  # [B, max_new_tokens] int32
    n_gen: torch.Tensor  # [B] int32
    hist: torch.Tensor  # [B, S_text + max_new_tokens] int32: the draft history
    hist_len: torch.Tensor  # [B] int32
    window: torch.Tensor  # [B, M] int32: the last M tokens, right-aligned
    done: torch.Tensor  # [B] bool
    logits: torch.Tensor  # [B, V] fp32
    rejected: torch.Tensor  # [B] int32
    steps: torch.Tensor  # [] int32
    accepted: torch.Tensor  # [] int32
    keyword_ids: torch.Tensor  # [K, M] int32
    keyword_lens: torch.Tensor  # [K] int32
    eos_id: torch.Tensor  # [] int32
    keep_prob: Optional[torch.Tensor] = None  # [] fp32: the bench's draft corruption
    oracle_ids: Optional[torch.Tensor] = None  # [B, max_new_tokens] int32: the bench's targets
    route: Optional[torch.Tensor] = None  # [B, A] fp32: the multi-LoRA route (None: no stack)

    @property
    def device(self) -> torch.device:
        return self.done.device

    @classmethod
    def new(cls, cache, vocab_size: int, max_new_tokens: int, keyword_shape, hist_width: int,
            *, draft_keep: bool = False, oracle: bool = False,
            n_adapters: int = 0) -> "SpecState":
        b, dev = cache.k.shape[1], cache.k.device

        def buf(shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return cls(cache=cache, start_pos=buf(b, torch.int64), tokens=buf((b, max_new_tokens)),
                   n_gen=buf(b), hist=buf((b, hist_width)), hist_len=buf(b),
                   window=buf((b, keyword_shape[1])), done=buf(b, torch.bool),
                   logits=buf((b, vocab_size), torch.float32), rejected=buf(b), steps=buf(()),
                   accepted=buf(()), keyword_ids=buf(keyword_shape),
                   keyword_lens=buf(keyword_shape[:1]), eos_id=buf(()),
                   keep_prob=buf((), torch.float32) if draft_keep else None,
                   oracle_ids=buf((b, max_new_tokens)) if oracle else None,
                   route=buf((b, n_adapters), torch.float32) if n_adapters else None)

    def reset(self, start_pos, logits0, prompt_ids, prompt_id_lens, stop: StopSpec, pad_id: int,
              keep_prob=None, oracle_ids=None, route=None) -> None:
        """The state before the first iteration: generated tokens from slot
        `start_pos` [B], `logits0` [B, V] the prompt's last logits, the
        history seeded with `prompt_ids` [B, S_text] (negative past each
        row's `prompt_id_lens`), routed by `route` [B, A]."""
        _set_route(self, route)
        prompt_ids = torch.as_tensor(prompt_ids)
        self.start_pos.copy_(torch.as_tensor(start_pos))
        self.tokens.fill_(pad_id)
        self.n_gen.zero_()
        self.hist.fill_(-1)
        self.hist[:, :prompt_ids.shape[1]].copy_(prompt_ids)
        self.hist_len.copy_(torch.as_tensor(prompt_id_lens))
        self.window.fill_(-1)
        self.done.zero_()
        self.logits.copy_(logits0)
        self.rejected.fill_(-1)
        self.steps.zero_()
        self.accepted.zero_()
        self.keyword_ids.copy_(torch.as_tensor(np.asarray(stop.keyword_ids)))
        self.keyword_lens.copy_(torch.as_tensor(np.asarray(stop.keyword_lens)))
        self.eos_id.fill_(int(stop.eos_id))
        for name, value in (("keep_prob", keep_prob), ("oracle_ids", oracle_ids)):
            held = getattr(self, name)
            if (held is None) != (value is None):
                raise ValueError(f"SpecState.reset: {name} given to a state made "
                                 f"{'without' if held is None else 'with'} it")
            if held is not None:
                held.copy_(torch.as_tensor(value))


def _spec_record(st: SpecState, tok: torch.Tensor, valid: torch.Tensor) -> None:
    """Append `tok` [B] to the rows where `valid` [B] (JAX's `record`)."""
    n_max, h_max = st.tokens.shape[1], st.hist.shape[1]
    rows = torch.arange(tok.shape[0], device=tok.device)
    t_idx = st.n_gen.clamp(max=n_max - 1).long()
    st.tokens[rows, t_idx] = torch.where(valid, tok, st.tokens[rows, t_idx])
    h_idx = st.hist_len.clamp(max=h_max - 1).long()
    st.hist[rows, h_idx] = torch.where(valid, tok, st.hist[rows, h_idx])
    shifted = torch.cat([st.window[:, 1:], tok[:, None]], dim=1)
    st.window.copy_(torch.where(valid[:, None], shifted, st.window))
    hit = (tok == st.eos_id) | _keyword_hit(st.window, st.keyword_ids, st.keyword_lens)
    st.done.logical_or_(valid & hit)
    st.n_gen.add_(valid.to(torch.int32))
    st.hist_len.add_(valid.to(torch.int32))
    st.done.logical_or_(st.n_gen >= n_max)


def _spec_iteration(params, cfg, st: SpecState, generator, *, spec_k: int, temperature,
                    do_sample, top_p, pad_id, emb_dtype, draft_keep: bool = False,
                    oracle: bool = False) -> None:
    """One verify iteration (JAX's `step_fn`), in place; reads nothing back.

    tok0 comes from the carried logits (argmax; or sampled from the residual
    past `rejected`), then k drafts by prompt lookup; the block [tok0,
    drafts] is written at slots pos0 + j (clipped below the trash slot) and
    verified in one spec_verify forward. Its queries attend `slot <= q_slot`:
    JAX's mask also has `slot <= pos0 + k`, which every q_slot already meets,
    so the forward takes no kv_mask and K2m's lengths are q_slot + 1 with no
    host read. Draft j is accepted where every draft before it was and it
    equals the target's argmax (greedy) or u < P(d_j) (sampled); the next
    logits are the block's after the last recorded token."""
    k = spec_k
    b, n_max = st.tokens.shape
    t_max = st.cache.max_len
    dev = st.done.device
    rows = torch.arange(b, device=dev)
    sampling = do_sample and temperature > 0.0
    st.steps.add_((~st.done).any().to(torch.int32))
    if sampling:
        tok0 = _sample_excluding(st.logits, generator, temperature, top_p, st.rejected)
    else:
        tok0 = torch.argmax(st.logits, dim=-1).to(torch.int32)
        if oracle:  # the bench's target sequence where it has a token
            o0 = st.oracle_ids[rows, st.n_gen.clamp(max=n_max - 1).long()]
            tok0 = torch.where(o0 >= 0, o0, tok0)
    tok0 = torch.where(st.done, pad_id, tok0)
    pos0 = st.start_pos + st.n_gen  # the cache slot of tok0
    _spec_record(st, tok0, ~st.done)
    drafts = _draft_lookup(st.hist, st.hist_len, k)
    if draft_keep:  # the bench's acceptance knob: a draft + 1 never equals its target
        u = torch.rand(drafts.shape, generator=generator, device=dev)
        drafts = torch.where(u < st.keep_prob, drafts, (drafts + 1) % cfg.vocab_size)

    blk = torch.cat([tok0[:, None], drafts], dim=1)  # [B, k + 1]
    blk_pos = (pos0[:, None] + torch.arange(k + 1, device=dev)[None, :]).clamp(max=t_max - 2)
    emb = backend_embed(params, blk.long(), dtype=emb_dtype)
    blk_logits = backend_forward(params, cfg, emb, position_ids=blk_pos, cache=st.cache,
                                 write_slots=blk_pos, logits_mode="all",
                                 spec_verify=True, adapter_route=st.route)  # [B, k + 1, V]
    if sampling:
        p = torch.softmax(_filtered_logits(blk_logits[:, :k], temperature, top_p), dim=-1)
        pd = torch.gather(p, -1, drafts.long()[..., None])[..., 0]
        match = torch.rand((b, k), generator=generator, device=dev) < pd
    else:
        targets = torch.argmax(blk_logits[:, :k], dim=-1).to(torch.int32)
        if oracle:  # draft j's target is the oracle's token n_gen + j (tok0 counted)
            oidx = (st.n_gen[:, None] + torch.arange(k, device=dev)[None, :]).clamp(0, n_max - 1)
            otgt = torch.gather(st.oracle_ids, 1, oidx.long())
            targets = torch.where(otgt >= 0, otgt, targets)
        match = drafts == targets
    acc = torch.cumprod(match.to(torch.int32), dim=1).bool()
    rec = torch.zeros(b, dtype=torch.int32, device=dev)  # drafts recorded
    for j in range(k):
        valid = acc[:, j] & ~st.done
        _spec_record(st, drafts[:, j], valid)
        rec = rec + valid.to(torch.int32)
    st.accepted.add_(rec.sum().to(torch.int32))
    st.logits.copy_(blk_logits[rows, rec.long()])
    if sampling:  # a chain stopped by a sampled rejection excludes that draft next
        at = rec.clamp(max=k - 1).long()
        was_rejected = (rec < k) & ~match[rows, at]
        st.rejected.copy_(torch.where(was_rejected, drafts[rows, at], -1))


def _run_spec_decode_loop(params, cfg, st: SpecState, generator,
                          graph: Optional["DecodeGraph"], *, max_new_tokens, **step_kw):
    """Verify iterations in chunks of SPEC_CHUNK, `done` read once a chunk.
    Every iteration records a token in each row not done, so max_new_tokens
    iterations end every row. `graph` replays them on the card; None runs
    them eagerly. Returns (tokens, n_gen, steps, accepted)."""
    n_run = 0
    while n_run < max_new_tokens:
        n = min(SPEC_CHUNK, max_new_tokens - n_run)
        if graph is not None:
            graph.run(n, params, cfg, generator)
        else:
            for _ in range(n):
                _spec_iteration(params, cfg, st, generator, **step_kw)
        n_run += n
        if bool(st.done.all()):  # the loop's one host read, once a chunk
            break
    return st.tokens, st.n_gen, st.steps, st.accepted


def _spec_kw(spec_k: int, temperature, do_sample, top_p, pad_id, emb_dtype,
             draft_keep_prob=None, oracle_ids=None) -> dict:
    if spec_k < 1:
        raise ValueError(f"speculation needs spec_k >= 1, got {spec_k}")
    return dict(spec_k=int(spec_k), temperature=temperature, do_sample=do_sample, top_p=top_p,
                pad_id=pad_id, emb_dtype=emb_dtype, draft_keep=draft_keep_prob is not None,
                oracle=oracle_ids is not None)


def generate_tokens_spec(
    params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D] fused prompt embeddings
    seq_lens: torch.Tensor,  # [B] true prompt lengths
    attention_mask: torch.Tensor,  # [B, S] prompt validity
    position_ids: torch.Tensor,  # [B, S]
    prompt_ids,  # [B, S_text] text token ids (pads and sentinels negative)
    prompt_id_lens,  # [B] valid text ids a row
    stop: StopSpec,
    generator: torch.Generator,
    *,
    max_new_tokens: int,
    cache_len: int,
    spec_k: int = 4,
    temperature: float = 0.0,
    do_sample: bool = False,
    top_p: float = 1.0,
    pad_id: int = 0,
    draft_keep_prob=None,
    oracle_ids=None,
    kv_dtype=None,
    adapter_route: Optional[torch.Tensor] = None,
):
    """Decode with prompt-lookup speculation (greedy or sampled).

    Returns (tokens [B, max_new_tokens], n_gen [B], steps, accepted): `steps`
    the verify iterations run, `accepted` the drafts recorded (0-d int32).
    The cache needs spec_k slots past prompt + max_new_tokens, and the trash
    slot. Bench knobs, as the JAX function's: `draft_keep_prob` (a float or
    a 0-d tensor) corrupts each draft with probability 1 - p, drawing from
    `generator` also on a greedy run; `oracle_ids` [B, max_new_tokens] makes
    the greedy target the oracle's token where it is >= 0. `kv_dtype` and
    `adapter_route` as generate_tokens'. On the card the iterations replay
    a CUDA graph (`DecodeGraph`, one a key)."""
    return _generate_tokens_spec(
        params, cfg, inputs_embeds, seq_lens, attention_mask, position_ids, prompt_ids,
        prompt_id_lens, stop, generator, max_new_tokens=max_new_tokens, cache_len=cache_len,
        spec_k=spec_k, temperature=temperature, do_sample=do_sample, top_p=top_p, pad_id=pad_id,
        draft_keep_prob=draft_keep_prob, oracle_ids=oracle_ids, kv_dtype=kv_dtype,
        adapter_route=adapter_route, graphed=inputs_embeds.is_cuda)[:4]


@torch.no_grad()
def _generate_tokens_spec(params, cfg, inputs_embeds, seq_lens, attention_mask, position_ids,
                          prompt_ids, prompt_id_lens, stop: StopSpec, generator, *,
                          max_new_tokens, cache_len, graphed: bool, spec_k=4, temperature=0.0,
                          do_sample=False, top_p=1.0, pad_id=0, draft_keep_prob=None,
                          oracle_ids=None, kv_dtype=None, adapter_route=None):
    """`generate_tokens_spec`, the iterations replayed from a CUDA graph
    (`graphed`) or run eagerly (the CPU's path; on the card, the reference
    the graph is held to). Returns (tokens, n_gen, steps, accepted, state)."""
    b = inputs_embeds.shape[0]
    dev, dtype = inputs_embeds.device, inputs_embeds.dtype
    kv_dtype = llama_mod.kv_dtype_of(kv_dtype, dtype)
    step_kw = _spec_kw(spec_k, temperature, do_sample, top_p, pad_id, dtype, draft_keep_prob,
                       oracle_ids)
    hist_width = np.shape(prompt_ids)[1] + max_new_tokens
    keyword_shape = tuple(np.shape(stop.keyword_ids))
    n_adapters = _route_width(adapter_route)
    if graphed and max_new_tokens > 1:  # one token: one iteration, nothing to replay
        entry = _decode_graph(params, cfg, b, cache_len, max_new_tokens, keyword_shape, dev,
                              step_kw, hist_width=hist_width, kv_dtype=kv_dtype,
                              n_adapters=n_adapters)
        state = entry.state
        state.cache.k.zero_()
        state.cache.v.zero_()
    else:
        entry = None
        state = SpecState.new(
            llama_mod.init_cache(cfg, b, cache_len, dtype=kv_dtype, device=dev),
            cfg.vocab_size, max_new_tokens, keyword_shape, hist_width,
            draft_keep=step_kw["draft_keep"], oracle=step_kw["oracle"], n_adapters=n_adapters)
    slots = torch.where(attention_mask, position_ids, cache_len - 1)
    logits = backend_forward(
        params, cfg, inputs_embeds, position_ids=position_ids, cache=state.cache,
        write_slots=slots, logits_mode="last", last_index=seq_lens - 1,
        adapter_route=adapter_route,
    )
    state.reset(seq_lens, logits[:, -1], prompt_ids, prompt_id_lens, stop, pad_id,
                draft_keep_prob, oracle_ids, adapter_route)
    out = _run_spec_decode_loop(params, cfg, state, generator, entry,
                                max_new_tokens=max_new_tokens, **step_kw)
    if entry is not None:  # the entry's buffers serve its next request
        out = tuple(t.clone() for t in out)
    return (*out, state)


@torch.no_grad()
def decode_with_cache_spec(params, cfg: LlamaConfig, cache: llama_mod.KVCache,
                           logits0: torch.Tensor, start_pos: torch.Tensor, prompt_ids,
                           prompt_id_lens, stop: StopSpec, generator: torch.Generator, *,
                           max_new_tokens: int, spec_k: int = 4, temperature: float = 0.0,
                           do_sample: bool = False, top_p: float = 1.0, pad_id: int = 0,
                           adapter_route: Optional[torch.Tensor] = None):
    """Speculative decode over the caller's cache, in place: the contract of
    decode_with_cache, the history seeded with `prompt_ids` (a session's
    whole conversation). The cache needs spec_k slots past start_pos +
    max_new_tokens, and the trash slot. Returns (tokens, n_gen, steps,
    accepted, cache). On the card the iterations replay a CUDA graph keyed
    by the cache's address, which the entry holds weakly, as
    decode_with_cache's; the blocks embed as decode_with_cache's steps."""
    b = logits0.shape[0]
    step_kw = _spec_kw(spec_k, temperature, do_sample, top_p, pad_id, _emb_dtype_over(cache))
    hist_width = np.shape(prompt_ids)[1] + max_new_tokens
    keyword_shape = tuple(np.shape(stop.keyword_ids))
    entry = None
    n_adapters = _route_width(adapter_route)
    if logits0.is_cuda and max_new_tokens > 1:
        entry = _decode_graph(params, cfg, b, cache.max_len, max_new_tokens, keyword_shape,
                              logits0.device, step_kw, cache=cache, hist_width=hist_width,
                              n_adapters=n_adapters)
        state = entry.state
    else:
        state = SpecState.new(cache, cfg.vocab_size, max_new_tokens, keyword_shape, hist_width,
                              n_adapters=n_adapters)
    state.reset(start_pos, logits0, prompt_ids, prompt_id_lens, stop, pad_id,
                route=adapter_route)
    try:
        out = _run_spec_decode_loop(params, cfg, state, generator, entry,
                                    max_new_tokens=max_new_tokens, **step_kw)
        if entry is not None:  # the entry's buffers serve its next call
            out = tuple(t.clone() for t in out)
    finally:
        if entry is not None:
            state.cache = None  # the entry holds the caller's cache only weakly
    return (*out, cache)


# ------------------------------------------------------------ the CUDA graph

_graphs: "collections.OrderedDict[tuple, DecodeGraph]" = collections.OrderedDict()
_owned_graphs: "weakref.WeakSet[DecodeGraph]" = weakref.WeakSet()  # entries kept by their owner
_capture_streams = {}  # device -> the side stream every capture on it runs on


class DecodeGraph:
    """One loop iteration captured in a CUDA graph, with all it touches: a
    decode step (`_decode_iteration` over a `DecodeState`), a speculative
    verify iteration (`_spec_iteration` over a `SpecState`) or the serving
    engine's step (serve/engine.py::_decode_step over its `EngineState`).

    It owns the loop's state and, for generate_tokens(_spec), its KV cache
    (the static buffers the graph reads and writes), the keyword tensors, a
    generator of its own for runs that draw (sampled, or drafts corrupted),
    the captured graph and its memory pool. The graph bakes in the
    addresses of the params, of those buffers and of the workspaces the
    kernels' wrappers took during the capture (their `torch.empty` comes
    from the graph's pool; K3's host-encoded TMA map of x holds x's
    captured address), so a replay is valid only with the params it was
    captured with: the key holds every leaf's address, and a weak reference
    to one leaf drops the entry when the params are freed. An entry over a
    caller's cache (decode_with_cache(_spec)) is keyed by the cache's
    address too and holds it by a weak reference alike: the state's cache
    is set for a call and cleared after it.

    An owner that keeps its entry out of the table (the serving engine)
    passes the generator its iteration draws from as `generator`: the graph
    reads that one, and `release` drops the captured graph, which
    `clear_decode_graphs` does to every such entry."""

    def __init__(self, state, iteration, anchor: torch.Tensor, step_kw: dict,
                 cache_anchor: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        self.state = state
        self.iteration = iteration
        self.step_kw = step_kw
        draws = ((step_kw.get("do_sample") and step_kw.get("temperature", 0.0) > 0.0)
                 or step_kw.get("draft_keep"))
        if generator is None and draws:
            generator = torch.Generator(device=state.device)
        self.generator = generator
        self.graph = None  # captured when a first iteration is asked for
        self.launches = {}  # LaunchCounter -> the launches one replay makes
        self.capture_seconds = None
        self.replays = 0
        self._lock = threading.Lock()
        self._anchor = weakref.ref(anchor, _drop_dead_graphs)
        self._cache_anchor = (None if cache_anchor is None
                              else weakref.ref(cache_anchor, _drop_dead_graphs))

    def alive(self) -> bool:
        """Whether the params (and the caller's cache) it was made for live."""
        return self._anchor() is not None and (
            self._cache_anchor is None or self._cache_anchor() is not None)

    def run(self, n: int, params, cfg, generator) -> None:
        """Run `n` iterations from the state as it stands. The first on a
        new entry runs eagerly, as the real iteration and the warm-up (the
        kernels' builds and set-up, cuBLAS's handles); then the capture; the
        rest replay. A sampled run draws from the caller's generator: its
        state goes into the entry's generator, which the graph reads, and
        comes back advanced (a run that corrupts drafts likewise)."""
        if n <= 0:
            return
        gen = generator
        handed = self.generator is not None and generator is not self.generator
        if handed:
            self.generator.set_state(generator.get_state())
            gen = self.generator
        with self._lock:
            if self.graph is None:
                self._warm_up_and_capture(params, cfg, gen)
                n -= 1
            for _ in range(n):
                self.graph.replay()
            _build.add_counts(self.launches, n)
            self.replays += n
        if handed:
            generator.set_state(self.generator.get_state())

    def release(self) -> None:
        """Drop the captured graph and its memory pool (after the work
        queued on the card has run); the next `run` captures anew."""
        with self._lock:
            if self.graph is not None and self.state.device.type == "cuda":
                torch.cuda.synchronize(self.state.device)
            self.graph, self.launches = None, {}

    def _warm_up_and_capture(self, params, cfg, generator) -> None:
        dev = self.state.device
        if dev not in _capture_streams:
            _capture_streams[dev] = torch.cuda.Stream(dev)
        stream = _capture_streams[dev]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.iteration(params, cfg, self.state, generator, **self.step_kw)
        torch.cuda.current_stream(dev).wait_stream(stream)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # cuBLAS keeps a workspace a stream for the life of the process. Cleared
        # before and after the capture (as torch's own graph trees do), the
        # graph's comes from its pool and goes with it, and the warm-up's on
        # the side stream is given back. The capture is begun and ended here,
        # not through `torch.cuda.graph`, whose entry empties the caching
        # allocator: the eager prefills after it would make their segments
        # anew (PERF.md, Findings). A capture that fails raises: there
        # is no eager fallback.
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with _build.capture_counts() as seen, torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    self.iteration(params, cfg, self.state, generator, **self.step_kw)
                finally:
                    graph.capture_end()
        finally:
            torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.graph, self.launches = graph, seen


def _decode_graph(params, cfg, batch: int, cache_len: int, max_new_tokens: int,
                  keyword_shape, device, step_kw: dict,
                  cache: Optional[llama_mod.KVCache] = None,
                  hist_width: Optional[int] = None,
                  kv_dtype: Optional[torch.dtype] = None, n_adapters: int = 0) -> DecodeGraph:
    """The entry for this call's key, made if there is none: with a zeroed
    cache of its own in `kv_dtype` (None: the embeddings' dtype), or over the
    caller's `cache` (set as its state's cache for this call); a decode
    step's, or with `hist_width` (the draft history's width) a speculative
    iteration's. The key is what `jax.jit` keys `generate_tokens(_spec)` on
    (the params tree's structure, shapes and dtypes, the config, the batch,
    cache_len, max_new_tokens, the keyword shape, the dtype, the cache's
    dtype, temperature, do_sample, top_p, pad_id; spec_k, the history's
    width and whether the keep probability and the oracle are in use, all
    in `step_kw` but the width and the cache's dtype), with each leaf's
    address and strides: the graph reads the params where they lay at its
    capture; and the caller's cache's addresses and strides, where it lies.
    An e4m3 call never replays a bf16 entry's graph, nor the reverse. The
    multi-LoRA route's width `n_adapters` (0: no route) is in the key; the
    route itself is a state buffer each call writes."""
    leaves = tree_leaves_with_path(params)
    if cache is not None:
        kv_dtype = cache.dtype
    elif kv_dtype is None:
        kv_dtype = step_kw["emb_dtype"]
    cache_key = None if cache is None else tuple(
        (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in (cache.k, cache.v))
    key = (tuple((path, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for path, t in leaves),
           cfg, batch, cache_len, max_new_tokens, keyword_shape, str(device),
           tuple(sorted(step_kw.items())), hist_width, kv_dtype, cache_key, n_adapters)
    entry = _graphs.get(key)
    if entry is not None and entry.alive():
        _graphs.move_to_end(key)
        if cache is not None:
            entry.state.cache = cache
        return entry
    if cache is None:
        cache = owned = llama_mod.init_cache(cfg, batch, cache_len, dtype=kv_dtype,
                                             device=device)
    else:
        owned = None
    if hist_width is None:
        state = DecodeState.new(cache, cfg.vocab_size, max_new_tokens, keyword_shape, n_adapters)
        iteration = _decode_iteration
    else:
        state = SpecState.new(cache, cfg.vocab_size, max_new_tokens, keyword_shape, hist_width,
                              draft_keep=step_kw["draft_keep"], oracle=step_kw["oracle"],
                              n_adapters=n_adapters)
        iteration = _spec_iteration
    entry = DecodeGraph(state, iteration, leaves[0][1], step_kw,
                        cache_anchor=None if owned is not None else cache.k)
    _graphs[key] = entry
    while len(_graphs) > MAX_DECODE_GRAPHS:
        _graphs.popitem(last=False)
    return entry


def _drop_dead_graphs(_ref=None) -> None:
    """Drop every entry whose params or caller's cache are gone (a weak
    reference's callback)."""
    for key in [k for k, e in list(_graphs.items()) if not e.alive()]:
        _graphs.pop(key, None)


def decode_graphs() -> List[DecodeGraph]:
    """The live entries, least recently used first."""
    return list(_graphs.values())


def own_decode_graph(entry: DecodeGraph) -> DecodeGraph:
    """Register an entry its owner keeps out of the table (the serving
    engine's), so that `clear_decode_graphs` releases its graph too."""
    _owned_graphs.add(entry)
    return entry


def clear_decode_graphs() -> None:
    """Drop every entry: its graph, memory pool, cache and buffers (the
    memory goes back to the caching allocator; `torch.cuda.empty_cache`
    returns it to the card); an owned entry loses its captured graph."""
    for entry in list(_owned_graphs):
        entry.release()
    entries = list(_graphs.values())
    _graphs.clear()
    # freed after the table is consistent again: a cache an entry frees may
    # call _drop_dead_graphs, which reads the table
    del entries
