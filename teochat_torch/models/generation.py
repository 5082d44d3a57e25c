"""Generation: prefill, then a decode loop with EOS and keyword stops.

Port of teochat_tpu/models/generation.py (`StopSpec`, `make_stop_spec`,
`_keyword_hit`, `sample_token`, `_filtered_logits`, `generate_tokens`,
`_run_decode_loop`). The semantics are the JAX package's: tokens after a row
stops are `pad_id`, `n_gen` counts up to and including the stop token, and
the loop ends when every row is done. This eager loop reads the done flags
back to the host once per step (the JAX loop stays on the device); removing
that sync is later work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from teochat_torch.config import LlamaConfig
from teochat_torch.models import llama as llama_mod


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_new_tokens] with pad_id after a stop, n_gen [B]).

    Generated tokens include the stop keyword; callers strip it. The cache
    holds `cache_len` slots; the last one is the trash slot where padded
    prompt positions point (never attended).
    """
    b, s, _ = inputs_embeds.shape
    cache = llama_mod.init_cache(cfg, b, cache_len, dtype=inputs_embeds.dtype,
                                 device=inputs_embeds.device)
    trash = cache.max_len - 1
    slots = torch.where(attention_mask, position_ids, trash)
    logits = llama_mod.llama_forward(
        params, cfg, inputs_embeds, position_ids=position_ids, cache=cache,
        write_slots=slots, logits_mode="last", last_index=seq_lens - 1,
    )
    return _run_decode_loop(
        params, cfg, cache, logits[:, -1], seq_lens, stop, generator,
        max_new_tokens=max_new_tokens, temperature=temperature,
        do_sample=do_sample, top_p=top_p, pad_id=pad_id,
        emb_dtype=inputs_embeds.dtype,
    )


def _run_decode_loop(params, cfg, cache, logits0, start_pos, stop: StopSpec, generator, *,
                     max_new_tokens, temperature, do_sample, top_p, pad_id, emb_dtype):
    """Sample from logits0, feed the token, repeat.

    start_pos [B]: cache slot of each row's first generated token. Returns
    (tokens [B, max_new_tokens], n_gen [B])."""
    dev = logits0.device
    b = start_pos.shape[0]
    keyword_ids = torch.as_tensor(stop.keyword_ids, device=dev)
    keyword_lens = torch.as_tensor(stop.keyword_lens, device=dev)
    tokens = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32, device=dev)
    window = torch.full((b, keyword_ids.shape[1]), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    n_gen = torch.zeros(b, dtype=torch.int32, device=dev)
    logits = logits0
    for step in range(max_new_tokens):
        tok = sample_token(logits, generator, temperature=temperature,
                           do_sample=do_sample, top_p=top_p).to(torch.int32)
        tok = torch.where(done, pad_id, tok)
        tokens[:, step] = tok
        window = torch.cat([window[:, 1:], tok[:, None]], dim=1)
        n_gen += (~done).to(torch.int32)
        done = done | (tok == stop.eos_id) | _keyword_hit(window, keyword_ids, keyword_lens)
        # the one host read per step; the JAX loop would also run this
        # step's forward, whose result nothing reads
        if step + 1 == max_new_tokens or bool(done.all()):
            break
        pos = start_pos + step
        emb = llama_mod.embed_tokens(params, tok[:, None].long(), dtype=emb_dtype)
        logits = llama_mod.llama_forward(
            params, cfg, emb, position_ids=pos[:, None], cache=cache,
            write_slots=pos[:, None], logits_mode="last",
        )[:, -1]
    return tokens, n_gen
