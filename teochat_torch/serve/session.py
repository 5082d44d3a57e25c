"""Incremental multi-turn decoding: one KV cache a chat session.

Port of teochat_tpu/serve/session.py. The reference demo re-renders the
whole conversation each turn and re-prefills it (teochat_demo.py:513-546).
A `ChatSession` keeps one KV cache: each turn finds the longest committed
prefix of the newly rendered conversation, prefills only the suffix after
it (`generation.prefill_suffix`: spec_verify writes and K2m over the
committed cache) and decodes in place (`generation.decode_with_cache`, a
CUDA graph over this cache on the card). Frames inside the reused prefix
are not encoded again.

The committed prefix is the longest common prefix of the token ids whose
frames are also unchanged: a sentinel token stands for the frame at its
place, and a turn can change that frame while keeping the ids (a new frame
whose timestamp sorts before the committed ones moves every later frame
one place on). The JAX session compares the ids only and reuses the old
frames' K/V there; this one re-prefills from the first sentinel whose frame
changed. Elsewhere it reuses what the JAX session reuses.

A turn gives the tokens of a stateless `TEOChat.generate` on the whole
conversation, up to floating-point argmax ties between the suffix-prefill
and full-prefill shapes. A turn with `speculative_k` > 0 decodes with
prompt-lookup speculation (`generation.decode_with_cache_spec`) whose
history is the whole conversation's ids; the cache then keeps spec_k draft
slots free, and `stats` counts `spec_steps` and `spec_accepted`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from teochat_torch.config import GenerationConfig
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.models import generation as gen_mod
from teochat_torch.models import llama as llama_mod
from teochat_torch.models import teochat as teochat_mod


def _count_sentinels(ids: Sequence[int]) -> int:
    return sum(1 for t in ids if t == fusion_mod.IMAGE_TOKEN_INDEX)


class ChatSession:
    """One conversation's persistent KV cache over a TEOChat model."""

    def __init__(self, model: teochat_mod.TEOChat, *, max_len: int = 4096):
        self.model = model
        self.max_len = max_len
        # allocated on the first turn: an idle session holds no device memory
        # (a 7B cache of 4,096 bf16 slots is 2 GiB)
        self.cache: Optional[llama_mod.KVCache] = None
        self.tokens: List[int] = []  # the whole rendered conversation (token ids)
        self.frames: Optional[np.ndarray] = None  # the frames of its sentinels, in order
        self.kv_len = 0  # leading tokens of `tokens` whose K/V are committed
        self.stats = {"turns": 0, "reused_tokens": 0, "prefilled_tokens": 0}

    def _fused_len(self, n_tokens: int) -> int:
        sent = _count_sentinels(self.tokens[:n_tokens])
        return n_tokens + sent * (self.model.tokens_per_frame - 1)

    def reset(self) -> None:
        self.cache = None  # freed (with its decode graph); made again on the next turn
        self.tokens = []
        self.frames = None
        self.kv_len = 0

    def _ensure_cache(self) -> None:
        if self.cache is None:
            self.cache = llama_mod.init_cache(self.model.cfg.llm, 1, self.max_len,
                                              dtype=self.model.dtype, device=self.model.device)

    def _reusable(self, input_ids: List[int], pixel_values: Optional[np.ndarray]) -> int:
        """Leading tokens of `input_ids` whose committed K/V hold: the
        common prefix of the ids, cut at the first sentinel whose frame
        differs from the committed one."""
        lcp = 0
        for a, b in zip(self.tokens, input_ids):
            if a != b:
                break
            lcp += 1
        reuse = min(lcp, self.kv_len)
        frame = 0
        for pos in range(reuse):
            if input_ids[pos] != fusion_mod.IMAGE_TOKEN_INDEX:
                continue
            if not np.array_equal(pixel_values[frame], self.frames[frame]):
                return pos
            frame += 1
        return reuse

    @torch.no_grad()
    def generate(
        self,
        input_ids: Sequence[int],
        pixel_values: Optional[np.ndarray],  # frames for ALL sentinels, flat
        gen: Optional[GenerationConfig] = None,
        rng: Union[torch.Generator, int, None] = None,
    ) -> List[int]:
        """One turn: `input_ids` is the whole rendered conversation so far
        (the contract of TEOChat.generate with a single row). Returns the
        generated ids (stop string included). `rng` is a torch.Generator on
        the model's device or an int seed (sampled turns)."""
        model, cfg = self.model, self.model.cfg
        gen = gen or GenerationConfig()
        input_ids = list(input_ids)

        n_sent = _count_sentinels(input_ids)
        if n_sent:
            if pixel_values is None or pixel_values.shape[0] != n_sent:
                got = None if pixel_values is None else pixel_values.shape[0]
                raise ValueError(f"conversation needs {n_sent} frames, got {got}")

        reuse = self._reusable(input_ids, pixel_values)
        if reuse >= len(input_ids):  # nothing new to prefill: feed the last token again
            reuse = len(input_ids) - 1
        delta = input_ids[reuse:]
        start_tok = self._fused_len(reuse)

        # frames for the sentinels inside the delta only
        sent_prefix = _count_sentinels(input_ids[:reuse])
        if n_sent - sent_prefix:
            vision = model.encode(pixel_values[sent_prefix:])
        else:
            vision = torch.zeros((1, model.tokens_per_frame, cfg.llm.hidden_size),
                                 dtype=model.dtype, device=model.device)

        fused_delta = len(delta) + _count_sentinels(delta) * (model.tokens_per_frame - 1)
        spec_k = gen.speculative_k
        if start_tok + fused_delta + gen.max_new_tokens + spec_k + 1 > self.max_len:
            raise ValueError(
                f"session cache full: {start_tok} committed + {fused_delta} new "
                f"+ {gen.max_new_tokens} generated + {spec_k} draft slots + 1 spare "
                f"exceeds max_len {self.max_len}"
            )
        self._ensure_cache()
        pad_to = min(teochat_mod.round_to_bucket(fused_delta, teochat_mod.SEQ_BUCKETS),
                     self.max_len)
        plan = fusion_mod.build_fusion_plan(
            [delta], tokens_per_frame=model.tokens_per_frame, max_length=self.max_len,
            pad_to=pad_to,
        )
        embeds = teochat_mod.multimodal_embeds(model.params, cfg, plan, vision)

        def dev(a):
            return torch.as_tensor(a, device=model.device)

        llm = model.params["llm"]
        seq_lens = dev(plan.seq_lens)
        start = torch.full((1,), start_tok, dtype=seq_lens.dtype, device=model.device)
        if reuse == 0:
            logits, self.cache = gen_mod.prefill_full(
                llm, cfg.llm, self.cache, embeds, seq_lens, dev(plan.attention_mask),
                dev(plan.position_ids),
            )
        else:
            logits, self.cache = gen_mod.prefill_suffix(
                llm, cfg.llm, self.cache, embeds, start, seq_lens, dev(plan.attention_mask),
                dev(plan.position_ids),
            )

        if model.tokenizer is not None and gen.stop_strings:
            stop = gen_mod.make_stop_spec(gen.stop_strings, model.tokenizer,
                                          cfg.llm.eos_token_id)
        else:
            stop = gen_mod.StopSpec(keyword_ids=np.zeros((1, 1), np.int32),
                                    keyword_lens=np.zeros((1,), np.int32),
                                    eos_id=cfg.llm.eos_token_id)
        if spec_k > 0:
            # the draft history is the whole conversation: earlier turns are
            # the best draft material (a chat echoes itself)
            width = teochat_mod.round_to_bucket(len(input_ids), teochat_mod.SEQ_BUCKETS)
            hist_ids = np.full((1, width), -1, np.int32)
            hist_ids[0, : len(input_ids)] = input_ids
            tokens, n_gen, steps, accepted, self.cache = gen_mod.decode_with_cache_spec(
                llm, cfg.llm, self.cache, logits, start + seq_lens, hist_ids,
                np.asarray([len(input_ids)], np.int32), stop, model._generator(rng),
                max_new_tokens=gen.max_new_tokens, spec_k=spec_k, temperature=gen.temperature,
                do_sample=gen.do_sample, top_p=gen.top_p, pad_id=cfg.llm.pad_token_id,
            )
            self.stats["spec_steps"] = self.stats.get("spec_steps", 0) + int(steps)
            self.stats["spec_accepted"] = self.stats.get("spec_accepted", 0) + int(accepted)
        else:
            tokens, n_gen, self.cache = gen_mod.decode_with_cache(
                llm, cfg.llm, self.cache, logits, start + seq_lens, stop, model._generator(rng),
                max_new_tokens=gen.max_new_tokens, temperature=gen.temperature,
                do_sample=gen.do_sample and gen.temperature > 0.0, top_p=gen.top_p,
                pad_id=cfg.llm.pad_token_id,
            )
        out = tokens[0, : int(n_gen[0])].tolist()

        self.tokens = input_ids + out
        self.frames = None if pixel_values is None else np.array(pixel_values, copy=True)
        # the prefill commits every prompt token's K/V; the decode every
        # generated token's but the last one's (never fed back)
        self.kv_len = len(self.tokens) - 1 if out else len(input_ids)
        self.stats["turns"] += 1
        self.stats["reused_tokens"] += reuse
        self.stats["prefilled_tokens"] += len(delta)
        return out
