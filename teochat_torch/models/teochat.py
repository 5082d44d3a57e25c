"""TEOChat: CLIP tower + projector + LLaMA or MPT decoder (port of teochat_tpu/models/teochat.py).

`TEOChat` has the JAX class's surface (`cfg`, `tokenizer`,
`tokens_per_frame`, `encode`, `generate`), so `run_inference_single`
(eval/inference.py, a copy of the JAX package's) drives it. Prompt lengths
are bucketed as in the JAX package, so the cache size and the prefill shapes
are the same on both backends. The decoder is LLaMA's or, for an
MptConfig, LLaVA-MPT's (models/mpt.py: its tied `wte` embeds the text, and
generation's backend dispatch runs it). `forward_train` is the training
loss, on either decoder.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from teochat_torch.config import GenerationConfig, TEOChatConfig
from teochat_torch.checkpoint.bridge import init_teochat  # noqa: F401  (public here too)
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.models import generation as gen_mod
from teochat_torch.models import llama as llama_mod
from teochat_torch.models import mpt as mpt_mod
from teochat_torch.models.projector import projector_forward
from teochat_torch.models.vit import select_features, vit_forward
from teochat_torch.train import lora as lora_mod
from teochat_torch.utils import tree_leaves_with_path

Params = dict

# prefill-length buckets (fused tokens) and frame-count buckets
SEQ_BUCKETS = (128, 256, 512, 768, 1024, 1536, 2048, 3072, 4352)
FRAME_BUCKETS = (1, 2, 4, 8, 16)


def round_to_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


def encode_frames(params: Params, cfg: TEOChatConfig, pixel_values: torch.Tensor,
                  num_frames: int = 1) -> torch.Tensor:
    """[N, 3, H, W] -> [N, tokens_per_frame, D_llm] (tower, then projector)."""
    hidden = vit_forward(
        params["vision"], cfg.vision, pixel_values,
        select_layer=cfg.mm_vision_select_layer, num_frames=num_frames,
    )
    feats = select_features(hidden, cfg.mm_vision_select_feature)
    return projector_forward(params["projector"], cfg.projector, feats)


def fuse_embeds(llm_params: Params, plan: fusion_mod.FusionPlan,
                vision_tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings + vision splice -> [B, L, D]; MPT's tied `wte` table
    where the params hold one."""
    text_ids = torch.as_tensor(plan.text_ids, dtype=torch.long, device=vision_tokens.device)
    text_emb = gen_mod.backend_embed(llm_params, text_ids, dtype=vision_tokens.dtype)
    return fusion_mod.fuse(text_emb, vision_tokens, plan)


def multimodal_embeds(params: Params, cfg: TEOChatConfig, plan: fusion_mod.FusionPlan,
                      vision_tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings + vision splice -> [B, L, D]."""
    return fuse_embeds(params["llm"], plan, vision_tokens)


def forward_train(params: Params, cfg: TEOChatConfig, plan: fusion_mod.FusionPlan,
                  pixel_values: torch.Tensor, remat: bool = False,
                  attn_impl: str = "auto", sharded=None) -> torch.Tensor:
    """Mean next-token cross-entropy over the valid labels of a fused batch.

    The tower runs without a graph unless one of its leaves requires a
    gradient (full fine-tuning: its attention then takes the trainable
    flash path, models/vit.py::attend); the
    projector, the fusion and the decoder carry gradients. The decoder (LLaMA,
    or MPT where the params hold its tied `wte`) runs cache-free on the
    right-padded plan (`right_padded=True`: the flash kernels on CUDA, K4a-c
    with MPT's ALiBi table). JAX's MPT branch passes the mask to its plain
    path; dropping it changes nothing that reaches the loss: a causal,
    key-separable bias leaves the padded keys after every valid query, and
    the padded rows' logits are out of the loss, as for LLaMA.
    `remat` recomputes decoder layers in the backward (HF gradient
    checkpointing); `attn_impl='plain'` runs the plain attention instead.

    `sharded` (parallel/tensor_parallel.py::Sharded) runs it on the mesh:
    `params` are this rank's local shards and `plan` / `pixel_values` its
    rows; the result is this rank's share of the global batch's loss, its
    rows' sum over the count of valid labels in every rank's rows (JAX's
    mean under GSPMD), so the ranks' shares and gradients sum to the
    global mean's. With `cfg.llm.sequence_axis` (a `sequence` axis) each
    rank runs the decoder on its chunk of S and its share counts the
    chunk's labels; on a `pipe` axis every pipe rank returns the same loss.
    """
    dev = pixel_values.device
    tower_trains = any(x.requires_grad for _, x in tree_leaves_with_path(params["vision"]))
    with torch.set_grad_enabled(torch.is_grad_enabled() and tower_trains):
        hidden = vit_forward(params["vision"], cfg.vision, pixel_values,
                             select_layer=cfg.mm_vision_select_layer, sharded=sharded)
        feats = select_features(hidden, cfg.mm_vision_select_feature)
    vision_tokens = projector_forward(params["projector"], cfg.projector, feats, sharded)
    if sharded is None:
        embeds = multimodal_embeds(params, cfg, plan, vision_tokens)
    else:
        embeds = _sharded_embeds(params["llm"], plan, vision_tokens, sharded)
    attention_mask = torch.as_tensor(plan.attention_mask, device=dev)
    position_ids = torch.as_tensor(plan.position_ids, device=dev)
    labels = torch.as_tensor(plan.labels, dtype=torch.long, device=dev)
    on_ring = getattr(cfg.llm, "sequence_axis", None) is not None
    if on_ring:
        # this rank's chunk of S; each label shifted on the whole sequence
        # first, so a chunk's last token takes the next chunk's first
        ignore = torch.full_like(labels[:, :1], fusion_mod.IGNORE_INDEX)
        labels = torch.cat([labels[:, 1:], ignore], 1)
        embeds, attention_mask, position_ids, labels = (
            sharded.own_sequence(a, 1) for a in (embeds, attention_mask, position_ids, labels))
    if mpt_mod.is_mpt_params(params["llm"]):
        logits = mpt_mod.mpt_forward(
            params["llm"], cfg.llm, embeds, attention_mask=attention_mask,
            right_padded=True, remat=remat, attn_impl=attn_impl, sharded=sharded,
        )
    else:
        logits = llama_mod.llama_forward(
            params["llm"], cfg.llm, embeds, position_ids=position_ids,
            attention_mask=attention_mask, right_padded=True, remat=remat,
            attn_impl=attn_impl, sharded=sharded,
        )
    if not on_ring:
        labels, logits = labels[:, 1:], logits[:, :-1]
    valid = labels != fusion_mod.IGNORE_INDEX
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    count = valid.sum()
    if sharded is not None:
        count = sharded.sum_rows(count)
    return -(tok_lp * valid).sum() / count.clamp(min=1)


def _sharded_embeds(llm_params: Params, plan: fusion_mod.FusionPlan,
                    vision_tokens: torch.Tensor, sh) -> torch.Tensor:
    """fuse_embeds on the mesh: the table's fsdp dim gathered, its
    vocabulary split over `model` (each rank's rows, summed)."""
    name = "wte" if mpt_mod.is_mpt_params(llm_params) else "embed_tokens"
    table = sh.gather(llm_params[name]["embedding"], f"llm/{name}/embedding")
    text_ids = torch.as_tensor(plan.text_ids, dtype=torch.long, device=vision_tokens.device)
    text_emb = sh.vocab_embed(table.to(vision_tokens.dtype), text_ids)
    return fusion_mod.fuse(text_emb, vision_tokens, plan)


class TEOChat:
    """Imperative shell for the harnesses; params live on one device."""

    def __init__(self, cfg: TEOChatConfig, params: Params, tokenizer=None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.dtype = getattr(torch, cfg.dtype)
        self.device = gen_mod.embedding_table(params["llm"]).device

    @property
    def tokens_per_frame(self) -> int:
        n = self.cfg.vision.num_patches
        return n if self.cfg.mm_vision_select_feature == "patch" else n + 1

    def encode(self, pixel_values: np.ndarray) -> torch.Tensor:
        """Encode N frames, padded to a frame bucket as in the JAX package."""
        n = pixel_values.shape[0]
        nb = round_to_bucket(n, FRAME_BUCKETS)
        if nb != n:
            pad = np.zeros((nb - n,) + pixel_values.shape[1:], pixel_values.dtype)
            pixel_values = np.concatenate([pixel_values, pad], axis=0)
        pv = torch.as_tensor(pixel_values).to(self.device, self.dtype)
        return encode_frames(self.params, self.cfg, pv)[:n]

    def _generator(self, rng) -> torch.Generator:
        if isinstance(rng, torch.Generator):
            return rng
        return torch.Generator(device=self.device).manual_seed(0 if rng is None else int(rng))

    @torch.no_grad()
    def generate(
        self,
        input_ids: Sequence[Sequence[int]],
        pixel_values: Optional[np.ndarray],  # [N_frames, 3, H, W] flat batch order
        gen: Optional[GenerationConfig] = None,
        rng: Union[torch.Generator, int, None] = None,
        stop_spec: Optional[gen_mod.StopSpec] = None,
        adapters: Optional[Sequence[int]] = None,
    ) -> List[List[int]]:
        """Batched generate; returns the generated ids per row (stop included).

        `rng` is a torch.Generator on the model's device or an int seed.
        `gen.speculative_k` > 0 decodes with prompt-lookup speculation
        (greedy: the plain path's tokens; sampled: its distribution, other
        draws) and leaves `last_spec_stats` {"steps", "drafts_accepted",
        "tokens"}. `adapters` (multi-LoRA params only: train/lora.py
        stack_lora_adapters) is each row's adapter index, -1 the base model."""
        gen = gen or GenerationConfig()
        cfg = self.cfg
        adapter_route = None
        if adapters is not None:
            n_adapters = lora_mod.num_stacked_adapters(self.params["llm"])
            if not n_adapters:
                raise ValueError("adapters= given but params carry no adapter-stacked LoRA "
                                 "leaves (use train.lora.stack_lora_adapters)")
            adapter_route = lora_mod.adapter_route(
                torch.as_tensor(list(adapters), device=self.device), n_adapters)
        n_frames = fusion_mod.count_frames(input_ids)
        if n_frames:
            if pixel_values is None or pixel_values.shape[0] != n_frames:
                got = None if pixel_values is None else pixel_values.shape[0]
                raise ValueError(f"prompt needs {n_frames} frames, got {got}")
            vision_tokens = self.encode(pixel_values)
        else:
            vision_tokens = torch.zeros(
                (1, self.tokens_per_frame, cfg.llm.hidden_size),
                dtype=self.dtype, device=self.device,
            )
        fused_len = max(
            len(r) + sum(1 for t in r if t == fusion_mod.IMAGE_TOKEN_INDEX)
            * (self.tokens_per_frame - 1)
            for r in input_ids
        )
        pad_to = round_to_bucket(min(fused_len, cfg.tokenizer_model_max_length), SEQ_BUCKETS)
        plan = fusion_mod.build_fusion_plan(
            input_ids, tokens_per_frame=self.tokens_per_frame,
            max_length=cfg.tokenizer_model_max_length, pad_to=pad_to,
        )
        embeds = multimodal_embeds(self.params, cfg, plan, vision_tokens)
        if stop_spec is None:
            if self.tokenizer is not None and gen.stop_strings:
                stop_spec = gen_mod.make_stop_spec(
                    gen.stop_strings, self.tokenizer, cfg.llm.eos_token_id
                )
            else:
                stop_spec = gen_mod.StopSpec(
                    keyword_ids=np.zeros((1, 1), np.int32),
                    keyword_lens=np.zeros((1,), np.int32),
                    eos_id=cfg.llm.eos_token_id,
                )

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        if gen.speculative_k > 0:
            k = gen.speculative_k
            # the history's width is a shape of the loop's graph: bucketed as
            # the fused prompt is, so that a sweep reuses its entries
            s_text = round_to_bucket(max(len(r) for r in input_ids), SEQ_BUCKETS)
            prompt_ids = np.full((len(input_ids), s_text), -1, np.int32)
            for i, r in enumerate(input_ids):
                prompt_ids[i, : len(r)] = r
            tokens, n_gen, steps, accepted = gen_mod.generate_tokens_spec(
                self.params["llm"], cfg.llm, embeds,
                dev(plan.seq_lens), dev(plan.attention_mask), dev(plan.position_ids),
                prompt_ids, np.asarray([len(r) for r in input_ids], np.int32),
                stop_spec, self._generator(rng),
                max_new_tokens=gen.max_new_tokens,
                cache_len=pad_to + gen.max_new_tokens + k + 1,
                spec_k=k,
                temperature=gen.temperature,
                do_sample=gen.do_sample,
                top_p=gen.top_p,
                pad_id=cfg.llm.pad_token_id,
                draft_keep_prob=gen.speculative_draft_keep_prob,
                adapter_route=adapter_route,
            )
            tokens, n_gen = tokens.cpu().numpy(), n_gen.cpu().numpy()
            self.last_spec_stats = {"steps": int(steps), "drafts_accepted": int(accepted),
                                    "tokens": int(n_gen.sum())}
            return [tokens[i, : n_gen[i]].tolist() for i in range(len(input_ids))]

        tokens, n_gen = gen_mod.generate_tokens(
            self.params["llm"], cfg.llm, embeds,
            dev(plan.seq_lens), dev(plan.attention_mask), dev(plan.position_ids),
            stop_spec, self._generator(rng),
            max_new_tokens=gen.max_new_tokens,
            temperature=gen.temperature,
            do_sample=gen.do_sample,
            top_p=gen.top_p,
            pad_id=cfg.llm.pad_token_id,
            cache_len=pad_to + gen.max_new_tokens + 1,
            adapter_route=adapter_route,
        )
        tokens, n_gen = tokens.cpu().numpy(), n_gen.cpu().numpy()
        return [tokens[i, : n_gen[i]].tolist() for i in range(len(input_ids))]
