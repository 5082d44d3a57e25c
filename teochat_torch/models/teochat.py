"""TEOChat: CLIP tower + projector + LLaMA decoder (port of teochat_tpu/models/teochat.py).

`TEOChat` has the JAX class's surface (`cfg`, `tokenizer`,
`tokens_per_frame`, `encode`, `generate`), so the unmodified
`teochat_tpu.eval.inference.run_inference_single` drives it. Prompt lengths
are bucketed as in the JAX package, so the cache size and the prefill shapes
are the same on both backends. `forward_train` is the training loss.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from teochat_tpu.config import GenerationConfig, LlamaConfig, TEOChatConfig
from teochat_torch.checkpoint.bridge import init_teochat  # noqa: F401  (public here too)
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.models import generation as gen_mod
from teochat_torch.models import llama as llama_mod
from teochat_torch.models.projector import projector_forward
from teochat_torch.models.vit import select_features, vit_forward

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
    """Token embeddings + vision splice -> [B, L, D]."""
    if "wte" in llm_params:
        raise NotImplementedError("the MPT backend is not ported yet")
    text_ids = torch.as_tensor(plan.text_ids, dtype=torch.long, device=vision_tokens.device)
    text_emb = llama_mod.embed_tokens(llm_params, text_ids, dtype=vision_tokens.dtype)
    return fusion_mod.fuse(text_emb, vision_tokens, plan)


def multimodal_embeds(params: Params, cfg: TEOChatConfig, plan: fusion_mod.FusionPlan,
                      vision_tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings + vision splice -> [B, L, D]."""
    return fuse_embeds(params["llm"], plan, vision_tokens)


def forward_train(params: Params, cfg: TEOChatConfig, plan: fusion_mod.FusionPlan,
                  pixel_values: torch.Tensor, remat: bool = False,
                  attn_impl: str = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy over the valid labels of a fused batch.

    The tower is frozen, so it runs without a graph; the projector, the
    fusion and the decoder carry gradients. The decoder runs cache-free on
    the right-padded plan (`right_padded=True`: the flash kernels on CUDA).
    `remat` recomputes decoder layers in the backward (HF gradient
    checkpointing); `attn_impl='plain'` runs the plain attention instead.
    """
    if not isinstance(cfg.llm, LlamaConfig):
        raise NotImplementedError("only the LLaMA backend is ported")
    dev = pixel_values.device
    with torch.no_grad():
        hidden = vit_forward(params["vision"], cfg.vision, pixel_values,
                             select_layer=cfg.mm_vision_select_layer)
        feats = select_features(hidden, cfg.mm_vision_select_feature)
    vision_tokens = projector_forward(params["projector"], cfg.projector, feats)
    embeds = multimodal_embeds(params, cfg, plan, vision_tokens)
    logits = llama_mod.llama_forward(
        params["llm"], cfg.llm, embeds,
        position_ids=torch.as_tensor(plan.position_ids, device=dev),
        attention_mask=torch.as_tensor(plan.attention_mask, device=dev),
        right_padded=True, remat=remat, attn_impl=attn_impl,
    )
    labels = torch.as_tensor(plan.labels, dtype=torch.long, device=dev)[:, 1:]
    valid = labels != fusion_mod.IGNORE_INDEX
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tok_lp = torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    return -(tok_lp * valid).sum() / valid.sum().clamp(min=1)


class TEOChat:
    """Imperative shell for the harnesses; params live on one device."""

    def __init__(self, cfg: TEOChatConfig, params: Params, tokenizer=None):
        if not isinstance(cfg.llm, LlamaConfig):
            raise NotImplementedError("only the LLaMA backend is ported")
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.dtype = getattr(torch, cfg.dtype)
        self.device = params["llm"]["embed_tokens"]["embedding"].device

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

        `rng` is a torch.Generator on the model's device or an int seed."""
        gen = gen or GenerationConfig()
        if adapters is not None:
            raise NotImplementedError("multi-LoRA adapters are not ported yet")
        if gen.speculative_k > 0:
            raise NotImplementedError("speculative decoding is not ported yet")
        cfg = self.cfg
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
        )
        tokens, n_gen = tokens.cpu().numpy(), n_gen.cpu().numpy()
        return [tokens[i, : n_gen[i]].tolist() for i in range(len(input_ids))]
