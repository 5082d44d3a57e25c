"""Vision-tokenizer special tokens: <im_patch> / <im_start> / <im_end> (port of
teochat_tpu/vision_tokenizer.py).

Three reference sites:
- llava_arch.py:348-391 `initialize_vision_tokenizer`: the train-time token
  add, the embedding resize with MEAN-init of the new rows, and the optional
  embed rows of a pretrained mm-projector checkpoint;
- model/builder.py:135-147: the load-time token add (patch tokens with
  `mm_use_im_patch_token`, start / end with `mm_use_im_start_end`), then
  `resize_token_embeddings(len(tokenizer))`;
- the `<im_start><image><im_end>` prompt wrap that `mm_use_im_start_end`
  implies (upstream LLaVA's preprocess_multimodal).

As in the JAX package, resizing is a function over the params tree (no
module is mutated): embed_tokens [V, D] gets rows appended, lm_head [D, V]
gets columns appended, and a quantized lm_head (int8 {kernel, scale}, int4
{packed | packed_tiles, scale}) is dequantized, resized and requantized by
`quantize_kernel` / `quantize_kernel_int4` (their eager form, as JAX's
resize calls them). New rows and columns are the deterministic mean of the
existing ones, in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from teochat_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
)
from teochat_torch.ops.quant import (
    dequantize_kernel,
    quantize_kernel,
    quantize_kernel_int4,
    unpack_int4,
)

Params = Dict[str, Any]


def wrap_image_tokens(text: str) -> str:
    """`<image>` -> `<im_start><image><im_end>`, at each `<image>` (so the
    interleave strategy's "Image 1: " text stays outside the markers).
    Applied to prompts of models trained with `mm_use_im_start_end`."""
    return text.replace(
        DEFAULT_IMAGE_TOKEN,
        DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN,
    )


def add_vision_tokens(tokenizer, mm_use_im_patch_token: bool, mm_use_im_start_end: bool) -> int:
    """Add the special tokens the flags call for; return the number of new
    vocabulary entries. Patch tokens first (image and video share the
    "<im_patch>" string, so the second add is a no-op), then the four
    start / end markers. Safe to call twice: `add_tokens` dedupes."""
    added = 0
    if mm_use_im_patch_token:
        added += tokenizer.add_tokens([DEFAULT_IMAGE_PATCH_TOKEN], special_tokens=True)
        added += tokenizer.add_tokens([DEFAULT_VIDEO_PATCH_TOKEN], special_tokens=True)
    if mm_use_im_start_end:
        added += tokenizer.add_tokens(
            [DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN], special_tokens=True)
        added += tokenizer.add_tokens(
            [DEFAULT_VID_START_TOKEN, DEFAULT_VID_END_TOKEN], special_tokens=True)
    return added


# ------------------------------------------------------------- resize core


def _dequant_lm_head(head: Params) -> torch.Tensor:
    """Any lm_head leaf group -> fp32 [D', V] (D' the int4 leaf's padded fan-in)."""
    if "packed_tiles" in head or "packed" in head:
        if "packed_tiles" in head:
            tiles = head["packed_tiles"]  # [n_tiles, in/2, bn]
            k2 = tiles.shape[-2]
            flat = tiles.movedim(-3, -2).reshape(k2, -1)
        else:
            flat = head["packed"]
        w = unpack_int4(flat, torch.float32)[..., : head["scale"].shape[-1]]
        return w * head["scale"].float()
    if "scale" in head:
        return dequantize_kernel(head, torch.float32)
    return head["kernel"].float()


def _requant_lm_head(w: torch.Tensor, like: Params) -> Params:
    """fp32 [D, V] -> the quantization family of `like`."""
    if "packed_tiles" in like or "packed" in like:
        return quantize_kernel_int4(w)
    if "scale" in like:
        return quantize_kernel(w)
    return {"kernel": w.to(like["kernel"].dtype)}


def resize_token_embeddings(llm_params: Params, new_vocab: int) -> Params:
    """Resize embed_tokens (and the lm_head when untied) to `new_vocab`.

    Grow: the new embedding rows and lm_head columns are the mean of the
    existing ones in fp32 (reference llava_arch.py:358-367). Shrink:
    truncate (HF `resize_token_embeddings`). The same tree when the sizes
    already match."""
    emb = llm_params["embed_tokens"]["embedding"]
    old_vocab = emb.shape[0]
    if new_vocab == old_vocab:
        return llm_params

    out = dict(llm_params)
    if new_vocab < old_vocab:
        out["embed_tokens"] = {"embedding": emb[:new_vocab]}
        if "lm_head" in llm_params:
            w = _dequant_lm_head(llm_params["lm_head"])[:, :new_vocab]
            out["lm_head"] = _requant_lm_head(w, llm_params["lm_head"])
        return out

    n_new = new_vocab - old_vocab
    row = emb.float().mean(dim=0, keepdim=True)
    out["embed_tokens"] = {"embedding": torch.cat([emb, row.expand(n_new, -1).to(emb.dtype)])}

    if "lm_head" in llm_params:
        w = _dequant_lm_head(llm_params["lm_head"])  # [D, V]
        col = w.mean(dim=1, keepdim=True)
        w = torch.cat([w, col.expand(-1, n_new)], dim=1)
        out["lm_head"] = _requant_lm_head(w, llm_params["lm_head"])
    return out


# ----------------------------------------------------- train-time machinery


def initialize_vision_tokenizer(
    model_args,
    cfg,
    params: Params,
    tokenizer,
    pretrain_embed_rows: Optional[Any] = None,
) -> Tuple[Any, Params, int]:
    """Train-time token add + resize (reference llava_arch.py:348-391).

    Returns (cfg, params, num_new_tokens), with cfg.llm.vocab_size and the
    mm_use_* flags updated so checkpoints record what they were trained
    with. `pretrain_embed_rows` (a tensor or an array: the
    `model.embed_tokens.weight` of a pretrain_mm_mlp_adapter checkpoint,
    llava_arch.py:375-387) overwrites the new input-embedding rows with its
    last num_new rows, or with itself when it holds exactly num_new."""
    use_patch = bool(getattr(model_args, "mm_use_im_patch_token", False))
    use_start_end = bool(getattr(model_args, "mm_use_im_start_end", False))

    params = dict(params)
    llm = params["llm"]
    num_new = 0
    if use_patch:
        num_new += tokenizer.add_tokens([DEFAULT_IMAGE_PATCH_TOKEN], special_tokens=True)
        llm = resize_token_embeddings(llm, len(tokenizer))
    if use_start_end:
        n = tokenizer.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN],
                                 special_tokens=True)
        num_new += n
        llm = resize_token_embeddings(llm, len(tokenizer))
        if n > 0 and pretrain_embed_rows is not None:
            rows = torch.as_tensor(pretrain_embed_rows)
            emb = llm["embed_tokens"]["embedding"]
            if tuple(rows.shape) == tuple(emb.shape):
                new_rows = rows[-n:]
            elif rows.shape[0] == n:
                new_rows = rows
            else:
                raise ValueError(
                    f"Unexpected embed_tokens shape from pretrain adapter: "
                    f"{tuple(rows.shape)} vs current {tuple(emb.shape)}, {n} new tokens")
            emb = emb.clone()
            emb[-n:] = new_rows.to(emb.device, emb.dtype)
            llm = {**llm, "embed_tokens": {"embedding": emb}}
    params["llm"] = llm

    cfg = dataclasses.replace(
        cfg,
        llm=dataclasses.replace(cfg.llm, vocab_size=len(tokenizer)),
        mm_use_im_start_end=use_start_end,
        mm_use_im_patch_token=use_patch,
    )
    return cfg, params, num_new


def embed_trainable_filter(base_filter):
    """Wrap a trainable filter so the input embeddings train too and the
    lm_head stays frozen (the reference's tune_mm_mlp_adapter +
    mm_use_im_start_end gating, llava_arch.py:369-374), as a path predicate."""

    def fn(path: str) -> bool:
        if "embed_tokens" in path:
            return True
        if "lm_head" in path:
            return False
        return base_filter(path) if base_filter is not None else True

    return fn
