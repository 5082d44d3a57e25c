"""LLaMA-2 decoder (port of teochat_tpu/models/llama.py).

Params keep the JAX layout: stacked per-layer tensors (`[L, ...]`), kernels
`[in, out]`, int8 projections as {'kernel' int8, 'scale' fp32 [out]}, LoRA
adapters as extra leaves of a projection ('lora_a' [L, in, r], 'lora_b'
[L, r, out], 'lora_scale' [L], fp32 masters).

The cache-free forward (`cache=None`, training) runs causal self-attention
over the whole sequence: a right-padded batch on CUDA goes to the
differentiable flash kernels (K4a-c) with the padding mask dropped, other
cases to the plain masked attention. `remat=True` wraps each decoder layer
in a non-reentrant `torch.utils.checkpoint` (the JAX `jax.checkpoint(...,
nothing_saveable)`), so its activations are recomputed in the backward.

The KV cache is two buffers K and V of shape [L, B, T_max, Hkv, D]. Unlike
the JAX package, which is functional and threads new buffers through its
loops, this port UPDATES THE BUFFERS IN PLACE: a prefill writes its
contiguous [B, S] panel at slot `prefill_start`, a decode step writes one
slot per row at `write_slots`. Prefill attends over the fresh K/V through
the flash kernel (right-padded causal prompts need no mask); decode attends
the layer's cache slab in place through the decode kernel with
`lengths = q_slot + 1`, which on the plain generate path equals the JAX mask
`slot <= q_slot & kv_mask` because each row's slots are contiguous.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from teochat_tpu.config import LlamaConfig
from teochat_torch.ops.attention import dot_product_attention
from teochat_torch.ops.decode_attention import decode_attention
from teochat_torch.ops.quant import quantized_proj

Params = Dict


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, T_max, Hkv, D], updated in place
    v: torch.Tensor  # [L, B, T_max, Hkv, D], updated in place

    @property
    def dtype(self):
        return self.k.dtype

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    # HF casts back to the input dtype before multiplying by the scale
    return y.to(x.dtype) * scale.to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for HF rotate-half RoPE. positions [...] -> [..., head_dim]."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=positions.device) / head_dim)
    )
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D] (HF rotate-half convention)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def _proj(x: torch.Tensor, p: Params) -> torch.Tensor:
    if "packed" in p or "packed_tiles" in p:
        raise NotImplementedError("int4 projections are not ported yet")
    if "scale" in p:  # int8 weight-only
        y = quantized_proj(x, p)
    else:
        y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "lora_a" in p:  # LoRA adapter (train/lora.py); fp32 masters cast to x's dtype
        if p["lora_a"].ndim == 3:
            raise NotImplementedError("multi-LoRA (adapter-stacked) leaves are not ported yet")
        a, b = p["lora_a"].to(x.dtype), p["lora_b"].to(x.dtype)
        delta = torch.matmul(torch.matmul(x, a), b)  # fp32 accumulation in each product
        y = y + (delta.float() * p["lora_scale"].detach().float()).to(x.dtype)
    return y


def _mlp(x: torch.Tensor, lp: Params) -> torch.Tensor:
    if "gateup" in lp:
        raise NotImplementedError("fused gate|up projections are not ported yet")
    gate = F.silu(_proj(x, lp["gate"]).float()).to(x.dtype)
    return _proj(gate * _proj(x, lp["up"]), lp["down"])


def _attention_layer(x, lp, cfg: LlamaConfig, cos, sin, cache: Optional[KVCache],
                     layer: int, write_slots, prefill_start: int, attn_impl: str,
                     attention_mask=None, right_padded: bool = False) -> torch.Tensor:
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "qkv" in lp:
        raise NotImplementedError("fused q|k|v projections are not ported yet")
    q = apply_rope(_proj(x, lp["q"]).reshape(b, s, h, hd), cos, sin)
    k = apply_rope(_proj(x, lp["k"]).reshape(b, s, hkv, hd), cos, sin)
    v = _proj(x, lp["v"]).reshape(b, s, hkv, hd)
    if cache is None:
        # cache-free path: causal self-attention over S, plus the padding mask
        # (which the flash kernels drop for a right-padded batch)
        out = dot_product_attention(q, k, v, causal=True, mask=attention_mask,
                                    impl=attn_impl, right_padded=right_padded)
        return _proj(out.reshape(b, s, h * hd), lp["out"])
    k_slab, v_slab = cache.k[layer], cache.v[layer]  # [B, T, Hkv, D] views
    if s > 1:
        # prefill: one contiguous panel; causal attention over the fresh K/V
        # equals attention over the cache, since the prompt starts at slot 0
        k_slab[:, prefill_start:prefill_start + s] = k.to(cache.dtype)
        v_slab[:, prefill_start:prefill_start + s] = v.to(cache.dtype)
        out = dot_product_attention(q, k, v, causal=True, impl=attn_impl)
    else:
        rows = torch.arange(b, device=x.device)
        slots = write_slots[:, 0].long()
        k_slab[rows, slots] = k[:, 0].to(cache.dtype)
        v_slab[rows, slots] = v[:, 0].to(cache.dtype)
        lengths = (write_slots[:, 0] + 1).to(torch.int32)
        out = decode_attention(
            q[:, 0], k_slab.transpose(1, 2).to(q.dtype), v_slab.transpose(1, 2).to(q.dtype),
            lengths, impl=attn_impl,
        )[:, None]
    return _proj(out.reshape(b, s, h * hd), lp["out"])


def _decoder_layer(x, lp, cfg: LlamaConfig, cos, sin, cache, layer, write_slots,
                   prefill_start, attn_impl, attention_mask, right_padded) -> torch.Tensor:
    y = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps)
    x = x + _attention_layer(y, lp["attn"], cfg, cos, sin, cache, layer, write_slots,
                             prefill_start, attn_impl, attention_mask, right_padded)
    y = rms_norm(x, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps)
    return x + _mlp(y, lp["mlp"])


def unstack_layers(tree, n_layers: int):
    """A stacked params tree -> one tree per layer (views). `unbind` gives a
    trainable [L, ...] leaf one gradient stack in the backward, where
    indexing each layer would add a full-size zero tensor per layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, n_layers) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n_layers)]
    return tree.unbind(0)


def embed_tokens(params: Params, input_ids: torch.Tensor, dtype=None) -> torch.Tensor:
    emb = params["embed_tokens"]["embedding"]
    if dtype is not None:
        emb = emb.to(dtype)
    return emb[input_ids]


def _check_supported(cfg: LlamaConfig, cache: Optional[KVCache], b: int,
                     spec_verify: bool, attend_cache: bool) -> None:
    unsupported = {
        "spec_verify": spec_verify,
        "attend_cache": attend_cache,
        "a cache wider than the batch": cache is not None and cache.k.shape[1] != b,
        "int8_prefill_activations (w8a8)": cfg.int8_prefill_activations,
        "sequence_axis (ring attention)": cfg.sequence_axis is not None,
        "cache_sequence_axis (sharded cache)": cfg.cache_sequence_axis is not None,
        "pipeline_axis": cfg.pipeline_axis is not None,
    }
    named = [name for name, on in unsupported.items() if on]
    if named:
        raise NotImplementedError(f"llama_forward: not ported yet: {', '.join(named)}")


def llama_forward(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    *,
    position_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    write_slots: Optional[torch.Tensor] = None,
    logits_mode: str = "all",  # all | last
    last_index: Optional[torch.Tensor] = None,
    remat: bool = False,
    right_padded: bool = False,
    prefill_start: int = 0,
    spec_verify: bool = False,
    attend_cache: bool = False,
    attn_impl: str = "auto",  # auto | plain
) -> torch.Tensor:
    """Run the decoder stack; returns fp32 logits [B, S|1, V].

    inputs_embeds [B, S, D]; position_ids [B, S] RoPE positions.
    Cached path: write_slots [B, S] is the cache slot of each token (the slot
    a decode query attends up to); S > 1 is a prefill, S == 1 a decode step.
    Cache-free path (`cache=None`, training): `attention_mask` [B, S] marks
    the valid tokens, `right_padded` says the padding is all on the right,
    `remat` recomputes each layer in the backward. `last_index` [B] picks
    each row's position for logits_mode='last'. `attn_impl` 'plain' routes
    every attention to its plain twin (the kernels' reference).
    """
    x = inputs_embeds
    b, s, _ = x.shape
    _check_supported(cfg, cache, b, spec_verify, attend_cache)
    cos, sin = rope_tables(position_ids, cfg.head_dim, cfg.rope_theta)
    mask = None if attention_mask is None else attention_mask.bool()
    for layer, lp in enumerate(unstack_layers(params["layers"], cfg.num_layers)):
        args = (x, lp, cfg, cos, sin, cache, layer, write_slots, prefill_start,
                attn_impl, mask, right_padded)
        if remat and cache is None:
            x = checkpoint(_decoder_layer, *args, use_reentrant=False)
        else:
            x = _decoder_layer(*args)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)

    if logits_mode == "last":
        if last_index is None:
            x = x[:, -1:]
        else:
            x = x[torch.arange(b, device=x.device), last_index.long()][:, None]
    elif logits_mode != "all":
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    head = params.get("lm_head")
    if head is None:  # tied embeddings
        return torch.matmul(x, params["embed_tokens"]["embedding"].to(x.dtype).T).float()
    if "packed" in head or "packed_tiles" in head:
        raise NotImplementedError("int4 lm_head is not ported yet")
    if "lora_a" in head:
        raise NotImplementedError("a LoRA lm_head is not ported yet")
    if "scale" in head:  # int8 weight-only lm_head
        return quantized_proj(x, head, fp32_out=True)
    return torch.matmul(x, head["kernel"].to(x.dtype)).float()
