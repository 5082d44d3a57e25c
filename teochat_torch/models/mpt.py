"""MPT decoder backend: ALiBi attention, no positional embeddings (port of
teochat_tpu/models/mpt.py).

The reference's vendored MosaicML MPT stack as one functional module over
the same params layout as the JAX package's (stacked `[L, ...]` leaves,
kernels `[in, out]`):

- ALiBi as a key-position bias table bias_k [H, T] = -slope_h (T - 1 - key):
  softmax is row-shift invariant, so under a causal mask it equals the
  relative form, and a cached decode needs no per-query bias;
- one packed q|k|v projection (`wqkv`), multi-head or multiquery (one kv
  head shared by every query head, each with its own slope);
- pre-LN blocks (fp32 LayerNorm, eps 1e-5), an exact-GELU MLP, bias-free
  projections by default (`no_bias`), and the tied `wte` head.

`_dense` sends int8, int4, LoRA and adapter-stacked leaves through
models/llama.py::_proj, as the JAX module does. The table is sized to the
KV cache (`cache.max_len`, or S without one) and sliced per call.

Attention, by path:
- a cached prefill (S > 1, not `spec_verify` / `attend_cache`) writes its
  contiguous panel at `prefill_start` and attends its fresh K / V causally
  with bias[:, :S]: on the card the hand-written flash kernel K1 with its
  bias branch (ops/flash_attention.py), on the CPU the plain twin;
- a decode step, a verify block (`spec_verify`) and an `attend_cache`
  prefill attend the row's cache slab through the plain masked attention,
  mask `slot <= q_slot & kv_mask & slot < kv_len` built on the device from
  `write_slots` (no host read, so a CUDA graph can hold the step) and the
  whole table as its bias: JAX runs XLA's masked attention there, not a
  Pallas kernel, and the decode kernels K2 / K2m take no bias;
- cache-free (`cache=None`): causal self-attention over S, through the
  differentiable flash path (K4a, K4b and K4c with the bias) on the card
  when there is no mask or the mask is right padding (`right_padded`, the
  training plan: the padded keys sit after every valid query), else the
  plain masked attention.

The KV cache is llama.py's `KVCache`, updated in place as there.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from teochat_torch.models import llama as llama_mod
from teochat_torch.ops.attention import dot_product_attention
from teochat_torch.ops.quant import matmul_fp32
from teochat_torch.utils import resolve_device, unported

Params = Dict

NUM_SENTINEL_TOKENS = 100  # reference mpt/adapt_tokenizer.py:4


def is_mpt(cfg) -> bool:
    """Whether a decoder config is MPT's: configs are read by their fields
    (a JAX package's config describes the same model), and only MPT's has
    `d_model`. What builds the params reads this; what runs them reads
    `is_mpt_params`."""
    return hasattr(cfg, "d_model")


def is_mpt_params(llm_params) -> bool:
    """Whether a decoder's params are MPT's: only MPT's hold the tied `wte`."""
    return "wte" in llm_params


def alibi_slopes(n_heads: int, alibi_bias_max: int = 8, device=None) -> torch.Tensor:
    """Per-head slopes with the power-of-two interleave (attention.py gen_slopes), fp32 [H]."""
    ceil_pow2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, ceil_pow2 + 1, dtype=torch.float32, device=device)
    m = m * (alibi_bias_max / ceil_pow2)
    slopes = 1.0 / torch.pow(2.0, m)
    if ceil_pow2 != n_heads:
        # interleave: odd-indexed slopes first, then evens, truncated
        slopes = torch.cat([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes


def alibi_bias(n_heads: int, seq_len: int, alibi_bias_max: int = 8,
               device=None) -> torch.Tensor:
    """[1, H, 1, S] key-position bias (reference modeling_mpt.py:88-143 form)."""
    slopes = alibi_slopes(n_heads, alibi_bias_max, device)
    dist = torch.arange(1 - seq_len, 1, dtype=torch.float32, device=device)
    return (slopes[:, None] * dist[None, :])[None, :, None, :]


def _ln(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def _dense(x: torch.Tensor, p: Params, layer: Optional[int] = None, route=None) -> torch.Tensor:
    if "scale" in p or "packed" in p or "packed_tiles" in p or "lora_a" in p:
        # int8 / packed int4 / LoRA leaves: llama's projection dispatch
        # covers every quantized layout; `route` [B, A] mixes
        # adapter-stacked multi-LoRA leaves per row
        y = llama_mod._proj(x, p, layer, route)
    else:
        y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _query_mask(write_slots: torch.Tensor, t_max: int, kv_mask=None, kv_len=None):
    """[B, S, T] bool: `slot <= q_slot & kv_mask & slot < kv_len`, on the device."""
    slots = torch.arange(t_max, device=write_slots.device)[None, None, :]
    mask = slots <= write_slots[:, :, None]
    if kv_mask is not None:
        mask = mask & kv_mask.bool()[:, None, :]
    if kv_len is not None:
        cap = kv_len if kv_len.ndim == 2 else kv_len[:, None]
        mask = mask & (slots < cap[:, :, None])
    return mask


def _mpt_layer(x, lp, cfg, bias, layer: int, cache, mask, write_slots, query_mask,
               row_offset: int = 0, spec_verify: bool = False, prefill_start: int = 0,
               attend_cache: bool = False, route=None, attn_impl: str = "auto",
               right_padded: bool = False, sh=None) -> torch.Tensor:
    """One block. `bias` is the [H, T] ALiBi table; `mask` the cache-free
    padding mask [B, S] (right padding where `right_padded`); `query_mask`
    [B, S, T_max] what a cached query reading the slab attends. On the mesh
    (`sh`) the block's fsdp shards are gathered here, the heads split over
    `model` take their own rows of the table."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    n_kv = cfg.num_kv_heads
    if sh is not None:
        lp = sh.gather(lp, "llm/layers", lead=1)
    split = sh is not None and sh.splits("attn")
    split_mlp = sh is not None and sh.splits("mlp")

    y = _ln(x, lp["norm1"])
    wqkv = lp["wqkv"]
    if split:  # this rank's heads: [its q | its k | its v] columns of wqkv
        h, n_kv, d = h // sh.m, n_kv // sh.m, d // sh.m
        bias = bias[sh.model_rank * h:(sh.model_rank + 1) * h]
        y, wqkv = sh.to_model(y), sh.col(wqkv)
    qkv = _dense(y, wqkv, layer, route)  # [B, S, D + 2 n_kv hd]
    q = qkv[..., :d].reshape(b, s, h, hd)
    k = qkv[..., d:d + n_kv * hd].reshape(b, s, n_kv, hd)
    v = qkv[..., d + n_kv * hd:].reshape(b, s, n_kv, hd)

    if cache is None:
        # the differentiable flash path with the table riding in-kernel
        # where the mask may be dropped, else the plain masked attention
        out = dot_product_attention(q, k, v, causal=True, mask=mask, bias_k=bias[:, :s],
                                    impl=attn_impl, right_padded=right_padded or mask is None)
    else:
        # this batch's rows of the layer's slab, [B, T, Hkv, D] views
        k_slab = cache.k[layer, row_offset:row_offset + b]
        v_slab = cache.v[layer, row_offset:row_offset + b]
        if s > 1 and not spec_verify:
            # a contiguous right-padded panel at prefill_start
            k_slab[:, prefill_start:prefill_start + s] = k.to(cache.dtype)
            v_slab[:, prefill_start:prefill_start + s] = v.to(cache.dtype)
        else:
            # per-row scatter writes at each token's slot
            rows = torch.arange(b, device=x.device)[:, None]
            slots = write_slots.long()
            k_slab[rows, slots] = k.to(cache.dtype)
            v_slab[rows, slots] = v.to(cache.dtype)
        if s > 1 and not spec_verify and not attend_cache:
            # causal attention over the fresh K / V: K1 with its bias on the card
            out = dot_product_attention(q, k, v, causal=True, bias_k=bias[:, :s],
                                        impl=attn_impl)
        else:
            t_max = k_slab.shape[1]
            out = dot_product_attention(q, k_slab.to(q.dtype), v_slab.to(q.dtype),
                                        mask=query_mask, bias_k=bias[:, :t_max], impl="plain")
    if split:
        x = x + sh.row_proj(out.reshape(b, s, d), lp["out_proj"])
    else:
        x = x + _dense(out.reshape(b, s, d), lp["out_proj"], layer, route)

    y = _ln(x, lp["norm2"])
    if split_mlp:
        y = F.gelu(_dense(sh.to_model(y), sh.col(lp["up_proj"]), layer, route))
        return x + sh.row_proj(y, lp["down_proj"])
    y = _dense(F.gelu(_dense(y, lp["up_proj"], layer, route)), lp["down_proj"], layer, route)
    return x + y


def _check_supported(cfg, cache, b: int, row_offset: int, sharded=None) -> None:
    if sharded is not None and cache is not None:
        raise unported("a KV cache on a mesh (sharded generate, sessions, the engine)", 16)
    if cache is not None and not 0 <= row_offset <= cache.k.shape[1] - b:
        raise ValueError(f"mpt_forward: rows [{row_offset}, {row_offset + b}) "
                         f"outside a cache of {cache.k.shape[1]} rows")
    if cfg.cache_sequence_axis is not None:
        raise unported("mpt_forward: cache_sequence_axis (sharded cache)", 16)


def mpt_forward(
    params: Params,
    cfg,
    inputs_embeds: torch.Tensor,
    *,
    attention_mask: Optional[torch.Tensor] = None,
    cache: Optional[llama_mod.KVCache] = None,
    write_slots: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    logits_mode: str = "all",  # all | last | none
    last_index: Optional[torch.Tensor] = None,
    remat: bool = False,
    cache_row_offset: int = 0,
    spec_verify: bool = False,
    prefill_start: int = 0,
    attend_cache: bool = False,
    kv_len: Optional[torch.Tensor] = None,
    adapter_route: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",  # auto | plain
    right_padded: bool = False,
    sharded=None,
) -> torch.Tensor:
    """Run the MPT stack with llama_forward's cache contract; returns fp32
    logits [B, S|1, V] (the tied `wte` head, times `cfg.logit_scale`), or
    with logits_mode 'none' the final norm's output [B, S, D].

    write_slots [B, S] is each token's cache slot (the slot a cached query
    attends up to), kv_mask [B, T_max] and kv_len [B] or [B, S] bound what a
    decode / spec_verify / attend_cache query attends; `spec_verify` runs an
    S > 1 block as S decode steps (scatter writes, attention over the
    slab); `attend_cache` makes an S > 1 prefill written at `prefill_start`
    attend the cache; the cached path runs on rows [cache_row_offset,
    cache_row_offset + B). ALiBi takes the place of position ids. Cache-free
    (`cache=None`): `attention_mask` [B, S] marks valid tokens,
    `right_padded` says they are all on the left (the training plan), so the
    flash kernels may drop the mask, and `remat` recomputes each block in the
    backward. `attn_impl` 'plain' routes every attention to the plain
    version (the kernel's reference). `sharded` runs the cache-free stack
    on the mesh as llama_forward's does (the tied `wte` vocab-sharded), and
    with `cfg.pipeline_axis` as a GPipe pipeline over its `pipe` axis."""
    x = inputs_embeds
    b, s, _ = x.shape
    _check_supported(cfg, cache, b, cache_row_offset, sharded)
    t_bias = cache.max_len if cache is not None else s
    # key-separable [H, T] form: the flash kernel's per-key add, the plain
    # path's [1, H, 1, T] broadcast
    bias = alibi_bias(cfg.n_heads, t_bias, cfg.alibi_bias_max, x.device)[0, :, 0, :]
    mask = None if attention_mask is None else attention_mask.bool()
    query_mask = None
    if cache is not None and (s == 1 or spec_verify or attend_cache):
        query_mask = _query_mask(write_slots, cache.max_len, kv_mask, kv_len)
    if cache is None and cfg.pipeline_axis is not None:
        # GPipe over the stacked layer axis (parallel/pipeline.py): the ALiBi
        # table closes over the block, only the padding mask travels
        llama_mod.check_pipeline(cfg, adapter_route)
        from teochat_torch.parallel.pipeline import pipelined_scan_blocks

        def block_fn(xc, lp, layer, mask_b):
            args = (xc, lp, cfg, bias, layer, None, mask_b, None, None, 0, False, 0, False,
                    None, attn_impl, right_padded, sharded)
            if remat:
                return checkpoint(_mpt_layer, *args, use_reentrant=False)
            return _mpt_layer(*args)

        x = pipelined_scan_blocks(params["layers"], block_fn, x, (mask,), sharded=sharded,
                                  num_layers=cfg.n_layers,
                                  num_microbatches=cfg.pipeline_microbatches)
    else:
        for layer, lp in enumerate(llama_mod.unstack_layers(params["layers"], cfg.n_layers)):
            args = (x, lp, cfg, bias, layer, cache, mask, write_slots, query_mask,
                    cache_row_offset, spec_verify, prefill_start, attend_cache, adapter_route,
                    attn_impl, right_padded, sharded)
            if remat and cache is None:
                x = checkpoint(_mpt_layer, *args, use_reentrant=False)
            else:
                x = _mpt_layer(*args)
    x = _ln(x, params["final_norm"])
    if sharded is not None:
        if logits_mode != "all" or last_index is not None:
            raise ValueError("mpt_forward on a mesh: training's logits_mode 'all' only")
        table = sharded.gather(params["wte"]["embedding"], "llm/wte/embedding")
        logits = llama_mod.vocab_logits(x, None, table, sharded)
        return logits * cfg.logit_scale if cfg.logit_scale is not None else logits

    if logits_mode == "none":
        return x
    if logits_mode == "last":
        if last_index is None:
            x = x[:, -1:]
        else:
            x = x[torch.arange(b, device=x.device), last_index.long()][:, None]
    elif logits_mode != "all":
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    # tied embeddings (MPT SharedEmbedding)
    logits = matmul_fp32(x, params["wte"]["embedding"].to(x.dtype).T)
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    return logits


def mpt_embed(params: Params, input_ids: torch.Tensor, dtype=None) -> torch.Tensor:
    emb = params["wte"]["embedding"]
    if dtype is not None:
        emb = emb.to(dtype)
    return emb[input_ids]


def adapt_tokenizer_for_denoising(tokenizer) -> None:
    """Add <extra_id_0..99> sentinels and a <pad> token for MPT
    mixture-of-denoiser training (reference mpt/adapt_tokenizer.py:6-23).
    Idempotent: add_tokens skips existing entries. Sets
    ``tokenizer.sentinel_token_ids`` like the reference."""
    sentinels = [f"<extra_id_{i}>" for i in range(NUM_SENTINEL_TOKENS)]
    tokenizer.add_tokens(sentinels, special_tokens=True)
    if getattr(tokenizer, "pad_token", None) is None:
        tokenizer.add_tokens("<pad>", special_tokens=True)
        tokenizer.pad_token = "<pad>"
        assert tokenizer.pad_token_id is not None
    joined = "".join(sentinels)
    tokenizer.sentinel_token_ids = tokenizer(joined, add_special_tokens=False).input_ids


def init_mpt(generator: torch.Generator, cfg, dtype: torch.dtype = torch.float32,
             device=None) -> Params:
    """Random MPT params on `device` (None = the card), drawn from
    `generator`: a named scheme of the reference's registry when
    `cfg.init_config` is set (models/mpt_init.py), else every kernel
    N(0, 0.02), norms ones, biases zeros (the JAX `init_mpt`)."""
    device = resolve_device(device)
    if cfg.init_config is not None:
        from teochat_torch.models.mpt_init import init_mpt_params

        return init_mpt_params(generator, cfg, dtype=dtype, device=device)
    from teochat_torch.checkpoint.bridge import init_mpt as draw

    return draw(cfg, generator, device, dtype, quant=None)


def convert_hf_mpt(sd, cfg, prefix: str = "transformer.") -> Params:
    """HF MptForCausalLM state_dict -> params tree (stacked layers), host
    tensors in the checkpoint's dtype, norm scales fp32."""
    from teochat_torch.checkpoint.convert_hf import _host, _stack

    L, p = cfg.n_layers, prefix

    def stack(fmt, transpose=False):
        return _stack(sd, fmt, L, transpose)

    return {
        "wte": {"embedding": _host(sd[f"{p}wte.weight"])},
        "layers": {
            "norm1": {"scale": stack(f"{p}blocks.{{i}}.norm_1.weight").float()},
            "wqkv": {"kernel": stack(f"{p}blocks.{{i}}.attn.Wqkv.weight", True)},
            "out_proj": {"kernel": stack(f"{p}blocks.{{i}}.attn.out_proj.weight", True)},
            "norm2": {"scale": stack(f"{p}blocks.{{i}}.norm_2.weight").float()},
            "up_proj": {"kernel": stack(f"{p}blocks.{{i}}.ffn.up_proj.weight", True)},
            "down_proj": {"kernel": stack(f"{p}blocks.{{i}}.ffn.down_proj.weight", True)},
        },
        "final_norm": {"scale": _host(sd[f"{p}norm_f.weight"]).float()},
    }
