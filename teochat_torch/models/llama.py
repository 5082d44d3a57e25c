"""LLaMA-2 decoder (port of teochat_tpu/models/llama.py).

Params keep the JAX layout: stacked per-layer tensors (`[L, ...]`), kernels
`[in, out]`, int8 projections as {'kernel' int8, 'scale' fp32 [out]}
(w8a16, or w8a8 in an S > 1 block with `cfg.int8_prefill_activations`:
per-token int8 activations, ops/quant.py::quantized_proj_act_i8), int4
projections as {'packed_tiles' | 'packed', 'scale'} (ops/quant.py), optionally
fused into 'qkv' and 'gateup' leaves, LoRA
adapters as extra leaves of a projection ('lora_a' [L, in, r], 'lora_b'
[L, r, out], 'lora_scale' [L], fp32 masters), or adapter-stacked for
multi-LoRA serving ('lora_a' [L, A, in, r], 'lora_b' [L, A, r, out],
'lora_scale' [L, A]: train/lora.py::stack_lora_adapters), which the
forward's `adapter_route` [B, A] mixes per batch row. An lm_head's adapter
is added to the fp32 logits (the JAX forward reads only the head's kernel:
ROADMAP F6).

The cache-free forward (`cache=None`, training) runs causal self-attention
over the whole sequence: a right-padded batch on CUDA goes to the
differentiable flash kernels (K4a-c) with the padding mask dropped, other
cases to the plain masked attention. On a mesh, `LlamaConfig.sequence_axis`
runs it as ring attention over this rank's chunk of the sequence, and
`pipeline_axis` runs the layer stack as a GPipe pipeline (parallel/).
`remat=True` wraps each decoder layer in a non-reentrant
`torch.utils.checkpoint` (the JAX `jax.checkpoint(..., nothing_saveable)`),
so its activations are recomputed in the backward.

The KV cache is two buffers K and V of shape [L, B, T_max, Hkv, D]. Unlike
the JAX package, which is functional and threads new buffers through its
loops, this port UPDATES THE BUFFERS IN PLACE: a prefill writes its
contiguous [B, S] panel at slot `prefill_start`, a decode step writes one
slot per row at `write_slots`. Prefill attends over the fresh K/V through
the flash kernel (right-padded causal prompts need no mask); decode attends
the layer's cache slab in place through the decode kernel (K2) with
`lengths = min(q_slot + 1, kv_len)`, which equals the JAX mask
`slot <= q_slot & kv_mask` because each row's slots are contiguous and
kv_mask is a prefix of each row (`ops/decode_attention.py::query_lengths`).
`spec_verify` treats an S > 1 block as S decode steps: each row scatters its
writes at `write_slots`, then the block's queries attend the cache slab
through K2m, the decode kernel's multi-query form. `attend_cache` makes an
S > 1 prefill write its panel at `prefill_start` and then attend the row's
cache through K2m, each query up to its own slot (a chunked prefill's later
pieces, a prefix-cache hit's suffix: serve/engine.py). `cache_row_offset`
runs a B-row forward over rows [offset, offset + B) of a cache that holds
more rows, as views of each layer's slab (never a copy), and `kv_len` [B]
or [B, S] caps each query's live length from the device
(`slot <= q_slot & slot < kv_len`, with no host read). A session's suffix
prefill runs this way over its committed conversation, and so does each
verify block of the speculative loop (generation.py::_spec_iteration),
with no kv_mask: JAX's `slot <= pos0 + k` there holds for every query's
slot already, so K2m's lengths are q_slot + 1 and nothing is read back.

The cache is in the model's dtype or in fp8 e4m3 (the JAX package's
`kv_dtype="float8_e4m3fn"`, half the bytes). Each write casts K and V to
the cache's dtype once, as the JAX package does (torch's cast saturates to
±448 where JAX's gives NaN at |x| >= 464: ROADMAP F5), and K2 / K2m read an
e4m3 slab in place, upcasting inside; the prefill over fresh K/V attends
them in the model's dtype.

A decode step reads nothing back to the host: `write_slots`, `lengths`, the
rows' cache indices and the RoPE positions stay device tensors, no shape or
allocation depends on their values, and the int4 layer index is the Python
loop's. So generation.py can capture the step in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from teochat_torch.config import LlamaConfig
from teochat_torch.ops.attention import dot_product_attention
from teochat_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_multi,
    query_lengths,
)
from teochat_torch.ops.quant import (
    int4_proj,
    matmul_fp32,
    quantized_proj,
    quantized_proj_act_i8,
)
from teochat_torch.utils import resolve_device, unported

Params = Dict


def kv_dtype_of(kv_dtype, default: torch.dtype) -> torch.dtype:
    """The cache's dtype from `kv_dtype`: None or `default` (the model's
    dtype), or float8_e4m3fn, by name or as a torch dtype; any other raises."""
    if kv_dtype is None:
        return default
    named = getattr(torch, kv_dtype, None) if isinstance(kv_dtype, str) else kv_dtype
    if named not in (default, torch.float8_e4m3fn):
        raise ValueError(f"kv_dtype {kv_dtype!r}: the cache is in the model's dtype "
                         f"({default}) or float8_e4m3fn")
    return named


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
    """Zeroed cache buffers on `device` (None = the card, see resolve_device),
    in `dtype` (e.g. torch.float8_e4m3fn)."""
    device = resolve_device(device)
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


def _is_int4(p: Params) -> bool:
    return "packed" in p or "packed_tiles" in p


def _lora_delta(x: torch.Tensor, p: Params, route: Optional[torch.Tensor]) -> torch.Tensor:
    """The adapter's fp32 delta on x [B, S, in] (train/lora.py), scale and
    route applied: x a rounded to x's dtype, times b as an fp32 sum, the
    fp32 masters cast to x's dtype first, as the JAX package does.

    Adapter-stacked leaves (a [A, in, r], b [A, r, out], scale [A]) are
    mixed per row by `route` [B, A]: the adapter axis unrolls, each adapter
    runs the single-adapter chain and is weighted per row in fp32 by route *
    scale, and the weighted deltas are summed in fp32. A zero weight adds
    an exact zero, so a one-hot row is BITWISE the single-adapter model and
    an all-zero row the base model. (JAX measured a fused [B, A] contraction
    to flip near-tie greedy tokens across batch sizes.)"""
    a, b = p["lora_a"].to(x.dtype), p["lora_b"].to(x.dtype)
    scale = p["lora_scale"].detach().float()
    if a.ndim == 2:
        return matmul_fp32(torch.matmul(x, a), b) * scale
    if route is None:
        raise ValueError("params carry adapter-stacked LoRA leaves (multi-LoRA) "
                         "but no adapter_route was passed to the forward")
    w = route.float() * scale[None, :]  # [B, A]
    delta = None
    for i in range(a.shape[0]):
        d_i = matmul_fp32(torch.matmul(x, a[i]), b[i]) * w[:, i, None, None]
        delta = d_i if delta is None else delta + d_i
    return delta


def _proj(x: torch.Tensor, p: Params, layer: Optional[int] = None,
          route: Optional[torch.Tensor] = None, act_quant: bool = False) -> torch.Tensor:
    if _is_int4(p):  # int4 w4a16 (act_quant ignored); `layer` picks from the stack
        y = int4_proj(x, p, layer)
    elif "scale" in p and act_quant:  # w8a8: per-token int8 activations
        y = quantized_proj_act_i8(x, p)
    elif "scale" in p:  # int8 weight-only
        y = quantized_proj(x, p)
    else:
        y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "lora_a" in p:  # LoRA adapter: the fp32 delta rounded once to x's dtype
        y = y + _lora_delta(x, p, route).to(x.dtype)
    return y


def _mlp(x: torch.Tensor, lp: Params, layer: Optional[int] = None,
         route: Optional[torch.Tensor] = None, act_quant: bool = False,
         sh=None) -> torch.Tensor:
    split = sh is not None and sh.splits("mlp")
    if split:  # this rank's gate / up columns, its rows of down
        x = sh.to_model(x)
        lp = {k: sh.col(v) if k != "down" else v for k, v in lp.items()}
    if "gateup" in lp:  # fused gate|up (ops/quant.py fuse_projections; per rank on a mesh)
        gu = _proj(x, lp["gateup"], layer, route, act_quant)
        i_sz = gu.shape[-1] // 2
        gate_in, up = gu[..., :i_sz], gu[..., i_sz:]
    else:
        gate_in = _proj(x, lp["gate"], layer, route, act_quant)
        up = _proj(x, lp["up"], layer, route, act_quant)
    gate = F.silu(gate_in.float()).to(x.dtype)
    if split:
        return sh.row_proj(gate * up, lp["down"])
    return _proj(gate * up, lp["down"], layer, route, act_quant)


def _attention_layer(x, lp, cfg: LlamaConfig, cos, sin, cache: Optional[KVCache],
                     layer: int, write_slots, prefill_start: int, attn_impl: str,
                     attention_mask=None, right_padded: bool = False, lengths=None,
                     spec_verify: bool = False, row_offset: int = 0,
                     attend_cache: bool = False, route=None,
                     act_quant: bool = False, sh=None) -> torch.Tensor:
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    split = sh is not None and sh.splits("attn")
    if split:  # this model rank's heads: its q heads and their kv heads
        h, hkv = h // sh.m, hkv // sh.m
        x = sh.to_model(x)
        lp = {k: sh.col(v) if k != "out" else v for k, v in lp.items()}
    if "qkv" in lp:
        # fused q|k|v projection (ops/quant.py fuse_projections): one weight
        # read and one launch instead of three
        fused = _proj(x, lp["qkv"], layer, route, act_quant)
        q = fused[..., : h * hd]
        k = fused[..., h * hd: (h + hkv) * hd]
        v = fused[..., (h + hkv) * hd:]
    else:
        q, k, v = (_proj(x, lp[n], layer, route, act_quant) for n in ("q", "k", "v"))
    q = apply_rope(q.reshape(b, s, h, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, hkv, hd), cos, sin)
    v = v.reshape(b, s, hkv, hd)
    if cache is None:
        if cfg.sequence_axis is not None:
            # context parallelism: x is this rank's chunk of S, and the key /
            # value blocks rotate around the `sequence` ring (K4a-c on the
            # card). Right-padded batches only: causality hides the pads.
            if not (right_padded or attention_mask is None):
                raise ValueError("sequence_axis needs right-padded batches (causal-only "
                                 "masking); got a padding mask without right_padded=True")
            from teochat_torch.parallel.ring_attention import ring_self_attention

            out = ring_self_attention(q, k, v, sharded=sh, axis_name=cfg.sequence_axis,
                                      causal=True, impl=attn_impl)
        else:
            # causal self-attention over S, plus the padding mask (which the
            # flash kernels drop for a right-padded batch)
            out = dot_product_attention(q, k, v, causal=True, mask=attention_mask,
                                        impl=attn_impl, right_padded=right_padded)
        if split:
            return sh.row_proj(out.reshape(b, s, h * hd), lp["out"])
        return _proj(out.reshape(b, s, h * hd), lp["out"], layer, route, act_quant)
    # this batch's rows of the layer's slab, [B, T, Hkv, D] views
    k_slab = cache.k[layer, row_offset:row_offset + b]
    v_slab = cache.v[layer, row_offset:row_offset + b]
    if s > 1 and not spec_verify:
        # prefill: one contiguous panel at prefill_start
        k_slab[:, prefill_start:prefill_start + s] = k.to(cache.dtype)
        v_slab[:, prefill_start:prefill_start + s] = v.to(cache.dtype)
        if attend_cache:  # each query over the row's cache up to its own slot
            out = decode_attention_multi(q, k_slab.transpose(1, 2), v_slab.transpose(1, 2),
                                         lengths, impl=attn_impl)
        else:
            # causal attention over the fresh K/V equals attention over the
            # cache, since the prompt starts at slot 0
            out = dot_product_attention(q, k, v, causal=True, impl=attn_impl)
    elif s == 1:
        rows = torch.arange(b, device=x.device)
        slots = write_slots[:, 0].long()
        k_slab[rows, slots] = k[:, 0].to(cache.dtype)
        v_slab[rows, slots] = v[:, 0].to(cache.dtype)
        out = decode_attention(q[:, 0], k_slab.transpose(1, 2), v_slab.transpose(1, 2),
                               lengths[:, 0], impl=attn_impl)[:, None]
    else:
        # spec_verify: each row's writes at its slots (padded queries all at
        # the trash slot, never attended), then every query over the slab
        rows = torch.arange(b, device=x.device)[:, None]
        slots = write_slots.long()
        k_slab[rows, slots] = k.to(cache.dtype)
        v_slab[rows, slots] = v.to(cache.dtype)
        out = decode_attention_multi(q, k_slab.transpose(1, 2), v_slab.transpose(1, 2),
                                     lengths, impl=attn_impl)
    return _proj(out.reshape(b, s, h * hd), lp["out"], layer, route, act_quant)


def _decoder_layer(x, lp, cfg: LlamaConfig, cos, sin, cache, layer, write_slots,
                   prefill_start, attn_impl, attention_mask, right_padded, lengths=None,
                   spec_verify=False, row_offset=0, attend_cache=False,
                   route=None, act_quant=False, sh=None) -> torch.Tensor:
    if sh is not None:  # the layer's fsdp shards gathered at use (inside remat)
        lp = sh.gather(lp, "llm/layers", lead=1)
    y = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps)
    x = x + _attention_layer(y, lp["attn"], cfg, cos, sin, cache, layer, write_slots,
                             prefill_start, attn_impl, attention_mask, right_padded,
                             lengths, spec_verify, row_offset, attend_cache, route,
                             act_quant, sh)
    y = rms_norm(x, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps)
    return x + _mlp(y, lp["mlp"], layer, route, act_quant, sh)


def unstack_layers(tree, n_layers: int):
    """A stacked params tree -> one tree per layer (views). `unbind` gives a
    trainable [L, ...] leaf one gradient stack in the backward, where
    indexing each layer would add a full-size zero tensor per layer.

    An int4 group keeps its `packed` / `packed_tiles` and `scale` leaves
    stacked in every layer's tree (the JAX cached forward does the same):
    `_proj` hands them to `int4_proj` with the layer index, and the kernel
    reads that layer's bytes out of the whole buffer. Its other leaves (LoRA)
    are split like everything else."""
    if isinstance(tree, dict):
        whole = ("packed", "packed_tiles", "scale") if _is_int4(tree) else ()
        stacked = {k: v for k, v in tree.items() if k in whole}
        per_key = {k: unstack_layers(v, n_layers) for k, v in tree.items() if k not in whole}
        return [{**stacked, **{k: v[i] for k, v in per_key.items()}} for i in range(n_layers)]
    return tree.unbind(0)


def embed_tokens(params: Params, input_ids: torch.Tensor, dtype=None) -> torch.Tensor:
    emb = params["embed_tokens"]["embedding"]
    if dtype is not None:
        emb = emb.to(dtype)
    return emb[input_ids]


def _check_supported(cfg: LlamaConfig, cache: Optional[KVCache], b: int,
                     row_offset: int, sharded=None) -> None:
    if sharded is not None and cache is not None:
        raise unported("a KV cache on a mesh (sharded generate, sessions, the engine)", 16)
    if cache is not None and not 0 <= row_offset <= cache.k.shape[1] - b:
        raise ValueError(f"llama_forward: rows [{row_offset}, {row_offset + b}) "
                         f"outside a cache of {cache.k.shape[1]} rows")
    if cfg.cache_sequence_axis is not None:
        raise unported("llama_forward: cache_sequence_axis (sharded cache)", 16)


def check_pipeline(cfg, adapter_route) -> None:
    """JAX's errors for a pipelined forward (`cfg.pipeline_axis`)."""
    if getattr(cfg, "sequence_axis", None) is not None:
        raise ValueError("pipeline_axis and sequence_axis cannot be combined "
                         "(ring attention inside a pipeline stage nests shard_maps)")
    if adapter_route is not None:
        raise ValueError("adapter_route (multi-LoRA) is a serving feature and does not "
                         "compose with pipeline_axis (the route would have to travel with "
                         "each microbatch); merge or route on the host")


def vocab_logits(x: torch.Tensor, head: Optional[Params], table: Optional[torch.Tensor],
                 sh) -> torch.Tensor:
    """fp32 logits [..., V] on the mesh from the vocab-sharded lm_head
    (`head`, its fsdp dim gathered) or tied table [V/m, D]: x enters by
    to_model, each rank takes its vocabulary's columns, and the columns are
    all-gathered over `model` (the cross-entropy then sees the whole
    vocabulary, F1)."""
    split = sh.splits("vocab")
    if split:
        x = sh.to_model(x)
    if head is None:
        logits = matmul_fp32(x, table.to(x.dtype).T)
    elif "scale" in head:
        logits = quantized_proj(x, head, fp32_out=True)
    else:
        logits = matmul_fp32(x, head["kernel"].to(x.dtype))
    return sh.gather_model(logits, -1) if split else logits


def _sharded_head(params, cfg, x, sh, logits_mode, last_index):
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)
    if logits_mode != "all" or last_index is not None:
        raise ValueError("llama_forward on a mesh: training's logits_mode 'all' only")
    head = params.get("lm_head")
    if head is not None:
        return vocab_logits(x, sh.gather(head, "llm/lm_head"), None, sh)
    table = sh.gather(params["embed_tokens"]["embedding"], "llm/embed_tokens/embedding")
    return vocab_logits(x, None, table, sh)


def llama_forward(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    *,
    position_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    write_slots: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    logits_mode: str = "all",  # all | last | none
    last_index: Optional[torch.Tensor] = None,
    remat: bool = False,
    right_padded: bool = False,
    cache_row_offset: int = 0,
    prefill_start: int = 0,
    spec_verify: bool = False,
    attend_cache: bool = False,
    kv_len: Optional[torch.Tensor] = None,
    adapter_route: Optional[torch.Tensor] = None,
    act_quant_ok: Optional[bool] = None,
    attn_impl: str = "auto",  # auto | plain
    sharded=None,
) -> torch.Tensor:
    """Run the decoder stack; returns fp32 logits [B, S|1, V], or with
    logits_mode 'none' the final norm's output [B, S, D] (no lm_head).

    inputs_embeds [B, S, D]; position_ids [B, S] RoPE positions.
    Cached path: write_slots [B, S] is the cache slot of each token (the slot
    a decode query attends up to); S > 1 is a prefill, S == 1 a decode step.
    kv_mask [B, T_max], a prefix of each row, bounds what a decode or
    spec_verify query attends (`slot <= q_slot & kv_mask`); the prefill
    ignores it, as in the JAX package. Without one a query attends `slot <=
    q_slot` and no host read is made (a CUDA graph can hold the forward).
    `spec_verify` runs an S > 1 block as S decode steps: writes at
    `write_slots`, attention over the cache (K2m). `attend_cache` makes an
    S > 1 prefill (its panel written at `prefill_start`) attend the cache
    through K2m, query s up to its slot write_slots[:, s]. The cached path
    runs on rows [cache_row_offset, cache_row_offset + B) of the cache.
    `kv_len` [B] or [B, S] int32 caps each decode / spec_verify /
    attend_cache query's live length on the device (the JAX mask
    `slot < kv_len`).
    `adapter_route` [B, A] mixes adapter-stacked LoRA leaves per row
    (train/lora.py::adapter_route; required with such leaves, which raise
    without it).
    `cfg.int8_prefill_activations` runs the int8 projections of an S > 1
    block as w8a8 (`quantized_proj_act_i8`) where `act_quant_ok` allows it;
    it defaults to `not spec_verify`, so a speculative verify block keeps
    bf16 activations and the plain decode's numerics (a session's suffix
    prefill passes True). Decode (S = 1), int4 and float leaves and the
    lm_head stay as they are.
    Cache-free path (`cache=None`, training): `attention_mask` [B, S] marks
    the valid tokens, `right_padded` says the padding is all on the right,
    `remat` recomputes each layer in the backward. `last_index` [B] picks
    each row's position for logits_mode='last'. `attn_impl` 'plain' routes
    every attention to its plain twin (the kernels' reference).
    `sharded` (parallel/tensor_parallel.py::Sharded; cache-free only) runs
    the stack on the mesh: `params` are this rank's local shards, each
    layer's gathered over `fsdp` at use, its heads and MLP columns split
    over `model`; the logits come back whole (fp32, all-gathered over
    `model` from the vocab-sharded head). With `cfg.sequence_axis` the
    inputs (`inputs_embeds`, `position_ids`: global positions, and
    `attention_mask`) are this rank's chunk of S on the mesh's `sequence`
    axis, attention runs the ring (parallel/ring_attention.py) and the
    logits are the chunk's. With `cfg.pipeline_axis` the layers run as a
    GPipe pipeline over the mesh's `pipe` axis
    (parallel/pipeline.py::pipelined_scan_blocks, `params["layers"]` this
    stage's), and every pipe rank gets the whole output.
    """
    x = inputs_embeds
    b, s, _ = x.shape
    _check_supported(cfg, cache, b, cache_row_offset, sharded)
    if act_quant_ok is None:
        act_quant_ok = not spec_verify
    act_quant = bool(cfg.int8_prefill_activations) and s > 1 and act_quant_ok
    cos, sin = rope_tables(position_ids, cfg.head_dim, cfg.rope_theta)
    mask = None if attention_mask is None else attention_mask.bool()
    # the live length of each query that reads the cache, once for all layers
    lengths = None
    if cache is not None and (s == 1 or spec_verify or attend_cache):
        lengths = query_lengths(write_slots, kv_mask)
        if kv_len is not None:
            cap = kv_len if kv_len.ndim == 2 else kv_len[:, None]
            lengths = torch.minimum(lengths, cap.to(torch.int32))
    if cache is None and cfg.pipeline_axis is not None:
        # GPipe over the stacked layer axis (parallel/pipeline.py): this
        # stage's layers; cos, sin and the mask travel with their microbatch
        check_pipeline(cfg, adapter_route)
        from teochat_torch.parallel.pipeline import pipelined_scan_blocks

        def block_fn(xc, lp, layer, cos_b, sin_b, mask_b):
            args = (xc, lp, cfg, cos_b, sin_b, None, layer, None, 0, attn_impl, mask_b,
                    right_padded, None, False, 0, False, None, act_quant, sharded)
            if remat:
                return checkpoint(_decoder_layer, *args, use_reentrant=False)
            return _decoder_layer(*args)

        x = pipelined_scan_blocks(params["layers"], block_fn, x, (cos, sin, mask),
                                  sharded=sharded, num_layers=cfg.num_layers,
                                  num_microbatches=cfg.pipeline_microbatches)
    else:
        for layer, lp in enumerate(unstack_layers(params["layers"], cfg.num_layers)):
            args = (x, lp, cfg, cos, sin, cache, layer, write_slots, prefill_start,
                    attn_impl, mask, right_padded, lengths, spec_verify, cache_row_offset,
                    attend_cache, adapter_route, act_quant, sharded)
            if remat and cache is None:
                x = checkpoint(_decoder_layer, *args, use_reentrant=False)
            else:
                x = _decoder_layer(*args)
    if sharded is not None:
        return _sharded_head(params, cfg, x, sharded, logits_mode, last_index)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)

    if logits_mode == "none":
        return x
    if logits_mode == "last":
        if last_index is None:
            x = x[:, -1:]
        else:
            x = x[torch.arange(b, device=x.device), last_index.long()][:, None]
    elif logits_mode != "all":
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    head = params.get("lm_head")
    if head is None:  # tied embeddings
        return matmul_fp32(x, params["embed_tokens"]["embedding"].to(x.dtype).T)
    if _is_int4(head):  # int4 lm_head: the product in x's dtype, fp32 logits
        logits = int4_proj(x, head).float()
    elif "scale" in head:  # int8 weight-only lm_head
        logits = quantized_proj(x, head, fp32_out=True)
    else:
        logits = matmul_fp32(x, head["kernel"].to(x.dtype))  # the fp32 sum, not a rounded product
    if "lora_a" in head:  # the head's adapter, on the fp32 logits (ROADMAP F6)
        logits = logits + _lora_delta(x, head, adapter_route)
    return logits
