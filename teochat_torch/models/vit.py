"""CLIP ViT vision tower (port of teochat_tpu/models/vit.py).

Params keep the JAX layout: stacked per-layer tensors under `layers`
(`[L, ...]`), dense kernels `[in, out]`. The layer loop runs only the prefix
that `select_layer` needs (select_layer = -2 runs 23 of 24 layers). Attention
is the plain masked attention (ops/attention.py), as the TPU path used XLA
here; the one-shot ViT attention kernel is later work.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from teochat_tpu.config import VisionConfig
from teochat_torch.ops.attention import plain_attention

Params = Dict


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACT = {"quick_gelu": quick_gelu, "gelu": _gelu_tanh}


def layer_index(tree, i: int):
    """Layer `i` of a stacked params tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_index(v, i) for k, v in tree.items()}
    return tree[i]


def _layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _attn_block(x: torch.Tensor, p: Params, cfg: VisionConfig) -> torch.Tensor:
    """CLIP bidirectional self-attention. x: [B, N, D]."""
    b, n, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = _dense(x, p["q"]).reshape(b, n, h, hd)
    k = _dense(x, p["k"]).reshape(b, n, h, hd)
    v = _dense(x, p["v"]).reshape(b, n, h, hd)
    out = plain_attention(q, k, v, causal=False)
    return _dense(out.reshape(b, n, h * hd), p["out"])


def _mlp_block(x: torch.Tensor, p: Params, cfg: VisionConfig) -> torch.Tensor:
    return _dense(ACT[cfg.hidden_act](_dense(x, p["fc1"])), p["fc2"])


def _encoder_layer(x: torch.Tensor, lp: Params, cfg: VisionConfig,
                   num_frames: int = 1) -> torch.Tensor:
    """One pre-LN CLIP layer; temporal attention first when configured.

    x: [(B*T), N, D] with T = num_frames when temporal attention is on.
    """
    if cfg.add_time_attn:
        bt, n, d = x.shape
        t = num_frames
        b = bt // t
        # (b t) n d -> (b n) t d
        xt = x.reshape(b, t, n, d).transpose(1, 2).reshape(b * n, t, d)
        if t != 1:
            xt = xt + lp["temporal_embedding"][:t].to(x.dtype)
        y = _layer_norm(xt, lp["temporal_ln"], cfg.layer_norm_eps)
        xt = xt + _attn_block(y, lp["temporal_attn"], cfg)
        # (b n) t d -> (b t) n d
        x = xt.reshape(b, n, t, d).transpose(1, 2).reshape(bt, n, d)

    x = x + _attn_block(_layer_norm(x, lp["ln1"], cfg.layer_norm_eps), lp["attn"], cfg)
    return x + _mlp_block(_layer_norm(x, lp["ln2"], cfg.layer_norm_eps), lp["mlp"], cfg)


def embed_patches(params: Params, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] -> [B, 1 + num_patches, D] (CLS + patches + positions + pre-LN)."""
    b = pixel_values.shape[0]
    p = cfg.patch_size
    gh, gw = cfg.grid
    # flatten each patch in (c, ph, pw) order, as the checkpoint converter
    # flattens the conv kernel
    x = pixel_values.reshape(b, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, gh * gw, 3 * p * p)
    x = torch.matmul(x, params["patch_embedding"]["kernel"].to(x.dtype))
    cls = params["class_embedding"].to(x.dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["position_embedding"].to(x.dtype)
    return _layer_norm(x, params["pre_layernorm"], cfg.layer_norm_eps)


def vit_forward(
    params: Params,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,
    *,
    select_layer: Optional[int] = None,
    num_frames: int = 1,
) -> torch.Tensor:
    """Hidden states at `select_layer`, before the post-layernorm.

    pixel_values: [B*T, 3, H, W] (frames folded into the batch). As in HF,
    hidden_states[select_layer] with -2 is the input of the last layer.
    """
    if select_layer is None:
        select_layer = cfg.select_layer
    k = cfg.num_layers + 1 + select_layer if select_layer < 0 else select_layer
    if not 0 <= k <= cfg.num_layers:
        raise ValueError(f"select_layer {select_layer} out of range")
    x = embed_patches(params, cfg, pixel_values)
    for i in range(k):
        x = _encoder_layer(x, layer_index(params["layers"], i), cfg, num_frames)
    return x


def select_features(hidden: torch.Tensor, feature: str = "patch") -> torch.Tensor:
    """'patch' drops CLS; 'cls_patch' keeps all."""
    if feature == "patch":
        return hidden[:, 1:]
    if feature == "cls_patch":
        return hidden
    raise ValueError(f"Unexpected select feature: {feature}")
