"""CLIP ViT vision tower (port of teochat_tpu/models/vit.py).

Params keep the JAX layout: stacked per-layer tensors under `layers`
(`[L, ...]`), dense kernels `[in, out]`. The layer loop runs only the prefix
that `select_layer` needs (select_layer = -2 runs 23 of 24 layers). The
spatial attention goes through `vit_attention` (ops/vit_attention.py: the
one-shot kernel on a CUDA tensor, the plain attention on a CPU tensor)
whenever the sequence is inside the JAX function's gate for its kernel
(64 <= S <= 1024); the temporal attention over a few frames, and shorter
or longer sequences, take the plain attention (ops/attention.py). A tower
that trains (a q, k or v that requires a gradient) attends through the
trainable flash path instead (`attend`): K5 has no backward. A tower
quantized by `ops/quant.py::quantize_vit_params` runs its projections w8a8
(per-token int8 activations on the int8 tensor cores, the bias added to the
rounded product as in the JAX function). `resize_position_embedding`
resamples the patch position table as `jax.image.resize(..., "bicubic")`
does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from teochat_torch.config import VisionConfig
from teochat_torch.ops.attention import plain_attention
from teochat_torch.ops.flash_attention import flash_attention_trainable
from teochat_torch.ops.quant import quantized_proj_act_i8
from teochat_torch.ops.vit_attention import in_kernel_range, vit_attention

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
    if "scale" in p:  # w8a8 (ops/quant.py::quantize_vit_params); the bias after
        y = quantized_proj_act_i8(x, p)
    else:
        y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The tower's bidirectional attention, by what the call needs: without
    a gradient (no tower leaf requires one, or grad is off) K5 inside its
    range; with one, the trainable flash path (K4a, K4b, K4c non-causal on
    the card; plain autograd on the CPU), since K5 has no backward; outside
    K5's range without a gradient, the plain attention."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        return flash_attention_trainable(q, k, v, causal=False)
    if in_kernel_range(q.shape[1]):
        return vit_attention(q, k, v)
    return plain_attention(q, k, v, causal=False)


def _attn_block(x: torch.Tensor, p: Params, cfg: VisionConfig, sh=None) -> torch.Tensor:
    """CLIP bidirectional self-attention. x: [B, N, D]. On the mesh (`sh`)
    with `model` splitting the heads: this rank's heads, q / k / v
    column-parallel, out row-parallel."""
    b, n, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    split = sh is not None and sh.splits("vit_attn")
    if split:
        h, x = h // sh.m, sh.to_model(x)
    q = _dense(x, p["q"]).reshape(b, n, h, hd)
    k = _dense(x, p["k"]).reshape(b, n, h, hd)
    v = _dense(x, p["v"]).reshape(b, n, h, hd)
    out = attend(q, k, v).reshape(b, n, h * hd)
    return sh.row_proj(out, p["out"]) if split else _dense(out, p["out"])


def _mlp_block(x: torch.Tensor, p: Params, cfg: VisionConfig, sh=None) -> torch.Tensor:
    if sh is not None and sh.splits("vit_mlp"):
        return sh.row_proj(ACT[cfg.hidden_act](_dense(sh.to_model(x), p["fc1"])), p["fc2"])
    return _dense(ACT[cfg.hidden_act](_dense(x, p["fc1"])), p["fc2"])


def _encoder_layer(x: torch.Tensor, lp: Params, cfg: VisionConfig,
                   num_frames: int = 1, sh=None) -> torch.Tensor:
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
        xt = xt + _attn_block(y, lp["temporal_attn"], cfg, sh)
        # (b n) t d -> (b t) n d
        x = xt.reshape(b, n, t, d).transpose(1, 2).reshape(bt, n, d)

    x = x + _attn_block(_layer_norm(x, lp["ln1"], cfg.layer_norm_eps), lp["attn"], cfg, sh)
    return x + _mlp_block(_layer_norm(x, lp["ln2"], cfg.layer_norm_eps), lp["mlp"], cfg, sh)


def embed_patches(params: Params, cfg: VisionConfig, pixel_values: torch.Tensor,
                  sh=None) -> torch.Tensor:
    """[B, 3, H, W] -> [B, 1 + num_patches, D] (CLS + patches + positions + pre-LN)."""
    if sh is not None:  # the patch kernel's and the positions' fsdp shards
        params = {**params, "patch_embedding": sh.gather(params["patch_embedding"],
                                                         "vision/patch_embedding"),
                  "position_embedding": sh.gather(params["position_embedding"],
                                                  "vision/position_embedding")}
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
    sharded=None,
) -> torch.Tensor:
    """Hidden states at `select_layer`, before the post-layernorm.

    pixel_values: [B*T, 3, H, W] (frames folded into the batch). As in HF,
    hidden_states[select_layer] with -2 is the input of the last layer.
    `sharded` (parallel/tensor_parallel.py::Sharded) runs the tower on the
    mesh: each layer's fsdp shards gathered at use, its heads and MLP
    columns split over `model`.
    """
    if select_layer is None:
        select_layer = cfg.select_layer
    k = cfg.num_layers + 1 + select_layer if select_layer < 0 else select_layer
    if not 0 <= k <= cfg.num_layers:
        raise ValueError(f"select_layer {select_layer} out of range")
    x = embed_patches(params, cfg, pixel_values, sharded)
    for i in range(k):
        lp = layer_index(params["layers"], i)
        if sharded is not None:
            lp = sharded.gather(lp, "vision/layers", lead=1)
        x = _encoder_layer(x, lp, cfg, num_frames, sharded)
    return x


def select_features(hidden: torch.Tensor, feature: str = "patch") -> torch.Tensor:
    """'patch' drops CLS; 'cls_patch' keeps all."""
    if feature == "patch":
        return hidden[:, 1:]
    if feature == "cls_patch":
        return hidden
    raise ValueError(f"Unexpected select feature: {feature}")


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 on |distance| (jax.image's)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] fp32 weights of jax.image.resize's bicubic along one
    axis (`scale_and_translate` with antialiasing): the kernel widened by
    the inverse scale when shrinking, each column normalised to sum 1, and
    zero where the sample falls outside the input."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = _keys_cubic(dist / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_position_embedding(pos: torch.Tensor, old_grid: int, new_grid: int) -> torch.Tensor:
    """Bicubic resampling of the patch position table [1 + old^2, D] to
    [1 + new^2, D] (reference modeling_video.py:800-846 `resize_pos`), as
    the JAX package's `jax.image.resize(method="bicubic")`; the CLS row is
    kept. Computed in fp32, returned in pos's dtype."""
    cls_row, patch = pos[:1], pos[1:]
    d = patch.shape[-1]
    grid = patch.float().reshape(old_grid, old_grid, d)
    w = _resize_weights(old_grid, new_grid).to(grid.device)
    resized = torch.einsum("hwd,hi,wj->ijd", grid, w, w)
    return torch.cat([cls_row, resized.reshape(new_grid * new_grid, d).to(pos.dtype)], dim=0)
