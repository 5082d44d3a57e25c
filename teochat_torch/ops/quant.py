"""Int8 weight-only quantization for the decoder.

Port of teochat_tpu/ops/quant.py (`quantize_kernel`, `dequantize_kernel`,
`quantized_proj`, `quantize_llama_params`): symmetric per-output-channel int8
weights with fp32 scales, in the JAX layout (`kernel [..., in, out]` int8,
`scale [..., out]` fp32). Scales commute with the product, so a projection
is a matmul over the int8 weight converted to the activation dtype, then one
fp32 multiply. The JAX package leaves this product to XLA; here it is
`torch.matmul`. A fused w8a16 kernel that reads the int8 bytes directly is
later work.

The frozen int8 backbone still passes a gradient to x (LoRA in earlier
layers needs it). The projection is an autograd.Function that saves the
int8 kernel and its fp32 scale, and dequantizes again in the backward,
dx = (dy * scale) @ W_i8^T: plain autograd through `kernel.to(x.dtype)`
would save a bf16 copy of every weight it touches (13.5 GB for the 7B
decoder without remat).
"""

from __future__ import annotations

from typing import Dict

import torch

_QUANT_TARGETS = ("attn", "mlp")  # groups inside llm/layers whose kernels quantize


def quantize_kernel(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] float -> {'kernel': int8, 'scale': fp32 [..., out]}."""
    k32 = kernel.float()
    amax = k32.abs().amax(dim=-2)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.round(k32 / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    return {"kernel": q, "scale": scale}


def dequantize_kernel(p: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (p["kernel"].float() * p["scale"][..., None, :]).to(dtype)


class _Int8Proj(torch.autograd.Function):
    """y = (x @ W_i8) * scale, with dx from the saved int8 kernel."""

    @staticmethod
    def forward(ctx, x, kernel, scale, fp32_out: bool):
        y = torch.matmul(x, kernel.to(x.dtype))
        if not fp32_out:  # a projection: product in x's dtype, then the scale
            y = (y.float() * scale.float()).to(x.dtype)
        else:  # the lm_head: fp32 logits
            y = y.float() * scale.float()
        ctx.save_for_backward(kernel, scale)
        ctx.x_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        kernel, scale = ctx.saved_tensors
        g = (dy.float() * scale.float()).to(ctx.x_dtype)
        return torch.matmul(g, kernel.to(ctx.x_dtype).t()), None, None, None


def quantized_proj(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   fp32_out: bool = False) -> torch.Tensor:
    """y = (x @ W_i8) * scale: the product in x's dtype, the scale in fp32.

    kernel is [in, out] and scale [out] (one layer's slice). `fp32_out`
    (the int8 lm_head) returns the fp32 product times the scale."""
    return _Int8Proj.apply(x, p["kernel"], p["scale"], fp32_out)


def quantize_llama_params(params: Dict, quantize_lm_head: bool = True) -> Dict:
    """Quantize every decoder projection kernel; norms and embeddings stay."""
    out = dict(params)
    layers = dict(params["layers"])
    for group in _QUANT_TARGETS:
        layers[group] = {
            name: quantize_kernel(proj["kernel"]) for name, proj in layers[group].items()
        }
    out["layers"] = layers
    if quantize_lm_head and "lm_head" in params:
        out["lm_head"] = quantize_kernel(params["lm_head"]["kernel"])
    return out
