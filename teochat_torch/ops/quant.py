"""Int8 weight-only quantization for the decoder.

Port of teochat_tpu/ops/quant.py (`quantize_kernel`, `dequantize_kernel`,
`quantized_proj`, `quantize_llama_params`): symmetric per-output-channel int8
weights with fp32 scales, in the JAX layout (`kernel [..., in, out]` int8,
`scale [..., out]` fp32). Scales commute with the product, so a projection
is a matmul over the int8 weight converted to the activation dtype, then one
fp32 multiply. The JAX package leaves this product to XLA; here it is
`torch.matmul`. A fused w8a16 kernel that reads the int8 bytes directly is
later work.
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


def quantized_proj(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """y = (x @ W_i8) * scale: the product in x's dtype, the scale in fp32.

    kernel is [in, out] and scale [out] (one layer's slice)."""
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    return (y.float() * p["scale"].float()).to(x.dtype)


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
