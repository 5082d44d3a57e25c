"""LoRA adapters (port of teochat_tpu/train/lora.py).

Adapters are extra leaves of each decoder projection's params dict:
'lora_a' [L, in, r] ~ N(0, 1/r), 'lora_b' [L, r, out] = 0 (the peft init)
and 'lora_scale' [L] = alpha / r, all fp32 (the masters; the forward casts
a and b to the activation dtype). `models/llama.py::_proj` applies them as
y += ((x @ a) @ b) * scale, with no dropout, as the JAX package does (the
reference's peft applies 0.05). The backbone kernel may be int8 (the
reference's 8-bit k-bit training). The MPT layout and multi-LoRA stacking
are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

LORA_TARGET_GROUPS = ("attn", "mlp")  # all decoder linears (llama layout)
LORA_TARGET_NAMES = {
    "attn": ("q", "k", "v", "out"),
    "mlp": ("gate", "up", "down"),
}


def add_lora_params(generator: torch.Generator, llm_params: Dict, rank: int = 128,
                    alpha: float = 256.0, dtype: torch.dtype = torch.float32,
                    include_lm_head: bool = False) -> Dict:
    """Attach adapters (A ~ N(0, 1/r) drawn from `generator`, B = 0) on the
    device of the kernels. Returns a new tree; the backbone leaves are shared."""
    if "wqkv" in llm_params["layers"]:
        raise NotImplementedError("LoRA on the MPT backend is not ported yet")
    if include_lm_head:
        raise NotImplementedError("a LoRA lm_head is not ported yet")

    def attach(proj: Dict) -> Dict:
        kern = proj["kernel"]
        n_layers, fan_in, fan_out = kern.shape
        a = torch.randn((n_layers, fan_in, rank), generator=generator,
                        device=generator.device) * rank ** -0.5
        return {
            **proj,
            "lora_a": a.to(kern.device, dtype),
            "lora_b": torch.zeros((n_layers, rank, fan_out), dtype=dtype, device=kern.device),
            "lora_scale": torch.full((n_layers,), alpha / rank, dtype=torch.float32,
                                     device=kern.device),
        }

    layers = dict(llm_params["layers"])
    for group in LORA_TARGET_GROUPS:
        layers[group] = {name: attach(layers[group][name]) for name in LORA_TARGET_NAMES[group]}
    return {**llm_params, "layers": layers}


def merge_lora(llm_params: Dict) -> Dict:
    """Fold adapters into the kernels and drop the lora leaves (merge_and_unload)."""

    def merge_proj(proj: Dict) -> Dict:
        if "lora_a" not in proj:
            return proj
        kern = proj["kernel"]
        if kern.dtype == torch.int8:
            raise ValueError(
                "cannot merge LoRA into int8 weights; dequantize first or keep "
                "adapters unmerged (the reference also skips merge under 8-bit)"
            )
        scale = proj["lora_scale"].float()
        if scale.ndim == 1:  # stacked per-layer scale -> broadcast over (in, out)
            scale = scale[:, None, None]
        delta = torch.matmul(proj["lora_a"].float(), proj["lora_b"].float()) * scale
        rest = {k: v for k, v in proj.items()
                if k not in ("kernel", "lora_a", "lora_b", "lora_scale")}
        return {"kernel": (kern.float() + delta).to(kern.dtype), **rest}

    layers = {
        gname: ({n: merge_proj(p) for n, p in group.items()}
                if gname in LORA_TARGET_GROUPS else group)
        for gname, group in llm_params["layers"].items()
    }
    return {**llm_params, "layers": layers}


def lora_trainable_filter(path: str) -> bool:
    """Trainable leaves under LoRA: the adapters and the projector."""
    return (
        path.endswith("lora_a")
        or path.endswith("lora_b")
        or "/projector/" in path
        or path.startswith("projector/")
    )
