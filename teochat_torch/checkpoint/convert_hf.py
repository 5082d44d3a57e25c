"""HF checkpoint -> params-tree converters (port of teochat_tpu/checkpoint/convert_hf.py).

Ingests the merged LLaVA-LLaMA weights (jirvin16/TEOChat layout), the
LanguageBind image tower (HF CLIPVisionModel layout) and `mm_projector.bin`
dicts. Per-layer HF weights are STACKED along a leading layer axis, and
linear weights are transposed to `kernel [in, out]`: the layout that
`checkpoint/bridge.py::to_torch` and the models take.

Everything stays on the host. Leaves are CPU tensors in the checkpoint's own
dtype: fp16 and bf16 keep 2 bytes an element, where the JAX converter widens
bf16 to fp32, so the stacked 7B decoder is 13.5 GB on the host and not 27.
The peft LoRA converters (`attach_lora_to_llama`, `merge_lora_into_llama`)
are not ported yet (ROADMAP item 12).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from teochat_torch.config import LlamaConfig, ProjectorConfig, VisionConfig


def _host(t: Any) -> torch.Tensor:
    """torch.Tensor | np.ndarray -> a CPU tensor in its own dtype (the JAX
    converter's `_np`, without its widening of bf16)."""
    if isinstance(t, np.ndarray):
        return torch.from_numpy(t)
    return t.detach().cpu()


def _stack(sd: Mapping[str, Any], fmt: str, n: int, transpose: bool = False) -> torch.Tensor:
    arrs = [_host(sd[fmt.format(i=i)]) for i in range(n)]
    if transpose:
        arrs = [a.T for a in arrs]
    return torch.stack(arrs, dim=0)


def convert_clip_vision(sd: Mapping[str, Any], cfg: VisionConfig,
                        prefix: str = "vision_model.") -> Dict:
    """HF CLIPVisionModel state_dict -> vit.py param tree.

    Handles the LanguageBind video-tower extras (temporal_attn/temporal_ln/
    temporal_embedding) when cfg.add_time_attn.
    """
    p = prefix
    L = cfg.num_layers
    d = cfg.hidden_size

    conv = _host(sd[f"{p}embeddings.patch_embedding.weight"])  # [D,3,P,P]
    patch_kernel = conv.reshape(d, -1).T.contiguous()  # -> [3*P*P, D], flatten order (c,ph,pw)

    def ln(name_fmt: str, stacked: bool) -> Dict:
        if stacked:
            return {
                "scale": _stack(sd, name_fmt + ".weight", L).float(),
                "bias": _stack(sd, name_fmt + ".bias", L).float(),
            }
        return {
            "scale": _host(sd[name_fmt + ".weight"]).float(),
            "bias": _host(sd[name_fmt + ".bias"]).float(),
        }

    def dense(base: str) -> Dict:
        return {
            "kernel": _stack(sd, f"{base}.weight", L, transpose=True),
            "bias": _stack(sd, f"{base}.bias", L),
        }

    def attn(base: str) -> Dict:
        return {
            "q": dense(f"{base}.q_proj"),
            "k": dense(f"{base}.k_proj"),
            "v": dense(f"{base}.v_proj"),
            "out": dense(f"{base}.out_proj"),
        }

    layers = {
        "ln1": ln(f"{p}encoder.layers.{{i}}.layer_norm1", True),
        "attn": attn(f"{p}encoder.layers.{{i}}.self_attn"),
        "ln2": ln(f"{p}encoder.layers.{{i}}.layer_norm2", True),
        "mlp": {
            "fc1": dense(f"{p}encoder.layers.{{i}}.mlp.fc1"),
            "fc2": dense(f"{p}encoder.layers.{{i}}.mlp.fc2"),
        },
    }
    if cfg.add_time_attn:
        layers["temporal_ln"] = ln(f"{p}encoder.layers.{{i}}.temporal_layer_norm1", True)
        layers["temporal_attn"] = attn(f"{p}encoder.layers.{{i}}.temporal_attn")
        # HF shape [1, num_frames, D] -> [num_frames, D], stacked over layers
        layers["temporal_embedding"] = torch.stack(
            [
                _host(sd[f"{p}encoder.layers.{i}.temporal_embedding"]).reshape(
                    cfg.num_frames, d
                )
                for i in range(L)
            ],
            dim=0,
        )

    # HF names the pre-LN "pre_layrnorm" (sic)
    pre_key = f"{p}pre_layrnorm" if f"{p}pre_layrnorm.weight" in sd else f"{p}pre_layernorm"
    return {
        "patch_embedding": {"kernel": patch_kernel},
        "class_embedding": _host(sd[f"{p}embeddings.class_embedding"]),
        "position_embedding": _host(sd[f"{p}embeddings.position_embedding.weight"]),
        "pre_layernorm": ln(pre_key, False),
        "post_layernorm": ln(f"{p}post_layernorm", False),
        "layers": layers,
    }


def convert_llama(sd: Mapping[str, Any], cfg: LlamaConfig,
                  prefix: str = "model.") -> Dict:
    """HF LlamaForCausalLM state_dict -> llama.py param tree."""
    p = prefix
    L = cfg.num_layers

    def proj(base: str) -> Dict:
        return {"kernel": _stack(sd, base + ".weight", L, transpose=True)}

    params = {
        "embed_tokens": {"embedding": _host(sd[f"{p}embed_tokens.weight"])},
        "layers": {
            "input_norm": {"scale": _stack(sd, f"{p}layers.{{i}}.input_layernorm.weight", L)},
            "attn": {
                "q": proj(f"{p}layers.{{i}}.self_attn.q_proj"),
                "k": proj(f"{p}layers.{{i}}.self_attn.k_proj"),
                "v": proj(f"{p}layers.{{i}}.self_attn.v_proj"),
                "out": proj(f"{p}layers.{{i}}.self_attn.o_proj"),
            },
            "post_attn_norm": {
                "scale": _stack(sd, f"{p}layers.{{i}}.post_attention_layernorm.weight", L)
            },
            "mlp": {
                "gate": proj(f"{p}layers.{{i}}.mlp.gate_proj"),
                "up": proj(f"{p}layers.{{i}}.mlp.up_proj"),
                "down": proj(f"{p}layers.{{i}}.mlp.down_proj"),
            },
        },
        "final_norm": {"scale": _host(sd[f"{p}norm.weight"])},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": _host(sd["lm_head.weight"]).T.contiguous()}
    return params


def convert_projector(sd: Mapping[str, Any], cfg: ProjectorConfig,
                      prefix: str = "model.mm_projector.") -> Dict:
    """mm_projector state dict -> projector.py tree.

    The reference saves keys like `model.mm_projector.0.weight` (Sequential
    indices 0, 2, 4... with GELU at odd slots) or bare `0.weight`.
    """
    if cfg.depth == 0:
        return {}
    keys = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}

    def layer(w, b) -> Dict:
        return {"kernel": _host(w).T.contiguous(), "bias": _host(b)}

    if cfg.projector_type == "linear" and "weight" in keys:
        return {"layers": [layer(keys["weight"], keys["bias"])]}
    idxs = sorted(
        {int(m.group(1)) for k in keys if (m := re.match(r"^(\d+)\.weight$", k))}
    )
    layers = [layer(keys[f"{i}.weight"], keys[f"{i}.bias"]) for i in idxs]
    if len(layers) != cfg.depth:
        raise ValueError(
            f"projector depth mismatch: found {len(layers)}, config wants {cfg.depth}"
        )
    return {"layers": layers}
