"""HF checkpoint -> params-tree converters (port of teochat_tpu/checkpoint/convert_hf.py).

Ingests the merged LLaVA-LLaMA weights (jirvin16/TEOChat layout), the
LanguageBind image tower (HF CLIPVisionModel layout) and `mm_projector.bin`
dicts. Per-layer HF weights are STACKED along a leading layer axis, and
linear weights are transposed to `kernel [in, out]`: the layout that
`checkpoint/bridge.py::to_torch` and the models take.

Everything stays on the host. Leaves are CPU tensors in the checkpoint's own
dtype: fp16 and bf16 keep 2 bytes an element, where the JAX converter widens
bf16 to fp32, so the stacked 7B decoder is 13.5 GB on the host and not 27.

The peft LoRA converters read an adapter state dict
(`base_model.model.model.layers.{i}.<module>.lora_A/B.weight`):
`merge_lora_into_llama` folds it into a host decoder's 16-bit kernels (the
reference's merge_and_unload, before any quantization), and
`attach_lora_to_llama` adds it as unmerged fp32 adapter leaves over any
decoder, quantized ones included (the multi-LoRA loader's form).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

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


_PEFT_NAME_MAP = {
    "self_attn.q_proj": ("attn", "q"),
    "self_attn.k_proj": ("attn", "k"),
    "self_attn.v_proj": ("attn", "v"),
    "self_attn.o_proj": ("attn", "out"),
    "mlp.gate_proj": ("mlp", "gate"),
    "mlp.up_proj": ("mlp", "up"),
    "mlp.down_proj": ("mlp", "down"),
}


def _peft_lora_pairs(lora_sd: Mapping[str, Any]) -> Dict:
    """Parse peft keys (`base_model.model.model.layers.{i}.<module>.lora_A/\
B.weight`) into {(layer, module): {"A": [r, in], "B": [out, r]}}."""
    norm = {}
    for k, v in lora_sd.items():
        k2 = re.sub(r"^(base_model\.model\.)?(model\.)?", "", k)
        k2 = k2.replace(".default.weight", ".weight")
        norm[k2] = v
    pairs = {}
    for k in norm:
        m = re.match(r"^layers\.(\d+)\.(.+)\.lora_A\.weight$", k)
        if m:
            pairs.setdefault((int(m.group(1)), m.group(2)), {})["A"] = norm[k]
        m = re.match(r"^layers\.(\d+)\.(.+)\.lora_B\.weight$", k)
        if m:
            pairs.setdefault((int(m.group(1)), m.group(2)), {})["B"] = norm[k]
    return pairs


def _f32(t: Any) -> torch.Tensor:
    return _host(t).float()


def _leaf_device(tree) -> torch.device:
    """The device of a params subtree's first tensor."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


def attach_lora_to_llama(params: Dict, lora_sd: Mapping[str, Any], cfg: LlamaConfig,
                         rank: Optional[int] = None, alpha: Optional[float] = None) -> Dict:
    """Attach peft LoRA A/B pairs as UNMERGED adapter leaves.

    The multi-LoRA loader's form (builder.load_multi_lora): the base kernels
    stay as they are (int8 / int4 included: a merge needs 16-bit weights)
    and each projection gains lora_a [L, in, r], lora_b [L, r, out] and
    lora_scale [L] (alpha / r), fp32, on the device of the projection's own
    leaves. Layers absent from the checkpoint get zero adapters; a module
    absent from every layer raises. Over the fused int4 layouts (ops/quant.py)
    the adapter is block-composed: A's columns concatenate (rank 3r for
    q|k|v, 2r for gate|up) and B is block-diagonal, so the fused delta is
    the per-projection deltas side by side. Returns a new tree that shares
    the base leaves."""
    pairs = _peft_lora_pairs(lora_sd)
    if not pairs:
        raise ValueError("no LoRA A/B pairs found in adapter state dict")
    if rank is None:
        rank = _host(next(iter(pairs.values()))["A"]).shape[0]
    alpha = alpha if alpha is not None else 2 * rank
    L = cfg.num_layers

    def stacks(module):
        """(A [L, in, r], B [L, r, out]) for one peft module; widths from the
        adapter's own tensors, so a quantized base needs no 16-bit kernel."""
        present = [(layer, ab) for (layer, m), ab in pairs.items() if m == module]
        if not present:
            raise ValueError(f"adapter has no LoRA pair for {module}")
        a0, b0 = _host(present[0][1]["A"]), _host(present[0][1]["B"])
        if a0.shape[0] != rank:
            raise ValueError(f"adapter rank mismatch in {module}: {a0.shape[0]} vs {rank}")
        a = torch.zeros((L, a0.shape[1], rank), dtype=torch.float32)
        b = torch.zeros((L, rank, b0.shape[0]), dtype=torch.float32)
        for layer, ab in present:
            a[layer] = _f32(ab["A"]).T
            b[layer] = _f32(ab["B"]).T
        return a, b

    def block_diag_b(parts):
        """[L, r, out_i] parts -> [L, len(parts) r, sum(out_i)], block diagonal."""
        n_layers, r = parts[0].shape[:2]
        out = torch.zeros((n_layers, len(parts) * r, sum(p.shape[2] for p in parts)))
        col = 0
        for i, p in enumerate(parts):
            out[:, i * r:(i + 1) * r, col:col + p.shape[2]] = p
            col += p.shape[2]
        return out

    layers = {g: (dict(v) if isinstance(v, dict) else v) for g, v in params["layers"].items()}
    mods = {name: stacks(module) for module, (_, name) in _PEFT_NAME_MAP.items()}
    fused = {}
    if "qkv" in layers["attn"]:
        fused["attn", "qkv"] = ("q", "k", "v")
    if "gateup" in layers["mlp"]:
        fused["mlp", "gateup"] = ("gate", "up")
    consumed = {n for parts in fused.values() for n in parts}
    leaves = dict(fused.items())
    leaves.update({(group, name): (name,) for group, name in _PEFT_NAME_MAP.values()
                   if name not in consumed})
    for (group, name), parts in leaves.items():
        proj = layers[group][name]
        dev = _leaf_device(proj)
        a = torch.cat([mods[n][0] for n in parts], dim=2)
        b = block_diag_b([mods[n][1] for n in parts]) if len(parts) > 1 else mods[name][1]
        layers[group][name] = {
            **proj, "lora_a": a.to(dev), "lora_b": b.to(dev),
            "lora_scale": torch.full((L,), alpha / rank, dtype=torch.float32, device=dev),
        }
    return {**params, "layers": layers}


def merge_lora_into_llama(params: Dict, lora_sd: Mapping[str, Any], cfg: LlamaConfig,
                          scaling: Optional[float] = None, rank: Optional[int] = None,
                          alpha: Optional[float] = None) -> Dict:
    """Merge peft LoRA A/B pairs into a host decoder's kernels: W' = W +
    (alpha / r) B A, the reference's merge_and_unload (builder.py:65-72).

    With the JAX converter's roundings: the delta (B @ A).T * scaling is an
    fp32 product (numpy's, as there) cast to the kernel's dtype before the
    add, in that dtype, for fp16 and fp32 kernels; a bf16 kernel, which the
    JAX converter widens to fp32, takes the fp32 sum rounded once. Returns
    a new tree; each changed kernel is a copy, the input is untouched."""
    pairs = _peft_lora_pairs(lora_sd)
    if scaling is None:
        if rank is None or alpha is None:
            # the rank from the first A; alpha defaults to 2 r (the recipe's r 128, alpha 256)
            rank = _host(next(iter(pairs.values()))["A"]).shape[0]
            alpha = alpha if alpha is not None else 2 * rank
        scaling = alpha / rank
    layers = {g: (dict(v) if isinstance(v, dict) else v) for g, v in params["layers"].items()}
    merged = {}
    for (layer, module), ab in sorted(pairs.items()):
        if module not in _PEFT_NAME_MAP:
            continue
        group, name = _PEFT_NAME_MAP[module]
        if (group, name) not in merged:
            merged[group, name] = layers[group][name]["kernel"].clone()
        kern = merged[group, name]
        # (B @ A).T as numpy's fp32 product A.T @ B.T: the same sums (the
        # tests hold the bytes to JAX's), laid out [in, out] as the kernel is,
        # so that the scale, the cast and the add below stream contiguously
        delta = torch.from_numpy(_f32(ab["A"]).numpy().T @ _f32(ab["B"]).numpy().T)
        delta.mul_(scaling)
        if kern.dtype == torch.bfloat16:
            kern[layer] = (kern[layer].float() + delta).to(kern.dtype)
        else:
            kern[layer].add_(delta.to(kern.dtype))
    for (group, name), kern in merged.items():
        layers[group] = {**layers[group], name: {**layers[group][name], "kernel": kern}}
    return {**params, "layers": layers}
