"""LoRA adapters (port of teochat_tpu/train/lora.py).

Adapters are extra leaves of each decoder projection's params dict (LLaMA's
`attn` / `mlp` groups, or MPT's flat `wqkv`, `out_proj`, `up_proj` and
`down_proj`: models/mpt.py::_dense routes them through the same `_proj`):
'lora_a' [L, in, r] ~ N(0, 1/r), 'lora_b' [L, r, out] = 0 (the peft init)
and 'lora_scale' [L] = alpha / r, all fp32 (the masters; the forward casts
a and b to the activation dtype). `models/llama.py::_proj` applies them as
y += ((x @ a) @ b) * scale, with no dropout, as the JAX package does (the
reference's peft applies 0.05). The backbone kernel may be int8 (the
reference's 8-bit k-bit training). `include_lm_head` attaches an adapter to
the lm_head too, which the port's forward adds to the fp32 logits (the JAX
forward never reads it: ROADMAP F6).

Multi-LoRA serving: `stack_lora_adapters` stacks N single-adapter trees
over one backbone into adapter-stacked leaves ('lora_a' [L, A, in, r],
'lora_b' [L, A, r, out], 'lora_scale' [L, A]), which `_proj` routes per
batch row by an `adapter_route` [B, A] (one-hot rows; an all-zero row is
the base model), on either layout.
"""

from __future__ import annotations

from typing import Dict

import torch

LORA_TARGET_GROUPS = ("attn", "mlp")  # all decoder linears (llama layout)
LORA_TARGET_NAMES = {
    "attn": ("q", "k", "v", "out"),
    "mlp": ("gate", "up", "down"),
}
# MPT layout (models/mpt.py): flat projection dicts inside layers
MPT_TARGET_NAMES = ("wqkv", "out_proj", "up_proj", "down_proj")


def add_lora_params(generator: torch.Generator, llm_params: Dict, rank: int = 128,
                    alpha: float = 256.0, dtype: torch.dtype = torch.float32,
                    include_lm_head: bool = False) -> Dict:
    """Attach adapters (A ~ N(0, 1/r) drawn from `generator`, B = 0) on the
    device of the kernels. Returns a new tree; the backbone leaves are shared.
    The MPT layout (a `wqkv` in the layers) gets adapters on its four
    projections, drawn in MPT_TARGET_NAMES' order."""

    def attach(proj: Dict) -> Dict:
        kern = proj["kernel"]
        *lead, fan_in, fan_out = kern.shape  # [L, in, out], or the head's [in, out]
        a = torch.randn((*lead, fan_in, rank), generator=generator,
                        device=generator.device) * rank ** -0.5
        return {
            **proj,
            "lora_a": a.to(kern.device, dtype),
            "lora_b": torch.zeros((*lead, rank, fan_out), dtype=dtype, device=kern.device),
            "lora_scale": torch.full(lead, alpha / rank, dtype=torch.float32,
                                     device=kern.device),
        }

    layers = dict(llm_params["layers"])
    if "wqkv" in layers:
        for name in MPT_TARGET_NAMES:
            layers[name] = attach(layers[name])
    else:
        for group in LORA_TARGET_GROUPS:
            layers[group] = {name: attach(layers[group][name])
                             for name in LORA_TARGET_NAMES[group]}
    out = {**llm_params, "layers": layers}
    if include_lm_head and "lm_head" in out:
        out["lm_head"] = attach(out["lm_head"])
    return out


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

    def merge_group(gname, group):
        if gname in LORA_TARGET_GROUPS:
            return {n: merge_proj(p) for n, p in group.items()}
        return merge_proj(group) if gname in MPT_TARGET_NAMES else group

    layers = {gname: merge_group(gname, group) for gname, group in llm_params["layers"].items()}
    out = {**llm_params, "layers": layers}
    if "lm_head" in out:
        out["lm_head"] = merge_proj(out["lm_head"])
    return out


def stack_lora_adapters(llm_params_list) -> Dict:
    """N single-adapter LLM trees over one backbone -> ONE multi-LoRA tree.

    Every tree shares the base weights and the LoRA rank; only the adapter
    leaves differ. The projections get lora_a [L, A, in, r], lora_b
    [L, A, r, out] and lora_scale [L, A]; every other leaf (int8 and int4
    kernels, norms, embeddings, the lm_head) is the FIRST tree's, so N
    fine-tunes serve from one backbone plus N rank-r adapter sets."""
    if not llm_params_list:
        raise ValueError("stack_lora_adapters needs at least one adapter tree")
    first = llm_params_list[0]

    def stack_proj(projs):
        p0 = dict(projs[0])
        if "lora_a" not in p0:
            return p0
        ranks = {p["lora_a"].shape[-1] for p in projs}
        if len(ranks) != 1:
            raise ValueError(f"all adapters must share one LoRA rank; got {sorted(ranks)}")
        p0["lora_a"] = torch.stack([p["lora_a"] for p in projs], dim=1)
        p0["lora_b"] = torch.stack([p["lora_b"] for p in projs], dim=1)
        p0["lora_scale"] = torch.stack([p["lora_scale"].float() for p in projs], dim=1)
        return p0

    layers = {}
    for gname, group in first["layers"].items():
        if gname in LORA_TARGET_GROUPS and all(isinstance(v, dict) for v in group.values()):
            layers[gname] = {n: stack_proj([t["layers"][gname][n] for t in llm_params_list])
                             for n in group}
        elif gname in MPT_TARGET_NAMES:
            layers[gname] = stack_proj([t["layers"][gname] for t in llm_params_list])
        else:
            layers[gname] = group
    return {**first, "layers": layers}


def adapter_route(adapter_ids, num_adapters: int) -> torch.Tensor:
    """[B] adapter indices (a list or an integer tensor, on its device) ->
    the [B, A] fp32 one-hot routing matrix, the forward's `adapter_route`.
    Id -1 (the base model), like any id outside [0, A), gives an all-zero
    row, as JAX's `one_hot` does. Built by comparison and not `F.one_hot`,
    which asserts on the card for such ids: a CUDA graph cannot catch that."""
    ids = torch.as_tensor(adapter_ids, dtype=torch.int32)
    arange = torch.arange(num_adapters, dtype=torch.int32, device=ids.device)
    return (ids[:, None] == arange[None, :]).float()


def num_stacked_adapters(llm_params) -> int:
    """Adapter count A of a multi-LoRA tree (0: single-adapter or no LoRA)."""
    layers = llm_params.get("layers", {})
    for gname in (*LORA_TARGET_GROUPS, *MPT_TARGET_NAMES):
        group = layers.get(gname)
        if not isinstance(group, dict):
            continue
        for p in ([group] if "lora_a" in group else group.values()):
            if isinstance(p, dict) and "lora_a" in p:
                a = p["lora_a"]
                return a.shape[1] if a.ndim == 4 else 0
    return 0


def lora_trainable_filter(path: str) -> bool:
    """Trainable leaves under LoRA: the adapters and the projector."""
    return (
        path.endswith("lora_a")
        or path.endswith("lora_b")
        or "/projector/" in path
        or path.startswith("projector/")
    )
