"""Params bridge and random init for the port.

`to_torch` turns a JAX-layout params tree (nested dicts and lists of numpy
arrays, e.g. `np.asarray` of every leaf of the JAX package's `vision`,
`projector` and `llm` trees, plain, int8- or int4-quantized) into tensors on
one device; `to_numpy` goes back. Layouts are unchanged: stacked `[L, ...]`
per-layer leaves, `kernel [in, out]`, int8 `scale [out]`; the int4 leaves
`packed` (uint8) and `packed_tiles` (int8 or uint8) keep their bytes and
dtype, so a tree from the JAX `quantize_llama_params_int4` loads byte for
byte.

`init_teochat` makes a random TEOChat directly on a device, with the JAX
package's init scheme. With quant='int8' or 'int4' it draws and quantizes one
layer's projection at a time, so the peak stays near the quantized model
rather than the bf16 one (13.5 GB for the 7B decoder).

The device defaults to the card: `device=None` means "cuda" and raises when
there is none; the CPU is used only when the caller passes "cpu".
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from teochat_torch.config import TEOChatConfig
from teochat_torch.ops.quant import quantize_kernel, quantize_kernel_int4
from teochat_torch.utils import resolve_device

Params = Dict


def _leaf_to_torch(name: str, arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a JAX bf16 leaf
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    # quantization and norm scales stay fp32, as in the JAX trees; LoRA
    # leaves are fp32 masters (the forward casts them to the activation dtype)
    if t.is_floating_point() and dtype is not None and name != "scale":
        t = t.float() if name.startswith("lora_") else t.to(dtype)
    return t.to(device)


def to_torch(tree, device=None, dtype: Optional[torch.dtype] = None, _name: str = ""):
    """numpy params tree -> tensors on `device` (None = the card). Float
    leaves other than 'scale' and the LoRA leaves (fp32) are cast to `dtype`
    (None keeps them); integer leaves (int8 kernels, packed int4 bytes) keep
    theirs."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype, _name) for v in tree]
    return _leaf_to_torch(_name, tree, device, dtype)


def to_numpy(tree):
    """Tensors -> numpy (bf16 leaves come back as float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _Init:
    """Draws normal tensors from one generator on one device."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.gen, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, std: float, dtype=None) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device) * std
        return x.to(dtype or self.dtype)

    def zeros(self, shape, dtype=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def ones32(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=torch.float32, device=self.device)

    def stacked(self, n_layers: int, fan_in: int, fan_out: int, std: float,
                quant: Optional[str]) -> Params:
        """A stacked [L, in, out] projection, drawn (and quantized) per layer."""
        if quant is None:
            return {"kernel": torch.stack(
                [self.normal((fan_in, fan_out), std) for _ in range(n_layers)])}
        if quant == "int4":
            return self.stacked_int4(n_layers, fan_in, (fan_out,), std)
        if quant != "int8":
            raise NotImplementedError(f"quant={quant!r} is not ported yet")
        kernel = torch.empty((n_layers, fan_in, fan_out), dtype=torch.int8, device=self.device)
        scale = torch.empty((n_layers, fan_out), dtype=torch.float32, device=self.device)
        for i in range(n_layers):
            qp = quantize_kernel(self.normal((fan_in, fan_out), std, torch.float32))
            kernel[i], scale[i] = qp["kernel"], qp["scale"]
        return {"kernel": kernel, "scale": scale}

    def stacked_int4(self, n_layers: int, fan_in: int, fan_outs, std: float) -> Params:
        """A stacked int4 projection whose output is the concatenation of
        `fan_outs` (q|k|v, gate|up or a single projection), drawn, quantized
        and packed one layer at a time into the stacked leaves."""
        out: Params = {}
        for i in range(n_layers):
            kernel = torch.cat(
                [self.normal((fan_in, n), std, torch.float32) for n in fan_outs], dim=-1)
            for name, leaf in quantize_kernel_int4(kernel).items():
                if name not in out:
                    out[name] = torch.empty((n_layers, *leaf.shape), dtype=leaf.dtype,
                                            device=self.device)
                out[name][i] = leaf
        return out


def _init_vit(ini: _Init, cfg) -> Params:
    d, i_size, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    in_std = d ** -0.5
    attn_std = (d ** -0.5) * ((2 * L) ** -0.5)
    fc_std = (2 * d) ** -0.5

    def dense(fan_in, fan_out, std):
        return {**ini.stacked(L, fan_in, fan_out, std, None), "bias": ini.zeros((L, fan_out))}

    def ln(shape):
        return {"scale": ini.ones32(shape), "bias": torch.zeros(shape, device=ini.device)}

    def attn():
        return {n: dense(d, d, attn_std) for n in ("q", "k", "v", "out")}

    layers = {
        "ln1": ln((L, d)),
        "attn": attn(),
        "ln2": ln((L, d)),
        "mlp": {"fc1": dense(d, i_size, fc_std), "fc2": dense(i_size, d, in_std)},
    }
    if cfg.add_time_attn:
        layers["temporal_ln"] = ln((L, d))
        layers["temporal_attn"] = attn()
        layers["temporal_embedding"] = ini.normal((L, cfg.num_frames, d), d ** -0.5)
    return {
        "patch_embedding": {"kernel": ini.normal((3 * cfg.patch_size ** 2, d), in_std)},
        "class_embedding": ini.normal((d,), in_std),
        "position_embedding": ini.normal((cfg.num_positions, d), in_std),
        "pre_layernorm": ln((d,)),
        "post_layernorm": ln((d,)),
        "layers": layers,
    }


def _init_projector(ini: _Init, cfg) -> Params:
    layers, fan_in = [], cfg.mm_hidden_size
    for _ in range(cfg.depth):
        layers.append({
            "kernel": ini.normal((fan_in, cfg.hidden_size), fan_in ** -0.5),
            "bias": ini.zeros((cfg.hidden_size,)),
        })
        fan_in = cfg.hidden_size
    return {"layers": layers} if layers else {}


def _init_llama(ini: _Init, cfg, quant: Optional[str], fuse_projections: bool) -> Params:
    d, i_sz, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hkv_d = cfg.num_kv_heads * cfg.head_dim
    std = 0.02
    if quant == "int4" and fuse_projections:
        # the leaves quantize_llama_params_int4 makes: q|k|v and gate|up fused
        attn = {"qkv": ini.stacked_int4(L, d, (d, hkv_d, hkv_d), std),
                "out": ini.stacked(L, d, d, std, quant)}
        mlp = {"gateup": ini.stacked_int4(L, d, (i_sz, i_sz), std),
               "down": ini.stacked(L, i_sz, d, std, quant)}
    else:
        attn = {
            "q": ini.stacked(L, d, d, std, quant),
            "k": ini.stacked(L, d, hkv_d, std, quant),
            "v": ini.stacked(L, d, hkv_d, std, quant),
            "out": ini.stacked(L, d, d, std, quant),
        }
        mlp = {
            "gate": ini.stacked(L, d, i_sz, std, quant),
            "up": ini.stacked(L, d, i_sz, std, quant),
            "down": ini.stacked(L, i_sz, d, std, quant),
        }
    params = {
        "embed_tokens": {"embedding": ini.normal((cfg.vocab_size, d), std)},
        "layers": {
            "input_norm": {"scale": ini.ones32((L, d))},
            "attn": attn,
            "post_attn_norm": {"scale": ini.ones32((L, d))},
            "mlp": mlp,
        },
        "final_norm": {"scale": ini.ones32((d,))},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = ini.stacked(1, d, cfg.vocab_size, std, quant)
        params["lm_head"] = {k: v[0] for k, v in params["lm_head"].items()}
    return params


def init_encoder(cfg: TEOChatConfig, generator: torch.Generator, device=None,
                 dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random tower and projector alone: {'vision', 'projector'}."""
    ini = _Init(generator, resolve_device(device), dtype)
    return {"vision": _init_vit(ini, cfg.vision),
            "projector": _init_projector(ini, cfg.projector)}


def init_projector(cfg, generator: torch.Generator, device=None,
                   dtype: torch.dtype = torch.bfloat16) -> Params:
    """A random projector alone (`cfg` is the ProjectorConfig): each kernel
    drawn N(0, 1 / fan_in), biases zero, as JAX's `init_projector`."""
    return _init_projector(_Init(generator, resolve_device(device), dtype), cfg)


def init_llama(cfg, generator: torch.Generator, device=None,
               dtype: torch.dtype = torch.bfloat16, quant: Optional[str] = "int8",
               fuse_projections: bool = True) -> Params:
    """A random decoder alone (`cfg` is the LlamaConfig), quantized as in init_teochat."""
    ini = _Init(generator, resolve_device(device), dtype)
    return _init_llama(ini, cfg, quant, fuse_projections)


def init_teochat(cfg: TEOChatConfig, generator: torch.Generator, device=None,
                 dtype: torch.dtype = torch.bfloat16, quant: Optional[str] = "int8",
                 fuse_projections: bool = True) -> Params:
    """Random TEOChat params on `device` (None = the card), drawn from
    `generator` (which must live on that device). The decoder's projections
    and lm_head are int8 when quant='int8' and packed int4 when quant='int4'
    (q|k|v and gate|up fused unless `fuse_projections` is False); the tower
    and projector stay in `dtype`."""
    return {
        **init_encoder(cfg, generator, device, dtype),
        "llm": init_llama(cfg.llm, generator, device, dtype, quant, fuse_projections),
    }
