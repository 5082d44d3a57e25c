"""Int8 and int4 weight-only quantization for the decoder.

Port of teochat_tpu/ops/quant.py. Int8 (`quantize_kernel`,
`dequantize_kernel`, `quantized_proj`, `quantize_llama_params`): symmetric
per-output-channel int8 weights with fp32 scales, in the JAX layout
(`kernel [..., in, out]` int8, `scale [..., out]` fp32). Scales commute
with the product, so a projection is a matmul over the int8 weight
converted to the activation dtype, then one fp32 multiply on the fp32 sum
(`matmul_fp32`: 16-bit operands, the fp32 accumulator as the result, as
JAX's `preferred_element_type=float32`; also the lm_head's and the LoRA
delta's product). The JAX package leaves this product to XLA; here it is
cuBLAS. A fused w8a16 kernel that reads the int8 bytes directly is later
work.

The frozen int8 backbone still passes a gradient to x (LoRA in earlier
layers needs it). The projection is an autograd.Function that saves the
int8 kernel and its fp32 scale, and dequantizes again in the backward,
dx = (dy * scale) @ W_i8^T: plain autograd through `kernel.to(x.dtype)`
would save a bf16 copy of every weight it touches (13.5 GB for the 7B
decoder without remat). The fp32 `dy * scale` meets the weight whole
(`mm_fp32_operand`), as in the reference's gradient; so does the fp32
cotangent in `matmul_fp32`'s gradients.

Int4, w4a16 (`quantize_kernel_int4`, `unpack_int4`, `int4_proj`,
`quantize_llama_params_int4`): per-output-channel scale `amax / 7`, values
clipped to [-8, 7], two per byte (ops/int4_matmul.py). An output narrower
than one 512-column tile keeps the flat u8 `packed` leaf; a wider one is
stored as `packed_tiles`, v3 int8 bytes in the tile-contiguous layout, with
its fan-in zero-padded by `_pad_k2`. `int4_proj` is the fused
dequantize-matmul: the hand-written kernels on a CUDA tensor, the plain
unpack -> matmul -> scale on a CPU tensor. Forward only, as in the JAX
package (int4 is a serving format). The JAX module's search for a block
size that fits the TPU's vector memory has no counterpart here.

w8a8 (`quantized_proj_act_i8`, `quantize_vit_params`): per-token int8
activations times the int8 weight, the int32 sum scaled in fp32 and rounded
once; the product is `int8_matmul` (`torch._int_mm`: cuBLASLt's int8 GEMM on
the card, the JAX package's XLA int8 `einsum`), the quantize and the scale
plain torch ops. It runs the prefill of an int8 decoder with
`int8_prefill_activations` (models/llama.py) and a tower quantized by
`quantize_vit_params` (models/vit.py).

`quantize_kernel_host` and `quantize_llama_params_host` take a decoder
tree that lies on the host (the checkpoint loader's) and quantize it on the
card a few layers at a time, so the 16-bit decoder (13.5 GB at 7B) is never
on the card whole. `quantize_mpt_params` and `quantize_mpt_params_host` do
the same for the MPT decoder's four projections a block (models/mpt.py):
norms, biases and the tied `wte` stay as they are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from teochat_torch.ops import _build
from teochat_torch.ops import int4_matmul as int4_mod
from teochat_torch.utils import resolve_device, tree_map

INT4_TILE_BN = int4_mod.TILE_BN
_QUANT_TARGETS = ("attn", "mlp")  # groups inside llm/layers whose kernels quantize


def _quantize_symmetric(kernel: torch.Tensor, qmin: int, qmax: int, reciprocal_scale: bool):
    """(round(kernel / scale) clipped to [qmin, qmax] as fp32, scale), with a
    per-output-channel scale amax / qmax (1 where amax is 0).

    The work is done in place on one fp32 copy of the weight, the only
    full-size buffer allocated: the checkpoint loader quantizes a chunk of
    7B layers at a time on the card. `reciprocal_scale` takes the scale as
    amax * fp32(1 / qmax), as XLA compiles the JAX quantizers under `jit`;
    only quantize_kernel_host asks for it (see there)."""
    k32 = kernel.to(torch.float32, copy=True)
    amax = torch.maximum(k32.amax(dim=-2), -k32.amin(dim=-2))
    step = amax * float(np.float32(1.0) / np.float32(qmax)) if reciprocal_scale else amax / qmax
    scale = torch.where(amax == 0, torch.ones_like(amax), step)
    return k32.div_(scale[..., None, :]).round_().clamp_(qmin, qmax), scale


def _int8_leaf(q: torch.Tensor, scale: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"kernel": q.to(torch.int8), "scale": scale}


def quantize_kernel(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] float -> {'kernel': int8, 'scale': fp32 [..., out]}."""
    return _int8_leaf(*_quantize_symmetric(kernel, -127, 127, reciprocal_scale=False))


def dequantize_kernel(p: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (p["kernel"].float() * p["scale"][..., None, :]).to(dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """a [M, K] @ b [K, N], both in one 16-bit dtype, summed in fp32 and
    rounded once to `out_dtype`. On the card one cuBLAS product that writes
    `out_dtype` from its fp32 accumulator; on the CPU, where `mm` has no
    `out_dtype`, the product of fp32 copies: the same sum of exact products."""
    if a.is_cuda:
        return torch.mm(a, b) if out_dtype == a.dtype else torch.mm(a, b, out_dtype=out_dtype)
    return torch.mm(a.float(), b.float()).to(out_dtype)


def _split_bf16(g: torch.Tensor):
    """An fp32 tensor as a 16-bit head and the 16-bit rounding of what the
    head leaves: head + remainder is g to about 2^-17 of each element."""
    head = g.to(torch.bfloat16)
    return head, (g - head.float()).to(torch.bfloat16)


def mm_fp32_operand(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """a [M, K] @ b [K, N] where one operand is fp32 and the other bf16 (a
    cotangent against a weight or an activation), summed in fp32 and rounded
    once to `out_dtype`: what JAX's transpose of a `preferred_element_type=
    float32` product computes. On the card the fp32 operand goes to the bf16
    tensor cores as a head and a remainder: two cuBLAS products, the second
    accumulating into the first's fp32 result (on an H100 the cheapest of
    three such forms, chip_probe.py int8-proj). On the CPU, the product of
    fp32 copies."""
    f32 = torch.float32
    if not a.is_cuda or a.dtype == b.dtype == f32:
        return torch.mm(a.float(), b.float()).to(out_dtype)
    if a.dtype == f32:
        head, rest = _split_bf16(a)
        y = torch.addmm(torch.mm(head, b, out_dtype=f32), rest, b, out_dtype=f32)
    else:
        head, rest = _split_bf16(b)
        y = torch.addmm(torch.mm(a, head, out_dtype=f32), a, rest, out_dtype=f32)
    return y.to(out_dtype)


class _MatmulFp32(torch.autograd.Function):
    """y = a @ b as the fp32 accumulator; the gradients in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm(a, b, torch.float32)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        g = dy.float()  # the fp32 cotangent, whole, as the reference transposes it
        da = mm_fp32_operand(g, b.t(), a.dtype) if ctx.needs_input_grad[0] else None
        db = mm_fp32_operand(a.t(), g, b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] -> fp32 [..., N]: bf16 operands, the fp32
    accumulator as the result (JAX's `preferred_element_type=float32`), where
    `torch.matmul` would round it to bf16. fp32 operands go to `torch.matmul`."""
    if x.dtype != w.dtype:
        raise ValueError(f"matmul_fp32: operand dtypes {x.dtype} and {w.dtype} differ")
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _MatmulFp32.apply(x2, w)
    else:  # no graph to record: skip the autograd.Function's host cost
        y = _mm(x2, w, torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


class _Int8Proj(torch.autograd.Function):
    """y = (x @ W_i8) * scale, with dx from the saved int8 kernel."""

    @staticmethod
    def forward(ctx, x, kernel, scale, fp32_out: bool):
        y = matmul_fp32(x, kernel.to(x.dtype)) * scale.float()  # the scale on the fp32 sum
        ctx.save_for_backward(kernel, scale)
        ctx.x_dtype = x.dtype
        return y if fp32_out else y.to(x.dtype)  # fp32 logits, or a projection: one rounding

    @staticmethod
    def backward(ctx, dy):
        kernel, scale = ctx.saved_tensors
        # the reference multiplies the fp32 dy * scale by the weight: it stays
        # fp32 here too, and the weight is converted once
        g = dy.reshape(-1, dy.shape[-1]).float() * scale.float()
        dx = mm_fp32_operand(g, kernel.to(ctx.x_dtype).t(), ctx.x_dtype)
        dx = dx.reshape(*dy.shape[:-1], kernel.shape[0])
        return dx, None, None, None


def quantized_proj(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   fp32_out: bool = False) -> torch.Tensor:
    """y = (x @ W_i8) * scale: the product summed in fp32, scaled there, and
    rounded once to x's dtype.

    kernel is [in, out] and scale [out] (one layer's slice). `fp32_out`
    (the int8 lm_head) returns the scaled fp32 sum itself."""
    return _Int8Proj.apply(x, p["kernel"], p["scale"], fp32_out)


# ------------------------------------------------------------- w8a8 (int8 x int8)

# every w8a8 product (`int8_matmul`), on any device: a count of the int8
# tensor-core GEMMs a run made (a CUDA graph's capture records it as a launch)
ACT_I8_PRODUCTS = _build.LaunchCounter("w8a8_int_mm")
INT_MM_MIN_ROWS = 17  # torch._int_mm on the card takes more than 16 rows
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> int32 [M, N], exact.

    One `torch._int_mm`: cuBLASLt's int8 tensor-core GEMM on the card, the
    JAX package's int8 `einsum` with `preferred_element_type=int32` (an XLA
    op there, not a Pallas kernel). On the card it takes M > 16 and K, N
    multiples of 8: fewer rows, and K or N off a multiple of 8, are padded
    with zeros and the result sliced back. Each row's int32 sum is exact and
    depends on its own row alone, and zero columns add exact zeros, so the
    padding changes no bit. On the card b goes to cuBLASLt K-contiguous
    (column-major, its "TN" form): on an H100 the product runs 4-7x faster
    that way (chip_smoke.py phase 21 (a)). The w8a8 tower's kernels are
    stored so once (`quantize_vit_params`, `k_major`) and go straight in;
    the decoder's int8 leaves, row-major because the w8a16 path reads them
    too, are copied to that order on every call."""
    m, k = a.shape
    n = b.shape[1]
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    rows = max(m, INT_MM_MIN_ROWS) if a.is_cuda else m
    a_p = _pad_to(_pad_to(a, 1, k8), 0, rows)
    b_p = _pad_to(_pad_to(b, 0, k8), 1, n8)
    if b_p.is_cuda and b_p.stride(0) != 1:
        b_p = b_p.t().contiguous().t()
    ACT_I8_PRODUCTS.count += 1
    y = torch._int_mm(a_p.contiguous(), b_p)
    return y if (rows, n8) == (m, n) else y[:m, :n]


def quantize_rows_i8(x: torch.Tensor):
    """Per-token symmetric int8 quantization of x [..., K]: (x_i8, scale_x
    fp32 [..., 1]). In fp32: amax over the feature axis, scale_x = amax *
    fp32(1 / 127) (1 where amax is 0), round half to even, clip to ±127.

    The scale takes the form XLA gives `amax / 127.0` under `jit` (a
    multiplication by the fp32 reciprocal); the JAX package runs this
    quantizer inside jitted programs (`llama_forward`, `encode_frames`), so
    the port holds `jax.jit(quantized_proj_act_i8)` bit for bit (ROADMAP,
    differences)."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()  # a max is exact in x's dtype
    scale_x = torch.where(amax == 0, torch.ones_like(amax), amax * _INV_127)
    x_i8 = torch.div(x, scale_x).round_().clamp_(-127, 127).to(torch.int8)  # in fp32
    return x_i8, scale_x


def quantized_proj_act_i8(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """w8a8 projection: per-token int8 activations times the int8 weight on
    the int8 tensor cores, y = (x_i8 @ W_i8) * scale_x[token] *
    scale_w[channel], the int32 sum converted to fp32, scaled in that order
    and rounded once to x's dtype (the JAX function's fp32 chain).

    kernel is [in, out] int8 and scale [out] fp32 (one layer's slice). The
    quantize runs as plain torch ops (`quantize_rows_i8`); the product is
    `int8_matmul`. No gradient reaches x through the rounding (as in JAX)."""
    x_i8, scale_x = quantize_rows_i8(x)
    kernel = p["kernel"]
    y = int8_matmul(x_i8.reshape(-1, x.shape[-1]), kernel)
    y = y.reshape(*x.shape[:-1], kernel.shape[-1]).float()
    return (y * scale_x * p["scale"].float()).to(x.dtype)


_VIT_QUANT_GROUPS = ("attn", "temporal_attn", "mlp")


def k_major(kernel: torch.Tensor) -> torch.Tensor:
    """The same [..., K, N] values stored K-contiguous (each [K, N] slice
    column-major), the order `int8_matmul` hands cuBLASLt without a copy."""
    return kernel.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_vit_params(params: Dict) -> Dict:
    """Quantize the ViT encoder's projection kernels for the w8a8 encode
    path: each kernel of the `attn`, `temporal_attn` and `mlp` groups
    becomes {'kernel' int8, 'scale' fp32} by `quantize_kernel` (the eager
    form, as the JAX function's), its bias kept; `vit._dense` takes the
    w8a8 product where a leaf has a `scale`. The int8 kernel is stored
    `k_major` (no other path reads it), so `int8_matmul` copies nothing.
    LayerNorms, embeddings and the patch embedding stay as they are."""
    out = dict(params)
    layers = dict(params["layers"])
    for group in _VIT_QUANT_GROUPS:
        if group not in layers:
            continue
        g = {}
        for name, proj in layers[group].items():
            q = quantize_kernel(proj["kernel"])
            q["kernel"] = k_major(q["kernel"])
            if "bias" in proj:
                q["bias"] = proj["bias"]
            g[name] = q
        layers[group] = g
    out["layers"] = layers
    return out


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


# ---------------------------------------------------------------- int4 w4a16

def _pad_k2(k2: int) -> int:
    """Packed fan-in (K/2) padded to a multiple of 256, as the JAX quantizer
    pads it (LLaMA's down projection: K = 11008 -> k2 = 5504 -> 5632), so
    that trees quantized by either package hold the same bytes."""
    if k2 <= 128 or k2 % 256 == 0:
        return k2
    return ((k2 + 255) // 256) * 256


def quantize_kernel_int4(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] float -> {'packed_tiles': int8 [..., ceil(out/bn), in/2, bn],
    'scale': fp32 [..., out]}, or {'packed': uint8 [..., in/2, out], 'scale'}
    for an output narrower than one tile."""
    _check_int4_fan_in(kernel)
    return _int4_leaf(*_quantize_symmetric(kernel, -8, 7, reciprocal_scale=False))


def _check_int4_fan_in(kernel: torch.Tensor) -> None:
    if kernel.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even fan-in, got {kernel.shape[-2]}")


def _int4_leaf(q: torch.Tensor, scale: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Pack quantized int4 values (fp32 [..., in, out]) into quantize_kernel_int4's layout."""
    fan_in = q.shape[-2]
    q = q.to(torch.int32)
    if q.shape[-1] < INT4_TILE_BN:
        return {"packed": int4_mod.pack_int4(q), "scale": scale}
    # zero-pad the fan-in (the zero rows contribute nothing: int4_proj reads
    # the activations past their true K as zeros)
    k2p = _pad_k2(fan_in // 2)
    if 2 * k2p != fan_in:
        q = torch.nn.functional.pad(q, (0, 0, 0, 2 * k2p - fan_in))
    if q.ndim == 2:
        tiles = int4_mod.pack_int4_tiled_i8(q, INT4_TILE_BN)
    else:
        lead = q.shape[:-2]
        flat = q.reshape(-1, *q.shape[-2:])
        tiles = torch.stack([int4_mod.pack_int4_tiled_i8(w, INT4_TILE_BN) for w in flat])
        tiles = tiles.reshape(*lead, *tiles.shape[1:])
    return {"packed_tiles": tiles, "scale": scale}


def unpack_int4(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[..., in/2, out] packed bytes -> [..., in, out] centered int4 values.

    Dispatches on dtype: int8 = v3 combined byte, uint8 = split nibbles."""
    return int4_mod.unpack_int4_any(packed, dtype)


def _int4_proj_tiled(x: torch.Tensor, p: Dict[str, torch.Tensor], layer=None) -> torch.Tensor:
    tiles, scale = p["packed_tiles"], p["scale"]
    n_out = scale.shape[-1]  # true (unpadded) output width
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])  # a strided slice becomes contiguous here
    if tiles.ndim == 4:
        if layer is None:
            raise ValueError(
                "int4_proj: layer-stacked packed_tiles (ndim=4) require a "
                "layer index; pass layer= or slice the layer axis first"
            )
        y = int4_mod.int4_matmul_tiled_stacked(x2, tiles, scale, layer, n_out=n_out)
    else:
        y = int4_mod.int4_matmul_tiled(x2, tiles, scale, n_out=n_out)
    return y.reshape(*lead, n_out)


def int4_proj(x: torch.Tensor, p: Dict[str, torch.Tensor], layer=None) -> torch.Tensor:
    """y = (x @ unpack(W_i4)) * scale, in x's dtype.

    `layer`: when `p` holds layer-stacked leaves ([L, ...]), selects the
    layer; a stacked `packed_tiles` buffer is handed to the kernel whole."""
    if "packed_tiles" in p:
        return _int4_proj_tiled(x, p, layer)
    packed, scale = p["packed"], p["scale"]
    if packed.ndim == 3:  # stacked flat layout: a layer is a contiguous view
        if layer is None:
            raise ValueError("int4_proj: layer-stacked packed (ndim=3) requires a layer index")
        packed, scale = packed[layer], scale[layer]
    lead = x.shape[:-1]
    y = int4_mod.int4_matmul(x.reshape(-1, x.shape[-1]), packed, scale)
    return y.reshape(*lead, scale.shape[-1])


def quantize_llama_params_int4(params: Dict, quantize_lm_head: bool = True,
                               fuse_projections: bool = True) -> Dict:
    """Quantize the decoder projections to packed int4 (layer-stacked leaves).

    `fuse_projections` concatenates q|k|v and gate|up along the output before
    packing (per-column scales are unchanged by the concat, so the math is
    the same): 4 projections a layer instead of 7. The fused leaves are the
    'qkv' / 'gateup' keys that models/llama.py looks for."""
    out = dict(params)
    layers = dict(params["layers"])

    def _plain(group, names):
        return all(set(layers[group][n].keys()) == {"kernel"} for n in names)

    if fuse_projections and _plain("attn", ("q", "k", "v")) and _plain("mlp", ("gate", "up")):
        attn, mlp = layers["attn"], layers["mlp"]
        qkv = torch.cat([attn[n]["kernel"] for n in ("q", "k", "v")], dim=-1)
        gateup = torch.cat([mlp[n]["kernel"] for n in ("gate", "up")], dim=-1)
        layers["attn"] = {
            "qkv": quantize_kernel_int4(qkv),
            "out": quantize_kernel_int4(attn["out"]["kernel"]),
        }
        layers["mlp"] = {
            "gateup": quantize_kernel_int4(gateup),
            "down": quantize_kernel_int4(mlp["down"]["kernel"]),
        }
    else:
        for group in _QUANT_TARGETS:
            layers[group] = {
                name: quantize_kernel_int4(proj["kernel"])
                for name, proj in layers[group].items()
            }
    out["layers"] = layers
    if quantize_lm_head and "lm_head" in params:
        out["lm_head"] = quantize_kernel_int4(params["lm_head"]["kernel"])
    return out


# ------------------------------------------------- host trees (the loader's)

def quantize_kernel_host(kernel: torch.Tensor, int4: bool = False, layer_chunk: int = 8,
                         device=None) -> Dict[str, torch.Tensor]:
    """Quantize a HOST stacked kernel [L, in, out] on `device` (None = the
    card) with bounded device memory.

    `layer_chunk` layers are uploaded at a time, quantized there and written
    into the preallocated stacked result, so the device holds the quantized
    leaf plus one chunk's working set (its 16-bit upload, one fp32 copy and
    the result), never the whole 16-bit kernel. Un-stacked 2-D kernels
    (lm_head) are small and quantize whole.

    The scale is amax * fp32(1 / qmax), not amax / qmax as in
    quantize_kernel: the JAX package's host quantizer runs under `jit`,
    where XLA rewrites the division so, and this path holds the same bytes
    as that one (ROADMAP queue 3, differences)."""
    device = resolve_device(device)
    if int4:
        _check_int4_fan_in(kernel)

    def fn(k):
        if int4:
            return _int4_leaf(*_quantize_symmetric(k, -8, 7, reciprocal_scale=True))
        return _int8_leaf(*_quantize_symmetric(k, -127, 127, reciprocal_scale=True))

    if kernel.ndim < 3:
        return fn(kernel.to(device))
    n_layers = kernel.shape[0]
    out: Dict[str, torch.Tensor] = {}
    for i in range(0, n_layers, layer_chunk):
        q = fn(kernel[i : i + layer_chunk].to(device))
        for name, leaf in q.items():
            if name not in out:
                out[name] = torch.empty((n_layers, *leaf.shape[1:]), dtype=leaf.dtype,
                                        device=device)
            out[name][i : i + leaf.shape[0]] = leaf
        del q
    return out


def quantize_llama_params_host(params: Dict, int4: bool = False, layer_chunk: int = 8,
                               device=None) -> Dict:
    """quantize_llama_params / _int4 for a HOST tree (CPU tensors, the output
    of convert_hf.convert_llama): the checkpoint loader's path
    (builder.load_pretrained_model).

    The output layout is the device-tree versions' at their defaults: int8
    q, k, v unfused; int4 q|k|v and gate|up fused (concatenated on the
    host); the lm_head quantized. The difference is memory: projections
    stream to `device` in layer chunks (quantize_kernel_host). The other
    leaves (norm scales, embeddings) are moved to `device` as they are."""
    device = resolve_device(device)
    layers = dict(params["layers"])

    def quantize(kernel):
        return quantize_kernel_host(kernel, int4=int4, layer_chunk=layer_chunk, device=device)

    if int4:
        attn, mlp = layers["attn"], layers["mlp"]
        qkv = torch.cat([attn[n]["kernel"] for n in ("q", "k", "v")], dim=-1)
        layers["attn"] = {"qkv": quantize(qkv), "out": quantize(attn["out"]["kernel"])}
        del qkv
        gateup = torch.cat([mlp[n]["kernel"] for n in ("gate", "up")], dim=-1)
        layers["mlp"] = {"gateup": quantize(gateup), "down": quantize(mlp["down"]["kernel"])}
        del gateup
    else:
        for group in _QUANT_TARGETS:
            layers[group] = {
                name: quantize(proj["kernel"]) for name, proj in layers[group].items()
            }
    out = dict(params)
    out["layers"] = layers
    out["lm_head"] = quantize_kernel_host(params["lm_head"]["kernel"], int4=int4, device=device)
    return tree_map(lambda t: t.to(device), out)


# ------------------------------------------------------------------- MPT int8

_MPT_QUANT_TARGETS = ("wqkv", "out_proj", "up_proj", "down_proj")


def _quantize_mpt(params: Dict, quantize) -> Dict:
    out = dict(params)
    layers = dict(params["layers"])
    for name in _MPT_QUANT_TARGETS:
        proj = dict(layers[name])
        q = quantize(proj.pop("kernel"))
        q.update(proj)  # any bias leaf rides beside the quantized kernel
        layers[name] = q
    out["layers"] = layers
    return out


def quantize_mpt_params(params: Dict) -> Dict:
    """int8 weight-only quantization of the MPT decoder (models/mpt.py): the
    four projection kernels of each block (biases, norms and the tied wte
    stay). The llama quantizer's per-channel layout; mpt._dense dispatches
    on the 'scale' key."""
    return _quantize_mpt(params, quantize_kernel)


def quantize_mpt_params_host(params: Dict, layer_chunk: int = 8, device=None) -> Dict:
    """quantize_mpt_params for a HOST tree (models/mpt.py::convert_hf_mpt's),
    the projections streamed to `device` in layer chunks as
    quantize_llama_params_host streams them (the same bytes as the JAX
    host quantizer under `jit`); the other leaves are moved as they are."""
    device = resolve_device(device)
    out = _quantize_mpt(params, lambda k: quantize_kernel_host(
        k, layer_chunk=layer_chunk, device=device))
    return tree_map(lambda t: t.to(device), out)
