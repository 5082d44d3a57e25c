"""Decode attention over the KV cache: the CUDA kernel's wrapper and its twin.

Port of teochat_tpu/ops/decode_attention.py::decode_attention (the kernel
`_decode_kernel`). On the TPU an XLA fusion did this work and the kernel
stayed unwired; the port has no XLA, so the kernel (csrc/decode_attention.cu)
runs every decode step. The plain twin is the JAX function's `impl="xla"`
branch. A CPU tensor goes to the twin; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from teochat_torch.ops import _build
from teochat_torch.ops.attention import NEG_INF

LAUNCHES = _build.LaunchCounter("decode_attention")
HEAD_DIMS = (64, 128)
GROUP_SIZES = (1, 2, 4, 8)


def decode_attention_plain(q, k_cache, v_cache, lengths, *, scale=None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch, in fp32.

    q [B, H, D]; k_cache, v_cache [B, Hkv, T, D]; lengths [B]."""
    b, h, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    kf = k_cache.float().repeat_interleave(h // hkv, dim=1)
    vf = v_cache.float().repeat_interleave(h // hkv, dim=1)
    logits = torch.einsum("bhd,bhtd->bht", q.float(), kf) * scale
    live = torch.arange(t, device=q.device)[None, None, :] < lengths.to(q.device)[:, None, None]
    probs = torch.softmax(torch.where(live, logits, NEG_INF), dim=-1)
    return torch.einsum("bht,bhtd->bhd", probs, vf).to(q.dtype)


def _decode_cuda(q, k_cache, v_cache, lengths, scale: float) -> torch.Tensor:
    _build.check_bf16_operand("q", q, 3)
    _build.check_bf16_operand("k_cache", k_cache, 4)
    _build.check_bf16_operand("v_cache", v_cache, 4)
    b, h, d = q.shape
    _, hkv, t, _ = k_cache.shape
    if d not in HEAD_DIMS or h % hkv or h // hkv not in GROUP_SIZES:
        raise ValueError(
            f"decode_attention: head_dim {d} (need {HEAD_DIMS}) or group "
            f"{h}/{hkv} (need {GROUP_SIZES}) not supported"
        )
    if k_cache.shape != (b, hkv, t, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: shapes q {q.shape} k {k_cache.shape} v {v_cache.shape}")
    if lengths.shape != (b,) or lengths.device != q.device or lengths.dtype != torch.int32:
        raise ValueError("decode_attention: lengths must be int32 [B] on q's device")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("decode_attention: q and the cache on different devices")
    lengths = lengths.contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib.call(
            "teochat_decode_attention",
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            b, h, hkv, t, d,
            q.stride(0), q.stride(1),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            float(scale), stream,
        )
    LAUNCHES.count += 1
    return out


def decode_attention(
    q: torch.Tensor,  # [B, H, D] one query per row
    k_cache: torch.Tensor,  # [B, Hkv, T, D], any strides with D contiguous
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] live prefix length per row
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-step attention against the cache; returns [B, H, D].

    impl: auto | plain | kernel. "auto" launches the kernel for a CUDA tensor
    and takes the plain twin for a CPU tensor. The cache may be a strided
    view, e.g. the layer slab of the [L, B, T, Hkv, D] buffer transposed to
    [B, Hkv, T, D]: the kernel reads it in place.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        if q.is_cuda:
            impl = "kernel"
        elif q.device.type == "cpu":
            impl = "plain"
        else:
            raise ValueError(f"decode_attention: no kernel for device {q.device}")
    if impl == "kernel":
        return _decode_cuda(q, k_cache, v_cache, lengths, scale)
    if impl != "plain":
        raise ValueError(f"unknown decode attention impl {impl!r}")
    return decode_attention_plain(q, k_cache, v_cache, lengths, scale=scale)
