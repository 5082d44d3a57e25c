"""One-shot short-sequence attention for the ViT: the CUDA kernel's wrapper and its plain version.

Port of teochat_tpu/ops/vit_attention.py::vit_attention (the kernel
`_attn_kernel`). The encoder's spatial attention (S = 257 tokens, 16 heads
of 64) in plain PyTorch materializes the [B, H, S, S] score matrices in
device memory; the kernel (csrc/vit_attention.cu) computes scores, an exact
softmax and PV without writing anything but the output. On the TPU the
kernel stayed opt-in because XLA fused the attention with its neighbours;
the port has no such fusion, so models/vit.py routes the spatial attention
here. Forward only: the vision tower is frozen in every TEOChat recipe.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises (head_dim other than 64, S outside [64, 1024]); nothing falls back to
the plain version on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from teochat_torch.ops import _build
from teochat_torch.ops.attention import plain_attention

LAUNCHES = _build.LaunchCounter("vit_attention")
HEAD_DIM = 64
MIN_SEQ, MAX_SEQ = 64, 1024  # the JAX function's gate for its kernel


def in_kernel_range(seq_len: int) -> bool:
    """Whether the one-shot kernel is the intended path at this length (the
    temporal attention over a handful of frames is not)."""
    return MIN_SEQ <= seq_len <= MAX_SEQ


def vit_attention_plain(q, k, v, *, scale: Optional[float] = None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: bidirectional softmax attention."""
    return plain_attention(q, k, v, causal=False, scale=scale)


def _vit_attention_cuda(q, k, v, scale: float) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_bf16_operand(name, t, 4)
    b, s, h, d = q.shape
    if d != HEAD_DIM or not in_kernel_range(s):
        raise ValueError(
            f"vit_attention: head_dim {d} (need {HEAD_DIM}) or S {s} "
            f"(need {MIN_SEQ}..{MAX_SEQ}) not supported"
        )
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"vit_attention: shapes q {q.shape} k {k.shape} v {v.shape}")
    if not (q.device == k.device == v.device):
        raise ValueError("vit_attention: q, k and v on different devices")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch(
        "teochat_vit_attention", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale),
    )
    LAUNCHES.count += 1
    return out


def vit_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Bidirectional attention for short sequences; returns [B, S, H, D].

    impl: auto | plain | kernel. "auto" launches the kernel for a CUDA tensor
    and takes the plain version for a CPU tensor."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        if q.is_cuda:
            impl = "kernel"
        elif q.device.type == "cpu":
            impl = "plain"
        else:
            raise ValueError(f"vit_attention: no kernel for device {q.device}")
    if impl == "kernel":
        return _vit_attention_cuda(q, k, v, scale)
    if impl != "plain":
        raise ValueError(f"unknown vit attention impl {impl!r}")
    return vit_attention_plain(q, k, v, scale=scale)
