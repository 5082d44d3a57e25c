"""One-shot short-sequence attention for the ViT: the CUDA kernel's wrapper and its plain version.

Port of teochat_tpu/ops/vit_attention.py::vit_attention (the kernel
`_attn_kernel`). The encoder's spatial attention (S = 257 tokens, 16 heads
of 64) in plain PyTorch materializes the [B, H, S, S] score matrices in
device memory; the kernel (csrc/vit_attention.cu) computes scores, an exact
softmax and PV without writing anything but the output. On the TPU the
kernel stayed opt-in because XLA fused the attention with its neighbours;
the port has no such fusion, so models/vit.py routes the spatial attention
here. Forward only: the vision tower is frozen in every TEOChat recipe.

The kernel computes every score once: keys come in windows of 272 (two
`wgmma` products, 256 + 16 keys), whose scores a 64-row query tile holds in
registers whole, so up to S = 272 its softmax is exact as the TPU kernel's;
past that it walks several windows with one online rescale between them.
`vit_attention_schedule` is that walk in plain PyTorch, held against the
Pallas kernel on the CPU by the tests.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises (head_dim other than 64, S outside [64, 1024]); nothing falls back to
the plain version on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from teochat_torch.ops import _build
from teochat_torch.ops.attention import NEG_INF, plain_attention

LAUNCHES = _build.LaunchCounter("vit_attention")
HEAD_DIM = 64
MIN_SEQ, MAX_SEQ = 64, 1024  # the JAX function's gate for its kernel
TILE_Q = 64  # query rows a consumer warpgroup of the kernel takes
WINDOW = 272  # keys whose scores a query tile holds at once (256 + 16)


def in_kernel_range(seq_len: int) -> bool:
    """Whether the one-shot kernel is the intended path at this length (the
    temporal attention over a handful of frames is not)."""
    return MIN_SEQ <= seq_len <= MAX_SEQ


def vit_attention_plain(q, k, v, *, scale: Optional[float] = None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: bidirectional softmax attention."""
    return plain_attention(q, k, v, causal=False, scale=scale)


def vit_attention_schedule(q, k, v, *, scale: Optional[float] = None,
                           window: int = WINDOW, tile_q: int = TILE_Q) -> torch.Tensor:
    """The kernel's schedule, window by window, in plain PyTorch.

    As in csrc/vit_attention.cu: query tiles of `tile_q` rows (rows past S
    read as zeros) walk the keys in windows of `window`; keys past S are read
    as zeros and then masked; scores are scaled into base-2 units; each
    window's row maximum updates the running one, and the fp32 sum and
    accumulator are rescaled by 2^(m_old - m_new) (0 in the first window, so
    a single window, S <= 272, is the exact softmax with no rescale); P is
    rounded to v's dtype (bf16 on the card) before P V; o = acc / l in q's
    dtype. [B, S, H, D] in, [B, S, H, D] out."""
    b, s, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    log2e = 1.4426950408889634
    c2 = scale * log2e
    pad_s, pad_t = -s % tile_q, -s % window
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, pad_s)).float()
    kp = pad(k, (0, 0, 0, 0, 0, pad_t)).float()
    vp = pad(v, (0, 0, 0, 0, 0, pad_t))
    o = torch.zeros((b, s + pad_s, h, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s + pad_s, tile_q):
        m = torch.full((b, h, tile_q), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, tile_q, d), device=q.device)
        for k0 in range(0, s + pad_t, window):
            sc = torch.einsum("bshd,bthd->bhst", qp[:, q0:q0 + tile_q],
                              kp[:, k0:k0 + window]) * c2
            dead = torch.arange(k0, k0 + window, device=q.device) >= s
            sc = torch.where(dead, NEG_INF, sc)
            m_next = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2(m - m_next)
            p = torch.exp2(sc - m_next[..., None])
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhst,bthd->bhsd", p.to(v.dtype).float(), vp[:, k0:k0 + window].float())
            m = m_next
        o[:, q0:q0 + tile_q] = (acc / l[..., None]).transpose(1, 2)
    return o[:, :s].to(q.dtype)


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
