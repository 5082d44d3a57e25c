"""Attention dispatch: the plain masked attention and the flash kernel.

Port of teochat_tpu/ops/attention.py. `plain_attention` is the reference
(the JAX package's `xla_attention`): fp32 logits and softmax whatever the
input dtype. `dot_product_attention` sends a causal self-attention
(S == T) on a CUDA tensor, with no bias or with a key-separable one
(`bias_k` [H, T], ALiBi: the MPT backend), to the hand-written flash kernels
(ops/flash_attention.py): a right-padded one (the training forward) to the
differentiable `flash_attention_trainable_padded`, dropping the padding mask
as the JAX cache-free path does (causality hides the padded keys), and a
mask-free one (the prefill) to the inference kernel. Everything else, and
every CPU tensor, takes the plain path. Unlike the TPU rule there is no
length or head-dim gate: the kernels take every shape the model makes, and
raise on a CUDA shape or dtype they do not take rather than dropping to the
plain path.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, T, Hkv, D] -> [B, T, Hkv * n_rep, D] (GQA head expansion)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention. q [B,S,H,D], k/v [B,T,Hkv,D] -> [B,S,H,D].

    `mask` is boolean [B,T], [B,S,T] or [B,1,S,T] (True = attend); `bias` is
    additive [B|1, H|1, S, T]. A causal mask aligns the last query with the
    last key (offset T - S).
    """
    orig_dtype = q.dtype
    b, s, h, d = q.shape
    t = k.shape[1]
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        q_pos = torch.arange(s, device=q.device)[:, None] + (t - s)
        k_pos = torch.arange(t, device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, NEG_INF)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[:, None, None, :]
        elif mask.ndim == 3:
            mask = mask[:, None, :, :]
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).float(), v.float())
    return out.to(orig_dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    bias_k: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "auto",
    right_padded: bool = False,
) -> torch.Tensor:
    """Attention entry point. impl: auto | plain | flash.

    `right_padded` says that `mask` only marks right padding of a causal
    self-attention, so the flash kernels may drop it. `bias_k` [H, T] is a
    key-separable additive bias (ALiBi): unlike the general `bias` it stays
    eligible for the flash kernel; on the plain path it broadcasts to
    [1, H, 1, T]."""
    if bias is not None and bias_k is not None:
        raise ValueError("pass either bias or bias_k, not both")
    if impl == "auto":
        use_flash = (
            q.is_cuda
            and causal
            and bias is None
            and (mask is None or right_padded)
            and q.shape[1] == k.shape[1]
        )
        impl = "flash" if use_flash else "plain"
    if impl == "flash":
        from teochat_torch.ops import flash_attention as flash_mod

        if bias is not None or (mask is not None and not right_padded):
            raise ValueError("the flash kernels take no mask or bias")
        if right_padded:
            return flash_mod.flash_attention_trainable_padded(q, k, v, causal, scale,
                                                              bias_k=bias_k)
        return flash_mod.flash_attention(q, k, v, causal=causal, scale=scale, bias_k=bias_k)
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r}")
    if bias_k is not None:
        bias = bias_k[None, :, None, :]
    return plain_attention(q, k, v, bias=bias, mask=mask, causal=causal, scale=scale)
