"""Flash-attention forward: the CUDA kernel's wrapper and its plain twin.

Port of teochat_tpu/ops/flash_attention.py::flash_attention (the forward
kernel `_flash_kernel`). The kernel is csrc/flash_attention.cu; its source
note says what bounds it on the card and how it is laid out. A CPU tensor
goes to the plain twin (ops/attention.py::plain_attention); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from teochat_torch.ops import _build
from teochat_torch.ops.attention import plain_attention

LAUNCHES = _build.LaunchCounter("flash_attention")
HEAD_DIMS = (64, 128)


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch (fp32 logits and softmax)."""
    return plain_attention(q, k, v, causal=causal, scale=scale)


def _flash_cuda(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    _build.check_bf16_operand("q", q, 4)
    _build.check_bf16_operand("k", k, 4)
    _build.check_bf16_operand("v", v, 4)
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {q.shape} k {k.shape} v {v.shape}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib.call(
            "teochat_flash_attention_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, hkv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), stream,
        )
    LAUNCHES.count += 1
    return out


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    bias_k: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B,S,H,D] attention; GQA kv heads are shared, never expanded.

    A causal call is a self-attention prefill (S == T), as for the TPU
    kernel. There is no mask argument: right-padded causal prompts need none
    (padded keys sit after every valid query). `bias_k` (ALiBi, the MPT
    backend) is not supported yet and raises.
    """
    if bias_k is not None:
        raise NotImplementedError("flash_attention: bias_k (ALiBi) is not ported yet")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash attention needs S == T, got {q.shape[1]}, {k.shape[1]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_cuda(q, k, v, causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, scale=scale)
