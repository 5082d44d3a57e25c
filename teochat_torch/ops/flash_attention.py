"""Flash attention: the CUDA kernels' wrappers and their plain twins.

Port of teochat_tpu/ops/flash_attention.py:
- `flash_attention`, the inference forward (K1, `_flash_kernel`);
- `flash_attention_trainable` and `_padded`, the training attention: an
  autograd.Function whose forward is K4a (`_flash_fwd_res_kernel`: K1 plus
  each row's max m and denominator l) and whose backward computes
  di = rowsum(o * dO) in fp32 with torch ops, as the JAX package does outside
  its kernels, then launches K4b (dK, dV; `_bwd_dkv_kernel`) and K4c (dQ;
  `_bwd_dq_kernel`).
The kernels are csrc/flash_attention.cu (K1, K4a) and
csrc/flash_attention_bwd.cu (K4b, K4c); their source notes say what bounds
them on the card and how they are laid out. A CPU tensor goes to the plain
twin (ops/attention.py::plain_attention, with autograd for the trainable
one); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from teochat_torch.ops import _build
from teochat_torch.ops.attention import plain_attention

LAUNCHES = _build.LaunchCounter("flash_attention")  # K1
FWD_RES_LAUNCHES = _build.LaunchCounter("flash_attention_fwd_res")  # K4a
BWD_DKV_LAUNCHES = _build.LaunchCounter("flash_attention_bwd_dkv")  # K4b
BWD_DQ_LAUNCHES = _build.LaunchCounter("flash_attention_bwd_dq")  # K4c
HEAD_DIMS = (64, 128)


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch (fp32 logits and softmax)."""
    return plain_attention(q, k, v, causal=causal, scale=scale)


def _check_cuda_operands(q, k, v) -> None:
    _build.check_bf16_operand("q", q, 4)
    _build.check_bf16_operand("k", k, 4)
    _build.check_bf16_operand("v", v, 4)
    b, _, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {q.shape} k {k.shape} v {v.shape}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")


def _strides(*tensors):
    return [st for x in tensors for st in x.stride()[:3]]


def _flash_cuda(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    _check_cuda_operands(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # the K1 launch records no autograd graph: gradients would stop here
        raise ValueError("flash_attention has no backward; use flash_attention_trainable")
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib.call(
            "teochat_flash_attention_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, hkv, d, *_strides(q, k, v),
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


# ------------------------------------------------------------------ training


def _fwd_res_cuda(q, k, v, causal: bool, scale: float):
    """K4a: o [B, S, H, D] bf16 plus m and l, fp32 [B, H, S]."""
    _check_cuda_operands(q, k, v)
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib.call(
            "teochat_flash_attention_fwd_res",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(),
            b, s, t, h, hkv, d, *_strides(q, k, v),
            float(scale), int(causal), stream,
        )
    FWD_RES_LAUNCHES.count += 1
    return out, m, l


def _bwd_args(q, k, v, do, m, l, di, causal: bool, scale: float):
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(),
        b, s, t, h, hkv, d, *_strides(q, k, v, do),
        float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )


def _bwd_dkv_cuda(q, k, v, do, m, l, di, causal: bool, scale: float):
    """K4b: dk, dv [B, T, Hkv, D] from the forward's m, l and di = rowsum(o * dO)."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        _build.library().call("teochat_flash_attention_bwd_dkv",
                              *_bwd_args(q, k, v, do, m, l, di, causal, scale),
                              dk.data_ptr(), dv.data_ptr())
    BWD_DKV_LAUNCHES.count += 1
    return dk, dv


def _bwd_dq_cuda(q, k, v, do, m, l, di, causal: bool, scale: float):
    """K4c: dq [B, S, H, D]."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _build.library().call("teochat_flash_attention_bwd_dq",
                              *_bwd_args(q, k, v, do, m, l, di, causal, scale), dq.data_ptr())
    BWD_DQ_LAUNCHES.count += 1
    return dq


def _bwd_cuda(q, k, v, o, m, l, do, causal: bool, scale: float):
    """di = rowsum(o * dO) in fp32 [B, H, S], then K4b and K4c."""
    _build.check_bf16_operand("do", do, 4)
    if do.shape != q.shape:
        raise ValueError(f"flash backward: dO {do.shape} != q {q.shape}")
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = _bwd_dkv_cuda(q, k, v, do, m, l, di, causal, scale)
    return _bwd_dq_cuda(q, k, v, do, m, l, di, causal, scale), dk, dv


class _FlashTrainable(torch.autograd.Function):
    """K4a forward, K4b + K4c backward (the JAX custom_vjp's _fa_fwd/_fa_bwd)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, m, l = _fwd_res_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = _bwd_cuda(q, k, v, o, m, l, do.contiguous(), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_trainable(q, k, v, causal: bool = True, scale: Optional[float] = None,
                              *, bias_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable [B,S,H,D] attention; k/v [B,T,Hkv,D] with Hkv dividing H.

    On CUDA tensors the forward is K4a and the backward K4b and K4c; dK and
    dV sum the GQA group's gradient inside K4b. On CPU tensors it is autograd
    through the fp32 plain attention. As in the JAX function, right-padded
    causal batches need no mask: padded keys sit after every valid query,
    and padded queries' gradients arrive as zeros through the loss mask.
    `bias_k` (ALiBi, the MPT backend) is not ported yet and raises.
    """
    if bias_k is not None:
        raise NotImplementedError("flash_attention_trainable: bias_k (ALiBi) is not ported yet")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash attention needs S == T, got {q.shape[1]}, {k.shape[1]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _FlashTrainable.apply(q, k, v, causal, float(scale))
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention_trainable: no kernel for device {q.device}")
    return plain_attention(q, k, v, causal=causal, scale=scale)


def flash_attention_trainable_padded(q, k, v, causal: bool = True,
                                     scale: Optional[float] = None, *,
                                     bias_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flash_attention_trainable for any sequence length (causal only).

    The TPU wrapper pads S and T to its 128-row tile and slices the output
    back. K4a-c mask a ragged last tile per element (keys past T take the
    mask value, rows past S are read as zeros and written nowhere), which
    gives the real rows the same values and gradients as the pad (padded
    keys sit after every real query; padded queries get zero dO), so here
    the pad is not needed and nothing is copied.
    """
    if not causal:
        raise ValueError(
            "padded flash attention requires causal=True (zero-padded keys "
            "would be attended under a non-causal mask); use the plain path"
        )
    return flash_attention_trainable(q, k, v, True, scale, bias_k=bias_k)
