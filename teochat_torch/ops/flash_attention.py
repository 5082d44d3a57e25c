"""Flash attention: the CUDA kernels' wrappers and their plain twins.

Port of teochat_tpu/ops/flash_attention.py:
- `flash_attention`, the inference forward (K1, `_flash_kernel`);
- `flash_attention_trainable` and `_padded`, the training attention: an
  autograd.Function whose forward is K4a (`_flash_fwd_res_kernel`: K1 plus
  each row's max m and denominator l) and whose backward launches a small
  preamble kernel for di = rowsum(o * dO) (fp32 [B, H, S]; the JAX package
  computes it outside its kernels), then K4b (dK, dV; `_bwd_dkv_kernel`) and
  K4c (dQ; `_bwd_dq_kernel`).
The kernels are csrc/flash_attention.cu (K1, K4a) and
csrc/flash_attention_bwd.cu (di, K4b, K4c): persistent `wgmma` kernels fed by
TMA loads through a ring of shared-memory tiles; their source notes say what
bounds them on the card and how they are laid out. A CPU tensor goes to the
plain twin (ops/attention.py::plain_attention, with autograd for the
trainable one); a CUDA tensor launches the kernels or raises.
Every kernel takes the JAX kernels' optional key-separable bias `bias_k`
[H, T] fp32 (ALiBi, the MPT backend: models/mpt.py), added to each scaled
score before the causal mask, as the Pallas kernels add their [1, block_k]
tile: K1 and K4a (csrc/flash_attention.cu) and K4b and K4c
(csrc/flash_attention_bwd.cu) as a BIAS template branch, each head's table
taken relative to its last key's bias. The table is a constant: it gets no
gradient, as JAX's custom_vjp gives it zeros. A launch with a bias is
counted on the branch's own counter (LAUNCHES_BIAS, FWD_RES_BIAS_LAUNCHES,
BWD_DKV_BIAS_LAUNCHES, BWD_DQ_BIAS_LAUNCHES), one without it on the
bias-free one, so that a run tells the branches apart.
`flash_forward_schedule`, `flash_backward_dkv_schedule` and
`flash_backward_dq_schedule` walk the kernels' tiles in plain PyTorch, so
that their schedules can be held against the JAX kernels without a card.
"""

from __future__ import annotations

from typing import Optional

import torch

from teochat_torch.ops import _build
from teochat_torch.ops.attention import NEG_INF, _repeat_kv, plain_attention

LAUNCHES = _build.LaunchCounter("flash_attention")  # K1
LAUNCHES_BIAS = _build.LaunchCounter("flash_attention_bias")  # K1 with bias_k
FWD_RES_LAUNCHES = _build.LaunchCounter("flash_attention_fwd_res")  # K4a
BWD_DKV_LAUNCHES = _build.LaunchCounter("flash_attention_bwd_dkv")  # K4b
BWD_DQ_LAUNCHES = _build.LaunchCounter("flash_attention_bwd_dq")  # K4c
# the same three with bias_k
FWD_RES_BIAS_LAUNCHES = _build.LaunchCounter("flash_attention_fwd_res_bias")
BWD_DKV_BIAS_LAUNCHES = _build.LaunchCounter("flash_attention_bwd_dkv_bias")
BWD_DQ_BIAS_LAUNCHES = _build.LaunchCounter("flash_attention_bwd_dq_bias")
HEAD_DIMS = (64, 128)
# the forward kernel's tiles (csrc/flash_attention.cu: TEOCHAT_FLASH_BQ, _BK)
FWD_BLOCK_Q = 128  # query rows a tile: two warpgroups of 64
FWD_BLOCK_K = 128  # keys a kv tile
# the backward kernels' tiles (csrc/flash_attention_bwd.cu: DKV_BK, DKV_BQ, DQ_BQ, DQ_BK)
BWD_DKV_BLOCK_K = 128  # K4b: keys a block owns, two warpgroups of 64
BWD_DKV_BLOCK_Q = 64  # K4b: query rows a step of the ring
BWD_DQ_BLOCK_Q = 128  # K4c: query rows a block owns, two warpgroups of 64
BWD_DQ_BLOCK_K = 64  # K4c: keys a step of the ring


def _bias_4d(bias_k: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[H, T] -> the [1, H, 1, T] additive bias of the plain attention."""
    return None if bias_k is None else bias_k.float()[None, :, None, :]


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None,
                          bias_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch (fp32 logits and softmax)."""
    return plain_attention(q, k, v, causal=causal, scale=scale, bias=_bias_4d(bias_k))


def flash_statistics_plain(q, k, v, *, causal: bool = True, scale=None,
                           bias_k: Optional[torch.Tensor] = None):
    """What K4a stores beside o, in plain PyTorch: each row's largest scaled
    score m (plus its key's bias_k) and the sum l of exp(score - m) over its
    keys, fp32 [B, H, S]."""
    b, s, h, d = q.shape
    t = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(),
                          _repeat_kv(k, h // k.shape[2]).float()) * scale
    if bias_k is not None:
        logits = logits + _bias_4d(bias_k)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None] + (t - s)
        logits = torch.where(rows >= torch.arange(t, device=q.device)[None, :], logits, NEG_INF)
    m = logits.amax(-1)
    return m, torch.exp(logits - m[..., None]).sum(-1)


def flash_forward_schedule(q, k, v, *, causal: bool = True, scale=None,
                           block_q: int = FWD_BLOCK_Q, block_k: int = FWD_BLOCK_K,
                           bias_k: Optional[torch.Tensor] = None):
    """The forward kernel's schedule, tile by tile, in plain PyTorch.

    Returns (o [B, S, H, D] in q's dtype, m, l fp32 [B, H, S]). As in
    csrc/flash_attention.cu: a tile of `block_q` query rows walks the kv
    tiles of `block_k` keys up to its diagonal; rows past S and keys past T
    are read as zeros, and keys past T are then masked; scores are scaled
    into base-2 units, the running maximum, sum and accumulator are fp32, P
    is rounded to v's dtype (bf16 on the card) before P V; a row whose sum
    is 0 is written as 0; m leaves in natural units. With `bias_k` [H, T]
    each head's table is taken relative to its last key's bias bref (the
    kernel's shift: softmax does not move, and the scores stay near 0 where
    fp32 is finer), each score is s c2 + (bias - bref) log2(e), formed before
    the mask (a key past T reads 0), the row maximum is taken over those, and
    bref is added back to m. (The order in which a block takes its tiles,
    and which warpgroup multiplies when, move no number.)"""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    log2e = 1.4426950408889634
    c2 = scale * log2e
    pad_s, pad_t = -s % block_q, -t % block_k
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_s)).float()
    kp = torch.nn.functional.pad(_repeat_kv(k, h // hkv), (0, 0, 0, 0, 0, pad_t)).float()
    vp = torch.nn.functional.pad(_repeat_kv(v, h // hkv), (0, 0, 0, 0, 0, pad_t))
    bl, bref = None, torch.zeros((1, h, 1), device=q.device)
    if bias_k is not None and t > 0:  # [1, H, 1, T + pad] in base-2 units, relative to bref
        bref = bias_k.float()[None, :, t - 1:]
        bl = torch.nn.functional.pad(bias_k.float() - bref[0], (0, pad_t))[None, :, None, :] * log2e
    o = torch.zeros((b, s + pad_s, h, d), dtype=torch.float32, device=q.device)
    m_out = torch.zeros((b, h, s + pad_s), dtype=torch.float32, device=q.device)
    l_out = torch.zeros_like(m_out)
    for q0 in range(0, s + pad_s, block_q):
        n_kv = (t + pad_t) // block_k
        if causal:
            n_kv = min(n_kv, (q0 + block_q - 1) // block_k + 1)
        rows = torch.arange(q0, q0 + block_q, device=q.device)
        m = torch.full((b, h, block_q), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for j in range(n_kv):
            k0 = j * block_k
            cols = torch.arange(k0, k0 + block_k, device=q.device)
            sc = torch.einsum("bshd,bthd->bhst", qp[:, q0:q0 + block_q],
                              kp[:, k0:k0 + block_k]) * c2
            if bl is not None:
                sc = sc + bl[..., k0:k0 + block_k]
            dead = (cols >= t)[None, :]
            if causal:
                dead = dead | (cols[None, :] > rows[:, None])
            sc = torch.where(dead, NEG_INF, sc)
            m_next = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2(m - m_next)
            p = torch.exp2(sc - m_next[..., None])
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhst,bthd->bhsd", p.to(v.dtype).float(), vp[:, k0:k0 + block_k].float())
            m = m_next
        inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
        o[:, q0:q0 + block_q] = (acc * inv[..., None]).transpose(1, 2)
        m_out[:, :, q0:q0 + block_q] = m / log2e + bref
        l_out[:, :, q0:q0 + block_q] = l
    return o[:, :s].to(q.dtype), m_out[:, :, :s].contiguous(), l_out[:, :, :s].contiguous()


def flash_di_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * dO) in fp32, [B, S, H, D] x 2 -> [B, H, S]: what the
    backward's preamble kernel computes."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _backward_operands(q, k, v, do, m, l, di, block_q: int, block_k: int, bias_k=None):
    """The backward tile walks' inputs: q, k, v, dO in fp32 with rows past S
    and keys past T as zeros (k and v expanded to the q heads), the rows'
    m, 1 / l (1 where l == 0) and di, padded with 0, 1 and 0, and the bias
    table [1, H, 1, T] (None without one) taken relative to each head's last
    key's bias bref, keys past T 0, with m - bref in place of m (the
    kernels' shift: p does not move, and the scores stay near 0 where fp32
    is finer)."""
    h, hkv, t = q.shape[2], k.shape[2], k.shape[1]
    pad_s, pad_t = -q.shape[1] % block_q, -k.shape[1] % block_k
    pad = torch.nn.functional.pad
    qp, dop = (pad(x, (0, 0, 0, 0, 0, pad_s)).float() for x in (q, do))
    kp, vp = (pad(_repeat_kv(x, h // hkv), (0, 0, 0, 0, 0, pad_t)).float() for x in (k, v))
    linv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    bl = None
    if bias_k is not None and t > 0:
        bref = bias_k.float()[:, t - 1:]  # [H, 1]
        bl = pad(bias_k.float() - bref, (0, pad_t))[None, :, None, :]
        m = m - bref[None]
    return (qp, kp, vp, dop, pad(m, (0, pad_s)), pad(linv, (0, pad_s), value=1.0),
            pad(di, (0, pad_s)), bl)


def _backward_tile(qt, kt, vt, dot, m, linv, di, q0: int, k0: int, t: int,
                   causal: bool, scale: float, dtype, bl=None):
    """P and dS of one (query tile, kv tile) pair, [B, H, rows, keys], each
    rounded to `dtype` as the kernels round them before their products. `bl`
    is this tile's slice of the relative bias table, m the rows' maxima
    relative to it, as `_backward_operands` makes them."""
    rows = torch.arange(q0, q0 + qt.shape[1], device=qt.device)
    cols = torch.arange(k0, k0 + kt.shape[1], device=qt.device)
    sc = torch.einsum("bshd,bthd->bhst", qt, kt) * scale
    if bl is not None:
        sc = sc + bl
    dead = (cols >= t)[None, :]
    if causal:
        dead = dead | (cols[None, :] > rows[:, None])
    p = torch.exp(torch.where(dead, NEG_INF, sc) - m[..., None]) * linv[..., None]
    dp = torch.einsum("bshd,bthd->bhst", dot, vt)
    ds = p * (dp - di[..., None])
    return p.to(dtype).float(), ds.to(dtype).float()


def flash_backward_dkv_schedule(q, k, v, do, m, l, di, *, causal: bool = True, scale=None,
                                block_q: int = BWD_DKV_BLOCK_Q,
                                block_k: int = BWD_DKV_BLOCK_K,
                                bias_k: Optional[torch.Tensor] = None):
    """K4b's schedule, tile by tile, in plain PyTorch: (dk, dv) [B, T, Hkv, D]
    in k's dtype from q, k, v, dO and the rows' m, l and di (fp32 [B, H, S]).

    As in csrc/flash_attention_bwd.cu: a block owns `block_k` keys and walks,
    for each q head of its kv head's group, the tiles of `block_q` query rows
    at or below its diagonal; rows past S and keys past T are read as zeros,
    keys past T and above the diagonal are masked; p = exp(s - m) / l with
    1 / l = 1 where l == 0, ds = p (dp - di); P and dS are rounded to the
    inputs' dtype before dV += P^T dO and dK += dS^T Q; the sums are fp32
    over the whole walk (the group's heads included) and `scale` meets the
    fp32 dK before its one rounding. With `bias_k` [H, T] (the table K4a's m
    and l were taken with) each key's bias is added to the scaled score
    before the mask, relative to the head's last key's bias as K4a took it:
    s + (bias - bref), against m - bref."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qp, kp, vp, dop, mp, linv, dip, bl = _backward_operands(q, k, v, do, m, l, di, block_q,
                                                            block_k, bias_k)
    dk = torch.zeros((b, kp.shape[1], h, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, kp.shape[1], block_k):
        # q tiles wholly above the diagonal are skipped
        first = (k0 // block_q) * block_q if causal else 0
        for q0 in range(first, qp.shape[1], block_q):
            rows, keys = slice(q0, q0 + block_q), slice(k0, k0 + block_k)
            p, ds = _backward_tile(qp[:, rows], kp[:, keys], vp[:, keys], dop[:, rows],
                                   mp[..., rows], linv[..., rows], dip[..., rows],
                                   q0, k0, t, causal, scale, q.dtype,
                                   None if bl is None else bl[..., keys])
            dv[:, keys] += torch.einsum("bhst,bshd->bthd", p, dop[:, rows])
            dk[:, keys] += torch.einsum("bhst,bshd->bthd", ds, qp[:, rows])

    def group_sum(x):  # [B, T, H, D] -> [B, T, Hkv, D]: the group's heads into their kv head
        return x[:, :t].reshape(b, t, hkv, h // hkv, d).sum(3)

    return (group_sum(dk) * scale).to(k.dtype), group_sum(dv).to(v.dtype)


def flash_backward_dq_schedule(q, k, v, do, m, l, di, *, causal: bool = True, scale=None,
                               block_q: int = BWD_DQ_BLOCK_Q, block_k: int = BWD_DQ_BLOCK_K,
                               bias_k: Optional[torch.Tensor] = None):
    """K4c's schedule, tile by tile, in plain PyTorch: dq [B, S, H, D] in q's
    dtype. A block owns `block_q` query rows and walks the kv tiles of
    `block_k` keys up to its diagonal; padding, masking, the bias, p, ds and
    the rounding of dS as in `flash_backward_dkv_schedule`; dQ += dS K in
    fp32, times `scale` before the one rounding."""
    b, s, h, d = q.shape
    t = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qp, kp, vp, dop, mp, linv, dip, bl = _backward_operands(q, k, v, do, m, l, di, block_q,
                                                            block_k, bias_k)
    dq = torch.zeros(qp.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, qp.shape[1], block_q):
        n_kv = kp.shape[1] // block_k
        if causal:
            n_kv = min(n_kv, (q0 + block_q - 1) // block_k + 1)
        rows = slice(q0, q0 + block_q)
        for k0 in range(0, n_kv * block_k, block_k):
            keys = slice(k0, k0 + block_k)
            _, ds = _backward_tile(qp[:, rows], kp[:, keys], vp[:, keys], dop[:, rows],
                                   mp[..., rows], linv[..., rows], dip[..., rows],
                                   q0, k0, t, causal, scale, q.dtype,
                                   None if bl is None else bl[..., keys])
            dq[:, rows] += torch.einsum("bhst,bthd->bshd", ds, kp[:, keys])
    return (dq[:, :s] * scale).to(q.dtype)


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


def _check_bias_shape(bias_k: Optional[torch.Tensor], q, k) -> None:
    if bias_k is not None and tuple(bias_k.shape) != (q.shape[2], k.shape[1]):
        raise ValueError(f"bias_k shape {tuple(bias_k.shape)} != (H={q.shape[2]}, "
                         f"T={k.shape[1]})")


def _bias_operand(bias_k: Optional[torch.Tensor], q) -> Optional[torch.Tensor]:
    """The [H, T] table as the kernel reads it (None stays None): fp32 on q's
    device, each row contiguous. A row-strided view (a cache-sized table's
    first T columns, models/mpt.py) is read in place: the kernel takes the
    rows' stride."""
    if bias_k is None:
        return None
    if bias_k.device != q.device:
        raise ValueError(f"flash_attention: bias_k on {bias_k.device}, q on {q.device}")
    bias_k = bias_k.to(torch.float32)
    return bias_k if bias_k.stride(-1) == 1 else bias_k.contiguous()


def _bias_ptr(bias_k: Optional[torch.Tensor]) -> tuple:
    """(pointer, rows' stride) of the table for the C entries; (0, 0) for none.
    The caller keeps the tensor alive across the launch."""
    return (0, 0) if bias_k is None else (bias_k.data_ptr(), bias_k.stride(0))


def _flash_cuda(q, k, v, causal: bool, scale: float,
                bias_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_cuda_operands(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # the K1 launch records no autograd graph: gradients would stop here
        raise ValueError("flash_attention has no backward; use flash_attention_trainable")
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    bias_k = _bias_operand(bias_k, q)
    bias_ptr, bias_sh = _bias_ptr(bias_k)
    _build.launch(
        "teochat_flash_attention_fwd", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bias_ptr,
        b, s, t, h, hkv, d, *_strides(q, k, v), bias_sh,
        float(scale), int(causal),
    )
    (LAUNCHES if bias_k is None else LAUNCHES_BIAS).count += 1
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
    (padded keys sit after every valid query). `bias_k` [H, T] (fp32; ALiBi,
    the MPT backend) is added to each query head's scaled scores, by key,
    before the causal mask.
    """
    _check_bias_shape(bias_k, q, k)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash attention needs S == T, got {q.shape[1]}, {k.shape[1]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_cuda(q, k, v, causal, scale, bias_k)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, scale=scale, bias_k=bias_k)


# ------------------------------------------------------------------ training


def _fwd_res_cuda(q, k, v, causal: bool, scale: float, bias_k: Optional[torch.Tensor] = None):
    """K4a: o [B, S, H, D] bf16 plus m and l, fp32 [B, H, S]; with `bias_k`
    [H, T] the biased scores' (K1's bias branch)."""
    _check_cuda_operands(q, k, v)
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l
    bias_k = _bias_operand(bias_k, q)
    bias_ptr, bias_sh = _bias_ptr(bias_k)
    _build.launch(
        "teochat_flash_attention_fwd_res", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), bias_ptr,
        b, s, t, h, hkv, d, *_strides(q, k, v), bias_sh,
        float(scale), int(causal),
    )
    (FWD_RES_LAUNCHES if bias_k is None else FWD_RES_BIAS_LAUNCHES).count += 1
    return out, m, l


def _bwd_args(q, k, v, do, m, l, di, causal: bool, scale: float,
              bias_k: Optional[torch.Tensor] = None):
    """The backward entries' arguments before their outputs; `bias_k` as
    `_bias_operand` gives it (kept alive by the caller across the launch)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    bias_ptr, bias_sh = _bias_ptr(bias_k)
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(), bias_ptr,
        b, s, t, h, hkv, d, *_strides(q, k, v, do), bias_sh,
        float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )


def _bwd_dkv_cuda(q, k, v, do, m, l, di, causal: bool, scale: float,
                  bias_k: Optional[torch.Tensor] = None):
    """K4b: dk, dv [B, T, Hkv, D] from the forward's m, l and di = rowsum(o * dO);
    with `bias_k` [H, T], the table the forward's m and l were taken with."""
    _check_bias_shape(bias_k, q, k)
    bias_k = _bias_operand(bias_k, q)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        _build.library().call("teochat_flash_attention_bwd_dkv",
                              *_bwd_args(q, k, v, do, m, l, di, causal, scale, bias_k),
                              dk.data_ptr(), dv.data_ptr())
    (BWD_DKV_LAUNCHES if bias_k is None else BWD_DKV_BIAS_LAUNCHES).count += 1
    return dk, dv


def _bwd_dq_cuda(q, k, v, do, m, l, di, causal: bool, scale: float,
                 bias_k: Optional[torch.Tensor] = None):
    """K4c: dq [B, S, H, D]; `bias_k` as for K4b."""
    _check_bias_shape(bias_k, q, k)
    bias_k = _bias_operand(bias_k, q)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _build.library().call("teochat_flash_attention_bwd_dq",
                              *_bwd_args(q, k, v, do, m, l, di, causal, scale, bias_k),
                              dq.data_ptr())
    (BWD_DQ_LAUNCHES if bias_k is None else BWD_DQ_BIAS_LAUNCHES).count += 1
    return dq


def _bwd_di_cuda(o, do):
    """The backward's preamble kernel: di = rowsum(o * dO), fp32 [B, H, S]."""
    _build.check_bf16_operand("o", o, 4)
    _build.check_bf16_operand("do", do, 4)
    b, s, h, d = o.shape
    if do.shape != o.shape or d not in HEAD_DIMS:
        raise ValueError(f"flash backward: o {o.shape}, dO {do.shape}, head_dim in {HEAD_DIMS}")
    if not (o.is_contiguous() and do.is_contiguous()):
        raise ValueError("flash backward: o and dO must be contiguous")
    di = torch.empty((b, h, s), dtype=torch.float32, device=o.device)
    _build.launch("teochat_flash_attention_bwd_di", o, o.data_ptr(), do.data_ptr(),
                  di.data_ptr(), b, s, h, d)
    return di


def _bwd_cuda(q, k, v, o, m, l, do, causal: bool, scale: float,
              bias_k: Optional[torch.Tensor] = None):
    """di = rowsum(o * dO) in fp32 [B, H, S] (the preamble kernel), then K4b and
    K4c, with the bias branch where `bias_k` is given."""
    if do.shape != q.shape:
        raise ValueError(f"flash backward: dO {do.shape} != q {q.shape}")
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    di = _bwd_di_cuda(o, do)
    dk, dv = _bwd_dkv_cuda(q, k, v, do, m, l, di, causal, scale, bias_k)
    return _bwd_dq_cuda(q, k, v, do, m, l, di, causal, scale, bias_k), dk, dv


class _FlashTrainable(torch.autograd.Function):
    """K4a forward, K4b + K4c backward (the JAX custom_vjp's _fa_fwd/_fa_bwd),
    each with its bias branch where a table is given. The table is a
    constant: its gradient is None (JAX's is zeros)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, bias_k=None):
        o, m, l = _fwd_res_cuda(q, k, v, causal, scale, bias_k)
        ctx.save_for_backward(q, k, v, o, m, l, None if bias_k is None else bias_k.detach())
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l, bias_k = ctx.saved_tensors
        dq, dk, dv = _bwd_cuda(q, k, v, o, m, l, do.contiguous(), ctx.causal, ctx.scale, bias_k)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q, k, v, causal: bool = True, scale: Optional[float] = None,
                              *, bias_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable [B,S,H,D] attention; k/v [B,T,Hkv,D] with Hkv dividing H.

    On CUDA tensors the forward is K4a and the backward K4b and K4c; dK and
    dV sum the GQA group's gradient inside K4b. On CPU tensors it is autograd
    through the fp32 plain attention. As in the JAX function, right-padded
    causal batches need no mask: padded keys sit after every valid query,
    and padded queries' gradients arrive as zeros through the loss mask.
    `bias_k` [H, T] (ALiBi, the MPT backend) is a constant table, as in the
    JAX function (its cotangent is zero): on CUDA tensors the forward and
    backward run the kernels' bias branches, and the table gets no gradient.
    """
    _check_bias_shape(bias_k, q, k)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash attention needs S == T, got {q.shape[1]}, {k.shape[1]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _FlashTrainable.apply(q, k, v, causal, float(scale), bias_k)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention_trainable: no kernel for device {q.device}")
    return plain_attention(q, k, v, causal=causal, scale=scale,
                           bias=None if bias_k is None else _bias_4d(bias_k.detach()))


def flash_attention_trainable_padded(q, k, v, causal: bool = True,
                                     scale: Optional[float] = None, *,
                                     bias_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flash_attention_trainable for any sequence length (causal only).

    The TPU wrapper pads S and T to its 128-row tile and slices the output
    back. K4a-c mask a ragged last tile per element (keys past T take the
    mask value, rows past S are read as zeros and written nowhere), which
    gives the real rows the same values and gradients as the pad (padded
    keys sit after every real query; padded queries get zero dO), so here
    the pad is not needed and nothing is copied: nor is `bias_k`, which JAX
    zero-pads along T and the kernels read as 0 past T.
    """
    if not causal:
        raise ValueError(
            "padded flash attention requires causal=True (zero-padded keys "
            "would be attended under a non-causal mask); use the plain path"
        )
    return flash_attention_trainable(q, k, v, True, scale, bias_k=bias_k)
