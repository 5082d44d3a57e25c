"""Decode attention over the KV cache: the CUDA kernel's wrapper and its twin.

Port of teochat_tpu/ops/decode_attention.py::decode_attention (the kernel
`_decode_kernel`). On the TPU an XLA fusion did this work and the kernel
stayed unwired; the port has no XLA, so the kernel (csrc/decode_attention.cu)
runs every decode step. The plain twin is the JAX function's `impl="xla"`
branch. A CPU tensor goes to the twin; a CUDA tensor launches the kernel or
raises.

The kernel splits each row's slots into chunks of CHUNK, one block a chunk
(flash-decoding): each block writes a partial (m, l, acc) to an fp32
workspace and the last block of a row's head group to finish merges them in
chunk order. `decode_attention_split_schedule` is that walk in plain
PyTorch. The tickets that tell a block it is the last stay zero between
calls (the kernel resets them); one buffer of them is kept per device and
size, so calls that share it run on one stream, as the decode loop's do.

K2m, the kernel's multi-query form (`decode_attention_multi`, the same
.cu), takes S queries a row: query (b, s) attends the slots
t < lengths[b, s]. A session's suffix prefill runs it over the committed
cache (models/llama.py, `spec_verify`); on the TPU this was XLA's masked
attention under `slot <= q_slot & kv_mask`, and `query_lengths` turns that
mask into `lengths` where kv_mask is a prefix of each row. Its rows are
(query, head) pairs of one kv head, 16 a warp on `mma.sync`; a block takes
16 * row_warps rows and walks the slots in chunks of MULTI_CHUNK, the
4 / row_warps warps of a row group each taking its share of a chunk. When
the row tiles are few, the slots are also split across blocks, merged in
split order by the tile's last block (a workspace and tickets, as K2's).
`multi_plan` picks row_warps and the splits from the shapes alone, and
`decode_attention_multi_schedule` is the walk in plain PyTorch.

Both take a bf16 or an fp8 (e4m3) cache with a bf16 query (any float query
on the CPU). The kernels read an e4m3 slab in place and convert each
element exactly (e4m3 -> f16 -> f32), so they give the bf16 kernels' bits on
`slab.to(bfloat16)`; the plain versions and the walks upcast it likewise.
Each form has its own launch counter (`LAUNCHES_E4M3`, `LAUNCHES_MULTI_E4M3`).
"""

from __future__ import annotations

from typing import Optional

import torch

from teochat_torch.ops import _build
from teochat_torch.ops.attention import NEG_INF, plain_attention

LAUNCHES = _build.LaunchCounter("decode_attention")
LAUNCHES_MULTI = _build.LaunchCounter("decode_attention_multi")
LAUNCHES_E4M3 = _build.LaunchCounter("decode_attention_e4m3")
LAUNCHES_MULTI_E4M3 = _build.LaunchCounter("decode_attention_multi_e4m3")
HEAD_DIMS = (64, 128)
GROUP_SIZES = (1, 2, 4, 8, 16)  # query heads per kv head; 16 runs as two blocks of 8
CHUNK = 64  # cache slots a block of the kernel takes
MAX_HEADS_A_BLOCK = 8
MULTI_CHUNK = 64  # K2m: cache slots a chunk of its ring (MQ_CHUNK in the .cu)
MULTI_WARPS = 4  # K2m: warps a block (MQ_WARPS); 16 (query, head) rows a row group
MULTI_ROW_WARPS = (1, 2, 4)  # row groups a block, the kernel's instantiations
MULTI_MIN_SPLIT_CHUNKS = 4  # K2m: no split of the slots is shorter than this many chunks
MULTI_MAX_SPLITS = 16  # nor are there more splits than this (MQ_MAX_SPLITS)
LOG2E = 1.4426950408889634


def decode_attention_plain(q, k_cache, v_cache, lengths, *, scale=None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch, in fp32.

    q [B, H, D]; k_cache, v_cache [B, Hkv, T, D] (bf16, e4m3 or fp32: the
    upcast is exact); lengths [B]."""
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


def decode_attention_split_schedule(q, k_cache, v_cache, lengths, *, scale=None,
                                    chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's split walk in plain PyTorch, fp32 statistics.

    As in csrc/decode_attention.cu: the slots go in chunks of `chunk`; a
    chunk past a row's live slots (other than chunk 0) is left out; each
    chunk's partial is its own row maximum m_c, l_c = sum exp(s - m_c) and
    acc_c = sum exp(s - m_c) v over its live slots; the partials are merged
    in chunk order against their largest m, and a row whose l is 0 (length 0)
    is written as 0. q [B, H, D]; k_cache, v_cache [B, Hkv, T, D]; lengths [B]."""
    b, h, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    kf = k_cache.float().repeat_interleave(h // hkv, dim=1)
    vf = v_cache.float().repeat_interleave(h // hkv, dim=1)
    lens = lengths.to(q.device).long().clamp(0, t)
    n_live = torch.clamp((lens + chunk - 1) // chunk, min=1)  # [B]
    ms, ls, accs = [], [], []
    for c0 in range(0, t, chunk):
        sc = torch.einsum("bhd,bhtd->bht", q.float(), kf[:, :, c0:c0 + chunk]) * scale
        slot = torch.arange(c0, min(c0 + chunk, t), device=q.device)
        live = slot[None, None, :] < lens[:, None, None]
        sc = torch.where(live, sc, float("-inf"))
        m = sc.amax(-1)  # -inf where the chunk has no live slot
        p = torch.where(live, torch.exp(sc - torch.where(m.isinf(), 0.0, m)[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bht,bhtd->bhd", p, vf[:, :, c0:c0 + chunk]))
    m_c, l_c, acc_c = torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)
    taken = torch.arange(m_c.shape[-1], device=q.device)[None, :] < n_live[:, None]  # [B, C]
    m_c = torch.where(taken[:, None, :], m_c, float("-inf"))
    mx = m_c.amax(-1)
    f = torch.where(m_c.isinf(), 0.0, torch.exp(m_c - torch.where(mx.isinf(), 0.0, mx)[..., None]))
    l = (l_c * f).sum(-1)
    acc = (acc_c * f[..., None]).sum(-2)
    out = torch.where(l[..., None] == 0, 0.0, acc / torch.where(l == 0, 1.0, l)[..., None])
    return out.to(q.dtype)


def _check_cache_pair(fn: str, k_cache, v_cache) -> bool:
    """Raise unless K and V are slabs the kernels read in place, of one
    dtype; whether they are e4m3."""
    _build.check_kv_operand("k_cache", k_cache, 4)
    _build.check_kv_operand("v_cache", v_cache, 4)
    if k_cache.dtype != v_cache.dtype:
        raise ValueError(f"{fn}: k_cache {k_cache.dtype} and v_cache {v_cache.dtype} differ")
    return k_cache.dtype == torch.float8_e4m3fn


def _decode_cuda(q, k_cache, v_cache, lengths, scale: float) -> torch.Tensor:
    _build.check_bf16_operand("q", q, 3)
    fp8 = _check_cache_pair("decode_attention", k_cache, v_cache)
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
    # in the decode step's CUDA graph, out and the partials come from the
    # graph's pool and keep their addresses in every replay
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    n_chunks = -(-t // CHUNK)
    part_ml = torch.empty((b, h, n_chunks, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b, h, n_chunks, d), dtype=torch.float32, device=q.device)
    tickets = _build.tickets_for(q.device, b * (h // min(h // hkv, MAX_HEADS_A_BLOCK)))
    _build.launch(
        "teochat_decode_attention_e4m3" if fp8 else "teochat_decode_attention", q,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), tickets.data_ptr(),
        b, h, hkv, t, d,
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        float(scale),
    )
    (LAUNCHES_E4M3 if fp8 else LAUNCHES).count += 1
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
    [B, Hkv, T, D], in bf16 or e4m3: the kernel reads it in place.
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


# ------------------------------------------------------------------ K2m


def query_lengths(q_slots: torch.Tensor, kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] int32 live lengths for queries at cache slots `q_slots` [B, S]:
    the mask `slot <= q_slot & kv_mask` of the JAX cached path as a length,
    min(q_slot + 1, kv_len). `kv_mask` [B, T] must be a prefix of each row
    (its first kv_len slots); a mask that is not raises. Without one no host
    read is made, so a decode step can run in a CUDA graph; with one the
    prefix is checked on the host."""
    lengths = (q_slots + 1).to(torch.int32)
    if kv_mask is None:
        return lengths
    kv_mask = kv_mask.bool()
    kv_len = kv_mask.sum(-1)
    prefix = torch.arange(kv_mask.shape[-1], device=kv_mask.device)[None, :] < kv_len[:, None]
    if not torch.equal(kv_mask, prefix):
        raise NotImplementedError(
            "query_lengths: a kv_mask that is not a prefix of each row has no length form; "
            "every caller's mask is one")
    return torch.minimum(lengths, kv_len[:, None].to(torch.int32))


def _multi_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """[B, S] lengths -> the boolean [B, S, T] mask slot < length."""
    return torch.arange(t, device=lengths.device)[None, None, :] < lengths.long()[..., None]


def decode_attention_multi_plain(q, k_cache, v_cache, lengths, *, scale=None) -> torch.Tensor:
    """What K2m computes, as the plain attention under the mask built from
    `lengths` (fp32 logits and softmax). q [B, S, H, D]; k_cache, v_cache
    [B, Hkv, T, D]; lengths [B, S]. A query of length 0 gets the mean of V
    here (every logit masked alike) and 0 from the kernel; the model never
    asks for one. An e4m3 cache is upcast to q's dtype first (exactly)."""
    mask = _multi_mask(lengths.to(q.device), k_cache.shape[2])
    if k_cache.dtype == torch.float8_e4m3fn:
        k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    return plain_attention(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), mask=mask,
                           scale=scale)


def multi_plan(b: int, s: int, h: int, hkv: int, t: int, sms: int):
    """K2m's launch from the shapes alone (never the lengths, which stay on
    the device): (row_warps, splits, split_chunks).

    A block takes 16 * row_warps (query, head) rows of one kv head: the
    fewest row groups that hold a kv head's S * G rows, at most 4, then
    fewer while the tiles (B * Hkv * row tiles) are fewer than half the SMs
    (on an H100 at S 128, 128 tiles of 32 rows beat 256 of 16 and 64 of 64).
    While even the smallest tiles leave the SMs idle, the T / MULTI_CHUNK
    chunks are split across blocks until there is about one block an SM
    (on an H100 one beat two), each split at least MULTI_MIN_SPLIT_CHUNKS chunks long,
    at most MULTI_MAX_SPLITS of them; split j takes chunks
    [j * split_chunks, (j + 1) * split_chunks)."""
    rows = s * (h // hkv)
    rw = 4 if rows > 32 else 2 if rows > 16 else 1
    while rw > 1 and 2 * b * hkv * -(-rows // (16 * rw)) < sms:
        rw //= 2
    tiles = b * hkv * -(-rows // (16 * rw))
    n_chunks = -(-t // MULTI_CHUNK)
    splits = max(1, min(sms // tiles, n_chunks // MULTI_MIN_SPLIT_CHUNKS, MULTI_MAX_SPLITS))
    split_chunks = -(-n_chunks // splits)
    return rw, -(-n_chunks // split_chunks), split_chunks


def decode_attention_multi_schedule(q, k_cache, v_cache, lengths, *, sms: int,
                                    scale=None) -> torch.Tensor:
    """K2m's walk in plain PyTorch, fp32 statistics.

    As in csrc/decode_attention.cu, with `multi_plan`'s launch for `sms`
    SMs: the rows of kv head hk are (query r // G, head hk * G + r % G); a
    tile of 16 * row_warps rows walks the chunks of MULTI_CHUNK slots of
    each split up to the tile's longest length, and each of the
    MULTI_WARPS / row_warps warps of a row group keeps its own running
    (m, l, acc) over its share of every chunk. Scores are in base-2 units,
    a slot at or past a row's length is masked, P is rounded to bf16 before
    P V as the kernel rounds it, whatever the cache's dtype (an fp32 V keeps
    P in fp32: fp32 inputs stay exact). The warps'
    partials are merged in warp order, then the splits' in split order; o =
    acc / l, and 0 where l is 0 (a query of length 0). q [B, S, H, D];
    k_cache, v_cache [B, Hkv, T, D]; lengths [B, S]."""
    b, s, h, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    c2 = scale * LOG2E
    rw, splits, split_chunks = multi_plan(b, s, h, hkv, t, sms)
    rows_t, sw = 16 * rw, MULTI_WARPS // rw
    ns = MULTI_CHUNK // sw
    n_rows = s * g
    tiles = -(-n_rows // rows_t)
    pad = tiles * rows_t - n_rows
    # [B, Hkv, tiles, rows_t, D]: row r of kv head hk is query r // G, head hk * G + r % G
    qr = q.float().reshape(b, s, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(b, hkv, n_rows, d)
    qr = torch.nn.functional.pad(qr, (0, 0, 0, pad)).reshape(b, hkv, tiles, rows_t, d)
    lens = lengths.to(q.device).long().clamp(0, t).repeat_interleave(g, dim=1)  # [B, n_rows]
    tile_max = torch.nn.functional.pad(lens, (0, pad)).reshape(b, tiles, rows_t).amax(-1)
    lens = torch.nn.functional.pad(lens, (0, pad)).reshape(b, 1, tiles, rows_t, 1)
    c_end = -(-tile_max // MULTI_CHUNK)  # [B, tiles] chunks a tile walks
    kf, vf = k_cache.float(), v_cache.float()
    p_dtype = torch.float32 if v_cache.dtype == torch.float32 else torch.bfloat16
    m = torch.full((b, hkv, tiles, splits, sw, rows_t), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*m.shape, d), device=q.device)
    for c in range(int(c_end.max()) if c_end.numel() else 0):
        j = c // split_chunks
        taken = (c < c_end)[:, None, :, None]  # [B, 1, tiles, 1]
        for w in range(sw):
            t0 = c * MULTI_CHUNK + w * ns
            if t0 >= t:
                break
            t1 = min(t0 + ns, t)
            sc = torch.einsum("bktrd,bkjd->bktrj", qr, kf[:, :, t0:t1]) * c2
            sc = torch.where(torch.arange(t0, t1, device=q.device) < lens, sc, float("-inf"))
            m_old = m[:, :, :, j, w]
            m_new = torch.maximum(m_old, sc.amax(-1))
            alpha = torch.where(m_new.isinf(), 1.0, torch.exp2(m_old - m_new))
            p = torch.exp2(sc - torch.where(m_new.isinf(), 0.0, m_new)[..., None])
            l_new = l[:, :, :, j, w] * alpha + p.sum(-1)
            acc_new = acc[:, :, :, j, w] * alpha[..., None] + torch.einsum(
                "bktrj,bkjd->bktrd", p.to(p_dtype).float(), vf[:, :, t0:t1])
            m[:, :, :, j, w] = torch.where(taken, m_new, m_old)
            l[:, :, :, j, w] = torch.where(taken, l_new, l[:, :, :, j, w])
            acc[:, :, :, j, w] = torch.where(taken[..., None], acc_new, acc[:, :, :, j, w])

    def merge(m, l, acc, dim):  # partials along `dim`, in order, against their largest m
        mx = m.amax(dim, keepdim=True)
        f = torch.where(m.isinf(), 0.0, torch.exp2(m - torch.where(mx.isinf(), 0.0, mx)))
        return mx.squeeze(dim), (l * f).sum(dim), (acc * f[..., None]).sum(dim)

    m, l, acc = merge(m, l, acc, 4)  # the warps of a row group
    m, l, acc = merge(m, l, acc, 3)  # the splits
    out = torch.where(l[..., None] == 0, 0.0, acc / torch.where(l == 0, 1.0, l)[..., None])
    out = out.reshape(b, hkv, tiles * rows_t, d)[:, :, :n_rows]
    out = out.reshape(b, hkv, s, g, d).permute(0, 2, 1, 3, 4).reshape(b, s, h, d)
    return out.to(q.dtype)


def _multi_cuda(q, k_cache, v_cache, lengths, scale: float) -> torch.Tensor:
    _build.check_bf16_operand("q", q, 4)
    fp8 = _check_cache_pair("decode_attention_multi", k_cache, v_cache)
    b, s, h, d = q.shape
    _, hkv, t, _ = k_cache.shape
    if d not in HEAD_DIMS or h % hkv or h // hkv not in GROUP_SIZES:
        raise ValueError(
            f"decode_attention_multi: head_dim {d} (need {HEAD_DIMS}) or group "
            f"{h}/{hkv} (need {GROUP_SIZES}) not supported"
        )
    if k_cache.shape != (b, hkv, t, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode_attention_multi: shapes q {q.shape} k {k_cache.shape} v {v_cache.shape}")
    if lengths.shape != (b, s) or lengths.device != q.device or lengths.dtype != torch.int32:
        raise ValueError("decode_attention_multi: lengths must be int32 [B, S] on q's device")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("decode_attention_multi: q and the cache on different devices")
    lengths = lengths.contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    rw, splits, split_chunks = multi_plan(b, s, h, hkv, t, _build.sm_count(q.device))
    part_ml = part_acc = tickets = None
    if splits > 1:
        tiles = b * hkv * -(-s * (h // hkv) // (16 * rw))
        part_ml = torch.empty((tiles, splits, 16 * rw, 2), dtype=torch.float32, device=q.device)
        part_acc = torch.empty((tiles, splits, 16 * rw, d), dtype=torch.float32, device=q.device)
        tickets = _build.tickets_for(q.device, tiles)
    _build.launch(
        "teochat_decode_attention_multi_e4m3" if fp8 else "teochat_decode_attention_multi", q,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        *(x.data_ptr() if x is not None else None for x in (part_ml, part_acc, tickets)),
        b, s, h, hkv, t, d, rw, splits, split_chunks,
        q.stride(0), q.stride(1), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        float(scale),
    )
    (LAUNCHES_MULTI_E4M3 if fp8 else LAUNCHES_MULTI).count += 1
    return out


def decode_attention_multi(
    q: torch.Tensor,  # [B, S, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, T, D], any strides with D contiguous
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B, S] live length of each query
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """K2m: S queries a row against the cache; returns [B, S, H, D].

    impl: auto | plain | kernel, as `decode_attention`: "auto" launches the
    kernel for a CUDA tensor and takes the plain version for a CPU tensor.
    The cache is read in place (the layer slab transposed to [B, Hkv, T, D]),
    in bf16 or e4m3."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        if q.is_cuda:
            impl = "kernel"
        elif q.device.type == "cpu":
            impl = "plain"
        else:
            raise ValueError(f"decode_attention_multi: no kernel for device {q.device}")
    if impl == "kernel":
        return _multi_cuda(q, k_cache, v_cache, lengths, scale)
    if impl != "plain":
        raise ValueError(f"unknown decode attention impl {impl!r}")
    return decode_attention_multi_plain(q, k_cache, v_cache, lengths, scale=scale)
