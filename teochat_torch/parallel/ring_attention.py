"""Ring attention: context parallelism over a `sequence` axis (port of
teochat_tpu/parallel/ring_attention.py).

The sequence is split over the `n` ranks of a process group: rank i holds
queries, keys and values of the global positions [i S/n, (i+1) S/n). Each
of n steps attends the resident queries to the key / value block the rank
holds, then passes the block to the next rank (`_rotate`), so a rank holds
O(S/n) of the sequence at a time and the traffic is neighbour to
neighbour. GQA blocks rotate at Hkv width.

Three entry points, as in the JAX module:
- `ring_attention`: rank-local, [B, S/n, H, D] queries and this rank's
  [B, S/n, Hkv, D] key and value block, over a process group;
- `ring_self_attention`: the same over the `sequence` group of a mesh's
  `Sharded` view (the decoder's cache-free path with
  `LlamaConfig.sequence_axis`);
- `context_parallel_attention`: full [B, S, H, D] arrays and a DeviceMesh;
  returns THIS RANK's chunk of the output, [B, S/n, H, D] (JAX's returns
  the whole array, sharded, which one process cannot hold for another).

Two forms compute it:
- the plain twin (`ring_attention_plain`) is JAX's: fp32 queries, each
  block through grouped einsums with global positions and causal masking,
  the online softmax in fp32, differentiable through autograd (`_Rotate`'s
  backward is the reverse rotation). The CPU and the tests take it, and
  the card with `impl="plain"`;
- on CUDA tensors the ring runs on the card's flash kernels K4a-c
  (ops/flash_attention.py) in one autograd Function, `_RingFlash`:
  - forward: for each (resident queries, held block) pair, K4a with
    `causal=True` on the diagonal pair and `causal=False` on a block from an
    earlier rank. A block from a later rank is wholly masked under
    causality and is skipped with no launch (its l is 0, what JAX's masked
    product gives). So a causal ring is unbalanced: rank i launches i + 1
    of its n pairs, rank n - 1 all of them (n(n+1)/2 K4a launches over the
    ranks a call). The pairs' (o, m, l), K4a's natural-log convention
    (`flash_statistics_plain`), combine in fp32: M = max m_i,
    L = sum l_i e^(m_i - M), O = sum o_i l_i e^(m_i - M) / L, rounded to
    q's dtype once;
  - backward: di = rowsum(O dO) from the global O (the preamble kernel),
    then K4b and K4c on each pair the forward launched, with the global
    (M, L) in place of the pair's m and l, which makes their p the exact
    global probabilities; dq sums the pairs in fp32 on the rank, dK and dV
    sum in fp32 while they travel with their block around the ring and one
    more step back to the block's owner. The kernels write each pair's part
    in bf16; each gradient's sum is rounded once, at the end. As many K4b
    and K4c launches as K4a's.
  If the kernels cannot be built or launched the call raises: it never
  gives way to the plain twin. The rotation waits for its block before the
  pair's launch (no overlap yet: ROADMAP 16b).
The kernel path's arithmetic is written once (`ring_flash_forward`,
`ring_flash_backward`) over a block source: `RingBlocks` rotates over the
group, `IndexedBlocks` indexes every rank's chunk in one process
(`ring_flash_one_process`, the card test's form); `schedule_kernels` puts
the kernels' tile walks in the kernels' place for the CPU tests.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from teochat_torch.ops.attention import NEG_INF
from teochat_torch.parallel import tensor_parallel as tp


def _rotate(tensors, group, n: int, rank: int, reverse: bool = False):
    """Each tensor of this rank to the next rank of the ring (the previous
    one with `reverse`), and the previous (next) rank's in return: JAX's
    ppermute [(j, j + 1 mod n)]. The transport is `exchange`'s, chosen by
    the group's backend: NCCL's `batch_isend_irecv` on CUDA tensors, gloo's
    on host tensors, gloo on CUDA tensors through pinned host buffers
    (counted on tensor_parallel.HOST_STAGED)."""
    to, frm = ((rank - 1) % n, (rank + 1) % n) if reverse else ((rank + 1) % n, (rank - 1) % n)
    return tp.exchange([(x, to) for x in tensors], [(x, frm) for x in tensors], group)


class _Rotate(torch.autograd.Function):
    """The plain twin's rotation: forward to the next rank, the gradients
    back to the previous one."""

    @staticmethod
    def forward(ctx, group, n: int, rank: int, *tensors):
        ctx.group, ctx.n, ctx.rank = group, n, rank
        return tuple(_rotate(tensors, group, n, rank))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *_rotate(grads, ctx.group, ctx.n, ctx.rank, reverse=True))


def _check_shapes(q, k, v) -> None:
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"ring attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")


def ring_attention_plain(q, k, v, *, group, n: int, rank: int, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """JAX's ring_attention in plain PyTorch (the kernels' reference):
    [B, S/n, H, D] out in q's dtype."""
    _check_shapes(q, k, v)
    b, s_loc, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    pos = torch.arange(s_loc, device=q.device)
    q_pos = rank * s_loc + pos
    qf = q.float().reshape(b, s_loc, hkv, g, d)
    m = torch.full((b, h, s_loc), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s_loc), device=q.device)
    acc = torch.zeros((b, h, s_loc, d), device=q.device)
    kb, vb = k, v
    for i in range(n):
        if i:  # rotate first, then consume: n - 1 rotations a call
            kb, vb = _Rotate.apply(group, n, rank, kb, vb)
        k_pos = ((rank - i) % n) * s_loc + pos
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb.float()).reshape(b, h, s_loc, s_loc) * scale
        if causal:
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.reshape(b, hkv, g, s_loc, s_loc), vb.float()
        ).reshape(b, h, s_loc, d)
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ring_pairs(n: int, rank: int, causal: bool):
    """{step: causal} of each pair this rank launches: the block held at
    step i came from rank (rank - i) mod n; under causality the diagonal
    pair (step 0) is causal, earlier ranks' blocks are whole, later ranks'
    are skipped."""
    return {i: causal and i == 0 for i in range(n) if not (causal and (rank - i) % n > rank)}


def combine_partials(parts):
    """The pairs' (o [B, S, H, D], m, l [B, H, S]) as one softmax: (O fp32,
    M, L) with M = max m_i, L = sum l_i e^(m_i - M), O = sum o_i l_i
    e^(m_i - M) / L."""
    m_all = torch.stack([m for _, m, _ in parts])
    big = m_all.amax(0)
    w = torch.stack([l for _, _, l in parts]) * torch.exp(m_all - big)
    total = w.sum(0)
    frac = w / torch.where(total == 0, torch.ones_like(total), total)
    out = sum(o.float() * f.transpose(1, 2)[..., None] for (o, _, _), f in zip(parts, frac))
    return out, big, total


class FlashKernels(NamedTuple):
    """The four entries the kernel path calls, with ops/flash_attention.py's
    signatures: fwd (K4a), dkv (K4b), dq (K4c), di (the preamble)."""

    fwd: Callable
    dkv: Callable
    dq: Callable
    di: Callable


def cuda_kernels() -> FlashKernels:
    from teochat_torch.ops import flash_attention as fa

    return FlashKernels(fa._fwd_res_cuda, fa._bwd_dkv_cuda, fa._bwd_dq_cuda, fa._bwd_di_cuda)


def schedule_kernels() -> FlashKernels:
    """The kernels' tile walks (ops/flash_attention.py's schedules, held to
    JAX's kernels by the tests) in their place: the kernel path's
    arithmetic on any device, for the CPU tests."""
    from teochat_torch.ops import flash_attention as fa

    return FlashKernels(
        lambda q, k, v, causal, scale: fa.flash_forward_schedule(q, k, v, causal=causal,
                                                                 scale=scale),
        lambda q, k, v, do, m, l, di, causal, scale: fa.flash_backward_dkv_schedule(
            q, k, v, do, m, l, di, causal=causal, scale=scale),
        lambda q, k, v, do, m, l, di, causal, scale: fa.flash_backward_dq_schedule(
            q, k, v, do, m, l, di, causal=causal, scale=scale),
        fa.flash_di_plain)


class RingBlocks:
    """The key / value block a rank holds at each step, rotating around the
    ring; with `grads`, the fp32 sums of their dK and dV travel with it."""

    def __init__(self, k, v, group, n: int, rank: int, grads: bool = False):
        self.k, self.v, self.group, self.n, self.rank = k, v, group, n, rank
        self.dk = self.dv = None
        if grads:
            self.dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            self.dv = torch.zeros_like(self.dk)

    def advance(self) -> None:
        held = [self.k, self.v] + ([self.dk, self.dv] if self.dk is not None else [])
        held = _rotate(held, self.group, self.n, self.rank)
        self.k, self.v = held[:2]
        if self.dk is not None:
            self.dk, self.dv = held[2:]

    def add(self, dk, dv) -> None:
        self.dk += dk.float()
        self.dv += dv.float()

    def home(self):
        """The sums of this rank's own block: after the last step the held
        block is the next rank's, so its sums take one more step."""
        if self.n > 1:
            self.dk, self.dv = _rotate([self.dk, self.dv], self.group, self.n, self.rank)
        return self.dk, self.dv


class IndexedBlocks:
    """RingBlocks' interface in one process: the block a rank holds at step
    i is indexed from every rank's chunks, and each pair's dK, dV is added
    to its owner's sum at once (`ring_flash_one_process`)."""

    def __init__(self, ks, vs, rank: int, dks=None, dvs=None):
        self.ks, self.vs, self.rank, self.n, self.step = ks, vs, rank, len(ks), 0
        self.dks, self.dvs = dks, dvs
        self.k, self.v = ks[rank], vs[rank]

    def advance(self) -> None:
        self.step += 1
        src = (self.rank - self.step) % self.n
        self.k, self.v = self.ks[src], self.vs[src]

    def add(self, dk, dv) -> None:
        src = (self.rank - self.step) % self.n
        self.dks[src] += dk.float()
        self.dvs[src] += dv.float()


def ring_flash_one_process(q, k, v, do, n: int, causal: bool = True,
                           scale: Optional[float] = None,
                           kernels: Optional[FlashKernels] = None):
    """The kernel path of an n-rank ring run rank after rank in one process
    (the rotation replaced by indexing the blocks): whole (o, dq, dk, dv)
    for q [B, S, H, D], k / v [B, S, Hkv, D] and dO, each gradient summed in
    fp32 and rounded once."""
    kernels = kernels or cuda_kernels()
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs, ks, vs, dos = (x.chunk(n, 1) for x in (q, k, v, do))
    ks, vs, dos = [x.contiguous() for x in ks], [x.contiguous() for x in vs], list(dos)
    dks = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in ks]
    dvs = [torch.zeros_like(x) for x in dks]
    outs, dqs = [], []
    for rank in range(n):
        qr = qs[rank].contiguous()
        o, big, total = ring_flash_forward(qr, IndexedBlocks(ks, vs, rank), n, rank, causal,
                                           scale, kernels)
        dqs.append(ring_flash_backward(qr, IndexedBlocks(ks, vs, rank, dks, dvs),
                                       dos[rank].contiguous(), o, big, total, n, rank, causal,
                                       scale, kernels).to(q.dtype))
        outs.append(o)
    return (torch.cat(outs, 1), torch.cat(dqs, 1), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


def ring_flash_forward(q, blocks, n: int, rank: int, causal: bool, scale: float,
                       kernels: FlashKernels):
    """One rank's forward on the kernels: (O in q's dtype, M, L)."""
    pairs, parts = ring_pairs(n, rank, causal), []
    for i in range(n):
        if i:
            blocks.advance()
        if i in pairs:
            parts.append(kernels.fwd(q, blocks.k, blocks.v, pairs[i], scale))
    o, big, total = combine_partials(parts)
    return o.to(q.dtype), big, total


def ring_flash_backward(q, blocks, do, o, big, total, n: int, rank: int, causal: bool,
                        scale: float, kernels: FlashKernels) -> torch.Tensor:
    """One rank's backward on the kernels: dq in fp32; each pair's dK, dV
    added to `blocks`' travelling sums."""
    di = kernels.di(o, do)
    pairs = ring_pairs(n, rank, causal)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i in range(n):
        if i:
            blocks.advance()
        if i in pairs:
            args = (q, blocks.k, blocks.v, do, big, total, di, pairs[i], scale)
            blocks.add(*kernels.dkv(*args))
            dq += kernels.dq(*args).float()
    return dq


class _RingFlash(torch.autograd.Function):
    """The ring on K4a (forward) and K4b / K4c (backward); see the module
    docstring."""

    @staticmethod
    def forward(ctx, q, k, v, group, n: int, rank: int, causal: bool, scale: float,
                kernels: FlashKernels):
        o, big, total = ring_flash_forward(q, RingBlocks(k, v, group, n, rank), n, rank,
                                           causal, scale, kernels)
        ctx.save_for_backward(q, k, v, o, big, total)
        ctx.args = (group, n, rank, causal, scale, kernels)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, big, total = ctx.saved_tensors
        group, n, rank, causal, scale, kernels = ctx.args
        blocks = RingBlocks(k, v, group, n, rank, grads=True)
        dq = ring_flash_backward(q, blocks, do.contiguous(), o, big, total, n, rank, causal,
                                 scale, kernels)
        dk, dv = blocks.home()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def ring_attention_flash(q, k, v, *, group, n: int, rank: int, causal: bool = True,
                         scale: Optional[float] = None,
                         kernels: Optional[FlashKernels] = None) -> torch.Tensor:
    """The kernel path, differentiable: K4a-c (`cuda_kernels`, the default)
    or the entries given."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(), group, n, rank,
                            causal, float(scale), kernels or cuda_kernels())


def ring_attention(q, k, v, *, group, n: int, rank: int, causal: bool = True,
                   scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """Attention over the whole sequence, split over `group`'s n ranks:
    q [B, S/n, H, D], k / v [B, S/n, Hkv, D] this rank's chunk (global
    positions [rank S/n, (rank + 1) S/n)); returns this rank's [B, S/n, H, D].
    `impl` "auto" runs K4a-c on CUDA tensors and the plain twin on the CPU;
    "plain" the plain twin anywhere."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "plain" or (impl == "auto" and q.device.type == "cpu"):
        return ring_attention_plain(q, k, v, group=group, n=n, rank=rank, causal=causal,
                                    scale=scale)
    if impl != "auto" or not q.is_cuda:
        raise ValueError(f"ring_attention: impl {impl!r} on {q.device}")
    return ring_attention_flash(q, k, v, group=group, n=n, rank=rank, causal=causal, scale=scale)


def ring_self_attention(q, k, v, *, sharded, axis_name: str = "sequence", causal: bool = True,
                        scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """ring_attention over the `axis_name` group of `sharded`
    (parallel/tensor_parallel.py::Sharded): q, k, v are this rank's
    chunk of the sequence. The caller guarantees that causal masking is
    enough (right-padded rows: the pads sit after every valid query)."""
    sizes = {} if sharded is None else sharded.sizes
    if axis_name not in sizes:
        raise ValueError(f"sequence axis {axis_name!r} not in the active mesh {sizes}")
    return ring_attention(q, k, v, group=sharded.groups[axis_name], n=sizes[axis_name],
                          rank=sharded.coords[axis_name], causal=causal, scale=scale, impl=impl)


def context_parallel_attention(q, k, v, mesh, *, axis_name: str = "sequence",
                               causal: bool = True, scale: Optional[float] = None,
                               impl: str = "auto") -> torch.Tensor:
    """q, k, v whole ([B, S, H, D], the same on every rank): each rank takes
    its chunk of S along `mesh`'s `axis_name` and runs the ring. Returns
    THIS RANK's chunk of the output, [B, S/n, H, D]. S must divide by the
    axis size (pad upstream: static shapes)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    s = q.shape[1]
    if s % n:
        raise ValueError(f"sequence length {s} not divisible by {axis_name}={n}")
    rank = mesh.get_local_rank(axis_name)
    own = [x.chunk(n, 1)[rank] for x in (q, k, v)]
    return ring_attention(*own, group=mesh.get_group(axis_name), n=n, rank=rank,
                          causal=causal, scale=scale, impl=impl)
