"""The port's CUDA kernels against their plain twins, on the card.

Every test here is marked `cuda` and skips where torch sees no CUDA device.
On a machine with a card (which need not have JAX; the suite's conftest
imports it, so skip that file):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are bf16 from a seeded generator; the reference is the plain twin in
fp32 on the same bf16 inputs. Outputs are averages of N(0, 1) values, so
|o| < 4 and bf16 output rounding alone reaches 2^-8 * 4 = 1.6e-2; P is
rounded to bf16 before the PV product, as in the TPU kernels. The flash
backward (K4b, K4c) also rounds P and dS to bf16 before its products and
writes bf16 gradients, so each gradient is held to GRAD_REL_L2 of its norm
(bf16 keeps 8 bits: 2^-9 relative rounding per term, summed over many
terms) and its largest error to GRAD_REL_MAX of its largest element.
The int4 products (K3a-c) accumulate exact products in fp32 on both sides,
so they differ from the fp32 plain version (or the M > 8 kernel's tile walk,
`int4_prefill_schedule`) by the one bf16 rounding of the output: half an
ulp, 2^-8 = 3.9e-3 of the element at most. The kernel
benches' int4 variants (S1) are held to the same bound against their plain
versions, with xa and xb rounded to bf16 once for both sides, and their
attention variants (S2) to TOL.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from teochat_torch.bench import int4_kernel as bench_int4
from teochat_torch.bench import vit_attention as bench_vit
from teochat_torch.checkpoint import bridge
from teochat_torch.config import TEOChatConfig
from teochat_torch.models import generation as gen_mod
from teochat_torch.models import llama as llama_mod
from teochat_torch.models import mpt as mpt_mod
from teochat_torch.ops import _build
from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.ops import flash_attention as flash_mod
from teochat_torch.ops import int4_matmul as int4_mod
from teochat_torch.ops import quant as quant_mod
from teochat_torch.ops import vit_attention as vit_mod
from teochat_torch.ops.attention import dot_product_attention

TOL = 2e-2
GRAD_REL_L2 = 1e-2
GRAD_REL_MAX = 2e-2
INT4_REL_L2 = 3e-3
INT4_REL_MAX = 4e-3
STAT_M_ATOL = 2e-4  # K4a's row maximum, absolute
# K4a's row maximum with MPT's ALiBi table for a 4,096-slot cache: m near
# -3,000, where the plain version's fp32 sum of score and bias rounds by up to
# 1.2e-4 and one ulp of m is 2.4e-4; the kernel shifts the table by each
# head's last bias first, so the two round in other places: four ulps
BIAS_STAT_M_ATOL = 1e-3
STAT_L_RTOL = 1e-3  # K4a's denominator, relative
# K4b and K4c against their tile walks on the same bf16 inputs: summation
# order and ex2.approx against exp move a P, a dS or a gradient across a bf16
# rounding boundary now and then (read on an H100: relative L2 up to 2.3e-4,
# largest error up to 4.4e-3 of the largest gradient: one bf16 step)
WALK_REL_L2 = 1e-3
WALK_REL_MAX = 1e-2
DI_REL_TOL = 1e-5  # the di preamble against its torch line, of the largest |di|
# K2m, each live (query, head) row's largest error over its largest |o|
# (chip_smoke.py says why): against the plain version, and against the walk
# on the same bf16 K / V, where only the output's rounding and the order of
# fp32 sums are left
K2M_REL_MAX = 1e-2
K2M_WALK_REL_MAX = 5e-3
# S2 against its walk (`one_sweep_schedule`) on the same bf16 inputs: both
# round p / l and o to bf16, so what differs is ex2.approx against exp2 and
# the order of the fp32 sums, which move a p / l or an o across a bf16
# rounding boundary now and then. One bf16 step of o is at most 2^-7 of |o|;
# a flipped p / l moves o by at most 2^-8 of that p's share of the row's
# values, less than one step of the largest |o|: two steps bound both
S2_WALK_REL = 2.0 ** -6  # of the largest |o|

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize(
    "b,s,t,h,hkv,d,causal",
    [
        (1, 64, 64, 2, 2, 128, True),  # one tile
        (2, 333, 333, 4, 1, 128, True),  # ragged S, GQA 4:1
        (1, 130, 130, 4, 2, 64, True),  # head_dim 64
        (2, 100, 257, 4, 4, 128, False),  # non-causal, S != T, ragged T
        (1, 9, 9, 2, 2, 128, True),  # S far below one warpgroup's 64 rows
        (2, 40, 40, 4, 2, 64, True),  # S < 64 at head_dim 64, GQA
        (1, 257, 257, 2, 2, 64, True),  # head_dim 64: three query tiles, one key past 256
        (1, 640, 640, 2, 1, 128, True),  # five kv tiles: each ring stage reused
        (2, 300, 70, 4, 2, 64, False),  # non-causal, S != T, head_dim 64
        (1, 1, 1, 2, 2, 128, True),  # one query, one key
        (3, 768, 768, 8, 8, 128, True),  # the 2-frame prompt bucket, batched
    ],
)
def test_flash_kernel_matches_plain(gen, b, s, t, h, hkv, d, causal):
    q, k, v = _randn((b, s, h, d), gen), _randn((b, t, hkv, d), gen), _randn((b, t, hkv, d), gen)
    before = flash_mod.LAUNCHES.count
    got = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.LAUNCHES.count == before + 1
    want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, d)
    assert (got.float() - want).abs().max().item() <= TOL


def test_flash_reads_strided_inputs(gen):
    """q, k and v sliced out of one fused [B, S, 3, H, D] buffer are read in place."""
    qkv = _randn((1, 200, 3, 4, 128), gen)
    q, k, v = qkv.unbind(2)
    got = flash_mod.flash_attention(q, k, v, causal=True)
    want = flash_mod.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_reads_v_from_a_fused_projection(gen):
    """q, k and v as the fused int4 q|k|v projection hands them over: column
    slices of one [B, S, (H + 2 Hkv) D] output, each with the fused row's
    stride; v differs from k, so a wrong V operand cannot pass."""
    b, s, h, hkv, d = 2, 200, 8, 2, 128
    fused = _randn((b, s, (h + 2 * hkv) * d), gen)
    q = fused[..., : h * d].view(b, s, h, d)
    k = fused[..., h * d : (h + hkv) * d].view(b, s, hkv, d)
    v = fused[..., (h + hkv) * d :].view(b, s, hkv, d)
    assert v.stride(1) == (h + 2 * hkv) * d and not v.is_contiguous()
    got = flash_mod.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    assert (got.float() - want).abs().max().item() <= TOL
    same = flash_mod.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, same, rtol=0, atol=0)


def test_flash_reads_head_major_inputs(gen):
    """[B, H, S, D] storage read as [B, S, H, D] views: a head's stride is
    the larger one, so the tensor maps put rows before heads."""
    q, k, v = (_randn((2, 4, 150, 128), gen).transpose(1, 2) for _ in range(3))
    got = flash_mod.flash_attention(q, k, v, causal=True)
    want = flash_mod.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "b,s,t,h,hkv,d,causal",
    [
        (4, 1024, 1024, 32, 32, 128, True),  # the training batch
        (2, 333, 333, 4, 1, 128, True),  # ragged S, GQA 4:1
        (1, 40, 40, 2, 2, 64, True),  # S < 64, head_dim 64
        (2, 100, 257, 4, 4, 128, False),  # non-causal, S != T
    ],
)
def test_flash_forward_statistics_match_plain(gen, b, s, t, h, hkv, d, causal):
    """K4a's m and l against the row maximum and the sum of exp(s - m) of the
    fp32 scores on the same bf16 inputs. Scores are sums of D products of
    N(0, 1) values times D^-0.5, |s| < 8: the tensor cores' fp32 sum and the
    plain one differ by ~1e-5 there, which moves m by as much and each term
    of l, exp(s - m) in (0, 1], by ~1e-5 of itself; ex2.approx adds 2e-7."""
    q, k, v = _randn((b, s, h, d), gen), _randn((b, t, hkv, d), gen), _randn((b, t, hkv, d), gen)
    before = flash_mod.FWD_RES_LAUNCHES.count
    o, m, l = flash_mod._fwd_res_cuda(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_mod.FWD_RES_LAUNCHES.count == before + 1
    want_m, want_l = flash_mod.flash_statistics_plain(q.float(), k.float(), v.float(),
                                                      causal=causal)
    assert m.shape == l.shape == (b, h, s) and m.dtype == l.dtype == torch.float32
    torch.testing.assert_close(m, want_m, rtol=0, atol=STAT_M_ATOL)
    torch.testing.assert_close(l, want_l, rtol=STAT_L_RTOL, atol=0)
    want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
    assert (o.float() - want).abs().max().item() <= TOL


@pytest.mark.parametrize(
    "b,h,hkv,t,d,lengths",
    [
        (3, 8, 8, 801, 128, [801, 1, 0]),  # a row with no live slot writes 0
        (2, 32, 8, 300, 128, [300, 129]),  # GQA 4:1
        (2, 8, 1, 70, 128, [5, 70]),  # GQA 8:1
        (2, 4, 2, 50, 64, [50, 17]),  # head_dim 64
        (2, 32, 2, 90, 128, [90, 33]),  # GQA 16:1, two blocks of 8 heads a kv head
        # the split's edges: 1, CHUNK - 1, CHUNK, CHUNK + 1 and T slots, and none
        (6, 32, 32, 801, 128, [1, 63, 64, 65, 801, 0]),
        (6, 32, 8, 200, 128, [1, 63, 64, 65, 200, 0]),  # GQA 4:1, T a ragged chunk
        (6, 32, 2, 129, 128, [1, 63, 64, 65, 129, 0]),  # GQA 16:1
        (6, 16, 16, 256, 64, [1, 63, 64, 65, 256, 0]),  # head_dim 64
        (8, 32, 32, 1025, 128, [1025, 1, 517, 1024, 64, 300, 1000, 2]),  # a ragged batch
    ],
)
def test_decode_kernel_matches_plain(gen, b, h, hkv, t, d, lengths):
    # the layer slab of a [L, B, T, Hkv, D] cache, read in place as [B, Hkv, T, D]
    k = _randn((2, b, t, hkv, d), gen)[1].transpose(1, 2)
    v = _randn((2, b, t, hkv, d), gen)[1].transpose(1, 2)
    q = _randn((b, h, d), gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = dec_mod.LAUNCHES.count
    got = dec_mod.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert dec_mod.LAUNCHES.count == before + 1
    want = dec_mod.decode_attention_plain(q.float(), k.float(), v.float(), lens)
    # a row with no live slot is 0 in the kernel (as in the Pallas kernel) and
    # the mean of V in the plain twin (as in the JAX XLA branch); the model
    # never asks for one, since lengths = q_slot + 1
    live = lens > 0
    assert (got.float() - want)[live].abs().max().item() <= TOL
    assert got[~live].abs().sum().item() == 0.0


def test_decode_kernel_is_the_same_on_every_run(gen):
    """The last block of a row's chunks merges them in chunk order and resets
    its ticket: a second call on the same inputs gives the same bits, and so
    does a call of another shape in between."""
    k = _randn((4, 32, 801, 128), gen)
    v = _randn((4, 32, 801, 128), gen)
    q = _randn((4, 32, 128), gen)
    lens = torch.tensor([580, 801, 64, 3], dtype=torch.int32, device="cuda")
    first = dec_mod.decode_attention(q, k, v, lens)
    again = dec_mod.decode_attention(q, k, v, lens)
    dec_mod.decode_attention(q[:1], k[:1], v[:1], lens[:1])
    third = dec_mod.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, third)
    want = dec_mod.decode_attention_split_schedule(q.float(), k.float(), v.float(), lens)
    assert (first.float() - want).abs().max().item() <= TOL


def _suffix_lengths(b, s, t, starts, live):
    """K2m's lengths for a session's suffix: row b's live queries at slots
    starts[b] + i, its padded ones at the trash slot t - 1, kv_mask the
    prefix starts[b] + live[b]."""
    starts = torch.tensor(starts, device="cuda")[:, None]
    live = torch.tensor(live, device="cuda")[:, None]
    pos = torch.arange(s, device="cuda")[None, :]
    q_slots = torch.where(pos < live, starts + pos, t - 1)
    return dec_mod.query_lengths(q_slots, torch.arange(t, device="cuda")[None, :] < starts + live)


@pytest.mark.parametrize(
    "b,s,h,hkv,t,d,starts,live",
    [
        (1, 9, 32, 32, 801, 128, [700], [9]),
        (1, 128, 32, 32, 1025, 128, [700], [100]),  # padded queries at the trash slot
        (6, 9, 32, 32, 300, 128, [0, 1, 31, 32, 33, 200], [9, 9, 9, 9, 5, 9]),  # chunk edges
        (2, 40, 32, 8, 200, 128, [63, 0], [40, 0]),  # GQA 4:1; row 1 has no live slot
        (2, 33, 16, 4, 257, 64, [64, 65], [33, 20]),  # head_dim 64
        (1, 17, 32, 2, 129, 128, [65], [17]),  # GQA 16:1: a row tile is one query's 16 heads
        (1, 2, 32, 32, 4096, 128, [3998], [2]),  # speculative verify at k = 1: slots split 4 ways
        (1, 5, 32, 32, 4096, 128, [3995], [5]),  # k = 4
        (1, 1024, 32, 32, 4096, 128, [100], [870]),  # a turn that re-prefills three frames
        # T 1000: two splits of 512 slots, the second ending mid-chunk at T;
        # row 0's lengths straddle the first split's end
        (2, 9, 32, 8, 1000, 128, [508, 991], [9, 9]),
        (1, 3, 16, 4, 2048, 64, [2040], [3]),  # head_dim 64, group 4: slots split 8 ways
        (2, 2, 32, 32, 2048, 128, [2040, 0], [2, 0]),  # split tiles beside a row of no live slot
    ],
)
def test_decode_multi_kernel_matches_plain_and_its_walk(gen, b, s, h, hkv, t, d, starts, live):
    """K2m against its plain version and its walk (`decode_attention_multi_schedule`,
    planned for this card's SMs, on the same bf16 K / V) on the layer slab of a
    [L, B, T, Hkv, D] cache, each live (query, head) row also held to its own
    largest |o|; a query without a live slot is 0, and a second call gives the
    same bits (the splits' tickets are back at 0)."""
    k = _randn((2, b, t, hkv, d), gen)[1].transpose(1, 2)
    v = _randn((2, b, t, hkv, d), gen)[1].transpose(1, 2)
    q = _randn((b, s, h, d), gen)
    lens = _suffix_lengths(b, s, t, starts, live)
    before = dec_mod.LAUNCHES_MULTI.count
    got = dec_mod.decode_attention_multi(q, k, v, lens)
    again = dec_mod.decode_attention_multi(q, k, v, lens)
    torch.cuda.synchronize()
    assert dec_mod.LAUNCHES_MULTI.count == before + 2 and torch.equal(got, again)
    alive = lens > 0
    want = dec_mod.decode_attention_multi_plain(q.float(), k.float(), v.float(), lens)
    walk = dec_mod.decode_attention_multi_schedule(q.float(), k, v, lens,
                                                   sms=_build.sm_count(q.device))
    assert (got.float() - want)[alive].abs().max().item() <= TOL
    assert (got.float() - walk).abs().max().item() <= TOL
    for ref, bound in ((want, K2M_REL_MAX), (walk, K2M_WALK_REL_MAX)):
        err = (got.float() - ref).abs().amax(-1)[alive]
        assert (err / ref.abs().amax(-1)[alive]).max().item() <= bound
    assert got[~alive].abs().sum().item() == 0.0


def test_cuda_tensors_the_kernels_do_not_take_raise(gen):
    q = torch.randn(1, 64, 2, 128, device="cuda")  # fp32
    with pytest.raises(ValueError):
        dot_product_attention(q, q, q, causal=True)  # auto picks the kernel: no fallback
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(qb[..., :96], qb[..., :96], qb[..., :96])  # head_dim 96
    with pytest.raises(ValueError):
        dec_mod.decode_attention(qb[:, 0], qb.transpose(1, 2), qb.transpose(1, 2),
                                 torch.tensor([3], device="cuda"))  # int64 lengths
    with pytest.raises(ValueError):
        dec_mod.decode_attention_multi(qb, qb.transpose(1, 2), qb.transpose(1, 2),
                                       torch.tensor([[3] * 64], device="cuda"))  # int64 lengths


def _trainable_case(gen, b, s, h, hkv, d):
    q, k, v = _randn((b, s, h, d), gen), _randn((b, s, hkv, d), gen), _randn((b, s, hkv, d), gen)
    do = _randn((b, s, h, d), gen)
    return q, k, v, do


def _grads(fn, q, k, v, do):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v)
    o.backward(do.to(o.dtype))
    return [x.detach().float() for x in (o, q.grad, k.grad, v.grad)]


def _counts():
    return (flash_mod.FWD_RES_LAUNCHES.count, flash_mod.BWD_DKV_LAUNCHES.count,
            flash_mod.BWD_DQ_LAUNCHES.count)


@pytest.mark.parametrize(
    "b,s,h,hkv,d,padded",
    [
        (1, 64, 2, 2, 128, False),  # one tile
        (2, 256, 4, 4, 128, False),  # several tiles: the causal skip in all three
        (2, 333, 4, 1, 128, True),  # ragged S through the padded wrapper, GQA 4:1
        (1, 130, 4, 2, 64, False),  # head_dim 64, GQA 2:1, ragged
    ],
)
def test_flash_backward_matches_plain(gen, b, s, h, hkv, d, padded):
    q, k, v, do = _trainable_case(gen, b, s, h, hkv, d)
    fn = flash_mod.flash_attention_trainable_padded if padded else flash_mod.flash_attention_trainable
    before = _counts()
    got = _grads(fn, q, k, v, do)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    want = _grads(lambda q, k, v: flash_mod.flash_attention_plain(q.float(), k.float(), v.float()),
                  q, k, v, do)
    assert (got[0] - want[0]).abs().max().item() <= TOL
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert g.shape == w.shape, name
        assert (g - w).norm().item() <= GRAD_REL_L2 * w.norm().item(), name
        assert (g - w).abs().max().item() <= GRAD_REL_MAX * w.abs().max().item(), name


def test_flash_backward_skips_above_the_diagonal(gen):
    """dO only on the first 64 rows: keys past row 63 get exactly zero dK and
    dV (their q tiles are skipped or masked), and dQ of later rows is zero."""
    q, k, v, do = _trainable_case(gen, 1, 256, 2, 2, 128)
    do[:, 64:] = 0
    _, dq, dk, dv = _grads(flash_mod.flash_attention_trainable, q, k, v, do)
    assert dk[:, 64:].abs().max().item() == 0.0 and dv[:, 64:].abs().max().item() == 0.0
    assert dq[:, 64:].abs().max().item() == 0.0
    assert dk[:, :64].abs().max().item() > 0 and dv[:, :64].abs().max().item() > 0


def _general_case(gen, b, s, t, h, hkv, d, fused):
    """q, k, v, dO; `fused`: q, k and v are column slices of one q|k|v projection."""
    if fused:
        qkv = _randn((b, s, (h + 2 * hkv) * d), gen)
        q = qkv[..., : h * d].view(b, s, h, d)
        k = qkv[..., h * d: (h + hkv) * d].view(b, s, hkv, d)
        v = qkv[..., (h + hkv) * d:].view(b, s, hkv, d)
    else:
        q, k, v = _randn((b, s, h, d), gen), _randn((b, t, hkv, d), gen), _randn((b, t, hkv, d), gen)
    return q, k, v, _randn((b, s, h, d), gen)


BACKWARD_CASES = [  # (B, S, T, H, Hkv, D, causal, fused)
    (2, 300, 801, 4, 4, 128, False, False),  # non-causal, S != T, both ragged
    (2, 801, 300, 8, 2, 64, False, False),  # the same at head_dim 64 with GQA 4:1
    (2, 768, 768, 4, 4, 64, True, False),  # head_dim 64
    (1, 1000, 1000, 8, 2, 128, True, False),  # the last q tile (of 64, of 128) and kv tile part-filled
    (2, 40, 40, 8, 2, 128, True, False),  # below one tile
    (1, 1, 1, 2, 2, 64, True, False),  # one query, one key
    (1, 768, 768, 4, 4, 128, True, True),  # strided slices of a fused q|k|v
    (1, 1024, 1024, 8, 1, 128, True, False),  # GQA 8:1: the group's sum over eight heads
]


@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,fused", BACKWARD_CASES)
def test_flash_backward_matches_plain_on_the_new_cases(gen, b, s, t, h, hkv, d, causal, fused):
    q, k, v, do = _general_case(gen, b, s, t, h, hkv, d, fused)
    got = _grads(lambda q, k, v: flash_mod.flash_attention_trainable(q, k, v, causal=causal),
                 q, k, v, do)
    torch.cuda.synchronize()
    want = _grads(lambda q, k, v: flash_mod.flash_attention_plain(
        q.float(), k.float(), v.float(), causal=causal), q, k, v, do)
    assert (got[0] - want[0]).abs().max().item() <= TOL
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert (g - w).norm().item() <= GRAD_REL_L2 * w.norm().item(), name
        assert (g - w).abs().max().item() <= GRAD_REL_MAX * w.abs().max().item(), name


@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,fused", BACKWARD_CASES)
def test_flash_backward_kernels_match_their_tile_walks(gen, b, s, t, h, hkv, d, causal, fused):
    """di, K4b and K4c from K4a's residuals against the preamble's torch line
    and `flash_backward_*_schedule` on the same bf16 inputs: the same tiles,
    roundings and fp32 sums in another order."""
    q, k, v, do = _general_case(gen, b, s, t, h, hkv, d, fused)
    scale = d ** -0.5
    o, m, l = flash_mod._fwd_res_cuda(q, k, v, causal, scale)
    di = flash_mod._bwd_di_cuda(o, do)
    want_di = flash_mod.flash_di_plain(o, do)
    assert (di - want_di).abs().max().item() <= DI_REL_TOL * want_di.abs().max().item()
    dk, dv = flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, causal, scale)
    dq = flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, causal, scale)
    torch.cuda.synchronize()
    want_dk, want_dv = flash_mod.flash_backward_dkv_schedule(q, k, v, do, m, l, want_di,
                                                             causal=causal)
    want_dq = flash_mod.flash_backward_dq_schedule(q, k, v, do, m, l, want_di, causal=causal)
    for name, g, w in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
        g, w = g.float(), w.float()
        assert (g - w).norm().item() <= WALK_REL_L2 * w.norm().item(), name
        assert (g - w).abs().max().item() <= WALK_REL_MAX * w.abs().max().item(), name


def test_flash_backward_is_the_same_on_every_run(gen):
    """dK and dV sum the GQA group inside the block, without atomics."""
    q, k, v, do = _general_case(gen, 2, 512, 512, 8, 2, 128, False)
    first = _grads(flash_mod.flash_attention_trainable, q, k, v, do)
    for _ in range(3):
        again = _grads(flash_mod.flash_attention_trainable, q, k, v, do)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_backward_refuses_what_it_does_not_take(gen):
    q = _randn((1, 64, 2, 96), gen).requires_grad_(True)
    with pytest.raises(ValueError, match="head_dim"):
        flash_mod.flash_attention_trainable(q, q, q)
    x = torch.randn(1, 64, 2, 128, device="cuda", requires_grad=True)  # fp32
    with pytest.raises(ValueError):
        flash_mod.flash_attention_trainable(x, x, x)
    with pytest.raises(ValueError, match="no backward"):  # K1 records no graph
        flash_mod.flash_attention(x.to(torch.bfloat16), x.to(torch.bfloat16), x.to(torch.bfloat16))


def _assert_int4_close(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = got.float() - want
    assert diff.norm().item() <= INT4_REL_L2 * want.norm().item()
    assert diff.abs().max().item() <= INT4_REL_MAX * want.abs().max().item()


def _int4_leaf(gen, k, n):
    return quant_mod.quantize_kernel_int4(torch.randn((k, n), generator=gen, device="cuda") * 0.02)


@pytest.mark.parametrize("m", [1, 3, 8, 9, 200])  # 9 and 200 take the tensor-core kernel
@pytest.mark.parametrize("k,n", [(256, 256), (1024, 72)])  # 72: a ragged last band
def test_int4_flat_kernel_matches_plain(gen, m, k, n):
    leaf = _int4_leaf(gen, k, n)
    assert leaf["packed"].dtype == torch.uint8
    x = _randn((m, k), gen)
    before = int4_mod.LAUNCHES_FLAT.count
    got = int4_mod.int4_matmul(x, leaf["packed"], leaf["scale"])
    torch.cuda.synchronize()
    assert int4_mod.LAUNCHES_FLAT.count == before + 1
    _assert_int4_close(got, int4_mod.int4_matmul_plain(x.float(), leaf["packed"], leaf["scale"]))


@pytest.mark.parametrize("fmt", ["i8", "u8"])
@pytest.mark.parametrize("m", [1, 4, 7, 16, 130])
@pytest.mark.parametrize("k,n", [(512, 1024), (600, 700)])  # 600: fan-in padded; 700: N padded
def test_int4_tiled_kernel_matches_plain(gen, fmt, m, k, n):
    leaf = _int4_leaf(gen, k, n)
    tiles, scale = leaf["packed_tiles"], leaf["scale"]
    if fmt == "u8":  # the same weights in the older byte format
        tiles = (tiles.view(torch.uint8) ^ 0x80).contiguous()
    x = _randn((m, k), gen)
    before = int4_mod.LAUNCHES_TILED.count
    got = int4_mod.int4_matmul_tiled(x, tiles, scale, n_out=n)
    torch.cuda.synchronize()
    assert int4_mod.LAUNCHES_TILED.count == before + 1
    _assert_int4_close(got, int4_mod.int4_matmul_tiled_plain(x.float(), tiles, scale, n_out=n))


@pytest.mark.parametrize("m", [1, 5, 64])
def test_int4_stacked_kernel_picks_each_layer(gen, m):
    k, n = 600, 700
    leaves = [_int4_leaf(gen, k, n) for _ in range(3)]
    tiles = torch.stack([leaf["packed_tiles"] for leaf in leaves])
    scale = torch.stack([leaf["scale"] for leaf in leaves])
    x = _randn((m, k), gen)
    for layer in range(3):
        before = int4_mod.LAUNCHES_STACKED.count, int4_mod.LAUNCHES_STACKED_SMALL_M.count
        got = int4_mod.int4_matmul_tiled_stacked(x, tiles, scale, layer, n_out=n)
        torch.cuda.synchronize()
        # the decode kernel's launches are counted apart as well
        assert (int4_mod.LAUNCHES_STACKED.count, int4_mod.LAUNCHES_STACKED_SMALL_M.count) == (
            before[0] + 1, before[1] + (m <= int4_mod.SMALL_M))
        _assert_int4_close(got, int4_mod.int4_matmul_tiled_stacked_plain(
            x.float(), tiles, scale, layer, n_out=n))
    # int4_proj reads a strided slice of a fused output through its row stride
    wide = _randn((m, 2 * k), gen)
    got = quant_mod.int4_proj(wide[:, :k], {"packed_tiles": tiles, "scale": scale}, layer=2)
    want = quant_mod.int4_proj(wide[:, :k].contiguous(), {"packed_tiles": tiles, "scale": scale}, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int4_cuda_tensors_the_kernels_do_not_take_raise(gen):
    leaf = _int4_leaf(gen, 512, 1024)
    tiles, scale = leaf["packed_tiles"], leaf["scale"]
    with pytest.raises(ValueError):  # fp32 x: no kernel, and no fallback
        int4_mod.int4_matmul_tiled(torch.randn(2, 512, device="cuda"), tiles, scale, n_out=1024)
    x = _randn((2, 512), gen)
    with pytest.raises(ValueError):  # more columns than the tiles hold
        int4_mod.int4_matmul_tiled(x, tiles, scale, n_out=2048)
    with pytest.raises(ValueError):  # x wider than the weight's fan-in
        int4_mod.int4_matmul_tiled(_randn((2, 1040), gen), tiles, scale, n_out=1024)
    with pytest.raises(ValueError):  # columns of x are not contiguous
        int4_mod.int4_matmul_tiled(_randn((512, 2), gen).t(), tiles, scale, n_out=1024)
    with pytest.raises(IndexError):
        int4_mod.int4_matmul_tiled_stacked(x, tiles[None], scale[None], 1, n_out=1024)
    with pytest.raises(NotImplementedError):  # forward only
        int4_mod.int4_matmul_tiled(x.requires_grad_(True), tiles, scale, n_out=1024)


# the 7B decoder's projections (fan-in, fan-out): q|k|v and gate|up fused,
# out, down (its packed fan-in padded 5504 -> 5632 byte rows)
INT4_7B = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]


@pytest.mark.parametrize("m", [16, 100, 768])  # batched decode, a short prompt, 2 frames
@pytest.mark.parametrize("k,n", INT4_7B)
def test_int4_prefill_kernel_at_the_7b_shapes(gen, k, n, m):
    """The M > 8 kernel: K3c on layer 1 of 2 (v3 bytes) and the same bytes as
    u8 tiles through K3b."""
    leaves = [_int4_leaf(gen, k, n) for _ in range(2)]
    tiles = torch.stack([leaf["packed_tiles"] for leaf in leaves])
    scale = torch.stack([leaf["scale"] for leaf in leaves])
    u8 = (tiles[1].view(torch.uint8) ^ 0x80).contiguous()
    x = _randn((m, k), gen)
    before = int4_mod.LAUNCHES_STACKED.count, int4_mod.LAUNCHES_TILED.count
    got = int4_mod.int4_matmul_tiled_stacked(x, tiles, scale, 1, n_out=n)
    got_u8 = int4_mod.int4_matmul_tiled(x, u8, scale[1], n_out=n)
    torch.cuda.synchronize()
    assert (int4_mod.LAUNCHES_STACKED.count, int4_mod.LAUNCHES_TILED.count) == (
        before[0] + 1, before[1] + 1)
    want = int4_mod.int4_matmul_tiled_stacked_plain(x.float(), tiles, scale, 1, n_out=n)
    _assert_int4_close(got, want)
    _assert_int4_close(got_u8, want)


@pytest.mark.parametrize("m", [16, 100, 768])
def test_int4_prefill_flat_kernel_at_the_kv_shape(gen, m):
    """K3a at an unfused k or v of a model with 2 kv heads: K 4096, N 256."""
    leaf = _int4_leaf(gen, 4096, 256)
    x = _randn((m, 4096), gen)
    before = int4_mod.LAUNCHES_FLAT.count
    got = int4_mod.int4_matmul(x, leaf["packed"], leaf["scale"])
    torch.cuda.synchronize()
    assert int4_mod.LAUNCHES_FLAT.count == before + 1
    _assert_int4_close(got, int4_mod.int4_matmul_plain(x.float(), leaf["packed"], leaf["scale"]))


@pytest.mark.parametrize("layout", ["flat", "tiled_u8", "tiled_i8", "stacked"])
@pytest.mark.parametrize("m", [9, 70, 130])  # ragged against the 128-row tile
@pytest.mark.parametrize("k,k2", [(208, 104), (200, 104), (96, 128)])
def test_int4_prefill_kernel_matches_its_walk(gen, layout, m, k, k2):
    """The kernel against `int4_prefill_schedule` on the CPU tests' cases:
    k2 % 64 != 0, K < 2 k2, K < k2; N 640 (a ragged tile and, flat, a ragged
    band); x a column slice of a wider activation (row stride > K)."""
    n = 640
    w = torch.randint(-8, 8, (2 * k2, n), generator=gen, device="cuda")
    scale = torch.rand(n, generator=gen, device="cuda") * 0.1 + 0.01
    x = _randn((m, 2 * k + 8), gen)[:, 8:8 + k]
    if layout == "flat":
        packed = int4_mod.pack_int4(w)
        got = int4_mod.int4_matmul(x, packed, scale)
        walk = int4_mod.int4_prefill_schedule(x.float(), packed, scale)
    elif layout == "stacked":
        packed = torch.stack([int4_mod.pack_int4_tiled_i8(w.flip(0)),
                              int4_mod.pack_int4_tiled_i8(w)])
        scale2 = torch.stack([scale * 2, scale])
        got = int4_mod.int4_matmul_tiled_stacked(x, packed, scale2, 1, n_out=n)
        walk = int4_mod.int4_prefill_schedule(x.float(), packed, scale2, n_out=n, layer=1)
    else:
        pack = int4_mod.pack_int4_tiled if layout == "tiled_u8" else int4_mod.pack_int4_tiled_i8
        packed = pack(w)
        got = int4_mod.int4_matmul_tiled(x, packed, scale, n_out=n)
        walk = int4_mod.int4_prefill_schedule(x.float(), packed, scale, n_out=n)
    torch.cuda.synchronize()
    _assert_int4_close(got, walk)


@pytest.mark.parametrize("m,launches", [(16, 600), (768, 200)])
def test_int4_prefill_kernel_is_bit_stable_over_many_launches(gen, m, launches):
    """A stress case for the hand-over of the dequantized tiles: the dequant
    threads' ordinary shared-memory stores reach `wgmma` (the async proxy)
    only through their `fence.proxy.async` before the `full` arrival. Without
    it the products may read a stage's bytes from an earlier step. Back to
    back launches over four layers of out's shape (N 4096: 32 column bands),
    at M 16, where the consumers wait on the dequant threads and issue
    `wgmma` right after their arrival, and at M 768; each output must be
    bit-equal to the first launch on its layer."""
    k, n, n_layers = 4096, 4096, 4
    leaves = [_int4_leaf(gen, k, n) for _ in range(n_layers)]
    tiles = torch.stack([leaf["packed_tiles"] for leaf in leaves])
    scale = torch.stack([leaf["scale"] for leaf in leaves])
    x = _randn((m, k), gen)
    before = int4_mod.LAUNCHES_STACKED.count
    first = torch.stack([int4_mod.int4_matmul_tiled_stacked(x, tiles, scale, layer, n_out=n)
                         for layer in range(n_layers)])
    outs = torch.stack([int4_mod.int4_matmul_tiled_stacked(x, tiles, scale, i % n_layers,
                                                           n_out=n)
                        for i in range(launches)])
    torch.cuda.synchronize()
    assert int4_mod.LAUNCHES_STACKED.count == before + n_layers + launches
    _assert_int4_close(first[1], int4_mod.int4_matmul_tiled_stacked_plain(
        x.float(), tiles, scale, 1, n_out=n))
    differ = (outs != first.repeat(launches // n_layers, 1, 1)).flatten(1).any(1)
    assert not differ.any(), f"launches {differ.nonzero().flatten().tolist()[:20]} differ"


# the M <= 8 kernel: K3a's 256-wide k or v (K 4096: 32 K slices of 64 byte
# rows merged in the launch) and N 640 over 1024 byte rows (K < 2 k2; a
# ragged tile and, flat, a ragged band; 26 slices of 40 rows, the last 24)
INT4_DECODE_CASES = [(4096, 2048, 256), (2000, 1024, 640)]


@pytest.mark.parametrize("layout", ["flat", "tiled_u8", "tiled_v3", "stacked"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("k,k2,n", INT4_DECODE_CASES)
def test_int4_decode_kernel_matches_plain_and_its_walk(gen, layout, m, k, k2, n):
    """The split-K kernel against the plain version and `int4_decode_schedule`,
    x a column slice of a wider activation (row stride > K)."""
    w = torch.randint(-8, 8, (2 * k2, n), generator=gen, device="cuda")
    scale = torch.rand(n, generator=gen, device="cuda") * 0.01 + 0.001
    x = _randn((m, 2 * k + 8), gen)[:, 8:8 + k]
    sms = _build.sm_count(x.device)  # the walk cuts K as the wrapper does on this card
    counter = int4_mod.LAUNCHES_TILED
    if layout == "flat":
        packed, counter = int4_mod.pack_int4(w), int4_mod.LAUNCHES_FLAT
        run = lambda: int4_mod.int4_matmul(x, packed, scale)
        plain = int4_mod.int4_matmul_plain(x.float(), packed, scale)
        walk = int4_mod.int4_decode_schedule(x.float(), packed, scale, sms=sms)
    elif layout == "stacked":
        packed = torch.stack([int4_mod.pack_int4_tiled_i8(w.flip(0)),
                              int4_mod.pack_int4_tiled_i8(w)])
        scale2, counter = torch.stack([scale * 2, scale]), int4_mod.LAUNCHES_STACKED_SMALL_M
        run = lambda: int4_mod.int4_matmul_tiled_stacked(x, packed, scale2, 1, n_out=n)
        plain = int4_mod.int4_matmul_tiled_stacked_plain(x.float(), packed, scale2, 1, n_out=n)
        walk = int4_mod.int4_decode_schedule(x.float(), packed, scale2, n_out=n, layer=1,
                                             sms=sms)
    else:
        pack = int4_mod.pack_int4_tiled if layout == "tiled_u8" else int4_mod.pack_int4_tiled_i8
        packed = pack(w)
        run = lambda: int4_mod.int4_matmul_tiled(x, packed, scale, n_out=n)
        plain = int4_mod.int4_matmul_tiled_plain(x.float(), packed, scale, n_out=n)
        walk = int4_mod.int4_decode_schedule(x.float(), packed, scale, n_out=n, sms=sms)
    before = counter.count
    got = run()
    torch.cuda.synchronize()
    assert counter.count == before + 1
    assert int4_mod.decode_k_slices(n, k2, sms) > 1  # both cases merge partials in the launch
    _assert_int4_close(got, plain)
    _assert_int4_close(got, walk)


def _out_stack(gen, n_layers):
    """out's shape (K 4096, N 4096: 32 bands x 4 K slices) over n_layers layers."""
    leaves = [_int4_leaf(gen, 4096, 4096) for _ in range(n_layers)]
    return (torch.stack([leaf["packed_tiles"] for leaf in leaves]),
            torch.stack([leaf["scale"] for leaf in leaves]))


def test_int4_decode_kernel_is_bit_stable_over_many_launches(gen):
    """600 back-to-back M 1 launches over four layers, each bit-equal to the
    first launch on its layer: the partials are merged in slice order by
    whichever block of a band comes last, and the tickets are reset."""
    n_layers, launches = 4, 600
    tiles, scale = _out_stack(gen, n_layers)
    x = _randn((1, 4096), gen)
    before = int4_mod.LAUNCHES_STACKED_SMALL_M.count
    first = torch.stack([int4_mod.int4_matmul_tiled_stacked(x, tiles, scale, layer, n_out=4096)
                         for layer in range(n_layers)])
    outs = torch.stack([int4_mod.int4_matmul_tiled_stacked(x, tiles, scale, i % n_layers,
                                                           n_out=4096)
                        for i in range(launches)])
    torch.cuda.synchronize()
    assert int4_mod.LAUNCHES_STACKED_SMALL_M.count == before + n_layers + launches
    _assert_int4_close(first[1], int4_mod.int4_matmul_tiled_stacked_plain(
        x.float(), tiles, scale, 1, n_out=4096))
    differ = (outs != first.repeat(launches // n_layers, 1, 1)).flatten(1).any(1)
    assert not differ.any(), f"launches {differ.nonzero().flatten().tolist()[:20]} differ"


@pytest.mark.parametrize("m", [1, 8])
def test_int4_decode_kernel_replays_in_a_cuda_graph(gen, m):
    """One launch captured in a CUDA graph and replayed 100 times, each
    replay bit-equal to the eager launch: the workspace is sized by the
    shape, the tickets stay zero between launches."""
    tiles, scale = _out_stack(gen, 2)
    x = _randn((m, 4096), gen)
    eager = int4_mod.int4_matmul_tiled_stacked(x, tiles, scale, 1, n_out=4096)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up torch.cuda.graph asks for
        int4_mod.int4_matmul_tiled_stacked(x, tiles, scale, 1, n_out=4096)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = int4_mod.int4_matmul_tiled_stacked(x, tiles, scale, 1, n_out=4096)
    replays = []
    for _ in range(100):
        graph.replay()
        replays.append(static.clone())
    torch.cuda.synchronize()
    _assert_int4_close(eager, int4_mod.int4_matmul_tiled_stacked_plain(
        x.float(), tiles, scale, 1, n_out=4096))
    differ = [i for i, out in enumerate(replays) if not torch.equal(out, eager)]
    assert not differ, f"replays {differ[:20]} differ from the eager launch"


@pytest.mark.parametrize("b,s,h", [
    (2, 257, 16), (3, 100, 4), (1, 64, 2), (1, 1024, 2),
    (32, 257, 16),  # the bench's encode: two warpgroups a block, persistent blocks
    (2, 272, 4), (2, 273, 4),  # one window exactly; a second window with one key
    (1, 577, 16), (4, 577, 16),  # a 336-pixel tower: three windows, at both launch shapes
    (3, 65, 8),  # a second query tile with one row
])
def test_vit_attention_kernel_matches_plain(gen, b, s, h):
    q, k, v = (_randn((b, s, h, 64), gen) for _ in range(3))
    before = vit_mod.LAUNCHES.count
    got = vit_mod.vit_attention(q, k, v)
    torch.cuda.synchronize()
    assert vit_mod.LAUNCHES.count == before + 1
    want = vit_mod.vit_attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, 64)
    assert (got.float() - want).abs().max().item() <= TOL


@pytest.mark.parametrize("b,s,h", [(2, 130, 4), (32, 257, 16)])  # both launch shapes
def test_vit_attention_reads_strided_inputs_and_refuses_the_rest(gen, b, s, h):
    qkv = _randn((b, s, 3, h, 64), gen)
    q, k, v = qkv.unbind(2)
    got = vit_mod.vit_attention(q, k, v, scale=0.2)
    want = vit_mod.vit_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=0.2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # head-major views ([B, H, S, D] transposed) are read in place as well
    hm = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    torch.testing.assert_close(vit_mod.vit_attention(*hm, scale=0.2), want, rtol=0, atol=0)
    sched = vit_mod.vit_attention_schedule(q.float(), k.float(), v.float(), scale=0.2)
    assert (got.float() - sched).abs().max().item() <= TOL
    with pytest.raises(ValueError):  # head_dim 128
        x = _randn((1, 64, 2, 128), gen)
        vit_mod.vit_attention(x, x, x)
    with pytest.raises(ValueError):  # S below the gate: no fallback on the card
        x = _randn((1, 8, 2, 64), gen)
        vit_mod.vit_attention(x, x, x)
    with pytest.raises(ValueError):  # fp32
        x = torch.randn(1, 64, 2, 64, device="cuda")
        vit_mod.vit_attention(x, x, x)
    # no backward: a tower that trains raises instead of cutting the gradient
    x = _randn((1, 64, 2, 64), gen).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        vit_mod.vit_attention(x, x, x)
    with torch.no_grad():
        assert vit_mod.vit_attention(x, x, x).shape == x.shape


# ------------------------------------------------ gradients with an fp32 operand (F2b, F3)


def _steps_off_exact(got, a, b):
    """How many of `got` (bf16) differ from the one rounding of the exact sum a @ b."""
    exact = (a.double() @ b.double()).float().to(torch.bfloat16)
    return int((got != exact).sum()), got.numel()


def test_fp32_cotangent_products_are_one_rounding_of_the_exact_sum(gen):
    """matmul_fp32's gradients and the int8 projection's dx take the fp32
    cotangent whole (a bf16 head and remainder in one product): at most 2 of
    256 values a bf16 step from the exact sum's rounding."""
    a = _randn((64, 1024), gen).requires_grad_(True)
    b = _randn((1024, 512), gen).requires_grad_(True)
    dy = torch.randn((64, 512), generator=gen, device="cuda")
    quant_mod.matmul_fp32(a, b).backward(dy)
    for got, x, y in ((a.grad, dy, b.detach().t()), (b.grad, a.detach().t(), dy)):
        off, n = _steps_off_exact(got, x, y)
        assert got.dtype == torch.bfloat16 and off <= 2 * n / 256, (off, n)
    w = torch.randint(-127, 128, (1024, 512), generator=gen, device="cuda", dtype=torch.int8)
    p = {"kernel": w, "scale": torch.rand(512, generator=gen, device="cuda") * 1e-2}
    x = _randn((64, 1024), gen).requires_grad_(True)
    dy16 = _randn((64, 512), gen)
    quant_mod.quantized_proj(x, p).backward(dy16)
    off, n = _steps_off_exact(x.grad, dy16.float() * p["scale"], w.float().t())
    assert off <= 2 * n / 256, (off, n)


# ------------------------------------------------ the kernel benches' variants (S1, S2)


def _bench_int4_inputs(gen, k, n, m, bn=512):
    w_q = torch.randint(-8, 8, (k, n), generator=gen, device="cuda").to(torch.int8)
    scale = torch.rand((n,), generator=gen, device="cuda") * 0.01
    return w_q, scale, _randn((m, k), gen)


BENCH_INT4_CASES = {  # name -> (packer, kernel, plain, takes xa / xb)
    "v2": (int4_mod.pack_int4_tiled, bench_int4.v2_matmul, bench_int4.v2_matmul_plain, True),
    "v3": (bench_int4.pack_int4_i8, bench_int4.v3_matmul, bench_int4.v3_matmul_plain, True),
    "v5": (bench_int4.pack_int4_i8, bench_int4.v5_matmul, bench_int4.v5_matmul_plain, True),
    "v4": (bench_int4.pack_int4_native, bench_int4.v4_matmul, bench_int4.v4_matmul_plain, False),
}


@pytest.mark.parametrize("name", list(BENCH_INT4_CASES))
@pytest.mark.parametrize("k,n,m,bn,k_slices", [
    (4096, 11008, 1, 512, 0),  # the bench's projection
    (4096, 11008, 8, 512, 0),
    (256, 700, 3, 512, 3),  # ragged N; slices of 48, 48, 32 rows
    (512, 2048, 19, 1024, 5),  # three row chunks of 8, a wider tile; 56 x 4 and 32 rows
    (512, 700, 1, 128, 0),  # the narrowest tile: stages of 128 rows
    (2048, 3000, 8, 1024, 0),  # stages of 16 rows
    (1024, 5000, 2, 2048, 0),  # the widest tile: stages of 8 rows
    (1040, 600, 19, 512, 7),  # k2 520: slices of 80 rows, the last 40; M 19
])
def test_bench_int4_variant_matches_plain(gen, name, k, n, m, bn, k_slices):
    pack, kernel, plain, split = BENCH_INT4_CASES[name]
    w_q, scale, x = _bench_int4_inputs(gen, k, n, m)
    tiles = pack(w_q, bn)
    # xa and xb are rounded to bf16 once, for both sides
    kw = {"operands": bench_int4.byte_reuse_operands(x, k // 2)} if split else {}
    slices_kw = {"k_slices": k_slices}  # the ring body takes the K slices of a tile
    kw_kernel = {**kw, **slices_kw}
    counter = bench_int4.COUNTERS[f"S1-{name}"]
    before = counter.count
    got = kernel(x, tiles, scale, n_out=n, **kw_kernel)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    _assert_int4_close(got, plain(x.float(), tiles, scale, n_out=n, **kw))
    if split:  # and the wrapper's own split gives the same bytes
        assert torch.equal(kernel(x, tiles, scale, n_out=n, **slices_kw), got)
    # and the walk on the same inputs (the byte reuse: the same rounded xa, xb)
    walk = bench_int4.ring_schedule(
        x.float(), tiles, scale, n_out=n, variant=name, operands=kw.get("operands"),
        k_slices=k_slices or None, sms=_build.sm_count(x.device))
    _assert_int4_close(got, walk.float())
    if name == "v3":
        m16 = kernel(x, tiles, scale, n_out=n, mask_dtype=torch.int16, **kw_kernel)
        assert torch.equal(m16, got)  # the mask's width changes the code, not the result
    # against the exact product: the bf16 rounding of xa adds ~1e-3 relative L2
    exact = x.float() @ w_q.float() * scale
    bound = bench_int4.BYTE_REUSE_REL_MAX if split else bench_int4.EXACT_REL_MAX
    assert (got.float() - exact).abs().max().item() <= bound * exact.abs().max().item()


def _bench_int4_ring_call(name, x, tiles, scale, n, kw):
    if name == "dma":
        return bench_int4.dma_only_matmul(x, tiles, n_out=n)
    if name == "vpu":
        return bench_int4.vpu_only(tiles)[0]
    return BENCH_INT4_CASES[name][1](x, tiles, scale, n_out=n, **kw)


@pytest.mark.parametrize("name,m", [(name, m) for name in BENCH_INT4_CASES for m in (1, 8)]
                         + [("dma", 1), ("dma", 8), ("vpu", 1)])
def test_bench_int4_ring_is_bit_equal_and_resets_its_tickets(gen, name, m):
    """200 back-to-back launches at the bench's shape give the same bits, and
    the tickets the tiles' last blocks take are zero again after them (the
    probes on u8 tiles; vpu takes no x, so M is 1)."""
    k, n = bench_int4.K, bench_int4.N
    pack, split = (int4_mod.pack_int4_tiled, False) if name in ("dma", "vpu") else (
        BENCH_INT4_CASES[name][0], BENCH_INT4_CASES[name][3])
    w_q, scale, x = _bench_int4_inputs(gen, k, n, m)
    tiles = pack(w_q, 512)
    kw = {"operands": bench_int4.byte_reuse_operands(x, k // 2)} if split else {}
    first = _bench_int4_ring_call(name, x, tiles, scale, n, kw)
    outs = [_bench_int4_ring_call(name, x, tiles, scale, n, kw) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)
    k_slices = bench_int4.ring_k_slices(tiles.shape[0], k // 2, _build.sm_count(x.device))
    assert k_slices > 1
    tickets = _build.tickets_for(x.device, -(-m // (1 if m == 1 else 8)) * tiles.shape[0])
    assert int(tickets.abs().sum().item()) == 0


@pytest.mark.parametrize("k,n,m,bn,k_slices", [
    (4096, 11008, 1, 512, 0), (4096, 11008, 8, 512, 0), (256, 700, 11, 512, 0),
    (256, 700, 3, 512, 3),  # ragged N; slices of 48, 48, 32 rows
    (512, 2048, 19, 1024, 5),  # three row chunks of 8, a wider tile; 56 x 4 and 32 rows
    (512, 700, 1, 128, 0),  # the narrowest tile: stages of 128 rows
    (1024, 5000, 2, 2048, 0),  # the widest tile: stages of 8 rows
    (1040, 600, 19, 512, 7),  # k2 520: slices of 80 rows, the last 40; M 19
])
def test_bench_int4_probes_match_plain(gen, k, n, m, bn, k_slices):
    """dma and vpu on the ring body against their plain versions and the
    walk; dma also on x read at a row stride of K + 64."""
    w_q, _, x = _bench_int4_inputs(gen, k, n, m)
    tiles = int4_mod.pack_int4_tiled(w_q, bn)
    before = bench_int4.LAUNCHES_DMA.count, bench_int4.LAUNCHES_VPU.count
    got = bench_int4.dma_only_matmul(x, tiles, n_out=n, k_slices=k_slices)
    cols, total = bench_int4.vpu_only(tiles, k_slices=k_slices)
    torch.cuda.synchronize()
    assert (bench_int4.LAUNCHES_DMA.count, bench_int4.LAUNCHES_VPU.count) == (
        before[0] + 1, before[1] + 1)
    _assert_int4_close(got, bench_int4.dma_only_matmul_plain(x.float(), tiles, n_out=n))
    sms = _build.sm_count(x.device)
    walk = bench_int4.ring_schedule(x.float(), tiles, None, n_out=n, variant="dma",
                                    k_slices=k_slices or None, sms=sms)
    _assert_int4_close(got, walk)
    wide = torch.zeros((m, k + 64), dtype=x.dtype, device=x.device)
    wide[:, :k] = x
    assert torch.equal(bench_int4.dma_only_matmul(wide[:, :k], tiles, n_out=n,
                                                  k_slices=k_slices), got)
    want_cols, want_total = bench_int4.vpu_only_plain(tiles)
    assert torch.equal(cols, want_cols)  # sums of small integers: exact
    assert torch.equal(cols, bench_int4.ring_schedule(None, tiles, None, n_out=0, variant="vpu",
                                                      k_slices=k_slices or None, sms=sms))
    assert abs(total.item() - want_total.item()) <= 1e-6 * abs(want_total.item())


def test_bench_int4_sass_shows_the_ring(gen):
    """The probes' kernels stream by bulk copies, and dma's M > 1 kernel
    takes its bytes to mma.sync without an int-to-float conversion."""
    sass = bench_int4.sass_counts()
    for key in ("dma_ring", "vpu_ring", "dma_ring m8"):
        assert sass[key].get("UBLKCP", 0) >= 1, key
    m8 = sass["dma_ring m8"]
    assert m8.get("HMMA", 0) >= 8 and not m8.get("I2FP", 0) and not m8.get("F2F", 0)


def test_bench_int4_cuda_tensors_the_kernels_do_not_take_raise(gen):
    w_q, scale, x = _bench_int4_inputs(gen, 256, 700, 2)
    u8, i8 = int4_mod.pack_int4_tiled(w_q), bench_int4.pack_int4_i8(w_q)
    with pytest.raises(ValueError):  # int8 tiles to the u8 kernel: no fallback
        bench_int4.v2_matmul(x, i8, scale, n_out=700)
    with pytest.raises(ValueError):  # fp32 x
        bench_int4.v3_matmul(x.float(), i8, scale, n_out=700)
    with pytest.raises(ValueError):  # more columns than the tiles hold
        bench_int4.v5_matmul(x, i8, scale, n_out=2048)
    with pytest.raises(ValueError):  # x narrower than the weight's fan-in
        bench_int4.v4_matmul(x[:, :128], u8, scale, n_out=700)
    with pytest.raises(ValueError):  # K slices that leave slices without rows
        bench_int4.v3_matmul(x, i8, scale, n_out=700, k_slices=15)
    with pytest.raises(ValueError):
        bench_int4.v2_matmul(x, u8, scale, n_out=700, k_slices=15)
    with pytest.raises(ValueError):
        bench_int4.dma_only_matmul(x, u8, n_out=700, k_slices=15)
    with pytest.raises(ValueError):
        bench_int4.vpu_only(u8, k_slices=15)
    with pytest.raises(ValueError):  # a row stride the bulk copies cannot take (not 16 bytes)
        wide = torch.zeros((2, 260), dtype=x.dtype, device=x.device)
        bench_int4.dma_only_matmul(wide[:, :256], u8, n_out=700)
    with pytest.raises(ValueError):  # a tile width that is no multiple of 128
        bench_int4.vpu_only(int4_mod.pack_int4_tiled(w_q, 64))


@pytest.mark.parametrize("name", ["b", "c"])
@pytest.mark.parametrize("b,s,h,bh", [
    (32, 257, 16, 1), (32, 257, 16, 2), (32, 257, 16, 4), (32, 257, 16, 8),
    (32, 257, 16, 16),  # the bench's shape at each bh of its sweep: one window, 15 keys masked
    (2, 257, 16, 16), (3, 100, 4, 1), (1, 17, 2, 2),
    (2, 300, 4, 2),  # two sweeps; the second window holds 28 keys
    (1, 832, 2, 1),  # the gate: four windows, the last with 16 keys
])
def test_bench_vit_variant_matches_plain(gen, name, b, s, h, bh):
    q, k, v = (_randn((b, s, h, 64), gen) for _ in range(3))
    counter = bench_vit.COUNTERS[f"S2-{name}"]
    before = counter.count
    call = (lambda: bench_vit.call_b(q, k, v, bh=bh)) if name == "b" else (
        lambda: bench_vit.call_c(q, k, v))
    got = call()
    torch.cuda.synchronize()
    assert counter.count == before + 1
    want = bench_vit.call_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, 64) and got.is_contiguous()
    assert (got.float() - want).abs().max().item() <= bench_vit.TOL
    walk = bench_vit.one_sweep_schedule(q, k, v)  # bf16 in: p / l rounded as the kernel does
    walk_err = (got.float() - walk.float()).abs().max().item()
    assert walk_err <= S2_WALK_REL * walk.float().abs().max().item()
    assert torch.equal(call(), got)  # no atomics: the same bits on every call


def test_bench_vit_reads_strided_inputs_and_refuses_the_rest(gen):
    qkv = _randn((2, 130, 3, 4, 64), gen)
    q, k, v = qkv.unbind(2)
    for fn in (lambda *qkv: bench_vit.call_b(*qkv, bh=2), bench_vit.call_c):
        got = fn(q, k, v)
        torch.testing.assert_close(got, fn(q.contiguous(), k.contiguous(), v.contiguous()),
                                   rtol=0, atol=0)
        with pytest.raises(ValueError):  # head_dim 128
            x = _randn((1, 64, 2, 128), gen)
            fn(x, x, x)
        with pytest.raises(ValueError):  # S = 833 is past the bench's gate
            x = _randn((1, 833, 2, 64), gen)
            fn(x, x, x)
        with pytest.raises(ValueError):  # fp32
            x = torch.randn(1, 64, 2, 64, device="cuda")
            fn(x, x, x)
    with pytest.raises(ValueError):  # bh must divide H
        bench_vit.call_b(q, k, v, bh=3)


# ---------------------------------------------- the decode step's CUDA graph
#
# generate_tokens on the card replays one decode iteration from a CUDA graph
# (models/generation.py::DecodeGraph). These run a 2-layer decoder at
# LLaMA-7B width (int8: cuBLAS products; int4: K3's decode kernel, its int4
# lm_head) against the eager loop on the same card.

GRAPH_CFG = dataclasses.replace(TEOChatConfig().llm, num_layers=2)
GRAPH_S = 48


@pytest.fixture(scope="module")
def decoders():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {quant: bridge.init_llama(GRAPH_CFG, gen, "cuda", torch.bfloat16, quant=quant)
            for quant in ("int8", "int4")}


def _graph_prompt(b, seed=3):
    """[B, S, D] stand-in embeddings of ragged prompts, right-padded."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cut = [0, 5, 17, 1, 9, 30, 2, 12, 0, 21, 7, 3, 40, 15, 11, 26][:b]
    lens = GRAPH_S - torch.tensor(cut, device="cuda")
    embeds = (torch.randn(b, GRAPH_S, GRAPH_CFG.hidden_size, generator=gen, device="cuda")
              * 0.02).to(torch.bfloat16)
    slot = torch.arange(GRAPH_S, device="cuda")
    mask = slot[None, :] < lens[:, None]
    return embeds, lens.to(torch.int32), mask, torch.where(mask, slot, 0).to(torch.int32)


def _never_stop(eos=-1, m=1):
    return gen_mod.StopSpec(keyword_ids=np.zeros((1, m), np.int32),
                            keyword_lens=np.zeros((1,), np.int32), eos_id=eos)


def _decode(params, prompt, graphed, *, max_new=11, stop=None, generator=None,
            temperature=0.0, do_sample=False, kv_dtype=None, state_out=None, adapter_route=None):
    embeds, lens, mask, pos = prompt
    if generator is None:
        generator = torch.Generator(device="cuda").manual_seed(0)
    tokens, n_gen, state = gen_mod._generate_tokens(
        params, GRAPH_CFG, embeds, lens, mask, pos, stop or _never_stop(), generator,
        max_new_tokens=max_new, cache_len=GRAPH_S + max_new + 1, temperature=temperature,
        do_sample=do_sample, top_p=1.0, pad_id=0, graphed=graphed, kv_dtype=kv_dtype,
        adapter_route=adapter_route)
    if state_out is not None:
        state_out.append(state)
    return tokens, n_gen, state.logits.clone()


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_decode_graph_tokens_equal_the_eager_loop(decoders, quant, b):
    """Greedy tokens and n_gen of the replayed graph (its first call: the
    warm-up iteration, the capture, replays; its second: replays only) are
    the eager loop's, without a stop and with EOS inside a chunk. At 16 rows
    the int4 step runs K3's M > 8 kernel (its TMA map of x encoded at the
    capture)."""
    params, prompt = decoders[quant], _graph_prompt(b)
    gen_mod.clear_decode_graphs()
    want = _decode(params, prompt, False)
    for _ in range(2):
        got = _decode(params, prompt, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    eos = int(want[0][0, 4])  # row 0 stops by its fifth token, inside a chunk of 2
    stop = _never_stop(eos, m=2)
    want = _decode(params, prompt, False, stop=stop)
    got = _decode(params, prompt, True, stop=stop)
    assert int(want[1][0]) <= 5
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    gen_mod.clear_decode_graphs()


@pytest.mark.parametrize("b", [1, 16])
def test_decode_graph_replays_are_bit_equal(decoders, b):
    """Two requests of 51 tokens on one entry (49 replays, then 50): the
    same tokens, last logits and KV cache bits, and the eager loop's
    tokens and n_gen. The graph's workspaces, x and outputs are its
    capture's own: K3's decode kernel at 1 row, its M > 8 kernel at 16."""
    params, prompt = decoders["int4"], _graph_prompt(b)
    gen_mod.clear_decode_graphs()
    first = _decode(params, prompt, True, max_new=51)
    (entry,) = gen_mod.decode_graphs()
    large_m = (entry.launches.get(int4_mod.LAUNCHES_STACKED, 0)
               - entry.launches.get(int4_mod.LAUNCHES_STACKED_SMALL_M, 0))
    assert large_m == (4 * GRAPH_CFG.num_layers if b > 8 else 0)  # a step's M > 8 launches
    cache = entry.state.cache.k.clone(), entry.state.cache.v.clone()
    second = _decode(params, prompt, True, max_new=51)
    assert entry.replays == 49 + 50
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(cache[0], entry.state.cache.k) and torch.equal(cache[1], entry.state.cache.v)
    eager = _decode(params, prompt, False, max_new=51)
    assert torch.equal(eager[0], second[0]) and torch.equal(eager[1], second[1])
    gen_mod.clear_decode_graphs()


def test_decode_graph_is_captured_once_a_key(decoders):
    """A second request with the same key (another prompt of the same
    length) replays the graph of the first: no new entry, no new capture.
    A request of one token makes no entry."""
    params = decoders["int8"]
    gen_mod.clear_decode_graphs()
    _decode(params, _graph_prompt(4), True)
    (entry,) = gen_mod.decode_graphs()
    graph, seconds, replays = entry.graph, entry.capture_seconds, entry.replays
    assert graph is not None and seconds > 0
    _decode(params, _graph_prompt(4, seed=4), True)
    assert gen_mod.decode_graphs() == [entry]
    assert entry.graph is graph and entry.capture_seconds == seconds
    assert entry.replays == replays + 10
    embeds, lens, mask, pos = _graph_prompt(4)
    tokens, _ = gen_mod.generate_tokens(  # one token feeds nothing back: no entry
        params, GRAPH_CFG, embeds, lens, mask, pos, _never_stop(),
        torch.Generator(device="cuda"), max_new_tokens=1, cache_len=GRAPH_S + 2)
    assert tokens.shape == (4, 1) and gen_mod.decode_graphs() == [entry]
    gen_mod.clear_decode_graphs()


def test_decode_graph_counts_its_replayed_launches(decoders):
    """The launch counts of a graphed request (first call and a replayed
    one) are those of the eager loop: what the device ran."""
    params, prompt = decoders["int4"], _graph_prompt(1)
    counters = {"K1": flash_mod.LAUNCHES, "K2": dec_mod.LAUNCHES,
                "K3b": int4_mod.LAUNCHES_TILED, "K3c": int4_mod.LAUNCHES_STACKED,
                "K3c M<=8": int4_mod.LAUNCHES_STACKED_SMALL_M}
    gen_mod.clear_decode_graphs()

    def counts(graphed):
        for c in counters.values():
            c.reset()
        _decode(params, prompt, graphed)
        return {name: c.count for name, c in counters.items()}

    eager, first, again = counts(False), counts(True), counts(True)
    assert eager == first == again
    layers, steps = GRAPH_CFG.num_layers, 10  # 11 tokens: 10 fed back
    assert eager["K2"] == layers * steps and eager["K3c M<=8"] == 4 * layers * steps
    assert eager["K3b"] == 1 + steps and eager["K1"] == layers
    gen_mod.clear_decode_graphs()


def test_decode_graph_samples_follow_the_seed(decoders):
    """A sampled run: the same seed gives the same tokens, another seed
    other tokens, and the caller's generator advances."""
    params, prompt = decoders["int4"], _graph_prompt(4)
    gen_mod.clear_decode_graphs()

    def sample(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        before = gen.get_state().clone()
        tokens = _decode(params, prompt, True, generator=gen, temperature=1.0,
                         do_sample=True)[0]
        return tokens, before, gen.get_state()

    a, b, c = sample(1), sample(1), sample(2)
    assert gen_mod.decode_graphs()[0].generator is not None
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert not torch.equal(a[1], a[2])
    gen_mod.clear_decode_graphs()


def test_a_failed_capture_raises(decoders, monkeypatch):
    """A host read inside the captured iteration fails the capture, and the
    call raises (there is no eager fallback); then the same request captures
    and replays as it should."""
    params, prompt = decoders["int4"], _graph_prompt(1)
    gen_mod.clear_decode_graphs()
    hit = gen_mod._keyword_hit

    def reads_back(window, keyword_ids, keyword_lens):
        out = hit(window, keyword_ids, keyword_lens)
        out.any().item()
        return out

    monkeypatch.setattr(gen_mod, "_keyword_hit", reads_back)
    before = dec_mod.LAUNCHES.count
    with pytest.raises(RuntimeError):
        _decode(params, prompt, True)
    monkeypatch.undo()
    assert gen_mod.decode_graphs()[0].graph is None
    assert dec_mod.LAUNCHES.count == before + GRAPH_CFG.num_layers  # the eager warm-up's
    gen_mod.clear_decode_graphs()
    want = _decode(params, prompt, False)
    got = _decode(params, prompt, True)
    assert torch.equal(got[0], want[0])
    gen_mod.clear_decode_graphs()


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_decode_graph_dies_with_its_params(decoders, quant):
    """An entry holds its params weakly: once they are deleted it is gone,
    and empty_cache returns its cache, buffers and pool to the card (int8's
    cuBLAS workspace too: the capture's lives in the graph's pool)."""
    prompt = _graph_prompt(1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    gen_mod.clear_decode_graphs()

    def run_once():
        params = bridge.init_llama(GRAPH_CFG, gen, "cuda", torch.bfloat16, quant=quant)
        _decode(params, prompt, True)
        assert len(gen_mod.decode_graphs()) == 1
        del params
        gc.collect()
        assert gen_mod.decode_graphs() == []

    run_once()  # whatever a first capture leaves for the process (handles) stays
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    run_once()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() == allocated
    assert torch.cuda.memory_reserved() <= reserved


def test_session_decode_graph_keeps_its_cache_and_dies_with_it(decoders):
    """decode_with_cache over a caller's cache on the card: its tokens equal
    the eager loop's from the same cache, a second call on the same cache
    replays the same graph (no capture), the cache is never zeroed, and the
    entry (with its pool) goes when the cache is dropped."""
    params = decoders["int8"]
    embeds, lens, mask, pos = _graph_prompt(1)
    gen_mod.clear_decode_graphs()

    def turn(graphed, cache=None):
        cache = cache or llama_mod.init_cache(GRAPH_CFG, 1, 512, device="cuda")
        logits, cache = gen_mod.prefill_full(params, GRAPH_CFG, cache, embeds, lens, mask, pos)
        if graphed:
            out = gen_mod.decode_with_cache(params, GRAPH_CFG, cache, logits, lens, _never_stop(),
                                            torch.Generator(device="cuda"), max_new_tokens=11)
        else:
            state = gen_mod.DecodeState.new(cache, GRAPH_CFG.vocab_size, 11, (1, 1))
            state.reset(lens, _never_stop(), 0)
            out = (*gen_mod._run_decode_loop(params, GRAPH_CFG, state, logits,
                                             torch.Generator(device="cuda"), None,
                                             max_new_tokens=11, temperature=0.0, do_sample=False,
                                             top_p=1.0, pad_id=0, emb_dtype=torch.bfloat16),
                   cache)
        return out

    want = turn(False)
    tokens, n_gen, cache = turn(True)
    assert torch.equal(tokens, want[0]) and torch.equal(n_gen, want[1])
    assert torch.equal(cache.k[:, :, :GRAPH_S + 10], want[2].k[:, :, :GRAPH_S + 10])
    entry, = gen_mod.decode_graphs()
    assert entry.graph is not None and entry.state.cache is None
    replays = entry.replays
    again = turn(True, cache)
    assert torch.equal(again[0], tokens) and gen_mod.decode_graphs() == [entry]
    assert entry.replays > replays and cache.k[:, :, :GRAPH_S].abs().sum() > 0
    held = torch.cuda.memory_allocated()
    del cache, again
    gc.collect()
    assert gen_mod.decode_graphs() == []
    assert torch.cuda.memory_allocated() < held - 2 * GRAPH_CFG.num_layers * 512 * 32 * 128 * 2


# ------------------------------------------- the speculative loop's CUDA graph
#
# generate_tokens_spec on the card replays one verify iteration (prompt
# lookup, a block of k + 1 queries through K2m, acceptance) from a CUDA
# graph; the same 2-layer decoders at LLaMA-7B width against the eager loop.


def _spec(params, prompt, graphed, *, k, max_new=11, oracle=None, keep=None, generator=None,
          temperature=0.0, do_sample=False, stop=None, adapter_route=None):
    """(tokens, n_gen, steps, accepted, the last carried logits) of a
    speculative request; the history repeats 4 ids, and `oracle` (True)
    makes the target echo them, so drafts are accepted."""
    embeds, lens, mask, pos = prompt
    b = embeds.shape[0]
    cycle = np.array([11, 12, 13, 14], np.int32)
    pids = np.tile(cycle, (b, GRAPH_S // 4))
    if oracle:
        oracle = np.tile(cycle, (b, -(-max_new // 4)))[:, :max_new]
    out = gen_mod._generate_tokens_spec(
        params, GRAPH_CFG, embeds, lens, mask, pos, pids, lens.cpu().numpy(),
        stop or _never_stop(), generator or torch.Generator(device="cuda").manual_seed(0),
        max_new_tokens=max_new, cache_len=GRAPH_S + max_new + k + 1, spec_k=k,
        temperature=temperature, do_sample=do_sample, top_p=1.0, pad_id=0,
        draft_keep_prob=keep, oracle_ids=oracle if oracle is not None else None,
        graphed=graphed, adapter_route=adapter_route)
    return (*out[:4], out[4].logits.clone())


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("b", [1, 4])
def test_spec_graph_equals_the_eager_loop(decoders, b, k):
    """Greedy, with and without the oracle (drafts accepted), on int8 and
    int4: the graph's tokens, n_gen, steps and accepted are the eager
    loop's; a second request replays the first's graph bit for bit (tokens,
    counters, the carried logits); K2m runs in the graph, once a layer
    (int4 at M = B (k + 1) > 8 runs K3's M > 8 kernel there too)."""
    for quant in ("int8", "int4"):
        params, prompt = decoders[quant], _graph_prompt(b)
        for oracle in (False, True):
            gen_mod.clear_decode_graphs()
            want = _spec(params, prompt, False, k=k, oracle=oracle)
            first = _spec(params, prompt, True, k=k, oracle=oracle)
            (entry,) = gen_mod.decode_graphs()
            again = _spec(params, prompt, True, k=k, oracle=oracle)
            for w, g in zip(want[:4], first[:4]):
                assert torch.equal(w, g), (quant, oracle)
            for f, a in zip(first, again):
                assert torch.equal(f, a), (quant, oracle)
            assert entry.launches[dec_mod.LAUNCHES_MULTI] == GRAPH_CFG.num_layers
            assert dec_mod.LAUNCHES not in entry.launches  # no single-query step in it
            if oracle:
                assert int(want[3]) > 0 and int(want[2]) < 11
            if quant == "int4" and b * (k + 1) > int4_mod.SMALL_M:
                assert entry.launches[int4_mod.LAUNCHES_STACKED] > \
                    entry.launches.get(int4_mod.LAUNCHES_STACKED_SMALL_M, 0)
    gen_mod.clear_decode_graphs()


def test_spec_graph_counts_k2m_per_iteration(decoders):
    """K2m's count over a graphed request is num_layers a verify iteration
    run (warm-up and replays), as the eager loop's over the same iterations."""
    params, prompt = decoders["int8"], _graph_prompt(1)
    gen_mod.clear_decode_graphs()
    counts = []
    for graphed in (False, True):
        dec_mod.LAUNCHES_MULTI.reset()
        out = _spec(params, prompt, graphed, k=4)
        counts.append(dec_mod.LAUNCHES_MULTI.count)
    (entry,) = gen_mod.decode_graphs()
    iterations = entry.replays + 1  # the warm-up ran the first
    assert counts[0] == counts[1] == GRAPH_CFG.num_layers * iterations
    assert int(out[2]) <= iterations < int(out[2]) + gen_mod.SPEC_CHUNK
    gen_mod.clear_decode_graphs()


def test_spec_graph_samples_and_corruption_follow_the_generator(decoders):
    """A sampled request (temperature 0.8) and a greedy one with drafts
    corrupted (keep 0.5): from the same generator state the graph gives the
    eager loop's tokens and counters; another seed other samples; the keep
    rate is the state's scalar, so 0.5 and 0.25 share one graph."""
    params, prompt = decoders["int4"], _graph_prompt(4)
    gen_mod.clear_decode_graphs()

    def run(graphed, seed, **kw):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return _spec(params, prompt, graphed, k=4, generator=gen, **kw)

    sampled = dict(temperature=0.8, do_sample=True)
    want, got = run(False, 1, **sampled), run(True, 1, **sampled)
    for w, g in zip(want[:4], got[:4]):
        assert torch.equal(w, g)
    assert not torch.equal(run(True, 2, **sampled)[0], got[0])
    want, got = run(False, 3, keep=0.5, oracle=True), run(True, 3, keep=0.5, oracle=True)
    for w, g in zip(want[:4], got[:4]):
        assert torch.equal(w, g)
    entries = len(gen_mod.decode_graphs())
    run(True, 3, keep=0.25, oracle=True)
    assert len(gen_mod.decode_graphs()) == entries
    assert all(e.generator is not None for e in gen_mod.decode_graphs())
    gen_mod.clear_decode_graphs()


def test_a_failed_spec_capture_raises(decoders, monkeypatch):
    params, prompt = decoders["int8"], _graph_prompt(1)
    gen_mod.clear_decode_graphs()
    hit = gen_mod._keyword_hit

    def reads_back(window, keyword_ids, keyword_lens):
        out = hit(window, keyword_ids, keyword_lens)
        out.any().item()
        return out

    monkeypatch.setattr(gen_mod, "_keyword_hit", reads_back)
    with pytest.raises(RuntimeError):
        _spec(params, prompt, True, k=4)
    monkeypatch.undo()
    assert gen_mod.decode_graphs()[0].graph is None
    gen_mod.clear_decode_graphs()


def test_session_spec_turn_is_bit_equal_twice(decoders):
    """decode_with_cache_spec over a caller's cache: the eager loop's
    tokens and counters; the same turn again (a fresh prefill into the same
    cache) replays the same graph and gives the same tokens, counters and
    committed cache bits; the entry goes with the cache."""
    params = decoders["int8"]
    embeds, lens, mask, pos = _graph_prompt(1)
    pids = np.tile(np.array([11, 12, 13, 14], np.int32), (1, GRAPH_S // 4))
    gen_mod.clear_decode_graphs()
    cache = llama_mod.init_cache(GRAPH_CFG, 1, 512, device="cuda")

    def turn(graphed):
        logits, _ = gen_mod.prefill_full(params, GRAPH_CFG, cache, embeds, lens, mask, pos)
        gen = torch.Generator(device="cuda")
        if graphed:
            return gen_mod.decode_with_cache_spec(params, GRAPH_CFG, cache, logits, lens, pids,
                                                  lens.cpu().numpy(), _never_stop(), gen,
                                                  max_new_tokens=11, spec_k=4)[:4]
        st = gen_mod.SpecState.new(cache, GRAPH_CFG.vocab_size, 11, (1, 1), GRAPH_S + 11)
        st.reset(lens, logits, pids, lens.cpu().numpy(), _never_stop(), 0)
        return tuple(t.clone() for t in gen_mod._run_spec_decode_loop(
            params, GRAPH_CFG, st, gen, None, max_new_tokens=11, spec_k=4, temperature=0.0,
            do_sample=False, top_p=1.0, pad_id=0, emb_dtype=torch.bfloat16))

    want = turn(False)
    first = turn(True)
    n = GRAPH_S + int(first[1][0]) - 1
    kept = cache.k[:, :, :n].clone(), cache.v[:, :, :n].clone()
    second = turn(True)
    (entry,) = gen_mod.decode_graphs()
    assert entry.graph is not None and entry.state.cache is None
    for w, f, s in zip(want, first, second):
        assert torch.equal(w, f) and torch.equal(f, s)
    assert torch.equal(kept[0], cache.k[:, :, :n]) and torch.equal(kept[1], cache.v[:, :, :n])
    del cache
    gc.collect()
    assert gen_mod.decode_graphs() == []


# -------------------------------------------------- the serving engine's graph
# (serve/engine.py): one decode step over all request rows of a cache with
# pool rows after them, replayed `chunk` times a chunk from a CUDA graph the
# engine owns, on the 2-layer decoder at 7B width above.


def _engine(params, max_slots, max_len=256, chunk=8):
    from teochat_torch.models.teochat import TEOChat
    from teochat_torch.serve.engine import BatchEngine

    model = TEOChat(dataclasses.replace(TEOChatConfig(), llm=GRAPH_CFG), {"llm": params})
    return BatchEngine(model, max_slots=max_slots, max_len=max_len, chunk=chunk,
                       prefix_cache_slots=1)


def _engine_state(engine):
    st = engine._state
    return ({n: getattr(st, n).clone() for n in ("last_tokens", "positions", "active",
                                                 "hist", "hist_len", "tokens", "col")},
            engine.cache.k.clone(), engine.cache.v.clone())


def _set_engine_state(engine, saved):
    fields, k, v = saved
    for n, t in fields.items():
        getattr(engine._state, n).copy_(t)
    engine.cache.k.copy_(k)
    engine.cache.v.copy_(v)


@pytest.mark.parametrize("max_slots", [1, 8])
def test_engine_graph_replays_bit_equal_its_eager_step(decoders, max_slots):
    """From the same state (greedy rows prefilled through the engine's own
    admission, the last row of 8 left empty), a chunk of 8 steps replayed
    from the engine's graph (its first: the warm-up step, the capture and 7
    replays; its second: 8 replays) gives the eager chunk's tokens, cache
    and state bit for bit; shutdown releases the graph."""
    from teochat_torch.config import GenerationConfig
    from teochat_torch.serve import engine as engine_mod

    engine = _engine(decoders["int8"], max_slots)
    gen = GenerationConfig(max_new_tokens=64, temperature=0.0, do_sample=False, stop_strings=())
    for slot in range(max(1, max_slots - 1)):
        req = engine._make_request([1] + list(range(30 + 5 * slot, 50 + 9 * slot)), None, gen)
        engine._slots[slot] = req
        engine._prefill(req, slot)
    engine._resolve_pending_first()
    before = _engine_state(engine)
    kw = dict(chunk=engine.chunk, **engine._step_kw())
    llm, cfg = engine.model.params["llm"], GRAPH_CFG
    want = engine_mod._decode_chunk(llm, cfg, engine._state, **kw).clone()
    want_state = _engine_state(engine)
    graph = engine._decode_graph()
    for _ in range(2):
        _set_engine_state(engine, before)
        got = engine_mod._decode_chunk(llm, cfg, engine._state, graph=graph, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        got_state = _engine_state(engine)
        for n, t in want_state[0].items():
            assert torch.equal(got_state[0][n], t), n
        assert torch.equal(got_state[1], want_state[1]) and torch.equal(got_state[2],
                                                                         want_state[2])
    assert graph.graph is not None and graph.replays == 15
    engine.shutdown()
    assert engine._graph is None and graph.graph is None


def test_decode_kernel_reads_a_row_slice_of_a_wider_cache(gen):
    """K2 on rows [0, 3) of a 5-row layer slab (a view, as the engine's
    decode step reads the request rows before the pool rows) gives the bits
    of K2 on a contiguous copy of those rows."""
    k_all = _randn((2, 5, 300, 8, 128), gen)
    v_all = _randn((2, 5, 300, 8, 128), gen)
    k, v = k_all[1, 0:3].transpose(1, 2), v_all[1, 0:3].transpose(1, 2)
    q = _randn((3, 32, 128), gen)
    lens = torch.tensor([1, 200, 300], dtype=torch.int32, device="cuda")
    got = dec_mod.decode_attention(q, k, v, lens)
    want = dec_mod.decode_attention(q, k.contiguous(), v.contiguous(), lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_decode_multi_kernel_at_a_row_offset(gen):
    """K2m on row 1 of a 3-row cache (a 1-row view at an offset, as the
    engine's chunked prefill reads a request's row) gives the bits of the
    same call on that row alone."""
    k_all = _randn((3, 1024, 32, 128), gen)
    v_all = _randn((3, 1024, 32, 128), gen)
    k, v = k_all[1:2].transpose(1, 2), v_all[1:2].transpose(1, 2)
    q = _randn((1, 256, 32, 128), gen)
    lens = (torch.arange(256, 512, device="cuda", dtype=torch.int32) + 1)[None]
    got = dec_mod.decode_attention_multi(q, k, v, lens)
    want = dec_mod.decode_attention_multi(q, k_all[1:2].clone().transpose(1, 2),
                                          v_all[1:2].clone().transpose(1, 2), lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ref = dec_mod.decode_attention_multi_plain(q.float(), k.float(), v.float(), lens)
    assert (got.float() - ref).abs().max().item() <= TOL


# ------------------------------------------------------- the fp8 (e4m3) cache

E4M3 = torch.float8_e4m3fn


def _e4m3_slab(shape, gen):
    """The layer slab of a [L, B, T, Hkv, D] e4m3 cache, read in place as
    [B, Hkv, T, D], and its exact bf16 upcast (the same strides)."""
    slab = (_randn((2, *shape), gen).float() * 2).to(E4M3)[1].transpose(1, 2)
    return slab, slab.to(torch.bfloat16)


@pytest.mark.parametrize(
    "b,h,hkv,t,d,lengths",
    [
        (1, 32, 32, 801, 128, [580]),  # the 2-frame request's last step
        (3, 8, 8, 801, 128, [801, 1, 0]),
        (6, 32, 8, 200, 128, [1, 63, 64, 65, 200, 0]),  # the split's edges, GQA 4:1
        (2, 32, 2, 90, 128, [90, 33]),  # GQA 16:1
        (6, 16, 16, 256, 64, [1, 63, 64, 65, 256, 0]),  # head_dim 64
        (8, 32, 32, 1025, 128, [1025, 1, 517, 1024, 64, 300, 1000, 2]),
    ],
)
def test_decode_e4m3_kernel_is_the_bf16_kernel_on_the_upcast_slab(gen, b, h, hkv, t, d,
                                                                   lengths):
    """K2 on an e4m3 slab converts each element exactly and sums in the bf16
    kernel's order: the bits of K2 on the slab upcast to bf16, within TOL of
    the plain version, counted on its own counter."""
    k8, kb = _e4m3_slab((b, t, hkv, d), gen)
    v8, vb = _e4m3_slab((b, t, hkv, d), gen)
    q = _randn((b, h, d), gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = (dec_mod.LAUNCHES_E4M3.count, dec_mod.LAUNCHES.count)
    got = dec_mod.decode_attention(q, k8, v8, lens)
    torch.cuda.synchronize()
    assert (dec_mod.LAUNCHES_E4M3.count, dec_mod.LAUNCHES.count) == (before[0] + 1, before[1])
    assert torch.equal(got, dec_mod.decode_attention(q, kb, vb, lens))
    live = lens > 0
    want = dec_mod.decode_attention_plain(q.float(), k8, v8, lens)
    assert (got.float() - want)[live].abs().max().item() <= TOL
    assert got[~live].abs().sum().item() == 0.0


@pytest.mark.parametrize(
    "b,s,h,hkv,t,d,starts,live",
    [
        (1, 9, 32, 32, 801, 128, [700], [9]),
        (1, 128, 32, 32, 1025, 128, [700], [100]),
        (6, 9, 32, 32, 300, 128, [0, 1, 31, 32, 33, 200], [9, 9, 9, 9, 5, 9]),  # chunk edges
        (2, 40, 32, 8, 200, 128, [63, 0], [40, 0]),  # GQA 4:1; row 1 has no live slot
        (2, 33, 16, 4, 257, 64, [64, 65], [33, 20]),  # head_dim 64
        (1, 5, 32, 32, 4096, 128, [3995], [5]),  # a verify block: slots split across blocks
        (1, 1024, 32, 32, 4096, 128, [100], [870]),  # 64-row tiles
        (1, 3, 16, 4, 2048, 64, [2040], [3]),  # head_dim 64, split 8 ways
    ],
)
def test_decode_multi_e4m3_kernel_is_the_bf16_kernel_on_the_upcast_slab(
        gen, b, s, h, hkv, t, d, starts, live):
    """K2m on an e4m3 slab (its ring holds the e4m3 chunks, each converted
    into the bf16 tile the products read): the bits of K2m on the slab
    upcast to bf16, each live (query, head) row within K2M_REL_MAX of its
    largest |o| against the plain version and K2M_WALK_REL_MAX against the
    walk, bit-equal twice, counted on its own counter."""
    k8, kb = _e4m3_slab((b, t, hkv, d), gen)
    v8, vb = _e4m3_slab((b, t, hkv, d), gen)
    q = _randn((b, s, h, d), gen)
    lens = _suffix_lengths(b, s, t, starts, live)
    before = (dec_mod.LAUNCHES_MULTI_E4M3.count, dec_mod.LAUNCHES_MULTI.count)
    got = dec_mod.decode_attention_multi(q, k8, v8, lens)
    again = dec_mod.decode_attention_multi(q, k8, v8, lens)
    torch.cuda.synchronize()
    assert (dec_mod.LAUNCHES_MULTI_E4M3.count, dec_mod.LAUNCHES_MULTI.count) == \
        (before[0] + 2, before[1])
    assert torch.equal(got, again)
    assert torch.equal(got, dec_mod.decode_attention_multi(q, kb, vb, lens))
    alive = lens > 0
    want = dec_mod.decode_attention_multi_plain(q.float(), k8, v8, lens)
    walk = dec_mod.decode_attention_multi_schedule(q.float(), k8, v8, lens,
                                                   sms=_build.sm_count(q.device))
    assert (got.float() - want)[alive].abs().max().item() <= TOL
    for ref, bound in ((want, K2M_REL_MAX), (walk, K2M_WALK_REL_MAX)):
        err = (got.float() - ref).abs().amax(-1)[alive]
        assert (err / ref.abs().amax(-1)[alive]).max().item() <= bound
    assert got[~alive].abs().sum().item() == 0.0


def test_decode_kernels_refuse_a_cache_they_do_not_read(gen):
    """A float16 slab, or K and V of two dtypes, raise on the card: no
    fallback to the plain version."""
    q = _randn((1, 8, 128), gen)
    kb = _randn((1, 8, 64, 128), gen)
    lens = torch.tensor([10], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bfloat16 or float8_e4m3fn"):
        dec_mod.decode_attention(q, kb.half(), kb.half(), lens)
    with pytest.raises(ValueError, match="differ"):
        dec_mod.decode_attention(q, kb, kb.to(E4M3), lens)
    with pytest.raises(ValueError, match="differ"):
        dec_mod.decode_attention_multi(q[:, None], kb.to(E4M3), kb, lens[:, None])
    # e4m3 rows 136 bytes apart: K2m's 16-byte copies would be misaligned
    rows = torch.zeros((1, 8, 64, 136), dtype=torch.uint8, device="cuda").view(E4M3)[..., 8:]
    with pytest.raises(ValueError, match="strides"):
        dec_mod.decode_attention(q, rows, rows, lens)


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_decode_graph_over_an_e4m3_cache_is_bit_equal(decoders, quant, b):
    """generate_tokens(kv_dtype=e4m3) on the 2-layer 7B-width decoder: the
    replayed graph's tokens and n_gen are the eager loop's, two requests
    on the entry give the same tokens, logits and cache bytes, the entry's
    cache is e4m3 (a bf16 request takes an entry of its own), and the
    decode steps launched K2's e4m3 form only."""
    params, prompt = decoders[quant], _graph_prompt(b)
    gen_mod.clear_decode_graphs()
    dec_mod.LAUNCHES.reset()
    dec_mod.LAUNCHES_E4M3.reset()
    want = _decode(params, prompt, False, max_new=21, kv_dtype=E4M3)
    states = []
    first = _decode(params, prompt, True, max_new=21, kv_dtype=E4M3, state_out=states)
    k_bytes = states[0].cache.k.view(torch.uint8).clone()
    second = _decode(params, prompt, True, max_new=21, kv_dtype=E4M3, state_out=states)
    torch.cuda.synchronize()
    assert states[1].cache.dtype == E4M3 and states[1] is states[0]
    assert torch.equal(first[0], want[0]) and torch.equal(first[1], want[1])
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert torch.equal(k_bytes, states[1].cache.k.view(torch.uint8))
    assert dec_mod.LAUNCHES.count == 0 and dec_mod.LAUNCHES_E4M3.count > 0
    bf16 = _decode(params, prompt, True, max_new=21)
    assert len(gen_mod.decode_graphs()) == 2
    assert torch.equal(bf16[0][:, 0], first[0][:, 0])  # the prefill attends fresh bf16 K/V
    gen_mod.clear_decode_graphs()


# --------------------------------------------------------------- multi-LoRA
#
# Two rank-16 peft adapters attached over the 2-layer 7B-width decoders (the
# int4 one's fused q|k|v and gate|up take the block-composed form) and
# stacked: a one-hot route row must give the single-adapter model's bits and
# a -1 row the base model's, at the same batch shape, plain, graphed and
# speculative; one graph entry serves any adapter list of its width.

LORA_RANK = 16


def _peft_sd(seed):
    """A peft adapter state dict at GRAPH_CFG's widths, A and B drawn from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    d, i_sz = GRAPH_CFG.hidden_size, GRAPH_CFG.intermediate_size
    kv = GRAPH_CFG.num_kv_heads * GRAPH_CFG.head_dim
    widths = {"self_attn.q_proj": (d, d), "self_attn.k_proj": (d, kv),
              "self_attn.v_proj": (d, kv), "self_attn.o_proj": (d, d),
              "mlp.gate_proj": (d, i_sz), "mlp.up_proj": (d, i_sz), "mlp.down_proj": (i_sz, d)}
    sd = {}
    for layer in range(GRAPH_CFG.num_layers):
        for mod, (fan_in, fan_out) in widths.items():
            pre = f"base_model.model.model.layers.{layer}.{mod}"
            sd[f"{pre}.lora_A.weight"] = torch.randn(LORA_RANK, fan_in, generator=gen) * 0.02
            sd[f"{pre}.lora_B.weight"] = torch.randn(fan_out, LORA_RANK, generator=gen) * 0.02
    return sd


@pytest.fixture(scope="module")
def lora_decoders(decoders):
    """{quant: (base, [single-adapter trees], the stacked tree)}."""
    from teochat_torch.checkpoint.convert_hf import attach_lora_to_llama
    from teochat_torch.train.lora import stack_lora_adapters

    out = {}
    for quant, base in decoders.items():
        singles = [attach_lora_to_llama(base, _peft_sd(40 + i), GRAPH_CFG, alpha=32.0)
                   for i in range(2)]
        out[quant] = (base, singles, stack_lora_adapters(singles))
    return out


def _route(ids):
    from teochat_torch.train.lora import adapter_route

    return adapter_route(torch.tensor(ids, device="cuda"), 2)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_multi_lora_rows_are_bit_equal_to_their_models(lora_decoders, quant):
    """A ragged batch of 4 routed [0, 1, -1, 1]: the prefill's last logits
    and the eager and graphed greedy tokens of each row are BITWISE those of
    its single-adapter model (or the base model) on the same batch; the
    graph's tokens are the eager loop's, and the adapters move the tokens."""
    base, singles, multi = lora_decoders[quant]
    prompt = _graph_prompt(4)
    ids = [0, 1, -1, 1]
    models = {0: singles[0], 1: singles[1], -1: base}
    gen_mod.clear_decode_graphs()
    for graphed in (False, True):
        got = _decode(multi, prompt, graphed, adapter_route=_route(ids))
        for row, a in enumerate(ids):
            want = _decode(models[a], prompt, graphed)
            assert torch.equal(got[0][row], want[0][row]), (graphed, row, a)
        if graphed:
            assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])
        eager = got
    assert not torch.equal(got[0][2], _decode(singles[0], prompt, False)[0][2])
    embeds, lens, mask, pos = prompt
    cache = llama_mod.init_cache(GRAPH_CFG, 4, 128, device="cuda")
    logits, _ = gen_mod.prefill_full(multi, GRAPH_CFG, cache, embeds, lens, mask, pos,
                                     adapter_route=_route(ids))
    for row, a in enumerate(ids):
        cache = llama_mod.init_cache(GRAPH_CFG, 4, 128, device="cuda")
        want, _ = gen_mod.prefill_full(models[a], GRAPH_CFG, cache, embeds, lens, mask, pos)
        assert torch.equal(logits[row], want[row]), (row, a)
    gen_mod.clear_decode_graphs()


def test_multi_lora_one_entry_serves_two_adapter_lists(lora_decoders):
    """Two requests with other adapter lists ([0, 1, -1, 0], then
    [1, -1, 0, 1]) replay one graph entry (the route is a state buffer
    written before the replay): each gives its own eager run's tokens."""
    _, _, multi = lora_decoders["int8"]
    prompt = _graph_prompt(4)
    gen_mod.clear_decode_graphs()
    lists = ([0, 1, -1, 0], [1, -1, 0, 1])
    eager = [_decode(multi, prompt, False, adapter_route=_route(ids)) for ids in lists]
    assert not torch.equal(eager[0][0], eager[1][0])
    for ids, want in zip(lists * 2, eager * 2):
        got = _decode(multi, prompt, True, adapter_route=_route(ids))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), ids
    (entry,) = gen_mod.decode_graphs()
    assert entry.replays == 9 + 3 * 10  # 10 iterations a request; the first request's first ran eagerly
    gen_mod.clear_decode_graphs()


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_multi_lora_spec_graph_equals_eager_and_the_single_models(lora_decoders, quant):
    """Speculative (k 4, the oracle accepting drafts) over the stacked tree
    routed [1, -1, 0, 1]: the graph's tokens, steps and accepted are the
    eager loop's, and each row's tokens its own model's on the same batch."""
    base, singles, multi = lora_decoders[quant]
    prompt = _graph_prompt(4)
    ids = [1, -1, 0, 1]
    models = {0: singles[0], 1: singles[1], -1: base}
    gen_mod.clear_decode_graphs()
    want = _spec(multi, prompt, False, k=4, adapter_route=_route(ids))
    got = _spec(multi, prompt, True, k=4, adapter_route=_route(ids))
    for w, g in zip(want[:4], got[:4]):
        assert torch.equal(w, g)
    for row, a in enumerate(ids):
        assert torch.equal(got[0][row], _spec(models[a], prompt, True, k=4)[0][row]), (row, a)
    gen_mod.clear_decode_graphs()


# ------------------------------------------------------------- w8a8 (_int_mm)

@pytest.mark.parametrize("m", [1, 5, 16, 17, 64, 640])
def test_w8a8_int_mm_pads_rows_exactly(gen, m):
    """`int8_matmul` on the card: torch._int_mm takes more than 16 rows, so
    fewer are padded with zero rows and sliced off. The int32 sums equal the
    exact product (fp64 on the card: |sum| < 2^27, exact there) at the
    projection shapes of the 7B prefill and the tower, with b row-major (the
    decoder's leaves) and `k_major` (the tower's), and a w8a8 projection
    gives the CPU's bits."""
    for k, n in ((4096, 1024), (1024, 4096), (4096, 12288)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        for w in (b, quant_mod.k_major(b)):
            got = quant_mod.int8_matmul(a, w)
            assert got.dtype == torch.int32 and got.shape == (m, n)
            assert torch.equal(got.double(), a.double() @ b.double())
    x = torch.randn(m, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    p = quant_mod.quantize_kernel(torch.randn(1024, 1024, generator=gen, device="cuda") * 0.02)
    got = quant_mod.quantized_proj_act_i8(x, p)
    want = quant_mod.quantized_proj_act_i8(x.cpu(), {k: v.cpu() for k, v in p.items()})
    assert torch.equal(got.cpu(), want)


def test_w8a8_prefill_leaves_the_decode_graph_w8a16(decoders):
    """With `int8_prefill_activations` the prefill takes one w8a8 product a
    projection and the replayed decode steps none (a capture would record
    it as a launch); the graph's tokens are the eager loop's."""
    cfg = dataclasses.replace(GRAPH_CFG, int8_prefill_activations=True)
    params, (embeds, lens, mask, pos) = decoders["int8"], _graph_prompt(4)
    gen_mod.clear_decode_graphs()
    out = []
    for graphed in (False, True, True):
        quant_mod.ACT_I8_PRODUCTS.reset()
        tokens, n_gen, _ = gen_mod._generate_tokens(
            params, cfg, embeds, lens, mask, pos, _never_stop(),
            torch.Generator(device="cuda").manual_seed(0), max_new_tokens=11,
            cache_len=GRAPH_S + 12, temperature=0.0, do_sample=False, top_p=1.0, pad_id=0,
            graphed=graphed)
        out.append((tokens.cpu(), n_gen.cpu(), quant_mod.ACT_I8_PRODUCTS.count))
    for tokens, n_gen, count in out:
        assert torch.equal(tokens, out[0][0]) and torch.equal(n_gen, out[0][1])
        assert count == 7 * cfg.num_layers
    gen_mod.clear_decode_graphs()



# ------------------------------------------- the MPT backend: K1 / K4a with bias_k


def _alibi(h, s, t_cache=4096):
    """MPT-7B's table for a `t_cache`-slot cache (32 heads), its first H
    heads and S keys: a row-strided view, as mpt_forward slices it."""
    return mpt_mod.alibi_bias(32, t_cache, device="cuda")[0, :h, 0, :s]


@pytest.mark.parametrize("b,s,h,hkv,d", [
    (1, 768, 32, 32, 128),  # MPT-7B's 2-frame prefill
    (1, 768, 32, 1, 128),  # multiquery: one kv head, 32 slopes
    (2, 700, 8, 8, 128),  # ragged S
    (1, 300, 4, 4, 64),  # head_dim 64, ragged
    (2, 40, 4, 1, 64),  # S below one warpgroup's 64 rows
])
def test_flash_bias_kernel_matches_plain(gen, b, s, h, hkv, d):
    """K1's bias branch against the plain twin with the same table (TOL, as
    the bias-free kernel); counted on LAUNCHES_BIAS alone; a contiguous copy
    of the table gives the same bits as the strided view."""
    q, k, v = _randn((b, s, h, d), gen), _randn((b, s, hkv, d), gen), _randn((b, s, hkv, d), gen)
    bias = _alibi(h, s)
    before, plain_before = flash_mod.LAUNCHES_BIAS.count, flash_mod.LAUNCHES.count
    got = flash_mod.flash_attention(q, k, v, bias_k=bias)
    torch.cuda.synchronize()
    assert flash_mod.LAUNCHES_BIAS.count == before + 1
    assert flash_mod.LAUNCHES.count == plain_before
    want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), bias_k=bias)
    assert torch.isfinite(got).all() and (got.float() - want).abs().max().item() <= TOL
    same = flash_mod.flash_attention(q, k, v, bias_k=bias.contiguous())
    torch.testing.assert_close(got, same, rtol=0, atol=0)


def test_flash_bias_statistics_match_plain_and_the_backward_raises(gen):
    """K4a's bias branch: o, m and l against the plain twin's on the biased
    scores; the trainable path runs it forward and refuses the backward."""
    b, s, h, d = 2, 333, 4, 128
    q, k, v = _randn((b, s, h, d), gen), _randn((b, s, 1, d), gen), _randn((b, s, 1, d), gen)
    bias = _alibi(h, s)
    o, m, l = flash_mod._fwd_res_cuda(q, k, v, True, d ** -0.5, bias)
    torch.cuda.synchronize()
    want_m, want_l = flash_mod.flash_statistics_plain(q.float(), k.float(), v.float(),
                                                      bias_k=bias)
    torch.testing.assert_close(m, want_m, rtol=0, atol=BIAS_STAT_M_ATOL)
    torch.testing.assert_close(l, want_l, rtol=STAT_L_RTOL, atol=0)
    want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), bias_k=bias)
    assert (o.float() - want).abs().max().item() <= TOL
    qg = q.clone().requires_grad_()
    out = flash_mod.flash_attention_trainable_padded(qg, k, v, True, bias_k=bias)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        out.float().sum().backward()


@pytest.fixture(scope="module")
def mpt_decoder():
    """A 2-layer MPT at MPT-7B's width (d 4096, 32 heads, vocab 50,432), int8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from teochat_torch.config import MptConfig

    cfg = MptConfig(vocab_size=50432, n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, bridge.init_mpt(cfg, gen, "cuda", torch.bfloat16, quant="int8")


@pytest.mark.parametrize("b", [1, 4])
def test_mpt_decode_graph_is_bit_equal_to_the_eager_loop(mpt_decoder, b):
    """The MPT decode step (plain masked attention with the ALiBi table, the
    slot mask built on the device) replayed from a CUDA graph: the eager
    loop's tokens, n_gen and last logits bit for bit, twice; the prefill
    launches K1's bias branch once a layer and the steps no attention kernel."""
    cfg, params = mpt_decoder
    embeds, lens, mask, pos = _graph_prompt(b)  # d 4096: MPT-7B's d_model too
    gen_mod.clear_decode_graphs()
    out = []
    for graphed in (False, True, True):
        flash_mod.LAUNCHES_BIAS.reset()
        dec_mod.LAUNCHES.reset()
        tokens, n_gen, state = gen_mod._generate_tokens(
            params, cfg, embeds, lens, mask, pos, _never_stop(),
            torch.Generator(device="cuda").manual_seed(0), max_new_tokens=11,
            cache_len=GRAPH_S + 12, temperature=0.0, do_sample=False, top_p=1.0, pad_id=0,
            graphed=graphed)
        assert flash_mod.LAUNCHES_BIAS.count == cfg.n_layers and dec_mod.LAUNCHES.count == 0
        out.append((tokens.clone(), n_gen.clone(), state.logits.clone()))
    assert len(gen_mod.decode_graphs()) == 1
    for got in out[1:]:
        for a, w in zip(got, out[0]):
            assert torch.equal(a, w)
    gen_mod.clear_decode_graphs()
