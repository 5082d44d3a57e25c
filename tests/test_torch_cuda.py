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
"""

import pytest
import torch

from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.ops import flash_attention as flash_mod
from teochat_torch.ops.attention import dot_product_attention

TOL = 2e-2
GRAD_REL_L2 = 1e-2
GRAD_REL_MAX = 2e-2

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


@pytest.mark.parametrize(
    "b,h,hkv,t,d,lengths",
    [
        (3, 8, 8, 801, 128, [801, 1, 0]),  # a row with no live slot writes 0
        (2, 32, 8, 300, 128, [300, 129]),  # GQA 4:1
        (2, 8, 1, 70, 128, [5, 70]),  # GQA 8:1
        (2, 4, 2, 50, 64, [50, 17]),  # head_dim 64
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


def test_flash_backward_refuses_what_it_does_not_take(gen):
    q = _randn((1, 64, 2, 96), gen).requires_grad_(True)
    with pytest.raises(ValueError, match="head_dim"):
        flash_mod.flash_attention_trainable(q, q, q)
    x = torch.randn(1, 64, 2, 128, device="cuda", requires_grad=True)  # fp32
    with pytest.raises(ValueError):
        flash_mod.flash_attention_trainable(x, x, x)
    with pytest.raises(ValueError, match="no backward"):  # K1 records no graph
        flash_mod.flash_attention(x.to(torch.bfloat16), x.to(torch.bfloat16), x.to(torch.bfloat16))
