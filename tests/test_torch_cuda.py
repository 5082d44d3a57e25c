"""The port's CUDA kernels against their plain twins, on the card.

Every test here is marked `cuda` and skips where torch sees no CUDA device.
On a machine with a card (which need not have JAX; the suite's conftest
imports it, so skip that file):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are bf16 from a seeded generator; the reference is the plain twin in
fp32 on the same bf16 inputs. Outputs are averages of N(0, 1) values, so
|o| < 4 and bf16 output rounding alone reaches 2^-8 * 4 = 1.6e-2; P is
rounded to bf16 before the PV product, as in the TPU kernels.
"""

import pytest
import torch

from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.ops import flash_attention as flash_mod
from teochat_torch.ops.attention import dot_product_attention

TOL = 2e-2

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
