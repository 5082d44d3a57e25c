"""The Hopper flash backward's schedules against the JAX kernels they replace.

The CUDA kernels (teochat_torch/csrc/flash_attention_bwd.cu: K4b dK/dV and
K4c dQ, with di = rowsum(o * dO) from a preamble kernel) run only on a card.
Their tile walks are written out in plain PyTorch as
`flash_backward_dkv_schedule` and `flash_backward_dq_schedule`: the kernels'
tile sizes, the tiles above the diagonal left out, rows and keys past the
end read as zeros with the keys then masked, the `l == 0` guard, P and dS
rounded to the inputs' type before their products, fp32 sums with the GQA
group's sum inside dK and dV, the scale on the fp32 sum. Here those walks
are held against `teochat_tpu`'s `_bwd_dkv_kernel` and `_bwd_dq_kernel`,
reached through the custom_vjp `flash_attention_trainable` in Pallas
interpret mode on the CPU, and against autograd through the plain attention.

Same fp32 inputs and the same dO from a seeded numpy generator on both
sides; the walks take o, m and l from `flash_forward_schedule`. In fp32 the
two sides differ by summation order only: 1e-4, absolute and relative, as
tests/test_torch_flash_backward.py holds the plain twin.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.ops import flash_attention as jax_flash
from teochat_torch.ops import flash_attention as flash_mod

GRAD_TOL = 1e-4


def _inputs(b, s, t, h, hkv, d, seed, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    shapes = [(b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d)]
    scales = (0.3, 0.3, 1.0, 1.0)  # q, k, v, dO
    return [torch.from_numpy((rs.randn(*shape) * sc).astype(np.float32)).to(dtype)
            for shape, sc in zip(shapes, scales)]


def _schedules(q, k, v, do, causal=True, dkv_tiles=None, dq_tiles=None):
    """(dq, dk, dv) from the two tile walks, on the forward walk's o, m, l."""
    o, m, l = flash_mod.flash_forward_schedule(q, k, v, causal=causal)
    di = flash_mod.flash_di_plain(o, do)
    kw = lambda tiles: {} if tiles is None else dict(block_q=tiles[0], block_k=tiles[1])  # noqa: E731
    dk, dv = flash_mod.flash_backward_dkv_schedule(q, k, v, do, m, l, di, causal=causal,
                                                   **kw(dkv_tiles))
    dq = flash_mod.flash_backward_dq_schedule(q, k, v, do, m, l, di, causal=causal,
                                              **kw(dq_tiles))
    return dq, dk, dv


def _jax_grads(q, k, v, do, padded):
    fn = jax_flash.flash_attention_trainable_padded if padded else jax_flash.flash_attention_trainable
    _, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, True, None, 128, 128, True),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]


def _plain_grads(q, k, v, do, causal):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    flash_mod.flash_attention_plain(q, k, v, causal=causal).backward(do)
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize(
    "b,s,h,hkv,d,padded",
    [
        (1, 384, 2, 2, 64, False),  # causal, 3 x 3 tiles of the JAX kernels: the diagonal skip
        (2, 256, 4, 2, 64, False),  # GQA 2:1, the group's dK/dV sum
        (1, 256, 4, 1, 128, False),  # GQA 4:1, head_dim 128
        (1, 200, 2, 1, 64, True),  # ragged S: the last q and kv tiles part-filled
        (1, 333, 2, 2, 128, True),  # ragged S, head_dim 128
        (1, 128, 2, 2, 128, False),  # one kv tile of K4b, two q steps
    ],
    ids=["causal-multi-tile", "gqa2", "gqa4-d128", "ragged", "ragged-d128", "d128"],
)
def test_schedules_match_jax_kernels(b, s, h, hkv, d, padded):
    q, k, v, do = _inputs(b, s, s, h, hkv, d, seed=s + h + d)
    got = _schedules(q, k, v, do)
    want = _jax_grads(q, k, v, do, padded)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("s,t,h,hkv,d", [(100, 257, 4, 2, 64), (300, 70, 2, 2, 128),
                                         (1, 129, 4, 1, 128), (130, 1, 2, 2, 64)])
def test_schedules_full_attention_over_other_lengths(s, t, h, hkv, d):
    """Non-causal with S != T: every kv tile walks every q tile."""
    q, k, v, do = _inputs(2, s, t, h, hkv, d, seed=s + t)
    got = _schedules(q, k, v, do, causal=False)
    want = _plain_grads(q, k, v, do, causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_schedules_match_autograd_through_the_plain_attention(causal):
    q, k, v, do = _inputs(2, 150, 150, 4, 1, 128, seed=3)
    got = _schedules(q, k, v, do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, _plain_grads(q, k, v, do, causal)):
        torch.testing.assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, msg=name)


@pytest.mark.parametrize("dkv_tiles,dq_tiles", [((64, 64), (64, 64)), ((32, 128), (128, 128)),
                                                ((128, 64), (64, 128)), ((333, 333), (333, 333))])
def test_schedules_give_the_same_answer_at_other_tile_sizes(dkv_tiles, dq_tiles):
    """The tile sizes (block_q, block_k) move only the summation order."""
    q, k, v, do = _inputs(1, 333, 333, 4, 2, 64, seed=5)
    want = _schedules(q, k, v, do)
    got = _schedules(q, k, v, do, dkv_tiles=dkv_tiles, dq_tiles=dq_tiles)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("s,d,causal", [(200, 128, True), (257, 64, True), (96, 128, False)])
def test_schedules_round_p_and_ds_to_bf16(s, d, causal):
    """bf16 inputs, as on the card: P and dS are rounded to bf16 before their
    products (2^-9 relative on each of many terms) and the gradients are
    written in bf16. Against the same walk on the same values in fp32 that
    is a relative L2 of 2.2e-3 to 2.4e-3 as read: above what fp32 summation order
    gives (1e-6), below the 1e-2 the card's smoke holds the kernels to."""
    q, k, v, do = _inputs(1, s, s, 4, 2, d, seed=s, dtype=torch.bfloat16)
    got = _schedules(q, k, v, do, causal=causal)
    want = _schedules(q.float(), k.float(), v.float(), do.float(), causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        rel = ((g.float() - w).norm() / w.norm()).item()
        assert 1e-4 < rel < 1e-2, (name, rel)
    # the rounding happens tile by tile: one tile over everything rounds the same values
    whole = _schedules(q, k, v, do, causal=causal, dkv_tiles=(512, 512), dq_tiles=(512, 512))
    for g, w in zip(got, whole):  # one bf16 step of the largest gradient
        assert (g.float() - w.float()).abs().max() <= 2.0 ** -7 * w.float().abs().max()


def test_a_row_whose_denominator_is_zero_takes_one_over_l_as_one():
    """The `l == 0` guard: 1 / l = 1 there, so the gradients stay finite and
    are what l = 1 gives."""
    q, k, v, do = _inputs(1, 70, 70, 2, 2, 64, seed=11)
    o, m, l = flash_mod.flash_forward_schedule(q, k, v)
    di = flash_mod.flash_di_plain(o, do)
    l0, l1 = l.clone(), l.clone()
    l0[0, 1, 5], l1[0, 1, 5] = 0.0, 1.0
    for fn in (flash_mod.flash_backward_dkv_schedule, flash_mod.flash_backward_dq_schedule):
        got, want = fn(q, k, v, do, m, l0, di), fn(q, k, v, do, m, l1, di)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.isfinite(g).all() and torch.equal(g, w)


def test_di_plain_is_the_row_sum():
    rs = np.random.RandomState(2)
    o, do = (rs.randn(2, 9, 3, 64).astype(np.float32) for _ in range(2))
    got = flash_mod.flash_di_plain(torch.from_numpy(o).bfloat16(), torch.from_numpy(do).bfloat16())
    o16, do16 = (torch.from_numpy(x).bfloat16().float().numpy() for x in (o, do))
    assert got.shape == (2, 3, 9) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), (o16 * do16).sum(-1).transpose(0, 2, 1), rtol=1e-5,
                               atol=1e-5)


def test_module_tile_sizes_are_the_kernels():
    """The sizes the schedules walk are the ones the CUDA source is built
    with, and the source holds the `wgmma` design only."""
    source = (Path(flash_mod._build.CSRC) / "flash_attention_bwd.cu").read_text()
    sizes = {name: int(value) for name, value in re.findall(
        r"(?:constexpr int |#define TEOCHAT_FLASH_BWD_)(DKV_BK|DKV_BQ|DQ_BQ|DQ_BK)(?: =)? (\d+)",
        source)}
    assert sizes == {"DKV_BK": flash_mod.BWD_DKV_BLOCK_K, "DKV_BQ": flash_mod.BWD_DKV_BLOCK_Q,
                     "DQ_BQ": flash_mod.BWD_DQ_BLOCK_Q, "DQ_BK": flash_mod.BWD_DQ_BLOCK_K}
    assert flash_mod.BWD_DKV_BLOCK_K == flash_mod.BWD_DQ_BLOCK_Q == 128  # two warpgroups of 64
    assert "mma_16816" not in source and "wgmma_ss" in source and "wgmma_rs_tb" in source
    assert "tma_load" in source
    # dK and dV are summed in registers: no atomic instruction anywhere
    assert not re.search(r"atomic[A-Z]\w*\s*\(|\bred\.(global|shared)|\batom\.", source)
