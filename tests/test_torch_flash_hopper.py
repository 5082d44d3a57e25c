"""The Hopper flash forward's schedule against the JAX kernels it replaces.

The CUDA kernel (teochat_torch/csrc/flash_attention.cu: K1 and, with its
statistics, K4a) runs only on a card. Its schedule is written out in plain
PyTorch as `flash_forward_schedule`: query tiles and kv tiles of the kernel's
sizes, the kv tiles above a query tile's diagonal left out, rows and keys
past the end read as zeros with the keys then masked, scores in base-2
units, P rounded to the inputs' type before P V, the `l == 0` guard. Here
that walk is held against `teochat_tpu`'s `_flash_kernel` and
`_flash_fwd_res_kernel`, run in Pallas interpret mode on the CPU.

Same inputs from a seeded numpy generator on both sides. In fp32 the two
differ by summation order and by exp2(x log2 e) against exp(x): o, m and l
to 1e-4 relative (o and m with 1e-5 absolute beside it, for values near 0).
The JAX kernels do not mask a ragged last tile, so a causal S above one
tile is padded to their 128-row tile with zeros (padded keys sit after every
real query) and sliced back, as the JAX package's own padded wrapper does;
a non-causal call runs them as one tile of S rows. Their m and l come back
padded to 128 lanes: lane 0 is read.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from teochat_tpu.ops import flash_attention as jax_flash
from teochat_torch.ops import flash_attention as flash_mod

RTOL, ATOL = 1e-4, 1e-5


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_forward(q, k, v, causal, dtype=jnp.float32):
    """(o [B,S,H,D], m, l [B,H,S]) from the JAX residual kernel, and o from
    the inference kernel, both in interpret mode."""
    s, t = q.shape[1], k.shape[1]
    block = 128 if causal and s > 128 else max(s, t)
    pad = -s % block if causal else 0
    qp, kp, vp = (jnp.asarray(np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))), dtype)
                  for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    o1 = jax_flash.flash_attention(qp, kp, vp, causal=causal, block_q=block, block_k=block,
                                   interpret=True)
    o2, m, l = jax_flash._flash_fwd_with_residuals(
        qp.transpose(0, 2, 1, 3), kp.transpose(0, 2, 1, 3), vp.transpose(0, 2, 1, 3),
        causal=causal, scale=scale, block_q=min(block, s + pad), block_k=min(block, t + pad),
        interpret=True)
    as_np = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    return (as_np(o1)[:, :s], as_np(o2.transpose(0, 2, 1, 3))[:, :s],
            as_np(m)[:, :, :s, 0], as_np(l)[:, :, :s, 0])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [9, 64, 200, 257])
@pytest.mark.parametrize("d,h,hkv", [(64, 4, 2), (128, 2, 2), (128, 4, 1)],
                         ids=["d64-gqa2", "d128", "d128-gqa4"])
def test_schedule_matches_jax_kernels(d, h, hkv, s, causal):
    b = 2
    q, k, v = _rand((b, s, h, d), s + d), _rand((b, s, hkv, d), s + d + 1), _rand((b, s, hkv, d), s + d + 2)
    o_k1, o_k4a, want_m, want_l = _jax_forward(q, k, v, causal)
    o, m, l = flash_mod.flash_forward_schedule(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    assert o.shape == (b, s, h, d) and m.shape == l.shape == (b, h, s)
    np.testing.assert_allclose(o.numpy(), o_k1, rtol=RTOL, atol=ATOL)  # _flash_kernel
    np.testing.assert_allclose(o.numpy(), o_k4a, rtol=RTOL, atol=ATOL)  # _flash_fwd_res_kernel
    np.testing.assert_allclose(m.numpy(), want_m, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=RTOL, atol=0)


@pytest.mark.parametrize("s,t,d", [(100, 257, 64), (300, 70, 128), (1, 129, 128)])
def test_schedule_full_attention_over_other_lengths(s, t, d):
    """Non-causal with S != T (the kernel's wrapper takes it; the JAX kernel
    as one tile of S x T)."""
    b, h, hkv = 1, 4, 2
    q, k, v = _rand((b, s, h, d), 7), _rand((b, t, hkv, d), 8), _rand((b, t, hkv, d), 9)
    o_k1, o_k4a, want_m, want_l = _jax_forward(q, k, v, False)
    o, m, l = flash_mod.flash_forward_schedule(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(o.numpy(), o_k1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(o.numpy(), o_k4a, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=RTOL, atol=0)


@pytest.mark.parametrize("s,d,causal", [(200, 128, True), (257, 64, True), (64, 128, False)])
def test_schedule_rounds_p_to_bf16_as_the_jax_kernels_do(s, d, causal):
    """bf16 inputs, as on the card: both sides round P to bf16 before P V and
    write a bf16 o. |o| < 4, so one bf16 ulp of o is at most 2^-6 = 1.6e-2;
    the two may round a value that lies between two bf16 numbers apart."""
    b, h, hkv = 1, 4, 2
    q, k, v = (torch.from_numpy(_rand(shape, i)).to(torch.bfloat16)
               for i, shape in enumerate([(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)]))
    f32 = [x.float().numpy() for x in (q, k, v)]
    o_k1, o_k4a, want_m, want_l = _jax_forward(*f32, causal, dtype=jnp.bfloat16)
    o, m, l = flash_mod.flash_forward_schedule(q, k, v, causal=causal)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), o_k1, rtol=0, atol=1.6e-2)
    np.testing.assert_allclose(o.float().numpy(), o_k4a, rtol=0, atol=1.6e-2)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=RTOL, atol=0)


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 64), (64, 128)])
def test_schedule_gives_the_same_answer_at_other_tile_sizes(block_q, block_k):
    """The tile sizes move only the summation order (the sizes the card's
    probe times against the kernel's own)."""
    q, k, v = (torch.from_numpy(_rand(shape, i)) for i, shape in
               enumerate([(1, 333, 4, 64), (1, 333, 2, 64), (1, 333, 2, 64)]))
    want = flash_mod.flash_forward_schedule(q, k, v)
    got = flash_mod.flash_forward_schedule(q, k, v, block_q=block_q, block_k=block_k)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_schedule_matches_the_plain_versions():
    q, k, v = (torch.from_numpy(_rand(shape, i)) for i, shape in
               enumerate([(2, 150, 4, 128), (2, 150, 1, 128), (2, 150, 1, 128)]))
    o, m, l = flash_mod.flash_forward_schedule(q, k, v)
    want_m, want_l = flash_mod.flash_statistics_plain(q, k, v)
    torch.testing.assert_close(o, flash_mod.flash_attention_plain(q, k, v), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(m, want_m, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(l, want_l, rtol=RTOL, atol=0)


def test_a_row_without_a_live_key_is_written_as_zero():
    """The `l == 0` guard: no key at all leaves l = 0 and o = 0."""
    q = torch.from_numpy(_rand((1, 5, 2, 64), 0))
    kv = torch.zeros((1, 0, 2, 64))
    o, m, l = flash_mod.flash_forward_schedule(q, kv, kv, causal=False)
    assert o.abs().sum().item() == 0.0 and l.abs().sum().item() == 0.0


def test_module_tile_sizes_are_the_kernels():
    """The sizes the schedule walks are the ones the CUDA source is built with."""
    source = (Path(flash_mod._build.CSRC) / "flash_attention.cu").read_text()
    sizes = {name: int(value) for name, value in
             re.findall(r"#define TEOCHAT_FLASH_(BQ|BK) (\d+)", source)}
    assert sizes == {"BQ": flash_mod.FWD_BLOCK_Q, "BK": flash_mod.FWD_BLOCK_K}
    assert flash_mod.FWD_BLOCK_Q in (64, 128)  # one or two warpgroups of 64 rows
    assert "mma_16816" not in source and "wgmma_ss" in source and "tma_load" in source
