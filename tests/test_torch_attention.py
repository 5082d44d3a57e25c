"""The port's attention twins against the JAX package's kernels, on CPU.

The CUDA kernels cannot run here; their plain twins are what a CPU tensor
reaches, and they must compute what the Pallas kernels compute. The Pallas
kernels run in interpret mode, as the JAX package's own tests run them, and
shapes they do not tile are compared with the JAX reference paths. Inputs
come from seeded numpy; everything is fp32, compared to 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from teochat_tpu.ops.attention import xla_attention
from teochat_tpu.ops.decode_attention import decode_attention as jax_decode
from teochat_tpu.ops.flash_attention import flash_attention as jax_flash
from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.ops import flash_attention as flash_mod
from teochat_torch.ops.attention import dot_product_attention, plain_attention

RTOL, ATOL = 1e-4, 1e-5  # fp32 on both sides; only the summation order differs


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize(
    "b,s,h,hkv,d,causal,via",
    [
        (1, 256, 2, 2, 32, True, "interpret"),  # two 128-tiles, causal skip
        (2, 128, 2, 2, 32, False, "interpret"),
        (1, 100, 2, 2, 32, True, "interpret"),  # ragged vs the CUDA 64-row tile
        (1, 200, 2, 2, 32, True, "xla"),  # ragged vs the Pallas 128-tile
        (1, 128, 8, 2, 32, True, "interpret"),  # GQA
    ],
)
def test_flash_twin_matches_jax(b, s, h, hkv, d, causal, via):
    q = _rand((b, s, h, d), 0)
    k = _rand((b, s, hkv, d), 1)
    v = _rand((b, s, hkv, d), 2)
    if via == "interpret":
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, interpret=True)
    else:
        want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    before = flash_mod.LAUNCHES.count
    got = flash_mod.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert flash_mod.LAUNCHES.count == before  # a CPU tensor never launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "b,h,hkv,t,d,via",
    [
        (2, 4, 4, 256, 32, "interpret"),
        (3, 8, 2, 256, 32, "interpret"),  # GQA
        (3, 8, 2, 200, 32, "xla"),  # T not a multiple of 128: the Pallas path does not tile it
    ],
)
def test_decode_twin_matches_jax(b, h, hkv, t, d, via):
    q = _rand((b, h, d), 3)
    k = _rand((b, hkv, t, d), 4)
    v = _rand((b, hkv, t, d), 5)
    lens = np.array([1, t, t // 2 + 3][:b], np.int32)
    impl = "pallas" if via == "interpret" else "xla"
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                      impl=impl, interpret=via == "interpret")
    before = dec_mod.LAUNCHES.count
    got = dec_mod.decode_attention(_t(q), _t(k), _t(v), _t(lens))
    assert dec_mod.LAUNCHES.count == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_decode_reads_strided_cache_slab():
    """The decoder hands the twin (and the kernel) a transposed layer slab of
    the [L, B, T, Hkv, D] cache; the result equals a contiguous copy's."""
    cache_k = _t(_rand((2, 2, 40, 4, 16), 6))
    cache_v = _t(_rand((2, 2, 40, 4, 16), 7))
    q = _t(_rand((2, 8, 16), 8))
    lens = torch.tensor([5, 40], dtype=torch.int32)
    ks, vs = cache_k[1].transpose(1, 2), cache_v[1].transpose(1, 2)
    got = dec_mod.decode_attention(q, ks, vs, lens)
    want = dec_mod.decode_attention(q, ks.contiguous(), vs.contiguous(), lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dispatch_takes_plain_path_for_cpu_tensors():
    q = _t(_rand((1, 64, 2, 16), 9))
    before = flash_mod.LAUNCHES.count
    got = dot_product_attention(q, q, q, causal=True)
    assert flash_mod.LAUNCHES.count == before
    torch.testing.assert_close(got, plain_attention(q, q, q, causal=True), rtol=0, atol=0)
    # the kernel route refuses what it cannot take instead of falling back
    with pytest.raises(ValueError):
        dot_product_attention(q, q, q, causal=True, impl="flash",
                              mask=torch.ones(1, 64, dtype=torch.bool))
    with pytest.raises(ValueError):
        dec_mod.decode_attention(q[:, 0], q.transpose(1, 2), q.transpose(1, 2),
                                 torch.tensor([3], dtype=torch.int32), impl="kernel")
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, q[:, :32], q[:, :32], causal=True)
    with pytest.raises(NotImplementedError):
        flash_mod.flash_attention(q, q, q, bias_k=torch.zeros(2, 64))
