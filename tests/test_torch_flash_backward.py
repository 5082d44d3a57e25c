"""The port's trainable flash attention (K4a-c's plain twin) against the JAX
custom_vjp `flash_attention_trainable` / `_padded`, run in Pallas interpret
mode on the CPU.

Same fp32 inputs from a seeded numpy generator on both sides; the upstream
gradient is that of sum(o * cos(o)), so dO is not constant. The port's twin
is autograd through the plain attention (full softmax), the JAX side the
tiled online softmax with recomputed probabilities, so they differ by fp32
summation order only: o to 1e-5 and dq, dk, dv to 1e-4 (absolute and
relative; gradients are O(1) sums over up to 256 keys or queries). The
`bias_k` cases add an ALiBi-style table [H, T] (JAX's `has_bias_k`
branch, a constant on both sides): MPT's table sized to S, a random one,
and the first S keys of MPT's table for a 1,024-slot cache, whose biases
reach -860 (JAX adds them to the scores before it subtracts m, so they cost
it half an fp32 ulp there, 3e-5 relative, inside GRAD_TOL).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.ops import flash_attention as jax_flash
from teochat_torch.models import mpt as torch_mpt
from teochat_torch.ops import flash_attention as torch_flash
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

O_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(b, s, h, hkv, d, seed):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, s, h, d) * 0.3).astype(np.float32)
    k = (rs.randn(b, s, hkv, d) * 0.3).astype(np.float32)
    v = rs.randn(b, s, hkv, d).astype(np.float32)
    return q, k, v


def _table(kind, h, s):
    """[H, S] fp32 bias_k: MPT's ALiBi table sized to S, a random one, or the
    first S keys of MPT's table for a 1,024-slot cache (32 heads' slopes)."""
    if kind == "mpt":
        return np.asarray(torch_mpt.alibi_bias(h, s)[0, :, 0, :])
    if kind == "random":
        return (np.random.RandomState(h + s).randn(h, s) * 2).astype(np.float32)
    return np.ascontiguousarray(torch_mpt.alibi_bias(32, 1024)[0, :h, 0, :s].numpy())


def _jax_grads(fn, q, k, v):
    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o * jnp.cos(o)), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (o, *grads)]


def _torch_grads(fn, q, k, v):
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v)
    (o * torch.cos(o)).sum().backward()
    return [x.detach().numpy() for x in (o, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize(
    "b,s,h,hkv,d,padded,table",
    [
        (1, 256, 2, 2, 64, False, None),  # causal, 2 x 2 tiles: the diagonal skip
        (2, 256, 4, 2, 64, False, None),  # GQA 2:1, the group's dK/dV sum
        (1, 200, 2, 1, 64, True, None),  # ragged S through the padded wrapper, GQA 2:1
        (1, 128, 2, 2, 128, False, None),  # head_dim 128, one tile
        (1, 256, 2, 2, 64, False, "mpt"),  # MPT's ALiBi table, the diagonal skip
        (1, 256, 2, 1, 64, False, "random"),  # multiquery: one kv head
        (1, 200, 2, 2, 64, True, "cache"),  # a cache-sized table, ragged S padded
    ],
    ids=["causal-multi-tile", "gqa", "ragged-padded", "d128", "bias-mpt",
         "bias-random-multiquery", "bias-cache-ragged-padded"],
)
def test_trainable_flash_matches_jax_interpret(b, s, h, hkv, d, padded, table):
    q, k, v = _inputs(b, s, h, hkv, d, seed=s + h + d)
    bias = None if table is None else _table(table, h, s)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    if padded:
        jfn = lambda q, k, v: jax_flash.flash_attention_trainable_padded(  # noqa: E731
            q, k, v, True, None, 128, 128, True, bias_k=jb)
        tfn = lambda q, k, v: torch_flash.flash_attention_trainable_padded(  # noqa: E731
            q, k, v, bias_k=tb)
    else:
        jfn = lambda q, k, v: jax_flash.flash_attention_trainable(  # noqa: E731
            q, k, v, True, None, 128, 128, True, jb)
        tfn = lambda q, k, v: torch_flash.flash_attention_trainable(q, k, v, bias_k=tb)  # noqa: E731
    want = _jax_grads(jfn, q, k, v)
    got = _torch_grads(tfn, q, k, v)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        tol = O_TOL if name == "o" else GRAD_TOL
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def test_trainable_flash_refuses_what_it_does_not_take():
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="bias_k"):  # the table must be [H, T]
        torch_flash.flash_attention_trainable(x, x, x, bias_k=torch.zeros(2, 4))
    with pytest.raises(ValueError, match="causal"):
        torch_flash.flash_attention_trainable_padded(x, x, x, causal=False)
    with pytest.raises(ValueError, match="S == T"):
        torch_flash.flash_attention_trainable(x, x[:, :4], x[:, :4])
