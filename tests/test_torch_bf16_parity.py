"""Where the port rounds to bf16, against the JAX package in bf16 on the CPU.

The decoder parity tests run in fp32, where a product's result dtype cannot
matter. Here the same numpy weights and inputs go through both packages in
bf16: every product sums exact bf16 x bf16 products in fp32, and what is
held is where that sum is rounded. The reference returns the fp32 sum for
the logits (`preferred_element_type=float32`), scales the int8 projection's
fp32 sum before its one rounding, and keeps the second LoRA product in fp32
until `lora_scale`. JAX matmuls run at `highest` (tests/conftest.py), torch
on the CPU has no TF32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import tiny_test_config
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.ops import quant as jax_quant
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.models import llama as torch_llama
from teochat_torch.ops import quant as torch_quant

# Two fp32 sums of the same K exact products in different orders differ by at
# most ~K * 2^-24 of the sum of their magnitudes; read 2e-7 relative at K = 256
SUM_ORDER_RTOL = 1e-5
# The two decoders' hidden states differ by a bf16 rounding here and there
# (exp, rsqrt and the order of fp32 sums differ in the last bit, which now
# and then moves a value across a rounding boundary), so their logits (|l| up
# to 0.66) differ by 5.4e-4 to 6.5e-4 as read over the three heads. Logits
# rounded to bf16 would add half a step of 2^-8 at |l| > 0.5: read 1.6e-3 to
# 2.1e-3 with a head that rounds
DECODER_LOGITS_ATOL = 1e-3


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _is_bf16_representable(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.array(x))
    return (t.bfloat16().float() == t).numpy()


def _steps_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many elements of two bf16 tensors differ at all."""
    assert a.dtype == b.dtype == torch.bfloat16
    return int((a.float() != b.float()).sum())


@pytest.mark.parametrize("head", ["bf16", "tied", "int8"])
def test_decoder_logits_are_the_fp32_sum(head):
    cfg = tiny_test_config().llm
    params = jax_llama.init_llama(jax.random.PRNGKey(5), cfg)
    if head == "int8":
        params = jax_quant.quantize_llama_params(params)
    if head == "tied":
        params = {k: v for k, v in params.items() if k != "lm_head"}
    # weights to bf16; int8 kernels and their fp32 scales stay
    params = jax.tree.map(
        lambda x: _bf16(x) if x.dtype == jnp.float32 and x.ndim > 1 else x, params)
    if head == "int8":
        params["lm_head"]["scale"] = params["lm_head"]["scale"].astype(jnp.float32)
    rs = np.random.RandomState(6)
    emb = rs.randn(2, 12, cfg.hidden_size).astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    want, _ = jax_llama.llama_forward(params, cfg, _bf16(emb), position_ids=jnp.asarray(pos))
    want = np.asarray(want)
    got = torch_llama.llama_forward(
        to_torch(_np_tree(params), "cpu"), cfg, torch.from_numpy(emb).bfloat16(),
        position_ids=torch.from_numpy(pos))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    # an fp32 sum of 64 products has more than bf16's 8 bits: hardly any
    # logit lies on the bf16 grid, in either package
    assert _is_bf16_representable(got).mean() < 0.05
    assert _is_bf16_representable(want).mean() < 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=DECODER_LOGITS_ATOL)


def test_matmul_fp32_is_the_accumulator():
    """bf16 operands at K = 256 with logits of size ~16: the result is JAX's
    fp32 sum to summation order, where a bf16 product is off by up to 0.06."""
    rs = np.random.RandomState(7)
    a = torch.from_numpy(rs.randn(8, 256).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rs.randn(256, 512).astype(np.float32)).bfloat16()
    want = np.asarray(jnp.einsum("md,df->mf", _bf16(a.float().numpy()), _bf16(b.float().numpy()),
                                 preferred_element_type=jnp.float32))
    got = torch_quant.matmul_fp32(a, b)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SUM_ORDER_RTOL, atol=1e-5)
    assert np.abs(torch.matmul(a, b).float().numpy() - want).max() > 1e-2  # what rounding costs
    # fp32 operands are an ordinary product
    assert torch.equal(torch_quant.matmul_fp32(a.float(), b.float()),
                       torch.matmul(a.float(), b.float()))
    # leading dimensions are kept
    assert torch.equal(torch_quant.matmul_fp32(a.reshape(2, 4, 256), b), got.reshape(2, 4, 512))
    with pytest.raises(ValueError, match="dtypes"):
        torch_quant.matmul_fp32(a, b.float())


def test_matmul_fp32_gradients_match_a_bf16_product():
    """Gradients arrive in the operands' dtype: the cotangent rounded once as
    an operand, each product summed in fp32 and rounded once."""
    rs = np.random.RandomState(8)
    a = torch.from_numpy(rs.randn(4, 64).astype(np.float32)).bfloat16().requires_grad_(True)
    b = torch.from_numpy(rs.randn(64, 32).astype(np.float32)).bfloat16().requires_grad_(True)
    dy = torch.from_numpy(rs.randn(4, 32).astype(np.float32))
    torch_quant.matmul_fp32(a, b).backward(dy)
    g = dy.bfloat16().float()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert torch.equal(a.grad, (g @ b.detach().float().t()).bfloat16())
    assert torch.equal(b.grad, (a.detach().float().t() @ g).bfloat16())


def _int8_case():
    rs = np.random.RandomState(9)
    x = rs.randn(1, 256).astype(np.float32)
    w = rs.randn(256, 512).astype(np.float32) * 0.05
    dy = rs.randn(1, 512).astype(np.float32)
    return x, w, dy


def test_int8_projection_rounds_once():
    """[1, 256] x [256, 512]: the scale meets the fp32 sum, so no output is a
    bf16 step away from the reference's (rounding the product first moves
    about a fifth of them)."""
    x, w, _ = _int8_case()
    pj = jax_quant.quantize_kernel(jnp.asarray(w))
    want = np.asarray(jax_quant.quantized_proj(_bf16(x), pj).astype(jnp.float32))
    pt = to_torch(_np_tree(pj), "cpu")
    got = torch_quant.quantized_proj(torch.from_numpy(x).bfloat16(), pt)
    assert got.dtype == torch.bfloat16
    assert _steps_apart(got, torch.from_numpy(np.array(want)).bfloat16()) == 0
    # the int8 lm_head's form of it: the scaled fp32 sum itself
    logits = torch_quant.quantized_proj(torch.from_numpy(x).bfloat16(), pt, fp32_out=True)
    ref = np.asarray(jnp.einsum("md,df->mf", _bf16(x), pj["kernel"].astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32) * pj["scale"])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref, rtol=SUM_ORDER_RTOL, atol=1e-6)


def test_int8_projection_dx_is_one_rounding_from_jax():
    """dx = (dy * scale) @ W^T. The reference multiplies the fp32 dy * scale;
    the port rounds it to bf16 as the product's operand (once, 2^-9 relative
    on each term), sums in fp32 and rounds the sum once: a known deviation.
    So each dx lies within 2^-9 * sum |g| |W| of the reference's fp32 value,
    plus the final rounding's half step (2^-9 relative); it is exactly the
    one rounding of the exact sum over the rounded operand (no second
    rounding of the sum). Read: 112 of 256 differ from the reference's, by
    one bf16 step except where the sum cancels to a small value."""
    x, w, dy = _int8_case()
    pj = jax_quant.quantize_kernel(jnp.asarray(w))
    want = np.asarray(jax.grad(
        lambda xx: jnp.sum(jax_quant.quantized_proj(xx, pj).astype(jnp.float32) * _bf16(dy)
                           .astype(jnp.float32)))(_bf16(x)).astype(jnp.float32))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    torch_quant.quantized_proj(xt, to_torch(_np_tree(pj), "cpu")).backward(
        torch.from_numpy(dy).bfloat16())
    assert xt.grad.dtype == torch.bfloat16
    g = np.abs(np.asarray(_bf16(dy).astype(jnp.float32)) * np.asarray(pj["scale"]))
    spread = g @ np.abs(np.asarray(pj["kernel"], np.float32)).T  # sum |g| |W|, [1, 256]
    bound = 2.0 ** -9 * spread + 2.0 ** -8 * np.abs(want)
    got = xt.grad.float().numpy()
    assert (np.abs(got - want) <= bound).all()
    g16 = torch.from_numpy(np.asarray(_bf16(dy).astype(jnp.float32)) * np.asarray(pj["scale"]))
    exact = g16.bfloat16().double() @ torch.from_numpy(np.array(pj["kernel"])).double().t()
    assert _steps_apart(xt.grad, exact.float().bfloat16()) == 0
    assert (got != want).sum() <= 128


def test_lora_delta_stays_fp32_until_the_scale():
    """y + (x a) b * 1.5 on a zero base kernel: (x a) is rounded to bf16, the
    second product is scaled as an fp32 sum and rounded once, as in the
    reference (rounding it before the scale moves a quarter of the outputs)."""
    rs = np.random.RandomState(10)
    x = rs.randn(1, 256).astype(np.float32)
    p = {
        "kernel": np.zeros((256, 512), np.float32),
        "lora_a": (rs.randn(256, 16) * 0.1).astype(np.float32),
        "lora_b": (rs.randn(16, 512) * 0.1).astype(np.float32),
        "lora_scale": np.asarray(1.5, np.float32),
    }
    want = np.asarray(jax_llama._proj(_bf16(x), jax.tree.map(jnp.asarray, p)).astype(jnp.float32))
    got = torch_llama._proj(torch.from_numpy(x).bfloat16(), to_torch(p, "cpu"))
    assert got.dtype == torch.bfloat16
    assert np.abs(want).max() > 0.1
    assert _steps_apart(got, torch.from_numpy(np.array(want)).bfloat16()) == 0
