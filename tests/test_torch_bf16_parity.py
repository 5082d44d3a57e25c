"""Where the port rounds to bf16, against the JAX package in bf16 on the CPU.

The decoder parity tests run in fp32, where a product's result dtype cannot
matter. Here the same numpy weights and inputs go through both packages in
bf16: every product sums exact bf16 x bf16 products in fp32, and what is
held is where that sum is rounded. The reference returns the fp32 sum for
the logits (`preferred_element_type=float32`), scales the int8 projection's
fp32 sum before its one rounding, and keeps the second LoRA product in fp32
until `lora_scale`; its gradients meet the fp32 cotangent (and the int8
projection's fp32 dy * scale) whole. JAX matmuls run at `highest` (tests/conftest.py), torch
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
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

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
    """The gradients of the fp32-accumulated product are JAX's: `jax.grad` of
    the reference's einsum (`preferred_element_type=float32`) transposes with
    the fp32 cotangent whole, sums in fp32 and rounds once to the operands'
    bf16. No gradient is a bf16 step from JAX's; the cotangent rounded to bf16
    first (the port before this repair) moved 104 of a's 256."""
    rs = np.random.RandomState(8)
    a32 = rs.randn(4, 64).astype(np.float32)
    b32 = rs.randn(64, 32).astype(np.float32)
    dy = rs.randn(4, 32).astype(np.float32)
    want_a, want_b = jax.grad(
        lambda aa, bb: jnp.sum(jnp.einsum("md,df->mf", aa, bb, preferred_element_type=jnp.float32)
                               * dy), argnums=(0, 1))(_bf16(a32), _bf16(b32))
    a = torch.from_numpy(a32).bfloat16().requires_grad_(True)
    b = torch.from_numpy(b32).bfloat16().requires_grad_(True)
    torch_quant.matmul_fp32(a, b).backward(torch.from_numpy(dy))
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    for got, want in ((a.grad, want_a), (b.grad, want_b)):
        assert _steps_apart(got, torch.from_numpy(np.asarray(want.astype(jnp.float32))).bfloat16()) == 0
    rounded = (torch.from_numpy(dy).bfloat16().float() @ b.detach().float().t()).bfloat16()
    assert _steps_apart(rounded, a.grad) > 0


def test_lora_proj_gradients_match_jax():
    """`_proj` with a LoRA adapter at lora_scale 1.5 in bf16, against the
    reference's `_proj` under `jax.grad`: the gradients of the fp32 lora_a and
    lora_b masters and of x. Both sides sum exact bf16 products in fp32 and
    round where the reference rounds, so they differ only where two fp32 sums
    in another order fall on either side of a bf16 rounding: read 0 of 256 x
    values, 0 of 512 lora_a and 0 of 384 lora_b values apart; held to one in
    64 of each a bf16 step apart, none further. Rounding the fp32 cotangent
    of the second LoRA product to bf16 (the port before this repair) moved
    76 of 256 x, 307 of 512 lora_a and 157 of 384 lora_b values, some by
    more than a step."""
    rs = np.random.RandomState(11)
    x = rs.randn(4, 64).astype(np.float32)
    p = {
        "kernel": (rs.randn(64, 48) * 0.1).astype(np.float32),
        "lora_a": (rs.randn(64, 8) * 0.1).astype(np.float32),
        "lora_b": (rs.randn(8, 48) * 0.1).astype(np.float32),
        "lora_scale": np.asarray(1.5, np.float32),
    }
    w = rs.randn(4, 48).astype(np.float32)

    def jax_loss(xx, la, lb):
        pj = {"kernel": _bf16(p["kernel"]), "lora_a": la, "lora_b": lb,
              "lora_scale": jnp.asarray(p["lora_scale"])}
        return jnp.sum(jax_llama._proj(xx, pj).astype(jnp.float32) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(_bf16(x), jnp.asarray(p["lora_a"]),
                                                 jnp.asarray(p["lora_b"]))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    pt = to_torch({**p, "kernel": np.asarray(_bf16(p["kernel"]).astype(jnp.float32))}, "cpu")
    pt["kernel"] = pt["kernel"].bfloat16()
    pt["lora_a"].requires_grad_(True)
    pt["lora_b"].requires_grad_(True)
    (torch_llama._proj(xt, pt).float() * torch.from_numpy(w)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and pt["lora_a"].grad.dtype == torch.float32
    for got, ref in ((xt.grad, want[0]), (pt["lora_a"].grad, want[1]), (pt["lora_b"].grad, want[2])):
        ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
        got = got.float()
        # the fp32 masters' gradients are bf16 values cast up, on both sides
        assert torch.equal(got.bfloat16().float(), got) and torch.equal(ref.bfloat16().float(), ref)
        step = 2.0 ** -7 * ref.abs()  # one bf16 step at |ref| (8 bits of mantissa)
        assert int((got != ref).sum()) <= got.numel() // 64
        assert ((got - ref).abs() <= step + 1e-30).all()


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
    """dx = (dy * scale) @ W^T, with the fp32 dy * scale whole as the
    reference's gradient has it (`teochat_tpu/ops/quant.py:46-50` under
    `jax.grad`), summed in fp32 and rounded once. Held to JAX's dx: at most 2
    of 256 a bf16 step apart (two fp32 sums in another order on either side
    of a rounding; the card's head-and-remainder split leaves ~2^-17 of each
    term as well), none further. Read here: 0 apart. Rounding dy * scale to
    bf16 first (the port before this repair) moved 112 of 256."""
    x, w, dy = _int8_case()
    pj = jax_quant.quantize_kernel(jnp.asarray(w))
    want = np.asarray(jax.grad(
        lambda xx: jnp.sum(jax_quant.quantized_proj(xx, pj).astype(jnp.float32) * _bf16(dy)
                           .astype(jnp.float32)))(_bf16(x)).astype(jnp.float32))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    torch_quant.quantized_proj(xt, to_torch(_np_tree(pj), "cpu")).backward(
        torch.from_numpy(dy).bfloat16())
    assert xt.grad.dtype == torch.bfloat16
    got, ref = xt.grad.float(), torch.from_numpy(want)
    assert int((got != ref).sum()) <= 2
    assert ((got - ref).abs() <= 2.0 ** -7 * ref.abs()).all()  # at most one bf16 step
    # and one rounding of the exact sum over the fp32 operand
    g = torch.from_numpy(np.asarray(_bf16(dy).astype(jnp.float32)) * np.asarray(pj["scale"]))
    exact = g.double() @ torch.from_numpy(np.array(pj["kernel"])).double().t()
    assert _steps_apart(xt.grad, exact.float().bfloat16()) <= 2
    rounded = g.bfloat16().double() @ torch.from_numpy(np.array(pj["kernel"])).double().t()
    assert _steps_apart(rounded.float().bfloat16(), ref.bfloat16()) > 64  # what the repair buys


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
