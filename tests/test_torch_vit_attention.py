"""Port vs JAX: the plain `vit_attention` against the Pallas one-shot kernel
in interpret mode (fp32, CPU), 1e-4 relative (the two sides sum in different
orders), and the tower unchanged by routing its spatial attention there."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import tiny_test_config
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.models import vit as jax_vit
from teochat_tpu.ops import vit_attention as jax_va
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.models import vit as torch_vit
from teochat_torch.ops import vit_attention as torch_va


def _qkv(b, s, h, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,s,h,d", [(2, 257, 4, 64), (3, 100, 2, 64), (1, 128, 2, 32)])
def test_plain_vit_attention_matches_pallas(b, s, h, d):
    """S = 257 is the tower's length; S = 100 is ragged against every tile."""
    q, k, v = _qkv(b, s, h, d, 0)
    want = jax_va.vit_attention(*map(jnp.asarray, (q, k, v)), impl="pallas", interpret=True)
    got = torch_va.vit_attention(*map(torch.from_numpy, (q, k, v)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_vit_attention_scale_and_impl():
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 2, 64, 1))
    want = np.asarray(jax_va.vit_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                           scale=0.2, impl="pallas", interpret=True))
    np.testing.assert_allclose(torch_va.vit_attention(q, k, v, scale=0.2, impl="plain").numpy(),
                               want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        torch_va.vit_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError):  # the kernel takes CUDA bf16 tensors only
        torch_va.vit_attention(q, k, v, impl="kernel")


def test_gate_is_the_jax_functions():
    assert [torch_va.in_kernel_range(s) for s in (8, 63, 64, 257, 1024, 1025)] == \
        [False, False, True, True, True, False]


def test_vit_forward_unchanged_by_the_routing(monkeypatch):
    """A tower whose sequence (65) is inside the gate goes through
    `vit_attention` and still matches the JAX tower."""
    cfg = tiny_test_config()
    vision = dataclasses.replace(cfg.vision, image_size=32, patch_size=4)  # 64 patches + CLS
    cfg = dataclasses.replace(cfg, vision=vision)
    params = jax_teochat.init_teochat(jax.random.PRNGKey(3), cfg)["vision"]
    frames = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    want = np.asarray(jax_vit.vit_forward(params, vision, jnp.asarray(frames)))
    calls = []
    real = torch_vit.vit_attention
    monkeypatch.setattr(torch_vit, "vit_attention",
                        lambda q, k, v: calls.append(q.shape[1]) or real(q, k, v))
    got = torch_vit.vit_forward(to_torch(jax.tree.map(np.asarray, params), "cpu"), vision,
                                torch.from_numpy(frames))
    assert calls and set(calls) == {65}
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
