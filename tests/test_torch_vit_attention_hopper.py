"""The Hopper ViT attention's schedule against the JAX kernel it replaces.

The CUDA kernel (teochat_torch/csrc/vit_attention.cu, K5) runs only on a
card. Its schedule is written out in plain PyTorch as
`vit_attention_schedule`: query tiles of 64 rows, keys in windows of 272
whose scores a tile holds whole (an exact softmax up to S = 272, one online
rescale between windows past it), keys past S masked, scores in base-2
units, P rounded to the inputs' type before P V. Here that walk is held
against `teochat_tpu`'s `_attn_kernel` (one-shot, the whole key row at
once), run in Pallas interpret mode on the CPU, as
tests/test_torch_vit_attention.py holds the plain version.

Same inputs from a seeded numpy generator on both sides. In fp32 the two
differ by summation order and by exp2(x log2 e) against exp(x): 1e-4
relative, with 1e-4 of the largest output beside it for values near 0.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from teochat_tpu.ops import vit_attention as jax_va
from teochat_torch.ops import vit_attention as vit_mod
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

RTOL = 1e-4


def _qkv(b, s, h, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


def _pallas(q, k, v, dtype=jnp.float32, **kw):
    out = jax_va.vit_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)), impl="pallas",
                               interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("b,s,h", [
    (2, 257, 2),  # the tower's length: one window, 15 keys of it masked
    (1, 100, 2),  # ragged against the query tile and the window
    (1, 577, 1),  # a 336-pixel tower: three windows, two rescales
    (1, 1024, 1),  # the longest the gate lets through: four windows
])
def test_schedule_matches_the_pallas_kernel(b, s, h):
    q, k, v = _qkv(b, s, h, 64, 0)
    got = vit_mod.vit_attention_schedule(*map(torch.from_numpy, (q, k, v)))
    _close(got.numpy(), _pallas(q, k, v))


def test_schedule_takes_the_scale():
    q, k, v = _qkv(1, 257, 2, 64, 1)
    got = vit_mod.vit_attention_schedule(*map(torch.from_numpy, (q, k, v)), scale=0.2)
    _close(got.numpy(), _pallas(q, k, v, scale=0.2))


@pytest.mark.parametrize("window,tile_q", [(136, 64), (544, 64), (272, 128), (64, 16)])
def test_schedule_gives_the_same_answer_at_other_sizes(window, tile_q):
    """The window and the tile change where sums are split, not what they
    are: the same output as the kernel's sizes, at S = 577 (several windows
    at every size)."""
    q, k, v = map(torch.from_numpy, _qkv(1, 577, 2, 64, 2))
    want = vit_mod.vit_attention_schedule(q, k, v)
    got = vit_mod.vit_attention_schedule(q, k, v, window=window, tile_q=tile_q)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_one_window_is_the_exact_softmax():
    """Up to 272 keys the walk makes no rescale: the result is the exact
    softmax's, as the plain version computes it."""
    q, k, v = map(torch.from_numpy, _qkv(2, 272, 2, 64, 3))
    got = vit_mod.vit_attention_schedule(q, k, v)
    torch.testing.assert_close(got, vit_mod.vit_attention_plain(q, k, v), rtol=1e-5, atol=1e-6)


def test_schedule_rounds_p_to_bf16_as_the_pallas_kernel_does():
    """In bf16 both round P to bf16 before P V and o once: at S = 257 (one
    window, no rescale) they differ only where exp2 against exp or the sum's
    order moves a value across a bf16 rounding, one bf16 step of the output
    (|o| < 2, so 2^-7) at most. Read: 179 of 131,584 outputs apart, by
    2^-10 at most."""
    q, k, v = _qkv(2, 257, 4, 64, 4)
    want = _pallas(q, k, v, dtype=jnp.bfloat16)
    got = vit_mod.vit_attention_schedule(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v))).float().numpy()
    assert np.abs(want).max() < 2
    assert np.abs(got - want).max() <= 2.0 ** -7
    assert (got != want).mean() < 5e-3


def test_module_sizes_are_the_kernels():
    source = (Path(vit_mod._build.CSRC) / "vit_attention.cu").read_text()
    sizes = {name: int(value) for name, value in
             re.findall(r"constexpr int (TILE_Q|KEYS_A|KEYS_B) = (\d+)", source)}
    assert sizes == {"TILE_Q": vit_mod.TILE_Q, "KEYS_A": 256, "KEYS_B": 16}
    assert sizes["KEYS_A"] + sizes["KEYS_B"] == vit_mod.WINDOW
    # one sweep on the tensor cores: wgmma products, no mma.sync
    assert "wgmma_ss" in source and "wgmma_rs_tb" in source and "mma_16816" not in source
