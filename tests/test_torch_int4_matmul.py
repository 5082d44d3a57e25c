"""Port vs JAX: int4 packing is bit-exact, and the plain int4 products agree
with the Pallas kernels run in interpret mode (fp32, CPU).

Tolerance: 1e-4 relative with an absolute floor of 1e-4 of the largest
output. The v3 Pallas body sums terms 16 times the result before they
cancel, and the two sides add in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from teochat_tpu.ops import int4_matmul as jax_i4
from teochat_tpu.ops import quant as jax_quant
from teochat_torch.ops import int4_matmul as torch_i4
from teochat_torch.ops import quant as torch_quant
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _values(k, n, seed):
    return np.random.RandomState(seed).randint(-8, 8, (k, n)).astype(np.int32)


def _assert_close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("fmt", ["u8", "i8"])
def test_pack_unpack_bit_exact(fmt):
    w = _values(64, 96, 0)
    jpack, tpack = {"u8": (jax_i4.pack_int4, torch_i4.pack_int4),
                    "i8": (jax_i4.pack_int4_i8, torch_i4.pack_int4_i8)}[fmt]
    want = np.asarray(jpack(jnp.asarray(w)))
    got = tpack(torch.from_numpy(w))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    junpack, tunpack = {"u8": (jax_i4.unpack_int4_halves, torch_i4.unpack_int4_halves),
                        "i8": (jax_i4.unpack_int4_i8, torch_i4.unpack_int4_i8)}[fmt]
    np.testing.assert_array_equal(tunpack(got, torch.int32).numpy(), w)
    np.testing.assert_array_equal(
        torch_i4.unpack_int4_any(got, torch.float32).numpy(),
        np.asarray(junpack(jnp.asarray(want), jnp.float32)),
    )


def test_v3_bytes_are_u8_bytes_with_the_top_bit_flipped():
    w = torch.from_numpy(_values(32, 40, 1))
    u8 = torch_i4.pack_int4(w)
    i8 = torch_i4.pack_int4_i8(w)
    np.testing.assert_array_equal((u8 ^ 0x80).numpy().view(np.int8), i8.numpy())


@pytest.mark.parametrize("fmt", ["u8", "i8"])
@pytest.mark.parametrize("n,bn", [(256, 128), (300, 128), (700, 512)])
def test_tiled_layouts_bit_exact(fmt, n, bn):
    w = _values(32, n, 2)
    jpack, tpack = {"u8": (jax_i4.pack_int4_tiled, torch_i4.pack_int4_tiled),
                    "i8": (jax_i4.pack_int4_tiled_i8, torch_i4.pack_int4_tiled_i8)}[fmt]
    want = np.asarray(jpack(jnp.asarray(w), bn))
    got = tpack(torch.from_numpy(w), bn)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    flat = torch_i4.untile(got)[:, :n]
    np.testing.assert_array_equal(torch_i4.unpack_int4_any(flat, torch.int32).numpy(), w)


@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (5, 512, 128), (13, 256, 384)])
def test_int4_matmul_plain_matches_pallas(m, k, n):
    rs = np.random.RandomState(3)
    w, x = _values(k, n, 3), rs.randn(m, k).astype(np.float32)
    scale = (rs.rand(n) * 0.1 + 0.01).astype(np.float32)
    packed = np.array(jax_i4.pack_int4(jnp.asarray(w)))
    want = jax_i4.int4_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale),
                              block_n=128, block_k2=128, interpret=True)
    got = torch_i4.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                               torch.from_numpy(scale))
    _assert_close(got, want)


@pytest.mark.parametrize("fmt", ["u8", "i8"])
@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (8, 512, 384), (5, 256, 300)])
def test_int4_matmul_tiled_plain_matches_pallas(fmt, m, k, n):
    """N = 300 is not a multiple of the tile: padded columns are dropped."""
    rs = np.random.RandomState(4)
    w, x = _values(k, n, 4), rs.randn(m, k).astype(np.float32)
    jpack = jax_i4.pack_int4_tiled if fmt == "u8" else jax_i4.pack_int4_tiled_i8
    tiles = np.array(jpack(jnp.asarray(w), 128))
    n_pad = tiles.shape[0] * 128
    scale = (rs.rand(n) * 0.1 + 0.01).astype(np.float32)
    want = jax_i4.int4_matmul_tiled(
        jnp.asarray(x), jnp.asarray(tiles), jnp.asarray(np.pad(scale, (0, n_pad - n))),
        n_out=n, block_k2=128, interpret=True)
    # the port takes the scale at its true width or padded
    for sc in (scale, np.pad(scale, (0, n_pad - n))):
        got = torch_i4.int4_matmul_tiled(torch.from_numpy(x), torch.from_numpy(tiles),
                                         torch.from_numpy(sc), n_out=n)
        _assert_close(got, want)


@pytest.mark.parametrize("fmt", ["u8", "i8"])
def test_int4_matmul_tiled_stacked_plain_matches_pallas_each_layer(fmt):
    rs = np.random.RandomState(5)
    n_layers, m, k, n = 3, 4, 256, 300
    jpack = jax_i4.pack_int4_tiled if fmt == "u8" else jax_i4.pack_int4_tiled_i8
    tiles = np.stack([np.asarray(jpack(jnp.asarray(_values(k, n, 10 + i)), 128))
                      for i in range(n_layers)])
    n_pad = tiles.shape[1] * 128
    scale = (rs.rand(n_layers, n) * 0.1 + 0.01).astype(np.float32)
    x = rs.randn(m, k).astype(np.float32)
    for layer in range(n_layers):
        want = jax_i4.int4_matmul_tiled_stacked(
            jnp.asarray(x), jnp.asarray(tiles),
            jnp.asarray(np.pad(scale, ((0, 0), (0, n_pad - n)))), layer,
            n_out=n, block_k2=128, interpret=True)
        got = torch_i4.int4_matmul_tiled_stacked(
            torch.from_numpy(x), torch.from_numpy(tiles), torch.from_numpy(scale), layer,
            n_out=n)
        _assert_close(got, want)


def test_padded_fan_in_matches_pallas():
    """K = 2 * 300 is padded by `_pad_k2` to 2 * 512; x keeps its true K in
    the port (zeros are implied) and is padded for the Pallas kernel."""
    rs = np.random.RandomState(6)
    m, k, n = 3, 600, 512
    assert jax_quant._pad_k2(k // 2) == torch_quant._pad_k2(k // 2) == 512
    kernel = rs.randn(k, n).astype(np.float32)
    x = rs.randn(m, k).astype(np.float32)
    jq = jax_quant.quantize_kernel_int4(jnp.asarray(kernel))
    tiles, scale = np.array(jq["packed_tiles"]), np.array(jq["scale"])
    assert tiles.shape == (1, 512, 512)
    want = jax_i4.int4_matmul_tiled(
        jnp.asarray(np.pad(x, ((0, 0), (0, 1024 - k)))), jnp.asarray(tiles), jnp.asarray(scale),
        n_out=n, block_k2=128, interpret=True)
    got = torch_quant.int4_proj(torch.from_numpy(x), {"packed_tiles": torch.from_numpy(tiles),
                                                      "scale": torch.from_numpy(scale)})
    _assert_close(got, want)


def test_wrappers_reject_unknown_impl_and_missing_layer():
    x = torch.zeros(1, 16)
    packed = torch.zeros(8, 8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        torch_i4.int4_matmul(x, packed, torch.ones(8), impl="pallas")
    stacked = {"packed_tiles": torch.zeros(2, 1, 8, 128, dtype=torch.int8),
               "scale": torch.ones(2, 128)}
    with pytest.raises(ValueError):
        torch_quant.int4_proj(x, stacked)
