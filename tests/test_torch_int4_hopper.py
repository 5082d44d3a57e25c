"""The Hopper int4 prefill kernel's tile walk against the JAX kernels it replaces.

The M > 8 kernel of teochat_torch/csrc/int4_matmul.cu (K3a, K3b and K3c at
prefill) runs only on a card. Its walk is written out in plain PyTorch as
`int4_prefill_schedule`: row tiles of 128, column bands of 128, steps of
64 byte rows, x read at columns r0 and k2 + r0 with zeros past K
and past M, zero weights for byte rows past k2, fp32 sums, the scale on the
accumulator. Here that walk is held against `teochat_tpu`'s `_int4_kernel`,
`_int4_tiled_kernel(_i8)` and `_int4_tiled_kernel_stacked(_i8)`, run in
Pallas interpret mode on the CPU, and against the port's plain versions.

Same seeded numpy inputs on both sides, fp32. Tolerance: 1e-4 relative with
an absolute floor of 1e-4 of the largest output (the v3 Pallas body sums
terms 16 times the result before they cancel, and the sums run in other
orders). The JAX kernels read x at its padded fan-in, so x is zero-padded to
2 k2 for them; the port reads it at its true K.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from teochat_tpu.ops import int4_matmul as jax_i4
from teochat_torch.ops import int4_matmul as torch_i4
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

N_OUT = 640  # two tiles of 512, the second ragged; five bands of 128


def _values(k, n, seed):
    return np.random.RandomState(seed).randint(-8, 8, (k, n)).astype(np.int32)


def _inputs(m, k, k2, n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype(np.float32)
    scale = (rs.rand(n) * 0.1 + 0.01).astype(np.float32)
    return x, scale


def _x_for_jax(x, k2):
    """The JAX kernels read x at the padded fan-in 2 k2."""
    return jnp.asarray(np.pad(x, ((0, 0), (0, 2 * k2 - x.shape[1]))))


def _tiles(fmt, w, tw):
    pack = jax_i4.pack_int4_tiled if fmt == "u8" else jax_i4.pack_int4_tiled_i8
    return np.array(pack(jnp.asarray(w), tw))


def _assert_close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def _schedule(x, packed, scale, **kw):
    return torch_i4.int4_prefill_schedule(torch.from_numpy(x), torch.from_numpy(packed),
                                          torch.from_numpy(scale), **kw)


# (K, k2): k2 % 64 != 0 (the low box reads the high half's first x values),
# and the same bytes with K < 2 k2 (the quantizer's padded fan-in)
FAN_INS = [(208, 104), (200, 104)]


@pytest.mark.parametrize("fmt", ["u8", "i8"])
# ragged against the 128-row tile; 16 is batched decode, past the small-M kernel
@pytest.mark.parametrize("m", [9, 16, 70, 130])
@pytest.mark.parametrize("k,k2", FAN_INS)
def test_schedule_matches_jax_stacked_kernel_on_layer_1(fmt, m, k, k2):
    x, _ = _inputs(m, k, k2, N_OUT, 0)
    tiles = np.stack([_tiles(fmt, _values(2 * k2, N_OUT, 10 + i), 512) for i in range(2)])
    n_pad = tiles.shape[1] * 512
    scale = (np.random.RandomState(1).rand(2, n_pad) * 0.1 + 0.01).astype(np.float32)
    want = jax_i4.int4_matmul_tiled_stacked(
        _x_for_jax(x, k2), jnp.asarray(tiles), jnp.asarray(scale), 1, n_out=N_OUT,
        block_k2=128, interpret=True)
    _assert_close(_schedule(x, tiles, scale, n_out=N_OUT, layer=1), want)


@pytest.mark.parametrize("fmt", ["u8", "i8"])
@pytest.mark.parametrize("k,k2,n,tw", [
    (208, 104, N_OUT, 512),
    (96, 128, 300, 128),  # K < k2: the high half is all zeros; tiles of 128
])
def test_schedule_matches_jax_tiled_kernel(fmt, k, k2, n, tw):
    x, scale = _inputs(70, k, k2, n, 2)
    tiles = _tiles(fmt, _values(2 * k2, n, 3), tw)
    scale_pad = np.pad(scale, (0, tiles.shape[0] * tw - n))
    want = jax_i4.int4_matmul_tiled(_x_for_jax(x, k2), jnp.asarray(tiles),
                                    jnp.asarray(scale_pad), n_out=n, block_k2=128,
                                    interpret=True)
    _assert_close(_schedule(x, tiles, scale, n_out=n), want)


@pytest.mark.parametrize("m", [9, 130])
@pytest.mark.parametrize("k,k2,n", [(208, 104, N_OUT), (200, 104, 256)])
def test_schedule_matches_jax_flat_kernel(m, k, k2, n):
    """A flat weight is one tile of TW = N: N 640 leaves a ragged last band."""
    x, scale = _inputs(m, k, k2, n, 4)
    packed = np.array(jax_i4.pack_int4(jnp.asarray(_values(2 * k2, n, 5))))
    want = jax_i4.int4_matmul(_x_for_jax(x, k2), jnp.asarray(packed), jnp.asarray(scale),
                              block_n=128, block_k2=128, interpret=True)
    _assert_close(_schedule(x, packed, scale), want)


def test_schedule_reads_x_through_its_row_stride():
    """x as a column slice of a wider activation (row stride > K), as int4_proj
    hands a slice of a fused output to the kernel."""
    m, k, k2 = 70, 200, 104
    wide = np.random.RandomState(6).randn(m, 3 * k).astype(np.float32)
    tiles = _tiles("i8", _values(2 * k2, N_OUT, 7), 512)
    scale = (np.random.RandomState(8).rand(N_OUT) * 0.1 + 0.01).astype(np.float32)
    x = torch.from_numpy(wide)[:, k:2 * k]
    assert x.stride(0) == 3 * k
    got = torch_i4.int4_prefill_schedule(x, torch.from_numpy(tiles), torch.from_numpy(scale),
                                         n_out=N_OUT)
    want = jax_i4.int4_matmul_tiled(_x_for_jax(wide[:, k:2 * k], k2), jnp.asarray(tiles),
                                    jnp.asarray(np.pad(scale, (0, 1024 - N_OUT))), n_out=N_OUT,
                                    block_k2=128, interpret=True)
    _assert_close(got, want)


@pytest.mark.parametrize("layout", ["flat", "tiled", "stacked"])
def test_schedule_matches_the_plain_versions(layout):
    m, k, k2 = 130, 200, 104
    x, scale = _inputs(m, k, k2, N_OUT, 9)
    xt, st = torch.from_numpy(x), torch.from_numpy(scale)
    w = torch.from_numpy(_values(2 * k2, N_OUT, 10))
    if layout == "flat":
        packed = torch_i4.pack_int4(w)
        want = torch_i4.int4_matmul_plain(xt, packed, st)
        got = torch_i4.int4_prefill_schedule(xt, packed, st)
    elif layout == "tiled":
        packed = torch_i4.pack_int4_tiled_i8(w)
        want = torch_i4.int4_matmul_tiled_plain(xt, packed, st, n_out=N_OUT)
        got = torch_i4.int4_prefill_schedule(xt, packed, st, n_out=N_OUT)
    else:
        packed = torch.stack([torch_i4.pack_int4_tiled(w.flip(0)), torch_i4.pack_int4_tiled(w)])
        st2 = torch.stack([st * 2, st])
        want = torch_i4.int4_matmul_tiled_stacked_plain(xt, packed, st2, 1, n_out=N_OUT)
        got = torch_i4.int4_prefill_schedule(xt, packed, st2, n_out=N_OUT, layer=1)
    _assert_close(got, want.numpy())


def test_schedule_refuses_a_band_that_straddles_tiles():
    """Tiles of 64 columns: a 128-column band would span two (the kernel's
    entries refuse such tiles too)."""
    tiles = torch_i4.pack_int4_tiled(torch.from_numpy(_values(64, 300, 11)), 64)
    with pytest.raises(ValueError, match="straddle"):
        torch_i4.int4_prefill_schedule(torch.zeros(9, 64), tiles, torch.ones(300), n_out=300)


def test_module_tile_sizes_are_the_kernels():
    """The sizes the walk takes are the ones the CUDA source is built with,
    and the M > 8 kernel is the wgmma one, not mma.sync (which the M <= 8
    kernel uses).

    The dequant threads' `fence.proxy.async` (their ordinary stores, then
    `wgmma` reading them through the async proxy) is only looked for here.
    The card test `test_int4_prefill_kernel_is_bit_stable_over_many_launches`
    is meant to catch its removal, but with the fence planted out it still
    passed on an H100 (PERF.md, section 6): this check stands in for a
    test of the race, and the fence stays because the memory model requires
    it."""
    source = (Path(torch_i4._build.CSRC) / "int4_matmul.cu").read_text()
    sizes = {name: int(value) for name, value in
             re.findall(r"#define TEOCHAT_INT4_(BM|BN|STEP) (\d+)", source)}
    assert sizes == {"BM": torch_i4.PREFILL_BLOCK_M, "BN": torch_i4.PREFILL_BLOCK_N,
                     "STEP": torch_i4.PREFILL_STEP}
    body = source[source.index("int4_large_m_kernel("):source.index("int launch_large_m(")]
    assert "mma_16816" not in body and "wgmma_ss_tb" in body and "tma_load" in body
    assert re.search(r"fence_proxy_async_shared\(\);\s*mbar_arrive\(full\(st\)\);", body)
    assert f"M <= {torch_i4.SMALL_M})" in source
