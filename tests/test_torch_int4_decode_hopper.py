"""The Hopper int4 decode kernel's split-K walk against the JAX kernels it replaces.

The M <= 8 kernel of teochat_torch/csrc/int4_matmul.cu (K3a, K3b and K3c at
decode) runs only on a card. Its walk is written out in plain PyTorch as
`int4_decode_schedule`: column bands of 128, K cut into the slices that
`decode_k_slices` picks for an H100 SXM's 132 SMs, x read at columns r and k2 + r with zeros past K,
an fp32 partial for each (band, slice), the partials summed in slice order,
the scale on that sum, one rounding. Here that walk is held against
`teochat_tpu`'s `_int4_kernel`, `_int4_tiled_kernel(_i8)` and
`_int4_tiled_kernel_stacked(_i8)`, run in Pallas interpret mode on the CPU,
and against the port's plain versions; and the split rule against the
block count it is meant to reach at the 7B shapes.

Same seeded numpy inputs on both sides, fp32. Tolerance: 1e-4 relative with
an absolute floor of 1e-4 of the largest output, as in
tests/test_torch_int4_hopper.py (the v3 Pallas body sums terms 16 times the
result before they cancel, and the sums run in other orders). The JAX
kernels read x at its padded fan-in, so x is zero-padded to 2 k2 for them;
the port reads it at its true K. Each JAX shape is one more XLA compilation
in the worker's process, so the cases share shapes where they can.
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


def _inputs(m, k, n, seed):
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
    return torch_i4.int4_decode_schedule(torch.from_numpy(x), torch.from_numpy(packed),
                                         torch.from_numpy(scale), **kw)


def _stacked_case(fmt, m, k, k2, seed=0):
    x, _ = _inputs(m, k, N_OUT, seed)
    tiles = np.stack([_tiles(fmt, _values(2 * k2, N_OUT, 10 + i), 512) for i in range(2)])
    n_pad = tiles.shape[1] * 512
    scale = (np.random.RandomState(1).rand(2, n_pad) * 0.1 + 0.01).astype(np.float32)
    want = jax_i4.int4_matmul_tiled_stacked(
        _x_for_jax(x, k2), jnp.asarray(tiles), jnp.asarray(scale), 1, n_out=N_OUT,
        block_k2=128, interpret=True)
    return x, tiles, scale, want


# (M, K, k2, bytes, K slices): M 1, 3 and 8 (the kernel pads x to 8 rows),
# u8 and v3 bytes, the same bytes with K < 2 k2 (the quantizer's padded
# fan-in), the rule's slice count (13 of 8 rows here) and K whole
STACKED_CASES = [(1, 208, 104, "u8", None), (1, 200, 104, "i8", 1), (3, 208, 104, "i8", 1),
                 (3, 200, 104, "u8", None), (8, 208, 104, "u8", None), (8, 200, 104, "i8", 1)]


@pytest.mark.parametrize("m,k,k2,fmt,k_slices", STACKED_CASES)
def test_schedule_matches_jax_stacked_kernel_on_layer_1(m, k, k2, fmt, k_slices):
    x, tiles, scale, want = _stacked_case(fmt, m, k, k2)
    assert torch_i4.decode_k_slices(N_OUT, k2, torch_i4.H100_SXM_SMS) == 13
    got = _schedule(x, tiles, scale, n_out=N_OUT, layer=1, k_slices=k_slices)
    _assert_close(got, want)


def test_schedule_with_a_ragged_last_slice_matches_jax():
    """Three slices of 104 byte rows: 40, 40 and 24."""
    x, tiles, scale, want = _stacked_case("i8", 8, 200, 104, seed=3)
    assert torch_i4.decode_slice_rows(104, 3) == 40
    _assert_close(_schedule(x, tiles, scale, n_out=N_OUT, layer=1, k_slices=3), want)


@pytest.mark.parametrize("m,fmt,k,k2,n,tw", [
    (1, "i8", 208, 104, N_OUT, 512),
    (8, "u8", 96, 128, 300, 128),  # K < k2: the high half is all zeros; tiles of 128
])
def test_schedule_matches_jax_tiled_kernel(m, fmt, k, k2, n, tw):
    x, scale = _inputs(m, k, n, 2)
    tiles = _tiles(fmt, _values(2 * k2, n, 3), tw)
    scale_pad = np.pad(scale, (0, tiles.shape[0] * tw - n))
    want = jax_i4.int4_matmul_tiled(_x_for_jax(x, k2), jnp.asarray(tiles),
                                    jnp.asarray(scale_pad), n_out=n, block_k2=128,
                                    interpret=True)
    _assert_close(_schedule(x, tiles, scale, n_out=n), want)


@pytest.mark.parametrize("m,k,k2,n", [(1, 208, 104, N_OUT), (3, 200, 104, 256)])
def test_schedule_matches_jax_flat_kernel(m, k, k2, n):
    """A flat weight is one tile of TW = N."""
    x, scale = _inputs(m, k, n, 4)
    packed = np.array(jax_i4.pack_int4(jnp.asarray(_values(2 * k2, n, 5))))
    want = jax_i4.int4_matmul(_x_for_jax(x, k2), jnp.asarray(packed), jnp.asarray(scale),
                              block_n=128, block_k2=128, interpret=True)
    _assert_close(_schedule(x, packed, scale), want)


def test_schedule_reads_x_through_its_row_stride():
    """x as a column slice of a wider activation (row stride > K), as int4_proj
    hands a slice of a fused output to the kernel."""
    m, k, k2 = 1, 200, 104
    wide = np.random.RandomState(6).randn(m, 3 * k).astype(np.float32)
    tiles = _tiles("i8", _values(2 * k2, N_OUT, 7), 512)
    scale = (np.random.RandomState(8).rand(N_OUT) * 0.1 + 0.01).astype(np.float32)
    x = torch.from_numpy(wide)[:, k:2 * k]
    assert x.stride(0) == 3 * k
    got = torch_i4.int4_decode_schedule(x, torch.from_numpy(tiles), torch.from_numpy(scale),
                                        n_out=N_OUT)
    want = jax_i4.int4_matmul_tiled(_x_for_jax(wide[:, k:2 * k], k2), jnp.asarray(tiles),
                                    jnp.asarray(np.pad(scale, (0, 1024 - N_OUT))), n_out=N_OUT,
                                    block_k2=128, interpret=True)
    _assert_close(got, want)


@pytest.mark.parametrize("layout", ["flat", "tiled", "stacked"])
@pytest.mark.parametrize("m", [1, 8])
def test_schedule_matches_the_plain_versions(layout, m):
    """Also a flat weight of N 72: its one band holds 72 of 128 columns."""
    k, k2 = 200, 104
    n = 72 if layout == "flat" else N_OUT
    x, scale = _inputs(m, k, n, 9)
    xt, st = torch.from_numpy(x), torch.from_numpy(scale)
    w = torch.from_numpy(_values(2 * k2, n, 10))
    if layout == "flat":
        packed = torch_i4.pack_int4(w)
        want = torch_i4.int4_matmul_plain(xt, packed, st)
        got = torch_i4.int4_decode_schedule(xt, packed, st)
    elif layout == "tiled":
        packed = torch_i4.pack_int4_tiled_i8(w)
        want = torch_i4.int4_matmul_tiled_plain(xt, packed, st, n_out=n)
        got = torch_i4.int4_decode_schedule(xt, packed, st, n_out=n, k_slices=5)
    else:
        packed = torch.stack([torch_i4.pack_int4_tiled(w.flip(0)), torch_i4.pack_int4_tiled(w)])
        st2 = torch.stack([st * 2, st])
        want = torch_i4.int4_matmul_tiled_stacked_plain(xt, packed, st2, 1, n_out=n)
        got = torch_i4.int4_decode_schedule(xt, packed, st2, n_out=n, layer=1)
    _assert_close(got, want.numpy())


# (n_out, k2, the rule's slices): the 7B decoder's q|k|v, out, gate|up, down
# (k2 5632) and lm_head, and K3a's unfused 256-wide k or v. The counts are
# the ones measured fastest on an H100 among those tried (PERF.md, PR 10).
SPLIT_SHAPES = [(12288, 2048, 1), (4096, 2048, 4), (22016, 2048, 2), (4096, 5632, 4),
                (32000, 2048, 1), (256, 2048, 32)]


@pytest.mark.parametrize("n,k2,want", SPLIT_SHAPES)
def test_split_rule_at_the_7b_shapes(n, k2, want):
    """On an H100 SXM's 132 SMs: the grid stays in one wave of the kernel's
    resident blocks; the busiest SM streams no more rows than without the
    split; slices of whole 8-row groups, none empty, covering k2 exactly.
    The rule does not depend on M."""
    sms = torch_i4.H100_SXM_SMS
    k_slices = torch_i4.decode_k_slices(n, k2, sms)
    assert k_slices == want
    bands = -(-n // torch_i4.DECODE_BLOCK_N)
    assert bands * k_slices <= torch_i4.DECODE_BLOCKS_PER_SM * sms
    rows = torch_i4.decode_slice_rows(k2, k_slices)
    assert rows % torch_i4.DECODE_ALIGN == 0
    assert (k_slices - 1) * rows < k2 <= k_slices * rows
    assert -(-bands * k_slices // sms) * rows <= -(-bands // sms) * k2


@pytest.mark.parametrize("sms,n,k2,want", [
    (114, 4096, 2048, 3),  # an H100 PCIe: out's 32 bands get 3 slices, not 4
    (114, 22016, 2048, 1),  # gate|up's 172 bands: twice that is past 3 x 114
    (78, 12288, 2048, 2),  # fewer SMs than q|k|v's 96 bands: 2 x 96 fits in 3 x 78
])
def test_split_rule_follows_the_sm_count(sms, n, k2, want):
    """The rule takes the card's SM count as given (the wrappers read it from
    the device), not an H100 SXM's."""
    assert torch_i4.decode_k_slices(n, k2, sms) == want


def test_split_rule_leaves_no_empty_slice():
    """Across many widths and byte-row counts the kernel's cut (rows of
    decode_slice_rows) gives exactly the rule's slice count."""
    for n in (64, 256, 640, 4096, 8192):
        for k2 in range(8, 6000, 8 * 37):
            k_slices = torch_i4.decode_k_slices(n, k2, torch_i4.H100_SXM_SMS)
            rows = torch_i4.decode_slice_rows(k2, k_slices)
            assert -(-k2 // rows) == k_slices, (n, k2, k_slices, rows)


def test_schedule_refuses_a_band_that_straddles_tiles():
    """The kernel's tiled entries refuse tiles that are not a whole number of
    128-column bands wide (a band's box is read from one tile); so does the walk."""
    w = torch.from_numpy(_values(64, 300, 11))
    x, scale = (torch.from_numpy(a) for a in _inputs(3, 64, 300, 12))
    with pytest.raises(ValueError, match="straddle"):
        torch_i4.int4_decode_schedule(x, torch_i4.pack_int4_tiled(w, 64), scale, n_out=300)


def test_module_decode_sizes_are_the_kernels():
    """The sizes the walk takes are the ones the CUDA source is built with;
    the M <= 8 route is the split-K kernel alone, and the split point stays."""
    source = (Path(torch_i4._build.CSRC) / "int4_matmul.cu").read_text()
    sizes = {name: int(value) for name, value in
             re.findall(r"#define TEOCHAT_INT4_DECODE_(BN|ALIGN) (\d+)", source)}
    assert sizes == {"BN": torch_i4.DECODE_BLOCK_N, "ALIGN": torch_i4.DECODE_ALIGN}
    # the split rule's wave is the blocks the launch bounds keep resident;
    # the ring's sizes are constants, not build switches
    per_sm = re.search(r"constexpr int DC_BLOCKS_PER_SM = (\d+);", source)
    assert int(per_sm.group(1)) == torch_i4.DECODE_BLOCKS_PER_SM
    assert "__launch_bounds__(DC_THREADS, DC_BLOCKS_PER_SM)" in source
    assert "#ifndef TEOCHAT_INT4" not in source
    assert "int4_small_m_kernel" not in source and "int4_decode_kernel" in source
    assert f"M <= {torch_i4.SMALL_M})" in source
    # the kernel and its launch set no function attribute (a captured launch
    # replays as it was recorded) and merge through the tickets
    decode = source[source.index("int4_decode_kernel("):source.index("// ---", source.index(
        "int launch_decode("))]
    assert "cudaFuncSetAttribute" not in decode and "atomicAdd(tickets" in decode
    assert "mma_16816" in decode and "tma_load_4d" in decode
