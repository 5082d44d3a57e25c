"""The Hopper decode attention's split walk against the JAX kernel it replaces.

The CUDA kernel (teochat_torch/csrc/decode_attention.cu, K2) runs only on a
card. It splits each row's cache slots into chunks of CHUNK, one block a
chunk, and merges the chunks' partials (m, l, acc) in chunk order in the
last block to finish. That walk is `decode_attention_split_schedule`, held
here against `teochat_tpu`'s `_decode_kernel` in Pallas interpret mode
(T a multiple of its 128-slot blocks) and against the JAX function's XLA
path (any T), as tests/test_torch_attention.py holds the plain twin.

Same inputs from a seeded numpy generator on both sides, fp32, 1e-4
relative (the two sum in another order). Lengths sit at the chunk's edges:
1, CHUNK - 1, CHUNK, CHUNK + 1 and T, and 0, which the kernel and the
Pallas kernel write as 0.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from teochat_tpu.ops.decode_attention import decode_attention as jax_decode
from teochat_torch.ops import decode_attention as dec_mod

RTOL, ATOL = 1e-4, 1e-5
C = dec_mod.CHUNK


def _case(b, h, hkv, t, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, d).astype(np.float32), rs.randn(b, hkv, t, d).astype(np.float32),
            rs.randn(b, hkv, t, d).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hkv", [(2, 2), (8, 2), (16, 1)])  # groups 1, 4, 16
def test_split_walk_matches_the_pallas_kernel(d, h, hkv):
    t = 256
    lens = np.array([0, 1, C - 1, C, C + 1, t], np.int32)
    q, k, v = _case(len(lens), h, hkv, t, d, 0)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lens), impl="pallas", interpret=True))
    got = dec_mod.decode_attention_split_schedule(_t(q), _t(k), _t(v), _t(lens))
    assert not got[0].any()  # length 0 is written as 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hkv", [(2, 2), (8, 2), (16, 1)])
def test_split_walk_matches_the_xla_path(d, h, hkv):
    """T = 200 is no multiple of the chunk: the last chunk is part-filled."""
    t = 200
    lens = np.array([1, C - 1, C, C + 1, t], np.int32)
    q, k, v = _case(len(lens), h, hkv, t, d, 1)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lens), impl="xla"))
    got = dec_mod.decode_attention_split_schedule(_t(q), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [16, 32, 128, 1024])
def test_split_walk_gives_the_same_answer_at_other_chunks(chunk):
    q, k, v = map(_t, _case(3, 8, 2, 300, 64, 2))
    lens = torch.tensor([5, 150, 300], dtype=torch.int32)
    want = dec_mod.decode_attention_split_schedule(q, k, v, lens)
    got = dec_mod.decode_attention_split_schedule(q, k, v, lens, chunk=chunk)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    live = lens > 0
    torch.testing.assert_close(got[live], dec_mod.decode_attention_plain(q, k, v, lens)[live],
                               rtol=1e-5, atol=1e-6)


def test_split_walk_reads_a_strided_cache_slab():
    """The decoder hands the kernel a transposed layer slab of the
    [L, B, T, Hkv, D] cache; the walk on it equals a contiguous copy's."""
    rs = np.random.RandomState(3)
    cache_k, cache_v = (_t(rs.randn(2, 2, 90, 4, 16).astype(np.float32)) for _ in range(2))
    q = _t(rs.randn(2, 8, 16).astype(np.float32))
    lens = torch.tensor([65, 90], dtype=torch.int32)
    ks, vs = cache_k[1].transpose(1, 2), cache_v[1].transpose(1, 2)
    got = dec_mod.decode_attention_split_schedule(q, ks, vs, lens)
    want = dec_mod.decode_attention_split_schedule(q, ks.contiguous(), vs.contiguous(), lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_module_chunk_is_the_kernels():
    source = (Path(dec_mod._build.CSRC) / "decode_attention.cu").read_text()
    assert int(re.search(r"#define TEOCHAT_DECODE_CHUNK (\d+)", source).group(1)) == dec_mod.CHUNK
    assert int(re.search(r"constexpr int MAX_G = (\d+);", source).group(1)) == \
        dec_mod.MAX_HEADS_A_BLOCK
    # the grid is sized from T (lengths stay on the device) and the merge is in the same launch
    assert re.search(r"const dim3 grid\(\(T \+ CHUNK - 1\) / CHUNK", source)
    # one launch of K2 a call (its multi-query form, K2m, is the file's other launch)
    assert source.count("<<<") == 2 and source.count("decode_split_kernel<D, GV><<<") == 1
    assert "atomicAdd(ticket, 1)" in source


def test_multi_query_walk_sizes_are_the_kernels():
    """K2m's walk (`decode_attention_multi_schedule`) takes the kernel's
    chunk of slots and pairs a block, and the kernel needs no workspace or
    tickets: its C entry takes q, k, v, lengths and o alone."""
    source = (Path(dec_mod._build.CSRC) / "decode_attention.cu").read_text()
    assert int(re.search(r"constexpr int MQ_SLOTS = (\d+);", source).group(1)) == dec_mod.MULTI_CHUNK
    nwarps = int(re.search(r"constexpr int NWARPS = (\d+);", source).group(1))
    per_warp = int(re.search(r"constexpr int MQ_WARP_PAIRS = (\d+);", source).group(1))
    assert nwarps * per_warp == dec_mod.MULTI_PAIRS == 32  # one pair's length a lane of warp 0
    entry = source[source.index('extern "C" int teochat_decode_attention_multi('):]
    entry = entry[:entry.index(")")]
    assert "tickets" not in entry and "part_" not in entry
    assert len(dec_mod._build._SIGNATURES["teochat_decode_attention_multi"]) == \
        entry.count(",") + 1
