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
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

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
    assert source.count("<<<") == 2 and source.count("decode_split_kernel<D, GV, KV><<<") == 1
    assert "atomicAdd(ticket, 1)" in source


def test_multi_query_walk_sizes_are_the_kernels():
    """K2m's walk (`decode_attention_multi_schedule`) and plan (`multi_plan`)
    take the kernel's chunk, warps and row-group counts; the kernel reads
    its slots through a `cp.async` ring into `mma.sync` tiles, launches once
    a call, and its C entry takes the plan, the workspace and the tickets as
    `_build._SIGNATURES` declares them."""
    source = (Path(dec_mod._build.CSRC) / "decode_attention.cu").read_text()
    k2m = source[source.index("// ---------------------------------------------------------------- K2m"):]
    assert int(re.search(r"constexpr int MQ_CHUNK = (\d+);", k2m).group(1)) == dec_mod.MULTI_CHUNK
    assert re.search(r"constexpr int MQ_WARPS = NWARPS;", k2m)
    assert int(re.search(r"constexpr int MQ_MAX_SPLITS = (\d+);", k2m).group(1)) == \
        dec_mod.MULTI_MAX_SPLITS
    assert int(re.search(r"constexpr int NWARPS = (\d+);", source).group(1)) == dec_mod.MULTI_WARPS
    assert int(re.search(r"constexpr int MQ_STAGES = (\d+);", k2m).group(1)) >= 2  # a ring
    cases = re.findall(r"case (\d+): TEOCHAT_MULTI_LAUNCH\((\d+)\);", k2m)
    assert [(int(a), int(b)) for a, b in cases] == [(r, r) for r in dec_mod.MULTI_ROW_WARPS]
    kernel = k2m[k2m.index("decode_multi_kernel("):
                 k2m.index("template <int D, int RW, typename KV>\nint launch_multi(")]
    assert "mma_16816(" in kernel and "ldsm_x4_t(" in kernel
    assert "cp_async16(" in kernel and "cp_async_wait<MQ_STAGES - 2>()" in kernel
    assert "fmaf(" not in kernel  # no FMA products left
    assert "atomicAdd(tickets + tile_id, 1)" in kernel  # the splits merged in the launch
    assert k2m.count("<<<") == 1
    entry = source[source.index('extern "C" int teochat_decode_attention_multi('):]
    entry = entry[:entry.index(")")]
    assert "tickets" in entry and "part_ml" in entry and "split_chunks" in entry
    assert len(dec_mod._build._SIGNATURES["teochat_decode_attention_multi"]) == \
        entry.count(",") + 1


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_multi_plan_is_bounded_and_covers_every_slot(sms):
    """`multi_plan` over verify blocks, suffixes and GQA shapes: splits
    cover every chunk of T, none shorter than MULTI_MIN_SPLIT_CHUNKS (but
    where T has fewer chunks than that), taken only while the tiles are no
    more than the SMs, so the workspace holds at most one tile of partials
    an SM; a tile's rows never exceed 16 per warp of a row group."""
    for b in (1, 3, 8):
        for s in (1, 2, 5, 9, 17, 100, 128, 512, 1024, 4096):
            for h, hkv in ((32, 32), (32, 8), (32, 2)):
                for t in (1, 63, 64, 700, 4096):
                    rw, splits, split_chunks = dec_mod.multi_plan(b, s, h, hkv, t, sms)
                    assert rw in dec_mod.MULTI_ROW_WARPS
                    tiles = b * hkv * -(-s * (h // hkv) // (16 * rw))
                    n_chunks = -(-t // dec_mod.MULTI_CHUNK)
                    assert (splits - 1) * split_chunks < n_chunks <= splits * split_chunks
                    assert splits <= dec_mod.MULTI_MAX_SPLITS
                    if splits > 1:
                        assert tiles <= sms and split_chunks >= dec_mod.MULTI_MIN_SPLIT_CHUNKS
                        assert tiles * splits <= sms
                    if rw > 1:
                        assert 2 * tiles >= sms and s * (h // hkv) > 16 * rw // 2


def test_multi_plan_at_the_7b_shapes():
    """The picks on an H100 (132 SMs), batch 1, 32 heads, T 4096: a verify
    block or a short suffix splits the slots 4 ways (32 tiles of 16 rows),
    a text turn's S 128 takes 32-row tiles (128 of them) and no split, S
    512 and up 64-row tiles and no split."""
    plan = {s: dec_mod.multi_plan(1, s, 32, 32, 4096, 132) for s in (1, 2, 5, 9, 128, 512, 1024)}
    assert plan == {1: (1, 4, 16), 2: (1, 4, 16), 5: (1, 4, 16), 9: (1, 4, 16),
                    128: (2, 1, 64), 512: (4, 1, 64), 1024: (4, 1, 64)}
