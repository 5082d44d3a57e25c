"""Port vs JAX: int4 (w4a16) quantization is byte-exact and scale-exact, a
tree quantized by JAX loads through the bridge and gives the same products,
and a small fused-int4 decoder gives the same logits and greedy tokens.

All on the CPU in fp32, where both packages take the unpack -> matmul ->
scale path; logits to 1e-4 relative (summation order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import tiny_test_config
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import quant as jax_quant
from teochat_torch.checkpoint.bridge import init_teochat as torch_init_teochat
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.config import GenerationConfig
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.ops import quant as torch_quant

RTOL, ATOL = 1e-4, 1e-5
IMG = -200


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert (x.shape, x.dtype) == (y.shape, y.dtype)
        np.testing.assert_array_equal(x, y)


def _llm_cfg(kv_heads=8):
    """Wide enough for tiled leaves: qkv 1536, gate|up 1200 (3 tiles, padded),
    down with fan-in 600 (300 byte rows padded to 512), lm_head 700 (2 tiles)."""
    return dataclasses.replace(
        tiny_test_config().llm, hidden_size=512, num_heads=8, num_kv_heads=kv_heads,
        intermediate_size=600, vocab_size=700, num_layers=2)


@pytest.mark.parametrize("shape,leaf", [
    ((64, 48), "packed"),            # narrower than a tile: flat u8
    ((2, 64, 200), "packed"),        # stacked flat
    ((600, 512), "packed_tiles"),    # fan-in padded by _pad_k2
    ((256, 700), "packed_tiles"),    # N not a multiple of the tile
    ((3, 64, 1100), "packed_tiles"),  # stacked, 3 tiles a layer
])
def test_quantize_kernel_int4_is_bitwise_equal(shape, leaf):
    k = np.random.RandomState(1).randn(*shape).astype(np.float32)
    k[..., :, 5] = 0.0  # an all-zero channel takes scale 1
    got = to_numpy(torch_quant.quantize_kernel_int4(torch.from_numpy(k)))
    want = _np_tree(jax_quant.quantize_kernel_int4(jnp.asarray(k)))
    assert leaf in got
    _assert_trees_equal(got, want)
    sizes = (64, 128, 300, 512, 5504)
    assert [torch_quant._pad_k2(v) for v in sizes] == [jax_quant._pad_k2(v) for v in sizes]


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kv_heads", [8, 2], ids=["mha", "gqa"])
def test_quantize_llama_params_int4_is_bitwise_equal(fuse, kv_heads):
    """gqa + unfused has flat k and v (128 wide) beside tiled q."""
    cfg = _llm_cfg(kv_heads)
    params = jax_llama.init_llama(jax.random.PRNGKey(2), cfg)
    want = _np_tree(jax_quant.quantize_llama_params_int4(params, fuse_projections=fuse))
    got = to_numpy(torch_quant.quantize_llama_params_int4(
        to_torch(_np_tree(params), "cpu"), fuse_projections=fuse))
    _assert_trees_equal(got, want)
    assert ("qkv" in got["layers"]["attn"]) == fuse
    if not fuse and kv_heads == 2:
        assert "packed" in got["layers"]["attn"]["k"] and "packed_tiles" in got["layers"]["attn"]["q"]
    # the bridge carries the packed leaves byte for byte, with their dtypes
    _assert_trees_equal(to_numpy(to_torch(want, "cpu", dtype=torch.float32)), want)
    assert to_torch(want, "cpu")["lm_head"]["packed_tiles"].dtype == torch.int8


def test_int4_proj_on_a_bridged_jax_tree_matches_jax():
    cfg = _llm_cfg(2)
    params = jax_llama.init_llama(jax.random.PRNGKey(3), cfg)
    jq = jax_quant.quantize_llama_params_int4(params, fuse_projections=False)
    tq = to_torch(_np_tree(jq), "cpu")
    rs = np.random.RandomState(4)
    for group, name, fan_in in (("attn", "q", 512), ("attn", "k", 512), ("mlp", "down", 600)):
        x = rs.randn(2, 3, fan_in).astype(np.float32)
        for layer in range(cfg.num_layers):
            want = np.asarray(jax_quant.int4_proj(jnp.asarray(x), jq["layers"][group][name], layer))
            got = torch_quant.int4_proj(torch.from_numpy(x), tq["layers"][group][name], layer)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    x = rs.randn(2, 1, 512).astype(np.float32)
    want = np.asarray(jax_quant.int4_proj(jnp.asarray(x), jq["lm_head"]))
    got = torch_quant.int4_proj(torch.from_numpy(x), tq["lm_head"])
    assert got.shape == (2, 1, 700)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        torch_quant.unpack_int4(tq["layers"]["attn"]["k"]["packed"], torch.float32).numpy(),
        np.asarray(jax_quant.unpack_int4(jq["layers"]["attn"]["k"]["packed"], jnp.float32)))


@pytest.mark.parametrize("fuse,kv_heads", [(True, 8), (False, 2)], ids=["fused", "unfused-gqa"])
def test_int4_prefill_then_decode_logits_match_jax(fuse, kv_heads):
    cfg = _llm_cfg(kv_heads)
    params = jax_quant.quantize_llama_params_int4(
        jax_llama.init_llama(jax.random.PRNGKey(5), cfg), fuse_projections=fuse)
    tparams = to_torch(_np_tree(params), "cpu")
    rs = np.random.RandomState(6)
    pad_to, t_max = 8, 10
    seq_lens = np.array([8, 5], np.int32)
    emb = rs.randn(2, pad_to, cfg.hidden_size).astype(np.float32)
    dec_ids = rs.randint(3, cfg.vocab_size, (2, 1)).astype(np.int32)
    mask = np.arange(pad_to)[None] < seq_lens[:, None]
    pos = np.where(mask, np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    slots = np.where(mask, pos, t_max - 1).astype(np.int32)

    jcache = jax_llama.init_cache(cfg, 2, t_max, dtype=jnp.float32)
    w0, jcache = jax_llama.llama_forward(
        params, cfg, jnp.asarray(emb), position_ids=jnp.asarray(pos), cache=jcache,
        write_slots=jnp.asarray(slots),
        kv_mask=jnp.asarray(np.arange(t_max)[None] < seq_lens[:, None]),
        logits_mode="last", last_index=jnp.asarray(seq_lens - 1))
    w1, _ = jax_llama.llama_forward(
        params, cfg, jax_llama.embed_tokens(params, jnp.asarray(dec_ids)),
        position_ids=jnp.asarray(seq_lens[:, None]), cache=jcache,
        write_slots=jnp.asarray(seq_lens[:, None]),
        kv_mask=jnp.asarray(np.arange(t_max)[None] <= seq_lens[:, None]), logits_mode="last")

    tcache = torch_llama.init_cache(cfg, 2, t_max, dtype=torch.float32, device="cpu")
    lens = torch.from_numpy(seq_lens)
    g0 = torch_llama.llama_forward(
        tparams, cfg, torch.from_numpy(emb), position_ids=torch.from_numpy(pos), cache=tcache,
        write_slots=torch.from_numpy(slots), logits_mode="last", last_index=lens - 1)
    g1 = torch_llama.llama_forward(
        tparams, cfg, torch_llama.embed_tokens(tparams, torch.from_numpy(dec_ids).long()),
        position_ids=lens[:, None], cache=tcache, write_slots=lens[:, None], logits_mode="last")
    for g, w in ((g0, w0), (g1, w1)):
        assert g.dtype == torch.float32 and g.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_int4_cache_free_forward_matches_jax():
    """The training-style forward (no cache): JAX slices each layer's tiles in
    its scan, the port hands the stack and the layer index to `int4_proj`."""
    cfg = _llm_cfg()
    params = jax_quant.quantize_llama_params_int4(jax_llama.init_llama(jax.random.PRNGKey(7), cfg))
    emb = np.random.RandomState(8).randn(2, 6, cfg.hidden_size).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    want, _ = jax_llama.llama_forward(params, cfg, jnp.asarray(emb), position_ids=jnp.asarray(pos))
    got = torch_llama.llama_forward(to_torch(_np_tree(params), "cpu"), cfg, torch.from_numpy(emb),
                                    position_ids=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_int4_greedy_generate_matches_jax():
    """A model whose top logits are well separated (lm_head scaled up before
    it is quantized), so a last-bit difference cannot flip a greedy token."""
    base = tiny_test_config(vocab_size=700)
    cfg = dataclasses.replace(base, dtype="float32", llm=dataclasses.replace(
        _llm_cfg(), vocab_size=700), projector=dataclasses.replace(base.projector, hidden_size=512))
    params = jax_teochat.init_teochat(jax.random.PRNGKey(9), cfg)
    llm = dict(params["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}
    params = {**params, "llm": jax_quant.quantize_llama_params_int4(llm)}
    assert "qkv" in params["llm"]["layers"]["attn"] and "packed_tiles" in params["llm"]["lm_head"]
    jm = jax_teochat.TEOChat(cfg, params)
    tm = torch_teochat.TEOChat(cfg, to_torch(_np_tree(params), "cpu"))
    ids = [[1, 5, IMG, 7, 8, IMG, 9], [1, 3, 4]]
    frames = np.random.RandomState(10).randn(2, 3, 28, 28).astype(np.float32)
    greedy = GenerationConfig(max_new_tokens=6, temperature=0.0, do_sample=False, stop_strings=())
    want = jm.generate(ids, frames, greedy)
    assert tm.generate(ids, frames, greedy) == want
    assert all(len(r) == 6 for r in want)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_init_teochat_int4_has_the_jax_layout_and_generates(fuse):
    base = tiny_test_config(vocab_size=700)
    cfg = dataclasses.replace(base, dtype="float32", llm=_llm_cfg(2),
                              projector=dataclasses.replace(base.projector, hidden_size=512))
    tparams = torch_init_teochat(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32,
                                 quant="int4", fuse_projections=fuse)
    jparams = jax_teochat.init_teochat(jax.random.PRNGKey(0), cfg)
    jllm = jax_quant.quantize_llama_params_int4(jparams["llm"], fuse_projections=fuse)
    want, got = _np_tree(jllm), to_numpy(tparams["llm"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    frames = np.random.RandomState(11).randn(1, 3, 28, 28).astype(np.float32)
    greedy = GenerationConfig(max_new_tokens=4, temperature=0.0, do_sample=False, stop_strings=())
    out = torch_teochat.TEOChat(cfg, tparams).generate([[1, IMG, 5], [1, 7]], frames, greedy)
    assert [len(r) for r in out] == [4, 4]


def test_int4_kernels_are_forward_only_and_take_cuda_bf16_only():
    x = torch.zeros(2, 16, requires_grad=True)
    leaf = torch_quant.quantize_kernel_int4(torch.ones(16, 8))
    # the plain path differentiates through x like any torch code
    torch_quant.int4_proj(x, leaf).sum().backward()
    assert x.grad is not None
    with pytest.raises(ValueError):  # impl="kernel" on a CPU fp32 tensor raises, never falls back
        from teochat_torch.ops import int4_matmul as torch_i4
        torch_i4.int4_matmul(x.detach(), leaf["packed"], leaf["scale"], impl="kernel")
